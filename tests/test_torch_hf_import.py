"""The port's HF encoder import (`vod_tpu_torch/models/hf_import.py`) against
the JAX package's (`vod_tpu/models/hf_import.py`), on tiny random BERT,
RoBERTa and XLM-R models from `transformers` saved to a temporary directory
as `model.safetensors` and as `pytorch_model.bin`.

The port reads the directory itself (no `transformers`, no `safetensors`);
JAX goes through `transformers.AutoModel.from_pretrained`. Tolerances: the
ported weights equal `convert.flax_to_state_dict(JAX's)` exactly; encodings
within atol 1e-5 of JAX's (f32, other sum orders) and within 2e-4 of
`transformers`' on valid positions (JAX's bound, `tests/test_hf_import.py`:
the port, like JAX, uses the tanh GELU where BERT uses erf).
"""

import functools
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_helpers import CPU, np_of
from vod_tpu.exps import cli as jax_cli
from vod_tpu.exps.structconf import ModelConfig as JaxModelConfig
from vod_tpu.models.encoder import TransformerEncoder as JaxBackbone
from vod_tpu.models.encoder import TransformerEncoderConfig as JaxEncoderConfig
from vod_tpu.models.encoder import VodEncoder as JaxVodEncoder
from vod_tpu.models.hf_import import load_hf_encoder as jax_load_hf_encoder
from vod_tpu.models.pooler import VodPoolerConfig as JaxPoolerConfig
from vod_tpu_torch.exps import cli
from vod_tpu_torch.exps.structconf import ModelConfig
from vod_tpu_torch.models import TransformerEncoder, flax_to_state_dict, load_hf_encoder
from vod_tpu_torch.models.hf_import import read_safetensors, resolve_checkpoint, write_safetensors

ROOT = Path(__file__).resolve().parent.parent
F32_ATOL = 1e-5
HF_ATOL = 2e-4
TINY = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4, intermediate_size=64,
            hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)


def _hf_model(kind: str, seed: int = 0):
    import transformers

    torch.manual_seed(seed)
    if kind == "bert":
        cfg = transformers.BertConfig(vocab_size=128, max_position_embeddings=512, type_vocab_size=2, **TINY)
        return transformers.BertModel(cfg).eval()
    if kind == "roberta":
        cfg = transformers.RobertaConfig(vocab_size=200, max_position_embeddings=514, type_vocab_size=1, pad_token_id=1,
                                         **TINY)
        return transformers.RobertaModel(cfg).eval()
    cfg = transformers.XLMRobertaConfig(vocab_size=150, max_position_embeddings=514, type_vocab_size=1, pad_token_id=1,
                                        **TINY)
    return transformers.XLMRobertaModel(cfg).eval()


def _save(tmp: Path, kind: str, safe: bool, seed: int = 0) -> Path:
    hf = _hf_model(kind, seed)
    out = tmp / f"{kind}-{'safe' if safe else 'bin'}"
    hf.save_pretrained(out, safe_serialization=safe)
    assert (out / ("model.safetensors" if safe else "pytorch_model.bin")).is_file()
    return out


def _tokens(vocab: int, pad: int = 0):
    rng = np.random.default_rng(1)
    ids = rng.integers(2, vocab, size=(2, 12)).astype(np.int64)
    mask = np.ones((2, 12), np.int64)
    mask[1, 9:] = 0
    ids[1, 9:] = pad  # HF RoBERTa derives positions from non-pad tokens
    return ids, mask


@pytest.mark.parametrize("safe", [True, False], ids=["safetensors", "bin"])
@pytest.mark.parametrize("kind", ["bert", "roberta", "xlm-roberta"])
def test_load_matches_jax_and_transformers(tmp_path: Path, kind: str, safe: bool) -> None:
    path = _save(tmp_path, kind, safe)
    cfg, sd = load_hf_encoder(str(path))
    jcfg, jparams = jax_load_hf_encoder(str(path))
    for f in ("vocab_size", "hidden_size", "num_layers", "num_heads", "intermediate_size", "max_position_embeddings",
              "type_vocab_size", "layer_norm_eps"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    want = {k.removeprefix("backbone."): v for k, v in
            flax_to_state_dict({"backbone": jax.device_get(jparams)}).items()}
    assert set(sd) == set(want)
    for name, v in sd.items():
        assert v.dtype == torch.float32 and torch.equal(v, want[name]), name

    backbone = TransformerEncoder(cfg, device=CPU)
    backbone.load_state_dict(sd)
    ids, mask = _tokens(cfg.vocab_size, pad=0 if kind == "bert" else 1)
    with torch.no_grad():
        got = np_of(backbone(torch.from_numpy(ids), torch.from_numpy(mask)))
        ref = _hf_model(kind).eval()(input_ids=torch.from_numpy(ids),
                                     attention_mask=torch.from_numpy(mask)).last_hidden_state.numpy()
    j = np.asarray(JaxBackbone(jcfg).apply({"params": jparams}, jnp.asarray(ids, jnp.int32),
                                           jnp.asarray(mask, jnp.int32)), np.float32)
    valid = mask.astype(bool)
    np.testing.assert_allclose(got[valid], j[valid], atol=F32_ATOL, rtol=0)
    assert np.abs(got - ref)[valid].max() < HF_ATOL


def test_old_layernorm_names_and_prefixes_load(tmp_path: Path) -> None:
    """`bert.`-prefixed keys with LayerNorm `gamma` / `beta` (older BERT
    checkpoints) load as the same weights."""
    path = _save(tmp_path, "bert", safe=True)
    sd = read_safetensors(path / "model.safetensors")
    old = {"bert." + k.replace("LayerNorm.weight", "LayerNorm.gamma").replace("LayerNorm.bias", "LayerNorm.beta"): v
           for k, v in sd.items()}
    other = tmp_path / "old"
    other.mkdir()
    (other / "config.json").write_text((path / "config.json").read_text())
    torch.save(old, other / "pytorch_model.bin")
    _, want = load_hf_encoder(str(path))
    _, got = load_hf_encoder(str(other))
    assert set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in want)


def test_safetensors_round_trip_and_dtypes(tmp_path: Path) -> None:
    import safetensors.torch

    tensors = {"a": torch.randn(3, 5), "b": torch.randn(7).to(torch.bfloat16), "c": torch.randn(2, 2, 2).half(),
               "d": torch.arange(6, dtype=torch.int64).reshape(2, 3), "e": torch.zeros(0, 4)}
    write_safetensors(tmp_path / "x.safetensors", tensors)
    theirs = safetensors.torch.load_file(str(tmp_path / "x.safetensors"))
    safetensors.torch.save_file(tensors, str(tmp_path / "y.safetensors"))
    ours = read_safetensors(tmp_path / "y.safetensors")
    for name, t in tensors.items():
        assert theirs[name].dtype == ours[name].dtype == t.dtype and torch.equal(theirs[name], t)
        assert torch.equal(ours[name], t)
    bad = {"i": torch.zeros(2, dtype=torch.int32)}
    safetensors.torch.save_file(bad, str(tmp_path / "z.safetensors"))
    with pytest.raises(ValueError, match="I32"):
        read_safetensors(tmp_path / "z.safetensors")


def test_load_works_with_transformers_and_safetensors_blocked(tmp_path: Path) -> None:
    path = _save(tmp_path, "bert", safe=True)
    _, want = load_hf_encoder(str(path))
    torch.save(want, tmp_path / "want.pt")
    code = (
        "import sys\n"
        "for name in ('transformers', 'safetensors', 'jax', 'flax', 'vod_tpu', 'huggingface_hub'):\n"
        "    sys.modules[name] = None\n"
        "import torch\n"
        "from vod_tpu_torch.models import load_hf_encoder\n"
        f"cfg, sd = load_hf_encoder({str(path)!r})\n"
        f"want = torch.load({str(tmp_path / 'want.pt')!r})\n"
        "assert set(sd) == set(want) and all(torch.equal(sd[k], want[k]) for k in want)\n"
        "print('ok', cfg.num_layers)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip() == "ok 2"


@pytest.mark.parametrize("env", ["HF_HOME", "HOME"])
def test_hub_id_resolves_in_the_offline_cache(tmp_path: Path, monkeypatch, env: str) -> None:
    """`$HF_HOME/hub`, else `~/.cache/huggingface/hub`."""
    src = _save(tmp_path, "bert", safe=True)
    home = tmp_path / "cache"
    hub = home / "hub" if env == "HF_HOME" else home / ".cache" / "huggingface" / "hub"
    snapshot = hub / "models--intfloat--tiny-bert" / "snapshots" / "abc123"
    snapshot.mkdir(parents=True)
    for f in src.iterdir():
        (snapshot / f.name).write_bytes(f.read_bytes())
    (hub / "models--intfloat--tiny-bert" / "refs").mkdir()
    (hub / "models--intfloat--tiny-bert" / "refs" / "main").write_text("abc123\n")
    monkeypatch.delenv("HF_HOME", raising=False)
    monkeypatch.setenv(env, str(home))
    assert resolve_checkpoint("intfloat/tiny-bert") == snapshot
    _, got = load_hf_encoder("intfloat/tiny-bert")
    _, want = load_hf_encoder(str(src))
    assert all(torch.equal(got[k], want[k]) for k in want)
    with pytest.raises(FileNotFoundError, match="HF cache"):
        resolve_checkpoint("intfloat/absent")


def _model_cfg(path: str, **kw) -> dict:
    return dict(kind="ranker", gradients="retrieval", name_or_path=path, vocab_size=128, hidden_size=32,
                num_layers=2, num_heads=4, intermediate_size=64, agg_method="mean", output_norm="l2", scaler=10.0,
                **kw)


def test_hf_fallback_in_both_modes(tmp_path: Path) -> None:
    absent = str(tmp_path / "absent")
    gen = torch.Generator().manual_seed(0)
    model = cli.build_model(ModelConfig(**_model_cfg(absent)), device="cpu", generator=gen)
    with pytest.raises(FileNotFoundError):
        cli._maybe_port_hf_encoder(model, ModelConfig(**_model_cfg(absent)))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with pytest.warns(UserWarning, match="random init"):
        cli._maybe_port_hf_encoder(model, ModelConfig(**_model_cfg(absent, hf_fallback="random")))
    assert all(torch.equal(before[k], v) for k, v in model.state_dict().items())
    path = str(_save(tmp_path, "bert", safe=True))
    with pytest.raises(ValueError, match="config mismatch"):
        cli._maybe_port_hf_encoder(model, ModelConfig(**{**_model_cfg(path), "num_layers": 3}))


@pytest.mark.parametrize("lora_rank", [0, 4])
def test_graft_at_step_0_equals_jax_graft_without_lora(tmp_path: Path, lora_rank: int) -> None:
    """The port loads the checkpoint into each LoRA `base` and keeps the
    adapters' init (`lora_b` 0): at step 0 it encodes as JAX's graft into an
    encoder without LoRA (JAX's own LoRA graft cannot be applied)."""
    path = str(_save(tmp_path, "bert", safe=True))
    pooler = dict(agg_method="mean", output_norm="l2", scaler=10.0)
    jcfg = JaxEncoderConfig(vocab_size=128, hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
                            dtype=jnp.float32, pooler=JaxPoolerConfig(**pooler))
    ids, mask = _tokens(128)
    jenc = JaxVodEncoder(jcfg)
    init = jenc.init(jax.random.PRNGKey(0), jnp.asarray(ids, jnp.int32), jnp.asarray(mask, jnp.int32))
    grafted = jax_cli._maybe_port_hf_encoder({"params": {"encoder": init["params"]}},
                                             JaxModelConfig(**_model_cfg(path)))
    j = np_of(jenc.apply({"params": grafted["params"]["encoder"]}, jnp.asarray(ids, jnp.int32),
                         jnp.asarray(mask, jnp.int32)))

    mcfg = ModelConfig(**_model_cfg(path, lora_rank=lora_rank))
    build = functools.partial(cli.TransformerEncoderConfig, dtype=torch.float32)
    cli_cfg = cli.TransformerEncoderConfig
    cli.TransformerEncoderConfig = build
    try:
        model = cli.build_model(mcfg, device="cpu", generator=torch.Generator().manual_seed(3))
    finally:
        cli.TransformerEncoderConfig = cli_cfg
    cli._maybe_port_hf_encoder(model, mcfg)
    if lora_rank:
        a = model.encoder.backbone.layers[0].intermediate.lora_a
        assert a.abs().max() > 0 and model.encoder.backbone.layers[1].output.lora_b.abs().max() == 0
    with torch.no_grad():
        t = np_of(model.encode_field(torch.from_numpy(ids).int(), torch.from_numpy(mask).int()))
    np.testing.assert_allclose(t, j, atol=F32_ATOL, rtol=0)


def test_config_from_a_config_json_dict(tmp_path: Path) -> None:
    from vod_tpu_torch.models import config_from_hf

    path = _save(tmp_path, "roberta", safe=True)
    raw = json.loads((path / "config.json").read_text())
    cfg = config_from_hf(raw, position_offset=2)
    assert (cfg.max_position_embeddings, cfg.type_vocab_size, cfg.num_layers) == (512, 1, 2)
    assert cfg == config_from_hf(_hf_model("roberta").config, position_offset=2)
