"""The large-encoder options of the port's experiment runner
(`vod_tpu_torch/exps/cli.py`): `model.name_or_path`, `lora_rank`, `kbit`,
`remat`, `trainer.gradcache_chunk_rows` and `optimizer: adafactor`, with the
JAX `run_experiment` beside the port's as in `tests/test_torch_cli.py`
(f32 activations on both sides, sampling temperature 0 so that no random
draw enters, `sys.mesh_shape: [1]`).

Tolerance: each logged loss within 1e-5 (f32 sums in other orders). The
runs use a learning rate of 1e-3 so that an Adafactor update of a gradient
entry that is rounding noise (sign-normalized at its first step) moves the
next loss by less than that.
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from tests.helpers import _VOCAB, tiny_tokenizer
from tests.test_exps import _toy_data
from tests.test_torch_cli import _capture_jax_init, _carry_into_port, _f32, _port_tok, _raw
from vod_tpu.exps import cli as jax_cli
from vod_tpu.exps.structconf import Experiment as JaxExperiment
from vod_tpu_torch.exps import cli
from vod_tpu_torch.exps.structconf import Experiment
from vod_tpu_torch.models import QuantizedLeaf, kbit_params

ROOT = Path(__file__).resolve().parent.parent
ATOL = 1e-5
WIDTHS = dict(hidden_size=32, num_hidden_layers=1, num_attention_heads=2, intermediate_size=64)


def _checkpoint(tmp: Path, vocab_size: int = len(_VOCAB)) -> Path:
    """A tiny random BERT in the HF layout (safetensors), 512 positions."""
    import transformers

    torch.manual_seed(0)
    cfg = transformers.BertConfig(vocab_size=vocab_size, max_position_embeddings=512, hidden_dropout_prob=0.0,
                                  attention_probs_dropout_prob=0.0, **WIDTHS)
    out = tmp / "tiny-bert"
    transformers.BertModel(cfg).save_pretrained(out, safe_serialization=True)
    return out


def _experiment(**over) -> dict:
    raw = _raw(collate={"temperature": 0.0},
               trainer={"optimizer": "adafactor", "learning_rate": 1e-3, "weight_decay": 0.01, "max_steps": 3,
                        "period": 2, "gradcache_chunk_rows": 4,
                        "parameters": {"dense": {"mode": "constant", "value": 1.0},
                                       "sparse": {"mode": "constant", "value": 0.5}}})
    raw["model"] = {**raw["model"], "num_layers": 1, "learn_scaler": True, "scaler": 10.0, "agg_method": "mean",
                    "output_norm": "l2", "remat": True}
    for k, v in over.items():
        raw[k] = {**raw.get(k, {}), **v}
    return raw


def _run_both(monkeypatch, raw: dict, carry_init: bool) -> tuple[list, list, dict]:
    sections, queries = _toy_data(n_sections=24, n_queries=24)
    _f32(monkeypatch)
    seen = _capture_jax_init(monkeypatch)
    jlogs, tlogs = [], []
    jax_cli.run_experiment(JaxExperiment.parse(raw), sections=sections, queries=queries, tokenizer=tiny_tokenizer(),
                           on_log=lambda s, m: jlogs.append(m))
    if carry_init:
        _carry_into_port(monkeypatch, seen)
    out = cli.run_experiment(Experiment.parse(raw), sections=sections, queries=queries, tokenizer=_port_tok(),
                             on_log=lambda s, m: tlogs.append(m), device="cpu")
    return jlogs, tlogs, out


def test_checkpoint_remat_gradcache_adafactor_match_jax(tmp_path: Path, monkeypatch) -> None:
    """Both runners load the same local checkpoint (JAX through
    `transformers`, the port through its own reader): the same losses."""
    raw = _experiment(model={"name_or_path": str(_checkpoint(tmp_path))})
    jlogs, tlogs, out = _run_both(monkeypatch, raw, carry_init=False)
    assert out["state"].step == 3 and len(jlogs) == len(tlogs) == 3
    for j, t in zip(jlogs, tlogs):
        assert t["loss"] == pytest.approx(j["loss"], abs=ATOL)
    assert out["step_fn"].gradcache_chunk_rows == 4 and out["model"].cfg.remat
    assert type(out["optimizer"]).__name__ == "Adafactor"


def test_kbit_lora_remat_gradcache_adafactor_match_jax(monkeypatch) -> None:
    """JAX's init (random `lora_a`, zero `lora_b`) carried over, then both
    int8-freeze the base: the same losses, and only the adapters and the
    pooler train."""
    raw = _experiment(model={"lora_rank": 4, "lora_alpha": 8.0, "kbit": True})
    jlogs, tlogs, out = _run_both(monkeypatch, raw, carry_init=True)
    assert len(jlogs) == len(tlogs) == 3
    for j, t in zip(jlogs, tlogs):
        assert t["loss"] == pytest.approx(j["loss"], abs=ATOL)
    kb = kbit_params(out["model"])
    assert kb is not None and sorted({n.rsplit(".", 1)[-1] for n in kb.trainable}) == ["log_scaler", "lora_a", "lora_b"]
    opt_params = [p for g in out["optimizer"].param_groups for p in g["params"]]
    assert {id(p) for p in opt_params} == {id(p) for p in kb.trainable.values()}
    assert all(p.abs().max() > 0 for n, p in kb.trainable.items() if n.endswith("lora_b"))


def test_kbit_needs_lora(monkeypatch) -> None:
    raw = _experiment(model={"kbit": True})
    sections, queries = _toy_data(n_sections=8, n_queries=8)
    with pytest.raises(ValueError, match="lora_rank > 0"):
        cli.run_experiment(Experiment.parse(raw), sections=sections, queries=queries, tokenizer=_port_tok(),
                           device="cpu")


def test_check_ported_refuses_only_the_rest() -> None:
    """The six options, the SPLADE encoder, MoE and profile traces pass
    `check_ported`: no option is left to refuse."""
    ok = _raw(model={"name_or_path": "x", "kbit": True, "lora_rank": 2, "remat": True},
              trainer={"gradcache_chunk_rows": 8, "optimizer": "adafactor"})
    cli.check_ported(Experiment.parse(ok), "cpu")
    cli.check_ported(Experiment.parse(_raw(model={"splade_encoder": True})), "cpu")
    cli.check_ported(Experiment.parse(_raw(model={"moe_experts": 2})), "cpu")
    cli.check_ported(Experiment.parse(_raw(sys={"profile_dir": "trace"})), "cpu")


BLOCKED = ("jax", "jaxlib", "flax", "optax", "vod_tpu", "pydantic", "yaml", "transformers", "tokenizers",
           "datasets", "tensorstore", "safetensors")


def test_qlora_preset_runs_from_a_local_checkpoint(tmp_path: Path) -> None:
    """`extends: [arch/v5e-1-large-qlora, optimizer/adafactor]` at toy widths
    from a local checkpoint, through `main` in a subprocess with JAX,
    `transformers` and `safetensors` blocked: 8 micro-batches of 4 a step,
    GradCache at 128 rows, int8 codes unchanged by training, every LoRA
    group and the pooler moved."""
    sections, queries = _toy_data(n_sections=12, n_queries=36)
    beir = tmp_path / "beir"
    (beir / "qrels").mkdir(parents=True)
    (beir / "corpus.jsonl").write_text("".join(
        json.dumps({"_id": s["id"], "title": s["title"], "text": s["content"]}) + "\n" for s in sections))
    (beir / "queries.jsonl").write_text("".join(json.dumps({"_id": q["id"], "text": q["query"]}) + "\n" for q in queries))
    (beir / "qrels" / "train.tsv").write_text("query-id\tcorpus-id\tscore\n" + "".join(
        f"{q['id']}\t{q['retrieval_ids'][0]}\t1\n" for q in queries))
    vocab = tmp_path / "vocab"
    vocab.mkdir()
    words = _VOCAB + list("abcdefghijklmnopqrstuvwxyz")
    (vocab / "vocab.txt").write_text("\n".join(words))
    ckpt = _checkpoint(tmp_path, vocab_size=len(words))
    cfg = tmp_path / "exp.yaml"
    cfg.write_text(f"""\
extends: [arch/v5e-1-large-qlora, optimizer/adafactor]
model: {{kind: ranker, gradients: retrieval, name_or_path: '{ckpt}', vocab_size: {len(words)}, hidden_size: 32,
        num_layers: 1, num_heads: 2, intermediate_size: 64, agg_method: mean, output_norm: l2, scaler: 10.0,
        learn_scaler: true}}
tokenizer: {{name_or_path: '{vocab}', max_length: 16}}
collate: {{prefetch_n_sections: 4, n_sections: 2, max_pos_sections: 1}}
search_defaults:
  dense: {{codec: flat, dtype: bfloat16, kernel: fused, fused_bins: 4}}
  sparse: {{max_postings: 16}}
trainer: {{max_steps: 2, period: 1, log_interval: 1, learning_rate: 1.0e-3}}
datasets:
  queries:
    - {{identifier: tiny-train, name_or_path: beir, subsets: ['{beir}'], split: train, link: tiny-corpus}}
  sections:
    - {{identifier: tiny-corpus, name_or_path: beir, subsets: ['{beir}']}}
""")
    code = (
        "import sys, json\n"
        f"for name in {BLOCKED!r}:\n"
        "    sys.modules[name] = None\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        "from vod_tpu_torch.exps import cli\n"
        "from vod_tpu_torch.models import QuantizedLeaf, kbit_params, load_hf_encoder\n"
        "from vod_tpu_torch.models.kbit import quantize_leaf\n"
        "from vod_tpu_torch.models.convert import flax_layout\n"
        f"out = cli.main(['--config', {str(cfg)!r}, '--device', 'cpu'])\n"
        "model, exp = out['model'], cli.Experiment.from_file(" f"{str(cfg)!r})\n"
        "kb = kbit_params(model)\n"
        "_, sd = load_hf_encoder(exp.model.name_or_path)\n"
        "checked = 0\n"
        "for name, leaf in kb.frozen.items():\n"
        "    if isinstance(leaf, QuantizedLeaf):\n"
        "        key = name.removeprefix('encoder.backbone.').replace('.base.', '.')\n"
        "        want = quantize_leaf(flax_layout(model, name).to_flax(sd[key]))\n"
        "        assert torch.equal(leaf.codes, want.codes) and torch.equal(leaf.scale, want.scale), name\n"
        "        checked += 1\n"
        "fresh = cli.build_model(exp.model, device='cpu', generator=torch.Generator().manual_seed(exp.sys.seed))\n"
        "init = dict(fresh.named_parameters())\n"
        "moved = sorted(n for n, p in kb.trainable.items() if not torch.equal(p, init[n]))\n"
        "blocked = " f"{BLOCKED!r}\n"
        "loaded = [m for m in sys.modules if m.split('.')[0] in blocked and sys.modules[m] is not None]\n"
        "print(json.dumps(dict(step=out['state'].step, accum=out['step_fn'].accumulate_grad_batches,\n"
        "    chunk=out['step_fn'].gradcache_chunk_rows, remat=model.cfg.remat, checked=checked,\n"
        "    moved=moved, trainable=sorted(kb.trainable), loaded=loaded,\n"
        "    optimizer=type(out['optimizer']).__name__)))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    lines = res.stdout.strip().splitlines()
    got = json.loads(lines[-1])
    logs = [line for line in lines if line.startswith("[")]
    assert len(logs) == 2 and "done: 2 steps" in res.stdout
    assert (got["step"], got["accum"], got["chunk"], got["remat"], got["optimizer"]) == (2, 8, 128, True, "Adafactor")
    assert got["checked"] == 3 + 3 * 2 + 1 + 2 and not got["loaded"]
    assert got["moved"] == got["trainable"] and len(got["trainable"]) == 5
    assert QuantizedLeaf is not None
