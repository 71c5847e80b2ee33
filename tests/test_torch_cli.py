"""The port's experiment runner and CLI (`vod_tpu_torch/exps/cli.py`) against
the JAX package's, mirroring `tests/test_exps.py`: `build_model` per kind and
reader, the effective-batch accounting, `resume_from` and `main`, the
unported options (each raises `NotImplementedError` naming its ROADMAP item
before any data loads), and the first optimizer steps of `run_experiment`
from one config with JAX's initial weights carried across
(`models/convert.py`): the logged losses agree within 1e-5 (f32 activations
on both sides, sampling temperature 0 so that no random draw enters).

A subprocess runs the CLI with JAX, flax, optax, `vod_tpu`, pydantic, PyYAML,
`transformers`, `tokenizers`, `datasets` and tensorstore blocked: what the
card's machine has is enough."""

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

from tests.helpers import _VOCAB, tiny_tokenizer
from tests.test_exps import _toy_data
from vod_tpu.exps import cli as jax_cli
from vod_tpu.exps.structconf import Experiment as JaxExperiment
from vod_tpu_torch.data.tokenizer import WordPieceTokenizer
from vod_tpu_torch.exps import cli
from vod_tpu_torch.exps.structconf import Experiment, ModelConfig
from vod_tpu_torch.models import Ranker, Realm, Seq2SeqRealm, system_flax_to_state_dict

ROOT = Path(__file__).resolve().parent.parent
FIXTURE = ROOT / "tests" / "fixtures" / "beir_tiny"
ATOL = 1e-5
TINY = dict(hidden_size=32, num_layers=1, num_heads=2, intermediate_size=64, lm_hidden_size=32, lm_num_layers=1)


def _port_tok() -> WordPieceTokenizer:
    return WordPieceTokenizer(_VOCAB)


def _raw(**over) -> dict:
    raw = {
        "model": {"kind": "ranker", "gradients": "retrieval", "vocab_size": len(_VOCAB), **TINY},
        "tokenizer": {"max_length": 16},
        "collate": {"prefetch_n_sections": 8, "n_sections": 2, "max_pos_sections": 1},
        "dataloader": {"batch_size": 4},
        "search_defaults": {"dense": {"codec": "flat", "dtype": "float32", "approx_recall": None}},
        "trainer": {"max_steps": 2, "period": 2, "log_interval": 1},
        "sys": {"mesh_shape": [1]},
    }
    for k, v in over.items():
        raw[k] = {**raw.get(k, {}), **v}
    return raw


@pytest.mark.parametrize("kind,reader,cls", [("ranker", "causal", Ranker), ("realm", "causal", Realm),
                                             ("realm", "seq2seq", Seq2SeqRealm)])
def test_build_model_per_kind_and_reader(kind: str, reader: str, cls) -> None:
    cfg = ModelConfig(kind=kind, reader=reader, gradients="vod", vod_alpha=0.5, vocab_size=len(_VOCAB), **TINY)
    model = cli.build_model(cfg, proposal_temperature=0.7, device="cpu", generator=torch.Generator().manual_seed(0))
    jmodel = jax_cli.build_model(jax_cli.ModelConfig(**cfg.to_dict()), proposal_temperature=0.7)
    assert isinstance(model, cls) and type(jmodel).__name__ == cls.__name__
    assert model.gradients.alpha == jmodel.gradients.alpha and model.gradients.proposal_temperature == 0.7
    for f in ("vocab_size", "hidden_size", "num_layers", "num_heads", "intermediate_size"):
        assert getattr(model.cfg, f) == getattr(jmodel.cfg, f), f
    assert model.cfg.pooler.scaler == jmodel.cfg.pooler.scaler
    if reader == "seq2seq":
        assert model.reader_cfg.head_dim * model.reader_cfg.num_heads == 32
    if kind == "realm" and reader == "causal":
        assert model.lm_cfg.hidden_size == jmodel.lm_cfg.hidden_size == 32
    assert next(model.parameters()).device.type == "cpu"


def _capture_jax_init(monkeypatch) -> dict:
    seen = {}
    real = jax_cli._maybe_port_hf_encoder

    def capture(params, cfg):
        seen["params"] = jax.device_get(params)
        return real(params, cfg)

    monkeypatch.setattr(jax_cli, "_maybe_port_hf_encoder", capture)
    return seen


def _carry_into_port(monkeypatch, seen: dict) -> None:
    def load(model, cfg):
        model.load_state_dict(system_flax_to_state_dict(seen["params"]))
        return model

    monkeypatch.setattr(cli, "_maybe_port_hf_lm", load)


def _f32(monkeypatch) -> None:
    from vod_tpu.models import TransformerEncoderConfig as JaxEnc

    monkeypatch.setattr(jax_cli, "TransformerEncoderConfig", functools.partial(JaxEnc, dtype=jnp.float32))
    monkeypatch.setattr(cli, "TransformerEncoderConfig", functools.partial(cli.TransformerEncoderConfig,
                                                                           dtype=torch.float32))


@pytest.mark.parametrize("optimizer", ["adamw", "sgd"])
def test_first_steps_of_run_experiment_match_jax(monkeypatch, optimizer: str) -> None:
    """One config through both runners: the same corpus arrays, BM25 index,
    batches and initial weights; the first step's loss (and, under SGD, the
    second's) agree within 1e-5, and so does the monitor's first mrr."""
    sections, queries = _toy_data(n_sections=24, n_queries=16)
    raw = _raw(collate={"temperature": 0.0},
               trainer={"optimizer": optimizer, "learning_rate": 0.5 if optimizer == "sgd" else 1e-3,
                        "weight_decay": 0.01, "max_steps": 2, "period": 2,
                        "parameters": {"dense": {"mode": "constant", "value": 1.0},
                                       "sparse": {"mode": "constant", "value": 0.5}}})
    _f32(monkeypatch)
    seen = _capture_jax_init(monkeypatch)
    jlogs, tlogs = [], []
    jax_cli.run_experiment(JaxExperiment.parse(raw), sections=sections, queries=queries, tokenizer=tiny_tokenizer(),
                           on_log=lambda s, m: jlogs.append(m))
    _carry_into_port(monkeypatch, seen)
    out = cli.run_experiment(Experiment.parse(raw), sections=sections, queries=queries, tokenizer=_port_tok(),
                             on_log=lambda s, m: tlogs.append(m), device="cpu")
    assert out["state"].step == 2 and len(jlogs) == len(tlogs) == 2
    n = 2 if optimizer == "sgd" else 1
    for j, t in zip(jlogs[:n], tlogs[:n]):
        assert t["loss"] == pytest.approx(j["loss"], abs=ATOL)
        assert t["parameters/sparse"] == j["parameters/sparse"] == 0.5
    assert tlogs[0]["mrr"] == pytest.approx(jlogs[0]["mrr"], abs=ATOL)


def test_effective_batch_accounting_infers_accumulation() -> None:
    """`trainer.batch_size` drives the loader's batch and infers
    accumulate_grad_batches = ceil(effective / per_device): 32 / 8 -> 4."""
    sections = [{"id": f"s{i}", "content": f"paris capital france tok{i}", "title": "t", "subset_id": None}
                for i in range(12)]
    queries = [{"id": f"q{i}", "query": f"capital of france tok{i % 12}", "answers": [], "answer_scores": [],
                "retrieval_ids": [f"s{i % 12}"], "retrieval_scores": [1.0], "subset_ids": []} for i in range(16)]
    raw = _raw(dataloader={"batch_size": 16}, trainer={"max_steps": 2, "period": None,
                                                       "batch_size": {"effective": 32, "per_device": 8}})
    out = cli.run_experiment(Experiment.parse(raw), sections=sections, queries=queries, tokenizer=_port_tok(),
                             device="cpu")
    assert out["state"].step == 2 and out["step_fn"].accumulate_grad_batches == 4
    assert out["state"].accumulate_grad_batches == 4
    # pinned by hand, accumulation stays; per_device alone keeps the default effective 32
    raw2 = _raw(trainer={"max_steps": 1, "period": None, "accumulate_grad_batches": 2,
                         "batch_size": {"per_device": 4}})
    out2 = cli.run_experiment(Experiment.parse(raw2), sections=sections, queries=queries, tokenizer=_port_tok(),
                              device="cpu")
    assert out2["step_fn"].accumulate_grad_batches == 2


def test_resume_from_continues_the_run(tmp_path: Path) -> None:
    sections, queries = _toy_data(n_sections=16, n_queries=16)
    raw = _raw(trainer={"checkpoint_path": str(tmp_path / "run"), "lr_schedule": {"kind": "linear", "warmup_steps": 1}})
    out1 = cli.run_experiment(Experiment.parse(raw), sections=sections, queries=queries, tokenizer=_port_tok(),
                              device="cpu")
    assert out1["state"].step == 2
    assert (tmp_path / "run" / "period-0" / "trainer_state.json").exists()
    saved = json.loads((tmp_path / "run" / "config.json").read_text())
    assert saved == json.loads(JaxExperiment.parse(raw).model_dump_json())
    raw2 = {**raw, "trainer": {**raw["trainer"], "max_steps": 4}}
    out2 = cli.run_experiment(Experiment.parse(raw2), sections=sections, queries=queries, tokenizer=_port_tok(),
                              resume_from=str(tmp_path / "run"), device="cpu")
    assert out2["state"].step == 4 and out2["state"].update_steps == 4
    assert len(out2["history"]) == 1  # only the remaining period ran
    # the schedule resumes at update 2 of 4 (warmup 1, then linear decay to 0)
    want = JaxExperiment.parse(raw2).trainer.lr_schedule.instantiate(raw["trainer"].get("learning_rate", 1e-4), 4)
    assert out2["optimizer"].param_groups[0]["lr"] == pytest.approx(float(want(3)), rel=1e-6)
    with pytest.raises(FileNotFoundError):
        cli._latest_checkpoint_dir(str(tmp_path / "nothing"))
    assert cli._latest_checkpoint_dir(str(tmp_path / "run")).name == "period-1"


def _write_cli_inputs(tmp: Path, steps: int = 2) -> Path:
    """A BeIR directory from the fixture (train split), a vocab directory and
    a config naming both."""
    beir = tmp / "beir"
    (beir / "qrels").mkdir(parents=True)
    for name in ("corpus.jsonl", "queries.jsonl"):
        (beir / name).write_text((FIXTURE / name).read_text())
    (beir / "qrels" / "train.tsv").write_text((FIXTURE / "qrels" / "test.tsv").read_text())
    vocab = tmp / "vocab"
    vocab.mkdir()
    (vocab / "vocab.txt").write_text("\n".join(_VOCAB + list("abcdefghijklmnopqrstuvwxyz")))
    cfg = tmp / "exp.yaml"
    cfg.write_text(f"""\
extends: [model/realm-vod]
model: {{vocab_size: {len(_VOCAB) + 26}, hidden_size: 32, num_layers: 1, num_heads: 2, intermediate_size: 64,
        lm_hidden_size: 32, lm_num_layers: 1}}
tokenizer: {{name_or_path: '{vocab}', max_length: 16}}
collate: {{prefetch_n_sections: 4, n_sections: 2, max_pos_sections: 1}}
dataloader: {{batch_size: 2}}
search_defaults:
  dense: {{codec: flat, dtype: bfloat16, kernel: fused, fused_bins: 4}}
  sparse: {{max_postings: 16}}
trainer:
  max_steps: {steps}
  period: 1
  log_interval: 1
  accumulate_grad_batches: 2
  batch_size: {{effective: 4, per_device: 2}}
  learning_rate: 5.0e-5
  checkpoint_path: '{tmp / "run"}'
  parameters:
    dense: {{mode: linear, start: 0.0, value: 1.0, period: 20000}}
    sparse: {{mode: constant, value: 1.0}}
datasets:
  queries:
    - {{identifier: tiny-train, name_or_path: beir, subsets: ['{beir}'], split: train, link: tiny-corpus}}
  sections:
    - {{identifier: tiny-corpus, name_or_path: beir, subsets: ['{beir}']}}
""")
    return cfg


def test_main_runs_and_resumes_from_a_config_file(tmp_path: Path, capsys) -> None:
    cfg = _write_cli_inputs(tmp_path)
    out = cli.main(["--config", str(cfg), "--device", "cpu"])
    assert out["state"].step == 2 and len(out["history"]) == 2
    assert isinstance(out["model"], Realm)
    assert "done: 2 steps" in capsys.readouterr().out
    want = JaxExperiment.from_file(str(cfg)).model_dump()
    assert json.loads((tmp_path / "run" / "config.json").read_text()) == json.loads(json.dumps(want))
    out2 = cli.main(["--resume_from", str(tmp_path / "run"), "--max_steps", "3", "--device", "cpu"])
    assert out2["state"].step == 3 and len(out2["history"]) == 1
    assert cli.parser().parse_args([]).device == "cuda"
    import inspect

    assert inspect.signature(cli.run_experiment).parameters["device"].default == "cuda"
    from vod_tpu_torch.dataloaders import RealmDataloader

    assert inspect.signature(RealmDataloader).parameters["device"].default == "cuda"


UNPORTED = {
    "moe": ({"model": {"moe_experts": 4, "moe_top_k": 2, "moe_capacity_factor": 2.0}}, "item 6"),
    "profile": ({"sys": {"profile_dir": "trace"}}, "item 7"),
}
# items of UNPORTED that have since been ported: the option reaches the model
# (item 6) or the run (item 7)
PORTED = {"item 6", "item 7"}


@pytest.mark.parametrize("over,item", UNPORTED.values(), ids=UNPORTED.keys())
def test_unported_option_raises_before_data_loads(over: dict, item: str, tmp_path: Path) -> None:
    raw = _raw()
    for k, v in over.items():
        raw[k] = {**raw.get(k, {}), **v}
    if item == "item 7":  # profile traces: 4 steps reach the loop's default window (3, 6)
        from tests.test_exps import _toy_data

        raw["sys"]["profile_dir"] = str(tmp_path / "trace")
        raw["trainer"] = {**raw["trainer"], "max_steps": 4, "period": 4}
        sections, queries = _toy_data(n_sections=16, n_queries=16)
        exp = Experiment.parse(raw)
        cli.check_ported(exp, "cpu")
        out = cli.run_experiment(exp, sections=sections, queries=queries, tokenizer=_port_tok(), device="cpu")
        assert out["state"].step == 4 and len(list((tmp_path / "trace").glob("trace-rank0-*.json"))) == 1
        return
    if item in PORTED:  # MoE: the three options reach every encoder layer
        from vod_tpu_torch.parallel.moe import MoEFFN

        exp = Experiment.parse(raw)
        cli.check_ported(exp, "cpu")
        enc = cli.build_model(exp.model, device="cpu").encoder
        assert (enc.cfg.moe_experts, enc.cfg.moe_top_k, enc.cfg.moe_capacity_factor) == (4, 2, 2.0)
        assert all(isinstance(layer.moe, MoEFFN) and layer.moe.top_k == 2 for layer in enc.backbone.layers)
        return

    def loader(**kw):
        raise AssertionError("data was loaded before the option was refused")

    raw["datasets"] = {"queries": [{"identifier": "q", "name_or_path": loader, "link": "s"}],
                       "sections": [{"identifier": "s", "name_or_path": loader}]}
    with pytest.raises(NotImplementedError, match=f"ROADMAP §A {item}"):
        cli.run_experiment(Experiment.parse(raw), tokenizer=_port_tok(), device="cpu")


def test_mesh_and_multi_process_launch_raise(monkeypatch) -> None:
    """A mesh is ported: one process (one rank) runs without one, as JAX does
    on one device, whatever the devices. A multi-process launch needs a
    coordinator or torchrun's environment (`tests/test_torch_cli_mesh.py`
    runs two ranks)."""
    for name in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    exp = Experiment.parse(_raw(sys={"mesh_shape": [2, 2], "mesh_axes": ["dp", "shard"]}))
    cli.check_ported(exp, "cuda")
    cli.check_ported(exp, "cpu")
    cli.check_ported(Experiment.parse(_raw(sys={"mesh_shape": [1]})), "cuda")
    with pytest.raises(ValueError, match="coordinator"):
        cli.main(["--config", "x.yaml", "--num_processes", "2", "--device", "cpu"])


BLOCKED = ("jax", "jaxlib", "flax", "optax", "vod_tpu", "pydantic", "yaml", "transformers", "tokenizers",
           "datasets", "tensorstore")


def test_cli_runs_with_only_what_the_card_machine_has(tmp_path: Path) -> None:
    cfg = _write_cli_inputs(tmp_path)
    code = (
        "import sys\n"
        f"for name in {BLOCKED!r}:\n"
        "    sys.modules[name] = None\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        "from vod_tpu_torch.exps.cli import main\n"
        f"out = main(['--config', {str(cfg)!r}, '--device', 'cpu'])\n"
        "assert out['state'].step == 2, out['state']\n"
        f"blocked = {BLOCKED!r}\n"
        "loaded = [m for m in sys.modules if m.split('.')[0] in blocked and sys.modules[m] is not None]\n"
        "assert not loaded, loaded\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().endswith("ok") and "done: 2 steps" in res.stdout
    logs = [line for line in res.stdout.splitlines() if line.startswith("[")]
    assert len(logs) == 2 and all(np.isfinite(float(line.split("'loss': ")[1].split(",")[0])) for line in logs)
