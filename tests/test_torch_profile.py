"""The port's profiler traces (`runtime/train.py:training_loop(profile_dir=)`,
`exps/recipes.py`), the counterpart of `tests/test_runtime.py::
test_profiler_trace_hook`.

JAX writes an xplane trace of the loop-local steps `[profile_steps[0],
profile_steps[1])`; the port writes one Chrome trace JSON per rank of the
same window, with one `train_step` span per optimizer step and one
`fused_mips_binned` span per kernel call. A one-layer `Ranker` (hidden 32,
f32) over the separable topic task of `tests/test_torch_train.py` trains on
the CPU with the flat index's `kernel: fused` (the plain version there).
Tracing changes nothing: the parameters after the loop are bit-equal with
and without it. The loop itself is held to JAX's by
`tests/test_torch_train.py`.
"""

import json
from pathlib import Path

import numpy as np
import torch

from tests.test_torch_train import _ranker_cfg, _topic_task
from tests.torch_helpers import CPU
from vod_tpu_torch.exps import PeriodicTrainingConfig, periodic_training
from vod_tpu_torch.models import Ranker, RetrievalGradients
from vod_tpu_torch.ops import mips
from vod_tpu_torch.runtime import (
    QueryBatch,
    TrainerState,
    adamw,
    build_device_corpus,
    compute_embeddings,
    make_train_step,
    training_loop,
)
from vod_tpu_torch.search import HybridEngines, build_dense_index

STEP = dict(prefetch=16, n_sections=4, max_pos_sections=1)


def _queries(make_queries, n: int, first: int = 0) -> list[QueryBatch]:
    qs = [make_queries(4, first + i) for i in range(n)]
    return [QueryBatch(torch.from_numpy(i), torch.ones_like(torch.from_numpy(i)), section_ids=torch.from_numpy(g))
            for i, g in qs]


def _setup():
    sec, make_queries = _topic_task(0)
    _, tcfg = _ranker_cfg()
    model = Ranker(tcfg, RetrievalGradients(), device=CPU, generator=torch.Generator().manual_seed(0))
    corpus = build_device_corpus(sec, np.ones_like(sec), device=CPU)
    emb = compute_embeddings(model.encode_field, corpus, chunk=32)
    engines = HybridEngines(dense=build_dense_index(emb, dtype="float32", kernel="fused", device=CPU))
    step = make_train_step(model, adamw(model, 1e-3, weight_decay=0.0), **STEP)
    return step, corpus, engines, make_queries


class _StepOfCall:
    """Counts the `fused_mips_binned` calls of each optimizer step."""

    def __init__(self):
        self.step, self.calls = None, {}

    def on_train_batch_start(self, batch, step):
        self.step = step

    def __getattr__(self, hook):
        return lambda **kw: None


def _spans(trace: Path, name: str) -> list[dict]:
    events = json.loads(trace.read_text())["traceEvents"]
    return [e for e in events if e.get("name") == name and e.get("ph") == "X"]


def _run(tmp_path: Path, profile_dir, monkeypatch=None):
    step, corpus, engines, make_queries = _setup()
    seen = _StepOfCall()
    if monkeypatch is not None:
        real = mips.binned_cells_reference

        def counted(*args, **kw):
            seen.calls[seen.step] = seen.calls.get(seen.step, 0) + 1
            return real(*args, **kw)

        monkeypatch.setattr(mips, "binned_cells_reference", counted)
    training_loop(step_fn=step, engines=engines, corpus=corpus, train_queries=_queries(make_queries, 3),
                  state=TrainerState(max_steps=3, period=3), generator=torch.Generator().manual_seed(1),
                  prefetch_batches=0, callbacks=[seen], profile_dir=profile_dir, profile_steps=(1, 2))
    return step.model, seen


def test_training_loop_writes_the_window_trace(tmp_path: Path, monkeypatch) -> None:
    _, seen = _run(tmp_path, str(tmp_path / "trace"), monkeypatch)
    (trace,) = (tmp_path / "trace").iterdir()
    assert trace.name.startswith("trace-rank0-") and trace.suffix == ".json"
    (span,) = _spans(trace, "train_step")  # loop-local step 1 only
    calls = _spans(trace, "fused_mips_binned")
    assert seen.calls[1] >= 1 and len(calls) == seen.calls[1], (seen.calls, len(calls))
    for c in calls:
        assert span["ts"] <= c["ts"] and c["ts"] + c["dur"] <= span["ts"] + span["dur"]


def test_tracing_leaves_the_parameters_bit_equal(tmp_path: Path) -> None:
    traced, _ = _run(tmp_path, str(tmp_path / "trace"))
    plain, _ = _run(tmp_path, None)
    assert len(list((tmp_path / "trace").iterdir())) == 1
    for (name, a), b in zip(traced.state_dict().items(), plain.state_dict().values()):
        assert torch.equal(a, b), name


def test_the_recipe_traces_the_first_period_only(tmp_path: Path) -> None:
    """Two periods of 4 steps at JAX's default window (3, 6): the first
    period's loop ends inside the window, so its trace holds loop-local step
    3 and is written when the loop ends; the second period writes none."""
    step, corpus, _, make_queries = _setup()
    cfg = PeriodicTrainingConfig(dense=PeriodicTrainingConfig().dense, profile_dir=str(tmp_path / "trace"))
    state, history = periodic_training(
        step_fn=step, corpus=corpus, state=TrainerState(max_steps=8, period=4),
        train_queries_fn=lambda p: _queries(make_queries, 4, 100 * p), generator=torch.Generator().manual_seed(2),
        config=cfg,
    )
    assert state.step == 8 and len(history) == 2
    (trace,) = (tmp_path / "trace").iterdir()
    assert len(_spans(trace, "train_step")) == 1
