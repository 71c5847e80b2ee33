"""The master recipe: periodic training with in-loop reindexing (port of
`vod_tpu/exps/recipes.py`).

While training is not done: re-embed the corpus with the current encoder ->
rebuild the dense index through the factory (`PeriodicTrainingConfig.dense`
names any ported codec: flat, int8, pq, ivf, ivfpq) -> optionally re-tune its
runtime knobs (`dense.autotune_target_recall`) -> optionally benchmark ->
train one period with live retrieval (`runtime/train.py:training_loop` until
the period's end) -> checkpoint.

When the `[N, H]` f32 embeddings would exceed `embed_hbm_budget_bytes` under
the pq, int8 or ivfpq codecs, the corpus is embedded into host RAM
(`compute_embeddings_to_host`) and the index built from host slabs
(`build_dense_from_host`); only the codes land on the device.

Random draws: where the JAX version splits its key into a build key, a tune
key and a loop key each period, the port draws all three from the one
`torch.Generator` it is given, in that order. Not ported yet, each raising
`NotImplementedError`: SPLADE reindexing (`splade_doc_k`), a device mesh
(`mesh`, `dp_axis`) and profiler traces (`profile_dir`).

Each period's summary holds, beside JAX's `period`, `embed_s` (re-embed,
build and tuning), `autotune` (when tuned) and `period_s`: `reembed_s`,
`build_ms` by stage (the build's stages), `host_build` (whether the
host-slab branch ran), `index_bytes` and `train`, the loop's last logged
metrics. The device is synchronized at those boundaries, once a period.
"""

from __future__ import annotations

import dataclasses
import pathlib
import time
import typing as typ

import torch

from vod_tpu_torch.configs.search import DenseFactoryConfig
from vod_tpu_torch.runtime.benchmark import benchmark_retrieval
from vod_tpu_torch.runtime.checkpoint import save_checkpoint
from vod_tpu_torch.runtime.collate import DeviceCorpus, QueryBatch
from vod_tpu_torch.runtime.predict import compute_embeddings, compute_embeddings_to_host
from vod_tpu_torch.runtime.state import TrainerState
from vod_tpu_torch.runtime.train import RealmTrainStep, training_loop
from vod_tpu_torch.search.dense import index_nbytes
from vod_tpu_torch.search.autotune import autotune_after_build
from vod_tpu_torch.search.factory import build_dense_from_config, build_dense_from_host
from vod_tpu_torch.search.hybrid import HybridEngines


@dataclasses.dataclass
class PeriodicTrainingConfig:
    embed_chunk: int = 512
    # above this many bytes of [N, H] f32 embeddings (pq/int8/ivfpq codecs)
    # the corpus is embedded into host RAM and the index built from host slabs
    embed_hbm_budget_bytes: int = 8 << 30
    # the dense-index factory config rebuilt every period; None disables the
    # dense engine
    dense: typ.Optional[DenseFactoryConfig] = dataclasses.field(default_factory=DenseFactoryConfig)
    splade_doc_k: typ.Optional[int] = None
    splade_max_postings: int = 4096
    splade_query_k: int = 64
    mesh: typ.Any = None
    dp_axis: typ.Optional[str] = None
    checkpoint_dir: typ.Optional[str] = None
    benchmark_on_init: bool = False
    benchmark_between_periods: bool = False
    log_interval: int = 50
    val_check_interval: typ.Optional[int] = None
    metrics: tuple[str, ...] = ("mrr", "ndcg_10", "hitrate_3")
    profile_dir: typ.Optional[str] = None


def _check_ported(cfg: PeriodicTrainingConfig) -> None:
    if cfg.splade_doc_k is not None:
        raise NotImplementedError("SPLADE periodic reindexing (splade_doc_k) is not ported to vod_tpu_torch yet")
    if cfg.mesh is not None or cfg.dp_axis is not None:
        raise NotImplementedError("training over a device mesh (mesh, dp_axis) is not ported to vod_tpu_torch yet")
    if cfg.profile_dir is not None:
        raise NotImplementedError("profiler traces (profile_dir) are not ported to vod_tpu_torch yet")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def periodic_training(
    *,
    step_fn: RealmTrainStep,
    corpus: DeviceCorpus,
    state: TrainerState,
    train_queries_fn: typ.Callable[[int], typ.Iterable[QueryBatch]],
    generator: torch.Generator,
    sparse_engine: typ.Any = None,
    val_queries: typ.Optional[typ.Sequence[QueryBatch]] = None,
    benchmark_queries: typ.Optional[typ.Sequence[QueryBatch]] = None,
    config: typ.Optional[PeriodicTrainingConfig] = None,
    on_log: typ.Optional[typ.Callable[[int, dict], None]] = None,
    callbacks: typ.Sequence[typ.Any] = (),
) -> tuple[TrainerState, list[dict]]:
    """Train `step_fn.model` with `step_fn.optimizer` until `state.completed`,
    re-embedding the corpus and rebuilding the dense index at every period
    boundary. `train_queries_fn(pidx)` yields that period's query batches;
    `callbacks` go to each period's `training_loop`. Returns (state, one
    summary per period)."""
    cfg = config or PeriodicTrainingConfig()
    _check_ported(cfg)
    model = step_fn.model
    device = corpus.input_ids.device
    history: list[dict] = []

    while not state.completed:
        pidx, start_step = state.pidx, state.step
        _sync(device)
        t0 = time.perf_counter()
        summary: dict[str, typ.Any] = {"period": pidx}

        # 1. re-embed the corpus with the current encoder, rebuild the index
        if cfg.dense is None:
            engines = HybridEngines(dense=None, sparse=sparse_engine)
        else:
            with torch.no_grad():
                dim = int(model.encode_field(corpus.input_ids[:1], corpus.attention_mask[:1]).shape[-1])
            host = corpus.size * dim * 4 > cfg.embed_hbm_budget_bytes and cfg.dense.codec in ("pq", "int8", "ivfpq")
            if host:
                emb: typ.Any = compute_embeddings_to_host(
                    model.encode_field, corpus.input_ids.cpu().numpy(), corpus.attention_mask.cpu().numpy(),
                    chunk=cfg.embed_chunk, device=device,
                )
            else:
                emb = compute_embeddings(model.encode_field, corpus, chunk=cfg.embed_chunk)
            _sync(device)
            summary["reembed_s"] = time.perf_counter() - t0
            build_ms: dict[str, float] = {}
            t1 = time.perf_counter()
            build = build_dense_from_host if host else build_dense_from_config
            dense = build(cfg.dense, emb, generator=generator, subset_ids=corpus.subset_ids, device=device,
                          timings=build_ms)
            _sync(device)
            build_ms["total_ms"] = (time.perf_counter() - t1) * 1e3
            summary.update(build_ms=build_ms, host_build=host, index_bytes=index_nbytes(dense))
            if cfg.dense.autotune_target_recall is not None:
                # re-tune the runtime knobs against this period's embeddings
                dense, tune_info = autotune_after_build(dense, cfg.dense, emb, generator=generator)
                if tune_info is not None:
                    summary["autotune"] = tune_info
            del emb
            engines = HybridEngines(dense=dense, sparse=sparse_engine)
        summary["embed_s"] = time.perf_counter() - t0

        # 2. optional between-period benchmark
        if benchmark_queries is not None and (
            cfg.benchmark_between_periods or (pidx == 0 and cfg.benchmark_on_init)
        ):
            with torch.no_grad():
                q_vecs = [model.encode_field(qb.input_ids, qb.attention_mask) for qb in benchmark_queries]
            summary["benchmark"] = benchmark_retrieval(
                engines, benchmark_queries, query_vectors=q_vecs, metrics=cfg.metrics
            )

        # 3. train for one period with live retrieval
        state, last = training_loop(
            step_fn=step_fn,
            engines=engines,
            corpus=corpus,
            train_queries=train_queries_fn(pidx),
            state=state,
            generator=generator,
            val_queries=val_queries,
            val_check_interval=cfg.val_check_interval,
            log_interval=cfg.log_interval,
            metrics=cfg.metrics,
            on_log=on_log,
            callbacks=callbacks,
            until_step=state.next_period_start_step,
        )
        if state.step == start_step and not state.completed:
            raise RuntimeError(f"period {pidx} took no optimizer step: train_queries_fn({pidx}) yielded too few batches")
        summary["train"] = last
        _sync(device)
        summary["period_s"] = time.perf_counter() - t0
        history.append(summary)

        # 4. checkpoint at the period boundary
        if cfg.checkpoint_dir:
            save_checkpoint(
                pathlib.Path(cfg.checkpoint_dir) / f"period-{pidx}",
                model=model, optimizer=step_fn.optimizer, state=state, generator=generator,
            )
        del engines
    return state, history
