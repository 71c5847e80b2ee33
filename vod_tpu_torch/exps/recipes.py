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

With `splade_doc_k` (a SPLADE Ranker) the learned-sparse index takes the
dense index's place: each period boundary encodes the corpus to its top
`splade_doc_k` impact terms (`models/splade.py:encode_corpus_terms`, chunk
by chunk on the device), rebuilds the impact postings (`build_impact_index`,
`n_terms` from a probe's width, at most `splade_max_postings` a term) and
trains against `HybridEngines(dense=None, sparse=learned)`; the benchmark
between periods searches the queries' top `splade_query_k` impact terms.

Random draws: where the JAX version splits its key into a build key, a tune
key and a loop key each period, the port draws all three from the one
`torch.Generator` it is given, in that order. `profile_dir` traces the
first period's loop only (`training_loop`'s window), as JAX does.

Over a mesh (`mesh`; `dp_axis` names the data-parallel axis, None for
none): the re-embed splits its chunks over `dp_axis` (or the mesh's `dp`
axis) and gathers the embeddings to every rank, the factory shards a
`dense.sharded` index over `dense.shard_axis`, the loops split the batches
over `dp_axis` (when it is set, as JAX passes the mesh to the loops only
then), and every rank passes a barrier after each rebuild. The autotuner
sweeps a sharded index on every rank in lockstep and every rank takes rank
0's choice; the learned-sparse reindex encodes each rank's block of the
corpus's impacts, gathers them, and every rank builds the same impact
index. Rank 0 writes the checkpoints.

The re-embed calls the model's `encode_field`, so a kbit-prepared model
(`models/kbit.py`) re-embeds through its dequantizing view, as JAX's
`full_params` gives it.

Each period's summary holds, beside JAX's `period`, `embed_s` (re-embed,
build and tuning), `autotune` (when tuned) and `period_s`: `reembed_s`,
`build_ms` by stage (the build's stages), `host_build` (whether the
host-slab branch ran), `index_bytes` and `train`, the loop's last logged
metrics; a SPLADE period has `reembed_s` (the impact encode),
`build_ms` (`total_ms`), `index_bytes` and `learned_terms` (the postings
table's width and the mean terms a document keeps). The device is
synchronized at those boundaries, once a period.
"""

from __future__ import annotations

import dataclasses
import pathlib
import time
import typing as typ

import numpy as np
import torch

from vod_tpu_torch.configs.search import DenseFactoryConfig
from vod_tpu_torch.models.splade import encode_corpus_terms, splade_topk_terms
from vod_tpu_torch.parallel.distributed import barrier
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
from vod_tpu_torch.search.sparse import build_impact_index


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
    model = step_fn.model
    device = corpus.input_ids.device
    history: list[dict] = []

    while not state.completed:
        pidx, start_step = state.pidx, state.step
        _sync(device)
        t0 = time.perf_counter()
        summary: dict[str, typ.Any] = {"period": pidx}

        # 1. re-embed the corpus with the current encoder, rebuild the index
        if cfg.splade_doc_k is not None:
            # learned-sparse reindex: the impact postings of the current encoder
            terms, weights = encode_corpus_terms(
                model.encode_field, corpus.input_ids, corpus.attention_mask, k=cfg.splade_doc_k, chunk=cfg.embed_chunk,
                mesh=cfg.mesh, dp_axis=cfg.dp_axis or "dp",
            )
            with torch.no_grad():
                n_terms = int(model.encode_field(corpus.input_ids[:1], corpus.attention_mask[:1]).shape[-1])
            summary["reembed_s"] = time.perf_counter() - t0
            t1 = time.perf_counter()
            learned = build_impact_index(
                terms, weights, n_terms=n_terms, max_postings=cfg.splade_max_postings,
                subset_ids=None if corpus.subset_ids is None else corpus.subset_ids.cpu().numpy(), device=device,
            )
            _sync(device)
            summary.update(build_ms={"total_ms": (time.perf_counter() - t1) * 1e3}, index_bytes=index_nbytes(learned),
                           learned_terms={"width": int(learned.postings_docs.shape[1]),
                                          "doc_terms_mean": float(np.mean(np.sum(terms >= 0, axis=1)))})
            engines = HybridEngines(dense=None, sparse=learned)
        elif cfg.dense is None:
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
                emb = compute_embeddings(
                    model.encode_field, corpus, chunk=cfg.embed_chunk, mesh=cfg.mesh, dp_axis=cfg.dp_axis or "dp"
                )
            _sync(device)
            summary["reembed_s"] = time.perf_counter() - t0
            build_ms: dict[str, float] = {}
            t1 = time.perf_counter()
            build = build_dense_from_host if host else build_dense_from_config
            dense = build(cfg.dense, emb, generator=generator, subset_ids=corpus.subset_ids, mesh=cfg.mesh,
                          device=device, timings=build_ms)
            _sync(device)
            barrier("rebuild")
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
            if cfg.splade_doc_k is not None:
                # learned-sparse queries: impacts -> top-k (terms, weights)
                bq = []
                for qb, imp in zip(benchmark_queries, q_vecs):
                    tq, wq = splade_topk_terms(imp, cfg.splade_query_k)
                    bq.append(dataclasses.replace(qb, terms=tq, term_weights=wq))
                summary["benchmark"] = benchmark_retrieval(engines, bq, metrics=cfg.metrics)
            else:
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
            mesh=cfg.mesh if cfg.dp_axis else None,
            dp_axis=cfg.dp_axis or "dp",
            profile_dir=cfg.profile_dir if pidx == 0 else None,
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
