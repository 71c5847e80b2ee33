"""Retrieval benchmarking without a gradient step (port of
`vod_tpu/runtime/benchmark.py`): the hybrid engine over query batches, with
retrieval metrics per score key (combined `score`, `sparse`, `dense`) against
the gold labels."""

from __future__ import annotations

import typing as typ

import torch

from vod_tpu_torch.models.monitoring import RetrievalMonitor
from vod_tpu_torch.search.base import SearchQueries
from vod_tpu_torch.search.hybrid import HybridEngines, hybrid_search
from .collate import QueryBatch

_SCORE_KEYS = ("score", "sparse", "dense")


@torch.no_grad()
def benchmark_retrieval(
    engines: HybridEngines,
    query_batches: typ.Sequence[QueryBatch],
    *,
    query_vectors: typ.Optional[typ.Sequence[torch.Tensor]] = None,
    top_k: int = 100,
    metrics: typ.Sequence[str] = ("ndcg_10", "mrr_10", "hitrate_3", "recall_50"),
    weights: typ.Optional[dict[str, float]] = None,
    reranker: typ.Optional[typ.Callable[[int, typ.Any], torch.Tensor]] = None,
) -> dict[str, dict[str, float]]:
    """Run the hybrid engine over query batches; metrics per score key.
    `reranker(batch_index, merged) -> [B, K] scores` adds the key "rerank"."""
    keys = _SCORE_KEYS + (("rerank",) if reranker is not None else ())
    monitors = {k: RetrievalMonitor(list(metrics)) for k in keys}
    for bi, qb in enumerate(query_batches):
        sq = SearchQueries(
            vector=None if query_vectors is None else query_vectors[bi],
            terms=qb.terms,
            term_weights=qb.term_weights,
            subset_ids=qb.subset_ids,
            section_ids=qb.section_ids,
            shard=qb.shard,
        )
        merged, raw = hybrid_search(engines, sq, top_k, weights)
        rel = torch.clamp(merged.labels, min=0) if merged.labels is not None else torch.zeros_like(merged.indices)
        for key in keys:
            if key == "score":
                scores = merged.scores
            elif key == "rerank":
                scores = reranker(bi, merged)
            elif key in raw:
                scores = raw[key]
            else:
                continue
            monitors[key].update(relevances=rel, scores=scores)
    return {k: m.compute() for k, m in monitors.items() if m._state is not None}
