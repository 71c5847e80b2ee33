"""Hybrid engine composition (port of `vod_tpu/search/hybrid.py`: dense, sparse and lookup).

Every named engine searches the query batch; engine scores are min-subtracted
per row, the gold lookup rides along with score 0 and label 1, and the results
are merged by weighted score sum. `hybrid_search_and_sample` adds the
truncation to the prefetch width and labeled priority sampling: the retrieval
segment of the training collate. The dense engine is a flat/int8
`DenseIndex`, a `PQIndex`, an `IVFIndex` or an `IVFPQIndex`; the sparse
engine is a BM25 `SparseIndex`. The sharded indexes (dense and sparse) wait
for later slices of the port.
"""

from __future__ import annotations

import dataclasses
import typing as typ

import torch

from vod_tpu_torch.ops.merge import merge_search_results
from vod_tpu_torch.ops.numpy_ops import normalize_scores
from vod_tpu_torch.ops.sample import PrioritySampledSections, sample_search_results
from vod_tpu_torch.types.retrieval import RetrievalBatch
from .base import SearchQueries
from .dense import DenseIndex, IVFIndex, PQIndex, dense_search, ivf_search, pq_search
from .ivfpq import IVFPQIndex, ivfpq_search
from .lookup import lookup_search
from .sparse import SparseIndex, sparse_search


@dataclasses.dataclass
class HybridEngines:
    """Named engine bundle. The dense engine is a `DenseIndex`, `PQIndex`,
    `IVFIndex` or `IVFPQIndex`, the sparse engine a `SparseIndex`; any other
    engine raises `NotImplementedError` when searched."""

    dense: typ.Optional[typ.Union[DenseIndex, PQIndex, IVFIndex, IVFPQIndex]] = None
    sparse: typ.Optional[SparseIndex] = None


def _dense_dispatch(index: typ.Any, queries: SearchQueries, top_k: int) -> RetrievalBatch:
    if isinstance(index, IVFPQIndex):
        return ivfpq_search(index, queries, top_k)
    if isinstance(index, PQIndex):
        return pq_search(index, queries, top_k)
    if isinstance(index, IVFIndex):
        return ivf_search(index, queries, top_k)
    if isinstance(index, DenseIndex):
        return dense_search(index, queries, top_k)
    raise NotImplementedError(f"{type(index).__name__} is not ported to vod_tpu_torch yet")


def hybrid_search(
    engines: HybridEngines,
    queries: SearchQueries,
    top_k: int,
    weights: typ.Optional[dict[str, torch.Tensor | float]] = None,
) -> tuple[RetrievalBatch, dict[str, torch.Tensor]]:
    """Search every engine, normalize, weighted-merge.

    Returns (merged batch sorted by combined score, per-engine raw scores
    aligned to the merged ids)."""
    results: dict[str, RetrievalBatch] = {}
    if queries.section_ids is not None:
        results["lookup"] = lookup_search(queries)
    if engines.dense is not None and queries.vector is not None:
        r = _dense_dispatch(engines.dense, queries, top_k)
        results["dense"] = r.replace(scores=normalize_scores(r.scores))
    if engines.sparse is not None and queries.terms is not None:
        if not isinstance(engines.sparse, SparseIndex):
            raise NotImplementedError(
                f"the sparse engine {type(engines.sparse).__name__} is not ported to vod_tpu_torch yet"
            )
        r = sparse_search(engines.sparse, queries, top_k)
        results["sparse"] = r.replace(scores=normalize_scores(r.scores))
    if not results:
        raise ValueError("No engine matched the provided queries")

    w = {name: 1.0 for name in results}
    if weights:
        w.update({k: v for k, v in weights.items() if k in results})
    merged, raw = merge_search_results(results, w)
    raw.pop("lookup", None)
    return merged, raw


def hybrid_search_and_sample(
    engines: HybridEngines,
    queries: SearchQueries,
    *,
    prefetch: int = 100,
    total: int = 8,
    max_pos_sections: int = 2,
    temperature: float = 1.0,
    max_support_size: typ.Optional[int] = None,
    weights: typ.Optional[dict[str, torch.Tensor | float]] = None,
    noise: typ.Optional[tuple[torch.Tensor, torch.Tensor]] = None,
    generator: typ.Optional[torch.Generator] = None,
) -> tuple[PrioritySampledSections, RetrievalBatch]:
    """search -> normalize -> merge -> truncate to `prefetch` -> labeled
    priority sampling. Returns (the samples, the truncated merged batch).

    Positives (gold lookup hits, label > 0) survive the truncation even when
    their combined score (the lookup contributes 0) falls below the engine
    scores: they sort first by a +1e30 key, in their merged order (a stable
    sort). `noise` is the sampler's Exp(1) draws, each `[B, min(prefetch,
    merged width)]`; without it they come from `generator`."""
    merged, raw = hybrid_search(engines, queries, prefetch, weights)
    k = min(prefetch, merged.scores.shape[-1])
    if merged.labels is not None:
        key = torch.where(merged.labels > 0, merged.scores + 1e30, merged.scores)
    else:
        key = merged.scores
    order = torch.argsort(-key, dim=-1, stable=True)[..., :k]
    merged = RetrievalBatch(
        scores=torch.gather(merged.scores, -1, order),
        indices=torch.gather(merged.indices, -1, order),
        labels=None if merged.labels is None else torch.gather(merged.labels, -1, order),
    )
    raw = {name: torch.gather(v, -1, order) for name, v in raw.items()}
    sampled = sample_search_results(
        search_results=merged,
        raw_scores=raw,
        total=total,
        max_pos_sections=max_pos_sections,
        temperature=temperature,
        max_support_size=max_support_size,
        noise=noise,
        generator=generator,
    )
    return sampled, merged
