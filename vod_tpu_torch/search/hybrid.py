"""Hybrid engine composition (port of `vod_tpu/search/hybrid.py`, dense and lookup branches).

Every named engine searches the query batch; engine scores are min-subtracted
per row, the gold lookup rides along with score 0 and label 1, and the results
are merged by weighted score sum. The sparse engine, the compressed dense
codecs and `hybrid_search_and_sample` wait for later slices of the port.
"""

from __future__ import annotations

import dataclasses
import typing as typ

import torch

from vod_tpu_torch.ops.merge import merge_search_results
from vod_tpu_torch.ops.numpy_ops import normalize_scores
from vod_tpu_torch.types.retrieval import RetrievalBatch
from .base import SearchQueries
from .dense import DenseIndex, dense_search
from .lookup import lookup_search


@dataclasses.dataclass
class HybridEngines:
    """Named engine bundle. Only `DenseIndex` is ported; any other engine raises
    `NotImplementedError` when searched."""

    dense: typ.Optional[DenseIndex] = None
    sparse: typ.Any = None


def _dense_dispatch(index: typ.Any, queries: SearchQueries, top_k: int) -> RetrievalBatch:
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
        raise NotImplementedError("the sparse engine is not ported to vod_tpu_torch yet")
    if not results:
        raise ValueError("No engine matched the provided queries")

    w = {name: 1.0 for name in results}
    if weights:
        w.update({k: v for k, v in weights.items() if k in results})
    merged, raw = merge_search_results(results, w)
    raw.pop("lookup", None)
    return merged, raw
