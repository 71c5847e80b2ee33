"""Search engines (port of `vod_tpu/search/`: flat/int8, PQ, IVF and IVF-PQ dense
indexes, the BM25 sparse index, lookup, hybrid, the config-driven factory with
its index cache and host-slab builds, and operating-point autotuning)."""

from .base import SearchQueries, subset_mask
from .dense import (
    DenseIndex,
    IVFIndex,
    PQIndex,
    build_dense_index,
    build_ivf_index,
    build_pq_index,
    build_pq_index_from_host,
    dense_search,
    ivf_search,
    pq_search,
)
from .autotune import OperatingPoint, autotune, autotune_after_build
from .factory import build_dense_from_config, build_dense_from_host, build_hybrid_engines, build_sparse_from_config
from .hybrid import HybridEngines, hybrid_search, hybrid_search_and_sample
from .ivfpq import IVFPQIndex, build_ivfpq_index, ivfpq_search
from .lookup import lookup_search
from .sparse import (
    SparseIndex,
    bm25_topk,
    build_impact_index,
    build_sparse_index,
    build_sparse_index_native,
    sparse_search,
)

__all__ = [
    "DenseIndex",
    "HybridEngines",
    "IVFIndex",
    "IVFPQIndex",
    "OperatingPoint",
    "PQIndex",
    "SearchQueries",
    "SparseIndex",
    "autotune",
    "autotune_after_build",
    "bm25_topk",
    "build_dense_from_config",
    "build_dense_from_host",
    "build_dense_index",
    "build_hybrid_engines",
    "build_impact_index",
    "build_ivf_index",
    "build_ivfpq_index",
    "build_pq_index",
    "build_pq_index_from_host",
    "build_sparse_from_config",
    "build_sparse_index",
    "build_sparse_index_native",
    "dense_search",
    "hybrid_search",
    "hybrid_search_and_sample",
    "ivf_search",
    "ivfpq_search",
    "lookup_search",
    "pq_search",
    "sparse_search",
    "subset_mask",
]
