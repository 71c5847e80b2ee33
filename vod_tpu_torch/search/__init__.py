"""Search engines (port of `vod_tpu/search/`: flat/int8, PQ and IVF dense indexes, lookup,
hybrid, and the config-driven dense factory)."""

from .base import SearchQueries, subset_mask
from .dense import (
    DenseIndex,
    IVFIndex,
    PQIndex,
    build_dense_index,
    build_ivf_index,
    build_pq_index,
    dense_search,
    ivf_search,
    pq_search,
)
from .factory import build_dense_from_config
from .hybrid import HybridEngines, hybrid_search, hybrid_search_and_sample
from .lookup import lookup_search

__all__ = [
    "DenseIndex",
    "HybridEngines",
    "IVFIndex",
    "PQIndex",
    "SearchQueries",
    "build_dense_from_config",
    "build_dense_index",
    "build_ivf_index",
    "build_pq_index",
    "dense_search",
    "hybrid_search",
    "hybrid_search_and_sample",
    "ivf_search",
    "lookup_search",
    "pq_search",
    "subset_mask",
]
