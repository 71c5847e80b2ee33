"""Search engines (port of `vod_tpu/search/`: flat/int8 dense, lookup, hybrid)."""

from .base import SearchQueries, subset_mask
from .dense import DenseIndex, build_dense_index, dense_search
from .hybrid import HybridEngines, hybrid_search
from .lookup import lookup_search

__all__ = [
    "DenseIndex",
    "HybridEngines",
    "SearchQueries",
    "build_dense_index",
    "dense_search",
    "hybrid_search",
    "lookup_search",
    "subset_mask",
]
