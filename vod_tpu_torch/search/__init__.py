"""Search engines (port of `vod_tpu/search/`: flat/int8, PQ, IVF and IVF-PQ dense
indexes, the BM25 and learned-impact sparse index, lookup, hybrid, the
config-driven factory with its index cache and host-slab builds,
operating-point autotuning, the mutable dense store, the MaxSim
late-interaction reranker, and the sharded flat/int8 and BM25 indexes over a
mesh axis)."""

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
from .dynamic import (
    DynamicDenseIndex,
    dynamic_add,
    dynamic_compact,
    dynamic_delete,
    dynamic_from_dense,
    dynamic_index_init,
    dynamic_search,
    dynamic_update,
)
from .factory import build_dense_from_config, build_dense_from_host, build_hybrid_engines, build_sparse_from_config
from .hybrid import HybridEngines, hybrid_search, hybrid_search_and_sample
from .ivfpq import IVFPQIndex, build_ivfpq_index, ivfpq_search
from .lookup import lookup_search
from .maxsim import MaxSimIndex, build_maxsim_index, maxsim_rerank, maxsim_search
from .sharded import (
    ShardedDenseIndex,
    ShardedSparseIndex,
    build_sharded_dense_index,
    shard_sparse_index,
    sharded_dense_search,
    sharded_sparse_search,
)
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
    "DynamicDenseIndex",
    "HybridEngines",
    "IVFIndex",
    "IVFPQIndex",
    "MaxSimIndex",
    "OperatingPoint",
    "PQIndex",
    "SearchQueries",
    "ShardedDenseIndex",
    "ShardedSparseIndex",
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
    "build_maxsim_index",
    "build_pq_index",
    "build_pq_index_from_host",
    "build_sharded_dense_index",
    "build_sparse_from_config",
    "build_sparse_index",
    "build_sparse_index_native",
    "dense_search",
    "dynamic_add",
    "dynamic_compact",
    "dynamic_delete",
    "dynamic_from_dense",
    "dynamic_index_init",
    "dynamic_search",
    "dynamic_update",
    "hybrid_search",
    "hybrid_search_and_sample",
    "ivf_search",
    "ivfpq_search",
    "lookup_search",
    "maxsim_rerank",
    "maxsim_search",
    "pq_search",
    "shard_sparse_index",
    "sharded_dense_search",
    "sharded_sparse_search",
    "sparse_search",
    "subset_mask",
]
