"""Index builds from the factory configs (port of `vod_tpu/search/factory.py`:
`build_dense_from_config`, `build_sparse_from_config`, `build_hybrid_engines`).

Dense codecs flat, int8, pq and ivf are built on the device; the BM25 index
is built on the host by the native postings builder and moved to the device.
Not ported yet, each raising `NotImplementedError`: the ivfpq codec,
sharding over a mesh (`sharded`, `mesh`, for both engines), the
fingerprint-keyed index cache (`cache_dir`) and the host-slab build
`build_dense_from_host`.
"""

from __future__ import annotations

import typing as typ

import numpy as np
import torch

from vod_tpu_torch.configs.search import DenseFactoryConfig, HybridSearchFactoryConfig, SparseFactoryConfig
from .dense import build_dense_index, build_ivf_index, build_pq_index
from .hybrid import HybridEngines
from .sparse import SparseIndex, build_sparse_index_native


def build_dense_from_config(
    cfg: DenseFactoryConfig,
    vectors: typ.Union[torch.Tensor, np.ndarray],
    *,
    generator: typ.Optional[torch.Generator] = None,
    subset_ids: typ.Union[torch.Tensor, np.ndarray, None] = None,
    cache_dir: typ.Optional[str] = None,
    data_fingerprint: typ.Optional[str] = None,
    mesh: typ.Any = None,
    device: typ.Union[str, torch.device] = "cuda",
    timings: typ.Optional[dict] = None,
) -> typ.Any:
    """Build the dense index `cfg` names over `vectors`, on `device`.

    The pq and ivf builds draw from `generator` (default: seed 0 on the
    device, as the JAX factory defaults to `PRNGKey(0)`). `timings`, when
    given, receives the pq build's wall ms by stage (`build_pq_index`)."""
    del data_fingerprint  # keys the cache, which is not ported
    if cache_dir is not None:
        raise NotImplementedError("the index cache (cache_dir) is not ported to vod_tpu_torch yet")
    if cfg.sharded or mesh is not None:
        raise NotImplementedError("sharded dense indexes (sharded, mesh) are not ported to vod_tpu_torch yet")
    if cfg.codec in ("flat", "int8"):
        # flat/int8 + refine='float32' keeps exact f32 rows for a k_factor*k re-rank
        return build_dense_index(
            vectors, subset_ids=subset_ids, dtype="int8" if cfg.codec == "int8" else cfg.dtype,
            approx_recall=cfg.approx_recall, kernel=cfg.kernel,
            refine="float32" if cfg.refine == "float32" else "none", k_factor=cfg.k_factor, device=device,
        )
    if cfg.codec == "pq":
        return build_pq_index(
            vectors,
            n_subquantizers=cfg.n_subquantizers,
            code_bits=cfg.code_bits,
            coarse_dim=cfg.coarse_dim,
            n_candidates=cfg.n_candidates,
            train_size=cfg.train_size,
            kmeans_iters=cfg.kmeans_iters,
            use_opq=cfg.use_opq,
            opq_iters=cfg.opq_iters,
            refine=cfg.refine,
            refine_dim=cfg.refine_dim,
            k_factor=cfg.k_factor,
            subset_ids=subset_ids,
            approx_recall=cfg.approx_recall,
            aniso_eta=cfg.aniso_eta,
            keep_codes=cfg.keep_codes,
            kernel=cfg.kernel,
            fused_bins=cfg.fused_bins,
            fused_tile=cfg.fused_tile,
            generator=generator,
            device=device,
            timings=timings,
        )
    if cfg.codec == "ivf":
        return build_ivf_index(
            vectors, n_clusters=cfg.n_clusters, nprobe=cfg.nprobe, kmeans_iters=cfg.kmeans_iters,
            train_size=cfg.train_size, dtype=cfg.dtype, subset_ids=subset_ids, generator=generator, device=device,
        )
    if cfg.codec == "ivfpq":
        raise NotImplementedError("the ivfpq codec (search/ivfpq.py) is not ported to vod_tpu_torch yet")
    raise ValueError(f"Unknown dense codec {cfg.codec!r}")


def build_dense_from_host(cfg: DenseFactoryConfig, vectors_np: typ.Any, **kw: typ.Any) -> typ.Any:
    """The host-slab build for corpora larger than device memory: not ported yet."""
    raise NotImplementedError("build_dense_from_host (the host-slab builders) is not ported to vod_tpu_torch yet")


def build_sparse_from_config(
    cfg: SparseFactoryConfig,
    doc_terms: typ.Sequence[typ.Sequence[int]],
    *,
    n_terms: int = 1 << 18,
    subset_ids: typ.Union[torch.Tensor, np.ndarray, None] = None,
    mesh: typ.Any = None,
    shard_axis: str = "shard",
    device: typ.Union[str, torch.device] = "cuda",
    timings: typ.Optional[dict] = None,
) -> SparseIndex:
    """Config-driven BM25 build through the O(tokens) C++ postings builder
    (python fallback inside), moved to `device`; `timings` receives the
    build's wall ms by stage (`build_sparse_index_native`)."""
    del shard_axis  # names the mesh axis, which is not ported
    if mesh is not None:
        raise NotImplementedError("the sharded sparse index (mesh) is not ported to vod_tpu_torch yet")
    return build_sparse_index_native(
        doc_terms, n_terms=n_terms, max_postings=cfg.max_postings, k1=cfg.k1, b=cfg.b,
        subset_ids=subset_ids, device=device, timings=timings,
    )


def build_hybrid_engines(
    config: HybridSearchFactoryConfig,
    *,
    vectors: typ.Union[torch.Tensor, np.ndarray, None] = None,
    doc_terms: typ.Optional[typ.Sequence[typ.Sequence[int]]] = None,
    generator: typ.Optional[torch.Generator] = None,
    subset_ids: typ.Union[torch.Tensor, np.ndarray, None] = None,
    cache_dir: typ.Optional[str] = None,
    data_fingerprint: typ.Optional[str] = None,
    mesh: typ.Any = None,
    device: typ.Union[str, torch.device] = "cuda",
) -> HybridEngines:
    """Assemble the hybrid bundle: each engine the config names and the
    inputs feed (dense from `vectors`, sparse from `doc_terms`), both with
    the corpus's `subset_ids`."""
    if cache_dir is not None:
        raise NotImplementedError("the index cache (cache_dir) is not ported to vod_tpu_torch yet")
    if mesh is not None:
        raise NotImplementedError("sharded engines (mesh) are not ported to vod_tpu_torch yet")
    dense = None
    if config.dense is not None and vectors is not None:
        dense = build_dense_from_config(
            config.dense, vectors, generator=generator, subset_ids=subset_ids,
            data_fingerprint=data_fingerprint, device=device,
        )
    sparse = None
    if config.sparse is not None and doc_terms is not None:
        # as in JAX, `sparse.sharded` shards only when a mesh is given
        sparse = build_sparse_from_config(config.sparse, doc_terms, subset_ids=subset_ids, device=device)
    return HybridEngines(dense=dense, sparse=sparse)
