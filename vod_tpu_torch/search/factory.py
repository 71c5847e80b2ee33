"""Dense-index builds from a `DenseFactoryConfig` (port of
`vod_tpu/search/factory.py:build_dense_from_config`).

Codecs flat, int8, pq and ivf are built on the device. Not ported yet, each
raising `NotImplementedError`: the ivfpq codec, sharding over a mesh
(`sharded`, `mesh`), the fingerprint-keyed index cache (`cache_dir`) and the
host-slab build `build_dense_from_host`.
"""

from __future__ import annotations

import typing as typ

import numpy as np
import torch

from vod_tpu_torch.configs.search import DenseFactoryConfig
from .dense import build_dense_index, build_ivf_index, build_pq_index


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
