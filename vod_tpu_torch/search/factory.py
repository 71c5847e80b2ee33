"""Index builds from the factory configs (port of `vod_tpu/search/factory.py`:
`build_dense_from_config`, `build_dense_from_host`, `build_sparse_from_config`,
`build_hybrid_engines`), with the fingerprint-keyed index cache.

Dense codecs flat, int8, pq, ivf and ivfpq are built on the device;
`build_dense_from_host` builds pq, int8 and ivfpq from a host matrix that
may not fit on the device, slab by slab. The BM25 index is built on the host
by the native postings build and moved to the device.

The cache: with `cache_dir` and `data_fingerprint`, a dense build is stored
under `cache_dir/indices/<key>/` and loaded from there when the key is seen
again. The key is the JAX package's (`fingerprint` of the kind, the config's
fields and the data fingerprint), so one config and one data fingerprint
name the same directory in both packages. The files differ, a declared
difference like the port's checkpoints: `arrays.pt` (`torch.save` of the
index's tensors, on the CPU) and `meta.json` (its type and every other field,
a `None` field as null), where JAX writes orbax arrays beside the same
`meta.json`.

Not ported, each raising `NotImplementedError`: sharding over a mesh
(`sharded`, `mesh`, for both engines).
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import typing as typ
import warnings

import numpy as np
import torch

from vod_tpu_torch.configs.search import DenseFactoryConfig, HybridSearchFactoryConfig, SparseFactoryConfig
from vod_tpu_torch.utils.fingerprint import fingerprint
from . import dense as dense_module
from .dense import DenseIndex, IVFIndex, PQIndex, build_dense_index, build_ivf_index, build_pq_index
from .hybrid import HybridEngines
from .ivfpq import IVFPQIndex, build_ivfpq_index
from .sparse import SparseIndex, build_sparse_index_native

_INDEX_TYPES = {cls.__name__: cls for cls in (DenseIndex, PQIndex, IVFIndex, IVFPQIndex, SparseIndex)}


def _index_fingerprint(kind: str, cfg: typ.Any, data_fp: str) -> str:
    """The cache key: JAX's `fingerprint` of the same content
    (`dataclasses.asdict` of the config is JAX's `model_dump()`)."""
    return fingerprint({"kind": kind, "cfg": dataclasses.asdict(cfg), "data": data_fp})


def _save_index(path: pathlib.Path, index: typ.Any) -> None:
    arrays, meta = {}, {}
    for name, value in vars(index).items():
        if isinstance(value, torch.Tensor):
            arrays[name] = value.detach().cpu()
        else:
            meta[name] = value  # None included: it round-trips as null
    path.mkdir(parents=True, exist_ok=True)
    torch.save(arrays, path / "arrays.pt")
    (path / "meta.json").write_text(json.dumps({"type": type(index).__name__, "meta": meta}))


def _load_index(path: pathlib.Path, device: typ.Union[str, torch.device] = "cuda") -> typ.Any:
    spec = json.loads((path / "meta.json").read_text())
    cls = _INDEX_TYPES[spec["type"]]
    arrays = torch.load(path / "arrays.pt", map_location=torch.device(device), weights_only=True)
    # meta holds every other field, None-valued ones too: a field that was
    # None in the live index (IVFPQIndex.codes under keep_codes=False) may have
    # no default to fall back on
    return cls(**arrays, **spec["meta"])


def _check_unsharded(cfg: DenseFactoryConfig, mesh: typ.Any) -> None:
    if cfg.sharded or mesh is not None:
        raise NotImplementedError("sharded dense indexes (sharded, mesh) are not ported to vod_tpu_torch yet")


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
    """Build (or load from the cache) the dense index `cfg` names over
    `vectors`, on `device`.

    The pq, ivf and ivfpq builds draw from `generator` (default: seed 0 on
    the device, as the JAX factory defaults to `PRNGKey(0)`). `timings`,
    when given, receives the pq and ivfpq builds' wall ms by stage
    (`build_pq_index`, `build_ivfpq_index`), and "load_ms" when the index
    comes from the cache."""
    _check_unsharded(cfg, mesh)
    cache_path = None
    if cache_dir is not None and data_fingerprint is not None:
        cache_path = pathlib.Path(cache_dir) / "indices" / _index_fingerprint("dense", cfg, data_fingerprint)
        if (cache_path / "meta.json").exists():
            clock = dense_module._StageClock(timings, torch.device(device))
            with clock("load_ms"):
                index = _load_index(cache_path, device)
            return index

    if cfg.codec in ("flat", "int8"):
        # flat/int8 + refine='float32' keeps exact f32 rows for a k_factor*k re-rank
        index = build_dense_index(
            vectors, subset_ids=subset_ids, dtype="int8" if cfg.codec == "int8" else cfg.dtype,
            approx_recall=cfg.approx_recall, kernel=cfg.kernel,
            refine="float32" if cfg.refine == "float32" else "none", k_factor=cfg.k_factor, device=device,
        )
    elif cfg.codec == "pq":
        index = build_pq_index(
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
    elif cfg.codec == "ivfpq":
        index = build_ivfpq_index(
            vectors,
            n_clusters=cfg.n_clusters,
            nprobe=cfg.nprobe,
            window=cfg.ivf_window,
            max_windows=cfg.max_windows,
            n_subquantizers=cfg.n_subquantizers,
            code_bits=cfg.code_bits,
            train_size=cfg.train_size,
            kmeans_iters=cfg.kmeans_iters,
            use_opq=cfg.use_opq,
            opq_iters=cfg.opq_iters,
            refine=cfg.refine,
            refine_dim=cfg.refine_dim,
            rerank=cfg.rerank,
            rerank_dim=cfg.rerank_dim,
            k_factor=cfg.k_factor,
            keep_codes=cfg.keep_codes,
            subset_ids=subset_ids,
            approx_recall=cfg.approx_recall,
            aniso_eta=cfg.aniso_eta,
            spill=cfg.spill,
            soar_lambda=cfg.soar_lambda,
            generator=generator,
            device=device,
            timings=timings,
        )
    elif cfg.codec == "ivf":
        index = build_ivf_index(
            vectors, n_clusters=cfg.n_clusters, nprobe=cfg.nprobe, kmeans_iters=cfg.kmeans_iters,
            train_size=cfg.train_size, dtype=cfg.dtype, subset_ids=subset_ids, generator=generator, device=device,
        )
    else:
        raise ValueError(f"Unknown dense codec {cfg.codec!r}")

    if cache_path is not None:
        _save_index(cache_path, index)
    return index


def _host_store(kind: str, value: str) -> str:
    """A full-precision refine/rerank store cannot fit by the host-slab
    path's premise (the corpus exceeds the device budget): int8 rows are
    used instead, with a warning, so `RFlat`-style configs do not change
    meaning silently when the periodic recipe crosses its budget."""
    if value in ("bfloat16", "float32"):
        warnings.warn(
            f"build_dense_from_host: {kind}={value!r} does not fit the over-budget build path; "
            f"using int8 {kind} rows instead",
            stacklevel=3,
        )
        return "int8"
    return value


def build_dense_from_host(
    cfg: DenseFactoryConfig,
    vectors_np: typ.Any,  # numpy [N, D] in host RAM; may exceed device memory
    *,
    generator: typ.Optional[torch.Generator] = None,
    subset_ids: typ.Union[torch.Tensor, np.ndarray, None] = None,
    mesh: typ.Any = None,
    slab: int = 1_000_000,
    device: typ.Union[str, torch.device] = "cuda",
    timings: typ.Optional[dict] = None,
) -> typ.Any:
    """Config-driven build from a host embedding matrix that may not fit on
    the device; only the compressed representation lands there:

      * pq    -> `build_pq_index_from_host` (train on a sample, encode host
        slabs on the device one at a time); int8 refine;
      * int8  -> slab-quantized int8 codes (scale from the first 500,000
        rows), D bytes a row on the device;
      * ivfpq -> the stages trained on a sample (`train_ivfpq_stages`), host
        slabs assigned (and SOAR-spilled) and encoded on the device, the
        parts gathered on the host and laid out by `build_ivfpq_from_parts`;
      * flat  -> refused: it cannot fit by definition.

    Draws come from `generator` (default: seed 0 on the device). `timings`
    receives the wall ms by stage."""
    from .dense import _auto_pad_multiple, _slab_on, build_pq_index_from_host

    _check_unsharded(cfg, mesh)
    dev = torch.device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    n, d = (int(s) for s in vectors_np.shape)

    if cfg.codec == "pq":
        return build_pq_index_from_host(
            vectors_np,
            n_subquantizers=cfg.n_subquantizers,
            code_bits=cfg.code_bits,
            coarse_dim=cfg.coarse_dim,
            n_candidates=cfg.n_candidates,
            train_size=min(cfg.train_size or 500_000, n),
            kmeans_iters=cfg.kmeans_iters,
            use_opq=cfg.use_opq,
            refine=_host_store("refine", cfg.refine),
            refine_dim=cfg.refine_dim,
            k_factor=cfg.k_factor,
            slab=slab,
            subset_ids=subset_ids,
            approx_recall=cfg.approx_recall,
            aniso_eta=cfg.aniso_eta,
            keep_codes=cfg.keep_codes,
            kernel=cfg.kernel,
            fused_bins=cfg.fused_bins,
            fused_tile=cfg.fused_tile,
            generator=generator,
            device=dev,
            timings=timings,
        )

    clock = dense_module._StageClock(timings, dev)
    if cfg.codec == "int8":
        from .dense import _pad_rows

        with clock("train_ms"):
            sample = _slab_on(vectors_np, 0, min(n, 500_000), dev)
            scale = torch.clamp(torch.amax(torch.abs(sample), dim=0, keepdim=True), min=1e-8) / 127.0
            del sample
        tile = 1024 if cfg.kernel == "fused" else 128
        mult = max(tile, _auto_pad_multiple(n, None))
        codes = torch.zeros((-(-n // mult) * mult, d), dtype=torch.int8, device=dev)
        with clock("encode_ms"):
            for s0 in range(0, n, slab):
                x = _slab_on(vectors_np, s0, slab, dev)
                codes[s0 : s0 + int(x.shape[0])] = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
                del x
        subs = None
        if subset_ids is not None:
            subs = _pad_rows(torch.as_tensor(subset_ids, device=dev).to(torch.int32), mult)
        return DenseIndex(vectors=codes, scale=scale, subset_ids=subs, n_real=n, approx_recall=cfg.approx_recall,
                          kernel=cfg.kernel)

    if cfg.codec == "ivfpq":
        from vod_tpu_torch.ops import pq as pq_ops
        from vod_tpu_torch.ops.kmeans import _assign_chunked
        from vod_tpu_torch.ops.mips import set_full_f32_matmul
        from .dense import _pack_codes4
        from .ivfpq import assign_soar, build_ivfpq_from_parts, train_ivfpq_stages, train_refine_int8_params

        refine, rerank = _host_store("refine", cfg.refine), _host_store("rerank", cfg.rerank)
        if not cfg.keep_codes and refine == "none":
            raise ValueError("ivfpq keep_codes=False requires a refine store")
        with clock("train_ms"):
            sample = _slab_on(vectors_np, 0, min(n, cfg.train_size or 500_000), dev)
            rotation, codebooks, centroids, aniso_resolved = train_ivfpq_stages(
                sample, n_subquantizers=cfg.n_subquantizers, code_bits=cfg.code_bits,
                kmeans_iters=cfg.kmeans_iters, opq_iters=cfg.opq_iters, use_opq=cfg.use_opq,
                keep_codes=cfg.keep_codes, n_clusters=cfg.n_clusters, n_total=n, aniso_eta=cfg.aniso_eta,
                generator=generator,
            )
            refine_proj = refine_scale = rerank_proj = rerank_scale = None
            if refine == "int8":
                refine_proj, refine_scale = train_refine_int8_params(sample, cfg.refine_dim)
            if rerank == "int8":
                rerank_proj, rerank_scale = train_refine_int8_params(sample, cfg.rerank_dim)
            del sample

        def int8_rows(x: torch.Tensor, proj: typ.Optional[torch.Tensor], scale: torch.Tensor) -> np.ndarray:
            xr = x if proj is None else x @ proj
            return torch.clamp(torch.round(xr / scale), -127, 127).to(torch.int8).cpu().numpy()

        assign_np = np.zeros((n,), np.int32)
        assign2_np = np.zeros((n,), np.int32) if cfg.spill else None
        m_bytes = cfg.n_subquantizers // (2 if cfg.code_bits == 4 else 1)
        codes_np = np.zeros((n, m_bytes), np.uint8) if cfg.keep_codes else None
        rdim = cfg.refine_dim if (refine == "int8" and cfg.refine_dim and cfg.refine_dim < d) else d
        refine_np = np.zeros((n, rdim), np.int8) if refine == "int8" else None
        rrdim = cfg.rerank_dim if (rerank == "int8" and cfg.rerank_dim and cfg.rerank_dim < d) else d
        rerank_np = np.zeros((n, rrdim), np.int8) if rerank == "int8" else None
        with clock("encode_ms"):
            for s0 in range(0, n, slab):
                x = _slab_on(vectors_np, s0, slab, dev)
                s1 = s0 + int(x.shape[0])
                set_full_f32_matmul()
                x_rot = x if rotation is None else x @ rotation
                a = _assign_chunked(x_rot, centroids)
                assign_np[s0:s1] = a.cpu().numpy()
                if assign2_np is not None:
                    assign2_np[s0:s1] = assign_soar(x_rot, centroids, a, soar_lambda=cfg.soar_lambda).cpu().numpy()
                if codes_np is not None:
                    c = pq_ops.encode_pq_auto(codebooks, x_rot, eta=aniso_resolved)
                    codes_np[s0:s1] = (_pack_codes4(c) if cfg.code_bits == 4 else c).cpu().numpy()
                if refine_np is not None:
                    refine_np[s0:s1] = int8_rows(x, refine_proj, refine_scale)
                if rerank_np is not None:
                    rerank_np[s0:s1] = int8_rows(x, rerank_proj, rerank_scale)
                del x, x_rot, a

        with clock("layout_ms"):
            subset_ids_np = None if subset_ids is None else np.asarray(torch.as_tensor(subset_ids).cpu()).astype(np.int32)
            row_ids_np = None
            if cfg.spill:
                # SOAR duplication on the host (the parts double in host RAM,
                # not on the device; the sorted layout lands there once)
                assign_np = np.concatenate([assign_np, assign2_np])
                row_ids_np = np.tile(np.arange(n, dtype=np.int32), 2)
                codes_np = None if codes_np is None else np.concatenate([codes_np, codes_np])
                refine_np = None if refine_np is None else np.concatenate([refine_np, refine_np])
                subset_ids_np = None if subset_ids_np is None else np.tile(subset_ids_np, 2)
            index = build_ivfpq_from_parts(
                centroids, codebooks, assign_np, codes_np, rotation=rotation,
                refine_np=refine_np, refine_scale=refine_scale, refine_proj=refine_proj,
                rerank_np=rerank_np, rerank_scale=rerank_scale, rerank_proj=rerank_proj,
                k_factor=cfg.k_factor, subset_ids_np=subset_ids_np, window=cfg.ivf_window, nprobe=cfg.nprobe,
                max_windows=cfg.max_windows, code_bits=cfg.code_bits, approx_recall=cfg.approx_recall,
                row_ids_np=row_ids_np, n_real=n, spilled=cfg.spill, device=dev,
            )
        return index

    raise ValueError(
        f"host-slab build supports codecs pq|int8|ivfpq; {cfg.codec!r} requires the "
        "full matrix on the device (use build_dense_from_config when it fits)"
    )


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
    inputs feed (dense from `vectors`, through the cache when `cache_dir` and
    `data_fingerprint` are given; sparse from `doc_terms`, never cached, as
    in JAX), both with the corpus's `subset_ids`."""
    if mesh is not None:
        raise NotImplementedError("sharded engines (mesh) are not ported to vod_tpu_torch yet")
    dense = None
    if config.dense is not None and vectors is not None:
        dense = build_dense_from_config(
            config.dense, vectors, generator=generator, subset_ids=subset_ids, cache_dir=cache_dir,
            data_fingerprint=data_fingerprint, device=device,
        )
    sparse = None
    if config.sparse is not None and doc_terms is not None:
        # as in JAX, `sparse.sharded` shards only when a mesh is given
        sparse = build_sparse_from_config(config.sparse, doc_terms, subset_ids=subset_ids, device=device)
    return HybridEngines(dense=dense, sparse=sparse)
