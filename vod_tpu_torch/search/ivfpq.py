"""IVF-PQ: cell-pruned PQ search (port of `vod_tpu/search/ivfpq.py`; faiss
`OPQ{M},IVF{n},PQ{M}x{b}[,Refine]`, the reference's default dense factory
`OPQ32_512,IVFauto,PQ32x8`).

The layout is the JAX package's, bit for bit:

  * Cluster-sorted flat layout. Rows are reordered by k-means cell and each
    cell is padded up to a multiple of a fixed `window` (e.g. 512 rows)
    inside the same flat arrays (`_sorted_window_layout`, a copy of the
    numpy code).
  * Static window probing. A query's candidates are the first `max_windows`
    windows of its `nprobe` best cells, in probe order (descending centroid
    score), found by a batched `searchsorted` over the cumulative window
    counts: static shapes, no host sync.
  * Gathered-window scoring. Windows are rows of a `[n_windows, window, ...]`
    view of the stored rows; each scoring chunk gathers whole windows.
  * Refine rows are the scoring rows when they exist (int8, optionally in a
    truncated PCA space, or bf16/f32); otherwise the PQ codes are decoded
    (the one-hot ADC decode in JAX, a gather of the same bf16 codebook rows
    here). An optional second store (`rerank_codes`, original row order)
    re-ranks a pool of `k_factor * top_k` window candidates.

Centroids, codes and the coarse assignment live in the OPQ-rotated space;
refine and rerank rows in the original space.

Differences from the JAX package, all declared:

  * Selection is exact and lowest-index-first (`topk_lowest_first`), where
    JAX takes `approx_max_k` inside each scoring chunk; on the CPU JAX's is
    exact too, which is what the parity tests compare.
  * int8 products (`einsum("bd,brd->br", int8, int8) -> int32` in JAX) are
    multiplied in float32 with TF32 off: every product is at most 127² and
    every partial sum an integer, so the sums are exact while 127² · R <
    2^24 (R <= 1040); wider rows go through float64. The float32 copy of a
    gathered chunk is 4x the int8 bytes that `_OH_BUDGET` counts: at B = 64,
    R = 128 and 512-row windows a chunk gathers 64 windows, 256 MiB of int8
    rows and a 1 GiB float32 copy, the peak of a search.
  * bf16 products are exact in float32 on both sides; the sums are in
    another order, so scores agree to float32 rounding.
  * `lax.map` over query chunks and `lax.scan` over window chunks are
    Python loops with JAX's chunk sizes (from `_OH_BUDGET`).
  * The on-device build permutes its rows into the layout with one device
    scatter per array (`build_ivfpq_from_device_parts`) where JAX's goes
    through the host (`build_ivfpq_from_parts`); both give the same arrays.
  * Random draws come from the `torch.Generator` the caller gives: PQ/OPQ
    training first, then the coarse k-means (JAX folds 17 into its key for
    the latter).

With a `mesh`, the coarse quantizer trains by `ops/kmeans.py:kmeans_sharded`
over the ranks of `mesh_axis` (every rank passes the same training rows and
the same generator state); the rest of the build runs on every rank.
"""

from __future__ import annotations

import dataclasses
import typing as typ

import numpy as np
import torch

from vod_tpu_torch.ops import pq as pq_ops
from vod_tpu_torch.ops.mips import set_full_f32_matmul
from vod_tpu_torch.ops.numpy_ops import topk_lowest_first
from vod_tpu_torch.types.retrieval import RetrievalBatch
from .base import SearchQueries
from .dense import _FROM_INDEX, _StageClock, _build_refine, _pack_codes4, _unpack_codes4, quantize_queries_int8

# scoring-stage temp budget (bytes): bounds B*rows_per_chunk*row_cost where
# row_cost counts all live temps per (query, row) in JAX's scoring stage
_OH_BUDGET = 1 << 28


@dataclasses.dataclass
class IVFPQIndex:
    """Cell-pruned PQ index in the cluster-sorted window layout."""

    centroids: torch.Tensor  # [C, D] f32 (rotated space)
    codebooks: torch.Tensor  # [M, n_codes, dsub] f32
    # [N_sorted, M] uint8 (or [N_sorted, M//2] packed, 4-bit); None when the
    # refine rows are the scoring store (`keep_codes=False`)
    codes: typ.Optional[torch.Tensor]
    row_ids: torch.Tensor  # [N_sorted] int32 original row id, -1 for cell padding
    win_start: torch.Tensor  # [C] int32 first window of each cell
    win_count: torch.Tensor  # [C] int32 windows in each cell
    rotation: typ.Optional[torch.Tensor] = None  # [D, D] OPQ (None = identity)
    subset_ids: typ.Optional[torch.Tensor] = None  # [N_sorted] int32 (sorted layout)
    refine_codes: typ.Optional[torch.Tensor] = None  # [N_sorted, R] (sorted layout)
    refine_scale: typ.Optional[torch.Tensor] = None  # [1, R] f32 when int8 refine
    refine_proj: typ.Optional[torch.Tensor] = None  # [D, R] truncated-PCA (None = raw)
    # faiss IndexRefine on top of IVF: the window stage pools the top
    # k_factor * top_k candidates, re-ranked against this store (original
    # row order, gathered by row id, so SOAR spilling costs no second copy)
    rerank_codes: typ.Optional[torch.Tensor] = None  # [N, R2] (original order)
    rerank_scale: typ.Optional[torch.Tensor] = None  # [1, R2] f32 when int8
    rerank_proj: typ.Optional[torch.Tensor] = None  # [D, R2] truncated-PCA (None = raw)
    n_real: int = 0
    offset: int = 0
    window: int = 512
    nprobe: int = 32
    max_windows: int = 0  # 0 = nprobe cells, untruncated
    # candidate-pool widening for the rerank stage; inert without rerank_codes
    k_factor: int = 16
    code_bits: int = 8
    approx_recall: typ.Optional[float] = 0.95
    # SOAR spilling: every row is stored under two cells, so search dedups
    spilled: bool = False

    def replace(self, **changes: typ.Any) -> "IVFPQIndex":
        return dataclasses.replace(self, **changes)


def assign_soar(
    x: torch.Tensor,
    centroids: torch.Tensor,
    assign: torch.Tensor,
    *,
    soar_lambda: float = 1.0,
    chunk: int = 2048,
) -> torch.Tensor:
    """Secondary (spilled) cell per row, SOAR (Sun, Guo & Simcha, NeurIPS
    2023): the cell c' != c1 minimizing ``||x-c'||^2 + lambda * <x-c',
    r_hat>^2`` with r = x - c1, i.e. one whose residual is orthogonal to the
    primary's. Chunked over rows; [N] int32."""
    set_full_f32_matmul()
    n = int(x.shape[0])
    cent = centroids.to(torch.float32)
    c_sq = torch.sum(cent * cent, dim=-1)  # [C]
    iota_c = torch.arange(int(cent.shape[0]), device=x.device)
    out = []
    for s in range(0, n, chunk):
        xc = x[s : s + chunk].to(torch.float32)
        ac = assign[s : s + chunk].long()
        r = xc - cent[ac]
        r_hat = r / (torch.linalg.vector_norm(r, dim=-1, keepdim=True) + 1e-12)
        dist = c_sq[None, :] - 2.0 * (xc @ cent.T)  # ||x-c'||^2 minus the per-row ||x||^2
        xr = torch.sum(xc * r_hat, dim=-1, keepdim=True)  # <x - c', r_hat> = <x, r_hat> - <c', r_hat>
        cr = r_hat @ cent.T
        loss = dist + soar_lambda * (xr - cr) ** 2
        loss = torch.where(iota_c[None, :] == ac[:, None], float("inf"), loss)
        out.append(torch.argmin(loss, dim=-1).to(torch.int32))
    return torch.cat(out) if out else torch.zeros((0,), dtype=torch.int32, device=x.device)


def _dedup_equal_rows(scores: torch.Tensor, indices: torch.Tensor, top_k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Keep one copy per row id, then cut to top_k. Spilled copies are exact
    duplicates (both score the raw row), so masking either is lossless; -1
    padding ids are exempt (already -inf)."""
    order = torch.argsort(indices, dim=-1, stable=True)
    sid = torch.gather(indices, -1, order)
    ss = torch.gather(scores, -1, order)
    dup = (sid[:, 1:] == sid[:, :-1]) & (sid[:, 1:] >= 0)
    ss = torch.cat([ss[:, :1], torch.where(dup, float("-inf"), ss[:, 1:])], dim=-1)
    out_s, pos = topk_lowest_first(ss, min(top_k, int(ss.shape[-1])))
    out_i = torch.gather(sid, -1, pos)
    return out_s, torch.where(torch.isfinite(out_s), out_i, -1)


def _gathered_dot(q: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """q [B, R] . rows [B, r, R] -> [B, r] f32, products and sums in float32
    (TF32 off), or float64 for int8 rows too wide for float32 to sum
    exactly (127² · R >= 2^24)."""
    set_full_f32_matmul()
    dt = torch.float32
    if rows.dtype == torch.int8 and 127 * 127 * int(rows.shape[-1]) >= 2**24:
        dt = torch.float64
    return torch.bmm(rows.to(dt), q.to(dt)[:, :, None])[..., 0].to(torch.float32)


def _store_scorer(
    q: torch.Tensor, proj: typ.Optional[torch.Tensor], scale: typ.Optional[torch.Tensor]
) -> typ.Callable[[torch.Tensor], torch.Tensor]:
    """Scores of gathered store rows [B, r, R] -> [B, r] for queries q [B, D]
    (original space): projected by `proj`; against int8 rows (`scale` set)
    the query is quantized per row with the per-dim scale folded in, the
    product summed exactly and rescaled; against bf16/f32 rows the query is
    rounded to their dtype."""
    set_full_f32_matmul()
    q = q.to(torch.float32)
    if proj is not None:
        q = q @ proj
    if scale is not None:
        q_i8, q_row = quantize_queries_int8(q, scale)
        return lambda rows: _gathered_dot(q_i8, rows) * q_row
    return lambda rows: _gathered_dot(q.to(rows.dtype), rows)


def rerank_candidates(
    q: torch.Tensor,  # [B, D] query vectors (original space)
    cand_s: torch.Tensor,  # [B, pool] candidate scores (validity mask only)
    cand_i: torch.Tensor,  # [B, pool] candidate row ids (offset applied), -1 pad
    top_k: int,
    *,
    rerank_codes: torch.Tensor,  # [n_real, R2] original row order
    rerank_scale: typ.Optional[torch.Tensor],
    rerank_proj: typ.Optional[torch.Tensor],
    offset: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact re-rank of pooled candidates against the rerank store: one
    [B, pool, R2] gather by original row id and one product (faiss
    IndexRefine: pool k_factor * k, rescore, cut to k)."""
    n_rr = int(rerank_codes.shape[0])
    rid = torch.clamp(cand_i - offset, 0, n_rr - 1).long()
    s_rr = _store_scorer(q, rerank_proj, rerank_scale)(rerank_codes[rid])  # rows [B, pool, R2]
    s_rr = torch.where(torch.isfinite(cand_s) & (cand_i >= 0), s_rr, float("-inf"))
    out_s, sel = topk_lowest_first(s_rr, min(top_k, int(s_rr.shape[-1])))
    out_i = torch.gather(cand_i, -1, sel)
    return out_s, torch.where(torch.isfinite(out_s), out_i, -1)


def _sorted_window_layout(
    assign_np: np.ndarray,
    n_cells: int,
    window: int,
    nprobe: int,
    max_windows: typ.Optional[int],
) -> tuple[np.ndarray, int, np.ndarray, np.ndarray, int]:
    """Cluster-sorted padded-window layout shared by the host and device builds.

    Returns `(dst, total, win_start, win_count, max_windows)` where `dst[i]`
    is the padded-layout slot of original row `i` and `total` the slot count.
    `max_windows=None` sizes the per-query window budget as nprobe cells of
    ~1.5x the mean cell's windows (truncation then only bites pathologically
    skewed probes; the probe order drops the least promising cells first).
    """
    n_real = int(assign_np.shape[0])
    order = np.argsort(assign_np, kind="stable")
    counts = np.bincount(assign_np, minlength=n_cells)
    wcounts = -(-counts // window)  # ceil; 0 for empty cells
    starts_pad = np.concatenate([[0], np.cumsum(wcounts * window)])
    total = int(starts_pad[-1])
    # dst[i] = padded-layout position of original row i (vectorized scatter map)
    sorted_assign = assign_np[order]
    cell_first = np.concatenate([[0], np.cumsum(counts)])[:-1]
    within = np.arange(n_real, dtype=np.int64) - cell_first[sorted_assign]
    dst = np.empty(n_real, np.int64)
    dst[order] = starts_pad[sorted_assign] + within
    win_start = (starts_pad[:-1] // window).astype(np.int32)
    win_count = wcounts.astype(np.int32)
    if max_windows is None:
        nonempty = wcounts[wcounts > 0]
        mean_w = float(nonempty.mean()) if nonempty.size else 1.0
        max_windows = int(min(int(wcounts.sum()), nprobe * max(1, int(np.ceil(1.5 * mean_w)))))
    return dst, total, win_start, win_count, int(max_windows)


def _on(x: typ.Any, device: torch.device, dtype: typ.Optional[torch.dtype] = None) -> typ.Optional[torch.Tensor]:
    return None if x is None else torch.as_tensor(x, device=device, dtype=dtype)


def build_ivfpq_from_parts(
    centroids: torch.Tensor,
    codebooks: torch.Tensor,
    assign_np: np.ndarray,  # [N] int32 cell id per row
    codes_np: typ.Optional[np.ndarray],  # [N, M or M//2] uint8; None = refine rows only
    *,
    rotation: typ.Optional[torch.Tensor] = None,
    refine_np: typ.Optional[np.ndarray] = None,  # [N, R] (original order)
    refine_scale: typ.Optional[torch.Tensor] = None,
    refine_proj: typ.Optional[torch.Tensor] = None,
    rerank_np: typ.Optional[np.ndarray] = None,  # [n_real, R2] (original order, not spilled)
    rerank_scale: typ.Optional[torch.Tensor] = None,
    rerank_proj: typ.Optional[torch.Tensor] = None,
    k_factor: int = 16,
    subset_ids_np: typ.Optional[np.ndarray] = None,
    window: int = 512,
    nprobe: int = 32,
    max_windows: typ.Optional[int] = None,
    code_bits: int = 8,
    offset: int = 0,
    approx_recall: typ.Optional[float] = 0.95,
    row_ids_np: typ.Optional[np.ndarray] = None,  # [rows] original id per stored row
    n_real: typ.Optional[int] = None,  # distinct real rows (= rows unless spilled)
    spilled: bool = False,
    device: typ.Union[str, torch.device] = "cuda",
) -> IVFPQIndex:
    """Assemble the sorted window layout from host parts, then move it to
    `device` (faiss's chunked `index.add`). SOAR-spilled builds pass every
    row twice (primary + secondary cell) with `row_ids_np` carrying the
    duplicated original ids and `spilled=True`."""
    dev = torch.device(device)
    n_rows = int(assign_np.shape[0])
    if n_real is None:
        n_real = n_rows
    c = int(centroids.shape[0])
    dst, total, win_start, win_count, max_windows = _sorted_window_layout(assign_np, c, window, nprobe, max_windows)
    if codes_np is None and refine_np is None:
        raise ValueError("need codes_np and/or refine_np to score against")
    codes_sorted = None
    if codes_np is not None:
        codes_sorted = np.zeros((total, codes_np.shape[1]), np.uint8)
        codes_sorted[dst] = codes_np
    row_ids = np.full((total,), -1, np.int32)
    row_ids[dst] = np.arange(n_rows, dtype=np.int32) if row_ids_np is None else row_ids_np.astype(np.int32)
    subs = None
    if subset_ids_np is not None:
        subs = np.full((total,), -1, np.int32)
        subs[dst] = subset_ids_np
    refine_sorted = None
    if refine_np is not None:
        refine_sorted = np.zeros((total, refine_np.shape[1]), refine_np.dtype)
        refine_sorted[dst] = refine_np
    return IVFPQIndex(
        centroids=_on(centroids, dev, torch.float32),
        codebooks=_on(codebooks, dev),
        codes=_on(codes_sorted, dev),
        row_ids=_on(row_ids, dev),
        win_start=_on(win_start, dev),
        win_count=_on(win_count, dev),
        rotation=_on(rotation, dev),
        subset_ids=_on(subs, dev),
        refine_codes=_on(refine_sorted, dev),
        refine_scale=_on(refine_scale, dev),
        refine_proj=_on(refine_proj, dev),
        rerank_codes=_on(rerank_np, dev),
        rerank_scale=_on(rerank_scale, dev),
        rerank_proj=_on(rerank_proj, dev),
        k_factor=k_factor, n_real=n_real, offset=offset, window=window, nprobe=nprobe,
        max_windows=int(max_windows), code_bits=code_bits, approx_recall=approx_recall, spilled=spilled,
    )


def build_ivfpq_from_device_parts(
    centroids: torch.Tensor,
    codebooks: torch.Tensor,
    assign_np: np.ndarray,  # [N] int32 (host; sizes the layout)
    codes_dev: typ.Optional[torch.Tensor],  # [N, Mc] uint8 on the device (None = refine only)
    *,
    refine_dev: typ.Optional[torch.Tensor] = None,  # [N, R] on the device
    refine_scale: typ.Optional[torch.Tensor] = None,
    refine_proj: typ.Optional[torch.Tensor] = None,
    rerank_dev: typ.Optional[torch.Tensor] = None,  # [n_real, R2] on the device (original order)
    rerank_scale: typ.Optional[torch.Tensor] = None,
    rerank_proj: typ.Optional[torch.Tensor] = None,
    k_factor: int = 16,
    rotation: typ.Optional[torch.Tensor] = None,
    subset_ids_np: typ.Optional[np.ndarray] = None,
    window: int = 512,
    nprobe: int = 32,
    max_windows: typ.Optional[int] = None,
    code_bits: int = 8,
    offset: int = 0,
    approx_recall: typ.Optional[float] = 0.95,
    row_ids_np: typ.Optional[np.ndarray] = None,
    n_real: typ.Optional[int] = None,
    spilled: bool = False,
) -> IVFPQIndex:
    """Assemble the sorted window layout when the big arrays already live on
    the device: only the [N] assignment crosses to the host, and each array
    is permuted into the padded layout by one device scatter. Spilled builds
    pass duplicated rows + `row_ids_np`/`spilled` as `build_ivfpq_from_parts`."""
    dev = centroids.device
    n_rows = int(assign_np.shape[0])
    if n_real is None:
        n_real = n_rows
    c = int(centroids.shape[0])
    dst, total, win_start, win_count, max_windows = _sorted_window_layout(assign_np, c, window, nprobe, max_windows)
    dst_dev = torch.from_numpy(dst).to(dev)

    def scatter_rows(src: torch.Tensor) -> torch.Tensor:
        out = torch.zeros((total, int(src.shape[1])), dtype=src.dtype, device=dev)
        out[dst_dev] = src
        return out

    def scatter_ids(src: torch.Tensor) -> torch.Tensor:
        out = torch.full((total,), -1, dtype=torch.int32, device=dev)
        out[dst_dev] = src.to(torch.int32)
        return out

    ids = torch.arange(n_rows, dtype=torch.int32, device=dev) if row_ids_np is None else _on(row_ids_np, dev)
    return IVFPQIndex(
        centroids=centroids.to(torch.float32),
        codebooks=codebooks,
        codes=None if codes_dev is None else scatter_rows(codes_dev),
        row_ids=scatter_ids(ids),
        win_start=_on(win_start, dev),
        win_count=_on(win_count, dev),
        rotation=rotation,
        subset_ids=None if subset_ids_np is None else scatter_ids(_on(subset_ids_np, dev)),
        refine_codes=None if refine_dev is None else scatter_rows(refine_dev),
        refine_scale=refine_scale,
        refine_proj=refine_proj,
        rerank_codes=rerank_dev,
        rerank_scale=rerank_scale,
        rerank_proj=rerank_proj,
        k_factor=k_factor, n_real=n_real, offset=offset, window=window, nprobe=nprobe,
        max_windows=int(max_windows), code_bits=code_bits, approx_recall=approx_recall, spilled=spilled,
    )


def train_ivfpq_stages(
    train: torch.Tensor,
    *,
    n_subquantizers: int,
    code_bits: int,
    kmeans_iters: int,
    opq_iters: int,
    use_opq: bool,
    keep_codes: bool,
    n_clusters: typ.Optional[int],
    n_total: int,
    mesh: typ.Any = None,
    mesh_axis: str = "shard",
    aniso_eta: pq_ops.AnisoEta = None,
    generator: torch.Generator,
) -> tuple[typ.Optional[torch.Tensor], torch.Tensor, torch.Tensor, typ.Optional[float]]:
    """Train the IVF-PQ stages shared by the in-memory and host-slab builds.

    Returns `(rotation, codebooks, centroids, resolved_aniso_eta)`; the last
    goes to `encode_pq_auto`. One place pins what both builds must agree
    on: the OPQ inner k-means budget, the draw order (PQ/OPQ, then the coarse
    k-means) and `IVFauto` from the total row count, not the sample's. With
    `mesh`, the coarse k-means runs over the ranks of `mesh_axis`."""
    from vod_tpu_torch.ops.kmeans import infer_n_clusters, kmeans, kmeans_sharded

    d = int(train.shape[-1])
    rotation = None
    aniso_resolved = None
    if not keep_codes:
        # refine rows are the scoring store; skip PQ/OPQ training outright
        codebooks = torch.zeros((1, 1, d), dtype=torch.float32, device=train.device)
        train_rot = train
    else:
        rotation, codebooks, aniso_resolved = pq_ops.train_pq_codebooks(
            train, n_subquantizers, n_codes=1 << code_bits, kmeans_iters=kmeans_iters, use_opq=use_opq,
            opq_iters=opq_iters, aniso_eta=aniso_eta, generator=generator,
        )
        set_full_f32_matmul()
        train_rot = train if rotation is None else train @ rotation
    c = n_clusters or infer_n_clusters(n_total)
    if mesh is not None:
        centroids, _ = kmeans_sharded(train_rot, c, mesh, axis=mesh_axis, n_iters=kmeans_iters, generator=generator)
    else:
        centroids, _ = kmeans(train_rot, n_clusters=c, n_iters=kmeans_iters, generator=generator)
    return rotation, codebooks, centroids, aniso_resolved


def train_refine_int8_params(
    train: torch.Tensor, refine_dim: typ.Optional[int]
) -> tuple[typ.Optional[torch.Tensor], torch.Tensor]:
    """(proj, scale) for int8 refine rows trained from a sample: the
    host-slab counterpart of `dense._build_refine`, which scales against the
    full matrix."""
    proj = None
    ref = train
    if refine_dim is not None and refine_dim < train.shape[-1]:
        proj, _mean = pq_ops.train_projection(train, refine_dim)
        set_full_f32_matmul()
        ref = train @ proj
    scale = torch.clamp(torch.amax(torch.abs(ref), dim=0, keepdim=True), min=1e-8) / 127.0
    return proj, scale


def build_ivfpq_index(
    vectors: typ.Union[torch.Tensor, np.ndarray],
    *,
    n_clusters: typ.Optional[int] = None,
    nprobe: int = 32,
    window: int = 512,
    max_windows: typ.Optional[int] = None,
    n_subquantizers: int = 32,
    code_bits: int = 8,
    train_size: typ.Optional[int] = None,
    kmeans_iters: int = 10,
    use_opq: bool = False,
    opq_iters: int = 4,
    refine: str = "none",
    refine_dim: typ.Optional[int] = None,
    rerank: str = "none",
    rerank_dim: typ.Optional[int] = None,
    k_factor: int = 16,
    keep_codes: bool = True,
    subset_ids: typ.Union[torch.Tensor, np.ndarray, None] = None,
    offset: int = 0,
    approx_recall: typ.Optional[float] = 0.95,
    mesh: typ.Any = None,
    mesh_axis: str = "shard",
    aniso_eta: pq_ops.AnisoEta = None,
    spill: bool = False,
    soar_lambda: float = 1.0,
    generator: typ.Optional[torch.Generator] = None,
    device: typ.Union[str, torch.device] = "cuda",
    timings: typ.Optional[dict] = None,
) -> IVFPQIndex:
    """Build an IVF-PQ index on `device` (`IVFauto` when n_clusters is None).

    refine='int8' (optionally with `refine_dim` truncated-PCA rows) stores
    scoring rows in the sorted layout; bf16/f32 refine too. With a refine
    store, `keep_codes=False` skips PQ training and drops the codes: IVF +
    (PCA-)SQ at R + 4 bytes a row. `rerank` adds the second-stage store.
    `spill=True` also stores every row under its SOAR secondary cell.
    With `mesh`, the coarse k-means runs over the ranks of `mesh_axis`.
    Draws come from `generator` (default: seed 0 on the device). With
    `timings`, the wall ms of each stage is added under "train_ms",
    "assign_ms", "encode_ms", "refine_ms" and "layout_ms"."""
    from vod_tpu_torch.ops.kmeans import _assign_chunked

    if code_bits not in (8, 4):
        raise ValueError(f"code_bits must be 8 or 4, got {code_bits}")
    if code_bits == 4 and n_subquantizers % 2:
        raise ValueError("code_bits=4 requires an even n_subquantizers (nibble packing)")
    if not keep_codes and refine == "none":
        raise ValueError("keep_codes=False requires a refine store to score against")
    vectors = torch.as_tensor(vectors, device=device)
    dev = vectors.device
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    clock = _StageClock(timings, dev)
    n_real = int(vectors.shape[0])
    x = vectors.to(torch.float32)
    train = x if train_size is None or train_size >= n_real else x[:train_size]

    with clock("train_ms"):
        rotation, codebooks, centroids, aniso_resolved = train_ivfpq_stages(
            train, n_subquantizers=n_subquantizers, code_bits=code_bits, kmeans_iters=kmeans_iters,
            opq_iters=opq_iters, use_opq=use_opq, keep_codes=keep_codes, n_clusters=n_clusters, n_total=n_real,
            mesh=mesh, mesh_axis=mesh_axis, aniso_eta=aniso_eta, generator=generator,
        )
    with clock("assign_ms"):
        set_full_f32_matmul()
        x_rot = x if rotation is None else x @ rotation
        assign = _assign_chunked(x_rot, centroids)
        assign2 = assign_soar(x_rot, centroids, assign, soar_lambda=soar_lambda) if spill else None
    codes = None
    with clock("encode_ms"):
        if keep_codes:
            codes = pq_ops.encode_pq_auto(codebooks, x_rot, eta=aniso_resolved)
            if code_bits == 4:
                codes = _pack_codes4(codes)
    del x_rot
    with clock("refine_ms"):
        # refine rows are scored in the sorted layout; the rerank store stays
        # in original row order
        refine_rows, refine_scale, refine_proj = _build_refine(x, refine, 1, refine_dim=refine_dim, train=train)
        rerank_rows, rerank_scale, rerank_proj = _build_refine(x, rerank, 1, refine_dim=rerank_dim, train=train)

    with clock("layout_ms"):
        assign_np = assign.cpu().numpy().astype(np.int32)
        row_ids_np = None
        subset_ids_np = None if subset_ids is None else np.asarray(torch.as_tensor(subset_ids).cpu()).astype(np.int32)
        if spill:
            # SOAR: every row again under its secondary cell (same codes and
            # refine rows: they encode the raw row, so copies score identically)
            assign_np = np.concatenate([assign_np, assign2.cpu().numpy().astype(np.int32)])
            row_ids_np = np.tile(np.arange(n_real, dtype=np.int32), 2)
            codes = None if codes is None else torch.cat([codes, codes])
            refine_rows = None if refine_rows is None else torch.cat([refine_rows, refine_rows])
            subset_ids_np = None if subset_ids_np is None else np.tile(subset_ids_np, 2)
        index = build_ivfpq_from_device_parts(
            centroids, codebooks, assign_np, codes, refine_dev=refine_rows, refine_scale=refine_scale,
            refine_proj=refine_proj, rerank_dev=rerank_rows, rerank_scale=rerank_scale, rerank_proj=rerank_proj,
            k_factor=k_factor, rotation=rotation, subset_ids_np=subset_ids_np, window=window, nprobe=nprobe,
            max_windows=max_windows, code_bits=code_bits, offset=offset, approx_recall=approx_recall,
            row_ids_np=row_ids_np, n_real=n_real, spilled=spill,
        )
    return index


def _probe_window_ids(index: IVFPQIndex, q_eff: torch.Tensor, w_max: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-query window-id lists: [B, W] window ids + [B, W] validity.

    Probes the `nprobe` best cells (descending centroid score, lowest cell
    first on ties) and emits their windows in probe order until the static
    `w_max` budget fills: a batched searchsorted over each query's
    cumulative window counts."""
    set_full_f32_matmul()
    c = int(index.centroids.shape[0])
    nprobe = min(index.nprobe, c)
    cscores = q_eff @ index.centroids.T
    _, cells = topk_lowest_first(cscores, nprobe)  # [B, P] descending
    ws = index.win_start[cells]  # [B, P]
    wc = index.win_count[cells]  # [B, P]
    cum = torch.cumsum(wc, dim=-1, dtype=torch.int32)  # [B, P]
    slots = torch.arange(w_max, dtype=torch.int32, device=cum.device)
    p = torch.searchsorted(cum, slots[None, :].expand(cum.shape[0], w_max).contiguous(), right=True)  # [B, W]
    p_safe = torch.clamp(p, 0, nprobe - 1)
    prev = torch.where(p_safe > 0, torch.gather(cum, -1, torch.clamp(p_safe - 1, min=0)), 0)
    off = slots[None, :] - prev
    win_id = torch.gather(ws, -1, p_safe) + off
    valid = slots[None, :] < cum[:, -1:]
    return torch.where(valid, win_id, 0).to(torch.int32), valid


def ivfpq_search(
    index: IVFPQIndex,
    queries: SearchQueries,
    top_k: int,
    *,
    approx_recall: typ.Any = _FROM_INDEX,
) -> RetrievalBatch:
    """Cell-pruned search + optional exact re-rank (faiss IVFPQ `search` with
    `nprobe`). Batches larger than the scoring budget's query chunk are
    searched chunk by chunk, each padded to the chunk's size as JAX's
    `lax.map` does. Nothing here waits for the device."""
    del approx_recall  # selection is exact here (see the module docstring)
    q = queries.vector
    if q is None:
        raise ValueError("ivfpq_search requires queries.vector")
    b, d = (int(s) for s in q.shape)
    m = int(index.codebooks.shape[0])
    n_codes = int(index.codebooks.shape[1])
    window = index.window
    do_refine = index.refine_codes is not None
    if not do_refine and index.codes is None:
        raise ValueError("IVFPQIndex built with keep_codes=False requires refine rows")

    # per-(query, row) temp bytes of JAX's scoring stage: R gathered bytes on
    # the refine path; on the ADC path the bool one-hot and its bf16 cast
    # (3 B per (M, n_codes) entry) plus the decoded bf16 row (2 B per dim)
    if do_refine:
        row_cost = int(index.refine_codes.shape[-1]) * index.refine_codes.element_size()
    else:
        row_cost = 3 * m * n_codes + 2 * d
    qchunk = max(8, _OH_BUDGET // (window * row_cost))
    if b > qchunk:
        pad = (-b) % qchunk
        qp = torch.nn.functional.pad(q, (0, 0, 0, pad)) if pad else q
        sub = queries.subset_ids
        if sub is not None and pad:
            sub = torch.nn.functional.pad(sub, (0, 0, 0, pad), value=-1)
        outs = [
            ivfpq_search(index, SearchQueries(vector=qp[s : s + qchunk],
                                              subset_ids=None if sub is None else sub[s : s + qchunk]), top_k)
            for s in range(0, b + pad, qchunk)
        ]
        return RetrievalBatch(scores=torch.cat([o.scores for o in outs])[:b],
                              indices=torch.cat([o.indices for o in outs])[:b])

    set_full_f32_matmul()
    q_eff = q.to(torch.float32)
    if index.rotation is not None:
        q_eff = q_eff @ index.rotation

    n_sorted = int(index.row_ids.shape[0])
    n_windows = n_sorted // window
    w_max = index.max_windows if index.max_windows > 0 else n_windows
    w_max = min(w_max, n_windows)
    # windows per scoring chunk, bounded by the gather/temp budget
    wchunk = min(max(1, _OH_BUDGET // (b * window * row_cost)), w_max)
    w_pad = -(-w_max // wchunk) * wchunk
    n_wchunks = w_pad // wchunk

    win_id, valid = _probe_window_ids(index, q_eff, w_max)
    if w_pad > w_max:
        win_id = torch.nn.functional.pad(win_id, (0, w_pad - w_max))
        valid = torch.nn.functional.pad(valid, (0, w_pad - w_max))

    rows_w = index.row_ids.view(n_windows, window)
    allowed = queries.subset_ids
    subs_w = None
    if allowed is not None and index.subset_ids is not None:
        subs_w = index.subset_ids.view(n_windows, window)

    # with a rerank store the window stage pools a widened candidate set for
    # the exact re-rank below; otherwise the window-scoring order is final
    do_rerank = index.rerank_codes is not None
    pool = max(1, index.k_factor) * top_k if do_rerank else top_k
    rc = wchunk * window  # rows per scoring chunk
    # a spilled index may hold both copies of a row in one chunk: keep 2 * pool
    kc = min(rc, 2 * pool if index.spilled else pool)

    if do_refine:
        # score gathered windows directly against the refine rows
        refine_w = index.refine_codes.view(n_windows, window, -1)
        score_rows = _store_scorer(q, index.refine_proj, index.refine_scale)
    else:
        codes_w = index.codes.view(n_windows, window, -1)
        unpack = _unpack_codes4 if index.code_bits == 4 else (lambda cc: cc)
        # the one-hot bf16 decode selects one codebook entry per value: a
        # gather of the bf16 codebook rows gives the same numbers
        flat_cb = index.codebooks.reshape(m * n_codes, -1).to(torch.bfloat16)
        cb_off = torch.arange(m, device=q.device) * n_codes
        q_adc = q_eff.to(torch.bfloat16)
    in_window = torch.arange(window, dtype=torch.int32, device=q.device).repeat(wchunk)[None, :]

    parts_s, parts_p = [], []
    for wi in range(n_wchunks):
        ids_c = win_id[:, wi * wchunk : (wi + 1) * wchunk]  # [B, Wc]
        val_c = valid[:, wi * wchunk : (wi + 1) * wchunk]
        idx_c = ids_c.long()
        rid = rows_w[idx_c].reshape(b, rc)
        if do_refine:
            s = score_rows(refine_w[idx_c].reshape(b, rc, -1))  # rows [B, rc, R]
        else:
            cand = unpack(codes_w[idx_c]).reshape(b * rc, m)
            dec = flat_cb[cand.long() + cb_off[None, :]].reshape(b, rc, d)
            s = _gathered_dot(q_adc, dec)
        ok = val_c[:, :, None].expand(b, wchunk, window).reshape(b, rc) & (rid >= 0)
        if subs_w is not None:
            sub = subs_w[idx_c].reshape(b, rc)
            ok &= (sub[:, :, None] == allowed[:, None, :]).any(dim=-1) | (allowed < 0).all(dim=-1, keepdim=True)
        s = torch.where(ok, s, float("-inf"))
        pos = (ids_c[:, :, None] * window).expand(b, wchunk, window).reshape(b, rc) + in_window
        c_s, c_p = topk_lowest_first(s, kc)
        parts_s.append(c_s)
        parts_p.append(torch.gather(pos, -1, c_p))
    all_s, all_p = torch.cat(parts_s, dim=-1), torch.cat(parts_p, dim=-1)
    # spilled: gather 2 * pool (a row id may appear twice), dedup, then cut
    k_eff = min(2 * pool if index.spilled else pool, int(all_s.shape[-1]))
    top_s, sel = topk_lowest_first(all_s, k_eff)
    top_p = torch.gather(all_p, -1, sel)

    # sorted-layout positions -> original row ids
    top_i = index.row_ids[torch.clamp(top_p, 0, n_sorted - 1).long()]
    ok = torch.isfinite(top_s) & (top_p >= 0) & (top_i >= 0)
    top_s = torch.where(ok, top_s, float("-inf"))
    top_i = torch.where(ok, top_i + index.offset, -1)
    if index.spilled:
        top_s, top_i = _dedup_equal_rows(top_s, top_i, pool)
    if do_rerank:
        top_s, top_i = rerank_candidates(
            q, top_s, top_i, top_k, rerank_codes=index.rerank_codes, rerank_scale=index.rerank_scale,
            rerank_proj=index.rerank_proj, offset=index.offset,
        )
    if top_s.shape[-1] < top_k:
        padk = top_k - int(top_s.shape[-1])
        top_s = torch.nn.functional.pad(top_s, (0, padk), value=float("-inf"))
        top_i = torch.nn.functional.pad(top_i, (0, padk), value=-1)
    else:
        top_s, top_i = top_s[:, :top_k], top_i[:, :top_k]
    return RetrievalBatch(scores=top_s, indices=top_i.to(torch.int32))
