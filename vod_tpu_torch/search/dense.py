"""Flat dense MIPS indexes resident in device memory (port of the flat and int8
codecs of `vod_tpu/search/dense.py`).

  * flat — raw bf16/f32 vectors, exhaustive scan with a running top-k;
  * int8 — per-dim symmetric int8 codes (1 byte/dim), int8 x int8 products
           summed exactly, the per-row query scale applied afterwards.

`kernel="fused"` routes the scan through the hand-written `fused_mips_binned`
CUDA kernel (`ops/mips.py`), as `kernel: fused` routes it through the Pallas
kernel in the JAX package. PQ, IVF and the host-slab indexes are not ported yet.

On the card the scan is exact: chunked matmul plus a stable top-k, which is
what the JAX package's `approx_max_k` does on the CPU. Float32 products run in
full float32 (TF32 off, see `ops.mips.set_full_f32_matmul`).
"""

from __future__ import annotations

import dataclasses
import typing as typ

import numpy as np
import torch

from vod_tpu_torch.ops import pq as pq_ops
from vod_tpu_torch.ops.mips import fused_mips_binned, set_full_f32_matmul
from vod_tpu_torch.ops.numpy_ops import topk_lowest_first
from vod_tpu_torch.types.retrieval import RetrievalBatch
from .base import SearchQueries


@dataclasses.dataclass
class DenseIndex:
    """Flat (optionally int8-quantized) dense index."""

    vectors: torch.Tensor  # [N, D] bf16/f32, or int8 codes
    scale: typ.Optional[torch.Tensor] = None  # [1, D] f32 when int8
    subset_ids: typ.Optional[torch.Tensor] = None  # [N] int32
    # Optional exact-f32 re-rank rows (faiss `Flat,RFlat` analogue): the scan or
    # kernel selects k_factor*k candidates from the bf16/int8 store, then a
    # gather + full-f32 product restores exact f32 ordering of that pool.
    refine_rows: typ.Optional[torch.Tensor] = None  # [N, D] f32
    n_real: int = 0  # rows before padding
    offset: int = 0  # global-id offset
    k_factor: int = 4  # refine pool = k_factor * k
    # None = exact selection; any other value lets `kernel="fused"` run (the
    # binned kernel is approximate). The scan itself is exact either way.
    approx_recall: typ.Optional[float] = 0.95
    kernel: str = "scan"  # "scan" | "fused"
    # bins of the fused kernel: more bins, higher recall (~1-(k-1)/(2*bins)).
    # The TPU's `fused_qblock` has no counterpart: it never changed results.
    fused_bins: int = 512

    def replace(self, **changes: typ.Any) -> "DenseIndex":
        return dataclasses.replace(self, **changes)


def _pad_rows(x: torch.Tensor, multiple: int) -> torch.Tensor:
    pad = (-x.shape[0]) % multiple
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))], dim=0)
    return x


def _auto_pad_multiple(n: int, requested: typ.Optional[int]) -> int:
    """Row-padding granularity: 128 for small corpora (one chunk), 8192 for large
    ones so the chunked scan always finds a well-sized divisor chunk."""
    if requested is not None:
        return requested
    return 128 if n <= 131072 else 8192


def build_dense_index(
    vectors: typ.Union[torch.Tensor, np.ndarray],
    *,
    subset_ids: typ.Union[torch.Tensor, np.ndarray, None] = None,
    dtype: str = "bfloat16",
    offset: int = 0,
    pad_multiple: typ.Optional[int] = None,
    approx_recall: typ.Optional[float] = 0.95,
    kernel: str = "scan",
    refine: str = "none",
    k_factor: int = 4,
    device: typ.Union[str, torch.device] = "cuda",
) -> DenseIndex:
    """Build a flat index on `device` (parity: faiss `Flat`).

    dtype: 'float32' | 'bfloat16' | 'int8'. Rows are padded (to 1024 for
    kernel='fused', the kernel's row tile on the TPU); padded rows are masked
    through n_real. refine='float32' also keeps exact f32 rows for the re-rank.
    """
    vectors = torch.as_tensor(vectors, device=device)
    n_real = int(vectors.shape[0])
    if kernel not in ("scan", "fused"):
        raise ValueError(f"kernel must be 'scan' or 'fused', got {kernel!r}")
    if kernel == "fused":
        pad_multiple = max(pad_multiple or 0, 1024)
    pad_multiple = _auto_pad_multiple(n_real, pad_multiple)
    vectors = _pad_rows(vectors, pad_multiple)
    if subset_ids is not None:
        subset_ids = _pad_rows(torch.as_tensor(subset_ids, device=device).to(torch.int32), pad_multiple)
    refine_rows = None
    if refine == "float32":
        refine_rows = vectors.to(torch.float32)
    elif refine != "none":
        raise ValueError(f"flat refine must be 'none' or 'float32', got {refine!r}")
    scale = None
    if dtype == "int8":
        vectors, scale = pq_ops.quantize_int8(vectors.to(torch.float32), dim=0)
    elif dtype in ("bfloat16", "float32"):
        vectors = vectors.to(getattr(torch, dtype))
    else:
        raise ValueError(f"dtype must be 'float32', 'bfloat16' or 'int8', got {dtype!r}")
    return DenseIndex(
        vectors=vectors.contiguous(), scale=scale, subset_ids=subset_ids, n_real=n_real,
        offset=offset, approx_recall=approx_recall, kernel=kernel,
        refine_rows=refine_rows, k_factor=k_factor,
    )


def _scan_topk(
    score_chunk_fn: typ.Callable[[int], torch.Tensor],  # chunk start -> [B, chunk] f32
    n_rows: int,
    n_real: int,
    batch: int,
    top_k: int,
    chunk: int,
    device: torch.device,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Streaming exact top-k over corpus chunks with a running (scores, ids)
    carry; rows at or past n_real score -inf; lowest id first on ties."""
    top_s = torch.full((batch, top_k), float("-inf"), dtype=torch.float32, device=device)
    top_i = torch.full((batch, top_k), -1, dtype=torch.int32, device=device)
    for start in range(0, n_rows, chunk):
        s = score_chunk_fn(start)
        row_ids = torch.arange(start, start + chunk, device=device)
        s = torch.where(row_ids < n_real, s, float("-inf"))
        c_s, c_pos = topk_lowest_first(s, top_k)
        c_i = (c_pos + start).to(torch.int32)
        all_s = torch.cat([top_s, c_s], dim=-1)
        all_i = torch.cat([top_i, c_i], dim=-1)
        top_s, pos = topk_lowest_first(all_s, top_k)
        top_i = torch.gather(all_i, -1, pos)
    return top_s, top_i


def quantize_queries_int8(q: torch.Tensor, scale: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """int8 codec queries: fold the per-dim corpus scale into the query, then
    quantize it per row. Returns (codes int8 [B, D], row scale f32 [B, 1]);
    score = row scale * (codes . corpus codes)."""
    q_f = q.to(torch.float32) * scale
    q_absmax = torch.amax(torch.abs(q_f), dim=-1, keepdim=True)
    q_row_scale = torch.clamp(q_absmax, min=1e-8) / 127.0
    return torch.clamp(torch.round(q_f / q_row_scale), -127, 127).to(torch.int8), q_row_scale


_FROM_INDEX = "from_index"  # sentinel: take approx_recall from the index config


def _subset_ok(index: DenseIndex, allowed: torch.Tensor, start: int, chunk: int) -> torch.Tensor:
    sub = index.subset_ids[start : start + chunk]
    match = sub[None, None, :] == allowed[:, :, None]
    return match.any(dim=1) | (allowed < 0).all(dim=-1, keepdim=True)


def dense_search(
    index: DenseIndex,
    queries: SearchQueries,
    top_k: int,
    *,
    chunk: int = 131072,
    approx_recall: typ.Any = _FROM_INDEX,
) -> RetrievalBatch:
    """Exhaustive MIPS over a flat index with optional subset filtering.

    `kernel="fused"` takes the CUDA kernel only with no subset filter and
    `approx_recall is not None`; otherwise the exact scan runs."""
    if approx_recall is _FROM_INDEX:
        approx_recall = index.approx_recall
    q = queries.vector
    if q is None:
        raise ValueError("dense_search requires queries.vector")
    b = int(q.shape[0])
    n = int(index.vectors.shape[0])
    device = index.vectors.device
    chunk = min(chunk, n)
    if n % chunk != 0:
        # fall back to a divisor-friendly chunk (rows are padded to 128s)
        chunk = n if n <= 131072 else 128 * (n // 128 // max(1, n // 131072))
        while n % chunk != 0:
            chunk -= 128
    allowed = queries.subset_ids
    filtered = allowed is not None and index.subset_ids is not None
    use_kernel = index.kernel == "fused" and allowed is None and approx_recall is not None

    # exact-f32 refine: the scan/kernel selects a k_factor*k candidate pool;
    # `_finish` rescores it from the f32 rows and cuts back to top_k
    refine = index.refine_rows is not None
    sel_k = min(index.k_factor * top_k, n) if refine else top_k

    def _finish(top_s: torch.Tensor, top_i: torch.Tensor) -> RetrievalBatch:
        if refine:
            top_s, top_i = _flat_refine_rerank(index, q, top_s, top_i, top_k)
        top_i = torch.where(top_i >= 0, top_i + index.offset, top_i)
        return RetrievalBatch(scores=top_s, indices=top_i)

    if index.scale is not None:
        q_i8, q_row_scale = quantize_queries_int8(q, index.scale)

        if use_kernel:
            top_s, top_i = fused_mips_binned(
                index.vectors, q_i8, k=min(sel_k, index.fused_bins),
                n_real=index.n_real, bins=index.fused_bins,
            )
            top_s = top_s.to(torch.float32) * q_row_scale
            top_s = torch.where(top_i >= 0, top_s, float("-inf"))
            return _finish(top_s, top_i)

        q_64 = q_i8.to(torch.float64)

        def score_chunk_i8(start: int) -> torch.Tensor:
            v = index.vectors[start : start + chunk].to(torch.float64)
            # int8 products summed in float64 are exact, as the int32 accumulator is
            s = (q_64 @ v.T).to(torch.float32) * q_row_scale
            if filtered:
                s = torch.where(_subset_ok(index, allowed, start, chunk), s, float("-inf"))
            return s

        top_s, top_i = _scan_topk(score_chunk_i8, n, index.n_real, b, sel_k, chunk, device)
        return _finish(top_s, top_i)

    q_eff = q.to(index.vectors.dtype)

    if use_kernel:
        top_s, top_i = fused_mips_binned(
            index.vectors, q_eff.contiguous(), k=min(sel_k, index.fused_bins),
            n_real=index.n_real, bins=index.fused_bins,
        )
        return _finish(top_s, top_i)

    set_full_f32_matmul()
    q_32 = q_eff.to(torch.float32)

    def score_chunk(start: int) -> torch.Tensor:
        v = index.vectors[start : start + chunk].to(torch.float32)
        s = q_32 @ v.T
        if filtered:
            s = torch.where(_subset_ok(index, allowed, start, chunk), s, float("-inf"))
        return s

    top_s, top_i = _scan_topk(score_chunk, n, index.n_real, b, sel_k, chunk, device)
    return _finish(top_s, top_i)


def _flat_refine_rerank(
    index: DenseIndex, q: torch.Tensor, cand_s: torch.Tensor, cand_i: torch.Tensor, top_k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact-f32 rescore of the candidate pool: gather the candidates' f32 rows
    and re-order by a full-f32 product. Candidates the first stage filtered
    (-inf score) or never filled (id -1) stay excluded."""
    set_full_f32_matmul()
    valid = torch.isfinite(cand_s) & (cand_i >= 0)
    rows = index.refine_rows[cand_i.clamp(min=0).long()]  # [B, K, D]
    s = torch.einsum("bd,bkd->bk", q.to(torch.float32), rows)
    s = torch.where(valid, s, float("-inf"))
    k_eff = min(top_k, s.shape[-1])
    new_s, pos = topk_lowest_first(s, k_eff)
    new_i = torch.gather(cand_i, -1, pos)
    if k_eff < top_k:
        pad = top_k - k_eff
        new_s = torch.nn.functional.pad(new_s, (0, pad), value=float("-inf"))
        new_i = torch.nn.functional.pad(new_i, (0, pad), value=-1)
    return new_s, torch.where(torch.isfinite(new_s), new_i, -1)
