"""Dense MIPS indexes resident in device memory (port of `vod_tpu/search/dense.py`).

  * flat — raw bf16/f32 vectors, exhaustive scan with a running top-k;
  * int8 — per-dim symmetric int8 codes (1 byte/dim), int8 x int8 products
           summed exactly, the per-row query scale applied afterwards;
  * pq   — `PQIndex`: exhaustive ADC (decode + product over every row), or an
           int8 PCA-projected coarse scan whose candidates are ADC-rescored
           (or go straight to the re-rank), then an optional exact re-rank;
  * ivf  — `IVFIndex`: k-means cells padded to one slab size, nprobe probing.

`kernel="fused"` routes the flat/int8 scan, and the PQ coarse stage, through
the hand-written `fused_mips_binned` CUDA kernel (`ops/mips.py`), as
`kernel: fused` routes them through the Pallas kernel in the JAX package.
`build_pq_index_from_host` builds a PQ index from host slabs for corpora
whose embeddings do not fit on the device.

On the card every scan is exact: chunked products plus a stable top-k, which
is what the JAX package's `approx_max_k` does on the CPU. Float32 products run
in full float32 (TF32 off, see `ops.mips.set_full_f32_matmul`).

int8 products: PyTorch has no int8 matmul on the CPU, and on the card
`torch._int_mm` takes only more than 16 rows. The int8 scans of the PQ codec
(the coarse scan, the exhaustive ADC scan) therefore multiply their int8
operands in float32 with TF32 off (`_int8_dot`): every product is at most
127² and every partial sum an integer, so the sums are exact, as JAX's int32
accumulator is, while 127² · D < 2^24 (D ≤ 1040); wider rows go through
float64. The flat int8 codec keeps its float64 scan. JAX decodes the
exhaustive ADC scan by a one-hot product that only selects codebook rows;
here a gather of the same int8 rows gives the same decoded values.

The coarse int8 codes are stored with zero columns up to a multiple of 16
(`PQIndex.coarse_codes`), and the coarse queries get the same zero columns:
zeros add nothing to an int8 product, and D % 16 == 0 puts every coarse
`fused_mips_binned` call on the kernel's tensor-core body.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
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
    q_row_scale = torch.clamp(q_absmax, min=1e-8) / torch.full_like(q_absmax, 127.0)  # a tensor: exact on CUDA
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


# ---- PQ ---------------------------------------------------------------------------

_COARSE_COLS = 16  # coarse codes and queries get zero columns up to a multiple of this
_PQ_RESCORE_ELEMS = 1 << 27  # ~512MB f32 rescore gather cap


@dataclasses.dataclass
class PQIndex:
    """PQ-compressed index: exhaustive ADC or int8 coarse scan + ADC rescore.

    Three candidate-generation modes (chosen at build time):
      * exhaustive (`coarse_codes is None`): ADC over every row, as a decode +
        product scan (sum_m lut[m, code] equals q . decode(codes));
      * coarse: the int8 PCA-projected scan picks `n_candidates`, ADC
        rescores them;
      * coarse -> refine direct (`codes is None`, needs coarse + refine): the
        coarse scan's top k_factor * k go straight to the exact re-rank.
    An optional exact re-rank ("refine") rescores the top k_factor * k from
    `refine_codes` (int8 when `refine_scale` is set, else bf16/f32), in a
    truncated PCA space when `refine_proj` is set.
    """

    codebooks: torch.Tensor  # [M, n_codes, dsub] f32 (n_codes = 1 << code_bits)
    # [N, M] uint8, or [N, M//2] nibble-packed when code_bits=4; None = direct mode
    codes: typ.Optional[torch.Tensor]
    coarse_codes: typ.Optional[torch.Tensor] = None  # [N, dc up to a multiple of 16] int8, zeros past dc
    coarse_scale: typ.Optional[torch.Tensor] = None  # [1, dc] f32
    proj: typ.Optional[torch.Tensor] = None  # [D, dc] f32 PCA projection of the coarse stage
    rotation: typ.Optional[torch.Tensor] = None  # [D, D] OPQ rotation (None = identity)
    subset_ids: typ.Optional[torch.Tensor] = None  # [N] int32
    refine_codes: typ.Optional[torch.Tensor] = None  # [N, D or refine_dim] re-rank rows
    refine_scale: typ.Optional[torch.Tensor] = None  # [1, R] f32 when refine is int8
    refine_proj: typ.Optional[torch.Tensor] = None  # [D, refine_dim] PCA (None = raw rows)
    n_real: int = 0
    offset: int = 0
    n_candidates: int = 1024
    approx_recall: typ.Optional[float] = 0.95
    k_factor: int = 4  # refine pool = k_factor * k
    code_bits: int = 8  # 8 = PQ{M}x8; 4 = fast-scan PQ{M}x4 (16-entry codebooks, nibble-packed)
    # "fused" routes the coarse stage through `fused_mips_binned` (no subset
    # filter, approximate selection allowed, and a bins-aligned tile that
    # divides the padded rows; else the scan)
    kernel: str = "scan"
    fused_bins: int = 512
    fused_tile: int = 0  # corpus rows per kernel tile; 0 = max(1024, fused_bins)

    def replace(self, **changes: typ.Any) -> "PQIndex":
        return dataclasses.replace(self, **changes)


def index_nbytes(index: typ.Any) -> int:
    """Device bytes held by the tensors of an index."""
    return sum(
        v.numel() * v.element_size() for v in vars(index).values() if isinstance(v, torch.Tensor)
    )


def _zero_cols(x: torch.Tensor, width: int) -> torch.Tensor:
    """x with zero columns appended up to `width`."""
    pad = width - int(x.shape[-1])
    if pad <= 0:
        return x
    return torch.cat([x, x.new_zeros(tuple(x.shape[:-1]) + (pad,))], dim=-1)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _StageClock:
    """Adds the wall ms of each named stage to `out`, the device synchronized
    at both ends; times nothing when `out` is None."""

    def __init__(self, out: typ.Optional[dict], device: torch.device):
        self.out, self.device = out, device

    @contextlib.contextmanager
    def __call__(self, name: str) -> typ.Iterator[None]:
        if self.out is None:
            yield
            return
        _sync(self.device)
        t0 = time.perf_counter()
        yield
        _sync(self.device)
        self.out[name] = self.out.get(name, 0.0) + (time.perf_counter() - t0) * 1e3


def _build_refine(
    vectors: torch.Tensor,
    refine: str,
    pad_multiple: int,
    refine_dim: typ.Optional[int] = None,
    train: typ.Optional[torch.Tensor] = None,
) -> tuple[typ.Optional[torch.Tensor], typ.Optional[torch.Tensor], typ.Optional[torch.Tensor]]:
    """Re-rank row storage (faiss Refine). Returns (codes, scale, proj).
    `refine_dim` projects rows onto the top PCA directions of `train` first."""
    if refine == "none":
        return None, None, None
    x = _pad_rows(vectors.to(torch.float32), pad_multiple)
    proj = None
    if refine_dim is not None and refine_dim < x.shape[-1]:
        proj, _mean = pq_ops.train_projection(train if train is not None else vectors, refine_dim)
        set_full_f32_matmul()
        x = x @ proj
    if refine == "int8":
        codes, scale = pq_ops.quantize_int8(x, dim=0)
        return codes, scale, proj
    if refine in ("bfloat16", "float32"):
        return x.to(getattr(torch, refine)), None, proj
    raise ValueError(f"unknown refine codec {refine!r}")


def build_pq_index(
    vectors: typ.Union[torch.Tensor, np.ndarray],
    *,
    n_subquantizers: int = 32,
    coarse_dim: typ.Optional[int] = 32,
    n_candidates: int = 1024,
    train_size: typ.Optional[int] = None,
    kmeans_iters: int = 10,
    use_opq: bool = False,
    opq_iters: int = 4,
    refine: str = "none",
    refine_dim: typ.Optional[int] = None,
    k_factor: int = 4,
    subset_ids: typ.Union[torch.Tensor, np.ndarray, None] = None,
    offset: int = 0,
    pad_multiple: typ.Optional[int] = None,
    approx_recall: typ.Optional[float] = 0.95,
    code_bits: int = 8,
    aniso_eta: pq_ops.AnisoEta = None,
    keep_codes: bool = True,
    kernel: str = "scan",
    fused_bins: int = 512,
    fused_tile: int = 0,
    generator: typ.Optional[torch.Generator] = None,
    device: typ.Union[str, torch.device] = "cuda",
    timings: typ.Optional[dict] = None,
) -> PQIndex:
    """Build a PQ index on `device` (faiss `OPQ{M}_{d},PQ{M}x8[,RFlat]`;
    code_bits=4 is the fast-scan `PQ{M}x4fs` codec).

    coarse_dim=None builds the exhaustive-ADC index; an int adds the int8
    coarse scan. refine='int8'|'bfloat16'|'float32' stores rows for the exact
    re-rank of the top k_factor * k. keep_codes=False (needs coarse_dim and a
    refine store) trains no PQ: the coarse scan feeds the re-rank directly.
    Codebooks, OPQ and k-means draw from `generator` (default: seed 0 on the
    device, as JAX defaults to `PRNGKey(0)` in its factory). With `timings`,
    the wall ms of each stage is added to it under "train_pq_ms",
    "coarse_ms", "encode_ms" and "refine_ms" (the device is synchronized at
    each stage's ends)."""
    vectors = torch.as_tensor(vectors, device=device)
    dev = vectors.device
    n_real = int(vectors.shape[0])
    if code_bits not in (8, 4):
        raise ValueError(f"code_bits must be 8 or 4, got {code_bits}")
    if code_bits == 4 and n_subquantizers % 2:
        raise ValueError("code_bits=4 requires an even n_subquantizers (nibble packing)")
    if not keep_codes and (coarse_dim is None or refine == "none"):
        raise ValueError("keep_codes=False requires coarse_dim and a refine store")
    if kernel not in ("scan", "fused"):
        raise ValueError(f"kernel must be 'scan' or 'fused', got {kernel!r}")
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    clock = _StageClock(timings, dev)
    n_codes = 1 << code_bits
    pad_multiple = _auto_pad_multiple(n_real, pad_multiple)
    x = vectors.to(torch.float32)
    train = x if train_size is None or train_size >= n_real else x[:train_size]

    with clock("train_pq_ms"):
        if keep_codes:
            rotation, codebooks, aniso_resolved = pq_ops.train_pq_codebooks(
                train, n_subquantizers, n_codes=n_codes, kmeans_iters=kmeans_iters,
                use_opq=use_opq, opq_iters=opq_iters, aniso_eta=aniso_eta, generator=generator,
            )
        else:
            rotation, codebooks, aniso_resolved = None, torch.zeros((1, 1, 1), device=dev), None
        set_full_f32_matmul()
        x_rot = x if rotation is None else x @ rotation
        train_rot = train if rotation is None else train @ rotation

    coarse_codes = coarse_scale = proj = None
    with clock("coarse_ms"):
        if coarse_dim is not None:
            # MIPS is shift-sensitive: project without centering
            proj, _mean = pq_ops.train_projection(train_rot, coarse_dim)
            coarse_codes, coarse_scale = pq_ops.quantize_int8(x_rot @ proj, dim=0)
            width = -(-coarse_dim // _COARSE_COLS) * _COARSE_COLS
            coarse_codes = _pad_rows(_zero_cols(coarse_codes, width), pad_multiple).contiguous()

    codes = None
    with clock("encode_ms"):
        if keep_codes:
            codes = pq_ops.encode_pq_auto(codebooks, x_rot, eta=aniso_resolved)
            if code_bits == 4:
                codes = _pack_codes4(codes)
            codes = _pad_rows(codes, pad_multiple).contiguous()
    del x_rot, train_rot
    with clock("refine_ms"):
        refine_codes, refine_scale, refine_proj = _build_refine(x, refine, pad_multiple, refine_dim, train)
    if subset_ids is not None:
        subset_ids = _pad_rows(torch.as_tensor(subset_ids, device=dev).to(torch.int32), pad_multiple)
    return PQIndex(
        codebooks=codebooks, codes=codes, coarse_codes=coarse_codes, coarse_scale=coarse_scale, proj=proj,
        rotation=rotation, subset_ids=subset_ids, refine_codes=refine_codes, refine_scale=refine_scale,
        refine_proj=refine_proj, n_real=n_real, offset=offset, n_candidates=n_candidates,
        approx_recall=approx_recall, k_factor=k_factor, code_bits=code_bits, kernel=kernel,
        fused_bins=fused_bins, fused_tile=fused_tile,
    )


def _scan_collect_topk(
    score_chunk_fn: typ.Callable[[int], torch.Tensor],
    n_rows: int,
    n_real: int,
    batch: int,
    top_k: int,
    chunk: int,
    device: torch.device,
    per_chunk_k: typ.Optional[int] = None,
    approx_recall: typ.Optional[float] = 0.95,
    concentrated: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Candidate selection for a large k (the PQ coarse stage, wide refine
    pools): each chunk keeps a proportional share, ~4x oversampled with a
    floor of 32, and one final top-k runs over the stacked shares. With a
    subset filter (`concentrated`) or exact selection (`approx_recall=None`)
    every chunk keeps min(chunk, k): lossless. The same shares as the JAX
    version, so the same candidates: a plain top-k over every row could
    differ. Lowest id first on ties."""
    n_chunks = n_rows // chunk
    if per_chunk_k is None:
        if concentrated or approx_recall is None:
            per_chunk_k = min(chunk, top_k)
        else:
            per_chunk_k = min(chunk, max(32, -(-4 * top_k // n_chunks)))
    parts_s, parts_i = [], []
    for start in range(0, n_rows, chunk):
        s = score_chunk_fn(start)
        row_ids = torch.arange(start, start + chunk, device=device)
        s = torch.where(row_ids < n_real, s, float("-inf"))
        c_s, c_pos = topk_lowest_first(s, per_chunk_k)
        parts_s.append(c_s)
        parts_i.append((c_pos + start).to(torch.int32))
    all_s, all_i = torch.cat(parts_s, dim=-1), torch.cat(parts_i, dim=-1)
    k_eff = min(top_k, int(all_s.shape[-1]))
    top_s, pos = topk_lowest_first(all_s, k_eff)
    top_i = torch.gather(all_i, -1, pos)
    if k_eff < top_k:
        top_s = torch.nn.functional.pad(top_s, (0, top_k - k_eff), value=float("-inf"))
        top_i = torch.nn.functional.pad(top_i, (0, top_k - k_eff), value=-1)
    return top_s, torch.where(torch.isfinite(top_s), top_i, -1)


def decode_rows(codebooks: torch.Tensor, codes: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Reconstruct a block of rows from PQ codes: [c, M] -> [c, d] in `dtype`,
    by one flat lookup into the codebook table (JAX's `onehot=True` product
    only selects the same rows)."""
    m, k, dsub = codebooks.shape
    flat = codebooks.reshape(m * k, dsub).to(dtype)
    idx = codes.long() + (torch.arange(m, device=codes.device) * k)[None, :]
    return flat[idx].reshape(codes.shape[0], m * dsub)


def _pack_codes4(codes: torch.Tensor) -> torch.Tensor:
    """Nibble-pack 4-bit PQ codes two per byte, the even subquantizer in the
    low nibble: [..., M] (values < 16) -> [..., M//2] uint8."""
    lo = codes[..., 0::2].to(torch.uint8)
    hi = codes[..., 1::2].to(torch.uint8)
    return lo | (hi << 4)


def _unpack_codes4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of `_pack_codes4`: [..., M//2] -> [..., M] uint8 (values < 16)."""
    lo = packed & 15
    hi = packed >> 4
    return torch.stack([lo, hi], dim=-1).reshape(*packed.shape[:-1], -1)


def _int8_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [B, D] int8 . b [N, D] int8 -> [B, N] f32 holding the exact integer
    sums: float32 products (TF32 off) are exact while 127² · D < 2^24, else
    float64 is used."""
    set_full_f32_matmul()
    dt = torch.float32 if 127 * 127 * int(a.shape[-1]) < 2**24 else torch.float64
    return (a.to(dt) @ b.to(dt).T).to(torch.float32)


def _int8_codebooks(codebooks: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-subspace symmetric int8 codebooks and the scale vector that expands
    each subspace's scale over its dims: (cb_i8 [M, n_codes, dsub], [D])."""
    cb_absmax = torch.amax(torch.abs(codebooks), dim=(1, 2), keepdim=True)
    cb_scale = torch.clamp(cb_absmax, min=1e-8) / 127.0
    cb_i8 = torch.clamp(torch.round(codebooks / cb_scale), -127, 127).to(torch.int8)
    return cb_i8, cb_scale[:, 0, 0].repeat_interleave(codebooks.shape[-1])


def _int8_queries(q_eff: torch.Tensor, scale_vec: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Row-quantized int8 queries with the codebook scale folded in:
    (q_i8 [B, D], q_row_scale [B, 1])."""
    q_f = q_eff.to(torch.float32) * scale_vec
    q_row = torch.clamp(torch.amax(torch.abs(q_f), dim=-1, keepdim=True), min=1e-8) / 127.0
    return torch.clamp(torch.round(q_f / q_row), -127, 127).to(torch.int8), q_row


def _int8_adc_scan_inputs(
    codebooks: torch.Tensor, q_eff: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The int8 exhaustive-ADC scan's inputs: per-subspace-quantized codebooks
    and row-quantized queries with the codebook scale folded in. Returns
    (cb_i8 [M, n_codes, dsub], q_i8 [B, D], q_row_scale [B, 1])."""
    cb_i8, scale_vec = _int8_codebooks(codebooks)
    return (cb_i8, *_int8_queries(q_eff, scale_vec))


def _int8_onehot_adc_chunk(
    cb_i8: torch.Tensor, q_i8: torch.Tensor, q_row: torch.Tensor, c: torch.Tensor
) -> torch.Tensor:
    """Score one code chunk: the int8 codebook rows of the codes (JAX selects
    them by a one-hot product; a gather gives the same int8 rows), an exact
    int8 product (`_int8_dot`), scores rescaled to f32. `c` is unpacked codes
    [chunk, M]."""
    dec = decode_rows(cb_i8, c, dtype=torch.int8)
    return _int8_dot(q_i8, dec) * q_row


def _refine_rerank(
    index: PQIndex, q_orig: torch.Tensor, cand_s: torch.Tensor, cand_i: torch.Tensor, top_k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact re-rank of the candidates against the refine rows: gathers
    [B, K, R] rows, K = k_factor * top_k; local ids (offset not yet applied)."""
    set_full_f32_matmul()
    n = int(index.refine_codes.shape[0])
    raw = index.refine_codes[torch.clamp(cand_i, 0, n - 1).long()]  # [B, K, R]
    q = q_orig.to(torch.float32)
    if index.refine_proj is not None:  # truncated-PCA refine: project the queries
        q = q @ index.refine_proj
    if index.refine_scale is not None:  # int8 rows: fold the per-dim scale into q
        q = q * index.refine_scale
    else:  # bf16/f32 rows: the query rounded to the rows' dtype, products summed in f32
        q = q.to(raw.dtype).to(torch.float32)
    exact = torch.einsum("bd,bkd->bk", q, raw.to(torch.float32))
    exact = torch.where(torch.isfinite(cand_s), exact, float("-inf"))
    top_s, pos = topk_lowest_first(exact, top_k)
    return top_s, torch.gather(cand_i, -1, pos)


def pq_search(
    index: PQIndex,
    queries: SearchQueries,
    top_k: int,
    *,
    chunk: int = 131072,
    approx_recall: typ.Any = _FROM_INDEX,
) -> RetrievalBatch:
    """PQ search: exhaustive ADC (decode + product scan) or coarse scan + ADC
    rescore (or direct), then the optional exact re-rank of the top
    k_factor * k candidates. Query batches whose rescore gathers would
    exceed ~512 MB are searched in chunks of queries."""
    if approx_recall is _FROM_INDEX:
        approx_recall = index.approx_recall
    q = queries.vector
    if q is None:
        raise ValueError("pq_search requires queries.vector")
    b = int(q.shape[0])
    exhaustive = index.coarse_codes is None
    do_refine = index.refine_codes is not None
    direct = index.codes is None  # coarse -> refine, no ADC stage
    if direct and (exhaustive or not do_refine):
        raise ValueError("PQIndex built with keep_codes=False requires coarse + refine stores")
    store = index.coarse_codes if direct else index.codes
    n = int(store.shape[0])
    dev = store.device
    if exhaustive:
        # the chunk caps bound the decoded [chunk, D] temp
        chunk = min(chunk, 32768 if do_refine and index.code_bits == 8 else 65536)
    chunk = min(chunk, n)
    while n % chunk != 0:
        chunk -= 128
    n_cand = min(index.n_candidates, n)
    n_pool = min(index.k_factor * top_k, n) if do_refine else top_k

    # cap the [B, n_cand, M] ADC and [B, n_pool, R] refine gathers at ~512MB
    m_sub = int(index.codebooks.shape[0])
    r_dim = int(index.refine_codes.shape[-1]) if do_refine else 0
    per_q = (n_cand * m_sub if not (exhaustive or direct) else 0) + n_pool * r_dim
    qchunk = max(8, _PQ_RESCORE_ELEMS // max(1, per_q))
    if b > qchunk:
        sub = queries.subset_ids
        outs = [
            pq_search(
                index, SearchQueries(vector=q[s : s + qchunk], subset_ids=None if sub is None else sub[s : s + qchunk]),
                top_k, chunk=chunk, approx_recall=approx_recall,
            )
            for s in range(0, b, qchunk)
        ]
        return RetrievalBatch(
            scores=torch.cat([o.scores for o in outs]), indices=torch.cat([o.indices for o in outs])
        )

    set_full_f32_matmul()
    q_eff = q.to(torch.float32)
    if index.rotation is not None:  # OPQ: rotate queries into codebook space
        q_eff = q_eff @ index.rotation
    allowed = queries.subset_ids
    # subset filtering can put every finite score in one chunk: proportional
    # candidate collection must not truncate there (see _scan_collect_topk)
    filtered = allowed is not None and index.subset_ids is not None

    def _mask_chunk(s: torch.Tensor, start: int) -> torch.Tensor:
        if filtered:
            s = torch.where(_subset_ok(index, allowed, start, chunk), s, float("-inf"))
        return s

    if exhaustive:
        unpack = _unpack_codes4 if index.code_bits == 4 else (lambda c: c)
        if do_refine:
            # with a re-rank fixing the final order, the scan runs in int8
            # (the codebook scale folded into the query)
            cb_i8, q_i8, q_row = _int8_adc_scan_inputs(index.codebooks, q_eff)

            def score_chunk(start: int) -> torch.Tensor:
                c = unpack(index.codes[start : start + chunk])
                return _mask_chunk(_int8_onehot_adc_chunk(cb_i8, q_i8, q_row, c), start)
        else:

            def score_chunk(start: int) -> torch.Tensor:
                dec = decode_rows(index.codebooks, unpack(index.codes[start : start + chunk]))
                return _mask_chunk(q_eff @ dec.T, start)

        if approx_recall is not None and n_pool > 64:
            pool_s, pool_i = _scan_collect_topk(
                score_chunk, n, index.n_real, b, n_pool, chunk, dev,
                approx_recall=approx_recall, concentrated=filtered,
            )
        else:
            pool_s, pool_i = _scan_topk(score_chunk, n, index.n_real, b, n_pool, chunk, dev)
    else:
        # stage 1: coarse int8 scores over every row; the row-quantized query
        # keeps the order (its positive scale factors out of the int sum)
        q_proj = (q_eff @ index.proj) * index.coarse_scale  # [B, dc]
        q_cr = torch.clamp(torch.amax(torch.abs(q_proj), dim=-1, keepdim=True), min=1e-8) / 127.0
        q_ci8 = torch.clamp(torch.round(q_proj / q_cr), -127, 127).to(torch.int8)
        q_ci8 = _zero_cols(q_ci8, int(index.coarse_codes.shape[1])).contiguous()

        def score_chunk(start: int) -> torch.Tensor:
            acc = _int8_dot(q_ci8, index.coarse_codes[start : start + chunk])
            return _mask_chunk(acc * q_cr, start)

        n_stage1 = n_pool if direct else n_cand
        use_fused = index.kernel == "fused" and allowed is None and approx_recall is not None
        if use_fused:
            f_bins = index.fused_bins
            f_tile = index.fused_tile or max(1024, f_bins)
            if n % f_tile != 0 or f_tile % f_bins != 0:
                f_tile = max(1024, f_bins)
            use_fused = n % f_tile == 0 and f_tile % f_bins == 0
        if use_fused:
            cand_s, cand_i = fused_mips_binned(
                index.coarse_codes, q_ci8, k=min(n_stage1, f_bins), n_real=index.n_real, bins=f_bins, tile=f_tile,
            )
            cand_s = torch.where(cand_i >= 0, cand_s.to(torch.float32) * q_cr, float("-inf"))
        else:
            cand_s, cand_i = _scan_collect_topk(
                score_chunk, n, index.n_real, b, n_stage1, chunk, dev,
                approx_recall=approx_recall, concentrated=filtered,
            )

        if direct:
            pool_s, pool_i = cand_s, cand_i
        else:
            # stage 2: ADC rescore of the candidates
            cand_codes = index.codes[torch.clamp(cand_i, 0, n - 1).long()]  # [B, n_cand, M (or M//2)]
            if index.code_bits == 4:
                cand_codes = _unpack_codes4(cand_codes)
            adc = pq_ops.adc_score_codes(pq_ops.adc_lut(index.codebooks, q_eff), cand_codes)
            adc = torch.where(torch.isfinite(cand_s), adc, float("-inf"))
            pool_s, pos = topk_lowest_first(adc, min(n_pool, int(adc.shape[-1])))
            pool_i = torch.gather(cand_i, -1, pos)

    if pool_s.shape[-1] < top_k:  # tiny corpus / n_candidates < k
        pad = top_k - int(pool_s.shape[-1])
        pool_s = torch.nn.functional.pad(pool_s, (0, pad), value=float("-inf"))
        pool_i = torch.nn.functional.pad(pool_i, (0, pad), value=-1)
    if do_refine:
        top_s, top_i = _refine_rerank(index, q, pool_s, pool_i, top_k)
    else:
        top_s, top_i = pool_s[:, :top_k], pool_i[:, :top_k]
    finite = torch.isfinite(top_s)
    return RetrievalBatch(scores=top_s, indices=torch.where(finite, top_i + index.offset, -1))


# ---- IVF --------------------------------------------------------------------------


@dataclasses.dataclass
class IVFIndex:
    """IVF: k-means cells, each padded to one slab size, nprobe probing (faiss
    `IVF{n},Flat`)."""

    centroids: torch.Tensor  # [C, D] f32
    vectors: torch.Tensor  # [C, S, D] cluster-padded rows
    row_ids: torch.Tensor  # [C, S] int32 original row ids, -1 pad
    subset_ids: typ.Optional[torch.Tensor] = None  # [C, S]
    nprobe: int = 8
    offset: int = 0

    def replace(self, **changes: typ.Any) -> "IVFIndex":
        return dataclasses.replace(self, **changes)


def build_ivf_index(
    vectors: typ.Union[torch.Tensor, np.ndarray],
    *,
    n_clusters: typ.Optional[int] = None,
    nprobe: int = 8,
    kmeans_iters: int = 10,
    train_size: typ.Optional[int] = None,
    dtype: str = "bfloat16",
    subset_ids: typ.Union[torch.Tensor, np.ndarray, None] = None,
    offset: int = 0,
    generator: typ.Optional[torch.Generator] = None,
    device: typ.Union[str, torch.device] = "cuda",
) -> IVFIndex:
    """Build IVF cells on `device` (`IVFauto` when n_clusters is None):
    k-means on the first `train_size` rows, every row assigned to its
    nearest centroid, rows bucketed on the host into slabs padded to a
    multiple of 128. k-means draws from `generator` (default: seed 0)."""
    from vod_tpu_torch.ops.kmeans import _assign_chunked, infer_n_clusters, kmeans

    vectors = torch.as_tensor(vectors, device=device)
    dev = vectors.device
    n, d = (int(s) for s in vectors.shape)
    c = n_clusters or infer_n_clusters(n)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    x = vectors.to(torch.float32)
    train = x if train_size is None or train_size >= n else x[:train_size]
    centroids, _ = kmeans(train, n_clusters=c, n_iters=kmeans_iters, generator=generator)
    assign = _assign_chunked(x, centroids).cpu().numpy()
    order = np.argsort(assign, kind="stable")
    counts = np.bincount(assign[order], minlength=c)
    s = int(max(128, ((counts.max() + 127) // 128) * 128))
    slot = np.arange(n) - np.repeat(np.cumsum(counts) - counts, counts)  # position inside its cell
    cell = assign[order]
    slabs = torch.zeros((c, s, d), dtype=getattr(torch, dtype), device=dev)
    slabs[torch.from_numpy(cell).to(dev), torch.from_numpy(slot).to(dev)] = x[torch.from_numpy(order).to(dev)].to(slabs.dtype)
    row_ids = np.full((c, s), -1, dtype=np.int32)
    row_ids[cell, slot] = order
    subs = None
    if subset_ids is not None:
        sub_np = np.asarray(torch.as_tensor(subset_ids).cpu()).astype(np.int32)
        subs_np = np.full((c, s), -1, dtype=np.int32)
        subs_np[cell, slot] = sub_np[order]
        subs = torch.from_numpy(subs_np).to(dev)
    return IVFIndex(
        centroids=centroids, vectors=slabs, row_ids=torch.from_numpy(row_ids).to(dev), subset_ids=subs,
        nprobe=nprobe, offset=offset,
    )


def ivf_search(index: IVFIndex, queries: SearchQueries, top_k: int) -> RetrievalBatch:
    """Probe the nprobe nearest cells per query, score their slabs, top-k."""
    q = queries.vector
    if q is None:
        raise ValueError("ivf_search requires queries.vector")
    set_full_f32_matmul()
    b = int(q.shape[0])
    c, s, _ = (int(x) for x in index.vectors.shape)
    nprobe = min(index.nprobe, c)
    _, probe = topk_lowest_first(q.to(torch.float32) @ index.centroids.T, nprobe)  # [B, P]
    allowed = queries.subset_ids
    q_v = q.to(index.vectors.dtype).to(torch.float32)  # products of the slab dtype, summed in f32
    probe_s, probe_i = [], []
    for p in range(nprobe):
        cell = probe[:, p]
        slab = index.vectors[cell].to(torch.float32)  # [B, S, D]
        ids = index.row_ids[cell]  # [B, S]
        sc = torch.einsum("bd,bsd->bs", q_v, slab)
        sc = torch.where(ids >= 0, sc, float("-inf"))
        if allowed is not None and index.subset_ids is not None:
            sub = index.subset_ids[cell]
            ok = (sub[:, :, None] == allowed[:, None, :]).any(dim=-1) | (allowed < 0).all(dim=-1, keepdim=True)
            sc = torch.where(ok, sc, float("-inf"))
        ts, tp = topk_lowest_first(sc, min(top_k, s))
        probe_s.append(ts)
        probe_i.append(torch.gather(ids, -1, tp))
    all_s = torch.stack(probe_s, dim=1).reshape(b, -1)
    all_i = torch.stack(probe_i, dim=1).reshape(b, -1)
    top_s, pos = topk_lowest_first(all_s, top_k)
    top_i = torch.gather(all_i, -1, pos)
    ok = torch.isfinite(top_s)
    return RetrievalBatch(scores=top_s, indices=torch.where(ok, top_i + index.offset, -1))


# ---- host slabs -------------------------------------------------------------------


def _slab_on(vectors_np: typ.Any, s0: int, slab: int, device: torch.device) -> torch.Tensor:
    """Rows [s0, s0 + slab) of a host matrix as f32 on `device`."""
    return torch.as_tensor(np.ascontiguousarray(vectors_np[s0 : s0 + slab]), device=device).to(torch.float32)


def build_pq_index_from_host(
    vectors_np: typ.Any,  # numpy [N, D] in host RAM; may exceed device memory
    *,
    n_subquantizers: int = 32,
    coarse_dim: typ.Optional[int] = 32,
    n_candidates: int = 1024,
    train_size: int = 500_000,
    kmeans_iters: int = 10,
    use_opq: bool = False,
    refine: str = "none",
    refine_dim: typ.Optional[int] = None,
    k_factor: int = 4,
    slab: int = 1_000_000,
    subset_ids: typ.Union[torch.Tensor, np.ndarray, None] = None,
    offset: int = 0,
    approx_recall: typ.Optional[float] = 0.95,
    code_bits: int = 8,
    aniso_eta: pq_ops.AnisoEta = None,
    keep_codes: bool = True,
    kernel: str = "scan",
    fused_bins: int = 512,
    fused_tile: int = 0,
    generator: typ.Optional[torch.Generator] = None,
    device: typ.Union[str, torch.device] = "cuda",
    timings: typ.Optional[dict] = None,
) -> PQIndex:
    """PQ build for corpora larger than device memory (faiss's chunked
    train + add): train on the first `train_size` rows, then encode host
    slabs on `device` one at a time. Only the codes (M [+ the coarse width]
    [+ R for int8 refine] bytes a row) accumulate on the device, written in
    place slab by slab.

    refine='int8' stores int8 re-rank rows (D, or refine_dim in the
    truncated-PCA space), their scale and projection taken from the training
    sample; bf16/f32 refine is refused. `keep_codes=False` (needs coarse_dim
    and refine) builds the serving codec: coarse scan -> direct refine.
    Draws come from `generator` (default: seed 0 on the device). With
    `timings`, the wall ms of "train_ms" and "encode_ms" are added to it."""
    if refine not in ("none", "int8"):
        raise ValueError(f"host-slab PQ build supports refine none|int8, got {refine!r}")
    if code_bits not in (8, 4):
        raise ValueError(f"code_bits must be 8 or 4, got {code_bits}")
    if code_bits == 4 and n_subquantizers % 2:
        raise ValueError("code_bits=4 requires an even n_subquantizers (nibble packing)")
    if not keep_codes and (coarse_dim is None or refine == "none"):
        raise ValueError("keep_codes=False requires coarse_dim and a refine store")
    if kernel not in ("scan", "fused"):
        raise ValueError(f"kernel must be 'scan' or 'fused', got {kernel!r}")
    dev = torch.device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    clock = _StageClock(timings, dev)
    n_real, d = (int(s) for s in vectors_np.shape)

    with clock("train_ms"):
        train = _slab_on(vectors_np, 0, train_size, dev)
        if keep_codes:
            rotation, codebooks, aniso_resolved = pq_ops.train_pq_codebooks(
                train, n_subquantizers, n_codes=1 << code_bits, kmeans_iters=kmeans_iters, use_opq=use_opq,
                opq_iters=4, aniso_eta=aniso_eta, generator=generator,
            )
        else:
            rotation, codebooks, aniso_resolved = None, torch.zeros((1, 1, 1), device=dev), None
        set_full_f32_matmul()
        train_rot = train if rotation is None else train @ rotation
        proj = coarse_scale = None
        if coarse_dim is not None:
            proj, _mean = pq_ops.train_projection(train_rot, coarse_dim)
            _, coarse_scale = pq_ops.quantize_int8(train_rot @ proj, dim=0)
        refine_scale = refine_proj = None
        if refine == "int8":
            ref_sample = train
            if refine_dim is not None and refine_dim < d:
                refine_proj, _mean = pq_ops.train_projection(train, refine_dim)
                ref_sample = train @ refine_proj
            _, refine_scale = pq_ops.quantize_int8(ref_sample, dim=0)
            del ref_sample
        del train, train_rot

    pad_multiple = _auto_pad_multiple(n_real, None)
    n_pad = -(-n_real // pad_multiple) * pad_multiple
    code_cols = n_subquantizers // 2 if code_bits == 4 else n_subquantizers
    codes = torch.zeros((n_pad, code_cols), dtype=torch.uint8, device=dev) if keep_codes else None
    coarse_codes = None
    if coarse_dim is not None:
        width = -(-coarse_dim // _COARSE_COLS) * _COARSE_COLS  # zero columns up to the tensor-core width
        coarse_codes = torch.zeros((n_pad, width), dtype=torch.int8, device=dev)
    r_dim = d if refine_dim is None else min(refine_dim, d)
    refine_codes = torch.zeros((n_pad, r_dim), dtype=torch.int8, device=dev) if refine == "int8" else None

    def int8_rows(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)

    with clock("encode_ms"):
        for s0 in range(0, n_real, slab):
            x = _slab_on(vectors_np, s0, slab, dev)
            s1 = s0 + int(x.shape[0])
            set_full_f32_matmul()
            xr = x if rotation is None else x @ rotation
            if codes is not None:
                c = pq_ops.encode_pq_auto(codebooks, xr, eta=aniso_resolved)
                codes[s0:s1] = _pack_codes4(c) if code_bits == 4 else c
            if coarse_codes is not None:
                coarse_codes[s0:s1, :coarse_dim] = int8_rows(xr @ proj, coarse_scale)
            if refine_codes is not None:
                refine_codes[s0:s1] = int8_rows(x if refine_proj is None else x @ refine_proj, refine_scale)
            del x, xr

    if subset_ids is not None:
        subset_ids = _pad_rows(torch.as_tensor(subset_ids, device=dev).to(torch.int32), pad_multiple)
    return PQIndex(
        codebooks=codebooks, codes=codes, coarse_codes=coarse_codes, coarse_scale=coarse_scale, proj=proj,
        rotation=rotation, subset_ids=subset_ids, refine_codes=refine_codes, refine_scale=refine_scale,
        refine_proj=refine_proj, n_real=n_real, offset=offset, n_candidates=n_candidates,
        approx_recall=approx_recall, k_factor=k_factor, code_bits=code_bits, kernel=kernel,
        fused_bins=fused_bins, fused_tile=fused_tile,
    )
