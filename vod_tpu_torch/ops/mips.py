"""Fused MIPS: the port of `vod_tpu/ops/mips_pallas.py`'s two kernels.

`fused_mips_binned` (approximate): scores `s = q . v` are folded into `bins`
running (score, id) cells per query, bin(j) = j mod bins over global row ids,
with the lowest row id winning a tie. On the card the folding happens inside
the hand-written CUDA kernel `csrc/fused_mips_binned.cu`, so no `[B, N]` score
array exists in device memory; `k` of the `[B, bins]` cells are then selected
here, in the order `lax.top_k` gives. Expected recall@k is about
1 - (k-1)/(2*bins).

`fused_mips_topk` (exact): the k highest scores per query, by (score
descending, row id ascending), from the CUDA kernel `csrc/fused_mips_topk.cu`.

Each wrapper launches its kernel for a CUDA tensor and raises if it cannot; for
a CPU tensor it runs its `*_reference`, the plain PyTorch version of the same
function, which the CPU tests compare with JAX.
"""

from __future__ import annotations

import ctypes
import threading
import typing as typ

import torch

from .numpy_ops import topk_lowest_first

_INT32_MIN = -(2**31) + 1  # empty int8 cell (the TPU kernel's sentinel, note the +1)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_QUERY_TILE = 64  # queries per block in both CUDA kernels
_BIN_TILE = 64  # bins per block in the binned kernel
_ROW_TILE = 64  # rows per tile in the exact kernel
_K_MAX = 128  # widest exact top-k (the TPU kernel's _K_PAD)
_REF_CHUNK_ELEMS = 1 << 25  # score elements per chunk of the plain versions


def set_full_f32_matmul() -> None:
    """Make float32 products on the card run in full float32, not TF32. Both
    flags are global to the process; the port sets them wherever it computes a
    float32 product that must match an f32 reference (the plain kernel version,
    the exact re-rank)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _check_pair(vectors: torch.Tensor, queries: torch.Tensor) -> None:
    if vectors.ndim != 2 or queries.ndim != 2 or vectors.shape[1] != queries.shape[1]:
        raise ValueError(f"expected vectors [N, D] and queries [B, D], got {tuple(vectors.shape)} and {tuple(queries.shape)}")
    if vectors.device != queries.device:
        raise ValueError(f"vectors on {vectors.device} but queries on {queries.device}")


def _check(
    vectors: torch.Tensor, queries: torch.Tensor, k: int, bins: int, tile: int, n_real: int
) -> tuple[int, int, bool]:
    """Validate the call as the wrapper does; returns (effective bins, n_real, int8)."""
    _check_pair(vectors, queries)
    int8 = vectors.dtype == torch.int8
    if int8 != (queries.dtype == torch.int8):
        raise TypeError("an int8 corpus needs int8-quantized queries, and int8 queries an int8 corpus")
    for t in (vectors, queries):
        if t.dtype not in _DTYPE_CODES:
            raise TypeError(f"fused_mips_binned takes bfloat16, float32 or int8, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("fused_mips_binned needs contiguous vectors and queries")
    n = int(vectors.shape[0])
    tile = min(tile, n)
    bins_eff = min(bins, tile)  # the TPU kernel's clamp: bins never exceed one tile
    if tile <= 0 or n % tile != 0 or tile % bins_eff != 0:
        raise ValueError(f"need N % tile == 0 and tile % bins == 0 (N={n}, tile={tile}, bins={bins_eff})")
    if not 0 < k <= bins_eff:
        raise ValueError(f"need 0 < k <= effective bins, got k={k}, bins={bins_eff}")
    if n_real < 0:
        n_real = n
    if n_real > n:
        raise ValueError(f"n_real={n_real} exceeds the {n} rows")
    return bins_eff, int(n_real), int8


def binned_cells_reference(
    vectors: torch.Tensor, queries: torch.Tensor, bins: int, n_real: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel's cells: `[B, bins]` scores (f32, or
    int32 for int8) and row ids. Chunked `q @ vᵀ`, reshaped into
    `[B, rows/bins, bins]`, max with first-index ties, folded across chunks in
    row order with a strict `>`. int8 products are summed in float64, which
    holds every int8 dot product exactly."""
    set_full_f32_matmul()
    int8 = vectors.dtype == torch.int8
    b = int(queries.shape[0])
    compute = torch.float64 if int8 else torch.float32
    neg = float(_INT32_MIN) if int8 else float("-inf")
    dev = vectors.device
    cell_s = torch.full((b, bins), neg, dtype=compute, device=dev)
    cell_i = torch.full((b, bins), -1, dtype=torch.int32, device=dev)
    q = queries.to(compute)
    stop_all = -(-n_real // bins) * bins  # strides at or past n_real hold nothing
    chunk = bins * max(1, _REF_CHUNK_ELEMS // max(1, b * bins))
    big = torch.iinfo(torch.int32).max
    for start in range(0, stop_all, chunk):
        stop = min(start + chunk, stop_all)
        s = q @ vectors[start:stop].to(compute).T  # [B, rows]
        rows = torch.arange(start, stop, device=dev, dtype=torch.int32)
        s = torch.where(rows < n_real, s, neg).view(b, -1, bins)
        m = s.amax(dim=1)  # [B, bins]
        first = torch.where(s == m.unsqueeze(1), rows.view(1, -1, bins), big).amin(dim=1)
        better = m > cell_s
        cell_s = torch.where(better, m, cell_s)
        cell_i = torch.where(better, first, cell_i)
    return cell_s.to(torch.int32 if int8 else torch.float32), cell_i


def _sms(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _launch(
    wrapper: typ.Callable, vectors: torch.Tensor, queries: torch.Tensor, width: int, n_real: int,
    score_dtype: torch.dtype, splits: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel of `wrapper` (C entry `vod_<name>` of `csrc/<name>.cu`)
    on the current stream with the rows cut into `splits` ranges, count the
    launch on `wrapper.launches`, and return outputs `[B, width]` (scores,
    int32 ids). Both kernels take the same C arguments."""
    from .cuda_build import load_library

    name = wrapper.__name__
    fn = getattr(load_library(name), f"vod_{name}")
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    b, d = (int(x) for x in queries.shape)
    dev = vectors.device
    out_s = torch.empty((b, width), dtype=score_dtype, device=dev)
    out_i = torch.empty((b, width), dtype=torch.int32, device=dev)
    if b == 0:
        return out_s, out_i
    if splits > 1:
        part_s = torch.empty((splits, b, width), dtype=score_dtype, device=dev)
        part_i = torch.empty((splits, b, width), dtype=torch.int32, device=dev)
    else:
        part_s, part_i = out_s, out_i
    with torch.cuda.device(dev):  # the launch goes to the tensors' card; the caller's is restored
        err = fn(
            _DTYPE_CODES[vectors.dtype], queries.data_ptr(), vectors.data_ptr(),
            part_s.data_ptr(), part_i.data_ptr(), out_s.data_ptr(), out_i.data_ptr(),
            b, d, width, n_real, splits, torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {err}")
    with _launch_lock:  # server threads may call concurrently
        wrapper.launches += 1
    return out_s, out_i


def _kernel_cells(
    vectors: torch.Tensor, queries: torch.Tensor, bins: int, n_real: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the binned CUDA kernel; outputs `[B, bins]` cells."""
    int8 = vectors.dtype == torch.int8
    b, d = (int(x) for x in queries.shape)
    if int8 and (d % 4 or vectors.data_ptr() % 4 or queries.data_ptr() % 4):
        raise ValueError("the int8 kernel needs D % 4 == 0 and 4-byte aligned rows")
    # split the row strides across a third grid dimension until about two
    # blocks per SM are in flight (serving batch gives only a few tiles)
    tiles = -(-bins // _BIN_TILE) * -(-b // _QUERY_TILE)
    splits = max(1, min(-(-n_real // bins), -(-2 * _sms(vectors.device) // tiles), 65535))
    return _launch(fused_mips_binned, vectors, queries, bins, n_real, torch.int32 if int8 else torch.float32, splits)


def _select(
    cell_s: torch.Tensor, cell_i: torch.Tensor, k: int, int8: bool
) -> tuple[torch.Tensor, torch.Tensor]:
    """k of the `[B, bins]` cells, lowest cell first on ties (as `lax.top_k`);
    id -1 where the score is -inf (float) or the int8 sentinel."""
    top_s, pos = topk_lowest_first(cell_s, k)
    top_i = torch.gather(cell_i, -1, pos)
    valid = top_s > _INT32_MIN if int8 else torch.isfinite(top_s)
    return top_s, torch.where(valid, top_i, -1)


def fused_mips_binned(
    vectors: torch.Tensor,
    queries: torch.Tensor,
    *,
    k: int,
    bins: int = 512,
    tile: int = 1024,
    n_real: int = -1,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Approximate top-k by inner product. Returns (scores [B, k], row ids [B, k]).

    `vectors` [N, D] and `queries` [B, D] are bf16/f32 (float queries are cast
    to the corpus dtype and products are summed in f32), or both int8 (summed
    exactly in int32; the caller applies the query scale afterwards). Rows at or
    past `n_real` are masked. `tile` only clamps the bins, as on the TPU:
    the effective bin count is min(bins, tile, N).

    On a CUDA tensor this launches the kernel or raises; on a CPU tensor it
    runs the plain version."""
    bins_eff, n_real, int8 = _check(vectors, queries, k, bins, tile, n_real)
    q = queries if int8 else queries.to(vectors.dtype)
    if vectors.device.type == "cuda":
        cells = _kernel_cells(vectors, q, bins_eff, n_real)
    elif vectors.device.type == "cpu":
        cells = binned_cells_reference(vectors, q, bins_eff, n_real)
    else:
        raise ValueError(f"fused_mips_binned runs on cuda or cpu, not {vectors.device}")
    return _select(*cells, k, int8)


# One count per call that launches the CUDA kernels: `binned_*_kernel`, and
# after it on the same stream `merge_splits_kernel` when the row strides are
# split (every call at serving batch). The plain version never adds to it.
fused_mips_binned.launches = 0
_launch_lock = threading.Lock()


def fused_mips_binned_reference(
    vectors: torch.Tensor,
    queries: torch.Tensor,
    *,
    k: int,
    bins: int = 512,
    tile: int = 1024,
    n_real: int = -1,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of `fused_mips_binned`, on any device."""
    bins_eff, n_real, int8 = _check(vectors, queries, k, bins, tile, n_real)
    q = queries if int8 else queries.to(vectors.dtype)
    return _select(*binned_cells_reference(vectors, q, bins_eff, n_real), k, int8)


def _check_topk(
    vectors: torch.Tensor, queries: torch.Tensor, k: int, tile: int, qblock: int, n_real: int
) -> int:
    """Validate a `fused_mips_topk` call, refusing what the TPU wrapper refuses
    (`vod_tpu/ops/mips_pallas.py:113-120`); returns n_real."""
    _check_pair(vectors, queries)
    if vectors.dtype not in (torch.float32, torch.bfloat16) or not queries.is_floating_point():
        raise TypeError(f"fused_mips_topk takes a bfloat16 or float32 corpus and float queries, got {vectors.dtype} and {queries.dtype}")
    if not vectors.is_contiguous():
        raise ValueError("fused_mips_topk needs contiguous vectors")
    n, b = int(vectors.shape[0]), int(queries.shape[0])
    if tile <= 0 or n % tile != 0:
        raise ValueError(f"need N % tile == 0 (N={n}, tile={tile})")
    qb = min(qblock, b)
    if qb <= 0 or b % qb != 0:
        raise ValueError(f"need B % min(qblock, B) == 0 (B={b}, qblock={qblock})")
    if not 1 <= k <= _K_MAX:
        raise ValueError(f"need 1 <= k <= {_K_MAX}, got k={k}")
    if n_real < 0:
        n_real = n
    if n_real > n:
        raise ValueError(f"n_real={n_real} exceeds the {n} rows")
    return int(n_real)


def _topk_splits(vectors: torch.Tensor, queries: torch.Tensor, k: int, n_real: int) -> int:
    """Row splits of the exact kernel: as many as keep every block resident in
    one wave (the kernel's occupancy at this k times the SMs), at most one per
    64-row tile."""
    from .cuda_build import load_library

    fn = load_library("fused_mips_topk").vod_fused_mips_topk_blocks_per_sm
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
    with torch.cuda.device(vectors.device):
        per_sm = fn(_DTYPE_CODES[vectors.dtype], k)
    if per_sm <= 0:
        raise RuntimeError(f"fused_mips_topk occupancy query failed with CUDA error {-per_sm}")
    tiles = -(-int(queries.shape[0]) // _QUERY_TILE)
    return max(1, min(-(-n_real // _ROW_TILE), per_sm * _sms(vectors.device) // tiles, 65535))


def exact_topk_reference(
    vectors: torch.Tensor, queries: torch.Tensor, k: int, n_real: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the exact kernel: chunked f32 `q @ vᵀ` over rows
    below n_real, each chunk folded into the running k in row order by a stable
    descending sort, so ties keep the lowest id; id -1 where the score is -inf."""
    set_full_f32_matmul()
    b = int(queries.shape[0])
    dev = vectors.device
    top_s = torch.full((b, k), float("-inf"), dtype=torch.float32, device=dev)
    top_i = torch.full((b, k), -1, dtype=torch.int32, device=dev)
    q = queries.to(torch.float32)
    chunk = max(1, _REF_CHUNK_ELEMS // max(1, b))
    for start in range(0, n_real, chunk):
        stop = min(start + chunk, n_real)
        s = q @ vectors[start:stop].to(torch.float32).T  # [B, rows]
        rows = torch.arange(start, stop, device=dev, dtype=torch.int32).expand(b, -1)
        top_s, pos = topk_lowest_first(torch.cat([top_s, s], dim=-1), k)
        top_i = torch.gather(torch.cat([top_i, rows], dim=-1), -1, pos)
    return top_s, torch.where(torch.isfinite(top_s), top_i, -1)


def fused_mips_topk(
    vectors: torch.Tensor,
    queries: torch.Tensor,
    *,
    k: int,
    tile: int = 2048,
    qblock: int = 256,
    n_real: int = -1,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k by inner product. Returns (scores f32 [B, k], row ids int32 [B, k]).

    `vectors` [N, D] is bf16 or f32; queries are cast to its dtype and products
    are summed in f32 (f32 runs in full f32, no TF32). Rows at or past `n_real`
    are masked. The k highest scores come ordered by (score descending, row id
    ascending); where the score is -inf the id is -1. The TPU kernel leaves a
    stale id in such slots once the rows span more than one tile: the port
    follows the repo's `-1`/`-inf` padding contract instead, and equals the TPU
    kernel on every slot with a finite score. `tile` and `qblock` change no
    result: they are checked as on the TPU (N % tile == 0, B % min(qblock, B)
    == 0), so that a call the TPU refuses is refused here too.

    On a CUDA tensor this launches the kernel or raises; on a CPU tensor it
    runs the plain version. Each call that launches adds one to
    `fused_mips_topk.launches`, under the module's launch lock: one count is
    one wrapper call, which covers `topk_float_kernel` and, when the rows are
    split across the grid, `merge_splits_kernel` after it on the same stream.
    The plain version never adds to it."""
    n_real = _check_topk(vectors, queries, k, tile, qblock, n_real)
    q = queries.to(vectors.dtype).contiguous()
    if vectors.device.type == "cuda":
        return _launch(fused_mips_topk, vectors, q, k, n_real, torch.float32, _topk_splits(vectors, q, k, n_real))
    if vectors.device.type == "cpu":
        return exact_topk_reference(vectors, q, k, n_real)
    raise ValueError(f"fused_mips_topk runs on cuda or cpu, not {vectors.device}")


fused_mips_topk.launches = 0


def fused_mips_topk_reference(
    vectors: torch.Tensor,
    queries: torch.Tensor,
    *,
    k: int,
    tile: int = 2048,
    qblock: int = 256,
    n_real: int = -1,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of `fused_mips_topk`, on any device."""
    n_real = _check_topk(vectors, queries, k, tile, qblock, n_real)
    return exact_topk_reference(vectors, queries.to(vectors.dtype), k, n_real)
