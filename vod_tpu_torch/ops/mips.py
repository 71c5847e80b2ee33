"""Fused MIPS with binned selection: the port of `vod_tpu/ops/mips_pallas.py:fused_mips_binned`.

Scores `s = q . v` are folded into `bins` running (score, id) cells per query,
bin(j) = j mod bins over global row ids, with the lowest row id winning a tie.
On the card the folding happens inside the hand-written CUDA kernel
`csrc/fused_mips_binned.cu`, so no `[B, N]` score array exists in device
memory; `k` of the `[B, bins]` cells are then selected here, in the order
`lax.top_k` gives. Expected recall@k is about 1 - (k-1)/(2*bins).

`fused_mips_binned` launches the kernel for a CUDA tensor and raises if it
cannot; for a CPU tensor it runs `fused_mips_binned_reference`, the plain
PyTorch version of the same function, which the CPU tests compare with JAX.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from .numpy_ops import topk_lowest_first

_INT32_MIN = -(2**31) + 1  # empty int8 cell (the TPU kernel's sentinel, note the +1)
_KERNEL = "fused_mips_binned"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_QUERY_TILE = 64  # queries per block in the CUDA kernel
_BIN_TILE = 64  # bins per block in the CUDA kernel
_REF_CHUNK_ELEMS = 1 << 25  # score elements per chunk of the plain version


def set_full_f32_matmul() -> None:
    """Make float32 products on the card run in full float32, not TF32. Both
    flags are global to the process; the port sets them wherever it computes a
    float32 product that must match an f32 reference (the plain kernel version,
    the exact re-rank)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _check(
    vectors: torch.Tensor, queries: torch.Tensor, k: int, bins: int, tile: int, n_real: int
) -> tuple[int, int, bool]:
    """Validate the call as the wrapper does; returns (effective bins, n_real, int8)."""
    if vectors.ndim != 2 or queries.ndim != 2 or vectors.shape[1] != queries.shape[1]:
        raise ValueError(f"expected vectors [N, D] and queries [B, D], got {tuple(vectors.shape)} and {tuple(queries.shape)}")
    if vectors.device != queries.device:
        raise ValueError(f"vectors on {vectors.device} but queries on {queries.device}")
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


def _kernel_cells(
    vectors: torch.Tensor, queries: torch.Tensor, bins: int, n_real: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel on the current stream; outputs `[B, bins]` cells."""
    from .cuda_build import load_library

    lib = load_library(_KERNEL)
    fn = lib.vod_fused_mips_binned
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    int8 = vectors.dtype == torch.int8
    b, d = (int(x) for x in queries.shape)
    if int8 and (d % 4 or vectors.data_ptr() % 4 or queries.data_ptr() % 4):
        raise ValueError("the int8 kernel needs D % 4 == 0 and 4-byte aligned rows")
    dev = vectors.device
    score_dtype = torch.int32 if int8 else torch.float32
    out_s = torch.empty((b, bins), dtype=score_dtype, device=dev)
    out_i = torch.empty((b, bins), dtype=torch.int32, device=dev)
    if b == 0:
        return out_s, out_i
    # split the row strides across a third grid dimension until about two
    # blocks per SM are in flight (serving batch gives only a few tiles)
    n_strides = -(-n_real // bins)
    tiles = -(-bins // _BIN_TILE) * -(-b // _QUERY_TILE)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    splits = max(1, min(n_strides, -(-2 * sms // tiles), 65535))
    if splits > 1:
        part_s = torch.empty((splits, b, bins), dtype=score_dtype, device=dev)
        part_i = torch.empty((splits, b, bins), dtype=torch.int32, device=dev)
    else:
        part_s, part_i = out_s, out_i
    with torch.cuda.device(dev):  # the launch goes to the tensors' card; the caller's is restored
        err = fn(
            _DTYPE_CODES[vectors.dtype], queries.data_ptr(), vectors.data_ptr(),
            part_s.data_ptr(), part_i.data_ptr(), out_s.data_ptr(), out_i.data_ptr(),
            b, d, bins, n_real, splits, torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_mips_binned kernel launch failed with CUDA error {err}")
    with _launch_lock:  # server threads may call concurrently
        fused_mips_binned.launches += 1
    return out_s, out_i


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

