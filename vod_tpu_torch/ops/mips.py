"""Fused MIPS: the port of `vod_tpu/ops/mips_pallas.py`'s two kernels.

`fused_mips_binned` (approximate): scores `s = q . v` are folded into `bins`
running (score, id) cells per query, bin(j) = j mod bins over global row ids,
with the lowest row id winning a tie, and `k` of the `[B, bins]` cells are
selected in the order `lax.top_k` gives. On the card both happen in the
hand-written CUDA kernels of `csrc/fused_mips_binned.cu`, so no `[B, N]` score
array exists in device memory: the body, whose tile product runs on the tensor
cores or on CUDA cores by a fixed rule on dtype and shape (`_binned_body`),
then `select_kernel`. Expected recall@k is about 1 - (k-1)/(2*bins).

`fused_mips_topk` (exact): the k highest scores per query, by (score
descending, row id ascending), from the CUDA kernel `csrc/fused_mips_topk.cu`,
whose tile product runs on the tensor cores or on CUDA cores by a fixed rule
on dtype and shape (`_topk_body`), each split of the rows into a list of its
own, then `merge_splits_kernel` over the splits' lists (alone:
`merge_splits`).

Each wrapper launches its kernel for a CUDA tensor and raises if it cannot; for
a CPU tensor it runs its `*_reference`, the plain PyTorch version of the same
function, which the CPU tests compare with JAX.

The host path of a CUDA call is a launch plan (`_Plan`), built once per card
and shape under a lock and kept: the body, the splits from the body's
occupancy (one C query per card, body, dtype and D, kept too) and the C entry
with its ctypes argument types. The C side reads the card's shared-memory
limit and sets each kernel's opt-in once per card (`csrc/sm90.cuh`). A call
then checks its arguments, looks its plan up, makes one output and one
workspace allocation and calls one C entry, which launches every kernel of the
call on the current stream.
"""

from __future__ import annotations

import contextlib
import ctypes
import threading
import typing as typ

import torch

from .numpy_ops import topk_lowest_first

_INT32_MIN = -(2**31) + 1  # empty int8 cell (the TPU kernel's sentinel, note the +1)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_QUERY_TILE = 64  # queries per block in both CUDA kernels
_K_MAX = 128  # widest exact top-k (the TPU kernel's _K_PAD)
# Body indices of both kernels' `vod_<name>_blocks_per_sm` (twins in each
# `.cu` file).
_BODIES = {"fma": 0, "wgmma": 1}
# The next two have twins in `csrc/fused_mips_topk.cu` (MAX_CHUNKS * KC, RT and
# WRT): change both sides together. The C side refuses a call outside its own
# limits.
_WGMMA_MAX_D = 896  # the tensor-core body's resident query tile fits beside the k = 128 lists
_TOPK_ROW_TILE = {"fma": 64, "wgmma": 128}  # rows per tile of each body of the exact kernel
# The next three have twins in `csrc/fused_mips_binned.cu` (BT and WBT,
# MAX_CHUNKS times each type's KC, MAX_STRIDES): change both sides together.
# The C side refuses a call outside its own limits.
_BINNED_BIN_TILE = {"fma": 64, "wgmma": 128}  # bins per block of each body of the binned kernel
# the tensor-core body's resident query tile: at most 24 boxes of 128 bytes of K
_BINNED_WGMMA_MAX_D = {torch.bfloat16: 1536, torch.int8: 3072}
_BINNED_MAX_STRIDES = 65535  # strides per split of the tensor-core body: a cell keeps its winner in 16 bits
# Twin of SELECT_SMEM_CELLS in `csrc/fused_mips_binned.cu`: the select kernel
# keeps its cells and candidates in shared memory up to this many bins (padded
# to a power of two), and in a workspace that the wrapper allocates above (16
# bytes a padded cell).
_SELECT_SMEM_CELLS = 8192
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
) -> tuple[torch.Tensor, int, int, bool]:
    """Validate the call as the wrapper does. Float queries are cast to the
    corpus dtype and made contiguous first, as the TPU wrapper casts them
    (`vod_tpu/ops/mips_pallas.py:257`); int8 queries pair only with an int8
    corpus. Returns (queries as the kernel takes them, effective bins, n_real,
    int8)."""
    _check_pair(vectors, queries)
    if vectors.dtype not in _DTYPE_CODES:
        raise TypeError(f"fused_mips_binned takes a bfloat16, float32 or int8 corpus, got {vectors.dtype}")
    if not vectors.is_contiguous():
        raise ValueError("fused_mips_binned needs contiguous vectors")
    int8 = vectors.dtype == torch.int8
    if int8 != (queries.dtype == torch.int8):
        raise TypeError("an int8 corpus needs int8-quantized queries, and int8 queries an int8 corpus")
    if not int8 and not queries.is_floating_point():
        raise TypeError(f"a float corpus takes float queries, got {queries.dtype}")
    if queries.dtype != vectors.dtype:
        queries = queries.to(vectors.dtype)
    if not queries.is_contiguous():
        queries = queries.contiguous()
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
    return queries, bins_eff, int(n_real), int8


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


class _Plan(typ.NamedTuple):
    """The host's part of a CUDA call, worked out once per card and shape."""

    entry: typ.Any  # the C entry (ctypes function, argument types set)
    body: str  # "wgmma" or "fma"
    splits: int  # row ranges across the grid
    sort_cells: int  # 16-byte cells of the select kernel's workspace a query (0: it works in shared memory)


_plan_lock = threading.Lock()  # builds plans; server threads call concurrently
_plans: dict[tuple, _Plan] = {}  # (kernel, card, dtype, B, D, width, n_real, 16-byte aligned) -> plan
# Plans kept at most: a server that dispatches batches of many sizes builds
# one plan per B; past this many the oldest goes (it is rebuilt, without an
# occupancy query, if its shape comes back).
_MAX_PLANS = 256
_occupancy: dict[tuple, int] = {}  # (kernel, card, body, dtype, D[, k]) -> blocks an SM keeps resident
_entries: dict[tuple[str, str], typ.Any] = {}  # (library, symbol) -> ctypes function
# Plans built and occupancy queries made since import (a test reads them).
plan_stats = {"plans": 0, "occupancy_queries": 0}
_PTR, _INT = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {  # every C entry's arguments; the stream comes last
    "vod_fused_mips_binned_fma": [_INT] + [_PTR] * 7 + [_INT] * 6 + [_PTR],
    "vod_fused_mips_binned_wgmma": [_INT] + [_PTR] * 7 + [_INT] * 6 + [_PTR],
    "vod_fused_mips_binned_select": [_INT] + [_PTR] * 5 + [_INT] * 4 + [_PTR],
    "vod_fused_mips_topk_fma": [_INT] + [_PTR] * 6 + [_INT] * 5 + [_PTR],
    "vod_fused_mips_topk_wgmma": [_INT] + [_PTR] * 6 + [_INT] * 5 + [_PTR],
    "vod_fused_mips_topk_merge": [_PTR] * 4 + [_INT] * 3 + [_PTR],
}


def _entry(name: str, symbol: str) -> typ.Any:
    """C entry `symbol` of `csrc/<name>.cu`'s library (built at first use),
    its argument types set once."""
    fn = _entries.get((name, symbol))
    if fn is None:
        from .cuda_build import load_library

        fn = getattr(load_library(name), symbol)
        fn.argtypes, fn.restype = _ARGTYPES[symbol], ctypes.c_int
        _entries[(name, symbol)] = fn
    return fn


def _blocks_per_sm(name: str, card: int, *args: int) -> int:
    """How many blocks of one body of kernel `name` an SM of card `card` keeps
    resident (C entry `vod_<name>_blocks_per_sm(*args)`), asked once per card
    and arguments. Called under the plan lock."""
    key = (name, card, *args)
    per_sm = _occupancy.get(key)
    if per_sm is None:
        from .cuda_build import load_library

        fn = getattr(load_library(name), f"vod_{name}_blocks_per_sm")
        fn.argtypes, fn.restype = [ctypes.c_int] * len(args), ctypes.c_int
        with torch.cuda.device(card):
            per_sm = fn(*args)
        plan_stats["occupancy_queries"] += 1
        if per_sm <= 0:
            raise RuntimeError(f"{name} occupancy query failed with CUDA error {-per_sm}")
        _occupancy[key] = per_sm
    return per_sm


def _plan(key: tuple, build: typ.Callable[[], _Plan]) -> _Plan:
    """The plan of `key`, built by `build` under the lock the first time; the
    oldest plan goes once `_MAX_PLANS` are kept."""
    plan = _plans.get(key)
    if plan is None:
        with _plan_lock:
            plan = _plans.get(key)
            if plan is None:
                plan = build()
                while len(_plans) >= _MAX_PLANS:
                    del _plans[next(iter(_plans))]
                _plans[key] = plan
                plan_stats["plans"] += 1
    return plan


# PyTorch's binding that reads the current stream's handle without building a
# `Stream` object; a build that lacks it takes the public call.
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _current_stream(dev: torch.device) -> int:
    """The handle of PyTorch's current stream on the card of `dev`."""
    if _raw_stream is not None:
        return _raw_stream(dev.index)
    return torch.cuda.current_stream(dev).cuda_stream


def _launch(wrapper: typ.Callable, plan: _Plan, dev: torch.device, *args) -> None:
    """Call `plan.entry(*args, stream)` on the card of `dev` (made current only
    if it is not) with PyTorch's current stream there; raise on a CUDA error,
    else count the launch on `wrapper.launches` and `wrapper.body_launches`."""
    if dev.index == torch.cuda.current_device():
        err = plan.entry(*args, _current_stream(dev))
    else:
        with torch.cuda.device(dev):  # the launch goes to the tensors' card; the caller's is restored
            err = plan.entry(*args, _current_stream(dev))
    if err != 0:
        raise RuntimeError(f"{wrapper.__name__} kernel launch failed: {torch.cuda.CudaError(err)}")
    with _launch_lock:  # server threads may call concurrently
        wrapper.launches += 1
        if plan.body:
            wrapper.body_launches[plan.body] += 1


def _binned_body(dtype: torch.dtype, d: int, bins: int, ptrs: typ.Iterable[int]) -> str:
    """The body of the binned kernel that a CUDA call takes, by a fixed rule on
    dtype and shape: "wgmma" (tensor cores fed by TMA) for bf16 with
    D % 8 == 0 and D <= 1536, or int8 with D % 16 == 0 and D <= 3072 (TMA
    needs 16-byte row strides; the resident query tile fits in shared memory),
    with bins % 128 == 0 (a block owns 128 bins) and 16-byte-aligned data
    pointers `ptrs` (corpus and queries); "fma" for every other call, f32
    included (`wgmma` has no full-f32 mode): f32 FMAs on CUDA cores, or for
    int8 `mma.sync` on the tensor cores, at any D and byte offset."""
    row_elems = {torch.bfloat16: 8, torch.int8: 16}.get(dtype)
    if (
        row_elems is not None
        and d % row_elems == 0
        and d <= _BINNED_WGMMA_MAX_D[dtype]
        and bins % _BINNED_BIN_TILE["wgmma"] == 0
        and all(p % 16 == 0 for p in ptrs)
    ):
        return "wgmma"
    return "fma"


def binned_splits(sms: int, per_sm: int, b: int, bins: int, n_real: int, body: str) -> int:
    """Stride splits of the binned kernel: as many as keep every block resident
    in one wave (`per_sm`, the body's occupancy at this dtype and D, times
    `sms`), at most one per stride, and for the tensor-core body enough that
    no split holds more than 65,535 strides."""
    strides = -(-n_real // bins)
    tiles = -(-bins // _BINNED_BIN_TILE[body]) * -(-b // _QUERY_TILE)
    splits = max(1, min(strides, per_sm * sms // max(1, tiles), 65535))
    if body == "wgmma":
        splits = max(splits, -(-strides // _BINNED_MAX_STRIDES))
    return splits


def _select_cells(bins: int) -> int:
    """The select kernel's workspace cells a query: 0 where the bins, padded
    to a power of two, fit in shared memory."""
    n_pad = 1 << max(0, bins - 1).bit_length()
    return 0 if n_pad <= _SELECT_SMEM_CELLS else n_pad


def _binned_plan(vectors: torch.Tensor, queries: torch.Tensor, bins: int, n_real: int) -> _Plan:
    b, d = (int(x) for x in queries.shape)
    dev = vectors.device
    ptrs = (vectors.data_ptr(), queries.data_ptr())
    aligned = all(p % 16 == 0 for p in ptrs)
    key = ("fused_mips_binned", dev.index, vectors.dtype, b, d, bins, n_real, aligned)

    def build() -> _Plan:
        body = _binned_body(vectors.dtype, d, bins, ptrs)
        per_sm = _blocks_per_sm("fused_mips_binned", dev.index, _BODIES[body], _DTYPE_CODES[vectors.dtype], d)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        return _Plan(_entry("fused_mips_binned", f"vod_fused_mips_binned_{body}"), body,
                     binned_splits(sms, per_sm, b, bins, n_real, body), _select_cells(bins))

    return _plan(key, build)


def _workspace(dev: torch.device, plan: _Plan, b: int, width: int) -> tuple[torch.Tensor, int, int, int]:
    """One allocation for the partials [splits, B, width] (scores, ids) and the
    select kernel's cells; returns it and the addresses of the three parts."""
    cells = plan.splits * b * width
    ws = torch.empty(2 * cells + 4 * b * plan.sort_cells, dtype=torch.int32, device=dev)
    base = ws.data_ptr()
    return ws, base, base + 4 * cells, base + 8 * cells if plan.sort_cells else 0


def _outputs(b: int, k: int, score_dtype: torch.dtype, dev: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """[B, k] scores and int32 ids, views of one allocation."""
    out_s, out_i = torch.empty((2, b, k), dtype=torch.int32, device=dev).unbind(0)
    return (out_s if score_dtype == torch.int32 else out_s.view(score_dtype)), out_i


def _kernel_topk(
    vectors: torch.Tensor, queries: torch.Tensor, k: int, bins: int, n_real: int, int8: bool
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the binned body that `_binned_body` names, then the select
    kernel, on the current stream; outputs `[B, k]`."""
    b, d = (int(x) for x in queries.shape)
    dev = vectors.device
    out_s, out_i = _outputs(b, k, torch.int32 if int8 else torch.float32, dev)
    if b == 0:
        return out_s, out_i
    plan = _binned_plan(vectors, queries, bins, n_real)
    ws, part_s, part_i, keys = _workspace(dev, plan, b, bins)
    _launch(fused_mips_binned, plan, dev, _DTYPE_CODES[vectors.dtype], queries.data_ptr(), vectors.data_ptr(),
            part_s, part_i, out_s.data_ptr(), out_i.data_ptr(), keys, b, d, bins, n_real, plan.splits, k)
    return out_s, out_i


def _select(
    cell_s: torch.Tensor, cell_i: torch.Tensor, k: int, int8: bool
) -> tuple[torch.Tensor, torch.Tensor]:
    """k of the `[B, bins]` cells, lowest cell first on ties (as `lax.top_k`);
    id -1 where the score is -inf (float) or the int8 sentinel. The plain
    versions' selection; on the card `select_kernel` does it."""
    top_s, pos = topk_lowest_first(cell_s, k)
    top_i = torch.gather(cell_i, -1, pos)
    valid = top_s > _INT32_MIN if int8 else torch.isfinite(top_s)
    return top_s, torch.where(valid, top_i, -1)


def merge_select_reference(
    part_s: torch.Tensor, part_i: torch.Tensor, k: int, int8: bool
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of `select_kernel`: the partial cells `[splits, B, bins]`
    folded in increasing split order with a strict `>` (the lower split on equal
    scores), then `_select`. The tests and the card script hold the kernel
    against it; the main path never runs it."""
    cell_s, cell_i = part_s[0], part_i[0]
    for z in range(1, int(part_s.shape[0])):
        better = part_s[z] > cell_s
        cell_s = torch.where(better, part_s[z], cell_s)
        cell_i = torch.where(better, part_i[z], cell_i)
    return _select(cell_s, cell_i, k, int8)


def merge_select(part_s: torch.Tensor, part_i: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """`select_kernel` alone, on partial cells that the caller made: scores
    `[splits, B, bins]` (int32 for int8, else float32) and int32 ids of the
    same shape, contiguous; returns `[B, k]` scores and ids, as
    `merge_select_reference`. On a CUDA tensor this launches the kernel or
    raises, counted on `merge_select.launches`; on a CPU tensor it runs the
    plain version. `fused_mips_binned` launches the same kernel itself."""
    if part_s.ndim != 3 or part_s.shape != part_i.shape or part_i.dtype != torch.int32:
        raise ValueError(f"expected [splits, B, bins] scores and int32 ids, got {tuple(part_s.shape)} and "
                         f"{tuple(part_i.shape)} {part_i.dtype}")
    if part_s.dtype not in (torch.int32, torch.float32):
        raise TypeError(f"merge_select takes int32 or float32 scores, got {part_s.dtype}")
    splits, b, bins = (int(x) for x in part_s.shape)
    if not 0 < k <= bins or splits < 1:
        raise ValueError(f"need 0 < k <= bins and a split, got k={k}, shape {tuple(part_s.shape)}")
    int8 = part_s.dtype == torch.int32
    dev = part_s.device
    if dev.type == "cpu":
        return merge_select_reference(part_s, part_i, k, int8)
    if dev.type != "cuda" or part_i.device != dev:
        raise ValueError(f"merge_select runs on cuda or cpu, with both tensors on one device, not {dev}")
    if not (part_s.is_contiguous() and part_i.is_contiguous()):
        raise ValueError("merge_select needs contiguous partials")
    out_s, out_i = _outputs(b, k, part_s.dtype, dev)
    if b == 0:
        return out_s, out_i
    plan = _plan(("merge_select", dev.index, bins), lambda: _Plan(  # the splits come with each call
        _entry("fused_mips_binned", "vod_fused_mips_binned_select"), "", 0, _select_cells(bins)))
    ws = torch.empty(4 * b * plan.sort_cells, dtype=torch.int32, device=dev)
    _launch(merge_select, plan, dev, _DTYPE_CODES[torch.int8] if int8 else 0, part_s.data_ptr(), part_i.data_ptr(),
            out_s.data_ptr(), out_i.data_ptr(), ws.data_ptr() if plan.sort_cells else 0, b, bins, splits, k)
    return out_s, out_i


merge_select.launches = 0


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

    `vectors` [N, D] is a contiguous bf16/f32 corpus, with float queries
    `[B, D]` of any dtype and layout (cast to the corpus dtype and made
    contiguous; products are summed in f32), or both are int8 (summed
    exactly in int32; the caller applies the query scale afterwards). Rows at or
    past `n_real` are masked. `tile` only clamps the bins, as on the TPU:
    the effective bin count is min(bins, tile, N).

    On a CUDA tensor this launches the kernel or raises; on a CPU tensor it
    runs the plain version. The kernel's body follows a fixed rule
    (`_binned_body`): bf16 with D % 8 == 0 and D <= 1536, or int8 with
    D % 16 == 0 and D <= 3072, at an effective bin count divisible by 128,
    with corpus and (cast) queries on 16-byte-aligned addresses, runs its tile
    product on the tensor cores (`binned_wgmma_kernel`); f32, and any other
    call (a misaligned `storage_offset` included), on the "fma" body: CUDA
    cores for float (`binned_float_kernel`), `mma.sync` for int8 at any D
    (`binned_int8_kernel`). A call that the rule gives
    to the tensor cores and that cannot build or launch there raises; it never
    runs on the other body. Every CUDA call then selects on the card
    (`select_kernel`, any bins and k): two launches a call, and one more to
    cast float queries of another dtype. Each call that launches adds one to
    `fused_mips_binned.launches` and to `fused_mips_binned.body_launches[body]`,
    under the module's launch lock; the plain version never adds to them.
    While a profiler records, the call is one `fused_mips_binned` span."""
    with _span("fused_mips_binned"):
        q, bins_eff, n_real, int8 = _check(vectors, queries, k, bins, tile, n_real)
        if vectors.device.type == "cuda":
            return _kernel_topk(vectors, q, k, bins_eff, n_real, int8)
        if vectors.device.type == "cpu":
            return _select(*binned_cells_reference(vectors, q, bins_eff, n_real), k, int8)
        raise ValueError(f"fused_mips_binned runs on cuda or cpu, not {vectors.device}")


def _span(name: str) -> typ.ContextManager:
    """A profiler span named `name` while a profiler records (the kernels
    launch through ctypes, with no aten op of their own to name them), else
    a null context."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


# One count per call that launches the CUDA kernels: the body's
# `binned_*_kernel`, and after it on the same stream `select_kernel`. The plain
# version never adds to them.
fused_mips_binned.launches = 0
fused_mips_binned.body_launches = {body: 0 for body in _BODIES}
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
    q, bins_eff, n_real, int8 = _check(vectors, queries, k, bins, tile, n_real)
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


def _topk_body(dtype: torch.dtype, d: int, ptrs: typ.Iterable[int]) -> str:
    """The body of the exact kernel that a CUDA call takes, by a fixed rule on
    dtype and shape: "wgmma" (tensor cores fed by TMA) for a bf16 corpus with
    D % 8 == 0 (TMA needs 16-byte row strides), D <= 896 (the resident query
    tile fits in shared memory at every k) and 16-byte-aligned data pointers
    `ptrs` (corpus and queries); "fma" (f32 FMAs on CUDA cores) for every
    other call, f32 included (`wgmma` has no full-f32 mode)."""
    if dtype == torch.bfloat16 and d % 8 == 0 and d <= _WGMMA_MAX_D and all(p % 16 == 0 for p in ptrs):
        return "wgmma"
    return "fma"


def _topk_plan(vectors: torch.Tensor, queries: torch.Tensor, k: int, n_real: int) -> _Plan:
    b, d = (int(x) for x in queries.shape)
    dev = vectors.device
    ptrs = (vectors.data_ptr(), queries.data_ptr())
    aligned = all(p % 16 == 0 for p in ptrs)
    key = ("fused_mips_topk", dev.index, vectors.dtype, b, d, k, n_real, aligned)

    def build() -> _Plan:
        # row splits: as many as keep every block resident in one wave (the
        # body's occupancy at this D and k times the SMs), at most one per row tile
        body = _topk_body(vectors.dtype, d, ptrs)
        per_sm = _blocks_per_sm("fused_mips_topk", dev.index, _BODIES[body], _DTYPE_CODES[vectors.dtype], d, k)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        tiles = -(-b // _QUERY_TILE)
        splits = max(1, min(-(-n_real // _TOPK_ROW_TILE[body]), per_sm * sms // tiles, 65535))
        return _Plan(_entry("fused_mips_topk", f"vod_fused_mips_topk_{body}"), body, splits, 0)

    return _plan(key, build)


def _kernel_exact(
    vectors: torch.Tensor, queries: torch.Tensor, k: int, n_real: int
) -> tuple[torch.Tensor, torch.Tensor, typ.Optional[torch.Tensor]]:
    """Launch the exact kernel on the body `_topk_body` names (and its merge of
    the splits) on the current stream; returns the outputs `[B, k]` and the
    workspace that holds the body's partial lists (`_exact_partials` reads
    them), None where one split writes the result itself."""
    b, d = (int(x) for x in queries.shape)
    dev = vectors.device
    out_s, out_i = _outputs(b, k, torch.float32, dev)
    if b == 0:
        return out_s, out_i, None
    plan = _topk_plan(vectors, queries, k, n_real)
    ws = None
    if plan.splits > 1:
        ws, part_s, part_i, _ = _workspace(dev, plan, b, k)
    else:
        part_s, part_i = out_s.data_ptr(), out_i.data_ptr()
    _launch(fused_mips_topk, plan, dev, _DTYPE_CODES[vectors.dtype], queries.data_ptr(), vectors.data_ptr(),
            part_s, part_i, out_s.data_ptr(), out_i.data_ptr(), b, d, k, n_real, plan.splits)
    return out_s, out_i, ws


def _exact_partials(vectors: torch.Tensor, queries: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The partial lists `[splits, B, k]` (float32 scores, int32 ids) that one
    CUDA `fused_mips_topk` call over all of `vectors` writes before its merge,
    for a benchmark of `merge_splits`. One launch of the call, counted as
    such; raises where the call runs in one split (no merge)."""
    b = int(queries.shape[0])
    _, _, ws = _kernel_exact(vectors, queries.to(vectors.dtype).contiguous(), k, int(vectors.shape[0]))
    if ws is None:
        raise ValueError(f"the exact call at B={b}, k={k} runs in one split: it has no partial lists")
    cells = ws.numel() // 2  # scores, then ids: an exact plan has no select cells
    return ws[:cells].view(torch.float32).view(-1, b, k), ws[cells:].view(-1, b, k)


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


def merge_splits_reference(
    part_s: torch.Tensor, part_i: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of `merge_splits_kernel`: each query's splits x k pairs
    in split order, the k highest by a stable descending selection (so the
    lower split, whose ids are the lower, wins a tie), id -1 where the score
    is -inf. The tests and the card script hold the kernel against it; the
    main path never runs it."""
    splits, b, width = (int(x) for x in part_s.shape)
    pairs_s = part_s.permute(1, 0, 2).reshape(b, splits * width)
    top_s, pos = topk_lowest_first(pairs_s, k)
    top_i = torch.gather(part_i.permute(1, 0, 2).reshape(b, splits * width), -1, pos)
    return top_s, torch.where(torch.isneginf(top_s), -1, top_i)


def merge_splits(part_s: torch.Tensor, part_i: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """`merge_splits_kernel` alone, on partial lists that the caller made:
    float32 scores `[splits, B, k]` and int32 ids of the same shape,
    contiguous, each list sorted by (score descending, id ascending), split
    z's ids above split z - 1's, empty slots (-inf, -1); returns `[B, k]`
    scores and ids, as `merge_splits_reference`. On a CUDA tensor this
    launches the kernel or raises, counted on `merge_splits.launches`; on a
    CPU tensor it runs the plain version. `fused_mips_topk` launches the same
    kernel itself."""
    if part_s.ndim != 3 or part_s.shape != part_i.shape or part_i.dtype != torch.int32:
        raise ValueError(f"expected [splits, B, k] scores and int32 ids, got {tuple(part_s.shape)} and "
                         f"{tuple(part_i.shape)} {part_i.dtype}")
    if part_s.dtype != torch.float32:
        raise TypeError(f"merge_splits takes float32 scores, got {part_s.dtype}")
    splits, b, width = (int(x) for x in part_s.shape)
    if width != k or not 1 <= k <= _K_MAX or not 1 <= splits <= 65535:
        raise ValueError(f"need lists of k in [1, {_K_MAX}] and 1 to 65,535 splits, got k={k}, "
                         f"shape {tuple(part_s.shape)}")
    dev = part_s.device
    if dev.type == "cpu":
        return merge_splits_reference(part_s, part_i, k)
    if dev.type != "cuda" or part_i.device != dev:
        raise ValueError(f"merge_splits runs on cuda or cpu, with both tensors on one device, not {dev}")
    if not (part_s.is_contiguous() and part_i.is_contiguous()):
        raise ValueError("merge_splits needs contiguous partials")
    out_s, out_i = _outputs(b, k, torch.float32, dev)
    if b == 0:
        return out_s, out_i
    plan = _plan(("merge_splits", dev.index), lambda: _Plan(
        _entry("fused_mips_topk", "vod_fused_mips_topk_merge"), "", 0, 0))
    _launch(merge_splits, plan, dev, part_s.data_ptr(), part_i.data_ptr(), out_s.data_ptr(), out_i.data_ptr(), b, k,
            splits)
    return out_s, out_i


merge_splits.launches = 0


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
    are summed in f32 (f32 runs in full f32, no TF32; bf16 products are exact
    in f32, so the two bodies differ only in the order of the f32 sums). Rows
    at or past `n_real` are masked. The k highest scores come ordered by (score descending, row id
    ascending); where the score is -inf the id is -1. The TPU kernel leaves a
    stale id in such slots once the rows span more than one tile: the port
    follows the repo's `-1`/`-inf` padding contract instead, and equals the TPU
    kernel on every slot with a finite score. `tile` and `qblock` change no
    result: they are checked as on the TPU (N % tile == 0, B % min(qblock, B)
    == 0), so that a call the TPU refuses is refused here too.

    On a CUDA tensor this launches the kernel or raises; on a CPU tensor it
    runs the plain version. The kernel's body follows a fixed rule
    (`_topk_body`): a bf16 corpus with D % 8 == 0, D <= 896 and corpus and
    (cast) queries on 16-byte-aligned addresses runs its tile product on the
    tensor cores (`topk_wgmma_kernel`); f32, and any other bf16 call (a
    misaligned `storage_offset` included), on CUDA cores
    (`topk_float_kernel`). A call that the rule gives to the tensor cores and
    that cannot build or launch there raises; it never runs on the other body.
    Each call that launches adds one to `fused_mips_topk.launches` and to
    `fused_mips_topk.body_launches[body]`, under the module's launch lock: one
    count is one wrapper call, which covers the body's kernel and, when the
    rows are split across the grid, `merge_splits_kernel` after it on the same
    stream. The plain version never adds to them."""
    n_real = _check_topk(vectors, queries, k, tile, qblock, n_real)
    q = queries.to(vectors.dtype).contiguous()
    if vectors.device.type == "cuda":
        return _kernel_exact(vectors, q, k, n_real)[:2]
    if vectors.device.type == "cpu":
        return exact_topk_reference(vectors, q, k, n_real)
    raise ValueError(f"fused_mips_topk runs on cuda or cpu, not {vectors.device}")


fused_mips_topk.launches = 0
fused_mips_topk.body_launches = {body: 0 for body in _BODIES}


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
