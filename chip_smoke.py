#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`vod_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout, on a machine with one H100

It imports nothing of JAX or of the JAX package, and fails (exit 1, no result
line) where there is no CUDA device or no checkout around it. Phases, each
checked, none caught:

 1. the card: name and power limit (nvidia-smi), CUDA version;
 2. build both hand-written kernels from `vod_tpu_torch/csrc/`, one `nvcc`
    each, started together, with the time taken, registers and shared memory;
 3. `fused_mips_binned` against its plain PyTorch version on the card at
    N = 2^20, D = 768, bins 512 and 1024, B = 1, 64 and 2048, k = 40 (the
    tensor-core body), and on rows off the 16-byte grid (bf16 2 bytes off at
    B = 64, 1024 bins and B = 2048, 512 bins; int8 4 bytes off at B = 64,
    512 bins: the CUDA-core body), each call checked to take the body that
    `_binned_body` names: bf16 scores within twice the f32 sum-order bound
    and ids equal wherever the margin exceeds it; int8 ids and scores exactly
    equal (every cell); tensor-core edge cases B = 3 and 65 with
    n_real = N - 77 (a ragged last stride); n_real masking; duplicate rows tie
    to the lowest id. Then times on both bodies: kernel, plain version, the
    library yardstick (`torch.topk(q @ Vᵀ, k)` in bf16,
    `torch.topk(torch._int_mm(q, Vᵀ), k)` in int8), and the bound;
 3b. `fused_mips_topk` against its plain PyTorch version on the card at
    N = 2^20, D = 768: bf16 at B = 1, 64 and 2048 with k = 10 and 128 (the
    tensor-core body), f32 at B = 64 with k = 128 and bf16 rows 2 bytes off
    the 16-byte grid at B = 64, k = 10 and B = 2048, k = 128 (the CUDA-core
    body), each call checked to take the body that `_topk_body` names. One
    PyTorch read of the corpus is timed beside them. Scores within
    twice the f32 sum-order bound, ids equal wherever the margin exceeds it;
    tensor-core edge cases B = 3 and 65 with k = 1 and n_real = N - 77 (a
    ragged last tile); n_real masking at N - 12345; n_real = 3 leaves slots
    3-9 at -1/-inf; three equal rows in different splits tie to the lowest
    id. Then times: kernel, plain version, the library yardstick
    `torch.topk(q @ Vᵀ, k)`, and the bound;
 4. the serving path, end to end (the main path: launch counts are zeroed just
    before it and read just after): an e5-base-width `VodEncoder` (bf16
    activations, f32 params, seed 0) encodes 64 queries of 64 seeded tokens;
    a 1,000,000 x 768 unit-norm corpus made on the card from a seeded
    generator is indexed as flat bf16 (kernel "fused", f32 re-rank, 1024 bins)
    and as int8 (kernel "fused"); two `SearchServer`s (2 ms batch window,
    max batch 64) answer concurrent HTTP requests with gold lookups and
    held-out requests (corpus rows + 0.1 noise). Checked: ids in [0, N) or -1,
    gold ids with label 1, fewer dispatches than requests, kernel launches,
    all on the tensor-core body, recall@10 against exact f32 search, served ids == direct `dense_search`;
    then request latency at one client and under 32 concurrent clients;
 4b. the kernel shootout, end to end (the exact kernel's main path: launch
    counts are zeroed just before it and read just after):
    `vod_tpu_torch.examples.mips_kernel_bench.main` at 1M x 768 bf16,
    2048-query blocks, k = 10: the exact scan, `fused_mips_binned` and
    `fused_mips_topk` timed for QPS, each with recall@10 against exact search.
    Checked: exact-kernel recall >= 0.999, binned recall >= 0.975, and
    launches of both kernels, all on their tensor-core bodies;
 5. the `kernels` JSON line, the card line, and the last line
    `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import concurrent.futures
import json
import math
import statistics
import sys
import time
import urllib.request
from pathlib import Path

ROOT = Path(__file__).resolve().parent
D = 768
N_KERNEL = 1 << 20
BATCHES = (1, 64, 2048)  # a one-query dispatch, the serving batch, a bulk search
K_POOL = 40  # min(k_factor * top_k, bins): the kernel's k on the served path
EXACT_KS = (10, 128)  # the shootout's k, and the exact kernel's widest list
TOP_K = 10
N_SERVE = 1_000_000
N_QUERIES, QUERY_TOKENS = 64, 64
# Recall@10 floor of the flat index (bf16 store, 1024 bins, 40-wide pool, f32
# re-rank). Bin collisions alone cost about (k-1)/(2*bins) = 9/2048 = 0.44%:
# expected recall 0.9956, i.e. ~3 misses in 640 (query, neighbour) pairs. The
# floor allows 12 misses, far outside that count's binomial spread.
RECALL_FLOOR = 0.98
# Published data-sheet peaks per H100 model, dense (no sparsity):
# (HBM bytes/s, bf16 FLOP/s, int8 OP/s, f32 FLOP/s outside the tensor cores).
# Matched on nvidia-smi's name, first hit wins.
DATASHEETS = (
    ("PCIe", (2.0e12, 756e12, 1513e12, 51e12)),
    ("NVL", (3.9e12, 835e12, 1670e12, 60e12)),
    ("H100", (3.35e12, 989e12, 1979e12, 67e12)),  # H100 SXM5
)
SHOOTOUT_ARGS = ["--n", str(1 << 20), "--d", "768", "--blk", "2048", "--nblocks", "8", "--k", "10"]
EXACT_RECALL_FLOOR = 0.999  # only bf16 near-ties between two f32 sum orders may differ
# 1 - (k-1)/(2*bins) = 1 - 9/1024 = 0.991 expected at 512 bins; the floor leaves
# room for the sampling spread of 256 queries
BINNED_RECALL_FLOOR = 0.975


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def log(*parts) -> None:
    print(*parts, flush=True)


def time_ms(fn, reps: int) -> float:
    """Mean ms per call over `reps` calls after one warm-up, by CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def check_against_plain(label: str, ks, ki, rs, ri, qq, vv, tol: float) -> tuple[float, int]:
    """Kernel (ks, ki) against plain (rs, ri): the same slots are empty (-inf),
    finite scores agree within `tol`, and an id may differ only where its exact
    score lies within the band of the plain score. Returns (max error, swaps)."""
    import torch

    finite = torch.isfinite(rs)
    check(torch.equal(torch.isfinite(ks), finite), f"{label}: empty slots differ")
    err = (ks[finite] - rs[finite]).abs().max().item() if finite.any() else 0.0
    check(err <= tol, f"{label}: max score error {err:.3g} > {tol:.3g}")
    check(torch.equal(ki[~finite], ri[~finite]), f"{label}: ids of empty slots differ")
    rows, cols = (ki != ri).nonzero(as_tuple=True)
    if len(rows):  # a swap is allowed only inside the tolerance band
        exact = (qq[rows].double() * vv[ki[rows, cols].long()].double()).sum(-1)
        gap = (exact - rs[rows, cols].double()).abs().max().item()
        check(gap <= 2 * tol, f"{label}: id swap outside the band ({gap:.3g})")
    return err, len(rows)


def percentile(xs: list[float], p: float) -> float:
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(round(p / 100 * (len(xs) - 1))))]


def main() -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: this script runs the port on an NVIDIA GPU")
    kernel_names = ("fused_mips_binned", "fused_mips_topk")
    if not all((ROOT / "vod_tpu_torch" / "csrc" / f"{name}.cu").is_file() for name in kernel_names):
        fail(f"no vod_tpu_torch checkout around {ROOT}")
    sys.path.insert(0, str(ROOT))
    from vod_tpu_torch.examples import mips_kernel_bench
    from vod_tpu_torch.models import TransformerEncoderConfig, VodEncoder, VodPoolerConfig
    from vod_tpu_torch.ops import cuda_build
    from vod_tpu_torch.ops.mips import (
        _binned_body,
        _topk_body,
        fused_mips_binned,
        fused_mips_binned_reference,
        fused_mips_topk,
        fused_mips_topk_reference,
    )
    from vod_tpu_torch.ops.pq import quantize_int8
    from vod_tpu_torch.search import HybridEngines, SearchQueries, build_dense_index, dense_search
    from vod_tpu_torch.search.dense import quantize_queries_int8
    from vod_tpu_torch.serving import SearchHttpClient, SearchServer

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False  # exact f32 ground truth
    torch.backends.cudnn.allow_tf32 = False

    # 1. the card
    card = mips_kernel_bench.card_name(dev)
    kind = torch.cuda.get_device_name(0)
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}; devices: {torch.cuda.device_count()}")
    sheet = next((v for key, v in DATASHEETS if key in kind), None)
    check(sheet is not None, f"no data-sheet peaks for {kind!r}")
    hbm, peak_bf16, peak_int8, peak_f32 = sheet

    # 2. kernel builds, one nvcc per source, all started together
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(kernel_names)) as ex:
        builds = list(ex.map(cuda_build.build, kernel_names))
    for name, (path, seconds, nvcc_log) in zip(kernel_names, builds):
        regs = [ln.split("info    : ")[-1] for ln in nvcc_log.splitlines() if "registers" in ln]
        log(f"build: {name}: nvcc {seconds:.2f} s -> {path.relative_to(ROOT)}; " + " | ".join(regs))
    log(f"build: both kernels in {time.perf_counter() - t0:.2f} s")

    # 3. kernel vs plain version at the headline shape
    g = torch.Generator(device=dev).manual_seed(0)
    v32 = torch.randn((N_KERNEL, D), generator=g, device=dev)
    v32 /= v32.norm(dim=-1, keepdim=True)
    src = torch.randint(0, N_KERNEL, (2048,), generator=g, device=dev)
    q32 = v32[src] + 0.1 * torch.randn((2048, D), generator=g, device=dev)
    q32 /= q32.norm(dim=-1, keepdim=True)
    vb = v32.to(torch.bfloat16)
    vi8, scale = quantize_int8(v32, dim=0)
    qi8, _ = quantize_queries_int8(q32, scale)
    del v32
    qb = q32.to(torch.bfloat16)
    # the same rows off the 16-byte grid (bf16 2 bytes, int8 4 bytes): the body
    # rules send them to the CUDA-core bodies
    vb_odd = torch.empty(N_KERNEL * D + 1, dtype=torch.bfloat16, device=dev)[1:].view(N_KERNEL, D)
    vb_odd.copy_(vb)
    vi8_odd = torch.empty(N_KERNEL * D + 4, dtype=torch.int8, device=dev)[4:].view(N_KERNEL, D)
    vi8_odd.copy_(vi8)
    # twice the f32 sum-order bound gamma_D * |q| * |v| for the bf16 inputs
    tol = 2 * D * 2.0**-24 * qb.float().norm(dim=-1).max().item() * vb.float().norm(dim=-1).max().item()
    max_err = 0.0

    def binned_body_of(vv, qs, bins: int, expect: str) -> str:
        """The body a binned call takes, named by the wrapper's rule."""
        body = _binned_body(vv.dtype, D, bins, (vv.data_ptr(), qs.to(vv.dtype).data_ptr()))
        check(body == expect, f"binned {vv.dtype} at offset {vv.storage_offset()}: body {body}, not {expect}")
        return body

    def binned_call(vv, qs, bins: int, expect: str, **kw):
        """One `fused_mips_binned` call, checked to launch once on the named body."""
        body = binned_body_of(vv, qs, bins, expect)
        before = fused_mips_binned.body_launches[body]
        out = fused_mips_binned(vv, qs, bins=bins, **kw)
        check(fused_mips_binned.body_launches[body] == before + 1, f"binned {vv.dtype}: not on the {body} body")
        return out

    # (dtype, corpus, queries, B, bins, body, n_real): the twelve headline
    # shapes, the CUDA-core body on rows off the grid, the tensor-core edge cases
    binned_cases = [
        (dt, vv, qq, b, bins, "wgmma", N_KERNEL)
        for dt, vv, qq in (("bfloat16", vb, qb), ("int8", vi8, qi8)) for b in BATCHES for bins in (512, 1024)
    ] + [
        ("bfloat16", vb_odd, qb, 64, 1024, "fma", N_KERNEL),
        ("bfloat16", vb_odd, qb, 2048, 512, "fma", N_KERNEL),
        ("int8", vi8_odd, qi8, 64, 512, "fma", N_KERNEL),
    ] + [
        (dt, vv, qq, b, bins, "wgmma", N_KERNEL - 77)
        for dt, vv, qq, bins in (("bfloat16", vb, qb, 1024), ("int8", vi8, qi8, 512)) for b in (3, 65)
    ]
    for dtype, vv, qq, b, bins, expect, n_real in binned_cases:
        label = f"{dtype} B={b} bins={bins} n_real={n_real} ({expect})"
        if dtype == "bfloat16":
            ks, ki = binned_call(vv, qq[:b], bins, expect, k=K_POOL, n_real=n_real)
            err, swaps = check_against_plain(
                label, ks, ki, *fused_mips_binned_reference(vv, qq[:b], k=K_POOL, bins=bins, n_real=n_real),
                qq[:b], vv, tol,
            )
            max_err = max(max_err, err)
            log(f"check {label}: max |kernel - plain| = {err:.3g} (tol {tol:.3g}), {swaps} id swaps inside the band")
        else:
            ks, ki = binned_call(vv, qq[:b], bins, expect, k=bins, n_real=n_real)  # every cell
            rs, ri = fused_mips_binned_reference(vv, qq[:b], k=bins, bins=bins, n_real=n_real)
            check(torch.equal(ks, rs) and torch.equal(ki, ri), f"{label}: kernel != plain")
            log(f"check {label}: all {b}x{bins} cells equal (ids and int32 scores)")
        check(ki.max().item() < n_real, f"{label}: a masked row was returned")
    n_real = N_KERNEL - 12345
    for vv, qq in ((vb, qb[:64]), (vi8, qi8[:64])):
        ks, ki = binned_call(vv, qq, 1024, "wgmma", k=K_POOL, n_real=n_real)
        rs, ri = fused_mips_binned_reference(vv, qq, k=K_POOL, bins=1024, n_real=n_real)
        check(ki.max().item() < n_real, f"n_real masking ({vv.dtype}): a masked row was returned")
        if vv.dtype == torch.int8:
            check(torch.equal(ki, ri) and torch.equal(ks, rs), "n_real masking (int8): kernel != plain")
        else:  # the two sum orders may swap ids inside the band
            check_against_plain(f"n_real masking ({vv.dtype})", ks, ki, rs, ri, qq, vv, tol)
    saved = vi8[[7 + 512 * 3, 7 + 512 * 20]].clone()
    vi8[7 + 512 * 3] = vi8[7]
    vi8[7 + 512 * 20] = vi8[7]
    qdup = qi8[:64].clone()
    qdup[0] = vi8[7]
    ks, ki = binned_call(vi8, qdup, 512, "wgmma", k=512)
    rs, ri = fused_mips_binned_reference(vi8, qdup, k=512, bins=512)
    check(ki[0, 0].item() == 7 and torch.equal(ki, ri) and torch.equal(ks, rs), "duplicate rows: tie not to lowest id")
    vi8[[7 + 512 * 3, 7 + 512 * 20]] = saved
    log(f"check edges: n_real={n_real} masked in bf16 and int8; duplicate rows tie to the lowest id")

    shapes = []
    for dtype, vv, qq, b, bins, expect, n_real in binned_cases:
        if n_real != N_KERNEL:
            continue
        qs = qq[:b]
        body = binned_body_of(vv, qs, bins, expect)
        reps = 20 if b <= 64 else 3
        ms = time_ms(lambda: fused_mips_binned(vv, qs, k=K_POOL, bins=bins), reps)
        plain_ms = time_ms(lambda: fused_mips_binned_reference(vv, qs, k=K_POOL, bins=bins), 2)
        # the library yardstick: exact top-k over one library product
        # (cuBLAS bf16 GEMM, or cuBLASLt int8 x int8 -> int32 through
        # `torch._int_mm`, which takes only more than 16 rows; it reads the
        # aligned int8 corpus, since cuBLASLt may refuse rows off the grid)
        library_ms = None
        if dtype == "bfloat16":
            library_ms = time_ms(lambda: torch.topk(qs @ vv.T, K_POOL, dim=-1), reps)
        elif b > 16:
            library_ms = time_ms(lambda: torch.topk(torch._int_mm(qs, vi8.T), K_POOL, dim=-1), reps)
        peak = peak_bf16 if dtype == "bfloat16" else peak_int8
        nbytes = (N_KERNEL + b) * D * vv.element_size() + b * K_POOL * 8
        ops = 2 * b * N_KERNEL * D
        bound = max(nbytes / hbm, ops / peak) * 1e3
        shapes.append(dict(
            dtype=dtype, body=body, B=b, N=N_KERNEL, D=D, bins=bins, k=K_POOL, ms=ms, plain_ms=plain_ms,
            library_ms=library_ms, bound_ms=bound,
            bound_by="bytes" if nbytes / hbm >= ops / peak else "operations",
        ))
        log(f"time {dtype} B={b} bins={bins} ({body}): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"library {library_ms if library_ms is None else round(library_ms, 4)} ms, "
            f"bound {bound:.4f} ms ({shapes[-1]['bound_by']}) [{card}]")
    del vi8, qi8, vi8_odd, binned_cases

    # 3b. the exact kernel vs its plain version at the headline shape
    v32 = vb.float()  # the f32 case: the bf16 corpus widened, summed in full f32
    exact_cases = [("bfloat16", vb, qb, b, k, "wgmma") for b in BATCHES for k in EXACT_KS] + [
        ("float32", v32, q32, 64, 128, "fma"),
        ("bfloat16", vb_odd, qb, 64, 10, "fma"),
        ("bfloat16", vb_odd, qb, 2048, 128, "fma"),
    ]
    exact_err = 0.0

    def body_of(vv, qs, expect: str) -> str:
        """The body a call takes, named by the wrapper's rule and confirmed by
        the per-body launch count."""
        body = _topk_body(vv.dtype, D, (vv.data_ptr(), qs.to(vv.dtype).data_ptr()))
        check(body == expect, f"{vv.dtype} at offset {vv.storage_offset()}: body {body}, not {expect}")
        return body

    # the tensor-core body's edge cases: a ragged query tile, k = 1, a ragged last row tile
    edge_cases = [("bfloat16", vb, qb, b, 1, "wgmma", N_KERNEL - 77) for b in (3, 65)]
    for dtype, vv, qq, b, k, expect, n_real in [c + (N_KERNEL,) for c in exact_cases] + edge_cases:
        body = body_of(vv, qq[:b], expect)
        before = fused_mips_topk.body_launches[body]
        ks, ki = fused_mips_topk(vv, qq[:b], k=k, n_real=n_real)
        check(fused_mips_topk.body_launches[body] == before + 1, f"exact {dtype} B={b}: not on the {body} body")
        err, swaps = check_against_plain(
            f"exact {dtype} B={b} k={k} n_real={n_real}", ks, ki,
            *fused_mips_topk_reference(vv, qq[:b], k=k, n_real=n_real), qq[:b].to(vv.dtype), vv, tol,
        )
        check(ki.max().item() < n_real, f"exact {dtype} B={b} n_real={n_real}: a masked row was returned")
        exact_err = max(exact_err, err)
        log(f"check exact {dtype} B={b} k={k} n_real={n_real} ({body}): max |kernel - plain| = {err:.3g} "
            f"(tol {tol:.3g}), {swaps} id swaps inside the band")
    for n_real, k in ((N_KERNEL - 12345, 10), (3, 10)):
        ks, ki = fused_mips_topk(vb, qb[:64], k=k, n_real=n_real)
        check_against_plain(f"exact n_real={n_real}", ks, ki,
                            *fused_mips_topk_reference(vb, qb[:64], k=k, n_real=n_real), qb[:64], vb, tol)
        check(ki.max().item() < n_real, f"exact n_real={n_real}: a masked row was returned")
    check(bool((ki[:, 3:] == -1).all()) and bool(torch.isneginf(ks[:, 3:]).all()),
          "exact n_real=3: slots 3-9 are not -1/-inf")
    # equal rows in different splits at B = 64 (~8k rows a split) and B = 2048 (262,144)
    dups = (7, 7 + 2 * N_KERNEL // 7, 7 + 2 * N_KERNEL // 3)
    saved = vb[list(dups[1:])].clone()
    vb[list(dups[1:])] = vb[7].clone()
    for b in (64, 2048):
        qdup = qb[:b].clone()
        qdup[0] = vb[7]
        ks, ki = fused_mips_topk(vb, qdup, k=10)
        check_against_plain(f"exact duplicates B={b}", ks, ki, *fused_mips_topk_reference(vb, qdup, k=10), qdup, vb, tol)
        check(ki[0, :3].tolist() == list(dups), f"exact duplicates B={b}: {ki[0, :3].tolist()} != {list(dups)}")
    vb[list(dups[1:])] = saved
    log(f"check exact edges: n_real={N_KERNEL - 12345} masked; n_real=3 leaves slots 3-9 at -1/-inf; "
        f"rows {dups} tie in that order at B=64 and 2048")

    # one PyTorch read of the corpus: the rate at which the card streams these bytes
    read_ms = time_ms(lambda: vb.sum(dtype=torch.float32), 20)
    log(f"time corpus read (bf16 {N_KERNEL} x {D}, {vb.numel() * 2 / 1e9:.4f} GB): {read_ms:.4f} ms [{card}]")
    exact_shapes = []
    for dtype, vv, qq, b, k, expect in exact_cases:
        qs = qq[:b].to(vv.dtype)
        body = body_of(vv, qs, expect)
        reps = 20 if b <= 64 else 3
        ms = time_ms(lambda: fused_mips_topk(vv, qs, k=k), reps)
        plain_ms = time_ms(lambda: fused_mips_topk_reference(vv, qs, k=k), 2)
        library_ms = time_ms(lambda: torch.topk(qs @ vv.T, k, dim=-1), reps)
        nbytes = (N_KERNEL + b) * D * vv.element_size() + b * k * 8
        ops = 2 * b * N_KERNEL * D
        peak = peak_bf16 if dtype == "bfloat16" else peak_f32
        bound = max(nbytes / hbm, ops / peak) * 1e3
        exact_shapes.append(dict(
            dtype=dtype, body=body, B=b, N=N_KERNEL, D=D, k=k, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
            bound_ms=bound, bound_by="bytes" if nbytes / hbm >= ops / peak else "operations",
        ))
        log(f"time exact {dtype} B={b} k={k} ({body}): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"library {library_ms:.4f} ms, bound {bound:.4f} ms ({exact_shapes[-1]['bound_by']}) [{card}]")
    del vb, vb_odd, qb, q32, v32
    torch.cuda.empty_cache()

    # 4. the serving path (main path)
    cfg = TransformerEncoderConfig(  # configs/presets/encoder/e5-base.yaml + pooler/mean-l2.yaml
        vocab_size=30522, hidden_size=768, num_layers=12, num_heads=12, intermediate_size=3072,
        max_position_embeddings=512, dtype=torch.bfloat16,
        pooler=VodPoolerConfig(agg_method="mean", output_norm="l2", scaler=10.0, learn_scaler=True),
    )
    encoder = VodEncoder(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0)).eval()
    gs = torch.Generator(device=dev).manual_seed(1)
    corpus = torch.randn((N_SERVE, D), generator=gs, device=dev)
    corpus /= corpus.norm(dim=-1, keepdim=True)
    t0 = time.perf_counter()
    flat = build_dense_index(corpus, dtype="bfloat16", kernel="fused", refine="float32", device=dev)
    flat = flat.replace(fused_bins=1024)
    int8 = build_dense_index(corpus, dtype="int8", kernel="fused", device=dev)
    torch.cuda.synchronize()
    log(f"indexes: flat bf16 + f32 refine ({flat.vectors.shape[0]} rows, 1024 bins), int8 (512 bins); "
        f"built in {time.perf_counter() - t0:.2f} s")
    held_src = torch.randperm(N_SERVE, generator=gs, device=dev)[:N_QUERIES]
    held = corpus[held_src] + 0.1 * torch.randn((N_QUERIES, D), generator=gs, device=dev)
    held = held / held.norm(dim=-1, keepdim=True)
    exact_ids = torch.topk(held @ corpus.T, TOP_K, dim=-1).indices.cpu().numpy()
    ids = torch.randint(1000, cfg.vocab_size, (N_QUERIES, QUERY_TOKENS), generator=gs, device=dev)
    lengths = torch.randint(8, QUERY_TOKENS + 1, (N_QUERIES, 1), generator=gs, device=dev)
    mask = (torch.arange(QUERY_TOKENS, device=dev)[None] < lengths).to(torch.int32)
    gold = torch.randint(0, N_SERVE, (N_QUERIES, 1), generator=gs, device=dev).to(torch.int32).cpu().numpy()
    held_np = held.cpu().numpy()
    del corpus
    direct = {}  # the port's own dense_search on the held-out vectors, called directly
    for name, ix in (("flat", flat), ("int8", int8)):
        out = dense_search(ix, SearchQueries(vector=held), top_k=TOP_K)
        direct[name] = (out.indices.cpu().numpy(), out.scores.cpu().numpy())

    def post_all(client, payloads, workers):
        lat = []

        def one(p):
            t = time.perf_counter()
            out = client.search(top_k=TOP_K, **p)
            lat.append(time.perf_counter() - t)
            return out

        with concurrent.futures.ThreadPoolExecutor(workers) as ex:
            outs = list(ex.map(one, payloads))
        return outs, lat

    fused_mips_binned.launches = 0
    fused_mips_binned.body_launches.update(wgmma=0, fma=0)  # main path starts
    t_main = time.perf_counter()
    with torch.inference_mode():
        qv = encoder(ids, mask)
    torch.cuda.synchronize()
    check(qv.shape == (N_QUERIES, D) and bool(torch.isfinite(qv).all()), "encoder output not finite [64, 768]")
    norms = qv.norm(dim=-1)
    check(bool(((norms - 10.0**0.5).abs() < 1e-3).all()), "pooled norms are not sqrt(10)")
    qv_np = qv.cpu().numpy()
    log(f"encode: {N_QUERIES} x {QUERY_TOKENS} tokens through the e5-base-width encoder -> {tuple(qv.shape)}")
    servers = [
        SearchServer(HybridEngines(dense=ix), batch_window_ms=2, max_batch=64, device=dev) for ix in (flat, int8)
    ]
    results = {}
    for name, ix, srv in (("flat", flat, servers[0]), ("int8", int8, servers[1])):
        with srv:
            srv.warmup({"vector": qv_np[:1], "section_ids": gold[:1]}, top_k=TOP_K)
            srv.warmup({"vector": held_np[:1]}, top_k=TOP_K)
            client = SearchHttpClient(srv.url)
            check(client.ping(), f"{name}: server not ready")
            with urllib.request.urlopen(srv.url + "/stats", timeout=30) as r:
                before = json.loads(r.read())
            enc_payloads = [
                {"vector": qv_np[i : i + 4], "section_ids": gold[i : i + 4]} for i in range(0, N_QUERIES, 4)
            ]
            held_payloads = [{"vector": held_np[i : i + 4]} for i in range(0, N_QUERIES, 4)]
            enc_out, _ = post_all(client, enc_payloads, 16)
            held_out, _ = post_all(client, held_payloads, 16)
            with urllib.request.urlopen(srv.url + "/stats", timeout=30) as r:
                after = json.loads(r.read())
            stats = {k: after[k] - before[k] for k in ("requests", "dispatches")}
            n_req = len(enc_payloads) + len(held_payloads)
            check(stats["requests"] == n_req and stats["dispatches"] < n_req, f"{name}: no batching {stats}")
            for i, out in enumerate(enc_out):
                got = out.indices
                check(bool(((got >= 0) & (got < N_SERVE) | (got == -1)).all()), f"{name}: id out of range")
                for r in range(got.shape[0]):
                    g_id = int(gold[4 * i + r, 0])
                    row = got[r].tolist()
                    check(g_id in row and out.labels[r][row.index(g_id)] == 1, f"{name}: gold id lost")
            served = np.concatenate([o.indices for o in held_out], axis=0)
            check(bool(((served >= 0) & (served < N_SERVE)).all()), f"{name}: held-out id out of range")
            direct_ids, direct_s = direct[name]
            for r, c in zip(*(served != direct_ids).nonzero()):  # only an f32 tie may swap two ids
                pos = direct_ids[r].tolist().index(served[r, c]) if served[r, c] in direct_ids[r] else None
                check(pos is not None and abs(direct_s[r, pos] - direct_s[r, c]) < 1e-5,
                      f"{name}: served ids != direct dense_search ids (row {r})")
            recall = float(sum(len(set(served[r]) & set(exact_ids[r])) for r in range(N_QUERIES)) / (N_QUERIES * TOP_K))
            top1 = float((served[:, 0] == held_src.cpu().numpy()).mean())
            results[name] = dict(recall_at_10=recall, top1_is_source=top1, stats=stats)
            log(f"serve {name}: {n_req} requests in {stats['dispatches']} dispatches; recall@10 {recall:.4f}; "
                f"top-1 = source row for {top1:.3f}; served ids == direct dense_search")
            check(top1 == 1.0, f"{name}: a held-out query lost its source row")
            if name == "flat":
                check(recall >= RECALL_FLOOR, f"flat recall@10 {recall:.4f} < floor {RECALL_FLOOR}")
                single = [{"vector": held_np[i % N_QUERIES : i % N_QUERIES + 1]} for i in range(100)]
                _, lat1 = post_all(client, single, 1)
                many = [{"vector": held_np[i % N_QUERIES : i % N_QUERIES + 1]} for i in range(320)]
                t = time.perf_counter()
                _, lat32 = post_all(client, many, 32)
                wall = time.perf_counter() - t
                results["latency"] = dict(
                    one_client_ms=dict(n=100, p50=statistics.median(lat1) * 1e3, p90=percentile(lat1, 90) * 1e3),
                    clients_32_ms=dict(n=320, p50=statistics.median(lat32) * 1e3, p95=percentile(lat32, 95) * 1e3),
                    clients_32_qps=320 / wall,
                )
                log(f"latency flat [{card}]: {json.dumps(results['latency'])}")
    torch.cuda.synchronize()
    launches = fused_mips_binned.launches  # main path ends
    binned_body_launches = dict(fused_mips_binned.body_launches)
    log(f"main path: {time.perf_counter() - t_main:.2f} s; fused_mips_binned launches {launches}, "
        f"by body {binned_body_launches}")
    check(launches > 0, "the main path never launched fused_mips_binned")
    check(binned_body_launches == {"wgmma": launches, "fma": 0},
          "the serving path's fused_mips_binned calls did not all take the tensor-core body")

    # 4b. the kernel shootout (the exact kernel's main path)
    fused_mips_binned.launches = 0
    fused_mips_binned.body_launches.update(wgmma=0, fma=0)
    fused_mips_topk.launches = 0
    fused_mips_topk.body_launches.update(wgmma=0, fma=0)  # main path starts
    t_main = time.perf_counter()
    shootout = mips_kernel_bench.main(SHOOTOUT_ARGS)
    torch.cuda.synchronize()
    shootout_launches = {"fused_mips_topk": fused_mips_topk.launches, "fused_mips_binned": fused_mips_binned.launches}
    body_launches = dict(fused_mips_topk.body_launches)
    shootout_binned_bodies = dict(fused_mips_binned.body_launches)
    log(f"main path (shootout): {time.perf_counter() - t_main:.2f} s; launches {shootout_launches}, "
        f"fused_mips_topk by body {body_launches}, fused_mips_binned by body {shootout_binned_bodies}")
    check(shootout_launches["fused_mips_topk"] > 0, "the shootout never launched fused_mips_topk")
    check(body_launches == {"wgmma": shootout_launches["fused_mips_topk"], "fma": 0},
          "the shootout's fused_mips_topk calls did not all take the tensor-core body")
    check(shootout_launches["fused_mips_binned"] > 0, "the shootout never launched fused_mips_binned")
    check(shootout_binned_bodies == {"wgmma": shootout_launches["fused_mips_binned"], "fma": 0},
          "the shootout's fused_mips_binned calls did not all take the tensor-core body")
    check(shootout["exact_kernel_recall"] >= EXACT_RECALL_FLOOR,
          f"exact kernel recall@10 {shootout['exact_kernel_recall']} < {EXACT_RECALL_FLOOR}")
    check(shootout["binned_recall"] >= BINNED_RECALL_FLOOR,
          f"binned recall@10 {shootout['binned_recall']} < {BINNED_RECALL_FLOOR}")
    check(all(math.isfinite(shootout[f"{r}_qps"]) and shootout[f"{r}_qps"] > 0
              for r in ("scan", "binned", "exact_kernel")), "a shootout route has no QPS")

    # 5. result lines
    main = next(s for s in shapes if s["dtype"] == "bfloat16" and s["B"] == 64 and s["bins"] == 1024
                and s["body"] == "wgmma")
    exact_main = next(s for s in exact_shapes if s["dtype"] == "bfloat16" and s["B"] == 2048 and s["k"] == 10
                      and s["body"] == "wgmma")
    kernels = [dict(
        name="fused_mips_binned", route="cuda", source="vod_tpu_torch/csrc/fused_mips_binned.cu",
        replaces="vod_tpu/ops/mips_pallas.py:151", launches=launches, max_abs_err=max_err,
        ms=main["ms"], plain_ms=main["plain_ms"], bound_ms=main["bound_ms"], bound_by=main["bound_by"],
        library_ms=main["library_ms"], shape=f"bfloat16 B=64 N={N_KERNEL} D={D} bins=1024 k={K_POOL}",
        shapes=shapes, serving=results, shootout_launches=shootout_launches["fused_mips_binned"],
        body=main["body"], body_launches=binned_body_launches, shootout_body_launches=shootout_binned_bodies,
        body_ms={body: {f"{s['dtype']} B={s['B']} bins={s['bins']}": s["ms"] for s in shapes if s["body"] == body}
                 for body in ("wgmma", "fma")},
    ), dict(
        name="fused_mips_topk", route="cuda", source="vod_tpu_torch/csrc/fused_mips_topk.cu",
        replaces="vod_tpu/ops/mips_pallas.py:57", launches=shootout_launches["fused_mips_topk"],
        max_abs_err=exact_err, ms=exact_main["ms"], plain_ms=exact_main["plain_ms"],
        bound_ms=exact_main["bound_ms"], bound_by=exact_main["bound_by"], library_ms=exact_main["library_ms"],
        shape=f"bfloat16 B=2048 N={N_KERNEL} D={D} k=10", shapes=exact_shapes, shootout=shootout,
        body=exact_main["body"], body_launches=body_launches, corpus_read_ms=read_ms,
        body_ms={body: {f"{s['dtype']} B={s['B']} k={s['k']}": s["ms"] for s in exact_shapes if s["body"] == body}
                 for body in ("wgmma", "fma")},
    )]
    log(json.dumps({"kernels": kernels}))
    log(mips_kernel_bench.card_name(dev))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
