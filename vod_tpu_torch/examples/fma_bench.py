"""The CUDA-core ("fma") bodies of both MIPS kernels beside their yardsticks,
on one NVIDIA GPU.

    python -m vod_tpu_torch.examples.fma_bench
    python -m vod_tpu_torch.examples.fma_bench --device cpu --n 4096 --d 48   # the plain path

`fused_mips_topk` and `fused_mips_binned` each run a call on one of two
bodies, named by a fixed rule (`ops/mips.py:_topk_body`, `_binned_body`):
"wgmma" (tensor cores) or "fma" (f32 FMAs on CUDA cores: every f32 call, and
bf16 calls off the tensor-core rule, such as rows one element off the 16-byte
grid). `CASES` holds the fma calls that the card script's phases 3 and 3b
time, the exact f32 call at k = 1, 10 and 128 (the product is the same, only
the selection's work differs, so the differences split the time between
product and selection), and three wide `wgmma` calls as controls. The inputs
are phase 3's: seeded unit rows (N x D) and queries near corpus rows, the bf16
rows copied one element off the grid, the f32 rows the bf16 ones widened.

For each case it measures:

  ms                  CUDA events over `--reps` calls (3 at B = 2048), per call;
  plain_ms            the plain PyTorch version, 2 calls;
  library_ms          `torch.topk(q @ Vᵀ, k)` (int8: `torch._int_mm`, B > 16)
                      between CUDA events; f32 products run with TF32 off;
  bound_ms            the card's bound: the larger of the bytes (corpus and
                      queries read once, [B, k] scores and ids written once)
                      over the memory rate and 2 B N D operations over the
                      peak of the inputs' type (bf16 and int8 on the tensor
                      cores, f32 on CUDA cores), from an H100 SXM's data sheet;
  cuda_core_bound_ms  the same with the operations over the f32 CUDA-core peak
                      (the fma bodies' own ceiling);
  body, launches      the body the rule names and, on the card, the launches
                      the call added to that body's count;
  max_abs_err, swaps  the kernel against the plain version: scores within
                      twice the f32 sum-order bound, ids equal except swaps
                      inside that band (checked; a failure raises).

On the CPU (`--device cpu`) the wrappers run their plain versions, so `ms` is
a CPU time of the plain path, no library call is timed and no bound applies.
Prints one JSON line per case and one with the card; `main` returns the
rows.
"""

from __future__ import annotations

import argparse
import json
import typing as typ

# (label, kernel, corpus, B, bins or k, body): corpus "bf16_odd" is the bf16
# rows one element off the 16-byte grid, "f32" the bf16 rows widened
CASES = (
    ("binned bf16 off-grid B=64 1024 bins", "binned", "bf16_odd", 64, 1024, "fma"),
    ("binned bf16 off-grid B=2048 512 bins", "binned", "bf16_odd", 2048, 512, "fma"),
    ("binned f32 B=64 1024 bins", "binned", "f32", 64, 1024, "fma"),
    ("exact f32 B=64 k=1", "exact", "f32", 64, 1, "fma"),
    ("exact f32 B=64 k=10", "exact", "f32", 64, 10, "fma"),
    ("exact f32 B=64 k=128", "exact", "f32", 64, 128, "fma"),
    ("exact bf16 off-grid B=64 k=10", "exact", "bf16_odd", 64, 10, "fma"),
    ("exact bf16 off-grid B=2048 k=128", "exact", "bf16_odd", 2048, 128, "fma"),
    ("control binned bf16 B=64 1024 bins", "binned", "bf16", 64, 1024, "wgmma"),
    ("control binned bf16 B=2048 1024 bins", "binned", "bf16", 2048, 1024, "wgmma"),
    ("control binned int8 B=2048 512 bins", "binned", "int8", 2048, 512, "wgmma"),
)
K_POOL = 40  # the binned calls' k (the served path's pool, as phase 3)
# an H100 SXM's data sheet: memory bytes/s; dense bf16, int8 and f32 (CUDA-core) operations/s
HBM, PEAK_BF16, PEAK_INT8, PEAK_F32 = 3.35e12, 989e12, 1979e12, 67e12


def make_inputs(n: int, d: int, device) -> dict:
    """Phase 3's inputs: unit rows, 2,048 queries near rows, the bf16 rows, a
    copy one element off the grid, int8 codes, and the f32 rows widened from
    bf16."""
    import torch

    from vod_tpu_torch.ops.pq import quantize_int8
    from vod_tpu_torch.search.dense import quantize_queries_int8

    g = torch.Generator(device=device).manual_seed(0)
    v32 = torch.randn((n, d), generator=g, device=device)
    v32 /= v32.norm(dim=-1, keepdim=True)
    src = torch.randint(0, n, (2048,), generator=g, device=device)
    q32 = v32[src] + 0.1 * torch.randn((2048, d), generator=g, device=device)
    q32 /= q32.norm(dim=-1, keepdim=True)
    vb = v32.to(torch.bfloat16)
    vi8, scale = quantize_int8(v32, dim=0)
    qi8, _ = quantize_queries_int8(q32, scale)
    del v32
    vb_odd = torch.empty(n * d + 1, dtype=torch.bfloat16, device=device)[1:].view(n, d)
    vb_odd.copy_(vb)
    return dict(bf16=(vb, q32.to(torch.bfloat16)), bf16_odd=(vb_odd, q32.to(torch.bfloat16)),
                f32=(vb.float(), q32), int8=(vi8, qi8))


def compare(ks, ki, rs, ri, q, v, tol: float) -> tuple[float, int]:
    """Kernel (ks, ki) against plain (rs, ri), as the card script's
    `check_against_plain`: the same empty slots, finite scores within `tol`,
    an id different only where its exact score lies within 2 tol of the plain
    one. Returns (max error, swaps); raises on a failure."""
    import torch

    finite = torch.isfinite(rs)
    if not torch.equal(torch.isfinite(ks), finite) or not torch.equal(ki[~finite], ri[~finite]):
        raise AssertionError("empty slots differ")
    err = (ks[finite] - rs[finite]).abs().max().item() if finite.any() else 0.0
    if err > tol:
        raise AssertionError(f"max score error {err:.3g} > {tol:.3g}")
    rows, cols = (ki != ri).nonzero(as_tuple=True)
    if len(rows):
        exact = (q.to(v.dtype)[rows].double() * v[ki[rows, cols].long()].double()).sum(-1)
        gap = (exact - rs[rows, cols].double()).abs().max().item()
        if gap > 2 * tol:
            raise AssertionError(f"id swap outside the band ({gap:.3g})")
    return err, len(rows)


def run(device, *, n: int = 1 << 20, d: int = 768, reps: int = 20, wide_reps: int = 3, cases=CASES,
        hbm: float = HBM, peaks: typ.Optional[dict] = None, inputs: typ.Optional[dict] = None,
        library_inputs: typ.Optional[dict] = None, extra: typ.Optional[typ.Callable] = None) -> list[dict]:
    """Measure each case; see the module docstring. `inputs` (default
    `make_inputs(n, d)`) maps a case's corpus to its (rows, queries), and
    `library_inputs` an int8 corpus to the (rows, queries) that the library
    call reads in its place (cuBLASLt wants rows on the grid and D % 8 == 0).
    `extra(row, v, q, call, reps)` adds a card row's own fields."""
    import torch

    from vod_tpu_torch.examples.narrow_call_bench import _events_ms
    from vod_tpu_torch.ops import mips

    peaks = peaks or dict(bf16=PEAK_BF16, int8=PEAK_INT8, f32=PEAK_F32)
    mips.set_full_f32_matmul()
    inputs = inputs or make_inputs(n, d, device)
    library_inputs = library_inputs or {}
    vb, qb = inputs["bf16"]
    tol = 2 * d * 2.0**-24 * qb.float().norm(dim=-1).max().item() * vb.float().norm(dim=-1).max().item()
    out = []
    for label, kernel, corpus, b, width, expect in cases:
        v, q = inputs[corpus]
        q = q[:b]
        qk = q.to(v.dtype)
        d = int(v.shape[1])
        ptrs = (v.data_ptr(), qk.data_ptr())
        if kernel == "binned":
            body = mips._binned_body(v.dtype, d, width, ptrs)
            counter = mips.fused_mips_binned
            call = lambda: mips.fused_mips_binned(v, q, k=K_POOL, bins=width)  # noqa: E731
            plain = lambda: mips.fused_mips_binned_reference(v, q, k=K_POOL, bins=width)  # noqa: E731
            k = K_POOL
        else:
            body = mips._topk_body(v.dtype, d, ptrs)
            counter = mips.fused_mips_topk
            call = lambda: mips.fused_mips_topk(v, q, k=width)  # noqa: E731
            plain = lambda: mips.fused_mips_topk_reference(v, q, k=width)  # noqa: E731
            k = width
        if body != expect:
            raise AssertionError(f"{label}: the rule names {body}, not {expect}")
        row = dict(label=label, kernel=kernel, dtype=str(v.dtype).split(".")[-1],
                   storage_offset=v.storage_offset(), B=b, N=n, D=d, k=k, body=body)
        if kernel == "binned":
            row["bins"] = width
        before = counter.body_launches[body]
        ks, ki = call()
        rs, ri = plain()
        row["launches"] = counter.body_launches[body] - before
        if device.type == "cuda" and row["launches"] != 1:
            raise AssertionError(f"{label}: not launched once on the {body} body")
        if v.dtype == torch.int8:
            if not (torch.equal(ks, rs) and torch.equal(ki, ri)):
                raise AssertionError(f"{label}: kernel != plain")
            row["max_abs_err"], row["swaps"] = 0.0, 0
        else:
            row["max_abs_err"], row["swaps"] = compare(ks, ki, rs, ri, q, v, tol)
        r = reps if b <= 64 else wide_reps
        row["ms"] = _events_ms(call, r, device)
        row["plain_ms"] = _events_ms(plain, 2, device)
        if device.type == "cuda":
            if v.dtype == torch.int8:
                lv, lq = library_inputs.get(corpus, (v, qk))
                lq = lq[:b]
                row["library_ms"] = (_events_ms(lambda: torch.topk(torch._int_mm(lq, lv.T), k, dim=-1), r, device)
                                     if b > 16 else None)
            else:
                row["library_ms"] = _events_ms(lambda: torch.topk(qk @ v.T, k, dim=-1), r, device)
        nbytes = (n + b) * d * v.element_size() + b * k * 8
        ops = 2 * b * n * d
        peak = peaks[{torch.bfloat16: "bf16", torch.int8: "int8", torch.float32: "f32"}[v.dtype]]
        row["bound_ms"] = max(nbytes / hbm, ops / peak) * 1e3
        row["bound_by"] = "bytes" if nbytes / hbm >= ops / peak else "operations"
        row["cuda_core_bound_ms"] = max(nbytes / hbm, ops / peaks["f32"]) * 1e3
        if device.type == "cuda" and extra is not None:
            extra(row, v, q, call, r)
        out.append(row)
    return out


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=1 << 20)
    ap.add_argument("--d", type=int, default=768)
    ap.add_argument("--reps", type=int, default=20, help="timed calls a case at B <= 64 (3 at B = 2048)")
    return ap


def main(argv: typ.Optional[list[str]] = None) -> list[dict]:
    args = parser().parse_args(argv)
    from vod_tpu_torch.examples.mips_kernel_bench import card_name
    from vod_tpu_torch.examples.synthetic import device_of

    device = device_of(args.device)
    rows = run(device, n=args.n, d=args.d, reps=args.reps)
    for row in rows:
        print(json.dumps(row), flush=True)
    print(json.dumps({"card": card_name(device)}), flush=True)
    return rows


if __name__ == "__main__":
    main()
