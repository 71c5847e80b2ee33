"""Where the time of a narrow `fused_mips_binned` call goes, on one NVIDIA GPU.

    python -m vod_tpu_torch.examples.narrow_call_bench            # the five shapes of SHAPES
    python -m vod_tpu_torch.examples.narrow_call_bench --parts    # and phase 9's call taken apart

A narrow call is one retrieval call of the training CLI's loops: a few dozen
queries over 2^14 - 2^16 rows at k = 100 (`search/dense.py` flat and
`search/sharded.py` per shard reach `fused_mips_binned` so). `SHAPES` holds the
five that the card script's CLI phases reach. For each, over seeded random
unit rows (bf16) or int8 codes, it measures:

  wall_ms     20 back-to-back calls between CUDA events, per call;
  host_ms     the host's enqueue of `--reps` calls (perf_counter, no
              synchronize inside), per call;
  device_ms   `torch.profiler` over 50 calls (`profile_reps`): the device
  kernels     time per call and the kernel launches (copies included) per
              call, in all and by name (the wrapper's own span, which the
              profiler also puts on the device's timeline, left out);
  splits      the stride splits of the call's launch plan (the card only);
  library_ms  `torch.topk(q @ Vᵀ, k)` (bf16) or `torch.topk(torch._int_mm(q,
              Vᵀ), k)` (int8, B > 16), 20 calls between CUDA events;
  bound_ms    the larger of the bytes (corpus rows below n_real and the
              queries read once, [B, k] scores and ids written once) over the
              memory rate and the operations over the peak rate (`HBM`,
              `PEAK_BF16`, `PEAK_INT8`: an H100 SXM's data sheet).

`--parts` (the card only) times, at phase 9's shape, each part of a call
alone: `_check`, the plan's lookup, the two allocations, the current stream's
handle (the binding the wrapper uses, and the public
`torch.cuda.current_stream(dev).cuda_stream`), the C entry of the body and
the select kernel (two launches, two tensor-map encodes), the select kernel's
entry alone (one launch) and the whole wrapper, host µs a call over 2,000
calls, no synchronize inside.

On the CPU (`--device cpu`) only the host numbers mean anything, and they are
CPU numbers. Prints one JSON line per shape and one with the card; `run`
returns the rows.
"""

from __future__ import annotations

import argparse
import json
import time
import typing as typ

# (label, dtype, B, D, rows, bins, k): the CLI loops' narrow calls
SHAPES = (
    ("12b per shard", "int8", 32, 256, 1 << 16, 512, 100),
    ("15b roberta CLI", "bfloat16", 32, 768, 1 << 14, 512, 100),
    ("10 large CLI", "bfloat16", 4, 1024, 1 << 15, 512, 100),
    ("9 CLI loop", "bfloat16", 32, 384, 1 << 15, 512, 100),
    ("14a MoE CLI", "bfloat16", 32, 384, 1 << 14, 512, 100),
)
# an H100 SXM's data sheet: memory bytes/s, dense bf16 and int8 operations/s
HBM, PEAK_BF16, PEAK_INT8 = 3.35e12, 989e12, 1979e12


def _events_ms(fn: typ.Callable, reps: int, device) -> float:
    import torch

    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize(device)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_profile(fn: typ.Callable, reps: int) -> tuple[float, float, dict]:
    """Per call: device ms, kernel launches, and device ms by kernel name."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    for _ in range(3):  # a profile that records no device event at all (seen on the card) is taken again
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()  # kernels and copies, not the wrapper's span on the device's timeline
                if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)
                and e.key != "fused_mips_binned"]
        if rows:
            break
    by_name = {e.key[:60]: round(e.self_device_time_total / 1e3 / reps, 5) for e in rows}
    launches = sum(e.count for e in rows) / reps
    return sum(by_name.values()), launches, by_name


def make_inputs(dtype: str, b: int, d: int, rows: int, device, seed: int = 0):
    """Seeded unit rows and queries near corpus rows (bf16), or int8 codes."""
    import torch

    g = torch.Generator(device="cpu").manual_seed(seed)
    if dtype == "int8":
        v = torch.randint(-127, 128, (rows, d), generator=g, dtype=torch.int8)
        q = torch.randint(-127, 128, (b, d), generator=g, dtype=torch.int8)
    else:
        v = torch.randn((rows, d), generator=g)
        v /= v.norm(dim=-1, keepdim=True)
        q = v[torch.randint(0, rows, (b,), generator=g)] + 0.1 * torch.randn((b, d), generator=g)
        q /= q.norm(dim=-1, keepdim=True)
        v, q = v.to(torch.bfloat16), q.to(torch.bfloat16)
    return v.to(device), q.to(device)


def run(device, *, reps: int = 200, profile_reps: int = 50, scale: int = 1, hbm: float = HBM,
        peak_bf16: float = PEAK_BF16, peak_int8: float = PEAK_INT8, shapes=SHAPES) -> list[dict]:
    """Measure each shape (rows divided by `scale`); see the module docstring."""
    import torch

    from vod_tpu_torch.ops import mips

    out = []
    for label, dtype, b, d, rows, bins, k in shapes:
        rows //= scale
        v, q = make_inputs(dtype, b, d, rows, device)
        call = lambda: mips.fused_mips_binned(v, q, k=k, bins=bins)  # noqa: E731
        row = dict(label=label, dtype=dtype, B=b, D=d, rows=rows, bins=bins, k=k)
        call()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        for _ in range(reps):
            call()
        row["host_ms"] = (time.perf_counter() - t0) * 1e3 / reps
        row["wall_ms"] = _events_ms(call, 20, device)
        if device.type == "cuda":
            row["splits"] = mips._binned_plan(v, q, bins, rows).splits
            row["device_ms"], row["kernels"], row["by_kernel"] = device_profile(call, profile_reps)
            if dtype == "int8":
                row["library"] = "topk(_int_mm)"
                row["library_ms"] = (_events_ms(lambda: torch.topk(torch._int_mm(q, v.T), k, dim=-1), 20, device)
                                     if b > 16 else None)
            else:
                row["library"] = "topk(matmul)"
                row["library_ms"] = _events_ms(lambda: torch.topk(q @ v.T, k, dim=-1), 20, device)
        nbytes = (rows + b) * d * v.element_size() + b * k * 8
        ops = 2 * b * rows * d
        peak = peak_int8 if dtype == "int8" else peak_bf16
        row["bound_ms"] = max(nbytes / hbm, ops / peak) * 1e3
        row["bound_by"] = "bytes" if nbytes / hbm >= ops / peak else "operations"
        out.append(row)
        del v, q
    return out


def parts(device, reps: int = 2000) -> dict:
    """Host µs a call of each part of phase 9's call, timed alone (see the
    module docstring)."""
    import torch

    from vod_tpu_torch.ops import mips

    _, dtype, b, d, rows, bins, k = next(s for s in SHAPES if s[0] == "9 CLI loop")
    v, q = make_inputs(dtype, b, d, rows, device)
    device = v.device  # with its index, as the wrapper sees it

    def host_us(fn) -> float:
        fn()
        torch.cuda.synchronize(device)
        t0 = time.perf_counter_ns()
        for _ in range(reps):
            fn()
        us = (time.perf_counter_ns() - t0) / reps / 1e3
        torch.cuda.synchronize(device)
        return us

    plan = mips._binned_plan(v, q, bins, rows)
    ws, part_s, part_i, cells = mips._workspace(device, plan, b, bins)
    out_s, out_i = mips._outputs(b, k, torch.float32, device)
    stream = mips._current_stream(device)
    select = mips._entry("fused_mips_binned", "vod_fused_mips_binned_select")
    body_args = (mips._DTYPE_CODES[v.dtype], q.data_ptr(), v.data_ptr(), part_s, part_i, out_s.data_ptr(),
                 out_i.data_ptr(), cells, b, d, bins, rows, plan.splits, k, stream)
    return dict(
        label="9 CLI loop", splits=plan.splits,
        check_us=host_us(lambda: mips._check(v, q, k, bins, 1024, -1)),
        plan_us=host_us(lambda: mips._binned_plan(v, q, bins, rows)),
        outputs_us=host_us(lambda: mips._outputs(b, k, torch.float32, device)),
        workspace_us=host_us(lambda: mips._workspace(device, plan, b, bins)),
        stream_us=host_us(lambda: mips._current_stream(device)),
        stream_public_us=host_us(lambda: torch.cuda.current_stream(device).cuda_stream),
        entry_body_and_select_us=host_us(lambda: plan.entry(*body_args)),
        entry_select_us=host_us(lambda: select(0, part_s, part_i, out_s.data_ptr(), out_i.data_ptr(), cells, b,
                                               bins, plan.splits, k, stream)),
        wrapper_us=host_us(lambda: mips.fused_mips_binned(v, q, k=k, bins=bins)),
    )


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--parts", action="store_true", help="time each part of phase 9's call alone (the card only)")
    return ap


def main(argv: typ.Optional[list[str]] = None) -> list[dict]:
    args = parser().parse_args(argv)
    from vod_tpu_torch.examples.synthetic import device_of

    device = device_of(args.device)
    if args.parts and device.type != "cuda":
        raise SystemExit("--parts times the card's host path")
    rows = run(device, reps=args.reps)
    if args.parts:
        rows.append(parts(device))
    from vod_tpu_torch.examples.mips_kernel_bench import card_name

    for row in rows:
        print(json.dumps(row), flush=True)
    print(json.dumps({"card": card_name(device)}), flush=True)
    return rows


if __name__ == "__main__":
    main()
