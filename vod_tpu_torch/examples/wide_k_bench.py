"""The exact kernel's wide-k calls and the int8 CUDA-core body of the binned
kernel beside their yardsticks, on one NVIDIA GPU.

    python -m vod_tpu_torch.examples.wide_k_bench
    python -m vod_tpu_torch.examples.wide_k_bench --device cpu --n 4096 --d 48   # the plain path
    python -m vod_tpu_torch.examples.wide_k_bench --merge-only   # the split merge alone

`CASES` holds the exact bf16 calls on the tensor-core body ("wgmma") at
B = 64 and k = 10, 32, 64 and 128, at B = 1 and 2048 at k = 128 and at
B = 2048 at k = 10 (the product is the same at every k, so the differences
are the selection's), and the int8 binned calls that take the CUDA-core body
("fma"): rows 4 bytes off the 16-byte grid at 512 bins, B = 64 and 2048, and
D = 36 at B = 64. The inputs are the card script's phase 3 inputs
(`fma_bench.make_inputs`); D = 36 has its own, made the same way.

For each case it measures:

  ms, plain_ms,     as `fma_bench` measures them (its `run` times every
  library_ms,       case here); the int8 library call reads the aligned
  bound_ms, body,   copy of the rows 4 bytes off, and at D = 36 rows and
  launches,         queries zero-padded to D = 40 (cuBLASLt needs D % 8 ==
  max_abs_err       0; the padding adds zeros to every sum);
  device            exact calls: device ms by kernel from `torch.profiler`
                    over 5 calls (2 at B = 2048): `topk_wgmma_kernel`,
                    `merge_splits_kernel`;
  stages            exact calls: the tensor-core body's ring depth for the
                    call, from the library (`vod_fused_mips_topk_ring_stages`);
  merge             exact calls with more than one split: the split merge
                    (`merge_splits_kernel`) alone through `merge_splits`, on
                    the partial lists [splits, B, k] that the call's own body
                    wrote (`mips._exact_partials`: one launch of the call):
                    checked bit for bit against its plain version; device ms
                    from `torch.profiler` over `--reps` calls (`ms`); wall ms
                    between CUDA events; its plain version (a stable
                    descending sort of each query's splits x k pairs in split
                    order, the first k kept) and `torch.topk` of the same
                    pairs between CUDA events, the latter's device ms too;
                    and its bound (`merge_bound_bytes`): the bytes that any
                    merge of these sorted lists must move, over the memory
                    rate: for each query and split its scores down to the
                    first that does not win (at least its head), the
                    winners' ids, in whole 32-byte sectors, and [B, k]
                    written once.

With `--merge-only` it measures the merge alone, as above, on seeded lists
(`merge_lists`) at each shape of `MERGE_SHAPES`, and nothing else.

On the CPU (`--device cpu`) the wrappers run their plain versions: `ms` is a
CPU time of the plain path, and nothing else is timed. Prints one JSON line
per case and one with the card; `main` returns the rows.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import typing as typ

from vod_tpu_torch.examples import fma_bench
from vod_tpu_torch.examples.fma_bench import HBM

# (label, kernel, corpus, B, bins or k, body): corpus "int8_off" is the int8
# rows 4 bytes off the 16-byte grid, "int8_d36" int8 rows of D = 36
CASES = (
    ("exact bf16 B=64 k=10", "exact", "bf16", 64, 10, "wgmma"),
    ("exact bf16 B=64 k=32", "exact", "bf16", 64, 32, "wgmma"),
    ("exact bf16 B=64 k=64", "exact", "bf16", 64, 64, "wgmma"),
    ("exact bf16 B=64 k=128", "exact", "bf16", 64, 128, "wgmma"),
    ("exact bf16 B=1 k=128", "exact", "bf16", 1, 128, "wgmma"),
    ("exact bf16 B=2048 k=10", "exact", "bf16", 2048, 10, "wgmma"),
    ("exact bf16 B=2048 k=128", "exact", "bf16", 2048, 128, "wgmma"),
    ("binned int8 off-grid B=64 512 bins", "binned", "int8_off", 64, 512, "fma"),
    ("binned int8 off-grid B=2048 512 bins", "binned", "int8_off", 2048, 512, "fma"),
    ("binned int8 D=36 B=64 512 bins", "binned", "int8_d36", 64, 512, "fma"),
)
D_SMALL, D_PADDED = 36, 40
# (B, k, splits) of `--merge-only`: the exact cases' shapes (132 splits at
# B <= 64 and 4 at B = 2048 on the tensor-core body over 2^20 rows, 396 on
# the CUDA-core body) and one past shared memory (read in place)
MERGE_SHAPES = ((1, 10, 132), (1, 128, 132), (64, 1, 132), (64, 10, 132), (64, 64, 132), (64, 128, 132), (64, 128, 396),
                (2048, 10, 4), (2048, 64, 4), (2048, 128, 4), (64, 128, 500))


def int8_rows(n: int, d: int, device, seed: int):
    """Unit rows and 2,048 queries near rows as in `fma_bench.make_inputs`,
    quantized to int8."""
    import torch

    from vod_tpu_torch.ops.pq import quantize_int8
    from vod_tpu_torch.search.dense import quantize_queries_int8

    g = torch.Generator(device=device).manual_seed(seed)
    v32 = torch.randn((n, d), generator=g, device=device)
    v32 /= v32.norm(dim=-1, keepdim=True)
    src = torch.randint(0, n, (2048,), generator=g, device=device)
    q32 = v32[src] + 0.1 * torch.randn((2048, d), generator=g, device=device)
    q32 /= q32.norm(dim=-1, keepdim=True)
    vi8, scale = quantize_int8(v32, dim=0)
    qi8, _ = quantize_queries_int8(q32, scale)
    return vi8, qi8


def corpora(n: int, d: int, device) -> tuple[dict, dict]:
    """`fma_bench.make_inputs` with the int8 rows copied 4 bytes off the grid
    and int8 rows of D = 36 (seed 1) added, and the library's own copies of
    both (the aligned rows; the D = 36 ones zero-padded to D = 40)."""
    import torch

    inputs = fma_bench.make_inputs(n, d, device)
    vi8, qi8 = inputs["int8"]
    off = torch.empty(n * d + 4, dtype=torch.int8, device=device)[4:].view(n, d)
    off.copy_(vi8)
    v36, q36 = int8_rows(n, D_SMALL, device, seed=1)
    pad = lambda x: torch.nn.functional.pad(x, (0, D_PADDED - D_SMALL))  # noqa: E731
    inputs.update(int8_off=(off, qi8), int8_d36=(v36, q36))
    return inputs, dict(int8_off=(vi8, qi8), int8_d36=(pad(v36), pad(q36)))


def ring_stages(v, k: int, splits: int) -> int:
    """The exact tensor-core body's ring depth for a call over v's rows in
    `splits` splits on the current card, from the library."""
    from vod_tpu_torch.ops.cuda_build import load_library

    fn = load_library("fused_mips_topk").vod_fused_mips_topk_ring_stages
    fn.argtypes, fn.restype = [ctypes.c_int] * 4, ctypes.c_int
    return int(fn(int(v.shape[1]), k, int(v.shape[0]), splits))


def merge_lists(splits: int, b: int, k: int, device):
    """Seeded partial lists [splits, B, k] (scores, ids) in the exact kernel's
    contract: each sorted by score descending, ids rising along a list and
    from split to split."""
    import torch

    g = torch.Generator(device=device).manual_seed(splits + b + k)
    s = torch.randn((splits, b, k), generator=g, device=device).sort(dim=-1, descending=True).values
    z = torch.arange(splits, device=device, dtype=torch.int32).view(-1, 1, 1)
    return s.contiguous(), (z * k + torch.arange(k, device=device, dtype=torch.int32)).expand(splits, b, k).contiguous()


def merge_bound_bytes(part_s, k: int) -> int:
    """The bytes that any merge of these sorted lists [splits, B, k] must move:
    the 32-byte sectors that hold, for each query and split, its scores down
    to the first that does not win (the head where none wins), and those
    that hold the winners' ids (neighbouring lists share a sector); then the
    [B, k] scores and ids written."""
    import torch

    from vod_tpu_torch.ops.numpy_ops import topk_lowest_first

    splits, b, _ = (int(x) for x in part_s.shape)
    top, pos = topk_lowest_first(part_s.permute(1, 0, 2).reshape(b, splits * k), k)
    win = torch.zeros((b, splits * k), dtype=torch.bool, device=part_s.device)
    win.scatter_(1, pos, ~torch.isneginf(top))  # a -inf slot is no winner: its id is -1
    win = win.view(b, splits, k).permute(1, 0, 2)  # [splits, B, k], as the partials lie
    read = torch.arange(k, device=part_s.device) <= win.sum(-1, keepdim=True)

    def sectors(cells) -> int:  # the sectors of a partials array that hold a marked 4-byte cell
        return int(torch.unique(torch.nonzero(cells.reshape(-1)).squeeze(1) // 8).numel())

    return 32 * (sectors(read) + sectors(win)) + b * k * 8


def merge_yardsticks(part_s, part_i, k: int, reps: int, device, hbm: float = HBM) -> dict:
    """The split merge alone on partial lists [splits, B, k], beside its plain
    version and `torch.topk` of the same pairs; see the module docstring."""
    import torch

    from vod_tpu_torch.examples.narrow_call_bench import _events_ms, device_profile
    from vod_tpu_torch.ops import mips

    splits, b, _ = (int(x) for x in part_s.shape)
    got_s, got_i = mips.merge_splits(part_s, part_i, k)
    want_s, want_i = mips.merge_splits_reference(part_s, part_i, k)
    if not (torch.equal(got_s.view(torch.int32), want_s.view(torch.int32)) and torch.equal(got_i, want_i)):
        raise AssertionError(f"merge_splits_kernel != plain at B={b} k={k} splits={splits}")
    pairs = part_s.permute(1, 0, 2).reshape(b, splits * k)  # each query's pairs in split order
    merge = lambda: mips.merge_splits(part_s, part_i, k)  # noqa: E731
    library = lambda: torch.topk(pairs, k, dim=-1)  # noqa: E731
    return dict(splits=splits, ms=round(device_profile(merge, reps)[0], 5), wall_ms=_events_ms(merge, reps, device),
                plain_ms=_events_ms(lambda: mips.merge_splits_reference(part_s, part_i, k), reps, device),
                library_ms=_events_ms(library, reps, device),
                library_device_ms=round(device_profile(library, reps)[0], 5),
                bound_ms=merge_bound_bytes(part_s, k) / hbm * 1e3, bound_by="bytes",
                reads="each split's scores down to its first loser, the winners' ids (32-byte sectors)")


def merge_only(device, reps: int, hbm: float = HBM) -> list[dict]:
    """The merge alone at each shape of `MERGE_SHAPES`, on seeded lists."""
    return [dict(label=f"merge B={b} k={k} splits={splits}", B=b, k=k,
                 **merge_yardsticks(*merge_lists(splits, b, k, device), k, reps, device, hbm))
            for b, k, splits in MERGE_SHAPES]


def kernel_ms(by_name: dict, name: str) -> float:
    """Device ms a call of the kernels whose name holds `name`."""
    return round(sum(ms for key, ms in by_name.items() if name in key), 5)


def exact_extras(row: dict, v, q, call, reps: int, hbm: float = HBM) -> None:
    """An exact card row's device split, ring depth and merge yardsticks."""
    from vod_tpu_torch.examples.narrow_call_bench import device_profile
    from vod_tpu_torch.ops import mips

    if row["kernel"] != "exact":
        return
    b, k = row["B"], row["k"]
    device_ms, launches, by_name = device_profile(call, 5 if b <= 64 else 2)
    row["device"] = dict(total_ms=round(device_ms, 5), launches=launches,
                         topk_wgmma_kernel=kernel_ms(by_name, "topk_wgmma_kernel"),
                         merge_splits_kernel=kernel_ms(by_name, "merge_splits_kernel"))
    splits = mips._topk_plan(v, q.to(v.dtype), k, int(v.shape[0])).splits
    row["stages"] = ring_stages(v, k, splits)
    if splits > 1:
        row["merge"] = merge_yardsticks(*mips._exact_partials(v, q, k), k, reps, v.device, hbm)


def run(device, *, n: int = 1 << 20, d: int = 768, reps: int = 20, wide_reps: int = 3, cases=CASES,
        hbm: float = HBM) -> list[dict]:
    """Measure each case; see the module docstring."""
    inputs, library_inputs = corpora(n, d, device)
    return fma_bench.run(device, n=n, d=d, reps=reps, wide_reps=wide_reps, cases=cases, hbm=hbm,
                         inputs=inputs, library_inputs=library_inputs,
                         extra=lambda row, v, q, call, r: exact_extras(row, v, q, call, r, hbm))


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=1 << 20)
    ap.add_argument("--d", type=int, default=768)
    ap.add_argument("--reps", type=int, default=20, help="timed calls a case at B <= 64 (3 at B = 2048)")
    ap.add_argument("--merge-only", action="store_true", help="the split merge alone at MERGE_SHAPES (a card)")
    return ap


def main(argv: typ.Optional[list[str]] = None) -> list[dict]:
    args = parser().parse_args(argv)
    from vod_tpu_torch.examples.mips_kernel_bench import card_name
    from vod_tpu_torch.examples.synthetic import device_of

    device = device_of(args.device)
    if args.merge_only and device.type != "cuda":
        raise SystemExit("--merge-only times the merge kernel: it needs a CUDA device")
    rows = merge_only(device, args.reps) if args.merge_only else run(device, n=args.n, d=args.d, reps=args.reps)
    for row in rows:
        print(json.dumps(row), flush=True)
    print(json.dumps({"card": card_name(device)}), flush=True)
    return rows


if __name__ == "__main__":
    main()
