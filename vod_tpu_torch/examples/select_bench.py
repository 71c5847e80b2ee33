"""Where the time of `select_kernel` goes, on one NVIDIA GPU.

    python -m vod_tpu_torch.examples.select_bench

`select_kernel` (`csrc/fused_mips_binned.cu`) runs after the binned body on
every CUDA call of `fused_mips_binned`: it folds the partial cells
`[splits, B, bins]` in split order and writes k of them in `lax.top_k`'s
order. Here it runs alone through `merge_select` on seeded partials at the
main paths' shapes (`SHAPES`), with three kinds of score:

  int8       int32 scores in [-2, 2] (ties everywhere), 5% sentinel cells;
  float      f32 `randn`, 10% -inf cells;
  clustered  f32 `0.5 + 1e-3 * randn`: every score shares its top 9 bits,
             as the inner products a body writes share theirs.

Each call is checked against `merge_select_reference` bit for bit. For
each shape and kind it measures, per call:

  device_ms        `torch.profiler` over 20 calls (device time);
  split1_ms        the same on the first split alone (the fold reads 1 plane);
  k1_ms, kbins_ms  the same at k = 1 and at k = bins;
  wall_ms          20 calls between CUDA events;
  topk_ms          `torch.topk(cells, k)` on the already-folded `[B, bins]`
                   cells, device time: the selection's yardstick (it does no
                   fold and promises no tie order);
  bound_ms         every partial score read once, the k winners' ids read
                   once, `[B, k]` scores and ids written once, over the
                   memory rate (`narrow_call_bench.HBM`).

`neg_zero` probes whether a body writes -0: a zero corpus against all
negative queries, through `fused_mips_binned` on the tensor-core body
(16-byte-aligned rows) and on the CUDA-core body (rows one element off the
grid), counting -0 among the `[B, k]` scores.

On the CPU (`--device cpu`) only `wall_ms` is measured, and it times the
plain version. Prints one JSON line per row and one with the card.
"""

from __future__ import annotations

import argparse
import json
import typing as typ

from vod_tpu_torch.examples.narrow_call_bench import HBM, _events_ms, device_profile

# (label, splits, B, bins, k): the CLI loop's call (33 splits x 32 queries x
# 512 bins), the serving call at 1M (16 x 64 x 1,024), the msmarco codec's
# coarse call (4 x 64 x 4,096) and phase 10's call (B = 4; its plan takes 33
# splits on an H100 SXM: `narrow_call_bench` reports them)
SHAPES = (
    ("9 CLI loop", 33, 32, 512, 100),
    ("4 serving", 16, 64, 1024, 40),
    ("16a codec coarse", 4, 64, 4096, 160),
    ("10 large CLI", 33, 4, 512, 100),
)
KINDS = ("int8", "float", "clustered")


def make_partials(kind: str, splits: int, b: int, bins: int, device, seed: int = 0):
    """Seeded partials `[splits, B, bins]` of one kind (module docstring), ids
    of split z above those of split z - 1, id -1 at empty cells."""
    import torch

    from vod_tpu_torch.ops.mips import _INT32_MIN

    g = torch.Generator(device="cpu").manual_seed(seed)
    shape = (splits, b, bins)
    ids = torch.arange(splits * b * bins, dtype=torch.int32).view(shape)
    empty = torch.zeros(shape, dtype=torch.bool)
    if kind == "int8":
        s = torch.randint(-2, 3, shape, generator=g, dtype=torch.int32)
        empty = torch.rand(shape, generator=g) < 0.05
        s = torch.where(empty, torch.tensor(_INT32_MIN, dtype=torch.int32), s)
    elif kind == "float":
        s = torch.randn(shape, generator=g)
        empty = torch.rand(shape, generator=g) < 0.1
        s = torch.where(empty, torch.tensor(float("-inf")), s)
    else:
        s = 0.5 + 1e-3 * torch.randn(shape, generator=g)
    return s.to(device), torch.where(empty, torch.tensor(-1, dtype=torch.int32), ids).to(device)


def _same(got, want) -> bool:
    import torch

    bits = (lambda x: x.contiguous().view(torch.int32)) if want[0].dtype == torch.float32 else (lambda x: x)
    return torch.equal(bits(got[0]), bits(want[0])) and torch.equal(got[1], want[1])


def run(device, *, shapes=SHAPES, kinds=KINDS, reps: int = 20, hbm: float = HBM) -> list[dict]:
    """Measure each shape and kind (module docstring); raises if the kernel
    differs from its plain version."""
    import torch

    from vod_tpu_torch.ops.mips import merge_select, merge_select_reference

    cuda = device.type == "cuda"
    out = []
    for label, splits, b, bins, k in shapes:
        for kind in kinds:
            part_s, part_i = make_partials(kind, splits, b, bins, device)
            int8 = kind == "int8"
            row = dict(label=label, kind=kind, splits=splits, B=b, bins=bins, k=k)
            variants = dict(device_ms=(part_s, part_i, k), split1_ms=(part_s[:1], part_i[:1], k),
                            k1_ms=(part_s, part_i, 1), kbins_ms=(part_s, part_i, bins))
            for name, (ps, pi, kk) in variants.items():
                if not _same(merge_select(ps, pi, kk), merge_select_reference(ps, pi, kk, int8)):
                    raise AssertionError(f"select {label} {kind} ({name}, k={kk}): kernel != plain")
                if cuda:
                    row[name] = device_profile(lambda: merge_select(ps, pi, kk), reps)[0]
            row["wall_ms"] = _events_ms(lambda: merge_select(part_s, part_i, k), reps, device)
            if cuda:
                cells = part_s[0].clone()  # the fold's scores, as the plain version folds them
                for z in range(1, splits):
                    cells = torch.where(part_s[z] > cells, part_s[z], cells)
                row["topk_ms"] = device_profile(lambda: torch.topk(cells, k, dim=-1), reps)[0]
            row["bound_ms"] = (splits * b * bins * 4 + b * k * 4 + b * k * 8) / hbm * 1e3
            out.append(row)
            del part_s, part_i
    return out


def neg_zero(device, *, rows: int = 1 << 14, d: int = 128, b: int = 8, bins: int = 512, k: int = 10) -> dict:
    """-0 among the `[B, k]` scores of each body on a zero corpus against all
    negative queries (module docstring)."""
    import torch

    from vod_tpu_torch.ops.mips import _binned_body, fused_mips_binned

    q = -torch.ones((b, d), dtype=torch.bfloat16, device=device)
    out = {}
    for shift in (0, 1):
        base = torch.zeros(rows * d + 8, dtype=torch.bfloat16, device=device)
        v = base[shift : shift + rows * d].view(rows, d)
        body = (_binned_body(v.dtype, d, bins, (v.data_ptr(), q.data_ptr())) if device.type == "cuda"
                else f"plain, offset {shift}")
        s, _ = fused_mips_binned(v, q, k=k, bins=bins)
        zero = s == 0
        out[body] = dict(cells=int(zero.sum()), neg_zero=int((zero & torch.signbit(s)).sum()))
    return out


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reps", type=int, default=20)
    return ap


def main(argv: typ.Optional[list[str]] = None) -> list[dict]:
    args = parser().parse_args(argv)
    from vod_tpu_torch.examples.mips_kernel_bench import card_name
    from vod_tpu_torch.examples.synthetic import device_of

    device = device_of(args.device)
    rows = run(device, reps=args.reps)
    rows.append(dict(neg_zero=neg_zero(device)))
    for row in rows:
        print(json.dumps(row), flush=True)
    print(json.dumps({"card": card_name(device)}), flush=True)
    return rows


if __name__ == "__main__":
    main()
