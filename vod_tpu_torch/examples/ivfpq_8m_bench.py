"""IVF serving path at 8.8M, the small-batch answer to pq4fs: the port of `examples/ivfpq_8m_bench.py`.

    python -m vod_tpu_torch.examples.ivfpq_8m_bench                   # on the card: 8,841,823 rows, 4096 cells
    python -m vod_tpu_torch.examples.ivfpq_8m_bench --device cpu --n 16384 --d 64 --c 64 --window 64 \
        --refine_dim 32 --train 4096 --nprobes 4,8 --block 256 --blocks 2 --reps 1

`IVFPQIndex` in its production form: refine rows as the scoring store (IVF +
PCA-`--refine_dim` int8 rows, no PQ codes), `--c` k-means cells laid out in
windows of `--window` rows (`build_ivfpq_from_device_parts`), with `--spill`
adding SOAR secondary assignments (`assign_soar`: twice the rows, the same
refine row under both cells). Per nprobe: the window budget (1.5 x the mean
windows a cell, times nprobe), recall@10 against exact f32 search, the
serving ms per 64-query block and the throughput over `--block`-query blocks.

Corpus: `synthetic.SlabCorpus` (8 slabs aligned to
16384 rows, seeds 2000 + i, basis seed 99); the projection and k-means (generator seed 7) from slab
0's first `--train` rows: the port's own draws. Timing: distinct query
blocks between CUDA events, the minimum over `--reps` rounds (host clock on
the CPU); the JAX script differenced walls to cancel a relay's round trip.
Prints one JSON line per nprobe, the JAX script's keys plus `card`; `main`
returns the list.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import typing as typ

import numpy as np
import torch

from vod_tpu_torch.examples.mips_kernel_bench import card_name
from vod_tpu_torch.examples.synthetic import (
    MSMARCO_N,
    N_SLABS,
    SlabCorpus,
    add_timing_args,
    column_scale,
    device_of,
    quantize_with,
    recall_at,
    serving_ms,
    slab_rows,
    sync,
    throughput_qps,
)
from vod_tpu_torch.ops import pq as pq_ops
from vod_tpu_torch.ops.kmeans import _assign_chunked, kmeans
from vod_tpu_torch.search import SearchQueries
from vod_tpu_torch.search.ivfpq import IVFPQIndex, assign_soar, build_ivfpq_from_device_parts, ivfpq_search

K = 10


def log(msg: str) -> None:
    print(f"# {msg}", file=sys.stderr, flush=True)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=MSMARCO_N)
    ap.add_argument("--d", type=int, default=768)
    ap.add_argument("--c", type=int, default=4096)
    ap.add_argument("--window", type=int, default=512)
    ap.add_argument("--refine_dim", type=int, default=128)
    ap.add_argument("--train", type=int, default=262_144)
    ap.add_argument("--kmeans_iters", type=int, default=8)
    ap.add_argument("--n_eval", type=int, default=64)
    ap.add_argument("--nprobes", type=str, default="16,32,64,128")
    ap.add_argument("--spill", action="store_true", help="SOAR secondary assignments (2x rows)")
    ap.add_argument("--soar_lambda", type=float, default=1.0)
    add_timing_args(ap)
    return ap


def window_budget(index: IVFPQIndex, nprobe: int) -> int:
    """The JAX script's window cap: nprobe x ceil(1.5 x mean windows a cell),
    at most every window."""
    wc = index.win_count.cpu().numpy()
    mean_w = float(wc[wc > 0].mean())
    return int(min(wc.sum(), nprobe * max(1, int(np.ceil(1.5 * mean_w)))))


def main(argv: typ.Optional[list[str]] = None) -> list[dict]:
    args = parser().parse_args(argv)
    device = device_of(args.device)
    n, d = args.n, args.d
    corpus = SlabCorpus(n, slab_rows(n, align=16384), N_SLABS, device, d=d, seed0=2000)
    card = card_name(device)

    t0 = time.perf_counter()
    train = corpus.slab_of(0, args.train)
    proj, _ = pq_ops.train_projection(train, args.refine_dim)
    scale = column_scale(train @ proj)
    centroids, _ = kmeans(train, args.c, args.kmeans_iters, generator=torch.Generator(device=device).manual_seed(7))
    del train
    log(f"trained pca{args.refine_dim} + kmeans{args.c} in {time.perf_counter() - t0:.1f}s")

    def assign(x: torch.Tensor) -> torch.Tensor:
        a = _assign_chunked(x, centroids, chunk=16384)
        if args.spill:
            return torch.stack([a, assign_soar(x, centroids, a, soar_lambda=args.soar_lambda, chunk=4096)], -1)
        return a[:, None]

    t0 = time.perf_counter()
    rows, cells = corpus.fill((args.refine_dim, torch.int8, lambda x: quantize_with(x, proj, scale)),
                              (2 if args.spill else 1, torch.int32, assign))
    cells = cells[:n].cpu().numpy()
    refine = rows[:n]
    row_ids = None
    if args.spill:  # SOAR: the same rerank rows under the secondary cells
        refine = torch.cat([refine, refine])
        row_ids = np.tile(np.arange(n, dtype=np.int32), 2)
    assign_all = cells.T.reshape(-1)
    del rows
    index = build_ivfpq_from_device_parts(
        centroids, torch.zeros((1, 1, d), device=device), assign_all, None, refine_dev=refine, refine_scale=scale,
        refine_proj=proj, window=args.window, nprobe=32, row_ids_np=row_ids, n_real=n, spilled=args.spill,
    )
    del refine
    sync(device)
    total = int(index.row_ids.shape[0])
    log(f"layout built in {time.perf_counter() - t0:.1f}s: {total} slots ({100 * (total - n) / n:.1f}% padding), "
        f"{total * (args.refine_dim + 4) / 2**30:.2f} GiB")

    q = corpus.queries(args.n_eval)
    gt = corpus.exact_topk(q, K)
    jq = torch.from_numpy(q).to(device)
    out = []
    for nprobe in [int(p) for p in args.nprobes.split(",")]:
        mw = window_budget(index, nprobe)
        ix = index.replace(nprobe=nprobe, max_windows=mw)

        def search(v: torch.Tensor, ix: IVFPQIndex = ix) -> torch.Tensor:
            return ivfpq_search(ix, SearchQueries(vector=v), K).indices

        ms = serving_ms(search, q, device, b=64, blocks=args.blocks, reps=args.reps, seed0=10)
        row = {"nprobe": nprobe, "max_windows": mw, "scan_frac": mw * args.window / n,
               "recall10": recall_at(search(jq), gt, K), "serving_ms_per_64": ms, "serving_qps": 64 / (ms / 1000),
               "throughput_qps": throughput_qps(search, q, device, block=args.block, blocks=args.blocks,
                                                reps=args.reps),
               "card": card}
        print(json.dumps(row), flush=True)
        out.append(row)
    return out


if __name__ == "__main__":
    main()
