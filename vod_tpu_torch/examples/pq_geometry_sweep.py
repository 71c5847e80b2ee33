"""PQ geometry sweep at 8.8M (M against recall and QPS, with a refine): the port of `examples/pq_geometry_sweep.py`.

    python -m vod_tpu_torch.examples.pq_geometry_sweep                # on the card: 8,841,823 rows
    python -m vod_tpu_torch.examples.pq_geometry_sweep --device cpu --n 16384 --d 64 --m_list 8,16 \
        --refine_dim 32 --train 4096 --block 256 --blocks 2 --reps 1

Fewer, wider subquantizers decode more cheaply; with an exact refine fixing
the final order, the ADC stage needs only candidate recall over the
`k_factor * k` pool. Sweeps M x k_factor over one spectrum-matched corpus and
one shared PCA-`--refine_dim` int8 refine store: an exhaustive-ADC
`PQIndex` with the refine (`pq_search`), per (M, k_factor) its recall@10
against exact f32 search and its throughput.

Corpus: `synthetic.SlabCorpus` (8 slabs aligned to
8192 rows, seeds 2000 + i, basis seed 99), codebooks `train_pq` (generator seed 0) on slab 0's
first `--train` rows: the port's own draws. Throughput: `--blocks` distinct
`--block`-query blocks between CUDA events, the minimum over `--reps`
rounds (host clock on the CPU). Prints one JSON line per point, the JAX
script's keys plus `card`; `main` returns the list.
"""

from __future__ import annotations

import argparse
import json
import time
import typing as typ

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
    slab_rows,
    sync,
    throughput_qps,
)
from vod_tpu_torch.ops import pq as pq_ops
from vod_tpu_torch.search import SearchQueries
from vod_tpu_torch.search.dense import PQIndex, pq_search

K = 10


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=MSMARCO_N)
    ap.add_argument("--d", type=int, default=768)
    ap.add_argument("--m_list", type=str, default="16,24,32,64")
    ap.add_argument("--k_factors", type=str, default="16,32")
    ap.add_argument("--refine_dim", type=int, default=128)
    ap.add_argument("--train", type=int, default=262_144)
    ap.add_argument("--kmeans_iters", type=int, default=6)
    ap.add_argument("--n_eval", type=int, default=64)
    add_timing_args(ap)
    return ap


def exhaustive_refine_index(codebooks: torch.Tensor, codes: torch.Tensor, refine: dict[str, torch.Tensor], n: int,
                            k_factor: int) -> PQIndex:
    """Exhaustive ADC over `codes`, exact int8 re-rank on the PCA refine rows."""
    return PQIndex(codebooks=codebooks, codes=codes, refine_codes=refine["rows"], refine_scale=refine["scale"],
                   refine_proj=refine["proj"], n_real=n, k_factor=k_factor, approx_recall=0.95)


def main(argv: typ.Optional[list[str]] = None) -> list[dict]:
    args = parser().parse_args(argv)
    device = device_of(args.device)
    n, d, rdim = args.n, args.d, args.refine_dim
    corpus = SlabCorpus(n, slab_rows(n), N_SLABS, device, d=d, seed0=2000)
    train = corpus.slab_of(0, args.train)
    proj, _ = pq_ops.train_projection(train, rdim)
    scale = column_scale(train @ proj)
    (rows,) = corpus.fill((rdim, torch.int8, lambda x: quantize_with(x, proj, scale)))
    refine = dict(rows=rows, scale=scale, proj=proj)
    q = corpus.queries(args.n_eval)
    gt = corpus.exact_topk(q, K)
    jq = torch.from_numpy(q).to(device)
    card = card_name(device)

    out = []
    for m in [int(x) for x in args.m_list.split(",")]:
        t0 = time.perf_counter()
        codebooks = pq_ops.train_pq(train, m, n_iters=args.kmeans_iters,
                                    generator=torch.Generator(device=device).manual_seed(0))
        (codes,) = corpus.fill((m, torch.uint8, lambda x: pq_ops.encode_pq(codebooks, x)))
        sync(device)
        build_s = time.perf_counter() - t0
        for kf in [int(x) for x in args.k_factors.split(",")]:
            index = exhaustive_refine_index(codebooks, codes, refine, n, kf)

            def search(v: torch.Tensor, index: PQIndex = index) -> torch.Tensor:
                return pq_search(index, SearchQueries(vector=v), K).indices

            row = {"codec": f"pq{m}+pca{rdim}:exh+ref", "dsub": d // m, "n": n, "bytes_per_vec": m + rdim,
                   "k_factor": kf, "recall10": recall_at(search(jq), gt, K),
                   "qps": throughput_qps(search, q, device, block=args.block, blocks=args.blocks, reps=args.reps),
                   "build_s": build_s, "card": card}
            print(json.dumps(row), flush=True)
            out.append(row)
        del codes
    return out


if __name__ == "__main__":
    main()
