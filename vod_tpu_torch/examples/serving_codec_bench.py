"""8.8M-scale B=64 serving sweep of the coarse -> refine direct codec: the port of `examples/serving_codec_bench.py`.

    python -m vod_tpu_torch.examples.serving_codec_bench             # on the card: 8,841,823 rows
    python -m vod_tpu_torch.examples.serving_codec_bench --device cpu --n 16384 --train 4096 --reps 1 --blocks 2

The codec (the msmarco serving point): pca128 int8 coarse codes scanned for
the top `k_factor * k`, re-ranked exactly on pca256 int8 refine rows
(`PQIndex` with `codes=None`). The sweep, as the JAX script's: the coarse
stage as a chunked scan at `k_factor` 8, 16 and 32, and through
`fused_mips_binned` (the binned CUDA kernel on the int8 `wgmma` body) at
bins 2048 / 4096, tiles auto / 16384 and `k_factor` 16 / 32. The JAX
script's docstring also weighs IVF-PQ and the exhaustive pq4fs scan; its
code sweeps only this codec, and so does the port (those two live in
`ivfpq_crossover_bench` and `pq4_adc_variants_bench`).

`fused_tile` is the TPU kernel's VMEM tile. The port's kernel tiles its own
rows: the tile only clamps the bins, as on the TPU (`ops/mips.py`), and a
tile that does not divide the padded rows falls back to the default, as in
`search/dense.py:pq_search`. So the two `bins=2048, k_factor=16` rows differ
only by run-to-run noise.

Corpus: `synthetic.SlabCorpus` (8 slabs of
`ceil(ceil(n/8)/8192)*8192` rows,
seeds 1000 + i, basis seed 99; the port's own draws, not the JAX script's
`jax.random` ones). The projections and scales come from the first
`--train` rows of slab 0; the 64 eval queries are slab 0's first rows plus
0.1 rotated spectrum noise (numpy seed 0), with exact f32 ground truth from
the slabs made again.

Timing: `--blocks` distinct 64-query blocks (numpy seeds 200 + ...) run back
to back between two CUDA events; ms per block is the minimum over `--reps`
rounds (host clock on the CPU). The JAX script differenced 9-block against
1-block walls to cancel a relay's round trip; the card has none. Prints one
JSON line with the JAX script's keys plus `card`; `main` returns it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import typing as typ

import torch

from vod_tpu_torch.examples.mips_kernel_bench import card_name
from vod_tpu_torch.examples.synthetic import (
    MSMARCO_N,
    N_SLABS,
    SlabCorpus,
    block_ms,
    column_scale,
    device_of,
    make_queries,
    quantize_with,
    recall_at,
    slab_rows,
    sync,
)
from vod_tpu_torch.ops import pq as pq_ops
from vod_tpu_torch.search import SearchQueries
from vod_tpu_torch.search.dense import PQIndex, pq_search

K = 10
COARSE_DIM, REFINE_DIM = 128, 256
# (kernel, k_factor, fused_bins, fused_tile): the JAX script's sweep
VARIANTS = (
    ("scan", 8, 0, 0), ("scan", 16, 0, 0), ("scan", 32, 0, 0),
    ("fused", 16, 2048, 0), ("fused", 16, 2048, 16384),
    ("fused", 32, 2048, 16384), ("fused", 16, 4096, 16384),
    ("fused", 32, 4096, 16384),
)


def log(msg: str) -> None:
    print(f"# {msg}", file=sys.stderr, flush=True)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=MSMARCO_N)
    ap.add_argument("--b", type=int, default=64, help="serving block")
    ap.add_argument("--train", type=int, default=262_144)
    ap.add_argument("--n_eval", type=int, default=64)
    ap.add_argument("--blocks", type=int, default=9)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def build_direct_stores(corpus: SlabCorpus, train_rows: int) -> dict[str, torch.Tensor]:
    """The pca128 coarse and pca256 refine int8 stores with their
    projections and scales, trained on slab 0's first `train_rows` rows."""
    train = corpus.slab_of(0, train_rows)
    proj_c, _ = pq_ops.train_projection(train, COARSE_DIM)
    scale_c = column_scale(train @ proj_c)
    proj_r, _ = pq_ops.train_projection(train, REFINE_DIM)
    scale_r = column_scale(train @ proj_r)
    del train
    coarse, refine = corpus.fill((COARSE_DIM, torch.int8, lambda x: quantize_with(x, proj_c, scale_c)),
                                 (REFINE_DIM, torch.int8, lambda x: quantize_with(x, proj_r, scale_r)))
    return dict(coarse=coarse, proj_c=proj_c, scale_c=scale_c, refine=refine, proj_r=proj_r, scale_r=scale_r)


def direct_index(stores: dict[str, torch.Tensor], n: int, *, kernel: str = "scan", k_factor: int = 16,
                 fused_bins: int = 512, fused_tile: int = 0) -> PQIndex:
    """The serving codec: coarse int8 scan -> exact int8 re-rank, no PQ codes."""
    dev = stores["coarse"].device
    return PQIndex(
        codebooks=torch.zeros((1, 1, 1), device=dev), codes=None,
        coarse_codes=stores["coarse"], coarse_scale=stores["scale_c"], proj=stores["proj_c"],
        refine_codes=stores["refine"], refine_scale=stores["scale_r"], refine_proj=stores["proj_r"],
        n_real=n, k_factor=k_factor, approx_recall=0.95,
        kernel=kernel, fused_bins=fused_bins, fused_tile=fused_tile,
    )


def main(argv: typ.Optional[list[str]] = None) -> dict:
    args = parser().parse_args(argv)
    device = device_of(args.device)
    n, b = args.n, args.b
    corpus = SlabCorpus(n, slab_rows(n), N_SLABS, device)

    log(f"encoding {corpus.n_pad} rows into pca{COARSE_DIM} coarse + pca{REFINE_DIM} refine")
    t0 = time.perf_counter()
    stores = build_direct_stores(corpus, args.train)
    sync(device)
    build_s = time.perf_counter() - t0
    log(f"stores built in {build_s:.1f}s ({corpus.n_pad * (COARSE_DIM + REFINE_DIM) / 2**30:.2f} GiB)")

    q = corpus.queries(args.n_eval)
    gt = corpus.exact_topk(q, K)
    jq = torch.from_numpy(q).to(device)
    pools = [torch.from_numpy(make_queries(q, b, seed=200 + j)).to(device) for j in range(args.blocks)]

    results = []
    for kern, kf, bins, tile in VARIANTS:
        index = direct_index(stores, n, kernel=kern, k_factor=kf, fused_bins=bins or 512, fused_tile=tile)

        def search(v: torch.Tensor, index: PQIndex = index) -> torch.Tensor:
            return pq_search(index, SearchQueries(vector=v), K).indices

        rec = recall_at(search(jq), gt, K)
        ms = block_ms(search, pools, device, args.reps)
        qps = b / (ms / 1000)
        tag = kern + (f" bins={bins} tile={tile or 'auto'}" if kern == "fused" else "")
        log(f"direct pca{COARSE_DIM}+ref{REFINE_DIM} kf={kf} [{tag}]: recall@10={rec:.4f} {ms:.4f} ms/block = "
            f"{qps:,.0f} QPS")
        results.append({"codec": "direct", "kernel": kern, "k_factor": kf, "fused_bins": bins, "fused_tile": tile,
                        "recall": rec, "ms_block": ms, "qps": qps})

    out = {"n": n, "B": b, "coarse_dim": COARSE_DIM, "refine_dim": REFINE_DIM, "build_s": build_s,
           "results": results, "card": card_name(device)}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
