"""Exhaustive-ADC decode variants at 8.8M: the port of `examples/pq_decode_variants_bench.py`.

    python -m vod_tpu_torch.examples.pq_decode_variants_bench          # on the card: 8,841,823 rows, pq64
    python -m vod_tpu_torch.examples.pq_decode_variants_bench --device cpu --n 16384 --d 64 --m 16 --train 4096 \
        --chunks 4096 --block 256 --blocks 2 --reps 1

The decode of the PQ codes dominates the exhaustive-ADC scan. The variants,
each a plain torch function here (the JAX script's are defined inside its
`main`), score the same codes against the same exact f32 ground truth:
  bf16-oh           codebook rows in bf16 (JAX: a one-hot bf16 product), bf16 scan
  i8-oh/bf16-scan   int8-quantized codebook rows, cast to bf16, scale folded into q
  i8-oh/i8-scan     int8 codebook rows, row-quantized int8 queries, exact int sums
A one-hot product only selects codebook rows; the port selects them by a
gather (`search/dense.py:decode_rows`), the same values. Each variant keeps
the top 10 of every row chunk of `--chunks` rows (`_scan_topk`, exact).

Corpus: `synthetic.SlabCorpus` (8 slabs of
`ceil(ceil(n/8)/16384)*16384`
rows, seeds 2000 + i, basis seed 99), codebooks from `train_pq` on slab 0's
first `--train` rows (generator seed 0): the port's own draws, not the JAX
script's. Recall@10 against exact f32 search of the 64 eval queries.
Throughput: `--blocks` distinct `--block`-query blocks between CUDA events,
the minimum over `--reps` rounds (host clock on the CPU). Prints one JSON
line per (chunk, variant), the JAX script's keys plus `card`; `main` returns
the list.
"""

from __future__ import annotations

import argparse
import json
import typing as typ

import torch

from vod_tpu_torch.examples.mips_kernel_bench import card_name
from vod_tpu_torch.examples.synthetic import (
    MSMARCO_N,
    N_SLABS,
    SlabCorpus,
    add_timing_args,
    device_of,
    recall_at,
    slab_rows,
    throughput_qps,
)
from vod_tpu_torch.ops import pq as pq_ops
from vod_tpu_torch.search.dense import _int8_adc_scan_inputs, _int8_codebooks, _int8_dot, _scan_topk, decode_rows

K = 10


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=MSMARCO_N)
    ap.add_argument("--d", type=int, default=768)
    ap.add_argument("--m", type=int, default=64)
    ap.add_argument("--train", type=int, default=262_144)
    ap.add_argument("--kmeans_iters", type=int, default=6)
    ap.add_argument("--n_eval", type=int, default=64)
    ap.add_argument("--chunks", type=str, default="8192,16384")
    add_timing_args(ap)
    return ap


def bf16_oh(codebooks: torch.Tensor, codes: torch.Tensor, q: torch.Tensor, chunk: int, n_real: int) -> torch.Tensor:
    """bf16 codebook rows, bf16 queries, f32 sums: [B, 10] ids."""
    q_mm = q.to(torch.bfloat16).to(torch.float32)

    def score_chunk(start: int) -> torch.Tensor:
        dec = decode_rows(codebooks, codes[start : start + chunk], dtype=torch.bfloat16)
        return q_mm @ dec.to(torch.float32).T

    return _scan_topk(score_chunk, int(codes.shape[0]), n_real, int(q.shape[0]), K, chunk, q.device)[1]


def i8_oh_bf16_scan(codebooks: torch.Tensor, codes: torch.Tensor, q: torch.Tensor, chunk: int,
                    n_real: int) -> torch.Tensor:
    """int8 codebook rows as bf16, the codebook scale folded into bf16 queries."""
    cb_i8, scale_vec = _int8_codebooks(codebooks)
    q_mm = (q.to(torch.float32) * scale_vec).to(torch.bfloat16).to(torch.float32)

    def score_chunk(start: int) -> torch.Tensor:
        return q_mm @ decode_rows(cb_i8, codes[start : start + chunk], dtype=torch.float32).T

    return _scan_topk(score_chunk, int(codes.shape[0]), n_real, int(q.shape[0]), K, chunk, q.device)[1]


def i8_oh_i8_scan(codebooks: torch.Tensor, codes: torch.Tensor, q: torch.Tensor, chunk: int,
                  n_real: int) -> torch.Tensor:
    """int8 codebook rows, row-quantized int8 queries, exact integer sums."""
    cb_i8, q_i8, q_row = _int8_adc_scan_inputs(codebooks, q)

    def score_chunk(start: int) -> torch.Tensor:
        return _int8_dot(q_i8, decode_rows(cb_i8, codes[start : start + chunk], dtype=torch.int8)) * q_row

    return _scan_topk(score_chunk, int(codes.shape[0]), n_real, int(q.shape[0]), K, chunk, q.device)[1]


VARIANTS = {"bf16-oh": bf16_oh, "i8-oh/bf16-scan": i8_oh_bf16_scan, "i8-oh/i8-scan": i8_oh_i8_scan}


def main(argv: typ.Optional[list[str]] = None) -> list[dict]:
    args = parser().parse_args(argv)
    device = device_of(args.device)
    n, m = args.n, args.m
    corpus = SlabCorpus(n, slab_rows(n, align=16384), N_SLABS, device, d=args.d, seed0=2000)
    train = corpus.slab_of(0, args.train)
    codebooks = pq_ops.train_pq(train, m, n_iters=args.kmeans_iters,
                                generator=torch.Generator(device=device).manual_seed(0))
    del train
    (codes,) = corpus.fill((m, torch.uint8, lambda x: pq_ops.encode_pq(codebooks, x)))
    q = corpus.queries(args.n_eval)
    gt = corpus.exact_topk(q, K)
    jq = torch.from_numpy(q).to(device)
    card = card_name(device)

    out = []
    for chunk in [int(c) for c in args.chunks.split(",")]:
        for name, fn in VARIANTS.items():
            def search(v: torch.Tensor, fn=fn, chunk=chunk) -> torch.Tensor:
                return fn(codebooks, codes, v, chunk, n)

            row = {"variant": name, "chunk": chunk, "n": n, "recall10": recall_at(search(jq), gt, K),
                   "qps": throughput_qps(search, q, device, block=args.block, blocks=args.blocks, reps=args.reps),
                   "card": card}
            print(json.dumps(row), flush=True)
            out.append(row)
    return out


if __name__ == "__main__":
    main()
