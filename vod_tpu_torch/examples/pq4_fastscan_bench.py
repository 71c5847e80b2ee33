"""4-bit fast-scan PQ at 8.8M, pq128x4 against pq64x8: the port of `examples/pq4_fastscan_bench.py`.

    python -m vod_tpu_torch.examples.pq4_fastscan_bench               # on the card: 8,841,823 rows
    python -m vod_tpu_torch.examples.pq4_fastscan_bench --device cpu --n 16384 --d 64 --train 4096 --chunks 4096 \
        --block 256 --blocks 2 --reps 1

At equal code bytes (pq64x8 and nibble-packed pq128x4: 64 bytes a row),
the variants, each a plain torch function here (the JAX script's
are defined inside its `main`):
  pq64x8-i8      8-bit codes, int8 codebook rows, int8 scan
  pq128x4-i8     4-bit codes, the same structure with 16-entry codebooks
  pq128x4-g8     4-bit codes decoded 8 subspaces at a time against a
                 block-diagonal codebook (the TPU's MXU-friendlier shape)
  pq128x4-lutmm  no decode: scores = int8 LUT [B, 2048] . one-hot(codes)
Reported per variant: ADC-only recall@10, the containment of the true top 10
in the ADC top `--pool` (what an exact refine keeps), and scan throughput.
The grouped decode selects the same int8 rows as `pq128x4-i8` (the block
diagonal's zeros select nothing), so their ids agree.

Corpus and timing as `pq_decode_variants_bench` (seeds 2000 + i, slabs
aligned to 16384 rows, codebooks from `train_pq` with generator seeds 0 and
1 on slab 0's first `--train` rows; the port's own draws). The script's
width must give 64 and 128 subquantizers (D % 128 == 0). Prints one JSON
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
from vod_tpu_torch.search.dense import _int8_codebooks, _int8_dot, _int8_queries, _scan_topk, decode_rows

K = 10
GROUP = 8  # subspaces per grouped decode


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=MSMARCO_N)
    ap.add_argument("--d", type=int, default=768)
    ap.add_argument("--train", type=int, default=262_144)
    ap.add_argument("--kmeans_iters", type=int, default=6)
    ap.add_argument("--n_eval", type=int, default=64)
    ap.add_argument("--pool", type=int, default=160)
    ap.add_argument("--chunks", type=str, default="32768,65536")
    add_timing_args(ap)
    return ap


def onehot_decode_scan(cb_i8: torch.Tensor, scale_vec: torch.Tensor, codes: torch.Tensor, q: torch.Tensor,
                       chunk: int, n_real: int, pool: int) -> torch.Tensor:
    """int8 codebook rows of the codes, an exact int8 scan: [B, pool] ids."""
    q_i8, q_row = _int8_queries(q, scale_vec)

    def score_chunk(start: int) -> torch.Tensor:
        return _int8_dot(q_i8, decode_rows(cb_i8, codes[start : start + chunk], dtype=torch.int8)) * q_row

    return _scan_topk(score_chunk, int(codes.shape[0]), n_real, int(q.shape[0]), pool, chunk, q.device)[1]


def block_diagonal(cb_i8: torch.Tensor, group: int = GROUP) -> torch.Tensor:
    """[M / g, g * n_codes, g * dsub] int8: group j's block diagonal of its g codebooks."""
    m, n_codes, dsub = cb_i8.shape
    out = torch.zeros((m // group, group * n_codes, group * dsub), dtype=torch.int8, device=cb_i8.device)
    for j in range(group):
        out[:, j * n_codes : (j + 1) * n_codes, j * dsub : (j + 1) * dsub] = cb_i8[j::group]
    return out


def grouped_decode_scan(cb_bd: torch.Tensor, scale_vec: torch.Tensor, codes: torch.Tensor, q: torch.Tensor,
                        chunk: int, n_real: int, pool: int) -> torch.Tensor:
    """4-bit codes decoded `g` subspaces per product: one-hot [c, M/g, g*16]
    against the block-diagonal codebooks, then the exact int8 scan."""
    n_grp, width, _ = cb_bd.shape
    q_i8, q_row = _int8_queries(q, scale_vec)
    iota = torch.arange(16, device=codes.device)

    def score_chunk(start: int) -> torch.Tensor:
        c = codes[start : start + chunk].long()
        oh = (c[:, :, None] == iota).to(torch.float32).reshape(-1, n_grp, width)
        dec = torch.einsum("cgk,gkd->cgd", oh, cb_bd.to(torch.float32)).reshape(int(c.shape[0]), -1)
        return _int8_dot(q_i8, dec.to(torch.int8)) * q_row

    return _scan_topk(score_chunk, int(codes.shape[0]), n_real, int(q.shape[0]), pool, chunk, q.device)[1]


def lut_matmul_scan(codebooks: torch.Tensor, codes: torch.Tensor, q: torch.Tensor, chunk: int, n_real: int,
                    pool: int) -> torch.Tensor:
    """No decode: the f32 ADC LUT row-quantized to int8, scores = LUT . one-hot."""
    m, n_codes, _ = codebooks.shape
    lut = pq_ops.adc_lut(codebooks, q).reshape(int(q.shape[0]), m * n_codes)
    l_row = torch.clamp(torch.amax(torch.abs(lut), dim=-1, keepdim=True), min=1e-8) / 127.0
    lut_i8 = torch.clamp(torch.round(lut / l_row), -127, 127).to(torch.int8)
    iota = torch.arange(n_codes, device=codes.device)

    def score_chunk(start: int) -> torch.Tensor:
        c = codes[start : start + chunk].long()
        oh = (c[:, :, None] == iota).to(torch.int8).reshape(int(c.shape[0]), m * n_codes)
        return _int8_dot(lut_i8, oh) * l_row

    return _scan_topk(score_chunk, int(codes.shape[0]), n_real, int(q.shape[0]), pool, chunk, q.device)[1]


def main(argv: typ.Optional[list[str]] = None) -> list[dict]:
    args = parser().parse_args(argv)
    device = device_of(args.device)
    n, pool = args.n, args.pool
    corpus = SlabCorpus(n, slab_rows(n, align=16384), N_SLABS, device, d=args.d, seed0=2000)
    train = corpus.slab_of(0, args.train)
    cb8 = pq_ops.train_pq(train, 64, n_iters=args.kmeans_iters, generator=torch.Generator(device=device).manual_seed(0))
    cb4 = pq_ops.train_pq(train, 128, n_codes=16, n_iters=args.kmeans_iters,
                          generator=torch.Generator(device=device).manual_seed(1))
    del train
    codes8, codes4 = corpus.fill((64, torch.uint8, lambda x: pq_ops.encode_pq(cb8, x)),
                                 (128, torch.uint8, lambda x: pq_ops.encode_pq(cb4, x)))
    cb8_i8, svec8 = _int8_codebooks(cb8)
    cb4_i8, svec4 = _int8_codebooks(cb4)
    cb_bd = block_diagonal(cb4_i8)
    q = corpus.queries(args.n_eval)
    gt = corpus.exact_topk(q, K)
    jq = torch.from_numpy(q).to(device)
    card = card_name(device)

    variants = {
        "pq64x8-i8": lambda v, c: onehot_decode_scan(cb8_i8, svec8, codes8, v, c, n, pool),
        "pq128x4-i8": lambda v, c: onehot_decode_scan(cb4_i8, svec4, codes4, v, c, n, pool),
        "pq128x4-g8": lambda v, c: grouped_decode_scan(cb_bd, svec4, codes4, v, c, n, pool),
        "pq128x4-lutmm": lambda v, c: lut_matmul_scan(cb4, codes4, v, c, n, pool),
    }
    out = []
    for chunk in [int(c) for c in args.chunks.split(",")]:
        for name, fn in variants.items():
            def search(v: torch.Tensor, fn=fn, chunk=chunk) -> torch.Tensor:
                return fn(v, chunk)

            got = search(jq)
            row = {"variant": name, "chunk": chunk, "n": n, "bytes_per_vec": 64,
                   "adc_recall10": recall_at(got[:, :K], gt, K), f"pool{pool}_containment": recall_at(got, gt, K),
                   "qps": throughput_qps(search, q, device, block=args.block, blocks=args.blocks, reps=args.reps),
                   "card": card}
            print(json.dumps(row), flush=True)
            out.append(row)
    return out


if __name__ == "__main__":
    main()
