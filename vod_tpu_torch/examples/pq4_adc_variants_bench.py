"""4-bit exhaustive-ADC formulations at 8.8M (pq128x4fs geometry): the port of `examples/pq4_adc_variants_bench.py`.

    python -m vod_tpu_torch.examples.pq4_adc_variants_bench           # on the card: 8,841,823 rows
    python -m vod_tpu_torch.examples.pq4_adc_variants_bench --device cpu --n 16384 --d 128 --train 4096 \
        --chunk 4096 --pool 40 --block 256 --big 512 --blocks 2 --reps 1

Three near-identical ways to score q against nibble-packed PQ4 codes (M =
`--m` subquantizers of 16 entries; the flat one-hot width is M * 16), each a
plain torch function here (the JAX script's are defined inside its `main`):
  prod       per-subspace int8 codebook rows of the codes, int8 scan (production)
  blockdiag  one-hot [chunk, M*16] . blockdiag(cb) [M*16, D], then the int8
             scan; the same rows as `prod` (the zeros select nothing)
  direct     scores = one-hot [chunk, M*16] . int8 LUT [M*16, B], no decode
Each collects a `--pool` candidate pool (`_scan_collect_topk`, the shares the
JAX version keeps); pool recall@10 is the share of the true top 10 in it.

Modes, as the JAX script's: serving (B = 64 blocks: ms per block), throughput
over `--blocks` blocks of `--block` queries, and one `--big`-query pass at
chunk 16384 (decode variants only). The JAX script differenced 9- against
1-block walls to cancel a relay's round trip; here every block runs between
CUDA events (host clock on the CPU), the minimum over `--reps` rounds. The
JAX script's docstring records TPU v5e timings; none of them is the port's.

Corpus as `pq_decode_variants_bench` (seeds 2000 + i, slabs aligned to 16384
rows, codebooks `train_pq(..., n_codes=16)` with generator seed 0; the
port's own draws). Prints one JSON line per (variant, mode), the JAX
script's keys plus `card`; `main` returns the list.
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
    make_queries,
    recall_at,
    serving_ms,
    slab_rows,
    throughput_qps,
)
from vod_tpu_torch.ops import pq as pq_ops
from vod_tpu_torch.search.dense import (
    _int8_codebooks, _int8_dot, _int8_queries, _pack_codes4, _scan_collect_topk, _unpack_codes4, decode_rows,
)

K = 10
SERVING_B = 64


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=MSMARCO_N)
    ap.add_argument("--d", type=int, default=768)
    ap.add_argument("--m", type=int, default=128)
    ap.add_argument("--train", type=int, default=262_144)
    ap.add_argument("--n_eval", type=int, default=64)
    ap.add_argument("--pool", type=int, default=320)  # k_factor 32 * k 10
    ap.add_argument("--chunk", type=int, default=65536)
    ap.add_argument("--big", type=int, default=8192, help="queries of the one-pass throughput mode")
    add_timing_args(ap)
    return ap


def flat_block_diagonal(cb_i8: torch.Tensor) -> torch.Tensor:
    """[M * n_codes, D] int8: row m * n_codes + j holds cb_i8[m, j] in subspace m's columns."""
    m, n_codes, dsub = cb_i8.shape
    out = torch.zeros((m * n_codes, m * dsub), dtype=torch.int8, device=cb_i8.device)
    for mm in range(m):
        out[mm * n_codes : (mm + 1) * n_codes, mm * dsub : (mm + 1) * dsub] = cb_i8[mm]
    return out


def _collect(score_chunk, codes: torch.Tensor, n_real: int, b: int, pool: int, chunk: int) -> torch.Tensor:
    return _scan_collect_topk(score_chunk, int(codes.shape[0]), n_real, b, pool, chunk, codes.device,
                              approx_recall=0.95)[1]


def prod(cb_i8: torch.Tensor, scale_vec: torch.Tensor, codes: torch.Tensor, q: torch.Tensor, chunk: int,
         n_real: int, pool: int) -> torch.Tensor:
    q_i8, q_row = _int8_queries(q, scale_vec)

    def score_chunk(start: int) -> torch.Tensor:
        c = _unpack_codes4(codes[start : start + chunk])
        return _int8_dot(q_i8, decode_rows(cb_i8, c, dtype=torch.int8)) * q_row

    return _collect(score_chunk, codes, n_real, int(q.shape[0]), pool, chunk)


def blockdiag(cb_bd: torch.Tensor, scale_vec: torch.Tensor, codes: torch.Tensor, q: torch.Tensor, chunk: int,
              n_real: int, pool: int) -> torch.Tensor:
    q_i8, q_row = _int8_queries(q, scale_vec)
    iota = torch.arange(16, device=codes.device)
    bd = cb_bd.to(torch.float32)

    def score_chunk(start: int) -> torch.Tensor:
        c = _unpack_codes4(codes[start : start + chunk]).long()
        oh = (c[:, :, None] == iota).to(torch.float32).reshape(int(c.shape[0]), -1)
        return _int8_dot(q_i8, (oh @ bd).to(torch.int8)) * q_row

    return _collect(score_chunk, codes, n_real, int(q.shape[0]), pool, chunk)


def direct(codebooks: torch.Tensor, codes: torch.Tensor, q: torch.Tensor, chunk: int, n_real: int,
           pool: int) -> torch.Tensor:
    m, n_codes, _ = codebooks.shape
    lut = pq_ops.adc_lut(codebooks, q).reshape(int(q.shape[0]), m * n_codes)
    l_row = torch.clamp(torch.amax(torch.abs(lut), dim=-1, keepdim=True), min=1e-8) / 127.0
    lut_i8 = torch.clamp(torch.round(lut / l_row), -127, 127).to(torch.int8)
    iota = torch.arange(n_codes, device=codes.device)

    def score_chunk(start: int) -> torch.Tensor:
        c = _unpack_codes4(codes[start : start + chunk]).long()
        oh = (c[:, :, None] == iota).to(torch.int8).reshape(int(c.shape[0]), m * n_codes)
        return _int8_dot(lut_i8, oh) * l_row

    return _collect(score_chunk, codes, n_real, int(q.shape[0]), pool, chunk)


def main(argv: typ.Optional[list[str]] = None) -> list[dict]:
    args = parser().parse_args(argv)
    device = device_of(args.device)
    n, m, pool = args.n, args.m, args.pool
    corpus = SlabCorpus(n, slab_rows(n, align=16384), N_SLABS, device, d=args.d, seed0=2000)
    train = corpus.slab_of(0, args.train)
    codebooks = pq_ops.train_pq(train, m, n_codes=16, n_iters=6,
                                generator=torch.Generator(device=device).manual_seed(0))
    del train
    (codes,) = corpus.fill((m // 2, torch.uint8, lambda x: _pack_codes4(pq_ops.encode_pq(codebooks, x))))
    cb_i8, scale_vec = _int8_codebooks(codebooks)
    cb_bd = flat_block_diagonal(cb_i8)
    q = corpus.queries(args.n_eval)
    gt = corpus.exact_topk(q, K)
    card = card_name(device)

    variants = {
        "prod": lambda v, c: prod(cb_i8, scale_vec, codes, v, c, n, pool),
        "blockdiag": lambda v, c: blockdiag(cb_bd, scale_vec, codes, v, c, n, pool),
        "direct": lambda v, c: direct(codebooks, codes, v, c, n, pool),
    }
    out = []

    def emit(row: dict) -> None:
        row["card"] = card
        print(json.dumps(row), flush=True)
        out.append(row)

    # serving: B = 64 blocks; the pool recall of the first block's queries
    first = torch.from_numpy(make_queries(q, SERVING_B, seed=0)).to(device)
    for name, fn in variants.items():
        def search(v: torch.Tensor, fn=fn) -> torch.Tensor:
            return fn(v, args.chunk)

        recall = recall_at(search(first)[: args.n_eval], gt, K)
        ms = serving_ms(search, q, device, b=SERVING_B, blocks=args.blocks, reps=args.reps, seed0=10)
        emit({"variant": name, "mode": f"serving B={SERVING_B}", "chunk": args.chunk, "pool_recall10": recall,
              "ms_per_block": ms, "qps": SERVING_B / (ms / 1000)})

    # throughput: --blocks blocks of --block queries
    for name, fn in variants.items():
        def search(v: torch.Tensor, fn=fn) -> torch.Tensor:
            return fn(v, args.chunk)

        qps = throughput_qps(search, q, device, block=args.block, blocks=args.blocks, reps=args.reps)
        emit({"variant": name, "mode": f"throughput {args.blocks}x{args.block}", "chunk": args.chunk, "qps": qps})

    # throughput with the decode amortized: one --big-query pass at chunk 16384
    chunk_b = min(16384, corpus.n_pad)
    for name, fn in variants.items():
        if name == "direct":
            continue

        def search(v: torch.Tensor, fn=fn) -> torch.Tensor:
            return fn(v, chunk_b)

        qps = throughput_qps(search, q, device, block=args.big, blocks=1, reps=args.reps, seed0=200)
        emit({"variant": name, "mode": f"throughput 1x{args.big}", "chunk": chunk_b, "qps": qps})
    return out


if __name__ == "__main__":
    main()
