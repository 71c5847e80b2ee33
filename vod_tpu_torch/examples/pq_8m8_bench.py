"""8.8M-scale PQ + truncated-PCA refine (BASELINE config #4): the port of `examples/pq_8m8_bench.py`.

    python -m vod_tpu_torch.examples.pq_8m8_bench                     # on the card: 8,841,823 rows, pq64 + pca128
    python -m vod_tpu_torch.examples.pq_8m8_bench --device cpu --n 16384 --d 64 --m 16 --refine_dim 32 \
        --train 4096 --block 256 --blocks 2 --reps 1

The corpus never exists in f32: slabs are made on the device and encoded to
PQ codes (`--code_bits` 8, or 4 for nibble-packed fast-scan codes) and
PCA-`--refine_dim` int8 refine rows. Reported, each against exact f32
search of the 64 eval queries, with its throughput:
  * (8-bit codes) the one-hot prototype: codebook rows in bf16, bf16 scan;
  * (8-bit codes) the dual estimator at w_adc 0.3 and 0.5: one scan over
    both stores, score = w * ADC + (1 - w) * PCA int8 estimate;
  * `pq_search` over `PQIndex`es: exhaustive ADC ("exh"), with the refine
    at k_factor 8 ("exh+ref8") and at `--k_factor` ("exh+ref");
  * an int8 flat comparator on the same corpus (fixed per-dim scale
    5 / sqrt(D) / 127, `dense_search`).
The prototypes are plain torch functions here (the JAX script's are defined
inside its `main`); the one-hot product of the JAX script selects codebook
rows, which the port gathers (`decode_rows`).

Corpus: `synthetic.SlabCorpus` (8 slabs aligned to
8192 rows, seeds 2000 + i, basis seed 99), codebooks `train_pq` (generator seed 0): the port's own
draws. Throughput as `pq_geometry_sweep`. Prints one JSON line per codec,
the JAX script's keys plus `card`; `main` returns the list.
"""

from __future__ import annotations

import argparse
import functools
import json
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
    slab_rows,
    sync,
    throughput_qps,
)
from vod_tpu_torch.ops import pq as pq_ops
from vod_tpu_torch.search import SearchQueries
from vod_tpu_torch.search.dense import (
    DenseIndex, PQIndex, _pack_codes4, _scan_topk, decode_rows, dense_search, pq_search,
)

K = 10


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=MSMARCO_N)
    ap.add_argument("--d", type=int, default=768)
    ap.add_argument("--m", type=int, default=64, help="PQ subquantizers")
    ap.add_argument("--code_bits", type=int, default=8, choices=(8, 4),
                    help="4 = fast-scan PQ{M}x4 (nibble-packed codes, 16-entry codebooks)")
    ap.add_argument("--refine_dim", type=int, default=128)
    ap.add_argument("--k_factor", type=int, default=16)
    ap.add_argument("--train", type=int, default=262_144)
    ap.add_argument("--kmeans_iters", type=int, default=6)
    ap.add_argument("--n_eval", type=int, default=64)
    add_timing_args(ap)
    return ap


def exh_onehot_indices(codebooks: torch.Tensor, codes: torch.Tensor, q: torch.Tensor, n_real: int,
                       chunk: int = 8192) -> torch.Tensor:
    """Exhaustive ADC with the codebook rows in bf16 and a bf16 scan: [B, 10] ids."""
    q_mm = q.to(torch.bfloat16).to(torch.float32)
    chunk = min(chunk, int(codes.shape[0]))

    def score_chunk(start: int) -> torch.Tensor:
        dec = decode_rows(codebooks, codes[start : start + chunk], dtype=torch.bfloat16)
        return q_mm @ dec.to(torch.float32).T

    return _scan_topk(score_chunk, int(codes.shape[0]), n_real, int(q.shape[0]), K, chunk, q.device)[1]


def dual_search_indices(codebooks: torch.Tensor, codes: torch.Tensor, refine: dict[str, torch.Tensor],
                        q: torch.Tensor, n_real: int, w_adc: float = 0.5, chunk: int = 65536) -> torch.Tensor:
    """One scan over both stores: w * (bf16 ADC) + (1 - w) * (PCA int8 estimate)."""
    q_eff = q.to(torch.float32)
    q_mm = q_eff.to(torch.bfloat16).to(torch.float32)
    q_pca = (q_eff @ refine["proj"]) * refine["scale"]  # [B, rdim]
    chunk = min(chunk, int(codes.shape[0]))

    def score_chunk(start: int) -> torch.Tensor:
        dec = decode_rows(codebooks, codes[start : start + chunk], dtype=torch.bfloat16)
        s_adc = q_mm @ dec.to(torch.float32).T
        s_pca = q_pca @ refine["rows"][start : start + chunk].to(torch.float32).T
        return w_adc * s_adc + (1.0 - w_adc) * s_pca

    return _scan_topk(score_chunk, int(codes.shape[0]), n_real, int(q.shape[0]), K, chunk, q.device)[1]


def main(argv: typ.Optional[list[str]] = None) -> list[dict]:
    args = parser().parse_args(argv)
    device = device_of(args.device)
    n, d, m, rdim = args.n, args.d, args.m, args.refine_dim
    cb_bytes = m // 2 if args.code_bits == 4 else m
    corpus = SlabCorpus(n, slab_rows(n), N_SLABS, device, d=d, seed0=2000)
    card = card_name(device)

    train = corpus.slab_of(0, args.train)
    codebooks = pq_ops.train_pq(train, m, n_codes=1 << args.code_bits, n_iters=args.kmeans_iters,
                                generator=torch.Generator(device=device).manual_seed(0))
    proj, _ = pq_ops.train_projection(train, rdim)
    scale = column_scale(train @ proj)
    del train

    def encode_codes(x: torch.Tensor) -> torch.Tensor:
        c = pq_ops.encode_pq(codebooks, x)
        return _pack_codes4(c) if args.code_bits == 4 else c

    t0 = time.perf_counter()
    codes, rows = corpus.fill((cb_bytes, torch.uint8, encode_codes),
                              (rdim, torch.int8, lambda x: quantize_with(x, proj, scale)))
    sync(device)
    build_s = time.perf_counter() - t0
    refine = dict(rows=rows, scale=scale, proj=proj)
    q = corpus.queries(args.n_eval)
    gt = corpus.exact_topk(q, K)
    jq = torch.from_numpy(q).to(device)
    out = []

    def emit(row: dict, search: typ.Callable[[torch.Tensor], torch.Tensor], **after: typ.Any) -> None:
        """One line: `row`'s keys, recall@10 and QPS, then `after`'s (the JAX script's order)."""
        row = dict(row, recall10=recall_at(search(jq), gt, K),
                   qps=throughput_qps(search, q, device, block=args.block, blocks=args.blocks, reps=args.reps),
                   **after, card=card)
        print(json.dumps(row), flush=True)
        out.append(row)

    # the prototypes assume 8-bit (256-entry) codebooks and unpacked codes
    if args.code_bits == 8:
        emit({"codec": f"pq{m}:exh-onehot", "n": n, "bytes_per_vec": m},
             lambda v: exh_onehot_indices(codebooks, codes, v, n))
        for w_adc in (0.3, 0.5):
            emit({"codec": f"pq{m}+pca{rdim}:dual{w_adc}", "n": n, "bytes_per_vec": m + rdim},
                 functools.partial(lambda v, w: dual_search_indices(codebooks, codes, refine, v, n, w), w=w_adc))

    variants = {
        "exh": PQIndex(codebooks=codebooks, codes=codes, n_real=n, approx_recall=0.95, code_bits=args.code_bits),
        "exh+ref8": PQIndex(codebooks=codebooks, codes=codes, refine_codes=rows, refine_scale=scale, refine_proj=proj,
                            n_real=n, k_factor=8, approx_recall=0.95, code_bits=args.code_bits),
        "exh+ref": PQIndex(codebooks=codebooks, codes=codes, refine_codes=rows, refine_scale=scale, refine_proj=proj,
                           n_real=n, k_factor=args.k_factor, approx_recall=0.95, code_bits=args.code_bits),
    }
    bits_tag = "x4" if args.code_bits == 4 else ""
    for vname, index in variants.items():
        emit({"codec": f"pq{m}{bits_tag}+pca{rdim}:{vname}", "n": n, "bytes_per_vec": cb_bytes + rdim,
              "hbm_gb": corpus.n_pad * (cb_bytes + rdim) / 2**30},
             functools.partial(lambda v, ix: pq_search(ix, SearchQueries(vector=v), K).indices, ix=index),
             build_s=build_s, k_factor=args.k_factor)
    del variants, codes, rows, refine

    # the int8 full-width comparator on the same corpus: after the rotation a
    # coordinate's spread is ~1/sqrt(D); int8 saturates at ~5 sigma
    t0 = time.perf_counter()
    i8_scale = torch.full((1, d), 5.0 / np.sqrt(d) / 127.0, device=device)
    (buf,) = corpus.fill((d, torch.int8, lambda x: torch.clamp(torch.round(x / i8_scale), -127, 127).to(torch.int8)))
    idx8 = DenseIndex(vectors=buf, scale=i8_scale, n_real=n, approx_recall=0.95)
    build8_s = time.perf_counter() - t0
    emit({"codec": "int8-flat", "n": n, "bytes_per_vec": d, "hbm_gb": corpus.n_pad * d / 2**30},
         lambda v: dense_search(idx8, SearchQueries(vector=v), K).indices, build_s=build8_s)
    return out


if __name__ == "__main__":
    main()
