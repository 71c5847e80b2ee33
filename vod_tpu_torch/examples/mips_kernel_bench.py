"""Fused-MIPS kernel shootout on one NVIDIA GPU: the port of `examples/mips_kernel_bench.py`.

    python -m vod_tpu_torch.examples.mips_kernel_bench      # on the card: 1M x 768 bf16, 2048-query blocks, k=10
    python -m vod_tpu_torch.examples.mips_kernel_bench --device cpu --n 4096 --d 32 --blk 64 --nblocks 2

Compares, on the corpus and queries of the JAX script (same numpy seeds):
  A. `dense_search` on a flat bf16 index. The port's scan is exact (chunked
     matmul + stable top-k); on the TPU it was `approx_max_k`;
  B. `fused_mips_binned`, the binned CUDA kernel (approximate);
  C. `fused_mips_topk`, the exact CUDA kernel;
with exact ground truth from `dense_search` on an index with
`approx_recall=None`. Recall@k is measured on up to 256 queries (padded with
zero rows to one block); each route is timed for QPS.

Data: the corpus is `default_rng(0).standard_normal` rows, normalised, in bf16.
Query blocks are corpus rows + 0.05 noise, normalised, in bf16: seed 98 warms
up, seeds 50 + i are the timed pools, seed 99 gives the recall queries. The
JAX script's one-block pools (seeds 10 + i) served only its differencing of 8
blocks against 1, which cancelled a relay's round trip; they are not made here.

Timing: every query pool is staged on the device first. Each pool's `--nblocks`
blocks run back to back between two CUDA events (host clock on the CPU);
seconds per block is the minimum over `--reps` pools, and QPS is
`blk / seconds per block`.

Prints one JSON line with the JAX script's keys plus `card` (nvidia-smi's name
and power limit, or "cpu"); `main` returns the same dict.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
import typing as typ

import numpy as np
import torch

from vod_tpu_torch.ops.mips import fused_mips_binned, fused_mips_topk
from vod_tpu_torch.search import SearchQueries, build_dense_index, dense_search

N_EVAL = 256  # recall queries


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1 << 20)
    ap.add_argument("--d", type=int, default=768)
    ap.add_argument("--blk", type=int, default=2048)
    ap.add_argument("--nblocks", type=int, default=8)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--skip-exact-kernel", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--reps", type=int, default=3)
    return ap


def card_name(device: torch.device) -> str:
    """nvidia-smi's `name, power.limit` of the card, or "cpu"."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def make_corpus(n: int, d: int) -> np.ndarray:
    """The JAX script's corpus, f32 unit rows (cast to bf16 by the caller)."""
    corpus = np.random.default_rng(0).standard_normal(size=(n, d), dtype=np.float32)
    corpus /= np.linalg.norm(corpus, axis=-1, keepdims=True)
    return corpus


def make_queries(corpus: np.ndarray, seed: int, nblocks: int, blk: int) -> np.ndarray:
    """The JAX script's `qblocks`: [nblocks, blk, d] f32 unit rows, corpus rows + 0.05 noise."""
    n, d = corpus.shape
    r = np.random.default_rng(seed)
    q = corpus[r.integers(0, n, size=nblocks * blk)]
    q = q + 0.05 * r.standard_normal((nblocks * blk, d), dtype=np.float32)
    q = (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)
    return q.reshape(nblocks, blk, d)


def _pad_rows(v: torch.Tensor, multiple: int) -> torch.Tensor:
    pad = (-v.shape[0]) % multiple
    return torch.cat([v, v.new_zeros((pad, v.shape[1]))]) if pad else v


def _seconds_per_block(fn: typ.Callable, blocks: torch.Tensor, device: torch.device) -> float:
    if device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(device)
        start.record()
        for qb in blocks:
            fn(qb)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / len(blocks)
    t = time.perf_counter()
    for qb in blocks:
        fn(qb)
    return (time.perf_counter() - t) / len(blocks)


def main(argv: typ.Optional[list[str]] = None) -> dict:
    args = parser().parse_args(argv)
    device = torch.device(args.device)
    n, d, blk, nb, k = args.n, args.d, args.blk, args.nblocks, args.k
    print(f"# corpus {n} x {d} bf16, {nb} blocks x {blk} queries, k={k}, on {device}", flush=True)
    corpus_np = make_corpus(n, d)
    corpus = torch.from_numpy(corpus_np).to(device).to(torch.bfloat16)

    def staged(seed: int, nblocks: int) -> torch.Tensor:
        return torch.from_numpy(make_queries(corpus_np, seed, nblocks, blk)).to(device).to(torch.bfloat16)

    pools = [staged(50 + i, nb) for i in range(args.reps)]
    warm = staged(98, 1)
    n_eval = min(N_EVAL, blk)
    q_eval = staged(99, 1)[0]
    q_eval[n_eval:] = 0  # the JAX script pads its 256 recall queries with zero rows to one block
    del corpus_np
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    print("# corpus and query pools staged on the device", flush=True)

    def ids_of(fn: typ.Callable) -> np.ndarray:
        return fn(q_eval)[:n_eval].cpu().numpy()

    exact_index = build_dense_index(corpus, dtype="bfloat16", approx_recall=None, device=device)
    gt = ids_of(lambda qq: dense_search(exact_index, SearchQueries(vector=qq), top_k=k).indices)
    print("# exact ground truth ready", flush=True)
    results: dict = {"n": n, "d": d, "blk": blk, "nblocks": nb, "k": k}

    def measure(fn: typ.Callable, name: str, key: str) -> None:
        fn(warm[0])
        per_block = min(_seconds_per_block(fn, pool, device) for pool in pools)
        ids = ids_of(fn)
        results[f"{key}_qps"] = blk / per_block
        results[f"{key}_recall"] = float(np.mean([len(set(ids[i]) & set(gt[i])) / k for i in range(n_eval)]))
        print(f"# {name}: {results[f'{key}_qps']:,.0f} QPS, recall@{k} {results[f'{key}_recall']:.4f}", flush=True)

    print("# A: the port's dense_search scan is exact (chunked matmul + stable top-k); "
          "on the TPU it was approx_max_k", flush=True)
    index = build_dense_index(corpus, dtype="bfloat16", device=device)
    measure(lambda qq: dense_search(index, SearchQueries(vector=qq), top_k=k).indices, "A scan", "scan")

    vpad = _pad_rows(corpus, 1024)
    measure(lambda qq: fused_mips_binned(vpad, qq, k=k, n_real=n)[1], "B fused_mips_binned", "binned")
    del vpad

    if not args.skip_exact_kernel:
        vpad2 = _pad_rows(corpus, 2048)
        measure(lambda qq: fused_mips_topk(vpad2, qq, k=k, qblock=256, n_real=n)[1],
                "C fused_mips_topk", "exact_kernel")

    results["card"] = card_name(device)
    print(json.dumps(results), flush=True)
    return results


if __name__ == "__main__":
    main()
