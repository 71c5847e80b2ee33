"""Flat dense index: build, query and time one batch: the port of `examples/search_flat.py`.

    python -m vod_tpu_torch.examples.search_flat                      # on the card: 100,000 x 256
    python -m vod_tpu_torch.examples.search_flat --device cpu --n 2000 --d 32

The corpus is numpy `default_rng(0)` normal rows, normalised; the batch is
`--batch` of those rows (picked by the same generator) plus 0.1 noise, as in
the JAX script, so both packages search the same numbers. The index is flat
bf16 (`build_dense_index`); one search warms up, the next (queries + 1e-4)
is timed between CUDA events (host clock on the CPU). Recall@topk against
the exact f32 ranking by numpy. `main` returns the printed quantities and
`card`.
"""

from __future__ import annotations

import time
import typing as typ

import numpy as np
import torch

from vod_tpu_torch.examples.mips_kernel_bench import card_name
from vod_tpu_torch.examples.synthetic import block_ms, device_of, sync
from vod_tpu_torch.search import SearchQueries, build_dense_index, dense_search
from vod_tpu_torch.utils.arguantic import Arguantic


class Args(Arguantic):
    n: int = 100_000
    d: int = 256
    batch: int = 32
    topk: int = 10
    device: str = "cuda"


def main(argv: typ.Optional[list[str]] = None) -> dict:
    args = Args.parse(argv)
    device = device_of(args.device)
    rng = np.random.default_rng(0)
    corpus = rng.normal(size=(args.n, args.d)).astype("float32")
    corpus /= np.linalg.norm(corpus, axis=-1, keepdims=True)
    q = corpus[rng.choice(args.n, args.batch)] + 0.1 * rng.normal(size=(args.batch, args.d)).astype("float32")

    t0 = time.perf_counter()
    index = build_dense_index(corpus, dtype="bfloat16", device=device)
    sync(device)
    build_s = time.perf_counter() - t0
    print(f"built flat bf16 index over {args.n} x {args.d} in {build_s:.2f}s")

    def search(v: torch.Tensor) -> torch.Tensor:
        return dense_search(index, SearchQueries(vector=v), top_k=args.topk).indices

    qj = torch.from_numpy(q).to(device)
    search_ms = block_ms(search, [qj + 1e-4], device, reps=1)
    print(f"search: {search_ms:.4f} ms/batch of {args.batch}")

    exact = np.argsort(-(q @ corpus.T), axis=-1)[:, : args.topk]
    got = search(qj + 1e-4).cpu().numpy()
    recall = float(np.mean([len(set(got[i]) & set(exact[i])) / args.topk for i in range(args.batch)]))
    print(f"recall@{args.topk} vs exact: {recall:.3f}")
    print("top-5 ids of query 0:", got[0][:5].tolist())
    return {"n": args.n, "d": args.d, "build_s": build_s, "search_ms": search_ms, "recall": recall,
            "top5_q0": got[0][:5].tolist(), "card": card_name(device)}


if __name__ == "__main__":
    main()
