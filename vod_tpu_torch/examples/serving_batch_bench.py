"""Served QPS with micro-batching off and on: the port of `examples/serving_batch_bench.py`.

    python -m vod_tpu_torch.examples.serving_batch_bench              # on the card: 200,000 x 256 bf16
    python -m vod_tpu_torch.examples.serving_batch_bench --device cpu --n 4000 --d 32 --requests 32 --clients 4

Each unbatched request pays a full device dispatch; with `--window_ms` > 0
concurrent requests coalesce onto one dispatch (`serving.MicroBatcher`).
Single-row requests from `--clients` concurrent clients, a warm wave first
(so every bucket shape the batcher forms has run once), then a timed wave;
QPS is requests over the wave's host wall (`time.perf_counter`: the HTTP
boundary, where the client waits). Corpus: numpy `default_rng(1)` normal
rows, normalised, in a flat bf16 index; queries numpy `default_rng(0)`.
`main` returns the printed quantities and `card`.
"""

from __future__ import annotations

import concurrent.futures
import time
import typing as typ

import numpy as np

from vod_tpu_torch.examples.mips_kernel_bench import card_name
from vod_tpu_torch.examples.synthetic import device_of
from vod_tpu_torch.search import HybridEngines, build_dense_index
from vod_tpu_torch.serving import SearchHttpClient, SearchServer
from vod_tpu_torch.utils.arguantic import Arguantic


class Args(Arguantic):
    n: int = 200_000
    d: int = 256
    clients: int = 16
    requests: int = 128
    window_ms: float = 5.0
    device: str = "cuda"


def run(engines: HybridEngines, args: Args, window_ms: float, device: typ.Any) -> tuple[float, int]:
    rng = np.random.default_rng(0)
    qs = [rng.normal(size=(1, args.d)).astype("float32") for _ in range(args.requests)]
    with SearchServer(engines, batch_window_ms=window_ms, max_batch=64, device=device) as srv:
        client = SearchHttpClient(srv.url)
        with concurrent.futures.ThreadPoolExecutor(max_workers=args.clients) as ex:
            list(ex.map(lambda q: client.search(vector=q, top_k=10), qs))
        base = srv._batcher.dispatches if srv._batcher else 0
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(max_workers=args.clients) as ex:
            list(ex.map(lambda q: client.search(vector=q, top_k=10), qs))
        wall = time.perf_counter() - t0
        dispatches = (srv._batcher.dispatches - base) if srv._batcher else args.requests
    return args.requests / wall, dispatches


def main(argv: typ.Optional[list[str]] = None) -> dict:
    args = Args.parse(argv)
    device = device_of(args.device)
    rng = np.random.default_rng(1)
    corpus = rng.normal(size=(args.n, args.d)).astype("float32")
    corpus /= np.linalg.norm(corpus, axis=-1, keepdims=True)
    engines = HybridEngines(dense=build_dense_index(corpus, dtype="bfloat16", device=device))

    qps_off, _ = run(engines, args, 0.0, device)
    qps_on, dispatches = run(engines, args, args.window_ms, device)
    speedup = qps_on / max(qps_off, 1e-9)
    print(f"unbatched: {qps_off:,.0f} QPS | batched({args.window_ms}ms window): {qps_on:,.0f} QPS "
          f"({dispatches} dispatches for {args.requests} requests, x{speedup:.1f})")
    return {"qps_off": qps_off, "qps_on": qps_on, "window_ms": args.window_ms, "dispatches": dispatches,
            "requests": args.requests, "speedup": speedup, "card": card_name(device)}


if __name__ == "__main__":
    main()
