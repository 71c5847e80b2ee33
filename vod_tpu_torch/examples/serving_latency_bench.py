"""Per-request p50/p99 through SearchServer + MicroBatcher: the port of `examples/serving_latency_bench.py`.

    python -m vod_tpu_torch.examples.serving_latency_bench            # on the card: 8,841,823 rows
    python -m vod_tpu_torch.examples.serving_latency_bench --device cpu --n 16384 --train 4096 --requests 16 --clients 4

What a single client request experiences at the 8.8M serving operating
point: the direct pca128 -> pca256 `PQIndex` (`keep_codes=False`) with its
coarse stage on `fused_mips_binned` (`kernel="fused"`, 2048 bins; the
kernel's int8 `wgmma` body on the card), served over HTTP by `SearchServer`
with the `MicroBatcher` coalescing concurrent singles onto one dispatch
(`--window_ms` > 0) and with a dispatch per request (window 0). For each:
32 sequential singles (the per-request floor) and `--requests` singles from
`--clients` concurrent clients, their p50/p99, and the batcher's dispatch
count. `fused_tile=16384` is kept from the JAX script: the port's kernel
tiles its own rows, and the tile only clamps the bins (`ops/mips.py`).

Also measured (not in the JAX script): the device time of one search
dispatch at B = 1 and B = 16, between CUDA events over distinct staged
queries, so that the HTTP walls can be split into host and device parts.
The JAX script's docstring describes a remote relay's fixed round trip; the
card is attached to its host and has none, so no such number is assumed.

Corpus: `synthetic.SlabCorpus` (slabs of min(n, 1,105,920) rows, seeds
1000 + i, basis seed 99; the port's own draws). The queries are slab 0's
first 256 rows (request i adds 1e-4 * i). Latencies are host walls around
each HTTP round trip (`time.perf_counter`). Prints one JSON line with the
JAX script's keys plus `device_ms` and `card`; `main` returns it.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import sys
import threading
import time
import typing as typ

import numpy as np
import torch

from vod_tpu_torch.examples.mips_kernel_bench import card_name
from vod_tpu_torch.examples.serving_codec_bench import build_direct_stores, direct_index
from vod_tpu_torch.examples.synthetic import MSMARCO_N, SlabCorpus, block_ms, device_of, sync
from vod_tpu_torch.search import HybridEngines, SearchQueries
from vod_tpu_torch.search.dense import PQIndex, pq_search
from vod_tpu_torch.serving import SearchHttpClient, SearchServer

K = 10
SLAB = 1_105_920


def log(msg: str) -> None:
    print(f"# {msg}", file=sys.stderr, flush=True)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=MSMARCO_N)
    ap.add_argument("--requests", type=int, default=128)
    ap.add_argument("--clients", type=int, default=16)
    # the coalescing window: sized to the dispatch cost, not below the
    # request-arrival jitter (a too-small window fragments batches)
    ap.add_argument("--window_ms", type=float, default=25.0)
    ap.add_argument("--train", type=int, default=262_144)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def build_serving_index(n: int, device: torch.device, train_rows: int = 262_144) -> tuple[PQIndex, np.ndarray]:
    """The serving codec at `n` rows, its coarse stage on the binned kernel;
    and slab 0's first 256 rows as the query pool."""
    slab = min(n, SLAB)
    corpus = SlabCorpus(n, slab, -(-n // slab), device)
    stores = build_direct_stores(corpus, train_rows)
    q_src = corpus.slab_of(0, 256).cpu().numpy()
    index = direct_index(stores, n, kernel="fused", k_factor=16, fused_bins=2048, fused_tile=16384)
    return index, q_src


def percentile_ms(walls: list[float], p: float) -> float:
    return float(np.percentile(np.asarray(walls) * 1000, p))


def run_clients(url: str, q_pool: np.ndarray, n_requests: int, n_clients: int) -> list[float]:
    client = SearchHttpClient(url)
    walls: list[float] = []
    lock = threading.Lock()

    def one(i: int) -> None:
        v = q_pool[i % len(q_pool)][None] + 1e-4 * np.float32(i)
        t0 = time.perf_counter()
        client.search(vector=v, top_k=K)
        w = time.perf_counter() - t0
        with lock:
            walls.append(w)

    with concurrent.futures.ThreadPoolExecutor(max_workers=n_clients) as ex:
        list(ex.map(one, range(n_requests)))
    return walls


def main(argv: typ.Optional[list[str]] = None) -> dict:
    args = parser().parse_args(argv)
    device = device_of(args.device)
    log(f"building serving index at n={args.n}")
    t0 = time.perf_counter()
    index, q_pool = build_serving_index(args.n, device, args.train)
    sync(device)
    log(f"built in {time.perf_counter() - t0:.1f}s")
    engines = HybridEngines(dense=index)

    def search(v: torch.Tensor) -> torch.Tensor:
        return pq_search(index, SearchQueries(vector=v), K).indices

    device_ms = {}
    for b in (1, 16):
        pools = [torch.from_numpy(q_pool[j * b : (j + 1) * b] + np.float32(1e-4)).to(device) for j in range(8)]
        device_ms[f"b{b}"] = block_ms(search, pools, device)

    out: dict[str, typ.Any] = {"n": args.n, "requests": args.requests, "clients": args.clients}
    for label, window in (("uncoalesced", 0.0), ("coalesced", args.window_ms)):
        with SearchServer(engines, batch_window_ms=window, max_batch=16, device=device) as srv:
            # every padded bucket once through the server's own dispatch, so
            # no first call (kernel build and load, allocator growth) is timed
            srv.warmup({"vector": q_pool[:1]}, top_k=K, batch_sizes=(1, 2, 4, 8, 16))
            seq = run_clients(srv.url, q_pool, 32, 1)
            conc = run_clients(srv.url, q_pool, args.requests, args.clients)
            b = srv._batcher
            out[label] = {
                "seq_p50_ms": percentile_ms(seq, 50),
                "conc_p50_ms": percentile_ms(conc, 50),
                "conc_p99_ms": percentile_ms(conc, 99),
                "dispatches": b.dispatches if b else None,
                "requests": b.requests if b else None,
            }
            log(f"{label}: seq p50={out[label]['seq_p50_ms']:.3f}ms conc p50={out[label]['conc_p50_ms']:.3f}ms "
                f"p99={out[label]['conc_p99_ms']:.3f}ms dispatches={out[label]['dispatches']}")
    out["device_ms"] = device_ms
    out["card"] = card_name(device)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
