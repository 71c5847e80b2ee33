"""IVF-PQ against serving-direct, the latency crossover at 8.8M: the port of `examples/ivfpq_crossover_bench.py`.

    python -m vod_tpu_torch.examples.ivfpq_crossover_bench            # on the card: 8,841,823 rows, 4096 cells
    python -m vod_tpu_torch.examples.ivfpq_crossover_bench --device cpu --n 16384 --c 64 --train 4096 \
        --nprobes 4,16 --blocks 2 --reps 1 --http_requests 4

Two engines over the same pca128 / pca256 int8 stores:
  * serving-direct: the pca128 int8 coarse scan -> exact pca256 re-rank
    (`PQIndex` with `codes=None`, `k_factor` 16);
  * ivfpq-SOAR: `--c` k-means cells (primary + `assign_soar` secondary
    assignments), the pca128 rows windowed per cell, the same pca256
    re-rank, at each of `--nprobes` (`apply_runtime_params`).
For each point: recall@10 against exact f32 search, and the device ms of
one search dispatch at each B of `--batches` (distinct query blocks back to
back between CUDA events, the minimum over `--reps` rounds; host clock on
the CPU). The decision rule, as the JAX script's: unless an ivfpq point with
recall@10 >= 0.9 beats serving-direct's dispatch ms at some B, ivfpq stays
out of the per-round benchmark. Then end-to-end p50/p99 of single requests
through `SearchServer` (no batching window) for serving-direct and the
best such ivfpq point (else nprobe 256, or the widest swept).

Corpus: `synthetic.SlabCorpus` (8 slabs aligned to
8192 rows, seeds 1000 + i, basis seed 99), projections and k-means (generator seed 11) from slab
0's first `--train` rows: the port's own draws. Prints one JSON line, the
JAX script's keys plus `card`; `main` returns it.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time
import typing as typ

import numpy as np
import torch

from vod_tpu_torch.examples.mips_kernel_bench import card_name
from vod_tpu_torch.examples.serving_codec_bench import build_direct_stores, direct_index
from vod_tpu_torch.examples.synthetic import MSMARCO_N, N_SLABS, SlabCorpus, device_of, recall_at, serving_ms, slab_rows
from vod_tpu_torch.ops.kmeans import _assign_chunked, kmeans
from vod_tpu_torch.search import HybridEngines, SearchQueries
from vod_tpu_torch.search.dense import pq_search
from vod_tpu_torch.search.ivfpq import assign_soar, build_ivfpq_from_device_parts, ivfpq_search
from vod_tpu_torch.serving import SearchHttpClient, SearchServer

K = 10


def log(msg: str) -> None:
    print(f"# {msg}", file=sys.stderr, flush=True)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=MSMARCO_N)
    ap.add_argument("--c", type=int, default=4096)
    ap.add_argument("--train", type=int, default=262_144)
    ap.add_argument("--n_eval", type=int, default=64)
    ap.add_argument("--nprobes", type=str, default="16,32,64,128,256")
    ap.add_argument("--batches", type=str, default="1,4,8,64")
    ap.add_argument("--blocks", type=int, default=9)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--http_requests", type=int, default=32)
    ap.add_argument("--skip_http", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def main(argv: typ.Optional[list[str]] = None) -> dict:
    args = parser().parse_args(argv)
    device = device_of(args.device)
    n = args.n
    autotune = importlib.import_module("vod_tpu_torch.search.autotune")
    corpus = SlabCorpus(n, slab_rows(n), N_SLABS, device)

    log(f"training projections + centroids (corpus {corpus.n_pad} x {corpus.d})")
    t0 = time.perf_counter()
    stores = build_direct_stores(corpus, args.train)
    centroids, _ = kmeans(corpus.slab_of(0, args.train), args.c, 8,
                          generator=torch.Generator(device=device).manual_seed(11))

    def assign(x: torch.Tensor) -> torch.Tensor:
        a = _assign_chunked(x, centroids, chunk=8192)
        return torch.stack([a, assign_soar(x, centroids, a, chunk=4096)], -1)

    (cells,) = corpus.fill((2, torch.int32, assign))
    cells = cells[:n].cpu().numpy()
    log(f"stores + assignments built in {time.perf_counter() - t0:.1f}s")

    q = corpus.queries(args.n_eval)
    gt = corpus.exact_topk(q, K)
    jq = torch.from_numpy(q).to(device)

    direct = direct_index(stores, n, k_factor=16)
    coarse = stores["coarse"][:n]
    ivf = build_ivfpq_from_device_parts(
        centroids, torch.zeros((1, 1, corpus.d), device=device), cells.T.reshape(-1), None,
        refine_dev=torch.cat([coarse, coarse]), refine_scale=stores["scale_c"], refine_proj=stores["proj_c"],
        rerank_dev=stores["refine"][:n], rerank_scale=stores["scale_r"], rerank_proj=stores["proj_r"],
        k_factor=16, window=512, nprobe=32, row_ids_np=np.tile(np.arange(n, dtype=np.int32), 2), n_real=n,
        spilled=True,
    )
    del coarse

    def sfn_direct(ix: typ.Any, v: torch.Tensor) -> torch.Tensor:
        return pq_search(ix, SearchQueries(vector=v), K).indices

    def sfn_ivf(ix: typ.Any, v: torch.Tensor) -> torch.Tensor:
        return ivfpq_search(ix, SearchQueries(vector=v), K).indices

    batches = [int(b) for b in args.batches.split(",")]

    def point(engine: str, sfn: typ.Callable, ix: typ.Any) -> dict:
        out = {"engine": engine, "recall10": recall_at(sfn(ix, jq), gt, K)}
        for b in batches:
            out[f"ms_b{b}"] = serving_ms(lambda v: sfn(ix, v), q, device, b=b, blocks=args.blocks, reps=args.reps)
        log(f"{engine}: recall {out['recall10']:.4f}, " + " ".join(f"B{b}={out[f'ms_b{b}']:.4f}ms" for b in batches))
        return out

    results: dict[str, typ.Any] = {"n": n, "points": [point("serving-direct", sfn_direct, direct)]}
    best_ivf_09 = None
    nprobes = [int(p) for p in args.nprobes.split(",")]
    for nprobe in nprobes:
        p = point(f"ivfpq-soar-np{nprobe}", sfn_ivf,
                  autotune.apply_runtime_params(ivf, {"nprobe": nprobe, "k_factor": 16}))
        results["points"].append(p)
        if p["recall10"] >= 0.9 and best_ivf_09 is None:
            best_ivf_09 = p

    direct_pt = results["points"][0]
    if best_ivf_09 is None:
        results["verdict"] = ("no ivfpq point reaches recall@10 0.9 at any swept nprobe — "
                              "ivfpq stays demoted from the per-round bench JSON")
    else:
        wins = [b for b in batches if best_ivf_09[f"ms_b{b}"] < direct_pt[f"ms_b{b}"]]
        results["verdict"] = (f"ivfpq at {best_ivf_09['engine']} (recall {best_ivf_09['recall10']}) "
                              + (f"beats serving-direct at B={wins}" if wins
                                 else "is slower than serving-direct at every batch size"))
    log(f"VERDICT: {results['verdict']}")

    if not args.skip_http:
        wide = 256 if 256 in nprobes else max(nprobes)
        np_best = int(best_ivf_09["engine"].rsplit("np", 1)[1]) if best_ivf_09 is not None else wide
        best = autotune.apply_runtime_params(ivf, {"nprobe": np_best, "k_factor": 16})
        candidates = [("serving-direct", direct), (f"ivfpq-soar-np{np_best}", best)]
        for label, engine_ix in candidates:
            with SearchServer(HybridEngines(dense=engine_ix), batch_window_ms=0.0, max_batch=16, device=device) as srv:
                srv.warmup({"vector": q[:1]}, top_k=K, batch_sizes=(1,))
                client = SearchHttpClient(srv.url)
                walls = []
                for i in range(args.http_requests):
                    v = q[i % args.n_eval][None] + 1e-4 * np.float32(i)
                    t0 = time.perf_counter()
                    client.search(vector=v, top_k=K)
                    walls.append(time.perf_counter() - t0)
                results[f"http_{label}"] = {"seq_p50_ms": float(np.percentile(np.asarray(walls) * 1e3, 50)),
                                            "seq_p99_ms": float(np.percentile(np.asarray(walls) * 1e3, 99))}
                log(f"http {label}: {results[f'http_{label}']}")
    results["card"] = card_name(device)
    print(json.dumps(results), flush=True)
    return results


if __name__ == "__main__":
    main()
