"""Hybrid dense + BM25 with subset filtering, the index sharded over two ranks:
the port of `examples/hybrid_sharded_bench.py` (BASELINE config #3).

    python -m vod_tpu_torch.examples.hybrid_sharded_bench                 # 2 ranks on the card(s)
    python -m vod_tpu_torch.examples.hybrid_sharded_bench --device cpu    # 2 CPU ranks (gloo)
    python -m vod_tpu_torch.examples.hybrid_sharded_bench --launch 0 --processes 2 --process_id 0 \\
        --coordinator localhost:9876                                      # one rank

The JAX script's data, drawn in its order from numpy seed 0: a corpus of
100,000 x 256 unit rows in 8 subsets, 12 terms a document out of 30,000,
and B = 256 queries (a corpus row + 0.05 noise, 6 terms, 4 of the 8 subsets
each). Unsharded engines (a bf16 flat index and the native BM25 build with
the subset ids, `max_postings` 256) built on every rank and timed on rank
0 alone, then the same engines
sharded over a "shard" axis of all ranks (`build_sharded_dense_index`,
`shard_sparse_index`); `hybrid_search` at k = 10 on each, one warm run and
three timed runs with the queries perturbed by 1e-5 * (i + 1), each between
CUDA events on the card (host clock on the CPU). Checked: every returned id
passes its row's subset filter, and the sharded ids agree with the
unsharded ones in at least 9 of 10 a query on average (bf16 ties may flip
the tail). On the CPU, the JAX script's bound on the time ratio holds too
(unsharded / sharded >= 0.6); on a card it is reported, not asserted: two
ranks on one card merge over gloo through the host.

The ranks join one `torch.distributed` group over localhost as
`multiprocess_dryrun` does: NCCL where every rank has a card of its own,
else gloo (NCCL refuses two ranks on one GPU). Rank 0 prints one JSON line
(the JAX script's `metric`, `value` in QPS, `unit`, `vs_baseline` = the
unsharded time over the sharded time, the rank's launches of the two
hand-written kernels, and `card`); with `--launch` the
launcher prints it again as its last line, and `main` returns it.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import socket
import subprocess
import sys
import tempfile
import time
import typing as typ

import numpy as np
import torch
import torch.distributed as dist

from vod_tpu_torch.examples.mips_kernel_bench import card_name
from vod_tpu_torch.examples.synthetic import device_of
from vod_tpu_torch.ops.mips import fused_mips_binned, fused_mips_topk
from vod_tpu_torch.parallel import barrier, init_distributed, make_mesh, rank_device
from vod_tpu_torch.search import (
    HybridEngines,
    ShardedDenseIndex,
    SearchQueries,
    build_dense_index,
    build_sharded_dense_index,
    build_sparse_index_native,
    hybrid_search,
    shard_sparse_index,
)

N, D, B, K, N_TERMS = 100_000, 256, 256, 10, 30_000
N_SUBSETS, DOC_TERMS, Q_TERMS, Q_SUBSETS = 8, 12, 6, 4
MIN_AGREEMENT = 0.9
MIN_RATIO_CPU = 0.6
LAUNCH_TIMEOUT_S = 900.0  # how long the launcher waits for its ranks


def make_data(n: int = N, d: int = D, b: int = B, n_terms: int = N_TERMS, seed: int = 0) -> dict:
    """The JAX script's arrays, drawn in its order."""
    rng = np.random.default_rng(seed)
    corpus = rng.standard_normal((n, d), dtype=np.float32)
    corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
    subsets = rng.integers(0, N_SUBSETS, size=n).astype("int32")
    doc_terms = [rng.integers(0, n_terms, size=DOC_TERMS).tolist() for _ in range(n)]
    q_vec = corpus[rng.choice(n, b, replace=False)] + 0.05 * rng.standard_normal((b, d)).astype(np.float32)
    return dict(
        corpus=corpus, subsets=subsets, doc_terms=doc_terms, n_terms=n_terms,
        q_vector=q_vec / np.linalg.norm(q_vec, axis=1, keepdims=True),
        q_terms=rng.integers(0, n_terms, size=(b, Q_TERMS)).astype("int32"),
        q_subsets=np.stack([rng.permutation(N_SUBSETS)[:Q_SUBSETS] for _ in range(b)]).astype("int32"),
    )


def build_unsharded(data: dict, device: torch.device) -> tuple[typ.Any, float]:
    """(HybridEngines of the bf16 flat index and the BM25 build, the BM25
    build's seconds)."""
    t0 = time.perf_counter()
    sparse = build_sparse_index_native(data["doc_terms"], n_terms=data["n_terms"], max_postings=256,
                                       subset_ids=data["subsets"], device=device)
    sparse_build_s = time.perf_counter() - t0
    dense = build_dense_index(data["corpus"], subset_ids=data["subsets"], dtype="bfloat16", device=device)
    return HybridEngines(dense=dense, sparse=sparse), sparse_build_s


def build_sharded(data: dict, unsharded: typ.Any, mesh: typ.Any, device: torch.device) -> typ.Any:
    """The same engines, this rank's shard of each over the mesh's "shard" axis."""
    return HybridEngines(
        dense=build_sharded_dense_index(data["corpus"], mesh, dtype="bfloat16", subset_ids=data["subsets"],
                                        device=device),
        sparse=shard_sparse_index(unsharded.sparse, mesh, device=device),
    )


def queries_on(data: dict, device: torch.device) -> typ.Any:
    return SearchQueries(vector=torch.from_numpy(data["q_vector"]).to(device),
                         terms=torch.from_numpy(data["q_terms"]).to(device),
                         subset_ids=torch.from_numpy(data["q_subsets"]).to(device))


def search_ids(engines: typ.Any, queries: typ.Any, k: int = K) -> torch.Tensor:
    return hybrid_search(engines, queries, k)[0].indices


def timed_runs(engines: typ.Any, queries: typ.Any, device: torch.device, k: int = K,
               runs: int = 3) -> tuple[np.ndarray, list[float]]:
    """One warm run (then a barrier: every rank starts the timed runs
    together), then `runs` runs with the vectors perturbed by 1e-5 * (i + 1):
    (the last run's ids, each run's seconds)."""
    search_ids(engines, queries, k).cpu()
    if isinstance(engines.dense, ShardedDenseIndex):
        barrier("warm")
    seconds = []
    for i in range(runs):
        q = SearchQueries(vector=queries.vector + 1e-5 * (i + 1), terms=queries.terms, subset_ids=queries.subset_ids)
        if device.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize(device)
            start.record()
            out = search_ids(engines, q, k)
            end.record()
            end.synchronize()
            seconds.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            out = search_ids(engines, q, k)
            out.cpu()
            seconds.append(time.perf_counter() - t0)
    return out.cpu().numpy(), seconds


def check_filter(ids: np.ndarray, subsets: np.ndarray, allowed: np.ndarray, label: str) -> None:
    """Every returned id (>= 0) lies in one of its row's allowed subsets."""
    for i in range(ids.shape[0]):
        for x in ids[i].tolist():
            if x >= 0 and subsets[x] not in allowed[i]:
                raise AssertionError(f"{label}: row {i} returned id {x} of subset {subsets[x]}, "
                                     f"outside {allowed[i].tolist()}")


def agreement(got: np.ndarray, ref: np.ndarray) -> float:
    """Mean over rows of |got ∩ ref| / |ref| (ids >= 0)."""
    overlaps = []
    for i in range(ref.shape[0]):
        got_set = {x for x in got[i].tolist() if x >= 0}
        ref_set = {x for x in ref[i].tolist() if x >= 0}
        overlaps.append(len(got_set & ref_set) / max(len(ref_set), 1))
    return float(np.mean(overlaps))


def run(device: torch.device, data: typ.Optional[dict] = None) -> typ.Optional[dict]:
    """This rank's part, in a joined process group: rank 0 times the
    unsharded engines while the others wait, then every rank builds its
    shards and they time the sharded search together. Rank 0 checks the
    filter and the agreement and returns the result; the others return
    None. (The CPU's bound on the time ratio is `worker`'s.)"""
    world, rank = dist.get_world_size(), dist.get_rank()
    mesh = make_mesh((world,), ("shard",))
    data = data or make_data()
    n, b = data["corpus"].shape[0], data["q_vector"].shape[0]
    print(f"# [rank {rank}] corpus {n}x{data['corpus'].shape[1]}, {data['n_terms']} terms, B={b}", flush=True)
    queries = queries_on(data, device)
    unsharded, sparse_build_s = build_unsharded(data, device)
    barrier("unsharded-built")
    if rank == 0:
        ref_i, t_un = timed_runs(unsharded, queries, device)
    barrier("unsharded-timed")
    sharded = build_sharded(data, unsharded, mesh, device)
    got_i, t_sh = timed_runs(sharded, queries, device)
    barrier("sharded-timed")
    if rank != 0:
        return None

    check_filter(got_i, data["subsets"], data["q_subsets"], "sharded")
    check_filter(ref_i, data["subsets"], data["q_subsets"], "unsharded")
    agree = agreement(got_i, ref_i)
    if agree < MIN_AGREEMENT:
        raise AssertionError(f"sharded ids agree with the unsharded ones in {agree:.3f} < {MIN_AGREEMENT}")
    ratio = float(np.mean(t_un) / np.mean(t_sh))
    backend = dist.get_backend()
    return {
        "metric": (
            f"hybrid dense+BM25 sharded over {world} ranks ({n} x {data['corpus'].shape[1]} + "
            f"{data['n_terms']}-term postings, subset-filtered, agreement {agree:.3f}, "
            f"sparse build {sparse_build_s:.1f}s)"
        ),
        "value": b / float(np.mean(t_sh)),
        "unit": f"QPS ({world} {backend} ranks, {device.type})",
        "vs_baseline": ratio,  # >= ~1 means sharding costs nothing
        "agreement": agree,
        "unsharded_s": t_un,
        "sharded_s": t_sh,
        "sparse_build_s": sparse_build_s,
        # this rank's launches of the hand-written kernels (a subset-filtered search takes neither)
        "kernel_launches": {"fused_mips_binned": fused_mips_binned.launches,
                            "fused_mips_topk": fused_mips_topk.launches},
        "card": card_name(device),
    }


def worker(args: argparse.Namespace) -> typ.Optional[dict]:
    device_of(args.device)
    world = args.processes
    if args.device == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or world) // world))
    cards = torch.cuda.device_count() if args.device == "cuda" else 0
    backend = "nccl" if cards >= world else "gloo"
    init_distributed(args.coordinator, world, args.process_id, backend=backend, device=args.device)
    try:
        result = run(rank_device(args.device))
    finally:
        dist.destroy_process_group()
    if result is not None and args.device == "cpu" and result["vs_baseline"] < MIN_RATIO_CPU:
        # two ranks on the CPU: anything worse than 40% is a regression in the sharded program itself
        raise AssertionError(f"unsharded / sharded time {result['vs_baseline']:.3f} < {MIN_RATIO_CPU} "
                             f"({result['unsharded_s']}, {result['sharded_s']})")
    if result is not None:
        if args.result:
            pathlib.Path(args.result).write_text(json.dumps(result))
        else:
            print(json.dumps(result), flush=True)
    return result


def launch(args: argparse.Namespace) -> dict:
    """Start `args.launch` ranks against a fresh localhost port, wait for
    them (stopping the others when one fails) and return rank 0's result."""
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    with tempfile.TemporaryDirectory(prefix="hybrid_sharded_") as tmp:
        result_path = pathlib.Path(tmp) / "result.json"
        procs = [
            subprocess.Popen(
                [sys.executable, "-m", "vod_tpu_torch.examples.hybrid_sharded_bench", "--launch", "0",
                 "--processes", str(args.launch), "--process_id", str(i), "--coordinator", f"localhost:{port}",
                 "--device", args.device, "--result", str(result_path)],
                cwd=pathlib.Path(__file__).resolve().parents[2],
            )
            for i in range(args.launch)
        ]
        deadline = time.monotonic() + LAUNCH_TIMEOUT_S
        try:
            while any(p.poll() is None for p in procs):
                if any(p.returncode for p in procs) or time.monotonic() > deadline:
                    break
                time.sleep(0.2)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        codes = [p.returncode for p in procs]
        if any(codes) or not result_path.exists():
            raise RuntimeError(f"the ranks exited with {codes}")
        return json.loads(result_path.read_text())


def main(argv: typ.Optional[list[str]] = None) -> typ.Optional[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--launch", type=int, default=2, help="start N ranks and wait (0: run as one rank)")
    ap.add_argument("--processes", type=int, default=2)
    ap.add_argument("--process_id", type=int, default=None)
    ap.add_argument("--coordinator", type=str, default=None)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--result", type=str, default=None, help="rank 0 writes its JSON here instead of printing it")
    args = ap.parse_args(argv)
    if args.launch:
        device_of(args.device)
        result = launch(args)
        print(json.dumps(result), flush=True)
        return result
    return worker(args)


if __name__ == "__main__":
    main()
