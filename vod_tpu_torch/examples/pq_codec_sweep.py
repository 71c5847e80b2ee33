"""PQ codec ladder on saved embeddings, recall@10 and QPS: the port of `examples/pq_codec_sweep.py`.

    python -m vod_tpu_torch.examples.pq_codec_sweep --emb emb.npy      # on the card
    python -m vod_tpu_torch.examples.pq_codec_sweep --device cpu --emb emb.npy --q 64 --configs int8-flat,pq64x8-exh

Reads the embeddings that `real_embedding_eval --out emb.npy` saves (and its
`emb_queries.npy`), so codec experiments skip harvest, training and
embedding. Ground truth: exact f32 search (`dense_search` with
`approx_recall=None`). The ladder, as the JAX script's: int8 flat, then PQ
codecs (`build_pq_index`: exhaustive ADC, coarse scan, int8 refine at
k_factor 8-32, truncated-PCA refine rows), each optionally with the
anisotropic (ScaNN) objective beside it (`--aniso`). `--configs` keeps the
entries whose name contains one of its comma-separated parts.

Codebooks, OPQ and k-means draw from a `torch.Generator` (seed 0 on the
device), so PQ recalls are the port's own, not the JAX script's (its
`PRNGKey(0)`); int8 flat is deterministic and equal. QPS: the `--q` queries
(plus 1e-4 noise, numpy seed 0) as one block, timed back to back `--reps`
times between CUDA events after a warm-up, the minimum kept (host clock on
the CPU); the JAX script differenced two batch sizes to cancel a relay's
round trip. Prints the JSON list of rows (the JAX script's keys plus
`card`); `main` returns it.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
import typing as typ

import numpy as np
import torch

from vod_tpu_torch.examples.mips_kernel_bench import card_name
from vod_tpu_torch.examples.synthetic import block_ms, device_of, recall_at, sync
from vod_tpu_torch.search import SearchQueries, build_dense_index, build_pq_index
from vod_tpu_torch.search.dense import dense_search, pq_search

K = 10


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--emb", default=os.path.join(tempfile.gettempdir(), "real_emb_200k.npy"))
    ap.add_argument("--queries", default=None, help="default: <emb>_queries.npy")
    ap.add_argument("--q", type=int, default=2048)
    ap.add_argument("--configs", default=None, help="comma list to filter by name substring")
    ap.add_argument("--aniso", action="store_true",
                    help="train the PQ entries with the anisotropic (ScaNN) objective too, side by side")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def ladder(dim: int) -> list[tuple[str, str, dict, int]]:
    """(name, kind, build_pq_index arguments, bytes a vector): the JAX script's ladder."""
    return [
        ("int8-flat", "int8", dict(), dim),
        ("pq64x8-exh", "pq", dict(n_subquantizers=64, coarse_dim=None), 64),
        ("pq32x8-exh+ref8", "pq", dict(n_subquantizers=32, coarse_dim=None, refine="int8", k_factor=8), 32 + dim),
        ("pq32x8-exh+ref32", "pq", dict(n_subquantizers=32, coarse_dim=None, refine="int8", k_factor=32), 32 + dim),
        ("pq64x8-exh+ref16", "pq", dict(n_subquantizers=64, coarse_dim=None, refine="int8", k_factor=16), 64 + dim),
        ("pq64x8-exh+ref32", "pq", dict(n_subquantizers=64, coarse_dim=None, refine="int8", k_factor=32), 64 + dim),
        ("pq32+coarse64+ref32", "pq",
         dict(n_subquantizers=32, coarse_dim=64, n_candidates=4096, refine="int8", k_factor=32), 32 + 64 + dim),
        # truncated-PCA refine: the memory frontier between codes-only and int8
        ("pq64-exh+ref32-d64", "pq",
         dict(n_subquantizers=64, coarse_dim=None, refine="int8", refine_dim=64, k_factor=32), 64 + 64),
        ("pq64-exh+ref32-d128", "pq",
         dict(n_subquantizers=64, coarse_dim=None, refine="int8", refine_dim=128, k_factor=32), 64 + 128),
        ("pq32-exh+ref32-d128", "pq",
         dict(n_subquantizers=32, coarse_dim=None, refine="int8", refine_dim=128, k_factor=32), 32 + 128),
    ]


def main(argv: typ.Optional[list[str]] = None) -> list[dict]:
    args = parser().parse_args(argv)
    device = device_of(args.device)
    emb = np.load(args.emb).astype(np.float32)
    q_emb = np.load(args.queries or args.emb.replace(".npy", "_queries.npy")).astype(np.float32)[: args.q]
    n, dim = emb.shape
    b = q_emb.shape[0]
    print(f"# corpus {n} x {dim}, {b} queries", flush=True)
    card = card_name(device)

    exact = build_dense_index(emb, dtype="float32", approx_recall=None, device=device)
    gt = dense_search(exact, SearchQueries(vector=torch.from_numpy(q_emb).to(device)), K).indices.cpu().numpy()
    del exact
    rng = np.random.default_rng(0)
    q1 = torch.from_numpy(q_emb + 1e-4 * rng.standard_normal(q_emb.shape).astype(np.float32)).to(device)
    jq = torch.from_numpy(q_emb).to(device)

    results = []
    for name, kind, kw, bytes_pv in ladder(dim):
        if args.configs and not any(c in name for c in args.configs.split(",")):
            continue
        variants = [("", None)]
        if kind == "pq" and args.aniso:
            variants.append(("+aniso", "auto"))
        for suffix, aniso_eta in variants:
            t0 = time.perf_counter()
            if kind == "int8":
                idx = build_dense_index(emb, dtype="int8", device=device)
                fn = dense_search
            else:
                idx = build_pq_index(emb, train_size=min(200_000, n), kmeans_iters=8, aniso_eta=aniso_eta,
                                     generator=torch.Generator(device=device).manual_seed(0), device=device, **kw)
                fn = pq_search
            sync(device)
            build_s = time.perf_counter() - t0

            def search(v: torch.Tensor, idx=idx, fn=fn) -> torch.Tensor:
                return fn(idx, SearchQueries(vector=v), K).indices

            rec = recall_at(search(jq), gt, K)
            qps = b / (block_ms(search, [q1], device, args.reps) / 1e3)
            print(f"# {name + suffix:30s} {bytes_pv:4d}B/vec recall@10 {rec:.4f}  ~{qps:,.0f} QPS", flush=True)
            results.append({"name": name + suffix, "bytes_per_vec": bytes_pv, "recall10": rec, "qps": qps,
                            "build_s": build_s, "card": card})
            del idx
    print(json.dumps(results), flush=True)
    return results


if __name__ == "__main__":
    main()
