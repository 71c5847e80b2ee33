"""Hybrid dense + BM25 + gold lookup search, merged and sampled: the port of `examples/search_hybrid.py`.

    python -m vod_tpu_torch.examples.search_hybrid                    # on the card
    python -m vod_tpu_torch.examples.search_hybrid --device cpu

Six documents: random f32 embeddings (numpy `default_rng(0)`, as the JAX
script) in a flat index with subset ids, BM25 impact postings from the
port's C++ analyzer (`native/`), two queries with a gold id each; then
`hybrid_search_and_sample` (dense weight 0.5, sparse 1.0, prefetch 6, 4
samples, 1 positive). The sampler's Exp(1) draws come from a
`torch.Generator` (seed 0): the port's own, not JAX's `PRNGKey(0)`, so the
samples may differ from the JAX script's while the merged results agree.
`main` returns the printed arrays (as lists) and `card`.
"""

from __future__ import annotations

import argparse
import typing as typ

import numpy as np
import torch

from vod_tpu_torch.examples.mips_kernel_bench import card_name
from vod_tpu_torch.examples.synthetic import device_of
from vod_tpu_torch.native import analyze_texts, build_postings
from vod_tpu_torch.search import HybridEngines, SearchQueries, build_dense_index, hybrid_search_and_sample
from vod_tpu_torch.search.sparse import SparseIndex

DOCS = [
    "paris is the capital of france",
    "tokyo is the capital of japan",
    "berlin is the capital of germany",
    "the eiffel tower is in paris",
    "mount fuji is near tokyo",
    "the brandenburg gate is in berlin",
]
QUERY_TEXTS = ["capital of france", "mountain near tokyo"]
VOCAB = 1 << 14
WEIGHTS = {"dense": 0.5, "sparse": 1.0}


def engines_and_queries(device: torch.device) -> tuple[HybridEngines, SearchQueries]:
    """The JAX script's engines and queries, on `device`."""
    rng = np.random.default_rng(0)
    n, d = len(DOCS), 64
    emb = rng.normal(size=(n, d)).astype("float32")
    dense = build_dense_index(emb, subset_ids=np.arange(n) % 2, dtype="float32", device=device)
    ids, counts = analyze_texts(DOCS, vocab_size=VOCAB, max_terms=32)
    docs_arr, imps_arr = build_postings(ids, counts, n_terms=VOCAB, max_postings=8)
    sparse = SparseIndex(postings_docs=torch.from_numpy(docs_arr).to(device),
                         postings_impacts=torch.from_numpy(imps_arr).to(device), n_docs=n)
    q_terms, _ = analyze_texts(QUERY_TEXTS, vocab_size=VOCAB, max_terms=8)
    queries = SearchQueries(
        vector=torch.from_numpy(rng.normal(size=(2, d)).astype("float32")).to(device),
        terms=torch.from_numpy(q_terms).to(device),
        section_ids=torch.tensor([[0, -1], [4, -1]], dtype=torch.int32, device=device),  # gold ids
    )
    return HybridEngines(dense=dense, sparse=sparse), queries


def run(device: torch.device, noise: typ.Optional[tuple[torch.Tensor, torch.Tensor]] = None) -> dict:
    """Search, merge and sample; `noise` replaces the sampler's draws."""
    engines, queries = engines_and_queries(device)
    sampled, merged = hybrid_search_and_sample(
        engines, queries, prefetch=6, total=4, max_pos_sections=1, weights=WEIGHTS, noise=noise,
        generator=torch.Generator(device=device).manual_seed(0),
    )
    out = {
        "merged_ids": merged.indices.cpu().tolist(),
        "merged_scores": merged.scores.cpu().tolist(),
        "merged_labels": merged.labels.cpu().tolist(),
        "sampled_ids": sampled.batch.indices.cpu().tolist(),
        "sampled_labels": sampled.batch.labels.cpu().tolist(),
        "log_weights": sampled.log_weights.cpu().tolist(),
    }
    out["top_sections"] = [DOCS[ids[0]] for ids in out["merged_ids"]]
    return out


def main(argv: typ.Optional[list[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    device = device_of(ap.parse_args(argv).device)
    out = run(device)
    print("merged ids:      ", np.asarray(out["merged_ids"]))
    print("merged scores:   ", np.round(np.asarray(out["merged_scores"]), 3))
    print("merged labels:   ", np.asarray(out["merged_labels"]))
    print("sampled ids:     ", np.asarray(out["sampled_ids"]))
    print("sampled labels:  ", np.asarray(out["sampled_labels"]))
    print("log weights:     ", np.round(np.asarray(out["log_weights"]), 3))
    for qi, text in enumerate(out["top_sections"]):
        print(f"query {qi}: top section = {text!r}")
    out["card"] = card_name(device)
    return out


if __name__ == "__main__":
    main()
