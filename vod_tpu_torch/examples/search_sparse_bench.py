"""Sparse BM25: analyzer -> postings -> device scoring, ms per batch: the port of `examples/search_sparse_bench.py`.

    python -m vod_tpu_torch.examples.search_sparse_bench              # on the card: 50,000 docs
    python -m vod_tpu_torch.examples.search_sparse_bench --device cpu --n_docs 2000 --batch 16

Docs of 8-24 words and queries of 4 words, drawn from a fixed 33-word list
by numpy `default_rng(0)` as in the JAX script, go through the port's own
C++ analyzer (`native/`: built with `g++` at first use; `native_available()`
says whether it loaded, else the Python fallbacks ran, as in JAX) into
impact-ordered BM25 postings (`build_postings`, 1024 a term) and
`sparse_search`. One search warms up, the next is timed between CUDA events
(host clock on the CPU). `main` returns the printed quantities and `card`.
"""

from __future__ import annotations

import time
import typing as typ

import numpy as np
import torch

from vod_tpu_torch.examples.mips_kernel_bench import card_name
from vod_tpu_torch.examples.synthetic import block_ms, device_of
from vod_tpu_torch.native import analyze_texts, build_postings, native_available
from vod_tpu_torch.search import SearchQueries, sparse_search
from vod_tpu_torch.search.sparse import SparseIndex
from vod_tpu_torch.utils.arguantic import Arguantic

WORDS = (
    "paris tokyo berlin rome madrid london capital city france japan germany "
    "italy spain england river mountain museum bridge king queen north south "
    "history ancient modern train airport harbor castle market festival"
).split()


class Args(Arguantic):
    n_docs: int = 50_000
    batch: int = 64
    top_k: int = 10
    vocab_bits: int = 16
    device: str = "cuda"


def main(argv: typ.Optional[list[str]] = None) -> dict:
    args = Args.parse(argv)
    device = device_of(args.device)
    rng = np.random.default_rng(0)
    vocab = 1 << args.vocab_bits
    docs = [" ".join(rng.choice(WORDS, size=rng.integers(8, 24))) for _ in range(args.n_docs)]
    t0 = time.perf_counter()
    ids, counts = analyze_texts(docs, vocab_size=vocab, max_terms=32)
    t_analyze = time.perf_counter() - t0
    t0 = time.perf_counter()
    docs_arr, imps_arr = build_postings(ids, counts, n_terms=vocab, max_postings=1024)
    t_postings = time.perf_counter() - t0
    native = native_available()
    print(f"native={native}: analyzed {args.n_docs} docs in {t_analyze:.2f}s, postings in {t_postings:.2f}s")
    index = SparseIndex(postings_docs=torch.from_numpy(docs_arr).to(device),
                        postings_impacts=torch.from_numpy(imps_arr).to(device), n_docs=args.n_docs)
    q_text = [" ".join(rng.choice(WORDS, size=4)) for _ in range(args.batch)]
    q_ids, _ = analyze_texts(q_text, vocab_size=vocab, max_terms=8)
    terms = torch.from_numpy(q_ids).to(device)

    def search(t: torch.Tensor) -> torch.Tensor:
        return sparse_search(index, SearchQueries(terms=t), top_k=args.top_k).indices

    search_ms = block_ms(search, [terms], device, reps=1)
    top = search(terms).cpu().numpy()
    print(f"BM25 search: {search_ms:.4f} ms/batch of {args.batch}")
    print("top ids q0:", top[0].tolist())
    print("q0:", q_text[0], "->", docs[int(top[0, 0])][:80])
    return {"native": native, "n_docs": args.n_docs, "analyze_s": t_analyze, "postings_s": t_postings,
            "search_ms": search_ms, "top_ids_q0": top[0].tolist(), "q0": q_text[0], "top_doc_q0": docs[int(top[0, 0])],
            "card": card_name(device)}


if __name__ == "__main__":
    main()
