"""Sparse term-impact (BM25) engine (port of `vod_tpu/search/sparse.py`).

The analyzer runs on the host (`vod_tpu_torch/native`): documents become
term-id lists; the build precomputes BM25 *impact scores* per (term, doc)
posting, impact-sorted and truncated to `max_postings` docs per term, on the
host as in JAX, and then moves the table to `device`. BM25 parameters follow
ES defaults (k1=1.2, b=0.75, idf = ln(1 + (N - df + 0.5)/(df + 0.5))).

Scoring is term-at-a-time in stock torch ops, with shapes that depend on
nothing but the inputs' shapes (no `.item()`, no `nonzero`, no boolean-mask
indexing, so the train step stays free of synchronizing calls): gather the
postings rows of the query's terms, flatten, stable-sort by doc id,
segment-sum the runs of equal doc ids, top-k.

- Order and ties: `jnp.argsort(stable=True)` -> `torch.sort(stable=True)`,
  and `lax.top_k` -> `topk_lowest_first`, so equal totals go to the lowest
  position, which after the sort is the lowest doc id.
- The segment sum: `jax.ops.segment_sum` -> `scatter_add_` into a
  `[B, L*P]` buffer, then a gather back. On the CPU the additions run in
  position order, as XLA's do; on CUDA they are atomics, so a doc's <= L
  contributions are summed in an order that may change from run to run: its
  total may then differ from the CPU's by (n-1) * 2^-24 * its sum of n
  contributions, a few ulps of the score.
"""

from __future__ import annotations

import dataclasses
import time
import typing as typ

import numpy as np
import torch

from vod_tpu_torch.ops.numpy_ops import topk_lowest_first
from vod_tpu_torch.types.retrieval import RetrievalBatch
from .base import SearchQueries

_SENTINEL = torch.iinfo(torch.int32).max


@dataclasses.dataclass
class SparseIndex:
    postings_docs: torch.Tensor  # [T, P] int32 doc ids, -1 = padding
    postings_impacts: torch.Tensor  # [T, P] f32 BM25 impacts (impact-sorted desc)
    subset_ids: typ.Optional[torch.Tensor] = None  # [N] int32
    n_docs: int = 0
    offset: int = 0


def _to_device(
    docs_arr: np.ndarray,
    imp_arr: np.ndarray,
    subset_ids: typ.Any,
    n_docs: int,
    offset: int,
    device: typ.Union[str, torch.device],
) -> SparseIndex:
    """The host postings as a `SparseIndex` on `device`; `torch.from_numpy`
    shares the host arrays, so only `.to(device)` copies them."""
    if subset_ids is not None:
        subset_ids = torch.as_tensor(subset_ids).to(device=device, dtype=torch.int32)
    return SparseIndex(
        postings_docs=torch.from_numpy(docs_arr).to(device),
        postings_impacts=torch.from_numpy(imp_arr).to(device),
        subset_ids=subset_ids,
        n_docs=n_docs,
        offset=offset,
    )


def build_sparse_index(
    doc_terms: typ.Sequence[typ.Sequence[int]],
    *,
    n_terms: typ.Optional[int] = None,
    max_postings: int = 2048,
    k1: float = 1.2,
    b: float = 0.75,
    subset_ids: typ.Optional[np.ndarray] = None,
    offset: int = 0,
    device: typ.Union[str, torch.device] = "cuda",
) -> SparseIndex:
    """Build the impact index host-side from per-document term-id lists."""
    n_docs = len(doc_terms)
    doc_lens = np.asarray([len(t) for t in doc_terms], dtype=np.float32)
    avgdl = max(doc_lens.mean(), 1.0) if n_docs else 1.0

    # term -> {doc: tf}
    df: dict[int, int] = {}
    postings: dict[int, list[tuple[int, int]]] = {}
    for d, terms in enumerate(doc_terms):
        counts: dict[int, int] = {}
        for t in terms:
            counts[t] = counts.get(t, 0) + 1
        for t, tf in counts.items():
            postings.setdefault(t, []).append((d, tf))
            df[t] = df.get(t, 0) + 1

    t_max = (n_terms if n_terms is not None else (max(postings) + 1 if postings else 1))
    p_width = min(max_postings, max((len(v) for v in postings.values()), default=1))
    docs_arr = np.full((t_max, p_width), -1, dtype=np.int32)
    imp_arr = np.zeros((t_max, p_width), dtype=np.float32)
    for t, plist in postings.items():
        if t >= t_max:
            continue
        idf = np.log(1.0 + (n_docs - df[t] + 0.5) / (df[t] + 0.5))
        scored = []
        for d, tf in plist:
            norm = tf + k1 * (1.0 - b + b * doc_lens[d] / avgdl)
            scored.append((d, idf * tf * (k1 + 1.0) / norm))
        scored.sort(key=lambda x: -x[1])  # impact-ordered truncation
        for j, (d, imp) in enumerate(scored[:p_width]):
            docs_arr[t, j] = d
            imp_arr[t, j] = imp
    return _to_device(docs_arr, imp_arr, subset_ids, n_docs, offset, device)


def build_sparse_index_native(
    doc_terms: typ.Sequence[typ.Sequence[int]],
    *,
    n_terms: int,
    max_postings: int = 2048,
    k1: float = 1.2,
    b: float = 0.75,
    subset_ids: typ.Optional[np.ndarray] = None,
    offset: int = 0,
    device: typ.Union[str, torch.device] = "cuda",
    timings: typ.Optional[dict] = None,
) -> SparseIndex:
    """Impact-index build through the C++ postings builder (the python
    fallback inside `native.build_postings` keeps parity when the .so is
    unavailable). Output postings are `build_sparse_index`'s, up to the
    order of equal impacts at the truncation (the C++ and Python builds order
    them differently, in JAX too); trailing all-empty columns are trimmed to
    match its dynamic width.

    The host table is `[n_terms, max_postings]` (8 GiB at 2^18 x 4096):
    where no column is trimmed it goes to the device as it is, with no
    second host copy. `timings`, when given, receives the
    wall ms of the host build (`postings_ms`) and of the move to the device
    (`upload_ms`)."""
    from vod_tpu_torch.native import build_postings

    t0 = time.perf_counter()
    docs_arr, imp_arr = build_postings(
        doc_terms, n_terms=n_terms, max_postings=max_postings, k1=k1, b=b
    )
    # match build_sparse_index's p_width = min(max_postings, widest term)
    col_used = (docs_arr >= 0).any(axis=0)
    width = int(col_used.sum()) if col_used.any() else 1
    if width < docs_arr.shape[1]:
        docs_arr = np.ascontiguousarray(docs_arr[:, :width])
        imp_arr = np.ascontiguousarray(imp_arr[:, :width])
    t1 = time.perf_counter()
    index = _to_device(docs_arr, imp_arr, subset_ids, len(doc_terms), offset, device)
    if timings is not None:
        if index.postings_docs.is_cuda:
            torch.cuda.synchronize(index.postings_docs.device)
        timings.update(postings_ms=(t1 - t0) * 1e3, upload_ms=(time.perf_counter() - t1) * 1e3)
    return index


def build_impact_index(
    doc_terms: np.ndarray,  # [N, K] int32 term ids, -1 = padding
    doc_impacts: np.ndarray,  # [N, K] f32 learned impacts (e.g. SPLADE)
    *,
    n_terms: int,
    max_postings: int = 2048,
    subset_ids: typ.Optional[np.ndarray] = None,
    offset: int = 0,
    device: typ.Union[str, torch.device] = "cuda",
) -> SparseIndex:
    """Invert per-document learned (term, impact) pairs into the
    impact-ordered postings table (the learned-sparse build: the model's
    impacts replace the BM25 formula; scoring is shared). Vectorized
    (lexsort + run-rank), O(NK log NK)."""
    doc_terms = np.asarray(doc_terms, dtype=np.int64)
    doc_impacts = np.asarray(doc_impacts, dtype=np.float32)
    n_docs, k = doc_terms.shape
    flat_t = doc_terms.ravel()
    flat_w = doc_impacts.ravel()
    flat_d = np.repeat(np.arange(n_docs, dtype=np.int32), k)
    keep = (flat_t >= 0) & (flat_t < n_terms) & (flat_w > 0)
    flat_t, flat_w, flat_d = flat_t[keep], flat_w[keep], flat_d[keep]

    # sort by (term asc, impact desc) -> postings rows come out impact-ordered
    order = np.lexsort((-flat_w, flat_t))
    st, sw, sd = flat_t[order], flat_w[order], flat_d[order]

    # rank within each term run = position - run start
    if st.size:
        new_run = np.empty(st.shape, dtype=bool)
        new_run[0] = True
        new_run[1:] = st[1:] != st[:-1]
        run_start = np.maximum.accumulate(np.where(new_run, np.arange(st.size), 0))
        rank = np.arange(st.size) - run_start
        p_width = int(min(max_postings, rank.max() + 1))
    else:
        rank = st.astype(np.int64)
        p_width = 1
    docs_arr = np.full((n_terms, p_width), -1, dtype=np.int32)
    imp_arr = np.zeros((n_terms, p_width), dtype=np.float32)
    trunc = rank < p_width  # impact-ordered truncation, same as the BM25 build
    docs_arr[st[trunc], rank[trunc]] = sd[trunc]
    imp_arr[st[trunc], rank[trunc]] = sw[trunc]
    return _to_device(docs_arr, imp_arr, subset_ids, n_docs, offset, device)


def _segment_sum_sorted(ids: torch.Tensor, vals: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per row: sum `vals` over runs of equal (sorted) `ids`.

    Returns (totals at first-of-run positions, first-of-run mask); other
    positions hold junk. ids must be ascending per row; sentinel ids allowed.
    A shape-static `scatter_add_` into one slot per run (runs numbered by a
    cumulative sum of the first-of-run mask), then a gather back. Never a
    difference of prefix sums: over 131,072 f32 entries that loses precision
    in proportion to the row's total."""
    first = torch.cat(
        [torch.ones_like(ids[..., :1], dtype=torch.bool), ids[..., 1:] != ids[..., :-1]], dim=-1
    )
    seg = torch.cumsum(first.to(torch.int64), dim=-1) - 1  # dense run numbering
    seg2 = seg.reshape(-1, seg.shape[-1])
    vals2 = vals.reshape(-1, vals.shape[-1])
    per_seg = torch.zeros_like(vals2).scatter_add_(-1, seg2, vals2)
    totals = torch.gather(per_seg, -1, seg2).reshape(vals.shape)
    return totals, first


def bm25_topk(
    postings_docs: torch.Tensor,  # [T, P] int32 doc ids (global), -1 padding
    postings_impacts: torch.Tensor,  # [T, P] f32
    terms: torch.Tensor,  # [B, L] query term ids
    weights: typ.Optional[torch.Tensor],  # [B, L] or None
    top_k: int,
    *,
    doc_subset_ids: typ.Optional[torch.Tensor] = None,  # [N] int32 per-doc subset
    query_subset_ids: typ.Optional[torch.Tensor] = None,  # [B, S]
) -> tuple[torch.Tensor, torch.Tensor]:
    """Term-at-a-time BM25 top-k over one postings table. Returns (scores,
    doc ids) with -inf / int32-max padding; doc ids are whatever id space the
    table stores. Terms that are negative or >= T are skipped; a query that
    repeats a term counts it each time; `weights=None` means ones. A `k`
    above L*P pads as JAX does."""
    b, l = terms.shape
    t_max, p = postings_docs.shape
    if weights is None:
        weights = torch.ones(terms.shape, dtype=postings_impacts.dtype, device=terms.device)

    term_ok = (terms >= 0) & (terms < t_max)
    # torch's gathers take int64 indices; the postings stay int32
    safe_terms = terms.clamp(0, t_max - 1).long()
    docs = postings_docs[safe_terms]  # [B, L, P]
    imps = postings_impacts[safe_terms] * weights.to(postings_impacts.dtype)[..., None]
    valid = term_ok[..., None] & (docs >= 0)
    docs = torch.where(valid, docs, _SENTINEL)
    imps = torch.where(valid, imps, 0.0)

    flat_docs = docs.reshape(b, l * p)
    flat_imps = imps.reshape(b, l * p)
    sdocs, order = torch.sort(flat_docs, dim=-1, stable=True)
    simps = torch.gather(flat_imps, -1, order)

    totals, first = _segment_sum_sorted(sdocs, simps)
    score = torch.where(first & (sdocs != _SENTINEL), totals, float("-inf"))

    if query_subset_ids is not None and doc_subset_ids is not None:
        # [B, L*P, S]; a query whose subset ids are all negative has no filter
        safe_d = sdocs.clamp(0, doc_subset_ids.shape[0] - 1).long()
        sub = doc_subset_ids[safe_d]  # [B, L*P]
        match = (sub[:, :, None] == query_subset_ids[:, None, :]).any(dim=-1)
        no_filter = (query_subset_ids < 0).all(dim=-1, keepdim=True)
        score = torch.where(match | no_filter, score, float("-inf"))

    k_eff = min(top_k, score.shape[-1])
    top_s, pos = topk_lowest_first(score, k_eff)
    top_d = torch.gather(sdocs, -1, pos)
    if k_eff < top_k:
        pad = top_k - k_eff
        top_s = torch.cat([top_s, top_s.new_full((b, pad), float("-inf"))], dim=-1)
        top_d = torch.cat([top_d, top_d.new_full((b, pad), _SENTINEL)], dim=-1)
    return top_s, top_d


def sparse_search(
    index: SparseIndex,
    queries: SearchQueries,
    top_k: int,
) -> RetrievalBatch:
    """BM25 scoring of query term-id lists against the impact index; empty
    slots hold id -1 and score -inf."""
    terms = queries.terms
    if terms is None:
        raise ValueError("sparse_search requires queries.terms")
    top_s, top_d = bm25_topk(
        index.postings_docs, index.postings_impacts, terms, queries.term_weights,
        top_k,
        doc_subset_ids=index.subset_ids, query_subset_ids=queries.subset_ids,
    )
    ok = torch.isfinite(top_s)
    top_d = torch.where(ok, top_d + index.offset, -1).to(torch.int32)
    top_s = torch.where(ok, top_s, float("-inf"))
    return RetrievalBatch(scores=top_s, indices=top_d)
