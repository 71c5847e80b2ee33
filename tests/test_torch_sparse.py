"""The port's BM25 engine (`vod_tpu_torch/search/sparse.py`) against the JAX
package's, on seeded toy corpora.

Tolerances: the three builds give the same postings as JAX exactly (doc ids
and f32 impacts equal bit for bit, since both run the same host code).
Scoring on the CPU sums each doc's contributions in position order, as
XLA's `segment_sum` does, so ids are equal and scores within 1e-6 (f32,
totals below 100). The numpy BM25 check holds scores within 1e-4 of the
f64 formula, as `tests/test_search.py` does for JAX.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_helpers import CPU, np_of
from vod_tpu.search import SearchQueries as JaxQueries
from vod_tpu.search import sparse as jax_sparse
from vod_tpu_torch.models.convert import sparse_index_from_fields
from vod_tpu_torch.search import (
    SearchQueries,
    SparseIndex,
    bm25_topk,
    build_impact_index,
    build_sparse_index,
    build_sparse_index_native,
    sparse_search,
)
from vod_tpu_torch.search.sparse import _segment_sum_sorted

ATOL = 1e-6
N_DOCS, N_TERMS = 120, 48


def _docs(seed: int = 0, n: int = N_DOCS, n_terms: int = N_TERMS) -> list[list[int]]:
    """Documents of 3-14 terms drawn from a skewed vocabulary, some repeated."""
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, n_terms + 1)
    p /= p.sum()
    return [rng.choice(n_terms, size=int(rng.integers(3, 15)), p=p).tolist() for _ in range(n)]


def _assert_same_postings(tix: SparseIndex, jix) -> None:
    np.testing.assert_array_equal(np_of(tix.postings_docs), np_of(jix.postings_docs))
    np.testing.assert_array_equal(np_of(tix.postings_impacts), np_of(jix.postings_impacts))
    assert tix.postings_docs.dtype == torch.int32 and tix.postings_impacts.dtype == torch.float32
    assert (tix.n_docs, tix.offset) == (jix.n_docs, jix.offset)


@pytest.mark.parametrize("n_terms, max_postings", [(None, 2048), (N_TERMS, 16), (N_TERMS + 10, 7)])
def test_build_sparse_index_matches_jax(n_terms, max_postings: int) -> None:
    docs = _docs(1)
    subset = np.arange(N_DOCS, dtype=np.int32) % 4
    kw = dict(n_terms=n_terms, max_postings=max_postings, subset_ids=subset, offset=5)
    tix = build_sparse_index(docs, device=CPU, **kw)
    _assert_same_postings(tix, jax_sparse.build_sparse_index(docs, **kw))
    np.testing.assert_array_equal(np_of(tix.subset_ids), subset)


@pytest.mark.parametrize("path", ["native", "fallback"])
@pytest.mark.parametrize("max_postings", [4, 4096])
def test_build_sparse_index_native_matches_jax(monkeypatch, path: str, max_postings: int) -> None:
    """The native build against JAX's, both on the C++ builder or both on its
    Python fallback (the two order equal impacts differently at the
    truncation, in JAX too): the trimmed width and every posting equal; the
    build's stages timed."""
    if path == "fallback":
        from vod_tpu.native import loader as jax_loader
        from vod_tpu_torch.native import loader

        monkeypatch.setattr(loader, "_get_lib", lambda: None)
        monkeypatch.setattr(jax_loader, "_get_lib", lambda: None)
    docs = _docs(2)
    want = jax_sparse.build_sparse_index_native(docs, n_terms=N_TERMS, max_postings=max_postings)
    timings: dict = {}
    tix = build_sparse_index_native(docs, n_terms=N_TERMS, max_postings=max_postings, device=CPU, timings=timings)
    _assert_same_postings(tix, want)
    widest = np.bincount(np.concatenate([np.unique(d) for d in docs])).max()  # the largest df
    assert tix.postings_docs.shape[1] == min(max_postings, widest)
    assert set(timings) == {"postings_ms", "upload_ms"} and all(v >= 0 for v in timings.values())


def test_build_impact_index_matches_jax() -> None:
    rng = np.random.default_rng(3)
    terms = rng.integers(-1, N_TERMS + 4, (60, 9)).astype(np.int32)  # -1 and >= T are dropped
    imps = rng.random((60, 9)).astype(np.float32) - 0.1  # non-positive impacts are dropped
    imps[5, :3] = imps[6, :3] = 0.5  # equal impacts
    terms[6, :3] = terms[5, :3]
    for max_postings in (3, 64):
        kw = dict(n_terms=N_TERMS, max_postings=max_postings, offset=2)
        _assert_same_postings(build_impact_index(terms, imps, device=CPU, **kw),
                              jax_sparse.build_impact_index(terms, imps, **kw))


def test_segment_sum_sorted_matches_jax() -> None:
    rng = np.random.default_rng(4)
    ids = np.sort(rng.integers(0, 20, (3, 2, 50)), axis=-1).astype(np.int32)
    ids[0, 0, -7:] = np.iinfo(np.int32).max
    vals = rng.normal(size=ids.shape).astype(np.float32)
    jt, jf = jax_sparse._segment_sum_sorted(jnp.asarray(ids), jnp.asarray(vals))
    tt, tf = _segment_sum_sorted(torch.from_numpy(ids), torch.from_numpy(vals))
    np.testing.assert_array_equal(np_of(tf), np_of(jf))
    first = np_of(jf)
    np.testing.assert_allclose(np_of(tt)[first], np_of(jt)[first], atol=ATOL, rtol=0)


def _queries(seed: int, b: int = 6, l: int = 5) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, N_TERMS, (b, l)).astype(np.int32)


def _case(name: str):
    """(terms, term_weights, query subset ids, k, offset) of one search case."""
    terms = _queries(10)
    weights = subsets = None
    k, offset = 10, 0
    if name == "repeated-terms":
        terms[:, 1] = terms[:, 0]
        terms[2, :] = terms[2, 0]
    elif name == "invalid-terms":
        terms[0, 2:] = -1
        terms[1, 0] = N_TERMS
        terms[2, :] = -1  # nothing to score: every slot empty
        terms[3, 4] = 10**6
    elif name == "term-weights":
        weights = np.random.default_rng(11).random(terms.shape).astype(np.float32)
        weights[0, 0] = 0.0
    elif name == "subset-filter":
        subsets = np.asarray([[1, -1], [0, 2], [-1, -1], [3, -1], [-1, 1], [2, 2]], np.int32)
    elif name == "k-above-LP":
        k = 40 * 5 * 2 + 3  # max_postings 40, L = 5
    elif name == "offset":
        offset = 1000
    return terms, weights, subsets, k, offset


CASES = ["plain", "repeated-terms", "invalid-terms", "term-weights", "subset-filter", "k-above-LP", "offset"]


@pytest.mark.parametrize("name", CASES)
def test_sparse_search_matches_jax(name: str) -> None:
    terms, weights, subsets, k, offset = _case(name)
    docs = _docs(5)
    doc_subsets = np.arange(N_DOCS, dtype=np.int32) % 4
    jix = jax_sparse.build_sparse_index(docs, n_terms=N_TERMS, max_postings=40, subset_ids=doc_subsets,
                                        offset=offset)
    tix = sparse_index_from_fields(
        {f: getattr(jix, f) for f in ("postings_docs", "postings_impacts", "subset_ids", "n_docs", "offset")},
        device=CPU,
    )
    jq = JaxQueries(terms=jnp.asarray(terms), term_weights=None if weights is None else jnp.asarray(weights),
                    subset_ids=None if subsets is None else jnp.asarray(subsets))
    tq = SearchQueries(terms=torch.from_numpy(terms),
                       term_weights=None if weights is None else torch.from_numpy(weights),
                       subset_ids=None if subsets is None else torch.from_numpy(subsets))
    want = jax_sparse.sparse_search(jix, jq, k)
    got = sparse_search(tix, tq, k)
    assert got.indices.dtype == torch.int32 and got.scores.shape == (terms.shape[0], k)
    np.testing.assert_array_equal(np_of(got.indices), np_of(want.indices))
    np.testing.assert_allclose(np_of(got.scores), np_of(want.scores), atol=ATOL, rtol=0)
    ids, scores = np_of(got.indices), np_of(got.scores)
    assert ((ids == -1) == np.isneginf(scores)).all()
    if name == "invalid-terms":
        assert (ids[2] == -1).all()
    if name == "offset":
        assert (ids[ids >= 0] >= offset).all()
    if name == "subset-filter":
        for r, allowed in enumerate(subsets):
            hit = ids[r][ids[r] >= 0]
            assert len(hit) and ((allowed < 0).all() or np.isin(doc_subsets[hit], allowed).all())
    if name == "k-above-LP":
        assert np.isneginf(scores[:, 40 * 5:]).all()


def test_equal_impacts_tie_to_the_lowest_doc_id() -> None:
    """Documents with the same terms get the same BM25 total; the top-k lists
    them by ascending id, as JAX's `lax.top_k` does after the id sort."""
    docs = [[1, 2], [3, 4], [1, 2], [5], [1, 2], [1, 2, 2, 2, 2]]
    kw = dict(n_terms=8, max_postings=8)
    jix = jax_sparse.build_sparse_index(docs, **kw)
    tix = build_sparse_index(docs, device=CPU, **kw)
    terms = np.asarray([[1, 2], [2, 1]], np.int32)
    want = jax_sparse.sparse_search(jix, JaxQueries(terms=jnp.asarray(terms)), 5)
    got = sparse_search(tix, SearchQueries(terms=torch.from_numpy(terms)), 5)
    np.testing.assert_array_equal(np_of(got.indices), np_of(want.indices))
    assert np_of(got.indices)[0, :3].tolist() == [0, 2, 4]
    np.testing.assert_allclose(np_of(got.scores), np_of(want.scores), atol=ATOL, rtol=0)


def test_bm25_topk_matches_jax_on_raw_tables() -> None:
    """`bm25_topk` on its own (ids in the table's space, int32-max padding)."""
    jix = jax_sparse.build_sparse_index(_docs(6), n_terms=N_TERMS, max_postings=12)
    terms = _queries(12, b=4, l=3)
    terms[0, 0] = -1
    for k in (5, 50):
        js, jd = jax_sparse.bm25_topk(jix.postings_docs, jix.postings_impacts, jnp.asarray(terms), None, k)
        ts, td = bm25_topk(torch.tensor(np_of(jix.postings_docs)), torch.tensor(np_of(jix.postings_impacts)),
                           torch.from_numpy(terms), None, k)
        np.testing.assert_array_equal(np_of(td), np_of(jd))
        np.testing.assert_allclose(np_of(ts), np_of(js), atol=ATOL, rtol=0)


def test_bm25_scoring_vs_reference_formula() -> None:
    """A numpy brute force of the BM25 formula over every document."""
    docs = [[1, 2, 2, 2], [2, 3, 3], [7, 7, 7, 7], [1, 3, 7], [9]]
    index = build_sparse_index(docs, max_postings=16, device=CPU)
    out = sparse_search(index, SearchQueries(terms=torch.tensor([[2, 3, -1]], dtype=torch.int32)), 5)
    k1, b = 1.2, 0.75
    lens = np.asarray([len(x) for x in docs], dtype=np.float64)

    def bm25(term: int, d: int) -> float:
        tf = docs[d].count(term)
        if tf == 0:
            return 0.0
        df = sum(1 for dd in docs if term in dd)
        idf = np.log(1 + (len(docs) - df + 0.5) / (df + 0.5))
        return idf * tf * (k1 + 1) / (tf + k1 * (1 - b + b * lens[d] / lens.mean()))

    expected = {d: bm25(2, d) + bm25(3, d) for d in range(len(docs))}
    expected = {d: s for d, s in expected.items() if s > 0}
    got = {int(i): float(s) for i, s in zip(np_of(out.indices)[0], np_of(out.scores)[0]) if i >= 0}
    assert set(got) == set(expected)
    for d in expected:
        assert np.isclose(got[d], expected[d], atol=1e-4), (d, got[d], expected[d])


def test_sparse_search_requires_terms_and_builders_default_to_the_card() -> None:
    import inspect

    index = build_sparse_index([[1, 2]], device=CPU)
    with pytest.raises(ValueError, match="terms"):
        sparse_search(index, SearchQueries(vector=torch.zeros(1, 4)), 3)
    for fn in (build_sparse_index, build_sparse_index_native, build_impact_index):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
