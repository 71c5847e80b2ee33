"""normalize_scores, merge_search_results, RetrievalBatch, quantize_int8 and
hybrid_search (dense + lookup) in the port against the JAX package.

Merging is exact arithmetic on the same inputs (sums of at most three f32
values in the same order), so ids, labels and NaN channels are equal and
scores agree to 1e-6; the hybrid search goes through the f32 scan and is
held to 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_helpers import np_of
from vod_tpu.ops.merge import merge_search_results as jax_merge
from vod_tpu.ops.numpy_ops import normalize_scores as jax_normalize
from vod_tpu.ops.pq import quantize_int8 as jax_quantize
from vod_tpu.search import HybridEngines as JaxEngines
from vod_tpu.search import SearchQueries as JaxQueries
from vod_tpu.search import build_dense_index as jax_build
from vod_tpu.search import hybrid_search as jax_hybrid
from vod_tpu.types.retrieval import RetrievalBatch as JaxBatch
from vod_tpu_torch.ops.merge import merge_search_results
from vod_tpu_torch.ops.numpy_ops import masked_log_softmax, normalize_scores, topk_lowest_first
from vod_tpu_torch.ops.pq import quantize_int8
from vod_tpu_torch.search import HybridEngines, SearchQueries, build_dense_index, hybrid_search
from vod_tpu_torch.types.retrieval import RetrievalBatch, stack_samples


def _engine_results(seed: int, b: int = 3, widths=(6, 4, 5), with_labels=(False, True, False)):
    """Per-engine numpy results with shared ids, -1/-inf padding and labels."""
    rng = np.random.default_rng(seed)
    out = {}
    for e, (w, lab) in enumerate(zip(widths, with_labels)):
        ids = rng.integers(0, 10, size=(b, w)).astype(np.int32)
        for r in range(b):  # ids are unique within one engine's row
            ids[r] = rng.permutation(10)[:w]
        scores = rng.normal(size=(b, w)).astype(np.float32)
        pad = rng.random((b, w)) < 0.2
        ids[pad] = -1
        scores[pad] = -np.inf
        labels = np.where(pad, -1, rng.integers(0, 2, size=(b, w))).astype(np.int32) if lab else None
        out[f"e{e}"] = (scores, ids, labels)
    return out


def _as_jax(parts):
    return {
        n: JaxBatch(scores=jnp.asarray(s), indices=jnp.asarray(i), labels=None if l is None else jnp.asarray(l))
        for n, (s, i, l) in parts.items()
    }


def _as_torch(parts):
    return {
        n: RetrievalBatch(
            scores=torch.from_numpy(s), indices=torch.from_numpy(i),
            labels=None if l is None else torch.from_numpy(l),
        )
        for n, (s, i, l) in parts.items()
    }


def test_normalize_scores_matches_jax() -> None:
    x = np.asarray(
        [[3.0, -np.inf, 1.0, 2.5], [-np.inf, -np.inf, -np.inf, -np.inf], [-2.0, 5.0, -np.inf, 0.0]],
        dtype=np.float32,
    )
    for offset in (0.0, 1.5):
        j = np_of(jax_normalize(jnp.asarray(x), offset=offset))
        t = np_of(normalize_scores(torch.from_numpy(x), offset=offset))
        np.testing.assert_array_equal(t, j)
    assert np.isneginf(np_of(normalize_scores(torch.from_numpy(x)))[1]).all()  # all-padding row kept


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merge_matches_jax(seed: int) -> None:
    parts = _engine_results(seed)
    weights = {"e0": 1.0, "e1": 0.5, "e2": 2.0}
    jm, jraw = jax_merge(_as_jax(parts), weights)
    tm, traw = merge_search_results(_as_torch(parts), weights)
    assert np.array_equal(np_of(jm.indices), np_of(tm.indices))
    assert np.array_equal(np_of(jm.labels), np_of(tm.labels))
    np.testing.assert_allclose(np_of(tm.scores), np_of(jm.scores), atol=1e-6, rtol=0)
    assert set(traw) == set(jraw)
    for n in jraw:  # raw channels: NaN exactly where the engine did not return the id
        np.testing.assert_array_equal(np.isnan(np_of(traw[n])), np.isnan(np_of(jraw[n])))
        np.testing.assert_allclose(np_of(traw[n]), np_of(jraw[n]), atol=1e-6, rtol=0, equal_nan=True)


def test_merge_without_labels_and_missing_weight() -> None:
    parts = _engine_results(3, with_labels=(False, False, False))
    tm, _ = merge_search_results(_as_torch(parts))
    jm, _ = jax_merge(_as_jax(parts))
    assert tm.labels is None and jm.labels is None
    assert np.array_equal(np_of(jm.indices), np_of(tm.indices))
    with pytest.raises(ValueError, match="Missing weights"):
        merge_search_results(_as_torch(parts), {"e0": 1.0})


def test_retrieval_batch_ops_match_jax() -> None:
    rng = np.random.default_rng(4)
    s = rng.normal(size=(2, 6)).astype(np.float32)
    s[0, 2] = s[0, 4] = 0.5  # a tie: lowest position first
    s[1, 5] = -np.inf
    i = np.arange(12, dtype=np.int32).reshape(2, 6)
    jb, tb = JaxBatch(scores=jnp.asarray(s), indices=jnp.asarray(i)), RetrievalBatch(
        scores=torch.from_numpy(s), indices=torch.from_numpy(i)
    )
    for jo, to in ((jb.sorted(), tb.sorted()), (jb.topk(4), tb.topk(4)), (jb * 0.0, tb * 0.0)):
        assert np.array_equal(np_of(jo.indices), np_of(to.indices))
        np.testing.assert_array_equal(np_of(to.scores), np_of(jo.scores))
    ja, ta = jb + jb, tb + tb
    assert np.array_equal(np_of(ja.indices), np_of(ta.indices))
    np.testing.assert_array_equal(np_of(ta.scores), np_of(ja.scores))
    one = RetrievalBatch(scores=torch.from_numpy(s[1, :2]), indices=torch.from_numpy(i[1, :2]))
    stacked = stack_samples([RetrievalBatch(scores=s[0], indices=i[0]), one], k=3)
    assert stacked.scores.shape == (2, 3) and stacked.indices.tolist() == [[0, 1, 2], [6, 7, -1]]


def test_topk_lowest_first_orders_ties_like_lax_top_k() -> None:
    import jax

    x = np.asarray([[1.0, 3.0, 3.0, -np.inf, 3.0, 2.0]], dtype=np.float32)
    js, ji = jax.lax.top_k(jnp.asarray(x), 5)
    ts, ti = topk_lowest_first(torch.from_numpy(x), 5)
    assert np_of(ti).tolist() == np_of(ji).tolist() == [[1, 2, 4, 5, 0]]
    np.testing.assert_array_equal(np_of(ts), np_of(js))


def test_masked_log_softmax_handles_padding() -> None:
    from vod_tpu.ops.numpy_ops import masked_log_softmax as jax_mls

    x = np.asarray([[1.0, np.nan, -np.inf, 2.0], [-np.inf] * 4], dtype=np.float32)
    j = np_of(jax_mls(jnp.asarray(x)))
    t = np_of(masked_log_softmax(torch.from_numpy(x)))
    np.testing.assert_allclose(t, j, atol=1e-6, rtol=0)


def test_numpy_ops_match_jax() -> None:
    """The rest of `ops/numpy_ops.py`: masked logsumexp, gathers by id, NaN
    filling, and padding-id replacement (random ids: only the contract is checked)."""
    import vod_tpu.ops.numpy_ops as jops
    import vod_tpu_torch.ops.numpy_ops as tops

    rng = np.random.default_rng(7)
    x = rng.normal(size=(3, 6)).astype(np.float32)
    x[0, 1], x[1, :] = np.nan, -np.inf
    mask = rng.random((3, 6)) < 0.7
    j = np_of(jops.masked_logsumexp(jnp.asarray(x), jnp.asarray(mask)))
    t = np_of(tops.masked_logsumexp(torch.from_numpy(x), torch.from_numpy(mask)))
    np.testing.assert_allclose(t, j, atol=1e-6, rtol=0)
    np.testing.assert_allclose(
        np_of(tops.masked_softmax(torch.from_numpy(x))), np_of(jops.masked_softmax(jnp.asarray(x))), atol=1e-6
    )
    np.testing.assert_array_equal(
        np_of(tops.fill_nans_with_min(torch.from_numpy(x))), np_of(jops.fill_nans_with_min(jnp.asarray(x)))
    )
    queries = rng.integers(0, 8, size=(3, 4)).astype(np.int32)
    keys = rng.integers(0, 8, size=(3, 5)).astype(np.int32)
    values = rng.normal(size=(3, 5)).astype(np.float32)
    for k_, v_ in ((keys, values), (keys[0], values[0]), (keys, keys)):
        j = np_of(jops.gather_values_by_indices(jnp.asarray(queries), jnp.asarray(k_), jnp.asarray(v_)))
        t = np_of(tops.gather_values_by_indices(torch.from_numpy(queries), torch.from_numpy(k_), torch.from_numpy(v_)))
        np.testing.assert_array_equal(t, j)
    ids = np.asarray([[3, -1, 5, -1]], dtype=np.int32)
    out = np_of(tops.replace_negative_indices(torch.from_numpy(ids), 10, torch.Generator().manual_seed(0)))
    assert out[0, 0] == 3 and out[0, 2] == 5 and ((out >= 0) & (out < 10)).all()


def test_quantize_int8_matches_jax() -> None:
    rng = np.random.default_rng(5)
    x = rng.normal(size=(50, 12)).astype(np.float32)
    x[:, 3] = 0.0  # an all-zero column takes the 1e-8 floor
    x[:4, 5] = [2.54, 0.5 * 2.54 / 127, 1.5 * 2.54 / 127, -2.5 * 2.54 / 127]  # halves round to even
    jc, js = jax_quantize(jnp.asarray(x), axis=0)
    tc, ts = quantize_int8(torch.from_numpy(x), dim=0)
    np.testing.assert_array_equal(np_of(tc), np_of(jc))
    np.testing.assert_array_equal(np_of(ts), np_of(js))


@pytest.mark.parametrize("kernel", ["scan", "fused"])
def test_hybrid_dense_and_lookup_match_jax(kernel: str) -> None:
    rng = np.random.default_rng(6)
    n, d, b, k = 300, 16, 4, 8
    corpus = rng.normal(size=(n, d)).astype(np.float32)
    q = corpus[:b] + 0.01
    gold = np.asarray([[42, -1], [7, 8], [-1, -1], [3, 0]], dtype=np.int32)
    jeng = JaxEngines(dense=jax_build(jnp.asarray(corpus), dtype="float32", kernel=kernel))
    teng = HybridEngines(dense=build_dense_index(corpus, dtype="float32", kernel=kernel, device="cpu"))
    weights = {"dense": 1.0, "lookup": 0.3}
    jm, jraw = jax_hybrid(jeng, JaxQueries(vector=jnp.asarray(q), section_ids=jnp.asarray(gold)), k, weights)
    tm, traw = hybrid_search(
        teng, SearchQueries(vector=torch.from_numpy(q), section_ids=torch.from_numpy(gold)), k, weights
    )
    assert np.array_equal(np_of(jm.indices), np_of(tm.indices))
    assert np.array_equal(np_of(jm.labels), np_of(tm.labels))
    np.testing.assert_allclose(np_of(tm.scores), np_of(jm.scores), atol=1e-5, rtol=0)
    assert set(traw) == set(jraw) == {"dense"}
    np.testing.assert_allclose(np_of(traw["dense"]), np_of(jraw["dense"]), atol=1e-5, equal_nan=True)
    ids, labels = np_of(tm.indices), np_of(tm.labels)
    for r in range(b):  # gold ids come back with label 1
        for g in gold[r][gold[r] >= 0]:
            assert labels[r][ids[r].tolist().index(g)] == 1


def test_hybrid_rejects_engines_not_ported() -> None:
    q = SearchQueries(vector=torch.zeros(1, 4), terms=torch.zeros(1, 2, dtype=torch.int32))
    with pytest.raises(NotImplementedError, match="sparse"):
        hybrid_search(HybridEngines(sparse=object()), q, 3)
    with pytest.raises(NotImplementedError):
        hybrid_search(HybridEngines(dense=object()), q, 3)
    with pytest.raises(ValueError, match="No engine"):
        hybrid_search(HybridEngines(), SearchQueries(), 3)
