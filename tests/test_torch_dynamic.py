"""The port's mutable dense store (`vod_tpu_torch/search/dynamic.py`) against
the JAX package, mirroring `tests/test_dynamic.py`: the same numpy vectors
and the same sequence of adds, deletes, updates and compactions go to both,
with exact selection on both sides (`approx_recall=None` in JAX).

Tolerances: int8 codes, the frozen scale, ids and int8 scores equal exactly
(integer products summed exactly, then one f32 multiply); f32 scores within
1e-6 (sums in other orders) and ids equal wherever neighbouring scores
differ by more than that; bf16 stores within 1e-6 of JAX's f32-accumulated
scores likewise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_helpers import np_of
from vod_tpu.search import dynamic as jd
from vod_tpu.search.base import SearchQueries as JaxQueries
from vod_tpu_torch.search import (
    DynamicDenseIndex,
    SearchQueries,
    dynamic_add,
    dynamic_compact,
    dynamic_delete,
    dynamic_from_dense,
    dynamic_index_init,
    dynamic_search,
    dynamic_update,
)

TOL = 1e-6


def _vecs(rng, n, d=16):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _search(index, q, k=5, subset_ids=None):
    out = dynamic_search(index, SearchQueries(
        vector=torch.from_numpy(q), subset_ids=None if subset_ids is None else torch.as_tensor(subset_ids)), top_k=k)
    return np_of(out.indices), np_of(out.scores)


def _jsearch(index, q, k=5, subset_ids=None):
    out = jd.dynamic_search(index, JaxQueries(
        vector=jnp.asarray(q), subset_ids=None if subset_ids is None else jnp.asarray(subset_ids, jnp.int32)), top_k=k)
    return np_of(out.indices), np_of(out.scores)


def _assert_same(got, want, exact: bool = False):
    (gi, gs), (wi, ws) = got, want
    np.testing.assert_array_equal(np.isfinite(gs), np.isfinite(ws))
    if exact:
        np.testing.assert_array_equal(gs, ws)
        np.testing.assert_array_equal(gi, wi)
        return
    fin = np.isfinite(ws)
    np.testing.assert_allclose(gs[fin], ws[fin], atol=TOL, rtol=0)
    gaps = np.abs(np.diff(np.where(fin, ws, -1e9), axis=1))
    clear = fin.copy()
    clear[:, 1:] &= gaps > TOL
    clear[:, :-1] &= gaps > TOL
    np.testing.assert_array_equal(gi[clear], wi[clear])
    np.testing.assert_array_equal(gi[~fin], wi[~fin])


def _both(x, capacity, dtype="float32"):
    return (dynamic_from_dense(torch.from_numpy(x), capacity=capacity, dtype=dtype),
            jd.dynamic_from_dense(jnp.asarray(x), capacity=capacity, dtype=dtype, approx_recall=None))


def test_add_then_search_matches_bruteforce_and_jax():
    rng = np.random.default_rng(0)
    x = _vecs(rng, 50)
    index, jindex = _both(x, 200)
    assert index.capacity == jindex.capacity == 256 and index.vectors.device.type == "cpu"
    q = _vecs(rng, 4)
    ids, scores = _search(index, q)
    expect = q @ x.T
    for i in range(4):
        best = np.argsort(-expect[i])[:5]
        np.testing.assert_array_equal(ids[i], best)
        np.testing.assert_allclose(scores[i], expect[i, best], rtol=1e-5)
    _assert_same((ids, scores), _jsearch(jindex, q))


def test_incremental_add_visible_and_ids_autoassigned():
    rng = np.random.default_rng(1)
    x = _vecs(rng, 10)
    index = dynamic_index_init(128, 16, dtype="float32", device="cpu")
    index, ids1 = dynamic_add(index, torch.from_numpy(x[:6]))
    assert ids1.tolist() == list(range(6))
    index, ids2 = dynamic_add(index, torch.from_numpy(x[6:]))
    assert ids2.tolist() == list(range(6, 10)) and index.n_active == 10 and index.next_id == 10
    got, _ = _search(index, x, k=1)
    np.testing.assert_array_equal(got[:, 0], np.arange(10))


def test_add_count_masks_invalid_tail():
    rng = np.random.default_rng(2)
    x = _vecs(rng, 8)
    index = dynamic_index_init(128, 16, dtype="float32", device="cpu")
    index, ids = dynamic_add(index, torch.from_numpy(x), count=torch.tensor(5))
    jindex, jids = jd.dynamic_add(jd.dynamic_index_init(128, 16, dtype="float32", approx_recall=None),
                                  jnp.asarray(x), count=jnp.asarray(5))
    np.testing.assert_array_equal(np_of(ids), np_of(jids))
    assert int(index.n_alive) == int(jindex.n_alive) == 5 and index.next_id == int(jindex.next_id) == 5
    got, scores = _search(index, x[6:7], k=8)
    assert (got[0][np.isfinite(scores[0])] < 5).all()


def test_capacity_overflow_drops_not_clobbers_and_counts():
    rng = np.random.default_rng(3)
    x = _vecs(rng, 10)
    index, jindex = _both(x, 128)
    extra = _vecs(rng, 130)
    index, ids = dynamic_add(index, torch.from_numpy(extra))
    jindex, jids = jd.dynamic_add(jindex, jnp.asarray(extra))
    np.testing.assert_array_equal(np_of(ids), np_of(jids))
    assert int((ids == -1).sum()) == 12 and index.n_active == 128 and index.next_id == int(jindex.next_id) == 140
    got, _ = _search(index, x, k=1)
    np.testing.assert_array_equal(got[:, 0], np.arange(10))
    _assert_same(_search(index, extra[:8]), _jsearch(jindex, extra[:8]))


def test_delete_tombstones_and_compact_preserves_ids():
    rng = np.random.default_rng(4)
    x = _vecs(rng, 20)
    index, jindex = _both(x, 128)
    index = dynamic_delete(index, torch.tensor([3, 7, -1, 99], dtype=torch.int32))
    jindex = jd.dynamic_delete(jindex, jnp.asarray([3, 7, -1, 99], jnp.int32))
    np.testing.assert_array_equal(np_of(index.alive), np_of(jindex.alive))
    assert int(index.n_alive) == 18
    got, _ = _search(index, x[[3, 7]], k=3)
    assert 3 not in got[0] and 7 not in got[1]
    before = _search(index, x[:5])
    index2 = dynamic_compact(index)
    jindex2 = jd.dynamic_compact(jindex)
    assert index2.n_active == int(jindex2.n_active) == 18
    for name in ("ids", "alive", "subset_ids"):
        np.testing.assert_array_equal(np_of(getattr(index2, name)), np_of(getattr(jindex2, name)))
    after = _search(index2, x[:5])
    np.testing.assert_array_equal(before[0], after[0])
    _assert_same(after, _jsearch(jindex2, x[:5]))
    y = _vecs(rng, 2)
    index3, new_ids = dynamic_add(index2, torch.from_numpy(y))
    got, _ = _search(index3, y, k=1)
    np.testing.assert_array_equal(got[:, 0], np_of(new_ids))
    assert new_ids.tolist() == [20, 21]


def test_update_overwrites_existing_by_id():
    rng = np.random.default_rng(5)
    x = _vecs(rng, 12)
    index, jindex = _both(x, 128)
    new_vec = _vecs(rng, 3)
    upd = np.asarray([4, 99, -1], np.int32)
    index, found = dynamic_update(index, torch.from_numpy(upd), torch.from_numpy(new_vec),
                                  subset_ids=torch.tensor([7, 7, 7]))
    jindex, jfound = jd.dynamic_update(jindex, jnp.asarray(upd), jnp.asarray(new_vec),
                                       subset_ids=jnp.asarray([7, 7, 7], jnp.int32))
    assert found.tolist() == np_of(jfound).tolist() == [True, False, False]
    np.testing.assert_array_equal(np_of(index.vectors), np_of(jindex.vectors))
    np.testing.assert_array_equal(np_of(index.subset_ids), np_of(jindex.subset_ids))
    got, scores = _search(index, new_vec[:1], k=1)
    assert got[0, 0] == 4 and scores[0, 0] == pytest.approx(1.0, abs=1e-3)
    # a tombstoned id is not updated (qdrant semantics: upsert-on-existing)
    index = dynamic_delete(index, torch.tensor([5], dtype=torch.int32))
    _, found = dynamic_update(index, torch.tensor([5], dtype=torch.int32), torch.from_numpy(new_vec[:1]))
    assert found.tolist() == [False]


def test_subset_filtering_on_dynamic_rows():
    rng = np.random.default_rng(6)
    x = _vecs(rng, 16)
    sub = np.asarray([i % 2 for i in range(16)], np.int32)
    index, _ = dynamic_add(dynamic_index_init(128, 16, dtype="float32", device="cpu"), torch.from_numpy(x),
                           subset_ids=torch.from_numpy(sub))
    jindex, _ = jd.dynamic_add(jd.dynamic_index_init(128, 16, dtype="float32", approx_recall=None), jnp.asarray(x),
                               subset_ids=jnp.asarray(sub))
    allowed = np.ones((4, 1), np.int32)
    ids, scores = _search(index, x[:4], k=8, subset_ids=allowed)
    assert (ids[np.isfinite(scores)] % 2 == 1).all()
    _assert_same((ids, scores), _jsearch(jindex, x[:4], k=8, subset_ids=allowed))


@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
def test_quantized_store_equals_jax(dtype: str):
    """int8 (scale frozen from the first corpus; new rows quantize with it):
    codes and scores equal JAX's exactly. bf16: rows equal, scores within
    the f32 tolerance."""
    rng = np.random.default_rng(7)
    x = _vecs(rng, 60)
    index, jindex = _both(x, 256, dtype=dtype)
    y = _vecs(rng, 4) * 1.5  # beyond the frozen scale: clipped at +-127
    index, ids = dynamic_add(index, torch.from_numpy(y))
    jindex, _ = jd.dynamic_add(jindex, jnp.asarray(y))
    if dtype == "int8":
        np.testing.assert_array_equal(np_of(index.scale), np_of(jindex.scale))
    np.testing.assert_array_equal(np_of(index.vectors.float()), np_of(jnp.asarray(jindex.vectors, jnp.float32)))
    got, scores = _search(index, y / 1.5, k=1)
    np.testing.assert_array_equal(got[:, 0], np_of(ids))
    assert (scores[:, 0] > 0.9).all()
    q = _vecs(rng, 8)
    _assert_same(_search(index, q, k=10), _jsearch(jindex, q, k=10), exact=dtype == "int8")


def test_ops_keep_counts_on_the_host_and_searching_scans_written_slots():
    """The port's counts are Python ints; a search scans only the slots ever
    written (the rest are dead) and still returns -1 / -inf past the live rows."""
    rng = np.random.default_rng(8)
    index = dynamic_index_init(256, 16, dtype="float32", device="cpu")
    for _ in range(4):
        index, _ = dynamic_add(index, torch.from_numpy(_vecs(rng, 8)))
    assert isinstance(index, DynamicDenseIndex) and index.n_active == 32 and int(index.n_alive) == 32
    ids, scores = _search(index, _vecs(rng, 2), k=40)
    assert (ids[:, 32:] == -1).all() and np.isneginf(scores[:, 32:]).all()
    with pytest.raises(ValueError, match="frozen"):
        dynamic_index_init(128, 16, dtype="int8", device="cpu")
