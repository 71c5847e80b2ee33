"""`build_dense_index` + `dense_search` in the port against the JAX package.

Flat f32 and int8 indexes, scan and fused kernel, exact-f32 refine, id offset
and padded rows (shapes of `tests/test_topk.py`). On the CPU the JAX scan's
`approx_max_k` is exact, and so is the port's scan, so ids must be equal;
scores agree within 1e-5 (f32 sums in another order). int8 scores go through
the same integer sums and the same f32 scale, so they agree to 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_helpers import CPU, np_of, unit_rows
from vod_tpu.search import SearchQueries as JaxQueries
from vod_tpu.search import build_dense_index as jax_build
from vod_tpu.search.dense import dense_search as jax_search
from vod_tpu_torch.search import SearchQueries, build_dense_index, dense_search

ATOL = 1e-5


def _search_both(v, q, top_k, *, subset_ids=None, allowed=None, **build_kw):
    jix = jax_build(
        jnp.asarray(v), subset_ids=None if subset_ids is None else jnp.asarray(subset_ids), **build_kw
    )
    tix = build_dense_index(v, subset_ids=subset_ids, device="cpu", **build_kw)
    jq = JaxQueries(vector=jnp.asarray(q), subset_ids=None if allowed is None else jnp.asarray(allowed))
    tq = SearchQueries(
        vector=torch.from_numpy(q), subset_ids=None if allowed is None else torch.from_numpy(allowed)
    )
    return jax_search(jix, jq, top_k=top_k), dense_search(tix, tq, top_k=top_k), tix


@pytest.mark.parametrize("kernel", ["scan", "fused"])
@pytest.mark.parametrize("refine", ["none", "float32"])
def test_flat_f32_matches_jax(kernel: str, refine: str) -> None:
    rng = np.random.default_rng(5)
    n, d, b, k = 700, 32, 5, 5  # n pads to 1024 (fused) or 768 (scan)
    v = rng.normal(size=(n, d)).astype("float32")
    q = rng.normal(size=(b, d)).astype("float32")
    j, t, tix = _search_both(v, q, k, dtype="float32", kernel=kernel, refine=refine, offset=100)
    assert tix.vectors.shape[0] == (1024 if kernel == "fused" else 768) and tix.n_real == n
    assert np.array_equal(np_of(j.indices), np_of(t.indices))
    np.testing.assert_allclose(np_of(t.scores), np_of(j.scores), atol=ATOL, rtol=0)
    assert np_of(t.indices).min() >= 100 and np_of(t.indices).max() < n + 100


@pytest.mark.parametrize("kernel", ["scan", "fused"])
def test_int8_matches_jax(kernel: str) -> None:
    rng = np.random.default_rng(9)
    n, d, b, k = 600, 64, 8, 5
    v = unit_rows(rng, n, d)
    q = (v[rng.integers(0, n, b)] + 0.03 * rng.normal(size=(b, d))).astype("float32")
    j, t, tix = _search_both(v, q, k, dtype="int8", kernel=kernel)
    assert tix.vectors.dtype == torch.int8 and tix.scale.shape == (1, d)
    assert np.array_equal(np_of(j.indices), np_of(t.indices))
    np.testing.assert_allclose(np_of(t.scores), np_of(j.scores), atol=1e-6, rtol=0)


def test_int8_with_refine_matches_jax() -> None:
    rng = np.random.default_rng(11)
    v = unit_rows(rng, 900, 32)
    q = v[:6] + 0.05 * rng.normal(size=(6, 32)).astype("float32")
    j, t, _ = _search_both(v, q, 4, dtype="int8", kernel="fused", refine="float32", offset=7)
    assert np.array_equal(np_of(j.indices), np_of(t.indices))
    np.testing.assert_allclose(np_of(t.scores), np_of(j.scores), atol=ATOL, rtol=0)


def test_bf16_fused_with_refine_and_wide_bins_matches_jax() -> None:
    """The served configuration at toy size: bf16 store, fused kernel at 1024
    bins, exact-f32 re-rank of a 4k pool."""
    rng = np.random.default_rng(12)
    v = unit_rows(rng, 3000, 48)
    q = v[rng.integers(0, 3000, 8)] + 0.1 * rng.normal(size=(8, 48)).astype("float32")
    jix = jax_build(jnp.asarray(v), dtype="bfloat16", kernel="fused", refine="float32")
    jix = jix.replace(fused_bins=1024, fused_qblock=1024)
    tix = build_dense_index(v, dtype="bfloat16", kernel="fused", refine="float32", device=CPU)
    tix = tix.replace(fused_bins=1024)
    j = jax_search(jix, JaxQueries(vector=jnp.asarray(q)), top_k=10)
    t = dense_search(tix, SearchQueries(vector=torch.from_numpy(q)), top_k=10)
    assert np.array_equal(np_of(j.indices), np_of(t.indices))
    np.testing.assert_allclose(np_of(t.scores), np_of(j.scores), atol=ATOL, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_subset_filter_takes_the_scan(dtype: str) -> None:
    """A subset filter on a fused index runs the exact scan, as in JAX."""
    rng = np.random.default_rng(13)
    n, d = 400, 16
    v = rng.normal(size=(n, d)).astype("float32")
    q = rng.normal(size=(3, d)).astype("float32")
    subsets = (np.arange(n) % 3).astype("int32")
    allowed = np.asarray([[1, -1], [0, 2], [-1, -1]], dtype=np.int32)
    j, t, _ = _search_both(v, q, 6, dtype=dtype, kernel="fused", subset_ids=subsets, allowed=allowed)
    ids = np_of(t.indices)
    assert np.array_equal(np_of(j.indices), ids)
    np.testing.assert_allclose(np_of(t.scores), np_of(j.scores), atol=ATOL, rtol=0)
    assert (subsets[ids[0]] == 1).all() and np.isin(subsets[ids[1]], [0, 2]).all()


def test_exact_request_takes_the_scan() -> None:
    """approx_recall=None asks for exact selection: the fused index scans, and
    agrees with brute force."""
    rng = np.random.default_rng(14)
    v = rng.normal(size=(2048, 16)).astype("float32")
    q = rng.normal(size=(4, 16)).astype("float32")
    tix = build_dense_index(v, dtype="float32", kernel="fused", approx_recall=None, device="cpu")
    out = dense_search(tix, SearchQueries(vector=torch.from_numpy(q)), top_k=20)
    exact = np.argsort(-(q @ v.T), axis=-1, kind="stable")[:, :20]
    assert np.array_equal(np_of(out.indices), exact)


def test_build_rejects_unknown_options() -> None:
    v = np.zeros((8, 4), np.float32)
    with pytest.raises(ValueError, match="refine"):
        build_dense_index(v, refine="int8", device="cpu")
    with pytest.raises(ValueError, match="dtype"):
        build_dense_index(v, dtype="float16", device="cpu")
    with pytest.raises(ValueError, match="kernel"):
        build_dense_index(v, kernel="pallas", device="cpu")
