"""The port's k-means (`vod_tpu_torch/ops/kmeans.py`) against the JAX package's,
on seeded numpy blobs, f32 on both sides.

Tolerances: assignments equal (the distances differ only by the order of f32
sums, and no row of these blobs lies within that of a tie); centroids within
1e-5. The JAX initial rows are fed to the port as `init`, and each case
asserts that no cluster went empty, so the re-seed draws (which cannot match)
never enter.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_helpers import np_of
from vod_tpu.ops.kmeans import _assign_chunked as jax_assign
from vod_tpu.ops.kmeans import infer_n_clusters as jax_infer
from vod_tpu.ops.kmeans import kmeans as jax_kmeans
from vod_tpu_torch.ops.kmeans import _assign_chunked, infer_n_clusters, kmeans, kmeans_batched

ATOL = 1e-5


def _blobs(seed: int, n: int, d: int, k: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    centers = 4.0 * rng.standard_normal((k, d)).astype(np.float32)
    return (centers[rng.integers(0, k, n)] + rng.standard_normal((n, d)).astype(np.float32)).astype(np.float32)


@pytest.mark.parametrize("chunk", [64, 4096])
def test_assign_chunked_matches_jax(chunk: int) -> None:
    x = _blobs(0, 1000, 8, 16)
    c = np.random.default_rng(1).standard_normal((16, 8)).astype(np.float32)
    want = np_of(jax_assign(jnp.asarray(x), jnp.asarray(c), chunk=chunk))
    got = np_of(_assign_chunked(torch.from_numpy(x), torch.from_numpy(c), chunk=chunk))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def _assert_no_cluster_empties(x: np.ndarray, init: np.ndarray, iters: int) -> None:
    """Every Lloyd iteration from `init` assigns at least one row to each
    cluster, so the re-seed draws never enter."""
    c = torch.from_numpy(init)
    for _ in range(iters + 1):
        a = _assign_chunked(torch.from_numpy(x), c)
        assert np.bincount(np_of(a), minlength=len(init)).min() > 0
        c, _ = kmeans(torch.from_numpy(x), len(init), 1, init=c, generator=torch.Generator().manual_seed(0))


@pytest.mark.parametrize("n, d, k, iters, seed", [(600, 4, 8, 10, 2), (2000, 16, 32, 6, 5), (2000, 16, 16, 6, 2)])
def test_kmeans_with_jax_init_matches_jax(n: int, d: int, k: int, iters: int, seed: int) -> None:
    x = _blobs(seed, n, d, k)
    key = jax.random.PRNGKey(3)
    init_idx = np_of(jax.random.choice(key, n, shape=(k,), replace=False))  # JAX kmeans' own init draw
    _assert_no_cluster_empties(x, x[init_idx], iters)
    jc, ja = jax_kmeans(key, jnp.asarray(x), k, n_iters=iters)
    tc, ta = kmeans(torch.from_numpy(x), k, n_iters=iters, init=torch.from_numpy(x[init_idx]),
                    generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(np_of(tc), np_of(jc), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(np_of(ta), np_of(ja))


def test_kmeans_batched_is_kmeans_per_group() -> None:
    """The batched form (PQ subspaces trained together) gives each group's own
    `kmeans` result from the same init."""
    xs = np.stack([_blobs(s, 500, 3, 8) for s in range(3)])
    init = xs[:, :8].copy()
    cb, ab = kmeans_batched(torch.from_numpy(xs), 8, 5, init=torch.from_numpy(init),
                            generator=torch.Generator().manual_seed(0))
    for i in range(3):
        c, a = kmeans(torch.from_numpy(xs[i]), 8, 5, init=torch.from_numpy(init[i]),
                      generator=torch.Generator().manual_seed(0))
        torch.testing.assert_close(cb[i], c, atol=1e-6, rtol=0)
        assert torch.equal(ab[i], a)


def test_kmeans_reseeds_empty_clusters_from_the_generator() -> None:
    """A duplicated initial centroid leaves a cluster empty: it is re-seeded
    from a row the generator picks (no NaN), and the same seed gives the same
    result."""
    x = _blobs(4, 300, 4, 5)
    init = np.repeat(x[:1], 5, axis=0)  # five equal centroids: four go empty
    out = [kmeans(torch.from_numpy(x), 5, 4, init=torch.from_numpy(init), generator=torch.Generator().manual_seed(7))
           for _ in range(2)]
    assert torch.isfinite(out[0][0]).all()
    assert len(torch.unique(out[0][0], dim=0)) == 5
    assert torch.equal(out[0][0], out[1][0]) and torch.equal(out[0][1], out[1][1])
    with pytest.raises(ValueError, match="Generator"):
        kmeans(torch.from_numpy(x), 5, 1, generator=None)


@pytest.mark.parametrize("n", [1, 10, 1000, 2**20, 10**12])
def test_infer_n_clusters_matches_jax(n: int) -> None:
    assert infer_n_clusters(n) == jax_infer(n)
