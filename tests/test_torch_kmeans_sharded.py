"""The port's `kmeans_sharded` (`vod_tpu_torch/ops/kmeans.py`) at W = 2 and
4 ranks against JAX's `kmeans_sharded` from a warm start, and against the
port's unsharded `kmeans` from one generator state, a re-seed included.

JAX runs on the root conftest's 8-device virtual CPU mesh; the port on W
CPU ranks of one gloo group (`tests/torch_helpers.py:run_ranks`). The two
packages draw their re-seeds differently (ROADMAP §C, "Random draws"), so
the JAX comparison starts both from the same rows (`init`) on data where
no cluster goes empty. Tolerances: centroids within 1e-5 (the segment sums
meet in other orders: a few ulps), assignments equal (no row lies on a tie
at these seeds).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from tests.torch_helpers import job_kmeans_sharded, job_sequence, run_ranks, unit_rows
from vod_tpu.ops.kmeans import kmeans_sharded as jax_kmeans_sharded

N, D, K, ITERS = 203, 8, 6, 5
WORLDS = (2, 4)


def _data():
    rng = np.random.default_rng(2)
    centres = unit_rows(rng, K, D) * 3
    x = (centres[np.arange(N) % K] + 0.3 * rng.standard_normal((N, D))).astype(np.float32)
    warm = x[:K].copy()
    # a duplicate initial centroid wins no row (ties go to the first): it goes empty and is re-seeded
    dup = x[:K].copy()
    dup[3] = dup[2]
    return x, warm, dup


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"W{w}")
def ranks(request, tmp_path_factory) -> dict:
    x, warm, dup = _data()
    calls = [(job_kmeans_sharded, (x, K, warm, 0, ITERS)), (job_kmeans_sharded, (x, K, dup, 1, ITERS)),
             (job_kmeans_sharded, (x, K, None, 2, ITERS))]
    out = run_ranks(job_sequence, request.param, tmp_path_factory.mktemp(f"km{request.param}"), calls)
    return {"w": request.param, "warm": [r[0] for r in out], "reseed": [r[1] for r in out],
            "drawn": [r[2] for r in out]}


def test_warm_start_matches_jax(ranks: dict) -> None:
    x, warm, _ = _data()
    mesh = Mesh(np.array(jax.devices()[: ranks["w"]]), ("shard",))
    c, a = jax_kmeans_sharded(jax.random.PRNGKey(0), jnp.asarray(x), K, mesh, n_iters=ITERS, init=jnp.asarray(warm))
    for r in ranks["warm"]:
        np.testing.assert_allclose(r["centroids"], np.asarray(c), atol=1e-5, rtol=0)
        np.testing.assert_array_equal(r["assign"], np.asarray(a))
        assert np.bincount(r["assign"], minlength=K).min() > 0  # no cluster empty: the draws never mattered


@pytest.mark.parametrize("case", ["warm", "reseed", "drawn"])
def test_sharded_equals_unsharded_from_one_generator_state(ranks: dict, case: str) -> None:
    """The initial rows and the re-seed rows are drawn in `kmeans`'s order,
    so the sharded run follows the unsharded one, a re-seeded cluster too."""
    got = ranks[case]
    for r in got:
        np.testing.assert_allclose(r["centroids"], r["plain_centroids"], atol=1e-5, rtol=0)
        np.testing.assert_array_equal(r["assign"], r["plain_assign"])
        np.testing.assert_array_equal(r["centroids"], got[0]["centroids"])  # the same on every rank
    if case == "reseed":
        _, _, dup = _data()
        assert not np.allclose(got[0]["centroids"][3], got[0]["centroids"][2])  # cluster 3 came back
