"""The port's sharded MaxSim rerank (`vod_tpu_torch/search/sharded.py:
sharded_maxsim_rerank`) at W = 2 and 4 against JAX's and against the
unsharded `maxsim_rerank`, exactly.

JAX builds each store once and runs its `shard_map` rerank on the root
conftest's 8-device virtual CPU mesh; the port shards a copy of the same
store over W CPU ranks of one gloo group (one group per W). Candidates mix
rows of every shard, repeats and -1 padding; 45 rows split into blocks of
23 or 12, so the last shard is short. Each score is one owner's, so the
sharded rerank equals the port's unsharded one bit for bit. Against JAX:
the int8 codec equal bit for bit (exact integer products on both sides);
with a projection (`proj_dim`) or the f32 codec within 1e-6 relative, since
the f32 products `q @ proj` and the f32 interaction sum in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from tests.torch_helpers import job_sequence, job_sharded_maxsim, run_ranks
from vod_tpu.search.maxsim import build_maxsim_index as jax_build
from vod_tpu.search.sharded import shard_maxsim_index as jax_shard
from vod_tpu.search.sharded import sharded_maxsim_rerank as jax_rerank

N, LT, D, B, LQ, C = 45, 6, 16, 4, 5, 12
WORLDS = (2, 4)
CODECS = {"int8": dict(codec="int8"), "int8-pca": dict(codec="int8", proj_dim=8), "f32": dict(codec="float32")}


def _data():
    rng = np.random.default_rng(5)
    tokens = rng.standard_normal((N, LT, D)).astype(np.float32)
    mask = rng.random((N, LT)) < 0.8
    mask[7] = False  # a doc with no real token scores 0
    q = rng.standard_normal((B, LQ, D)).astype(np.float32)
    qm = rng.random((B, LQ)) < 0.9
    cand = rng.integers(0, N, (B, C)).astype(np.int32)
    cand[:, -2:] = -1
    cand[0, :3] = [N - 1, 0, 7]
    cand[1, 1] = cand[1, 0]
    return tokens, mask, q, qm, cand


@pytest.fixture(scope="module")
def stores() -> dict:
    tokens, mask, *_ = _data()
    return {name: jax_build(jnp.asarray(tokens), jnp.asarray(mask), **kw) for name, kw in CODECS.items()}


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"W{w}")
def ranks(request, tmp_path_factory, stores: dict) -> dict:
    _, _, q, qm, cand = _data()
    calls = [(job_sharded_maxsim, ({k: (np.asarray(v) if hasattr(v, "shape") else v)
                                    for k, v in vars(stores[name]).items()}, q, qm, cand)) for name in CODECS]
    out = run_ranks(job_sequence, request.param, tmp_path_factory.mktemp(f"smax{request.param}"), calls)
    return {"w": request.param, **{name: [rank[i] for rank in out] for i, name in enumerate(CODECS)}}


@pytest.mark.parametrize("name", list(CODECS))
def test_sharded_maxsim_equals_jax_and_the_unsharded_rerank(ranks: dict, stores: dict, name: str) -> None:
    from vod_tpu.search.maxsim import maxsim_rerank as jax_plain

    w = ranks["w"]
    _, _, q, qm, cand = _data()
    args = (jnp.asarray(q), jnp.asarray(qm), jnp.asarray(cand))
    mesh = Mesh(np.array(jax.devices()[:w]), ("shard",))
    want = np.asarray(jax_rerank(jax_shard(stores[name], mesh, axis="shard"), *args))
    np.testing.assert_array_equal(want, np.asarray(jax_plain(stores[name], *args)))
    for r in ranks[name]:
        np.testing.assert_array_equal(r["sharded"], r["plain"])
        if name == "int8":
            np.testing.assert_array_equal(r["sharded"], want)
        else:
            np.testing.assert_array_equal(np.isfinite(r["sharded"]), np.isfinite(want))
            fin = np.isfinite(want)
            np.testing.assert_allclose(r["sharded"][fin], want[fin], rtol=1e-6, atol=0)
        assert r["rows"] == -(-N // w)
    assert np.isneginf(want[:, -2:]).all() and want[0, 2] == 0.0
