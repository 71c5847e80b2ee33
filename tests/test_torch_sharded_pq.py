"""The port's sharded PQ search (`vod_tpu_torch/search/sharded.py:
sharded_pq_search`) against JAX's at W = 2 and 4 shards, every mode.

JAX builds each index once and runs its `shard_map` search on the root
conftest's 8-device virtual CPU mesh; the port shards a copy of the same
index (`models/convert.py:dense_index_from_fields`) over W CPU ranks of one
gloo group (`tests/torch_helpers.py:run_ranks`), all cases of one W in one
group. 700 rows re-pad to 768 (W = 2: 384 a shard) or 1024 (W = 4: 256 a
shard, the last holding padding only), so every W has a shard with fewer
real rows than k.

Tolerances: ids equal and scores within 1e-5 (f32 products and sums in
other orders; int8 products exact on both sides). JAX's indexes are built
with `approx_recall=None` (exact selection, as the port's) except in the
"shares" case, where both sides keep the same proportional per-chunk share
and JAX's `approx_max_k` is exact on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from tests.torch_helpers import job_sequence, job_sharded_engine, run_ranks, unit_rows
from vod_tpu.search import SearchQueries as JaxQueries
from vod_tpu.search.dense import build_pq_index as jax_build_pq
from vod_tpu.search.sharded import shard_pq_index as jax_shard_pq
from vod_tpu.search.sharded import sharded_pq_search as jax_sharded_pq

N, D, B, K = 700, 32, 6, 10
WORLDS = (2, 4)
_EXACT = dict(approx_recall=None)


def _data():
    rng = np.random.default_rng(3)
    x = unit_rows(rng, N, D)
    q = unit_rows(rng, B, D)
    subsets = (np.arange(N) % 4).astype(np.int32)
    allowed = np.array([[1, -1], [0, 2], [-1, -1], [3, 3], [2, -1], [0, 1]], np.int32)
    corpus = (np.arange(N) % 3).astype(np.int32)
    route = np.array([0, 1, 2, -1, 1, 0], np.int32)
    return x, q, subsets, allowed, corpus, route


def _cases() -> dict:
    """name -> (build kwargs, query fields, shard kwargs, batch axis)."""
    x, q, subsets, allowed, corpus, route = _data()
    base = dict(n_subquantizers=8, kmeans_iters=2)
    plain = dict(vector=q)
    return {
        "adc8": (dict(base, coarse_dim=None, **_EXACT), plain, {}, None),
        "adc4-refine-int8-pca": (dict(base, coarse_dim=None, code_bits=4, refine="int8", refine_dim=16, k_factor=8,
                                      **_EXACT), plain, {}, None),
        "adc8-refine-int8": (dict(base, coarse_dim=None, refine="int8", **_EXACT), plain, {}, None),
        "adc8-refine-f32": (dict(base, coarse_dim=None, refine="float32", **_EXACT), plain, {}, None),
        "coarse-adc": (dict(base, coarse_dim=12, n_candidates=200, **_EXACT), plain, {}, None),
        "coarse-adc-refine": (dict(base, coarse_dim=12, n_candidates=300, refine="int8", k_factor=2, **_EXACT), plain,
                              {}, None),
        "direct": (dict(base, coarse_dim=12, refine="int8", keep_codes=False, k_factor=4, **_EXACT), plain, {}, None),
        "shares": (dict(base, coarse_dim=12, n_candidates=200, refine="int8", k_factor=8), plain, {}, None),
        "subset": (dict(base, coarse_dim=12, n_candidates=200, subset_ids=subsets, **_EXACT),
                   dict(vector=q, subset_ids=allowed), {}, None),
        "route": (dict(base, coarse_dim=None, refine="int8", **_EXACT), dict(vector=q, shard=route),
                  dict(corpus_shard=corpus), None),
        "split": (dict(base, coarse_dim=None, code_bits=4, refine="int8", refine_dim=16, k_factor=8, **_EXACT), plain,
                  {}, "shard"),
    }


@pytest.fixture(scope="module")
def jax_indexes() -> dict:
    x = _data()[0]
    out = {}
    for name, (kw, _, _, _) in _cases().items():
        kw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
        out[name] = jax_build_pq(jax.random.PRNGKey(7), jnp.asarray(x), **kw)
    return out


def _fields(index) -> dict:
    return {k: (np.asarray(v) if hasattr(v, "shape") else v) for k, v in vars(index).items()}


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"W{w}")
def ranks(request, tmp_path_factory, jax_indexes: dict) -> dict:
    w = request.param
    names, calls = [], []
    for name, (_, q, shard_kw, batch_axis) in _cases().items():
        names.append(name)
        calls.append((job_sharded_engine, ("pq", _fields(jax_indexes[name]), "shard", q, K, batch_axis, shard_kw)))
    out = run_ranks(job_sequence, w, tmp_path_factory.mktemp(f"spq{w}"), calls)
    return {"w": w, **{name: [rank[i] for rank in out] for i, name in enumerate(names)}}


def _jax_answer(jax_indexes: dict, name: str, w: int):
    _, q, shard_kw, _ = _cases()[name]
    mesh = Mesh(np.array(jax.devices()[:w]), ("shard",))
    kw = {k: jnp.asarray(v) for k, v in shard_kw.items()}
    ix = jax_shard_pq(jax_indexes[name], mesh, axis="shard", **kw)
    r = jax_sharded_pq(ix, JaxQueries(**{k: jnp.asarray(v) for k, v in q.items()}), K)
    return ix, np.asarray(r.scores), np.asarray(r.indices)


@pytest.mark.parametrize("name", list(_cases()))
def test_sharded_pq_matches_jax(ranks: dict, jax_indexes: dict, name: str) -> None:
    w = ranks["w"]
    jix, want_s, want_i = _jax_answer(jax_indexes, name, w)
    results = ranks[name]
    if name == "split":  # each rank answered its block of the rows
        got_s = np.concatenate([r["scores"] for r in results])
        got_i = np.concatenate([r["ids"] for r in results])
        if B % w:
            got_s, got_i = results[0]["scores"], results[0]["ids"]
    else:
        got_s, got_i = results[0]["scores"], results[0]["ids"]
        for r in results[1:]:  # every rank holds the merged answer
            np.testing.assert_array_equal(r["ids"], got_i)
            np.testing.assert_array_equal(r["scores"], got_s)
    fin = np.isfinite(want_s)
    np.testing.assert_array_equal(np.isfinite(got_s), fin, err_msg=name)
    np.testing.assert_allclose(got_s[fin], want_s[fin], atol=1e-5, rtol=0, err_msg=name)
    np.testing.assert_array_equal(got_i, want_i, err_msg=name)
    # the shards' rows and this rank's block equal JAX's slice
    assert {r["meta"]["rows_per_shard"] for r in results} == {jix.rows_per_shard}
    store = "codes" if jix.codes is not None else "coarse_codes"
    want_rows = np.asarray(getattr(jix, store)).reshape(w, jix.rows_per_shard, -1)
    for rank, r in enumerate(results):
        got = r["arrays"][store]
        np.testing.assert_array_equal(got[:, : want_rows.shape[-1]], want_rows[rank], err_msg=store)


def test_a_shard_of_padding_only_and_short_shards_still_merge(ranks: dict) -> None:
    """W = 4: the last shard holds no real row and gathers k (-inf, -1)
    pairs like the others; W = 2: the last shard has fewer real rows than
    rows_per_shard. The answers still have k real rows each."""
    for name in ("adc8", "direct", "coarse-adc"):
        for r in ranks[name]:
            assert r["ids"].shape == (B, K) and (r["ids"] >= 0).all() and (r["ids"] < N).all()
    rows = ranks["adc8"][0]["meta"]["rows_per_shard"]
    assert rows * ranks["w"] - N >= (rows if ranks["w"] == 4 else 1)


def test_sharded_pq_keeps_the_unsharded_answer_where_the_pools_agree(ranks: dict, jax_indexes: dict) -> None:
    """Exhaustive ADC without refine selects the same k as the unsharded scan."""
    from vod_tpu.search.dense import pq_search as jax_pq

    _, q, _, _ = _cases()["adc8"]
    want = jax_pq(jax_indexes["adc8"], JaxQueries(vector=jnp.asarray(q["vector"])), K)
    np.testing.assert_array_equal(ranks["adc8"][0]["ids"], np.asarray(want.indices))
    np.testing.assert_array_equal(ranks["adc8"][0]["plain"][1], np.asarray(want.indices))
