"""The port's host-slab builds (`search/dense.py:build_pq_index_from_host`,
`search/factory.py:build_dense_from_host`) and the periodic recipe's
over-budget branch with autotuning (`exps/recipes.py`), against the JAX
package's and against the port's own in-memory builds.

Toy sizes: 1536 rows of D = 32 (decaying spectrum, unit norm), slabs of 500
or 700 rows, 8 queries, top 10. What is compared, and how closely:

  * the int8 codec and the PQ serving codec (coarse scan + int8 refine, no
    PQ codes) draw nothing: their arrays equal JAX's, the PCA columns up to
    their sign (`train_projection`'s eigenvectors), so a coarse or refine
    code column may be negated as a whole;
  * codecs with PQ training or k-means draw otherwise than JAX: the port's
    host build equals its in-memory build from the same generator (the
    training sample is then the whole corpus), array for array, as
    `tests/test_ivfpq.py::test_ivfpq_host_slab_build_matches_device_build`
    holds JAX's; against JAX the ivfpq arrays are compared with the coarse
    k-means started from the same rows in both packages (the first C rows,
    `_first_rows_kmeans`), where the centroids agree within 1e-5 and the
    layout exactly, the codes and answers within the rounding band;
  * the periodic recipe over budget: each period's host-built index and the
    final parameters equal JAX's within 1e-5, and each period's autotuning
    summary (chosen params, front) equals JAX's, recalls within 1.5e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.test_torch_ivfpq import _assert_same
from tests.test_torch_periodic import STEP, _batches, _setup
from tests.torch_helpers import CPU, np_of
from vod_tpu.configs.search import DenseFactoryConfig as JaxConfig
from vod_tpu.exps import recipes as jax_recipes
from vod_tpu.ops import kmeans as jax_kmeans
from vod_tpu.runtime.state import TrainerState as JaxTrainerState
from vod_tpu.runtime.train import make_train_step as jax_make_train_step
from vod_tpu.search import factory as jax_factory
from vod_tpu.search.base import SearchQueries as JaxQueries
from vod_tpu.search.dense import build_pq_index_from_host as jax_pq_from_host
from vod_tpu.search.factory import build_dense_from_host as jax_from_host
from vod_tpu.search.ivfpq import ivfpq_search as jax_ivfpq_search
from vod_tpu_torch.configs import DenseFactoryConfig
from vod_tpu_torch.exps import PeriodicTrainingConfig, periodic_training, recipes
from vod_tpu_torch.models import system_flax_to_state_dict
from vod_tpu_torch.ops import kmeans as torch_kmeans
from vod_tpu_torch.runtime import TrainerState, make_train_step
from vod_tpu_torch.search import (
    DenseIndex,
    IVFPQIndex,
    PQIndex,
    SearchQueries,
    build_dense_from_config,
    build_dense_from_host,
    build_pq_index,
    build_pq_index_from_host,
    dense_search,
    ivfpq_search,
    pq_search,
)

N, D, B, K = 1536, 32, 8, 10


def _corpus() -> np.ndarray:
    rng = np.random.default_rng(0)
    spec = np.exp(-np.arange(D) / 12.0).astype(np.float32)
    x = rng.standard_normal((N, D), dtype=np.float32) * spec
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _queries() -> np.ndarray:
    x = _corpus()
    q = x[:B] + 0.05 * np.random.default_rng(1).standard_normal((B, D)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _gen() -> torch.Generator:
    return torch.Generator().manual_seed(0)


def _assert_codes_close(got: np.ndarray, want: np.ndarray, name: str) -> None:
    """int8 codes equal JAX's up to each column's sign, except that a code
    may be 1 off where its f32 value rounds at a .5 boundary on one side
    only (the projections are f32 products in other orders): at most 0.1%
    of the codes."""
    got, want = got.astype(np.int32), want.astype(np.int32)
    sign = np.where(np.sum(got * want, axis=0) < 0, -1, 1)
    diff = np.abs(got * sign - want)
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, (name, diff.max(), (diff > 0).mean())


def _assert_same_arrays(got, want) -> None:
    for name, g in vars(got).items():
        w = getattr(want, name)
        if isinstance(g, torch.Tensor):
            assert torch.equal(g, w), name
        else:
            assert g == w, name


@pytest.mark.parametrize("refine_dim", [None, 12], ids=["raw", "pca"])
def test_pq_serving_codec_from_host_matches_jax(refine_dim) -> None:
    """Coarse scan + int8 refine, no PQ codes (nothing drawn): the coarse and
    refine codes equal JAX's up to each PCA column's sign and the rounding
    band (`_assert_codes_close`), the scales within 1e-5 of their size, and
    the answers equal (`_assert_same_answers`)."""
    x = _corpus()
    kw = dict(n_subquantizers=8, coarse_dim=12, refine="int8", refine_dim=refine_dim, keep_codes=False,
              train_size=1000, slab=500, k_factor=8)
    want = jax_pq_from_host(jax.random.PRNGKey(0), x, **kw)
    got = build_pq_index_from_host(x, generator=_gen(), device=CPU, **kw)
    assert got.codes is None and want.codes is None
    _assert_codes_close(np_of(got.coarse_codes)[:, :12], np.asarray(want.coarse_codes), "coarse_codes")
    assert not np_of(got.coarse_codes)[:, 12:].any()  # the port's zero columns up to 16
    _assert_codes_close(np_of(got.refine_codes), np.asarray(want.refine_codes), "refine_codes")
    for name in ("coarse_scale", "refine_scale"):
        np.testing.assert_allclose(np_of(getattr(got, name)), np.asarray(getattr(want, name)), rtol=1e-5)
    assert got.n_real == want.n_real == N and got.codes is None
    from vod_tpu.search.dense import pq_search as jax_pq_search

    q = _queries()
    _assert_same(jax_pq_search(want, JaxQueries(vector=jnp.asarray(q)), K),
                         pq_search(got, SearchQueries(vector=torch.from_numpy(q)), K))


PQ_BUILDS = {
    "adc4-int8-pca": dict(n_subquantizers=8, code_bits=4, coarse_dim=None, refine="int8", refine_dim=12),
    "coarse-opq": dict(n_subquantizers=8, coarse_dim=12, use_opq=True),
    "direct": dict(coarse_dim=12, refine="int8", keep_codes=False),
}


@pytest.mark.parametrize("name", list(PQ_BUILDS))
def test_pq_from_host_equals_the_in_memory_build(name: str) -> None:
    """Train sample = the corpus: the host-slab build (slabs of 500) equals
    the in-memory build from the same generator, array for array, and has
    JAX's host build's structure."""
    x = _corpus()
    kw = dict(PQ_BUILDS[name], kmeans_iters=2)
    timings: dict = {}
    host = build_pq_index_from_host(x, train_size=N, slab=500, generator=_gen(), device=CPU, timings=timings, **kw)
    mem = build_pq_index(x, train_size=N, generator=_gen(), device=CPU, **kw)
    _assert_same_arrays(host, mem)
    assert set(timings) == {"train_ms", "encode_ms"}
    want = jax_pq_from_host(jax.random.PRNGKey(0), x, train_size=N, slab=500, **kw)
    for name_, g in vars(host).items():
        w = getattr(want, name_)
        if isinstance(g, torch.Tensor):
            shape = list(np.shape(w))
            if name_ == "coarse_codes":
                shape[-1] = -(-shape[-1] // 16) * 16
            assert list(g.shape) == shape, name_
        elif name_ != "fused_tile":
            assert g == w or (g is None and w is None), name_


@pytest.mark.parametrize("kernel", ["scan", "fused"])
def test_int8_from_host_matches_jax_and_the_in_memory_build(kernel: str) -> None:
    x = _corpus()
    subset = (np.arange(N) % 5).astype(np.int32)
    cfg = DenseFactoryConfig(codec="int8", kernel=kernel)
    got = build_dense_from_host(cfg, x, subset_ids=subset, slab=700, device=CPU)
    want = jax_from_host(JaxConfig(codec="int8", kernel=kernel), x, subset_ids=jnp.asarray(subset), slab=700)
    assert isinstance(got, DenseIndex)
    for name in ("vectors", "scale", "subset_ids"):
        np.testing.assert_array_equal(np_of(getattr(got, name)), np.asarray(getattr(want, name)), err_msg=name)
    for name in ("n_real", "approx_recall", "kernel"):
        assert getattr(got, name) == getattr(want, name), name
    mem = build_dense_from_config(cfg, x, subset_ids=subset, device=CPU)
    assert torch.equal(got.vectors, mem.vectors) and torch.equal(got.scale, mem.scale)
    q = SearchQueries(vector=torch.from_numpy(_queries()))
    assert torch.equal(dense_search(got, q, K).indices, dense_search(mem, q, K).indices)


IVFPQ = dict(codec="ivfpq", n_clusters=12, nprobe=4, ivf_window=32, kmeans_iters=3, refine="int8", refine_dim=16,
             train_size=N, approx_recall=None)


@pytest.mark.parametrize("diff", [dict(n_subquantizers=8), dict(keep_codes=False),
                                  dict(n_subquantizers=8, code_bits=4, spill=True, rerank="int8", rerank_dim=8)],
                         ids=["codes", "no-codes", "spilled-4bit-rerank"])
def test_ivfpq_from_host_equals_the_in_memory_build(diff: dict) -> None:
    x = _corpus()
    cfg = DenseFactoryConfig(**IVFPQ, **diff)
    timings: dict = {}
    host = build_dense_from_host(cfg, x, generator=_gen(), slab=500, device=CPU, timings=timings)
    mem = build_dense_from_config(cfg, x, generator=_gen(), device=CPU)
    assert isinstance(host, IVFPQIndex) and set(timings) == {"train_ms", "encode_ms", "layout_ms"}
    _assert_same_arrays(host, mem)
    q = SearchQueries(vector=torch.from_numpy(_queries()))
    assert torch.equal(ivfpq_search(host, q, K).indices, ivfpq_search(mem, q, K).indices)


def _first_rows_kmeans(monkeypatch) -> None:
    """Both packages' coarse k-means started from the first C rows (no
    random draw), so they agree while no cluster empties."""
    real_j, real_t = jax_kmeans.kmeans, torch_kmeans.kmeans
    monkeypatch.setattr(jax_kmeans, "kmeans", lambda rng, x, n_clusters, n_iters=10, **kw: real_j(
        rng, x, n_clusters, n_iters, init=x[:n_clusters]))
    monkeypatch.setattr(torch_kmeans, "kmeans", lambda x, n_clusters, n_iters=10, **kw: real_t(
        x, n_clusters, n_iters, init=x[:n_clusters], generator=kw["generator"]))


@pytest.mark.parametrize("spill", [False, True], ids=["plain", "spilled"])
def test_ivfpq_from_host_matches_jax(spill: bool, monkeypatch) -> None:
    """The serving codec (IVF + int8 refine over 16 PCA dims, no codes) from
    host slabs, the k-means started alike: centroids within 1e-5, the layout
    exactly, the refine rows up to each PCA column's sign, and the answers."""
    _first_rows_kmeans(monkeypatch)
    x = _corpus()
    diff = dict(IVFPQ, keep_codes=False, spill=spill)
    got = build_dense_from_host(DenseFactoryConfig(**diff), x, slab=500, device=CPU)
    want = jax_from_host(JaxConfig(**diff), x, rng=jax.random.PRNGKey(0), slab=500)
    np.testing.assert_allclose(np_of(got.centroids), np.asarray(want.centroids), atol=1e-5)
    for name in ("row_ids", "win_start", "win_count"):
        np.testing.assert_array_equal(np_of(getattr(got, name)), np.asarray(getattr(want, name)), err_msg=name)
    _assert_codes_close(np_of(got.refine_codes), np.asarray(want.refine_codes), "refine_codes")
    for name in ("n_real", "window", "nprobe", "max_windows", "k_factor", "code_bits", "approx_recall", "spilled"):
        assert getattr(got, name) == getattr(want, name), name
    q = _queries()
    _assert_same(jax_ivfpq_search(want, JaxQueries(vector=jnp.asarray(q)), K),
                         ivfpq_search(got, SearchQueries(vector=torch.from_numpy(q)), K))


def test_host_build_downgrades_full_precision_stores_and_refuses_flat(tmp_path) -> None:
    x = _corpus()[:600]
    with pytest.warns(UserWarning, match="refine='float32'"):
        ix = build_dense_from_host(DenseFactoryConfig(codec="pq", n_subquantizers=8, kmeans_iters=1, refine="float32"),
                                   x, device=CPU)
    assert isinstance(ix, PQIndex) and ix.refine_codes.dtype == torch.int8
    with pytest.warns(UserWarning, match="rerank='bfloat16'"):
        ix = build_dense_from_host(DenseFactoryConfig(**dict(IVFPQ, keep_codes=False, rerank="bfloat16")), x,
                                   device=CPU)
    assert ix.rerank_codes.dtype == torch.int8 and ix.refine_codes.dtype == torch.int8
    with pytest.raises(ValueError, match="host-slab build supports"):
        build_dense_from_host(DenseFactoryConfig(codec="flat"), x, device=CPU)
    # sharded pq from host slabs, once a refusal (ROADMAP §A item 5b), now keeps this rank's shard
    from tests.torch_helpers import job_factory_sharded, run_ranks

    (res,) = run_ranks(job_factory_sharded, 1, tmp_path, "pq", x, dict(n_subquantizers=8, kmeans_iters=1), True)
    assert (res["type"], res["plain_type"]) == ("ShardedPQIndex", "PQIndex")
    np.testing.assert_array_equal(res["ids"], res["plain_ids"])


def _record(monkeypatch, module, name: str) -> list:
    seen = []
    real = getattr(module, name)

    def recording(cfg, vectors, **kw):
        index = real(cfg, vectors, **kw)
        seen.append((np.array(vectors), index))
        return index

    monkeypatch.setattr(module, name, recording)
    return seen


@pytest.mark.parametrize("codec", ["int8", "ivfpq-autotune"])
def test_periodic_training_over_budget_matches_jax(codec: str, monkeypatch) -> None:
    """Two periods of two steps with the embeddings over
    `embed_hbm_budget_bytes`: each period embeds into host RAM and builds
    from host slabs, in both packages; the host matrices and the final
    parameters within 1e-5, each period's index arrays equal (the ivfpq
    centroids within 1e-5, k-means started alike), and with autotuning each
    period's chosen operating point, recall and Pareto front equal JAX's."""
    jmodel, params, jcorpus, tmodel, tcorpus, make_queries = _setup(1)
    batches = {p: _batches(make_queries, p, 2) for p in range(2)}
    kw = dict(STEP, temperature=0.0)
    if codec == "int8":
        dense = dict(codec="int8")
    else:
        _first_rows_kmeans(monkeypatch)
        dense = dict(codec="ivfpq", n_clusters=4, nprobe=2, ivf_window=8, kmeans_iters=2, refine="int8",
                     keep_codes=False, approx_recall=None, autotune_target_recall=0.9)
    jseen = _record(monkeypatch, jax_factory, "build_dense_from_host")  # the JAX recipe imports it per call
    tseen = _record(monkeypatch, recipes, "build_dense_from_host")
    tx = optax.sgd(0.5)
    jparams, _, jstate, jhist = jax_recipes.periodic_training(
        model=jmodel, step_fn=jax_make_train_step(jmodel, tx, **kw), params=params, opt_state=tx.init(params),
        corpus=jcorpus, state=JaxTrainerState(max_steps=4, period=2), train_queries_fn=lambda p: batches[p][0],
        rng=jax.random.PRNGKey(0),
        config=jax_recipes.PeriodicTrainingConfig(dense=JaxConfig(**dense), log_interval=1, embed_hbm_budget_bytes=1),
    )
    step = make_train_step(tmodel, torch.optim.SGD(tmodel.parameters(), lr=0.5), **kw)
    tstate, thist = periodic_training(
        step_fn=step, corpus=tcorpus, state=TrainerState(max_steps=4, period=2),
        train_queries_fn=lambda p: batches[p][1], generator=torch.Generator().manual_seed(0),
        config=PeriodicTrainingConfig(dense=DenseFactoryConfig(**dense), log_interval=1, embed_hbm_budget_bytes=1),
    )
    assert tstate.to_json() == jstate.to_json() and len(jseen) == len(tseen) == 2
    for (jv, ji), (tv, ti) in zip(jseen, tseen):
        assert isinstance(tv, np.ndarray)  # embedded into host RAM
        np.testing.assert_allclose(tv, jv, atol=1e-5, rtol=0)
        if codec == "int8":
            np.testing.assert_array_equal(np_of(ti.vectors), np.asarray(ji.vectors))
        else:
            np.testing.assert_allclose(np_of(ti.centroids), np.asarray(ji.centroids), atol=1e-5)
            for name in ("row_ids", "refine_codes"):
                np.testing.assert_array_equal(np_of(getattr(ti, name)), np.asarray(getattr(ji, name)), err_msg=name)
    assert np.abs(tseen[1][0] - tseen[0][0]).max() > 1e-3  # period 1 indexes the moved encoder
    want = system_flax_to_state_dict(jax.device_get(jparams))
    for name, w in want.items():
        np.testing.assert_allclose(np_of(tmodel.state_dict()[name]), np_of(w), atol=1e-5, rtol=0, err_msg=name)
    for th, jh in zip(thist, jhist):
        assert th["host_build"] is True
        if codec == "int8":
            assert "autotune" not in th and "autotune" not in jh
        else:
            # the query sample is drawn from another seed (a permutation of
            # the same 64 rows: nq = N), so a mean over them may round its
            # 4th decimal otherwise
            ta, ja = th["autotune"], jh["autotune"]
            assert ta["params"] == ja["params"] and ta["met"] == ja["met"] and ta["target"] == ja["target"]
            assert abs(ta["recall"] - ja["recall"]) <= 1.5e-4
            assert [p["params"] for p in ta["front"]] == [p["params"] for p in ja["front"]] and ta["front"]
            assert all(abs(a["recall"] - b["recall"]) <= 1.5e-4 for a, b in zip(ta["front"], ja["front"]))
