"""The port's operating-point autotuning (`vod_tpu_torch/search/autotune.py`)
against the JAX package's, on indexes built by JAX and carried across
(`models/convert.py`), so both sweep identical arrays.

Toy sizes: 2048 rows of D = 32 drawn around 32 centres, 32 queries near
corpus rows, top 10. What must be equal: the default grids, the knobs each
grid point applies (the IVF-PQ window-budget rescale included), the recall
of every point (each package's ids against the same ground truth; the ids
are equal, so the recalls are, exactly), the Pareto front, the selection and
the tuned index, `autotune_after_build`'s summary on the device and the host
paths (the query sample drawn from JAX's seed), and the host ground truth.
The direct PQ serving codec's fused points run `fused_mips_binned`'s plain
version here and the Pallas kernel in interpret mode in JAX.
"""

import dataclasses
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_helpers import CPU
from vod_tpu.configs.search import DenseFactoryConfig as JaxConfig
from vod_tpu.search import build_dense_index as jax_build_flat
from vod_tpu.search import build_ivf_index as jax_build_ivf
from vod_tpu.search import build_ivfpq_index as jax_build_ivfpq
from vod_tpu.search import build_pq_index as jax_build_pq
from vod_tpu_torch.configs import DenseFactoryConfig
from vod_tpu_torch.models.convert import dense_index_from_fields, ivfpq_index_from_fields
from vod_tpu_torch.search import build_dense_index
from vod_tpu_torch.search.autotune import OperatingPoint

# the modules (each package's `search` exports a function `autotune` that
# shadows its module's name there)
autotune = importlib.import_module("vod_tpu_torch.search.autotune")
jax_autotune = importlib.import_module("vod_tpu.search.autotune")

N, D, B, K = 2048, 32, 32, 10


def _corpus() -> np.ndarray:
    r = np.random.default_rng(0)
    centers = r.standard_normal((32, D), dtype=np.float32) * 2
    return (centers[r.integers(0, 32, N)] + r.standard_normal((N, D), dtype=np.float32)).astype(np.float32)


def _queries_and_gt() -> tuple[np.ndarray, np.ndarray]:
    x = _corpus()
    r = np.random.default_rng(1)
    q = x[r.integers(0, N, B)] + 0.1 * r.standard_normal((B, D), dtype=np.float32)
    gt = np.argsort(-(q.astype(np.float64) @ x.astype(np.float64).T), axis=-1, kind="stable")[:, :K]
    return q.astype(np.float32), gt


def _fields(index) -> dict:
    return {k: (np.asarray(v) if hasattr(v, "shape") else v) for k, v in vars(index).items()}


BUILDS = {
    "ivfpq": lambda x: jax_build_ivfpq(jax.random.PRNGKey(0), x, n_clusters=16, nprobe=4, window=64,
                                       n_subquantizers=8, kmeans_iters=2, refine="int8", approx_recall=None),
    "ivfpq-rerank": lambda x: jax_build_ivfpq(jax.random.PRNGKey(0), x, n_clusters=16, nprobe=4, window=64,
                                              kmeans_iters=2, refine="int8", refine_dim=8, keep_codes=False,
                                              rerank="int8", approx_recall=None),
    "ivf": lambda x: jax_build_ivf(jax.random.PRNGKey(0), x, n_clusters=8, nprobe=2, kmeans_iters=2,
                                   dtype="float32"),
    "pq-refine": lambda x: jax_build_pq(jax.random.PRNGKey(0), x, n_subquantizers=8, coarse_dim=None,
                                        refine="int8", kmeans_iters=2, approx_recall=None),
    "pq-coarse": lambda x: jax_build_pq(jax.random.PRNGKey(0), x, n_subquantizers=8, coarse_dim=16,
                                        kmeans_iters=2, approx_recall=None),
    "pq-direct": lambda x: jax_build_pq(jax.random.PRNGKey(0), x, coarse_dim=16, refine="int8", k_factor=8,
                                        keep_codes=False),
}


@functools.lru_cache(maxsize=None)
def _built(name: str):
    ji = BUILDS[name](jnp.asarray(_corpus()))
    convert = ivfpq_index_from_fields if name.startswith("ivfpq") else dense_index_from_fields
    return ji, convert(_fields(ji), device=CPU)


def _knobs(index) -> dict:
    names = ("nprobe", "max_windows", "k_factor", "n_candidates", "kernel", "fused_bins", "fused_tile")
    return {n: getattr(index, n) for n in names if hasattr(index, n)}


@pytest.mark.parametrize("name", list(BUILDS))
def test_grids_and_runtime_params_match_jax(name: str) -> None:
    ji, ti = _built(name)
    grid = autotune.default_grid(ti)
    assert grid == jax_autotune.default_grid(ji) and len(grid) > 1
    for params in grid:
        assert _knobs(autotune.apply_runtime_params(ti, params)) == _knobs(jax_autotune.apply_runtime_params(ji, params))
    if name.startswith("ivfpq"):  # probing every cell lifts the budget to every window
        full = autotune.apply_runtime_params(ti, {"nprobe": 16})
        assert full.max_windows == int(ti.win_count.sum())
    assert autotune.apply_runtime_params(ti, {}) is ti


@pytest.mark.parametrize("name", list(BUILDS))
def test_sweep_recalls_front_and_selection_match_jax(name: str) -> None:
    ji, ti = _built(name)
    q, gt = _queries_and_gt()
    tpts = autotune.sweep_operating_points(ti, torch.from_numpy(q), gt, top_k=K, measure_time=False)
    jpts = jax_autotune.sweep_operating_points(ji, jnp.asarray(q), gt, top_k=K, measure_time=False)
    assert [(p.params, p.recall) for p in tpts] == [(p.params, p.recall) for p in jpts]
    tfront, jfront = autotune.pareto_front(tpts), jax_autotune.pareto_front(jpts)
    assert [(p.params, p.recall) for p in tfront] == [(p.params, p.recall) for p in jfront]
    for target in (0.5, 0.9, 0.99, 1.01):
        tsel = autotune.select_operating_point(tfront, target)
        assert tsel.params == jax_autotune.select_operating_point(jfront, target).params
    tuned, chosen, front = autotune.autotune(ti, torch.from_numpy(q), gt, target_recall=0.9, top_k=K,
                                             measure_time=False)
    jtuned, jchosen, _ = jax_autotune.autotune(ji, jnp.asarray(q), gt, target_recall=0.9, top_k=K,
                                                measure_time=False)
    assert chosen.params == jchosen.params and chosen.recall == jchosen.recall
    assert _knobs(tuned) == _knobs(jtuned)
    for f in dataclasses.fields(tuned):  # a view: the same tensors
        v = getattr(tuned, f.name)
        if isinstance(v, torch.Tensor):
            assert v is getattr(ti, f.name)


def test_pareto_front_and_selection_of_timed_points_match_jax() -> None:
    raw = [({"a": 1}, 0.50, 0.010), ({"a": 2}, 0.70, 0.020), ({"a": 3}, 0.70, 0.015), ({"a": 4}, 0.90, 0.012),
           ({"a": 5}, 0.95, 0.050), ({"a": 6}, 0.95, None), ({"a": 7}, 0.99, 0.080), ({"a": 8}, 0.60, None)]
    tpts = [OperatingPoint(params=p, recall=r, wall_s=w, _n_queries=64) for p, r, w in raw]
    jpts = [jax_autotune.OperatingPoint(params=p, recall=r, wall_s=w, _n_queries=64) for p, r, w in raw]
    tfront, jfront = autotune.pareto_front(tpts), jax_autotune.pareto_front(jpts)
    assert [(p.params, p.recall, p.wall_s, p.qps) for p in tfront] == [(p.params, p.recall, p.wall_s, p.qps)
                                                                       for p in jfront]
    for target in (0.4, 0.65, 0.9, 0.97, 1.0):
        assert autotune.select_operating_point(tfront, target).params == \
            jax_autotune.select_operating_point(jfront, target).params
    assert tpts[0].qps == jpts[0].qps == 6400.0


def test_timed_sweep_measures_every_point() -> None:
    _, ti = _built("ivfpq")
    q, gt = _queries_and_gt()
    pts = autotune.sweep_operating_points(ti, torch.from_numpy(q), gt, top_k=K, measure_time=True, time_repeats=2)
    assert all(p.wall_s is not None and p.wall_s > 0 and p.qps > 0 for p in pts)
    assert [p.params["nprobe"] for p in sorted(pts, key=lambda p: p.params["nprobe"])] == [1, 2, 4, 8, 16]


@pytest.mark.parametrize("where", ["device", "host"])
@pytest.mark.parametrize("name", ["ivfpq-rerank", "pq-direct"])
def test_autotune_after_build_matches_jax(name: str, where: str, monkeypatch) -> None:
    """The config-driven tuning on the device path (the embeddings a tensor)
    and the host path (numpy): the same query sample (JAX's seed), the same
    summary."""
    ji, ti = _built(name)
    x = _corpus()
    rng = jax.random.PRNGKey(3)
    monkeypatch.setattr(autotune, "_sample_seed", lambda g: int(jax.random.randint(rng, (), 0, 2**31 - 1)))
    kw = dict(autotune_target_recall=0.8, autotune_queries=48, autotune_top_k=K)
    tuned, info = autotune.autotune_after_build(
        ti, DenseFactoryConfig(**kw), torch.from_numpy(x) if where == "device" else x, generator=torch.Generator())
    jtuned, jinfo = jax_autotune.autotune_after_build(
        ji, JaxConfig(**kw), jnp.asarray(x) if where == "device" else x, rng=rng)
    assert info == jinfo and info["front"]
    assert _knobs(tuned) == _knobs(jtuned)


def test_autotune_after_build_is_off_or_inert_where_jax_is() -> None:
    _, ti = _built("ivfpq")
    x = _corpus()
    assert autotune.autotune_after_build(ti, DenseFactoryConfig(), x, generator=torch.Generator()) == (ti, None)
    flat = build_dense_index(x, dtype="float32", device=CPU)
    cfg = DenseFactoryConfig(autotune_target_recall=0.9)
    assert autotune.autotune_after_build(flat, cfg, x, generator=torch.Generator()) == (flat, None)
    assert autotune.default_grid(flat) == jax_autotune.default_grid(jax_build_flat(jnp.asarray(x))) == [{}]
    q, gt = _queries_and_gt()
    pts = autotune.sweep_operating_points(flat, torch.from_numpy(q), gt, top_k=K, measure_time=False)
    assert len(pts) == 1 and pts[0].recall == 1.0
    with pytest.raises(TypeError):
        autotune.apply_runtime_params(flat, {"nprobe": 2})


def test_exact_topk_host_and_recall_match_jax() -> None:
    x = _corpus()
    q, gt = _queries_and_gt()
    got = autotune._exact_topk_host(x, q, K, chunk=300)
    np.testing.assert_array_equal(got, jax_autotune._exact_topk_host(x, q, K, chunk=300))
    np.testing.assert_array_equal(got, gt)
    noisy = gt.copy()
    noisy[::3, -3:] = -1
    assert autotune._recall_at_k(noisy, gt, K) == jax_autotune._recall_at_k(noisy, gt, K) < 1.0
