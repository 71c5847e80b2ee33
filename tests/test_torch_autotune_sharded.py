"""The port's autotuning of the sharded engines (`vod_tpu_torch/search/
autotune.py`) at W = 2 and 4 against JAX's, on the same queries and ground
truth.

JAX sweeps its sharded index on the root conftest's 8-device virtual CPU
mesh; the port sweeps its sharded copy of the same index on W CPU ranks of
one gloo group, every rank in lockstep (each search is a collective).
Untimed sweeps (`measure_time=False`) make the choice a function of the
recalls alone, so it must equal JAX's, and the unsharded index's where the
sharded search gives the unsharded answer. A timed `autotune_after_build`
may time otherwise on each rank; every rank must end on rank 0's point.

Declared difference: JAX's default grid gives a sharded direct-mode PQ the
fused points, and `apply_runtime_params` then raises `TypeError` on them
(`ShardedPQIndex` has no `kernel`; ROADMAP §C). The port leaves them out of
that grid, so the JAX side here sweeps its own grid less those points.
Recalls are compared within 1e-9 (the same ids on both sides).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from tests.torch_helpers import job_autotune_sharded, job_sequence, run_ranks, unit_rows
from vod_tpu.search.dense import build_dense_index, build_ivf_index, build_pq_index, dense_search
from vod_tpu.search.ivfpq import build_ivfpq_index
from vod_tpu.search.sharded import shard_ivf_index, shard_ivfpq_index, shard_pq_index

jax_autotune = importlib.import_module("vod_tpu.search.autotune")

N, D, NQ, K = 640, 16, 24, 10
WORLDS = (2, 4)
TARGET = 0.8


def _data():
    rng = np.random.default_rng(21)
    centres = unit_rows(rng, 16, D)
    x = (centres[rng.integers(0, 16, N)] + 0.35 * rng.standard_normal((N, D))).astype(np.float32)
    q = x[rng.choice(N, NQ, replace=False)]
    return x, q


def _cases() -> dict:
    """name -> (kind, JAX build, its kwargs)."""
    ivfpq = dict(n_clusters=8, nprobe=2, window=16, n_subquantizers=8, kmeans_iters=3, refine="int8",
                 keep_codes=False, approx_recall=None)
    return {
        "ivfpq": ("ivfpq", build_ivfpq_index, ivfpq),
        "ivfpq-rerank": ("ivfpq", build_ivfpq_index, dict(ivfpq, rerank="int8", k_factor=4)),
        "ivf": ("ivf", build_ivf_index, dict(n_clusters=8, nprobe=2, dtype="float32")),
        "pq-coarse": ("pq", build_pq_index, dict(n_subquantizers=8, coarse_dim=8, refine="int8", kmeans_iters=2,
                                                  approx_recall=None)),
        "pq-direct": ("pq", build_pq_index, dict(coarse_dim=8, refine="int8", keep_codes=False, approx_recall=None)),
    }


@pytest.fixture(scope="module")
def built() -> dict:
    x, q = _data()
    gt = np.asarray(dense_search(build_dense_index(jnp.asarray(x), dtype="float32", approx_recall=None),
                                 jax_autotune.SearchQueries(vector=jnp.asarray(q)), K).indices)
    out = {"gt": gt}
    for name, (_, build, kw) in _cases().items():
        out[name] = build(jax.random.PRNGKey(4), jnp.asarray(x), **kw)
    return out


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"W{w}")
def ranks(request, tmp_path_factory, built: dict) -> dict:
    _, q = _data()
    fcfg = dict(autotune_target_recall=TARGET, autotune_queries=8, autotune_top_k=K, autotune_measure_time=True)
    calls = [(job_autotune_sharded, (kind, {k: (np.asarray(v) if hasattr(v, "shape") else v)
                                            for k, v in vars(built[name]).items()},
                                     q, built["gt"], TARGET, K, fcfg, 9)) for name, (kind, _, _) in _cases().items()]
    out = run_ranks(job_sequence, request.param, tmp_path_factory.mktemp(f"at{request.param}"), calls)
    return {"w": request.param, **{name: [rank[i] for rank in out] for i, name in enumerate(_cases())}}


def _shard(kind: str, index, w: int):
    mesh = Mesh(np.array(jax.devices()[:w]), ("shard",))
    return {"pq": shard_pq_index, "ivf": shard_ivf_index, "ivfpq": shard_ivfpq_index}[kind](index, mesh, axis="shard")


@pytest.mark.parametrize("name", list(_cases()))
def test_sharded_choice_matches_jax(ranks: dict, built: dict, name: str) -> None:
    kind = _cases()[name][0]
    jix = _shard(kind, built[name], ranks["w"])
    grid = [g for g in jax_autotune.default_grid(jix) if "fused" not in g]
    _, chosen, _ = jax_autotune.autotune(jix, jnp.asarray(_data()[1]), built["gt"], target_recall=TARGET, top_k=K,
                                         grid=grid, measure_time=False)
    for r in ranks[name]:
        assert r["grid"] == grid, name
        assert r["chosen"] == chosen.params and r["recall"] == pytest.approx(chosen.recall, abs=1e-9), name
    # every rank ends on rank 0's timed choice
    assert len({tuple(sorted(r["timed"].items())) for r in ranks[name]}) == 1


def test_jax_grid_has_the_fused_points_the_port_leaves_out(ranks: dict, built: dict) -> None:
    jix = _shard("pq", built["pq-direct"], ranks["w"])
    assert any("fused" in g for g in jax_autotune.default_grid(jix))
    assert not any("fused" in g for g in ranks["pq-direct"][0]["grid"])
    with pytest.raises(TypeError):  # the fault of the reference (ROADMAP §C)
        jax_autotune.apply_runtime_params(jix, {"k_factor": 8, "fused": 1, "fused_bins": 2048, "fused_tile": 16384})


@pytest.mark.parametrize("name", ["ivfpq", "ivf"])
def test_sharded_ivf_choices_are_the_unsharded_choices(ranks: dict, name: str) -> None:
    """As `tests/test_autotune.py:188` asks of JAX: the cell-sharded index
    picks the unsharded nprobe. IVF's sharded answer is the unsharded one,
    so its recalls agree too; a truncated IVF-PQ's per-shard window budget
    (1.5x its share) scans other windows, so only the choice is held."""
    for r in ranks[name]:
        assert r["chosen"] == r["plain"] and r["recall"] >= TARGET
        if name == "ivf":
            assert r["recall"] == pytest.approx(r["plain_recall"], abs=1e-9)


def test_the_sharded_window_budget_is_capped_at_the_busiest_shard(ranks: dict, built: dict) -> None:
    """nprobe 8 = every cell: the rescaled budget would exceed the busiest
    shard's windows and is cut to them, as JAX cuts it."""
    jix = _shard("ivfpq", built["ivfpq"], ranks["w"])
    want = jax_autotune.apply_runtime_params(jix, {"nprobe": 8})
    busiest = int(np.asarray(jix.win_count).reshape(ranks["w"], -1).sum(axis=1).max())
    assert want.max_windows <= busiest
    from vod_tpu_torch.search.sharded import ShardedIVFPQIndex

    at = importlib.import_module("vod_tpu_torch.search.autotune")
    meta = ranks["ivfpq"][0]["meta"]
    port = at.apply_runtime_params(ShardedIVFPQIndex(
        centroids=None, codebooks=None, codes=None, row_ids=None, win_start=None, win_count=None,
        window=meta["window"], nprobe=jix.nprobe, max_windows=jix.max_windows,
        slots_per_shard=meta["slots_per_shard"]), {"nprobe": 8})
    assert port.max_windows == want.max_windows and meta["slots_per_shard"] == jix.slots_per_shard
