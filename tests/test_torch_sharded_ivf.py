"""The port's sharded IVF and IVF-PQ (`vod_tpu_torch/search/sharded.py`)
against JAX's `sharded_ivf_search` / `sharded_ivfpq_search` at W = 2 and 4.

JAX builds each index once and runs its `shard_map` search on the root
conftest's 8-device virtual CPU mesh; the port shards a copy of the same
index (`models/convert.py`) over W CPU ranks of one gloo group, all cases of
one W in one group. Each rank's arrays are held against JAX's slice for its
shard: IVF cells, and IVF-PQ `win_start`, `win_count` and `row_ids` bit for
bit. The IVF-PQ "empty" case moves every row of the odd cells to the cell
before it, so at W = 2 rank 1 (and at W = 4 ranks 1 and 3) own only empty
cells and gather padding.

Tolerances: scores within 1e-5 of their size (f32 sums in other orders;
int8 products exact); an id may differ from JAX's only where JAX holds it
at a score within that band, as in `tests/test_torch_ivfpq.py`. JAX's
IVF-PQ indexes are built with `approx_recall=None` (exact selection, as the
port's).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from tests.torch_helpers import job_sequence, job_sharded_engine, run_ranks, unit_rows
from vod_tpu.search import SearchQueries as JaxQueries
from vod_tpu.search.dense import build_ivf_index as jax_build_ivf
from vod_tpu.search.ivfpq import build_ivfpq_from_parts as jax_from_parts
from vod_tpu.search.ivfpq import build_ivfpq_index as jax_build_ivfpq
from vod_tpu.search.sharded import shard_ivf_index, shard_ivfpq_index, sharded_ivf_search, sharded_ivfpq_search

N, D, B, K = 600, 16, 6, 10
WORLDS = (2, 4)
TOL = 1e-5
CELLS = 6


def _data():
    rng = np.random.default_rng(11)
    centres = unit_rows(rng, 12, D)
    x = centres[rng.integers(0, 12, N)] + 0.3 * rng.standard_normal((N, D)).astype(np.float32)
    q = x[rng.integers(0, N, B)] + 0.05 * rng.standard_normal((B, D)).astype(np.float32)
    subsets = (np.arange(N) % 4).astype(np.int32)
    allowed = np.array([[1, -1], [0, 2], [-1, -1], [3, 3], [2, -1], [0, 1]], np.int32)
    return x.astype(np.float32), q.astype(np.float32), subsets, allowed


def _ivfpq_base() -> dict:
    return dict(n_clusters=CELLS, nprobe=3, window=16, n_subquantizers=8, kmeans_iters=3, approx_recall=None)


def _cases() -> dict:
    """name -> (kind, build kwargs, query fields, batch axis)."""
    x, q, subsets, allowed = _data()
    plain, filtered = dict(vector=q), dict(vector=q, subset_ids=allowed)
    ivf = dict(n_clusters=CELLS, nprobe=3, dtype="float32")
    base = _ivfpq_base()
    refine = dict(base, refine="int8", refine_dim=8, keep_codes=False)
    full = dict(max_windows=0)  # every window of every probed cell: untruncated
    return {
        "ivf": ("ivf", ivf, plain, None),
        "ivf-all-cells": ("ivf", dict(ivf, nprobe=CELLS), plain, None),
        "ivf-subset": ("ivf", dict(ivf, subset_ids=subsets), filtered, None),
        "ivf-split": ("ivf", ivf, plain, "shard"),
        "ivfpq-adc": ("ivfpq", dict(base, **full), plain, None),
        "ivfpq-refine": ("ivfpq", dict(refine, **full), plain, None),
        "ivfpq-rerank": ("ivfpq", dict(refine, rerank="int8", k_factor=4), plain, None),
        "ivfpq-spilled": ("ivfpq", dict(refine, spill=True, **full), plain, None),
        "ivfpq-truncated": ("ivfpq", dict(refine, max_windows=5), plain, None),
        "ivfpq-subset": ("ivfpq", dict(refine, subset_ids=subsets), filtered, None),
        "ivfpq-split": ("ivfpq", dict(refine, rerank="int8", k_factor=4), plain, "shard"),
        "ivfpq-empty": ("ivfpq-empty", refine, plain, None),
    }


def _build(kind: str, kw: dict):
    x = jnp.asarray(_data()[0])
    kw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    if kind == "ivf":
        return jax_build_ivf(jax.random.PRNGKey(3), x, **kw)
    ix = jax_build_ivfpq(jax.random.PRNGKey(3), x, **kw)
    if kind == "ivfpq":
        return ix
    # every row of an odd cell moves to the even cell before it
    from vod_tpu.ops.kmeans import _assign_chunked

    assign = np.asarray(_assign_chunked(x, ix.centroids)).astype(np.int32)
    assign = assign - assign % 2
    refine = np.asarray(jnp.clip(jnp.round((x @ ix.refine_proj) / ix.refine_scale), -127, 127).astype(jnp.int8))
    return jax_from_parts(ix.centroids, ix.codebooks, assign, None, refine_np=refine, refine_scale=ix.refine_scale,
                          refine_proj=ix.refine_proj, window=ix.window, nprobe=ix.nprobe, approx_recall=None)


@pytest.fixture(scope="module")
def jax_indexes() -> dict:
    return {name: _build(kind, kw) for name, (kind, kw, _, _) in _cases().items()}


def _fields(index) -> dict:
    return {k: (np.asarray(v) if hasattr(v, "shape") else v) for k, v in vars(index).items()}


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"W{w}")
def ranks(request, tmp_path_factory, jax_indexes: dict) -> dict:
    w = request.param
    names, calls = [], []
    for name, (kind, _, q, batch_axis) in _cases().items():
        names.append(name)
        calls.append((job_sharded_engine, (kind.split("-")[0], _fields(jax_indexes[name]), "shard", q, K, batch_axis)))
    out = run_ranks(job_sequence, w, tmp_path_factory.mktemp(f"sivf{w}"), calls)
    return {"w": w, **{name: [rank[i] for rank in out] for i, name in enumerate(names)}}


def _jax_answer(jax_indexes: dict, name: str, w: int):
    kind, _, q, _ = _cases()[name]
    mesh = Mesh(np.array(jax.devices()[:w]), ("shard",))
    jq = JaxQueries(**{k: jnp.asarray(v) for k, v in q.items()})
    if kind == "ivf":
        ix = shard_ivf_index(jax_indexes[name], mesh, axis="shard")
        r = sharded_ivf_search(ix, jq, K)
    else:
        ix = shard_ivfpq_index(jax_indexes[name], mesh, axis="shard")
        r = sharded_ivfpq_search(ix, jq, K)
    return ix, np.asarray(r.scores), np.asarray(r.indices)


def _assert_same(name: str, got_s, got_i, want_s, want_i) -> None:
    fin = np.isfinite(want_s)
    np.testing.assert_array_equal(np.isfinite(got_s), fin, err_msg=name)
    band = TOL * max(1.0, float(np.abs(want_s[fin]).max())) if fin.any() else TOL
    np.testing.assert_allclose(got_s[fin], want_s[fin], rtol=0, atol=band, err_msg=name)
    for r, c in zip(*np.nonzero(got_i != want_i)):
        where = np.nonzero(want_i[r] == got_i[r, c])[0]
        other = want_s[r, where[0]] if len(where) else want_s[r, -1]
        assert abs(other - want_s[r, c]) <= 2 * band, (name, r, c, got_i[r], want_i[r])


def _merged(name: str, results: list, w: int):
    if name.endswith("split") and B % w == 0:  # each rank answered its block of the rows
        return np.concatenate([r["scores"] for r in results]), np.concatenate([r["ids"] for r in results])
    for r in results[1:]:  # every rank holds the merged answer
        np.testing.assert_array_equal(r["ids"], results[0]["ids"])
    return results[0]["scores"], results[0]["ids"]


@pytest.mark.parametrize("name", [n for n in _cases() if n.startswith("ivf-")])
def test_sharded_ivf_matches_jax(ranks: dict, jax_indexes: dict, name: str) -> None:
    w = ranks["w"]
    jix, want_s, want_i = _jax_answer(jax_indexes, name, w)
    _assert_same(name, *_merged(name, ranks[name], w), want_s, want_i)
    cpd = jix.cells_per_shard
    for rank, r in enumerate(ranks[name]):
        assert r["meta"]["cells_per_shard"] == cpd and r["meta"]["c_real"] == jix.c_real
        for key in ("vectors", "row_ids", "subset_ids") if jix.subset_ids is not None else ("vectors", "row_ids"):
            np.testing.assert_array_equal(r["arrays"][key], np.asarray(getattr(jix, key))[rank * cpd:(rank + 1) * cpd])
        np.testing.assert_array_equal(r["arrays"]["centroids"], np.asarray(jix.centroids))
    if name == "ivf-all-cells":  # every cell probed: the unsharded search's answer
        np.testing.assert_array_equal(ranks[name][0]["ids"], ranks[name][0]["plain"][1])


@pytest.mark.parametrize("name", [n for n in _cases() if n.startswith("ivfpq")])
def test_sharded_ivfpq_matches_jax_and_each_shard_is_jax_slice(ranks: dict, jax_indexes: dict, name: str) -> None:
    w = ranks["w"]
    jix, want_s, want_i = _jax_answer(jax_indexes, name, w)
    _assert_same(name, *_merged(name, ranks[name], w), want_s, want_i)
    c = int(jix.centroids.shape[0])
    slots = jix.slots_per_shard
    for rank, r in enumerate(ranks[name]):
        assert (r["meta"]["slots_per_shard"], r["meta"]["max_windows"]) == (slots, jix.max_windows), name
        assert r["meta"]["spilled"] == jix.spilled
        for key, size in (("win_start", c), ("win_count", c), ("row_ids", slots)):
            want = np.asarray(getattr(jix, key))[rank * size:(rank + 1) * size]
            np.testing.assert_array_equal(r["arrays"][key], want, err_msg=f"{name} rank {rank} {key}")
        if jix.refine_codes is not None:
            np.testing.assert_array_equal(r["arrays"]["refine_codes"],
                                          np.asarray(jix.refine_codes)[rank * slots:(rank + 1) * slots])


def test_shards_of_empty_cells_gather_padding(ranks: dict, jax_indexes: dict) -> None:
    """Odd cells empty: their owners' window tables count nothing and their
    layouts are padding, and they gather the same shapes as the others (the
    answers equal JAX's above). A query that probes only empty cells gets
    -1s, as in JAX; the others get real rows."""
    for rank, r in enumerate(ranks["ivfpq-empty"]):
        if rank % 2:
            assert r["arrays"]["win_count"].sum() == 0 and (r["arrays"]["row_ids"] == -1).all()
        assert r["ids"].shape == (B, K) and (r["ids"] >= 0).any(axis=1).sum() >= B - 2


def test_untruncated_ivfpq_keeps_the_unsharded_answer(ranks: dict) -> None:
    """Without a window budget every probed cell is scanned whole on its
    owner: the sharded answer is the unsharded one (ids where the score
    margin exceeds the tolerance)."""
    for name in ("ivfpq-refine", "ivfpq-adc", "ivfpq-spilled"):
        r = ranks[name][0]
        ps, pi = r["plain"]
        _assert_same(name, r["scores"], r["ids"], ps, pi)
