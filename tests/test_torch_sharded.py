"""The port's sharded search (`vod_tpu_torch/search/sharded.py`) against the
JAX package's `sharded_dense_search` / `sharded_sparse_search` at W = 2 and
4 shards.

JAX runs on the root conftest's 8-device virtual CPU mesh (its fused branch
runs the Pallas kernel in interpret mode); the port runs W CPU ranks of one
gloo group (`tests/torch_helpers.py:run_ranks`), each holding its shard, and
its fused branch runs the kernel's plain version. Every case of one W runs
in one group (`job_sequence`), once per module.

Tolerances: ids equal and scores within 1e-5 for f32 and int8; bf16 scores
within 2e-2, and bf16 ids compared only where the score margin to the next
candidate exceeds that (the two sides sum bf16 products in other orders).
"""

import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

import jax
from tests.torch_helpers import job_sequence, job_sharded_dense, job_sharded_sparse, run_ranks, unit_rows
from vod_tpu.search import SearchQueries as JaxQueries
from vod_tpu.search.sharded import build_sharded_dense_index as jax_build
from vod_tpu.search.sharded import shard_sparse_index as jax_shard_sparse
from vod_tpu.search.sharded import sharded_dense_search as jax_dense
from vod_tpu.search.sharded import sharded_sparse_search as jax_sparse
from vod_tpu.search.sparse import build_sparse_index as jax_build_sparse

N, D, B, K = 300, 32, 6, 10
WORLDS = (2, 4)


def _dense_cases() -> dict:
    """name -> (vectors, build kwargs, query fields); one seed for all."""
    rng = np.random.default_rng(0)
    x = unit_rows(rng, N, D)
    q = unit_rows(rng, B, D)
    subsets = (np.arange(N) % 4).astype(np.int32)
    allowed = np.array([[1, -1], [0, 2], [-1, -1], [3, 3], [2, -1], [0, 1]], np.int32)
    corpus = (np.arange(N) % 3).astype(np.int32)
    route = np.array([0, 1, 2, -1, 1, 0], np.int32)
    tied = np.concatenate([x[:128], x[:128]])  # row i and i + 128 score the same, on different shards
    scan = dict(approx_recall=None)
    return {
        "f32": (x, dict(dtype="float32", **scan), dict(vector=q)),
        "bf16": (x, dict(dtype="bfloat16", **scan), dict(vector=q)),
        "int8": (x, dict(dtype="int8", **scan), dict(vector=q)),
        "subset": (x, dict(dtype="float32", subset_ids=subsets, **scan), dict(vector=q, subset_ids=allowed)),
        "route": (x, dict(dtype="float32", corpus_shard=corpus, **scan), dict(vector=q, shard=route)),
        "ties": (tied, dict(dtype="float32", **scan), dict(vector=q)),
        "fused-int8": (x, dict(dtype="int8", kernel="fused", approx_recall=0.95), dict(vector=q)),
        "fused-f32": (x, dict(dtype="float32", kernel="fused", approx_recall=0.95), dict(vector=q)),
    }


def _sparse_table(seed: int = 0, n_docs: int = 90, n_terms: int = 40):
    rng = np.random.default_rng(seed)
    docs = [rng.integers(0, n_terms, size=rng.integers(3, 12)).tolist() for _ in range(n_docs)]
    subsets = (np.arange(n_docs) % 3).astype(np.int32)
    index = jax_build_sparse(docs, n_terms=n_terms, max_postings=64, subset_ids=subsets)
    terms = rng.integers(-1, n_terms, size=(B, 5)).astype(np.int32)
    weights = rng.uniform(0.5, 2.0, size=(B, 5)).astype(np.float32)
    allowed = np.array([[0, -1], [1, 2], [-1, -1], [2, 2], [0, 1], [-1, -1]], np.int32)
    return index, dict(terms=terms, term_weights=weights), dict(terms=terms, subset_ids=allowed)


def _jax_mesh(w: int, axis: str = "shard") -> Mesh:
    return Mesh(np.array(jax.devices()[:w]), (axis,))


def _jax_queries(fields: dict) -> JaxQueries:
    return JaxQueries(**{k: jnp.asarray(v) for k, v in fields.items()})


def _table_fields(index) -> dict:
    return dict(postings_docs=np.asarray(index.postings_docs), postings_impacts=np.asarray(index.postings_impacts),
                subset_ids=np.asarray(index.subset_ids), n_docs=index.n_docs)


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"W{w}")
def ranks(request, tmp_path_factory) -> dict:
    """Every port case at one W, run once: name -> rank results."""
    w = request.param
    calls, names = [], []
    for name, (x, kw, q) in _dense_cases().items():
        names.append(name)
        calls.append((job_sharded_dense, (x, (w,), ("shard",), "shard", kw, q, K)))
    x, kw, q = _dense_cases()["int8"]
    names.append("split")  # the batch's rows split over the index's own axis
    calls.append((job_sharded_dense, (x, (w,), ("dp",), "dp", kw, q, K, "dp")))
    index, q_plain, q_subset = _sparse_table()
    for name, q in (("bm25", q_plain), ("bm25-subset", q_subset)):
        names.append(name)
        calls.append((job_sharded_sparse, (_table_fields(index), "shard", q, K)))
    names.append("bm25-split")
    calls.append((job_sharded_sparse, (_table_fields(index), "dp", q_plain, K, "dp")))
    out = run_ranks(job_sequence, w, tmp_path_factory.mktemp(f"sharded{w}"), calls)
    return {"w": w, **{name: [rank[i] for rank in out] for i, name in enumerate(names)}}


def _assert_close(name: str, got_s, got_i, want_s, want_i) -> None:
    want_s, want_i = np.asarray(want_s, np.float32), np.asarray(want_i)
    fin = np.isfinite(want_s)
    np.testing.assert_array_equal(np.isfinite(got_s), fin, err_msg=name)
    tol = 2e-2 if name == "bf16" else 1e-5
    np.testing.assert_allclose(got_s[fin], want_s[fin], atol=tol, rtol=0, err_msg=name)
    if name == "bf16":
        # ids where the margin to both neighbours exceeds the tolerance
        s = np.where(fin, want_s, -1e9)
        gap = np.minimum(np.abs(np.diff(s, axis=1, prepend=1e9)), np.abs(np.diff(s, axis=1, append=-1e9)))
        clear = gap > tol
        np.testing.assert_array_equal(got_i[clear], want_i[clear], err_msg=name)
    else:
        np.testing.assert_array_equal(got_i, want_i, err_msg=name)


@pytest.mark.parametrize("name", list(_dense_cases()))
def test_sharded_dense_search_matches_jax(ranks: dict, name: str) -> None:
    w = ranks["w"]
    x, kw, q = _dense_cases()[name]
    mesh = _jax_mesh(w)
    jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    jr = jax_dense(jax_build(jnp.asarray(x), mesh, axis="shard", **jkw), _jax_queries(q), K)
    for s, i, _ in ranks[name]:  # every rank holds the merged answer
        _assert_close(name, s, i, jr.scores, jr.indices)
    if name == "ties":
        # equal scores on two shards: the lower shard (the lower global id) comes first
        i = ranks[name][0][1]
        assert (i[:, ::2] < 128).all() and (i[:, 1::2] == i[:, ::2] + 128).all()
    if name.startswith("fused"):
        reals = [r[2] for r in ranks[name]]
        assert reals[0] == N and reals[1:] == [0] * (w - 1)  # every real row on rank 0: the others are padding


def test_batch_split_over_the_index_axis_gathers_the_queries(ranks: dict) -> None:
    """Each rank passes its block of the query rows; the answer for its rows
    equals JAX's for the whole (replicated) batch."""
    w = ranks["w"]
    x, kw, q = _dense_cases()["int8"]
    jr = jax_dense(jax_build(jnp.asarray(x), _jax_mesh(w), axis="shard", **kw), _jax_queries(q), K)
    got_s = np.concatenate([r[0] for r in ranks["split"]])
    got_i = np.concatenate([r[1] for r in ranks["split"]])
    if B % w:  # a batch that does not divide stays whole on every rank
        got_s, got_i = ranks["split"][0][0], ranks["split"][0][1]
    _assert_close("split", got_s, got_i, jr.scores, jr.indices)


@pytest.mark.parametrize("name", ["bm25", "bm25-subset", "bm25-split"])
def test_sharded_bm25_equals_jax_and_the_unsharded_index(ranks: dict, name: str) -> None:
    from vod_tpu.search.sparse import sparse_search as jax_unsharded

    w = ranks["w"]
    index, q_plain, q_subset = _sparse_table()
    q = q_subset if name == "bm25-subset" else q_plain
    axis = "dp" if name == "bm25-split" else "shard"
    jr = jax_sparse(jax_shard_sparse(index, _jax_mesh(w, axis), axis=axis), _jax_queries(q), K)
    plain = jax_unsharded(index, _jax_queries(q), K)
    np.testing.assert_array_equal(np.asarray(jr.indices), np.asarray(plain.indices))  # doc ranges keep the answer
    results = ranks[name]
    if name == "bm25-split" and B % w == 0:
        got = (np.concatenate([r[0] for r in results]), np.concatenate([r[1] for r in results]))
    else:
        got = results[0][:2]
        for r in results:
            np.testing.assert_array_equal(r[1], got[1])
    _assert_close(name, got[0], got[1], jr.scores, jr.indices)
    # the shards' tables share one width: the widest doc range's, as JAX stacks them
    assert len({r[2] for r in results}) == 1
