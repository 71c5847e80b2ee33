"""The port of `examples/hybrid_sharded_bench.py` against the JAX package on
the CPU, at a small size (4,096 x 64 rows, 2,000 terms, B = 32; the
script's draws and widths otherwise).

Two gloo CPU ranks (`tests/torch_helpers.py:run_ranks`) run the script's
`run` (its own filter and agreement checks), then return the unsharded and
sharded ids. Checked: the data are the JAX script's draws; every id passes
its row's subset filter; the sharded ids equal the port's unsharded ids (a
shard scores its rows as the whole index does, so no bf16 tie can split
them here); the port's unsharded ids agree with JAX's unsharded
`hybrid_search` on the same arrays, and its sharded ids with JAX's sharded
route over a 2-device mesh of the 8 JAX CPU devices (conftest.py), in at least
`MIN_OVERLAP_JAX` of each row's ids on average (JAX's bf16 dot products
and approximate top-k may order near-ties otherwise).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tests.torch_helpers import job_hybrid_sharded, run_ranks
from vod_tpu_torch.examples import hybrid_sharded_bench as hb

SIZES = dict(n=4096, d=64, b=32, n_terms=2000)
MIN_OVERLAP_JAX = 0.97


def _jax_ids(data: dict, sharded: bool) -> np.ndarray:
    from vod_tpu.parallel import make_mesh
    from vod_tpu.search import (
        HybridEngines,
        SearchQueries,
        build_dense_index,
        build_sharded_dense_index,
        build_sparse_index_native,
        hybrid_search,
        shard_sparse_index,
    )

    sparse = build_sparse_index_native(data["doc_terms"], n_terms=data["n_terms"], max_postings=256,
                                       subset_ids=data["subsets"])
    corpus, subsets = jnp.asarray(data["corpus"]), jnp.asarray(data["subsets"])
    if sharded:
        mesh = make_mesh((2,), ("shard",))
        engines = HybridEngines(
            dense=build_sharded_dense_index(corpus, mesh, dtype="bfloat16", subset_ids=subsets),
            sparse=shard_sparse_index(sparse, mesh),
        )
    else:
        engines = HybridEngines(dense=build_dense_index(corpus, subset_ids=subsets, dtype="bfloat16"), sparse=sparse)
    q = SearchQueries(vector=jnp.asarray(data["q_vector"]), terms=jnp.asarray(data["q_terms"]),
                      subset_ids=jnp.asarray(data["q_subsets"]))
    f = jax.jit(lambda qv, qt, qs: hybrid_search(
        engines, SearchQueries(vector=qv, terms=qt, subset_ids=qs), top_k=hb.K)[0].indices)
    return np.asarray(f(q.vector, q.terms, q.subset_ids))


def _jax_script_data(n: int, d: int, b: int, n_terms: int) -> dict:
    """The JAX script's draws, as written there."""
    rng = np.random.default_rng(0)
    corpus = rng.standard_normal((n, d), dtype=np.float32)
    corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
    subsets = rng.integers(0, 8, size=n).astype("int32")
    doc_terms = [rng.integers(0, n_terms, size=12).tolist() for _ in range(n)]
    q_vec = corpus[rng.choice(n, b, replace=False)] + 0.05 * rng.standard_normal((b, d)).astype(np.float32)
    return dict(corpus=corpus, subsets=subsets, doc_terms=doc_terms,
                q_vector=q_vec / np.linalg.norm(q_vec, axis=1, keepdims=True),
                q_terms=rng.integers(0, n_terms, size=(b, 6)).astype("int32"),
                q_subsets=np.stack([rng.permutation(8)[:4] for _ in range(b)]).astype("int32"))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory) -> tuple:
    out = run_ranks(job_hybrid_sharded, 2, tmp_path_factory.mktemp("hybrid"), SIZES)
    return out[0]


def test_the_data_are_the_jax_scripts_draws() -> None:
    got, want = hb.make_data(**SIZES), _jax_script_data(**SIZES)
    for key, value in want.items():
        if key == "doc_terms":
            assert got[key] == value
        else:
            assert got[key].dtype == value.dtype and np.array_equal(got[key], value), key


def test_two_ranks_run_the_script_and_check_it(ranks) -> None:
    result, _, _ = ranks
    assert list(result)[:4] == ["metric", "value", "unit", "vs_baseline"] and result["card"] == "cpu"
    assert result["agreement"] >= hb.MIN_AGREEMENT and result["value"] > 0
    assert result["unit"] == "QPS (2 gloo ranks, cpu)" and len(result["sharded_s"]) == 3
    json.dumps(result)


def test_every_id_passes_its_rows_subset_filter(ranks) -> None:
    _, unsharded, sharded = ranks
    data = hb.make_data(**SIZES)
    for ids in (unsharded, sharded):
        # the merge of the dense and the sparse top-k: up to 2k ids a row, -1 after the union
        assert ids.shape == (SIZES["b"], 2 * hb.K) and (ids[:, : hb.K] >= 0).all() and (ids >= -1).all()
        hb.check_filter(ids, data["subsets"], data["q_subsets"], "ids")
        assert all(np.isin(data["subsets"][row[row >= 0]], allowed).all()
                   for row, allowed in zip(ids, data["q_subsets"]))
    with pytest.raises(AssertionError, match="outside"):
        bad = unsharded.copy()
        bad[0, 0] = int(np.flatnonzero(~np.isin(data["subsets"], data["q_subsets"][0]))[0])
        hb.check_filter(bad, data["subsets"], data["q_subsets"], "bad")


def test_sharded_ids_equal_the_unsharded_ones(ranks) -> None:
    _, unsharded, sharded = ranks
    assert np.array_equal(sharded, unsharded)
    assert hb.agreement(sharded, unsharded) == 1.0


@pytest.mark.parametrize("route", ["unsharded", "sharded"])
def test_ids_agree_with_jax(route: str, ranks) -> None:
    _, unsharded, sharded = ranks
    want = _jax_ids(hb.make_data(**SIZES), sharded=route == "sharded")
    got = sharded if route == "sharded" else unsharded
    assert hb.agreement(got, want) >= MIN_OVERLAP_JAX


def test_without_a_card_it_raises() -> None:
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        hb.main([])
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        hb.main(["--launch", "0", "--processes", "1", "--process_id", "0"])
