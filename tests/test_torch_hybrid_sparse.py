"""The port's hybrid with three engines (gold lookup, dense, BM25) against the
JAX package's, on the CPU: `hybrid_search`, `hybrid_search_and_sample`, the
sparse and hybrid factory, and a `SearchServer` answering requests with
terms.

With three engines the merge runs its second shifted comparison, which two
engines never reach: each case has an id that all three engines return.
The weights are {dense 1, sparse 1} and the yaml's step 0, {dense 0.0,
sparse 1.0}. Tolerances: merged ids and labels equal; scores and per-engine
raw scores within 1e-5 (f32 sums in another order); the sampler's
log-weights within 1e-5 with JAX's draws fed in (`jax_labeled_noise`).
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from tests.test_torch_sample import jax_labeled_noise
from tests.torch_helpers import CPU, np_of
from vod_tpu.configs.search import HybridSearchFactoryConfig as JaxHybridConfig
from vod_tpu.configs.search import SparseFactoryConfig as JaxSparseConfig
from vod_tpu.search import HybridEngines as JaxEngines
from vod_tpu.search import SearchQueries as JaxQueries
from vod_tpu.search import build_dense_index as jax_build_dense
from vod_tpu.search import build_sparse_index as jax_build_sparse
from vod_tpu.search.factory import build_hybrid_engines as jax_build_hybrid
from vod_tpu.search.factory import build_sparse_from_config as jax_build_sparse_cfg
from vod_tpu.search.hybrid import hybrid_search as jax_hybrid
from vod_tpu.search.hybrid import hybrid_search_and_sample as jax_hss
from vod_tpu.serving import SearchHttpClient as JaxClient
from vod_tpu.serving import SearchServer as JaxServer
from vod_tpu_torch.configs import DenseFactoryConfig, HybridSearchFactoryConfig, SparseFactoryConfig
from vod_tpu_torch.models.convert import sparse_index_from_fields
from vod_tpu_torch.search import (
    HybridEngines,
    SearchQueries,
    SparseIndex,
    build_dense_index,
    build_hybrid_engines,
    build_sparse_from_config,
    hybrid_search,
    hybrid_search_and_sample,
)
from vod_tpu_torch.serving import SearchHttpClient, SearchServer

ROOT = Path(__file__).resolve().parent.parent
ATOL = 1e-5
N, D, B, L, T = 300, 16, 4, 5, 64
SHARED = 42  # the id all three engines return for query 0
WEIGHTS = {"both": {"dense": 1.0, "sparse": 1.0}, "yaml-step-0": {"dense": 0.0, "sparse": 1.0}}


def _data(seed: int = 0):
    """Corpus vectors and term lists; queries near a corpus row, with that
    row's terms plus noise terms, and gold ids (query 0's is SHARED)."""
    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(N, D)).astype(np.float32)
    docs = [rng.integers(0, T, size=int(rng.integers(4, 12))).tolist() for _ in range(N)]
    src = np.asarray([SHARED, 7, 100, 250])
    q = emb[src] + 0.2 * rng.normal(size=(B, D)).astype(np.float32)
    terms = np.full((B, L), -1, np.int32)
    for r, s in enumerate(src):
        picked = docs[s][:3] + rng.integers(0, T, 1).tolist()
        terms[r, : len(picked)] = picked
    gold = np.asarray([[SHARED, -1], [8, 9], [-1, -1], [250, 3]], np.int32)
    return emb, docs, q, terms, gold


def _engines(emb, docs):
    jeng = JaxEngines(dense=jax_build_dense(jnp.asarray(emb), dtype="float32"),
                      sparse=jax_build_sparse(docs, n_terms=T, max_postings=32))
    sp = jeng.sparse
    teng = HybridEngines(
        dense=build_dense_index(emb, dtype="float32", device=CPU),
        sparse=sparse_index_from_fields({"postings_docs": sp.postings_docs, "postings_impacts": sp.postings_impacts,
                                         "n_docs": sp.n_docs}, device=CPU),
    )
    return jeng, teng


@pytest.mark.parametrize("weights", list(WEIGHTS), ids=list(WEIGHTS))
def test_hybrid_search_three_engines_matches_jax(weights: str) -> None:
    emb, docs, q, terms, gold = _data(0)
    jeng, teng = _engines(emb, docs)
    k = 10
    w = WEIGHTS[weights]
    jm, jraw = jax_hybrid(jeng, JaxQueries(vector=jnp.asarray(q), terms=jnp.asarray(terms),
                                           section_ids=jnp.asarray(gold)), k, w)
    tm, traw = hybrid_search(teng, SearchQueries(vector=torch.from_numpy(q), terms=torch.from_numpy(terms),
                                                 section_ids=torch.from_numpy(gold)), k, w)
    np.testing.assert_array_equal(np_of(tm.indices), np_of(jm.indices))
    np.testing.assert_array_equal(np_of(tm.labels), np_of(jm.labels))
    np.testing.assert_allclose(np_of(tm.scores), np_of(jm.scores), atol=ATOL, rtol=0)
    assert set(traw) == set(jraw) == {"dense", "sparse"}
    for name in traw:
        np.testing.assert_allclose(np_of(traw[name]), np_of(jraw[name]), atol=ATOL, rtol=0, equal_nan=True)
    # the shared id: one merged slot, label 1, both engines' raw scores, the weighted sum
    row = np_of(tm.indices)[0].tolist()
    assert row.count(SHARED) == 1
    c = row.index(SHARED)
    dense, sparse = np_of(traw["dense"])[0, c], np_of(traw["sparse"])[0, c]
    assert np_of(tm.labels)[0, c] == 1 and np.isfinite(dense) and np.isfinite(sparse)
    assert np_of(tm.scores)[0, c] == pytest.approx(w["dense"] * dense + w["sparse"] * sparse, abs=ATOL)
    if weights == "yaml-step-0":  # the dense engine's ids stay, scored by BM25 alone (0 where it has none)
        live = np.isfinite(np_of(tm.scores))
        assert (~np.isnan(np_of(traw["dense"]))[live]).sum() > 0
        sparse_only = np.nan_to_num(np_of(traw["sparse"]), nan=0.0)
        np.testing.assert_allclose(np_of(tm.scores)[live], sparse_only[live], atol=ATOL, rtol=0)


@pytest.mark.parametrize("weights", list(WEIGHTS), ids=list(WEIGHTS))
def test_hybrid_search_and_sample_three_engines_matches_jax(weights: str) -> None:
    emb, docs, q, terms, gold = _data(1)
    jeng, teng = _engines(emb, docs)
    prefetch, total = 12, 6
    w = WEIGHTS[weights]
    key = jax.random.PRNGKey(3)
    js, jm = jax.jit(
        lambda r, e, qq: jax_hss(r, e, qq, prefetch=prefetch, total=total, max_pos_sections=2, weights=w)
    )(key, jeng, JaxQueries(vector=jnp.asarray(q), terms=jnp.asarray(terms), section_ids=jnp.asarray(gold)))
    ts, tm = hybrid_search_and_sample(
        teng, SearchQueries(vector=torch.from_numpy(q), terms=torch.from_numpy(terms),
                            section_ids=torch.from_numpy(gold)),
        prefetch=prefetch, total=total, max_pos_sections=2, weights=w, noise=jax_labeled_noise(key, B, prefetch),
    )
    np.testing.assert_array_equal(np_of(tm.indices), np_of(jm.indices))
    np.testing.assert_array_equal(np_of(tm.labels), np_of(jm.labels))
    np.testing.assert_allclose(np_of(tm.scores), np_of(jm.scores), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(np_of(ts.batch.indices), np_of(js.batch.indices))
    np.testing.assert_array_equal(np_of(ts.batch.labels), np_of(js.batch.labels))
    for name in ("log_weights", "lse_pos", "lse_neg"):
        np.testing.assert_allclose(np_of(getattr(ts, name)), np_of(getattr(js, name)), atol=ATOL, rtol=0)
    for name in ("dense", "sparse"):
        np.testing.assert_allclose(np_of(ts.raw_scores[name]), np_of(js.raw_scores[name]), atol=ATOL,
                                   equal_nan=True)


def test_sparse_and_hybrid_configs_match_jax() -> None:
    assert dataclasses.asdict(SparseFactoryConfig()) == JaxSparseConfig().model_dump()
    assert dataclasses.asdict(HybridSearchFactoryConfig()) == JaxHybridConfig().model_dump()
    diff = {"max_postings": 4096, "k1": 0.9, "language": None}
    assert dataclasses.asdict(SparseFactoryConfig() + diff) == (JaxSparseConfig() + diff).model_dump()
    both = {"dense": {"codec": "pq", "coarse_dim": None}, "sparse": {"max_postings": 64, "stem": True}}
    got = HybridSearchFactoryConfig(dense=DenseFactoryConfig(**both["dense"]), sparse=SparseFactoryConfig(**both["sparse"]))
    assert dataclasses.asdict(got) == JaxHybridConfig(**both).model_dump()
    with pytest.raises(TypeError):
        SparseFactoryConfig() + {"no_such_field": 1}
    with pytest.raises(dataclasses.FrozenInstanceError):
        got.sparse = None


def test_msmarco_pq_realm_sparse_and_schedules_are_the_yaml() -> None:
    """What the card smoke run's phase 6 builds and weights is exactly
    `configs/msmarco_pq_realm.yaml`'s `search_defaults.sparse` and
    `trainer.parameters`."""
    import chip_smoke

    cfg = yaml.safe_load((ROOT / "configs" / "msmarco_pq_realm.yaml").read_text())
    assert chip_smoke.PERIODIC_SPARSE == cfg["search_defaults"]["sparse"]
    assert chip_smoke.PERIODIC_PARAMETERS == cfg["trainer"]["parameters"]
    assert (SparseFactoryConfig() + chip_smoke.PERIODIC_SPARSE).k1 == 1.2


def test_build_sparse_from_config_and_hybrid_engines_match_jax() -> None:
    emb, docs, _, _, _ = _data(2)
    subsets = (np.arange(N) % 3).astype(np.int32)
    cfg = SparseFactoryConfig(max_postings=16, k1=1.0, b=0.6)
    jcfg = JaxSparseConfig(max_postings=16, k1=1.0, b=0.6)
    want = jax_build_sparse_cfg(jcfg, docs, n_terms=T, subset_ids=subsets)
    got = build_sparse_from_config(cfg, docs, n_terms=T, subset_ids=subsets, device=CPU)
    assert isinstance(got, SparseIndex) and got.n_docs == want.n_docs == N
    for name in ("postings_docs", "postings_impacts", "subset_ids"):
        np.testing.assert_array_equal(np_of(getattr(got, name)), np_of(getattr(want, name)))

    hcfg = HybridSearchFactoryConfig(dense=DenseFactoryConfig(codec="flat", dtype="float32"), sparse=cfg)
    jh = jax_build_hybrid(JaxHybridConfig(dense={"codec": "flat", "dtype": "float32"}, sparse=jcfg.model_dump()),
                          vectors=jnp.asarray(emb), doc_terms=docs, subset_ids=jnp.asarray(subsets))
    th = build_hybrid_engines(hcfg, vectors=emb, doc_terms=docs, subset_ids=subsets, device=CPU)
    np.testing.assert_array_equal(np_of(th.dense.vectors[:N]), np_of(jh.dense.vectors[:N]))
    # the factory's default vocabulary is 2^18 terms, as in JAX
    assert th.sparse.postings_docs.shape == tuple(jh.sparse.postings_docs.shape)
    np.testing.assert_array_equal(np_of(th.sparse.postings_docs), np_of(jh.sparse.postings_docs))
    np.testing.assert_array_equal(np_of(th.sparse.subset_ids), subsets)
    only_sparse = build_hybrid_engines(HybridSearchFactoryConfig(sparse=cfg), vectors=emb, doc_terms=docs, device=CPU)
    assert only_sparse.dense is None and isinstance(only_sparse.sparse, SparseIndex)
    assert build_hybrid_engines(hcfg, device=CPU) == HybridEngines()


@pytest.mark.parametrize("call", ["sparse-mesh", "hybrid-mesh"])
def test_unported_options_raise(call: str) -> None:
    docs = [[1, 2], [3]]
    cfg = HybridSearchFactoryConfig(sparse=SparseFactoryConfig(sharded=True))
    with pytest.raises(NotImplementedError):
        if call == "sparse-mesh":
            build_sparse_from_config(SparseFactoryConfig(), docs, mesh=object(), device=CPU)
        else:
            build_hybrid_engines(cfg, doc_terms=docs, mesh=object(), device=CPU)


def test_sharded_flag_without_a_mesh_builds_the_plain_index_as_jax_does() -> None:
    docs = [[1, 2], [3, 3, 1]]
    cfg = HybridSearchFactoryConfig(sparse=SparseFactoryConfig(sharded=True))
    assert isinstance(build_hybrid_engines(cfg, doc_terms=docs, device=CPU).sparse, SparseIndex)
    assert type(jax_build_hybrid(JaxHybridConfig(sparse={"sharded": True}), doc_terms=docs).sparse).__name__ == "SparseIndex"
    import inspect

    for fn in (build_sparse_from_config, build_hybrid_engines):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn


def test_search_server_with_a_sparse_engine_matches_jax() -> None:
    """A request with vectors and terms, one with terms alone, and one with
    gold lookups: the port's server answers as the JAX server does."""
    emb, docs, q, terms, gold = _data(3)
    jeng, teng = _engines(emb, docs)
    w = {"dense": 1.0, "sparse": 0.5}
    requests = [dict(vector=q, terms=terms), dict(terms=terms[:2]), dict(vector=q[1:3], terms=terms[1:3],
                                                                         section_ids=gold[1:3])]
    with JaxServer(jeng, weights=w) as jsrv, SearchServer(teng, weights=w, device="cpu") as tsrv:
        for req in requests:
            j = JaxClient(jsrv.url).search(top_k=8, **req)
            t = SearchHttpClient(tsrv.url).search(top_k=8, **req)
            np.testing.assert_array_equal(t.indices, j.indices)
            np.testing.assert_allclose(t.scores, j.scores, atol=ATOL, rtol=0)
            assert set(t.meta) == set(j.meta) and "sparse" in t.meta
            for name in t.meta:
                np.testing.assert_allclose(t.meta[name], j.meta[name], atol=ATOL, rtol=0, equal_nan=True)
            assert (t.labels is None) == (j.labels is None)
            if t.labels is not None:
                np.testing.assert_array_equal(t.labels, j.labels)
    with pytest.raises(ValueError, match="engines live on"):
        SearchServer(HybridEngines(sparse=teng.sparse))  # the default device is cuda


def test_search_server_takes_a_pq_index() -> None:
    """A `PQIndex` has no `vectors` field; the server used to read it to
    check the engines' device and refused the index with `AttributeError`,
    where the JAX server serves it. Now it answers with what a direct
    `hybrid_search` returns, and still refuses engines on another device."""
    from vod_tpu_torch.search import build_pq_index, build_sparse_index

    emb, docs, q, terms, _ = _data(4)
    pq = build_pq_index(emb, n_subquantizers=4, coarse_dim=None, kmeans_iters=2, refine="int8",
                        generator=torch.Generator().manual_seed(0), device=CPU)
    engines = HybridEngines(dense=pq, sparse=build_sparse_index(docs, n_terms=T, max_postings=32, device=CPU))
    with SearchServer(engines, device="cpu") as srv:
        out = SearchHttpClient(srv.url).search(vector=q, terms=terms, top_k=6)
    want, _ = hybrid_search(engines, SearchQueries(vector=torch.from_numpy(q), terms=torch.from_numpy(terms)), 6)
    np.testing.assert_array_equal(out.indices, np_of(want.indices))
    np.testing.assert_allclose(out.scores, np_of(want.scores), atol=ATOL, rtol=0)
    with pytest.raises(ValueError, match="engines live on"):
        SearchServer(HybridEngines(dense=pq))
