"""The port's IVF-PQ (`vod_tpu_torch/search/ivfpq.py`), its factory branch,
the index cache and its dispatch, against the JAX package's.

The search runs on indexes built by JAX and carried across
(`models/convert.py:ivfpq_index_from_fields`), so both packages search
identical arrays, in every scoring mode. Toy sizes: 2048 rows of D = 32
(decaying spectrum, unit norm), 12 queries, top 10, 16 cells, 64-row windows.

Tolerances: scores within 1e-5 of their size (f32 sums in other orders; the
int8 products sum exactly on both sides, but the query's projection feeding
its int8 rounding is an f32 product); ids equal wherever the margin to the
neighbouring score exceeds that (`_assert_same`). With every cell probed and
f32 refine rows the search is exact: the ids are a float64 top-10's. The
layout and the probe lists are equal bit for bit.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_helpers import CPU, np_of
from vod_tpu.configs.search import DenseFactoryConfig as JaxConfig
from vod_tpu.search import ivfpq as jax_ivfpq
from vod_tpu.search.base import SearchQueries as JaxQueries
from vod_tpu.search.factory import _index_fingerprint as jax_fingerprint
from vod_tpu.search.factory import build_dense_from_config as jax_build_cfg
from vod_tpu_torch.configs import DenseFactoryConfig, HybridSearchFactoryConfig
from vod_tpu_torch.models.convert import ivfpq_index_from_fields
from vod_tpu_torch.search import (
    HybridEngines,
    IVFPQIndex,
    SearchQueries,
    build_dense_from_config,
    build_hybrid_engines,
    build_ivfpq_index,
    hybrid_search,
    ivfpq_search,
)
from vod_tpu_torch.search import factory, ivfpq
from vod_tpu_torch.serving import SearchHttpClient, SearchServer

N, D, B, K = 2048, 32, 12, 10
TOL = 1e-5

# (name, build kwargs): every scoring mode of ivfpq_search
BUILDS = {
    "int8-pca": dict(refine="int8", refine_dim=16, keep_codes=False),
    "int8": dict(n_subquantizers=8, refine="int8"),
    "f32": dict(n_subquantizers=8, refine="float32"),
    "bf16": dict(n_subquantizers=8, refine="bfloat16", use_opq=True, opq_iters=1),
    "adc8": dict(n_subquantizers=8),
    "adc4": dict(n_subquantizers=8, code_bits=4),
    "adc8-opq": dict(n_subquantizers=8, use_opq=True, opq_iters=1),
    "rerank-int8": dict(n_subquantizers=8, rerank="int8", rerank_dim=16, k_factor=4),
    "rerank-f32": dict(refine="int8", refine_dim=16, keep_codes=False, rerank="float32", k_factor=8),
    "spilled": dict(refine="int8", keep_codes=False, spill=True),
    "spilled-adc4-rerank": dict(n_subquantizers=8, code_bits=4, spill=True, rerank="bfloat16", k_factor=4),
    "truncated": dict(n_subquantizers=8, refine="int8", max_windows=3),
}


def _rows(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    spec = np.exp(-np.arange(D) / 12.0).astype(np.float32)
    x = rng.standard_normal((n, D), dtype=np.float32) * spec
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _corpus() -> np.ndarray:
    return _rows(N, 0)


def _query_vectors(b: int = B) -> np.ndarray:
    x = _corpus()
    q = x[:b] + 0.05 * np.random.default_rng(1).standard_normal((b, D)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _fields(index) -> dict:
    return {k: (np.asarray(v) if hasattr(v, "shape") else v) for k, v in vars(index).items()}


@functools.lru_cache(maxsize=None)
def _built(name: str):
    """(JAX index, the port's copy of it), with 16 subset ids on the rows."""
    subset = (np.arange(N) % 16).astype(np.int32)
    ji = jax_ivfpq.build_ivfpq_index(jax.random.PRNGKey(0), jnp.asarray(_corpus()), n_clusters=16, nprobe=4,
                                     window=64, kmeans_iters=3, subset_ids=jnp.asarray(subset), **BUILDS[name])
    return ji, ivfpq_index_from_fields(_fields(ji), device=CPU)


def _queries(subset: bool = False, b: int = B):
    q = _query_vectors(b)
    sub = None
    if subset:
        sub = np.array([[3, 7], [0, -1], [-1, -1], [5, 5], [15, 2], [1, -1]] * (b // 6 + 1), np.int32)[:b]
    return (JaxQueries(vector=jnp.asarray(q), subset_ids=None if sub is None else jnp.asarray(sub)),
            SearchQueries(vector=torch.from_numpy(q), subset_ids=None if sub is None else torch.from_numpy(sub)))


def _assert_same(jout, tout) -> None:
    """Scores within TOL of their size; an id may differ from JAX's only
    where JAX holds it at a score within that band of the slot's score."""
    js, ts = np_of(jout.scores), np_of(tout.scores)
    ji, ti = np_of(jout.indices), np_of(tout.indices)
    np.testing.assert_array_equal(np.isfinite(ts), np.isfinite(js))
    fin = np.isfinite(js)
    band = TOL * max(1.0, float(np.abs(js[fin]).max())) if fin.any() else TOL
    np.testing.assert_allclose(ts[fin], js[fin], rtol=0, atol=band)
    for r, c in zip(*np.nonzero(ti != ji)):
        where = np.nonzero(ji[r] == ti[r, c])[0]
        other = js[r, where[0]] if len(where) else js[r, -1]
        assert abs(other - js[r, c]) <= 2 * band, (r, c, ti[r], ji[r])


CASES = [(name, False) for name in BUILDS] + [(n, True) for n in ("int8-pca", "adc8", "spilled", "rerank-int8")]


@pytest.mark.parametrize("name, subset", CASES, ids=[f"{n}{'-subset' if s else ''}" for n, s in CASES])
def test_ivfpq_search_matches_jax(name: str, subset: bool) -> None:
    """Refine rows scored directly (int8 with and without PCA, f32, bf16),
    the ADC decode (8- and 4-bit, OPQ), the rerank store (int8 over PCA,
    f32), SOAR-spilled indexes (dedup), a truncated window budget, and the
    subset filter."""
    ji, ti = _built(name)
    assert ti.spilled == ji.spilled and ti.max_windows == ji.max_windows
    jq, tq = _queries(subset)
    tout = ivfpq_search(ti, tq, top_k=K)
    _assert_same(jax_ivfpq.ivfpq_search(ji, jq, top_k=K), tout)
    ids = np_of(tout.indices)
    if ti.spilled:  # one copy per row id
        for row in ids:
            real = row[row >= 0]
            assert len(set(real.tolist())) == len(real)
    if subset:  # every returned id belongs to an allowed subset
        sub = np_of(tq.subset_ids)
        for r in range(B):
            ok = ids[r][ids[r] >= 0]
            assert (sub[r] < 0).all() or np.isin(ok % 16, sub[r]).all()


@pytest.mark.parametrize("name", ["adc8", "int8-pca"])
def test_chunked_queries_and_windows_match_jax(name: str, monkeypatch) -> None:
    """A scoring budget small enough to chunk the queries (B = 12 over
    chunks of 8, the last padded) and the windows, in both packages."""
    monkeypatch.setattr(jax_ivfpq, "_OH_BUDGET", 1 << 19)
    monkeypatch.setattr(ivfpq, "_OH_BUDGET", 1 << 19)
    ji, ti = _built(name)
    jq, tq = _queries()
    _assert_same(jax_ivfpq.ivfpq_search(ji, jq, top_k=K), ivfpq_search(ti, tq, top_k=K))


@pytest.mark.parametrize("spill", [False, True], ids=["plain", "spilled"])
def test_full_probe_with_f32_rows_is_exact(spill: bool) -> None:
    """Every cell probed and f32 refine rows: the exact top-10 (float64)
    wherever its margin exceeds the f32 band, on the port's own build."""
    x = _corpus()
    q = _query_vectors()
    index = build_ivfpq_index(x, n_clusters=16, nprobe=16, window=64, kmeans_iters=3, refine="float32",
                              keep_codes=False, spill=spill, generator=torch.Generator().manual_seed(0), device=CPU)
    got = ivfpq_search(index.replace(max_windows=0), SearchQueries(vector=torch.from_numpy(q)), K)
    exact = q.astype(np.float64) @ x.astype(np.float64).T
    want = np.argsort(-exact, axis=-1, kind="stable")[:, :K]
    for r in range(B):
        s = np.sort(exact[r])[::-1]
        margin_ok = np.abs(np.diff(s[: K + 1])) > 1e-6
        for c in range(K):
            if margin_ok[c] and (c == 0 or margin_ok[c - 1]):
                assert np_of(got.indices)[r, c] == want[r, c], (r, c)


def test_sorted_window_layout_is_bit_equal() -> None:
    rng = np.random.default_rng(5)
    for n_cells, window, nprobe, max_windows in ((16, 64, 4, None), (40, 8, 7, None), (40, 8, 7, 5), (3, 512, 8, None)):
        assign = rng.integers(0, n_cells, size=777).astype(np.int32)
        assign[assign == 2] = 1  # an empty cell
        want = jax_ivfpq._sorted_window_layout(assign, n_cells, window, nprobe, max_windows)
        got = ivfpq._sorted_window_layout(assign, n_cells, window, nprobe, max_windows)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
            assert np.asarray(g).dtype == np.asarray(w).dtype


@pytest.mark.parametrize("w_max", [1, 7, 20, 64])
def test_probe_window_ids_are_bit_equal(w_max: int) -> None:
    ji, ti = _built("int8")
    q = _query_vectors()
    jw, jv = jax_ivfpq._probe_window_ids(ji, jnp.asarray(q), w_max)
    tw, tv = ivfpq._probe_window_ids(ti, torch.from_numpy(q), w_max)
    np.testing.assert_array_equal(np_of(tw), np.asarray(jw))
    np.testing.assert_array_equal(np_of(tv), np.asarray(jv))
    assert tw.dtype == torch.int32


def test_dedup_and_rerank_candidates_match_jax() -> None:
    rng = np.random.default_rng(7)
    scores = np.sort(rng.standard_normal((5, 24)).astype(np.float32), axis=-1)[:, ::-1].copy()
    ids = rng.integers(-1, 12, size=(5, 24)).astype(np.int32)
    scores[ids < 0] = -np.inf
    js, jids = jax_ivfpq._dedup_equal_rows(jnp.asarray(scores), jnp.asarray(ids), 10)
    ts, tids = ivfpq._dedup_equal_rows(torch.from_numpy(scores), torch.from_numpy(ids), 10)
    np.testing.assert_array_equal(np_of(tids), np.asarray(jids))
    np.testing.assert_array_equal(np_of(ts), np.asarray(js))
    q = _query_vectors(5)
    for store in ("int8", "float32"):
        rr = (rng.integers(-127, 128, size=(12, D)).astype(np.int8) if store == "int8"
              else rng.standard_normal((12, D)).astype(np.float32))
        scale = np.full((1, D), 0.01, np.float32) if store == "int8" else None
        jout = jax_ivfpq.rerank_candidates(jnp.asarray(q), jnp.asarray(scores), jnp.asarray(ids), 6,
                                           rerank_codes=jnp.asarray(rr), rerank_scale=None if scale is None
                                           else jnp.asarray(scale), rerank_proj=None)
        tout = ivfpq.rerank_candidates(torch.from_numpy(q), torch.from_numpy(scores), torch.from_numpy(ids), 6,
                                       rerank_codes=torch.from_numpy(rr), rerank_scale=None if scale is None
                                       else torch.from_numpy(scale), rerank_proj=None)
        np.testing.assert_array_equal(np_of(tout[1]), np.asarray(jout[1]))
        np.testing.assert_allclose(np_of(tout[0]), np.asarray(jout[0]), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("spill, code_bits", [(False, 8), (True, 4)], ids=["plain", "spilled-4bit"])
def test_build_from_parts_matches_jax(spill: bool, code_bits: int) -> None:
    """The same parts give equal arrays and metadata in both packages, and
    the port's device-parts assembly equals its host-parts one."""
    rng = np.random.default_rng(3)
    n, c = 500, 9
    assign = rng.integers(0, c, size=n).astype(np.int32)
    codes = rng.integers(0, 256 if code_bits == 8 else 16, size=(n, 4)).astype(np.uint8)
    refine = rng.integers(-127, 128, size=(n, 6)).astype(np.int8)
    rerank = rng.integers(-127, 128, size=(n, 5)).astype(np.int8)
    subset = rng.integers(0, 4, size=n).astype(np.int32)
    cent = rng.standard_normal((c, 6)).astype(np.float32)
    books = rng.standard_normal((4, 1 << code_bits, 2)).astype(np.float32)
    kw = dict(k_factor=3, window=16, nprobe=3, code_bits=code_bits, offset=100, approx_recall=None)
    row_ids = None
    if spill:
        assign = np.concatenate([assign, (assign + 1) % c])
        codes, refine, subset = (np.concatenate([a, a]) for a in (codes, refine, subset))
        row_ids = np.tile(np.arange(n, dtype=np.int32), 2)
    kw.update(row_ids_np=row_ids, n_real=n, spilled=spill)
    want = jax_ivfpq.build_ivfpq_from_parts(
        jnp.asarray(cent), jnp.asarray(books), assign, codes, refine_np=refine, refine_scale=jnp.ones((1, 6)),
        rerank_np=rerank, subset_ids_np=subset, **kw)
    got = ivfpq.build_ivfpq_from_parts(
        torch.from_numpy(cent), torch.from_numpy(books), assign, codes, refine_np=refine,
        refine_scale=torch.ones((1, 6)), rerank_np=rerank, subset_ids_np=subset, device=CPU, **kw)
    dev_parts = ivfpq.build_ivfpq_from_device_parts(
        torch.from_numpy(cent), torch.from_numpy(books), assign, torch.from_numpy(codes),
        refine_dev=torch.from_numpy(refine), refine_scale=torch.ones((1, 6)), rerank_dev=torch.from_numpy(rerank),
        subset_ids_np=subset, **kw)
    for f in dataclasses.fields(IVFPQIndex):
        w, g, d = getattr(want, f.name), getattr(got, f.name), getattr(dev_parts, f.name)
        if isinstance(g, torch.Tensor):
            np.testing.assert_array_equal(np_of(g), np.asarray(w), err_msg=f.name)
            assert np_of(g).dtype == np.asarray(w).dtype, f.name
            assert torch.equal(g, d), f.name
        else:
            assert g == w == d or (g is None and w is None and d is None), f.name


def test_assign_soar_and_refine_params_match_jax() -> None:
    x = _corpus()[:700]
    cent = _rows(20, 9)
    prim = np.argmax(x @ cent.T, axis=-1).astype(np.int32)
    for lam in (0.0, 1.0, 4.0):
        want = jax_ivfpq.assign_soar(jnp.asarray(x), jnp.asarray(cent), jnp.asarray(prim), soar_lambda=lam, chunk=256)
        got = ivfpq.assign_soar(torch.from_numpy(x), torch.from_numpy(cent), torch.from_numpy(prim), soar_lambda=lam,
                                chunk=256)
        np.testing.assert_array_equal(np_of(got), np.asarray(want))
        assert (np_of(got) != prim).all()
    for dim in (None, 12):
        jproj, jscale = jax_ivfpq.train_refine_int8_params(jnp.asarray(x), dim)
        tproj, tscale = ivfpq.train_refine_int8_params(torch.from_numpy(x), dim)
        np.testing.assert_allclose(np_of(tscale), np.asarray(jscale), rtol=1e-5, atol=0)
        if dim is None:
            assert tproj is None and jproj is None
        else:  # PCA columns agree up to their sign
            sign = np.sign(np.sum(np_of(tproj) * np.asarray(jproj), axis=0))
            np.testing.assert_allclose(np_of(tproj) * sign, np.asarray(jproj), atol=1e-4)


def _structure_equal(got: IVFPQIndex, want) -> None:
    """Field by field: shapes and dtypes, and the static metadata; the window
    counts follow the clustering, which draws otherwise than JAX's."""
    for f in dataclasses.fields(got):
        w, g = getattr(want, f.name), getattr(got, f.name)
        if isinstance(g, torch.Tensor):
            shape = list(np.shape(w))
            if f.name in ("codes", "row_ids", "subset_ids", "refine_codes"):
                shape[0] = g.shape[0]
            assert list(g.shape) == shape and str(g.dtype).split(".")[-1] == str(np.asarray(w).dtype), f.name
        elif f.name != "max_windows":
            assert g == w or (w is None and g is None), f.name


@pytest.mark.parametrize("source", ["factory", "preset", "codec"])
def test_factory_builds_and_dispatches_ivfpq(source: str) -> None:
    """The reference's default factory string, the `ivfpq` preset and the
    plain codec build through `build_dense_from_config` with JAX's structure,
    and `hybrid_search` dispatches the index to `ivfpq_search`."""
    import yaml

    from tests.test_torch_factory import ROOT

    if source == "factory":
        cfg = DenseFactoryConfig.from_faiss_factory("OPQ32_512,IVFauto,PQ32x8")
        jcfg = JaxConfig.from_faiss_factory("OPQ32_512,IVFauto,PQ32x8")
    elif source == "preset":
        dense = yaml.safe_load((ROOT / "configs/presets/search/ivfpq.yaml").read_text())["search_defaults"]["dense"]
        cfg, jcfg = DenseFactoryConfig(**dense), JaxConfig(**dense)
    else:
        cfg, jcfg = DenseFactoryConfig(codec="ivfpq", n_subquantizers=8), JaxConfig(codec="ivfpq", n_subquantizers=8)
    assert dataclasses.asdict(cfg) == jcfg.model_dump()
    cfg, jcfg = cfg + {"kmeans_iters": 2, "opq_iters": 1}, jcfg + {"kmeans_iters": 2, "opq_iters": 1}
    x = np.concatenate([_corpus(), _corpus()], axis=1)  # D = 64: 32 subquantizers of 2 dims
    got = build_dense_from_config(cfg, x, generator=torch.Generator().manual_seed(0), device=CPU)
    want = jax_build_cfg(jcfg, jnp.asarray(x), rng=jax.random.PRNGKey(0))
    assert isinstance(got, IVFPQIndex) and type(want).__name__ == "IVFPQIndex"
    _structure_equal(got, want)
    assert got.centroids.shape[0] == 45  # IVFauto: round(sqrt(2048))
    q = torch.from_numpy(np.concatenate([_query_vectors(), _query_vectors()], axis=1))
    direct = ivfpq_search(got, SearchQueries(vector=q), K)
    merged, raw = hybrid_search(HybridEngines(dense=got), SearchQueries(vector=q), K)
    assert torch.equal(torch.sort(merged.indices, dim=-1).values, torch.sort(direct.indices, dim=-1).values)
    assert set(raw) == {"dense"}
    assert (np_of(direct.indices)[:, 0] == np.arange(B)).mean() >= 0.75  # each query's source row


def _cfg() -> DenseFactoryConfig:
    return DenseFactoryConfig(codec="ivfpq", n_clusters=16, nprobe=4, ivf_window=64, kmeans_iters=2, refine="int8",
                              refine_dim=16, keep_codes=False, rerank="int8")


def test_cache_round_trip_and_key_equal_jax(tmp_path, monkeypatch) -> None:
    """A second build with the same config and data fingerprint loads the
    first: equal fields (None codes stay None) and identical answers,
    without building. The key equals JAX's for the same config."""
    cfg = _cfg()
    assert factory._index_fingerprint("dense", cfg, "data-1") == jax_fingerprint(
        "dense", JaxConfig(**dataclasses.asdict(cfg)), "data-1")
    assert factory._index_fingerprint("dense", cfg, "data-1") != factory._index_fingerprint("dense", cfg, "data-2")
    x = _corpus()
    kw = dict(cache_dir=str(tmp_path), data_fingerprint="data-1", device=CPU)
    timings: dict = {}
    first = build_dense_from_config(cfg, x, generator=torch.Generator().manual_seed(0), timings=timings, **kw)
    assert first.codes is None and set(timings) >= {"train_ms", "layout_ms"}
    key = factory._index_fingerprint("dense", cfg, "data-1")
    assert (tmp_path / "indices" / key / "meta.json").is_file()

    def no_build(*a, **k):
        raise AssertionError("built again instead of loading the cache")

    monkeypatch.setattr(factory, "build_ivfpq_index", no_build)
    timings = {}
    second = build_dense_from_config(cfg, x, timings=timings, **kw)
    assert set(timings) == {"load_ms"}
    for f in dataclasses.fields(IVFPQIndex):
        a, b = getattr(first, f.name), getattr(second, f.name)
        assert (torch.equal(a, b) and a.dtype == b.dtype) if isinstance(a, torch.Tensor) else a == b, f.name
    q = SearchQueries(vector=torch.from_numpy(_query_vectors()))
    out1, out2 = ivfpq_search(first, q, K), ivfpq_search(second, q, K)
    assert torch.equal(out1.indices, out2.indices) and torch.equal(out1.scores, out2.scores)
    engines = build_hybrid_engines(HybridSearchFactoryConfig(dense=cfg), vectors=x, **kw)
    assert torch.equal(engines.dense.refine_codes, first.refine_codes)


@pytest.mark.parametrize("codec", ["flat", "int8", "pq"])
def test_cache_round_trips_every_codec(codec: str, tmp_path) -> None:
    cfg = DenseFactoryConfig(codec=codec, n_subquantizers=8, kmeans_iters=2, refine="int8")
    x = _corpus()[:700]
    kw = dict(cache_dir=str(tmp_path), data_fingerprint="fp", device=CPU)
    first = build_dense_from_config(cfg, x, **kw)
    second = build_dense_from_config(cfg, x, **kw)
    assert type(first) is type(second)
    for name, a in vars(first).items():
        b = getattr(second, name)
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b, name


def test_search_server_serves_what_ivfpq_search_returns() -> None:
    ji, ti = _built("int8-pca")
    q = _query_vectors()
    direct = ivfpq_search(ti, SearchQueries(vector=torch.from_numpy(q)), K)
    gold = np.arange(B, dtype=np.int32)[:, None] * 7
    with SearchServer(HybridEngines(dense=ti), batch_window_ms=20.0, max_batch=16, device=CPU) as srv:
        client = SearchHttpClient(srv.url)
        for rows in (slice(0, 1), slice(1, 5), slice(0, B)):
            out = client.search(vector=q[rows], top_k=K)
            # the merge may order equal (int8) scores otherwise: the same ids, and
            # each row's scores are the direct ones less their minimum
            want_s = np_of(direct.scores)[rows]
            np.testing.assert_array_equal(np.sort(out.indices, -1), np.sort(np_of(direct.indices)[rows], -1))
            np.testing.assert_allclose(out.scores, want_s - want_s.min(-1, keepdims=True), atol=1e-6, rtol=0)
            with_gold = client.search(vector=q[rows], section_ids=gold[rows], top_k=K)
            for r, g in enumerate(gold[rows][:, 0]):
                row = with_gold.indices[r].tolist()
                assert g in row and with_gold.labels[r][row.index(g)] == 1


def test_mesh_still_raises() -> None:
    with pytest.raises(NotImplementedError):
        build_ivfpq_index(_corpus()[:100], n_clusters=4, refine="int8", keep_codes=False, mesh=object(), device=CPU)
    with pytest.raises(NotImplementedError):
        build_dense_from_config(_cfg(), _corpus()[:100], mesh=object(), device=CPU)


def test_build_defaults_to_the_card() -> None:
    import inspect

    for fn in (build_ivfpq_index, ivfpq.build_ivfpq_from_parts):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn


def test_card_smoke_run_uses_the_preset_and_the_factory_default() -> None:
    """chip_smoke phase 8 builds exactly `configs/presets/search/ivfpq.yaml`
    and the reference's default factory string, as JAX reads them."""
    import yaml

    import chip_smoke
    from tests.test_torch_factory import ROOT

    dense = yaml.safe_load((ROOT / "configs/presets/search/ivfpq.yaml").read_text())["search_defaults"]["dense"]
    assert chip_smoke.IVFPQ_PRESET == dense == chip_smoke.IVFPQ_SERVE["preset"]
    assert chip_smoke.IVFPQ_PERIODIC["dense"] == dict(dense, autotune_target_recall=0.9)
    assert chip_smoke.IVFPQ_SERVE["factory"] == "OPQ32_512,IVFauto,PQ32x8"
    got = DenseFactoryConfig.from_faiss_factory(chip_smoke.IVFPQ_SERVE["factory"])
    assert dataclasses.asdict(got) == JaxConfig.from_faiss_factory("OPQ32_512,IVFauto,PQ32x8").model_dump()
