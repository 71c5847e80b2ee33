"""The port's PQ and IVF search (`vod_tpu_torch/search/dense.py`) against the
JAX package's, on indexes built by JAX and carried across
(`models/convert.py:dense_index_from_fields`), so both search identical
arrays. JAX's `kernel="fused"` runs its Pallas kernel in interpret mode; the
port's wrapper runs its plain version on CPU tensors.

Toy sizes: 2048 rows of D = 32 (seeded correlated rows), 6 queries, top 10.
Tolerances: ids equal; scores within 1e-5 of their size (f32 sums in other
orders). The int8 scans sum exactly on both sides.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_helpers import np_of
from vod_tpu.search import build_ivf_index as jax_build_ivf
from vod_tpu.search import build_pq_index as jax_build_pq
from vod_tpu.search import HybridEngines as JaxEngines
from vod_tpu.search import hybrid_search as jax_hybrid
from vod_tpu.search.base import SearchQueries as JaxQueries
from vod_tpu.search.dense import ivf_search as jax_ivf_search
from vod_tpu.search.dense import pq_search as jax_pq_search
from vod_tpu_torch.models.convert import dense_index_from_fields
from vod_tpu_torch.ops.mips import _binned_body
from vod_tpu_torch.search import HybridEngines, SearchQueries, build_pq_index, hybrid_search, ivf_search, pq_search
from vod_tpu_torch.search import dense

N, D, B, K = 2048, 32, 6, 10
RTOL = 1e-5

# (name, build kwargs): every mode of pq_search
BUILDS = {
    "adc8": dict(coarse_dim=None, n_subquantizers=8),
    "adc8-int8": dict(coarse_dim=None, n_subquantizers=8, refine="int8", k_factor=20),
    "adc4-int8-dim": dict(coarse_dim=None, n_subquantizers=8, code_bits=4, refine="int8", refine_dim=16, k_factor=4),
    "adc4-bf16": dict(coarse_dim=None, n_subquantizers=8, code_bits=4, refine="bfloat16", k_factor=4),
    "adc8-f32": dict(coarse_dim=None, n_subquantizers=8, refine="float32", k_factor=8),
    "coarse8": dict(coarse_dim=16, n_subquantizers=8, n_candidates=256),
    "coarse4-int8-dim": dict(coarse_dim=16, n_subquantizers=8, code_bits=4, n_candidates=300, refine="int8",
                             refine_dim=16, k_factor=8),
    "coarse-opq-f32": dict(coarse_dim=16, n_subquantizers=8, use_opq=True, opq_iters=2, n_candidates=256,
                           refine="float32"),
    "direct-f32": dict(coarse_dim=16, keep_codes=False, refine="float32", k_factor=8),
    "coarse30-int8": dict(coarse_dim=30, n_subquantizers=8, n_candidates=512, refine="int8", k_factor=4),
}


def _rows(seed: int, n: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    mix = rng.standard_normal((D, D)).astype(np.float32) * np.linspace(1.0, 0.2, D, dtype=np.float32)[:, None]
    return (rng.standard_normal((n, D)).astype(np.float32) @ mix).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _built(name: str):
    """(JAX index, port index) of one build, with the corpus's 16 subset ids."""
    x = _rows(0, N)
    subset = (np.arange(N) % 16).astype(np.int32)
    ji = jax_build_pq(jax.random.PRNGKey(0), jnp.asarray(x), kmeans_iters=3, pad_multiple=1024,
                      subset_ids=jnp.asarray(subset), **BUILDS[name])
    fields = {k: (np.asarray(v) if hasattr(v, "shape") else v) for k, v in vars(ji).items()}
    return ji, dense_index_from_fields(fields, device="cpu")


def _queries(subset: bool = False):
    q = _rows(1, B)
    sub = np.array([[3, 7], [0, -1], [-1, -1], [5, 5], [15, 2], [1, -1]], np.int32) if subset else None
    return (JaxQueries(vector=jnp.asarray(q), subset_ids=None if sub is None else jnp.asarray(sub)),
            SearchQueries(vector=torch.from_numpy(q), subset_ids=None if sub is None else torch.from_numpy(sub)))


def _assert_same(jout, tout) -> None:
    np.testing.assert_array_equal(np_of(tout.indices), np_of(jout.indices))
    js, ts = np_of(jout.scores), np_of(tout.scores)
    np.testing.assert_array_equal(np.isfinite(ts), np.isfinite(js))
    fin = np.isfinite(js)
    np.testing.assert_allclose(ts[fin], js[fin], rtol=RTOL, atol=RTOL * np.abs(js[fin]).max())


CASES = [(name, kernel, False) for name in BUILDS for kernel in ("scan", "fused")
         if kernel == "scan" or BUILDS[name].get("coarse_dim") is not None]
CASES += [("adc8-int8", "scan", True), ("coarse8", "scan", True), ("coarse4-int8-dim", "fused", True),
          ("direct-f32", "fused", True)]


@pytest.mark.parametrize("name, kernel, subset", CASES, ids=[f"{n}-{k}{'-subset' if s else ''}" for n, k, s in CASES])
def test_pq_search_matches_jax(name: str, kernel: str, subset: bool, monkeypatch) -> None:
    """Every mode: exhaustive ADC (8- and 4-bit, refine none / int8 / bf16 /
    f32, with and without refine_dim), coarse + ADC rescore (with OPQ), coarse
    -> refine direct, the coarse stage on the scan and on `fused_mips_binned`,
    and the subset filter (which keeps the coarse stage on the scan)."""
    ji, ti = _built(name)
    ji, ti = ji.replace(kernel=kernel), ti.replace(kernel=kernel)
    jq, tq = _queries(subset)
    calls = []
    real = dense.fused_mips_binned

    def counting(*a, **kw):
        calls.append(kw)
        return real(*a, **kw)

    monkeypatch.setattr(dense, "fused_mips_binned", counting)
    tout = pq_search(ti, tq, top_k=K)
    _assert_same(jax_pq_search(ji, jq, top_k=K), tout)
    assert len(calls) == int(kernel == "fused" and not subset)
    if subset:  # every returned id belongs to an allowed subset
        ids, sub = np_of(tout.indices), np_of(tq.subset_ids)
        for r in range(B):
            ok = ids[r][ids[r] >= 0]
            assert (sub[r] < 0).all() or np.isin(ok % 16, sub[r]).all()


def test_coarse_dim_30_pads_to_the_tensor_core_width_and_matches_jax() -> None:
    """coarse_dim = 30: the port stores the coarse codes with two zero
    columns (D = 32, a multiple of 16, which the int8 tensor-core body takes)
    and pads the coarse queries the same way; the fused route gives JAX's ids
    (JAX's Pallas kernel in interpret mode at D = 30)."""
    ji, ti = _built("coarse30-int8")
    assert np_of(ji.coarse_codes).shape[1] == 30 and ti.coarse_codes.shape[1] == 32
    assert (ti.coarse_codes[:, 30:] == 0).all() and ti.coarse_codes.is_contiguous()
    np.testing.assert_array_equal(np_of(ti.coarse_codes[:, :30]), np_of(ji.coarse_codes))
    assert _binned_body(torch.int8, int(ti.coarse_codes.shape[1]), ti.fused_bins, (0, 0)) == "wgmma"
    jq, tq = _queries()
    _assert_same(jax_pq_search(ji.replace(kernel="fused"), jq, top_k=K), pq_search(ti.replace(kernel="fused"), tq, top_k=K))


def test_query_chunking_keeps_results(monkeypatch) -> None:
    """Batches whose rescore gathers exceed the cap are searched in query
    chunks (here 8 of 20 queries a chunk): the same results as one pass."""
    _, ti = _built("coarse4-int8-dim")
    q = torch.from_numpy(_rows(2, 20))
    ref = pq_search(ti, SearchQueries(vector=q), top_k=K)
    per_q = ti.n_candidates * 8 + ti.k_factor * K * 16
    monkeypatch.setattr(dense, "_PQ_RESCORE_ELEMS", 8 * per_q)
    out = pq_search(ti, SearchQueries(vector=q), top_k=K)
    assert torch.equal(out.indices, ref.indices) and torch.equal(out.scores, ref.scores)


def test_port_build_searches_like_its_jax_counterpart() -> None:
    """The port's own build (4-bit exhaustive ADC + int8 refine over a PCA
    space, the msmarco_pq_realm codec at toy width): shapes and dtypes, and a
    recall@10 against exact search within 0.05 of the JAX build's."""
    x = _rows(3, N)
    kw = dict(coarse_dim=None, n_subquantizers=16, code_bits=4, refine="int8", refine_dim=16, k_factor=8, kmeans_iters=4)
    ti = build_pq_index(x, generator=torch.Generator().manual_seed(0), device="cpu", timings=(t := {}), **kw)
    assert ti.codes.shape == (N, 8) and ti.codes.dtype == torch.uint8
    assert ti.refine_codes.shape == (N, 16) and ti.refine_codes.dtype == torch.int8
    assert set(t) == {"train_pq_ms", "coarse_ms", "encode_ms", "refine_ms"}
    ji = jax_build_pq(jax.random.PRNGKey(0), jnp.asarray(x), **kw)
    q = _rows(4, 64)
    exact = np.argsort(-(q @ x.T), axis=-1, kind="stable")[:, :K]

    def recall(ids):
        return np.mean([len(set(ids[r]) & set(exact[r])) / K for r in range(len(q))])

    r_t = recall(np_of(pq_search(ti, SearchQueries(vector=torch.from_numpy(q)), top_k=K).indices))
    r_j = recall(np_of(jax_pq_search(ji, JaxQueries(vector=jnp.asarray(q)), top_k=K).indices))
    assert r_t >= r_j - 0.05 and r_t > 0.5, (r_t, r_j)


def test_ivf_search_matches_jax() -> None:
    x = _rows(5, N)
    subset = (np.arange(N) % 16).astype(np.int32)
    ji = jax_build_ivf(jax.random.PRNGKey(0), jnp.asarray(x), n_clusters=16, nprobe=4, kmeans_iters=4,
                       dtype="float32", subset_ids=jnp.asarray(subset))
    ti = dense_index_from_fields({k: (np.asarray(v) if hasattr(v, "shape") else v) for k, v in vars(ji).items()},
                                 device="cpu")
    for subset_q in (False, True):
        jq, tq = _queries(subset_q)
        _assert_same(jax_ivf_search(ji, jq, top_k=K), ivf_search(ti, tq, top_k=K))


def test_ivf_build_buckets_every_row_in_its_nearest_cell() -> None:
    from vod_tpu_torch.search import build_ivf_index

    x = _rows(6, 1000)
    ti = build_ivf_index(x, n_clusters=8, nprobe=8, kmeans_iters=3, dtype="float32",
                         generator=torch.Generator().manual_seed(0), device="cpu")
    ids = np_of(ti.row_ids)
    assert sorted(ids[ids >= 0].tolist()) == list(range(1000))
    c = np_of(ti.centroids)
    d2 = (c**2).sum(-1)[None] - 2 * x @ c.T
    cell_of = np.full(1000, -1)
    cell_of[ids[ids >= 0]] = np.nonzero(ids >= 0)[0]
    assert (cell_of == d2.argmin(-1)).mean() > 0.99  # f32 near-ties aside
    full = ivf_search(ti, SearchQueries(vector=torch.from_numpy(x[:5])), top_k=1)
    assert np_of(full.indices)[:, 0].tolist() == np.argmax(x[:5] @ x.T, axis=-1).tolist()


@pytest.mark.parametrize("kind", ["pq", "ivf"])
def test_hybrid_search_dispatches_pq_and_ivf_like_jax(kind: str) -> None:
    """`hybrid_search` (the collate's retrieval) searches a PQIndex and an
    IVFIndex: the merged batch and the raw dense scores equal JAX's, gold
    lookups included."""
    if kind == "pq":
        ji, ti = _built("adc4-int8-dim")
    else:
        ji = jax_build_ivf(jax.random.PRNGKey(0), jnp.asarray(_rows(5, N)), n_clusters=16, nprobe=4, kmeans_iters=4,
                           dtype="float32")
        ti = dense_index_from_fields({k: (np.asarray(v) if hasattr(v, "shape") else v) for k, v in vars(ji).items()},
                                     device="cpu")
    q = _rows(7, B)
    gold = np.arange(B, dtype=np.int32)[:, None] * 3
    jm, jraw = jax_hybrid(JaxEngines(dense=ji), JaxQueries(vector=jnp.asarray(q), section_ids=jnp.asarray(gold)), K)
    tm, traw = hybrid_search(HybridEngines(dense=ti), SearchQueries(vector=torch.from_numpy(q),
                                                                    section_ids=torch.from_numpy(gold)), K)
    np.testing.assert_array_equal(np_of(tm.indices), np_of(jm.indices))
    np.testing.assert_array_equal(np_of(tm.labels), np_of(jm.labels))
    for got, want in ((tm.scores, jm.scores), (traw["dense"], jraw["dense"])):
        g, w = np_of(got), np_of(want)
        np.testing.assert_array_equal(np.isfinite(g), np.isfinite(w))
        np.testing.assert_allclose(g[np.isfinite(w)], w[np.isfinite(w)], rtol=RTOL, atol=RTOL)
