"""The routes of the ported PQ / IVF-PQ research sweeps
(`vod_tpu_torch/examples/{pq_decode_variants_bench,pq4_fastscan_bench,
pq4_adc_variants_bench,pq_8m8_bench,pq_geometry_sweep,ivfpq_8m_bench,
ivfpq_crossover_bench}.py`) against the JAX scripts' routes, on the CPU.

The JAX scripts draw their 8.8M corpora with `jax.random` on the device and
define their variants inside `main`, so the variants are rebuilt here from
`vod_tpu` functions (`_scan_topk`, `_scan_collect_topk`, `_unpack_codes4`,
`decode_rows`, `adc_lut`, `PQIndex` / `pq_search`, `DenseIndex` /
`dense_search`, `build_ivfpq_from_device_parts` / `ivfpq_search`,
`apply_runtime_params`), each line as the script has it, and fed the same
numpy data (seeded codebooks, codes, rows and queries) as the port's plain
torch functions. Ids are compared exactly: the int8 variants sum exact
integer products on both sides, and the bf16 ones sum exact products of
bf16 values in f32, where no two scores of this data come within the sum
orders' difference.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vod_tpu.ops import pq as jax_pq
from vod_tpu.search import SearchQueries as JaxQueries
from vod_tpu.search.autotune import apply_runtime_params as jax_apply
from vod_tpu.search.dense import DenseIndex as JaxDenseIndex
from vod_tpu.search.dense import PQIndex as JaxPQIndex
from vod_tpu.search.dense import _scan_collect_topk as jax_collect
from vod_tpu.search.dense import _scan_topk as jax_scan
from vod_tpu.search.dense import _unpack_codes4 as jax_unpack4
from vod_tpu.search.dense import decode_rows as jax_decode_rows
from vod_tpu.search.dense import dense_search as jax_dense_search
from vod_tpu.search.dense import pq_search as jax_pq_search
from vod_tpu.search.ivfpq import build_ivfpq_from_device_parts as jax_build_ivfpq
from vod_tpu.search.ivfpq import ivfpq_search as jax_ivfpq_search
from vod_tpu_torch.examples import (
    ivfpq_8m_bench,
    pq4_adc_variants_bench,
    pq4_fastscan_bench,
    pq_8m8_bench,
    pq_decode_variants_bench,
    pq_geometry_sweep,
)
from vod_tpu_torch.search import SearchQueries
from vod_tpu_torch.search.autotune import apply_runtime_params
from vod_tpu_torch.search.dense import DenseIndex, PQIndex, _int8_codebooks, _pack_codes4, dense_search, pq_search
from vod_tpu_torch.search.ivfpq import build_ivfpq_from_device_parts, ivfpq_search

N_PAD, N, D, B, K = 8192, 8000, 64, 16, 10


def _t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x))


def _data(m: int, n_codes: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    cb = rng.normal(size=(m, n_codes, D // m)).astype(np.float32)
    codes = rng.integers(0, n_codes, size=(N_PAD, m)).astype(np.uint8)
    q = rng.normal(size=(B, D)).astype(np.float32)
    return cb, codes, q


def _int8_cb(cb):
    """The JAX scripts' per-subspace int8 codebooks and scale vector."""
    cb_scale = jnp.maximum(jnp.max(jnp.abs(cb), axis=(1, 2), keepdims=True), 1e-8) / 127.0
    cb_i8 = jnp.clip(jnp.round(cb / cb_scale), -127, 127).astype(jnp.int8)
    return cb_i8, jnp.repeat(cb_scale[:, 0, 0], D // cb.shape[0])


def _quant(qv, scale_vec):
    q_f = qv.astype(jnp.float32) * scale_vec
    q_row = jnp.maximum(jnp.max(jnp.abs(q_f), axis=-1, keepdims=True), 1e-8) / 127.0
    return jnp.clip(jnp.round(q_f / q_row), -127, 127).astype(jnp.int8), q_row


def _i8_scan(q_i8, q_row, dec):
    acc = jax.lax.dot_general(q_i8, dec, (((1,), (1,)), ((), ())), preferred_element_type=jnp.int32)
    return acc.astype(jnp.float32) * q_row


# -- pq_decode_variants_bench ------------------------------------------------------------
def _jax_decode_variant(name: str, cb, codes, qv, chunk: int):
    iota = jnp.arange(cb.shape[1], dtype=jnp.int32)
    cb_i8, scale_vec = _int8_cb(cb)

    def onehot(c, dtype):
        return (c.astype(jnp.int32)[:, :, None] == iota[None, None, :]).astype(dtype)

    if name == "bf16-oh":
        q_mm = qv.astype(jnp.bfloat16)

        def score(start):
            c = jax.lax.dynamic_slice_in_dim(codes, start, chunk, axis=0)
            dec = jnp.einsum("cmk,mkd->cmd", onehot(c, jnp.bfloat16), cb.astype(jnp.bfloat16),
                             preferred_element_type=jnp.bfloat16)
            return jnp.dot(q_mm, dec.reshape(chunk, -1).T, preferred_element_type=jnp.float32)
    elif name == "i8-oh/bf16-scan":
        q_mm = (qv.astype(jnp.float32) * scale_vec).astype(jnp.bfloat16)

        def score(start):
            c = jax.lax.dynamic_slice_in_dim(codes, start, chunk, axis=0)
            dec = jnp.einsum("cmk,mkd->cmd", onehot(c, jnp.int8), cb_i8, preferred_element_type=jnp.int32)
            return jnp.dot(q_mm, dec.reshape(chunk, -1).astype(jnp.bfloat16).T, preferred_element_type=jnp.float32)
    else:
        q_i8, q_row = _quant(qv, scale_vec)

        def score(start):
            c = jax.lax.dynamic_slice_in_dim(codes, start, chunk, axis=0)
            dec = jnp.einsum("cmk,mkd->cmd", onehot(c, jnp.int8), cb_i8, preferred_element_type=jnp.int32)
            return _i8_scan(q_i8, q_row, dec.reshape(chunk, -1).astype(jnp.int8))

    return jax_scan(score, N_PAD, N, qv.shape[0], K, chunk, approx_recall=0.95)[1]


@pytest.mark.parametrize("name", list(pq_decode_variants_bench.VARIANTS))
def test_decode_variants_equal_jax(name: str) -> None:
    cb, codes, q = _data(16, 256)
    want = jax.jit(functools.partial(_jax_decode_variant, name, chunk=2048))(jnp.asarray(cb), jnp.asarray(codes),
                                                                             jnp.asarray(q))
    got = pq_decode_variants_bench.VARIANTS[name](_t(cb), _t(codes), _t(q), 2048, N)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- pq4_fastscan_bench ------------------------------------------------------------------
def _jax_fastscan(name: str, cb, codes, qv, chunk: int, pool: int):
    cb_i8, svec = _int8_cb(cb)
    m, n_codes = cb.shape[0], cb.shape[1]
    iota = jnp.arange(n_codes, dtype=jnp.int32)
    if name in ("onehot", "g8"):
        q_i8, q_row = _quant(qv, svec)
        if name == "g8":
            g, n_grp, dsub = 8, m // 8, D // m
            bd = np.zeros((n_grp, g * 16, g * dsub), np.int8)
            cb_np = np.asarray(cb_i8)
            for grp in range(n_grp):
                for j in range(g):
                    bd[grp, j * 16 : (j + 1) * 16, j * dsub : (j + 1) * dsub] = cb_np[grp * g + j]
            bd = jnp.asarray(bd)

        def score(start):
            c = jax.lax.dynamic_slice_in_dim(codes, start, chunk, axis=0)
            oh = (c.astype(jnp.int32)[:, :, None] == iota[None, None, :]).astype(jnp.int8)
            if name == "g8":
                dec = jnp.einsum("cgk,gkd->cgd", oh.reshape(chunk, n_grp, -1), bd, preferred_element_type=jnp.int32)
            else:
                dec = jnp.einsum("cmk,mkd->cmd", oh, cb_i8, preferred_element_type=jnp.int32)
            return _i8_scan(q_i8, q_row, dec.reshape(chunk, -1).astype(jnp.int8))
    else:
        lut = jax_pq.adc_lut(cb, qv).reshape(qv.shape[0], m * n_codes)
        l_row = jnp.maximum(jnp.max(jnp.abs(lut), axis=-1, keepdims=True), 1e-8) / 127.0
        lut_i8 = jnp.clip(jnp.round(lut / l_row), -127, 127).astype(jnp.int8)

        def score(start):
            c = jax.lax.dynamic_slice_in_dim(codes, start, chunk, axis=0)
            oh = (c.astype(jnp.int32)[:, :, None] == iota[None, None, :]).astype(jnp.int8).reshape(chunk, -1)
            return _i8_scan(lut_i8, l_row, oh)

    return jax_scan(score, N_PAD, N, qv.shape[0], pool, chunk, approx_recall=0.95)[1]


@pytest.mark.parametrize("name, m, n_codes", [("onehot", 16, 256), ("onehot", 32, 16), ("g8", 32, 16),
                                              ("lutmm", 32, 16)])
def test_fastscan_variants_equal_jax(name: str, m: int, n_codes: int) -> None:
    cb, codes, q = _data(m, n_codes, seed=1)
    want = _jax_fastscan(name, jnp.asarray(cb), jnp.asarray(codes), jnp.asarray(q), chunk=2048, pool=40)
    tcb, tcodes, tq = _t(cb), _t(codes), _t(q)
    cb_i8, svec = _int8_codebooks(tcb)
    if name == "onehot":
        got = pq4_fastscan_bench.onehot_decode_scan(cb_i8, svec, tcodes, tq, 2048, N, 40)
    elif name == "g8":
        got = pq4_fastscan_bench.grouped_decode_scan(pq4_fastscan_bench.block_diagonal(cb_i8), svec, tcodes, tq,
                                                     2048, N, 40)
    else:
        got = pq4_fastscan_bench.lut_matmul_scan(tcb, tcodes, tq, 2048, N, 40)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- pq4_adc_variants_bench --------------------------------------------------------------
def _jax_adc(name: str, cb, packed, qv, chunk: int, pool: int):
    cb_i8, svec = _int8_cb(cb)
    m = cb.shape[0]
    iota16 = jnp.arange(16, dtype=jnp.int32)
    dsub = D // m
    bd = np.zeros((m * 16, D), np.int8)
    cb_np = np.asarray(cb_i8)
    for mm in range(m):
        bd[mm * 16 : (mm + 1) * 16, mm * dsub : (mm + 1) * dsub] = cb_np[mm]
    bd = jnp.asarray(bd)
    if name == "direct":
        q_sub = qv.astype(jnp.float32).reshape(qv.shape[0], m, dsub)
        lut = jnp.einsum("bmd,mjd->bmj", q_sub, cb, preferred_element_type=jnp.float32).reshape(qv.shape[0], -1)
        l_row = jnp.maximum(jnp.max(jnp.abs(lut), axis=-1, keepdims=True), 1e-8) / 127.0
        lut_i8 = jnp.clip(jnp.round(lut / l_row), -127, 127).astype(jnp.int8)
    else:
        q_i8, q_row = _quant(qv, svec)

    def score(start):
        c = jax_unpack4(jax.lax.dynamic_slice_in_dim(packed, start, chunk, axis=0))
        oh = (c.astype(jnp.int32)[:, :, None] == iota16[None, None, :]).astype(jnp.int8)
        if name == "prod":
            dec = jnp.einsum("cmk,mkd->cmd", oh, cb_i8, preferred_element_type=jnp.int32).reshape(chunk, -1)
            return _i8_scan(q_i8, q_row, dec.astype(jnp.int8))
        oh = oh.reshape(chunk, m * 16)
        if name == "blockdiag":
            dec = jax.lax.dot_general(oh, bd, (((1,), (0,)), ((), ())), preferred_element_type=jnp.int32)
            return _i8_scan(q_i8, q_row, dec.astype(jnp.int8))
        return _i8_scan(lut_i8, l_row, oh)

    return jax_collect(score, N_PAD, N, qv.shape[0], pool, chunk, approx_recall=0.95)[1]


@pytest.mark.parametrize("name", ["prod", "blockdiag", "direct"])
def test_adc_variants_equal_jax(name: str) -> None:
    cb, codes, q = _data(32, 16, seed=2)
    packed = np.asarray(_pack_codes4(_t(codes)))
    want = _jax_adc(name, jnp.asarray(cb), jnp.asarray(packed), jnp.asarray(q), chunk=2048, pool=80)
    tcb, tq, tp = _t(cb), _t(q), _t(packed)
    cb_i8, svec = _int8_codebooks(tcb)
    if name == "prod":
        got = pq4_adc_variants_bench.prod(cb_i8, svec, tp, tq, 2048, N, 80)
    elif name == "blockdiag":
        got = pq4_adc_variants_bench.blockdiag(pq4_adc_variants_bench.flat_block_diagonal(cb_i8), svec, tp, tq, 2048,
                                               N, 80)
    else:
        got = pq4_adc_variants_bench.direct(tcb, tp, tq, 2048, N, 80)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- pq_8m8_bench and pq_geometry_sweep ---------------------------------------------------
def _refine(seed: int = 3, rdim: int = 16):
    rng = np.random.default_rng(seed)
    proj = np.linalg.qr(rng.normal(size=(D, D)))[0][:, :rdim].astype(np.float32)
    rows = rng.integers(-127, 128, size=(N_PAD, rdim)).astype(np.int8)
    scale = np.full((1, rdim), 0.01, np.float32)
    return rows, scale, proj


def test_8m8_prototypes_equal_jax() -> None:
    cb, codes, q = _data(16, 256, seed=4)
    rows, scale, proj = _refine()
    jcb, jcodes, jq = jnp.asarray(cb), jnp.asarray(codes), jnp.asarray(q)

    def jax_onehot(chunk=2048):
        iota = jnp.arange(256, dtype=jnp.int32)

        def score(start):
            c = jax.lax.dynamic_slice_in_dim(jcodes, start, chunk, axis=0)
            oh = (c.astype(jnp.int32)[:, :, None] == iota[None, None, :]).astype(jnp.bfloat16)
            dec = jnp.einsum("cmk,mkd->cmd", oh, jcb.astype(jnp.bfloat16), preferred_element_type=jnp.bfloat16)
            return jnp.dot(jq.astype(jnp.bfloat16), dec.reshape(chunk, -1).T, preferred_element_type=jnp.float32)

        return jax_scan(score, N_PAD, N, B, K, chunk, approx_recall=0.95)[1]

    def jax_dual(w_adc, chunk=2048):
        q_pca = (jq @ jnp.asarray(proj)) * jnp.asarray(scale)

        def score(start):
            c = jax.lax.dynamic_slice_in_dim(jcodes, start, chunk, axis=0)
            dec = jax_decode_rows(jcb, c, dtype=jnp.bfloat16)
            s_adc = jnp.dot(jq.astype(jnp.bfloat16), dec.T, preferred_element_type=jnp.float32)
            r = jax.lax.dynamic_slice_in_dim(jnp.asarray(rows), start, chunk, axis=0)
            s_pca = jnp.dot(q_pca, r.T.astype(jnp.float32), preferred_element_type=jnp.float32)
            return w_adc * s_adc + (1.0 - w_adc) * s_pca

        return jax_scan(score, N_PAD, N, B, K, chunk, approx_recall=0.95)[1]

    got = pq_8m8_bench.exh_onehot_indices(_t(cb), _t(codes), _t(q), N, chunk=2048)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax.jit(jax_onehot)()))
    refine = dict(rows=_t(rows), scale=_t(scale), proj=_t(proj))
    for w in (0.3, 0.5):
        got = pq_8m8_bench.dual_search_indices(_t(cb), _t(codes), refine, _t(q), N, w, chunk=2048)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jax.jit(functools.partial(jax_dual, w))()), err_msg=w)


@pytest.mark.parametrize("code_bits, k_factor", [(8, None), (8, 8), (4, 16)])
def test_8m8_and_geometry_indexes_equal_jax(code_bits: int, k_factor) -> None:
    """The scripts' `PQIndex`es (exhaustive ADC, with the PCA int8 refine at
    a k_factor) through both packages' `pq_search`."""
    cb, codes, q = _data(16, 1 << code_bits, seed=5)
    if code_bits == 4:
        codes = np.asarray(_pack_codes4(_t(codes)))
    rows, scale, proj = _refine()
    refine = {} if k_factor is None else dict(refine_codes=rows, refine_scale=scale, refine_proj=proj,
                                              k_factor=k_factor)
    jix = JaxPQIndex(codebooks=jnp.asarray(cb), codes=jnp.asarray(codes), n_real=N, approx_recall=0.95,
                     code_bits=code_bits, **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                                             for k, v in refine.items()})
    want = np.asarray(jax_pq_search(jix, JaxQueries(vector=jnp.asarray(q)), K).indices)
    if k_factor is not None and code_bits == 8:  # the geometry sweep's constructor
        index = pq_geometry_sweep.exhaustive_refine_index(_t(cb), _t(codes), dict(rows=_t(rows), scale=_t(scale),
                                                                                     proj=_t(proj)), N, k_factor)
    else:
        index = PQIndex(codebooks=_t(cb), codes=_t(codes), n_real=N, approx_recall=0.95, code_bits=code_bits,
                        **{k: _t(v) if isinstance(v, np.ndarray) else v for k, v in refine.items()})
    got = pq_search(index, SearchQueries(vector=_t(q)), K).indices.numpy()
    np.testing.assert_array_equal(got, want)


def test_8m8_int8_comparator_equals_jax() -> None:
    rng = np.random.default_rng(6)
    x = rng.normal(size=(N_PAD, D)).astype(np.float32) / np.sqrt(D)
    scale = np.full((1, D), 5.0 / np.sqrt(D) / 127.0, np.float32)
    buf = np.clip(np.round(x / scale), -127, 127).astype(np.int8)
    q = rng.normal(size=(B, D)).astype(np.float32)
    want = jax_dense_search(JaxDenseIndex(vectors=jnp.asarray(buf), scale=jnp.asarray(scale), n_real=N,
                                          approx_recall=0.95), JaxQueries(vector=jnp.asarray(q)), K).indices
    got = dense_search(DenseIndex(vectors=_t(buf), scale=_t(scale), n_real=N, approx_recall=0.95),
                       SearchQueries(vector=_t(q)), K).indices
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- ivfpq_8m_bench and ivfpq_crossover_bench ----------------------------------------------
@pytest.mark.parametrize("spill, rerank", [(False, False), (True, False), (True, True)])
def test_ivfpq_layouts_and_searches_equal_jax(spill: bool, rerank: bool) -> None:
    """The refine-only IVF layout (`ivfpq_8m_bench`, with and without SOAR's
    duplicated rows) and the crossover's SOAR layout with the pca256-style
    re-rank, built by both packages from the same assignments and rows,
    searched at two nprobes (the 8M bench's window budget; the crossover's
    `apply_runtime_params`)."""
    rng = np.random.default_rng(7)
    c, r, n = 32, 16, N
    centroids = rng.normal(size=(c, D)).astype(np.float32)
    a1 = rng.integers(0, c, n).astype(np.int32)
    a2 = (a1 + rng.integers(1, c, n)).astype(np.int32) % c
    rows = rng.integers(-127, 128, size=(n, r)).astype(np.int8)
    proj = np.linalg.qr(rng.normal(size=(D, D)))[0][:, :r].astype(np.float32)
    scale = np.full((1, r), 0.01, np.float32)
    assign = np.concatenate([a1, a2]) if spill else a1
    row_ids = np.tile(np.arange(n, dtype=np.int32), 2) if spill else None
    refine = np.concatenate([rows, rows]) if spill else rows
    kw = dict(refine_scale=scale, refine_proj=proj, window=64, nprobe=8, row_ids_np=row_ids, n_real=n, spilled=spill)
    if rerank:
        rr = rng.integers(-127, 128, size=(n, 2 * r)).astype(np.int8)
        rr_proj = np.linalg.qr(rng.normal(size=(D, D)))[0][:, : 2 * r].astype(np.float32)
        kw.update(rerank_dev=rr, rerank_scale=np.full((1, 2 * r), 0.01, np.float32), rerank_proj=rr_proj, k_factor=16)
    jix = jax_build_ivfpq(jnp.asarray(centroids), jnp.zeros((1, 1, D), jnp.float32), assign, None,
                          refine_dev=jnp.asarray(refine),
                          **{k: jnp.asarray(v) if isinstance(v, np.ndarray) and k not in ("row_ids_np",) else v
                             for k, v in kw.items()})
    tix = build_ivfpq_from_device_parts(_t(centroids), torch.zeros((1, 1, D)), assign, None, refine_dev=_t(refine),
                                        **{k: _t(v) if isinstance(v, np.ndarray) and k not in ("row_ids_np",) else v
                                           for k, v in kw.items()})
    np.testing.assert_array_equal(tix.row_ids.numpy(), np.asarray(jix.row_ids))
    q = rng.normal(size=(B, D)).astype(np.float32)
    for nprobe in (4, 16):
        if rerank:
            ji, ti = (jax_apply(jix, {"nprobe": nprobe, "k_factor": 16}),
                      apply_runtime_params(tix, {"nprobe": nprobe, "k_factor": 16}))
        else:
            mw = ivfpq_8m_bench.window_budget(tix, nprobe)
            ji, ti = jix.replace(nprobe=nprobe, max_windows=mw), tix.replace(nprobe=nprobe, max_windows=mw)
        want = np.asarray(jax_ivfpq_search(ji, JaxQueries(vector=jnp.asarray(q)), K).indices)
        got = ivfpq_search(ti, SearchQueries(vector=_t(q)), K).indices.numpy()
        np.testing.assert_array_equal(got, want, err_msg=str(nprobe))
