"""The port's PQ ops (`vod_tpu_torch/ops/pq.py`) and the PQ helpers of
`search/dense.py` against the JAX package's, on seeded numpy data, f32.

Tolerances: codes, packed nibbles and int8 quantisation exactly equal;
decoded rows within 1e-6; LUTs and ADC scores within 1e-6 of the largest
|value| (f32 sums of terms that cancel, in other orders);
`train_projection` equal up to the sign of each column (LAPACK builds may
flip an eigenvector), checked as |columns| and proj @ projᵀ within 1e-5;
warm-started `train_pq` and `train_pq_anisotropic` within 1e-5 (no cluster
goes empty from these warm starts, so no re-seed draw enters); OPQ is
checked on the port alone.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_helpers import np_of
from vod_tpu.ops import pq as jpq
from vod_tpu.search import dense as jdense
from vod_tpu_torch.ops import pq
from vod_tpu_torch.search import dense

ATOL = 1e-6
TRAIN_ATOL = 1e-5


def _data(seed: int, n: int, d: int) -> np.ndarray:
    """Correlated rows with a decaying spectrum (distinct eigenvalues)."""
    rng = np.random.default_rng(seed)
    mix = rng.standard_normal((d, d)).astype(np.float32) * np.linspace(1.0, 0.1, d, dtype=np.float32)[:, None]
    return (rng.standard_normal((n, d)).astype(np.float32) @ mix).astype(np.float32)


def _codebooks(seed: int, m: int, k: int, dsub: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((m, k, dsub)).astype(np.float32)


@pytest.mark.parametrize("m, k", [(8, 256), (16, 16)])
def test_encode_decode_lut_adc_match_jax(m: int, k: int) -> None:
    x = _data(0, 700, 32)
    cb = _codebooks(1, m, k, 32 // m)
    codes_j = np_of(jpq.encode_pq(jnp.asarray(cb), jnp.asarray(x), chunk=256))
    codes_t = pq.encode_pq(torch.from_numpy(cb), torch.from_numpy(x), chunk=256)
    assert codes_t.dtype == torch.uint8
    np.testing.assert_array_equal(np_of(codes_t), codes_j)
    np.testing.assert_allclose(np_of(pq.decode_pq(torch.from_numpy(cb), codes_t)),
                               np_of(jpq.decode_pq(jnp.asarray(cb), jnp.asarray(codes_j))), atol=ATOL, rtol=0)
    q = _data(2, 5, 32)
    lut_j = jpq.adc_lut(jnp.asarray(cb), jnp.asarray(q))
    lut_t = pq.adc_lut(torch.from_numpy(cb), torch.from_numpy(q))
    np.testing.assert_allclose(np_of(lut_t), np_of(lut_j), atol=ATOL * np.abs(np_of(lut_j)).max(), rtol=0)
    cand = np.random.default_rng(3).integers(0, 700, (5, 40))
    adc_j = jpq.adc_score_codes(lut_j, jnp.asarray(codes_j[cand]))
    adc_t = pq.adc_score_codes(lut_t, codes_t[torch.from_numpy(cand)])
    np.testing.assert_allclose(np_of(adc_t), np_of(adc_j), atol=ATOL * np.abs(np_of(adc_j)).max(), rtol=0)


def test_pack_unpack_and_decode_rows_match_jax() -> None:
    codes = np.random.default_rng(4).integers(0, 16, (33, 12)).astype(np.uint8)
    packed_j = np_of(jdense._pack_codes4(jnp.asarray(codes)))
    packed_t = dense._pack_codes4(torch.from_numpy(codes))
    np.testing.assert_array_equal(np_of(packed_t), packed_j)
    assert packed_t.dtype == torch.uint8 and (np_of(packed_t) & 15 == codes[:, 0::2]).all()  # even one low
    np.testing.assert_array_equal(np_of(dense._unpack_codes4(packed_t)), codes)
    cb = _codebooks(5, 12, 16, 3)
    got = np_of(dense.decode_rows(torch.from_numpy(cb), torch.from_numpy(codes)))
    for onehot in (False, True):  # JAX's gather and one-hot products select the same rows
        want = np_of(jdense.decode_rows(jnp.asarray(cb), jnp.asarray(codes), onehot=onehot))
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_quantize_int8_and_adc_scan_inputs_match_jax() -> None:
    x = _data(6, 200, 24)
    cj, sj = jpq.quantize_int8(jnp.asarray(x), axis=0)
    ct, st = pq.quantize_int8(torch.from_numpy(x), dim=0)
    np.testing.assert_array_equal(np_of(ct), np_of(cj))
    np.testing.assert_array_equal(np_of(st), np_of(sj))
    cb, q = _codebooks(7, 8, 16, 3), _data(8, 6, 24)
    for got, want in zip(dense._int8_adc_scan_inputs(torch.from_numpy(cb), torch.from_numpy(q)),
                         jdense._int8_adc_scan_inputs(jnp.asarray(cb), jnp.asarray(q))):
        np.testing.assert_array_equal(np_of(got), np_of(want))
    cb_i8, q_i8, q_row = dense._int8_adc_scan_inputs(torch.from_numpy(cb), torch.from_numpy(q))
    c = np.random.default_rng(9).integers(0, 16, (50, 8)).astype(np.uint8)
    want = jdense._int8_onehot_adc_chunk(jnp.asarray(np_of(cb_i8)), jnp.asarray(np_of(q_i8)), jnp.asarray(np_of(q_row)),
                                         jnp.asarray(c))
    got = dense._int8_onehot_adc_chunk(cb_i8, q_i8, q_row, torch.from_numpy(c))
    np.testing.assert_array_equal(np_of(got), np_of(want))  # exact integer sums, one f32 scale


def test_train_projection_matches_jax_up_to_sign() -> None:
    x = _data(10, 500, 16)
    pj, mj = jpq.train_projection(jnp.asarray(x), 6)
    pt, mt = pq.train_projection(torch.from_numpy(x), 6)
    np.testing.assert_allclose(np_of(mt), np_of(mj), atol=ATOL, rtol=0)
    np.testing.assert_allclose(np.abs(np_of(pt)), np.abs(np_of(pj)), atol=TRAIN_ATOL, rtol=0)
    np.testing.assert_allclose(np_of(pt @ pt.T), np_of(pj @ pj.T), atol=TRAIN_ATOL, rtol=0)


@pytest.mark.parametrize("m, k", [(4, 16), (8, 32)])
def test_train_pq_warm_started_matches_jax(m: int, k: int) -> None:
    x = _data(11, 1500, 16)
    dsub = 16 // m
    # warm start: rows of x itself, so every codeword owns at least its row at first
    init = np.stack([x[np.random.default_rng(12 + i).choice(1500, k, replace=False), i * dsub:(i + 1) * dsub]
                     for i in range(m)])
    want = jpq.train_pq(jax.random.PRNGKey(0), jnp.asarray(x), m, n_codes=k, n_iters=5, init_codebooks=jnp.asarray(init))
    got = pq.train_pq(torch.from_numpy(x), m, n_codes=k, n_iters=5, init_codebooks=torch.from_numpy(init),
                      generator=torch.Generator().manual_seed(0))
    codes = np_of(pq.encode_pq(got, torch.from_numpy(x)))
    assert all(np.bincount(codes[:, i], minlength=k).min() > 0 for i in range(m))  # nothing went empty at the end
    np.testing.assert_allclose(np_of(got), np_of(want), atol=TRAIN_ATOL, rtol=0)


def test_train_pq_groups_subspaces_under_the_memory_bound() -> None:
    """The group size bounds the per-group temps at ~1 GB, as in JAX: 16
    subspaces a group at 1M rows x 16 codes (the msmarco_pq_realm codec)."""
    assert pq._group_size(128, 1_000_000, 16) == 16
    assert pq._group_size(32, 1_000_000, 256) == 1
    assert pq._group_size(8, 100, 256) == 8


def test_train_opq_rotation_is_orthonormal_and_no_worse_than_pq() -> None:
    x = _data(13, 2000, 16)
    g = torch.Generator().manual_seed(0)
    r, cb = pq.train_opq(torch.from_numpy(x), 4, n_codes=16, n_iters=4, kmeans_iters=4, generator=g)
    torch.testing.assert_close(r.T @ r, torch.eye(16), atol=1e-5, rtol=0)
    xr = torch.from_numpy(x) @ r
    err_opq = ((pq.decode_pq(cb, pq.encode_pq(cb, xr)) - xr) ** 2).sum(-1).mean()
    cb_pq = pq.train_pq(torch.from_numpy(x), 4, n_codes=16, n_iters=8, generator=torch.Generator().manual_seed(0))
    err_pq = ((pq.decode_pq(cb_pq, pq.encode_pq(cb_pq, torch.from_numpy(x))) - torch.from_numpy(x)) ** 2).sum(-1).mean()
    assert err_opq <= err_pq, (float(err_opq), float(err_pq))


def test_anisotropic_encode_and_train_match_jax() -> None:
    x = _data(14, 600, 16)
    cb = np.stack([x[np.random.default_rng(15 + i).choice(600, 16, replace=False), i * 4:(i + 1) * 4] for i in range(4)])
    want = np_of(jpq.encode_pq_anisotropic(jnp.asarray(cb), jnp.asarray(x), 4.0, chunk=256))
    got = np_of(pq.encode_pq_anisotropic(torch.from_numpy(cb), torch.from_numpy(x), 4.0, chunk=256))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np_of(pq.encode_pq_auto(torch.from_numpy(cb), torch.from_numpy(x), None)),
                                  np_of(jpq.encode_pq_auto(jnp.asarray(cb), jnp.asarray(x), None)))
    want_cb = jpq.train_pq_anisotropic(jax.random.PRNGKey(0), jnp.asarray(x), 4, n_codes=16, eta=4.0, n_iters=2,
                                       chunk=256, init_codebooks=jnp.asarray(cb))
    got_cb = pq.train_pq_anisotropic(torch.from_numpy(x), 4, n_codes=16, eta=4.0, n_iters=2, chunk=256,
                                     init_codebooks=torch.from_numpy(cb))
    np.testing.assert_allclose(np_of(got_cb), np_of(want_cb), atol=TRAIN_ATOL, rtol=0)


def test_eta_resolution_matches_jax() -> None:
    x = _data(16, 300, 24)
    assert pq.participation_ratio(torch.from_numpy(x)) == pytest.approx(jpq.participation_ratio(jnp.asarray(x)), rel=1e-5)
    for eta in (None, 3.5, "auto"):
        want = jpq.resolve_aniso_eta(eta, jnp.asarray(x))
        got = pq.resolve_aniso_eta(eta, torch.from_numpy(x))
        assert got == pytest.approx(want, rel=1e-5) if want is not None else got is None
    assert pq.anisotropic_eta(0.2, 768) == jpq.anisotropic_eta(0.2, 768)
