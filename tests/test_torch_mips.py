"""`fused_mips_binned` in the port against the JAX Pallas kernel (interpret mode).

On the CPU the port's wrapper runs its plain version, which must compute the
same function as the TPU kernel: f32 ids exact and scores within 1e-5 (the two
sum a 64-term dot product in different orders, ~1e-6 apart at these
magnitudes), int8 ids and scores exact (integer sums). The CUDA kernel is
held against the plain version on the card in `test_torch_cuda.py`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_helpers import np_of
from vod_tpu.ops.mips_pallas import fused_mips_binned as jax_binned
from vod_tpu_torch.ops.mips import fused_mips_binned

F32_ATOL = 1e-5


def _both(v: np.ndarray, q: np.ndarray, **kw):
    js, ji = jax_binned(jnp.asarray(v), jnp.asarray(q), qblock=8, interpret=True, **kw)
    ts, ti = fused_mips_binned(torch.from_numpy(v), torch.from_numpy(q), **kw)
    return np_of(js), np_of(ji), np_of(ts), np_of(ti)


def _data(seed: int, n: int = 1024, d: int = 64, b: int = 16):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, d)).astype("float32"), rng.normal(size=(b, d)).astype("float32")


@pytest.mark.parametrize(
    "kw",
    [
        dict(k=7, tile=256, bins=256),
        dict(k=7, tile=1024, bins=512),
        dict(k=40, tile=1024, bins=1024),
        dict(k=7, tile=256, bins=128),
    ],
    ids=["tile256-bins256", "tile1024-bins512", "bins1024-k40", "tile256-bins128"],
)
def test_binned_f32_matches_jax(kw) -> None:
    v, q = _data(2)
    js, ji, ts, ti = _both(v, q, **kw)
    assert np.array_equal(ji, ti)
    np.testing.assert_allclose(ts, js, atol=F32_ATOL, rtol=0)


def test_binned_int8_matches_jax_exactly() -> None:
    rng = np.random.default_rng(3)
    v = rng.integers(-127, 128, size=(1024, 64)).astype(np.int8)
    q = rng.integers(-127, 128, size=(16, 64)).astype(np.int8)
    for kw in (dict(k=7, tile=256, bins=256), dict(k=16, tile=1024, bins=512, n_real=700)):
        js, ji, ts, ti = _both(v, q, **kw)
        assert ts.dtype == np.int32
        assert np.array_equal(ji, ti) and np.array_equal(js, ts)


def test_binned_n_real_masking() -> None:
    v, q = _data(4)
    js, ji, ts, ti = _both(v, q, k=7, tile=256, bins=256, n_real=50)
    assert np.array_equal(ji, ti)
    assert ti.max() < 50
    np.testing.assert_allclose(ts, js, atol=F32_ATOL, rtol=0)
    # fewer real rows than k: empty cells are -inf with id -1 in both
    js, ji, ts, ti = _both(v, q, k=7, tile=256, bins=256, n_real=3)
    assert np.array_equal(ji, ti) and (ti[:, 3:] == -1).all()
    assert np.isneginf(ts[:, 3:]).all() and np.isneginf(js[:, 3:]).all()


def test_binned_int8_empty_cells_use_the_int32_sentinel() -> None:
    rng = np.random.default_rng(5)
    v = rng.integers(-127, 128, size=(256, 32)).astype(np.int8)
    q = rng.integers(-127, 128, size=(4, 32)).astype(np.int8)
    js, ji, ts, ti = _both(v, q, k=8, tile=256, bins=256, n_real=2)
    assert np.array_equal(ji, ti) and np.array_equal(js, ts)
    assert (ts[:, 2:] == -(2**31) + 1).all() and (ti[:, 2:] == -1).all()


def test_binned_duplicate_rows_tie_to_lowest_id() -> None:
    """Rows 5, 5+bins and 5+3*bins are equal: the cell keeps row 5, in JAX and the port."""
    v, q = _data(6, n=512, d=32, b=8)
    bins = 64
    for j in (5 + bins, 5 + 3 * bins):
        v[j] = v[5]
    q[:] = v[5] + 0.01 * q  # make the duplicated row the winner
    js, ji, ts, ti = _both(v, q, k=4, tile=512, bins=bins)
    assert np.array_equal(ji, ti)
    assert (ti[:, 0] == 5).all()
    np.testing.assert_allclose(ts, js, atol=F32_ATOL, rtol=0)


def test_binned_bins_clamped_to_tile() -> None:
    """bins > tile: the effective bin count is the tile, as on the TPU."""
    v, q = _data(7, n=512)
    js, ji, ts, ti = _both(v, q, k=10, tile=128, bins=1024)
    assert np.array_equal(ji, ti)
    np.testing.assert_allclose(ts, js, atol=F32_ATOL, rtol=0)
    with pytest.raises(ValueError, match="effective bins"):
        fused_mips_binned(torch.from_numpy(v), torch.from_numpy(q), k=200, tile=128, bins=1024)


def test_binned_bf16_corpus_casts_queries() -> None:
    """A bf16 corpus casts f32 queries to bf16 and sums in f32, as JAX does."""
    v, q = _data(8, n=1024, d=64, b=8)
    vb = jnp.asarray(v).astype(jnp.bfloat16)
    js, ji = jax_binned(vb, jnp.asarray(q), k=10, bins=256, qblock=8, interpret=True)
    ts, ti = fused_mips_binned(torch.from_numpy(v).to(torch.bfloat16), torch.from_numpy(q), k=10, bins=256)
    assert np.array_equal(np_of(ji), np_of(ti))
    np.testing.assert_allclose(np_of(ts), np_of(js), atol=F32_ATOL, rtol=0)


def test_binned_wrapper_rejects_bad_calls() -> None:
    v, q = _data(9, n=256, d=16, b=2)
    tv, tq = torch.from_numpy(v), torch.from_numpy(q)
    with pytest.raises(TypeError, match="int8"):
        fused_mips_binned(tv.to(torch.int8), tq, k=4, bins=64)
    with pytest.raises(TypeError):
        fused_mips_binned(tv.double(), tq.double(), k=4, bins=64)
    with pytest.raises(ValueError, match="contiguous"):
        fused_mips_binned(tv, torch.from_numpy(np.asfortranarray(q)), k=4, bins=64)
    with pytest.raises(ValueError, match="tile"):
        fused_mips_binned(tv[:200].contiguous(), tq, k=4, bins=64, tile=128)
    with pytest.raises(ValueError, match="n_real"):
        fused_mips_binned(tv, tq, k=4, bins=64, n_real=300)


def test_binned_cpu_path_never_counts_a_launch() -> None:
    v, q = _data(10, n=256, d=16, b=2)
    before = fused_mips_binned.launches
    fused_mips_binned(torch.from_numpy(v), torch.from_numpy(q), k=4, bins=64)
    assert fused_mips_binned.launches == before

