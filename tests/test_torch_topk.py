"""`fused_mips_topk` in the port against the JAX Pallas kernel (interpret mode).

On the CPU the port's wrapper runs its plain version, which must compute the
same function as the TPU kernel: f32 ids exact and scores within 1e-5 (the two
sum a 64-term dot product in different orders, ~1e-6 apart at these
magnitudes). One difference is declared: where a slot's score is -inf the port
returns id -1 (the repo's padding contract), while the TPU kernel repeats the
id of slot 0 there once the rows span more than one tile. The CUDA kernel is
held against the plain version on the card in `test_torch_cuda.py`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_helpers import np_of
from vod_tpu.ops.mips_pallas import fused_mips_topk as jax_topk
from vod_tpu_torch.ops.mips import _topk_body, fused_mips_topk, fused_mips_topk_reference

F32_ATOL = 1e-5


def _both(v: np.ndarray, q: np.ndarray, jv=None, **kw):
    jv = jnp.asarray(v) if jv is None else jv
    tv = torch.from_numpy(v) if jv.dtype != jnp.bfloat16 else torch.from_numpy(v).to(torch.bfloat16)
    js, ji = jax_topk(jv, jnp.asarray(q), interpret=True, **kw)
    ts, ti = fused_mips_topk(tv, torch.from_numpy(q), **kw)
    return np_of(js), np_of(ji), np_of(ts), np_of(ti)


def _data(seed: int, n: int = 1024, d: int = 64, b: int = 16):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, d)).astype("float32"), rng.normal(size=(b, d)).astype("float32")


@pytest.mark.parametrize("k", [1, 7, 128])
def test_topk_f32_matches_jax(k: int) -> None:
    v, q = _data(1)
    js, ji, ts, ti = _both(v, q, k=k, tile=256, qblock=8)
    assert ts.dtype == np.float32 and ti.dtype == np.int32 and ti.shape == (16, k)
    assert np.array_equal(ji, ti)
    np.testing.assert_allclose(ts, js, atol=F32_ATOL, rtol=0)


def test_topk_bf16_corpus_casts_queries() -> None:
    """A bf16 corpus casts f32 queries to bf16 and sums in f32, as JAX does."""
    v, q = _data(2)
    js, ji, ts, ti = _both(v, q, jv=jnp.asarray(v).astype(jnp.bfloat16), k=10, tile=256, qblock=8)
    assert np.array_equal(ji, ti)
    np.testing.assert_allclose(ts, js, atol=F32_ATOL, rtol=0)


def test_topk_n_real_masking() -> None:
    v, q = _data(3)
    js, ji, ts, ti = _both(v, q, k=7, tile=256, qblock=8, n_real=50)
    assert np.array_equal(ji, ti)
    assert ti.max() < 50
    np.testing.assert_allclose(ts, js, atol=F32_ATOL, rtol=0)


def test_topk_empty_slots_hold_minus_one() -> None:
    """n_real = 3 over 4 tiles of 256 rows with k = 7: the finite slots agree;
    at -inf JAX repeats slot 0's id (its masked argmax returns lane 0 again,
    which holds the buffer's best id after the first tile), the port has -1."""
    v, q = _data(4)
    js, ji, ts, ti = _both(v, q, k=7, tile=256, qblock=8, n_real=3)
    np.testing.assert_allclose(ts[:, :3], js[:, :3], atol=F32_ATOL, rtol=0)
    assert np.array_equal(ji[:, :3], ti[:, :3])
    assert sorted(ti[0, :3].tolist()) == [0, 1, 2]
    assert np.isneginf(js[:, 3:]).all() and np.isneginf(ts[:, 3:]).all()
    assert (ji[:, 3:] == ji[:, :1]).all()  # the TPU kernel's stale id
    assert (ti[:, 3:] == -1).all()  # the port's padding contract


def test_topk_duplicate_rows_tie_to_lowest_id() -> None:
    """Rows 5, 100 and 261 are equal and the query is row 5: lowest id first,
    across tiles of 256 rows, in JAX and in the port."""
    v, q = _data(5)
    for j in (100, 261):
        v[j] = v[5]
    q[0] = v[5]
    js, ji, ts, ti = _both(v, q, k=8, tile=256, qblock=8)
    assert ji[0, :3].tolist() == [5, 100, 261]
    assert np.array_equal(ji, ti)
    assert ts[0, 0] == ts[0, 1] == ts[0, 2]
    np.testing.assert_allclose(ts, js, atol=F32_ATOL, rtol=0)


def test_topk_wrapper_rejects_bad_calls() -> None:
    v, q = _data(6, n=512, d=16, b=6)
    tv, tq = torch.from_numpy(v), torch.from_numpy(q)
    with pytest.raises(ValueError, match="k"):
        fused_mips_topk(tv, tq, k=129, tile=256)
    with pytest.raises(ValueError, match="k"):
        fused_mips_topk(tv, tq, k=0, tile=256)
    with pytest.raises(ValueError, match="tile"):
        fused_mips_topk(tv, tq, k=4, tile=384)
    with pytest.raises(ValueError, match="qblock"):
        fused_mips_topk(tv, tq, k=4, tile=256, qblock=4)
    with pytest.raises(TypeError, match="int8|bfloat16"):
        fused_mips_topk(tv.to(torch.int8), tq, k=4, tile=256)
    with pytest.raises(ValueError, match="n_real"):
        fused_mips_topk(tv, tq, k=4, tile=256, n_real=513)
    with pytest.raises(ValueError, match="n_real"):
        fused_mips_topk_reference(tv, tq, k=4, tile=256, n_real=513)


def test_topk_cpu_path_never_counts_a_launch() -> None:
    v, q = _data(7, n=256, d=16, b=2)
    before = fused_mips_topk.launches
    fused_mips_topk(torch.from_numpy(v), torch.from_numpy(q), k=4, tile=256)
    assert fused_mips_topk.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_topk_cpu_path_never_counts_a_body_launch(dtype: torch.dtype) -> None:
    v, q = _data(7, n=256, d=16, b=2)
    before = fused_mips_topk.launches, dict(fused_mips_topk.body_launches)
    fused_mips_topk(torch.from_numpy(v).to(dtype), torch.from_numpy(q), k=4, tile=256)
    assert (fused_mips_topk.launches, fused_mips_topk.body_launches) == before


def _bf16_rows(n: int, d: int, offset: int = 0) -> torch.Tensor:
    """[n, d] bf16 rows starting `offset` elements into a fresh buffer."""
    return torch.zeros(n * d + offset, dtype=torch.bfloat16)[offset:].view(n, d)


@pytest.mark.parametrize(
    "dtype, d, v_offset, q_offset, body",
    [
        (torch.bfloat16, 768, 0, 0, "wgmma"),  # the shootout's corpus
        (torch.bfloat16, 64, 0, 0, "wgmma"),
        (torch.bfloat16, 896, 0, 0, "wgmma"),  # the widest query tile that fits
        (torch.float32, 768, 0, 0, "fma"),  # wgmma has no full-f32 mode
        (torch.bfloat16, 36, 0, 0, "fma"),  # D % 8 != 0: rows are not 16-byte strided
        (torch.bfloat16, 904, 0, 0, "fma"),  # the query tile would not fit beside k = 128 lists
        (torch.bfloat16, 64, 1, 0, "fma"),  # a storage_offset off the 16-byte grid
        (torch.bfloat16, 64, 8, 0, "wgmma"),  # ... and one on it
        (torch.bfloat16, 64, 0, 4, "fma"),  # the queries' pointer counts too
    ],
)
def test_topk_body_rule(dtype: torch.dtype, d: int, v_offset: int, q_offset: int, body: str) -> None:
    """The fixed rule that names the exact kernel's body for a CUDA call."""
    v, q = _bf16_rows(4, d, v_offset).to(dtype), _bf16_rows(2, d, q_offset)
    assert v.storage_offset() == v_offset
    assert _topk_body(dtype, d, (v.data_ptr(), q.data_ptr())) == body
