"""`fused_mips_binned` takes float queries of any dtype and layout for a float
corpus, casting them as the JAX wrapper does (`vod_tpu/ops/mips_pallas.py:257`),
and refuses what stays refused: non-float queries for a float corpus, an
int8 corpus without int8 queries, a non-contiguous corpus.

On the CPU the port runs the plain version of the kernel, compared with the
JAX Pallas kernel in interpret mode: ids exact, f32 scores within 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_helpers import np_of
from vod_tpu.ops.mips_pallas import fused_mips_binned as jax_binned
from vod_tpu_torch.ops.mips import fused_mips_binned, fused_mips_binned_reference

KW = dict(k=4, bins=128)


def _data() -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(0)
    return rng.normal(size=(2048, 64)).astype(np.float32), rng.normal(size=(64, 8)).astype(np.float32)


def test_float64_queries_match_jax() -> None:
    v, q = _data()
    q = q.T.copy()
    js, ji = jax_binned(jnp.asarray(v).astype(jnp.bfloat16), jnp.asarray(q), qblock=8, interpret=True, **KW)
    vb = torch.from_numpy(v).to(torch.bfloat16)
    for fn in (fused_mips_binned, fused_mips_binned_reference):
        ts, ti = fn(vb, torch.from_numpy(q).to(torch.float64), **KW)
        np.testing.assert_array_equal(np_of(ti), np_of(ji))
        np.testing.assert_allclose(np_of(ts), np_of(js), atol=1e-5, rtol=0)


def test_transposed_f32_queries_match_jax() -> None:
    v, q_t = _data()  # q_t is [D, B]: its transpose is a non-contiguous [B, D] view
    tq = torch.from_numpy(q_t).T
    assert not tq.is_contiguous()
    js, ji = jax_binned(jnp.asarray(v).astype(jnp.bfloat16), jnp.asarray(q_t.T), qblock=8, interpret=True, **KW)
    ts, ti = fused_mips_binned(torch.from_numpy(v).to(torch.bfloat16), tq, **KW)
    np.testing.assert_array_equal(np_of(ti), np_of(ji))
    np.testing.assert_allclose(np_of(ts), np_of(js), atol=1e-5, rtol=0)


def test_refused_calls_stay_refused() -> None:
    v, q_t = _data()
    tv, tq = torch.from_numpy(v), torch.from_numpy(q_t.T.copy())
    with pytest.raises(TypeError, match="float queries"):
        fused_mips_binned(tv, tq.to(torch.int32), **KW)
    with pytest.raises(TypeError, match="int8"):
        fused_mips_binned(tv.to(torch.int8), tq, **KW)
    with pytest.raises(TypeError, match="int8"):
        fused_mips_binned(tv, tq.to(torch.int8), **KW)
    with pytest.raises(ValueError, match="contiguous"):
        fused_mips_binned(tv.T.contiguous().T, tq, **KW)
