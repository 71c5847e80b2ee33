"""Ring attention and the sequence-parallel encoder
(`vod_tpu_torch/parallel/ring.py`) on W = 2 and 4 gloo ranks, against JAX's
`ring_attention` on an 8-device `sp` mesh, against full attention, and
against JAX's sequential encoder (`tests/test_parallel.py:225-258`).

The key mask holds a row with every key masked: the finite
`finfo(f32).min` fill gives its queries the mean of V in both packages.
Tolerances, f32: outputs within 1e-5; gradients of sum(out²) within 1e-4;
`sp_encoder_forward` within 1e-4 of the sequential encoder.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_parallel import _encoder_setup
from tests.torch_helpers import job_ring, job_sp_encoder, run_ranks
from vod_tpu.parallel import make_mesh as jax_make_mesh
from vod_tpu.parallel.ring import ring_attention as jax_ring_attention
from vod_tpu_torch.models import flax_to_state_dict

ATOL, GRAD_ATOL = 1e-5, 1e-4
B, T, HEADS, DH = 2, 32, 4, 8


@pytest.fixture(scope="module")
def attention_case():
    rng = np.random.default_rng(1)
    q, k, v = (rng.standard_normal((B, T, HEADS, DH)).astype(np.float32) for _ in range(3))
    mask = rng.random((B, T)) > 0.25
    mask[0] = False  # every key of row 0 masked
    neg = jnp.finfo(jnp.float32).min

    def full(qq, kk, vv):
        s = jnp.einsum("bqhd,bkhd->bhqk", qq, kk) * DH**-0.5
        s = jnp.where(jnp.asarray(mask)[:, None, None, :], s, neg)
        return jnp.einsum("bhqk,bkhd->bqhd", jax.nn.softmax(s, axis=-1), vv)

    ref = np.asarray(full(q, k, v))
    grads = [np.asarray(g) for g in jax.grad(lambda a, b, c: jnp.sum(full(a, b, c) ** 2), argnums=(0, 1, 2))(q, k, v)]
    jring = np.asarray(jax.jit(lambda a, b, c: jax_ring_attention(
        a, b, c, mesh=jax_make_mesh((8,), ("sp",)), kv_mask=jnp.asarray(mask)))(q, k, v))
    return dict(q=q, k=k, v=v, mask=mask, ref=ref, grads=grads, jring=jring)


@pytest.mark.parametrize("world", [2, 4])
def test_ring_attention_matches_jax_and_full_attention(world: int, attention_case, tmp_path) -> None:
    c = attention_case
    np.testing.assert_allclose(c["jring"], c["ref"], atol=ATOL, rtol=0)
    np.testing.assert_allclose(c["ref"][0], np.broadcast_to(c["v"][0].mean(0), c["ref"][0].shape), atol=ATOL)
    got = run_ranks(job_ring, world, tmp_path, c["q"], c["k"], c["v"], c["mask"], timeout=120)
    out = np.concatenate([g["out"] for g in got], axis=1)
    np.testing.assert_allclose(out, c["jring"], atol=ATOL, rtol=0)
    np.testing.assert_allclose(out, c["ref"], atol=ATOL, rtol=0)
    for name, want in zip("qkv", c["grads"]):
        np.testing.assert_allclose(np.concatenate([g[name] for g in got], axis=1), want, atol=GRAD_ATOL, rtol=0,
                                   err_msg=name)


def test_ring_attention_on_one_rank_is_full_attention(attention_case) -> None:
    from vod_tpu_torch.parallel import ring_attention

    c = attention_case
    q, k, v = (torch.from_numpy(c[n]).requires_grad_(True) for n in "qkv")
    out = ring_attention(q, k, v, kv_mask=torch.from_numpy(c["mask"]))
    out.pow(2).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), c["ref"], atol=ATOL, rtol=0)
    for t, want in zip((q, k, v), c["grads"]):
        np.testing.assert_allclose(t.grad.numpy(), want, atol=GRAD_ATOL, rtol=0)


@pytest.fixture(scope="module")
def encoder_case():
    cfg, _enc, params, ids, mask, ref = _encoder_setup(num_layers=2, seq=16)
    sizes = dict(vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size, num_layers=cfg.num_layers,
                 num_heads=cfg.num_heads, intermediate_size=cfg.intermediate_size)
    state = {k: v.numpy() for k, v in flax_to_state_dict({"backbone": jax.device_get(params)}).items()}
    return sizes, state, np.asarray(ids), np.asarray(mask), ref


@pytest.mark.parametrize("world", [2, 4])
def test_sp_encoder_forward_matches_jax_sequential(world: int, encoder_case, tmp_path) -> None:
    sizes, state, ids, mask, ref = encoder_case
    got = run_ranks(job_sp_encoder, world, tmp_path, sizes, state, ids, mask, timeout=120)
    np.testing.assert_allclose(np.concatenate(got, axis=1), ref, atol=GRAD_ATOL, rtol=0)


def test_sp_refuses_moe_lora_and_a_missing_group(encoder_case) -> None:
    from tests.torch_helpers import plain_encoder
    from vod_tpu_torch.parallel import ring_attention, sp_encoder_forward

    sizes, state, ids, mask, _ = encoder_case
    for extra in ({"moe_experts": 2}, {"lora_rank": 2}):
        from vod_tpu_torch.models.encoder import TransformerEncoder, TransformerEncoderConfig

        enc = TransformerEncoder(TransformerEncoderConfig(dtype=torch.float32, **sizes, **extra), device="cpu")
        with pytest.raises(ValueError, match="dense FFN layout only"):
            sp_encoder_forward(enc, torch.from_numpy(ids), torch.from_numpy(mask))

    class TwoRanks:  # an sp axis of size 2, and no process group
        mesh_dim_names = ("sp",)

        @staticmethod
        def size(i):
            return 2

    x = torch.zeros((1, 4, 2, 4))
    with pytest.raises(RuntimeError, match="process group"):
        ring_attention(x, x, x, mesh=TwoRanks())
    with pytest.raises(RuntimeError, match="process group"):
        sp_encoder_forward(plain_encoder(sizes, state), torch.from_numpy(ids), torch.from_numpy(mask), mesh=TwoRanks())
