"""The port's `VodEncoder` against the flax one, with the flax weights carried
over by `models/convert.py` (2 layers, hidden 64, 4 heads).

In float32 the two compute the same function with the same weights, summing in
other orders: embeddings agree within atol 1e-5. In bfloat16 the two round at
other places (bf16 softmax, the bias add before or after rounding), which
moves embeddings by a few bf16 ulps of the hidden states: atol 2e-2 on
embeddings of norm sqrt(10).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_helpers import CPU, np_of
from vod_tpu.models.encoder import DebugEncoder as JaxDebugEncoder
from vod_tpu.models.encoder import TransformerEncoderConfig as JaxConfig
from vod_tpu.models.encoder import VodEncoder as JaxEncoder
from vod_tpu.models.pooler import VodPoolerConfig as JaxPoolerConfig
from vod_tpu_torch.models import (
    DebugEncoder,
    TransformerEncoderConfig,
    VodEncoder,
    VodPoolerConfig,
    flax_to_state_dict,
)

SIZES = dict(vocab_size=97, hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128, max_position_embeddings=32)
POOLER = dict(agg_method="mean", output_norm="l2", scaler=10.0, learn_scaler=True)  # the mean-l2 preset
F32_ATOL = 1e-5
BF16_ATOL = 2e-2


def _tokens(seed: int, b: int = 3, length: int = 12):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, SIZES["vocab_size"], size=(b, length)).astype(np.int32)
    mask = np.ones((b, length), np.int32)
    mask[1, 7:] = 0  # padded rows
    mask[2, 3:] = 0
    return ids, mask


def _pair(jax_dtype, torch_dtype, pooler=POOLER, seed=0):
    jcfg = JaxConfig(dtype=jax_dtype, pooler=JaxPoolerConfig(**pooler), **SIZES)
    tcfg = TransformerEncoderConfig(dtype=torch_dtype, pooler=VodPoolerConfig(**pooler), **SIZES)
    jmodel = JaxEncoder(jcfg)
    ids, mask = _tokens(seed)
    params = jmodel.init(jax.random.PRNGKey(seed), jnp.asarray(ids), jnp.asarray(mask))
    tmodel = VodEncoder(tcfg, device=CPU)
    tmodel.load_state_dict(flax_to_state_dict(jax.device_get(params)))
    return jmodel, params, tmodel, ids, mask


@pytest.mark.parametrize("seed", [0, 1])
def test_encoder_f32_matches_flax(seed: int) -> None:
    jmodel, params, tmodel, ids, mask = _pair(jnp.float32, torch.float32, seed=seed)
    j = np_of(jmodel.apply(params, jnp.asarray(ids), jnp.asarray(mask)))
    with torch.no_grad():
        t = np_of(tmodel(torch.from_numpy(ids), torch.from_numpy(mask)))
    assert t.shape == (3, SIZES["hidden_size"]) and t.dtype == np.float32
    np.testing.assert_allclose(t, j, atol=F32_ATOL, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(t, axis=-1), np.sqrt(10.0), rtol=1e-5)


def test_encoder_bf16_matches_flax() -> None:
    jmodel, params, tmodel, ids, mask = _pair(jnp.bfloat16, torch.bfloat16)
    j = np_of(jmodel.apply(params, jnp.asarray(ids), jnp.asarray(mask)))
    with torch.no_grad():
        t = np_of(tmodel(torch.from_numpy(ids), torch.from_numpy(mask)))
    assert t.dtype == np.float32  # the pooler runs in f32
    np.testing.assert_allclose(t, j, atol=BF16_ATOL, rtol=0)


def test_encoder_tokens_match_flax() -> None:
    jmodel, params, tmodel, ids, mask = _pair(jnp.float32, torch.float32)
    j = np_of(jmodel.apply(params, jnp.asarray(ids), jnp.asarray(mask), method=jmodel.tokens))
    with torch.no_grad():
        t = np_of(tmodel.tokens(torch.from_numpy(ids), torch.from_numpy(mask)))
    np.testing.assert_allclose(t, j, atol=F32_ATOL, rtol=0)
    assert (t[2, 3:] == 0).all()


@pytest.mark.parametrize(
    "pooler",
    [
        dict(agg_method="cls", output_activation="tanh"),
        dict(agg_method="mean", output_norm="l1", scaler=2.0),
        dict(agg_method="mean", projection_size=16, output_activation="gelu", output_norm="l2"),
    ],
    ids=["cls-tanh", "mean-l1", "mean-proj-gelu"],
)
def test_pooler_variants_match_flax(pooler: dict) -> None:
    jmodel, params, tmodel, ids, mask = _pair(jnp.float32, torch.float32, pooler=pooler)
    j = np_of(jmodel.apply(params, jnp.asarray(ids), jnp.asarray(mask)))
    with torch.no_grad():
        t = np_of(tmodel(torch.from_numpy(ids), torch.from_numpy(mask)))
    np.testing.assert_allclose(t, j, atol=F32_ATOL, rtol=0)


def test_max_aggregation_matches_flax() -> None:
    """Max pooling picks the token of largest norm. Post-LN hidden states all
    have nearly the same norm, so it is checked on inputs whose norms differ."""
    from vod_tpu.models.pooler import _aggregate as jax_aggregate
    from vod_tpu_torch.models.pooler import _aggregate

    rng = np.random.default_rng(8)
    x = rng.normal(size=(4, 9, 16)).astype(np.float32) * rng.uniform(0.5, 2.0, size=(4, 9, 1)).astype(np.float32)
    _, mask = _tokens(8, b=4, length=9)
    j = np_of(jax_aggregate("max", jnp.asarray(x), jnp.asarray(mask)))
    t = np_of(_aggregate("max", torch.from_numpy(x), torch.from_numpy(mask)))
    np.testing.assert_array_equal(t, j)


def test_debug_encoder_matches_flax() -> None:
    jcfg = JaxConfig(dtype=jnp.float32, pooler=JaxPoolerConfig(**POOLER), **SIZES)
    tcfg = TransformerEncoderConfig(dtype=torch.float32, pooler=VodPoolerConfig(**POOLER), **SIZES)
    ids, mask = _tokens(3)
    jmodel = JaxDebugEncoder(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(ids), jnp.asarray(mask))
    tmodel = DebugEncoder(tcfg, device="cpu")
    tmodel.load_state_dict(flax_to_state_dict(jax.device_get(params)))
    j = np_of(jmodel.apply(params, jnp.asarray(ids), jnp.asarray(mask)))
    with torch.no_grad():
        t = np_of(tmodel(torch.from_numpy(ids), torch.from_numpy(mask)))
    np.testing.assert_allclose(t, j, atol=F32_ATOL, rtol=0)


def test_random_init_is_seeded_and_finite() -> None:
    cfg = TransformerEncoderConfig(pooler=VodPoolerConfig(**POOLER), **SIZES)
    a = VodEncoder(cfg, device="cpu", generator=torch.Generator().manual_seed(7))
    b = VodEncoder(cfg, device="cpu", generator=torch.Generator().manual_seed(7))
    for (na, pa), (nb, pb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert na == nb and torch.equal(pa, pb)
    assert a.state_dict()["backbone.layers.0.attention.query.weight"].dtype == torch.float32
    ids, mask = _tokens(4)
    with torch.no_grad():
        out = a(torch.from_numpy(ids), torch.from_numpy(mask))
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out.norm(dim=-1), torch.full((3,), 10.0**0.5), rtol=1e-3, atol=0)


def test_unported_options_raise() -> None:
    """MoE is ported: an MoE encoder builds, each layer with its routed FFN;
    MoE with LoRA raises `ValueError`, as JAX's `_Layer` does."""
    from vod_tpu_torch.parallel.moe import MoEFFN

    enc = VodEncoder(TransformerEncoderConfig(moe_experts=2, **SIZES), device="cpu")
    assert all(isinstance(layer.moe, MoEFFN) and layer.moe.n_experts == 2 for layer in enc.backbone.layers)
    with pytest.raises(ValueError, match="mutually exclusive"):
        VodEncoder(TransformerEncoderConfig(moe_experts=2, lora_rank=2, **SIZES), device="cpu")
