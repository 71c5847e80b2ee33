"""The port's LoRA encoder, activation checkpointing and kbit training
(`vod_tpu_torch/models/{encoder,kbit}.py`) against the JAX package's, with
the flax weights carried over by `models/convert.py` (2 layers, hidden 64,
4 heads, LoRA rank 4).

Tolerances: f32 encodings and gradients within atol 1e-5 (the two sum in
other orders); bf16 encodings within 2e-2 (`test_torch_encoder.py`'s bound);
int8 codes and f32 scales exactly equal, leaf by leaf (the same f32
arithmetic, round half to even on both sides); remat on and off equal
bit for bit in the port (the same operations, run again).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_helpers import CPU, np_of
from vod_tpu.models import kbit as jax_kbit
from vod_tpu.models.encoder import TransformerEncoderConfig as JaxConfig
from vod_tpu.models.encoder import VodEncoder as JaxEncoder
from vod_tpu.models.encoder import lora_trainable_mask as jax_lora_mask
from vod_tpu.models.pooler import VodPoolerConfig as JaxPoolerConfig
from vod_tpu_torch.models import (
    QuantizedLeaf,
    TransformerEncoderConfig,
    VodEncoder,
    VodPoolerConfig,
    flax_path,
    flax_to_state_dict,
    full_params,
    kbit_flax_to_state_dict,
    kbit_materialize,
    kbit_memory_bytes,
    kbit_params,
    kbit_prepare,
    lora_trainable_mask,
    quantize_leaf,
)

SIZES = dict(vocab_size=97, hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128, max_position_embeddings=32)
POOLER = dict(agg_method="mean", output_norm="l2", scaler=10.0, learn_scaler=True)
LORA = dict(lora_rank=4, lora_alpha=16.0)
F32_ATOL = 1e-5
BF16_ATOL = 2e-2


def _tokens(seed: int, b: int = 3, length: int = 12):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, SIZES["vocab_size"], size=(b, length)).astype(np.int32)
    mask = np.ones((b, length), np.int32)
    mask[1, 7:] = 0
    mask[2, 3:] = 0
    return ids, mask


def _with_random_adapters(params, seed: int):
    """Every `lora_b` (zero at init) drawn nonzero, so the adapters count."""
    rng = np.random.default_rng(seed + 100)

    def fill(path, leaf):
        if "lora_b" in jax.tree_util.keystr(path):
            return jnp.asarray(0.05 * rng.standard_normal(leaf.shape).astype(np.float32))
        return leaf

    return jax.tree_util.tree_map_with_path(fill, params)


def _pair(seed: int = 0, jax_dtype=jnp.float32, torch_dtype=torch.float32, remat: bool = False):
    jcfg = JaxConfig(dtype=jax_dtype, remat=remat, pooler=JaxPoolerConfig(**POOLER), **LORA, **SIZES)
    tcfg = TransformerEncoderConfig(dtype=torch_dtype, remat=remat, pooler=VodPoolerConfig(**POOLER), **LORA, **SIZES)
    jmodel = JaxEncoder(jcfg)
    ids, mask = _tokens(seed)
    params = jmodel.init(jax.random.PRNGKey(seed), jnp.asarray(ids), jnp.asarray(mask))
    params = jax.device_get(_with_random_adapters(params, seed))
    tmodel = VodEncoder(tcfg, device=CPU)
    tmodel.load_state_dict(flax_to_state_dict(params))
    return jmodel, params, tmodel, ids, mask


def _jax_grads(jmodel, params, ids, mask, weights):
    def loss(p):
        return jnp.sum(jmodel.apply(p, jnp.asarray(ids), jnp.asarray(mask)) * weights)

    return jax.device_get(jax.grad(loss)(params))


def _port_grads(tmodel, ids, mask, weights) -> dict:
    tmodel.zero_grad(set_to_none=True)
    out = tmodel(torch.from_numpy(ids), torch.from_numpy(mask))
    (out * torch.from_numpy(weights)).sum().backward()
    return {n: p.grad.clone() for n, p in tmodel.named_parameters()}


@pytest.mark.parametrize("seed", [0, 1])
def test_lora_encoder_f32_matches_flax(seed: int) -> None:
    jmodel, params, tmodel, ids, mask = _pair(seed)
    j = np_of(jmodel.apply(params, jnp.asarray(ids), jnp.asarray(mask)))
    with torch.no_grad():
        t = np_of(tmodel(torch.from_numpy(ids), torch.from_numpy(mask)))
    np.testing.assert_allclose(t, j, atol=F32_ATOL, rtol=0)
    # the adapters move the encoding: the same weights with lora_b at 0 differ
    sd = {k: (torch.zeros_like(v) if k.endswith("lora_b") else v) for k, v in tmodel.state_dict().items()}
    tmodel.load_state_dict(sd)
    with torch.no_grad():
        t0 = np_of(tmodel(torch.from_numpy(ids), torch.from_numpy(mask)))
    assert np.abs(t0 - j).max() > 100 * F32_ATOL


def test_lora_encoder_bf16_matches_flax() -> None:
    jmodel, params, tmodel, ids, mask = _pair(0, jnp.bfloat16, torch.bfloat16)
    j = np_of(jmodel.apply(params, jnp.asarray(ids), jnp.asarray(mask)))
    with torch.no_grad():
        t = np_of(tmodel(torch.from_numpy(ids), torch.from_numpy(mask)))
    np.testing.assert_allclose(t, j, atol=BF16_ATOL, rtol=0)


@pytest.mark.parametrize("remat", [False, True])
def test_lora_gradients_match_flax(remat: bool) -> None:
    """d(sum(w * encoding)) / d(every parameter), JAX's `nn.remat` beside the
    port's checkpointing."""
    jmodel, params, tmodel, ids, mask = _pair(0, remat=remat)
    weights = np.random.default_rng(5).standard_normal((3, SIZES["hidden_size"])).astype(np.float32)
    jg = flax_to_state_dict(_jax_grads(jmodel, params, ids, mask, jnp.asarray(weights)))
    tg = _port_grads(tmodel, ids, mask, weights)
    assert set(tg) == set(jg)
    for name, g in tg.items():
        np.testing.assert_allclose(np_of(g), np_of(jg[name]), atol=F32_ATOL, rtol=0, err_msg=name)


def test_remat_changes_neither_outputs_nor_gradients() -> None:
    _, _, plain, ids, mask = _pair(1)
    _, _, remat, _, _ = _pair(1, remat=True)
    remat.load_state_dict(plain.state_dict())
    weights = np.random.default_rng(6).standard_normal((3, SIZES["hidden_size"])).astype(np.float32)
    with torch.no_grad():
        assert torch.equal(plain(torch.from_numpy(ids), torch.from_numpy(mask)),
                           remat(torch.from_numpy(ids), torch.from_numpy(mask)))
    gp, gr = _port_grads(plain, ids, mask, weights), _port_grads(remat, ids, mask, weights)
    assert all(torch.equal(gp[n], gr[n]) for n in gp)


def test_trainable_mask_equals_jax() -> None:
    _, params, tmodel, _, _ = _pair(0)
    jmask = {jax.tree_util.keystr(p): bool(v)
             for p, v in jax.tree_util.tree_leaves_with_path(jax_lora_mask(params))}
    tmask = lora_trainable_mask(tmodel)
    assert {flax_path(n): v for n, v in tmask.items()} == jmask
    assert sorted(n.rsplit(".", 1)[-1] for n, v in tmask.items() if v) == ["log_scaler"] + ["lora_a"] * 4 + ["lora_b"] * 4


def _jax_kbit(params):
    return jax_kbit.kbit_prepare(params, jax_lora_mask(params))


def test_kbit_codes_and_scales_equal_jax_leaf_by_leaf() -> None:
    _, params, tmodel, _, _ = _pair(0)
    jkb = _jax_kbit(params)
    tkb = kbit_prepare(tmodel, lora_trainable_mask(tmodel))
    assert {flax_path(n) for n in tkb.trainable} == set(jkb.trainable)
    assert {flax_path(n) for n in tkb.frozen} == set(jkb.frozen)
    quantized = []
    for name, leaf in tkb.frozen.items():
        jleaf = jkb.frozen[flax_path(name)]
        assert isinstance(leaf, QuantizedLeaf) == isinstance(jleaf, jax_kbit.QuantizedLeaf), name
        if isinstance(leaf, QuantizedLeaf):
            assert leaf.codes.dtype == torch.int8 and leaf.scale.dtype == torch.float32
            np.testing.assert_array_equal(np_of(leaf.codes), np.asarray(jleaf.codes), err_msg=name)
            np.testing.assert_array_equal(np_of(leaf.scale), np.asarray(jleaf.scale), err_msg=name)
            quantized.append((name, tuple(leaf.scale.shape)))
        else:
            np.testing.assert_array_equal(np_of(leaf).reshape(-1), np.asarray(jleaf).reshape(-1), err_msg=name)
    shapes = dict(quantized)
    h, heads, head = SIZES["hidden_size"], SIZES["num_heads"], SIZES["hidden_size"] // SIZES["num_heads"]
    for qkv in ("query", "key", "value"):
        # one scale per head-dim index, shared across heads (flax's [h, heads, head] kernel)
        assert shapes[f"backbone.layers.0.attention.{qkv}.weight"] == (1, 1, head)
        assert shapes[f"backbone.layers.0.attention.{qkv}.bias"] == (1, head)
    assert shapes["backbone.layers.0.attention.out.weight"] == (1, 1, h)
    assert shapes["backbone.layers.1.intermediate.base.weight"] == (1, SIZES["intermediate_size"])
    assert shapes["backbone.embeddings.word_embeddings.weight"] == (1, h)
    assert "backbone.layers.0.attention.out.bias" not in shapes and "backbone.layers.0.output.base.bias" not in shapes
    assert len(quantized) == 3 + 2 * (3 * 2 + 1 + 2)  # embeddings; per layer q/k/v kernel+bias, out, 2 FFN bases
    assert {n for n, p in tmodel.named_parameters()} == set(tkb.trainable)


def test_kbit_forward_memory_and_materialize_match_jax() -> None:
    jmodel, params, tmodel, ids, mask = _pair(1)
    jkb = _jax_kbit(params)
    jfull = jax_kbit.full_params(jkb)
    j = np_of(jmodel.apply(jfull, jnp.asarray(ids), jnp.asarray(mask)))
    tkb = kbit_prepare(tmodel, lora_trainable_mask(tmodel))
    with torch.no_grad():
        t = np_of(tmodel(torch.from_numpy(ids), torch.from_numpy(mask)))
    np.testing.assert_allclose(t, j, atol=F32_ATOL, rtol=0)
    assert kbit_memory_bytes(tkb) == {k: int(v) for k, v in jax_kbit.kbit_memory_bytes(jkb).items()}
    want = flax_to_state_dict(jax.device_get(jfull))
    got = kbit_materialize(tmodel)
    assert set(got) == set(want) and full_params(tmodel).keys() == got.keys()
    for name, v in got.items():
        np.testing.assert_array_equal(np_of(v), np_of(want[name]), err_msg=name)
    # a plain encoder loads the materialized view and computes the same function
    _, _, plain, _, _ = _pair(1)
    plain.load_state_dict(got)
    with torch.no_grad():
        np.testing.assert_allclose(np_of(plain(torch.from_numpy(ids), torch.from_numpy(mask))), t, atol=1e-6, rtol=0)


def test_kbit_trainable_gradients_match_jax() -> None:
    """Gradients flow to the trainable subset only, through the dequantized base."""
    jmodel, params, tmodel, ids, mask = _pair(0, remat=True)
    jkb = _jax_kbit(params)
    weights = np.random.default_rng(7).standard_normal((3, SIZES["hidden_size"])).astype(np.float32)

    def loss(trainable):
        full = jax_kbit.kbit_materialize(trainable, jkb.frozen, jkb.treedef, jkb.paths)
        return jnp.sum(jmodel.apply(full, jnp.asarray(ids), jnp.asarray(mask)) * jnp.asarray(weights))

    jg = jax.device_get(jax.grad(loss)(jkb.trainable))
    kbit_prepare(tmodel, lora_trainable_mask(tmodel))
    tg = _port_grads(tmodel, ids, mask, weights)
    assert {flax_path(n) for n in tg} == set(jg)
    for name, g in tg.items():
        np.testing.assert_allclose(np_of(g), np.asarray(jg[flax_path(name)]), atol=F32_ATOL, rtol=0, err_msg=name)
    assert not any(b.requires_grad for b in tmodel.buffers())


def test_kbit_params_carry_over_from_jax() -> None:
    """A JAX `KbitParams` loads into a prepared port model: the same state."""
    _, params, tmodel, _, _ = _pair(0)
    jkb = _jax_kbit(params)
    kbit_prepare(tmodel, lora_trainable_mask(tmodel))
    frozen = {k: ((np.asarray(v.codes), np.asarray(v.scale)) if isinstance(v, jax_kbit.QuantizedLeaf)
                  else np.asarray(v)) for k, v in jkb.frozen.items()}
    sd = kbit_flax_to_state_dict(tmodel, jax.device_get(jkb.trainable), frozen)
    own = tmodel.state_dict()
    assert set(sd) == set(own)
    for name, v in sd.items():
        assert v.dtype == own[name].dtype and torch.equal(v, own[name]), name
    tmodel.load_state_dict(sd)


def test_quantize_leaf_and_embedding_gather() -> None:
    """`quantize_leaf` against JAX's on an odd shape with a zero column; a
    quantized embedding's gathered rows equal the dequantized table's."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((5, 3, 7)).astype(np.float32)
    x[..., 2] = 0.0
    t, j = quantize_leaf(torch.from_numpy(x)), jax_kbit.quantize_leaf(jnp.asarray(x))
    np.testing.assert_array_equal(np_of(t.codes), np.asarray(j.codes))
    np.testing.assert_array_equal(np_of(t.scale), np.asarray(j.scale))
    np.testing.assert_array_equal(np_of(t.dequantize()), np.asarray(j.dequantize()))
    _, _, tmodel, ids, _ = _pair(0)
    kbit_prepare(tmodel, lora_trainable_mask(tmodel))
    emb = tmodel.backbone.embeddings.word_embeddings
    table = kbit_params(tmodel).frozen["backbone.embeddings.word_embeddings.weight"].dequantize()
    assert torch.equal(emb(torch.from_numpy(ids)), table[torch.from_numpy(ids)])
    assert torch.equal(emb.weight, table)
