"""The port's reader `CausalLM` against the flax one, with the flax weights
carried over by `models/convert.py:lm_flax_to_state_dict` (2 layers, hidden
64, 4 heads, vocab 97; rows padded at the end, and one row whose first token
is masked, so its first query position sees no key and attends uniformly).

In float32 the two compute the same function with the same weights, summing
in other orders: logits (magnitude ~3.5) agree within atol 2e-5 (2.5e-6 seen).
In bfloat16 the two round at other places (the attention product, the bias
adds), which moves logits by a few bf16 ulps of the hidden states carried
through the f32 head: atol 0.1 (0.04 seen).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_helpers import CPU, np_of
from vod_tpu.models.lm import CausalLM as JaxLM
from vod_tpu.models.lm import CausalLMConfig as JaxConfig
from vod_tpu_torch.models import CausalLM, CausalLMConfig, lm_flax_to_state_dict

SIZES = dict(vocab_size=97, hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128, max_position_embeddings=32)
F32_ATOL = 2e-5
BF16_ATOL = 0.1


def _tokens(seed: int, b: int = 4, length: int = 12):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, SIZES["vocab_size"], size=(b, length)).astype(np.int32)
    mask = np.ones((b, length), np.int32)
    mask[1, 7:] = 0
    mask[2, 3:] = 0
    mask[3, 0] = 0  # no key for the first position
    return ids, mask


def _pair(jax_dtype, torch_dtype, tie: bool = False, seed: int = 0):
    ids, mask = _tokens(seed)
    jmodel = JaxLM(JaxConfig(dtype=jax_dtype, tie_word_embeddings=tie, **SIZES))
    params = jmodel.init(jax.random.PRNGKey(seed), jnp.asarray(ids), jnp.asarray(mask))
    tmodel = CausalLM(CausalLMConfig(dtype=torch_dtype, tie_word_embeddings=tie, **SIZES), device=CPU)
    tmodel.load_state_dict(lm_flax_to_state_dict(jax.device_get(params)))
    j = np_of(jax.jit(jmodel.apply)(params, jnp.asarray(ids), jnp.asarray(mask)))
    with torch.no_grad():
        t = np_of(tmodel(torch.from_numpy(ids), torch.from_numpy(mask)))
    return j, t


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("tie", [False, True], ids=["untied", "tied"])
def test_lm_f32_logits_match_flax(seed: int, tie: bool) -> None:
    j, t = _pair(jnp.float32, torch.float32, tie=tie, seed=seed)
    assert t.shape == (4, 12, SIZES["vocab_size"]) and t.dtype == np.float32
    np.testing.assert_allclose(t, j, atol=F32_ATOL, rtol=0)


def test_lm_bf16_logits_match_flax() -> None:
    j, t = _pair(jnp.bfloat16, torch.bfloat16)
    assert t.dtype == np.float32  # the head is an f32 product
    np.testing.assert_allclose(t, j, atol=BF16_ATOL, rtol=0)


def test_lm_random_init_is_seeded_and_untied_head_has_no_bias() -> None:
    cfg = CausalLMConfig(**SIZES)
    a = CausalLM(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    b = CausalLM(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    for (na, pa), (nb, pb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert na == nb and torch.equal(pa, pb) and pa.dtype == torch.float32
    assert a.lm_head.bias is None
    ids, mask = _tokens(2)
    with torch.no_grad():
        assert torch.isfinite(a(torch.from_numpy(ids), torch.from_numpy(mask))).all()
