"""The port's causal decoding against the JAX package: `CausalLM.prefill` and
`decode_step`, `lm_generate` (greedy, EOS/pad, sampled with shared Gumbel
noise), `filter_logits`, and `Realm.generate` / `mode="generate"`.

Reader: 2 layers, hidden 64, 4 heads, vocab 97, f32 on both sides, the flax
weights carried over by `models/convert.py`. Right-padded prompts of lengths
12, 7, 3 and 9. Logits (magnitude ~3) agree within atol 1e-4 (sums in other
orders; 2e-6 seen); caches within 1e-5.

Tokens follow the margin rule: for each row, tokens are compared up to the
first step whose top-2 margin (of the quantity whose argmax picks the token)
is under the logit tolerance, from the JAX reference's own per-step logits.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_helpers import CPU, np_of
from vod_tpu.models.lm import CausalLM as JaxLM
from vod_tpu.models.lm import CausalLMConfig as JaxConfig
from vod_tpu.models.lm import lm_generate as jax_lm_generate
from vod_tpu.models.seq2seq import filter_logits as jax_filter_logits
from vod_tpu_torch.models import CausalLM, CausalLMConfig, filter_logits, lm_flax_to_state_dict, lm_generate

SIZES = dict(vocab_size=97, hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128, max_position_embeddings=32)
LENGTHS = (12, 7, 3, 9)
LOGIT_ATOL = 1e-4
CACHE_ATOL = 1e-5
T = 6


def _prompts(seed: int = 0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(2, SIZES["vocab_size"], size=(len(LENGTHS), max(LENGTHS))).astype(np.int32)
    mask = (np.arange(max(LENGTHS))[None] < np.asarray(LENGTHS)[:, None]).astype(np.int32)
    return ids * mask, mask


def _pair(seed: int = 0, tie: bool = False):
    ids, mask = _prompts(seed)
    jmodel = JaxLM(JaxConfig(dtype=jnp.float32, tie_word_embeddings=tie, **SIZES))
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(seed), jnp.asarray(ids), jnp.asarray(mask)))
    tmodel = CausalLM(CausalLMConfig(dtype=torch.float32, tie_word_embeddings=tie, **SIZES), device=CPU)
    tmodel.load_state_dict(lm_flax_to_state_dict(params))
    return jmodel, params, tmodel, ids, mask


def jax_step_logits(jmodel, params, ids, mask, toks) -> np.ndarray:
    """The reference's logits before each generated token, [B, T, V]: the
    prefill's logits at each row's last valid position, then one decode step
    per token of `toks` [B, T]."""
    ids, mask = jnp.asarray(ids), jnp.asarray(mask)
    toks = jnp.asarray(np.asarray(toks), jnp.int32)
    logits_all, cache = jmodel.apply(params, ids, mask, ids.shape[1] + toks.shape[1], method=JaxLM.prefill)
    out = [logits_all[jnp.arange(ids.shape[0]), jnp.sum(mask > 0, axis=-1) - 1]]
    step = jax.jit(lambda p, t, c: jmodel.apply(p, t, c, method=JaxLM.decode_step))
    for t in range(toks.shape[1] - 1):
        logits, cache = step(params, toks[:, t], cache)
        out.append(logits)
    return np.stack([np.asarray(x) for x in out], axis=1)


def assert_tokens_margin(got, want, scores: np.ndarray, tol: float = LOGIT_ATOL) -> int:
    """Tokens equal per row up to the first step whose top-2 margin of
    `scores` [B, T, V] is under `tol`. Returns the number of steps compared."""
    got, want = np_of(got), np_of(want)
    assert got.shape == want.shape
    top2 = np.sort(scores, axis=-1)[..., -2:]
    close = (top2[..., 1] - top2[..., 0]) < tol
    compared = 0
    for r in range(got.shape[0]):
        n = int(np.argmax(close[r])) if close[r].any() else got.shape[1]
        np.testing.assert_array_equal(got[r, :n], want[r, :n], err_msg=f"row {r}")
        compared += n
    return compared


@pytest.mark.parametrize("tie", [False, True], ids=["untied", "tied"])
def test_prefill_and_decode_steps_match_jax(tie: bool) -> None:
    jmodel, params, tmodel, ids, mask = _pair(tie=tie)
    max_len = ids.shape[1] + T
    jlogits, jcache = jmodel.apply(params, jnp.asarray(ids), jnp.asarray(mask), max_len, method=JaxLM.prefill)
    with torch.no_grad():
        tlogits, tcache = tmodel.prefill(torch.from_numpy(ids), torch.from_numpy(mask), max_len)
        tlast, _ = tmodel.prefill(torch.from_numpy(ids), torch.from_numpy(mask), max_len, last_only=True)
    np.testing.assert_allclose(np_of(tlogits), np_of(jlogits), atol=LOGIT_ATOL, rtol=0)
    last = np.asarray(LENGTHS) - 1
    np.testing.assert_allclose(np_of(tlast)[:, 0], np_of(jlogits)[np.arange(len(LENGTHS)), last], atol=LOGIT_ATOL, rtol=0)

    def same_cache(tc, jc):
        np.testing.assert_array_equal(np_of(tc["pos"]), np_of(jc["pos"]))
        np.testing.assert_array_equal(np_of(tc["kv_mask"]), np_of(jc["kv_mask"]))
        for i in range(SIZES["num_layers"]):
            for kv in ("k", "v"):
                np.testing.assert_allclose(np_of(tc[f"layer_{i}"][kv]), np_of(jc[f"layer_{i}"][kv]),
                                           atol=CACHE_ATOL, rtol=0, err_msg=f"layer_{i}.{kv}")

    same_cache(tcache, jcache)
    assert tcache["pos"].dtype == torch.int32 and tcache["kv_mask"].dtype == torch.int32
    rng = np.random.default_rng(5)
    for _ in range(T):
        tok = rng.integers(0, SIZES["vocab_size"], size=len(LENGTHS)).astype(np.int32)
        jl, jcache = jmodel.apply(params, jnp.asarray(tok), jcache, method=JaxLM.decode_step)
        with torch.no_grad():
            tl, tcache = tmodel.decode_step(torch.from_numpy(tok), tcache)
        np.testing.assert_allclose(np_of(tl), np_of(jl), atol=LOGIT_ATOL, rtol=0)
        same_cache(tcache, jcache)


@pytest.mark.parametrize("eos", [None, "early"], ids=["no-eos", "eos-pad"])
def test_lm_generate_greedy_matches_jax(eos) -> None:
    """Greedy tokens for right-padded prompts; with `eos_id` set to a token
    that row 0 emits at step 2, finished rows emit `pad_id` after it."""
    jmodel, params, tmodel, ids, mask = _pair(seed=1)
    free = np.asarray(jax_lm_generate(jmodel, params, jnp.asarray(ids), jnp.asarray(mask), max_new_tokens=T))
    kw = dict(max_new_tokens=T)
    if eos:
        kw.update(eos_id=int(free[0, 2]), pad_id=5)
    want = np.asarray(jax_lm_generate(jmodel, params, jnp.asarray(ids), jnp.asarray(mask), **kw))
    got = lm_generate(tmodel, torch.from_numpy(ids), torch.from_numpy(mask), **kw)
    assert got.dtype == torch.int32 and tuple(got.shape) == (len(LENGTHS), T)
    scores = jax_step_logits(jmodel, params, ids, mask, want)
    assert assert_tokens_margin(got, want, scores) == len(LENGTHS) * T
    if eos:
        assert (want[0, 3:] == 5).all()  # row 0 finished at step 2


def test_lm_generate_without_mask_takes_every_token() -> None:
    jmodel, params, tmodel, ids, _ = _pair(seed=2)
    want = np.asarray(jax_lm_generate(jmodel, params, jnp.asarray(ids), max_new_tokens=T))
    got = lm_generate(tmodel, torch.from_numpy(ids), max_new_tokens=T)
    scores = jax_step_logits(jmodel, params, ids, np.ones_like(ids), want)
    assert assert_tokens_margin(got, want, scores) == len(LENGTHS) * T


@pytest.mark.parametrize("top_k, top_p", [(None, None), (10, None), (None, 0.8), (20, 0.9)])
def test_sampled_decoding_with_shared_noise_matches_jax(top_k, top_p) -> None:
    """`jax.random.categorical` is argmax(logits + Gumbel): the port gets the
    Gumbel draws JAX makes from each step's key as `noise`."""
    jmodel, params, tmodel, ids, mask = _pair(seed=3)
    key, temperature = jax.random.PRNGKey(11), 0.7
    kw = dict(max_new_tokens=T, temperature=temperature, top_k=top_k, top_p=top_p, eos_id=3, pad_id=0)
    want = np.asarray(jax_lm_generate(jmodel, params, jnp.asarray(ids), jnp.asarray(mask), rng=key, **kw))
    noise = np.stack([np.asarray(jax.random.gumbel(k, (len(LENGTHS), SIZES["vocab_size"]), jnp.float32))
                      for k in jax.random.split(key, T)])
    got = lm_generate(tmodel, torch.from_numpy(ids), torch.from_numpy(mask), noise=torch.from_numpy(noise), **kw)
    logits = jax_step_logits(jmodel, params, ids, mask, want)
    scores = np.asarray(jax_filter_logits(jnp.asarray(logits) / temperature, top_k, top_p)) + noise.transpose(1, 0, 2)
    assert assert_tokens_margin(got, want, np.where(np.isfinite(scores), scores, -1e30)) > 0


def test_top_k_one_sampling_is_greedy() -> None:
    _, _, tmodel, ids, mask = _pair(seed=4)
    greedy = lm_generate(tmodel, torch.from_numpy(ids), torch.from_numpy(mask), max_new_tokens=T)
    for temperature in (0.5, 3.0):
        sampled = lm_generate(tmodel, torch.from_numpy(ids), torch.from_numpy(mask), max_new_tokens=T,
                              temperature=temperature, top_k=1, generator=torch.Generator().manual_seed(0))
        assert torch.equal(sampled, greedy)


def test_sampling_draws_from_the_generator() -> None:
    _, _, tmodel, ids, mask = _pair(seed=4)
    run = lambda seed: lm_generate(tmodel, torch.from_numpy(ids), torch.from_numpy(mask), max_new_tokens=T,
                                   temperature=2.0, generator=torch.Generator().manual_seed(seed))
    assert torch.equal(run(1), run(1))
    assert not torch.equal(run(1), run(2))


@pytest.mark.parametrize("top_k, top_p", [(5, None), (None, 0.7), (3, 0.5), (None, 0.999), (1, None), (50, None)])
def test_filter_logits_matches_jax(top_k, top_p) -> None:
    logits = np.random.default_rng(7).normal(size=(6, 50)).astype(np.float32) * 2
    want = np.asarray(jax_filter_logits(jnp.asarray(logits), top_k, top_p))
    got = np_of(filter_logits(torch.from_numpy(logits), top_k, top_p))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_array_equal(got[np.isfinite(got)], want[np.isfinite(want)])


def test_filter_logits_keeps_ties_like_jax() -> None:
    """Equal logits at the k-th place are all kept by top-k; equal logits at
    the nucleus' edge are kept or cut together."""
    logits = np.array([[3.0, 1.0, 1.0, 1.0, 0.5, -2.0, 1.0, 3.0],
                       [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0]], np.float32)
    for top_k, top_p in ((3, None), (2, None), (None, 0.6), (None, 0.3), (4, 0.9)):
        want = np.asarray(jax_filter_logits(jnp.asarray(logits), top_k, top_p))
        got = np_of(filter_logits(torch.from_numpy(logits), top_k, top_p))
        np.testing.assert_array_equal(got, want, err_msg=f"top_k={top_k} top_p={top_p}")


def test_realm_generate_matches_jax_mode_generate() -> None:
    """`Realm.forward(batch, mode="generate")` against the flax
    `model.apply(..., mode="generate")`: [B*D, T] tokens, no EOS handling."""
    from tests.test_torch_train import _init, _to_torch_batch, _torch_side

    a, jmodel, _, _, jbatch, params = _init()
    tmodel, _, _ = _torch_side(a, params)
    want = np.asarray(jmodel.apply(params, jbatch, mode="generate", max_new_tokens=T))
    got = tmodel(_to_torch_batch(jbatch), mode="generate", max_new_tokens=T)
    ids = np.asarray(jbatch.lm__input_ids).reshape(-1, jbatch.lm__input_ids.shape[-1])
    mask = np.asarray(jbatch.lm__attention_mask).reshape(ids.shape)
    assert tuple(got.shape) == want.shape == (ids.shape[0], T)
    lm = JaxLM(jmodel.lm_cfg)
    scores = jax_step_logits(lm, {"params": params["params"]["lm"]}, ids, mask, want)
    assert assert_tokens_margin(got, want, scores) == ids.shape[0] * T


def test_generation_entry_points_default_to_the_card() -> None:
    from vod_tpu_torch.models import Seq2SeqLM, Seq2SeqRealm, T5Encoder, VodT5Encoder

    for fn in (CausalLM, T5Encoder, VodT5Encoder, Seq2SeqLM, Seq2SeqRealm):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
