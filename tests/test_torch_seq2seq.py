"""The port's seq2seq reader against the JAX package: `compact_answer_segment`,
`Seq2SeqLM` logits, `generate` (greedy with EOS, sampled with shared Gumbel
noise), `beam_generate` (tokens and scores, and a case built with tied
continuations), `realm_generate`, `realm_beam_generate`, and the loss and
gradients of `Seq2SeqRealm.evaluate`.

Reader: T5 layout, 2 layers, hidden 64, 4 heads of 16, vocab 101; the REALM
system at `tests/test_torch_train.py`'s shapes (retriever hidden 64, vocab
512), with a reader of vocab 512. Weights carried over from flax by
`models/convert.py`.

Tolerances, f32 on both sides (sums in other orders): logits (magnitude
~4) within atol 1e-4 (5e-6 seen); beam scores (mean log-probs ~-4.6)
within 1e-4; loss and retriever scores within 1e-5, gradients within 1e-5
plus 1e-4 of their size. bf16 logits: atol 0.1, as
`tests/test_torch_lm.py` holds the causal reader's (the hidden states
differ by a few bf16 ulps, carried through the f32 head; 0.05 seen). Tokens follow the margin rule
of `tests/test_torch_decode.py`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_decode import assert_tokens_margin
from tests.test_torch_train import ATOL, B, ENC, GRAD_RTOL, POOLER, _arrays, _jax_batch, _jax_queries, _to_torch_batch
from tests.torch_helpers import CPU, np_of
from vod_tpu.models import TransformerEncoderConfig as JaxEncConfig
from vod_tpu.models import VodGradients as JaxVodGradients
from vod_tpu.models import VodPoolerConfig as JaxPoolerConfig
from vod_tpu.models.seq2seq import Seq2SeqLM as JaxSeq2SeqLM
from vod_tpu.models.seq2seq import Seq2SeqRealm as JaxSeq2SeqRealm
from vod_tpu.models.seq2seq import beam_generate as jax_beam_generate
from vod_tpu.models.seq2seq import compact_answer_segment as jax_compact
from vod_tpu.models.seq2seq import filter_logits as jax_filter_logits
from vod_tpu.models.seq2seq import generate as jax_generate
from vod_tpu.models.seq2seq import realm_beam_generate as jax_realm_beam_generate
from vod_tpu.models.seq2seq import realm_generate as jax_realm_generate
from vod_tpu.models.t5_encoder import T5EncoderConfig as JaxT5Config
from vod_tpu.runtime import DeviceCorpus as JaxCorpus
from vod_tpu.search import HybridEngines as JaxEngines
from vod_tpu.search import build_dense_index as jax_build
from vod_tpu_torch.models import (
    Seq2SeqLM,
    Seq2SeqRealm,
    T5EncoderConfig,
    TransformerEncoderConfig,
    VodGradients,
    VodPoolerConfig,
    beam_generate,
    compact_answer_segment,
    generate,
    realm_beam_generate,
    realm_generate,
    seq2seq_flax_to_state_dict,
    system_flax_to_state_dict,
)

SIZES = dict(vocab_size=101, hidden_size=64, num_layers=2, num_heads=4, head_dim=16, intermediate_size=96)
READER = dict(SIZES, vocab_size=ENC["vocab_size"])
LOGIT_ATOL = 1e-4
BF16_ATOL = 0.1
T = 6


def _enc_inputs(seed: int = 0, b: int = 4, length: int = 30):
    rng = np.random.default_rng(seed)
    ids = rng.integers(2, SIZES["vocab_size"], size=(b, length)).astype(np.int32)
    mask = (np.arange(length)[None] < np.array([30, 21, 5, 14][:b])[:, None]).astype(np.int32)
    return ids * mask, mask


def _reader_pair(seed: int = 0, jdtype=jnp.float32, tdtype=torch.float32):
    ids, mask = _enc_inputs(seed)
    jmodel = JaxSeq2SeqLM(JaxT5Config(dtype=jdtype, **SIZES))
    dec = np.zeros((ids.shape[0], 3), np.int32)
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(seed), jnp.asarray(ids), jnp.asarray(mask),
                                        jnp.asarray(dec), jnp.ones_like(jnp.asarray(dec))))
    tmodel = Seq2SeqLM(T5EncoderConfig(dtype=tdtype, **SIZES), device=CPU)
    tmodel.load_state_dict(seq2seq_flax_to_state_dict(params))
    return jmodel, params, tmodel, ids, mask


def jax_s2s_step_logits(jmodel, params, enc_ids, enc_mask, toks, bos_id: int = 0) -> np.ndarray:
    """The reference's logits before each generated token [B, T, V]: step t
    reads token t-1 (BOS first)."""
    enc_ids, enc_mask = jnp.asarray(enc_ids), jnp.asarray(enc_mask)
    toks = np.asarray(toks)
    mem = jmodel.apply(params, enc_ids, enc_mask, method=JaxSeq2SeqLM.encode)
    cache = jmodel.apply(params, mem, toks.shape[1], method=JaxSeq2SeqLM.init_cache)
    step = jax.jit(lambda p, t, pos, c: jmodel.apply(p, t, pos, enc_mask, c, method=JaxSeq2SeqLM.decode_step))
    prev = np.full((toks.shape[0],), bos_id, np.int32)
    out = []
    for t in range(toks.shape[1]):
        logits, cache = step(params, jnp.asarray(prev), jnp.asarray(t, jnp.int32), cache)
        out.append(np.asarray(logits))
        prev = toks[:, t].astype(np.int32)
    return np.stack(out, axis=1)


def test_compact_answer_segment_matches_jax() -> None:
    rng = np.random.default_rng(0)
    ids = rng.integers(1, 50, size=(3, 4, 20)).astype(np.int32)
    tt = rng.integers(0, 3, size=(3, 4, 20)).astype(np.int32)
    mask = (rng.random((3, 4, 20)) < 0.8).astype(np.int32)
    for max_len in (20, 7, 1):
        want = jax_compact(jnp.asarray(ids), jnp.asarray(tt), jnp.asarray(mask), max_len)
        got = compact_answer_segment(torch.from_numpy(ids), torch.from_numpy(tt), torch.from_numpy(mask), max_len)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np_of(g), np_of(w))


@pytest.mark.parametrize("jdtype, tdtype, atol", [(jnp.float32, torch.float32, LOGIT_ATOL),
                                                  (jnp.bfloat16, torch.bfloat16, BF16_ATOL)], ids=["f32", "bf16"])
def test_seq2seq_lm_logits_match_jax(jdtype, tdtype, atol: float) -> None:
    """Teacher-forced decoder logits, with a right-padded decoder side of 20
    (past the causal bucketing's 16 exact positions)."""
    jmodel, params, tmodel, ids, mask = _reader_pair(jdtype=jdtype, tdtype=tdtype)
    rng = np.random.default_rng(1)
    dec = rng.integers(0, SIZES["vocab_size"], size=(4, 20)).astype(np.int32)
    dmask = (np.arange(20)[None] < np.array([20, 11, 1, 17])[:, None]).astype(np.int32)
    want = np.asarray(jmodel.apply(params, *(jnp.asarray(x) for x in (ids, mask, dec, dmask))))
    with torch.no_grad():
        got = tmodel(*(torch.from_numpy(x) for x in (ids, mask, dec, dmask)))
    assert got.dtype == torch.float32 and tuple(got.shape) == (4, 20, SIZES["vocab_size"])
    np.testing.assert_allclose(np_of(got), want, atol=atol, rtol=0)


def test_decode_steps_match_teacher_forced_logits_and_jax() -> None:
    """Each cached decode step's logits equal JAX's and the port's own
    teacher-forced forward over the same tokens."""
    jmodel, params, tmodel, ids, mask = _reader_pair(seed=1)
    toks = np.random.default_rng(2).integers(0, SIZES["vocab_size"], size=(4, 20)).astype(np.int32)
    want = jax_s2s_step_logits(jmodel, params, ids, mask, toks)
    with torch.no_grad():
        mem = tmodel.encode(torch.from_numpy(ids), torch.from_numpy(mask))
        cache = tmodel.init_cache(mem, 20)
        prev = torch.zeros(4, dtype=torch.int32)
        steps = []
        for t in range(20):
            logits, cache = tmodel.decode_step(prev, t, torch.from_numpy(mask), cache)
            steps.append(logits)
            prev = torch.from_numpy(toks[:, t])
        dec_in = np.concatenate([np.zeros((4, 1), np.int32), toks[:, :-1]], axis=1)
        forced = tmodel(torch.from_numpy(ids), torch.from_numpy(mask), torch.from_numpy(dec_in),
                        torch.ones((4, 20), dtype=torch.int32))
    got = np_of(torch.stack(steps, dim=1))
    np.testing.assert_allclose(got, want, atol=LOGIT_ATOL, rtol=0)
    np.testing.assert_allclose(got, np_of(forced), atol=LOGIT_ATOL, rtol=0)


def test_generate_greedy_matches_jax() -> None:
    jmodel, params, tmodel, ids, mask = _reader_pair(seed=2)
    free = np.asarray(jax_generate(jmodel, params, jnp.asarray(ids), jnp.asarray(mask), max_new_tokens=T))
    eos = int(free[1, 1])  # row 1 finishes at step 1; finished rows emit BOS
    want = np.asarray(jax_generate(jmodel, params, jnp.asarray(ids), jnp.asarray(mask), max_new_tokens=T, eos_id=eos))
    got = generate(tmodel, torch.from_numpy(ids), torch.from_numpy(mask), max_new_tokens=T, eos_id=eos)
    assert got.dtype == torch.int32
    scores = jax_s2s_step_logits(jmodel, params, ids, mask, want)
    assert assert_tokens_margin(got, want, scores) == 4 * T
    assert (want[1, 2:] == 0).all()


@pytest.mark.parametrize("top_k, top_p", [(None, None), (8, 0.9)])
def test_generate_sampled_with_shared_noise_matches_jax(top_k, top_p) -> None:
    jmodel, params, tmodel, ids, mask = _reader_pair(seed=3)
    key, temperature = jax.random.PRNGKey(4), 0.8
    kw = dict(max_new_tokens=T, temperature=temperature, top_k=top_k, top_p=top_p)
    want = np.asarray(jax_generate(jmodel, params, jnp.asarray(ids), jnp.asarray(mask), rng=key, **kw))
    noise = np.stack([np.asarray(jax.random.gumbel(k, (4, SIZES["vocab_size"]), jnp.float32))
                      for k in jax.random.split(key, T)])
    got = generate(tmodel, torch.from_numpy(ids), torch.from_numpy(mask), noise=torch.from_numpy(noise), **kw)
    logits = jax_s2s_step_logits(jmodel, params, ids, mask, want)
    scores = np.asarray(jax_filter_logits(jnp.asarray(logits) / temperature, top_k, top_p)) + noise.transpose(1, 0, 2)
    assert assert_tokens_margin(got, want, np.where(np.isfinite(scores), scores, -1e30)) > 0


def _beam_check(jmodel, params, tmodel, ids, mask, **kw) -> tuple[np.ndarray, np.ndarray]:
    wt, ws = jax_beam_generate(jmodel, params, jnp.asarray(ids), jnp.asarray(mask), **kw)
    gt, gs = beam_generate(tmodel, torch.from_numpy(ids), torch.from_numpy(mask), **kw)
    assert gt.dtype == torch.int32 and gs.dtype == torch.float32
    np.testing.assert_array_equal(np_of(gt), np.asarray(wt))
    np.testing.assert_allclose(np_of(gs), np.asarray(ws), atol=LOGIT_ATOL, rtol=0)
    return np_of(gt), np_of(gs)


@pytest.mark.parametrize("num_beams, length_penalty", [(4, 1.0), (3, 0.6), (1, 1.0)])
def test_beam_generate_matches_jax(num_beams: int, length_penalty: float) -> None:
    jmodel, params, tmodel, ids, mask = _reader_pair(seed=5)
    toks, scores = _beam_check(jmodel, params, tmodel, ids, mask, num_beams=num_beams, max_new_tokens=T,
                               length_penalty=length_penalty)
    # the winner's score is its length-penalised log-prob, recomputed teacher-forced (no EOS emitted here)
    assert not (toks == 1).any()
    dec_in = np.concatenate([np.zeros((4, 1), np.int32), toks[:, :-1]], axis=1)
    with torch.no_grad():
        logp = torch.log_softmax(tmodel(torch.from_numpy(ids), torch.from_numpy(mask), torch.from_numpy(dec_in),
                                        torch.ones((4, T), dtype=torch.int32)), dim=-1)
    total = torch.gather(logp, -1, torch.from_numpy(toks).long()[..., None])[..., 0].sum(-1)
    np.testing.assert_allclose(np_of(total) / T**length_penalty, scores, atol=LOGIT_ATOL, rtol=0)


def test_beam_generate_with_eos_matches_jax() -> None:
    """An EOS that the beams reach: finished beams emit BOS at zero cost and
    keep competing with their final length-penalised score."""
    jmodel, params, tmodel, ids, mask = _reader_pair(seed=6)
    first, _ = jax_beam_generate(jmodel, params, jnp.asarray(ids), jnp.asarray(mask), num_beams=4, max_new_tokens=T)
    eos = int(np.asarray(first)[0, 2])
    toks, _ = _beam_check(jmodel, params, tmodel, ids, mask, num_beams=4, max_new_tokens=T, eos_id=eos)
    assert (toks == eos).any()


def test_beam_generate_breaks_ties_like_lax_top_k() -> None:
    """Tied continuations: tokens a and b get equal head columns and equal
    decoder embeddings, so the beams extending them score exactly alike on
    both sides, step after step; the pruning keeps the lowest flat index
    (lowest beam, then lowest token) first, as `lax.top_k` does."""
    jmodel, params, tmodel, ids, mask = _reader_pair(seed=7)
    greedy = np.asarray(jax_generate(jmodel, params, jnp.asarray(ids), jnp.asarray(mask), max_new_tokens=1))
    a = int(greedy[0, 0])
    b = (a + 37) % SIZES["vocab_size"]
    p = params["params"]
    p["lm_head"]["kernel"] = np.array(p["lm_head"]["kernel"])
    p["lm_head"]["kernel"][:, b] = p["lm_head"]["kernel"][:, a]
    p["dec_embed"]["embedding"] = np.array(p["dec_embed"]["embedding"])
    p["dec_embed"]["embedding"][b] = p["dec_embed"]["embedding"][a]
    tmodel.load_state_dict(seq2seq_flax_to_state_dict(params))
    for num_beams in (2, 4):
        _beam_check(jmodel, params, tmodel, ids, mask, num_beams=num_beams, max_new_tokens=T, eos_id=-1)
    # one step: beams a and b tie exactly, and the winner is the lower token
    toks, _ = _beam_check(jmodel, params, tmodel, ids, mask, num_beams=2, max_new_tokens=1, eos_id=-1)
    assert toks[0, 0] == min(a, b)


# ---- the REALM system --------------------------------------------------------


def _realm_init(seed: int = 0):
    """A flax `Seq2SeqRealm` at `tests/test_torch_train.py`'s shapes, its
    collated batch (with reader inputs) and params, and the port's copy."""
    a = _arrays(seed)
    jcfg = JaxEncConfig(dtype=jnp.float32, pooler=JaxPoolerConfig(**POOLER), **ENC)
    jmodel = JaxSeq2SeqRealm(cfg=jcfg, reader_cfg=JaxT5Config(dtype=jnp.float32, **READER),
                             gradients=JaxVodGradients(alpha=0.5))
    n, ls = a["corpus_ids"].shape
    corpus = JaxCorpus(input_ids=jnp.asarray(a["corpus_ids"]), attention_mask=jnp.ones((n, ls), jnp.int32))
    engines = JaxEngines(dense=jax_build(jnp.asarray(a["emb"]), dtype="float32"))
    key = jax.random.PRNGKey(seed)
    batch = _jax_batch(jmodel, engines, corpus, _jax_queries(a), key)
    params = jax.device_get(jmodel.init(key, batch, mode="evaluate"))
    tmodel = torch_realm(params)
    return a, jmodel, corpus, engines, batch, params, tmodel


def torch_realm(params) -> Seq2SeqRealm:
    tcfg = TransformerEncoderConfig(dtype=torch.float32, pooler=VodPoolerConfig(**POOLER), **ENC)
    model = Seq2SeqRealm(tcfg, T5EncoderConfig(dtype=torch.float32, **READER), VodGradients(alpha=0.5), device=CPU)
    model.load_state_dict(system_flax_to_state_dict(params))
    return model


def test_seq2seq_realm_evaluate_matches_jax() -> None:
    """Loss, retriever scores and the gradient of every parameter."""
    _, jmodel, _, _, jbatch, params, tmodel = _realm_init()

    def loss_fn(p):
        out = jmodel.apply(p, jbatch, mode="evaluate")
        return out.loss, out.retriever_scores

    (jloss, jscores), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    out = tmodel(_to_torch_batch(jbatch), mode="evaluate")
    out.loss.backward()
    np.testing.assert_allclose(np_of(out.loss), np_of(jloss), atol=ATOL, rtol=0)
    np.testing.assert_allclose(np_of(out.retriever_scores), np_of(jscores), atol=ATOL, rtol=0)
    want = system_flax_to_state_dict(jax.device_get(jgrads))
    named = dict(tmodel.named_parameters())
    assert set(want) == set(named)
    for name, g in want.items():
        assert named[name].grad is not None, name
        np.testing.assert_allclose(np_of(named[name].grad), np_of(g), atol=ATOL, rtol=GRAD_RTOL, err_msg=name)
    with pytest.raises(ValueError, match="Unknown mode"):
        tmodel(_to_torch_batch(jbatch), mode="generate")  # generation goes through realm_generate


def test_realm_generate_and_beam_match_jax() -> None:
    _, jmodel, _, _, jbatch, params, tmodel = _realm_init(seed=1)
    tbatch = _to_torch_batch(jbatch)
    want = np.asarray(jax_realm_generate(jmodel, params, jbatch, max_new_tokens=T))
    got = realm_generate(tmodel, tbatch, max_new_tokens=T)
    b, d, length = jbatch.lm__input_ids.shape
    assert tuple(got.shape) == want.shape == (b * d, T)
    tt, m = np.asarray(jbatch.lm__token_type_ids), np.asarray(jbatch.lm__attention_mask)
    enc_mask = ((tt < 2) & (m > 0)).astype(np.int32).reshape(b * d, length)
    enc_ids = np.asarray(jbatch.lm__input_ids).reshape(b * d, length) * enc_mask
    reader = JaxSeq2SeqLM(jmodel.reader_cfg)
    rparams = {"params": params["params"]["reader"]}
    scores = jax_s2s_step_logits(reader, rparams, enc_ids, enc_mask, want)
    assert assert_tokens_margin(got, want, scores) == b * d * T

    wt, ws = jax_realm_beam_generate(jmodel, params, jbatch, num_beams=3, max_new_tokens=4)
    gt, gs = realm_beam_generate(tmodel, tbatch, num_beams=3, max_new_tokens=4)
    np.testing.assert_array_equal(np_of(gt), np.asarray(wt))
    np.testing.assert_allclose(np_of(gs), np.asarray(ws), atol=LOGIT_ATOL, rtol=0)
    assert tuple(gs.shape) == (B * d,)
