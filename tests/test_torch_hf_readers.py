"""The port's HF reader legs against random-init `transformers` models built
offline: `port_gpt2_weights` (logits and greedy tokens against
`GPT2LMHeadModel` and its `generate`), `load_hf_causal_lm` on a checkpoint
saved to a temporary directory, and `port_t5_seq2seq_weights` (teacher-forced
logits and greedy tokens against `T5ForConditionalGeneration`, whose head is
tied and scaled by d_model**-0.5).

f32 on both sides: logits within atol 1e-4 (the two sum in other orders;
5e-7 seen). Tokens follow the margin rule of `tests/test_torch_decode.py`
over HF's own per-step scores.
"""

import numpy as np
import pytest
import torch

from tests.test_torch_decode import assert_tokens_margin
from tests.torch_helpers import CPU, np_of
from vod_tpu_torch.models import (
    CausalLM,
    Seq2SeqLM,
    generate,
    gpt2_config_from_hf,
    lm_generate,
    load_hf_causal_lm,
    port_gpt2_weights,
    port_t5_seq2seq_weights,
    t5_config_from_hf,
)

transformers = pytest.importorskip("transformers")

ATOL = 1e-4


def _gpt2(vocab: int = 97, h: int = 32, layers: int = 2, heads: int = 4, positions: int = 64):
    torch.manual_seed(0)
    cfg = transformers.GPT2Config(vocab_size=vocab, n_embd=h, n_layer=layers, n_head=heads, n_positions=positions,
                                  resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0)
    return transformers.GPT2LMHeadModel(cfg).eval()


def _ported_gpt2(hf) -> CausalLM:
    cfg = gpt2_config_from_hf(hf.config)
    model = CausalLM(cfg, device=CPU)
    model.load_state_dict(port_gpt2_weights(hf.state_dict(), cfg))
    return model


def test_gpt2_port_logits_match_hf() -> None:
    hf = _gpt2()
    model = _ported_gpt2(hf)
    assert model.cfg.tie_word_embeddings and model.lm_head is None
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(1, 97, size=(3, 12)))
    mask = torch.ones_like(ids)
    mask[1, 8:] = 0
    with torch.no_grad():
        ref = hf(input_ids=ids, attention_mask=mask).logits
        got = model(ids.to(torch.int32), mask.to(torch.int32))
    valid = mask.bool()
    np.testing.assert_allclose(np_of(got[valid]), np_of(ref[valid]), atol=ATOL, rtol=0)


def test_gpt2_port_takes_linear_layout_and_prefixed_keys() -> None:
    """A fork that stores [out, in] `nn.Linear` weights, and keys with and
    without the `transformer.` prefix, port to the same state dict. The
    layout is told by shape, so a square weight (`attn.c_proj`, [H, H]) is
    always read as `Conv1D`, in JAX as here: the fork keeps it as GPT-2 does."""
    hf = _gpt2()
    cfg = gpt2_config_from_hf(hf.config)
    sd = hf.state_dict()
    base = port_gpt2_weights(sd, cfg)
    bare = {k[len("transformer."):]: v for k, v in sd.items() if k.startswith("transformer.")}
    linear = {k: (v.T if k.endswith(("c_attn.weight", "mlp.c_proj.weight", "c_fc.weight")) else v)
              for k, v in bare.items()}
    for other in (port_gpt2_weights(bare, cfg), port_gpt2_weights(linear, cfg)):
        assert set(other) == set(base) and all(torch.equal(other[k], base[k]) for k in base)
    with pytest.raises(ValueError, match="expected"):
        port_gpt2_weights({**bare, "h.0.mlp.c_fc.weight": torch.zeros(3, 5)}, cfg)


def test_gpt2_greedy_generation_matches_hf_generate() -> None:
    hf = _gpt2()
    model = _ported_gpt2(hf)
    ids = torch.from_numpy(np.random.default_rng(1).integers(1, 97, size=(3, 9)))
    t = 8
    with torch.no_grad():
        out = hf.generate(ids, attention_mask=torch.ones_like(ids), max_new_tokens=t, do_sample=False,
                          pad_token_id=0, output_scores=True, return_dict_in_generate=True)
    want = out.sequences[:, ids.shape[1]:]
    scores = np.stack([np_of(s) for s in out.scores], axis=1)
    got = lm_generate(model, ids.to(torch.int32), max_new_tokens=t)
    assert assert_tokens_margin(got, want, scores) == 3 * t


def test_load_hf_causal_lm_from_a_saved_checkpoint(tmp_path) -> None:
    hf = _gpt2()
    hf.save_pretrained(tmp_path)
    cfg, sd = load_hf_causal_lm(str(tmp_path))
    assert cfg == gpt2_config_from_hf(hf.config)
    model = CausalLM(cfg, device=CPU)
    model.load_state_dict(sd)
    ids = torch.from_numpy(np.random.default_rng(2).integers(1, 97, size=(2, 10)))
    with torch.no_grad():
        np.testing.assert_allclose(np_of(model(ids.to(torch.int32), torch.ones_like(ids, dtype=torch.int32))),
                                   np_of(hf(input_ids=ids).logits), atol=ATOL, rtol=0)
    opt = transformers.OPTConfig(vocab_size=16, hidden_size=8, num_hidden_layers=1, ffn_dim=16, num_attention_heads=2,
                                 max_position_embeddings=16, word_embed_proj_dim=8)
    transformers.OPTForCausalLM(opt).save_pretrained(tmp_path / "opt")
    with pytest.raises(ValueError, match="gpt2 layout; got 'opt'"):  # a causal LM of another layout
        load_hf_causal_lm(str(tmp_path / "opt"))


def _t5():
    torch.manual_seed(0)
    cfg = transformers.T5Config(vocab_size=64, d_model=32, d_kv=8, d_ff=64, num_layers=2, num_heads=4,
                                relative_attention_num_buckets=8, relative_attention_max_distance=32,
                                dropout_rate=0.0, feed_forward_proj="relu", decoder_start_token_id=0)
    return transformers.T5ForConditionalGeneration(cfg).eval()


def _ported_t5(hf) -> Seq2SeqLM:
    cfg = t5_config_from_hf(hf.config)
    model = Seq2SeqLM(cfg, device=CPU)
    model.load_state_dict(port_t5_seq2seq_weights(hf.state_dict(), cfg))
    return model


def _t5_inputs(seed: int = 3):
    rng = np.random.default_rng(seed)
    enc_ids = torch.from_numpy(rng.integers(2, 64, size=(2, 12)))
    enc_mask = torch.ones_like(enc_ids)
    enc_mask[1, 9:] = 0
    return enc_ids, enc_mask


def test_t5_seq2seq_port_logits_match_hf() -> None:
    """Teacher-forced logits: the tied head's d_model**-0.5 folded into the
    port's untied head, and the decoder's causal bucketing (decoder inputs of
    40 reach the log-spaced buckets)."""
    hf = _t5()
    model = _ported_t5(hf)
    enc_ids, enc_mask = _t5_inputs()
    rng = np.random.default_rng(4)
    dec = torch.from_numpy(np.concatenate([np.zeros((2, 1), np.int64), rng.integers(2, 64, size=(2, 39))], axis=1))
    dec_mask = torch.ones_like(dec)
    with torch.no_grad():
        ref = hf(input_ids=enc_ids, attention_mask=enc_mask, decoder_input_ids=dec,
                 decoder_attention_mask=dec_mask).logits
        got = model(enc_ids.to(torch.int32), enc_mask.to(torch.int32), dec.to(torch.int32), dec_mask.to(torch.int32))
    np.testing.assert_allclose(np_of(got), np_of(ref), atol=ATOL, rtol=0)


def test_t5_seq2seq_greedy_generation_matches_hf_generate() -> None:
    hf = _t5()
    model = _ported_t5(hf)
    enc_ids, enc_mask = _t5_inputs(5)
    t = 8
    with torch.no_grad():
        out = hf.generate(input_ids=enc_ids, attention_mask=enc_mask, max_new_tokens=t, do_sample=False,
                          num_beams=1, output_scores=True, return_dict_in_generate=True)
    want = out.sequences[:, 1:]  # HF starts from the decoder start token (0) and may stop early at EOS (1)
    scores = np.stack([np_of(s) for s in out.scores], axis=1)
    got = generate(model, enc_ids.to(torch.int32), enc_mask.to(torch.int32), max_new_tokens=t, eos_id=1, bos_id=0)
    n = want.shape[1]
    assert assert_tokens_margin(got[:, :n], want, scores) == 2 * n
    assert (got[:, n:] == 0).all()  # after every row's EOS, both emit the pad id 0
