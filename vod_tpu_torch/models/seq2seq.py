"""T5-style seq2seq reader: an encoder-decoder LM for REALM systems (port of
`vod_tpu/models/seq2seq.py`).

The decoder follows the T5 layout (RMSNorm pre-LN, a relative-position
self-attention bias on block 0, cross-attention, bias-free dense layers, a
relu FFN) on top of `t5_encoder.T5Encoder`, with an untied f32 `lm_head`.
`port_t5_seq2seq_weights` maps a HF `T5ForConditionalGeneration` state dict
onto `Seq2SeqLM.state_dict`.

`Seq2SeqRealm` feeds the collate's [context; question] tokens to the encoder
and the BOS-shifted answer tokens to the decoder, teacher-forced; the
gradient estimators get the BOS-prefixed answer and the decoder logits over
the same positions.

Decoding is KV-cached: the encoder runs once, each block's cross-attention
K/V are computed once in `init_cache`, and each of the `max_new_tokens`
steps is one [B, 1] decoder pass that writes its self-attention K/V into the
cache in place. Where JAX runs the steps under one `lax.scan`, the port runs
a Python loop whose step index is the host's counter (every row decodes the
same position); no step reads a value back from the card, and every step
runs (finished rows keep emitting the pad id, as in JAX).

Sampling: `jax.random.categorical` is the argmax of the logits plus Gumbel
draws. The port takes those draws as `noise` ([T, B, V]); without it, it
draws them from the caller's `torch.Generator`.
"""

from __future__ import annotations

import dataclasses
import typing as typ

import torch
import torch.nn.functional as F
from torch import nn

from vod_tpu_torch.ops.numpy_ops import topk_lowest_first
from vod_tpu_torch.types.batch import RealmBatch, RealmOutput
from .encoder import TransformerEncoderConfig
from .gradients import Gradients
from .systems import _encoder, _fused_encode
from .t5_encoder import (
    T5Encoder,
    T5EncoderConfig,
    _attend,
    _bucket_matrix,
    _heads,
    _f32,
    _linear,
    _log_bucket,
    _materialise_t5,
    _RMSNorm,
    port_t5_encoder_weights,
)


def compact_answer_segment(
    ids: torch.Tensor, tt: torch.Tensor, mask: torch.Tensor, max_len: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Front-compact the answer segment (`token_type_ids == 2`) of lm inputs:
    a stable argsort on (not answer) moves the answer tokens to the front in
    their order. Any leading dims; returns (answer_ids, answer_mask) cut to
    `max_len`."""
    ans_mask = ((tt == 2) & (mask > 0)).to(torch.int32)
    order = torch.argsort(1 - ans_mask, dim=-1, stable=True)
    ans_ids = torch.gather(ids * ans_mask, -1, order)
    ans_m = torch.gather(ans_mask, -1, order)
    return ans_ids[..., :max_len], ans_m[..., :max_len]


def _relative_buckets_causal(rel_pos: torch.Tensor, num_buckets: int, max_distance: int) -> torch.Tensor:
    """T5's unidirectional bucketing (decoder self-attention): all
    `num_buckets` for memory - query <= 0; future positions map to bucket 0
    (they are masked anyway)."""
    n = -torch.clamp(rel_pos, max=0)
    max_exact = num_buckets // 2
    return torch.where(n < max_exact, n, _log_bucket(n, max_exact, num_buckets, max_distance))


def filter_logits(
    logits: torch.Tensor, top_k: typ.Optional[int] = None, top_p: typ.Optional[float] = None
) -> torch.Tensor:
    """Top-k / nucleus (top-p) filtering for sampled decoding; filtered
    logits become -inf. Top-k keeps every logit at least the k-th largest;
    top-p keeps, in descending order, each token while the softmax mass
    before it is below `top_p` (always at least one)."""
    if top_k is not None and 0 < top_k < logits.shape[-1]:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, float("-inf"), logits)
    if top_p is not None and 0.0 < top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        keep = torch.cat([torch.ones_like(cum[..., :1], dtype=torch.bool), cum[..., :-1] < top_p], dim=-1)
        thresh = torch.amin(torch.where(keep, sorted_logits, float("inf")), dim=-1, keepdim=True)
        logits = torch.where(logits < thresh, float("-inf"), logits)
    return logits


def gumbel(shape: typ.Sequence[int], generator: typ.Optional[torch.Generator], device: typ.Any) -> torch.Tensor:
    """Standard Gumbel draws, -log(-log(U)) with U uniform in [tiny, 1)."""
    u = torch.rand(tuple(shape), generator=generator, device=device)
    return -torch.log(-torch.log(torch.clamp(u, min=torch.finfo(torch.float32).tiny)))


def pick_tokens(
    logits: torch.Tensor,
    step: int,
    *,
    temperature: float,
    top_k: typ.Optional[int],
    top_p: typ.Optional[float],
    generator: typ.Optional[torch.Generator],
    noise: typ.Optional[torch.Tensor],
) -> torch.Tensor:
    """The next token of each row: the argmax at temperature 0; otherwise a
    draw from softmax(filter(logits / temperature)) as the argmax of the
    filtered logits plus Gumbel noise (`noise[step]`, else drawn)."""
    if temperature > 0.0:
        filtered = filter_logits(logits / temperature, top_k, top_p)
        g = noise[step] if noise is not None else gumbel(filtered.shape, generator, logits.device)
        return torch.argmax(filtered + g, dim=-1)
    return torch.argmax(logits, dim=-1)


class _T5CrossAttention(nn.Module):
    def __init__(self, cfg: T5EncoderConfig, device: typ.Any = None):
        super().__init__()
        self.cfg = cfg
        inner = cfg.num_heads * cfg.head_dim
        self.q = nn.Linear(cfg.hidden_size, inner, bias=False, device=device)
        self.k = nn.Linear(cfg.hidden_size, inner, bias=False, device=device)
        self.v = nn.Linear(cfg.hidden_size, inner, bias=False, device=device)
        self.o = nn.Linear(inner, cfg.hidden_size, bias=False, device=device)

    def kv(self, mem: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Cross K/V of the encoder memory [B, Lm, Hh, Dh] (once per generation)."""
        return _heads(mem, self.k, self.cfg), _heads(mem, self.v, self.cfg)

    def forward(self, x: torch.Tensor, mem_mask: torch.Tensor, kv: tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
        q = _heads(x, self.q, self.cfg)
        out = _attend(q, kv[0], kv[1], None, mem_mask[:, None, None, :] > 0, self.cfg.dtype)
        return _linear(out, self.o, self.cfg.dtype)


class _T5DecoderBlock(nn.Module):
    def __init__(self, cfg: T5EncoderConfig, has_rel_bias: bool, device: typ.Any = None):
        super().__init__()
        self.cfg = cfg
        inner, h = cfg.num_heads * cfg.head_dim, cfg.hidden_size
        self.ln0 = _RMSNorm(h, cfg.layer_norm_eps, cfg.dtype, device)
        self.ln1 = _RMSNorm(h, cfg.layer_norm_eps, cfg.dtype, device)
        self.ln2 = _RMSNorm(h, cfg.layer_norm_eps, cfg.dtype, device)
        self.self_q = nn.Linear(h, inner, bias=False, device=device)
        self.self_k = nn.Linear(h, inner, bias=False, device=device)
        self.self_v = nn.Linear(h, inner, bias=False, device=device)
        self.self_o = nn.Linear(inner, h, bias=False, device=device)
        self.cross_attention = _T5CrossAttention(cfg, device)
        self.wi = nn.Linear(h, cfg.intermediate_size, bias=False, device=device)
        self.wo = nn.Linear(cfg.intermediate_size, h, bias=False, device=device)
        self.relative_attention_bias = (
            nn.Parameter(torch.empty(cfg.relative_attention_num_buckets, cfg.num_heads, device=device))
            if has_rel_bias else None
        )
        self._buckets: dict = {}

    def _causal_buckets(self, length: int, device: torch.device) -> torch.Tensor:
        cfg = self.cfg
        return _bucket_matrix(self._buckets, _relative_buckets_causal, cfg.relative_attention_num_buckets,
                              cfg.relative_attention_max_distance, length, device)

    def _ffn_and_cross(self, x: torch.Tensor, mem_mask: torch.Tensor, cross_kv: tuple) -> torch.Tensor:
        dt = self.cfg.dtype
        x = x + self.cross_attention(self.ln1(x), mem_mask, cross_kv)
        return x + _linear(F.relu(_linear(self.ln2(x), self.wi, dt)), self.wo, dt)

    def forward(
        self, x: torch.Tensor, self_mask: torch.Tensor, mem_mask: torch.Tensor, cross_kv: tuple,
        rel_bias: typ.Optional[torch.Tensor],
    ) -> tuple[torch.Tensor, typ.Optional[torch.Tensor]]:
        """Teacher-forced full-sequence pass; `self_mask` [B, 1, L, L] includes causality."""
        cfg = self.cfg
        h = self.ln0(x)
        if self.relative_attention_bias is not None:
            buckets = self._causal_buckets(x.shape[-2], x.device)
            rel_bias = self.relative_attention_bias[buckets].permute(2, 0, 1)[None]  # [1, Hh, L, L]
        q, k, v = (_heads(h, p, cfg) for p in (self.self_q, self.self_k, self.self_v))
        x = x + _linear(_attend(q, k, v, rel_bias, self_mask, cfg.dtype), self.self_o, cfg.dtype)
        return self._ffn_and_cross(x, mem_mask, cross_kv), rel_bias

    def step(
        self, x: torch.Tensor, pos: int, mem_mask: torch.Tensor, cross_kv: tuple, cache_k: torch.Tensor,
        cache_v: torch.Tensor, rel_bias: typ.Optional[torch.Tensor],
    ) -> tuple[torch.Tensor, typ.Optional[torch.Tensor]]:
        """One-token decode: x [B, 1, H]; caches [B, Lmax, Hh, Dh], written at
        `pos` in place. Returns (x, rel_bias)."""
        cfg = self.cfg
        l_max = cache_k.shape[1]
        h = self.ln0(x)
        if self.relative_attention_bias is not None:
            buckets = self._causal_buckets(l_max, x.device)[pos]  # [Lmax]: key - pos
            rel_bias = self.relative_attention_bias[buckets].t()[None, :, None, :]  # [1, Hh, 1, Lmax]
        q = _heads(h, self.self_q, cfg)
        cache_k[:, pos] = _heads(h, self.self_k, cfg)[:, 0].to(cache_k.dtype)
        cache_v[:, pos] = _heads(h, self.self_v, cfg)[:, 0].to(cache_v.dtype)
        key_mask = (torch.arange(l_max, device=x.device) <= pos)[None, None, None, :]
        x = x + _linear(_attend(q, cache_k, cache_v, rel_bias, key_mask, cfg.dtype), self.self_o, cfg.dtype)
        return self._ffn_and_cross(x, mem_mask, cross_kv), rel_bias


class Seq2SeqLM(nn.Module):
    """T5-style encoder-decoder: `forward(enc_ids, enc_mask, dec_ids,
    dec_mask)` returns decoder next-token logits [B, Ld, V] in f32.
    Parameters live on `device` (default "cuda"), random-initialised from
    `generator` (default: seed 0 there)."""

    def __init__(
        self,
        cfg: T5EncoderConfig,
        *,
        device: typ.Union[str, torch.device] = "cuda",
        generator: typ.Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.cfg = cfg
        meta = "meta"
        self.encoder = T5Encoder(cfg, device=meta)
        self.dec_embed = nn.Embedding(cfg.vocab_size, cfg.hidden_size, device=meta)
        self.blocks = nn.ModuleList(_T5DecoderBlock(cfg, i == 0, meta) for i in range(cfg.num_layers))
        self.final_norm = _RMSNorm(cfg.hidden_size, cfg.layer_norm_eps, cfg.dtype, meta)
        self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size, bias=False, device=meta)
        if torch.device(device).type != meta:  # a part of a larger module is materialised by it
            _materialise_t5(self, device, generator)

    def encode(self, enc_ids: torch.Tensor, enc_mask: torch.Tensor) -> torch.Tensor:
        return self.encoder(enc_ids, enc_mask)

    def _logits(self, h: torch.Tensor) -> torch.Tensor:
        return F.linear(self.final_norm(h).to(torch.float32), self.lm_head.weight.to(torch.float32))

    def forward(
        self, enc_ids: torch.Tensor, enc_mask: torch.Tensor, dec_ids: torch.Tensor, dec_mask: torch.Tensor
    ) -> torch.Tensor:
        mem = self.encode(enc_ids, enc_mask)
        h = self.dec_embed(dec_ids).to(self.cfg.dtype)
        ld = dec_ids.shape[-1]
        causal = torch.ones((ld, ld), dtype=torch.bool, device=dec_ids.device).tril()
        self_mask = causal[None, None] & (dec_mask[:, None, None, :] > 0)
        rel_bias = None
        for blk in self.blocks:
            h, rel_bias = blk(h, self_mask, enc_mask, blk.cross_attention.kv(mem), rel_bias)
        return self._logits(h)

    # ---- incremental decoding -------------------------------------------

    def init_cache(self, mem: torch.Tensor, max_len: int) -> dict:
        """Per-block self-attention K/V caches (zeros) and the cross K/V of `mem`."""
        cfg = self.cfg
        b = mem.shape[0]
        zeros = lambda: torch.zeros((b, max_len, cfg.num_heads, cfg.head_dim), dtype=cfg.dtype, device=mem.device)
        return {
            f"layer_{i}": {"k": zeros(), "v": zeros(), "cross_kv": blk.cross_attention.kv(mem)}
            for i, blk in enumerate(self.blocks)
        }

    def decode_step(
        self, tok: torch.Tensor, pos: int, mem_mask: torch.Tensor, cache: dict
    ) -> tuple[torch.Tensor, dict]:
        """One decode step: tok [B] at position `pos` (the same for every row)
        -> (logits [B, V] f32, cache). The self-attention caches are written
        in place and returned."""
        h = self.dec_embed(tok[:, None]).to(self.cfg.dtype)
        rel_bias = None
        for i, blk in enumerate(self.blocks):
            c = cache[f"layer_{i}"]
            h, rel_bias = blk.step(h, pos, mem_mask, c["cross_kv"], c["k"], c["v"], rel_bias)
        return self._logits(h)[:, 0, :], cache


@torch.no_grad()
def generate(
    model: Seq2SeqLM,
    enc_ids: torch.Tensor,
    enc_mask: torch.Tensor,
    *,
    max_new_tokens: int = 32,
    bos_id: int = 0,
    eos_id: int = 1,
    temperature: float = 0.0,
    top_k: typ.Optional[int] = None,
    top_p: typ.Optional[float] = None,
    generator: typ.Optional[torch.Generator] = None,
    noise: typ.Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """KV-cached generation, greedy or (temperature > 0) sampled with optional
    top-k / nucleus filtering. Rows that emitted `eos_id` keep emitting
    `bos_id` (T5's pad). Returns new tokens [B, max_new_tokens] (int32)."""
    mem = model.encode(enc_ids, enc_mask)
    cache = model.init_cache(mem, max_new_tokens)
    b = enc_ids.shape[0]
    tok = torch.full((b,), bos_id, dtype=torch.int32, device=enc_ids.device)
    finished = torch.zeros((b,), dtype=torch.bool, device=enc_ids.device)
    toks = []
    for t in range(max_new_tokens):
        logits, cache = model.decode_step(tok, t, enc_mask, cache)
        nxt = pick_tokens(logits, t, temperature=temperature, top_k=top_k, top_p=top_p, generator=generator,
                          noise=noise)
        tok = torch.where(finished, bos_id, nxt).to(torch.int32)
        finished = finished | (tok == eos_id)
        toks.append(tok)
    return torch.stack(toks, dim=1)


@torch.no_grad()
def beam_generate(
    model: Seq2SeqLM,
    enc_ids: torch.Tensor,
    enc_mask: torch.Tensor,
    *,
    num_beams: int = 4,
    max_new_tokens: int = 32,
    bos_id: int = 0,
    eos_id: int = 1,
    length_penalty: float = 1.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """KV-cached beam search. Returns (tokens [B, max_new_tokens] int32,
    scores [B] f32).

    All B * num_beams beams decode as one batched `decode_step`; each step
    prunes the num_beams * V continuations back to num_beams with a top-k
    that takes the lowest index first among equal scores (as `lax.top_k`),
    and re-gathers the caches, tokens, lengths and finished flags along the
    beam axis. Finished beams emit `bos_id` at zero cost and keep competing
    with their final score, sum(logp) / len ** length_penalty."""
    b, k = enc_ids.shape[0], num_beams
    dev = enc_ids.device
    enc_ids_k = torch.repeat_interleave(enc_ids, k, dim=0)
    enc_mask_k = torch.repeat_interleave(enc_mask, k, dim=0)
    mem = model.encode(enc_ids_k, enc_mask_k)
    cache = model.init_cache(mem, max_new_tokens)
    v = model.cfg.vocab_size
    pad_only = torch.full((v,), -1e9, device=dev)
    pad_only[bos_id] = 0.0

    tok = torch.full((b * k,), bos_id, dtype=torch.int32, device=dev)
    # first step: only beam 0 is live (every beam holds the same BOS context)
    logps = torch.full((b, k), -1e9, device=dev)
    logps[:, 0] = 0.0
    lens = torch.zeros((b, k), dtype=torch.int32, device=dev)
    finished = torch.zeros((b, k), dtype=torch.bool, device=dev)
    toks = torch.zeros((b, k, max_new_tokens), dtype=torch.int32, device=dev)
    base = (torch.arange(b, device=dev) * k)[:, None]
    for pos in range(max_new_tokens):
        logits, cache = model.decode_step(tok, pos, enc_mask_k, cache)
        logp = torch.log_softmax(logits.to(torch.float32), dim=-1).reshape(b, k, v)
        logp = torch.where(finished[..., None], pad_only, logp)
        cand = (logps[..., None] + logp).reshape(b, k * v)
        logps, flat_idx = topk_lowest_first(cand, k)
        src_beam = flat_idx // v
        new_tok = (flat_idx % v).to(torch.int32)

        rows = (base + src_beam).reshape(b * k)
        cache = {
            name: {"k": c["k"].index_select(0, rows), "v": c["v"].index_select(0, rows), "cross_kv": c["cross_kv"]}
            for name, c in cache.items()
        }
        toks = torch.gather(toks, 1, src_beam[..., None].expand(-1, -1, max_new_tokens))
        lens = torch.gather(lens, 1, src_beam)
        finished = torch.gather(finished, 1, src_beam)

        toks[:, :, pos] = new_tok
        lens = torch.where(finished, lens, lens + 1)
        finished = finished | (new_tok == eos_id)
        tok = new_tok.reshape(b * k)
    scores = logps / torch.clamp(lens, min=1).to(torch.float32) ** length_penalty
    best = torch.argmax(scores, dim=-1)
    out = torch.gather(toks, 1, best[:, None, None].expand(-1, 1, max_new_tokens))[:, 0]
    return out, torch.gather(scores, 1, best[:, None])[:, 0]


def _reader_inputs(batch: RealmBatch) -> tuple[torch.Tensor, torch.Tensor]:
    """The reader encoder's inputs of a Realm batch, [B*D, L]: the
    [context; question] segments (token_type_ids < 2), other ids zeroed."""
    ids, tt, mask = batch.lm__input_ids, batch.lm__token_type_ids, batch.lm__attention_mask
    b, d, length = ids.shape
    enc_mask = ((tt < 2) & (mask > 0)).to(torch.int32).reshape(b * d, length)
    return ids.reshape(b * d, length) * enc_mask, enc_mask


def realm_generate(model: "Seq2SeqRealm", batch: RealmBatch, **kwargs: typ.Any) -> torch.Tensor:
    """KV-cached answer generation for a Realm batch (`generate` over the
    reader). Returns tokens [B*D, max_new_tokens]."""
    return generate(model.reader, *_reader_inputs(batch), **kwargs)


def realm_beam_generate(
    model: "Seq2SeqRealm", batch: RealmBatch, **kwargs: typ.Any
) -> tuple[torch.Tensor, torch.Tensor]:
    """Beam-search answer generation for a Realm batch (`beam_generate` over
    the reader). Returns (tokens [B*D, T], scores [B*D])."""
    return beam_generate(model.reader, *_reader_inputs(batch), **kwargs)


def port_t5_seq2seq_weights(state_dict: typ.Mapping[str, typ.Any], cfg: T5EncoderConfig) -> dict[str, torch.Tensor]:
    """HF `T5ForConditionalGeneration` state dict -> `Seq2SeqLM.state_dict`.

    A tied head (T5's default: logits = (h * d_model**-0.5) @ shared.T) is
    carried as an untied head with the scale folded in, exactly when the
    head equals the shared embedding."""
    f32 = lambda key: _f32(state_dict[key])
    shared = f32("shared.weight") if "shared.weight" in state_dict else f32("encoder.embed_tokens.weight")
    sd = {f"encoder.{k}": v for k, v in port_t5_encoder_weights(state_dict, cfg).items()}
    sd["dec_embed.weight"] = shared.clone()
    sd["final_norm.weight"] = f32("decoder.final_layer_norm.weight")
    head = f32("lm_head.weight") if "lm_head.weight" in state_dict else shared
    tied = head.shape == shared.shape and torch.equal(head, shared)
    sd["lm_head.weight"] = head * (cfg.hidden_size**-0.5 if tied else 1.0)
    for i in range(cfg.num_layers):
        p, q = f"decoder.block.{i}.", f"blocks.{i}."
        sd[q + "ln0.weight"] = f32(p + "layer.0.layer_norm.weight")
        for name in ("q", "k", "v", "o"):
            sd[q + f"self_{name}.weight"] = f32(p + f"layer.0.SelfAttention.{name}.weight")
            sd[q + f"cross_attention.{name}.weight"] = f32(p + f"layer.1.EncDecAttention.{name}.weight")
        sd[q + "ln1.weight"] = f32(p + "layer.1.layer_norm.weight")
        sd[q + "ln2.weight"] = f32(p + "layer.2.layer_norm.weight")
        sd[q + "wi.weight"] = f32(p + "layer.2.DenseReluDense.wi.weight")
        sd[q + "wo.weight"] = f32(p + "layer.2.DenseReluDense.wo.weight")
        if i == 0:
            sd[q + "relative_attention_bias"] = f32(p + "layer.0.SelfAttention.relative_attention_bias.weight")
    return sd


class Seq2SeqRealm(nn.Module):
    """Dual-encoder retriever + T5 seq2seq reader (BASELINE config #5). The
    retriever is initialised first, then the reader, both from `generator`,
    on `device` (default "cuda")."""

    def __init__(
        self,
        cfg: TransformerEncoderConfig,
        reader_cfg: T5EncoderConfig,
        gradients: Gradients,
        *,
        debug_encoder: bool = False,
        device: typ.Union[str, torch.device] = "cuda",
        generator: typ.Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.cfg = cfg
        self.reader_cfg = reader_cfg
        self.gradients = gradients
        self.encoder = _encoder(cfg, debug_encoder, device, generator)
        self.reader = Seq2SeqLM(reader_cfg, device=device, generator=generator)

    def encode(self, batch: RealmBatch) -> dict[str, torch.Tensor]:
        return _fused_encode(self.encoder, batch)

    def encode_field(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        return self.encoder(input_ids, attention_mask)

    def _reader_io(self, batch: RealmBatch) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(lm_logits, bos_answer_ids, bos_answer_mask), flattened to [B*D, ...]:
        the encoder reads the [context; question] segments, the decoder the
        BOS-shifted answer (token_type_ids == 2), cut to min(L, 64)."""
        ids, tt, mask = batch.lm__input_ids, batch.lm__token_type_ids, batch.lm__attention_mask
        b, d, length = ids.shape
        enc_ids, enc_mask = _reader_inputs(batch)
        flat = lambda x: x.reshape(b * d, length)
        ans_ids, ans_m = compact_answer_segment(flat(ids), flat(tt), flat(mask), min(length, 64))
        # teacher forcing: the decoder reads [BOS, a1 .. a_{la-1}]
        dec_in = torch.cat([torch.zeros_like(ans_ids[:, :1]), ans_ids[:, :-1]], dim=-1)
        dec_m = torch.cat([torch.ones_like(ans_m[:, :1]), ans_m[:, :-1]], dim=-1)
        return self.reader(enc_ids, enc_mask, dec_in, dec_m), dec_in, dec_m

    def evaluate(self, batch: RealmBatch) -> RealmOutput:
        enc = self.encode(batch)
        logits, lm_ids, lm_mask = self._reader_io(batch)
        b, d = batch.query__input_ids.shape[0], batch.section__score.shape[-1]
        patched = dataclasses.replace(
            batch, lm__input_ids=lm_ids.reshape(b, d, -1), lm__attention_mask=lm_mask.reshape(b, d, -1)
        )
        return self.gradients(batch=patched, lm_logits=logits, **enc)

    def forward(self, batch: RealmBatch, mode: str = "evaluate") -> typ.Any:
        """`encode` or `evaluate`; generation goes through `realm_generate`."""
        if mode == "encode":
            return self.encode(batch)
        if mode == "evaluate":
            return self.evaluate(batch)
        raise ValueError(f"Unknown mode: {mode}")
