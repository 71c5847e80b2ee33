"""Causal language model, the REALM reader, in the GPT-2 layout (port of the
forward pass of `vod_tpu/models/lm.py`).

A pre-LN decoder: `x + attn(ln1 x)`, `x + mlp(ln2 x)`, learned positions,
a final `ln_f`, and an untied (or tied) output head. Parameters are f32 and
activations run in `cfg.dtype` (bf16 by default), as the flax module keeps
them. Parity traps with the flax module, each handled where it arises:
  * attention scores are taken in `cfg.dtype`, cast to f32 and divided by
    sqrt(head_dim); masked positions are filled with `finfo(f32).min`, not
    -inf, so a row whose keys are all masked attends uniformly; the
    probabilities are cast back to `cfg.dtype`;
  * GELU is the tanh approximation (flax `nn.gelu`);
  * `ln_f` runs in `cfg.dtype`, its result is cast to f32, and the head is an
    f32 product.
Attention is plain matmul + softmax: `scaled_dot_product_attention` masks
differently. `prefill`, `decode_step` and generation are not ported yet.
"""

from __future__ import annotations

import dataclasses
import math
import typing as typ

import torch
import torch.nn.functional as F
from torch import nn

from .encoder import _dense, _gelu, _LayerNorm, _materialise


@dataclasses.dataclass(frozen=True)
class CausalLMConfig:
    vocab_size: int = 30522
    hidden_size: int = 256
    num_layers: int = 4
    num_heads: int = 4
    intermediate_size: int = 1024
    max_position_embeddings: int = 1024
    layer_norm_eps: float = 1e-5
    tie_word_embeddings: bool = False
    dtype: torch.dtype = torch.bfloat16  # activations; parameters are f32

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


class _DecoderLayer(nn.Module):
    def __init__(self, cfg: CausalLMConfig, device: typ.Any = None):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        self.ln1 = _LayerNorm(h, cfg.layer_norm_eps, cfg.dtype, device)
        self.ln2 = _LayerNorm(h, cfg.layer_norm_eps, cfg.dtype, device)
        self.query = nn.Linear(h, h, device=device)
        self.key = nn.Linear(h, h, device=device)
        self.value = nn.Linear(h, h, device=device)
        self.out = nn.Linear(h, h, device=device)
        self.fc_in = nn.Linear(h, cfg.intermediate_size, device=device)
        self.fc_out = nn.Linear(cfg.intermediate_size, h, device=device)

    def _attend(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """x [B, L, H]; mask [B, 1, L, L] bool."""
        cfg, dt = self.cfg, self.cfg.dtype
        b, length, hidden = x.shape
        shape = (b, length, cfg.num_heads, cfg.head_dim)
        q = _dense(x, self.query, dt).view(shape)
        k = _dense(x, self.key, dt).view(shape)
        v = _dense(x, self.value, dt).view(shape)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32) / math.sqrt(cfg.head_dim)
        scores = torch.where(mask, scores, torch.finfo(torch.float32).min)
        probs = torch.softmax(scores, dim=-1).to(dt)
        o = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, length, hidden)
        return _dense(o, self.out, dt)

    def forward(self, h: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        dt = self.cfg.dtype
        h = h + self._attend(self.ln1(h), mask)
        return h + _dense(_gelu(_dense(self.ln2(h), self.fc_in, dt)), self.fc_out, dt)


class CausalLM(nn.Module):
    """`forward(input_ids, attention_mask)` returns next-token logits [B, L, V]
    in f32. Parameters live on `device` (default "cuda") and are
    random-initialised from `generator` (default: seed 0 on that device);
    load real weights with `load_state_dict(convert.lm_flax_to_state_dict(...))`."""

    def __init__(
        self,
        cfg: CausalLMConfig,
        *,
        device: typ.Union[str, torch.device] = "cuda",
        generator: typ.Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.cfg = cfg
        meta = "meta"
        self.wte = nn.Embedding(cfg.vocab_size, cfg.hidden_size, device=meta)
        self.wpe = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size, device=meta)
        self.layers = nn.ModuleList(_DecoderLayer(cfg, meta) for _ in range(cfg.num_layers))
        self.ln_f = _LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, cfg.dtype, meta)
        self.lm_head = (
            None if cfg.tie_word_embeddings else nn.Linear(cfg.hidden_size, cfg.vocab_size, bias=False, device=meta)
        )
        _materialise(self, device, generator)

    def _logits(self, h: torch.Tensor) -> torch.Tensor:
        h = self.ln_f(h).to(torch.float32)
        head = self.wte.weight if self.lm_head is None else self.lm_head.weight
        return F.linear(h, head.to(torch.float32))

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        dt = self.cfg.dtype
        length = input_ids.shape[-1]
        pos = torch.arange(length, device=input_ids.device)
        h = self.wte(input_ids).to(dt) + self.wpe(pos).to(dt)[None]
        causal = torch.ones((length, length), dtype=torch.bool, device=input_ids.device).tril()
        mask = causal[None, None] & (attention_mask[:, None, None, :] > 0)
        for layer in self.layers:
            h = layer(h, mask)
        return self._logits(h)
