"""BERT-style transformer encoder with VOD pooling (port of `vod_tpu/models/encoder.py`).

A bias-full post-LN encoder in the BERT weight layout, with activations in
`cfg.dtype` (bf16 by default) and parameters in f32, as the flax version keeps
them. `models/convert.py` carries a flax parameter tree over to this module's
`state_dict`.

Parity traps with the flax version, each handled where it arises below:
  * flax `nn.gelu` is the tanh approximation, not PyTorch's default erf form;
  * attention kernels are stored `[H, heads, head_dim]` (`out`: `[heads,
    head_dim, H]`) — `convert.py` reshapes them into `nn.Linear` weights;
  * the query is scaled by 1/sqrt(head_dim) before the product, and the mask
    fills with `finfo(dtype).min`, not -inf;
  * LayerNorm eps is 1e-12; with bf16 activations the statistics and the
    normalisation run in f32 (fast variance E[x²] - E[x]², clipped at 0) and
    the parameters stay f32;
  * the pooler runs on the hidden states cast to f32.

Attention is written with plain tensor ops: the JAX package computes it in
plain XLA, outside any Pallas kernel. The dense products stay `F.linear`.
"""

from __future__ import annotations

import dataclasses
import math
import typing as typ

import torch
import torch.nn.functional as F
from torch import nn

from .pooler import VodPooler, VodPoolerConfig


@dataclasses.dataclass(frozen=True)
class TransformerEncoderConfig:
    vocab_size: int = 30522
    hidden_size: int = 256
    num_layers: int = 4
    num_heads: int = 4
    intermediate_size: int = 1024
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    dtype: torch.dtype = torch.bfloat16  # activations; parameters are f32
    lora_rank: int = 0  # LoRA adapters: not ported yet
    moe_experts: int = 0  # routed-MoE FFN: not ported yet
    pooler: VodPoolerConfig = dataclasses.field(default_factory=VodPoolerConfig)


class _LayerNorm(nn.Module):
    """flax `nn.LayerNorm(dtype=cfg.dtype)`: f32 statistics by the fast variance,
    f32 scale and bias, result cast to the activation dtype."""

    def __init__(self, size: int, eps: float, dtype: torch.dtype, device: typ.Any = None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(size, device=device))
        self.bias = nn.Parameter(torch.zeros(size, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.float32)
        mean = x.mean(dim=-1, keepdim=True)
        var = torch.clamp((x * x).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
        y = (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias
        return y.to(self.dtype)


def _dense(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """flax `nn.Dense(dtype=...)`: input, kernel and bias cast to `dtype` first."""
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


def _gelu(x: torch.Tensor) -> torch.Tensor:
    # flax `nn.gelu` defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


class _Embeddings(nn.Module):
    def __init__(self, cfg: TransformerEncoderConfig, device: typ.Any = None):
        super().__init__()
        self.cfg = cfg
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size, device=device)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size, device=device)
        self.token_type_embeddings = (
            nn.Embedding(cfg.type_vocab_size, cfg.hidden_size, device=device) if cfg.type_vocab_size else None
        )
        self.LayerNorm = _LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, cfg.dtype, device)

    def forward(self, input_ids: torch.Tensor, token_type_ids: typ.Optional[torch.Tensor]) -> torch.Tensor:
        dt = self.cfg.dtype
        # flax `nn.Embed(dtype=...)` looks up in the table cast to dtype (the same
        # values as casting after the lookup); the sums stay in dtype
        h = self.word_embeddings(input_ids).to(dt)
        pos = torch.arange(input_ids.shape[-1], device=input_ids.device)
        h = h + self.position_embeddings(pos).to(dt)[None]
        if self.token_type_embeddings is not None:
            tt = token_type_ids if token_type_ids is not None else torch.zeros_like(input_ids)
            h = h + self.token_type_embeddings(tt).to(dt)
        return self.LayerNorm(h)


class _Attention(nn.Module):
    """flax `nn.MultiHeadDotProductAttention` (self-attention, boolean mask)."""

    def __init__(self, cfg: TransformerEncoderConfig, device: typ.Any = None):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        self.query = nn.Linear(h, h, device=device)
        self.key = nn.Linear(h, h, device=device)
        self.value = nn.Linear(h, h, device=device)
        self.out = nn.Linear(h, h, device=device)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        cfg, dt = self.cfg, self.cfg.dtype
        b, length, hidden = x.shape
        heads = cfg.num_heads
        depth = hidden // heads
        q = _dense(x, self.query, dt).view(b, length, heads, depth)
        k = _dense(x, self.key, dt).view(b, length, heads, depth)
        v = _dense(x, self.value, dt).view(b, length, heads, depth)
        # the query is scaled by 1/sqrt(head_dim) before the product
        q = q / torch.tensor(math.sqrt(depth), dtype=dt, device=x.device)
        w = torch.einsum("bqhd,bkhd->bhqk", q, k)
        # the mask fills with finfo(dtype).min, not -inf
        w = torch.where(mask, w, torch.finfo(dt).min)
        w = torch.softmax(w, dim=-1).to(dt)
        o = torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(b, length, hidden)
        return _dense(o, self.out, dt)


class _Layer(nn.Module):
    def __init__(self, cfg: TransformerEncoderConfig, device: typ.Any = None):
        super().__init__()
        self.cfg = cfg
        self.attention = _Attention(cfg, device)
        self.attention_norm = _LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, cfg.dtype, device)
        self.intermediate = nn.Linear(cfg.hidden_size, cfg.intermediate_size, device=device)
        self.output = nn.Linear(cfg.intermediate_size, cfg.hidden_size, device=device)
        self.output_norm = _LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, cfg.dtype, device)

    def forward(self, h: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        dt = self.cfg.dtype
        h = self.attention_norm(h + self.attention(h, mask))
        ff = _gelu(_dense(h, self.intermediate, dt))
        ff = _dense(ff, self.output, dt)
        return self.output_norm(h + ff)


class TransformerEncoder(nn.Module):
    """BERT-style post-LN encoder backbone."""

    def __init__(self, cfg: TransformerEncoderConfig, device: typ.Any = None):
        super().__init__()
        if cfg.lora_rank > 0:
            raise NotImplementedError("LoRA adapters (lora_rank > 0) are not ported to vod_tpu_torch yet")
        if cfg.moe_experts > 0:
            raise NotImplementedError("the MoE FFN (moe_experts > 0) is not ported to vod_tpu_torch yet")
        self.cfg = cfg
        self.embeddings = _Embeddings(cfg, device)
        self.layers = nn.ModuleList(_Layer(cfg, device) for _ in range(cfg.num_layers))

    def forward(
        self,
        input_ids: torch.Tensor,
        attention_mask: torch.Tensor,
        token_type_ids: typ.Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        h = self.embeddings(input_ids, token_type_ids)
        mask = attention_mask[:, None, None, :] > 0  # [B, 1, 1(=Lq), L]
        for layer in self.layers:
            h = layer(h, mask)
        return h


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Random-initialise every parameter from `generator` (BERT's scheme:
    normal(0, 0.02) weights, zero biases, unit LayerNorm scales; the pooler's
    log-scaler at log(scaler))."""
    for m in module.modules():
        if isinstance(m, nn.Linear):
            m.weight.normal_(0.0, 0.02, generator=generator)
            m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            m.weight.normal_(0.0, 0.02, generator=generator)
        elif isinstance(m, _LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, VodPooler):
            m.log_scaler.fill_(math.log(m.config.scaler))


def _materialise(module: nn.Module, device: typ.Any, generator: typ.Optional[torch.Generator]) -> None:
    module.to_empty(device=device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    init_weights(module, generator)


class VodEncoder(nn.Module):
    """Backbone + VodPooler: `forward(input_ids, attention_mask)` returns the
    pooled f32 embeddings `[B, H]`.

    Parameters live on `device` (default "cuda") and are random-initialised
    from `generator` (default: seed 0 on that device); load real weights with
    `load_state_dict(convert.flax_to_state_dict(...))`."""

    def __init__(
        self,
        cfg: TransformerEncoderConfig,
        *,
        device: typ.Union[str, torch.device] = "cuda",
        generator: typ.Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.cfg = cfg
        self.backbone = TransformerEncoder(cfg, device="meta")
        self.vod_pooler = VodPooler(cfg.pooler, cfg.hidden_size, device="meta")
        _materialise(self, device, generator)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        h = self.backbone(input_ids, attention_mask)
        # the pooler runs on the hidden states cast to f32
        return self.vod_pooler(h.to(torch.float32), attention_mask)

    def tokens(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        """Per-token L2-normalized embeddings `[B, T, H]`, padding tokens zeroed."""
        h = self.backbone(input_ids, attention_mask).to(torch.float32)
        h = h / torch.clamp(torch.linalg.vector_norm(h, dim=-1, keepdim=True), min=1e-9)
        return h * (attention_mask[..., None] > 0)


class DebugEncoder(nn.Module):
    """Embedding-only encoder: word embeddings + pooling, no attention."""

    def __init__(
        self,
        cfg: TransformerEncoderConfig,
        *,
        device: typ.Union[str, torch.device] = "cuda",
        generator: typ.Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.cfg = cfg
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size, device="meta")
        self.vod_pooler = VodPooler(cfg.pooler, cfg.hidden_size, device="meta")
        _materialise(self, device, generator)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        h = self.word_embeddings(input_ids)
        return self.vod_pooler(h.to(torch.float32), attention_mask)
