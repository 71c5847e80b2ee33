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

With `lora_rank > 0` the FFN's `intermediate` and `output` are `LoraDense`
(attention keeps plain kernels, as in JAX); `lora_trainable_mask` names the
adapters and the pooler, which `models/kbit.py` keeps trainable. With
`moe_experts > 0` each layer's FFN is a routed `parallel/moe.py:MoEFFN`
(`moe`), and the layer appends `moe_aux_weight * aux` to its `sown` slot
when a caller collects losses (`systems.collect_losses`, flax's `sow` into
`"losses"`); MoE and LoRA exclude each other, as in JAX. With
`remat` each layer runs under `torch.utils.checkpoint` (non-reentrant) when
a gradient is recorded: the same outputs and gradients, with a layer's
activations recomputed in the backward pass instead of kept.
"""

from __future__ import annotations

import dataclasses
import math
import typing as typ

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
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
    remat: bool = False  # recompute each layer's activations in the backward pass
    lora_rank: int = 0  # > 0: LoRA adapters on the FFN's two dense layers
    lora_alpha: float = 16.0
    moe_experts: int = 0  # > 0: each FFN is a top-k routed MoE (`parallel/moe.py`)
    moe_top_k: int = 1
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 1e-2
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


class LoraDense(nn.Module):
    """Dense + low-rank adapter: `x W + b + (alpha/r) (x A) B`, the adapter in
    the activation dtype. `base` is the `nn.Linear` a checkpoint loads into;
    `lora_a` [in, r] and `lora_b` [r, out] keep flax's layout. `init_weights`
    draws `lora_a` from normal(0.02) and zeroes `lora_b`, so a fresh adapter
    adds nothing."""

    def __init__(self, in_features: int, features: int, rank: int, alpha: float, dtype: torch.dtype,
                 device: typ.Any = None):
        super().__init__()
        self.dtype = dtype
        self.scale = alpha / rank
        self.base = nn.Linear(in_features, features, device=device)
        self.lora_a = nn.Parameter(torch.zeros(in_features, rank, device=device))
        self.lora_b = nn.Parameter(torch.zeros(rank, features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = _dense(x, self.base, self.dtype)
        return y + self.scale * ((x @ self.lora_a.to(x.dtype)) @ self.lora_b.to(x.dtype))


def lora_trainable_mask(model: nn.Module) -> dict[str, bool]:
    """Per parameter name: True for the LoRA adapters and the pooler (the
    rule of `vod_tpu/models/encoder.py:lora_trainable_mask` on each name's
    flax path); the rest is the frozen base."""
    from .convert import flax_path

    def rule(name: str) -> bool:
        key = flax_path(name)
        return "lora_a" in key or "lora_b" in key or "vod_pooler" in key

    return {name: rule(name) for name, _ in model.named_parameters()}


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

    def words(self, input_ids: torch.Tensor) -> torch.Tensor:
        # flax `nn.Embed(dtype=...)` looks up in the table cast to dtype (the same
        # values as casting after the lookup)
        return self.word_embeddings(input_ids).to(self.cfg.dtype)

    def forward(self, input_ids: torch.Tensor, token_type_ids: typ.Optional[torch.Tensor]) -> torch.Tensor:
        dt = self.cfg.dtype
        h = self.words(input_ids)  # the sums stay in dtype
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
        return _dense(self.attend(x, mask), self.out, self.cfg.dtype)

    def attend(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """The heads' outputs before the out projection, `[B, L, heads * head_dim]`
        for the heads this module holds (all of them, or a tensor-parallel
        block: the count comes from the query's rows)."""
        cfg, dt = self.cfg, self.cfg.dtype
        b, length, _ = x.shape
        depth = cfg.hidden_size // cfg.num_heads
        q = _dense(x, self.query, dt).view(b, length, -1, depth)
        k = _dense(x, self.key, dt).view(b, length, -1, depth)
        v = _dense(x, self.value, dt).view(b, length, -1, depth)
        # the query is scaled by 1/sqrt(head_dim), rounded to dt, before the
        # product (`torch.full` fills on the device: a host-made scalar tensor
        # would be a copy that waits for the card)
        q = q / torch.full((), math.sqrt(depth), dtype=dt, device=x.device)
        w = torch.einsum("bqhd,bkhd->bhqk", q, k)
        # the mask fills with finfo(dtype).min, not -inf
        w = torch.where(mask, w, torch.finfo(dt).min)
        w = torch.softmax(w, dim=-1).to(dt)
        return torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(b, length, -1)


class _Layer(nn.Module):
    def __init__(self, cfg: TransformerEncoderConfig, device: typ.Any = None):
        super().__init__()
        self.cfg = cfg
        self.attention = _Attention(cfg, device)
        self.attention_norm = _LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, cfg.dtype, device)
        h, inter, r = cfg.hidden_size, cfg.intermediate_size, cfg.lora_rank
        if cfg.moe_experts > 0:
            if r > 0:
                raise ValueError(
                    "moe_experts and lora_rank are mutually exclusive: the MoE FFN replaces the dense "
                    "layers LoRA would adapt"
                )
            from vod_tpu_torch.parallel.moe import MoEFFN

            self.moe = MoEFFN(h, cfg.moe_experts, inter, cfg.moe_top_k, cfg.moe_capacity_factor, cfg.dtype, device)
            # set by `systems.collect_losses`
            self.sown: typ.Optional[list[torch.Tensor]] = None
            self.sown_group: typ.Any = None
            self.sown_rows: typ.Optional[torch.Tensor] = None
        elif r > 0:
            self.intermediate = LoraDense(h, inter, r, cfg.lora_alpha, cfg.dtype, device)
            self.output = LoraDense(inter, h, r, cfg.lora_alpha, cfg.dtype, device)
        else:
            self.intermediate = nn.Linear(h, inter, device=device)
            self.output = nn.Linear(inter, h, device=device)
        self.output_norm = _LayerNorm(h, cfg.layer_norm_eps, cfg.dtype, device)

    def _ffn_dense(self, x: torch.Tensor, layer: nn.Module) -> torch.Tensor:
        return layer(x) if isinstance(layer, LoraDense) else _dense(x, layer, self.cfg.dtype)

    def forward(self, h: torch.Tensor, mask: torch.Tensor, group: typ.Any = None,
                rows: typ.Optional[torch.Tensor] = None) -> torch.Tensor:
        """`group` and `rows`: the MoE auxiliary loss's (`MoEFFN.forward`),
        passed as arguments so that a recomputed layer sees them too."""
        h = self.attention_norm(h + self.attention(h, mask))
        if self.cfg.moe_experts > 0:
            ff, aux = self.moe(h, group=group, rows=rows)
            if self.sown is not None:
                self.sown.append(self.cfg.moe_aux_weight * aux)
        else:
            ff = self._ffn_dense(_gelu(self._ffn_dense(h, self.intermediate)), self.output)
        return self.output_norm(h + ff)


class TransformerEncoder(nn.Module):
    """BERT-style post-LN encoder backbone."""

    def __init__(self, cfg: TransformerEncoderConfig, device: typ.Any = None):
        super().__init__()
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
        remat = self.cfg.remat and torch.is_grad_enabled()
        for layer in self.layers:
            aux = (getattr(layer, "sown_group", None), getattr(layer, "sown_rows", None))
            h = torch.utils.checkpoint.checkpoint(layer, h, mask, *aux, use_reentrant=False) if remat \
                else layer(h, mask, *aux)
        return h


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Random-initialise every parameter from `generator` (BERT's scheme:
    normal(0, 0.02) weights, zero biases, unit LayerNorm scales; the pooler's
    log-scaler at log(scaler); LoRA's `lora_a` normal(0, 0.02), `lora_b` 0;
    an MoE FFN's `lecun_normal`)."""
    from vod_tpu_torch.parallel.moe import MoEFFN

    for m in module.modules():
        if isinstance(m, MoEFFN):
            m.reset_parameters(generator)
        elif isinstance(m, LoraDense):
            m.lora_a.normal_(0.0, 0.02, generator=generator)
            m.lora_b.zero_()
        elif isinstance(m, nn.Linear):
            m.weight.normal_(0.0, 0.02, generator=generator)
            if m.bias is not None:
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
