"""T5-style encoder: pre-LN RMSNorm blocks, a relative position bias, bias-free
dense layers (port of `vod_tpu/models/t5_encoder.py`).

Parameters are f32 and activations run in `cfg.dtype` (bf16 by default), as
the flax module keeps them. Parity traps with the flax module, each handled
where it arises:
  * T5 does not scale the attention scores by 1/sqrt(head_dim);
  * masked keys are filled with -1e9, not `finfo.min` or -inf;
  * RMSNorm takes its statistics in f32, casts the normalised value to
    `cfg.dtype`, then multiplies by the scale cast to `cfg.dtype`;
  * only block 0 owns a relative-bias table; its bias is reused by every
    later block.
The relative-position buckets cast an f32 log ratio to int32, so a one-ulp
difference in `log` moves a bucket at a boundary. The buckets are therefore
always computed on the CPU (where `torch.log` agrees with XLA's over every
position, `tests/test_torch_t5.py`) and cached on the device per length.

`port_t5_encoder_weights` maps a HF T5 state dict onto this module's.
"""

from __future__ import annotations

import dataclasses
import typing as typ

import torch
import torch.nn.functional as F
from torch import nn

from .encoder import init_weights
from .pooler import VodPooler, VodPoolerConfig


@dataclasses.dataclass(frozen=True)
class T5EncoderConfig:
    vocab_size: int = 32128
    hidden_size: int = 512
    num_layers: int = 6
    num_heads: int = 8
    head_dim: int = 64
    intermediate_size: int = 2048
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_eps: float = 1e-6
    dtype: torch.dtype = torch.bfloat16  # activations; parameters are f32
    pooler: VodPoolerConfig = dataclasses.field(default_factory=VodPoolerConfig)


class _RMSNorm(nn.Module):
    """T5 LayerNorm: RMS only, no mean subtraction, no bias."""

    def __init__(self, size: int, eps: float = 1e-6, dtype: torch.dtype = torch.float32, device: typ.Any = None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(size, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        var = x.to(torch.float32).square().mean(dim=-1, keepdim=True)
        return (x * torch.rsqrt(var + self.eps)).to(self.dtype) * self.weight.to(self.dtype)


def _log_bucket(n: torch.Tensor, max_exact: int, num_buckets: int, max_distance: int) -> torch.Tensor:
    """The log-spaced bucket of distance `n` >= `max_exact`, in f32 as the flax
    module takes it (its `jnp.log` of the Python ratio included), cut to
    int32 and capped at `num_buckets - 1`."""
    log_ratio = torch.log(torch.tensor(max_distance / max_exact, dtype=torch.float32)).to(n.device)
    scaled = torch.log(torch.clamp(n, min=1).to(torch.float32) / max_exact) / log_ratio * (num_buckets - max_exact)
    return torch.clamp(max_exact + scaled.to(torch.int32), max=num_buckets - 1)


def _relative_buckets(rel_pos: torch.Tensor, num_buckets: int, max_distance: int) -> torch.Tensor:
    """T5's bidirectional relative-position bucketing (`rel_pos` = memory - query)."""
    num_buckets //= 2
    n = rel_pos.abs()
    max_exact = num_buckets // 2
    bucket = torch.where(n < max_exact, n, _log_bucket(n, max_exact, num_buckets, max_distance))
    return torch.where(rel_pos > 0, num_buckets, 0) + bucket


def _bucket_matrix(
    cache: dict, fn: typ.Callable, num_buckets: int, max_distance: int, length: int, device: torch.device
) -> torch.Tensor:
    """[L, L] int64 buckets of (key - query), computed on the CPU by `fn` and
    kept in `cache` per (length, device): a bucket must not depend on the
    device's `log`, and the copy to the card happens once per length."""
    key = (length, str(device))
    if key not in cache:
        pos = torch.arange(length)
        cache[key] = fn(pos[None, :] - pos[:, None], num_buckets, max_distance).to(torch.int64).to(device)
    return cache[key]


def _linear(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """flax `nn.Dense(use_bias=False, dtype=...)`: input and kernel cast to `dtype`."""
    return F.linear(x.to(dtype), layer.weight.to(dtype))


def _attend(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: typ.Optional[torch.Tensor], key_mask: torch.Tensor,
    dtype: torch.dtype,
) -> torch.Tensor:
    """T5 attention core: q [B, Lq, Hh, Dh], k/v [B, Lk, Hh, Dh], `bias`
    broadcast to [B, Hh, Lq, Lk] (f32), `key_mask` boolean, broadcast the
    same. No 1/sqrt(d) scale; masked scores are -1e9. Returns [B, Lq, Hh*Dh]."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32)
    if bias is not None:
        scores = scores + bias.to(torch.float32)
    scores = torch.where(key_mask, scores, -1e9)
    probs = torch.softmax(scores, dim=-1).to(dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
    return out.reshape(*out.shape[:2], -1)


def _heads(x: torch.Tensor, layer: nn.Linear, cfg: T5EncoderConfig) -> torch.Tensor:
    return _linear(x, layer, cfg.dtype).view(*x.shape[:-1], cfg.num_heads, cfg.head_dim)


class _T5Attention(nn.Module):
    def __init__(self, cfg: T5EncoderConfig, has_rel_bias: bool, device: typ.Any = None):
        super().__init__()
        self.cfg = cfg
        inner = cfg.num_heads * cfg.head_dim
        self.q = nn.Linear(cfg.hidden_size, inner, bias=False, device=device)
        self.k = nn.Linear(cfg.hidden_size, inner, bias=False, device=device)
        self.v = nn.Linear(cfg.hidden_size, inner, bias=False, device=device)
        self.o = nn.Linear(inner, cfg.hidden_size, bias=False, device=device)
        self.relative_attention_bias = (
            nn.Parameter(torch.empty(cfg.relative_attention_num_buckets, cfg.num_heads, device=device))
            if has_rel_bias else None
        )
        self._buckets: dict = {}

    def forward(
        self, x: torch.Tensor, mask: torch.Tensor, rel_bias: typ.Optional[torch.Tensor]
    ) -> tuple[torch.Tensor, typ.Optional[torch.Tensor]]:
        cfg = self.cfg
        q, k, v = (_heads(x, p, cfg) for p in (self.q, self.k, self.v))
        if self.relative_attention_bias is not None:
            buckets = _bucket_matrix(self._buckets, _relative_buckets, cfg.relative_attention_num_buckets,
                                     cfg.relative_attention_max_distance, x.shape[-2], x.device)
            rel_bias = self.relative_attention_bias[buckets].permute(2, 0, 1)[None]  # [1, Hh, L, L]
        out = _attend(q, k, v, rel_bias, mask[:, None, None, :] > 0, cfg.dtype)
        return _linear(out, self.o, cfg.dtype), rel_bias


class _T5Block(nn.Module):
    def __init__(self, cfg: T5EncoderConfig, has_rel_bias: bool, device: typ.Any = None):
        super().__init__()
        self.cfg = cfg
        self.ln0 = _RMSNorm(cfg.hidden_size, cfg.layer_norm_eps, cfg.dtype, device)
        self.attention = _T5Attention(cfg, has_rel_bias, device)
        self.ln1 = _RMSNorm(cfg.hidden_size, cfg.layer_norm_eps, cfg.dtype, device)
        self.wi = nn.Linear(cfg.hidden_size, cfg.intermediate_size, bias=False, device=device)
        self.wo = nn.Linear(cfg.intermediate_size, cfg.hidden_size, bias=False, device=device)

    def forward(
        self, x: torch.Tensor, mask: torch.Tensor, rel_bias: typ.Optional[torch.Tensor]
    ) -> tuple[torch.Tensor, typ.Optional[torch.Tensor]]:
        dt = self.cfg.dtype
        attn, rel_bias = self.attention(self.ln0(x), mask, rel_bias)
        x = x + attn
        ff = _linear(F.relu(_linear(self.ln1(x), self.wi, dt)), self.wo, dt)
        return x + ff, rel_bias


@torch.no_grad()
def init_t5_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Random-initialise every parameter from `generator`: the encoder's
    scheme for dense kernels, embeddings and the pooler, then unit RMSNorm
    scales and normal(0, 1) relative-bias tables (the flax initialiser)."""
    init_weights(module, generator)
    for m in module.modules():
        if isinstance(m, _RMSNorm):
            m.weight.fill_(1.0)
        table = getattr(m, "relative_attention_bias", None)
        if isinstance(table, nn.Parameter):
            table.normal_(0.0, 1.0, generator=generator)


def _materialise_t5(module: nn.Module, device: typ.Any, generator: typ.Optional[torch.Generator]) -> None:
    module.to_empty(device=device)
    init_t5_weights(module, generator or torch.Generator(device=device).manual_seed(0))


class T5Encoder(nn.Module):
    """`forward(input_ids, attention_mask)` returns the final-normed hidden
    states [B, L, H] in `cfg.dtype`. Parameters live on `device` (default
    "cuda"), random-initialised from `generator` (default: seed 0 there)."""

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
        self.shared = nn.Embedding(cfg.vocab_size, cfg.hidden_size, device=meta)
        self.blocks = nn.ModuleList(_T5Block(cfg, i == 0, meta) for i in range(cfg.num_layers))
        self.final_norm = _RMSNorm(cfg.hidden_size, cfg.layer_norm_eps, cfg.dtype, meta)
        if torch.device(device).type != meta:  # a part of a larger module is materialised by it
            _materialise_t5(self, device, generator)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        h = self.shared(input_ids).to(self.cfg.dtype)
        rel_bias = None
        for block in self.blocks:
            h, rel_bias = block(h, attention_mask, rel_bias)
        return self.final_norm(h)


class VodT5Encoder(nn.Module):
    """T5 encoder + VodPooler: `forward(input_ids, attention_mask)` returns the
    pooled f32 embeddings [B, H]."""

    def __init__(
        self,
        cfg: T5EncoderConfig,
        *,
        device: typ.Union[str, torch.device] = "cuda",
        generator: typ.Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.cfg = cfg
        self.backbone = T5Encoder(cfg, device="meta")
        self.vod_pooler = VodPooler(cfg.pooler, cfg.hidden_size, device="meta")
        _materialise_t5(self, device, generator)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        h = self.backbone(input_ids, attention_mask)
        return self.vod_pooler(h.to(torch.float32), attention_mask)


def t5_config_from_hf(
    hf_config: typ.Any, pooler: typ.Optional[VodPoolerConfig] = None, dtype: torch.dtype = torch.float32
) -> T5EncoderConfig:
    return T5EncoderConfig(
        vocab_size=hf_config.vocab_size,
        hidden_size=hf_config.d_model,
        num_layers=hf_config.num_layers,
        num_heads=hf_config.num_heads,
        head_dim=hf_config.d_kv,
        intermediate_size=hf_config.d_ff,
        relative_attention_num_buckets=hf_config.relative_attention_num_buckets,
        relative_attention_max_distance=getattr(hf_config, "relative_attention_max_distance", 128),
        dtype=dtype,
        pooler=pooler or VodPoolerConfig(),
    )


def _f32(v: typ.Any) -> torch.Tensor:
    return torch.as_tensor(v.detach().cpu() if hasattr(v, "detach") else v, dtype=torch.float32).clone()


def port_t5_encoder_weights(
    state_dict: typ.Mapping[str, typ.Any], cfg: T5EncoderConfig
) -> dict[str, torch.Tensor]:
    """HF T5 (encoder) state dict -> the port's `T5Encoder.state_dict`. HF's
    `nn.Linear` weights are stored [out, in] like the port's, so none is
    transposed; keys with and without the `encoder.` prefix are accepted."""
    prefix = "encoder." if any(k.startswith("encoder.") for k in state_dict) else ""
    shared = state_dict["shared.weight"] if "shared.weight" in state_dict else state_dict[prefix + "embed_tokens.weight"]
    sd = {"shared.weight": _f32(shared), "final_norm.weight": _f32(state_dict[prefix + "final_layer_norm.weight"])}
    for i in range(cfg.num_layers):
        p, q = f"{prefix}block.{i}.", f"blocks.{i}."
        sd[q + "ln0.weight"] = _f32(state_dict[p + "layer.0.layer_norm.weight"])
        for name in ("q", "k", "v", "o"):
            sd[q + f"attention.{name}.weight"] = _f32(state_dict[p + f"layer.0.SelfAttention.{name}.weight"])
        sd[q + "ln1.weight"] = _f32(state_dict[p + "layer.1.layer_norm.weight"])
        sd[q + "wi.weight"] = _f32(state_dict[p + "layer.1.DenseReluDense.wi.weight"])
        sd[q + "wo.weight"] = _f32(state_dict[p + "layer.1.DenseReluDense.wo.weight"])
        if i == 0:
            sd[q + "attention.relative_attention_bias"] = _f32(
                state_dict[p + "layer.0.SelfAttention.relative_attention_bias.weight"]
            )
    return sd
