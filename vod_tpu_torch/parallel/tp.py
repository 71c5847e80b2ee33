"""Tensor-parallel layers: the forwards of a transformer layer whose
parameters `mesh.shard_params_tp` split over a `tp` axis (Megatron's
layout, the all-reduces that GSPMD inserts for JAX's `tp_sharding`).

A split attention holds whole heads of q, k and v (their weight rows and
biases) and the matching columns of `out`; a split FFN holds a block of the
intermediate axis (the rows of `intermediate` / `fc_in` and the columns of
`output` / `fc_out`); a split word-embedding table (JAX's rule splits it on
the vocabulary: its key holds "wo") holds a block of rows, each rank looks
up the ids in its block, and the lookups are summed over the axis. The split layer's input reaches it through
`copy_over` (its gradient is summed over the axis), its partial outputs
are kept in f32 and summed over the axis by `sum_over`, and the replicated
output bias is added once, after the sum, before the one rounding to the
activation dtype. A replicated bias of a split layer (the
reader's `fc_in.bias`, which JAX's rule leaves whole) is read in blocks
through `copy_over`, so every rank holds its whole gradient.

The layers become these classes in place (`module.__class__`), and each
split parameter carries `tp_group`, which the train step's clip reads to
count its squares once over the axis.
"""

from __future__ import annotations

import dataclasses
import typing as typ

import torch
import torch.nn.functional as F
from torch import nn

from vod_tpu_torch.models.encoder import _dense, _Embeddings, _gelu, _Layer
from vod_tpu_torch.models.lm import _DecoderLayer
from .distributed import copy_over, sum_over


@dataclasses.dataclass(frozen=True)
class TpShard:
    """This rank's place on the tp axis and which parts of a layer are split."""

    group: typ.Any
    index: int
    size: int
    attention: bool
    ffn: bool


def _row_parallel(x: torch.Tensor, layer: nn.Linear, dt: torch.dtype, group: typ.Any) -> torch.Tensor:
    """`layer(x)` from this rank's block of input features, rounded to `dt`
    once, as the whole layer's product is: the partial products of the
    `dt`-rounded operands kept in f32 (exact products, f32 sums), summed
    over the axis, the replicated bias added, then the cast."""
    f32 = torch.float32
    part = F.linear(x.to(dt).to(f32), layer.weight.to(dt).to(f32))
    return (sum_over(part, group) + layer.bias.to(dt).to(f32)).to(dt)


def _block(t: torch.Tensor, tp: TpShard) -> torch.Tensor:
    """This rank's block of a replicated vector, its gradient summed over the axis."""
    per = t.shape[0] // tp.size
    return copy_over(t, tp.group)[tp.index * per : (tp.index + 1) * per]


class TpEmbeddings(_Embeddings):
    tp: TpShard

    def words(self, input_ids: torch.Tensor) -> torch.Tensor:
        table = self.word_embeddings.weight  # this rank's rows
        per = table.shape[0]
        local = input_ids - self.tp.index * per
        inside = (local >= 0) & (local < per)
        h = F.embedding(torch.where(inside, local, 0), table) * inside[..., None]
        return sum_over(h, self.tp.group).to(self.cfg.dtype)  # one rank holds each row: the sum is exact


class TpEncoderLayer(_Layer):
    tp: TpShard

    def forward(self, h: torch.Tensor, mask: torch.Tensor, group: typ.Any = None,
                rows: typ.Optional[torch.Tensor] = None) -> torch.Tensor:
        tp, dt = self.tp, self.cfg.dtype
        if tp.attention:
            att = self.attention
            a = _row_parallel(att.attend(copy_over(h, tp.group), mask), att.out, dt, tp.group)
        else:
            a = self.attention(h, mask)
        h = self.attention_norm(h + a)
        if tp.ffn:
            ff = _row_parallel(_gelu(_dense(copy_over(h, tp.group), self.intermediate, dt)), self.output, dt, tp.group)
        else:
            ff = self._ffn_dense(_gelu(self._ffn_dense(h, self.intermediate)), self.output)
        return self.output_norm(h + ff)


class TpDecoderLayer(_DecoderLayer):
    """The reader's layer: JAX's rule splits its FFN only (its attention's
    flax keys hold no "attention")."""

    tp: TpShard

    def _mlp(self, h: torch.Tensor) -> torch.Tensor:
        tp, dt = self.tp, self.cfg.dtype
        if not tp.ffn:
            return super()._mlp(h)
        bias = _block(self.fc_in.bias, tp)  # JAX's rule leaves it whole
        up = F.linear(copy_over(self.ln2(h), tp.group).to(dt), self.fc_in.weight.to(dt), bias.to(dt))
        return h + _row_parallel(_gelu(up), self.fc_out, dt, tp.group)


def _keep_block(module: nn.Module, name: str, dim: int, tp: TpShard) -> None:
    p = getattr(module, name)
    block = p.detach().chunk(tp.size, dim)[tp.index].clone()
    new = nn.Parameter(block, requires_grad=p.requires_grad)
    new.tp_group = tp.group
    setattr(module, name, new)


def split_layers(model: nn.Module, dims: typ.Mapping[str, typ.Optional[int]], group: typ.Any, index: int,
                 size: int) -> None:
    """Keep this rank's blocks of the parameters `dims` splits (torch dim per
    name) in every encoder and reader layer of `model`, and give those
    layers the tensor-parallel forwards. Raises for an MoE or LoRA layer
    that the rule would split (the port splits plain dense layers only)."""
    plans = {
        _Layer: (TpEncoderLayer, {
            "attention": {"attention.query.weight": 0, "attention.query.bias": 0, "attention.key.weight": 0,
                          "attention.key.bias": 0, "attention.value.weight": 0, "attention.value.bias": 0,
                          "attention.out.weight": 1},
            "ffn": {"intermediate.weight": 0, "intermediate.bias": 0, "output.weight": 1},
        }),
        _DecoderLayer: (TpDecoderLayer, {"attention": None, "ffn": {"fc_in.weight": 0, "fc_out.weight": 1}}),
        _Embeddings: (TpEmbeddings, {"words": {"word_embeddings.weight": 0}}),
    }
    for prefix, mod in list(model.named_modules()):
        kind = next((k for k in plans if type(mod) is k), None)
        if kind is None:
            continue
        cls, parts = plans[kind]
        dot = f"{prefix}." if prefix else ""
        if kind is _Layer and (mod.cfg.moe_experts > 0 or mod.cfg.lora_rank > 0) and any(
                dims.get(n) is not None for n in dims if n.startswith(dot)):
            raise ValueError("tensor parallelism splits plain dense layers only, not MoE or LoRA layers")
        split = {part: want is not None and all(dims.get(dot + n) == d for n, d in want.items())
                 for part, want in parts.items()}
        covered = {dot + n for part, want in parts.items() if split[part] for n in want}
        extra = sorted(n for n, d in dims.items() if n.startswith(dot) and d is not None and n not in covered)
        if extra:
            raise ValueError(f"tensor-parallel splits the port does not run: {extra}")
        tp = TpShard(group, index, size, split.get("attention", False), split.get("ffn", False))
        for part, want in parts.items():
            if split[part]:
                for n, d in want.items():
                    owner, attr = n.rsplit(".", 1)
                    _keep_block(mod.get_submodule(owner), attr, d, tp)
        mod.__class__ = cls
        mod.tp = tp
