"""Expert parallelism: the mixture-of-experts FFN and its expert-axis split
(port of `vod_tpu/parallel/moe.py`).

`MoEFFN` routes each token to its top-k experts by a softmax gate and
dispatches through one-hot einsums, step for step as the JAX module does:
  * the input is cast to `dtype`; the gate's logits and softmax run in f32;
  * each expert takes at most `cap = max(1, ceil(k·T/E·cf))` tokens of a
    row; a slot's position is the count of earlier slots routed to the same
    expert over the row's `[T·k]` flattening (token-major, then choice), and
    a token past the capacity gets 0 from that expert;
  * the gates are renormalised over the k choices, the combine runs in f32,
    and the experts' GELU is the tanh form;
  * the Switch auxiliary loss is `E · Σ_e frac_e · mean_p_e`, where
    `frac_e` counts first choices only. Padding tokens count, as in JAX.
Ties between equal gate probabilities go to the lowest expert id, as
`lax.top_k` breaks them (`ops/numpy_ops.py:topk_lowest_first`).

Over a split batch, `forward(x, group=..., rows=...)` makes the auxiliary
loss the global batch's: `frac` and `mean_p` are sums over the group's
tokens (a differentiable `all_reduce`) divided by their count before the
product, since a mean of per-rank products is another value.

`shard_params_ep` keeps each rank's block of experts (`wi`, `wo` split on
their leading axis by `ep_sharding`, JAX's rule). Tokens are replicated over
the axis, as in JAX: each rank runs its experts on every token, and the
partial outputs are summed over the axis (`sum_over`); the gate and the
input reach the experts through `copy_over`, so their gradients are the sum
of every rank's part and equal on each rank.
"""

from __future__ import annotations

import dataclasses
import math
import typing as typ

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from vod_tpu_torch.ops.numpy_ops import topk_lowest_first
from .distributed import copy_over, sum_over
from .mesh import _torch_dim, axis_group, axis_index, axis_size, flax_leaves

# JAX's truncated normal is cut at two standard deviations; this rescales its
# standard deviation to the one asked for (flax's `variance_scaling`)
_TRUNC_STD = 0.87962566103423978


@dataclasses.dataclass(frozen=True)
class ExpertShard:
    """This rank's block of experts on an expert-parallel axis."""

    group: typ.Any
    index: int
    size: int


class MoEFFN(nn.Module):
    """Top-k routed experts replacing a dense FFN. Parameters in flax's
    layout: `gate [H, E]`, `wi [E, H, I]`, `wo [E, I, H]`, f32, on `device`
    (default "cuda"; uninitialised until `reset_parameters`, which the
    encoder's `init_weights` calls). `forward(x [B, T, H])` returns
    (y [B, T, H] in `dtype`, aux scalar f32)."""

    def __init__(
        self,
        hidden_size: int,
        n_experts: int,
        intermediate_size: int,
        top_k: int = 1,
        capacity_factor: float = 1.25,
        dtype: torch.dtype = torch.float32,
        device: typ.Union[str, torch.device, None] = "cuda",
    ):
        super().__init__()
        self.n_experts = n_experts
        self.intermediate_size = intermediate_size
        self.top_k = top_k
        self.capacity_factor = capacity_factor
        self.dtype = dtype
        self.gate = nn.Parameter(torch.empty(hidden_size, n_experts, device=device))
        self.wi = nn.Parameter(torch.empty(n_experts, hidden_size, intermediate_size, device=device))
        self.wo = nn.Parameter(torch.empty(n_experts, intermediate_size, hidden_size, device=device))
        self.ep: typ.Optional[ExpertShard] = None  # set by `shard_params_ep`

    @torch.no_grad()
    def reset_parameters(self, generator: typ.Optional[torch.Generator] = None) -> None:
        """flax's `lecun_normal` from `generator`: a normal truncated at two
        standard deviations, of variance 1 / fan_in (the gate's H; the
        experts' H·E and I·E, as flax counts the leading axis)."""
        e = self.n_experts
        for p, fan_in in ((self.gate, self.gate.shape[0]), (self.wi, self.wi.shape[1] * e),
                          (self.wo, self.wo.shape[1] * e)):
            std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
            nn.init.trunc_normal_(p, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)

    def capacity(self, tokens: int) -> int:
        return max(1, math.ceil(self.top_k * tokens / self.n_experts * self.capacity_factor))

    def forward(
        self, x: torch.Tensor, *, group: typ.Any = None, rows: typ.Optional[torch.Tensor] = None
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """`group`: the process group whose tokens the auxiliary loss counts
        (a data-parallel axis splitting the batch); `rows`: a bool mask of
        the rows of `x` that count toward it (None: all)."""
        dt = self.dtype
        x = x.to(dt)
        b, t, _ = x.shape
        e, k = self.n_experts, self.top_k
        cap = self.capacity(t)

        probs = torch.softmax(torch.einsum("bth,he->bte", x.to(torch.float32), self.gate), dim=-1)
        top_p, top_e = topk_lowest_first(probs, k)  # [B, T, k]
        # each slot's position in its expert's buffer: the slots routed there before it
        flat = F.one_hot(top_e, e).reshape(b, t * k, e)
        pos = ((torch.cumsum(flat, dim=1) - flat) * flat).sum(-1).reshape(b, t, k)
        keep = pos < cap
        gk = (top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)) * keep
        # the k experts of a token differ, so no two choices share a (expert, slot)
        slot = top_e * cap + torch.clamp(pos, max=cap - 1)
        disp = torch.zeros((b, t, e * cap), dtype=dt, device=x.device).scatter_(-1, slot, keep.to(dt))
        if self.ep is not None:
            x_in, gk = copy_over(x, self.ep.group), copy_over(gk, self.ep.group)
        else:
            x_in = x
        comb = torch.zeros((b, t, e * cap), dtype=torch.float32, device=x.device).scatter(
            -1, slot, gk.to(torch.float32))
        disp, comb = disp.view(b, t, e, cap), comb.view(b, t, e, cap)
        if self.ep is not None:
            per = e // self.ep.size
            lo = self.ep.index * per
            disp, comb = disp[:, :, lo : lo + per], comb[:, :, lo : lo + per]

        xe = torch.einsum("bth,btec->bech", x_in, disp)  # [B, E, cap, H]
        he = F.gelu(torch.einsum("bech,ehi->beci", xe, self.wi.to(dt)), approximate="tanh")
        ye = torch.einsum("beci,eih->bech", he, self.wo.to(dt))
        y = torch.einsum("bech,btec->bth", ye.to(torch.float32), comb)
        if self.ep is not None:
            y = sum_over(y, self.ep.group)
        return y.to(dt), self._aux(probs, top_e[..., 0], group, rows)

    def _aux(self, probs: torch.Tensor, first: torch.Tensor, group: typ.Any,
             rows: typ.Optional[torch.Tensor]) -> torch.Tensor:
        e = self.n_experts
        chosen = F.one_hot(first, e).to(torch.float32)  # [B, T, E]
        if rows is None and (group is None or not dist.is_initialized() or dist.get_world_size(group) == 1):
            return e * torch.sum(chosen.mean(dim=(0, 1)) * probs.mean(dim=(0, 1)))
        w = torch.ones(probs.shape[:1], device=probs.device) if rows is None else rows.to(torch.float32)
        total = torch.cat([
            (chosen * w[:, None, None]).sum(dim=(0, 1)),
            (probs * w[:, None, None]).sum(dim=(0, 1)),
            (w.sum() * probs.shape[1]).reshape(1),
        ])
        if group is not None and dist.is_initialized() and dist.get_world_size(group) > 1:
            from torch.distributed.nn.functional import all_reduce

            total = all_reduce(total, group=group)
        return e * torch.sum((total[:e] / total[-1]) * (total[e : 2 * e] / total[-1]))


def ep_sharding(model: nn.Module, mesh: typ.Any, axis: str = "ep") -> dict[str, typ.Optional[int]]:
    """Per parameter: the torch dim split over the mesh's `axis`, or None
    (replicated). JAX's rule on each parameter's flax leaf: a 3-D leaf under
    a `wi` or `wo` key whose leading (expert) axis divides by the axis size
    is split on it; without the axis on the mesh, everything is replicated."""
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return {name: None for name, _ in model.named_parameters()}
    size = axis_size(mesh, axis)
    out: dict[str, typ.Optional[int]] = {}
    for name, key, layout, shape in flax_leaves(model):
        split = len(shape) == 3 and ("wi" in key or "wo" in key) and shape[0] % size == 0
        out[name] = _torch_dim(layout.kind, 0) if split else None
    return out


def shard_params_ep(model: nn.Module, mesh: typ.Any, axis: str = "ep") -> nn.Module:
    """Keep this rank's block of experts in every `MoEFFN` of `model` whose
    `wi` and `wo` `ep_sharding` splits (in place; returns `model`). A mesh
    without the axis, or with it at size 1, leaves `model` as it is."""
    size = axis_size(mesh, axis)
    if size == 1:
        return model
    dims = ep_sharding(model, mesh, axis)
    index, group = axis_index(mesh, axis), axis_group(mesh, axis)
    for prefix, mod in model.named_modules():
        if not isinstance(mod, MoEFFN) or mod.ep is not None:
            continue
        dot = f"{prefix}." if prefix else ""
        if dims[f"{dot}wi"] != 0 or dims[f"{dot}wo"] != 0:
            continue
        per = mod.n_experts // size
        for name in ("wi", "wo"):
            block = getattr(mod, name).detach()[index * per : (index + 1) * per].clone()
            setattr(mod, name, nn.Parameter(block, requires_grad=getattr(mod, name).requires_grad))
        mod.ep = ExpertShard(group, index, size)
    return model
