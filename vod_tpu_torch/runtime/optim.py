"""The optimizers of the train step: AdamW with the weight-decay mask of
`vod_tpu/exps/cli.py:_decay_mask`, as `optax.adamw(lr, weight_decay=wd,
mask=_decay_mask)` builds it.

A parameter is kept out of weight decay when its flax path (`convert.flax_path`)
contains bias, norm, scale, `ln_`, `'ln` or layernorm, or when it has fewer
than two dimensions: biases, norm scales and the pooler's `log_scaler` are not
decayed; matrix kernels and embeddings are. The mask becomes two AdamW
parameter groups.

`optax.adamw` and `torch.optim.AdamW` apply the same update, p - lr *
(m_hat / (sqrt(v_hat) + eps) + wd * p), with b1 0.9, b2 0.999 and eps 1e-8
passed explicitly here. Their default decays differ (optax 1e-4, torch 1e-2),
so the decay is always passed too.

`Adafactor` is `optax.adafactor(lr, weight_decay_rate=wd or None)` with its
defaults (optax 0.2.6), not `torch.optim.Adafactor`, whose rules differ. Per
parameter, in this order: the factored RMS scaling (decay 1 - (t+1)^-0.8,
eps 1e-30 added to g², the moments factored over the two largest axes when
the second largest is at least 128, else one full moment); a clip of the
block RMS at 1.0; the learning rate; a scale by max(rms(param), 1e-3); the
decay `wd * param`, added after the learning rate and with no mask; the
minus sign. The axes are the flax leaf's (`convert.flax_layout`): an
attention kernel [H, heads, head_dim] factors as flax's does, not as the
port's [H, H] weight would.
"""

from __future__ import annotations

import typing as typ

import numpy as np
import torch
from torch import nn

from vod_tpu_torch.models.convert import FlaxLayout, flax_layout, flax_path

_NO_DECAY_TOKENS = ("bias", "norm", "scale", "ln_", "'ln", "layernorm")
# optax.adafactor's defaults, the only values the JAX CLI uses
_ADAFACTOR_MIN_DIM_TO_FACTOR = 128
_ADAFACTOR_DECAY_RATE = 0.8
_ADAFACTOR_EPS = 1e-30
_ADAFACTOR_CLIP = 1.0
_ADAFACTOR_MIN_SCALE = 1e-3


def decay_mask(model: nn.Module) -> dict[str, bool]:
    """Per parameter name: True where weight decay applies."""
    return {
        name: p.ndim >= 2 and not any(t in flax_path(name).lower() for t in _NO_DECAY_TOKENS)
        for name, p in model.named_parameters()
    }


def adamw(model: nn.Module, lr: float, *, weight_decay: float, mask: bool = True) -> torch.optim.AdamW:
    """AdamW over `model`'s parameters in two groups, "decay" (weight decay
    `weight_decay`) and "no_decay" (0.0), split by `decay_mask`; with
    `mask=False` every parameter decays (`optax.adamw` without a mask)."""
    keep = decay_mask(model) if mask else None
    groups: dict[str, list[torch.Tensor]] = {"decay": [], "no_decay": []}
    for name, p in model.named_parameters():
        groups["decay" if keep is None or keep[name] else "no_decay"].append(p)
    param_groups: list[dict[str, typ.Any]] = [
        {"params": groups["decay"], "weight_decay": weight_decay, "name": "decay"},
        {"params": groups["no_decay"], "weight_decay": 0.0, "name": "no_decay"},
    ]
    return torch.optim.AdamW([g for g in param_groups if g["params"]], lr=lr, betas=(0.9, 0.999), eps=1e-8)


class Adafactor(torch.optim.Optimizer):
    """optax's `adafactor` over parameters whose flax view is given by
    `layouts` (one `FlaxLayout` per parameter, in order; default: as they
    are). Each parameter's state: `count` (updates taken), `v_row` and
    `v_col` (factored) or `v`, in the flax leaf's axes."""

    def __init__(
        self,
        params: typ.Iterable[torch.Tensor],
        lr: float,
        *,
        weight_decay: typ.Optional[float] = None,
        layouts: typ.Optional[typ.Sequence[FlaxLayout]] = None,
    ):
        params = list(params)
        layouts = list(layouts) if layouts is not None else [FlaxLayout()] * len(params)
        if len(layouts) != len(params):
            raise ValueError(f"{len(layouts)} layouts for {len(params)} parameters")
        self.layouts = {id(p): layout for p, layout in zip(params, layouts)}
        super().__init__(params, dict(lr=lr, weight_decay=weight_decay))

    @staticmethod
    def _factored_dims(shape: tuple[int, ...]) -> typ.Optional[tuple[int, int]]:
        """optax's choice: the two largest axes, when the smaller is at least 128."""
        if len(shape) < 2:
            return None
        order = np.argsort(shape)
        if shape[order[-2]] < _ADAFACTOR_MIN_DIM_TO_FACTOR:
            return None
        return int(order[-2]), int(order[-1])

    @torch.no_grad()
    def step(self, closure: typ.Any = None) -> None:
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                layout = self.layouts.get(id(p), FlaxLayout())
                g = layout.to_flax(p.grad).to(torch.float32)
                w = layout.to_flax(p)
                state = self.state[p]
                dims = self._factored_dims(tuple(w.shape))
                if not state:
                    state["count"] = 0
                    if dims is not None:
                        d1, d0 = dims
                        state["v_row"] = torch.zeros([n for i, n in enumerate(w.shape) if i != d0], device=w.device)
                        state["v_col"] = torch.zeros([n for i, n in enumerate(w.shape) if i != d1], device=w.device)
                    else:
                        state["v"] = torch.zeros(w.shape, device=w.device)
                count = state["count"]
                decay = float(np.float32(1.0) - np.float32(count + 1) ** np.float32(-_ADAFACTOR_DECAY_RATE))
                g2 = g * g + _ADAFACTOR_EPS
                if dims is not None:
                    d1, d0 = dims
                    v_row = state["v_row"].mul_(decay).add_((1.0 - decay) * g2.mean(dim=d0))
                    v_col = state["v_col"].mul_(decay).add_((1.0 - decay) * g2.mean(dim=d1))
                    reduced_d1 = d1 - 1 if d1 > d0 else d1
                    row_factor = (v_row / v_row.mean(dim=reduced_d1, keepdim=True)) ** -0.5
                    u = g * row_factor.unsqueeze(d0) * (v_col ** -0.5).unsqueeze(d1)
                else:
                    v = state["v"].mul_(decay).add_((1.0 - decay) * g2)
                    u = g * v ** -0.5
                state["count"] = count + 1
                u = u / torch.clamp(torch.sqrt((u * u).mean()) / _ADAFACTOR_CLIP, min=1.0)
                u = u * group["lr"]
                rms = torch.sqrt((w * w).mean())
                u = u * torch.where(rms <= _ADAFACTOR_MIN_SCALE, _ADAFACTOR_MIN_SCALE, rms)
                if group["weight_decay"] is not None:
                    u = u + group["weight_decay"] * w
                p.copy_(layout.from_flax(w - u))


def adafactor(model: nn.Module, lr: float, *, weight_decay: typ.Optional[float] = None) -> Adafactor:
    """`Adafactor` over `model`'s parameters, each factored in its flax axes."""
    named = list(model.named_parameters())
    return Adafactor([p for _, p in named], lr, weight_decay=weight_decay,
                     layouts=[flax_layout(model, n) for n, _ in named])
