"""The optimizer of the train step: AdamW with the weight-decay mask of
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
"""

from __future__ import annotations

import typing as typ

import torch
from torch import nn

from vod_tpu_torch.models.convert import flax_path

_NO_DECAY_TOKENS = ("bias", "norm", "scale", "ln_", "'ln", "layernorm")


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
