"""VodPooler: aggregate transformer hidden states into one embedding (port of
`vod_tpu/models/pooler.py`).

Aggregator (mean/max/cls/none), optional projection, activation, L1/L2 norm,
and a log-scale temperature applied as `* exp(0.5 * log_scaler)`.
"""

from __future__ import annotations

import dataclasses
import math
import typing as typ

import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class VodPoolerConfig:
    agg_method: str = "mean"
    projection_size: typ.Optional[int] = None
    output_activation: typ.Optional[str] = None  # relu | tanh | sigmoid | gelu
    output_norm: typ.Optional[str] = None  # l1 | l2
    scaler: float = 1.0
    learn_scaler: bool = False


def _aggregate(method: str, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """x: [..., L, H]; mask: [..., L]."""
    if method == "cls":
        return x[..., 0, :]
    if method == "mean":
        m = mask.unsqueeze(-1).to(x.dtype)
        return (x * m).sum(dim=-2) / torch.clamp(m.sum(dim=-2), min=1.0)
    if method == "max":
        # the vector with the largest norm
        norms = torch.linalg.vector_norm(x, dim=-1)
        norms = torch.where(mask > 0, norms, float("-inf"))
        best = norms.argmax(dim=-1)
        idx = best[..., None, None].expand(*best.shape, 1, x.shape[-1])
        return torch.gather(x, -2, idx).squeeze(-2)
    if method == "none":
        return x
    raise ValueError(f"Unknown agg_method: {method}")


_ACTIVATIONS: dict[str, typ.Callable[[torch.Tensor], torch.Tensor]] = {
    "relu": F.relu,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    # flax `nn.gelu` is the tanh approximation
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
}


class VodPooler(nn.Module):
    def __init__(
        self,
        config: VodPoolerConfig,
        backbone_output_size: int,
        *,
        device: typ.Union[str, torch.device, None] = None,
    ):
        super().__init__()
        self.config = config
        self.backbone_output_size = backbone_output_size
        self.projection = (
            nn.Linear(backbone_output_size, config.projection_size, device=device)
            if config.projection_size is not None
            else None
        )
        init = torch.tensor(math.log(config.scaler), dtype=torch.float32, device=device)
        if config.learn_scaler:
            self.log_scaler = nn.Parameter(init)
        else:
            self.register_buffer("log_scaler", init, persistent=False)

    def forward(self, hidden_states: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        pooled = _aggregate(cfg.agg_method, hidden_states, attention_mask)
        if self.projection is not None:
            pooled = self.projection(pooled)
        if cfg.output_activation is not None:
            pooled = _ACTIVATIONS[cfg.output_activation](pooled)
        if cfg.output_norm is not None:
            p = {"l1": 1, "l2": 2}[cfg.output_norm]
            norm = torch.linalg.vector_norm(pooled, ord=p, dim=-1, keepdim=True)
            pooled = pooled / torch.clamp(norm, min=1e-12)
        return pooled * torch.exp(0.5 * self.log_scaler.to(pooled.dtype))

    @property
    def output_size(self) -> int:
        return self.config.projection_size or self.backbone_output_size
