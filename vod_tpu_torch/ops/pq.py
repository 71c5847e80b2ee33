"""int8 quantisation (own copy of `quantize_int8` from `vod_tpu/ops/pq.py`).

The rest of the PQ module (codebooks, OPQ, ADC) waits for the slice that ports
the compressed codecs.
"""

from __future__ import annotations

import torch


def quantize_int8(x: torch.Tensor, dim: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantisation along `dim`: scale = max(absmax, 1e-8) / 127.
    Returns (codes int8, scale f32). `torch.round` rounds half to even, as
    `jnp.round` does."""
    absmax = torch.amax(torch.abs(x), dim=dim, keepdim=True)
    scale = torch.clamp(absmax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale
