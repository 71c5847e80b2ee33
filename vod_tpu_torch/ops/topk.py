"""Hierarchical top-k for wide score rows (port of `vod_tpu/ops/topk.py`).

Exact two-stage selection: the top-k within fixed blocks, then the top-k
over the blocks' winners, which is exact for any k because a global top-k
element is a top-k element of its own block. Both stages select in
`lax.top_k`'s order (descending, the lowest index first among equal values,
`numpy_ops.topk_lowest_first`), so the result equals one top-k over the row
in that order, ids included.
"""

from __future__ import annotations

import torch

from .numpy_ops import topk_lowest_first


def block_topk(x: torch.Tensor, k: int, block: int = 1024) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over the last axis via per-block pre-selection.

    x: [..., C]. Returns (values [..., k], int64 indices [..., k] into the last axis)."""
    c = int(x.shape[-1])
    if c <= max(block, 2 * k):
        return topk_lowest_first(x, min(k, c))
    k_eff = min(k, c)
    nb = -(-c // block)
    pad = nb * block - c
    if pad:
        x = torch.nn.functional.pad(x, (0, pad), value=float("-inf"))
    xr = x.reshape(*x.shape[:-1], nb, block)
    kb = min(k_eff, block)
    s1, i1 = topk_lowest_first(xr, kb)  # [..., nb, kb]
    base = (torch.arange(nb, device=x.device) * block)[:, None]
    flat_s = s1.reshape(*x.shape[:-1], nb * kb)
    flat_i = (i1 + base).reshape(*x.shape[:-1], nb * kb)
    s2, pos = topk_lowest_first(flat_s, k_eff)
    return s2, torch.gather(flat_i, -1, pos)
