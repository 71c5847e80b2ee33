"""Elementary tensor ops (port of `vod_tpu/ops/numpy_ops.py`).

Pure functions of tensors with static shapes, like their JAX counterparts.
`replace_negative_indices` takes an explicit `torch.Generator` where the JAX
version takes a key; the two draw different numbers from the same seed.
"""

from __future__ import annotations

import typing as typ

import torch


def topk_lowest_first(x: torch.Tensor, k: int, dim: int = -1) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k along `dim` in the order `lax.top_k` gives: descending, and the
    lowest index first among equal values. `torch.topk` does not promise that
    order on the card, so this takes a stable descending sort."""
    values, pos = torch.sort(x, dim=dim, descending=True, stable=True)
    return values.narrow(dim, 0, k), pos.narrow(dim, 0, k)


def masked_log_softmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """log_softmax treating NaN as -inf; all--inf rows return -inf (not NaN)."""
    x = torch.where(torch.isnan(x), float("-inf"), x)
    x_max = torch.amax(x, dim=dim, keepdim=True)
    x_max = torch.where(torch.isfinite(x_max), x_max, torch.zeros_like(x_max))
    shifted = x - x_max
    sum_exp = torch.sum(torch.exp(shifted), dim=dim, keepdim=True)
    lse = torch.log(torch.clamp(sum_exp, min=torch.finfo(x.dtype).tiny))
    out = shifted - lse
    return torch.where(torch.isfinite(x), out, float("-inf"))


def masked_softmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return torch.exp(masked_log_softmax(x, dim=dim))


def masked_logsumexp(
    x: torch.Tensor, mask: typ.Optional[torch.Tensor] = None, dim: int = -1
) -> torch.Tensor:
    """logsumexp over entries where `mask` is True; -inf where nothing is selected."""
    if mask is not None:
        x = torch.where(mask, x, float("-inf"))
    x = torch.where(torch.isnan(x), float("-inf"), x)
    x_max = torch.amax(x, dim=dim, keepdim=True)
    safe_max = torch.where(torch.isfinite(x_max), x_max, torch.zeros_like(x_max))
    sum_exp = torch.sum(torch.exp(x - safe_max), dim=dim, keepdim=True)
    out = safe_max + torch.log(torch.clamp(sum_exp, min=torch.finfo(x.dtype).tiny))
    out = torch.where(torch.isfinite(x_max), out, float("-inf"))
    return out.squeeze(dim)


def gather_values_by_indices(
    queries: torch.Tensor,
    indices: torch.Tensor,
    values: torch.Tensor,
    fill_value: float | int | None = None,
) -> torch.Tensor:
    """For each query id, the value whose key matches it (first match); NaN
    (floats) or -1 (ints) where none does."""
    if fill_value is None:
        fill_value = float("nan") if values.is_floating_point() else -1
    if indices.ndim == queries.ndim - 1:
        indices = indices.unsqueeze(0).expand(queries.shape[:1] + indices.shape)
        values = values.unsqueeze(0).expand(queries.shape[:1] + values.shape)
    eq = queries.unsqueeze(-1) == indices.unsqueeze(-2)  # [..., M, K]
    found = eq.any(dim=-1)
    pos = eq.to(torch.int8).argmax(dim=-1)  # first True (argmax returns the first max)
    gathered = torch.gather(values, -1, pos)
    return torch.where(found, gathered, torch.full_like(gathered, fill_value))


def normalize_scores(scores: torch.Tensor, offset: float = 0.0, dim: int = -1) -> torch.Tensor:
    """Subtract the per-row finite minimum (then add `offset`); -inf padding is
    kept and all-padding rows stay as they are. The sentinel is `finfo.max`,
    as in the JAX version."""
    finite = torch.isfinite(scores)
    big = torch.finfo(scores.dtype).max
    row_min = torch.amin(torch.where(finite, scores, big), dim=dim, keepdim=True)
    row_min = torch.where(row_min == big, torch.zeros_like(row_min), row_min)
    return torch.where(finite, scores - row_min + offset, scores)


def fill_nans_with_min(
    values: torch.Tensor, offset_min_value: float | None = -1.0, dim: int = -1
) -> torch.Tensor:
    """Replace NaNs with (row min + offset)."""
    isnan = torch.isnan(values)
    big = torch.finfo(values.dtype).max
    row_min = torch.amin(torch.where(isnan, big, values), dim=dim, keepdim=True)
    row_min = torch.where(row_min == big, torch.zeros_like(row_min), row_min)
    if offset_min_value is not None:
        row_min = row_min + offset_min_value
    return torch.where(isnan, row_min.expand_as(values), values)


def replace_negative_indices(
    indices: torch.Tensor, world_size: int, generator: torch.Generator
) -> torch.Tensor:
    """Replace padding (-1) ids with uniform random valid ids drawn from `generator`."""
    rand = torch.randint(
        0, world_size, indices.shape, generator=generator, device=indices.device, dtype=indices.dtype
    )
    return torch.where(indices < 0, rand, indices)
