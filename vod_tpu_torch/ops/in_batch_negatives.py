"""In-batch negatives: flatten per-query sections into one shared section pool
(port of `vod_tpu/ops/in_batch_negatives.py`).

The pool holds the batch's unique section ids in ascending order, padded
with -1 to the fixed width U = B * D; per-query scores, labels and
log-weights are gathered onto it, so every query scores against every pooled
section.
"""

from __future__ import annotations

import dataclasses

import torch

from .numpy_ops import fill_nans_with_min, gather_values_by_indices
from .sample import PrioritySampledSections


@dataclasses.dataclass
class FlatSampledSections:
    """A shared section pool: ids [U]; per-query channels [B, U]."""

    pool_ids: torch.Tensor  # [U], -1 padding
    scores: torch.Tensor  # [B, U]; absent (query, id) pairs get row_min - 1, -inf only at pool padding
    labels: torch.Tensor  # [B, U] (0 = negative)
    log_weights: torch.Tensor  # [B, U], -inf where absent
    raw_scores: dict[str, torch.Tensor]
    lse_pos: torch.Tensor
    lse_neg: torch.Tensor
    max_sampling_id: torch.Tensor


def unique_pool(ids: torch.Tensor) -> torch.Tensor:
    """The unique non-negative values of `ids`, ascending, padded with -1 to
    `ids.numel()` entries: what `jnp.unique(size=U, fill_value=-1)` followed
    by moving the -1s to the back gives. Static shape, so the device is never
    waited on (`torch.unique` would wait to learn its output size)."""
    flat = torch.sort(ids.reshape(-1)).values
    u = flat.numel()
    first = torch.ones_like(flat, dtype=torch.bool)
    first[1:] = flat[1:] != flat[:-1]
    keep = first & (flat >= 0)
    slot = torch.where(keep, torch.cumsum(keep, 0) - 1, u)  # dropped values land in an extra slot
    pool = torch.full((u + 1,), -1, dtype=flat.dtype, device=flat.device)
    pool.scatter_(0, slot, torch.where(keep, flat, -1))
    return pool[:u]


def flatten_samples(samples: PrioritySampledSections) -> FlatSampledSections:
    """Flatten per-query samples into one pool of static width U = B * D."""
    indices = samples.batch.indices  # [B, D]
    b = indices.shape[0]
    pool = unique_pool(indices)
    pool_b = pool.unsqueeze(0).expand(b, -1)
    # (query, id) pairs the query did not retrieve gather as NaN; they are
    # filled with row_min - 1 so they stay live in-batch negatives. Only pool
    # padding (-1 ids) stays -inf.
    scores = fill_nans_with_min(gather_values_by_indices(pool_b, indices, samples.batch.scores))
    scores = torch.where(pool_b < 0, float("-inf"), scores)
    labels = gather_values_by_indices(pool_b, indices, samples.batch.labels, fill_value=0)
    labels = torch.where(pool_b < 0, 0, labels)
    log_w = gather_values_by_indices(pool_b, indices, samples.log_weights)
    log_w = torch.where(torch.isnan(log_w) | (pool_b < 0), float("-inf"), log_w)
    raw = {k: gather_values_by_indices(pool_b, indices, v) for k, v in samples.raw_scores.items()}
    return FlatSampledSections(
        pool_ids=pool,
        scores=scores,
        labels=labels,
        log_weights=log_w,
        raw_scores=raw,
        lse_pos=samples.lse_pos,
        lse_neg=samples.lse_neg,
        max_sampling_id=samples.max_sampling_id,
    )
