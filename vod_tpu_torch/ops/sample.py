"""Priority sampling: sampling without replacement by exponential races (port of
`vod_tpu/ops/sample.py`).

  log_p  = log_softmax(scores * temperature)
  keys_i = log_p_i - log(e_i),  e_i ~ Exp(1)
  S      = top-k by key;  log_tau = (k+1)-th key (or -inf if k >= n)
  q_i    = P(key_i > tau) = 1 - exp(-exp(log_p_i - log_tau))
  log_w  = log_p_i - log q_i                          # unbiased importance weights

The labeled variant samples positives (label > 0) and negatives independently,
drawing more positives when the finite negatives run short.

Random draws: the JAX version draws the Exp(1) noise inside each row from a
key split once per row (and, for the labeled variant, once more into
positives and negatives). Here every sampler takes that noise as an optional
argument, one `[..., n]` tensor per group, and otherwise draws it from the
`torch.Generator` it is given, on the scores' device. Fed the same noise, the
port gives the JAX version's samples. Rows are processed together as one
batch of tensor ops; nothing here waits for the device.

A rank of a data-parallel group passes `rows` = (block, blocks): it holds
block `block` of a global batch cut into `blocks` equal blocks, draws the
noise for the global batch and keeps its block's rows, so W ranks draw what
one process draws for the global batch, and their generators stay in step.
"""

from __future__ import annotations

import dataclasses
import typing as typ

import torch

from vod_tpu_torch.types.retrieval import RetrievalBatch
from .numpy_ops import masked_log_softmax, masked_logsumexp

# Finite "almost -inf": in-group entries always outrank out-of-group entries
# when keys are sorted, even when their scores are -inf.
_NEG_BIG_FRAC = 0.5


def _neg_big(dtype: torch.dtype) -> float:
    return -torch.finfo(dtype).max * _NEG_BIG_FRAC


def _log1mexp(neg_x: torch.Tensor) -> torch.Tensor:
    """Stable log(1 - exp(-x)) for x = exp(delta), given delta = log x."""
    x = torch.exp(neg_x)
    small = neg_x < -10.0
    safe = torch.log(torch.clamp(-torch.expm1(-x), min=torch.finfo(x.dtype).tiny))
    return torch.where(small, neg_x, safe)


def rows_of_global(draw: typ.Callable[[tuple[int, ...]], torch.Tensor], shape: typ.Sequence[int],
                   rows: typ.Optional[tuple[int, int]]) -> torch.Tensor:
    """`draw(shape)`, or with `rows` = (block, blocks) block `block` of
    `draw` at the global batch's shape (`blocks` x the leading axis)."""
    shape = tuple(int(s) for s in shape)
    if rows is None:
        return draw(shape)
    block, blocks = rows
    full = draw((shape[0] * blocks,) + shape[1:])
    return full[block * shape[0] : (block + 1) * shape[0]]


def exponential_noise(
    shape: typ.Sequence[int],
    *,
    like: torch.Tensor,
    generator: typ.Optional[torch.Generator],
    rows: typ.Optional[tuple[int, int]] = None,
) -> torch.Tensor:
    """Exp(1) draws of `shape` in the dtype and on the device of `like`
    (with `rows`: this block's rows of the global batch's draws)."""
    if generator is None:
        raise ValueError("priority sampling needs `noise` or a torch.Generator to draw it")
    return rows_of_global(
        lambda sh: torch.empty(sh, dtype=like.dtype, device=like.device).exponential_(generator=generator), shape, rows
    )


def _masked_priority_sample(
    scores: torch.Tensor,  # [B, n] unnormalized log p
    mask: torch.Tensor,  # [B, n] bool group membership
    k_out: int,  # static output width
    k_dyn: torch.Tensor,  # [B] number of samples to draw (<= k_out)
    temperature: float,
    max_support_size: int,
    noise: typ.Optional[torch.Tensor],  # [B, n] Exp(1)
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sample up to `k_dyn` elements of each row's masked group. Returns (local
    ids [B, k_out] int64, log_w [B, k_out], lse [B]). Entries at rank >=
    min(k_dyn, group size) are junk; callers mask them."""
    n = scores.shape[-1]
    dtype = scores.dtype
    neg_big = _neg_big(dtype)
    neg_inf = float("-inf")

    beta = temperature if temperature > 0 else 1.0
    log_p = torch.where(mask, scores * beta, neg_inf)
    log_p = torch.where(torch.isnan(log_p), neg_inf, log_p)

    if 0 < max_support_size < n:
        thresh = torch.sort(log_p, dim=-1, descending=True).values[..., max_support_size - 1 : max_support_size]
        log_p = torch.where(log_p >= thresh, log_p, neg_inf)

    lse = masked_logsumexp(scores * beta, mask)
    log_p = masked_log_softmax(log_p)

    keys = log_p - torch.log(noise) if temperature > 0 else log_p
    keys = torch.where(mask, torch.clamp(keys, min=neg_big), neg_inf)

    order = torch.argsort(-keys, dim=-1, stable=True)
    sorted_keys = torch.gather(keys, -1, order)
    padded = torch.cat([sorted_keys, torch.full_like(sorted_keys[..., :1], neg_inf)], dim=-1)
    tau_raw = torch.gather(padded, -1, torch.clamp(k_dyn, 0, n).long().unsqueeze(-1))
    log_tau = torch.where(tau_raw <= neg_big, neg_inf, tau_raw)

    ids = order[..., :k_out]
    log_pi = torch.gather(log_p, -1, ids)

    delta = log_pi - log_tau
    log_qz = _log1mexp(torch.where(torch.isfinite(delta), delta, 0.0))
    weighted = log_pi - log_qz
    log_w = torch.where(torch.isfinite(log_tau) & torch.isfinite(log_pi), weighted, log_pi)
    return ids, log_w, lse


def priority_sampling(
    scores: torch.Tensor,
    k: int,
    temperature: float = 1.0,
    max_support_size: int = -1,
    *,
    noise: typ.Optional[torch.Tensor] = None,
    generator: typ.Optional[torch.Generator] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Priority sampling from unnormalized log p, over [n] or [B, n] scores.
    Returns (ids [..., k] int64, log_weights [..., k]). `noise` holds the
    Exp(1) draws, shaped like `scores`; without it they come from `generator`."""
    squeeze = scores.ndim == 1
    s = scores.unsqueeze(0) if squeeze else scores
    b, n = s.shape
    if noise is not None and squeeze:
        noise = noise.unsqueeze(0)
    elif noise is None and temperature > 0:
        noise = exponential_noise(s.shape, like=s, generator=generator)
    mask = torch.ones_like(s, dtype=torch.bool)
    k_dyn = torch.full((b,), min(k, n), dtype=torch.int64, device=s.device)
    ids, log_w, _ = _masked_priority_sample(s, mask, k, k_dyn, temperature, max_support_size, noise)
    return (ids[0], log_w[0]) if squeeze else (ids, log_w)


def labeled_priority_sampling(
    scores: torch.Tensor,
    labels: torch.Tensor,
    k_positive: int = 1,
    k_total: int = 2,
    normalized: bool = True,
    temperature: float = 1.0,
    max_support_size: typ.Optional[int] = None,
    *,
    noise: typ.Optional[tuple[torch.Tensor, torch.Tensor]] = None,
    generator: typ.Optional[torch.Generator] = None,
    rows: typ.Optional[tuple[int, int]] = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-label priority sampling over [n] or [B, n] scores.

    Returns (local ids [..., k_total] int64 with -1 padding, log_weights,
    labels {0, 1} int32, lse [..., 2] of the positive and negative groups).
    Positives come first, then negatives, then padding. `noise` is the pair
    (positives' draws, negatives' draws), each shaped like `scores`;
    without it they come from `generator` (`rows`: see the module)."""
    mss = max_support_size or -1
    if mss >= 0:
        mss = max(mss, k_total)
    squeeze = scores.ndim == 1
    s = scores.unsqueeze(0) if squeeze else scores
    lab = labels.unsqueeze(0) if squeeze else labels
    b, n = s.shape
    dtype = s.dtype
    if noise is not None:
        noise_pos, noise_neg = (e.unsqueeze(0) for e in noise) if squeeze else noise
    elif temperature > 0:
        noise_pos, noise_neg = (exponential_noise(s.shape, like=s, generator=generator, rows=rows) for _ in range(2))
    else:
        noise_pos = noise_neg = None

    pos_mask = lab if lab.dtype == torch.bool else lab > 0
    neg_mask = ~pos_mask
    n_pos_total = pos_mask.sum(-1)
    n_neg_total = neg_mask.sum(-1)
    n_neg_finite = (neg_mask & torch.isfinite(s)).sum(-1)

    k_total_eff = min(k_total, n)
    # Rebalance: not enough finite negatives -> draw more positives.
    k_pos = torch.where(
        n_neg_finite < k_total_eff - k_positive, k_total_eff - n_neg_finite, torch.full_like(n_neg_finite, k_positive)
    )
    k_pos = torch.clamp(k_pos, 0, k_total_eff)
    n_pos_out = torch.minimum(k_pos, n_pos_total)
    k_neg = k_total_eff - n_pos_out

    ids_p, w_p, lse_p = _masked_priority_sample(s, pos_mask, k_total_eff, k_pos, temperature, mss, noise_pos)
    ids_n, w_n, lse_n = _masked_priority_sample(s, neg_mask, k_total_eff, k_neg, temperature, mss, noise_neg)

    ranks = torch.arange(k_total_eff, device=s.device)
    n_neg_out = torch.minimum(k_neg, n_neg_total)
    if normalized:
        # Self-normalize within each drawn group.
        w_p = masked_log_softmax(torch.where(ranks < n_pos_out[:, None], w_p, float("-inf")))
        w_n = masked_log_softmax(torch.where(ranks < n_neg_out[:, None], w_n, float("-inf")))

    # Assemble: positives first, then negatives, then padding.
    out_ranks = torch.arange(k_total, device=s.device).expand(b, k_total)
    is_pos_slot = out_ranks < n_pos_out[:, None]
    src = torch.where(is_pos_slot, out_ranks, out_ranks - n_pos_out[:, None])
    src = torch.clamp(src, 0, k_total_eff - 1)
    neg_valid_slot = ~is_pos_slot & (src < n_neg_out[:, None])

    def take(arr_p: torch.Tensor, arr_n: torch.Tensor) -> torch.Tensor:
        return torch.where(is_pos_slot, torch.gather(arr_p, -1, src), torch.gather(arr_n, -1, src))

    filled = is_pos_slot | neg_valid_slot
    samples = torch.where(filled, take(ids_p, ids_n), -1)
    log_w = torch.where(filled, take(w_p, w_n), float("-inf"))
    out_labels = torch.where(filled, is_pos_slot.to(torch.int32), 0)
    lse = torch.stack([lse_p, lse_n], dim=-1).to(dtype)
    if squeeze:
        return samples[0], log_w[0], out_labels[0], lse[0]
    return samples, log_w, out_labels, lse


@dataclasses.dataclass
class PrioritySampledSections:
    """Samples plus importance weights, lse constants and diagnostics."""

    batch: RetrievalBatch
    log_weights: torch.Tensor
    max_sampling_id: torch.Tensor
    lse_pos: torch.Tensor
    lse_neg: torch.Tensor
    raw_scores: dict[str, torch.Tensor]


def sample_search_results(
    *,
    search_results: RetrievalBatch,
    raw_scores: dict[str, torch.Tensor],
    total: typ.Optional[int],
    max_pos_sections: typ.Optional[int],
    temperature: float = 1.0,
    max_support_size: typ.Optional[int] = None,
    noise: typ.Optional[tuple[torch.Tensor, torch.Tensor]] = None,
    generator: typ.Optional[torch.Generator] = None,
    rows: typ.Optional[tuple[int, int]] = None,
) -> PrioritySampledSections:
    """Sample positive/negative sections by per-label priority sampling, gather
    their ids, scores and raw engine scores, and compute the `max_sampling_id`
    sampling-depth diagnostic: the number of candidate negatives that score at
    least as high as the lowest sampled negative."""
    total = total or search_results.scores.shape[-1]
    max_pos_sections = max_pos_sections or total
    sr_scores = search_results.scores
    labels_ref = (
        torch.zeros(sr_scores.shape, dtype=torch.bool, device=sr_scores.device)
        if search_results.labels is None
        else search_results.labels > 0
    )
    local_ids, log_weights, labels, constants = labeled_priority_sampling(
        sr_scores, labels_ref, k_positive=max_pos_sections, k_total=total, normalized=True,
        temperature=temperature, max_support_size=max_support_size, noise=noise, generator=generator, rows=rows,
    )

    safe_ids = torch.clamp(local_ids, 0, sr_scores.shape[-1] - 1)
    pad = local_ids < 0
    indices = torch.where(pad, -1, torch.gather(search_results.indices, -1, safe_ids))
    scores = torch.where(pad, float("-inf"), torch.gather(sr_scores, -1, safe_ids))
    sampled_raw = {
        key: torch.where(pad, float("nan"), torch.gather(v, -1, safe_ids)) for key, v in raw_scores.items()
    }

    min_neg_score = torch.amin(
        torch.where((labels <= 0) & torch.isfinite(scores), scores, float("inf")), dim=-1, keepdim=True
    )
    larger = ~labels_ref & torch.isfinite(sr_scores) & (sr_scores >= min_neg_score)
    max_sampling_id = larger.to(torch.float32).sum(-1)

    return PrioritySampledSections(
        batch=RetrievalBatch(indices=indices, scores=scores, labels=labels),
        max_sampling_id=max_sampling_id,
        lse_pos=constants[..., 0],
        lse_neg=constants[..., 1],
        log_weights=log_weights,
        raw_scores=sampled_raw,
    )
