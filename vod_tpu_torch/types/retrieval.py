"""Retrieval result containers (port of `vod_tpu/types/retrieval.py`).

A `RetrievalBatch` is a rectangle of `(scores, indices, labels)` with the
padding contract `indices = -1`, `scores = -inf`, `labels = -1`. Every
constructor takes an explicit width and masks instead of re-padding, as the
JAX version does.
"""

from __future__ import annotations

import dataclasses
import typing as typ

import numpy as np
import torch

from vod_tpu_torch.ops.numpy_ops import topk_lowest_first

PAD_INDEX: int = -1
PAD_SCORE: float = -np.inf
PAD_LABEL: int = -1


@dataclasses.dataclass
class RetrievalBatch:
    """A batch of retrieval results: `[..., k]` scores/indices (+ optional labels).

    Fields hold torch tensors on the device, or numpy arrays once they have
    crossed the wire (`to_numpy`, `SearchHttpClient`)."""

    scores: typ.Any  # float [..., k], padding = -inf
    indices: typ.Any  # int32 [..., k], padding = -1
    labels: typ.Any = None  # int32 [..., k], padding = -1
    meta: dict = dataclasses.field(default_factory=dict)

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(self.scores.shape)

    def replace(self, **changes: typ.Any) -> "RetrievalBatch":
        return dataclasses.replace(self, **changes)

    def __mul__(self, weight: float | torch.Tensor) -> "RetrievalBatch":
        """Scale finite scores by `weight`; padding stays -inf (also for a zero
        weight, where a plain product would give `-inf * 0 = nan`)."""
        scaled = torch.where(torch.isfinite(self.scores), self.scores * weight, self.scores)
        return self.replace(scores=scaled)

    def __add__(self, other: "RetrievalBatch") -> "RetrievalBatch":
        """Union-merge with another batch, summing scores of shared ids."""
        from vod_tpu_torch.ops.merge import merge_search_results

        merged, _ = merge_search_results({"a": self, "b": other})
        return merged

    def sorted(self) -> "RetrievalBatch":
        """Sort by descending score (padding last, ties keep their order)."""
        order = torch.argsort(-self.scores, dim=-1, stable=True)
        return self._permute(order)

    def topk(self, k: int) -> "RetrievalBatch":
        """Keep the top-k entries by score, lowest position first on ties."""
        scores, pos = topk_lowest_first(self.scores, k)
        indices = torch.gather(self.indices, -1, pos)
        labels = None if self.labels is None else torch.gather(self.labels, -1, pos)
        return RetrievalBatch(scores=scores, indices=indices, labels=labels, meta=self.meta)

    def _permute(self, order: torch.Tensor) -> "RetrievalBatch":
        scores = torch.gather(self.scores, -1, order)
        indices = torch.gather(self.indices, -1, order)
        labels = None if self.labels is None else torch.gather(self.labels, -1, order)
        return RetrievalBatch(scores=scores, indices=indices, labels=labels, meta=self.meta)

    def to_numpy(self) -> "RetrievalBatch":
        def conv(x: typ.Any) -> typ.Any:
            return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

        return RetrievalBatch(
            scores=conv(self.scores),
            indices=conv(self.indices),
            labels=None if self.labels is None else conv(self.labels),
            meta=self.meta,
        )


def stack_samples(samples: typ.Sequence[RetrievalBatch], k: int | None = None) -> RetrievalBatch:
    """Stack 1-d retrieval samples into a rectangular numpy batch of width `k`
    (`k or max_len`); rows are truncated or padded to it. Host-side utility."""
    if k is None:
        k = max(int(s.scores.shape[-1]) for s in samples)
    n = len(samples)
    any_labels = any(s.labels is not None for s in samples)
    scores = np.full((n, k), PAD_SCORE, dtype=np.float32)
    indices = np.full((n, k), PAD_INDEX, dtype=np.int32)
    labels = np.full((n, k), PAD_LABEL, dtype=np.int32) if any_labels else None
    for i, s in enumerate(samples):
        s = s.to_numpy()
        w = min(k, int(s.scores.shape[-1]))
        scores[i, :w] = s.scores[:w]
        indices[i, :w] = s.indices[:w]
        if labels is not None and s.labels is not None:
            labels[i, :w] = s.labels[:w]
    return RetrievalBatch(scores=scores, indices=indices, labels=labels)
