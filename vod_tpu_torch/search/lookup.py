"""Lookup engine: return gold sections by explicit row id (port of `vod_tpu/search/lookup.py`).

Section-id hashes are resolved to global row ids on the host, so lookup is an
identity: the ids come back with score 0 and label 1; padding gets -inf / -1.
"""

from __future__ import annotations

import torch

from vod_tpu_torch.types.retrieval import RetrievalBatch
from .base import SearchQueries


def lookup_search(queries: SearchQueries, top_k: int | None = None) -> RetrievalBatch:
    """Return the queries' gold `section_ids` as results with score 0 / label 1."""
    ids = queries.section_ids
    if ids is None:
        raise ValueError("lookup_search requires queries.section_ids")
    if top_k is not None and top_k < ids.shape[-1]:
        ids = ids[..., :top_k]
    valid = ids >= 0
    zero = torch.zeros(ids.shape, dtype=torch.float32, device=ids.device)
    scores = torch.where(valid, zero, float("-inf"))
    labels = torch.where(valid, 1, -1).to(torch.int32)
    return RetrievalBatch(scores=scores, indices=ids.to(torch.int32), labels=labels)
