"""Search API surface (port of `vod_tpu/search/base.py`).

Engines are pure functions of (index, SearchQueries, top_k). String inputs are
resolved to integer ids on the host; on the device everything is int32.
"""

from __future__ import annotations

import dataclasses
import typing as typ

import torch


@dataclasses.dataclass
class SearchQueries:
    """Query batch for any engine combination; engines consume what they need.

      vector      [B, D]  dense query embeddings
      terms       [B, L]  int32 query term ids (sparse engine), -1 = padding
      term_weights[B, L]  per-term query weights
      subset_ids  [B, S]  allowed corpus subset ids per query, -1 = padding
      section_ids [B, G]  gold section row-ids for the lookup engine, -1 = padding
      shard       [B]     target shard per query (multi-corpus sharding)
    """

    vector: typ.Optional[torch.Tensor] = None
    terms: typ.Optional[torch.Tensor] = None
    term_weights: typ.Optional[torch.Tensor] = None
    subset_ids: typ.Optional[torch.Tensor] = None
    section_ids: typ.Optional[torch.Tensor] = None
    shard: typ.Optional[torch.Tensor] = None


def subset_mask(
    corpus_subset_ids: torch.Tensor,  # [N] int32, -1 = no subset
    allowed: typ.Optional[torch.Tensor],  # [B, S] int32, -1 = padding
) -> typ.Optional[torch.Tensor]:
    """[B, N] bool — True where the corpus row's subset is allowed for the query.
    A query with no allowed subsets (all -1) matches everything."""
    if allowed is None:
        return None
    match = corpus_subset_ids[None, None, :] == allowed[:, :, None]  # [B, S, N]
    any_match = match.any(dim=1)
    no_filter = (allowed < 0).all(dim=-1, keepdim=True)
    return any_match | no_filter
