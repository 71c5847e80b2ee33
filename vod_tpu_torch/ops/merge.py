"""Weighted union-merge of per-engine search results (port of `vod_tpu/ops/merge.py`).

The score of a section id is the weighted sum of the scores of every engine
that returned it. Per-engine raw scores come back aligned to the merged ids
(NaN where an engine did not return the id), and labels from whichever engine
carries them (fill -1). Duplicates are collapsed with one stable sort by id
and shifted compares; the output width is the sum of the input widths.
"""

from __future__ import annotations

import typing as typ

import torch

from vod_tpu_torch.types.retrieval import PAD_INDEX, RetrievalBatch

_SENTINEL = torch.iinfo(torch.int32).max


def _shift_left(x: torch.Tensor, d: int, fill: typ.Any) -> torch.Tensor:
    pad = torch.full(x.shape[:-1] + (d,), fill, dtype=x.dtype, device=x.device)
    return torch.cat([x[..., d:], pad], dim=-1)


def merge_search_results(
    search_results: dict[str, RetrievalBatch],
    weights: typ.Optional[dict[str, torch.Tensor | float]] = None,
) -> tuple[RetrievalBatch, dict[str, torch.Tensor]]:
    """Merge engine results by weighted score sum over shared ids.

    Returns (merged RetrievalBatch [B, sum K_e] sorted by descending score,
    per-engine raw scores aligned to the merged ids, NaN where absent).
    """
    names = list(search_results.keys())
    if weights is None:
        weights = {k: 1.0 for k in names}
    missing = set(names) - set(weights)
    if missing:
        raise ValueError(f"Missing weights for engines: {missing}")

    k_tot = sum(int(search_results[n].scores.shape[-1]) for n in names)
    f32 = search_results[names[0]].scores.dtype

    ids = torch.cat([search_results[n].indices.to(torch.int32) for n in names], dim=-1)
    wscores = []
    raw_channels: dict[str, list[torch.Tensor]] = {n: [] for n in names}
    labels_parts = []
    for n in names:
        r = search_results[n]
        finite = torch.isfinite(r.scores)
        wscores.append(torch.where(finite, r.scores * weights[n], float("-inf")))
        for m in names:
            if m == n:
                raw_channels[m].append(r.scores)
            else:
                raw_channels[m].append(torch.full_like(r.scores, float("nan"), dtype=f32))
        if r.labels is not None:
            labels_parts.append(r.labels.to(torch.int32))
        else:
            labels_parts.append(torch.full_like(r.indices, -1, dtype=torch.int32))
    wscores = torch.cat(wscores, dim=-1)
    raws = {n: torch.cat(parts, dim=-1) for n, parts in raw_channels.items()}
    labels = torch.cat(labels_parts, dim=-1)
    any_labels = any(search_results[n].labels is not None for n in names)

    # Stable sort by id (padding ids -> sentinel, pushed last).
    sort_ids = torch.where(ids < 0, _SENTINEL, ids)
    order = torch.argsort(sort_ids, dim=-1, stable=True)
    sid = torch.gather(sort_ids, -1, order)
    ws_s = torch.gather(wscores, -1, order)
    raw_s = {n: torch.gather(v, -1, order) for n, v in raws.items()}
    lab_s = torch.gather(labels, -1, order)

    # Duplicates of an id are now adjacent; an id appears at most len(names)
    # times (once per engine), so a fixed number of shifted compares collapses them.
    first = torch.cat(
        [torch.ones_like(sid[..., :1], dtype=torch.bool), sid[..., 1:] != sid[..., :-1]], dim=-1
    )
    has_finite = torch.isfinite(ws_s)
    contrib = torch.where(has_finite, ws_s, torch.zeros_like(ws_s))
    merged = contrib
    merged_has = has_finite
    lab_merged = lab_s
    raw_merged = dict(raw_s)
    for d in range(1, len(names)):
        same = (_shift_left(sid, d, _SENTINEL - 1) == sid) & (sid != _SENTINEL)
        merged = merged + torch.where(same, _shift_left(contrib, d, 0.0), 0.0)
        merged_has = merged_has | (same & _shift_left(has_finite, d, False))
        lab_merged = torch.maximum(lab_merged, torch.where(same, _shift_left(lab_s, d, -1), -1))
        for n in names:
            shifted = _shift_left(raw_s[n], d, float("nan"))
            take = same & torch.isnan(raw_merged[n]) & ~torch.isnan(shifted)
            raw_merged[n] = torch.where(take, shifted, raw_merged[n])

    valid = first & (sid != _SENTINEL)
    out_scores = torch.where(valid & merged_has, merged, float("-inf"))
    out_ids = torch.where(valid, sid, PAD_INDEX).to(torch.int32)
    out_labels = torch.where(valid, lab_merged, -1)
    out_raws = {n: torch.where(valid, raw_merged[n], float("nan")) for n in names}

    # Compact: descending score puts real entries first, padding last.
    final_order = torch.argsort(-out_scores, dim=-1, stable=True)
    out = RetrievalBatch(
        scores=torch.gather(out_scores, -1, final_order),
        indices=torch.gather(out_ids, -1, final_order),
        labels=torch.gather(out_labels, -1, final_order) if any_labels else None,
    )
    out_raws = {n: torch.gather(v, -1, final_order) for n, v in out_raws.items()}
    assert out.scores.shape[-1] == k_tot
    return out, out_raws
