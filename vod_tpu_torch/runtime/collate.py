"""Device-side collate: from sampled section ids to a full `RealmBatch`, on the
card (port of `vod_tpu/runtime/collate.py`).

The tokenized corpus is resident in device memory (`DeviceCorpus`), so
"fetch section content + render the template + tokenize" is a set of device
gathers and concatenations: `[context; question; answer]` token segments with
token_type_ids 0/1/2. The collate runs search -> merge -> sample -> gather
with no host round-trip.

Random draws: `device_collate` takes a `torch.Generator` on the card. It
draws the sampler's Exp(1) noise first (unless `noise` is given), then the
random real sections that padding slots fetch. The JAX version draws those
from two keys split off the step's key, so its padding slots fetch other
sections; their scores are -inf either way, so they never contribute.

Data parallel: a rank that holds block `rows` = (block, blocks) of a global
batch draws the noise and the padding sections for the global batch and
keeps its block, so W ranks draw what one process draws for it
(`ops/sample.py`); `batch_axis` names the mesh axis the rows are split over,
for the sharded engines. In-batch negatives pool the unique sections of the
global batch, as JAX's global collate does: the ranks gather their sampled
ids, scores, labels and log-weights over `group` (the axis's process group),
every rank flattens the same pool and fills its padding with the same draws
(the pool's width is the global batch's), and each keeps the pool's
channels for its own query rows, so every rank scores its queries against
the whole pool.
"""

from __future__ import annotations

import dataclasses
import typing as typ

import torch

from vod_tpu_torch.ops.in_batch_negatives import flatten_samples
from vod_tpu_torch.ops.numpy_ops import replace_negative_indices
from vod_tpu_torch.ops.sample import PrioritySampledSections
from vod_tpu_torch.parallel.distributed import all_gather_tensor
from vod_tpu_torch.search.base import SearchQueries
from vod_tpu_torch.search.hybrid import HybridEngines, hybrid_search_and_sample
from vod_tpu_torch.types.batch import RealmBatch
from vod_tpu_torch.types.retrieval import RetrievalBatch


@dataclasses.dataclass
class DeviceCorpus:
    """Tokenized sections resident in device memory."""

    input_ids: torch.Tensor  # [N, Ls] int
    attention_mask: torch.Tensor  # [N, Ls] int
    subset_ids: typ.Optional[torch.Tensor] = None  # [N] int32

    @property
    def size(self) -> int:
        return int(self.input_ids.shape[0])


@dataclasses.dataclass
class QueryBatch:
    """Tokenized query-side batch (one per training step)."""

    input_ids: torch.Tensor  # [B, Lq]
    attention_mask: torch.Tensor  # [B, Lq]
    section_ids: typ.Optional[torch.Tensor] = None  # [B, G] gold ids
    subset_ids: typ.Optional[torch.Tensor] = None  # [B, S]
    terms: typ.Optional[torch.Tensor] = None  # [B, L] sparse query terms
    term_weights: typ.Optional[torch.Tensor] = None
    shard: typ.Optional[torch.Tensor] = None
    answer_ids: typ.Optional[torch.Tensor] = None  # [B, La] tokenized answer (for the reader)
    answer_mask: typ.Optional[torch.Tensor] = None


def build_device_corpus(
    input_ids: typ.Any,
    attention_mask: typ.Any,
    subset_ids: typ.Any = None,
    *,
    device: typ.Union[str, torch.device] = "cuda",
) -> DeviceCorpus:
    """Place a tokenized corpus (arrays or tensors) on `device`."""
    as_dev = lambda x: None if x is None else torch.as_tensor(x, device=device)  # noqa: E731
    return DeviceCorpus(as_dev(input_ids), as_dev(attention_mask), as_dev(subset_ids))


def build_lm_inputs(
    section_ids: torch.Tensor,  # [B, D, Ls]
    section_mask: torch.Tensor,
    query_ids: torch.Tensor,  # [B, Lq]
    query_mask: torch.Tensor,
    answer_ids: typ.Optional[torch.Tensor],  # [B, La]
    answer_mask: typ.Optional[torch.Tensor],
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Concatenate [context; question; answer] token segments per (query, section).

    Returns (input_ids [B, D, L], attention_mask, token_type_ids with 0/1/2 =
    context/question/answer, 0 at padding)."""
    b, d, _ = section_ids.shape
    q = query_ids[:, None, :].expand(b, d, -1)
    qm = query_mask[:, None, :].expand(b, d, -1)
    parts_ids = [section_ids, q]
    parts_mask = [section_mask, qm]
    parts_tt = [torch.zeros_like(section_mask), torch.ones_like(qm)]
    if answer_ids is not None:
        parts_ids.append(answer_ids[:, None, :].expand(b, d, -1))
        am = answer_mask[:, None, :].expand(b, d, -1)
        parts_mask.append(am)
        parts_tt.append(torch.full_like(am, 2))
    ids = torch.cat(parts_ids, dim=-1)
    mask = torch.cat(parts_mask, dim=-1)
    tt = torch.cat(parts_tt, dim=-1)
    return ids, mask * (ids >= 0), torch.where(mask > 0, tt, 0)


def _global_samples(sampled: PrioritySampledSections, group: typ.Any) -> PrioritySampledSections:
    """The global batch's samples from every rank's rows (rank order)."""

    def rows(x: torch.Tensor) -> torch.Tensor:
        every = all_gather_tensor(x.contiguous(), group)
        return every.reshape((-1,) + tuple(x.shape[1:]))

    b = sampled.batch
    return PrioritySampledSections(
        batch=RetrievalBatch(scores=rows(b.scores), indices=rows(b.indices),
                             labels=None if b.labels is None else rows(b.labels)),
        log_weights=rows(sampled.log_weights), max_sampling_id=rows(sampled.max_sampling_id),
        lse_pos=rows(sampled.lse_pos), lse_neg=rows(sampled.lse_neg),
        raw_scores={k: rows(v) for k, v in sampled.raw_scores.items()},
    )


def device_collate(
    engines: HybridEngines,
    corpus: DeviceCorpus,
    queries: QueryBatch,
    *,
    generator: torch.Generator,
    query_vectors: typ.Optional[torch.Tensor] = None,
    prefetch: int = 100,
    n_sections: int = 8,
    max_pos_sections: int = 2,
    temperature: float = 1.0,
    max_support_size: typ.Optional[int] = None,
    weights: typ.Optional[dict[str, torch.Tensor | float]] = None,
    with_lm: bool = False,
    in_batch_negatives: bool = False,
    noise: typ.Optional[tuple[torch.Tensor, torch.Tensor]] = None,
    rows: typ.Optional[tuple[int, int]] = None,
    batch_axis: typ.Optional[str] = None,
    group: typ.Any = None,
) -> tuple[RealmBatch, PrioritySampledSections]:
    """search -> merge -> sample -> gather section tokens -> RealmBatch.

    `noise` is the sampler's Exp(1) draws (positives', negatives'), each
    `[B, min(prefetch, merged width)]`; without it they come from `generator`.
    `rows`, `batch_axis` and `group` (the process group of the axis `rows`
    splits, which in-batch negatives gather over): see the module."""
    if in_batch_negatives and rows is not None and group is None:
        raise ValueError("in-batch negatives over a data-parallel batch need the axis's process group (group=)")
    sq = SearchQueries(
        vector=query_vectors,
        terms=queries.terms,
        term_weights=queries.term_weights,
        subset_ids=queries.subset_ids,
        section_ids=queries.section_ids,
        shard=queries.shard,
    )
    sampled, _merged = hybrid_search_and_sample(
        engines, sq, prefetch=prefetch, total=n_sections, max_pos_sections=max_pos_sections,
        temperature=temperature, max_support_size=max_support_size, weights=weights,
        noise=noise, generator=generator, batch_axis=batch_axis, rows=rows,
    )
    b = int(queries.input_ids.shape[0])
    if in_batch_negatives:
        # one shared pool of the global batch's unique sections; every query
        # scores against all of it
        flat = flatten_samples(sampled if rows is None else _global_samples(sampled, group))
        if rows is not None:  # this rank's query rows of the per-query channels
            mine = slice(rows[0] * b, (rows[0] + 1) * b)
            flat = dataclasses.replace(
                flat, scores=flat.scores[mine], labels=flat.labels[mine], log_weights=flat.log_weights[mine],
                raw_scores={k: v[mine] for k, v in flat.raw_scores.items()}, lse_pos=flat.lse_pos[mine],
                lse_neg=flat.lse_neg[mine], max_sampling_id=flat.max_sampling_id[mine],
            )
        pool_idx = replace_negative_indices(flat.pool_ids, corpus.size, generator)  # [U]
        sec_ids = corpus.input_ids[pool_idx.long()]  # [U, Ls]
        sec_mask = corpus.attention_mask[pool_idx.long()]
        u = int(pool_idx.shape[0])
        nan = torch.full((b, u), float("nan"), dtype=torch.float32, device=sec_ids.device)
        kw: dict[str, typ.Any] = {}
        if with_lm:
            lm_ids, lm_mask, lm_tt = build_lm_inputs(
                sec_ids[None].expand(b, -1, -1), sec_mask[None].expand(b, -1, -1),
                queries.input_ids, queries.attention_mask, queries.answer_ids, queries.answer_mask,
            )
            kw = {"lm__input_ids": lm_ids, "lm__attention_mask": lm_mask, "lm__token_type_ids": lm_tt}
        batch = RealmBatch(
            query__input_ids=queries.input_ids,
            query__attention_mask=queries.attention_mask,
            section__input_ids=sec_ids,
            section__attention_mask=sec_mask,
            section__relevance=torch.clamp(flat.labels, min=0).to(torch.float32),
            section__idx=pool_idx[None].expand(b, -1),
            section__score=flat.scores,
            section__sparse=flat.raw_scores.get("sparse", nan),
            section__dense=flat.raw_scores.get("dense", nan),
            section__log_weight=flat.log_weights,
            section__lse_pos=flat.lse_pos,
            section__lse_neg=flat.lse_neg,
            extras={"flat_sections": True},
            **kw,
        )
        return batch, sampled

    # padding slots fetch a random real section; their scores stay -inf so
    # they never contribute
    flat_idx = replace_negative_indices(sampled.batch.indices, corpus.size, generator, rows)
    sec_ids = corpus.input_ids[flat_idx.long()]  # [B, D, Ls]
    sec_mask = corpus.attention_mask[flat_idx.long()]
    d = int(flat_idx.shape[1])
    raw = sampled.raw_scores
    nan = torch.full((b, d), float("nan"), dtype=torch.float32, device=sec_ids.device)
    kw = {}
    if with_lm:
        lm_ids, lm_mask, lm_tt = build_lm_inputs(
            sec_ids, sec_mask, queries.input_ids, queries.attention_mask, queries.answer_ids, queries.answer_mask,
        )
        kw = {"lm__input_ids": lm_ids, "lm__attention_mask": lm_mask, "lm__token_type_ids": lm_tt}
    batch = RealmBatch(
        query__input_ids=queries.input_ids,
        query__attention_mask=queries.attention_mask,
        section__input_ids=sec_ids.reshape(b * d, -1),
        section__attention_mask=sec_mask.reshape(b * d, -1),
        section__relevance=torch.clamp(sampled.batch.labels, min=0).to(torch.float32),
        section__idx=flat_idx,
        section__score=sampled.batch.scores,
        section__sparse=raw.get("sparse", nan),
        section__dense=raw.get("dense", nan),
        section__log_weight=sampled.log_weights,
        section__lse_pos=sampled.lse_pos,
        section__lse_neg=sampled.lse_neg,
        **kw,
    )
    return batch, sampled
