"""RealmDataloader: iterate query shards as `QueryBatch`es on the device (the
port's copy of `vod_tpu/dataloaders/realm_dataloader.py`).

The host shuffles or samples rows with numpy's `default_rng(seed)` (so the
batches are the JAX package's, row for row), tokenizes the queries, analyzes
their BM25 terms and resolves gold, section and subset ids to integer rows.
The batch's arrays are then packed into one pinned host buffer and copied to
the device once, without waiting (`non_blocking`): the step that reads the
batch is queued behind the copy on the same stream, and nothing synchronizes.
`runtime.train.training_loop` pulls batches through `prefetch_iterator`, so
the next batch is tokenized while the card runs the current step.

Declared difference: a batch in which no query restricts its subsets
carries `subset_ids=None`, where the JAX loader carries an all -1 array.
With no restriction the filtered scan and the unfiltered search give the
same answer, but the array sends `dense_search` to the filtered scan in
JAX, so an index built with `kernel: fused` never reaches
`fused_mips_binned` from the JAX CLI; here it does, as the config asks.
"""

from __future__ import annotations

import typing as typ

import numpy as np
import torch

from vod_tpu_torch.configs.dataloaders import DataLoaderConfig, TemplatesConfig
from vod_tpu_torch.runtime.collate import QueryBatch
from .samplers import dl_sampler_factory

_FIELDS = ("input_ids", "attention_mask", "section_ids", "subset_ids", "terms", "shard", "answer_ids", "answer_mask")


def to_device(arrays: typ.Mapping[str, typ.Optional[np.ndarray]], device: torch.device) -> dict[str, torch.Tensor]:
    """The int32 host arrays on `device`: one pinned buffer, one copy."""
    present = {k: np.ascontiguousarray(v, dtype=np.int32) for k, v in arrays.items() if v is not None}
    flat = torch.from_numpy(np.concatenate([v.reshape(-1) for v in present.values()]))
    if device.type == "cuda":
        flat = flat.pin_memory().to(device, non_blocking=True)
    out, start = {}, 0
    for k, v in present.items():
        out[k] = flat[start : start + v.size].view(v.shape)
        start += v.size
    return out


class RealmDataloader:
    """Yields `QueryBatch`es on `device` (default "cuda") from one or more
    canonical query shards."""

    def __init__(
        self,
        queries: typ.Sequence[typ.Mapping[str, typ.Any]],
        tokenizer: typ.Any,
        *,
        config: typ.Optional[DataLoaderConfig] = None,
        templates: typ.Optional[TemplatesConfig] = None,
        id_map: typ.Optional[dict[str, int]] = None,
        subset_id_map: typ.Optional[dict[str, int]] = None,
        shard_map: typ.Optional[dict[str, int]] = None,  # linked-shard name -> shard idx
        max_length: int = 200,
        answer_max_length: int = 64,
        max_gold: int = 4,
        max_subsets: int = 4,
        with_answers: bool = False,
        with_sparse_terms: bool = False,
        sparse_vocab_size: int = 1 << 18,
        sparse_language: str | None = None,
        sparse_stem: bool = False,
        device: typ.Union[str, torch.device] = "cuda",
    ):
        self.rows = list(queries)
        self.tokenizer = tokenizer
        self.config = config or DataLoaderConfig()
        self.templates = templates or TemplatesConfig()
        self.id_map = id_map
        self.subset_id_map = subset_id_map
        self.shard_map = shard_map
        self.max_length = max_length
        self.answer_max_length = answer_max_length
        self.max_gold = max_gold
        self.max_subsets = max_subsets
        self.with_answers = with_answers
        self.with_sparse_terms = with_sparse_terms
        self.sparse_vocab_size = sparse_vocab_size
        self.sparse_language = sparse_language
        self.sparse_stem = sparse_stem
        self.device = torch.device(device)
        self._probs = None
        if self.config.sampler is not None:
            self._probs = dl_sampler_factory(self.config.sampler)(self.rows)

    def __len__(self) -> int:
        return len(self.rows) // self.config.batch_size

    def _order(self, rng: np.random.Generator) -> np.ndarray:
        n = len(self.rows)
        if self._probs is not None:
            return rng.choice(n, size=n, replace=True, p=self._probs)
        if self.config.shuffle:
            return rng.permutation(n)
        return np.arange(n)

    def host_batch(self, idx: typ.Sequence[int]) -> dict[str, typ.Optional[np.ndarray]]:
        """The batch of rows `idx` as int32 host arrays (None where absent)."""
        from vod_tpu_torch.data.corpus import tokenize_queries

        rows = [self.rows[i] for i in idx]
        enc = tokenize_queries(
            rows,
            self.tokenizer,
            max_length=self.max_length,
            answer_max_length=self.answer_max_length,
            templates=self.templates,
            id_map=self.id_map,
            subset_id_map=self.subset_id_map,
            max_gold=self.max_gold,
            max_subsets=self.max_subsets,
            with_answers=self.with_answers,
            with_sparse_terms=self.with_sparse_terms,
            sparse_vocab_size=self.sparse_vocab_size,
            sparse_language=self.sparse_language,
            sparse_stem=self.sparse_stem,
        )
        shard = None
        if self.shard_map is not None:
            shard = np.asarray(
                [self.shard_map.get(str(r.get("__LINKED_SHARD__", "")), -1) for r in rows], dtype=np.int32
            )
        out = {k: (shard if k == "shard" else enc.get(k)) for k in _FIELDS}
        if (out["subset_ids"] < 0).all():
            out["subset_ids"] = None  # no query restricts its subsets
        return out

    def _make_batch(self, idx: typ.Sequence[int]) -> QueryBatch:
        return QueryBatch(**to_device(self.host_batch(idx), self.device))

    def epoch(self, seed: int = 0) -> typ.Iterator[QueryBatch]:
        """One epoch of batches (drop_last semantics)."""
        rng = np.random.default_rng(seed)
        order = self._order(rng)
        bs = self.config.batch_size
        n_full = len(order) // bs
        for i in range(n_full):
            yield self._make_batch(order[i * bs : (i + 1) * bs])

    def forever(self, seed: int = 0) -> typ.Iterator[QueryBatch]:
        """Infinite stream cycling epochs with fresh shuffles. Raises
        `ValueError` when an epoch holds no batch (the JAX loader spins)."""
        if len(self) == 0:
            raise ValueError(f"{len(self.rows)} query rows make no batch of {self.config.batch_size}")
        e = 0
        while True:
            yield from self.epoch(seed + e)
            e += 1
