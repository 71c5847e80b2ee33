"""Dataset loading interface (the port's copy of `vod_tpu/data/interface.py`):
load (a loader callable, or `beir`) -> rosetta transform -> postprocess
(subsampling, sectioning). Shards are lists of row dicts.

Declared differences from the JAX package, which has HF `datasets`:
 - `name_or_path: beir` (the name the repo's configs use) loads through
   `BeirDatasetLoader` with the shard's `subsets` (a BeIR-format directory)
   and `split`; any other name is a hub dataset and raises the zero-egress
   `RuntimeError`;
 - subsampling draws `np.random.default_rng(seed).permutation(n)`, the
   permutation HF's `Dataset.shuffle(seed)` draws, so the same rows are kept
   in the same order.
"""

from __future__ import annotations

import typing as typ

import numpy as np

from vod_tpu_torch.configs.datasets import BaseDatasetConfig, QueriesDatasetConfig, SectionsDatasetConfig
from .rosetta.adapters import transform


def _raw_load(cfg: BaseDatasetConfig, kind: str) -> list[dict]:
    src = cfg.name_or_path
    if callable(src):
        return src(subsets=cfg.subsets or None, split=cfg.split)
    if src == "beir":
        from .loaders.beir import BeirDatasetLoader

        return BeirDatasetLoader(kind)(subsets=cfg.subsets or None, split=cfg.split)
    raise RuntimeError(
        f"dataset {src!r} of shard {cfg.identifier!r} would come from the HF hub, which is not available "
        "(zero-egress environment, no `datasets` package); use `name_or_path: beir` with a BeIR-format "
        "directory in `subsets`, or pass a loader callable"
    )


def _postprocess(rows: list, cfg: BaseDatasetConfig, kind: str) -> list:
    opts = cfg.options
    if opts.subset_size is not None and len(rows) > opts.subset_size:
        order = np.random.default_rng(opts.seed).permutation(len(rows))[: opts.subset_size]
        rows = [rows[i] for i in order]
    if kind == "sections" and opts.sectioning:
        from .postprocessing import extract_sections

        rows = extract_sections(rows, opts.sectioning)
    return rows


def load_queries(cfg: QueriesDatasetConfig) -> list[dict]:
    """Load + adapt a queries shard."""
    out = transform(_raw_load(cfg, "queries"), "queries")
    if isinstance(out, tuple):  # queries-with-context got isolated
        out = out[0]
    return _postprocess(out, cfg, "queries")


def load_sections(cfg: SectionsDatasetConfig) -> list[dict]:
    """Load + adapt a sections shard."""
    return _postprocess(transform(_raw_load(cfg, "sections"), "sections"), cfg, "sections")


def load_dataset(cfg: BaseDatasetConfig) -> list[dict]:
    """Auto-detect the kind."""
    if isinstance(cfg, QueriesDatasetConfig):
        return load_queries(cfg)
    if isinstance(cfg, SectionsDatasetConfig):
        return load_sections(cfg)
    raise TypeError(f"Unknown dataset config type: {type(cfg)}")
