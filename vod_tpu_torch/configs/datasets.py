"""Dataset configs (the port's copy of `vod_tpu/configs/datasets.py`): a
shard's identifier, its source (a path or name, or a loader callable), subsets,
split, loading options and content fingerprint; query shards link to a
section shard, section shards carry a search diff."""

from __future__ import annotations

import dataclasses
import typing as typ

from .base import StrictModel

TARGET_SHARD_KEY = "__LINKED_SHARD__"


class DatasetOptionsConfig(StrictModel):
    """Loading options (subset sampling, sectioning)."""

    subset_size: typ.Optional[int] = None
    sectioning: typ.Optional[dict] = None  # see support.SectioningConfig
    seed: int = 0


class BaseDatasetConfig(StrictModel):
    identifier: str
    name_or_path: typ.Union[str, typ.Any] = None  # str path or DatasetLoader callable
    subsets: list[str] = dataclasses.field(default_factory=list)
    split: str = "train"
    options: DatasetOptionsConfig = dataclasses.field(default_factory=DatasetOptionsConfig)

    def fingerprint(self) -> str:
        from vod_tpu_torch.utils.fingerprint import fingerprint

        return fingerprint(
            {
                "identifier": self.identifier,
                "name_or_path": str(self.name_or_path),
                "subsets": self.subsets,
                "split": self.split,
                "options": self.options.to_dict(),
            }
        )


class QueriesDatasetConfig(BaseDatasetConfig):
    """Query shard, linked to a section shard by name."""

    link: typ.Optional[str] = None


class SectionsDatasetConfig(BaseDatasetConfig):
    """Section shard with its own search-engine diff."""

    search: typ.Optional[dict] = None  # diff over SearchFactoryDefaults
