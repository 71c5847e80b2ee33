"""Configs of the port (own copies of `vod_tpu/configs/`): frozen, validated
dataclasses with the same fields, defaults and `config + diff` algebra."""

from .base import AllowMutations, StrictModel, apply_diff
from .search import DenseFactoryConfig, HybridSearchFactoryConfig, SearchFactoryDefaults, SparseFactoryConfig
from .datasets import BaseDatasetConfig, QueriesDatasetConfig, SectionsDatasetConfig
from .dataloaders import DataLoaderConfig, RealmCollateConfig, TemplatesConfig, TokenizerConfig
from .trainer import BatchSizeConfig, BenchmarkConfig, SysConfig, TrainerConfig
from .support import FixedLengthSectioningConfig, SentenceSectioningConfig, TweaksConfig

__all__ = [
    "AllowMutations",
    "BaseDatasetConfig",
    "BatchSizeConfig",
    "BenchmarkConfig",
    "DataLoaderConfig",
    "DenseFactoryConfig",
    "FixedLengthSectioningConfig",
    "HybridSearchFactoryConfig",
    "QueriesDatasetConfig",
    "RealmCollateConfig",
    "SearchFactoryDefaults",
    "SectionsDatasetConfig",
    "SentenceSectioningConfig",
    "SparseFactoryConfig",
    "StrictModel",
    "SysConfig",
    "TemplatesConfig",
    "TokenizerConfig",
    "TrainerConfig",
    "TweaksConfig",
    "apply_diff",
]
