"""Core data types (port of `vod_tpu/types/`)."""

from .batch import RealmBatch, RealmOutput
from .lazy import LazyArray, TensorStoreFactory, UnreadableStore, ZarrStore, as_lazy_array
from .retrieval import PAD_INDEX, PAD_LABEL, PAD_SCORE, RetrievalBatch, stack_samples

__all__ = [
    "LazyArray",
    "PAD_INDEX",
    "PAD_LABEL",
    "PAD_SCORE",
    "RealmBatch",
    "RealmOutput",
    "RetrievalBatch",
    "TensorStoreFactory",
    "UnreadableStore",
    "ZarrStore",
    "as_lazy_array",
    "stack_samples",
]
