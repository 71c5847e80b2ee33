"""Core data types (port of `vod_tpu/types/`)."""

from .batch import RealmBatch, RealmOutput
from .retrieval import PAD_INDEX, PAD_LABEL, PAD_SCORE, RetrievalBatch, stack_samples

__all__ = ["PAD_INDEX", "PAD_LABEL", "PAD_SCORE", "RealmBatch", "RealmOutput", "RetrievalBatch", "stack_samples"]
