"""Core data types (port of `vod_tpu/types/`)."""

from .retrieval import PAD_INDEX, PAD_LABEL, PAD_SCORE, RetrievalBatch, stack_samples

__all__ = ["PAD_INDEX", "PAD_LABEL", "PAD_SCORE", "RetrievalBatch", "stack_samples"]
