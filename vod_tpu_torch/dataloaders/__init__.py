"""Host-side data loading (port of `vod_tpu/dataloaders/`: the prefetching iterator)."""

from .prefetch import prefetch_iterator

__all__ = ["prefetch_iterator"]
