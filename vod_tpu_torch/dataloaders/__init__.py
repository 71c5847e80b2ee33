"""Host-side data loading (port of `vod_tpu/dataloaders/`: the prefetching
iterator, the query dataloader, its samplers and the field tokenizer collate)."""

from .prefetch import prefetch_iterator
from .realm_dataloader import RealmDataloader
from .samplers import dl_sampler_factory
from .tokenizer_collate import TokenizerCollate

__all__ = ["RealmDataloader", "TokenizerCollate", "dl_sampler_factory", "prefetch_iterator"]
