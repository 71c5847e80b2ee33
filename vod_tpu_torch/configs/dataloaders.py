"""Dataloader, collate, template and tokenizer configs (the port's copy of
`vod_tpu/configs/dataloaders.py`).

`TokenizerConfig.instantiate()` builds the port's own tokenizer for a local
directory by what it holds (`data/tokenizer.py:load_tokenizer`):
`tokenizer.json` by its model (byte-level BPE or Unigram,
`data/tokenizer_json.py`), `vocab.txt` as WordPiece with the normalizer
flags of its `tokenizer_config.json`, `vocab.json` with `merges.txt` as a
byte-level BPE, as `AutoTokenizer` reads them; a hub name with no such
directory raises, since nothing is downloaded.
"""

from __future__ import annotations

import dataclasses
import typing as typ

from .base import StrictModel


class TemplatesConfig(StrictModel):
    """Jinja templates rendered before tokenization."""

    query: str = "{{ query }}"
    section: str = "{{ title }} {{ content }}"
    lm: str = "{{ section }} {{ query }} {{ answer }}"


class TokenizerConfig(StrictModel):
    name_or_path: str = "bert-base-uncased"
    max_length: int = 200
    lm_max_length: int = 512
    use_fast: bool = True

    def instantiate(self) -> typ.Any:
        from vod_tpu_torch.data.tokenizer import load_tokenizer

        return load_tokenizer(self.name_or_path)


class RealmCollateConfig(StrictModel):
    prefetch_n_sections: int = 100
    n_sections: typ.Optional[int] = 8
    max_pos_sections: typ.Optional[int] = 2
    support_size: typ.Optional[int] = None  # max_support_size truncation
    do_sample: bool = True
    in_batch_negatives: bool = False
    temperature: float = 1.0
    lookup_engine: str = "sparse"


class SamplerFactoryConfig(StrictModel):
    """Weighted query sampler."""

    mode: typ.Literal["lookup", "inverse_frequency", "product"] = "lookup"
    key: str = "answer"
    lookup: typ.Optional[dict[str, float]] = None


class DataLoaderConfig(StrictModel):
    batch_size: int = 32
    shuffle: bool = True
    seed: int = 0
    drop_last: bool = True
    num_workers: int = 0  # host-side prefetch threads (not torch workers)
    sampler: typ.Optional[SamplerFactoryConfig] = None
