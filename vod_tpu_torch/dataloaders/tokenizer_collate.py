"""Field tokenizer collate for the predict/embedding pipeline (the port's copy
of `vod_tpu/dataloaders/tokenizer_collate.py`).

Parity: reference `vod_dataloaders/tokenizer_collate.py:24` (`TokenizerCollate`:
jinja-render one field template, tokenize, prefix the output keys) used by
`workflows/compute.py` to embed queries/sections.
"""

from __future__ import annotations

import typing as typ

import numpy as np

from vod_tpu_torch.utils.template import Template


class TokenizerCollate:
    """Render `template` over rows and tokenize (numpy outputs)."""

    def __init__(
        self,
        tokenizer: typ.Any,
        template: str,
        *,
        max_length: int = 200,
        prefix: str = "",
    ):
        self.tokenizer = tokenizer
        self.template = Template(template)
        self.max_length = max_length
        self.prefix = prefix

    def __call__(self, rows: typ.Sequence[typ.Mapping[str, typ.Any]]) -> dict[str, np.ndarray]:
        texts = [self.template.render(dict(r)) for r in rows]
        enc = self.tokenizer(
            texts,
            max_length=self.max_length,
            truncation=True,
            padding="max_length",
            return_tensors="np",
        )
        return {
            f"{self.prefix}input_ids": enc["input_ids"].astype(np.int32),
            f"{self.prefix}attention_mask": enc["attention_mask"].astype(np.int32),
        }
