"""Tweaks and sectioning configs (the port's copy of
`vod_tpu/configs/support.py`)."""

from __future__ import annotations

import typing as typ

from .base import StrictModel


class TweaksConfig(StrictModel):
    remat: bool = False  # activation checkpointing over transformer layers
    force_dtype: typ.Optional[str] = None  # activation dtype override
    donate_state: bool = True  # donate params/opt_state buffers in the step


class SentenceSectioningConfig(StrictModel):
    mode: typ.Literal["sentence"] = "sentence"
    delimiter: str = ". "


class FixedLengthSectioningConfig(StrictModel):
    mode: typ.Literal["fixed_length"] = "fixed_length"
    section_length: int = 200
    stride: typ.Optional[int] = None
    ellipsis_start: str = "(...) "
    ellipsis_end: str = " (...)"
    tokenizer_name_or_path: str = "bert-base-uncased"
