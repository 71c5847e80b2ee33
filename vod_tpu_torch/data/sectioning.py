"""Corpus sectioning: chunk long documents into retrieval-sized passages (the
port's copy of `vod_tpu/data/sectioning.py`): sentence splits, and
token-budget windows with stride and ellipses cut on token boundaries by the
tokenizer's offsets (the port's `WordPieceTokenizer`, or any tokenizer with
the `transformers` calling convention)."""

from __future__ import annotations

import typing as typ


class SentenceSectionizer:
    """Split on sentence delimiters."""

    def __init__(self, delimiter: str = ". "):
        self.delimiter = delimiter

    def __call__(self, content: str, prefix: str = "") -> list[str]:
        parts = [p.strip() for p in content.split(self.delimiter)]
        return [prefix + p for p in parts if p]


class FixedLengthSectionizer:
    """Token-budget windows with stride + ellipses: windows are cut on token
    boundaries and emitted as character substrings, so that templating
    re-tokenizes them consistently."""

    def __init__(
        self,
        tokenizer: typ.Any,
        section_length: int = 200,
        stride: typ.Optional[int] = None,
        ellipsis_start: str = "(...) ",
        ellipsis_end: str = " (...)",
        prefix_template: str = "",
    ):
        self.tokenizer = tokenizer
        self.section_length = section_length
        self.stride = stride if stride is not None else section_length
        self.ellipsis_start = ellipsis_start
        self.ellipsis_end = ellipsis_end
        self.prefix_template = prefix_template
        # budget what the prefix + ellipses cost in tokens
        overhead = len(tokenizer(ellipsis_start + ellipsis_end, add_special_tokens=False)["input_ids"])
        self._budget = max(8, section_length - overhead)

    def __call__(self, content: str, prefix: str = "") -> list[str]:
        prefix_tokens = (
            len(self.tokenizer(prefix, add_special_tokens=False)["input_ids"]) if prefix else 0
        )
        budget = max(8, self._budget - prefix_tokens)
        enc = self.tokenizer(content, add_special_tokens=False, return_offsets_mapping=True)
        offsets = enc["offset_mapping"]
        n = len(offsets)
        if n == 0:
            return []
        if n <= budget:
            return [prefix + content]
        out = []
        start = 0
        while start < n:
            end = min(n, start + budget)
            c0 = offsets[start][0]
            c1 = offsets[end - 1][1]
            piece = content[c0:c1]
            if start > 0:
                piece = self.ellipsis_start + piece
            if end < n:
                piece = piece + self.ellipsis_end
            out.append(prefix + piece)
            if end >= n:
                break
            start += self.stride
        return out
