"""Dataset postprocessing: sectioning, subsampling, concatenation (the port's
copy of `vod_tpu/data/postprocessing.py`). Lists of row dicts take the place
of HF `datasets.Dataset`s."""

from __future__ import annotations

import typing as typ

from .sectioning import FixedLengthSectionizer, SentenceSectionizer


def make_sectionizer(cfg: typ.Mapping[str, typ.Any]) -> typ.Callable[[str, str], list[str]]:
    """The sectionizer a config names; the fixed-length one tokenizes with the
    port's tokenizer, read from `tokenizer_name_or_path` (a local directory,
    `tokenizer.load_tokenizer`)."""
    mode = cfg.get("mode", "fixed_length")
    if mode == "sentence":
        return SentenceSectionizer(delimiter=cfg.get("delimiter", ". "))
    if mode == "fixed_length":
        from .tokenizer import load_tokenizer

        tok = load_tokenizer(cfg.get("tokenizer_name_or_path", "bert-base-uncased"))
        return FixedLengthSectionizer(
            tok,
            section_length=cfg.get("section_length", 200),
            stride=cfg.get("stride"),
            ellipsis_start=cfg.get("ellipsis_start", "(...) "),
            ellipsis_end=cfg.get("ellipsis_end", " (...)"),
        )
    raise ValueError(f"Unknown sectioning mode {mode}")


def extract_sections(rows: typ.Sequence[typ.Mapping], sectioning_cfg: typ.Mapping[str, typ.Any]) -> list[dict]:
    """Explode each section row into its chunks (ids `<id>#<j>` when a row
    gives more than one)."""
    sectionize = make_sectionizer(sectioning_cfg)
    out: list[dict] = []
    for row in rows:
        pieces = sectionize(row["content"], "")
        for j, piece in enumerate(pieces):
            new = dict(row)
            new["content"] = piece
            if "id" in row:
                new["id"] = f"{row['id']}#{j}" if len(pieces) > 1 else row["id"]
            out.append(new)
    return out


def combine_datasets(parts: typ.Sequence[typ.Sequence[typ.Mapping]]) -> list:
    """Concatenate row lists."""
    parts = list(parts)
    if len(parts) == 1:
        return parts[0]
    return [row for part in parts for row in part]
