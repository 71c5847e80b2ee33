"""Host corpus preparation (the port's copy of `vod_tpu/data/corpus.py`):
sections and queries are rendered by their jinja templates and tokenized
once on the host; the section arrays then live on the card as a
`DeviceCorpus`, so the per-step collate is a device gather. The BM25 terms
come from the port's analyzer (`native.analyze_texts`).

`tokenizer` is the port's `WordPieceTokenizer`, or any tokenizer with the
`transformers` calling convention.
"""

from __future__ import annotations

import typing as typ

import numpy as np

from vod_tpu_torch.configs.dataloaders import TemplatesConfig
from vod_tpu_torch.utils.template import Template


def _render(template: str, rows: typ.Sequence[typ.Mapping]) -> list[str]:
    tpl = Template(template)
    return [tpl.render(row) for row in rows]


def tokenize_corpus(
    sections: typ.Sequence[typ.Mapping[str, typ.Any]],
    tokenizer: typ.Any,
    *,
    max_length: int = 200,
    templates: typ.Optional[TemplatesConfig] = None,
    subset_id_map: typ.Optional[dict[str, int]] = None,
    with_sparse_terms: bool = False,
    sparse_vocab_size: int = 1 << 18,
    sparse_max_terms: int = 512,
    sparse_language: typ.Optional[str] = None,
    sparse_stem: bool = False,
) -> dict[str, typ.Any]:
    """Render + tokenize all sections.

    Returns dict with `input_ids`/`attention_mask` [N, L] int32, `subset_ids`
    [N] int32 (-1 when absent), `id_map` (section-id -> row), and when
    `with_sparse_terms`, the analyzed `terms`/`term_counts` for the BM25 build.
    """
    templates = templates or TemplatesConfig()
    texts = _render(templates.section, [dict(s) for s in sections])
    enc = tokenizer(texts, max_length=max_length, truncation=True, padding="max_length", return_tensors="np")
    out: dict[str, typ.Any] = {
        "input_ids": enc["input_ids"].astype(np.int32),
        "attention_mask": enc["attention_mask"].astype(np.int32),
    }
    subset_ids = np.full((len(sections),), -1, dtype=np.int32)
    if subset_id_map is None:
        subset_id_map = {}
        for s in sections:
            sid = s.get("subset_id")
            if sid is not None and sid not in subset_id_map:
                subset_id_map[sid] = len(subset_id_map)
    for i, s in enumerate(sections):
        sid = s.get("subset_id")
        if sid is not None and sid in subset_id_map:
            subset_ids[i] = subset_id_map[sid]
    out["subset_ids"] = subset_ids
    out["subset_id_map"] = subset_id_map
    out["id_map"] = {str(s["id"]): i for i, s in enumerate(sections)}

    if with_sparse_terms:
        from vod_tpu_torch.native import analyze_texts

        terms, counts = analyze_texts(
            texts, vocab_size=sparse_vocab_size, max_terms=sparse_max_terms,
            language=sparse_language, stem=sparse_stem,
        )
        out["terms"] = terms
        out["term_counts"] = counts
    return out


def tokenize_queries(
    queries: typ.Sequence[typ.Mapping[str, typ.Any]],
    tokenizer: typ.Any,
    *,
    max_length: int = 200,
    answer_max_length: int = 64,
    templates: typ.Optional[TemplatesConfig] = None,
    id_map: typ.Optional[dict[str, int]] = None,
    subset_id_map: typ.Optional[dict[str, int]] = None,
    max_gold: int = 4,
    max_subsets: int = 4,
    with_answers: bool = False,
    with_sparse_terms: bool = False,
    sparse_vocab_size: int = 1 << 18,
    sparse_max_terms: int = 32,
    sparse_language: typ.Optional[str] = None,
    sparse_stem: bool = False,
) -> dict[str, np.ndarray]:
    """Render + tokenize a query list; resolve gold section ids and subset ids
    to int rows. The answer is the one of highest `answer_scores`."""
    templates = templates or TemplatesConfig()
    n = len(queries)
    texts = _render(templates.query, [dict(q) for q in queries])
    enc = tokenizer(texts, max_length=max_length, truncation=True, padding="max_length", return_tensors="np")
    out: dict[str, typ.Any] = {
        "input_ids": enc["input_ids"].astype(np.int32),
        "attention_mask": enc["attention_mask"].astype(np.int32),
    }

    gold = np.full((n, max_gold), -1, dtype=np.int32)
    subs = np.full((n, max_subsets), -1, dtype=np.int32)
    answers: list[str] = []
    for i, q in enumerate(queries):
        rids = list(q.get("retrieval_ids") or [])
        if id_map is not None:
            rows = [id_map[r] for r in rids if r in id_map]
            gold[i, : min(max_gold, len(rows))] = rows[:max_gold]
        sids = list(q.get("subset_ids") or [])
        if subset_id_map is not None:
            srows = [subset_id_map[s] for s in sids if s in subset_id_map]
            subs[i, : min(max_subsets, len(srows))] = srows[:max_subsets]
        ans_list = list(q.get("answers") or [])
        scores = list(q.get("answer_scores") or [])
        if ans_list:
            best = int(np.argmax(scores)) if scores else 0
            answers.append(ans_list[best])
        else:
            answers.append("")
    out["section_ids"] = gold
    out["subset_ids"] = subs

    if with_answers:
        aenc = tokenizer(
            answers, max_length=answer_max_length, truncation=True, padding="max_length", return_tensors="np"
        )
        out["answer_ids"] = aenc["input_ids"].astype(np.int32)
        out["answer_mask"] = aenc["attention_mask"].astype(np.int32)

    if with_sparse_terms:
        from vod_tpu_torch.native import analyze_texts

        terms, counts = analyze_texts(
            texts, vocab_size=sparse_vocab_size, max_terms=sparse_max_terms,
            language=sparse_language, stem=sparse_stem,
        )
        out["terms"] = terms
        out["term_counts"] = counts
    return out
