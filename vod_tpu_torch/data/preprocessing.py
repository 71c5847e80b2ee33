"""Split queries-with-contexts rows into separate query and section shards
(the port's copy of `vod_tpu/data/preprocessing.py`): contexts become
sections with content-hash ids, deduplicated, and each query links to its
sections by `retrieval_ids` and `subset_ids`. Rows are lists of dicts."""

from __future__ import annotations

import hashlib
import typing as typ


def _content_hash(content: str, title: typ.Optional[str]) -> str:
    h = hashlib.blake2b(digest_size=8)
    h.update((title or "").encode())
    h.update(b"\x00")
    h.update(content.encode())
    return h.hexdigest()


def isolate_qa_and_sections(
    data: typ.Iterable[typ.Mapping[str, typ.Any]], *, link_by_subset: bool = True
) -> tuple[list[dict], list[dict]]:
    """(queries_with_contexts rows) -> (query rows, section rows).

    Sections are deduplicated by content hash; each query gets
    `retrieval_ids` pointing at its contexts' section ids and, when
    `link_by_subset`, a `subset_ids` entry restricting its search space to
    those sections."""
    queries: list[dict] = []
    sections_by_id: dict[str, dict] = {}
    for row in data:
        contexts = row["contexts"]
        titles = row.get("titles") or [None] * len(contexts)
        sec_ids = []
        for content, title in zip(contexts, titles):
            sid = _content_hash(content, title)
            if sid not in sections_by_id:
                sections_by_id[sid] = {
                    "id": sid,
                    "content": content,
                    "title": title,
                    "subset_id": sid if link_by_subset else None,
                }
            sec_ids.append(sid)
        q = {k: v for k, v in row.items() if k not in ("contexts", "titles")}
        q["retrieval_ids"] = sec_ids
        q["retrieval_scores"] = [1.0] * len(sec_ids)
        q["subset_ids"] = sec_ids if link_by_subset else []
        queries.append(q)
    return queries, list(sections_by_id.values())
