"""BeIR dataset loader (the port's copy of `vod_tpu/data/loaders/beir.py`).

Loads a BeIR-format directory (`corpus.jsonl` + `queries.jsonl` +
`qrels/<split>.tsv`), turning qrels into per-query `retrieval_ids` /
`retrieval_scores`; queries without qrels are dropped. The JAX loader can
also read the HF hub (`BeIR/<subset>`) from a pre-populated cache; the port
has no `datasets` package, so a subset name raises the JAX loader's
zero-egress `RuntimeError`.
"""

from __future__ import annotations

import json
import pathlib
import typing as typ

SUBSETS = [
    "msmarco", "trec-covid", "nfcorpus", "nq", "hotpotqa", "fiqa",
    "arguana", "webis-touche2020", "cqadupstack", "quora", "dbpedia-entity",
    "scidocs", "fever", "climate-fever", "scifact",
]


def _read_jsonl(path: pathlib.Path) -> list[dict]:
    with open(path, encoding="utf-8") as f:
        return [json.loads(line) for line in f if line.strip()]


def _read_qrels_tsv(path: pathlib.Path) -> dict[str, list[tuple[str, float]]]:
    """TSV `query-id<TAB>corpus-id<TAB>score` (with optional header row)."""
    by_query: dict[str, list[tuple[str, float]]] = {}
    for line in path.read_text().splitlines():
        parts = line.strip().split("\t")
        if len(parts) < 3 or parts[0] in ("query-id", "qid"):
            continue
        by_query.setdefault(str(parts[0]), []).append((str(parts[1]), float(parts[-1])))
    return by_query


class BeirDatasetLoader:
    """Callable loader usable as `name_or_path` in dataset configs."""

    def __init__(self, what: typ.Literal["queries", "sections"] = "queries"):
        self.what = what

    def _load_local(self, root: pathlib.Path, split: str) -> list[dict]:
        if self.what == "sections":
            return [
                {
                    "id": str(r["_id"]),
                    "content": r["text"],
                    "title": r.get("title") or None,
                    "subset_id": None,
                }
                for r in _read_jsonl(root / "corpus.jsonl")
            ]
        by_query = _read_qrels_tsv(root / "qrels" / f"{split}.tsv")
        out = []
        for r in _read_jsonl(root / "queries.jsonl"):
            rels = by_query.get(str(r["_id"]), [])
            if not rels:  # queries without qrels are dropped
                continue
            out.append({
                "id": str(r["_id"]),
                "query": r["text"],
                "answers": [],
                "answer_scores": [],
                "retrieval_ids": [x for x, _ in rels],
                "retrieval_scores": [s for _, s in rels],
                "subset_ids": [],
            })
        return out

    def __call__(
        self, subsets: typ.Optional[list[str]] = None, split: str = "test", **kw: typ.Any
    ) -> list[dict]:
        subset = (subsets or ["scifact"])[0]
        local = pathlib.Path(subset)
        if local.is_dir():  # BeIR-format directory
            return self._load_local(local, split)
        if subset not in SUBSETS:
            raise ValueError(f"Unknown BeIR subset {subset!r}; known: {SUBSETS}")
        raise RuntimeError(
            f"BeIR/{subset} is not available offline (zero-egress environment); "
            "give the path of a BeIR-format directory (corpus.jsonl, queries.jsonl, qrels/) instead"
        )
