"""Dataset adapters (the port's copy of `vod_tpu/data/rosetta/adapters.py`):
the first adapter whose input schema validates the first row wins.

The JAX package writes each adapter's input schema as a pydantic model with
validation aliases (`AliasChoices`); here it is a list of `_Field`s: a field
is read from the first of its aliases present in the row (then from its own
name), checked and coerced as pydantic's lax mode does, and unknown keys are
ignored. `find_adapter` tries the adapters in the JAX package's order and
finds the same one for the same row.
"""

from __future__ import annotations

import dataclasses
import typing as typ
import uuid

from vod_tpu_torch.configs.base import validate
from .models import QueryModel, QueryWithContextsModel, SectionModel, _Row

# --- alias sets ---------------------------------------------------------------
QUERY_ALIASES = ("query", "question", "question_text", "text", "instruction", "prompt")
QUERY_ID_ALIASES = ("id", "_id", "qid", "query_id", "question_id", "uid")
ANSWER_ALIASES = ("answer", "answers", "answer_text", "output", "target", "response")
CHOICES_ALIASES = ("choices", "options", "candidates", "answer_choices", "opa_choices")
ANSWER_IDX_ALIASES = ("answer", "answer_idx", "label", "correct_answer_idx", "cop")
CONTENT_ALIASES = ("content", "text", "passage", "context", "document", "body", "contents")
TITLE_ALIASES = ("title", "document_title", "heading")
SECTION_ID_ALIASES = ("id", "_id", "pid", "doc_id", "passage_id", "section_id")
CONTEXTS_ALIASES = ("contexts", "context", "passages", "documents", "positive_ctxs")

_LETTERS = "ABCDEFGHIJ"
_REQUIRED = object()


@dataclasses.dataclass(frozen=True)
class _Field:
    name: str
    tp: typ.Any  # a type, or a tuple of `_Field`s (a nested schema)
    aliases: tuple[str, ...] = ()
    default: typ.Any = _REQUIRED
    to_str: bool = False  # the value is first made a string (ids)
    by_name: bool = True  # also read from the field's own name


def _id_field(aliases: tuple[str, ...]) -> _Field:
    return _Field("id", str, aliases, default=lambda: uuid.uuid4().hex, to_str=True)


def _read(schema: tuple[_Field, ...], row: typ.Any, path: str = "") -> dict[str, typ.Any]:
    """The schema's fields from a row, validated; raises ValueError."""
    if not isinstance(row, typ.Mapping):
        raise ValueError(f"{path or 'row'}: expected a mapping, got {row!r}")
    out: dict[str, typ.Any] = {}
    for f in schema:
        keys = (f.aliases or (f.name,)) + ((f.name,) if f.by_name else ())
        key = next((k for k in keys if k in row), None)
        if key is None:
            if f.default is _REQUIRED:
                raise ValueError(f"{path}{f.name}: field required")
            out[f.name] = f.default() if callable(f.default) else f.default
            continue
        value = str(row[key]) if f.to_str else row[key]
        if isinstance(f.tp, tuple):
            out[f.name] = _read(f.tp, value, f"{path}{f.name}.")
        else:
            out[f.name] = validate(f.tp, value, f"{path}{f.name}")
    return out


class Adapter:
    """Base adapter: `input_schema` validates raw rows, `translate_row` maps them."""

    input_schema: typ.ClassVar[typ.Any]  # a tuple of `_Field`s, or a canonical row class

    @classmethod
    def parse(cls, row: typ.Mapping[str, typ.Any]) -> typ.Any:
        if isinstance(cls.input_schema, tuple):
            return _read(cls.input_schema, row)
        return cls.input_schema.from_row(row)

    @classmethod
    def can_handle(cls, row: dict) -> bool:
        try:
            cls.parse(row)
            return True
        except ValueError:
            return False

    @classmethod
    def translate_row(cls, row: dict) -> _Row:
        raise NotImplementedError

    @classmethod
    def translate(cls, data: typ.Any, map_kwargs: typ.Optional[dict] = None) -> typ.Any:
        """Translate a row dict or a list of rows into canonical dicts."""
        del map_kwargs  # batching options of a HF dataset map; rows here are lists
        if isinstance(data, dict):
            return cls.translate_row(data).to_dict()
        if isinstance(data, (list, tuple)):
            return [cls.translate_row(row).to_dict() for row in data]
        raise TypeError(f"Cannot adapt {type(data)}")


# --- identity adapters ----------------------------------------------------------
class IdentityQueryAdapter(Adapter):
    input_schema = QueryModel

    @classmethod
    def translate_row(cls, row: dict) -> QueryModel:
        return QueryModel.from_row(row)


class IdentitySectionAdapter(Adapter):
    input_schema = SectionModel

    @classmethod
    def translate_row(cls, row: dict) -> SectionModel:
        return SectionModel.from_row(row)


class IdentityQueryWithContextsAdapter(Adapter):
    input_schema = QueryWithContextsModel

    @classmethod
    def translate_row(cls, row: dict) -> QueryWithContextsModel:
        return QueryWithContextsModel.from_row(row)


# --- renamed/aliased fields -------------------------------------------------------
class AliasedQueryAdapter(Adapter):
    input_schema = (
        _id_field(QUERY_ID_ALIASES),
        _Field("query", str, QUERY_ALIASES),
        _Field("answer", typ.Union[str, list[str]], ANSWER_ALIASES),
    )

    @classmethod
    def translate_row(cls, row: dict) -> QueryModel:
        m = cls.parse(row)
        answers = m["answer"] if isinstance(m["answer"], list) else [m["answer"]]
        return QueryModel(id=m["id"], query=m["query"], answers=answers, answer_scores=[1.0] * len(answers))


class AliasedSectionAdapter(Adapter):
    input_schema = (
        _id_field(SECTION_ID_ALIASES),
        _Field("content", str, CONTENT_ALIASES),
        _Field("title", typ.Optional[str], TITLE_ALIASES, default=None),
        _Field("subset_id", typ.Optional[str], default=None),
    )

    @classmethod
    def translate_row(cls, row: dict) -> SectionModel:
        m = cls.parse(row)
        return SectionModel(id=m["id"], content=m["content"], title=m["title"], subset_id=m["subset_id"])


# --- multiple choice -----------------------------------------------------------------
_MCQA = (
    _id_field(QUERY_ID_ALIASES),
    _Field("query", str, QUERY_ALIASES),
    _Field("choices", list[str], CHOICES_ALIASES),
    _Field("answer", typ.Union[int, str], ANSWER_IDX_ALIASES),
)


def _choice_index(answer: typ.Union[int, str], n: int) -> int:
    if isinstance(answer, int):
        idx = answer
    elif answer in _LETTERS:
        idx = _LETTERS.index(answer)
    else:
        raise ValueError(f"Cannot interpret MCQA answer {answer!r}")
    if not 0 <= idx < n:
        raise ValueError(f"MCQA answer index {idx} out of range ({n} choices)")
    return idx


class McqaQueryAdapter(Adapter):
    """Answer choices -> one-hot answer_scores."""

    input_schema = _MCQA

    @classmethod
    def translate_row(cls, row: dict) -> QueryModel:
        m = cls.parse(row)
        scores = [0.0] * len(m["choices"])
        scores[_choice_index(m["answer"], len(m["choices"]))] = 1.0
        return QueryModel(id=m["id"], query=m["query"], answers=m["choices"], answer_scores=scores)


class McqaQueryWithContextsAdapter(Adapter):
    input_schema = _MCQA + (_Field("contexts", typ.Union[list[str], str], CONTEXTS_ALIASES),)

    @classmethod
    def translate_row(cls, row: dict) -> QueryWithContextsModel:
        m = cls.parse(row)
        scores = [0.0] * len(m["choices"])
        scores[_choice_index(m["answer"], len(m["choices"]))] = 1.0
        ctx = m["contexts"] if isinstance(m["contexts"], list) else [m["contexts"]]
        return QueryWithContextsModel(
            id=m["id"], query=m["query"], answers=m["choices"], answer_scores=scores, contexts=ctx
        )


# --- squad-style ---------------------------------------------------------------------
class SquadQueryWithContextsAdapter(Adapter):
    input_schema = (
        _id_field(QUERY_ID_ALIASES),
        _Field("question", str),
        _Field("context", str),
        _Field("answers", (_Field("text", list[str], by_name=False),)),
        _Field("title", typ.Optional[str], default=None),
    )

    @classmethod
    def translate_row(cls, row: dict) -> QueryWithContextsModel:
        m = cls.parse(row)
        answers = m["answers"]["text"] or [""]
        return QueryWithContextsModel(
            id=m["id"],
            query=m["question"],
            answers=answers,
            answer_scores=[1.0] * len(answers),
            contexts=[m["context"]],
            titles=[m["title"]] if m["title"] is not None else None,
        )


# --- trivia-qa-style -------------------------------------------------------------------
class TriviaQaQueryAdapter(Adapter):
    input_schema = (
        _id_field(QUERY_ID_ALIASES),
        _Field("question", str),
        _Field("answer", (_Field("value", str, by_name=False), _Field("aliases", list[str], by_name=False,
                                                                       default=list))),
    )

    @classmethod
    def translate_row(cls, row: dict) -> QueryModel:
        m = cls.parse(row)
        value, aliases = m["answer"]["value"], m["answer"]["aliases"]
        answers = [value, *[a for a in aliases if a != value]]
        return QueryModel(id=m["id"], query=m["question"], answers=answers, answer_scores=[1.0] * len(answers))


# --- text-to-text --------------------------------------------------------------------------
class TextToTextQueryAdapter(Adapter):
    input_schema = (
        _Field("source", str, ("source", "input", "input_text", "src"), by_name=False),
        _Field("target", str, ("target", "output", "output_text", "tgt"), by_name=False),
    )

    @classmethod
    def translate_row(cls, row: dict) -> QueryModel:
        m = cls.parse(row)
        return QueryModel(query=m["source"], answers=[m["target"]], answer_scores=[1.0])


# --- missing-fields fill-in -------------------------------------------------------------------
class MissingFieldsQueryAdapter(Adapter):
    """Queries without answers (retrieval-only datasets)."""

    input_schema = (_id_field(QUERY_ID_ALIASES), _Field("query", str, QUERY_ALIASES))

    @classmethod
    def translate_row(cls, row: dict) -> QueryModel:
        m = cls.parse(row)
        return QueryModel(id=m["id"], query=m["query"])


# --- registry + transform ------------------------------------------------------------------------
# Order matters: most specific first (queries-with-context adapters are tried
# before plain query/section adapters).
ADAPTERS: dict[str, list[type[Adapter]]] = {
    "queries_with_context": [
        IdentityQueryWithContextsAdapter,
        SquadQueryWithContextsAdapter,
        McqaQueryWithContextsAdapter,
    ],
    "queries": [
        IdentityQueryAdapter,
        McqaQueryAdapter,
        TriviaQaQueryAdapter,
        TextToTextQueryAdapter,
        AliasedQueryAdapter,
        MissingFieldsQueryAdapter,
    ],
    "sections": [
        IdentitySectionAdapter,
        AliasedSectionAdapter,
    ],
}


def find_adapter(row: dict, kind: str) -> typ.Optional[type[Adapter]]:
    """First adapter (for `kind`) whose input schema validates the row."""
    for adapter in ADAPTERS[kind]:
        if adapter.can_handle(row):
            return adapter
    return None


def transform(data: typ.Any, kind: str, map_kwargs: typ.Optional[dict] = None) -> typ.Any:
    """Translate a row or a list of rows into the canonical schema for `kind`
    ('queries' | 'sections'). Queries-with-context rows are isolated into
    separate query + section shards by `preprocessing.isolate_qa_and_sections`."""
    first = data[0] if not isinstance(data, dict) else data
    if kind == "queries":
        qc = find_adapter(first, "queries_with_context")
        if qc is not None:
            from vod_tpu_torch.data.preprocessing import isolate_qa_and_sections

            return isolate_qa_and_sections(qc.translate(data, map_kwargs))
    adapter = find_adapter(first, kind)
    if adapter is None:
        raise ValueError(f"No rosetta adapter matches this row for kind={kind!r}: {sorted(first)[:20]}")
    return adapter.translate(data, map_kwargs)
