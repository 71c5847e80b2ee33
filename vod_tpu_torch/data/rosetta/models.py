"""Canonical dataset schemas (the port's copy of
`vod_tpu/data/rosetta/models.py`): a query row (id, query, answers with their
scores, retrieval ids with their scores, subset ids), a section row (id,
content, title, subset id) and a query bundled with its contexts.

The JAX package's schemas are pydantic models that ignore unknown keys; these
are frozen dataclasses built by `from_row`, which checks and coerces each
known field as pydantic's lax mode does (`configs/base.py:validate`) and
raises `ValueError` where pydantic raises its `ValidationError`.
"""

from __future__ import annotations

import dataclasses
import typing as typ
import uuid

from vod_tpu_torch.configs.base import _hints, validate

R = typ.TypeVar("R", bound="_Row")


def _uuid() -> str:
    return uuid.uuid4().hex


@dataclasses.dataclass(frozen=True)
class _Row:
    @classmethod
    def from_row(cls: type[R], row: typ.Mapping[str, typ.Any]) -> R:
        """Validate the known fields of `row` (unknown keys are ignored)."""
        hints = _hints(cls)
        values = {}
        for f in dataclasses.fields(cls):
            if f.name in row:
                values[f.name] = validate(hints[f.name], row[f.name], f.name)
            elif f.default is dataclasses.MISSING and f.default_factory is dataclasses.MISSING:
                raise ValueError(f"{cls.__name__}: field {f.name!r} is required")
        out = cls(**values)
        out.check()
        return out

    def check(self) -> None:
        pass

    def to_dict(self) -> dict[str, typ.Any]:
        """pydantic's `model_dump()`."""
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}


@dataclasses.dataclass(frozen=True, kw_only=True)
class QueryModel(_Row):
    """A canonical query row."""

    id: str = dataclasses.field(default_factory=_uuid)
    query: str
    answers: list[str] = dataclasses.field(default_factory=list)
    answer_scores: list[float] = dataclasses.field(default_factory=list)
    retrieval_ids: list[str] = dataclasses.field(default_factory=list)
    retrieval_scores: list[float] = dataclasses.field(default_factory=list)
    subset_ids: list[str] = dataclasses.field(default_factory=list)

    def check(self) -> None:
        if len(self.answers) != len(self.answer_scores):
            raise ValueError("answers and answer_scores must have equal length")
        if len(self.retrieval_ids) != len(self.retrieval_scores):
            raise ValueError("retrieval_ids and retrieval_scores must have equal length")


@dataclasses.dataclass(frozen=True, kw_only=True)
class SectionModel(_Row):
    """A canonical section (passage) row."""

    id: str
    content: str
    title: typ.Optional[str] = None
    subset_id: typ.Optional[str] = None


@dataclasses.dataclass(frozen=True, kw_only=True)
class QueryWithContextsModel(QueryModel):
    """A query bundled with its context passages (pre-retrieval datasets)."""

    contexts: list[str]
    titles: typ.Optional[list[str]] = None

    def check(self) -> None:
        super().check()
        if self.titles is not None and len(self.titles) != len(self.contexts):
            raise ValueError("titles must match contexts length")
