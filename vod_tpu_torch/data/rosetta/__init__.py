"""Rosetta: translate QA/retrieval datasets into the canonical query/section
schema (the port's copy of `vod_tpu/data/rosetta/`)."""

from .models import QueryModel, QueryWithContextsModel, SectionModel
from .adapters import ADAPTERS, find_adapter, transform

__all__ = [
    "ADAPTERS",
    "QueryModel",
    "QueryWithContextsModel",
    "SectionModel",
    "find_adapter",
    "transform",
]
