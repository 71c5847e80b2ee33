"""Pickle-safe jinja templates with input-variable extraction.

Parity: reference `vod_tools/misc/template.py:12` — a `Template` wrapping jinja2,
exposing `input_vars` (parsed from the source) and `render`/`render_batch`;
pickle-safe because only the source string is stored.
"""

from __future__ import annotations

import typing as typ

import jinja2
import jinja2.meta


class Template:
    """A jinja2 template keyed by its source string."""

    def __init__(self, template: str):
        self.template = template
        self._compiled: typ.Optional[jinja2.Template] = None

    def _get(self) -> jinja2.Template:
        if self._compiled is None:
            self._compiled = jinja2.Environment(autoescape=False).from_string(self.template)
        return self._compiled

    @property
    def input_vars(self) -> set[str]:
        env = jinja2.Environment(autoescape=False)
        return set(jinja2.meta.find_undeclared_variables(env.parse(self.template)))

    def render(self, row: typ.Mapping[str, typ.Any]) -> str:
        return self._get().render(**row)

    def render_batch(self, batch: typ.Mapping[str, list]) -> list[str]:
        keys = list(batch.keys())
        n = len(batch[keys[0]]) if keys else 0
        return [self.render({k: batch[k][i] for k in keys}) for i in range(n)]

    def __getstate__(self) -> dict:
        return {"template": self.template}

    def __setstate__(self, state: dict) -> None:
        self.template = state["template"]
        self._compiled = None

    def __repr__(self) -> str:
        return f"Template({self.template!r})"
