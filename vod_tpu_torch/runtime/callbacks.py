"""Training callbacks (port of `Callback` and `call_callbacks` of
`vod_tpu/runtime/callbacks.py`): hook points that the train and validation
loops call by name. `ExportModule` and `load_export` are not ported yet.
"""

from __future__ import annotations

import typing as typ


class Callback:
    """Hook points of the loops: fit, train batch and validation, each at start and end."""

    def on_fit_start(self, **kw: typ.Any) -> None: ...

    def on_fit_end(self, **kw: typ.Any) -> None: ...

    def on_train_batch_start(self, **kw: typ.Any) -> None: ...

    def on_train_batch_end(self, **kw: typ.Any) -> None: ...

    def on_validation_start(self, **kw: typ.Any) -> None: ...

    def on_validation_end(self, **kw: typ.Any) -> None: ...


def call_callbacks(callbacks: typ.Sequence[Callback], hook: str, **kw: typ.Any) -> None:
    """Invoke a hook on every callback."""
    for cb in callbacks:
        getattr(cb, hook)(**kw)
