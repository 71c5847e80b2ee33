"""Exception dumping for background workers (port of
`vod_tpu/utils/exceptions.py`): `dump_exceptions_to_file` writes the stack
and the call's arguments to `.exceptions/`, so that a crash in a worker
process can be read after it has gone."""

from __future__ import annotations

import datetime
import functools
import pathlib
import traceback
import typing as typ

F = typ.TypeVar("F", bound=typ.Callable)


def dump_exceptions_to_file(fn: F, directory: typ.Union[str, pathlib.Path] = ".exceptions") -> F:
    """Decorator: on an exception, write its traceback and the call's
    arguments to `directory/<qualname>-<time>.txt`, then re-raise."""

    @functools.wraps(fn)
    def wrapper(*args: typ.Any, **kwargs: typ.Any) -> typ.Any:
        try:
            return fn(*args, **kwargs)
        except Exception as exc:
            d = pathlib.Path(directory)
            d.mkdir(parents=True, exist_ok=True)
            stamp = datetime.datetime.now().strftime("%Y%m%d-%H%M%S-%f")
            path = d / f"{fn.__qualname__}-{stamp}.txt"
            try:
                path.write_text(
                    f"exception: {exc!r}\n\nargs: {args!r}\nkwargs: {kwargs!r}\n\n" + traceback.format_exc()
                )
            except Exception:
                pass
            raise

    return typ.cast(F, wrapper)
