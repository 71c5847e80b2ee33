"""Config foundations (the port's copy of `vod_tpu/configs/base.py`):
`StrictModel`, `AllowMutations` and `apply_diff`.

The JAX package's configs are frozen, extra-forbidding pydantic models. Here
a `StrictModel` subclass is a dataclass whose fields are checked and coerced
at construction as pydantic's lax mode does: an unknown key, a value outside
a `Literal` or of the wrong type raises `ValueError` (pydantic's
`ValidationError` is one); `"1e-4"` becomes 1e-4 for a float field, `5.0`
becomes 5 for an int field but `5.5` raises, an int becomes a float, `"yes"`
a bool, a dict a nested config, and a union tries the exact type first. A
model is frozen: setting a field raises, except inside `AllowMutations`.

Beside the fields a model keeps the names its input gave (`fields_set`,
pydantic's `model_fields_set`), which `apply_diff` uses as pydantic's
`model_dump(exclude_unset=True)` does. `to_dict()` equals `model_dump()`,
and `to_json()` gives the text of `model_dump_json(indent=2)` up to float
formatting, so a `config.json` written by either package is read by the
other. The card's machine has no pydantic: nothing here imports it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import re
import types
import typing as typ

M = typ.TypeVar("M", bound="StrictModel")

_TRUE_STRINGS = {"1", "on", "t", "true", "y", "yes"}
_FALSE_STRINGS = {"0", "off", "f", "false", "n", "no"}
# pydantic's int string: ASCII digits, single underscores between them, and
# a fraction of zeros only after a digit ("1.0" yes; "1.", "٣", "1__0" no)
_INT_STRING = re.compile(r"([+-]?[0-9]+(?:_[0-9]+)*)(?:\.0+)?")
# pydantic-core's float string: Rust's `f64::from_str` grammar (ASCII only, no
# whitespace, no underscores; inf / infinity / nan in any case) on the string
# trimmed of Unicode White_Space, else on the untrimmed string with single
# underscores removed, none at either end ("-_1", "1e_3" yes; "_1", "1__0" no)
_RUST_FLOAT = re.compile(r"[+-]?(?:inf|infinity|nan|(?:[0-9]+\.?[0-9]*|\.[0-9]+)(?:e[+-]?[0-9]+)?)",
                         re.IGNORECASE | re.ASCII)
_UNICODE_WHITE_SPACE = "\t\n\x0b\x0c\r \x85\xa0\u1680" + "".join(map(chr, range(0x2000, 0x200B))) + \
    "\u2028\u2029\u202f\u205f\u3000"


class _Invalid(ValueError):
    pass


def _fail(path: str, msg: str, value: typ.Any) -> typ.NoReturn:
    raise _Invalid(f"{path or 'value'}: {msg}, got {value!r}")


def _exact(tp: typ.Any, value: typ.Any) -> bool:
    """Whether `value` is exactly of type `tp` (the strict pass of a union)."""
    origin = typ.get_origin(tp)
    if tp is type(None):
        return value is None
    if origin is typ.Literal:
        return any(type(value) is type(c) and value == c for c in typ.get_args(tp))
    if tp in (str, int, float, bool):
        return type(value) is tp
    if origin in (list, dict):
        return type(value) is origin
    if isinstance(tp, type) and dataclasses.is_dataclass(tp):
        return isinstance(value, tp)
    return False


def _float_string(s: str) -> float | None:
    """pydantic's float of the string `s`, or None where pydantic refuses it."""
    trimmed = s.strip(_UNICODE_WHITE_SPACE)
    if _RUST_FLOAT.fullmatch(trimmed):
        return float(trimmed)
    if s.startswith("_") or s.endswith("_") or "__" in s:
        return None
    stripped = s.replace("_", "")
    return float(stripped) if _RUST_FLOAT.fullmatch(stripped) else None


def validate(tp: typ.Any, value: typ.Any, path: str = "") -> typ.Any:
    """`value` checked and coerced to `tp` as pydantic's lax mode does."""
    if tp is typ.Any or tp is object:
        return value
    origin = typ.get_origin(tp)
    if origin is typ.Union or origin is types.UnionType:
        members = typ.get_args(tp)
        for m in members:
            if _exact(m, value):
                return validate(m, value, path)
        errors = []
        for m in members:
            try:
                return validate(m, value, path)
            except _Invalid as exc:
                errors.append(str(exc))
        _fail(path, f"matches no member of {tp} ({'; '.join(errors)})", value)
    if tp is type(None):
        if value is not None:
            _fail(path, "expected None", value)
        return None
    if origin is typ.Literal:
        for c in typ.get_args(tp):
            if isinstance(value, bool) != isinstance(c, bool):
                continue
            if type(value) in (int, float, bool, str) and type(c) in (int, float, bool, str) and \
                    isinstance(value, str) == isinstance(c, str) and value == c:
                return c
        _fail(path, f"expected one of {typ.get_args(tp)}", value)
    if tp is str:
        if not isinstance(value, str):
            _fail(path, "expected a string", value)
        return value
    if tp is bool:
        if isinstance(value, bool):
            return value
        if isinstance(value, (int, float)) and value in (0, 1):
            return bool(value)
        if isinstance(value, str) and value.strip().lower() in _TRUE_STRINGS | _FALSE_STRINGS:
            return value.strip().lower() in _TRUE_STRINGS
        _fail(path, "expected a boolean", value)
    if tp is int:
        if isinstance(value, bool):
            return int(value)
        if isinstance(value, int):
            return value
        if isinstance(value, float):
            if math.isfinite(value) and value == int(value):
                return int(value)
            _fail(path, "expected an integer (a float with no fraction)", value)
        if isinstance(value, str):
            m = _INT_STRING.fullmatch(value.strip())
            if m:
                return int(m.group(1))
        _fail(path, "expected an integer", value)
    if tp is float:
        if isinstance(value, (bool, int, float)):
            return float(value)
        if isinstance(value, str):
            parsed = _float_string(value)
            if parsed is not None:
                return parsed
        _fail(path, "expected a number", value)
    if origin is list or tp is list:
        if isinstance(value, (str, bytes, dict)) or not isinstance(value, (list, tuple, set, frozenset)):
            _fail(path, "expected a list", value)
        (item,) = typ.get_args(tp) or (typ.Any,)
        return [validate(item, x, f"{path}[{i}]") for i, x in enumerate(value)]
    if origin is dict or tp is dict:
        if not isinstance(value, dict):
            _fail(path, "expected a mapping", value)
        kt, vt = typ.get_args(tp) or (typ.Any, typ.Any)
        return {validate(kt, k, f"{path}.key"): validate(vt, v, f"{path}.{k}") for k, v in value.items()}
    if isinstance(tp, type) and dataclasses.is_dataclass(tp):
        if isinstance(value, tp):
            return value
        if not isinstance(value, dict):
            _fail(path, f"expected a mapping for {tp.__name__}", value)
        return _construct(tp, value, path)
    raise TypeError(f"{path}: unsupported field type {tp!r}")


_HINTS: dict[type, dict[str, typ.Any]] = {}


def _hints(cls: type) -> dict[str, typ.Any]:
    if cls not in _HINTS:
        _HINTS[cls] = typ.get_type_hints(cls)
    return _HINTS[cls]


def _construct(cls: type, data: typ.Mapping[str, typ.Any], path: str = "") -> typ.Any:
    """An instance of the dataclass `cls` from a mapping: unknown keys raise,
    each given value is validated against its field's type."""
    names = {f.name for f in dataclasses.fields(cls) if f.init}
    extra = sorted(str(k) for k in data if k not in names)
    if extra:
        raise _Invalid(f"{path or cls.__name__}: unknown field(s) {extra} for {cls.__name__}")
    if issubclass(cls, StrictModel):
        return cls(**data)  # validates in __post_init__
    hints = _hints(cls)
    out = cls(**{k: validate(hints[k], v, f"{path}.{k}" if path else k) for k, v in data.items()})
    object.__setattr__(out, "_fields_set", frozenset(data))  # read by to_dict(exclude_unset=True)
    return out


def _dump(value: typ.Any, exclude_unset: bool = False) -> typ.Any:
    """pydantic's `model_dump` of a field value: configs (and dataclasses)
    become dicts, recursively through lists and dicts; with `exclude_unset`
    a config keeps only the fields its input named."""
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        names = [f.name for f in dataclasses.fields(value)]
        if exclude_unset:
            given = getattr(value, "_fields_set", None)
            names = [n for n in names if given is None or n in given]
        return {n: _dump(getattr(value, n), exclude_unset) for n in names}
    if isinstance(value, list):
        return [_dump(x, exclude_unset) for x in value]
    if isinstance(value, dict):
        return {k: _dump(v, exclude_unset) for k, v in value.items()}
    return value


class StrictModel:
    """A frozen, extra-forbidding config: each subclass becomes a dataclass
    whose fields are validated at construction (see the module docstring)."""

    def __init_subclass__(cls, **kw: typ.Any) -> None:
        super().__init_subclass__(**kw)
        dataclasses.dataclass(cls)
        generated = cls.__init__

        def __init__(self, *args: typ.Any, **kwargs: typ.Any) -> None:
            names = [f.name for f in dataclasses.fields(cls) if f.init]
            extra = sorted(k for k in kwargs if k not in names)
            if extra:
                raise ValueError(f"unknown field(s) {extra} for {cls.__name__}")
            if len(args) > len(names):
                raise ValueError(f"{cls.__name__} takes at most {len(names)} positional fields")
            object.__setattr__(self, "_mutable", True)
            generated(self, *args, **kwargs)
            object.__setattr__(self, "_fields_set", frozenset(names[: len(args)]) | frozenset(kwargs))
            object.__setattr__(self, "_mutable", False)

        __init__.__qualname__ = f"{cls.__qualname__}.__init__"
        cls.__init__ = __init__

    def __post_init__(self) -> None:
        hints = _hints(type(self))
        for f in dataclasses.fields(self):
            object.__setattr__(self, f.name, validate(hints[f.name], getattr(self, f.name), f.name))

    def __setattr__(self, name: str, value: typ.Any) -> None:
        if not getattr(self, "_mutable", False):
            raise ValueError(f"{type(self).__name__} is frozen: use AllowMutations to set {name!r}")
        object.__setattr__(self, name, value)

    __hash__ = None  # type: ignore[assignment]

    @classmethod
    def model_validate(cls: type[M], data: typ.Mapping[str, typ.Any]) -> M:
        """An instance from a mapping (pydantic's `model_validate`)."""
        if isinstance(data, cls):
            return data
        if not isinstance(data, typ.Mapping):
            raise ValueError(f"{cls.__name__} takes a mapping, got {data!r}")
        return cls(**dict(data))

    @property
    def fields_set(self) -> frozenset[str]:
        """The names the input gave (pydantic's `model_fields_set`)."""
        return self._fields_set

    def replace(self: M, **changes: typ.Any) -> M:
        """A copy with `changes` applied and validated; the fields set are
        this model's and the changed ones (pydantic's `model_copy(update=...)`)."""
        values = {f.name: getattr(self, f.name) for f in dataclasses.fields(self) if f.init}
        values.update(changes)
        out = type(self)(**values)
        object.__setattr__(out, "_fields_set", self._fields_set | frozenset(changes))
        return out

    def to_dict(self, exclude_unset: bool = False) -> dict[str, typ.Any]:
        """pydantic's `model_dump()` (and `model_dump(exclude_unset=True)`)."""
        return _dump(self, exclude_unset)

    def to_json(self, indent: typ.Optional[int] = 2) -> str:
        """The JSON text of `to_dict()` (pydantic's `model_dump_json(indent=2)`)."""
        return json.dumps(self.to_dict(), indent=indent)


@contextlib.contextmanager
def AllowMutations(model: StrictModel) -> typ.Iterator[StrictModel]:
    """Temporarily lift the frozen flag."""
    original = model._mutable
    object.__setattr__(model, "_mutable", True)
    try:
        yield model
    finally:
        object.__setattr__(model, "_mutable", original)


def apply_diff(base: M, diff: typ.Union[typ.Mapping[str, typ.Any], StrictModel, None]) -> M:
    """`base + diff`: non-None diff fields override base, recursively for
    nested models/dicts. Returns a new validated model."""
    if diff is None:
        return base
    if isinstance(diff, StrictModel):
        diff = diff.to_dict(exclude_unset=True)
    merged = base.to_dict()

    def merge(dst: dict, src: typ.Mapping) -> None:
        for k, v in src.items():
            if v is None:
                continue
            if isinstance(v, typ.Mapping) and isinstance(dst.get(k), dict):
                merge(dst[k], v)
            else:
                dst[k] = v

    merge(merged, diff)
    return type(base).model_validate(merged)
