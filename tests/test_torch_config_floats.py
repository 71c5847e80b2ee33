"""Float strings in the port's config validation (`configs/base.py:
validate`) against pydantic's (`pydantic.TypeAdapter(float)`, the JAX
package's configs, `vod_tpu/configs/base.py`).

pydantic reads a float string with Rust's `f64` grammar: first the string
trimmed of White_Space, then, if that fails, the untrimmed string with its
single underscores removed where none stands at either end. So `"-_1"` and
`"1e_3"` are numbers, `"_1"` and `"1__0"` are not. Each value of the table
is one case, then a seeded sweep of 2,000 strings over `0123456789_.eE+-`
(length 1-6) must give the same value or the same refusal; the values are
compared exactly (NaN to NaN).
"""

import math
import random

import pydantic
import pytest

from vod_tpu_torch.configs.base import validate

_ADAPTER = pydantic.TypeAdapter(float)

TABLE = {
    "-_1": -1.0, "+_1": 1.0, "-_1.5": -1.5, "1e_3": 1000.0, "1_e3": 1000.0, "1_000.5": 1000.5, " 1.5 ": 1.5,
    "inf": math.inf, "-Infinity": -math.inf, "nan": math.nan,
    "_1": None, "1_": None, "1__0": None, "1e3_": None,
    "٣": None, "1e١": None,  # other scripts' digits stay refused
}


def _port(v: str):
    try:
        return validate(float, v)
    except ValueError:
        return None


def _pydantic(v: str):
    try:
        return _ADAPTER.validate_python(v)
    except pydantic.ValidationError:
        return None


def _same(a, b) -> bool:
    if a is None or b is None:
        return a is b
    return (math.isnan(a) and math.isnan(b)) or a == b


@pytest.mark.parametrize("value", list(TABLE), ids=[repr(v) for v in TABLE])
def test_the_table_reads_as_pydantic_reads_it(value: str) -> None:
    want = TABLE[value]
    assert _same(_pydantic(value), want)
    got = _port(value)
    assert _same(got, want), (value, got, want)
    assert got is None or type(got) is float


def test_a_seeded_sweep_agrees_with_pydantic() -> None:
    rng = random.Random(17)
    values = {"".join(rng.choice("0123456789_.eE+-") for _ in range(rng.randint(1, 6))) for _ in range(2000)}
    read = sum(_pydantic(v) is not None for v in values)
    assert read > 200  # the sweep holds numbers as well as refusals
    for v in sorted(values):
        assert _same(_port(v), _pydantic(v)), v
