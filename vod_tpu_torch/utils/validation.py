"""Declarative shape and dtype checks of tensors and arrays (port of
`vod_tpu/utils/validation.py`), for batch-schema contracts at module
boundaries. A dtype is named as numpy and JAX name it (`"int32"`); a torch
dtype is read without its `torch.` prefix."""

from __future__ import annotations

import typing as typ


class ShapeError(ValueError):
    pass


def _dtype_name(x: typ.Any) -> typ.Optional[str]:
    dtype = getattr(x, "dtype", None)
    return None if dtype is None else str(dtype).removeprefix("torch.")


def check_array(
    x: typ.Any,
    *,
    shape: typ.Optional[typ.Sequence[typ.Union[int, str, None]]] = None,
    dtype: typ.Optional[str] = None,
    name: str = "array",
    dims: typ.Optional[dict[str, int]] = None,
) -> dict[str, int]:
    """Assert dtype and shape; shape entries may be ints, None (any), or
    string dimension variables shared across calls through `dims`:

        dims = {}
        check_array(scores, shape=("B", "D"), dims=dims)
        check_array(indices, shape=("B", "D"), dtype="int32", dims=dims)
    """
    dims = dims if dims is not None else {}
    if dtype is not None and _dtype_name(x) != dtype:
        raise ShapeError(f"{name}: expected dtype {dtype}, got {_dtype_name(x)}")
    if shape is not None:
        actual = tuple(getattr(x, "shape", ()))
        if len(actual) != len(shape):
            raise ShapeError(f"{name}: expected rank {len(shape)}, got shape {actual}")
        for i, spec in enumerate(shape):
            if spec is None:
                continue
            if isinstance(spec, int):
                if actual[i] != spec:
                    raise ShapeError(f"{name}: dim {i} expected {spec}, got {actual[i]}")
            else:
                if spec in dims and dims[spec] != actual[i]:
                    raise ShapeError(f"{name}: dim {i} ({spec}) expected {dims[spec]}, got {actual[i]}")
                dims[spec] = actual[i]
    return dims


def check_realm_batch(batch: typ.Any) -> dict[str, int]:
    """Validate the `RealmBatch` shape contract (`types/batch.py`)."""
    dims: dict[str, int] = {}
    check_array(batch.query__input_ids, shape=("B", "Lq"), name="query__input_ids", dims=dims)
    check_array(batch.query__attention_mask, shape=("B", "Lq"), name="query__attention_mask", dims=dims)
    check_array(batch.section__score, shape=("B", "D"), name="section__score", dims=dims)
    check_array(batch.section__relevance, shape=("B", "D"), name="section__relevance", dims=dims)
    check_array(batch.section__idx, shape=("B", "D"), name="section__idx", dims=dims)
    n_sec = batch.section__input_ids.shape[0]
    if not batch.extras.get("flat_sections", False):
        if n_sec != dims["B"] * dims["D"]:
            raise ShapeError(f"section__input_ids rows {n_sec} != B*D {dims['B'] * dims['D']}")
    return dims
