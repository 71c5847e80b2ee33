"""Array serialization for cross-process transport (own copy of `vod_tpu/search/io.py`).

Base64-encoded numpy arrays inside JSON payloads, the wire format of the
search server. Only the serving wrapper uses it.
"""

from __future__ import annotations

import base64
import io
import typing as typ

import numpy as np


def encode_array(x: typ.Any) -> dict:
    arr = np.asarray(x)
    buf = io.BytesIO()
    np.save(buf, arr, allow_pickle=False)
    return {"__np__": base64.b64encode(buf.getvalue()).decode("ascii")}


def decode_array(d: typ.Mapping) -> np.ndarray:
    raw = base64.b64decode(d["__np__"])
    return np.load(io.BytesIO(raw), allow_pickle=False)


def encode_payload(payload: typ.Mapping[str, typ.Any]) -> dict:
    return {
        k: encode_array(v) if isinstance(v, np.ndarray) or hasattr(v, "shape") else v
        for k, v in payload.items()
        if v is not None
    }


def decode_payload(payload: typ.Mapping[str, typ.Any]) -> dict:
    return {
        k: decode_array(v) if isinstance(v, dict) and "__np__" in v else v
        for k, v in payload.items()
    }
