"""Deterministic content fingerprints, the key of the index cache (the port's
copy of `fingerprint` from `vod_tpu/utils/fingerprint.py`).

The same content gives the same 16-hex-char digest as the JAX package's:
dicts hash in sorted key order, scalars by `repr`, arrays by shape, dtype and
bytes. A torch tensor hashes as the numpy array of its values (a bf16 tensor
as its float32 widening, which holds the same values).
"""

from __future__ import annotations

import hashlib
import typing as typ

import numpy as np
import torch


def _update(h: "hashlib._Hash", obj: typ.Any) -> None:
    if obj is None:
        h.update(b"~none~")
    elif isinstance(obj, (str, int, float, bool)):
        h.update(repr(obj).encode())
    elif isinstance(obj, bytes):
        h.update(obj)
    elif isinstance(obj, dict):
        for k in sorted(obj, key=str):
            _update(h, str(k))
            _update(h, obj[k])
    elif isinstance(obj, (list, tuple)):
        for x in obj:
            _update(h, x)
    elif isinstance(obj, np.ndarray):
        h.update(str(obj.shape).encode())
        h.update(str(obj.dtype).encode())
        h.update(np.ascontiguousarray(obj).tobytes())
    elif isinstance(obj, torch.Tensor):
        t = obj.detach().cpu()
        _update(h, (t.float() if t.dtype == torch.bfloat16 else t).numpy())
    elif callable(obj):
        h.update(getattr(obj, "__qualname__", repr(obj)).encode())
    else:
        h.update(repr(obj).encode())


def fingerprint(obj: typ.Any) -> str:
    """Deterministic 16-hex-char digest of (nested) python/numpy/torch content."""
    h = hashlib.blake2b(digest_size=8)
    _update(h, obj)
    return h.hexdigest()
