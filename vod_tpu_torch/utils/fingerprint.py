"""Deterministic content fingerprints, the keys of the index and embedding
caches (port of `vod_tpu/utils/fingerprint.py`).

The same content gives the same 16-hex-char digest as the JAX package's:
dicts hash in sorted key order, scalars by `repr`, arrays by shape, dtype and
bytes. A torch tensor hashes as the numpy array of its values (a bf16 tensor
as its float32 widening, which holds the same values).

`fingerprint_params` of a torch module hashes each tensor of its
`state_dict` under its flax key path (`models/convert.py:flax_path`), viewed
in flax's layout (`convert.flax_layout`), in the order in which JAX flattens
a parameter dict: weights carried over from JAX give JAX's key.
`fingerprint_tokenizer` hashes the tokenizer's class name, so the port's
WordPiece tokenizer keys differ from a `transformers` tokenizer's over the
same vocabulary (a declared difference).
"""

from __future__ import annotations

import hashlib
import json
import re
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


def _flat_items(tree: typ.Mapping, prefix: tuple = ()) -> typ.Iterator[tuple[tuple, typ.Any]]:
    for k in sorted(tree, key=str):
        if isinstance(tree[k], typ.Mapping):
            yield from _flat_items(tree[k], prefix + (str(k),))
        else:
            yield prefix + (str(k),), tree[k]


def fingerprint_params(params: typ.Any) -> str:
    """Fingerprint a model's weights: a torch module (its `state_dict`, each
    tensor under its flax key path in flax's layout) or a nested dict of
    arrays (as `jax.tree_util` flattens it: keys sorted at every level)."""
    if isinstance(params, torch.nn.Module):
        from vod_tpu_torch.models.convert import flax_layout, flax_path

        leaves = sorted(
            (tuple(re.findall(r"\['(.*?)'\]", flax_path(name))), flax_layout(params, name).to_flax(t.detach()))
            for name, t in params.state_dict().items()
        )
    else:
        leaves = list(_flat_items(params))
    h = hashlib.blake2b(digest_size=8)
    for path, leaf in leaves:
        h.update("".join(f"['{p}']" for p in path).encode())
        _update(h, leaf.contiguous() if isinstance(leaf, torch.Tensor) else leaf)
    return h.hexdigest()


def fingerprint_dataset(dataset: typ.Any) -> str:
    """Fingerprint a dataset: its own `_fingerprint` when it has one (a HF
    dataset), else its length and first row."""
    fp = getattr(dataset, "_fingerprint", None)
    if fp:
        return fingerprint(fp)
    return fingerprint({"len": len(dataset), "first": dataset[0] if len(dataset) else None})


def fingerprint_tokenizer(tokenizer: typ.Any) -> str:
    """Fingerprint a tokenizer by vocab, special tokens and class name."""
    try:
        vocab = tokenizer.get_vocab()
        spec = {
            "class": type(tokenizer).__name__,
            "vocab_size": len(vocab),
            "vocab_hash": fingerprint(json.dumps(sorted(vocab.items())[:1000])),
            "specials": str(getattr(tokenizer, "special_tokens_map", {})),
        }
    except Exception:  # noqa: BLE001 - a tokenizer without a vocab hashes by its repr
        spec = {"class": type(tokenizer).__name__, "repr": repr(tokenizer)}
    return fingerprint(spec)
