"""Carry the weights of the flax `VodEncoder` / `DebugEncoder` over to the port.

`flax_to_state_dict` takes the flax parameter tree as nested dicts of numpy
arrays (`jax.device_get(params)` gives that) and returns the `state_dict` of
`vod_tpu_torch.models.encoder.VodEncoder` (or `DebugEncoder`). flax stores a
Dense kernel as `[in, out]` and attention kernels as `[H, heads, head_dim]`
(query/key/value) and `[heads, head_dim, H]` (out); `nn.Linear` wants
`[out, in]`, so each is flattened and transposed here.
"""

from __future__ import annotations

import typing as typ

import numpy as np
import torch


def _t(x: typ.Any) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _dense(prefix: str, p: typ.Mapping, sd: dict[str, torch.Tensor]) -> None:
    kernel = np.asarray(p["kernel"], dtype=np.float32)
    sd[f"{prefix}.weight"] = _t(kernel.reshape(-1, kernel.shape[-1]).T)
    sd[f"{prefix}.bias"] = _t(np.asarray(p["bias"]).reshape(-1))


def _attention_in(prefix: str, p: typ.Mapping, sd: dict[str, torch.Tensor]) -> None:
    kernel = np.asarray(p["kernel"], dtype=np.float32)  # [H, heads, head_dim]
    sd[f"{prefix}.weight"] = _t(kernel.reshape(kernel.shape[0], -1).T)
    sd[f"{prefix}.bias"] = _t(np.asarray(p["bias"]).reshape(-1))


def _norm(prefix: str, p: typ.Mapping, sd: dict[str, torch.Tensor]) -> None:
    sd[f"{prefix}.weight"] = _t(p["scale"])
    sd[f"{prefix}.bias"] = _t(p["bias"])


def _pooler(p: typ.Mapping, sd: dict[str, torch.Tensor]) -> None:
    if "log_scaler" in p:
        sd["vod_pooler.log_scaler"] = _t(p["log_scaler"])
    if "projection" in p:
        _dense("vod_pooler.projection", p["projection"], sd)


def flax_to_state_dict(params: typ.Mapping) -> dict[str, torch.Tensor]:
    """flax params of `VodEncoder` or `DebugEncoder` -> the port's `state_dict`."""
    p = params.get("params", params)
    sd: dict[str, torch.Tensor] = {}
    _pooler(p.get("vod_pooler", {}), sd)
    if "backbone" not in p:  # DebugEncoder
        sd["word_embeddings.weight"] = _t(p["word_embeddings"]["embedding"])
        return sd
    bb = p["backbone"]
    emb = bb["embeddings"]
    for name in ("word_embeddings", "position_embeddings", "token_type_embeddings"):
        if name in emb:
            sd[f"backbone.embeddings.{name}.weight"] = _t(emb[name]["embedding"])
    _norm("backbone.embeddings.LayerNorm", emb["LayerNorm"], sd)
    i = 0
    while f"layer_{i}" in bb:
        layer, prefix = bb[f"layer_{i}"], f"backbone.layers.{i}"
        attn = layer["attention"]
        for name in ("query", "key", "value"):
            _attention_in(f"{prefix}.attention.{name}", attn[name], sd)
        _dense(f"{prefix}.attention.out", attn["out"], sd)  # [heads, head_dim, H] -> [H, H]
        _norm(f"{prefix}.attention_norm", layer["attention_norm"], sd)
        _dense(f"{prefix}.intermediate", layer["intermediate"], sd)
        _dense(f"{prefix}.output", layer["output"], sd)
        _norm(f"{prefix}.output_norm", layer["output_norm"], sd)
        i += 1
    return sd
