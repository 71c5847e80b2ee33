"""Carry flax weights over to the port, and name each port parameter's flax path.

`flax_to_state_dict` takes the flax parameter tree as nested dicts of numpy
arrays (`jax.device_get(params)` gives that) and returns the `state_dict` of
`vod_tpu_torch.models.encoder.VodEncoder` (or `DebugEncoder`);
`lm_flax_to_state_dict` does the same for the reader `CausalLM`, and
`system_flax_to_state_dict` for a whole `Ranker` or `Realm` (the `encoder`
subtree, plus the `lm` subtree of a `Realm`). flax stores a Dense kernel as
`[in, out]` and attention kernels as `[H, heads, head_dim]` (query/key/value)
and `[heads, head_dim, H]` (out); `nn.Linear` wants `[out, in]`, so each is
flattened and transposed here. The same functions carry a tree of flax
gradients over, since it has the parameters' structure.

`flax_path` maps a port parameter name back to its flax path, which the
optimizer's weight-decay groups are chosen by (`runtime/optim.py`).

`dense_index_from_fields` carries a JAX `PQIndex` or `IVFIndex` over: its
fields as numpy arrays (`np.asarray` of each array) plus its static fields;
`sparse_index_from_fields` does the same for a JAX BM25 `SparseIndex`.
"""

from __future__ import annotations

import dataclasses
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


def lm_flax_to_state_dict(params: typ.Mapping) -> dict[str, torch.Tensor]:
    """flax params of `CausalLM` -> the port's `CausalLM.state_dict`."""
    p = params.get("params", params)
    sd: dict[str, torch.Tensor] = {
        "wte.weight": _t(p["wte"]["embedding"]),
        "wpe.weight": _t(p["wpe"]["embedding"]),
    }
    _norm("ln_f", p["ln_f"], sd)
    if "lm_head" in p:
        sd["lm_head.weight"] = _t(np.asarray(p["lm_head"]["kernel"], dtype=np.float32).T)
    i = 0
    while f"layer_{i}" in p:
        layer, prefix = p[f"layer_{i}"], f"layers.{i}"
        _norm(f"{prefix}.ln1", layer["ln1"], sd)
        _norm(f"{prefix}.ln2", layer["ln2"], sd)
        for name in ("query", "key", "value"):
            _attention_in(f"{prefix}.{name}", layer[name], sd)
        for name in ("out", "fc_in", "fc_out"):  # out: [heads, head_dim, H] -> [H, H]
            _dense(f"{prefix}.{name}", layer[name], sd)
        i += 1
    return sd


def system_flax_to_state_dict(params: typ.Mapping) -> dict[str, torch.Tensor]:
    """flax params of `Ranker` or `Realm` -> the port's `state_dict`."""
    p = params.get("params", params)
    sd = {f"encoder.{k}": v for k, v in flax_to_state_dict(p["encoder"]).items()}
    if "lm" in p:
        sd.update({f"lm.{k}": v for k, v in lm_flax_to_state_dict(p["lm"]).items()})
    return sd


_NORMS = ("LayerNorm", "attention_norm", "output_norm", "ln1", "ln2", "ln_f")
_EMBEDDINGS = ("word_embeddings", "position_embeddings", "token_type_embeddings", "wte", "wpe")


def flax_path(name: str) -> str:
    """The flax path, as `jax.tree_util.keystr` writes it under `params`, of a
    port parameter of an encoder, a reader, a `Ranker` or a `Realm`:
    `layers.3` -> `layer_3`, the encoder's `backbone.layers.3` ->
    `backbone/layer_3`, and a weight named after its flax leaf (`embedding`,
    `scale` or `kernel`)."""
    parts = name.split(".")
    out: list[str] = []
    i = 0
    while i < len(parts):
        if parts[i] == "layers" and i + 1 < len(parts):
            out.append(f"layer_{parts[i + 1]}")
            i += 2
            continue
        out.append(parts[i])
        i += 1
    if out[-1] == "weight":
        owner = out[-2] if len(out) > 1 else ""
        out[-1] = "embedding" if owner in _EMBEDDINGS else "scale" if owner in _NORMS else "kernel"
    return "".join(f"['{part}']" for part in ["params", *out])



def dense_index_from_fields(
    fields: typ.Mapping[str, typ.Any], *, device: typ.Union[str, torch.device] = "cuda"
) -> typ.Any:
    """The port's `PQIndex` (fields with `codebooks`) or `IVFIndex` (with
    `centroids`) from a JAX index's fields: arrays as numpy (None where the
    JAX field is None), static fields as they are. The TPU-only
    `fused_qblock` is dropped, and the coarse int8 codes get the port's zero
    columns up to a multiple of 16."""
    from vod_tpu_torch.search import dense

    def tensor(x: typ.Any) -> typ.Optional[torch.Tensor]:
        if x is None:
            return None
        a = np.array(x)
        if a.dtype.name == "bfloat16":  # ml_dtypes' bf16: carry the bits over
            return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device).contiguous()
        return torch.from_numpy(a).to(device).contiguous()

    if "codebooks" in fields:
        cls = dense.PQIndex
    elif "centroids" in fields:
        cls = dense.IVFIndex
    else:
        raise ValueError(f"not a PQIndex or IVFIndex: fields {sorted(fields)}")
    names = {f.name for f in dataclasses.fields(cls)}
    kw = {k: (tensor(v) if hasattr(v, "__array__") else v) for k, v in fields.items() if k in names}
    if kw.get("coarse_codes") is not None:
        width = -(-int(kw["coarse_codes"].shape[1]) // dense._COARSE_COLS) * dense._COARSE_COLS
        kw["coarse_codes"] = dense._zero_cols(kw["coarse_codes"], width).contiguous()
    return cls(**kw)


def sparse_index_from_fields(
    fields: typ.Mapping[str, typ.Any], *, device: typ.Union[str, torch.device] = "cuda"
) -> typ.Any:
    """The port's `SparseIndex` from a JAX `SparseIndex`'s fields: the int32
    postings doc ids, the f32 impacts and the optional subset ids as numpy
    (None where the JAX field is None), `n_docs` and `offset` as they are."""
    from vod_tpu_torch.search.sparse import SparseIndex

    def tensor(x: typ.Any) -> typ.Optional[torch.Tensor]:
        return None if x is None else torch.from_numpy(np.array(x)).to(device).contiguous()

    return SparseIndex(
        postings_docs=tensor(fields["postings_docs"]),
        postings_impacts=tensor(fields["postings_impacts"]),
        subset_ids=tensor(fields.get("subset_ids")),
        n_docs=int(fields.get("n_docs", 0)),
        offset=int(fields.get("offset", 0)),
    )
