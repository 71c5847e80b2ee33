"""Carry flax weights over to the port, and name each port parameter's flax path.

`flax_to_state_dict` takes the flax parameter tree as nested dicts of numpy
arrays (`jax.device_get(params)` gives that) and returns the `state_dict` of
`vod_tpu_torch.models.encoder.VodEncoder` (or `DebugEncoder`);
`lm_flax_to_state_dict` does the same for the reader `CausalLM`,
`t5_flax_to_state_dict` for a `T5Encoder` or `VodT5Encoder`,
`seq2seq_flax_to_state_dict` for the seq2seq reader `Seq2SeqLM`, and
`system_flax_to_state_dict` for a whole `Ranker`, `Realm` or `Seq2SeqRealm`
(the `encoder` subtree, plus the `lm` or `reader` subtree). flax stores a Dense kernel as
`[in, out]` and attention kernels as `[H, heads, head_dim]` (query/key/value)
and `[heads, head_dim, H]` (out); `nn.Linear` wants `[out, in]`, so each is
flattened and transposed here. The same functions carry a tree of flax
gradients over, since it has the parameters' structure.

`flax_path` maps a port parameter name back to its flax path, which the
optimizer's weight-decay groups are chosen by (`runtime/optim.py`).

`dense_index_from_fields` carries a JAX `PQIndex` or `IVFIndex` over: its
fields as numpy arrays (`np.asarray` of each array) plus its static fields;
`ivfpq_index_from_fields` does the same for a JAX `IVFPQIndex` and
`sparse_index_from_fields` for a JAX BM25 `SparseIndex`.
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


def _kernel(prefix: str, p: typ.Mapping, sd: dict[str, torch.Tensor]) -> None:
    """A bias-free flax Dense ([in, out]) -> an `nn.Linear` weight ([out, in])."""
    sd[f"{prefix}.weight"] = _t(np.asarray(p["kernel"], dtype=np.float32).T)


def _t5_block_common(prefix: str, blk: typ.Mapping, sd: dict[str, torch.Tensor]) -> None:
    for name in ("ln0", "ln1", "ln2"):
        if name in blk:  # T5's RMSNorm keeps its flax name, `weight`
            sd[f"{prefix}.{name}.weight"] = _t(blk[name]["weight"])
    for name in ("wi", "wo"):
        _kernel(f"{prefix}.{name}", blk[name], sd)


def t5_flax_to_state_dict(params: typ.Mapping) -> dict[str, torch.Tensor]:
    """flax params of `T5Encoder` or `VodT5Encoder` -> the port's `state_dict`."""
    p = params.get("params", params)
    if "backbone" in p:  # VodT5Encoder
        sd = {f"backbone.{k}": v for k, v in t5_flax_to_state_dict(p["backbone"]).items()}
        _pooler(p.get("vod_pooler", {}), sd)
        return sd
    sd = {"shared.weight": _t(p["shared"]["embedding"]), "final_norm.weight": _t(p["final_norm"]["weight"])}
    i = 0
    while f"block_{i}" in p:
        blk, prefix = p[f"block_{i}"], f"blocks.{i}"
        _t5_block_common(prefix, blk, sd)
        attn = blk["attention"]
        for name in ("q", "k", "v", "o"):
            _kernel(f"{prefix}.attention.{name}", attn[name], sd)
        if "relative_attention_bias" in attn:
            sd[f"{prefix}.attention.relative_attention_bias"] = _t(attn["relative_attention_bias"])
        i += 1
    return sd


def seq2seq_flax_to_state_dict(params: typ.Mapping) -> dict[str, torch.Tensor]:
    """flax params of `Seq2SeqLM` -> the port's `Seq2SeqLM.state_dict`."""
    p = params.get("params", params)
    sd = {f"encoder.{k}": v for k, v in t5_flax_to_state_dict(p["encoder"]).items()}
    sd["dec_embed.weight"] = _t(p["dec_embed"]["embedding"])
    sd["final_norm.weight"] = _t(p["final_norm"]["weight"])
    _kernel("lm_head", p["lm_head"], sd)
    i = 0
    while f"block_{i}" in p:
        blk, prefix = p[f"block_{i}"], f"blocks.{i}"
        _t5_block_common(prefix, blk, sd)
        for name in ("self_q", "self_k", "self_v", "self_o"):
            _kernel(f"{prefix}.{name}", blk[name], sd)
        for name in ("q", "k", "v", "o"):
            _kernel(f"{prefix}.cross_attention.{name}", blk["cross_attention"][name], sd)
        if "relative_attention_bias" in blk:
            sd[f"{prefix}.relative_attention_bias"] = _t(blk["relative_attention_bias"])
        i += 1
    return sd


def system_flax_to_state_dict(params: typ.Mapping) -> dict[str, torch.Tensor]:
    """flax params of `Ranker`, `Realm` or `Seq2SeqRealm` -> the port's `state_dict`."""
    p = params.get("params", params)
    sd = {f"encoder.{k}": v for k, v in flax_to_state_dict(p["encoder"]).items()}
    if "lm" in p:
        sd.update({f"lm.{k}": v for k, v in lm_flax_to_state_dict(p["lm"]).items()})
    if "reader" in p:
        sd.update({f"reader.{k}": v for k, v in seq2seq_flax_to_state_dict(p["reader"]).items()})
    return sd


_NORMS = ("LayerNorm", "attention_norm", "output_norm", "ln1", "ln2", "ln_f")
_EMBEDDINGS = ("word_embeddings", "position_embeddings", "token_type_embeddings", "wte", "wpe", "shared", "dec_embed")
_T5_NORMS = ("ln0", "ln1", "ln2", "final_norm")


def flax_path(name: str) -> str:
    """The flax path, as `jax.tree_util.keystr` writes it under `params`, of a
    port parameter of an encoder, a reader, a `Ranker`, a `Realm` or a
    `Seq2SeqRealm`: `layers.3` -> `layer_3`, `blocks.3` -> `block_3`, the
    encoder's `backbone.layers.3` -> `backbone/layer_3`, and a weight named
    after its flax leaf (`embedding`, `scale` or `kernel`; a T5 RMSNorm's
    stays `weight`)."""
    parts = name.split(".")
    out: list[str] = []
    i = 0
    while i < len(parts):
        if parts[i] in ("layers", "blocks") and i + 1 < len(parts):
            out.append(f"{parts[i][:-1]}_{parts[i + 1]}")
            i += 2
            continue
        out.append(parts[i])
        i += 1
    owner = out[-2] if len(out) > 1 else ""
    t5_norm = owner in _T5_NORMS and (owner == "final_norm" or any(part.startswith("block_") for part in out))
    if out[-1] == "weight" and not t5_norm:
        out[-1] = "embedding" if owner in _EMBEDDINGS else "scale" if owner in _NORMS else "kernel"
    return "".join(f"['{part}']" for part in ["params", *out])



def _field_tensor(x: typ.Any, device: typ.Union[str, torch.device]) -> typ.Optional[torch.Tensor]:
    """A numpy field as a tensor on `device`, None as None; bf16 arrays
    (ml_dtypes) come over by their bits."""
    if x is None:
        return None
    a = np.array(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device).contiguous()
    return torch.from_numpy(a).to(device).contiguous()


def ivfpq_index_from_fields(
    fields: typ.Mapping[str, typ.Any], *, device: typ.Union[str, torch.device] = "cuda"
) -> typ.Any:
    """The port's `IVFPQIndex` from a JAX `IVFPQIndex`'s fields: arrays as
    numpy (None where the JAX field is None), the static metadata (`n_real`,
    `offset`, `window`, `nprobe`, `max_windows`, `k_factor`, `code_bits`,
    `approx_recall`, `spilled`) as they are."""
    from vod_tpu_torch.search.ivfpq import IVFPQIndex

    names = {f.name for f in dataclasses.fields(IVFPQIndex)}
    if not {"centroids", "win_start", "win_count"} <= set(fields):
        raise ValueError(f"not an IVFPQIndex: fields {sorted(fields)}")
    return IVFPQIndex(**{
        k: (_field_tensor(v, device) if v is None or hasattr(v, "__array__") else v)
        for k, v in fields.items() if k in names
    })


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
        return _field_tensor(x, device)

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
