"""Hugging Face BERT-family encoder checkpoints into the port's
`TransformerEncoder` (port of `vod_tpu/models/hf_import.py`).

`load_hf_encoder(name_or_path)` reads a local checkpoint directory with no
`transformers` and no `safetensors`: `config.json`, plus `model.safetensors`
(read here: an 8-byte little-endian header length, a JSON header of dtype,
shape and data offsets per tensor, then the raw bytes) or
`pytorch_model.bin` (`torch.load(weights_only=True)`). A hub id such as
`intfloat/e5-large-v2` resolves in the offline Hugging Face cache:
`$HF_HOME/hub`, else `~/.cache/huggingface/hub`, where
`models--intfloat--e5-large-v2/refs/main` names the snapshot. The JAX
version calls `transformers.AutoModel.from_pretrained` instead.

HF `nn.Linear` weights are `[out, in]`, as the port's, so the port carries
each tensor over as it is, renamed (old checkpoints' LayerNorm `gamma` /
`beta` too). RoBERTa, XLM-R and CamemBERT differ from BERT in the position
table's two leading rows (`position_offset` 2, sliced off so arange positions
line up) and one token-type row.

The port's encoder uses the tanh GELU, as the JAX one does; BERT checkpoints
were trained with the erf GELU, so outputs differ from `transformers` by
about 1e-4 at toy widths.
"""

from __future__ import annotations

import json
import os
import pathlib
import struct
import typing as typ

import torch

from .encoder import TransformerEncoderConfig
from .pooler import VodPoolerConfig

_ROBERTA_TYPES = ("roberta", "xlm-roberta", "camembert")
# I64: checkpoints saved before transformers 4.31 hold the `position_ids` buffer
_SAFETENSORS_DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16, "I64": torch.int64}


def _field(hf_config: typ.Any, name: str, default: typ.Any = None) -> typ.Any:
    if isinstance(hf_config, typ.Mapping):
        return hf_config.get(name, default)
    return getattr(hf_config, name, default)


def config_from_hf(
    hf_config: typ.Any,
    pooler: typ.Optional[VodPoolerConfig] = None,
    dtype: torch.dtype = torch.float32,
    position_offset: int = 0,
) -> TransformerEncoderConfig:
    """The encoder config of a `config.json` dict (or a `transformers`
    config). `position_offset=2` for RoBERTa/XLM-R."""
    return TransformerEncoderConfig(
        vocab_size=_field(hf_config, "vocab_size"),
        hidden_size=_field(hf_config, "hidden_size"),
        num_layers=_field(hf_config, "num_hidden_layers"),
        num_heads=_field(hf_config, "num_attention_heads"),
        intermediate_size=_field(hf_config, "intermediate_size"),
        max_position_embeddings=_field(hf_config, "max_position_embeddings") - position_offset,
        type_vocab_size=_field(hf_config, "type_vocab_size", 2),
        layer_norm_eps=_field(hf_config, "layer_norm_eps", 1e-12),
        dtype=dtype,
        pooler=pooler or VodPoolerConfig(),
    )


def read_safetensors(path: typ.Union[str, pathlib.Path]) -> dict[str, torch.Tensor]:
    """Every tensor of a `.safetensors` file, on the CPU (F32, F16, BF16, I64)."""
    data = bytearray(pathlib.Path(path).read_bytes())
    (n,) = struct.unpack("<Q", data[:8])
    header = json.loads(data[8 : 8 + n])
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in _SAFETENSORS_DTYPES:
            raise ValueError(f"{path}: tensor {name!r} has dtype {info['dtype']}, not one of "
                             f"{list(_SAFETENSORS_DTYPES)}")
        dtype = _SAFETENSORS_DTYPES[info["dtype"]]
        start, end = info["data_offsets"]
        count = (end - start) // dtype.itemsize
        flat = torch.empty(0, dtype=dtype)
        if count:
            flat = torch.frombuffer(data, dtype=dtype, count=count, offset=8 + n + start)
        out[name] = flat.reshape(info["shape"])
    return out


def write_safetensors(path: typ.Union[str, pathlib.Path], tensors: typ.Mapping[str, torch.Tensor]) -> None:
    """Write CPU tensors (F32, F16, BF16, I64) as a `.safetensors` file."""
    names = {v: k for k, v in _SAFETENSORS_DTYPES.items()}
    header, blobs, offset = {}, [], 0
    for name, t in tensors.items():
        raw = t.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
        header[name] = {"dtype": names[t.dtype], "shape": list(t.shape), "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for raw in blobs:
            f.write(raw)


def port_bert_weights(
    state_dict: typ.Mapping[str, torch.Tensor], cfg: TransformerEncoderConfig
) -> dict[str, torch.Tensor]:
    """A torch BERT `state_dict` -> the port's `TransformerEncoder.state_dict`
    (f32). Takes bare (`embeddings.*`) and prefixed (`bert.*`) keys."""
    sd = {k.replace("LayerNorm.gamma", "LayerNorm.weight").replace("LayerNorm.beta", "LayerNorm.bias"): v
          for k, v in state_dict.items()}
    if any(k.startswith("bert.") for k in sd):
        sd = {k[len("bert."):]: v for k, v in sd.items() if k.startswith("bert.")}

    def g(key: str) -> torch.Tensor:
        return sd[key].detach().to(torch.float32).contiguous()

    names = ["word_embeddings", "position_embeddings"] + (["token_type_embeddings"] if cfg.type_vocab_size else [])
    out = {f"embeddings.{n}.weight": g(f"embeddings.{n}.weight") for n in names}
    out["embeddings.LayerNorm.weight"] = g("embeddings.LayerNorm.weight")
    out["embeddings.LayerNorm.bias"] = g("embeddings.LayerNorm.bias")
    renames = {
        "attention.query": "attention.self.query",
        "attention.key": "attention.self.key",
        "attention.value": "attention.self.value",
        "attention.out": "attention.output.dense",
        "attention_norm": "attention.output.LayerNorm",
        "intermediate": "intermediate.dense",
        "output": "output.dense",
        "output_norm": "output.LayerNorm",
    }
    for i in range(cfg.num_layers):
        for port, hf in renames.items():
            for leaf in ("weight", "bias"):
                out[f"layers.{i}.{port}.{leaf}"] = g(f"encoder.layer.{i}.{hf}.{leaf}")
    return out


def port_roberta_weights(
    state_dict: typ.Mapping[str, torch.Tensor], cfg: TransformerEncoderConfig, *, position_offset: int = 2
) -> dict[str, torch.Tensor]:
    """A torch RoBERTa / XLM-R `state_dict` -> the port's encoder `state_dict`:
    BERT's layout with the position table's first `position_offset` rows
    dropped."""
    sd = dict(state_dict)
    for prefix in ("roberta.", "xlm_roberta."):
        if any(k.startswith(prefix) for k in sd):
            sd = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
            break
    sd["embeddings.position_embeddings.weight"] = sd["embeddings.position_embeddings.weight"][position_offset:]
    return port_bert_weights(sd, cfg)


def resolve_checkpoint(name_or_path: str) -> pathlib.Path:
    """A local directory as it is, or a hub id's snapshot in the offline HF cache."""
    local = pathlib.Path(name_or_path)
    if local.is_dir():
        return local
    home = os.environ.get("HF_HOME") or pathlib.Path.home() / ".cache" / "huggingface"
    hub = pathlib.Path(home) / "hub"
    repo = hub / ("models--" + name_or_path.replace("/", "--"))
    ref = repo / "refs" / "main"
    if not ref.is_file():
        raise FileNotFoundError(f"{name_or_path!r} is neither a directory nor in the HF cache at {hub}")
    snapshot = repo / "snapshots" / ref.read_text().strip()
    if not snapshot.is_dir():
        raise FileNotFoundError(f"{name_or_path!r}: the cache names snapshot {snapshot}, which is missing")
    return snapshot


def load_hf_state_dict(directory: pathlib.Path) -> dict[str, torch.Tensor]:
    """`model.safetensors`, else `pytorch_model.bin`, of a checkpoint directory."""
    if (directory / "model.safetensors").is_file():
        return read_safetensors(directory / "model.safetensors")
    if (directory / "pytorch_model.bin").is_file():
        return torch.load(directory / "pytorch_model.bin", map_location="cpu", weights_only=True)
    raise FileNotFoundError(f"{directory} holds neither model.safetensors nor pytorch_model.bin")


def load_hf_encoder(
    name_or_path: str,
    pooler: typ.Optional[VodPoolerConfig] = None,
    dtype: torch.dtype = torch.float32,
) -> tuple[TransformerEncoderConfig, dict[str, torch.Tensor]]:
    """Read a local or cached BERT-family checkpoint and port it: returns
    (config, the port's `TransformerEncoder.state_dict`). The layout (BERT,
    or RoBERTa / XLM-R / CamemBERT) follows `config.json`'s `model_type`."""
    directory = resolve_checkpoint(name_or_path)
    hf_config = json.loads((directory / "config.json").read_text())
    state_dict = load_hf_state_dict(directory)
    if hf_config.get("model_type", "bert") in _ROBERTA_TYPES:
        cfg = config_from_hf(hf_config, pooler=pooler, dtype=dtype, position_offset=2)
        return cfg, port_roberta_weights(state_dict, cfg)
    cfg = config_from_hf(hf_config, pooler=pooler, dtype=dtype)
    return cfg, port_bert_weights(state_dict, cfg)
