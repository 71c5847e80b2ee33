"""kbit (quantized-base) training, the QLoRA-style tweak (port of
`vod_tpu/models/kbit.py`).

`kbit_prepare(model, mask)` changes `model` in place: each parameter the mask
marks stays a trainable `nn.Parameter`; each frozen float parameter whose
flax leaf has two or more axes becomes int8 codes and f32 scales, held as
buffers (`<name>_codes`, `<name>_scale`); the other frozen parameters
(LayerNorms, 1-D biases) become float buffers. `model.parameters()` is then
the trainable subset, so an optimizer built afterwards, and the gradient
clip, see only it.

The quantization groups follow flax's layout, not torch's: `quantize_leaf`
reduces over every axis of the flax leaf but the last (`convert.flax_layout`
gives the view). So an attention query kernel ([H, heads, head_dim] in flax)
gets one scale per head-dim index shared across heads, its bias ([heads,
head_dim]) is quantized too, and an embedding table gets one scale per hidden
column; codes and scales keep flax's layout and equal JAX's leaf by leaf.

A quantized module dequantizes inside its forward: its weight is a property
that multiplies codes by scales in f32 (then casts to the parameter's dtype,
as JAX's `dequantize`), so only the codes persist and the full-precision
weight is a transient of one layer. A quantized embedding gathers code rows
first and dequantizes only those (the same values). Every forward of a
prepared model, the live query encoding and the periodic re-embed included,
runs through this view.
"""

from __future__ import annotations

import dataclasses
import typing as typ

import torch
from torch import nn

from .convert import FlaxLayout, flax_layout


@dataclasses.dataclass
class QuantizedLeaf:
    """Symmetric int8 quantization of a float tensor over all but its last axis."""

    codes: torch.Tensor  # int8, the leaf's (flax) shape
    scale: torch.Tensor  # f32, [1, ..., 1, last]
    dtype: torch.dtype = torch.float32

    def dequantize(self) -> torch.Tensor:
        return (self.codes.to(torch.float32) * self.scale).to(self.dtype)


def quantize_leaf(x: torch.Tensor) -> QuantizedLeaf:
    """Symmetric int8 over all-but-last axes (per output channel of a flax kernel)."""
    xf = x.to(torch.float32)
    absmax = xf.abs().amax(dim=tuple(range(x.ndim - 1)), keepdim=True)
    # a tensor divisor: CUDA divides by a Python scalar as a product with its
    # reciprocal, which rounds otherwise than JAX's division
    scale = torch.clamp(absmax, min=1e-12) / torch.full_like(absmax, 127.0)
    codes = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return QuantizedLeaf(codes=codes.contiguous(), scale=scale, dtype=x.dtype)


@dataclasses.dataclass
class KbitParams:
    """A prepared model's parameters by name: the trainable `nn.Parameter`s,
    and the frozen leaves (a `QuantizedLeaf` over the model's code and scale
    buffers, or a float buffer). A view of the model's tensors as they are."""

    trainable: dict[str, torch.Tensor]
    frozen: dict[str, typ.Union[QuantizedLeaf, torch.Tensor]]


def _dequantized(attr: str, layout: FlaxLayout, dtype: torch.dtype) -> property:
    def get(module: nn.Module) -> torch.Tensor:
        leaf = QuantizedLeaf(module._buffers[f"{attr}_codes"], module._buffers[f"{attr}_scale"], dtype)
        return layout.from_flax(leaf.dequantize())

    return property(get)


def _embedding_forward(module: nn.Embedding, input: torch.Tensor) -> torch.Tensor:
    leaf = QuantizedLeaf(module.weight_codes[input], module.weight_scale, module._kbit_attrs["weight"])
    return leaf.dequantize()


def _swap_class(module: nn.Module, attrs: dict[str, tuple[FlaxLayout, torch.dtype]]) -> None:
    """Give `module` a subclass of its class in which each quantized attribute
    is a dequantizing property (what `torch.nn.utils.parametrize` does, with
    the codes as buffers)."""
    cls = type(module)
    body: dict[str, typ.Any] = {a: _dequantized(a, layout, dt) for a, (layout, dt) in attrs.items()}
    body["_kbit_attrs"] = {a: dt for a, (_, dt) in attrs.items()}
    if isinstance(module, nn.Embedding) and "weight" in attrs:
        body["forward"] = _embedding_forward
    module.__class__ = type(f"Kbit{cls.__name__}", (cls,), body)


def kbit_prepare(model: nn.Module, trainable_mask: typ.Mapping[str, bool]) -> KbitParams:
    """Split `model`'s parameters by the mask (one entry per parameter name,
    e.g. `encoder.lora_trainable_mask(model)`) and int8-quantize the frozen
    float leaves of two or more flax axes, in place. Returns the split."""
    names = [n for n, _ in model.named_parameters()]
    if set(names) != set(trainable_mask):
        raise ValueError("the mask must name every parameter of the model")
    layouts = {n: flax_layout(model, n) for n in names}
    quantized: dict[nn.Module, dict[str, tuple[FlaxLayout, torch.dtype]]] = {}
    frozen_names: list[str] = []
    for name, p in list(model.named_parameters()):
        if trainable_mask[name]:
            continue
        *path, attr = name.split(".")
        module = model.get_submodule(".".join(path))
        leaf = layouts[name].to_flax(p.detach())
        del module._parameters[attr]
        frozen_names.append(name)
        if leaf.ndim >= 2 and p.is_floating_point():
            q = quantize_leaf(leaf)
            module.register_buffer(f"{attr}_codes", q.codes)
            module.register_buffer(f"{attr}_scale", q.scale)
            quantized.setdefault(module, {})[attr] = (layouts[name], p.dtype)
        else:
            module.register_buffer(attr, p.detach())
    for module, attrs in quantized.items():
        _swap_class(module, attrs)
    model._kbit_frozen = tuple(frozen_names)
    return _split(model, model._kbit_frozen)


def kbit_params(model: nn.Module) -> typ.Optional[KbitParams]:
    """The trainable / frozen split of a prepared `model` (None if it was not
    prepared), over its tensors as they are now."""
    names = getattr(model, "_kbit_frozen", None)
    return None if names is None else _split(model, names)


def _split(model: nn.Module, names: typ.Sequence[str]) -> KbitParams:
    frozen: dict[str, typ.Union[QuantizedLeaf, torch.Tensor]] = {}
    for name in names:
        *path, attr = name.split(".")
        module = model.get_submodule(".".join(path))
        dtypes = getattr(type(module), "_kbit_attrs", {})
        if attr in dtypes:
            codes, scale = module._buffers[f"{attr}_codes"], module._buffers[f"{attr}_scale"]
            frozen[name] = QuantizedLeaf(codes, scale, dtypes[attr])
        else:
            frozen[name] = module._buffers[attr]
    return KbitParams(trainable=dict(model.named_parameters()), frozen=frozen)


def kbit_materialize(model: nn.Module) -> dict[str, torch.Tensor]:
    """The full float parameters of a prepared `model` by name, the frozen
    leaves dequantized into torch's layout: a `state_dict` that a model of the
    same config, not prepared, loads."""
    kb = kbit_params(model)
    if kb is None:
        raise ValueError("the model was not prepared by kbit_prepare")
    out = {n: p.detach() for n, p in kb.trainable.items()}
    for name, leaf in kb.frozen.items():
        if isinstance(leaf, QuantizedLeaf):
            out[name] = flax_layout(model, name).from_flax(leaf.dequantize()).contiguous()
        else:
            out[name] = leaf
    return out


def full_params(model: nn.Module) -> dict[str, torch.Tensor]:
    """The float parameters `model` computes with: `kbit_materialize` for a
    prepared model, its own parameters otherwise."""
    if kbit_params(model) is not None:
        return kbit_materialize(model)
    return {n: p.detach() for n, p in model.named_parameters()}


def kbit_memory_bytes(kb: KbitParams) -> dict[str, int]:
    """Bytes held by the trainable leaves and by the frozen storage (codes and
    scales, or float buffers)."""

    def nbytes(x: torch.Tensor) -> int:
        return x.numel() * x.element_size()

    frozen = 0
    for v in kb.frozen.values():
        frozen += nbytes(v.codes) + nbytes(v.scale) if isinstance(v, QuantizedLeaf) else nbytes(v)
    return {"trainable": sum(nbytes(v) for v in kb.trainable.values()), "frozen": frozen}
