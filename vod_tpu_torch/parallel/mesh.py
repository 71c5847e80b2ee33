"""The device mesh and the parameter and batch sharding rules (port of
`vod_tpu/parallel/mesh.py`, the `dp` and `fsdp` axes).

A mesh is a `torch.distributed.device_mesh.DeviceMesh` over the ranks of the
process group, one device a rank:

  * `dp`   — data parallel: each rank keeps its block of a batch's rows
             (`shard_batch`); the parameters are replicated and the train
             step averages their gradients over the axis;
  * `fsdp` — parameter sharding: each parameter's largest axis divisible by
             the axis size (and at least 8 times it) is split over `fsdp`
             (`shard_params`, through FSDP2's `fully_shard`).

  * `tp`   — tensor parallelism: JAX's key rules split whole heads of the
             encoder's attention and the intermediate axis of every FFN
             (`tp_sharding`); `shard_params_tp` keeps each rank's block and
             gives the layers Megatron's forwards (`parallel/tp.py`).

`make_mesh((dp, fsdp), ("dp", "fsdp"))` builds the 2-D mesh; either axis may
be 1. `combined_sharding` takes TP where the TP rule splits a parameter and
FSDP for the rest, as JAX's does.
"""

from __future__ import annotations

import dataclasses
import typing as typ

import numpy as np
import torch
import torch.distributed as dist

from . import distributed
from .distributed import rank_device, world_size


def make_mesh(
    shape: typ.Sequence[int] = (-1,),
    axis_names: typ.Sequence[str] = ("dp",),
    *,
    device_type: typ.Optional[str] = None,
) -> typ.Any:
    """A `DeviceMesh` over the ranks of the process group, in rank order;
    -1 infers the remaining size. `device_type` defaults to the type of this
    rank's device (`init_distributed`'s choice; else the CPU under gloo)."""
    from torch.distributed.device_mesh import DeviceMesh

    shape = [int(s) for s in shape]
    world = world_size()
    known = int(np.prod([s for s in shape if s > 0])) or 1
    if -1 in shape:
        shape[shape.index(-1)] = world // known
    if int(np.prod(shape)) != world:
        raise ValueError(f"mesh shape {shape} does not cover the {world} ranks")
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} and axis names {list(axis_names)} differ in length")
    if device_type is None:
        nccl = dist.is_initialized() and dist.get_backend() == "nccl"
        device_type = rank_device(None if distributed._RANK_DEVICE or nccl else "cpu").type
    return DeviceMesh(device_type, torch.arange(world).reshape(shape), mesh_dim_names=tuple(axis_names))


def axis_size(mesh: typ.Any, axis: typ.Optional[str]) -> int:
    """The mesh's size along `axis`; 1 when there is no mesh or no such axis."""
    if mesh is None or axis is None or axis not in (mesh.mesh_dim_names or ()):
        return 1
    return int(mesh.size(mesh.mesh_dim_names.index(axis)))


def axis_index(mesh: typ.Any, axis: str) -> int:
    """This rank's coordinate along `axis` (0 without the axis)."""
    return mesh.get_local_rank(axis) if axis_size(mesh, axis) > 1 else 0


def axis_group(mesh: typ.Any, axis: str) -> typ.Any:
    """The process group of this rank's line along `axis`."""
    return mesh.get_group(axis)


def axis_group_of(mesh: typ.Any, axis: str, what: str) -> typ.Any:
    """The process group of `axis` for a model-parallel call (`what`), None
    at size 1. An axis of size > 1 without a process group raises: such a
    call never runs as one rank."""
    size = axis_size(mesh, axis)
    if size == 1:
        return None
    if not dist.is_initialized():
        raise RuntimeError(f"{what} over {axis!r} of size {size} needs its process group")
    return axis_group(mesh, axis)


@dataclasses.dataclass(frozen=True)
class DataParallel:
    """This rank's place on a data-parallel axis of `size` > 1. `split`: the
    batch's rows are split over the axis (this rank holds block `index`);
    otherwise every rank holds them all (`shard_batch` replicates a batch
    whose rows do not divide)."""

    mesh: typ.Any
    axis: str
    index: int
    size: int
    split: bool

    @property
    def group(self) -> typ.Any:
        return axis_group(self.mesh, self.axis)

    @property
    def rows(self) -> typ.Optional[tuple[int, int]]:
        """(block, blocks) of a split batch, else None: the draws that one
        process makes for the global batch, this rank keeps block `index`."""
        return (self.index, self.size) if self.split else None


def data_parallel(mesh: typ.Any, axis: typ.Optional[str], n_rows: int) -> typ.Optional[DataParallel]:
    """The `DataParallel` of a batch of `n_rows` global rows, or None without
    a mesh axis `axis` of size > 1."""
    size = axis_size(mesh, axis)
    if size == 1:
        return None
    return DataParallel(mesh, axis, axis_index(mesh, axis), size, n_rows % size == 0)


def _shard_leaf(x: typ.Any, index: int, size: int) -> typ.Any:
    if isinstance(x, torch.Tensor) and x.ndim >= 1 and x.shape[0] % size == 0:
        per = x.shape[0] // size
        return x[index * per : (index + 1) * per]
    return x


def shard_batch(batch: typ.Any, mesh: typ.Any, axis: str = "dp") -> typ.Any:
    """This rank's rows of every tensor leaf (a tensor, a dataclass, a dict
    or a sequence of them): block `index` of the leading axis split over the
    mesh's `axis`. A leaf whose leading axis does not divide, and every leaf
    without the axis (or at size 1), is kept whole (replicated)."""
    size = axis_size(mesh, axis)
    if size == 1:
        return batch
    index = axis_index(mesh, axis)
    if dataclasses.is_dataclass(batch) and not isinstance(batch, type):
        return dataclasses.replace(
            batch, **{f.name: shard_batch(getattr(batch, f.name), mesh, axis) for f in dataclasses.fields(batch)}
        )
    if isinstance(batch, dict):
        return {k: shard_batch(v, mesh, axis) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(shard_batch(v, mesh, axis) for v in batch)
    return _shard_leaf(batch, index, size)


# ---- fsdp ---------------------------------------------------------------------


def fsdp_dim(shape: typ.Sequence[int], size: int) -> typ.Optional[int]:
    """JAX's rule on one leaf: the largest axis divisible by `size` and at
    least 8 x `size` (the first of equal ones); None (replicated) for a
    scalar, at size 1, or where no axis qualifies."""
    if size == 1 or len(shape) == 0:
        return None
    for d in sorted(range(len(shape)), key=lambda i: -shape[i]):
        if shape[d] % size == 0 and shape[d] >= size * 8:
            return d
    return None


def _torch_dim(kind: str, flax_dim: int) -> int:
    """The torch dim of a parameter that holds flax dim `flax_dim` (see
    `models/convert.py:FlaxLayout`)."""
    if kind == "transpose":
        return 1 - flax_dim
    if kind == "qkv_kernel":  # flax [H, heads, head_dim] <- torch [heads*head_dim, H]
        return 1 if flax_dim == 0 else 0
    if kind == "out_kernel":  # flax [heads, head_dim, H] <- torch [H, heads*head_dim]
        return 0 if flax_dim == 2 else 1
    if kind == "qkv_bias":  # flax [heads, head_dim] <- torch [heads*head_dim]
        return 0
    return flax_dim


def flax_leaves(model: torch.nn.Module) -> typ.Iterator[tuple[str, str, typ.Any, tuple[int, ...]]]:
    """(name, flax path, layout, flax shape) of each parameter of `model`:
    the leaf JAX's sharding rules read (`models/convert.py:flax_layout`)."""
    from vod_tpu_torch.models.convert import flax_layout, flax_path

    for name, p in model.named_parameters():
        layout = flax_layout(model, name)
        yield name, flax_path(name), layout, tuple(layout.to_flax(torch.empty(p.shape, device="meta")).shape)


def fsdp_flax_dims(model: torch.nn.Module, size: int) -> dict[str, typ.Optional[int]]:
    """JAX's rule applied to each parameter of `model` as its flax leaf
    (`models/convert.py:flax_layout`): name -> the flax axis split over an
    fsdp axis of `size`, or None."""
    return {name: fsdp_dim(shape, size) for name, _, _, shape in flax_leaves(model)}


def fsdp_sharding(model: torch.nn.Module, mesh: typ.Any, axis: str = "fsdp") -> dict[str, typ.Optional[int]]:
    """Per parameter: the torch dim split over the mesh's `axis`, or None
    (replicated). The rule is JAX's (`fsdp_dim`), applied to the flax leaf
    each parameter stands for, so the same parameter is split along the same
    axis in both packages. Where a flax axis is one of several a torch dim
    holds (an attention head's `heads` or `head_dim`), the torch dim is
    split in contiguous blocks: the same axis, other element groups."""
    from vod_tpu_torch.models.convert import flax_layout

    size = axis_size(mesh, axis)
    out = {}
    for name, d in fsdp_flax_dims(model, size).items():
        out[name] = None if d is None else _torch_dim(flax_layout(model, name).kind, d)
    return out


def shard_params(model: torch.nn.Module, mesh: typ.Any, axis: str = "fsdp") -> torch.nn.Module:
    """Shard `model`'s parameters over the mesh's `axis` by `fsdp_sharding`
    through FSDP2's `fully_shard` (in place; returns `model`). Replicated
    parameters are left out of FSDP (`ignored_params`) and stay whole on
    every rank. `encode_field`, where the model has it, gathers the
    parameters as `forward` does."""
    from torch.distributed.fsdp import fully_shard, register_fsdp_forward_method
    from torch.distributed.tensor import Shard

    if axis_size(mesh, axis) == 1:
        return model
    dims = fsdp_sharding(model, mesh, axis)
    by_param = {p: dims[n] for n, p in model.named_parameters()}
    ignored = {p for p, d in by_param.items() if d is None}
    sub = mesh[axis] if len(mesh.mesh_dim_names) > 1 else mesh
    fully_shard(model, mesh=sub, shard_placement_fn=lambda p: Shard(by_param[p]), ignored_params=ignored)
    if hasattr(model, "encode_field"):
        register_fsdp_forward_method(model, "encode_field")
    return model


# ---- tp ---------------------------------------------------------------------


def tp_flax_dim(key: str, shape: typ.Sequence[int], size: int) -> typ.Optional[int]:
    """JAX's tensor-parallel key rules (`vod_tpu/parallel/mesh.py:tp_sharding`)
    on one leaf, by its flax path `key` and shape: the flax axis split over
    a tp axis of `size`, or None. FFN up-projections split their fan-out,
    down-projections their fan-in, attention q/k/v kernels and biases their
    heads axis, the attention output kernel its heads axis."""
    nd = len(shape)

    def on(dim: int) -> typ.Optional[int]:
        return dim if shape[dim] % size == 0 else None

    if "attention" in key and nd == 3 and "kernel" in key:
        return on(0) if "out" in key else on(1)
    if "attention" in key and nd == 2 and "bias" in key:
        return on(0) if "out" not in key else None
    if "intermediate" in key and nd == 2:
        return on(1)
    if "intermediate" in key and nd == 1:
        return on(0)
    if ("output" in key or "fc_out" in key or "wo" in key) and nd == 2:
        return on(0)
    if "fc_in" in key and nd == 2:
        return on(1)
    return None


def tp_sharding(model: torch.nn.Module, mesh: typ.Any, axis: str = "tp") -> dict[str, typ.Optional[int]]:
    """Per parameter: the torch dim split over the mesh's `axis`, or None
    (replicated). JAX's key rules (`tp_flax_dim`) on the flax leaf each
    parameter stands for, as `fsdp_sharding` applies its rule; without the
    axis, or at size 1, everything is replicated."""
    size = axis_size(mesh, axis)
    if size == 1:
        return {name: None for name, _ in model.named_parameters()}
    out: dict[str, typ.Optional[int]] = {}
    for name, key, layout, shape in flax_leaves(model):
        d = tp_flax_dim(key, shape, size)
        out[name] = None if d is None else _torch_dim(layout.kind, d)
    return out


def shard_params_tp(model: torch.nn.Module, mesh: typ.Any, axis: str = "tp") -> torch.nn.Module:
    """Keep this rank's block of every parameter `tp_sharding` splits, and
    give the encoder's embeddings and layers and the reader's layers the
    tensor-parallel forwards (in place; returns `model`). Raises where the
    rule splits a parameter that none of those holds."""
    from .tp import split_layers

    if axis_size(mesh, axis) == 1:
        return model
    dims = tp_sharding(model, mesh, axis)
    split_layers(model, dims, axis_group(mesh, axis), axis_index(mesh, axis), axis_size(mesh, axis))
    left = sorted(n for n, p in model.named_parameters() if dims.get(n) is not None and not hasattr(p, "tp_group"))
    if left:
        raise ValueError(f"tensor-parallel splits that no tensor-parallel forward runs: {left}")
    return model


def combined_sharding(model: torch.nn.Module, mesh: typ.Any, *, tp_axis: str = "tp",
                      fsdp_axis: str = "fsdp") -> dict[str, typ.Optional[tuple[str, int]]]:
    """Per parameter: (axis, torch dim) of its split, or None (replicated):
    the TP rule where it splits the parameter, FSDP's for the rest."""
    tp = tp_sharding(model, mesh, tp_axis)
    fsdp = fsdp_sharding(model, mesh, fsdp_axis)
    return {
        name: (tp_axis, tp[name]) if tp[name] is not None else (fsdp_axis, fsdp[name]) if fsdp[name] is not None
        else None
        for name in tp
    }


def shard_params_combined(model: torch.nn.Module, mesh: typ.Any, *, tp_axis: str = "tp",
                          fsdp_axis: str = "fsdp") -> torch.nn.Module:
    """`combined_sharding` applied (in place; returns `model`): the TP
    blocks by `shard_params_tp`, then FSDP2 over the mesh's `fsdp_axis` for
    the parameters FSDP's rule splits, with the TP blocks and the
    replicated parameters among `ignored_params`."""
    from torch.distributed.fsdp import fully_shard, register_fsdp_forward_method
    from torch.distributed.tensor import Shard

    plan = combined_sharding(model, mesh, tp_axis=tp_axis, fsdp_axis=fsdp_axis)
    shard_params_tp(model, mesh, tp_axis)
    if axis_size(mesh, fsdp_axis) == 1:
        return model
    by_param = {p: plan[n][1] for n, p in model.named_parameters() if plan[n] is not None and plan[n][0] == fsdp_axis}
    ignored = {p for p in model.parameters() if p not in by_param}
    sub = mesh[fsdp_axis] if len(mesh.mesh_dim_names) > 1 else mesh
    fully_shard(model, mesh=sub, shard_placement_fn=lambda p: Shard(by_param[p]), ignored_params=ignored)
    if hasattr(model, "encode_field"):
        register_fsdp_forward_method(model, "encode_field")
    return model
