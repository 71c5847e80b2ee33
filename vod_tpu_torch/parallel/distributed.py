"""Multi-process execution on `torch.distributed` (port of
`vod_tpu/parallel/distributed.py`).

Each process is one rank and holds one device. `init_distributed` joins the
process group from torchrun's environment (`RANK`, `WORLD_SIZE`,
`LOCAL_RANK`, `MASTER_ADDR`/`MASTER_PORT`), from the JAX package's flags
(`--coordinator host:port`, `--num_processes`, `--process_id`, or their
`JAX_COORDINATOR_ADDRESS` / `JAX_NUM_PROCESSES` / `JAX_PROCESS_ID`
variables), or from an explicit `init_method` (tests: `file://...`). The
backend is named, never guessed from what is installed: `nccl` for a CUDA
rank and `gloo` for a CPU rank, unless `backend=` says otherwise (gloo ranks
may hold CUDA tensors, as two ranks on one card do). A CUDA rank's device is
`cuda:{LOCAL_RANK % device_count}`; asking for CUDA where there is none
raises.

The collectives here (`all_gather_tensor`, `all_reduce_`) use only the calls
that both backends take on CUDA tensors (`broadcast`, `all_reduce`), so one
code path serves NCCL and gloo. The differentiable ones for model
parallelism: `ppermute` (JAX's `lax.ppermute` on a ring: batched send and
receive under NCCL, broadcasts under gloo; its backward is the opposite
shift), `sum_over` (an all_reduce whose backward is the identity: the
partial outputs of a split layer, summed into a result every rank holds)
and `copy_over` (the identity, whose backward sums the gradients over the
group: a replicated input of a split layer). These three take the group of
a mesh axis, and None means no group: one rank, no communication.

Declared difference: where JAX assembles a global array from the
processes' rows (`make_array_from_process_local_data`),
`global_batch_from_local` returns the rows of every rank, in rank order, as
one tensor on each rank.
"""

from __future__ import annotations

import os
import typing as typ

import numpy as np
import torch
import torch.distributed as dist

_RANK_DEVICE: typ.Optional[torch.device] = None


def _env_int(*names: str) -> typ.Optional[int]:
    for name in names:
        if os.environ.get(name):
            return int(os.environ[name])
    return None


def rank_device(device: typ.Union[str, torch.device, None] = None) -> torch.device:
    """The device of this rank: the one `init_distributed` chose, else
    `device` (default "cuda"), where "cuda" means `cuda:{LOCAL_RANK %
    device_count}`. Raises when CUDA is asked for and there is none."""
    if device is None and _RANK_DEVICE is not None:
        return _RANK_DEVICE
    dev = torch.device(device if device is not None else "cuda")
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError("a CUDA rank needs a GPU, and torch.cuda.is_available() is False")
    if dev.index is not None:
        return dev
    local = _env_int("LOCAL_RANK")
    if local is None:
        local = dist.get_rank() if dist.is_initialized() else 0
    return torch.device("cuda", local % torch.cuda.device_count())


def init_distributed(
    coordinator: typ.Optional[str] = None,
    num_processes: typ.Optional[int] = None,
    process_id: typ.Optional[int] = None,
    *,
    backend: typ.Optional[str] = None,
    device: typ.Union[str, torch.device] = "cuda",
    init_method: typ.Optional[str] = None,
) -> tuple[int, int]:
    """Join the process group. Returns (rank, world size), and (0, 1) when
    nothing names a group (no flags, no torchrun or JAX variables, or a
    world of one without a coordinator).

    `device` is the kind of device each rank holds ("cuda" or "cpu");
    `backend` defaults to nccl for CUDA and gloo for the CPU."""
    global _RANK_DEVICE
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    coordinator = coordinator or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if num_processes is None:
        num_processes = _env_int("WORLD_SIZE", "JAX_NUM_PROCESSES")
    if process_id is None:
        process_id = _env_int("RANK", "JAX_PROCESS_ID")
    torchrun = os.environ.get("MASTER_ADDR") is not None and _env_int("WORLD_SIZE") is not None
    if init_method is None and coordinator is None and not torchrun:
        if num_processes is not None and num_processes > 1:
            raise ValueError(f"{num_processes} processes need a coordinator (host:port) or torchrun's environment")
        return 0, 1
    if num_processes is None or process_id is None:
        raise ValueError("a process group needs both the number of processes and this process's id")
    if init_method is None:
        init_method = f"tcp://{coordinator}" if coordinator is not None else "env://"
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed(device='cuda') needs a GPU, and torch.cuda.is_available() is False")
        local = _env_int("LOCAL_RANK")
        dev = torch.device("cuda", (process_id if local is None else local) % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method, rank=process_id, world_size=num_processes, **kw)
    _RANK_DEVICE = dev
    return dist.get_rank(), dist.get_world_size()


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main_process() -> bool:
    """Rank 0, or no process group."""
    return not dist.is_initialized() or dist.get_rank() == 0


def process_slice(n: int, process_index: typ.Optional[int] = None) -> slice:
    """This process's contiguous row range of an n-row dataset: blocks of
    ceil(n / world) rows, in rank order."""
    pi = (dist.get_rank() if dist.is_initialized() else 0) if process_index is None else process_index
    per = -(-n // world_size())
    return slice(pi * per, min((pi + 1) * per, n))


def barrier(name: str = "barrier", group: typ.Any = None) -> None:
    """Cross-process sync point; a no-op without a process group. `name`
    labels the call site only."""
    del name
    if dist.is_initialized() and dist.get_world_size(group) > 1:
        dist.barrier(group=group)


def all_reduce_(t: torch.Tensor, op: typ.Any = None, group: typ.Any = None) -> torch.Tensor:
    """In-place all_reduce (default SUM) over `group`; a no-op without one."""
    if dist.is_initialized() and dist.get_world_size(group) > 1:
        dist.all_reduce(t, op=dist.ReduceOp.SUM if op is None else op, group=group)
    return t


def global_rank(group: typ.Any, rank: int) -> int:
    """The global rank of `group`'s rank `rank` (the world group: itself)."""
    if group is None or group is dist.GroupMember.WORLD:
        return rank
    return dist.get_global_rank(group, rank)


def _bytes_of(t: torch.Tensor) -> torch.Tensor:
    # a copy with row-major strides: `contiguous()` keeps the stride of a
    # size-1 axis (a one-row slice of a wider tensor), which `view` refuses
    dense = t if t.is_contiguous() and (t.numel() != 1 or t.stride() == (1,) * t.ndim) else \
        torch.empty(t.shape, dtype=t.dtype, device=t.device).copy_(t)
    return dense.reshape(-1).view(torch.uint8)


def all_gather_tensor(t: torch.Tensor, group: typ.Any = None) -> torch.Tensor:
    """`[W, *t.shape]`: every rank's `t` (same shape and dtype on each), in
    the group's rank order. One broadcast from each rank, of its bytes, into
    a shared buffer: both backends take `broadcast` on CUDA tensors, where
    gloo has no CUDA `all_gather`."""
    if not dist.is_initialized() or dist.get_world_size(group) == 1:
        return t.unsqueeze(0)
    w, me = dist.get_world_size(group), dist.get_rank(group)
    nbytes = t.numel() * t.element_size()
    out = torch.empty((w, nbytes), dtype=torch.uint8, device=t.device)
    if nbytes:
        out[me] = _bytes_of(t)
        for r in range(w):
            dist.broadcast(out[r], src=global_rank(group, r), group=group)
    return out.view(t.dtype).reshape((w,) + tuple(t.shape))


def global_batch_from_local(local: typ.Any, group: typ.Any = None) -> torch.Tensor:
    """The global batch from each rank's own rows: their concatenation in
    rank order, on every rank. Ranks may hold different row counts."""
    x = torch.as_tensor(np.asarray(local) if not isinstance(local, torch.Tensor) else local)
    if not dist.is_initialized() or dist.get_world_size(group) == 1:
        return x
    n = torch.tensor([x.shape[0]], dtype=torch.int64, device=x.device)
    counts = all_gather_tensor(n, group).reshape(-1).tolist()
    top = max(counts)
    padded = torch.cat([x, x.new_zeros((top - x.shape[0],) + tuple(x.shape[1:]))]) if x.shape[0] < top else x
    every = all_gather_tensor(padded, group)
    return torch.cat([every[r, :c] for r, c in enumerate(counts)])


def _group_size(group: typ.Any) -> int:
    """The size of `group`, where None means no group (not the world's)."""
    return dist.get_world_size(group) if group is not None and dist.is_initialized() else 1


def _shift(t: torch.Tensor, group: typ.Any, shift: int) -> torch.Tensor:
    """Rank r's `t` lands on rank (r + shift) mod W of `group`."""
    w, me = dist.get_world_size(group), dist.get_rank(group)
    if shift % w == 0:
        return t.clone()
    if dist.get_backend(group) == "nccl":
        out = torch.empty_like(t)
        ops = [dist.P2POp(dist.isend, t.contiguous(), global_rank(group, (me + shift) % w), group),
               dist.P2POp(dist.irecv, out, global_rank(group, (me - shift) % w), group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return out
    return all_gather_tensor(t, group)[(me - shift) % w].clone()


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx: typ.Any, t: torch.Tensor, group: typ.Any, shift: int) -> torch.Tensor:
        ctx.group, ctx.shift = group, shift
        return _shift(t, group, shift)

    @staticmethod
    def backward(ctx: typ.Any, g: torch.Tensor) -> tuple:
        return _shift(g.contiguous(), ctx.group, -ctx.shift), None, None


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx: typ.Any, t: torch.Tensor, group: typ.Any) -> torch.Tensor:
        out = t.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx: typ.Any, g: torch.Tensor) -> tuple:
        return g, None


class _CopyOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx: typ.Any, t: torch.Tensor, group: typ.Any) -> torch.Tensor:
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx: typ.Any, g: torch.Tensor) -> tuple:
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def ppermute(t: torch.Tensor, group: typ.Any, shift: int = 1) -> torch.Tensor:
    """Differentiable ring shift over `group`: rank r receives the `t` of rank
    (r - shift) mod W (every rank sends a tensor of the same shape and
    dtype). The backward shifts the gradients the other way. With no group
    (None), or in a group of one, a copy of `t`."""
    if _group_size(group) == 1:
        return t.clone()
    return _Shift.apply(t, group, shift)


def sum_over(t: torch.Tensor, group: typ.Any) -> torch.Tensor:
    """The sum of every rank's `t` over `group`, on every rank; the backward
    passes each rank's gradient through unchanged (each rank computes the
    same loss from the sum). `t` itself in a group of one."""
    if _group_size(group) == 1:
        return t
    return _SumOver.apply(t, group)


def copy_over(t: torch.Tensor, group: typ.Any) -> torch.Tensor:
    """`t` (the same on every rank of `group`) whose gradient is summed over
    the group: each rank differentiates its part of what reads it."""
    if _group_size(group) == 1:
        return t
    return _CopyOver.apply(t, group)
