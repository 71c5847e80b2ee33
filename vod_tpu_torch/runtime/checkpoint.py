"""Checkpoint save/load: model, optimizer, trainer state and the generator the
loop draws from (port of `vod_tpu/runtime/checkpoint.py`).

Declared difference: the JAX package writes orbax checkpoints of its
parameter and optimizer pytrees; here `torch.save` writes the model's and the
optimizer's `state_dict`s (and the `torch.Generator`'s state, when given) to
`state.pt`, beside the same `trainer_state.json`. Loading into the same
model, optimizer and generator resumes training bit for bit.

Under a process group every rank calls `save_checkpoint`: rank 0 writes and
the others wait at a barrier until the files are there (JAX relies on
orbax's multihost commit); then every rank may `load_checkpoint` them. The
ranks of a data-parallel run hold the same weights, optimizer state and
generator state, so rank 0's copy is everyone's.
"""

from __future__ import annotations

import pathlib
import typing as typ

import torch
from torch import nn

from vod_tpu_torch.parallel.distributed import barrier, is_main_process
from .state import TrainerState


def save_checkpoint(
    directory: typ.Union[str, pathlib.Path],
    *,
    model: nn.Module,
    optimizer: torch.optim.Optimizer,
    state: TrainerState,
    generator: typ.Optional[torch.Generator] = None,
) -> None:
    directory = pathlib.Path(directory).absolute()
    if is_main_process():
        directory.mkdir(parents=True, exist_ok=True)
        payload = {"model": model.state_dict(), "optimizer": optimizer.state_dict()}
        if generator is not None:
            payload["generator"] = generator.get_state()
        torch.save(payload, directory / "state.pt")
        state.save(directory / "trainer_state.json")
    barrier("checkpoint")


def load_checkpoint(
    directory: typ.Union[str, pathlib.Path],
    *,
    model: nn.Module,
    optimizer: torch.optim.Optimizer,
    generator: typ.Optional[torch.Generator] = None,
) -> TrainerState:
    """Restore `model` and `optimizer` in place (and `generator`, when given
    and saved); returns the trainer state."""
    directory = pathlib.Path(directory).absolute()
    payload = torch.load(directory / "state.pt", map_location="cpu", weights_only=True)
    model.load_state_dict(payload["model"])
    optimizer.load_state_dict(payload["optimizer"])
    if generator is not None and "generator" in payload:
        generator.set_state(payload["generator"])
    return TrainerState.load(directory / "trainer_state.json")
