"""Experiments (port of `vod_tpu/exps/`): the periodic-training recipe, the
config schema (`structconf`) and the experiment runner and CLI (`cli`,
`python -m vod_tpu_torch.exps.cli`)."""

from .recipes import PeriodicTrainingConfig, periodic_training

__all__ = ["PeriodicTrainingConfig", "periodic_training"]
