"""Experiment recipes (port of `vod_tpu/exps/recipes.py`; the CLI and its
config schema are not ported yet)."""

from .recipes import PeriodicTrainingConfig, periodic_training

__all__ = ["PeriodicTrainingConfig", "periodic_training"]
