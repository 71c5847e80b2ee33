"""Trainer, benchmark, batch-size and system configs (the port's copy of
`vod_tpu/configs/trainer.py`).

`LRScheduleConfig.instantiate` returns the learning rate as a function of the
count of optimizer updates applied so far, equal to the optax schedule the
JAX package builds (`linear_schedule`, `join_schedules`,
`warmup_cosine_decay_schedule`), or a float when the rate is constant.
"""

from __future__ import annotations

import dataclasses
import math
import typing as typ

from .base import StrictModel


class ScheduleConfig(StrictModel):
    """Scalar schedule of an engine weight."""

    mode: typ.Literal["constant", "linear", "step", "exponential"] = "constant"
    value: float = 1.0
    start: float = 0.0
    period: int = 1000
    offset: int = 0

    def instantiate(self):
        from vod_tpu_torch.runtime.state import ParameterSchedule

        return ParameterSchedule(**self.to_dict())


class BenchmarkConfig(StrictModel):
    metrics: list[str] = dataclasses.field(default_factory=lambda: ["ndcg_10", "mrr_10", "hitrate_3", "recall_50"])
    on_init: bool = False
    n_max_queries: typ.Optional[int] = None
    top_k: int = 100


class BatchSizeConfig(StrictModel):
    """Effective batch size accounting."""

    effective: int = 32
    per_device: int = 8

    def accumulation_steps(self, n_devices: int) -> int:
        return max(1, -(-self.effective // (n_devices * self.per_device)))


def _linear(init: float, end: float, steps: int) -> typ.Callable[[int], float]:
    """optax.linear_schedule: init -> end over `steps` updates, then end."""
    steps = max(1, steps)

    def fn(count: int) -> float:
        frac = 1.0 - min(max(count, 0), steps) / steps
        return (init - end) * frac + end

    return fn


class LRScheduleConfig(StrictModel):
    """Learning-rate schedule: `linear` = warmup + linear decay, `cosine` =
    warmup + cosine decay."""

    kind: typ.Literal["constant", "linear", "cosine"] = "linear"
    warmup_steps: int = 0
    decay_steps: typ.Optional[int] = None  # default: trainer.max_steps
    end_factor: float = 0.0  # final lr = end_factor * learning_rate

    def instantiate(self, learning_rate: float, max_steps: int) -> typ.Union[float, typ.Callable[[int], float]]:
        decay = self.decay_steps if self.decay_steps is not None else max_steps
        warmup = self.warmup_steps
        if self.kind == "constant":
            return _linear(0.0, learning_rate, warmup) if warmup else learning_rate
        if self.kind == "linear":
            up = _linear(0.0, learning_rate, max(1, warmup))
            down = _linear(learning_rate, learning_rate * self.end_factor, max(1, decay - warmup))
            return lambda count: up(count) if count < warmup else down(count - warmup)
        steps = decay - warmup
        if steps <= 0:
            raise ValueError(f"the cosine schedule needs decay_steps > warmup_steps, got {decay} and {warmup}")
        alpha = 0.0 if learning_rate == 0.0 else self.end_factor
        up = _linear(0.0, learning_rate, warmup)

        def cosine(count: int) -> float:
            # optax.cosine_decay_schedule over decay - warmup updates, exponent 1
            t = min(max(count, 0), steps) / steps
            return learning_rate * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * t)) + alpha)

        return lambda count: up(count) if count < warmup else cosine(count - warmup)


class TrainerConfig(StrictModel):
    max_steps: int = 1_000
    period: typ.Optional[int] = None
    val_check_interval: typ.Optional[int] = None
    log_interval: int = 50
    accumulate_grad_batches: int = 1
    gradient_clip_val: typ.Optional[float] = None
    gradcache_chunk_rows: typ.Optional[int] = None
    learning_rate: float = 1e-4
    weight_decay: float = 0.0
    optimizer: typ.Literal["adamw", "adafactor", "sgd"] = "adamw"
    lr_schedule: typ.Optional[LRScheduleConfig] = None
    parameters: dict[str, ScheduleConfig] = dataclasses.field(default_factory=dict)
    metrics: list[str] = dataclasses.field(default_factory=lambda: ["mrr", "ndcg_10", "hitrate_3"])
    checkpoint_path: typ.Optional[str] = None
    benchmark: BenchmarkConfig = dataclasses.field(default_factory=BenchmarkConfig)
    batch_size: BatchSizeConfig = dataclasses.field(default_factory=BatchSizeConfig)


class SysConfig(StrictModel):
    seed: int = 0
    cache_dir: typ.Optional[str] = None
    profile_dir: typ.Optional[str] = None  # profiler trace output dir
    mesh_shape: list[int] = dataclasses.field(default_factory=lambda: [-1])
    mesh_axes: list[str] = dataclasses.field(default_factory=lambda: ["dp"])
