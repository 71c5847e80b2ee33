"""Trainer state machine + parameter schedules (a copy of
`vod_tpu/runtime/state.py`, which the port does not import).

`TrainerState` keeps the step/epoch/period bookkeeping; `ParameterSchedule`
gives the constant/linear/step/exponential scalar schedules that drive the
hybrid engines' weights. The schedules' values enter each train step as
plain floats.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import typing as typ


@dataclasses.dataclass
class ParameterSchedule:
    """Scalar schedule evaluated at a step (parity: `schedule.py:10-50`)."""

    mode: str = "constant"  # constant | linear | step | exponential
    value: float = 1.0
    start: float = 0.0
    period: int = 1000
    offset: int = 0

    def __call__(self, step: int) -> float:
        if self.mode == "constant":
            return self.value
        t = max(0, step - self.offset)
        if self.mode == "linear":
            frac = min(1.0, t / max(1, self.period))
            return self.start + (self.value - self.start) * frac
        if self.mode == "step":
            return self.start if t < self.period else self.value
        if self.mode == "exponential":
            frac = min(1.0, t / max(1, self.period))
            if self.start <= 0:
                return self.value * frac
            return self.start * (self.value / self.start) ** frac
        raise ValueError(f"Unknown schedule mode: {self.mode}")


@dataclasses.dataclass
class TrainerState:
    """Step/epoch/period bookkeeping (parity: `trainer_state.py:9-80`)."""

    step: int = 0
    epoch: int = 0
    update_steps: int = 0
    max_steps: int = 1000
    period: typ.Optional[int] = None  # steps per training period (re-index cadence)
    accumulate_grad_batches: int = 1
    parameters: dict[str, ParameterSchedule] = dataclasses.field(default_factory=dict)

    @property
    def completed(self) -> bool:
        return self.step >= self.max_steps

    @property
    def pidx(self) -> int:
        """Current period index (parity: `trainer_state.py:36`)."""
        if not self.period:
            return 0
        return self.step // self.period

    @property
    def next_period_start_step(self) -> int:
        """Parity: `trainer_state.py:50`."""
        if not self.period:
            return self.max_steps
        return min(self.max_steps, (self.pidx + 1) * self.period)

    def get_parameters(self) -> dict[str, float]:
        """Evaluate every schedule at the current step (parity: `:54`)."""
        return {k: s(self.step) for k, s in self.parameters.items()}

    # -- persistence (parity: TrainerState JSON in `utils/io.py`) --
    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["parameters"] = {k: dataclasses.asdict(v) for k, v in self.parameters.items()}
        return d

    def save(self, path: str | pathlib.Path) -> None:
        pathlib.Path(path).write_text(json.dumps(self.to_json(), indent=2))

    @classmethod
    def load(cls, path: str | pathlib.Path) -> "TrainerState":
        d = json.loads(pathlib.Path(path).read_text())
        d["parameters"] = {k: ParameterSchedule(**v) for k, v in d.get("parameters", {}).items()}
        return cls(**d)
