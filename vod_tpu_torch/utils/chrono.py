"""Wall-clock instrumentation (port of `vod_tpu/utils/chrono.py`): `Chrono`,
a lap timer over a sliding window, and `BlockTimer`, which writes a stage's
seconds into a mapping (a batch's diagnostics). Host clocks only: a stage
that enqueues work on the card is timed to its enqueue unless it syncs."""

from __future__ import annotations

import time
import typing as typ


class Chrono:
    """Lap timer: average seconds per lap over a sliding window."""

    def __init__(self, window: int = 100):
        self.window = window
        self._laps: list[float] = []
        self._start: typ.Optional[float] = None

    def start(self) -> None:
        self._start = time.perf_counter()

    def stop(self) -> None:
        if self._start is None:
            return
        self._laps.append(time.perf_counter() - self._start)
        self._start = None
        if len(self._laps) > self.window:
            self._laps.pop(0)

    def get_avg_laps_per_second(self) -> float:
        if not self._laps:
            return float("nan")
        return len(self._laps) / sum(self._laps)

    def get_avg_lap_time(self) -> float:
        if not self._laps:
            return float("nan")
        return sum(self._laps) / len(self._laps)


class BlockTimer:
    """`with BlockTimer("search_time", diagnostics): ...` sets the seconds."""

    def __init__(self, name: str, output: typ.MutableMapping[str, typ.Any]):
        self.name = name
        self.output = output

    def __enter__(self) -> "BlockTimer":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc: typ.Any) -> None:
        self.output[self.name] = time.perf_counter() - self._t0
