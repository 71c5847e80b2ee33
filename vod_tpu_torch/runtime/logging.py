"""Metric logging: CSV / JSONL sinks + nested-metric flattening (a copy of
`vod_tpu/runtime/logging.py`, which the port does not import).

`TrackerLogger` uses `wandb` where it is importable and not disabled, and
otherwise writes the same records to a run directory.
"""

from __future__ import annotations

import csv
import json
import pathlib
import typing as typ


def flatten_metrics(metrics: typ.Mapping[str, typ.Any], prefix: str = "") -> dict[str, float]:
    """Flatten nested dicts to `a/b/c` keys, keeping numeric leaves."""
    out: dict[str, float] = {}
    for k, v in metrics.items():
        key = f"{prefix}{k}"
        if isinstance(v, typ.Mapping):
            out.update(flatten_metrics(v, prefix=f"{key}/"))
        else:
            try:
                out[key] = float(v)
            except (TypeError, ValueError):
                continue
    return out


class JSONLLogger:
    def __init__(self, path: str | pathlib.Path):
        self.path = pathlib.Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)

    def log(self, step: int, metrics: typ.Mapping[str, typ.Any]) -> None:
        rec = {"step": step, **flatten_metrics(metrics)}
        with self.path.open("a") as f:
            f.write(json.dumps(rec) + "\n")


class CSVLogger:
    """Append-only CSV with a growing header (rewrites on new columns)."""

    def __init__(self, path: str | pathlib.Path):
        self.path = pathlib.Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._fields: list[str] = []
        self._rows: list[dict] = []

    def log(self, step: int, metrics: typ.Mapping[str, typ.Any]) -> None:
        rec = {"step": step, **flatten_metrics(metrics)}
        for k in rec:
            if k not in self._fields:
                self._fields.append(k)
        self._rows.append(rec)
        with self.path.open("w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=self._fields)
            writer.writeheader()
            writer.writerows(self._rows)


class MultiLogger:
    def __init__(self, *loggers: typ.Any):
        self.loggers = loggers

    def log(self, step: int, metrics: typ.Mapping[str, typ.Any]) -> None:
        for lg in self.loggers:
            lg.log(step, metrics)

    def __call__(self, step: int, metrics: typ.Mapping[str, typ.Any]) -> None:
        self.log(step, metrics)


class TrackerLogger:
    """Experiment-tracker adapter, W&B-shaped. Interface: `log(step,
    metrics)`, `log_text(key, text, step)`, `finish()`.

    backend="auto" uses the real `wandb` package when importable and not
    disabled; otherwise it writes a run directory with `config.json`,
    `metrics.jsonl` and text artifacts, the same records a tracker holds.
    """

    def __init__(
        self,
        run_dir: str | pathlib.Path,
        *,
        project: str = "vod_tpu",
        run_name: typ.Optional[str] = None,
        config: typ.Optional[typ.Mapping[str, typ.Any]] = None,
        backend: str = "auto",
    ):
        import os

        self.run_dir = pathlib.Path(run_dir)
        self.run_dir.mkdir(parents=True, exist_ok=True)
        self._wandb = None
        if backend in ("auto", "wandb") and not os.environ.get("WANDB_DISABLED"):
            try:  # pragma: no cover - no wandb seat in this environment
                import wandb  # type: ignore

                self._wandb = wandb.init(
                    project=project, name=run_name, config=dict(config or {}),
                    dir=str(self.run_dir),
                )
            except Exception:
                self._wandb = None
        if self._wandb is None:
            if config is not None:
                (self.run_dir / "config.json").write_text(json.dumps(dict(config), default=str))
            self._jsonl = JSONLLogger(self.run_dir / "metrics.jsonl")

    def log(self, step: int, metrics: typ.Mapping[str, typ.Any]) -> None:
        if self._wandb is not None:  # pragma: no cover
            self._wandb.log(flatten_metrics(metrics), step=step)
        else:
            self._jsonl.log(step, metrics)

    __call__ = log

    def log_text(self, key: str, text: str, step: int = 0) -> None:
        """Text/HTML artifact (parity: `log_retrieval_batch`'s wandb.Html)."""
        if self._wandb is not None:  # pragma: no cover
            import wandb  # type: ignore

            self._wandb.log({key: wandb.Html(text)}, step=step)
        else:
            safe = key.replace("/", "_")
            (self.run_dir / f"{safe}_{step}.html").write_text(text)

    def finish(self) -> None:
        if self._wandb is not None:  # pragma: no cover
            self._wandb.finish()
