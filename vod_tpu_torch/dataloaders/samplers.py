"""Weighted query samplers (the port's copy of `vod_tpu/dataloaders/samplers.py`).

Parity: reference `vod_dataloaders/dl_sampler.py` — `LookupDlSamplerFactory:21`
(per-value weights for a row key), `InverseFrequencyDlSamplerFactory:40`,
`ProductDlSamplerFactory:58`, `dl_sampler_factory:76`. Here a sampler returns
per-row probabilities used by the dataloader's numpy RNG.
"""

from __future__ import annotations

import typing as typ

import numpy as np

from vod_tpu_torch.configs.dataloaders import SamplerFactoryConfig


def _row_values(rows: typ.Sequence[typ.Mapping], key: str) -> list[typ.Any]:
    return [r.get(key) for r in rows]


def lookup_weights(rows: typ.Sequence[typ.Mapping], key: str, lookup: dict[str, float]) -> np.ndarray:
    vals = _row_values(rows, key)
    return np.asarray([lookup.get(str(v), 1.0) for v in vals], dtype=np.float64)


def inverse_frequency_weights(rows: typ.Sequence[typ.Mapping], key: str) -> np.ndarray:
    vals = [str(v) for v in _row_values(rows, key)]
    counts: dict[str, int] = {}
    for v in vals:
        counts[v] = counts.get(v, 0) + 1
    return np.asarray([1.0 / counts[v] for v in vals], dtype=np.float64)


def dl_sampler_factory(
    cfg: SamplerFactoryConfig | typ.Sequence[SamplerFactoryConfig],
) -> typ.Callable[[typ.Sequence[typ.Mapping]], np.ndarray]:
    """Build a row-probability function from config(s); a list multiplies
    weights (parity: `ProductDlSamplerFactory:58`)."""
    cfgs = [cfg] if isinstance(cfg, SamplerFactoryConfig) else list(cfg)

    def fn(rows: typ.Sequence[typ.Mapping]) -> np.ndarray:
        w = np.ones((len(rows),), dtype=np.float64)
        for c in cfgs:
            if c.mode == "lookup":
                w = w * lookup_weights(rows, c.key, c.lookup or {})
            elif c.mode == "inverse_frequency":
                w = w * inverse_frequency_weights(rows, c.key)
            elif c.mode == "product":
                pass  # product semantics = multiplying the listed samplers
            else:
                raise ValueError(f"Unknown sampler mode {c.mode}")
        total = w.sum()
        return w / total if total > 0 else np.full_like(w, 1.0 / max(1, len(w)))

    return fn
