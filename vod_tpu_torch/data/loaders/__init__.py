"""Dataset loaders (the port's copies of `vod_tpu/data/loaders/`)."""

from .beir import BeirDatasetLoader

__all__ = ["BeirDatasetLoader"]
