"""Configs of the port (own copies of what it needs from `vod_tpu/configs/`)."""

from .search import DenseFactoryConfig

__all__ = ["DenseFactoryConfig"]
