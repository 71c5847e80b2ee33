"""Utilities of the port (own copies of what it needs from `vod_tpu/utils/`:
content fingerprints, the artifact cache, jinja templates) and its YAML reader."""

from .cache import CacheManager, cached_artifact_path
from .fingerprint import fingerprint, fingerprint_dataset, fingerprint_params, fingerprint_tokenizer

__all__ = [
    "CacheManager",
    "cached_artifact_path",
    "fingerprint",
    "fingerprint_dataset",
    "fingerprint_params",
    "fingerprint_tokenizer",
]
