"""Utilities of the port (own copies of what it needs from `vod_tpu/utils/`:
content fingerprints, the artifact cache, jinja templates, the typed CLI
arguments, exception dumps, timers, shape checks, pretty printers) and its
YAML reader."""

from .arguantic import Arguantic
from .cache import CacheManager, cached_artifact_path
from .exceptions import dump_exceptions_to_file
from .fingerprint import fingerprint, fingerprint_dataset, fingerprint_params, fingerprint_tokenizer

__all__ = [
    "Arguantic",
    "CacheManager",
    "cached_artifact_path",
    "dump_exceptions_to_file",
    "fingerprint",
    "fingerprint_dataset",
    "fingerprint_params",
    "fingerprint_tokenizer",
]
