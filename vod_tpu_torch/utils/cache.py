"""Artifact cache management (port of `vod_tpu/utils/cache.py`): a
period-scoped cache directory, and the fingerprint-keyed artifact paths of
the embedding and index caches."""

from __future__ import annotations

import pathlib
import shutil
import tempfile


class CacheManager:
    """A (period-scoped) cache directory; `delete_existing` clears it on entry."""

    def __init__(
        self,
        cache_dir: str | pathlib.Path | None = None,
        *,
        delete_existing: bool = False,
    ):
        if cache_dir is None:
            self._tmp = tempfile.mkdtemp(prefix="vod-tpu-cache-")
            self.cache_dir = pathlib.Path(self._tmp)
        else:
            self._tmp = None
            self.cache_dir = pathlib.Path(cache_dir)
            if delete_existing and self.cache_dir.exists():
                shutil.rmtree(self.cache_dir)
        self.cache_dir.mkdir(parents=True, exist_ok=True)

    def __enter__(self) -> pathlib.Path:
        return self.cache_dir

    def __exit__(self, *exc) -> None:
        if self._tmp is not None:
            shutil.rmtree(self._tmp, ignore_errors=True)

    def path(self, *parts: str) -> pathlib.Path:
        p = self.cache_dir.joinpath(*parts)
        p.parent.mkdir(parents=True, exist_ok=True)
        return p


def cached_artifact_path(
    cache_dir: str | pathlib.Path, kind: str, fingerprint: str, suffix: str = ""
) -> pathlib.Path:
    """`<cache_dir>/<kind>/<fingerprint><suffix>`, its parent made."""
    p = pathlib.Path(cache_dir) / kind / f"{fingerprint}{suffix}"
    p.parent.mkdir(parents=True, exist_ok=True)
    return p
