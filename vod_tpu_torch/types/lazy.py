"""Lazy vector access and zarr stores on disk (port of `vod_tpu/types/lazy.py`).

`LazyArray` gives one `__getitem__` over an in-memory array, an opened store
or a store's factory. `TensorStoreFactory` is the serializable spec of a
zarr v2 store on disk: the same `factory.json` (`to_json` / `from_json` /
`from_path`) and the same `.zarray` fields as the JAX package's, which opens
the store through `tensorstore`. The card's machine has no `tensorstore`, so
`ZarrStore` reads and writes the format itself: C-order chunks of
`chunk_rows` rows, one file each (`<i>.0`, ...), written raw
(`"compressor": null`), which `tensorstore` reads back.

Declared difference: the JAX package's stores are compressed with blosc-lz4
(`tensorstore`'s default), and no blosc decoder is installed here; opening
such a store raises `UnreadableStore`, which `runtime/predict.py:
cached_embeddings` treats as a miss (recompute and overwrite), as JAX treats
a store with holes.
"""

from __future__ import annotations

import json
import pathlib
import typing as typ

import numpy as np

_DTYPES = {"float32": "<f4", "float16": "<f2", "int32": "<i4", "uint8": "|u1"}


class UnreadableStore(ValueError):
    """A zarr store whose chunks this package cannot decode (a compressor or filters)."""


class ZarrStore:
    """An opened zarr v2 array on disk: `shape`, `dtype`, `read()` /
    `write(array)` of the whole array, rows by `[...]`. A chunk file that is
    missing reads as zeros (the fill value)."""

    def __init__(self, path: typ.Union[str, pathlib.Path], meta: typ.Mapping[str, typ.Any]):
        if meta.get("compressor") is not None or meta.get("filters"):
            raise UnreadableStore(f"{path}: compressor {meta.get('compressor')} / filters {meta.get('filters')}")
        if meta.get("zarr_format") != 2 or meta.get("order", "C") != "C":
            raise UnreadableStore(f"{path}: not a C-order zarr v2 array")
        self.path = pathlib.Path(path)
        self.shape = tuple(int(s) for s in meta["shape"])
        self.chunks = tuple(int(c) for c in meta["chunks"])
        self.dtype = np.dtype(meta["dtype"])
        self.sep = meta.get("dimension_separator", ".")
        if self.chunks[1:] != self.shape[1:]:
            raise UnreadableStore(f"{path}: chunks {self.chunks} split a dimension other than the rows")

    def _chunk_file(self, i: int) -> pathlib.Path:
        return self.path / self.sep.join([str(i)] + ["0"] * (len(self.shape) - 1))

    def _read_chunk(self, i: int) -> np.ndarray:
        f = self._chunk_file(i)
        if not f.is_file():
            return np.zeros(self.chunks, dtype=self.dtype)
        return np.frombuffer(f.read_bytes(), dtype=self.dtype).reshape(self.chunks)

    def read_rows(self, start: int, stop: int) -> np.ndarray:
        rows = self.chunks[0]
        stop = min(stop, self.shape[0])
        if stop <= start:
            return np.zeros((0, *self.shape[1:]), dtype=self.dtype)
        parts = [self._read_chunk(i) for i in range(start // rows, (stop - 1) // rows + 1)]
        off = (start // rows) * rows
        return np.concatenate(parts)[start - off : stop - off]

    def read(self) -> np.ndarray:
        return self.read_rows(0, self.shape[0])

    def write(self, array: typ.Any) -> None:
        a = np.ascontiguousarray(np.asarray(array), dtype=self.dtype)
        if a.shape != self.shape:
            raise ValueError(f"writing {a.shape} into a store of shape {self.shape}")
        rows = self.chunks[0]
        for i in range(-(-self.shape[0] // rows)):
            chunk = a[i * rows : (i + 1) * rows]
            if chunk.shape[0] < rows:  # zarr chunks are whole: the last one is padded
                chunk = np.concatenate([chunk, np.zeros((rows - chunk.shape[0], *self.shape[1:]), self.dtype)])
            self._chunk_file(i).write_bytes(chunk.tobytes())

    def __getitem__(self, item: typ.Any) -> np.ndarray:
        if isinstance(item, slice) and item.step in (None, 1):
            start, stop, _ = item.indices(self.shape[0])
            return self.read_rows(start, stop)
        return self.read()[item]


class LazyArray:
    """Lazy row access to a 2-d vector store (ndarray, tensor, store or factory)."""

    def __init__(self, source: typ.Any):
        self._source = source

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(self._resolved().shape)

    def _resolved(self) -> typ.Any:
        if isinstance(self._source, TensorStoreFactory):
            self._source = self._source.open()
        return self._source

    def __len__(self) -> int:
        return int(self.shape[0])

    def __getitem__(self, item: typ.Any) -> np.ndarray:
        src = self._resolved()
        if isinstance(src, np.ndarray):
            return src[item]
        if hasattr(src, "detach"):  # a torch tensor
            return src[item].detach().cpu().numpy()
        return np.asarray(src[item])

    def to_numpy(self) -> np.ndarray:
        return self[:]


def as_lazy_array(x: typ.Any) -> LazyArray:
    """Wrap anything row-indexable."""
    return x if isinstance(x, LazyArray) else LazyArray(x)


class TensorStoreFactory:
    """A serializable spec for a zarr-on-file store."""

    def __init__(self, path: typ.Union[str, pathlib.Path], shape: tuple[int, ...], dtype: str = "float32",
                 chunk_rows: int = 1024):
        self.path = str(path)
        self.shape = tuple(int(s) for s in shape)
        self.dtype = dtype
        self.chunk_rows = int(chunk_rows)

    def spec(self, create: bool = False) -> dict:
        """The store's spec in `tensorstore`'s form (the JAX package opens it so)."""
        spec: dict = {"driver": "zarr", "kvstore": {"driver": "file", "path": self.path}}
        if create:
            spec["metadata"] = {
                "shape": list(self.shape),
                "dtype": _DTYPES[self.dtype],
                "chunks": [min(self.chunk_rows, self.shape[0])] + list(self.shape[1:]),
            }
            spec["create"] = True
            spec["delete_existing"] = True
        return spec

    def _zarray(self) -> dict:
        meta = self.spec(create=True)["metadata"]
        return {"chunks": meta["chunks"], "compressor": None, "dimension_separator": ".", "dtype": meta["dtype"],
                "fill_value": None, "filters": None, "order": "C", "shape": meta["shape"], "zarr_format": 2}

    def instantiate(self) -> ZarrStore:
        """Create the store on disk, deleting an existing one, and write
        `factory.json` beside it."""
        root = pathlib.Path(self.path)
        root.mkdir(parents=True, exist_ok=True)
        for f in root.iterdir():  # an existing store's chunks and metadata
            if f.is_file() and (f.name == ".zarray" or f.name[:1].isdigit()):
                f.unlink()
        (root / ".zarray").write_text(json.dumps(self._zarray()))
        (root / "factory.json").write_text(json.dumps(self.to_json()))
        return self.open()

    def open(self) -> ZarrStore:
        return ZarrStore(self.path, json.loads((pathlib.Path(self.path) / ".zarray").read_text()))

    def exists(self) -> bool:
        return (pathlib.Path(self.path) / "factory.json").exists()

    def to_json(self) -> dict:
        return {"path": self.path, "shape": list(self.shape), "dtype": self.dtype, "chunk_rows": self.chunk_rows}

    @classmethod
    def from_json(cls, d: typ.Mapping) -> "TensorStoreFactory":
        return cls(d["path"], tuple(d["shape"]), d["dtype"], d.get("chunk_rows", 1024))

    @classmethod
    def from_path(cls, path: typ.Union[str, pathlib.Path]) -> "TensorStoreFactory":
        return cls.from_json(json.loads((pathlib.Path(path) / "factory.json").read_text()))
