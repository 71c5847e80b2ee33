"""Training callbacks (port of `vod_tpu/runtime/callbacks.py`): hook points
that the train and validation loops call by name, `ExportModule` (the
model's weights, tokenizer and config at fit end, optionally uploaded),
`load_export`, and `PprintBatch`.

Declared differences: the weights are one `torch.save` file of the state
dict (`params.pt`, as the port's checkpoints are) where JAX writes an orbax
directory, and the tokenizer is written by the port's own classes
(`save_pretrained`). An upload to `file://` or a plain path copies with the
standard library; another scheme goes through `fsspec` where it is
installed, and raises naming the scheme where it is not.
"""

from __future__ import annotations

import json
import pathlib
import shutil
import typing as typ
import urllib.parse

import torch


class Callback:
    """Hook points of the loops: fit, train batch and validation, each at start and end."""

    def on_fit_start(self, **kw: typ.Any) -> None: ...

    def on_fit_end(self, **kw: typ.Any) -> None: ...

    def on_train_batch_start(self, **kw: typ.Any) -> None: ...

    def on_train_batch_end(self, **kw: typ.Any) -> None: ...

    def on_validation_start(self, **kw: typ.Any) -> None: ...

    def on_validation_end(self, **kw: typ.Any) -> None: ...


def call_callbacks(callbacks: typ.Sequence[Callback], hook: str, **kw: typ.Any) -> None:
    """Invoke a hook on every callback."""
    for cb in callbacks:
        getattr(cb, hook)(**kw)


class ExportModule(Callback):
    """At fit end, write the model's weights (`params.pt`; only the top-level
    `submodules` where given), the tokenizer (`tokenizer/`) and the config
    (`config.json`) under `output_dir`, which `load_export` reads, then
    upload the directory to `upload_to` where given."""

    def __init__(
        self,
        output_dir: typ.Union[str, pathlib.Path],
        submodules: typ.Optional[list[str]] = None,
        upload_to: typ.Optional[str] = None,
    ):
        self.output_dir = pathlib.Path(output_dir)
        self.submodules = submodules
        self.upload_to = upload_to

    def on_fit_end(self, *, model: typ.Any = None, params: typ.Any = None, tokenizer: typ.Any = None,
                   config: typ.Any = None, **kw: typ.Any) -> None:
        """`model` (an `nn.Module`) or `params` (a state dict) is exported;
        the loops pass the model."""
        self.output_dir.mkdir(parents=True, exist_ok=True)
        state = model.state_dict() if model is not None else dict(params or {})
        if self.submodules:
            state = {k: v for k, v in state.items() if k.split(".")[0] in self.submodules}
        torch.save({k: v.detach().cpu() for k, v in state.items()}, self.output_dir / "params.pt")
        if tokenizer is not None and hasattr(tokenizer, "save_pretrained"):
            tokenizer.save_pretrained(self.output_dir / "tokenizer")
        if config is not None:
            text = config.to_json() if hasattr(config, "to_json") else json.dumps(config)
            (self.output_dir / "config.json").write_text(text)
        if self.upload_to:
            self.upload(self.upload_to)

    def upload(self, url: str) -> None:
        """Copy the export directory to `<url>/<its name>/`: a `file://` URL
        or a plain path by the standard library, another scheme (gs://,
        s3://, ...) through `fsspec`."""
        scheme = urllib.parse.urlparse(url).scheme
        if scheme in ("", "file"):
            root = urllib.parse.urlparse(url).path if scheme else url
            dest = pathlib.Path(root) / self.output_dir.name
            dest.mkdir(parents=True, exist_ok=True)
            shutil.copytree(self.output_dir, dest, dirs_exist_ok=True)
            return
        try:
            import fsspec
        except ImportError as exc:
            raise ValueError(f"uploading to a {scheme}:// URL needs fsspec, which is not installed") from exc
        fs, root = fsspec.core.url_to_fs(url)
        dest = f"{root.rstrip('/')}/{self.output_dir.name}"
        fs.makedirs(dest, exist_ok=True)
        fs.put(f"{self.output_dir}/", dest, recursive=True)


def load_export(output_dir: typ.Union[str, pathlib.Path], model: typ.Any = None) -> typ.Any:
    """The exported state dict (on the CPU); with `model`, loaded into it
    (every exported tensor must fit one of its own) and the model returned."""
    state = torch.load(pathlib.Path(output_dir) / "params.pt", map_location="cpu", weights_only=True)
    if model is None:
        return state
    missing, unexpected = model.load_state_dict(state, strict=False)
    if unexpected:
        raise ValueError(f"the export at {str(output_dir)!r} has tensors the model lacks: {sorted(unexpected)}")
    return model


class PprintBatch(Callback):
    """Pretty-print the first batch (`utils/pretty.py:pprint_batch`, or `printer`)."""

    def __init__(self, printer: typ.Optional[typ.Callable[[typ.Any], None]] = None):
        self.printer = printer
        self._done = False

    def on_train_batch_start(self, *, batch: typ.Any = None, **kw: typ.Any) -> None:
        if self._done or batch is None:
            return
        self._done = True
        if self.printer is not None:
            self.printer(batch)
        else:
            from vod_tpu_torch.utils.pretty import pprint_batch

            pprint_batch(batch)
