"""A typed argparse mini-CLI (port of `vod_tpu/utils/arguantic.py`, which
builds on pydantic): an `Arguantic` subclass declares typed fields with
defaults, and `.parse(argv)` reads each as `--name value` and validates it
as the port's configs do (`configs/base.py`, pydantic's lax mode), so
`--k 10` gives an int and `--on yes` a bool."""

from __future__ import annotations

import argparse
import dataclasses
import typing as typ

from vod_tpu_torch.configs.base import StrictModel

A = typ.TypeVar("A", bound="Arguantic")


class Arguantic(StrictModel):
    """Subclass with typed fields; `.parse()` reads them from argv."""

    @classmethod
    def parse(cls: type[A], args: typ.Optional[list[str]] = None) -> A:
        parser = argparse.ArgumentParser(description=cls.__doc__)
        hints = typ.get_type_hints(cls)
        for f in dataclasses.fields(cls):
            if not f.init or f.name.startswith("_"):
                continue
            if f.default is not dataclasses.MISSING:
                default = f.default
            elif f.default_factory is not dataclasses.MISSING:
                default = f.default_factory()
            else:
                default = None
            ann = hints[f.name]
            if ann is bool:
                parser.add_argument(f"--{f.name}", type=lambda x: x.lower() in ("1", "true", "yes"), default=default)
            elif ann in (int, float, str):
                parser.add_argument(f"--{f.name}", type=ann, default=default)
            else:
                parser.add_argument(f"--{f.name}", type=str, default=default)
        return cls(**vars(parser.parse_args(args)))
