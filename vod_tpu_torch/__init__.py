"""vod_tpu_torch — the PyTorch/CUDA port of vod_tpu, for NVIDIA Hopper (H100).

The port mirrors `vod_tpu`'s layout and names (`types/`, `ops/`, `search/`,
`models/`, `serving.py`), so each module's counterpart is easy to find. It
imports `torch` and never JAX, and nothing of `vod_tpu`: what it needs from a
JAX-free module there is copied here. Every TPU kernel on a ported path is a
hand-written CUDA kernel under `csrc/`, built at first use; beside each kernel
sits a plain PyTorch version that the CPU tests run.

Entry points (`build_dense_index`, `VodEncoder`, `SearchServer`, and the
kernel shootout `python -m vod_tpu_torch.examples.mips_kernel_bench`) default
to the card; they run on the CPU only when the caller asks for `cpu`.
"""

__version__ = "0.1.0"

# Lazy namespaces: importing the package loads no submodule and builds no kernel.
_SUBMODULES = ("examples", "models", "ops", "search", "serving", "types")


def __getattr__(name: str):
    if name in _SUBMODULES:
        import importlib

        return importlib.import_module(f"vod_tpu_torch.{name}")
    raise AttributeError(f"module 'vod_tpu_torch' has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_SUBMODULES))
