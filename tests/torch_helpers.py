"""Shared helpers for the parity tests of the PyTorch port (`tests/test_torch_*.py`).

Inputs are made with numpy from a seed and handed to both packages; JAX runs
on the CPU (conftest pins it there) and the port runs with `device="cpu"`.
The suite runs several pytest workers at once, so PyTorch gets one thread.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

CPU = torch.device("cpu")


def np_of(x) -> np.ndarray:
    """numpy copy of a JAX array or a torch tensor."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def unit_rows(rng: np.random.Generator, n: int, d: int) -> np.ndarray:
    v = rng.standard_normal((n, d)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


@pytest.fixture
def cuda_device() -> torch.device:
    """The first card; skips the test where there is none (decided at run time,
    never at import, so every worker collects the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA; run on the card")
    return torch.device("cuda", 0)
