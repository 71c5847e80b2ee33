"""Card tests of both MIPS kernels' CUDA-core ("fma") bodies: each call is
held to the plain version and checked to have launched the fma body.

Scores agree within twice the f32 sum-order bound (gamma_D |q| |v|); ids are
equal bit for bit except where two candidates lie within that band. The cases
cover f32 and bf16 rows at storage offsets 0, 1, 3 and 7 elements, D from 1 to
1544, ragged query tiles (B = 1, 3, 65, 130), exact k = 1, 10 and 128, bin
counts off the tensor cores' 128-bin tile, `n_real` cutting a tile and
leaving fewer real rows than slots, equal rows in different splits, and a
zero corpus against negative queries.

They skip where there is no NVIDIA GPU. This file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_fma.py -q -rs
"""

import pytest
import torch

from tests.torch_helpers import cuda_device  # noqa: F401  (fixture)
from vod_tpu_torch.examples.fma_bench import compare
from vod_tpu_torch.ops.mips import (
    _binned_body,
    _topk_body,
    fused_mips_binned,
    fused_mips_binned_reference,
    fused_mips_topk,
    fused_mips_topk_reference,
)

pytestmark = pytest.mark.cuda

LAYOUTS = [("float32", 0), ("bfloat16", 0), ("bfloat16", 1), ("bfloat16", 3), ("bfloat16", 7)]
DIMS = (1, 8, 36, 100, 768, 904, 1544)
BATCHES = (1, 3, 64, 65, 130)
N_EXACT = 4096  # 64 row tiles: with B <= 130 every tile is a split of its own
N_BINNED = 12288  # a multiple of each bin count's tile (1024, 3072)


def _exact_fma(dtype: str, offset: int, d: int) -> bool:
    """Whether the exact kernel's rule sends rows of this layout to the fma body."""
    return not (dtype == "bfloat16" and offset == 0 and d % 8 == 0 and d <= 896)


def _binned_fma(dtype: str, offset: int, d: int, bins: int) -> bool:
    return not (dtype == "bfloat16" and offset == 0 and d % 8 == 0 and d <= 1536 and bins % 128 == 0)


def _rows(dev, dtype: str, offset: int, n: int, d: int, g, unit: bool = True) -> torch.Tensor:
    """[n, d] seeded rows (unit norm) of `dtype`, `offset` elements into a fresh buffer."""
    x = torch.randn((n, d), generator=g, device=dev)
    if unit:
        x = x / x.norm(dim=-1, keepdim=True)
    out = torch.empty(n * d + offset, dtype=getattr(torch, dtype), device=dev)[offset:].view(n, d)
    out.copy_(x)
    return out


def _tol(d: int) -> float:
    return 2 * d * 2.0**-24 * 1.01  # twice gamma_D |q| |v|; bf16 rounding moves a unit norm by < 0.5%


def _exact_call(v, q, k: int, n_real: int) -> tuple:
    assert _topk_body(v.dtype, v.shape[1], (v.data_ptr(), q.to(v.dtype).data_ptr())) == "fma"
    before = fused_mips_topk.body_launches["fma"]
    out = fused_mips_topk(v, q, k=k, n_real=n_real)
    assert fused_mips_topk.body_launches["fma"] == before + 1
    return out


def _binned_call(v, q, bins: int, tile: int, n_real: int) -> tuple:
    assert _binned_body(v.dtype, v.shape[1], bins, (v.data_ptr(), q.to(v.dtype).data_ptr())) == "fma"
    before = fused_mips_binned.body_launches["fma"]
    out = fused_mips_binned(v, q, k=bins, bins=bins, tile=tile, n_real=n_real)  # every cell
    assert fused_mips_binned.body_launches["fma"] == before + 1
    return out


@pytest.mark.parametrize(
    "dtype, offset, d", [(dt, off, d) for dt, off in LAYOUTS for d in DIMS if _exact_fma(dt, off, d)]
)
def test_topk_fma_body_matches_plain(cuda_device, dtype: str, offset: int, d: int) -> None:
    """The exact kernel's fma body against the plain version at every B, k
    and n_real; the slots past n_real hold -inf and id -1."""
    g = torch.Generator(device=cuda_device).manual_seed(d + offset)
    v = _rows(cuda_device, dtype, offset, N_EXACT, d, g)
    q = torch.randn((max(BATCHES), d), generator=g, device=cuda_device)
    q = q / q.norm(dim=-1, keepdim=True)
    for b in BATCHES:
        for k in (1, 10, 128):
            for n_real in (N_EXACT, N_EXACT - 77, 3):
                ks, ki = _exact_call(v, q[:b], k, n_real)
                rs, ri = fused_mips_topk_reference(v, q[:b], k=k, n_real=n_real)
                compare(ks, ki, rs, ri, q[:b], v, _tol(d))
                assert ki.max().item() < n_real
                if n_real < k:
                    assert (ki[:, n_real:] == -1).all() and torch.isneginf(ks[:, n_real:]).all()
    torch.cuda.synchronize()


@pytest.mark.parametrize(
    "dtype, offset, d, bins",
    [(dt, off, d, bins) for dt, off in LAYOUTS for d in DIMS for bins in (64, 192, 1024)
     if _binned_fma(dt, off, d, bins)],
)
def test_binned_fma_body_matches_plain(cuda_device, dtype: str, offset: int, d: int, bins: int) -> None:
    """The binned kernel's fma body against the plain version, every cell, at
    every B and n_real; cells with no real row hold -inf and id -1."""
    g = torch.Generator(device=cuda_device).manual_seed(d + 10 * offset + bins)
    v = _rows(cuda_device, dtype, offset, N_BINNED, d, g)
    q = torch.randn((max(BATCHES), d), generator=g, device=cuda_device)
    q = q / q.norm(dim=-1, keepdim=True)
    tile = 1024 if 1024 % bins == 0 else 16 * bins  # N % tile == 0 and tile % bins == 0
    for b in BATCHES:
        for n_real in (N_BINNED, N_BINNED - 77, 3):
            ks, ki = _binned_call(v, q[:b], bins, tile, n_real)
            rs, ri = fused_mips_binned_reference(v, q[:b], k=bins, bins=bins, tile=tile, n_real=n_real)
            compare(ks, ki, rs, ri, q[:b], v, _tol(d))
            assert ki.max().item() < n_real
            if n_real == 3:
                assert (ki[:, 3:] == -1).all() and torch.isneginf(ks[:, 3:]).all()
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype, offset", LAYOUTS)
@pytest.mark.parametrize("b", (64, 130))
def test_fma_bodies_tie_equal_rows_to_the_lowest_id(cuda_device, dtype: str, offset: int, b: int) -> None:
    """Equal rows in different splits (exact) and in one bin at different
    strides and splits (binned) win in increasing id order."""
    d = 36  # off the tensor cores' rule at every offset
    g = torch.Generator(device=cuda_device).manual_seed(7)
    v = _rows(cuda_device, dtype, offset, N_BINNED, d, g)
    dups = (5, 5 + 64 * 20, 5 + 64 * 150)  # row tiles 0, 20 and 150: three splits; bin 5 of 64 at three strides
    v[list(dups[1:])] = v[5].clone()
    q = torch.randn((b, d), generator=g, device=cuda_device)
    q = q / q.norm(dim=-1, keepdim=True)
    q[0] = v[5].float()
    ks, ki = _exact_call(v, q, 10, N_BINNED)
    compare(ks, ki, *fused_mips_topk_reference(v, q, k=10), q, v, _tol(d))
    assert ki[0, :3].tolist() == list(dups)
    ks, ki = _binned_call(v, q, 64, 1024, N_BINNED)
    compare(ks, ki, *fused_mips_binned_reference(v, q, k=64, bins=64), q, v, _tol(d))
    assert ki[0, 0].item() == 5


@pytest.mark.parametrize("dtype, offset", LAYOUTS)
@pytest.mark.parametrize("d", (36, 768))
def test_fma_bodies_on_a_zero_corpus(cuda_device, dtype: str, offset: int, d: int) -> None:
    """A corpus of zeros against negative queries: every real row scores 0,
    the zeros the core stages for masked rows never enter, and ties go to the
    lowest ids."""
    if not _exact_fma(dtype, offset, d):
        offset = 1  # bf16 at D = 768 on the grid belongs to the tensor cores
    v = torch.zeros(N_BINNED * d + offset, dtype=getattr(torch, dtype), device=cuda_device)[offset:].view(N_BINNED, d)
    q = -torch.rand((65, d), generator=torch.Generator(device=cuda_device).manual_seed(3), device=cuda_device) - 0.5
    for n_real in (N_BINNED, N_BINNED - 77, 3):
        ks, ki = _exact_call(v, q, 10, n_real)
        live = min(10, n_real)
        assert (ks[:, :live] == 0).all() and (ki[:, :live] == torch.arange(live, device=cuda_device)).all()
        assert torch.isneginf(ks[:, live:]).all() and (ki[:, live:] == -1).all()
        ks, ki = _binned_call(v, q, 192, 3072, n_real)
        rs, ri = fused_mips_binned_reference(v, q, k=192, bins=192, tile=3072, n_real=n_real)
        assert torch.equal(ks, rs) and torch.equal(ki, ri)
        cells = min(192, n_real)
        assert (ks[:, :cells] == 0).all() and (ki[:, :cells] == torch.arange(cells, device=cuda_device)).all()
        assert torch.isneginf(ks[:, cells:]).all() and (ki[:, cells:] == -1).all()
