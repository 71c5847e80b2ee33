"""Tests of the port that need the card: the CUDA kernel against its plain
version, and the search path on the card against the same path on the CPU.

They skip where there is no NVIDIA GPU. This file imports no JAX, so it runs
on a machine that has only PyTorch, without the repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q -rs
"""

import numpy as np
import pytest
import torch

from tests.torch_helpers import cuda_device, unit_rows  # noqa: F401  (fixture)
from vod_tpu_torch.ops.mips import fused_mips_binned, fused_mips_binned_reference
from vod_tpu_torch.search import SearchQueries, build_dense_index, dense_search

pytestmark = pytest.mark.cuda


def test_binned_kernel_matches_plain_on_card(cuda_device) -> None:
    """int8 exact; f32/bf16 scores within an f32 sum-order bound and ids equal
    wherever the margin exceeds it; n_real masking; duplicate-row ties."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    n, d, b = 8192, 96, 80
    v = torch.randn((n, d), generator=g, device=cuda_device)
    v = v / v.norm(dim=-1, keepdim=True)
    q = torch.randn((b, d), generator=g, device=cuda_device)
    q = q / q.norm(dim=-1, keepdim=True)
    tol = 2 * d * 2.0**-24  # |q| = |v| = 1: twice the f32 sum-order bound gamma_D
    before = fused_mips_binned.launches
    for dtype in (torch.float32, torch.bfloat16):
        for bins, n_real in ((512, n), (1024, n - 77)):
            kw = dict(k=40, bins=bins, n_real=n_real)
            ks, ki = fused_mips_binned(v.to(dtype), q, **kw)
            rs, ri = fused_mips_binned_reference(v.to(dtype), q, **kw)
            assert (ks - rs).abs().max().item() <= tol
            assert ki.max().item() < n_real
            diff = ki != ri
            if diff.any():  # a swap is allowed only inside the tolerance band
                vf = v.to(dtype).float()
                exact = (q.to(dtype).float()[:, None, :] * vf[ki.long()]).sum(-1)
                assert ((exact - rs).abs()[diff] <= 2 * tol).all()
    qi = torch.randint(-127, 128, (b, d), generator=g, device=cuda_device, dtype=torch.int8)
    vi = torch.randint(-127, 128, (n, d), generator=g, device=cuda_device, dtype=torch.int8)
    vi[5 + 512] = vi[5]  # duplicate rows in one bin
    vi[5 + 7 * 512] = vi[5]
    qi[0] = vi[5]  # ... that win it for query 0
    for n_real in (n, 1000, 3):
        ks, ki = fused_mips_binned(vi, qi, k=512, bins=512, n_real=n_real)
        rs, ri = fused_mips_binned_reference(vi, qi, k=512, bins=512, n_real=n_real)
        assert torch.equal(ks, rs) and torch.equal(ki, ri)
    ks, ki = fused_mips_binned(vi, qi, k=4, bins=512)
    assert ki[0, 0].item() == 5
    torch.cuda.synchronize()
    assert fused_mips_binned.launches == before + 8  # 4 float calls, 4 int8 calls


@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
def test_dense_search_on_card_matches_cpu(cuda_device, dtype: str) -> None:
    rng = np.random.default_rng(1)
    v = unit_rows(rng, 20000, 64)
    q = v[rng.integers(0, 20000, 16)] + 0.1 * unit_rows(rng, 16, 64)
    out = {}
    for dev in ("cpu", cuda_device):
        ix = build_dense_index(v, dtype=dtype, kernel="fused", refine="float32", device=dev)
        ix = ix.replace(fused_bins=1024)
        out[str(dev)] = dense_search(ix, SearchQueries(vector=torch.from_numpy(q).to(dev)), top_k=10)
    cpu, card = out["cpu"], out[str(cuda_device)]
    torch.testing.assert_close(card.scores.cpu(), cpu.scores, atol=1e-5, rtol=0)
    assert torch.equal(card.indices.cpu()[:, 0], cpu.indices[:, 0])
    assert (card.indices.cpu() == cpu.indices).float().mean().item() >= 0.99
