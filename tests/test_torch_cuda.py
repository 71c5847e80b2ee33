"""Tests of the port that need the card: the CUDA kernels against their plain
versions, and the search path on the card against the same path on the CPU.

They skip where there is no NVIDIA GPU. This file imports no JAX, so it runs
on a machine that has only PyTorch, without the repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q -rs
"""

import numpy as np
import pytest
import torch

from tests.torch_helpers import cuda_device, unit_rows  # noqa: F401  (fixture)
from vod_tpu_torch.ops.mips import (
    fused_mips_binned,
    fused_mips_binned_reference,
    fused_mips_topk,
    fused_mips_topk_reference,
)
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


def test_topk_kernel_matches_plain_on_card(cuda_device) -> None:
    """Scores within an f32 sum-order bound and ids equal wherever the margin
    exceeds it; n_real masking; empty slots -1/-inf; duplicate rows in
    different splits tie to the lowest id; one launch counted per call."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    n, d, b = 8192, 96, 80
    v = torch.randn((n, d), generator=g, device=cuda_device)
    v = v / v.norm(dim=-1, keepdim=True)
    for j in (1005, 5005):  # 80 queries split the rows 128 ways: 64 rows a split
        v[j] = v[5]
    q = torch.randn((b, d), generator=g, device=cuda_device)
    q = q / q.norm(dim=-1, keepdim=True)
    q[0] = v[5]
    tol = 2 * d * 2.0**-24 * 1.01  # twice gamma_D * |q| * |v|; bf16 rounding moves a norm by < 0.5%
    before = fused_mips_topk.launches
    calls = 0
    for dtype in (torch.float32, torch.bfloat16):
        vv = v.to(dtype)
        for k in (10, 128):
            for n_real in (n, n - 77, 3):
                ks, ki = fused_mips_topk(vv, q, k=k, n_real=n_real)
                rs, ri = fused_mips_topk_reference(vv, q, k=k, n_real=n_real)
                calls += 1
                finite = torch.isfinite(rs)
                assert torch.equal(torch.isfinite(ks), finite)
                assert (ks[finite] - rs[finite]).abs().max().item() <= tol
                assert ki.max().item() < n_real and torch.equal(ki[~finite], ri[~finite])
                if n_real == 3:
                    assert (ki[:, 3:] == -1).all() and torch.isneginf(ks[:, 3:]).all()
                diff = ki != ri
                if diff.any():  # a swap is allowed only inside the tolerance band
                    exact = (q.to(dtype).double()[:, None, :] * vv[ki.long()].double()).sum(-1)
                    assert ((exact - rs.double()).abs()[diff] <= 2 * tol).all()
                if n_real > 5005:
                    assert ki[0, :3].tolist() == [5, 1005, 5005]
    torch.cuda.synchronize()
    assert fused_mips_topk.launches == before + calls


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
