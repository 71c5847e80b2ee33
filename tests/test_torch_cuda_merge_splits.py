"""The exact kernel's split merge (`merge_splits_kernel`) on the card.

The kernel must equal its plain version, `merge_splits_reference` (run on a
CPU copy of the partials), bit for bit, scores and ids: alone through
`merge_splits` on partial lists made here (each sorted by score descending,
then id ascending, split z's ids above split z - 1's, empty slots -inf with
id -1) at B = 1, 64 and 2,048, k = 1, 10, 100 and 128, 2, 132 and 396 splits,
and past shared memory (60,000 or more cells a query: read in place); scores
in {-1, 0, 1} (ties within and across splits); splits with no pair at all.
The shapes reach both sides of the kernel's rule for its bound step (more
than 256 cells a query) and of its pace (fewer than 2 queries an SM, or
more). Each call adds one to
`merge_splits.launches`. Then `fused_mips_topk` on both bodies, which merge
their splits with the same kernel, against its plain version on rows whose
products are exact (small integers), so that both must agree bit for bit
and ties abound.

They skip where there is no NVIDIA GPU. This file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_merge_splits.py -q -rs
"""

import pytest
import torch

from tests.torch_helpers import cuda_device  # noqa: F401  (fixture)
from vod_tpu_torch.ops.mips import (
    _topk_body,
    fused_mips_topk,
    fused_mips_topk_reference,
    merge_splits,
    merge_splits_reference,
)

pytestmark = pytest.mark.cuda


def _lists(kind: str, splits: int, b: int, k: int, seed: int, dev) -> tuple[torch.Tensor, torch.Tensor]:
    """[splits, B, k] partial lists of one kind that keep the kernel's
    contract: ids rise within a run of equal scores and from split to split."""
    g = torch.Generator(device=dev).manual_seed(seed)
    shape = (splits, b, k)
    if kind == "ties":
        s = torch.randint(-1, 2, shape, generator=g, device=dev).float()
    else:
        s = torch.randn(shape, generator=g, device=dev)
    if kind == "empty":  # half the splits hold nothing for a query, the rest a random tail of -inf
        none = torch.rand((splits, b, 1), generator=g, device=dev) < 0.5
        tail = torch.arange(k, device=dev) >= torch.randint(0, k + 1, (splits, b, 1), generator=g, device=dev)
        s = torch.where(none | tail, float("-inf"), s)
    s = s.sort(dim=-1, descending=True, stable=True).values
    j = torch.arange(k, device=dev, dtype=torch.int32)
    z = torch.arange(splits, device=dev, dtype=torch.int32).view(-1, 1, 1)
    ids = z * (3 * k + 3) + 3 * j + torch.randint(0, 3, shape, generator=g, device=dev, dtype=torch.int32)
    return s.contiguous(), torch.where(torch.isneginf(s), -1, ids).contiguous()


def _assert_merged(part_s, part_i, k: int) -> None:
    """One launch, equal to the plain version bit for bit."""
    before = merge_splits.launches
    got_s, got_i = merge_splits(part_s, part_i, k)
    torch.cuda.synchronize()
    assert merge_splits.launches == before + 1
    want_s, want_i = merge_splits_reference(part_s.cpu(), part_i.cpu(), k)
    assert torch.equal(got_s.cpu().view(torch.int32), want_s.view(torch.int32))
    assert torch.equal(got_i.cpu(), want_i)


@pytest.mark.parametrize("splits", [2, 132, 396])
@pytest.mark.parametrize("k", [1, 10, 100, 128])
@pytest.mark.parametrize("b", [1, 64, 2048])
def test_merge_equals_plain(cuda_device, b: int, k: int, splits: int) -> None:
    _assert_merged(*_lists("randn", splits, b, k, seed=b + k + splits, dev=cuda_device), k)


@pytest.mark.parametrize("kind", ["randn", "ties", "empty"])
@pytest.mark.parametrize("k, splits", [(1, 60000), (10, 6000), (100, 600), (128, 500)])
@pytest.mark.parametrize("b", [1, 64])
def test_merge_past_shared_memory(cuda_device, b: int, k: int, splits: int, kind: str) -> None:
    """60,000 or 64,000 cells a query: more than shared memory holds beside
    the list of cells in play, so the kernel reads the partials in place."""
    _assert_merged(*_lists(kind, splits, b, k, seed=splits + len(kind), dev=cuda_device), k)


@pytest.mark.parametrize("kind", ["ties", "empty"])
@pytest.mark.parametrize("splits", [2, 4, 132, 396])
@pytest.mark.parametrize("k", [1, 10, 128])
@pytest.mark.parametrize("b", [1, 64, 2048])
def test_merge_ties_and_empty_splits(cuda_device, b: int, k: int, splits: int, kind: str) -> None:
    """Scores in {-1, 0, 1}: the k-th place inside a run of equal scores that
    spans splits; or half the splits empty for a query and the rest with -inf
    tails, so that some queries have fewer finite pairs than k."""
    _assert_merged(*_lists(kind, splits, b, k, seed=3 * splits + k, dev=cuda_device), k)


def test_merge_of_only_empty_splits(cuda_device) -> None:
    """Nothing in any split: -inf with id -1 in every slot."""
    part_s = torch.full((132, 64, 128), float("-inf"), device=cuda_device)
    part_i = torch.full((132, 64, 128), -1, dtype=torch.int32, device=cuda_device)
    _assert_merged(part_s, part_i, 128)
    got_s, got_i = merge_splits(part_s, part_i, 128)
    assert torch.isneginf(got_s).all() and (got_i == -1).all()


def _integer_rows(n: int, d: int, g, dev) -> torch.Tensor:
    """Rows of small integers: every product and sum is exact in f32, and
    equal scores are many."""
    return torch.randint(-2, 3, (n, d), generator=g, device=dev).float()


@pytest.mark.parametrize("k", [10, 128])
@pytest.mark.parametrize("b", [1, 64])
@pytest.mark.parametrize("body", ["wgmma", "fma"])
def test_exact_kernel_merges_its_splits_as_the_plain_version(cuda_device, body: str, b: int, k: int) -> None:
    """2^16 rows of D = 64 (132 splits on the tensor-core body, 264 or 396 on
    the CUDA-core body): the call equals its plain version bit for bit."""
    g = torch.Generator(device=cuda_device).manual_seed(b + k)
    v = _integer_rows(1 << 16, 64, g, cuda_device)
    q = _integer_rows(b, 64, g, cuda_device)
    v = v.to(torch.bfloat16) if body == "wgmma" else v  # f32 runs on CUDA cores
    assert _topk_body(v.dtype, 64, (v.data_ptr(), q.to(v.dtype).data_ptr())) == body
    before, body_before = fused_mips_topk.launches, fused_mips_topk.body_launches[body]
    ks, ki = fused_mips_topk(v, q, k=k)
    torch.cuda.synchronize()
    assert fused_mips_topk.launches == before + 1 and fused_mips_topk.body_launches[body] == body_before + 1
    rs, ri = fused_mips_topk_reference(v, q, k=k)
    assert torch.equal(ks, rs) and torch.equal(ki, ri)
