"""The select kernel's radix design on the card: its hard cases.

`select_kernel` stages a query's partial scores in shared memory (TMA, or
`cp.async` off the 16-byte grid), finds the k-th score's threshold by radix
passes from the highest bit in which the cells differ, gathers the cells it
keeps in cell order and orders only those (by counting up to k = 256, by a
bitonic sort above). Each case here must equal the plain version, `merge_select_reference` (run on
a CPU copy of the partials, whose stable sort ties -0 with +0), bit for bit:
alone through `merge_select`, and after a body through `fused_mips_binned`'s
own launches on the partials that body wrote. The cases: ties that straddle
the k-th place within a split and across splits, every cell equal, NaN
cells, -0 beside +0, fewer live cells than k (-inf tails, int8 sentinels),
k in {1, bins - 1, bins} at bins in {1, 640, 8,192, 8,193, 32,768} (the last
three past shared memory), clustered scores, B in {1, 4, 32, 2,048}, and 8
host threads against one.

They skip where there is no NVIDIA GPU. This file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_select_radix.py -q -rs
"""

import threading

import pytest
import torch

from tests.torch_helpers import cuda_device  # noqa: F401  (fixture)
from vod_tpu_torch.ops import mips
from vod_tpu_torch.ops.mips import _INT32_MIN, fused_mips_binned, merge_select, merge_select_reference

pytestmark = pytest.mark.cuda


def _bits(x: torch.Tensor) -> torch.Tensor:
    x = x.contiguous().cpu()
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _assert_same(got, part_s, part_i, k: int) -> None:
    """The kernel's (scores, ids) equal the plain version's on a CPU copy of
    the partials: scores bit for bit (NaN and -0 too), ids equal."""
    want = merge_select_reference(part_s.cpu(), part_i.cpu(), k, part_s.dtype == torch.int32)
    assert got[0].dtype == want[0].dtype and got[1].dtype == torch.int32
    assert torch.equal(_bits(got[0]), _bits(want[0]))
    assert torch.equal(got[1].cpu(), want[1])


def _partials(kind: str, splits: int, b: int, bins: int, seed: int, dev):
    """[splits, B, bins] partials of one kind, ids of split z above split
    z - 1's, id -1 at empty cells."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    shape = (splits, b, bins)
    ids = torch.arange(splits * b * bins, dtype=torch.int32).view(shape)
    empty = torch.zeros(shape, dtype=torch.bool)
    if kind == "int8":  # [-2, 2]: the k-th place inside a run of equal cells, within and across splits
        s = torch.randint(-2, 3, shape, generator=g, dtype=torch.int32)
        empty = torch.rand(shape, generator=g) < 0.05
        s = torch.where(empty, torch.tensor(_INT32_MIN, dtype=torch.int32), s)
    elif kind == "split-ties":  # equal float scores in different splits
        s = torch.randint(0, 3, (1, b, bins), generator=g).float().expand(shape).contiguous() * 0.5
    elif kind == "equal":
        s = torch.full(shape, 0.75)
    elif kind == "nan":  # NaN in split 0 stays, in a later split never wins
        s = torch.randint(-3, 4, shape, generator=g).float() * 0.5
        s = torch.where(torch.rand(shape, generator=g) < 0.1, torch.tensor(float("nan")), s)
    elif kind == "zeros":  # -0 beside +0, in cells and across splits
        s = torch.tensor([0.0, -0.0, 1.0, -1.0])[torch.randint(0, 4, shape, generator=g)]
    elif kind in ("few-float", "few-int8"):  # 3 live cells a query (none at 1 bin)
        live = torch.zeros(shape, dtype=torch.bool)
        for q in range(b):
            live[:, q, torch.randperm(bins, generator=g)[: min(3, bins // 2)]] = True
        empty = ~live
        if kind == "few-int8":
            s = torch.randint(-2, 3, shape, generator=g, dtype=torch.int32)
            s = torch.where(empty, torch.tensor(_INT32_MIN, dtype=torch.int32), s)
        else:
            s = torch.where(empty, torch.tensor(float("-inf")), torch.randn(shape, generator=g))
    elif kind == "clustered":  # every score shares its top 9 bits
        s = 0.5 + 1e-3 * torch.randn(shape, generator=g)
    else:  # "randn" with -inf cells
        s = torch.randn(shape, generator=g)
        empty = torch.rand(shape, generator=g) < 0.1
        s = torch.where(empty, torch.tensor(float("-inf")), s)
    return s.to(dev), torch.where(empty, torch.tensor(-1, dtype=torch.int32), ids).to(dev)


KINDS = ["int8", "split-ties", "equal", "nan", "zeros", "few-float", "few-int8", "clustered", "randn"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("b", [1, 4, 32, 2048])
def test_select_kinds_at_each_batch(cuda_device, kind: str, b: int) -> None:
    """512 bins, k = 100, 33 splits (the CLI loops' partials) at every B."""
    part_s, part_i = _partials(kind, 33, b, 512, seed=b + len(kind), dev=cuda_device)
    before = merge_select.launches
    got = merge_select(part_s, part_i, 100)
    torch.cuda.synchronize()
    assert merge_select.launches == before + 1
    _assert_same(got, part_s, part_i, 100)


@pytest.mark.parametrize("kind", ["int8", "randn", "equal", "few-float"])
@pytest.mark.parametrize(
    "bins,k",
    [(1, 1), (640, 1), (640, 639), (640, 640), (8192, 1), (8192, 8191), (8192, 8192), (8193, 1), (8193, 8192),
     (8193, 8193), (32768, 1), (32768, 32767), (32768, 32768)],
)
def test_select_every_k_and_bins(cuda_device, kind: str, bins: int, k: int) -> None:
    """k at 1, bins - 1 and bins; bins past shared memory (8,193 and up) use
    the workspace; two queries, three splits."""
    part_s, part_i = _partials(kind, 3, 2, bins, seed=bins + k, dev=cuda_device)
    got = merge_select(part_s, part_i, k)
    torch.cuda.synchronize()
    _assert_same(got, part_s, part_i, k)


def _body_then_select(v, q, k: int, bins: int, n_real: int):
    """One CUDA call's launches as `fused_mips_binned` makes them, keeping its
    workspace: returns (scores, ids), the partials the body wrote, the plan."""
    int8 = v.dtype == torch.int8
    b, d = (int(x) for x in q.shape)
    dev = v.device
    plan = mips._binned_plan(v, q, bins, n_real)
    out_s, out_i = mips._outputs(b, k, torch.int32 if int8 else torch.float32, dev)
    ws, ps, pi, keys = mips._workspace(dev, plan, b, bins)
    mips._launch(fused_mips_binned, plan, dev, mips._DTYPE_CODES[v.dtype], q.data_ptr(), v.data_ptr(), ps, pi,
                 out_s.data_ptr(), out_i.data_ptr(), keys, b, d, bins, n_real, plan.splits, k)
    part = ws[: 2 * plan.splits * b * bins].view(2, plan.splits, b, bins)
    return (out_s, out_i), (part[0].view(out_s.dtype), part[1]), plan


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
@pytest.mark.parametrize("b", [1, 4, 32, 2048])
def test_select_after_the_body(cuda_device, dtype: torch.dtype, b: int) -> None:
    """The select kernel on the partials the tensor-core body wrote (real
    inner products, whose scores cluster; int8 ties), at k = 100, at
    k = bins and with fewer live rows than k (n_real = 50), at every B."""
    g = torch.Generator(device=cuda_device).manual_seed(b)
    n, d, bins = 1 << 15, 128, 512
    if dtype == torch.int8:
        v = torch.randint(-2, 3, (n, d), generator=g, device=cuda_device, dtype=torch.int8)
        q = torch.randint(-2, 3, (b, d), generator=g, device=cuda_device, dtype=torch.int8)
    else:
        v = torch.randn((n, d), generator=g, device=cuda_device)
        v /= v.norm(dim=-1, keepdim=True)
        q = v[torch.randint(0, n, (b,), generator=g, device=cuda_device)] + 0.1 * torch.randn(
            (b, d), generator=g, device=cuda_device)
        v, q = v.to(torch.bfloat16), q.to(torch.bfloat16)
    for k, n_real in ((100, n), (bins, n - 333), (100, 50)):
        before = fused_mips_binned.launches
        got, (part_s, part_i), plan = _body_then_select(v, q, k, bins, n_real)
        torch.cuda.synchronize()
        assert fused_mips_binned.launches == before + 1
        assert plan.body == "wgmma"
        _assert_same(got, part_s, part_i, k)
        if n_real < k:
            assert (got[1][:, n_real:] == -1).all()


def test_threads_equal_one_thread(cuda_device) -> None:
    """8 host threads call `merge_select` at once, each at a shape (B, bins)
    whose plan none has built yet, and `fused_mips_binned` after it; every
    result equals the single-thread one and the plain version."""
    jobs = []
    for t in range(8):
        b, bins, kind = (3 + t, 512 + 128 * t, KINDS[t])
        part_s, part_i = _partials(kind, 5, b, bins, seed=100 + t, dev=cuda_device)
        jobs.append((part_s, part_i, 37 + t))
    g = torch.Generator(device=cuda_device).manual_seed(11)
    v = torch.randn((1 << 14, 128), generator=g, device=cuda_device).to(torch.bfloat16)
    queries = [torch.randn((5 + t, 128), generator=g, device=cuda_device).to(torch.bfloat16) for t in range(8)]
    results: list = [None] * len(jobs)
    errors: list = []

    def work(i: int) -> None:
        try:
            part_s, part_i, k = jobs[i]
            for _ in range(20):
                out = merge_select(part_s, part_i, k)
                call = fused_mips_binned(v, queries[i], k=k, bins=512)
            torch.cuda.current_stream().synchronize()
            results[i] = (out, call)
        except Exception as exc:  # noqa: BLE001  (reported below)
            errors.append(exc)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(len(jobs))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    assert not any(th.is_alive() for th in threads)
    assert not errors, errors
    for i, ((part_s, part_i, k), (out, call)) in enumerate(zip(jobs, results)):
        _assert_same(out, part_s, part_i, k)
        again = fused_mips_binned(v, queries[i], k=k, bins=512)
        assert torch.equal(_bits(call[0]), _bits(again[0])) and torch.equal(call[1], again[1])
