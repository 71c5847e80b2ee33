"""The binned kernel's selection (`select_kernel`) and launch plans on the card.

The select kernel must equal its plain version, `merge_select_reference`, bit
for bit: alone on partials made here (int8 ties within and across splits,
-inf and NaN cells, one to five splits, bins from 1 to 32,768, k from 1 to
bins), and after each body on the partials the body wrote. (A -0 score is
left out: the kernel ties it with +0, as torch's CPU sort does; torch's radix
sort on the card need not.) The launch
plan is built once per shape, and concurrent calls from server-like threads
give the single-thread results.

They skip where there is no NVIDIA GPU. This file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_select.py -q -rs
"""

import threading

import pytest
import torch

from tests.torch_helpers import cuda_device  # noqa: F401  (fixture)
from vod_tpu_torch.ops import mips
from vod_tpu_torch.ops.mips import (
    _INT32_MIN,
    fused_mips_binned,
    fused_mips_binned_reference,
    merge_select,
    merge_select_reference,
)

pytestmark = pytest.mark.cuda


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _assert_same(got, want) -> None:
    """Scores equal bit for bit (NaN too), ids equal."""
    assert got[0].dtype == want[0].dtype and got[1].dtype == want[1].dtype == torch.int32
    assert torch.equal(_bits(got[0]), _bits(want[0].contiguous()))
    assert torch.equal(got[1], want[1])


def _partials(kind: str, splits: int, b: int, bins: int, seed: int, dev):
    """[splits, B, bins] partial cells as a body leaves them: ids of split z
    above those of split z - 1, empty cells with id -1."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    ids = torch.arange(splits * b * bins, dtype=torch.int32).view(splits, b, bins)
    if kind == "int8":  # heavy ties, the sentinel in a few cells
        s = torch.randint(-2, 3, (splits, b, bins), generator=g, dtype=torch.int32)
        empty = torch.rand((splits, b, bins), generator=g) < 0.05
        s = torch.where(empty, torch.tensor(_INT32_MIN, dtype=torch.int32), s)
    else:  # coarse floats (ties), -inf cells and a NaN
        s = torch.randint(-3, 4, (splits, b, bins), generator=g).float() * 0.5
        empty = torch.rand((splits, b, bins), generator=g) < 0.1
        s = torch.where(empty, torch.tensor(float("-inf")), s)
        s[0, 0, min(3, bins - 1)] = float("nan")
    ids = torch.where(empty, torch.tensor(-1, dtype=torch.int32), ids)
    return s.to(dev), ids.to(dev)


@pytest.mark.parametrize("kind", ["int8", "float"])
@pytest.mark.parametrize(
    "splits,b,bins,k",
    [(1, 4, 128, 1), (2, 3, 512, 100), (5, 8, 512, 512), (5, 2, 1024, 40), (2, 5, 4096, 160),
     (1, 2, 8192, 8192), (3, 2, 16384, 16384), (3, 2, 32768, 100), (2, 3, 640, 7), (1, 3, 1, 1)],
    ids=["s1-b128-k1", "s2-b512-k100", "s5-b512-kall", "s5-b1024-k40", "s2-b4096-k160", "s1-b8192-kall",
         "s3-b16384-ws-kall", "s3-b32768-ws", "s2-b640-k7", "s1-b1"],
)
def test_select_kernel_equals_reference(cuda_device, kind: str, splits: int, b: int, bins: int, k: int) -> None:
    part_s, part_i = _partials(kind, splits, b, bins, seed=splits * 7 + bins, dev=cuda_device)
    before = merge_select.launches
    got = merge_select(part_s, part_i, k)
    torch.cuda.synchronize()
    assert merge_select.launches == before + 1
    _assert_same(got, merge_select_reference(part_s, part_i, k, kind == "int8"))


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


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16, torch.float32])
@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "off-grid"])
def test_select_after_each_body(cuda_device, dtype: torch.dtype, aligned: bool) -> None:
    """The select kernel on the partials each body wrote: bit for bit its plain
    version's; int8 equals the whole plain path too (heavy ties). Rows off the
    16-byte grid (int8 4 bytes, floats one element) take the CUDA-core body."""
    g = torch.Generator(device=cuda_device).manual_seed(3)
    n, d, b, bins = 16384, 128, 33, 512
    if dtype == torch.int8:
        base = torch.randint(-2, 3, (n * d + 4,), generator=g, device=cuda_device, dtype=torch.int8)
        q = torch.randint(-2, 3, (b, d), generator=g, device=cuda_device, dtype=torch.int8)
    else:
        base = torch.randn((n * d + 4,), generator=g, device=cuda_device).to(dtype)
        q = torch.randn((b, d), generator=g, device=cuda_device).to(dtype)
    shift = 0 if aligned else (4 if dtype == torch.int8 else 1)
    v = base[shift : shift + n * d].view(n, d)
    expect = "wgmma" if dtype != torch.float32 and aligned else "fma"
    for k, n_real in ((100, n), (bins, n - 333), (1, 700)):
        got, (part_s, part_i), plan = _body_then_select(v, q, k, bins, n_real)
        torch.cuda.synchronize()
        assert plan.body == expect
        _assert_same(got, merge_select_reference(part_s, part_i, k, dtype == torch.int8))
        if dtype == torch.int8:
            _assert_same(got, fused_mips_binned_reference(v, q, k=k, bins=bins, n_real=n_real))
            _assert_same(got, fused_mips_binned(v, q, k=k, bins=bins, n_real=n_real))


def test_plan_is_built_once_per_shape(cuda_device) -> None:
    g = torch.Generator(device=cuda_device).manual_seed(5)
    v = torch.randn((8192, 64), generator=g, device=cuda_device).to(torch.bfloat16)
    q = torch.randn((7, 64), generator=g, device=cuda_device).to(torch.bfloat16)
    kw = dict(k=10, bins=256, n_real=8192 - 41)  # a shape no other test uses
    first = fused_mips_binned(v, q, **kw)
    stats = dict(mips.plan_stats)
    for _ in range(3):
        again = fused_mips_binned(v, q, **kw)
        _assert_same(again, first)
    assert mips.plan_stats == stats  # no plan built and no occupancy query made again
    fused_mips_binned(v, q[:6], **kw)  # another B: one more plan, the same occupancy
    assert mips.plan_stats == dict(stats, plans=stats["plans"] + 1)


def test_concurrent_calls_equal_single_thread(cuda_device) -> None:
    """8 threads (a server's handlers) call at once, over shapes whose plans
    none has built yet; each result equals the single-thread one."""
    g = torch.Generator(device=cuda_device).manual_seed(7)
    vb = torch.randn((16384, 128), generator=g, device=cuda_device).to(torch.bfloat16)
    vi = torch.randint(-2, 3, (16384, 128), generator=g, device=cuda_device, dtype=torch.int8)
    jobs = []
    for t in range(8):
        v = vb if t % 2 else vi
        q = (torch.randn((9 + t, 128), generator=g, device=cuda_device).to(torch.bfloat16) if t % 2 else
             torch.randint(-2, 3, (9 + t, 128), generator=g, device=cuda_device, dtype=torch.int8))
        jobs.append((v, q, dict(k=50, bins=512, n_real=16384 - 17 * t)))
    results: list = [None] * len(jobs)
    errors: list = []

    def work(i: int) -> None:
        try:
            v, q, kw = jobs[i]
            for _ in range(20):
                out = fused_mips_binned(v, q, **kw)
            torch.cuda.current_stream().synchronize()
            results[i] = out
        except Exception as exc:  # noqa: BLE001  (reported below)
            errors.append(exc)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(len(jobs))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    assert not any(th.is_alive() for th in threads)
    assert not errors, errors
    for (v, q, kw), got in zip(jobs, results):
        _assert_same(got, fused_mips_binned(v, q, **kw))
