"""The binned kernel's selection and launch plan against JAX, on the CPU.

`merge_select_reference` is the plain version of the card's `select_kernel`:
partial cells `[splits, B, bins]` folded in split order, then k of the cells
in `lax.top_k`'s order. Here it must equal JAX on the same partials (folded in
numpy, then `jax.lax.top_k` and the id mapping of
`vod_tpu/ops/mips_pallas.py:286-290`) exactly: int8 scores with heavy ties,
float scores with -inf cells, empty cells past n_real, k from 1 to bins, bins
from 128 to 8192. `fused_mips_binned` on the CPU at the CLI loops' shapes, cut
in rows, still equals the Pallas kernel in interpret mode, and the plan's
splits equal the formula the wrapper used before plans. The kernel itself is
held against `merge_select_reference` on the card in
`test_torch_cuda_select.py`.
"""

import sys
import threading
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_helpers import np_of
from vod_tpu.ops.mips_pallas import fused_mips_binned as jax_binned
from vod_tpu_torch.examples import narrow_call_bench
from vod_tpu_torch.ops import mips
from vod_tpu_torch.ops.mips import (
    _INT32_MIN,
    _select_cells,
    binned_splits,
    fused_mips_binned,
    merge_select,
    merge_select_reference,
)

F32_ATOL = 1e-5  # two f32 sum orders of a unit-row dot product (as tests/test_torch_mips.py)


def _partials(kind: str, splits: int, b: int, bins: int, seed: int, empty_tail: int = 0):
    """[splits, B, bins] partials as the kernel's bodies write them: split z's
    ids above split z - 1's, empty cells at the sentinel (int8) or -inf with
    id -1, and the last `empty_tail` cells empty in every split (rows past
    n_real)."""
    rng = np.random.default_rng(seed)
    ids = np.arange(splits * b * bins, dtype=np.int32).reshape(splits, b, bins)
    if kind == "int8":  # values in [-2, 2]: ties within and across splits
        s = rng.integers(-2, 3, size=(splits, b, bins)).astype(np.int32)
        empty = rng.random((splits, b, bins)) < 0.05
        fill = np.int32(_INT32_MIN)
    else:
        s = (rng.integers(-3, 4, size=(splits, b, bins)) * 0.5).astype(np.float32)
        empty = rng.random((splits, b, bins)) < 0.1
        fill = np.float32(-np.inf)
    if empty_tail:
        empty[..., bins - empty_tail:] = True
    return np.where(empty, fill, s), np.where(empty, np.int32(-1), ids)


def _jax_select(part_s: np.ndarray, part_i: np.ndarray, k: int, int8: bool):
    """The partials folded in numpy (strict `>`, increasing split), then the
    TPU wrapper's selection: `lax.top_k` and its id mapping."""
    cell_s, cell_i = part_s[0], part_i[0]
    for z in range(1, part_s.shape[0]):
        better = part_s[z] > cell_s
        cell_s, cell_i = np.where(better, part_s[z], cell_s), np.where(better, part_i[z], cell_i)
    top_s, pos = jax.lax.top_k(jnp.asarray(cell_s), k)
    top_i = jnp.take_along_axis(jnp.asarray(cell_i), pos, axis=-1)
    valid = top_s > _INT32_MIN if int8 else jnp.isfinite(top_s)
    return np.asarray(top_s), np.asarray(jnp.where(valid, top_i, -1))


@pytest.mark.parametrize("kind", ["int8", "float"])
@pytest.mark.parametrize("splits", [1, 2, 5])
@pytest.mark.parametrize(
    "b,bins,k,empty_tail",
    [(3, 128, 1, 0), (4, 512, 100, 0), (2, 512, 512, 0), (3, 1024, 40, 1000), (2, 2048, 160, 0),
     (2, 8192, 40, 0), (2, 256, 256, 200)],
    ids=["bins128-k1", "bins512-k100", "bins512-kall", "bins1024-tail", "bins2048-k160", "bins8192",
         "bins256-kall-tail"],
)
def test_merge_select_reference_matches_jax(kind: str, splits: int, b: int, bins: int, k: int,
                                            empty_tail: int) -> None:
    part_s, part_i = _partials(kind, splits, b, bins, seed=splits * 100 + bins + k, empty_tail=empty_tail)
    js, ji = _jax_select(part_s, part_i, k, kind == "int8")
    ts, ti = merge_select_reference(torch.from_numpy(part_s), torch.from_numpy(part_i), k, kind == "int8")
    assert ts.dtype == (torch.int32 if kind == "int8" else torch.float32) and ti.dtype == torch.int32
    assert np.array_equal(np_of(ti), ji)
    assert np.array_equal(np_of(ts), js)  # -inf == -inf; no NaN here
    if empty_tail >= bins - k + 1:  # the tail reaches the selection: those slots are empty
        assert (np_of(ti)[:, bins - empty_tail:] == -1).all()


def test_merge_select_on_the_cpu_is_the_reference_and_counts_nothing() -> None:
    part_s, part_i = _partials("int8", 3, 4, 512, seed=9)
    ps, pi = torch.from_numpy(part_s), torch.from_numpy(part_i)
    before = merge_select.launches
    got = merge_select(ps, pi, 100)
    want = merge_select_reference(ps, pi, 100, True)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert merge_select.launches == before


@pytest.mark.parametrize(
    "shape,k,error",
    [((2, 4), 1, ValueError), ((1, 2, 8), 9, ValueError), ((1, 2, 8), 0, ValueError)],
    ids=["not-3d", "k-above-bins", "k-zero"],
)
def test_merge_select_refuses_bad_calls(shape, k: int, error) -> None:
    s = torch.zeros(shape, dtype=torch.int32)
    with pytest.raises(error):
        merge_select(s, torch.zeros(shape, dtype=torch.int32), k)


def test_merge_select_refuses_other_score_types() -> None:
    with pytest.raises(TypeError):
        merge_select(torch.zeros((1, 2, 8), dtype=torch.float64), torch.zeros((1, 2, 8), dtype=torch.int32), 2)


def _unit(rng, n: int, d: int) -> np.ndarray:
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


@pytest.mark.parametrize(
    "dtype,b,d,n,k",
    [("float32", 32, 384, 2048, 100), ("int8", 32, 256, 4096, 100), ("float32", 4, 1024, 1024, 100)],
    ids=["phase9-cli-loop", "phase12b-per-shard", "phase10-large-cli"],
)
def test_binned_at_narrow_call_shapes_matches_jax(dtype: str, b: int, d: int, n: int, k: int) -> None:
    """The CLI loops' calls (bins 512, k = 100), rows cut to thousands: the
    port's CPU path equals the Pallas kernel in interpret mode (int8 exactly,
    f32 ids exactly and scores within F32_ATOL)."""
    rng = np.random.default_rng(b + d + n)
    if dtype == "int8":
        v = rng.integers(-127, 128, size=(n, d)).astype(np.int8)
        q = rng.integers(-127, 128, size=(b, d)).astype(np.int8)
    else:
        v = _unit(rng, n, d)
        q = _unit(rng, b, d)
    kw = dict(k=k, bins=512, tile=1024, n_real=n - 37)
    js, ji = jax_binned(jnp.asarray(v), jnp.asarray(q), qblock=8, interpret=True, **kw)
    ts, ti = fused_mips_binned(torch.from_numpy(v), torch.from_numpy(q), **kw)
    assert np.array_equal(np_of(ji), np_of(ti))
    if dtype == "int8":
        assert np.array_equal(np_of(js), np_of(ts))
    else:
        np.testing.assert_allclose(np_of(ts), np_of(js), atol=F32_ATOL, rtol=0)


def _splits_before_plans(sms: int, per_sm: int, b: int, bins: int, n_real: int, body: str) -> int:
    """The stride splits as the wrapper's `_binned_splits` computed them on
    every call before launch plans."""
    strides = -(-n_real // bins)
    tiles = -(-bins // {"fma": 64, "wgmma": 128}[body]) * -(-b // 64)
    splits = max(1, min(strides, per_sm * sms // max(1, tiles), 65535))
    if body == "wgmma":
        splits = max(splits, -(-strides // 65535))
    return splits


@pytest.mark.parametrize("body", ["wgmma", "fma"])
@pytest.mark.parametrize("sms,per_sm", [(132, 1), (132, 2), (114, 4), (1, 1)])
def test_plan_splits_equal_the_old_formula(body: str, sms: int, per_sm: int) -> None:
    for b in (1, 4, 32, 64, 65, 2048):
        for bins in (128, 512, 1024, 4096):
            for n_real in (0, 1, 1000, 1 << 15, 1 << 20, 1 << 30):
                assert binned_splits(sms, per_sm, b, bins, n_real, body) == _splits_before_plans(
                    sms, per_sm, b, bins, n_real, body), (b, bins, n_real)


def test_select_workspace_only_past_shared_memory() -> None:
    assert [_select_cells(bins) for bins in (1, 128, 640, 8192, 8193, 40000)] == [0, 0, 0, 0, 16384, 65536]
    assert mips._SELECT_SMEM_CELLS == 8192  # twin of SELECT_SMEM_CELLS in csrc/fused_mips_binned.cu


def test_plan_cache_builds_each_key_once_under_threads() -> None:
    """16 threads ask for 4 plans at once (a server's handlers on a fresh
    shape): each plan is built once, every thread gets the one built, and
    the build count moves by 4."""
    built: dict = {}
    before = dict(mips.plan_stats)
    keys = [("test-plan-cache", i, time.perf_counter_ns()) for i in range(4)]
    got: list = [None] * 16
    barrier = threading.Barrier(16)

    def build(key):
        def make():
            built[key] = built.get(key, 0) + 1
            time.sleep(0.01)  # another thread would build it again if the lock let it in
            return mips._Plan(None, "fma", 1, 0)
        return make

    def ask(i: int) -> None:
        barrier.wait(timeout=30)
        key = keys[i % 4]
        got[i] = (key, mips._plan(key, build(key)))

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=ask, args=(i,)) for i in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
        for key in keys:
            mips._plans.pop(key, None)
    assert not any(th.is_alive() for th in threads)
    assert built == {key: 1 for key in keys}
    for key, plan in got:
        assert plan is got[keys.index(key)][1]
    assert mips.plan_stats["plans"] == before["plans"] + 4


def test_plan_cache_keeps_at_most_max_plans(monkeypatch) -> None:
    """Past `_MAX_PLANS` the oldest plan goes; a plan that comes back is built
    again, and the newest stay."""
    monkeypatch.setattr(mips, "_plans", {})
    monkeypatch.setattr(mips, "_MAX_PLANS", 3)
    before = mips.plan_stats["plans"]
    plans = {i: mips._plan(("test-cap", i), lambda: mips._Plan(None, "fma", 1, 0)) for i in range(5)}
    assert list(mips._plans) == [("test-cap", i) for i in (2, 3, 4)]
    assert mips._plan(("test-cap", 4), lambda: mips._Plan(None, "fma", 2, 0)) is plans[4]
    again = mips._plan(("test-cap", 0), lambda: mips._Plan(None, "fma", 3, 0))
    assert again.splits == 3 and list(mips._plans) == [("test-cap", i) for i in (3, 4, 0)]
    assert mips.plan_stats["plans"] == before + 6


def test_current_stream_without_the_raw_binding(monkeypatch) -> None:
    """Where torch has its raw-stream binding the wrapper reads it; without it,
    the public `torch.cuda.current_stream(dev).cuda_stream`."""
    dev = torch.device("cuda", 1)
    monkeypatch.setattr(mips, "_raw_stream", lambda index: 7000 + index)
    assert mips._current_stream(dev) == 7001
    seen = []
    monkeypatch.setattr(mips, "_raw_stream", None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: seen.append(d) or types.SimpleNamespace(cuda_stream=4242))
    assert mips._current_stream(dev) == 4242 and seen == [dev]


def test_narrow_call_bench_runs_on_the_cpu() -> None:
    """The bench at a rehearsal size: every shape gives finite host numbers and
    a bound; no device number is made on the CPU."""
    rows = narrow_call_bench.run(torch.device("cpu"), reps=2, scale=64)
    assert [r["label"] for r in rows] == [s[0] for s in narrow_call_bench.SHAPES]
    for r in rows:
        assert np.isfinite(r["host_ms"]) and np.isfinite(r["wall_ms"]) and r["bound_ms"] > 0
        assert "device_ms" not in r and "library_ms" not in r


def test_narrow_call_bench_defaults_to_the_card() -> None:
    """Its `--device` defaults to cuda, and asking for the card where there is
    none fails rather than falling back to the CPU."""
    assert narrow_call_bench.parser().parse_args([]).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="needs a CUDA card"):
            narrow_call_bench.main(["--device", "cuda"])
