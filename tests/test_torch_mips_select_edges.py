"""The selection's edge cases against JAX, on the CPU.

The card's `select_kernel` finds a threshold by radix passes and orders only
the k cells it keeps, so its hard cases are the ones where the k-th place is
ambiguous: ties that straddle it (within a split and across splits, every
cell equal), scores that share their top bits (clustered), NaN cells, fewer
live cells than k, and k = bins. Here its plain version,
`merge_select_reference`, and `fused_mips_binned`'s CPU path must equal JAX
on those cases (the partials folded in numpy and `lax.top_k` with the TPU
wrapper's id mapping, as `test_torch_mips_select.py:_jax_select`; the Pallas
kernel in interpret mode): ids equal and scores equal bit for bit. Scores
are small multiples of a power of two, so every sum is exact in any order.

One declared difference is shown here: `lax.top_k` puts +0 above -0, while
the port ties them (lower cell first). No body writes -0 on the card
(`examples/select_bench.py:neg_zero`), so it is reached only through
hand-made partials. The kernel is held against `merge_select_reference` on
the card in `test_torch_cuda_select_radix.py`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_helpers import np_of
from vod_tpu.ops.mips_pallas import fused_mips_binned as jax_binned
from vod_tpu_torch.examples import select_bench
from vod_tpu_torch.ops import mips
from vod_tpu_torch.ops.mips import _INT32_MIN, fused_mips_binned, merge_select_reference


def _bits(x) -> np.ndarray:
    x = np.ascontiguousarray(np_of(x))
    return x.view(np.int32) if x.dtype == np.float32 else x


def _jax_select(part_s: np.ndarray, part_i: np.ndarray, k: int, int8: bool):
    """The partials folded in numpy (strict `>`, increasing split), then
    `lax.top_k` and the id mapping of `vod_tpu/ops/mips_pallas.py:286-290`."""
    cell_s, cell_i = part_s[0], part_i[0]
    for z in range(1, part_s.shape[0]):
        better = part_s[z] > cell_s
        cell_s, cell_i = np.where(better, part_s[z], cell_s), np.where(better, part_i[z], cell_i)
    top_s, pos = jax.lax.top_k(jnp.asarray(cell_s), k)
    top_i = jnp.take_along_axis(jnp.asarray(cell_i), pos, axis=-1)
    valid = top_s > _INT32_MIN if int8 else jnp.isfinite(top_s)
    return np.asarray(top_s), np.asarray(jnp.where(valid, top_i, -1))


def _edge_partials(kind: str, splits: int, b: int, bins: int, seed: int):
    """[splits, B, bins] partials of one edge case; ids of split z above
    split z - 1's, id -1 at empty cells."""
    rng = np.random.default_rng(seed)
    shape = (splits, b, bins)
    ids = np.arange(splits * b * bins, dtype=np.int32).reshape(shape)
    empty = np.zeros(shape, dtype=bool)
    if kind == "int8-straddle":  # [-2, 2]: the k-th place sits inside a run of equal cells
        s = rng.integers(-2, 3, size=shape).astype(np.int32)
    elif kind == "split-straddle":  # equal scores in different splits and cells
        s = (rng.integers(0, 3, size=shape) * 0.5).astype(np.float32)
    elif kind == "all-equal":
        s = np.full(shape, 0.75, dtype=np.float32)
    elif kind == "clustered":  # one exponent, a few mantissa bits: the top bits all alike
        s = (0.5 + rng.integers(0, 64, size=shape) * 2.0**-20).astype(np.float32)
    elif kind == "nan":  # NaN in split 0 stays, in a later split never wins
        s = (rng.integers(-3, 4, size=shape) * 0.5).astype(np.float32)
        s[rng.random(shape) < 0.1] = np.nan
    elif kind == "few-live-float":  # 5 live cells a query (none at 1 bin), the rest -inf
        s = (rng.integers(-3, 4, size=shape) * 0.5).astype(np.float32)
        empty = np.ones(shape, dtype=bool)
        for q in range(b):
            empty[:, q, rng.choice(bins, size=min(5, bins // 2), replace=False)] = False
        s = np.where(empty, np.float32(-np.inf), s)
    else:  # "few-live-int8": 5 live cells a query, the rest the sentinel
        s = rng.integers(-2, 3, size=shape).astype(np.int32)
        empty = np.ones(shape, dtype=bool)
        for q in range(b):
            empty[:, q, rng.choice(bins, size=min(5, bins // 2), replace=False)] = False
        s = np.where(empty, np.int32(_INT32_MIN), s)
    return s, np.where(empty, np.int32(-1), ids)


@pytest.mark.parametrize(
    "kind", ["int8-straddle", "split-straddle", "all-equal", "clustered", "nan", "few-live-float", "few-live-int8"]
)
@pytest.mark.parametrize(
    "splits,b,bins,k",
    [(33, 4, 512, 100), (3, 4, 512, 512), (5, 2, 640, 639), (2, 3, 1, 1), (4, 2, 4096, 160)],
    ids=["phase10-k100", "phase10-kall", "bins640-k639", "bins1", "bins4096-k160"],
)
def test_merge_select_reference_at_edges_matches_jax(kind: str, splits: int, b: int, bins: int, k: int) -> None:
    part_s, part_i = _edge_partials(kind, splits, b, bins, seed=splits + bins + k)
    int8 = part_s.dtype == np.int32
    js, ji = _jax_select(part_s, part_i, k, int8)
    ts, ti = merge_select_reference(torch.from_numpy(part_s), torch.from_numpy(part_i), k, int8)
    assert np.array_equal(np_of(ti), ji)
    assert np.array_equal(_bits(ts), _bits(js))


def _one_hot_call(scores: np.ndarray, b: int, dtype: str):
    """A corpus whose row j scores `scores[j]` against every one of B one-hot
    queries (float: the score in column 0; int8: the score in column 0 of
    int8 rows), so the products, hence the cells, are exact."""
    n = int(scores.shape[0])
    if dtype == "int8":
        v = np.zeros((n, 16), dtype=np.int8)
        v[:, 0] = scores
        q = np.zeros((b, 16), dtype=np.int8)
        q[:, 0] = 1
    else:
        v = np.zeros((n, 16), dtype=np.float32)
        v[:, 0] = scores
        v[:, 1] = np.arange(n) % 3  # a second product that the one-hot query zeroes
        q = np.zeros((b, 16), dtype=np.float32)
        q[:, 0] = 1.0
    return v, q


@pytest.mark.parametrize(
    "case,dtype,b,n,bins,k,n_real",
    [("straddle", "int8", 4, 2048, 512, 100, 2048), ("straddle", "float32", 32, 2048, 512, 100, 2000),
     ("clustered", "float32", 4, 4096, 512, 100, 4096), ("few-live", "float32", 4, 2048, 512, 100, 40),
     ("few-live", "int8", 4, 2048, 512, 100, 7), ("kall", "float32", 4, 2048, 512, 512, 2048),
     ("kall", "int8", 4, 1024, 512, 512, 1000)],
    ids=["straddle-int8", "straddle-f32", "clustered-f32", "few-live-f32", "few-live-int8", "kall-phase10-f32",
         "kall-phase10-int8"],
)
def test_binned_at_edges_matches_jax(case: str, dtype: str, b: int, n: int, bins: int, k: int, n_real: int) -> None:
    """`fused_mips_binned`'s CPU path against the Pallas kernel in interpret
    mode on corpora built so that the cells tie, cluster or run out."""
    rng = np.random.default_rng(n + bins + k + n_real)
    if case == "straddle" or case == "kall":
        scores = rng.integers(-2, 3, size=n)
    elif case == "clustered":
        scores = 0.5 + rng.integers(0, 64, size=n) * 2.0**-20
    else:
        scores = rng.integers(-3, 4, size=n)
    v, q = _one_hot_call(scores, b, dtype)
    kw = dict(k=k, bins=bins, tile=1024, n_real=n_real)
    js, ji = jax_binned(jnp.asarray(v), jnp.asarray(q), qblock=b, interpret=True, **kw)
    ts, ti = fused_mips_binned(torch.from_numpy(v), torch.from_numpy(q), **kw)
    assert np.array_equal(np_of(ti), np_of(ji))
    assert np.array_equal(_bits(ts), _bits(js))
    if n_real < k:  # the slots past the live rows are empty
        assert (np_of(ti)[:, n_real:] == -1).all()


def test_negative_zero_order_is_a_declared_difference() -> None:
    """Cells -0 (cell 0), +0 (cell 1) and +0 (cell 3) beside 1 and -1:
    `lax.top_k` orders +0 above -0; the port ties them, lower cell first.
    Every other slot, and the set of cells, agrees."""
    cells = np.array([[-0.0, 0.0, 1.0, 0.0, -1.0]], dtype=np.float32)
    part_s = cells[None]
    part_i = np.arange(5, dtype=np.int32).reshape(1, 1, 5)
    js, ji = _jax_select(part_s, part_i, 5, False)
    ts, ti = merge_select_reference(torch.from_numpy(part_s), torch.from_numpy(part_i), 5, False)
    assert ji.tolist() == [[2, 1, 3, 0, 4]]
    assert np_of(ti).tolist() == [[2, 0, 1, 3, 4]]
    assert np.signbit(js[0, 3]) and np.signbit(np_of(ts)[0, 1])
    assert sorted(ji[0].tolist()) == sorted(np_of(ti)[0].tolist())
    assert np.array_equal(_bits(ts)[0, [0, 4]], _bits(js)[0, [0, 4]])


def test_select_bench_runs_on_the_cpu() -> None:
    """The select bench at a rehearsal size: every kind holds against the
    plain version and gives a wall time and a bound; no device number is
    made on the CPU; the -0 probe runs on the plain path."""
    rows = select_bench.run(torch.device("cpu"), shapes=(("tiny", 3, 2, 64, 10),), reps=2)
    assert [r["kind"] for r in rows] == list(select_bench.KINDS)
    for r in rows:
        assert np.isfinite(r["wall_ms"]) and r["bound_ms"] > 0
        assert "device_ms" not in r and "topk_ms" not in r
    probe = select_bench.neg_zero(torch.device("cpu"), rows=1024, d=16, b=2, bins=128, k=4)
    assert all(p["cells"] == 8 and p["neg_zero"] == 0 for p in probe.values())
