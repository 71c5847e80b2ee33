"""The exact kernel's split merge, in its plain version, against the JAX
Pallas kernel in interpret mode.

On the card `fused_mips_topk` cuts the rows into splits, one list of k a
split, and `merge_splits_kernel` merges a query's splits x k pairs; the TPU
kernel carries one list over all the rows in order and needs no merge. Here a
seeded corpus is cut into row ranges as the launch plan cuts it (whole row
tiles a split, the last ragged or empty), each range goes through the port's
plain exact version with its ids offset, and `merge_splits_reference` (what
the card holds the kernel to, bit for bit, in `test_torch_cuda_merge_splits.py`)
merges the lists. The result must equal JAX's `fused_mips_topk` over the whole
corpus: ids equal on every finite slot, scores within twice the f32
sum-order bound of unit rows (the two sum in different orders), -inf with id
-1 on every other slot (JAX leaves a stale id there). The cases: k = 1, 10
and 128 at 1, 2, 132 and 400 splits; equal rows in different splits (ties
across splits); an `n_real` that empties the last splits; fewer finite pairs
than k.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_helpers import np_of, unit_rows
from vod_tpu.ops.mips_pallas import fused_mips_topk as jax_topk
from vod_tpu_torch.ops import mips
from vod_tpu_torch.ops.mips import exact_topk_reference, merge_splits, merge_splits_reference

N, D, B = 3200, 16, 4
ROW_TILE = 8  # rows a tile where the plan cuts the splits (the card's bodies take 64 or 128)
JAX_TILE = 640


def _tol() -> float:
    return 2 * D * 2.0**-24 * 1.01  # twice gamma_D |q| |v| for unit rows


def _split_lists(v: torch.Tensor, q: torch.Tensor, k: int, splits: int, n_real: int):
    """[splits, B, k] partial lists of rows below n_real, cut as the plan cuts
    them (`csrc/fused_mips_topk.cu:split_rows`): ceil(tiles / splits) whole
    tiles a split, the last ragged, any left over empty."""
    rows = -(-(-(-n_real // ROW_TILE)) // splits) * ROW_TILE
    part_s = torch.full((splits, B, k), float("-inf"))
    part_i = torch.full((splits, B, k), -1, dtype=torch.int32)
    for z in range(splits):
        lo, hi = z * rows, min(n_real, (z + 1) * rows)
        if hi > lo:
            s, i = exact_topk_reference(v[lo:hi], q, k, hi - lo)
            part_s[z], part_i[z] = s, torch.where(i >= 0, i + lo, -1)
    return part_s, part_i


def _assert_matches_jax(v: np.ndarray, q: np.ndarray, k: int, splits: int, n_real: int) -> np.ndarray:
    """The merged split lists against JAX's one pass; returns the port's ids."""
    part_s, part_i = _split_lists(torch.from_numpy(v), torch.from_numpy(q), k, splits, n_real)
    ts, ti = (np_of(x) for x in merge_splits_reference(part_s, part_i, k))
    js, ji = (np_of(x) for x in jax_topk(jnp.asarray(v), jnp.asarray(q), k=k, tile=JAX_TILE, qblock=B,
                                         n_real=n_real, interpret=True))
    finite = np.isfinite(ts)
    assert np.array_equal(finite, np.isfinite(js))
    assert np.array_equal(ti[finite], ji[finite])
    np.testing.assert_allclose(ts[finite], js[finite], atol=_tol(), rtol=0)
    assert (ti[~finite] == -1).all() and np.isneginf(ts[~finite]).all()
    assert ti.max() < n_real
    return ti


@pytest.mark.parametrize("splits", [1, 2, 132, 400])
@pytest.mark.parametrize("k", [1, 10, 128])
def test_merged_splits_match_jax(k: int, splits: int) -> None:
    rng = np.random.default_rng(100 * k + splits)
    _assert_matches_jax(unit_rows(rng, N, D), unit_rows(rng, B, D), k, splits, N)


@pytest.mark.parametrize("splits", [2, 132, 400])
@pytest.mark.parametrize("k", [1, 10, 128])
def test_equal_rows_in_different_splits_tie_to_the_lowest_id(k: int, splits: int) -> None:
    """Rows 5, 1,605 and 3,195 (in three splits, or two at 2 splits) equal
    query 0: they come first, in id order."""
    rng = np.random.default_rng(7 * k + splits)
    v, q = unit_rows(rng, N, D), unit_rows(rng, B, D)
    dups = [5, 1605, 3195]
    v[dups[1:]] = v[5]
    q[0] = v[5]
    ti = _assert_matches_jax(v, q, k, splits, N)
    assert ti[0, : min(k, 3)].tolist() == dups[: min(k, 3)]


@pytest.mark.parametrize("splits", [132, 400])
@pytest.mark.parametrize("k", [10, 128])
def test_n_real_empties_the_last_splits(k: int, splits: int) -> None:
    """n_real = 1,000, 125 tiles of 8 rows: at 132 splits the last 7 are
    empty, at 400 the last 275; their lists are all -inf with id -1."""
    rng = np.random.default_rng(k + splits)
    _assert_matches_jax(unit_rows(rng, N, D), unit_rows(rng, B, D), k, splits, 1000)


@pytest.mark.parametrize("splits", [2, 132, 400])
@pytest.mark.parametrize("n_real", [1, 50])
def test_fewer_finite_pairs_than_k(n_real: int, splits: int) -> None:
    """At k = 128 a query with 1 or 50 rows below n_real: its tail is -inf
    with id -1."""
    rng = np.random.default_rng(n_real + splits)
    ti = _assert_matches_jax(unit_rows(rng, N, D), unit_rows(rng, B, D), 128, splits, n_real)
    assert (ti[:, n_real:] == -1).all()


def test_cpu_wrapper_is_the_plain_version_and_never_counts_a_launch() -> None:
    g = torch.Generator().manual_seed(0)
    part_s = torch.randn((5, 3, 16), generator=g).sort(dim=-1, descending=True).values
    part_i = torch.arange(5 * 3 * 16, dtype=torch.int32).view(5, 3, 16)
    before = merge_splits.launches
    got = merge_splits(part_s, part_i, 16)
    want = merge_splits_reference(part_s, part_i, 16)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert merge_splits.launches == before


@pytest.mark.parametrize(
    "shape, k, s_dtype, i_dtype, error",
    [
        ((3, 2, 8), 8, torch.float64, torch.int32, TypeError),
        ((3, 2, 8), 8, torch.float32, torch.int64, ValueError),
        ((3, 2, 8), 4, torch.float32, torch.int32, ValueError),
        ((3, 2, 200), 200, torch.float32, torch.int32, ValueError),
        ((16, 8), 8, torch.float32, torch.int32, ValueError),
        ((0, 2, 8), 8, torch.float32, torch.int32, ValueError),
    ],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(shape, k: int, s_dtype, i_dtype, error) -> None:
    with pytest.raises(error):
        merge_splits(torch.zeros(shape, dtype=s_dtype), torch.zeros(shape, dtype=i_dtype), k)


def test_plain_version_ties_go_to_the_lower_split() -> None:
    """Every score equal: the first k pairs in split order, their ids."""
    part_s = torch.zeros((3, 1, 4))
    part_i = torch.arange(12, dtype=torch.int32).view(3, 1, 4)
    s, i = mips.merge_splits_reference(part_s, part_i, 4)
    assert i.tolist() == [[0, 1, 2, 3]] and s.tolist() == [[0.0] * 4]
