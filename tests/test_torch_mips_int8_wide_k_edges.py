"""Both MIPS wrappers' CPU paths at the calls that the card sends to the int8
body off the tensor-core rule and to the exact kernel's widest lists, against
the JAX Pallas kernels in interpret mode.

On the card an int8 call with D % 16 != 0, or rows off the 16-byte grid, runs
`binned_int8_kernel` on `mma.sync` (it takes any D and any byte offset), and
an exact call at k = 128 merges its candidates into lists of 128 in batches.
Here the port's plain versions (what the CPU runs, and what the card holds
the kernels to) must equal JAX on those calls: int8 cells bit for bit at D =
33 and 36 on views 1 and 3 bytes off, with 64 and 192 bins; exact k = 128 on
rows whose scores rise with the row id (every row enters the list), fall
with it, or tie across tiles, where scores are exact in any sum order. The
cases add what `test_torch_mips.py`, `test_torch_topk.py` and
`test_torch_mips_fma_edges.py` lack. The CUDA kernels are held to the plain
versions on the card in `test_torch_cuda_int8_wide_k.py`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_helpers import np_of
from vod_tpu.ops.mips_pallas import fused_mips_binned as jax_binned
from vod_tpu.ops.mips_pallas import fused_mips_topk as jax_topk
from vod_tpu_torch.examples import wide_k_bench
from vod_tpu_torch.ops.mips import _binned_body, _topk_body, fused_mips_binned, fused_mips_topk

N = 1536  # a multiple of the tiles below (768 binned, 512 exact)
B = 16


def _int8_view(x: np.ndarray, offset: int) -> torch.Tensor:
    """The int8 rows x, `offset` bytes into a fresh buffer."""
    view = torch.zeros(x.size + offset, dtype=torch.int8)[offset:].view(x.shape)
    view.copy_(torch.from_numpy(x))
    return view


@pytest.mark.parametrize("n_real", [N, N - 77])
@pytest.mark.parametrize("bins", [64, 192])
@pytest.mark.parametrize("offset", [1, 3])
@pytest.mark.parametrize("d", [33, 36])
def test_int8_off_the_grid_matches_jax(d: int, offset: int, bins: int, n_real: int) -> None:
    """Every cell (k = bins) of an int8 call the card gives to the `mma.sync`
    body: ids and int32 scores equal JAX's."""
    rng = np.random.default_rng(d + 10 * offset + bins + n_real)
    v = rng.integers(-127, 128, size=(N, d)).astype(np.int8)
    q = rng.integers(-127, 128, size=(B, d)).astype(np.int8)
    tv = _int8_view(v, offset)
    assert tv.storage_offset() == offset
    assert _binned_body(torch.int8, d, bins, (tv.data_ptr(), torch.from_numpy(q).data_ptr())) == "fma"
    kw = dict(k=bins, tile=768, bins=bins)
    js, ji = jax_binned(jnp.asarray(v), jnp.asarray(q), qblock=B, n_real=n_real, interpret=True, **kw)
    ts, ti = fused_mips_binned(tv, torch.from_numpy(q), n_real=n_real, **kw)
    assert np.array_equal(np_of(ti), np_of(ji))
    assert np.array_equal(np_of(ts), np_of(js))
    assert np_of(ti).max() < n_real


def _ordered(rising: bool, d: int = 16) -> tuple[np.ndarray, np.ndarray]:
    """Row j is (j // 64, j % 64, 0, ...) and the queries s (1, 1/64, 0, ...)
    for s in (1, 2, 3, ...) (falling: -s), so row j scores s j / 64, exact in
    bf16 inputs and in any f32 sum order."""
    j = np.arange(N)
    v = np.zeros((N, d), dtype=np.float32)
    v[:, 0], v[:, 1] = j // 64, j % 64
    scale = np.arange(1, B + 1, dtype=np.float32) * (1 if rising else -1)
    q = np.zeros((B, d), dtype=np.float32)
    q[:, 0], q[:, 1] = scale, scale / 64
    return v, q


def _tied(d: int = 16) -> tuple[np.ndarray, np.ndarray]:
    """Integer rows in [-2, 2] and one-hot queries: scores in {-2, ..., 2},
    so every row ties with hundreds of others, within and across tiles."""
    rng = np.random.default_rng(5)
    v = rng.integers(-2, 3, size=(N, d)).astype(np.float32)
    q = np.zeros((B, d), dtype=np.float32)
    q[np.arange(B), np.arange(B) % d] = 1.0
    return v, q


@pytest.mark.parametrize("n_real", [N, N - 77])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["rising", "falling", "tied"])
def test_exact_k128_matches_jax(case: str, dtype: str, n_real: int) -> None:
    """k = 128: the plain version equals JAX bit for bit where every row
    enters the list (rising), where only the first rows do (falling), and
    where the 128th place falls inside a run of equal scores (tied: the
    lowest ids win)."""
    v, q = _tied() if case == "tied" else _ordered(case == "rising")
    jv = jnp.asarray(v) if dtype == "float32" else jnp.asarray(v).astype(jnp.bfloat16)
    tv = torch.from_numpy(v).to(getattr(torch, dtype))
    if dtype == "bfloat16":
        assert _topk_body(tv.dtype, 16, (tv.data_ptr(), torch.from_numpy(q).to(tv.dtype).data_ptr())) == "wgmma"
    js, ji = jax_topk(jv, jnp.asarray(q), k=128, tile=512, qblock=B, n_real=n_real, interpret=True)
    ts, ti = fused_mips_topk(tv, torch.from_numpy(q), k=128, tile=512, qblock=B, n_real=n_real)
    assert np.array_equal(np_of(ti), np_of(ji))
    assert np.array_equal(np_of(ts), np_of(js))
    if case == "rising":  # query 0 scores row j as j / 64: the last real rows, highest first
        assert np_of(ti)[0].tolist() == list(range(n_real - 1, n_real - 129, -1))
    if case == "falling":
        assert np_of(ti)[0].tolist() == list(range(128))


def test_wide_k_bench_runs_on_the_cpu() -> None:
    """The bench at a rehearsal size: every case checked against the plain
    version (which the CPU path is, so exactly), the body its rule names, no
    launch, and no device number on the CPU."""
    rows = wide_k_bench.run(torch.device("cpu"), n=4096, d=48, reps=1, wide_reps=1)
    assert [r["label"] for r in rows] == [c[0] for c in wide_k_bench.CASES]
    for r, case in zip(rows, wide_k_bench.CASES):
        assert r["body"] == case[-1] and r["launches"] == 0
        assert r["max_abs_err"] == 0.0 and r["swaps"] == 0
        assert np.isfinite(r["ms"]) and np.isfinite(r["plain_ms"]) and r["bound_ms"] > 0
        assert "library_ms" not in r and "device" not in r and "stages" not in r


def test_wide_k_bench_defaults_to_the_card() -> None:
    """Its `--device` defaults to cuda, and asking for the card where there is
    none fails rather than falling back to the CPU."""
    assert wide_k_bench.parser().parse_args([]).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="needs a CUDA card"):
            wide_k_bench.main([])
