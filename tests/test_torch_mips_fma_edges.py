"""Both MIPS wrappers' CPU paths at the calls that the card sends to the
CUDA-core ("fma") bodies, against the JAX Pallas kernels in interpret mode.

On the card every f32 call, and every bf16 call off the tensor cores' rule
(D % 8 != 0, a view off the 16-byte grid), runs on the product core of
`csrc/sm90.cuh`; its hard cases are rows at any alignment and length, a
ragged `n_real`, and equal rows in different splits. Here the port's plain
versions (what the CPU runs, and what the card holds the kernels to) must
equal JAX on those calls: ids equal, scores within twice the f32 sum-order
bound of unit rows (the two sum in different orders). The cases add what
`test_torch_topk.py` and `test_torch_mips.py` lack: D = 36 and 100, bf16
views at storage offsets 1 and 3 (JAX gets the same values), `n_real` = N -
77, bins off the tensor cores' 128-bin tile, and equal rows folded across the
plain version's chunks (its splits). The CUDA kernels are held to the plain
versions on the card in `test_torch_cuda_fma.py`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_helpers import np_of
from vod_tpu.ops.mips_pallas import fused_mips_binned as jax_binned
from vod_tpu.ops.mips_pallas import fused_mips_topk as jax_topk
from vod_tpu_torch.examples import fma_bench
from vod_tpu_torch.ops import mips
from vod_tpu_torch.ops.mips import _binned_body, _topk_body, fused_mips_binned, fused_mips_topk

N = 1536  # a multiple of the tiles below (512 for the exact kernel, 768 binned)
B = 16

# (id, dtype, D, storage offset of the port's corpus, n_real or -1)
REGIMES = [
    ("f32-d36", "float32", 36, 0, -1),
    ("f32-d100-ragged", "float32", 100, 0, N - 77),
    ("bf16-d36", "bfloat16", 36, 0, -1),
    ("bf16-view-off-grid", "bfloat16", 64, 1, -1),
    ("bf16-d36-offset3-ragged", "bfloat16", 36, 3, N - 77),
]


def _unit(rng, n: int, d: int) -> np.ndarray:
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _corpus(v: np.ndarray, dtype: str, offset: int) -> tuple[torch.Tensor, jnp.ndarray]:
    """The port's corpus (`offset` elements into a fresh buffer) and JAX's,
    holding the same values."""
    tv = torch.from_numpy(v).to(getattr(torch, dtype))
    view = torch.zeros(tv.numel() + offset, dtype=tv.dtype)[offset:].view(tv.shape)
    view.copy_(tv)
    jv = jnp.asarray(v) if dtype == "float32" else jnp.asarray(v).astype(jnp.bfloat16)
    return view, jv


def _tol(d: int) -> float:
    return 2 * d * 2.0**-24 * 1.01  # twice gamma_D |q| |v| for unit rows (bf16 moves a norm by < 0.5%)


@pytest.mark.parametrize("k", [1, 10, 128])
@pytest.mark.parametrize("regime, dtype, d, offset, n_real", REGIMES, ids=[r[0] for r in REGIMES])
def test_topk_fma_regimes_match_jax(regime: str, dtype: str, d: int, offset: int, n_real: int, k: int) -> None:
    rng = np.random.default_rng(d + offset + k)
    v, q = _unit(rng, N, d), _unit(rng, B, d)
    tv, jv = _corpus(v, dtype, offset)
    assert tv.storage_offset() == offset
    assert _topk_body(tv.dtype, d, (tv.data_ptr(), torch.from_numpy(q).to(tv.dtype).data_ptr())) == "fma"
    # JAX gets n_real = N for -1: under its jit an explicit -1 is traced and masks every row
    js, ji = jax_topk(jv, jnp.asarray(q), k=k, tile=512, qblock=B, n_real=n_real % (N + 1), interpret=True)
    ts, ti = fused_mips_topk(tv, torch.from_numpy(q), k=k, tile=512, qblock=B, n_real=n_real)
    js, ji, ts, ti = np_of(js), np_of(ji), np_of(ts), np_of(ti)
    assert np.array_equal(ji, ti)
    np.testing.assert_allclose(ts, js, atol=_tol(d), rtol=0)
    assert ti.max() < (N if n_real < 0 else n_real)


@pytest.mark.parametrize("bins", [64, 192])
@pytest.mark.parametrize("regime, dtype, d, offset, n_real", REGIMES, ids=[r[0] for r in REGIMES])
def test_binned_fma_regimes_match_jax(regime: str, dtype: str, d: int, offset: int, n_real: int, bins: int) -> None:
    rng = np.random.default_rng(d + offset + bins)
    v, q = _unit(rng, N, d), _unit(rng, B, d)
    tv, jv = _corpus(v, dtype, offset)
    assert _binned_body(tv.dtype, d, bins, (tv.data_ptr(), torch.from_numpy(q).to(tv.dtype).data_ptr())) == "fma"
    kw = dict(k=bins, tile=768, bins=bins)  # every cell
    js, ji = jax_binned(jv, jnp.asarray(q), qblock=B, n_real=n_real % (N + 1), interpret=True, **kw)
    ts, ti = fused_mips_binned(tv, torch.from_numpy(q), n_real=n_real, **kw)
    js, ji, ts, ti = np_of(js), np_of(ji), np_of(ts), np_of(ti)
    assert np.array_equal(ji, ti)
    np.testing.assert_allclose(ts, js, atol=_tol(d), rtol=0)


@pytest.mark.parametrize("dtype, offset", [("float32", 0), ("bfloat16", 1)])
def test_fma_ties_across_splits_match_jax(monkeypatch, dtype: str, offset: int) -> None:
    """Rows 5, 5 + 64 * 9 and 5 + 64 * 20 are equal and win for query 0: the
    lowest id first (exact) and the lowest row of bin 5 (binned, 64 bins), in
    JAX and in the plain versions, whose chunks here hold 256 or 128 rows, so
    that the equal rows are folded in different chunks, as the card folds them
    in different splits."""
    d = 36
    rng = np.random.default_rng(11)
    v, q = _unit(rng, N, d), _unit(rng, B, d)
    dups = (5, 5 + 64 * 9, 5 + 64 * 20)
    v[list(dups[1:])] = v[5]
    q[0] = v[5]
    tv, jv = _corpus(v, dtype, offset)
    monkeypatch.setattr(mips, "_REF_CHUNK_ELEMS", 256 * B)
    js, ji = jax_topk(jv, jnp.asarray(q), k=8, tile=512, qblock=B, interpret=True)
    ts, ti = fused_mips_topk(tv, torch.from_numpy(q), k=8, tile=512, qblock=B)
    assert np_of(ji)[0, :3].tolist() == list(dups) == np_of(ti)[0, :3].tolist()
    assert np.array_equal(np_of(ji), np_of(ti))
    np.testing.assert_allclose(np_of(ts), np_of(js), atol=_tol(d), rtol=0)
    monkeypatch.setattr(mips, "_REF_CHUNK_ELEMS", 128 * B)
    js, ji = jax_binned(jv, jnp.asarray(q), k=64, tile=768, bins=64, qblock=B, interpret=True)
    ts, ti = fused_mips_binned(tv, torch.from_numpy(q), k=64, tile=768, bins=64)
    assert np_of(ti)[0, 0] == 5 == np_of(ji)[0, 0]
    assert np.array_equal(np_of(ji), np_of(ti))
    np.testing.assert_allclose(np_of(ts), np_of(js), atol=_tol(d), rtol=0)


def test_fma_bench_runs_on_the_cpu() -> None:
    """The bench at a rehearsal size: every case checked against the plain
    version (which the CPU path is, so exactly), the body its rule names, no
    launch and no device number on the CPU."""
    rows = fma_bench.run(torch.device("cpu"), n=4096, d=48, reps=1, wide_reps=1)
    assert [r["label"] for r in rows] == [c[0] for c in fma_bench.CASES]
    for r, case in zip(rows, fma_bench.CASES):
        assert r["body"] == case[-1] and r["launches"] == 0
        assert r["max_abs_err"] == 0.0 and r["swaps"] == 0
        assert np.isfinite(r["ms"]) and np.isfinite(r["plain_ms"]) and "library_ms" not in r
        assert 0 < r["bound_ms"] <= r["cuda_core_bound_ms"]


def test_fma_bench_defaults_to_the_card() -> None:
    """Its `--device` defaults to cuda, and asking for the card where there is
    none fails rather than falling back to the CPU."""
    assert fma_bench.parser().parse_args([]).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="needs a CUDA card"):
            fma_bench.main(["--device", "cuda"])
