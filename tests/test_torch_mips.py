"""`fused_mips_binned` in the port against the JAX Pallas kernel (interpret mode).

On the CPU the port's wrapper runs its plain version, which must compute the
same function as the TPU kernel: f32 ids exact and scores within 1e-5 (the two
sum a 64-term dot product in different orders, ~1e-6 apart at these
magnitudes), int8 ids and scores exact (integer sums). The CUDA kernel is
held against the plain version on the card in `test_torch_cuda.py`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_helpers import np_of
from vod_tpu.ops.mips_pallas import fused_mips_binned as jax_binned
from vod_tpu_torch.ops import cuda_build
from vod_tpu_torch.ops.mips import _binned_body, fused_mips_binned

F32_ATOL = 1e-5


def _both(v: np.ndarray, q: np.ndarray, **kw):
    js, ji = jax_binned(jnp.asarray(v), jnp.asarray(q), qblock=8, interpret=True, **kw)
    ts, ti = fused_mips_binned(torch.from_numpy(v), torch.from_numpy(q), **kw)
    return np_of(js), np_of(ji), np_of(ts), np_of(ti)


def _data(seed: int, n: int = 1024, d: int = 64, b: int = 16):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, d)).astype("float32"), rng.normal(size=(b, d)).astype("float32")


@pytest.mark.parametrize(
    "kw",
    [
        dict(k=7, tile=256, bins=256),
        dict(k=7, tile=1024, bins=512),
        dict(k=40, tile=1024, bins=1024),
        dict(k=7, tile=256, bins=128),
    ],
    ids=["tile256-bins256", "tile1024-bins512", "bins1024-k40", "tile256-bins128"],
)
def test_binned_f32_matches_jax(kw) -> None:
    v, q = _data(2)
    js, ji, ts, ti = _both(v, q, **kw)
    assert np.array_equal(ji, ti)
    np.testing.assert_allclose(ts, js, atol=F32_ATOL, rtol=0)


def test_binned_int8_matches_jax_exactly() -> None:
    rng = np.random.default_rng(3)
    v = rng.integers(-127, 128, size=(1024, 64)).astype(np.int8)
    q = rng.integers(-127, 128, size=(16, 64)).astype(np.int8)
    for kw in (dict(k=7, tile=256, bins=256), dict(k=16, tile=1024, bins=512, n_real=700)):
        js, ji, ts, ti = _both(v, q, **kw)
        assert ts.dtype == np.int32
        assert np.array_equal(ji, ti) and np.array_equal(js, ts)


def test_binned_n_real_masking() -> None:
    v, q = _data(4)
    js, ji, ts, ti = _both(v, q, k=7, tile=256, bins=256, n_real=50)
    assert np.array_equal(ji, ti)
    assert ti.max() < 50
    np.testing.assert_allclose(ts, js, atol=F32_ATOL, rtol=0)
    # fewer real rows than k: empty cells are -inf with id -1 in both
    js, ji, ts, ti = _both(v, q, k=7, tile=256, bins=256, n_real=3)
    assert np.array_equal(ji, ti) and (ti[:, 3:] == -1).all()
    assert np.isneginf(ts[:, 3:]).all() and np.isneginf(js[:, 3:]).all()


def test_binned_int8_empty_cells_use_the_int32_sentinel() -> None:
    rng = np.random.default_rng(5)
    v = rng.integers(-127, 128, size=(256, 32)).astype(np.int8)
    q = rng.integers(-127, 128, size=(4, 32)).astype(np.int8)
    js, ji, ts, ti = _both(v, q, k=8, tile=256, bins=256, n_real=2)
    assert np.array_equal(ji, ti) and np.array_equal(js, ts)
    assert (ts[:, 2:] == -(2**31) + 1).all() and (ti[:, 2:] == -1).all()


def test_binned_duplicate_rows_tie_to_lowest_id() -> None:
    """Rows 5, 5+bins and 5+3*bins are equal: the cell keeps row 5, in JAX and the port."""
    v, q = _data(6, n=512, d=32, b=8)
    bins = 64
    for j in (5 + bins, 5 + 3 * bins):
        v[j] = v[5]
    q[:] = v[5] + 0.01 * q  # make the duplicated row the winner
    js, ji, ts, ti = _both(v, q, k=4, tile=512, bins=bins)
    assert np.array_equal(ji, ti)
    assert (ti[:, 0] == 5).all()
    np.testing.assert_allclose(ts, js, atol=F32_ATOL, rtol=0)


def test_binned_bins_clamped_to_tile() -> None:
    """bins > tile: the effective bin count is the tile, as on the TPU."""
    v, q = _data(7, n=512)
    js, ji, ts, ti = _both(v, q, k=10, tile=128, bins=1024)
    assert np.array_equal(ji, ti)
    np.testing.assert_allclose(ts, js, atol=F32_ATOL, rtol=0)
    with pytest.raises(ValueError, match="effective bins"):
        fused_mips_binned(torch.from_numpy(v), torch.from_numpy(q), k=200, tile=128, bins=1024)


def test_binned_bf16_corpus_casts_queries() -> None:
    """A bf16 corpus casts f32 queries to bf16 and sums in f32, as JAX does."""
    v, q = _data(8, n=1024, d=64, b=8)
    vb = jnp.asarray(v).astype(jnp.bfloat16)
    js, ji = jax_binned(vb, jnp.asarray(q), k=10, bins=256, qblock=8, interpret=True)
    ts, ti = fused_mips_binned(torch.from_numpy(v).to(torch.bfloat16), torch.from_numpy(q), k=10, bins=256)
    assert np.array_equal(np_of(ji), np_of(ti))
    np.testing.assert_allclose(np_of(ts), np_of(js), atol=F32_ATOL, rtol=0)


def test_binned_wrapper_rejects_bad_calls() -> None:
    v, q = _data(9, n=256, d=16, b=2)
    tv, tq = torch.from_numpy(v), torch.from_numpy(q)
    with pytest.raises(TypeError, match="int8"):
        fused_mips_binned(tv.to(torch.int8), tq, k=4, bins=64)
    with pytest.raises(TypeError):
        fused_mips_binned(tv.double(), tq.double(), k=4, bins=64)
    with pytest.raises(ValueError, match="contiguous"):
        fused_mips_binned(tv, torch.from_numpy(np.asfortranarray(q)), k=4, bins=64)
    with pytest.raises(ValueError, match="tile"):
        fused_mips_binned(tv[:200].contiguous(), tq, k=4, bins=64, tile=128)
    with pytest.raises(ValueError, match="n_real"):
        fused_mips_binned(tv, tq, k=4, bins=64, n_real=300)


def test_binned_cpu_path_never_counts_a_launch() -> None:
    v, q = _data(10, n=256, d=16, b=2)
    before = fused_mips_binned.launches
    fused_mips_binned(torch.from_numpy(v), torch.from_numpy(q), k=4, bins=64)
    assert fused_mips_binned.launches == before



@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_binned_cpu_path_never_counts_a_body_launch(dtype: torch.dtype) -> None:
    v, q = _data(10, n=256, d=16, b=2)
    tv, tq = torch.from_numpy(v), torch.from_numpy(q)
    if dtype == torch.int8:
        tv, tq = (t.clamp(-1, 1).mul(100).to(torch.int8) for t in (tv, tq))
    before = fused_mips_binned.launches, dict(fused_mips_binned.body_launches)
    fused_mips_binned(tv.to(dtype), tq, k=4, bins=128)
    assert (fused_mips_binned.launches, fused_mips_binned.body_launches) == before


def _rows(dtype: torch.dtype, n: int, d: int, offset: int = 0) -> torch.Tensor:
    """[n, d] rows of `dtype` starting `offset` elements into a fresh buffer."""
    return torch.zeros(n * d + offset, dtype=dtype)[offset:].view(n, d)


@pytest.mark.parametrize(
    "dtype, d, bins, v_offset, q_offset, body",
    [
        (torch.bfloat16, 768, 1024, 0, 0, "wgmma"),  # the flat serving index
        (torch.bfloat16, 64, 128, 0, 0, "wgmma"),  # one bin tile
        (torch.bfloat16, 64, 512, 0, 0, "wgmma"),
        (torch.bfloat16, 96, 1024, 0, 0, "wgmma"),  # a ragged second box of K
        (torch.bfloat16, 1536, 512, 0, 0, "wgmma"),  # the widest query tile that fits
        (torch.bfloat16, 1544, 512, 0, 0, "fma"),  # ... and one box more
        (torch.bfloat16, 36, 512, 0, 0, "fma"),  # D % 8 != 0: rows are not 16-byte strided
        (torch.bfloat16, 64, 64, 0, 0, "fma"),  # bins % 128 != 0
        (torch.bfloat16, 64, 384, 0, 0, "wgmma"),
        (torch.bfloat16, 64, 192, 0, 0, "fma"),
        (torch.float32, 96, 512, 0, 0, "fma"),  # wgmma has no full-f32 mode
        (torch.int8, 768, 512, 0, 0, "wgmma"),  # the int8 serving index
        (torch.int8, 64, 512, 0, 0, "wgmma"),
        (torch.int8, 96, 1024, 0, 0, "wgmma"),
        (torch.int8, 3072, 512, 0, 0, "wgmma"),  # the widest int8 query tile
        (torch.int8, 3088, 512, 0, 0, "fma"),
        (torch.int8, 36, 512, 0, 0, "fma"),  # D % 16 != 0 (D % 4 == 0: __dp4a)
        (torch.int8, 40, 512, 0, 0, "fma"),
        (torch.bfloat16, 64, 512, 1, 0, "fma"),  # a storage_offset off the 16-byte grid
        (torch.bfloat16, 64, 512, 8, 0, "wgmma"),  # ... and one on it
        (torch.bfloat16, 64, 512, 0, 4, "fma"),  # the queries' pointer counts too
        (torch.int8, 64, 512, 4, 0, "fma"),  # int8 rows 4 bytes off the grid
        (torch.int8, 64, 512, 16, 0, "wgmma"),
        (torch.int8, 64, 512, 0, 8, "fma"),
    ],
)
def test_binned_body_rule(dtype: torch.dtype, d: int, bins: int, v_offset: int, q_offset: int, body: str) -> None:
    """The fixed rule that names the binned kernel's body for a CUDA call."""
    v, q = _rows(dtype, 4, d, v_offset), _rows(dtype, 2, d, q_offset)
    assert v.storage_offset() == v_offset and q.storage_offset() == q_offset
    assert _binned_body(dtype, d, bins, (v.data_ptr(), q.data_ptr())) == body


def test_build_digest_follows_included_headers(tmp_path, monkeypatch) -> None:
    """An edited header that a source includes, directly or through another
    header, changes that source's build key; an unrelated header does not."""
    (tmp_path / "kern.cu").write_text('#include <cuda_runtime.h>\n#include "a.cuh"\nint x;\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// b\n")
    (tmp_path / "other.cuh").write_text("// unrelated\n")
    monkeypatch.setattr(cuda_build, "CSRC", tmp_path)
    assert [p.name for p in cuda_build.sources("kern")] == ["kern.cu", "a.cuh", "b.cuh"]
    before = cuda_build.source_digest("kern")
    (tmp_path / "other.cuh").write_text("// unrelated, edited\n")
    assert cuda_build.source_digest("kern") == before
    (tmp_path / "b.cuh").write_text("// b, edited\n")
    edited = cuda_build.source_digest("kern")
    assert edited != before
    (tmp_path / "kern.cu").write_text('#include <cuda_runtime.h>\n#include "a.cuh"\nint y;\n')
    assert cuda_build.source_digest("kern") not in (before, edited)


@pytest.mark.parametrize("name", ["fused_mips_binned", "fused_mips_topk"])
def test_both_kernels_build_on_the_sm90_header(name: str) -> None:
    assert cuda_build.sources(name) == [cuda_build.CSRC / f"{name}.cu", cuda_build.CSRC / "sm90.cuh"]
