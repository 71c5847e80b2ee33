"""Card tests of the int8 body of `fused_mips_binned` off the tensor-core rule
(`binned_int8_kernel`, `mma.sync`) and of the exact kernel's tensor-core body
(`topk_wgmma_kernel`) at every k, each call held to the plain version and
checked to have launched the body its rule names.

The int8 body's cells equal the plain version's bit for bit (scores are exact
int32 sums): D from 1 to 3088, rows 0, 1, 3 and 4 bytes into their buffer,
64, 192 and 512 bins, ragged query tiles, `n_real` cutting a stride or
leaving fewer real rows than bins, equal rows in one bin across splits, and
codes of +-127 at D = 3088. The exact body's scores agree within twice the
f32 sum-order bound and its ids are equal outside that band: k from 1 to 128,
ragged query tiles, `n_real` cutting a tile, rows in ascending score order (so
that every row enters a list) and in descending order, and equal rows across
tiles and splits, which tie to the lowest ids.

They skip where there is no NVIDIA GPU. This file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_int8_wide_k.py -q -rs
"""

import pytest
import torch

from tests.torch_helpers import cuda_device  # noqa: F401  (fixture)
from vod_tpu_torch.examples.fma_bench import compare
from vod_tpu_torch.ops.mips import (
    _binned_body,
    _topk_body,
    fused_mips_binned,
    fused_mips_binned_reference,
    fused_mips_topk,
    fused_mips_topk_reference,
)

pytestmark = pytest.mark.cuda

OFFSETS = (0, 1, 3, 4)
DIMS = (1, 4, 33, 36, 100, 768, 3088)
BATCHES = (1, 3, 64, 65, 130)
N_BINNED = 12288  # a multiple of each bin count's tile (1024, 3072)
KS = (1, 10, 32, 64, 100, 128)
N_EXACT = 1 << 16  # 512 row tiles: several tiles a split at every B here


def _int8_fma(offset: int, d: int, bins: int) -> bool:
    """Whether the binned kernel's rule sends int8 rows of this layout to the
    fma body (off the 16-byte grid, D % 16 != 0, D > 3072 or bins % 128 != 0)."""
    return not (offset % 16 == 0 and d % 16 == 0 and d <= 3072 and bins % 128 == 0)


def _placed(x: torch.Tensor, offset: int) -> torch.Tensor:
    """A copy of the int8 rows x, `offset` bytes into a fresh buffer."""
    n, d = x.shape
    out = torch.empty(n * d + offset, dtype=torch.int8, device=x.device)[offset:].view(n, d)
    out.copy_(x)
    return out


def _codes(dev, n: int, d: int, g, offset: int = 0) -> torch.Tensor:
    """[n, d] seeded int8 codes in [-127, 127], `offset` bytes into a fresh buffer."""
    return _placed(torch.randint(-127, 128, (n, d), generator=g, device=dev, dtype=torch.int32).to(torch.int8), offset)


def _tile(bins: int) -> int:
    return 1024 if 1024 % bins == 0 else 16 * bins  # N % tile == 0 and tile % bins == 0


def _binned_call(v, q, bins: int, n_real: int) -> tuple:
    assert _binned_body(v.dtype, v.shape[1], bins, (v.data_ptr(), q.data_ptr())) == "fma"
    before = fused_mips_binned.body_launches["fma"]
    out = fused_mips_binned(v, q, k=bins, bins=bins, tile=_tile(bins), n_real=n_real)  # every cell
    assert fused_mips_binned.body_launches["fma"] == before + 1
    return out


def _assert_cells(v, q, bins: int, n_real: int) -> None:
    ks, ki = _binned_call(v, q, bins, n_real)
    rs, ri = fused_mips_binned_reference(v, q, k=bins, bins=bins, tile=_tile(bins), n_real=n_real)
    assert torch.equal(ks, rs) and torch.equal(ki, ri)
    assert ki.max().item() < n_real
    if n_real < bins:
        assert (ki[:, n_real:] == -1).all() and (ks[:, n_real:] == -(2**31) + 1).all()


@pytest.mark.parametrize(
    "offset, d, bins",
    [(off, d, bins) for off in OFFSETS for d in DIMS for bins in (64, 192, 512)
     if _int8_fma(off, d, bins) and (bins != 512 or off != 0)],
)
def test_int8_body_matches_plain(cuda_device, offset: int, d: int, bins: int) -> None:
    """Every cell of the int8 body equals the plain version's, at every B and
    n_real; cells with no real row hold the sentinel and id -1."""
    g = torch.Generator(device=cuda_device).manual_seed(d + 10 * offset + bins)
    v = _codes(cuda_device, N_BINNED, d, g, offset)
    q = _codes(cuda_device, max(BATCHES), d, g)
    for b in BATCHES:
        for n_real in (N_BINNED, N_BINNED - 77, 3):
            _assert_cells(v, q[:b], bins, n_real)
    torch.cuda.synchronize()


@pytest.mark.parametrize("offset, bins", [(0, 64), (1, 64), (3, 192), (1, 512), (4, 512)])
@pytest.mark.parametrize("b", (64, 130))
def test_int8_body_ties_equal_rows_to_the_lowest_id(cuda_device, offset: int, bins: int, b: int) -> None:
    """Equal rows in one bin at strides in different splits: the lowest id
    wins the cell."""
    d = 36
    g = torch.Generator(device=cuda_device).manual_seed(11)
    v = _codes(cuda_device, N_BINNED, d, g, offset)
    dups = (5, 5 + bins * 3, 5 + bins * 20)
    v[list(dups[1:])] = v[5].clone()
    q = _codes(cuda_device, b, d, g)
    q[0] = v[5]
    ks, ki = _binned_call(v, q, bins, N_BINNED)
    rs, ri = fused_mips_binned_reference(v, q, k=bins, bins=bins, tile=_tile(bins))
    assert torch.equal(ks, rs) and torch.equal(ki, ri)
    assert ki[0, 0].item() == 5


@pytest.mark.parametrize("offset", (0, 1))
def test_int8_body_sums_exactly_at_full_codes(cuda_device, offset: int) -> None:
    """Codes of +-127 at D = 3088: sums up to 127 * 127 * 3088 (about 5e7)
    stay exact int32, equal to the plain version's float64 sums."""
    d = 3088
    g = torch.Generator(device=cuda_device).manual_seed(13)
    def signs(n: int) -> torch.Tensor:
        return torch.where(torch.rand((n, d), generator=g, device=cuda_device) < 0.5, -127, 127).to(torch.int8)

    v = _placed(signs(N_BINNED), offset)
    q = signs(65)
    q[0] = v[9]  # the largest sum: 127 * 127 * 3088
    ks, ki = _binned_call(v, q, 64, N_BINNED)
    rs, ri = fused_mips_binned_reference(v, q, k=64, bins=64)
    assert torch.equal(ks, rs) and torch.equal(ki, ri)
    assert ks[0, 0].item() == 127 * 127 * d and ki[0, 0].item() == 9


def test_int8_body_at_d33_one_byte_off_the_grid(cuda_device) -> None:
    """The call the port refused before this body (D % 4 != 0, rows 1 byte
    off the grid) returns the plain version's cells."""
    g = torch.Generator(device=cuda_device).manual_seed(17)
    v = _codes(cuda_device, N_BINNED, 33, g, 1)
    q = _codes(cuda_device, 64, 33, g)
    ks, ki = _binned_call(v, q, 512, N_BINNED)
    rs, ri = fused_mips_binned_reference(v, q, k=512, bins=512)
    assert torch.equal(ks, rs) and torch.equal(ki, ri)


# ---- the exact kernel's tensor-core body ------------------------------------


def _unit_rows(dev, n: int, d: int, g) -> torch.Tensor:
    x = torch.randn((n, d), generator=g, device=dev)
    return (x / x.norm(dim=-1, keepdim=True)).to(torch.bfloat16)


def _exact_call(v, q, k: int, n_real: int) -> tuple:
    assert _topk_body(v.dtype, v.shape[1], (v.data_ptr(), q.to(v.dtype).data_ptr())) == "wgmma"
    before = fused_mips_topk.body_launches["wgmma"]
    out = fused_mips_topk(v, q, k=k, n_real=n_real)
    assert fused_mips_topk.body_launches["wgmma"] == before + 1
    return out


def _tol(d: int) -> float:
    return 2 * d * 2.0**-24 * 1.01  # twice gamma_D |q| |v|; bf16 rounding moves a unit norm by < 0.5%


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("d", (128, 768))
def test_wgmma_body_matches_plain(cuda_device, k: int, d: int) -> None:
    """Random unit rows: the tensor-core body against the plain version at
    every B and n_real; the slots past n_real hold -inf and id -1."""
    g = torch.Generator(device=cuda_device).manual_seed(k + d)
    v = _unit_rows(cuda_device, N_EXACT, d, g)
    q = torch.randn((max(BATCHES), d), generator=g, device=cuda_device)
    q = (q / q.norm(dim=-1, keepdim=True)).to(torch.bfloat16)
    for b in BATCHES:
        for n_real in (N_EXACT, N_EXACT - 77, 3):
            ks, ki = _exact_call(v, q[:b], k, n_real)
            rs, ri = fused_mips_topk_reference(v, q[:b], k=k, n_real=n_real)
            compare(ks, ki, rs, ri, q[:b], v, _tol(d))
            assert ki.max().item() < n_real
            if n_real < k:
                assert (ki[:, n_real:] == -1).all() and torch.isneginf(ks[:, n_real:]).all()
    torch.cuda.synchronize()


@pytest.mark.parametrize("k", KS)
def test_wgmma_body_on_ordered_scores(cuda_device, k: int) -> None:
    """Rows whose scores rise with the row id (every row enters a list) or
    fall with it (only the first rows enter): row j is (j // 256, j % 256,
    0, ...) and a query s (1, 1/256, 0, ...), so a score is s j / 256,
    exact in bf16 inputs and f32 sums; the ids must be the plain version's
    exactly."""
    d = 64
    j = torch.arange(N_EXACT, device=cuda_device)
    v = torch.zeros((N_EXACT, d), device=cuda_device)
    v[:, 0], v[:, 1] = (j // 256).float(), (j % 256).float()
    v = v.to(torch.bfloat16)
    for b in BATCHES:
        scale = torch.tensor([1.0, 2.0, -1.0, 3.0], device=cuda_device).repeat(b)[:b]
        q = torch.zeros((b, d), device=cuda_device)
        q[:, 0], q[:, 1] = scale, scale / 256
        q = q.to(torch.bfloat16)
        for n_real in (N_EXACT, N_EXACT - 77, 3):
            ks, ki = _exact_call(v, q, k, n_real)
            rs, ri = fused_mips_topk_reference(v, q, k=k, n_real=n_real)
            assert torch.equal(ks, rs) and torch.equal(ki, ri)
            live = min(k, n_real)
            top = torch.arange(n_real - 1, n_real - 1 - live, -1, device=cuda_device, dtype=torch.int32)
            assert torch.equal(ki[0, :live], top)  # scale 1: the last rows, highest first
            if b > 2:
                assert torch.equal(ki[2, :live], torch.arange(live, device=cuda_device, dtype=torch.int32))


@pytest.mark.parametrize("k", (10, 100, 128))
@pytest.mark.parametrize("b", (1, 64, 130))
def test_wgmma_body_ties_equal_rows_to_the_lowest_ids(cuda_device, k: int, b: int) -> None:
    """200 copies of one row, 300 rows apart (across tiles and splits): a
    query equal to it takes the k lowest copies, in increasing id order."""
    d = 128
    g = torch.Generator(device=cuda_device).manual_seed(19)
    v = _unit_rows(cuda_device, N_EXACT, d, g)
    dups = torch.arange(7, 7 + 300 * 200, 300, device=cuda_device)
    v[dups] = v[7].clone()
    q = _unit_rows(cuda_device, b, d, g)
    q[0] = v[7]
    ks, ki = _exact_call(v, q, k, N_EXACT)
    compare(ks, ki, *fused_mips_topk_reference(v, q, k=k), q, v, _tol(d))
    assert torch.equal(ki[0], dups[:k].to(torch.int32))
