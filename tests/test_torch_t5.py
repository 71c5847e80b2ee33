"""The port's T5 encoder against the JAX package: both relative-position
bucketings over every relative position in [-1024, 1024], `_RMSNorm`,
`T5Encoder` and `VodT5Encoder` (2 layers, hidden 64, 4 heads of 16, vocab
101), with the flax weights carried over by `models/convert.py`.

Buckets are integers: equal, exactly. In float32 the hidden states (RMS ~1)
agree within atol 1e-5 (sums in other orders; 4e-6 seen) and the pooled
embeddings too. In bfloat16 the two round at other places (the attention
products, the residual adds): atol 0.0625 on hidden states of RMS ~1 and
magnitude up to ~4, four bf16 ulps at [2, 4) (0.031 seen).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_helpers import CPU, np_of
from vod_tpu.models.pooler import VodPoolerConfig as JaxPoolerConfig
from vod_tpu.models.seq2seq import _relative_buckets_causal as jax_causal_buckets
from vod_tpu.models.t5_encoder import T5Encoder as JaxT5Encoder
from vod_tpu.models.t5_encoder import T5EncoderConfig as JaxT5Config
from vod_tpu.models.t5_encoder import VodT5Encoder as JaxVodT5Encoder
from vod_tpu.models.t5_encoder import _relative_buckets as jax_buckets
from vod_tpu.models.t5_encoder import _RMSNorm as JaxRMSNorm
from vod_tpu_torch.models import T5Encoder, T5EncoderConfig, VodPoolerConfig, VodT5Encoder, t5_flax_to_state_dict
from vod_tpu_torch.models.seq2seq import _relative_buckets_causal
from vod_tpu_torch.models.t5_encoder import _bucket_matrix, _relative_buckets, _RMSNorm

SIZES = dict(vocab_size=101, hidden_size=64, num_layers=2, num_heads=4, head_dim=16, intermediate_size=96)
F32_ATOL = 1e-5
BF16_ATOL = 0.0625
# (num_buckets, max_distance): T5's default (t5-small .. t5-11b), and others a config may set
BUCKETS = [(32, 128), (16, 64), (64, 256), (32, 64), (8, 32)]


@pytest.mark.parametrize("num_buckets, max_distance", BUCKETS)
@pytest.mark.parametrize("causal", [False, True], ids=["bidirectional", "causal"])
def test_relative_buckets_equal_jax_at_every_position(num_buckets: int, max_distance: int, causal: bool) -> None:
    rel = np.arange(-1024, 1025)
    jfn, tfn = (jax_causal_buckets, _relative_buckets_causal) if causal else (jax_buckets, _relative_buckets)
    want = np.asarray(jax.jit(lambda r: jfn(r, num_buckets, max_distance))(jnp.asarray(rel)))
    got = np_of(tfn(torch.from_numpy(rel), num_buckets, max_distance))
    np.testing.assert_array_equal(got, want)
    assert got.min() >= 0 and got.max() < num_buckets


def test_bucket_matrix_is_computed_once_per_length() -> None:
    cache: dict = {}
    a = _bucket_matrix(cache, _relative_buckets, 32, 128, 40, torch.device("cpu"))
    assert _bucket_matrix(cache, _relative_buckets, 32, 128, 40, torch.device("cpu")) is a
    pos = torch.arange(40)
    assert torch.equal(a, _relative_buckets(pos[None, :] - pos[:, None], 32, 128).to(torch.int64))
    assert len(cache) == 1


@pytest.mark.parametrize("jdtype, tdtype, atol", [(jnp.float32, torch.float32, 1e-6), (jnp.bfloat16, torch.bfloat16, 0.0)])
def test_rms_norm_matches_jax(jdtype, tdtype, atol: float) -> None:
    """f32 statistics, the normalised value cast to `dtype`, then times the
    scale cast to `dtype`: in bf16 both round the same f32 values, so equal."""
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(3, 5, 64)) * 3).astype(np.float32)
    scale = rng.normal(size=(64,)).astype(np.float32)
    jx = jnp.asarray(x, dtype=jdtype)
    want = JaxRMSNorm(1e-6, dtype=jdtype).apply({"params": {"weight": jnp.asarray(scale)}}, jx)
    norm = _RMSNorm(64, 1e-6, tdtype)
    norm.weight.data = torch.from_numpy(scale)
    got = norm(torch.from_numpy(np.array(jx.astype(jnp.float32))).to(tdtype))
    assert got.dtype == tdtype
    np.testing.assert_allclose(np_of(got.float()), np.asarray(want.astype(jnp.float32)), atol=atol, rtol=0)


def _tokens(seed: int, b: int = 4, length: int = 40):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, SIZES["vocab_size"], size=(b, length)).astype(np.int32)
    mask = np.ones((b, length), np.int32)
    mask[1, 25:] = 0
    mask[2, 4:] = 0
    return ids, mask


@pytest.mark.parametrize("jdtype, tdtype, atol", [(jnp.float32, torch.float32, F32_ATOL), (jnp.bfloat16, torch.bfloat16, BF16_ATOL)],
                         ids=["f32", "bf16"])
def test_t5_encoder_matches_jax(jdtype, tdtype, atol: float) -> None:
    """Sequences of 40 reach the log-spaced buckets (beyond 8 positions)."""
    ids, mask = _tokens(0)
    jmodel = JaxT5Encoder(JaxT5Config(dtype=jdtype, **SIZES))
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(0), jnp.asarray(ids), jnp.asarray(mask)))
    want = np.asarray(jmodel.apply(params, jnp.asarray(ids), jnp.asarray(mask)).astype(jnp.float32))
    tmodel = T5Encoder(T5EncoderConfig(dtype=tdtype, **SIZES), device=CPU)
    tmodel.load_state_dict(t5_flax_to_state_dict(params))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(ids), torch.from_numpy(mask))
    assert got.dtype == tdtype and tuple(got.shape) == (4, 40, SIZES["hidden_size"])
    np.testing.assert_allclose(np_of(got.float()), want, atol=atol, rtol=0)


@pytest.mark.parametrize("pooler", [dict(agg_method="mean", output_norm="l2", scaler=10.0, learn_scaler=True),
                                    dict(agg_method="cls")], ids=["mean-l2-scaled", "cls"])
def test_vod_t5_encoder_matches_jax(pooler: dict) -> None:
    ids, mask = _tokens(1)
    jmodel = JaxVodT5Encoder(JaxT5Config(dtype=jnp.float32, pooler=JaxPoolerConfig(**pooler), **SIZES))
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(1), jnp.asarray(ids), jnp.asarray(mask)))
    want = np.asarray(jmodel.apply(params, jnp.asarray(ids), jnp.asarray(mask)))
    tmodel = VodT5Encoder(T5EncoderConfig(dtype=torch.float32, pooler=VodPoolerConfig(**pooler), **SIZES), device=CPU)
    tmodel.load_state_dict(t5_flax_to_state_dict(params))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(np_of(got), want, atol=F32_ATOL, rtol=0)


def test_t5_random_init_is_seeded_and_finite() -> None:
    cfg = T5EncoderConfig(**SIZES)
    a = VodT5Encoder(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    b = VodT5Encoder(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    for (na, pa), (nb, pb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert na == nb and torch.equal(pa, pb) and pa.dtype == torch.float32
    table = a.backbone.blocks[0].attention.relative_attention_bias
    assert table.shape == (32, SIZES["num_heads"]) and 0.5 < table.std().item() < 1.5  # normal(0, 1)
    assert a.backbone.blocks[1].attention.relative_attention_bias is None  # block 0 owns the only table
    ids, mask = _tokens(2)
    with torch.no_grad():
        assert torch.isfinite(a(torch.from_numpy(ids), torch.from_numpy(mask))).all()
