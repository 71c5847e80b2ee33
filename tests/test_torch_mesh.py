"""The port's mesh and sharding rules (`vod_tpu_torch/parallel/mesh.py`)
against the JAX package's `vod_tpu/parallel/mesh.py`: the FSDP rule picks
the same axis of every parameter of a Ranker at fsdp sizes 2, 4 and 8
(each port parameter read as its flax leaf, `models/convert.py:
flax_layout`), `shard_batch` keeps the same rows and replicates the same
leaves, and one FSDP2 train step on two CPU ranks equals the one-rank step
within 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from tests.torch_helpers import job_fsdp_step, job_shard_batch, run_ranks, topic_ranker
from vod_tpu.models import Ranker as JaxRanker
from vod_tpu.models import RetrievalGradients as JaxRetrievalGradients
from vod_tpu.models import TransformerEncoderConfig as JaxEncConfig
from vod_tpu.models import VodPoolerConfig as JaxPoolerConfig
from vod_tpu.parallel import fsdp_sharding as jax_fsdp_sharding
from vod_tpu.parallel import shard_batch as jax_shard_batch
from vod_tpu.runtime import QueryBatch as JaxQueryBatch
from vod_tpu_torch.models import flax_path
from vod_tpu_torch.models.convert import flax_layout
from vod_tpu_torch.parallel import fsdp_dim, fsdp_flax_dims

SIZES = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=2, intermediate_size=128)
POOLER = dict(agg_method="mean", output_norm="l2", scaler=8.0, learn_scaler=True)


def _jax_params():
    model = JaxRanker(cfg=JaxEncConfig(dtype=jnp.float32, pooler=JaxPoolerConfig(**POOLER), **SIZES),
                      gradients=JaxRetrievalGradients())
    ids = jnp.ones((1, 8), jnp.int32)
    return jax.device_get(model.init(jax.random.PRNGKey(0), ids, ids, method=JaxRanker.encode_field))


@pytest.mark.parametrize("size", [2, 4, 8])
def test_fsdp_rule_picks_the_jax_axis_of_every_parameter(size: int) -> None:
    params = _jax_params()
    mesh = Mesh(np.array(jax.devices()[:size]), ("fsdp",))
    specs = jax_fsdp_sharding(params, mesh)
    flat = {jax.tree_util.keystr(path): spec for path, spec in jax.tree_util.tree_flatten_with_path(specs)[0]}
    model = topic_ranker(SIZES)
    got = fsdp_flax_dims(model, size)
    assert set(got) == {n for n, _ in model.named_parameters()}
    n_split = 0
    for name, dim in got.items():
        spec = tuple(flat[flax_path(name)].spec)
        want = spec.index("fsdp") if "fsdp" in spec else None
        assert dim == want, (name, dim, spec)
        flax_shape = flax_layout(model, name).to_flax(torch.empty(dict(model.named_parameters())[name].shape,
                                                                    device="meta")).shape
        assert fsdp_dim(flax_shape, size) == dim
        n_split += dim is not None
    assert n_split > 0  # the rule does split something at this size
    assert all(d is None for d in fsdp_flax_dims(model, 1).values())


def test_shard_batch_keeps_the_jax_rows(tmp_path) -> None:
    """Leaves whose leading axis divides are split in rank order; the others
    (and scalars) are replicated, as `vod_tpu/parallel/mesh.py:66-74` does."""
    w = 2
    rng = np.random.default_rng(0)
    leaves = dict(ids=rng.integers(0, 9, (6, 4)).astype(np.int32), mask=np.ones((6, 4), np.int32),
                  odd=rng.standard_normal((5, 2)).astype(np.float32), scalar=np.float32(3.0))
    out = run_ranks(job_shard_batch, w, tmp_path, leaves)
    mesh = Mesh(np.array(jax.devices()[:w]), ("dp",))
    jax_out = jax_shard_batch({k: jnp.asarray(v) for k, v in leaves.items()}, mesh, axis="dp")
    jq = jax_shard_batch(JaxQueryBatch(jnp.asarray(leaves["ids"]), jnp.asarray(leaves["mask"])), mesh, axis="dp")
    for rank, res in enumerate(out):
        for k, v in jax_out.items():
            shard = next(s for s in v.addressable_shards if s.device == mesh.devices[rank])
            np.testing.assert_array_equal(res["leaves"][k], np.asarray(shard.data), err_msg=k)
        shard = next(s for s in jq.input_ids.addressable_shards if s.device == mesh.devices[rank])
        np.testing.assert_array_equal(res["query"], np.asarray(shard.data))
        assert res["none_kept"]


def test_fsdp_step_on_two_ranks_equals_one_rank(tmp_path) -> None:
    """One AdamW step (clip 1.0) of a Ranker sharded by `shard_params` over
    fsdp = 2: the loss, the global gradient norm and every parameter equal
    the one-rank step's within 1e-6; the parameters the rule splits are
    FSDP2 DTensors, the others stay whole."""
    rng = np.random.default_rng(3)
    sizes = dict(vocab_size=64, hidden_size=32, num_layers=1, num_heads=2, intermediate_size=64)
    topics = rng.integers(4, 64, size=(64, 3))
    sec = np.stack([rng.choice(topics[i], size=8) for i in range(64)]).astype(np.int32)
    gold = rng.integers(0, 64, size=8)
    batch = (np.stack([rng.choice(topics[g], size=6) for g in gold]).astype(np.int32), gold[:, None].astype(np.int32))
    state = {k: v.numpy() for k, v in topic_ranker(sizes).state_dict().items()}
    one = job_fsdp_step(0, 1, sizes, state, sec, batch)
    two = run_ranks(job_fsdp_step, 2, tmp_path, sizes, state, sec, batch)
    for res in two:
        assert res["loss"] == pytest.approx(one["loss"], abs=1e-6)
        assert res["grad_norm"] == pytest.approx(one["grad_norm"], abs=1e-6)
        for k, v in one["params"].items():
            np.testing.assert_allclose(res["params"][k], v, atol=1e-6, rtol=0, err_msg=k)
        assert res["sharded"] == sorted(k for k, d in res["dims"].items() if d is not None)
        assert any(d is None for d in res["dims"].values())  # the learned scaler stays whole
