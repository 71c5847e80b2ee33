"""Tensor parallelism (`vod_tpu_torch/parallel/{mesh,tp}.py`): the split
rules against JAX's `tp_sharding` / `combined_sharding`, and the split
forwards of a Realm (`tests/test_torch_train.py`'s `_toy_setup` widths:
hidden 64, 2 layers, 2 heads, intermediate 128, vocab 512) on gloo ranks
against JAX's replicated forward.

Tolerances, f32: the loss, the retriever scores and the query encodings
within 1e-5; each rank's gradients (a split parameter's block, or the whole
replicated parameter) within atol 1e-5 plus rtol 1e-4 of JAX's.
"""

import jax
import numpy as np
import pytest

from tests.test_torch_train import _init, _to_torch_batch
from tests.torch_helpers import job_tp, np_of, run_ranks
from vod_tpu.parallel import make_mesh as jax_make_mesh
from vod_tpu.parallel.mesh import combined_sharding as jax_combined_sharding
from vod_tpu.parallel.mesh import tp_sharding as jax_tp_sharding
from vod_tpu_torch.models import flax_path, system_flax_to_state_dict
from vod_tpu_torch.models.convert import flax_layout
from vod_tpu_torch.parallel.mesh import _torch_dim

ATOL, GRAD_RTOL = 1e-5, 1e-4
SIZES = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=2, intermediate_size=128)


@pytest.fixture(scope="module")
def realm():
    """JAX's Realm, its params, a collated batch, and its replicated loss,
    scores, query encodings and gradients."""
    _, jmodel, _, _, jbatch, params = _init(reader=True)

    def loss_fn(p):
        out = jmodel.apply(p, jbatch, mode="evaluate")
        return out.loss, out.retriever_scores

    (loss, scores), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    enc = jmodel.apply(params, jbatch.query__input_ids, jbatch.query__attention_mask,
                       method=type(jmodel).encode_field)
    state = {k: v.numpy() for k, v in system_flax_to_state_dict(params).items()}
    want = {k: v.numpy() for k, v in system_flax_to_state_dict(jax.device_get(grads)).items()}
    batch = _to_torch_batch(jbatch)
    fields = {k: np_of(v) for k, v in vars(batch).items() if k not in ("extras", "diagnostics") and v is not None}
    return dict(params=params, state=state, grads=want, batch=fields, extras=dict(batch.extras), loss=float(loss),
                scores=np.asarray(scores), enc=np.asarray(enc))


def _port_model(state: dict):
    from tests.torch_helpers import realm_system

    return realm_system(SIZES, SIZES, state)


def _jax_plan(spec_tree) -> dict:
    """flax path -> (axis, flax dim) of each leaf's split, or None."""
    out = {}
    for path, sharding in jax.tree_util.tree_flatten_with_path(spec_tree)[0]:
        spec = list(sharding.spec)
        split = [(a, d) for d, a in enumerate(spec) if a is not None]
        out[jax.tree_util.keystr(path)] = split[0] if split else None
    return out


class _Mesh:
    """The axis names and sizes of a mesh: all the split rules read."""

    def __init__(self, names, sizes):
        self.mesh_dim_names, self._sizes = tuple(names), tuple(sizes)

    def size(self, i):
        return self._sizes[i]


def test_tp_and_combined_rules_pick_jax_axes_for_every_realm_parameter(realm) -> None:
    from vod_tpu_torch.parallel import combined_sharding, tp_sharding

    model = _port_model(realm["state"])
    jmesh = jax_make_mesh((2, 2, 2), ("dp", "fsdp", "tp"))
    jtp = _jax_plan(jax_tp_sharding(realm["params"], jmesh, "tp"))
    jcomb = _jax_plan(jax_combined_sharding(realm["params"], jmesh))
    mesh = _Mesh(("dp", "fsdp", "tp"), (2, 2, 2))
    tp, comb = tp_sharding(model, mesh), combined_sharding(model, mesh)
    assert {flax_path(n) for n in tp} == set(jtp)

    def torch_dim(name, split):
        return None if split is None else (split[0], _torch_dim(flax_layout(model, name).kind, split[1]))

    for name in tp:
        want = torch_dim(name, jtp[flax_path(name)])
        assert (None if tp[name] is None else ("tp", tp[name])) == want, name
        assert comb[name] == torch_dim(name, jcomb[flax_path(name)]), name
    split = sorted(n for n, d in tp.items() if d is not None)
    assert "encoder.backbone.embeddings.word_embeddings.weight" in split  # its key holds "wo", as in JAX
    assert "lm.layers.0.fc_in.weight" in split and "lm.layers.0.query.weight" not in split
    assert {n for n, d in comb.items() if d is not None and d[0] == "fsdp"}
    assert tp_sharding(model, _Mesh(("dp",), (2,))) == {n: None for n in tp}


def _check(res: dict, realm: dict, plan: dict, rank: int, world_tp: int, tp_index) -> None:
    np.testing.assert_allclose(res["loss"], realm["loss"], atol=ATOL, rtol=0)
    np.testing.assert_allclose(res["scores"], realm["scores"], atol=ATOL, rtol=0)
    np.testing.assert_allclose(res["enc"], realm["enc"], atol=ATOL, rtol=0)
    for name, g in res["grads"].items():
        split = plan[name]
        want = realm["grads"][name]
        if split is None:
            pass
        elif isinstance(split, tuple) and split[0] == "fsdp":
            continue  # an FSDP shard: checked by `tests/test_torch_mesh.py`'s FSDP cases
        else:
            dim = split[1] if isinstance(split, tuple) else split
            want = np.split(want, world_tp, axis=dim)[tp_index(rank)]
        np.testing.assert_allclose(g, want, atol=ATOL, rtol=GRAD_RTOL, err_msg=name)


def test_tp_forward_at_w2_equals_jax_replicated(realm, tmp_path) -> None:
    got = run_ranks(job_tp, 2, tmp_path, SIZES, SIZES, realm["state"], realm["batch"], realm["extras"], (2,),
                    ("tp",), False, timeout=180)
    for rank, res in enumerate(got):
        assert res["plan"]["encoder.backbone.layers.0.intermediate.weight"] == 0
        _check(res, realm, res["plan"], rank, 2, lambda r: r)


def test_combined_forward_at_w4_equals_jax_replicated(realm, tmp_path) -> None:
    """(fsdp 2, tp 2): TP blocks, FSDP2 shards of the rest, the same forward."""
    got = run_ranks(job_tp, 4, tmp_path, SIZES, SIZES, realm["state"], realm["batch"], realm["extras"], (2, 2),
                    ("fsdp", "tp"), True, timeout=180)
    for rank, res in enumerate(got):
        assert any(d is not None and d[0] == "fsdp" for d in res["plan"].values())
        _check(res, realm, res["plan"], rank, 2, lambda r: r % 2)


def test_tp_refuses_lora_and_moe_layers() -> None:
    import torch

    from tests.torch_helpers import topic_ranker
    from vod_tpu_torch.parallel.tp import split_layers
    from vod_tpu_torch.parallel import tp_sharding

    for extra in ({"lora_rank": 2}, {"moe_experts": 2}):
        model = topic_ranker(dict(vocab_size=64, hidden_size=32, num_layers=1, num_heads=2, intermediate_size=64,
                                  **extra))
        dims = tp_sharding(model, _Mesh(("tp",), (2,)))
        with pytest.raises(ValueError, match="plain dense layers only"):
            split_layers(model, dims, None, 0, 2)
    assert torch.is_tensor(model.encoder.backbone.layers[0].moe.wi)
