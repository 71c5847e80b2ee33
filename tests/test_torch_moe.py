"""The port's mixture-of-experts (`vod_tpu_torch/parallel/moe.py`, the
encoder's `moe_experts`) against the JAX package's.

Inputs come from numpy at a seed; JAX's weights are carried over by
`models/convert.py`. Routing is discontinuous (a gate probability a few ulps
off can pick another expert), so each comparison first asserts that both
packages chose the same experts and prints the smallest gap between the
k-th and the (k+1)-th probability, then compares the outputs.

Tolerances, f32: `MoEFFN` outputs and aux within 1e-5, gradients within
1e-4 (`jax.grad`); the MoE encoder within 1e-5; the one-step MoE Ranker
train step's loss within 1e-5 relative and the updated `wi` within 1e-5;
GradCache's loss within 1e-5 and gradients within atol 5e-5 plus rtol 1e-4
(`tests/test_gradcache.py`'s bound for its MoE case); a split batch at
W = 2 gives JAX's global aux within 1e-6 and the one-process gradients
within 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.test_gradcache import _cached, _cfg, _task
from tests.test_torch_gradcache import _cached_port, _port_ranker
from tests.test_torch_sample import jax_labeled_noise
from tests.test_torch_train import _capture_grads, _to_torch_batch
from tests.torch_helpers import CPU, job_train_batchwide, moe_module, np_of, run_ranks
from vod_tpu.models import Ranker as JaxRanker
from vod_tpu.models import RetrievalGradients as JaxRetrievalGradients
from vod_tpu.models import TransformerEncoderConfig as JaxEncConfig
from vod_tpu.models import VodPoolerConfig as JaxPoolerConfig
from vod_tpu.models.encoder import TransformerEncoder as JaxTransformerEncoder
from vod_tpu.parallel import fsdp_sharding as jax_fsdp_sharding
from vod_tpu.parallel import make_mesh as jax_make_mesh
from vod_tpu.parallel.moe import MoEFFN as JaxMoEFFN
from vod_tpu.parallel.moe import ep_sharding as jax_ep_sharding
from vod_tpu.runtime import DeviceCorpus as JaxCorpus
from vod_tpu.runtime import QueryBatch as JaxQueryBatch
from vod_tpu.runtime.train import make_train_step as jax_make_train_step
from vod_tpu.search import HybridEngines as JaxEngines
from vod_tpu.search import build_dense_index as jax_build
from vod_tpu_torch.models import (
    Ranker,
    RetrievalGradients,
    TransformerEncoderConfig,
    VodPoolerConfig,
    flax_path,
    flax_to_state_dict,
    system_flax_to_state_dict,
)
from vod_tpu_torch.models.convert import flax_layout
from vod_tpu_torch.models.encoder import TransformerEncoder
from vod_tpu_torch.models.systems import collect_losses
from vod_tpu_torch.parallel import fsdp_flax_dims
from vod_tpu_torch.ops.numpy_ops import topk_lowest_first
from vod_tpu_torch.parallel.moe import MoEFFN
from vod_tpu_torch.runtime import QueryBatch, build_device_corpus, make_train_step
from vod_tpu_torch.search import HybridEngines, build_dense_index

ATOL = 1e-5
GRAD_ATOL = 1e-4
B, T, H, E, INTER = 2, 16, 32, 4, 64


def _jax_moe(k: int, cf: float, seed: int = 0):
    x = np.random.default_rng(seed).standard_normal((B, T, H)).astype(np.float32)
    moe = JaxMoEFFN(n_experts=E, intermediate_size=INTER, top_k=k, capacity_factor=cf, dtype=jnp.float32)
    params = jax.device_get(moe.init(jax.random.PRNGKey(seed), jnp.asarray(x)))
    return moe, params, x


def _assert_same_routing(port_probs: torch.Tensor, jax_probs: np.ndarray, k: int) -> None:
    """The same top-k experts in both packages, with the smallest gap printed."""
    _, jax_top = jax.lax.top_k(jnp.asarray(jax_probs), k)
    _, port_top = topk_lowest_first(port_probs, k)
    srt = np.sort(jax_probs, axis=-1)[..., ::-1]
    gap = float((srt[..., k - 1] - srt[..., k]).min()) if k < srt.shape[-1] else float("inf")
    print(f"smallest gap between the {k}-th and the next gate probability: {gap:.3e}")
    np.testing.assert_array_equal(np_of(port_top), np.asarray(jax_top))


def _gate_probs(params: dict, x: np.ndarray) -> np.ndarray:
    return np.asarray(jax.nn.softmax(jnp.einsum("bth,he->bte", jnp.asarray(x), params["params"]["gate"]), axis=-1))


CASES = {"top1": (1, 1.25), "top2": (2, 1.25), "top1-tight": (1, 0.25), "top2-tight": (2, 0.5)}


@pytest.mark.parametrize("k,cf", CASES.values(), ids=CASES.keys())
def test_moe_ffn_matches_jax(k: int, cf: float) -> None:
    moe, params, x = _jax_moe(k, cf)
    y, aux = moe.apply(params, jnp.asarray(x))
    port = moe_module({n: np.asarray(v) for n, v in params["params"].items()}, k, cf)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        _assert_same_routing(torch.softmax(torch.einsum("bth,he->bte", xt, port.gate), -1), _gate_probs(params, x), k)
        ty, taux = port(xt)
    np.testing.assert_allclose(np_of(ty), np.asarray(y), atol=ATOL, rtol=0)
    np.testing.assert_allclose(float(taux), float(aux), atol=ATOL, rtol=0)
    if cf < 1.0:  # the tight capacity drops tokens to exactly 0, in both packages
        dropped = np.linalg.norm(np.asarray(y), axis=-1) == 0
        assert dropped.any()
        np.testing.assert_array_equal(np.linalg.norm(np_of(ty), axis=-1) == 0, dropped)


@pytest.mark.parametrize("k,cf", [(1, 1.25), (2, 0.5)], ids=["top1", "top2-tight"])
def test_moe_ffn_gradients_match_jax(k: int, cf: float) -> None:
    moe, params, x = _jax_moe(k, cf, seed=1)

    def loss(p, xx):
        y, aux = moe.apply(p, xx)
        return jnp.sum(y**2) + aux

    gp, gx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))
    port = moe_module({n: np.asarray(v) for n, v in params["params"].items()}, k, cf)
    xt = torch.from_numpy(x).requires_grad_(True)
    y, aux = port(xt)
    (y.pow(2).sum() + aux).backward()
    for name in ("gate", "wi", "wo"):
        np.testing.assert_allclose(np_of(getattr(port, name).grad), np.asarray(gp["params"][name]), atol=GRAD_ATOL,
                                   rtol=0, err_msg=name)
    np.testing.assert_allclose(np_of(xt.grad), np.asarray(gx), atol=GRAD_ATOL, rtol=0)


def test_ties_go_to_the_lowest_expert() -> None:
    """Equal gate columns tie every token; `lax.top_k` takes the lowest ids."""
    moe, params, x = _jax_moe(2, 1.25)
    params = jax.tree.map(np.array, params)
    params["params"]["gate"][:, 2] = params["params"]["gate"][:, 0]
    params["params"]["gate"][:, 3] = params["params"]["gate"][:, 0]
    probs = _gate_probs(params, x)
    _, jax_top = jax.lax.top_k(jnp.asarray(probs), 2)
    _, port_top = topk_lowest_first(torch.from_numpy(probs), 2)
    np.testing.assert_array_equal(np_of(port_top), np.asarray(jax_top))
    y, aux = moe.apply(params, jnp.asarray(x))
    ty, taux = moe_module({n: v for n, v in params["params"].items()}, 2, 1.25)(torch.from_numpy(x))
    np.testing.assert_allclose(np_of(ty), np.asarray(y), atol=ATOL, rtol=0)
    np.testing.assert_allclose(float(taux), float(aux), atol=ATOL, rtol=0)


ENC = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64)


def test_moe_encoder_matches_jax() -> None:
    """The MoE encoder's hidden states and its sown losses (the weighted aux
    of each layer, JAX's `mutable=["losses"]`)."""
    rng = np.random.default_rng(2)
    ids = rng.integers(1, 64, (3, 10)).astype(np.int32)
    mask = np.ones((3, 10), np.int32)
    mask[1, 6:] = 0
    jcfg = JaxEncConfig(dtype=jnp.float32, moe_experts=4, moe_top_k=2, **ENC)
    jenc = JaxTransformerEncoder(jcfg)
    params = jax.device_get(jenc.init(jax.random.PRNGKey(3), jnp.asarray(ids), jnp.asarray(mask)))
    assert "losses" not in params
    jh, sown = jenc.apply(params, jnp.asarray(ids), jnp.asarray(mask), mutable=["losses"])
    jlosses = [float(v) for _, v in sorted(
        ((jax.tree_util.keystr(p), leaf) for p, leaf in jax.tree_util.tree_flatten_with_path(sown["losses"])[0]))]
    sd = {k.removeprefix("backbone."): v for k, v in flax_to_state_dict({"backbone": params["params"]}).items()}
    enc = TransformerEncoder(TransformerEncoderConfig(dtype=torch.float32, moe_experts=4, moe_top_k=2, **ENC),
                             device=CPU)
    enc.load_state_dict(sd)
    assert all(isinstance(layer.moe, MoEFFN) for layer in enc.layers)
    with torch.no_grad(), collect_losses(enc) as losses:
        h = enc(torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(np_of(h), np.asarray(jh), atol=ATOL, rtol=0)
    assert len(losses) == 2
    np.testing.assert_allclose([float(v) for v in losses], jlosses, atol=ATOL * 1e-2, rtol=0)
    with torch.no_grad():
        enc(torch.from_numpy(ids), torch.from_numpy(mask))  # nobody collects: nothing is kept
    assert all(layer.sown is None for layer in enc.layers)


def test_moe_paths_layouts_and_fsdp_rule_match_jax() -> None:
    """The MoE leaves' flax paths, their `same` layout, JAX's FSDP rule and
    JAX's ep rule on a Ranker at fsdp/ep sizes 2 and 4."""
    model, params, _ = _task(b=4, cfg=_cfg(moe_experts=4, moe_top_k=2))
    port = _port_ranker(params, moe_experts=4, moe_top_k=2)
    leaves = {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_flatten_with_path(params)[0]}
    moe_names = [n for n, _ in port.named_parameters() if ".moe." in n]
    assert len(moe_names) == 3 and {flax_path(n) for n, _ in port.named_parameters()} == set(leaves)
    for name in moe_names:
        assert flax_layout(port, name).kind == "same"
        assert tuple(dict(port.named_parameters())[name].shape) == leaves[flax_path(name)].shape
    from vod_tpu_torch.parallel.moe import ep_sharding

    for size in (2, 4):
        mesh = jax_make_mesh((size, 8 // size), ("fsdp", "dp"))
        want = {k: s.spec for k, s in ((jax.tree_util.keystr(p), v) for p, v in
                                        jax.tree_util.tree_flatten_with_path(jax_fsdp_sharding(params, mesh))[0])}
        got = fsdp_flax_dims(port, size)
        for name, d in got.items():
            spec = want[flax_path(name)]
            assert (None if all(a is None for a in spec) else list(spec).index("fsdp")) == d, name
        ep_mesh = jax_make_mesh((size, 8 // size), ("ep", "dp"))
        jax_ep = {jax.tree_util.keystr(p): v.spec for p, v in
                  jax.tree_util.tree_flatten_with_path(jax_ep_sharding(params, ep_mesh))[0]}

        class _Mesh:  # the port's rule reads only the axis names and sizes
            mesh_dim_names = ("ep", "dp")

            @staticmethod
            def size(i):
                return (size, 8 // size)[i]

        for name, d in ep_sharding(port, _Mesh()).items():
            spec = jax_ep[flax_path(name)]
            assert (None if all(a is None for a in spec) else list(spec).index("ep")) == d, name
        assert {n for n, d in ep_sharding(port, _Mesh()).items() if d is not None} == {
            n for n in moe_names if n.endswith((".wi", ".wo"))}


def test_moe_with_lora_raises_as_in_jax() -> None:
    with pytest.raises(ValueError, match="mutually exclusive"):
        JaxTransformerEncoder(JaxEncConfig(moe_experts=2, lora_rank=2, **ENC)).init(
            jax.random.PRNGKey(0), jnp.ones((1, 4), jnp.int32), jnp.ones((1, 4), jnp.int32))
    with pytest.raises(ValueError, match="mutually exclusive"):
        TransformerEncoder(TransformerEncoderConfig(moe_experts=2, lora_rank=2, **ENC), device=CPU)


def _runtime_task():
    """`tests/test_runtime.py:601`'s setup: a topic corpus, 4 queries, hidden 32,
    one layer, 4 experts, top-2, Adam 3e-3, clip 1.0."""
    rng = np.random.default_rng(3)
    n, ls, lq = 64, 8, 6
    topics = rng.integers(4, 64, size=(n, 3))
    sec = np.stack([rng.choice(topics[i], size=ls) for i in range(n)]).astype(np.int32)
    r = np.random.default_rng(1)
    gold = r.integers(0, n, size=4)
    q = np.stack([r.choice(topics[g], size=lq) for g in gold]).astype(np.int32)
    emb = rng.normal(size=(n, 32)).astype(np.float32)
    return sec, q, gold[:, None].astype(np.int32), emb


def test_moe_ranker_train_step_matches_jax() -> None:
    """One live-retrieval train step of an MoE Ranker: the aux is in the
    loss, and every parameter after the Adam update equals JAX's."""
    sec, q, gold, emb = _runtime_task()
    pooler = dict(agg_method="mean", output_norm="l2", scaler=8.0, learn_scaler=True)
    enc = dict(vocab_size=64, hidden_size=32, num_layers=1, num_heads=2, intermediate_size=64, moe_experts=4,
               moe_top_k=2)
    jmodel = JaxRanker(cfg=JaxEncConfig(dtype=jnp.float32, pooler=JaxPoolerConfig(**pooler), **enc),
                       gradients=JaxRetrievalGradients())
    step_kw = dict(prefetch=8, n_sections=4, max_pos_sections=1, gradient_clip_val=1.0)
    jstep = jax_make_train_step(jmodel, optax.adam(3e-3), **step_kw)
    jcorpus = JaxCorpus(input_ids=jnp.asarray(sec), attention_mask=jnp.ones(sec.shape, jnp.int32))
    jq = JaxQueryBatch(input_ids=jnp.asarray(q), attention_mask=jnp.ones(q.shape, jnp.int32),
                       section_ids=jnp.asarray(gold))
    jeng = JaxEngines(dense=jax_build(jnp.asarray(emb), dtype="float32"))
    ids = jnp.ones((4, 8), jnp.int32)
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(0), ids, ids, method=JaxRanker.encode_field))
    key = jax.random.PRNGKey(1)
    new_params, _, jm, jrel, _ = jstep.train_step(params, jstep.tx.init(params), jeng, jcorpus, jq, key, None)

    model = Ranker(TransformerEncoderConfig(dtype=torch.float32, pooler=VodPoolerConfig(**pooler), **enc),
                   RetrievalGradients(), device=CPU)
    model.load_state_dict(system_flax_to_state_dict(params))
    wi_before = model.encoder.backbone.layers[0].moe.wi.detach().clone()
    step = make_train_step(model, torch.optim.Adam(model.parameters(), lr=3e-3), **step_kw)
    grads = _capture_grads(step)
    sown = []
    real_loss = step.loss

    def spy(batch, dp=None):
        total, out = real_loss(batch, dp)
        sown.append(float(total - out.loss))
        return total, out

    step.loss = spy
    tm, trel, _ = step.train_step(
        HybridEngines(dense=build_dense_index(emb, dtype="float32", device=CPU)),
        build_device_corpus(sec, np.ones_like(sec), device=CPU),
        QueryBatch(torch.from_numpy(q), torch.ones(q.shape, dtype=torch.int32), section_ids=torch.from_numpy(gold)),
        torch.Generator().manual_seed(0), None, noise=jax_labeled_noise(jax.random.split(key)[0], 4, 8))
    assert sown and sown[0] > 0.0  # the weighted aux is in the loss
    np.testing.assert_array_equal(np_of(trel), np.asarray(jrel))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=ATOL, atol=0)
    want = system_flax_to_state_dict(jax.device_get(new_params))
    wi = model.encoder.backbone.layers[0].moe.wi
    assert not torch.equal(wi.detach(), wi_before)
    np.testing.assert_allclose(np_of(wi), np_of(want["encoder.backbone.layers.0.moe.wi"]), atol=ATOL, rtol=0)
    # Adam turns a zero gradient's rounding noise (the attention key bias's)
    # into a whole step: elsewhere, where the gradient is signal, the updates agree
    for name, w in model.state_dict().items():
        diff = np.abs(np_of(w) - np_of(want[name]))
        signal = np.abs(np_of(grads[name])) >= 1e-6
        assert diff.max() <= 3e-3 * 1.001 and (diff[signal] <= ATOL).all(), (name, diff[signal].max(initial=0.0))


def test_gradcache_sums_the_chunks_aux_as_jax() -> None:
    """`tests/test_gradcache.py:121`'s case: GradCache evaluates the MoE aux
    per chunk and sums the chunks; loss and gradients equal JAX's
    `gradcache_value_and_grad`."""
    jmodel, params, jbatch = _task(b=4, cfg=_cfg(moe_experts=2, moe_top_k=1, moe_aux_weight=1e-2))
    jloss, _, jgrads = _cached(jmodel, params, jbatch, 8)
    model = _port_ranker(params, moe_experts=2, moe_top_k=1, moe_aux_weight=1e-2)
    out, grads = _cached_port(model, _to_torch_batch(jbatch), 8)
    np.testing.assert_allclose(np_of(out.loss), np_of(jloss), atol=ATOL, rtol=0)
    want = system_flax_to_state_dict(jax.device_get(jgrads))
    assert set(grads) == set(want)
    for name, g in grads.items():
        np.testing.assert_allclose(np_of(g), np_of(want[name]), atol=5e-5, rtol=1e-4, err_msg=name)
    assert max(float(g.abs().max()) for n, g in grads.items() if ".moe." in n) > 0.0


SIZES = dict(vocab_size=64, hidden_size=32, num_layers=1, num_heads=2, intermediate_size=64, moe_experts=4,
             moe_top_k=2)


def _topic_batches(seed: int = 4):
    rng = np.random.default_rng(seed)
    n = 64
    topics = rng.integers(4, 64, size=(n, 3))
    sec = np.stack([rng.choice(topics[i], size=8) for i in range(n)]).astype(np.int32)
    batches = []
    for s in range(2):
        r = np.random.default_rng(10 + s)
        gold = r.integers(0, n, size=4)
        batches.append((np.stack([r.choice(topics[g], size=6) for g in gold]).astype(np.int32),
                        gold[:, None].astype(np.int32)))
    return sec, batches


def test_split_batch_aux_is_the_global_batch_s(tmp_path) -> None:
    """Over a dp split at W = 2 the aux of each pass is the global batch's:
    two SGD steps of `training_loop` end at the one-process parameters. The
    aux of one fused pass equals JAX's on its 2-device dp mesh, and a mean
    of the two ranks' own aux would not."""
    from vod_tpu.parallel import make_mesh as jmake, shard_batch as jshard
    from vod_tpu_torch.parallel.mesh import _shard_leaf

    sec, batches = _topic_batches()
    model = _port_ranker_state()
    state = {k: np_of(v) for k, v in model.state_dict().items()}
    step_kw = dict(prefetch=16, n_sections=4, max_pos_sections=1, gradient_clip_val=1.0)
    one = run_ranks(job_train_batchwide, 1, tmp_path, "topic", SIZES, state, sec, batches, step_kw)[0]
    two = run_ranks(job_train_batchwide, 2, tmp_path, "topic", SIZES, state, sec, batches, step_kw)
    for name, w in one["params"].items():
        for r in range(2):
            np.testing.assert_allclose(two[r]["params"][name], w, atol=ATOL, rtol=0, err_msg=name)

    # one fused pass: JAX's aux on a dp mesh against the port's global and per-rank values
    jmodel, params, jbatch = _task(b=4, cfg=_cfg(moe_experts=4, moe_top_k=2))
    mesh = jmake((2, 4), ("dp", "fsdp"))

    @jax.jit
    def jax_aux(p, b):
        _, sown = jmodel.apply(p, b, mode="evaluate", mutable=["losses"])
        return sum(jnp.sum(v) for v in jax.tree.leaves(sown["losses"]))

    want = float(jax_aux(params, jshard(jbatch, mesh, axis="dp")))
    port = _port_ranker(params, moe_experts=4, moe_top_k=2)
    batch = _to_torch_batch(jbatch)
    with torch.no_grad(), collect_losses(port) as whole:
        port(batch, mode="evaluate")
    np.testing.assert_allclose(float(sum(whole)), want, atol=1e-6, rtol=0)
    halves = []
    for r in range(2):
        local = dataclasses.replace(batch, **{f.name: _shard_leaf(getattr(batch, f.name), r, 2)
                                              for f in dataclasses.fields(batch) if f.name != "extras"})
        with torch.no_grad(), collect_losses(port) as own:
            port(local, mode="evaluate")
        halves.append(float(sum(own)))
    assert abs(np.mean(halves) - want) > max(1e-6, 100 * abs(float(sum(whole)) - want)), (halves, want)


def _port_ranker_state():
    from vod_tpu_torch.models import Ranker as PortRanker

    cfg = TransformerEncoderConfig(dtype=torch.float32, pooler=VodPoolerConfig(
        agg_method="mean", output_norm="l2", scaler=8.0, learn_scaler=True), **SIZES)
    return PortRanker(cfg, RetrievalGradients(), device=CPU, generator=torch.Generator().manual_seed(1))


def test_moe_ffn_defaults_to_the_card() -> None:
    import inspect

    assert inspect.signature(MoEFFN).parameters["device"].default == "cuda"
