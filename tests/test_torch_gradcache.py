"""The port's GradCache (`vod_tpu_torch/runtime/gradcache.py`) against the
monolithic backward and against the JAX package's
`gradcache_value_and_grad`, mirroring `tests/test_gradcache.py` (all but its
MoE case: the port has no MoE encoder). The batches are JAX's collated
`RealmBatch`es carried over, the weights JAX's init carried over by
`models/convert.py` (f32, hidden 32, 1 layer, 2 heads).

Tolerances, f32 (sums in other orders): losses within 1e-5; gradients
within atol 2e-5 plus rtol 1e-4, `test_gradcache.py`'s bound; after one SGD
step the parameters within 5e-6 (its bound: an SGD step is linear in the
gradient).
"""

import jax
import numpy as np
import pytest
import torch

from tests.test_gradcache import _cached, _cfg, _monolithic, _task
from tests.test_torch_lora_kbit import _with_random_adapters
from tests.test_torch_train import _to_torch_batch
from tests.torch_helpers import CPU, np_of
from vod_tpu.models import kbit as jax_kbit
from vod_tpu.models.encoder import lora_trainable_mask as jax_lora_mask
from vod_tpu.runtime.gradcache import gradcache_value_and_grad
from vod_tpu_torch.models import (
    Ranker,
    RetrievalGradients,
    TransformerEncoderConfig,
    VodPoolerConfig,
    flax_path,
    kbit_prepare,
    lora_trainable_mask,
    system_flax_to_state_dict,
)
from vod_tpu_torch.runtime import (
    QueryBatch,
    build_device_corpus,
    gradcache_backward,
    make_train_step,
)
from vod_tpu_torch.search import HybridEngines, build_dense_index

ATOL, RTOL = 2e-5, 1e-4
LOSS_ATOL = 1e-5
STEP_ATOL = 5e-6
VOCAB = 64


def _port_ranker(params, **kw) -> Ranker:
    cfg = TransformerEncoderConfig(vocab_size=VOCAB, hidden_size=32, num_layers=1, num_heads=2, intermediate_size=64,
                                   dtype=torch.float32,
                                   pooler=VodPoolerConfig(agg_method="mean", output_norm="l2", scaler=8.0), **kw)
    model = Ranker(cfg, RetrievalGradients(), device=CPU)
    model.load_state_dict(system_flax_to_state_dict(jax.device_get(params)))
    return model


def _monolithic_port(model, batch):
    model.zero_grad(set_to_none=True)
    out = model(batch, mode="evaluate")
    out.loss.backward()
    return out, {n: p.grad.clone() for n, p in model.named_parameters()}


def _cached_port(model, batch, chunk_rows):
    model.zero_grad(set_to_none=True)
    out = gradcache_backward(model, batch, chunk_rows=chunk_rows)
    return out, {n: p.grad.clone() for n, p in model.named_parameters()}


def _assert_grads_close(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for name, g in got.items():
        np.testing.assert_allclose(np_of(g), np_of(want[name]), atol=ATOL, rtol=RTOL, err_msg=name)


@pytest.mark.parametrize("chunk_rows", [4, 8, 12, 20, 64])  # 20 rows: 12 leaves a short last chunk, 64 one chunk
def test_gradcache_matches_monolithic_gradients(chunk_rows: int) -> None:
    jmodel, params, jbatch = _task(b=4)
    model, batch = _port_ranker(params), _to_torch_batch(jbatch)
    out_m, grads_m = _monolithic_port(model, batch)
    out_c, grads_c = _cached_port(model, batch, chunk_rows)
    np.testing.assert_allclose(np_of(out_c.loss), np_of(out_m.loss), atol=LOSS_ATOL, rtol=0)
    np.testing.assert_allclose(np_of(out_c.retriever_scores), np_of(out_m.retriever_scores), atol=LOSS_ATOL, rtol=0)
    _assert_grads_close(grads_c, grads_m)
    jloss, _, jgrads = _monolithic(jmodel, params, jbatch)
    np.testing.assert_allclose(np_of(out_c.loss), np_of(jloss), atol=LOSS_ATOL, rtol=0)
    _assert_grads_close(grads_c, system_flax_to_state_dict(jax.device_get(jgrads)))


def test_gradcache_flat_inbatch_negative_pool() -> None:
    jmodel, params, jbatch = _task(b=4, in_batch_negatives=True)
    assert jbatch.extras.get("flat_sections", False)
    model, batch = _port_ranker(params), _to_torch_batch(jbatch)
    out_m, grads_m = _monolithic_port(model, batch)
    out_c, grads_c = _cached_port(model, batch, 8)
    np.testing.assert_allclose(np_of(out_c.loss), np_of(out_m.loss), atol=LOSS_ATOL, rtol=0)
    _assert_grads_close(grads_c, grads_m)


@pytest.mark.parametrize("chunk_rows", [8, 12])  # JAX pads 20 rows to 24 at 12; the port runs a short chunk
def test_port_matches_jax_gradcache(chunk_rows: int) -> None:
    jmodel, params, jbatch = _task(b=4)
    jloss, jscores, jgrads = _cached(jmodel, params, jbatch, chunk_rows)
    out, grads = _cached_port(_port_ranker(params), _to_torch_batch(jbatch), chunk_rows)
    np.testing.assert_allclose(np_of(out.loss), np_of(jloss), atol=LOSS_ATOL, rtol=0)
    np.testing.assert_allclose(np_of(out.retriever_scores), np_of(jscores), atol=LOSS_ATOL, rtol=0)
    _assert_grads_close(grads, system_flax_to_state_dict(jax.device_get(jgrads)))


def test_gradcache_through_kbit_lora_remat_matches_jax() -> None:
    """The qlora composition: LoRA adapters over an int8-frozen base with
    remat, GradCache's gradients of the trainable subset against JAX's
    `gradcache_value_and_grad` with the kbit `param_transform`."""
    jmodel, params, jbatch = _task(b=4, cfg=_cfg(lora_rank=4, remat=True))
    params = jax.device_get(_with_random_adapters(params, 0))
    kb = jax_kbit.kbit_prepare(params, jax_lora_mask(params))

    @jax.jit
    def run(trainable, b):
        transform = lambda t: jax_kbit.kbit_materialize(t, kb.frozen, kb.treedef, kb.paths)  # noqa: E731
        (loss, out), grads = gradcache_value_and_grad(jmodel, trainable, b, chunk_rows=8, param_transform=transform)
        return loss, grads

    jloss, jgrads = jax.device_get(run(kb.trainable, jbatch))
    model = _port_ranker(params, lora_rank=4, remat=True)
    kbit_prepare(model, lora_trainable_mask(model))
    out, grads = _cached_port(model, _to_torch_batch(jbatch), 8)
    np.testing.assert_allclose(np_of(out.loss), np_of(jloss), atol=LOSS_ATOL, rtol=0)
    assert {flax_path(n) for n in grads} == set(jgrads)
    for name, g in grads.items():
        np.testing.assert_allclose(np_of(g), np.asarray(jgrads[flax_path(name)]), atol=ATOL, rtol=RTOL, err_msg=name)


def _step_inputs():
    rng = np.random.default_rng(0)
    n_corpus = 64
    sec = rng.integers(4, VOCAB, size=(n_corpus, 8)).astype(np.int32)
    corpus = build_device_corpus(sec, np.ones((n_corpus, 8), np.int32), device=CPU)
    queries = QueryBatch(
        input_ids=torch.from_numpy(rng.integers(4, VOCAB, size=(4, 6)).astype(np.int32)),
        attention_mask=torch.ones((4, 6), dtype=torch.int32),
        section_ids=torch.from_numpy(rng.integers(0, n_corpus, size=(4, 1)).astype(np.int32)),
    )
    emb = rng.normal(size=(n_corpus, 32)).astype(np.float32)
    return corpus, queries, HybridEngines(dense=build_dense_index(emb, dtype="float32", device=CPU))


def test_train_step_with_gradcache_matches_plain_step() -> None:
    """`make_train_step(gradcache_chunk_rows=8)` takes the same SGD step as
    the monolithic one (same weights, same generator)."""
    _, params, _ = _task()
    corpus, queries, engines = _step_inputs()
    results = {}
    for name, chunk in (("plain", None), ("cache", 8)):
        model = _port_ranker(params)
        step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=1e-2), prefetch=16, n_sections=4,
                               max_pos_sections=1, gradient_clip_val=1.0, gradcache_chunk_rows=chunk)
        assert step.gradcache_chunk_rows == chunk
        m, _, _ = step.train_step(engines, corpus, queries, torch.Generator().manual_seed(2), {})
        results[name] = (model.state_dict(), float(m["loss"]), float(m["grad_norm"]))
    assert results["cache"][1] == pytest.approx(results["plain"][1], abs=LOSS_ATOL)
    assert results["cache"][2] == pytest.approx(results["plain"][2], rel=1e-5)
    for name, w in results["plain"][0].items():
        np.testing.assert_allclose(np_of(results["cache"][0][name]), np_of(w), atol=STEP_ATOL, rtol=0, err_msg=name)
    assert not torch.equal(results["cache"][0]["encoder.backbone.layers.0.output.weight"],
                           _port_ranker(params).state_dict()["encoder.backbone.layers.0.output.weight"])


def test_gradcache_rejects_lm_systems() -> None:
    _, params, _ = _task()
    model = _port_ranker(params)
    with pytest.raises(ValueError, match="retriever-only"):
        make_train_step(model, torch.optim.Adam(model.parameters(), 1e-3), with_lm=True, gradcache_chunk_rows=8)


def test_gradcache_rows_follow_the_fused_pass() -> None:
    """GradCache's rows are JAX's `_fused_rows`: queries, then sections, the
    shorter side padded."""
    from vod_tpu.runtime.gradcache import _fused_rows as jax_rows
    from vod_tpu_torch.models.systems import fused_rows

    _, _, jbatch = _task(b=4)
    ids, mask, b = fused_rows(_to_torch_batch(jbatch))
    jids, jmask, jb = jax_rows(jbatch)
    assert b == jb == 4 and ids.shape == (20, 8)
    np.testing.assert_array_equal(np_of(ids), np.asarray(jids))
    np.testing.assert_array_equal(np_of(mask), np.asarray(jmask))
