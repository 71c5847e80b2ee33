"""The port's periodic recipe and its parts (`runtime/predict.py`,
`runtime/benchmark.py`, `runtime/checkpoint.py`, `exps/recipes.py`) against
the JAX package's, at toy sizes: a one-layer `Ranker` (hidden 32, f32) over a
separable topic task of 64 sections, the flax weights carried over by
`models/convert.py`.

Tolerances, f32 on both sides: embeddings within 1e-5; benchmark metrics
within 1e-6. `periodic_training` over two periods with the flat codec runs
with sampling temperature 0 (the samplers then take the top sections, so no
random draw enters on either side) and plain SGD at lr 0.5 (no Adam
normalisation to turn rounding noise into a step): each period's index
vectors and the final parameters within 1e-5, the tolerance of
`tests/test_torch_train.py` for scores and gradients. The pq codec and the
checkpoint round trip are checked on the port alone; a resumed run equals
an uninterrupted one bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.test_torch_train import POOLER, _ranker_cfg, _topic_task
from tests.torch_helpers import CPU, np_of
from vod_tpu.configs.search import DenseFactoryConfig as JaxDenseConfig
from vod_tpu.exps import recipes as jax_recipes
from vod_tpu.models import Ranker as JaxRanker
from vod_tpu.models import RetrievalGradients as JaxRetrievalGradients
from vod_tpu.runtime import DeviceCorpus as JaxCorpus
from vod_tpu.runtime import QueryBatch as JaxQueryBatch
from vod_tpu.runtime.benchmark import benchmark_retrieval as jax_benchmark
from vod_tpu.runtime.predict import compute_embeddings as jax_embed
from vod_tpu.runtime.state import TrainerState as JaxTrainerState
from vod_tpu.runtime.train import make_train_step as jax_make_train_step
from vod_tpu.search import HybridEngines as JaxEngines
from vod_tpu.search import build_dense_index as jax_build
from vod_tpu_torch.configs import DenseFactoryConfig
from vod_tpu_torch.exps import PeriodicTrainingConfig, periodic_training
from vod_tpu_torch.exps import recipes
from vod_tpu_torch.models import Ranker, RetrievalGradients, system_flax_to_state_dict
from vod_tpu_torch.ops.pq import quantize_int8
from vod_tpu_torch.runtime import (
    QueryBatch,
    TrainerState,
    adamw,
    benchmark_retrieval,
    build_device_corpus,
    compute_embeddings,
    compute_embeddings_to_host,
    load_checkpoint,
    make_train_step,
)
from vod_tpu_torch.search import HybridEngines, PQIndex, build_dense_index

ATOL = 1e-5
STEP = dict(prefetch=16, n_sections=4, max_pos_sections=1)


def _setup(seed: int = 0):
    """The JAX Ranker and its params, the port's Ranker with the same weights,
    the corpus on both sides, and a query-batch maker."""
    sec, make_queries = _topic_task(seed)
    jcfg, tcfg = _ranker_cfg()
    jmodel = JaxRanker(cfg=jcfg, gradients=JaxRetrievalGradients())
    jcorpus = JaxCorpus(input_ids=jnp.asarray(sec), attention_mask=jnp.ones_like(jnp.asarray(sec)))
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(seed), jcorpus.input_ids[:1], jcorpus.attention_mask[:1],
                                        method=JaxRanker.encode_field))
    tmodel = Ranker(tcfg, RetrievalGradients(), device=CPU)
    tmodel.load_state_dict(system_flax_to_state_dict(params))
    tcorpus = build_device_corpus(sec, np.ones_like(sec), device=CPU)
    return jmodel, params, jcorpus, tmodel, tcorpus, make_queries


def _batches(make_queries, pidx: int, n: int, b: int = 4):
    qs = [make_queries(b, 100 * pidx + i) for i in range(n)]
    jax_qs = [JaxQueryBatch(jnp.asarray(i), jnp.ones_like(jnp.asarray(i)), section_ids=jnp.asarray(g)) for i, g in qs]
    torch_qs = [QueryBatch(torch.from_numpy(i), torch.ones_like(torch.from_numpy(i)), section_ids=torch.from_numpy(g))
                for i, g in qs]
    return jax_qs, torch_qs


def _jax_encode(jmodel):
    return lambda p, i, m: jmodel.apply(p, i, m, method=JaxRanker.encode_field)


@pytest.mark.parametrize("chunk", [7, 64])
def test_compute_embeddings_matches_jax(chunk: int) -> None:
    jmodel, params, jcorpus, tmodel, tcorpus, _ = _setup()
    want = jax_embed(_jax_encode(jmodel), params, jcorpus, chunk=chunk)
    got = compute_embeddings(tmodel.encode_field, tcorpus, chunk=chunk)
    assert got.dtype == torch.float32 and got.shape == tuple(want.shape) and not got.requires_grad
    np.testing.assert_allclose(np_of(got), np_of(want), atol=ATOL, rtol=0)


def test_compute_embeddings_to_host_matches_the_device_path() -> None:
    _, _, _, tmodel, tcorpus, _ = _setup()
    ref = np_of(compute_embeddings(tmodel.encode_field, tcorpus, chunk=16))
    ids = np_of(tcorpus.input_ids)
    for mask in (None, np.ones_like(ids)):
        out = compute_embeddings_to_host(tmodel.encode_field, ids, mask, chunk=5, slab=24, device=CPU)
        assert isinstance(out, np.ndarray) and out.dtype == np.float32
        np.testing.assert_allclose(out, ref, atol=1e-6, rtol=0)


def test_benchmark_retrieval_matches_jax() -> None:
    jmodel, params, jcorpus, tmodel, tcorpus, make_queries = _setup()
    emb = np.array(jax_embed(_jax_encode(jmodel), params, jcorpus))  # a writable copy
    jqs, tqs = _batches(make_queries, 0, 3)
    jvec = [jmodel.apply(params, q.input_ids, q.attention_mask, method=JaxRanker.encode_field) for q in jqs]
    with torch.no_grad():
        tvec = [tmodel.encode_field(q.input_ids, q.attention_mask) for q in tqs]
    metrics = ("ndcg_10", "mrr_10", "hitrate_3", "recall_50")
    want = jax_benchmark(JaxEngines(dense=jax_build(jnp.asarray(emb), dtype="float32")), jqs, query_vectors=jvec,
                         top_k=20, metrics=metrics)
    got = benchmark_retrieval(HybridEngines(dense=build_dense_index(emb, dtype="float32", device=CPU)), tqs,
                              query_vectors=tvec, top_k=20, metrics=metrics)
    assert set(got) == set(want) == {"score", "dense"}
    for key in want:
        assert set(got[key]) == set(want[key])
        for m in want[key]:
            assert got[key][m] == pytest.approx(want[key][m], abs=1e-6), (key, m)


def _record_builds(monkeypatch, module) -> list:
    """Capture (vectors, index) of each period's rebuild in a recipes module."""
    seen = []
    real = module.build_dense_from_config

    def recording(cfg, vectors, **kw):
        index = real(cfg, vectors, **kw)
        seen.append((np.array(vectors), index))
        return index

    monkeypatch.setattr(module, "build_dense_from_config", recording)
    return seen


def test_periodic_training_flat_matches_jax(monkeypatch) -> None:
    """Two periods of two steps: each period re-embeds the corpus with the
    current encoder and rebuilds the flat f32 index; the index vectors of
    both periods and the final parameters equal JAX's."""
    jmodel, params, jcorpus, tmodel, tcorpus, make_queries = _setup(1)
    batches = {p: _batches(make_queries, p, 2) for p in range(2)}
    kw = dict(STEP, temperature=0.0)
    jseen, tseen = _record_builds(monkeypatch, jax_recipes), _record_builds(monkeypatch, recipes)

    tx = optax.sgd(0.5)
    jparams, _, jstate, jhist = jax_recipes.periodic_training(
        model=jmodel, step_fn=jax_make_train_step(jmodel, tx, **kw), params=params, opt_state=tx.init(params),
        corpus=jcorpus, state=JaxTrainerState(max_steps=4, period=2), train_queries_fn=lambda p: batches[p][0],
        rng=jax.random.PRNGKey(0),
        config=jax_recipes.PeriodicTrainingConfig(dense=JaxDenseConfig(codec="flat", dtype="float32"), log_interval=1),
    )
    step = make_train_step(tmodel, torch.optim.SGD(tmodel.parameters(), lr=0.5), **kw)
    tstate, thist = periodic_training(
        step_fn=step, corpus=tcorpus, state=TrainerState(max_steps=4, period=2),
        train_queries_fn=lambda p: batches[p][1], generator=torch.Generator().manual_seed(0),
        config=PeriodicTrainingConfig(dense=DenseFactoryConfig(codec="flat", dtype="float32"), log_interval=1),
    )
    assert tstate.to_json() == jstate.to_json() and [h["period"] for h in thist] == [h["period"] for h in jhist] == [0, 1]
    assert len(jseen) == len(tseen) == 2
    for (jv, _), (tv, _) in zip(jseen, tseen):
        np.testing.assert_allclose(tv, jv, atol=ATOL, rtol=0)
    assert np.abs(tseen[1][0] - tseen[0][0]).max() > 1e-3  # period 1 indexes the moved encoder
    want = system_flax_to_state_dict(jax.device_get(jparams))
    got = tmodel.state_dict()
    for name, w in want.items():
        np.testing.assert_allclose(np_of(got[name]), np_of(w), atol=ATOL, rtol=0, err_msg=name)
    assert thist[1]["train"]["loss"] == pytest.approx(jhist[1]["train"]["loss"], abs=ATOL)
    assert {"reembed_s", "build_ms", "index_bytes", "embed_s", "period_s"} <= set(thist[0])


def test_periodic_training_pq_rebuilds_from_the_moved_encoder(monkeypatch) -> None:
    """The msmarco_pq_realm codec at toy width (4-bit exhaustive ADC, int8
    refine): every period builds a new `PQIndex` from that period's
    embeddings, which moved with the encoder."""
    _, _, _, tmodel, tcorpus, make_queries = _setup(2)
    seen = _record_builds(monkeypatch, recipes)
    cfg = DenseFactoryConfig(codec="pq", n_subquantizers=4, code_bits=4, coarse_dim=None, refine="int8", k_factor=8,
                             kmeans_iters=2)
    step = make_train_step(tmodel, adamw(tmodel, 1e-2, weight_decay=0.0), **STEP)
    state, hist = periodic_training(
        step_fn=step, corpus=tcorpus, state=TrainerState(max_steps=4, period=2),
        train_queries_fn=lambda p: _batches(make_queries, p, 2)[1], generator=torch.Generator().manual_seed(0),
        config=PeriodicTrainingConfig(dense=cfg),
    )
    assert state.step == 4 and len(seen) == 2 and all(isinstance(ix, PQIndex) for _, ix in seen)
    (v0, ix0), (v1, ix1) = seen
    assert np.abs(v1 - v0).max() > 1e-3
    for v, ix in seen:  # each refine store is the int8 quantisation of its own period's vectors
        assert ix.codes.shape == (128, 2) and ix.codes.dtype == torch.uint8
        np.testing.assert_array_equal(np_of(ix.refine_codes[: len(v)]), np_of(quantize_int8(torch.from_numpy(v))[0]))
    assert not torch.equal(ix0.refine_codes, ix1.refine_codes)
    assert set(hist[0]["build_ms"]) == {"train_pq_ms", "coarse_ms", "encode_ms", "refine_ms", "total_ms"}
    assert hist[0]["index_bytes"] == sum(t.numel() * t.element_size() for t in vars(ix0).values()
                                         if isinstance(t, torch.Tensor))


def test_checkpoint_round_trip_resumes_bit_for_bit(tmp_path) -> None:
    """Two periods straight, against one period, a checkpoint, a fresh
    model / optimizer / generator loaded from it, and the second period:
    parameters, optimizer moments and trainer state equal bit for bit."""
    cfg = PeriodicTrainingConfig(dense=DenseFactoryConfig(codec="flat", dtype="float32"),
                                 checkpoint_dir=str(tmp_path / "ckpt"))

    def run(state: TrainerState, model=None, opt=None, gen=None):
        _, _, _, tmodel, tcorpus, make_queries = _setup(3)
        model = model or tmodel
        opt = opt or adamw(model, 1e-2, weight_decay=0.01)
        gen = gen or torch.Generator().manual_seed(5)
        state, _ = periodic_training(step_fn=make_train_step(model, opt, **STEP), corpus=tcorpus, state=state,
                                     train_queries_fn=lambda p: _batches(make_queries, p, 2)[1], generator=gen,
                                     config=cfg)
        return model, opt, state

    model_a, opt_a, state_a = run(TrainerState(max_steps=4, period=2))
    _, _, _, model_b, _, _ = _setup(4)  # other weights, overwritten by the checkpoint
    opt_b, gen_b = adamw(model_b, 1e-2, weight_decay=0.01), torch.Generator().manual_seed(99)
    state_b = load_checkpoint(tmp_path / "ckpt" / "period-0", model=model_b, optimizer=opt_b, generator=gen_b)
    assert state_b.step == 2
    model_b, opt_b, state_b = run(state_b, model_b, opt_b, gen_b)
    assert state_b.to_json() == state_a.to_json()
    for (name, pa), pb in zip(model_a.state_dict().items(), model_b.state_dict().values()):
        assert torch.equal(pa, pb), name
    for sa, sb in zip(opt_a.state.values(), opt_b.state.values()):
        assert all(torch.equal(sa[k], sb[k]) for k in sa)


@pytest.mark.parametrize("change", [dict(profile_dir="trace")], ids=["profile"])
def test_unported_options_raise(change: dict, tmp_path) -> None:
    """Profile traces are ported: two one-step periods run and write no
    trace, as the loop's default window (3, 6) is never reached
    (`tests/test_torch_profile.py` checks a trace)."""
    _, _, _, tmodel, tcorpus, make_queries = _setup()
    cfg = dataclasses.replace(PeriodicTrainingConfig(), **{k: str(tmp_path / v) for k, v in change.items()})
    state, history = periodic_training(
        step_fn=make_train_step(tmodel, adamw(tmodel, 1e-3, weight_decay=0.0), **STEP),
        corpus=tcorpus, state=TrainerState(max_steps=2, period=1),
        train_queries_fn=lambda p: _batches(make_queries, p, 1)[1], generator=torch.Generator(), config=cfg)
    assert state.step == 2 and len(history) == 2 and not (tmp_path / "trace").exists()


def test_defaults_match_jax_and_the_host_path_defaults_to_the_card() -> None:
    import inspect

    want = dataclasses.asdict(jax_recipes.PeriodicTrainingConfig())
    got = dataclasses.asdict(PeriodicTrainingConfig())
    assert {k: v for k, v in got.items() if k != "dense"} == {k: v for k, v in want.items() if k != "dense"}
    assert got["dense"] == want["dense"].model_dump()
    assert inspect.signature(compute_embeddings_to_host).parameters["device"].default == "cuda"
    assert POOLER["output_norm"] == "l2"
