"""The port's train loops with the BM25 engine beside the dense one, against
the JAX package's: `training_loop` driving the hybrid weights from
`TrainerState` schedules, and `periodic_training` with a `sparse_engine`.

The task is `tests/test_torch_train.py`'s separable topic task (a one-layer
`Ranker`, hidden 32, f32, the flax weights carried over); the query tokens
double as the sparse terms and the sections' tokens as the documents, as in
`tests/test_runtime.py`. The schedules are the shape of
`configs/msmarco_pq_realm.yaml`'s: the dense weight linear from 0.0, the
sparse weight constant 1.0, so the first step ranks by BM25 alone.

Both loops run at sampling temperature 0 (the samplers take the top
sections, so no random draw enters on either side) with plain SGD at lr 0.5
(no Adam normalisation to turn rounding noise into a step). Tolerances, f32
on both sides: each step's loss, the final parameters and each period's
index vectors within 1e-5, as `tests/test_torch_train.py` holds losses; the
logged weights equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.test_torch_periodic import _record_builds, _setup
from tests.torch_helpers import CPU, np_of
from vod_tpu.configs.search import DenseFactoryConfig as JaxDenseConfig
from vod_tpu.exps import recipes as jax_recipes
from vod_tpu.runtime import QueryBatch as JaxQueryBatch
from vod_tpu.runtime.state import ParameterSchedule as JaxSchedule
from vod_tpu.runtime.state import TrainerState as JaxTrainerState
from vod_tpu.runtime.train import make_train_step as jax_make_train_step
from vod_tpu.runtime.train import training_loop as jax_training_loop
from vod_tpu.search import HybridEngines as JaxEngines
from vod_tpu.search import build_dense_index as jax_build
from vod_tpu.search import build_sparse_index as jax_build_sparse
from vod_tpu_torch.configs import DenseFactoryConfig
from vod_tpu_torch.exps import PeriodicTrainingConfig, periodic_training
from vod_tpu_torch.exps import recipes
from vod_tpu_torch.models import system_flax_to_state_dict
from vod_tpu_torch.models.convert import sparse_index_from_fields
from vod_tpu_torch.runtime import ParameterSchedule, QueryBatch, TrainerState, make_train_step, training_loop
from vod_tpu_torch.search import HybridEngines, SparseIndex, build_dense_index, build_sparse_index

ATOL = 1e-5
STEP = dict(prefetch=16, n_sections=4, max_pos_sections=1, temperature=0.0)
SCHEDULES = dict(dense=dict(mode="linear", start=0.0, value=1.0, period=3), sparse=dict(mode="constant", value=1.0))


def _schedules(cls) -> dict:
    return {name: cls(**kw) for name, kw in SCHEDULES.items()}


def _batches(make_queries, pidx: int, n: int, b: int = 4):
    """Query batches whose tokens are also their sparse terms."""
    qs = [make_queries(b, 100 * pidx + i) for i in range(n)]
    jax_qs = [JaxQueryBatch(jnp.asarray(i), jnp.ones_like(jnp.asarray(i)), section_ids=jnp.asarray(g),
                            terms=jnp.asarray(i)) for i, g in qs]
    torch_qs = [QueryBatch(torch.from_numpy(i), torch.ones_like(torch.from_numpy(i)), section_ids=torch.from_numpy(g),
                           terms=torch.from_numpy(i)) for i, g in qs]
    return jax_qs, torch_qs


def _sparse_pair(jcorpus):
    """The BM25 index over the sections' tokens, built in JAX and carried over."""
    docs = [list(map(int, row)) for row in np.asarray(jcorpus.input_ids)]
    jix = jax_build_sparse(docs, max_postings=16)
    tix = sparse_index_from_fields({"postings_docs": jix.postings_docs, "postings_impacts": jix.postings_impacts,
                                    "n_docs": jix.n_docs}, device=CPU)
    ref = build_sparse_index(docs, max_postings=16, device=CPU)
    assert torch.equal(tix.postings_docs, ref.postings_docs)  # the port's own build gives the same table
    return jix, tix


def _assert_params_close(tmodel, jparams) -> None:
    want = system_flax_to_state_dict(jax.device_get(jparams))
    got = tmodel.state_dict()
    for name, w in want.items():
        np.testing.assert_allclose(np_of(got[name]), np_of(w), atol=ATOL, rtol=0, err_msg=name)


def test_training_loop_with_schedules_and_sparse_matches_jax(monkeypatch) -> None:
    """Four steps over dense (flat f32) + BM25 + gold lookup, the weights
    from the schedules, with a validation batch every two steps: every
    step's loss and logged weights, the validation metrics, the final
    parameters; the port searched the BM25 index once a step and once a
    validation."""
    from vod_tpu_torch.search import hybrid as hybrid_module

    searched = []
    real_search = hybrid_module.sparse_search
    monkeypatch.setattr(hybrid_module, "sparse_search", lambda *a: searched.append(1) or real_search(*a))
    jmodel, params, jcorpus, tmodel, tcorpus, make_queries = _setup(5)
    jix, tix = _sparse_pair(jcorpus)
    emb = np.array(jmodel.apply(params, jcorpus.input_ids, jcorpus.attention_mask,
                                method=type(jmodel).encode_field))
    jqs, tqs = _batches(make_queries, 0, 4)
    jval, tval = _batches(make_queries, 9, 1)

    tx = optax.sgd(0.5)
    jlogs = []
    jparams, _, jstate, _ = jax_training_loop(
        step_fn=jax_make_train_step(jmodel, tx, **STEP), params=jax.device_get(params), opt_state=tx.init(params),
        engines=JaxEngines(dense=jax_build(jnp.asarray(emb), dtype="float32"), sparse=jix), corpus=jcorpus,
        train_queries=jqs, state=JaxTrainerState(max_steps=4, parameters=_schedules(JaxSchedule)),
        rng=jax.random.PRNGKey(0), prefetch_batches=0, log_interval=1, on_log=lambda s, m: jlogs.append(m),
        val_queries=jval, val_check_interval=2,
    )
    tlogs = []
    tstate, _ = training_loop(
        step_fn=make_train_step(tmodel, torch.optim.SGD(tmodel.parameters(), lr=0.5), **STEP),
        engines=HybridEngines(dense=build_dense_index(emb, dtype="float32", device=CPU), sparse=tix),
        corpus=tcorpus, train_queries=tqs, state=TrainerState(max_steps=4, parameters=_schedules(ParameterSchedule)),
        generator=torch.Generator().manual_seed(0), prefetch_batches=0, log_interval=1,
        on_log=lambda s, m: tlogs.append(m), val_queries=tval, val_check_interval=2,
    )
    # the validation loop's logs (steps 2 and 4) against JAX's, then the train steps'
    jvals, tvals = [m for m in jlogs if "val/loss" in m], [m for m in tlogs if "val/loss" in m]
    assert len(tvals) == len(jvals) == 2
    for t, j in zip(tvals, jvals):
        for name in ("val/loss", "val/mrr", "val/hitrate_3"):
            assert t[name] == pytest.approx(float(j[name]), abs=ATOL), name
    jlogs, tlogs = [m for m in jlogs if "loss" in m], [m for m in tlogs if "loss" in m]
    assert tstate.to_json() == jstate.to_json() and len(tlogs) == len(jlogs) == 4 and len(searched) == 4 + 2
    assert [m["parameters/dense"] for m in tlogs] == [float(m["parameters/dense"]) for m in jlogs] == [
        0.0, 1 / 3, 2 / 3, 1.0]
    assert [m["parameters/sparse"] for m in tlogs] == [1.0] * 4
    for t, j in zip(tlogs, jlogs):
        assert t["loss"] == pytest.approx(float(j["loss"]), abs=ATOL)
        for name in ("mrr", "hitrate_3"):
            assert t[name] == pytest.approx(float(j[name]), abs=1e-6), name
    _assert_params_close(tmodel, jparams)


def test_periodic_training_with_a_sparse_engine_matches_jax(monkeypatch) -> None:
    """Two periods of two steps over the flat codec and a BM25 engine that
    is built once and searched in every period (JAX passes it in and never
    rebuilds it): each period's index vectors, the last loss and the final
    parameters equal JAX's."""
    jmodel, params, jcorpus, tmodel, tcorpus, make_queries = _setup(6)
    jix, tix = _sparse_pair(jcorpus)
    batches = {p: _batches(make_queries, p, 2) for p in range(2)}
    jseen, tseen = _record_builds(monkeypatch, jax_recipes), _record_builds(monkeypatch, recipes)

    sparse_seen = []
    real_sparse = recipes.training_loop

    def recording_loop(*, engines, **kw):
        sparse_seen.append(engines.sparse)
        return real_sparse(engines=engines, **kw)

    monkeypatch.setattr(recipes, "training_loop", recording_loop)
    tx = optax.sgd(0.5)
    jlogs, tlogs = [], []
    jparams, _, jstate, jhist = jax_recipes.periodic_training(
        model=jmodel, step_fn=jax_make_train_step(jmodel, tx, **STEP), params=params, opt_state=tx.init(params),
        corpus=jcorpus, state=JaxTrainerState(max_steps=4, period=2, parameters=_schedules(JaxSchedule)),
        train_queries_fn=lambda p: batches[p][0], rng=jax.random.PRNGKey(0), sparse_engine=jix,
        config=jax_recipes.PeriodicTrainingConfig(dense=JaxDenseConfig(codec="flat", dtype="float32"), log_interval=1),
        on_log=lambda s, m: jlogs.append(m),
    )
    tstate, thist = periodic_training(
        step_fn=make_train_step(tmodel, torch.optim.SGD(tmodel.parameters(), lr=0.5), **STEP), corpus=tcorpus,
        state=TrainerState(max_steps=4, period=2, parameters=_schedules(ParameterSchedule)),
        train_queries_fn=lambda p: batches[p][1], generator=torch.Generator().manual_seed(0), sparse_engine=tix,
        config=PeriodicTrainingConfig(dense=DenseFactoryConfig(codec="flat", dtype="float32"), log_interval=1),
        on_log=lambda s, m: tlogs.append(m),
    )
    assert tstate.to_json() == jstate.to_json() and len(thist) == len(jhist) == 2
    assert len(sparse_seen) == 2 and all(s is tix for s in sparse_seen) and isinstance(tix, SparseIndex)
    assert len(jseen) == len(tseen) == 2
    for (jv, _), (tv, _) in zip(jseen, tseen):
        np.testing.assert_allclose(tv, jv, atol=ATOL, rtol=0)
    assert len(tlogs) == len(jlogs) == 4
    for t, j in zip(tlogs, jlogs):
        assert t["loss"] == pytest.approx(float(j["loss"]), abs=ATOL)
        assert (t["parameters/dense"], t["parameters/sparse"]) == (float(j["parameters/dense"]), 1.0)
    _assert_params_close(tmodel, jparams)
