"""The port's train path against the JAX package at the shapes of
`__graft_entry__._toy_setup` (hidden 64, two layers, two heads, vocab 512,
B = 4, 256 sections of 16 tokens, queries of 12, answers of 4,
`VodGradients(alpha=0.5)`), in float32, with the flax weights carried over by
`models/convert.py:system_flax_to_state_dict` and JAX's sampler draws fed in.

Tolerances, f32 on both sides (sums in other orders): losses and scores
within 1e-5; parameter gradients within 1e-5 absolute plus 1e-4 of their
size. After one AdamW step at lr 1e-3 the parameters agree within 2e-6
wherever the (clipped) gradient entry is at least 1e-6, and within lr
elsewhere: an Adam update is g / (|g| + 1e-8) * lr, so where a gradient entry
is rounding noise (an attention key bias, whose true gradient is 0, sees
1e-9) each side steps by its own noise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.test_torch_sample import jax_labeled_noise
from tests.torch_helpers import CPU, np_of
from vod_tpu.exps.cli import _decay_mask
from vod_tpu.models import CausalLMConfig as JaxLMConfig
from vod_tpu.models import Ranker as JaxRanker
from vod_tpu.models import Realm as JaxRealm
from vod_tpu.models import RetrievalGradients as JaxRetrievalGradients
from vod_tpu.models import TransformerEncoderConfig as JaxEncConfig
from vod_tpu.models import VodGradients as JaxVodGradients
from vod_tpu.models import VodPoolerConfig as JaxPoolerConfig
from vod_tpu.models.monitoring import RetrievalMonitor as JaxMonitor
from vod_tpu.models.monitoring import retrieval_metrics as jax_metrics
from vod_tpu.runtime import DeviceCorpus as JaxCorpus
from vod_tpu.runtime import QueryBatch as JaxQueryBatch
from vod_tpu.runtime.collate import device_collate as jax_collate
from vod_tpu.runtime.state import TrainerState as JaxTrainerState
from vod_tpu.runtime.train import make_train_step as jax_make_train_step
from vod_tpu.runtime.train import training_loop as jax_training_loop
from vod_tpu.search import HybridEngines as JaxEngines
from vod_tpu.search import build_dense_index as jax_build
from vod_tpu.types.batch import RealmBatch as JaxRealmBatch
from vod_tpu_torch.models import (
    CausalLMConfig,
    Ranker,
    Realm,
    RetrievalGradients,
    RetrievalMonitor,
    TransformerEncoderConfig,
    VodGradients,
    VodPoolerConfig,
    flax_path,
    retrieval_metrics,
    system_flax_to_state_dict,
)
from vod_tpu_torch.runtime import (
    QueryBatch,
    TrainerState,
    adamw,
    build_device_corpus,
    decay_mask,
    make_train_step,
    training_loop,
)
from vod_tpu_torch.search import HybridEngines, build_dense_index
from vod_tpu_torch.types.batch import RealmBatch

VOCAB, LQ, LS, LA, N, B, H = 512, 12, 16, 4, 256, 4, 64
ENC = dict(vocab_size=VOCAB, hidden_size=H, num_layers=2, num_heads=2, intermediate_size=128)
POOLER = dict(agg_method="mean", output_norm="l2", scaler=8.0, learn_scaler=True)
STEP = dict(prefetch=16, n_sections=4, max_pos_sections=2, with_lm=True, gradient_clip_val=1.0)
WEIGHTS = {"dense": 1.0}
ATOL = 1e-5
GRAD_RTOL = 1e-4
PARAM_ATOL = 2e-6
LR = 1e-3
NOISE_GRAD = 1e-6


def _arrays(seed: int = 0, b: int = B) -> dict[str, np.ndarray]:
    """The `_toy_setup` data: corpus tokens, queries with two gold ids, answers."""
    rng = np.random.default_rng(seed)
    return dict(
        corpus_ids=rng.integers(1, VOCAB, (N, LS)).astype(np.int32),
        q_ids=rng.integers(1, VOCAB, (b, LQ)).astype(np.int32),
        gold=rng.integers(0, N, (b, 2)).astype(np.int32),
        a_ids=rng.integers(1, VOCAB, (b, LA)).astype(np.int32),
        emb=np.random.default_rng(seed + 1).normal(size=(N, H)).astype(np.float32),
    )


def _jax_side(a: dict, reader: bool = True):
    jcfg = JaxEncConfig(dtype=jnp.float32, pooler=JaxPoolerConfig(**POOLER), **ENC)
    if reader:
        lm = JaxLMConfig(dtype=jnp.float32, **ENC)
        model = JaxRealm(cfg=jcfg, lm_cfg=lm, gradients=JaxVodGradients(alpha=0.5))
    else:
        model = JaxRanker(cfg=jcfg, gradients=JaxRetrievalGradients())
    corpus = JaxCorpus(input_ids=jnp.asarray(a["corpus_ids"]), attention_mask=jnp.ones((N, LS), jnp.int32))
    engines = JaxEngines(dense=jax_build(jnp.asarray(a["emb"]), dtype="float32"))
    return model, corpus, engines


def _jax_queries(a: dict, b: int = B) -> JaxQueryBatch:
    return JaxQueryBatch(
        input_ids=jnp.asarray(a["q_ids"][:b]), attention_mask=jnp.ones((b, LQ), jnp.int32),
        section_ids=jnp.asarray(a["gold"][:b]), answer_ids=jnp.asarray(a["a_ids"][:b]),
        answer_mask=jnp.ones((b, LA), jnp.int32),
    )


def _torch_side(a: dict, params, reader: bool = True):
    tcfg = TransformerEncoderConfig(dtype=torch.float32, pooler=VodPoolerConfig(**POOLER), **ENC)
    if reader:
        lm = CausalLMConfig(dtype=torch.float32, **ENC)
        model = Realm(tcfg, lm, VodGradients(alpha=0.5), device=CPU)
    else:
        model = Ranker(tcfg, RetrievalGradients(), device=CPU)
    model.load_state_dict(system_flax_to_state_dict(jax.device_get(params)))
    corpus = build_device_corpus(a["corpus_ids"], np.ones((N, LS), np.int32), device=CPU)
    engines = HybridEngines(dense=build_dense_index(a["emb"], dtype="float32", device=CPU))
    return model, corpus, engines


def _torch_queries(a: dict, b: int = B) -> QueryBatch:
    return QueryBatch(
        input_ids=torch.from_numpy(a["q_ids"][:b]), attention_mask=torch.ones((b, LQ), dtype=torch.int32),
        section_ids=torch.from_numpy(a["gold"][:b]), answer_ids=torch.from_numpy(a["a_ids"][:b]),
        answer_mask=torch.ones((b, LA), dtype=torch.int32),
    )


def _jax_batch(model, engines, corpus, queries, key):
    qv = jnp.asarray(np.random.default_rng(2).normal(size=(queries.input_ids.shape[0], H)).astype(np.float32))
    batch, _ = jax.jit(
        lambda k, e, c, q, v: jax_collate(k, e, c, q, query_vectors=v, prefetch=16, n_sections=4,
                                          max_pos_sections=2, with_lm=True)
    )(key, engines, corpus, queries, qv)
    return batch


def _init(reader: bool = True, seed: int = 0):
    a = _arrays(seed)
    model, corpus, engines = _jax_side(a, reader)
    key = jax.random.PRNGKey(seed)
    batch = _jax_batch(model, engines, corpus, _jax_queries(a), key)
    params = jax.device_get(model.init(key, batch, mode="evaluate"))
    return a, model, corpus, engines, batch, params


def _to_torch_batch(jb: JaxRealmBatch) -> RealmBatch:
    fields = {k: v for k, v in vars(jb).items() if k not in ("extras", "diagnostics") and v is not None}
    return RealmBatch(**{k: torch.from_numpy(np.array(v)) for k, v in fields.items()}, extras=dict(jb.extras))


def _capture_grads(step) -> dict[str, torch.Tensor]:
    """The gradients the optimizer steps on, copied at each `step()`."""
    grads: dict[str, torch.Tensor] = {}
    names = {id(p): n for n, p in step.model.named_parameters()}
    inner = step.optimizer.step

    def capturing_step(*args, **kw):
        for g in step.optimizer.param_groups:
            grads.update({names[id(p)]: p.grad.detach().clone() for p in g["params"]})
        return inner(*args, **kw)

    step.optimizer.step = capturing_step
    return grads


def _assert_state_close(tmodel, params, grads: dict[str, torch.Tensor]) -> None:
    want = system_flax_to_state_dict(jax.device_get(params))
    got = tmodel.state_dict()
    assert set(want) <= set(got)
    for name, w in want.items():
        diff = np.abs(np_of(got[name]) - np_of(w))
        signal = np.abs(np_of(grads[name])) >= NOISE_GRAD
        assert diff.max() <= LR and (diff[signal] <= PARAM_ATOL).all(), (name, diff[signal].max(initial=0.0))


def _evaluate_parity(reader: bool) -> None:
    a, jmodel, jcorpus, jeng, jbatch, params = _init(reader)
    tmodel, _, _ = _torch_side(a, params, reader)

    def loss_fn(p):
        out = jmodel.apply(p, jbatch, mode="evaluate")
        return out.loss, out.retriever_scores

    (jloss, jscores), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    out = tmodel(_to_torch_batch(jbatch), mode="evaluate")
    out.loss.backward()
    np.testing.assert_allclose(np_of(out.loss), np_of(jloss), atol=ATOL, rtol=0)
    np.testing.assert_allclose(np_of(out.retriever_scores), np_of(jscores), atol=ATOL, rtol=0)
    want = system_flax_to_state_dict(jax.device_get(jgrads))
    named = dict(tmodel.named_parameters())
    assert set(want) == set(named)
    for name, g in want.items():
        assert named[name].grad is not None, name
        np.testing.assert_allclose(np_of(named[name].grad), np_of(g), atol=ATOL, rtol=GRAD_RTOL, err_msg=name)


def test_realm_evaluate_matches_jax() -> None:
    """Loss, retriever scores and the gradient of every parameter."""
    _evaluate_parity(reader=True)


def test_ranker_retrieval_gradients_match_jax() -> None:
    _evaluate_parity(reader=False)


def test_flax_paths_and_decay_mask_match_jax() -> None:
    a, _, _, _, _, params = _init()
    tmodel, _, _ = _torch_side(a, params)
    paths, leaves = zip(*jax.tree_util.tree_flatten_with_path(params)[0])
    keys = [jax.tree_util.keystr(p) for p in paths]
    names = [n for n, _ in tmodel.named_parameters()]
    assert sorted(flax_path(n) for n in names) == sorted(keys)
    jmask = dict(zip(keys, jax.tree_util.tree_leaves(_decay_mask(params))))
    tmask = decay_mask(tmodel)
    assert {n: jmask[flax_path(n)] for n in names} == tmask
    assert not tmask["encoder.vod_pooler.log_scaler"] and not tmask["lm.layers.0.ln1.weight"]
    assert tmask["lm.wte.weight"] and tmask["encoder.backbone.embeddings.word_embeddings.weight"]
    assert tmask["lm.lm_head.weight"] and not tmask["lm.layers.0.query.bias"]


@pytest.mark.parametrize("masked, weight_decay", [(True, 0.1), (False, 1e-4)], ids=["decay-mask", "no-mask"])
def test_train_step_matches_optax(masked: bool, weight_decay: float) -> None:
    """One live-retrieval step (encode -> search -> sample -> collate ->
    evaluate -> backward -> clip -> AdamW) from the same weights and draws:
    the loss, the batch's relevances, the scores and every parameter after
    the update. `no-mask` is `_toy_setup`'s `optax.adamw(1e-3)`."""
    a, jmodel, jcorpus, jeng, _, params = _init()
    tmodel, tcorpus, teng = _torch_side(a, params)
    tx = optax.adamw(LR, weight_decay=weight_decay, mask=_decay_mask if masked else None)
    jstep = jax_make_train_step(jmodel, tx, **STEP)
    key = jax.random.PRNGKey(5)
    new_params, _, jm, jrel, jscores = jstep.train_step(
        params, tx.init(params), jeng, jcorpus, _jax_queries(a), key, WEIGHTS
    )
    tstep = make_train_step(tmodel, adamw(tmodel, LR, weight_decay=weight_decay, mask=masked), **STEP)
    grads = _capture_grads(tstep)
    tm, trel, tscores = tstep.train_step(
        teng, tcorpus, _torch_queries(a), torch.Generator().manual_seed(0), WEIGHTS,
        noise=jax_labeled_noise(jax.random.split(key)[0], B, STEP["prefetch"]),
    )
    np.testing.assert_allclose(np_of(tm["loss"]), np_of(jm["loss"]), atol=ATOL, rtol=0)
    assert np.isfinite(np_of(tm["grad_norm"])) and np_of(tm["grad_norm"]) > 1.0  # the clip was active
    np.testing.assert_array_equal(np_of(trel), np_of(jrel))
    np.testing.assert_allclose(np_of(tscores), np_of(jscores), atol=ATOL, rtol=0)
    _assert_state_close(tmodel, new_params, grads)


def test_train_step_accum_matches_optax() -> None:
    """Two micro-batches, each collated and encoded with the pre-update
    weights; gradients averaged, then one clipped AdamW step."""
    a, jmodel, jcorpus, jeng, _, params = _init()
    a2 = _arrays(7)
    a2["corpus_ids"], a2["emb"] = a["corpus_ids"], a["emb"]
    tmodel, tcorpus, teng = _torch_side(a, params)
    tx = optax.adamw(LR, weight_decay=0.1, mask=_decay_mask)
    jstep = jax_make_train_step(jmodel, tx, accumulate_grad_batches=2, **STEP)
    key = jax.random.PRNGKey(9)
    new_params, _, jm, jrel, jscores = jstep.train_step_accum(
        params, tx.init(params), jeng, jcorpus, [_jax_queries(a), _jax_queries(a2)], key, WEIGHTS
    )
    tstep = make_train_step(tmodel, adamw(tmodel, LR, weight_decay=0.1), accumulate_grad_batches=2, **STEP)
    grads = _capture_grads(tstep)
    noise = [jax_labeled_noise(jax.random.split(k)[0], B, STEP["prefetch"]) for k in jax.random.split(key, 2)]
    tm, trel, tscores = tstep.train_step_accum(
        teng, tcorpus, [_torch_queries(a), _torch_queries(a2)], torch.Generator().manual_seed(0), WEIGHTS,
        noise=noise,
    )
    np.testing.assert_allclose(np_of(tm["loss"]), np_of(jm["loss"]), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(np_of(trel), np_of(jrel))
    np.testing.assert_allclose(np_of(tscores), np_of(jscores), atol=ATOL, rtol=0)
    _assert_state_close(tmodel, new_params, grads)


METRICS = ["mrr", "mrr_3", "hitrate_3", "precision_2", "recall", "kldiv", "min", "max", "entropy", "ndcg_10"]


def test_retrieval_monitor_matches_jax() -> None:
    rng = np.random.default_rng(3)
    batches = []
    for _ in range(2):
        rel = (rng.random((6, 8)) < 0.3).astype(np.float32)
        rel[0] = 0.0  # no positives: recall and kldiv undefined
        scores = rng.normal(size=(6, 8)).astype(np.float32)
        scores[1, 5:] = -np.inf
        scores[2, 0] = np.nan
        batches.append((rel, scores))
    jmon, tmon = JaxMonitor(METRICS), RetrievalMonitor(METRICS)
    for rel, scores in batches:
        jv = jax_metrics(METRICS, relevances=jnp.asarray(rel), scores=jnp.asarray(scores))
        tv = retrieval_metrics(METRICS, relevances=torch.from_numpy(rel), scores=torch.from_numpy(scores))
        for m in METRICS:
            np.testing.assert_allclose(np_of(tv[m]), np_of(jv[m]), atol=1e-6, rtol=0, equal_nan=True, err_msg=m)
        jmon.update(relevances=jnp.asarray(rel), scores=jnp.asarray(scores))
        tmon.update(relevances=torch.from_numpy(rel), scores=torch.from_numpy(scores))
    jout, tout = jmon.compute(), tmon.compute()
    for m in METRICS:
        np.testing.assert_allclose(tout[m], jout[m], atol=1e-6, rtol=0, err_msg=m)
    assert RetrievalMonitor(["mrr"]).compute()["mrr"] != RetrievalMonitor(["mrr"]).compute()["mrr"]  # NaN


# ---- the loops: a separable toy task (each query shares topic tokens with its gold section) ----

TOPIC_VOCAB = 64


def _topic_task(seed: int, n_corpus: int = 64, ls: int = 8, lq: int = 6):
    rng = np.random.default_rng(seed)
    topics = rng.integers(4, TOPIC_VOCAB, size=(n_corpus, 3))
    sec = np.stack([rng.choice(topics[i], size=ls) for i in range(n_corpus)]).astype(np.int32)

    def queries(b: int, s: int) -> tuple[np.ndarray, np.ndarray]:
        r = np.random.default_rng(s)
        gold = r.integers(0, n_corpus, size=b)
        return np.stack([r.choice(topics[g], size=lq) for g in gold]).astype(np.int32), gold[:, None].astype(np.int32)

    return sec, queries


def _ranker_cfg():
    sizes = dict(vocab_size=TOPIC_VOCAB, hidden_size=32, num_layers=1, num_heads=2, intermediate_size=64)
    return (
        JaxEncConfig(dtype=jnp.float32, pooler=JaxPoolerConfig(**POOLER), **sizes),
        TransformerEncoderConfig(dtype=torch.float32, pooler=VodPoolerConfig(**POOLER), **sizes),
    )


def test_training_loop_loss_falls_on_a_separable_task() -> None:
    sec, make_queries = _topic_task(0)
    _, tcfg = _ranker_cfg()
    model = Ranker(tcfg, RetrievalGradients(), device=CPU, generator=torch.Generator().manual_seed(0))
    corpus = build_device_corpus(sec, np.ones_like(sec), device=CPU)
    with torch.no_grad():  # index the corpus with the initial encoder
        emb = model.encode_field(corpus.input_ids, corpus.attention_mask)
    engines = HybridEngines(dense=build_dense_index(emb, dtype="float32", device=CPU))
    step = make_train_step(model, adamw(model, 3e-3, weight_decay=0.0), prefetch=16, n_sections=4,
                           max_pos_sections=1, gradient_clip_val=1.0)
    batches = []
    for s in range(40):
        ids, gold = make_queries(8, s)
        batches.append(QueryBatch(torch.from_numpy(ids), torch.ones_like(torch.from_numpy(ids)),
                                  section_ids=torch.from_numpy(gold)))
    losses = []
    state = TrainerState(max_steps=40)
    state, last = training_loop(
        step_fn=step, engines=engines, corpus=corpus, train_queries=batches, state=state,
        generator=torch.Generator().manual_seed(1), log_interval=1, on_log=lambda s, m: losses.append(m["loss"]),
    )
    assert state.step == 40 and len(losses) == 40 and np.isfinite(losses).all()
    assert np.mean(losses[-8:]) < 0.5 * np.mean(losses[:8]), losses
    assert {"loss", "grad_norm", "mrr", "ndcg_10", "hitrate_3", "steps_per_sec", "step"} <= set(last)


@pytest.mark.parametrize("accum, max_steps, n_batches", [(2, 10, 5), (1, 3, 5)], ids=["accum-tail", "max-steps"])
def test_training_loop_counts_steps_like_jax(accum: int, max_steps: int, n_batches: int) -> None:
    """5 batches at accumulation 2: two optimizer steps, the orphan batch
    dropped; at accumulation 1 the loop stops at max_steps. The TrainerState
    fields and the number of validation calls equal JAX's."""
    sec, make_queries = _topic_task(20)
    jcfg, tcfg = _ranker_cfg()
    kw = dict(prefetch=16, n_sections=4, max_pos_sections=1, accumulate_grad_batches=accum)
    qs = [make_queries(4, s) for s in range(n_batches)]

    jmodel = JaxRanker(cfg=jcfg, gradients=JaxRetrievalGradients())
    jcorpus = JaxCorpus(input_ids=jnp.asarray(sec), attention_mask=jnp.ones_like(jnp.asarray(sec)))
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(0), jcorpus.input_ids[:1], jcorpus.attention_mask[:1],
                                        method=JaxRanker.encode_field))  # host copies: the loop donates its inputs
    emb = np.array(jmodel.apply(params, jcorpus.input_ids, jcorpus.attention_mask, method=JaxRanker.encode_field))
    tx = optax.adam(3e-3)
    jstate = JaxTrainerState(max_steps=max_steps, period=10)
    jval = []
    _, _, jstate, _ = jax_training_loop(
        step_fn=jax_make_train_step(jmodel, tx, **kw), params=params, opt_state=tx.init(params),
        engines=JaxEngines(dense=jax_build(jnp.asarray(emb), dtype="float32")), corpus=jcorpus,
        train_queries=[JaxQueryBatch(jnp.asarray(i), jnp.ones_like(jnp.asarray(i)), section_ids=jnp.asarray(g))
                       for i, g in qs],
        state=jstate, rng=jax.random.PRNGKey(1), prefetch_batches=0,
        val_queries=[JaxQueryBatch(jnp.asarray(qs[0][0]), jnp.ones_like(jnp.asarray(qs[0][0])))],
        val_check_interval=1, on_log=lambda s, m: jval.append(s) if any(k.startswith("val/") for k in m) else None,
    )

    tmodel = Ranker(tcfg, RetrievalGradients(), device=CPU)
    tmodel.load_state_dict(system_flax_to_state_dict(jax.device_get(params)))
    tstate = TrainerState(max_steps=max_steps, period=10)
    tval = []
    tstate, _ = training_loop(
        step_fn=make_train_step(tmodel, adamw(tmodel, 3e-3, weight_decay=0.0), **kw),
        engines=HybridEngines(dense=build_dense_index(emb, dtype="float32", device=CPU)),
        corpus=build_device_corpus(sec, np.ones_like(sec), device=CPU),
        train_queries=[QueryBatch(torch.from_numpy(i), torch.ones_like(torch.from_numpy(i)),
                                  section_ids=torch.from_numpy(g)) for i, g in qs],
        state=tstate, generator=torch.Generator().manual_seed(1), prefetch_batches=0,
        val_queries=[QueryBatch(torch.from_numpy(qs[0][0]), torch.ones_like(torch.from_numpy(qs[0][0])))],
        val_check_interval=1, on_log=lambda s, m: tval.append(s) if any(k.startswith("val/") for k in m) else None,
    )
    assert tstate.to_json() == jstate.to_json()
    assert tstate.step == min(max_steps, n_batches // accum)
    assert tval == jval


def test_unported_options_raise(tmp_path) -> None:
    """A mesh (tests/test_torch_train_dp.py) and profiler traces are ported:
    a one-step window over the Realm writes one trace."""
    a, _, _, _, _, params = _init()
    tmodel, tcorpus, teng = _torch_side(a, params)
    opt = adamw(tmodel, 1e-3, weight_decay=0.0)
    state, _ = training_loop(step_fn=make_train_step(tmodel, opt, **STEP), engines=teng, corpus=tcorpus,
                             train_queries=[_torch_queries(a)], state=TrainerState(max_steps=1, period=1),
                             generator=torch.Generator(), prefetch_batches=0, profile_dir=str(tmp_path / "trace"),
                             profile_steps=(0, 1))
    assert state.step == 1 and len(list((tmp_path / "trace").glob("trace-rank0-*.json"))) == 1


def test_new_entry_points_default_to_the_card() -> None:
    """The reader, the systems and the corpus builder default to "cuda"; the
    train step has no device of its own: it runs where its model and index live."""
    import inspect

    from vod_tpu_torch.models import CausalLM

    for fn in (CausalLM, Ranker, Realm, build_device_corpus):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    assert "device" not in inspect.signature(make_train_step).parameters


def test_state_logging_and_prefetch_copies_match_jax(tmp_path) -> None:
    """The port's copies of `runtime/state.py`, `runtime/logging.py` and
    `dataloaders/prefetch.py` behave as the JAX package's modules."""
    from vod_tpu.runtime.logging import flatten_metrics as jax_flatten
    from vod_tpu.runtime.state import ParameterSchedule as JaxSchedule
    from vod_tpu_torch.dataloaders import prefetch_iterator
    from vod_tpu_torch.runtime import ParameterSchedule
    from vod_tpu_torch.runtime.logging import CSVLogger, JSONLLogger, flatten_metrics

    for kw in (dict(mode="linear", start=0.0, value=1.0, period=10), dict(mode="step", start=2.0, value=3.0, period=5),
               dict(mode="exponential", start=0.5, value=4.0, period=8, offset=2)):
        assert [ParameterSchedule(**kw)(s) for s in range(0, 14, 3)] == [JaxSchedule(**kw)(s) for s in range(0, 14, 3)]
    state = TrainerState(step=7, max_steps=20, period=5, parameters={"dense": ParameterSchedule(mode="linear", period=10)})
    state.save(tmp_path / "state.json")
    assert TrainerState.load(tmp_path / "state.json") == state and state.pidx == 1 and state.next_period_start_step == 10
    metrics = {"loss": torch.tensor(1.5), "val": {"mrr": 0.25, "name": "x"}}
    assert flatten_metrics(metrics) == jax_flatten({"loss": 1.5, "val": {"mrr": 0.25, "name": "x"}}) == {
        "loss": 1.5, "val/mrr": 0.25}
    JSONLLogger(tmp_path / "m.jsonl").log(3, metrics)
    assert (tmp_path / "m.jsonl").read_text().strip() == '{"step": 3, "loss": 1.5, "val/mrr": 0.25}'
    csv = CSVLogger(tmp_path / "m.csv")
    csv.log(1, {"a": 1.0})
    csv.log(2, {"b": 2.0})
    assert (tmp_path / "m.csv").read_text().splitlines() == ["step,a,b", "1,1.0,", "2,,2.0"]
    assert list(prefetch_iterator(iter(range(7)), size=2)) == list(range(7))

    def failing():
        yield 1
        raise KeyError("boom")

    with pytest.raises(KeyError):
        list(prefetch_iterator(failing()))
