"""The port's data-parallel train path (`runtime/train.py` loops with
`mesh`, `runtime/predict.py:compute_embeddings(mesh=...)`,
`models/monitoring.py:aggregate_metrics_psum`) on gloo groups of CPU ranks.

  * W = 2 and 4 against W = 1 on the same global batches (SGD, so no Adam
    amplification of rounding noise): the logged losses within 1e-5 and the
    parameters within 1e-6 after 3 steps, with a replicated index and with
    the index sharded over dp (the queries gathered before the search); the
    validation loop's metrics too. The draws are made for the global batch,
    so sampling runs at temperature 1.
  * Against JAX's mesh run (`tests/test_parallel.py:54`'s task: the same
    data, widths, AdamW 1e-3 and 4 steps of B = 8, the index sharded over
    the batch's axis, JAX's init weights carried over) at that test's own
    tolerances (loss 2e-3, mrr 2e-2), at sampling temperature 0 since the
    packages' random draws differ.
  * `compute_embeddings` over dp equals JAX's mesh re-embed within 1e-5.
  * `aggregate_metrics_psum` equals JAX's on the same NaN-holding values.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from tests.torch_helpers import job_aggregate, job_embeddings, job_train_dp, run_ranks, topic_ranker
from vod_tpu.models import Ranker as JaxRanker
from vod_tpu.models import RetrievalGradients as JaxRetrievalGradients
from vod_tpu.models import TransformerEncoderConfig as JaxEncConfig
from vod_tpu.models import VodPoolerConfig as JaxPoolerConfig
from vod_tpu.models.monitoring import aggregate_metrics_psum as jax_aggregate
from vod_tpu.runtime import DeviceCorpus as JaxCorpus
from vod_tpu.runtime import QueryBatch as JaxQueryBatch
from vod_tpu.runtime.predict import compute_embeddings as jax_embed
from vod_tpu.runtime.state import TrainerState as JaxTrainerState
from vod_tpu.runtime.train import make_train_step as jax_make_train_step
from vod_tpu.runtime.train import training_loop as jax_training_loop
from vod_tpu.search import HybridEngines as JaxEngines
from vod_tpu.search.sharded import build_sharded_dense_index as jax_build_sharded
from vod_tpu_torch.models import system_flax_to_state_dict
from vod_tpu_torch.runtime import QueryBatch, build_device_corpus, device_collate

POOLER = dict(agg_method="mean", output_norm="l2", scaler=8.0, learn_scaler=True)
SIZES = dict(vocab_size=64, hidden_size=32, num_layers=1, num_heads=2, intermediate_size=64)


def _task(seed: int = 7, n: int = 64, ls: int = 8, lq: int = 6, b: int = 8, n_batches: int = 3, first: int = 100):
    """`tests/test_parallel.py:54`'s separable topic task."""
    rng = np.random.default_rng(seed)
    topics = rng.integers(4, 64, size=(n, 3))
    sec = np.stack([rng.choice(topics[i], size=ls) for i in range(n)]).astype(np.int32)
    batches = []
    for s in range(n_batches):
        r = np.random.default_rng(first + s)
        gold = r.integers(0, n, size=b)
        q = np.stack([r.choice(topics[g], size=lq) for g in gold]).astype(np.int32)
        batches.append((q, gold[:, None].astype(np.int32)))
    return sec, batches, rng


def _state(sizes: dict = SIZES) -> dict:
    return {k: v.numpy() for k, v in topic_ranker(sizes).state_dict().items()}


STEP = dict(prefetch=16, n_sections=4, max_pos_sections=1, gradient_clip_val=1.0)


@pytest.mark.parametrize("index, world", [("flat", 2), ("sharded", 2), ("sharded", 4)])
def test_two_ranks_train_and_validate_as_one(index: str, world: int, tmp_path) -> None:
    sec, batches, _ = _task()
    state = _state()
    one = job_train_dp(0, 1, SIZES, state, sec, batches, "flat", STEP, "sgd", 2)
    two = run_ranks(job_train_dp, world, tmp_path, SIZES, state, sec, batches, index, STEP, "sgd", 2)
    assert one["steps"] == 3 and all(res["steps"] == 3 for res in two)
    assert len(two[0]["logs"]) == 3 and all(res["logs"] == [] for res in two[1:])  # rank 0 logs
    for lo, lt in zip(one["logs"], two[0]["logs"]):
        for key in ("loss", "grad_norm", "mrr", "hitrate_3"):
            assert lt[key] == pytest.approx(lo[key], abs=1e-5), key
    for res in two:
        assert res["last"]["loss"] == pytest.approx(one["last"]["loss"], abs=1e-5)  # every rank has the reduced log
        for k, v in one["params"].items():
            np.testing.assert_allclose(res["params"][k], v, atol=1e-6, rtol=0, err_msg=k)
        for key, v in one["val"].items():
            assert res["val"][key] == pytest.approx(v, abs=1e-5), key


def test_accumulation_at_two_ranks_averages_once_a_step(tmp_path) -> None:
    """4 batches at accumulation 2: two optimizer steps; W = 2 equals W = 1."""
    sec, batches, _ = _task(n_batches=4)
    state = _state()
    kw = dict(STEP, accumulate_grad_batches=2)
    one = job_train_dp(0, 1, SIZES, state, sec, batches, "flat", kw, "sgd")
    two = run_ranks(job_train_dp, 2, tmp_path, SIZES, state, sec, batches, "sharded", kw, "sgd")
    assert one["steps"] == two[0]["steps"] == 2
    for k, v in one["params"].items():
        np.testing.assert_allclose(two[1]["params"][k], v, atol=1e-6, rtol=0, err_msg=k)


def _jax_model():
    cfg = JaxEncConfig(dtype=jnp.float32, pooler=JaxPoolerConfig(**POOLER), num_layers=2,
                       **{k: v for k, v in SIZES.items() if k != "num_layers"})
    return JaxRanker(cfg=cfg, gradients=JaxRetrievalGradients())


def test_mesh_training_matches_jax_mesh_run(tmp_path) -> None:
    sec, batches, rng = _task(n=128, b=8, n_batches=4)
    emb = rng.normal(size=(128, 32)).astype(np.float32)
    model = _jax_model()
    ids = jnp.asarray(sec)
    params = jax.device_get(model.init(jax.random.PRNGKey(0), ids[:1], ids[:1], method=JaxRanker.encode_field))
    kw = dict(prefetch=8, n_sections=2, max_pos_sections=1, temperature=0.0)
    mesh = Mesh(np.array(jax.devices()[:2]), ("dp",))
    tx = optax.adam(1e-3)
    logs = []
    jax_training_loop(
        step_fn=jax_make_train_step(model, tx, **kw), params=params, opt_state=tx.init(params),
        engines=JaxEngines(dense=jax_build_sharded(jnp.asarray(emb), mesh, axis="dp", dtype="float32",
                                                   approx_recall=None)),
        corpus=JaxCorpus(input_ids=ids, attention_mask=jnp.ones_like(ids)),
        train_queries=iter([JaxQueryBatch(jnp.asarray(q), jnp.ones_like(jnp.asarray(q)), section_ids=jnp.asarray(g))
                            for q, g in batches]),
        state=JaxTrainerState(max_steps=4), rng=jax.random.PRNGKey(5), log_interval=1, prefetch_batches=0,
        metrics=("mrr", "hitrate_3"), mesh=mesh, on_log=lambda s, m: logs.append(m),
    )
    sizes = dict(SIZES, num_layers=2)
    state = {k: v.numpy() for k, v in system_flax_to_state_dict(params).items()}
    two = run_ranks(job_train_dp, 2, tmp_path, sizes, state, sec, batches, "sharded", kw, "adam", 0, emb)
    assert len(two[0]["logs"]) == len(logs) == 4
    for lj, lt in zip(logs, two[0]["logs"]):
        assert lt["loss"] == pytest.approx(lj["loss"], abs=2e-3)
        assert lt["mrr"] == pytest.approx(lj["mrr"], abs=2e-2)
    assert two[0]["logs"][-1]["loss"] != pytest.approx(two[0]["logs"][0]["loss"])


@pytest.mark.parametrize("world", [2, 3])
def test_compute_embeddings_over_dp_equals_jax(world: int, tmp_path) -> None:
    """Chunks of 24 rows over W ranks (3: blocks of unequal real rows)."""
    sec, _, _ = _task(n=100)
    model = _jax_model()
    ids = jnp.asarray(sec)
    params = jax.device_get(model.init(jax.random.PRNGKey(1), ids[:1], ids[:1], method=JaxRanker.encode_field))
    mesh = Mesh(np.array(jax.devices()[:world]), ("dp",))
    want = np.asarray(jax_embed(lambda p, i, m: model.apply(p, i, m, method=JaxRanker.encode_field), params,
                                JaxCorpus(input_ids=ids, attention_mask=jnp.ones_like(ids)), chunk=24, mesh=mesh))
    state = {k: v.numpy() for k, v in system_flax_to_state_dict(params).items()}
    out = run_ranks(job_embeddings, world, tmp_path, dict(SIZES, num_layers=2), state, sec, 24)
    for got in out:
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("world", [2, 4])
def test_aggregate_metrics_psum_matches_jax(world: int, tmp_path) -> None:
    rng = np.random.default_rng(world)
    values = {"loss": rng.standard_normal(8).astype(np.float32), "mrr": rng.uniform(size=8).astype(np.float32)}
    values["mrr"][[1, 2, 5]] = np.nan  # NaN rows count for neither the sum nor the count
    values["all_nan"] = np.full(8, np.nan, np.float32)
    mesh = Mesh(np.array(jax.devices()[:world]), ("dp",))
    fn = jax.shard_map(lambda v: jax_aggregate(v, "dp"), mesh=mesh, in_specs=({k: P("dp") for k in values},),
                       out_specs={k: P() for k in values}, check_vma=False)
    want = {k: float(v) for k, v in fn({k: jnp.asarray(v) for k, v in values.items()}).items()}
    for got in run_ranks(job_aggregate, world, tmp_path, values):
        assert got.keys() == want.keys()
        for k in want:
            assert got[k] == pytest.approx(want[k], abs=1e-6), k


def test_batch_wide_options_raise_under_a_split_batch(tmp_path) -> None:
    """Once refusals (ROADMAP §A item 5b), now run: in-batch negatives and a
    sown auxiliary loss (SPLADE's FLOPS term) over a batch split on two
    ranks, each rank scoring its rows against the global batch's pool
    (`tests/test_torch_train_dp_batchwide.py` holds them to one process).
    A split batch without its axis's group still cannot pool, and says so."""
    from tests.torch_helpers import job_train_batchwide, splade_ranker
    from vod_tpu_torch.search import HybridEngines, build_dense_index

    sec, batches, _ = _task(n_batches=1)
    state = {k: v.numpy() for k, v in splade_ranker(SIZES).state_dict().items()}
    step = dict(STEP, in_batch_negatives=True)
    for res in run_ranks(job_train_batchwide, 2, tmp_path, "splade", SIZES, state, sec, batches, step):
        (q_shape, s_shape), = res["shapes"]
        assert q_shape[0] == 4 and s_shape[0] == 8 * STEP["n_sections"]
    corpus = build_device_corpus(sec, np.ones_like(sec), device="cpu")
    q = QueryBatch(torch.from_numpy(batches[0][0]), torch.ones_like(torch.from_numpy(batches[0][0])),
                   section_ids=torch.from_numpy(batches[0][1]))
    engines = HybridEngines(dense=build_dense_index(np.eye(64, 32, dtype=np.float32), dtype="float32", device="cpu"))
    with pytest.raises(ValueError, match="group"):
        device_collate(engines, corpus, q, generator=torch.Generator(), query_vectors=torch.zeros(8, 32),
                       in_batch_negatives=True, rows=(0, 2))