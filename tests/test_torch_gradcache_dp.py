"""GradCache with a sown auxiliary loss over a data-parallel split
(`runtime/gradcache.py`, `dp=`) against JAX's `gradcache_value_and_grad`
on the global batch.

JAX chunks the global batch's fused rows (all B queries, then all
sections, the last chunk padded with rows of one valid token) and sums each
chunk's sown term, a batch statistic over the chunk's rows. The port runs
two gloo CPU ranks, each holding its queries and their sections (or the
whole pool, with in-batch negatives); each global chunk's statistics are
summed over the ranks. Cases: SPLADE's FLOPS term and the MoE aux, each at
a `chunk_rows` that (a) divides a rank's 10 rows (5: a chunk where rank 1
holds no row), (b) straddles the ranks and the query/section boundary and
pads (6), and (c) leaves a padded last chunk (8); and the FLOPS term with
in-batch negatives (8). All cases run in one group (one `run_ranks`).

Tolerances, f32: the loss averaged over the ranks within 1e-5 of JAX's
(estimator plus sown terms); the gradients averaged over the ranks within
1e-5 plus rtol 1e-4 of JAX's (sums in other orders; the bound of
`tests/test_torch_gradcache.py`). A control checks that the sown term is
large enough to be seen: JAX's loss at another chunking moves by more than
the tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tests.test_gradcache import _cached
from tests.torch_helpers import job_gradcache_dp, run_ranks
from vod_tpu.models import Ranker as JaxRanker
from vod_tpu.models import RetrievalGradients as JaxRetrievalGradients
from vod_tpu.models import TransformerEncoderConfig as JaxEncCfg
from vod_tpu.models import VodPoolerConfig as JaxPoolerCfg
from vod_tpu.runtime import DeviceCorpus, QueryBatch, device_collate
from vod_tpu.search import HybridEngines, build_dense_index
from vod_tpu_torch.models import system_flax_to_state_dict

LOSS_ATOL = 1e-5
ATOL, RTOL = 1e-5, 1e-4
VOCAB = 64
SIZES = dict(vocab_size=VOCAB, hidden_size=32, num_layers=1, num_heads=2, intermediate_size=64)
MOE = dict(moe_experts=2, moe_top_k=1, moe_aux_weight=0.5)
FLOPS_WEIGHT = 1e-2
CASES = {
    "flops-5": ("splade", False, 5),
    "flops-6": ("splade", False, 6),
    "flops-8": ("splade", False, 8),
    "moe-5": ("moe", False, 5),
    "moe-6": ("moe", False, 6),
    "moe-8": ("moe", False, 8),
    "flops-in-batch-8": ("splade", True, 8),
}


def _jax_task(kind: str, in_batch_negatives: bool):
    """JAX's model, params and one collated global batch of B = 4 queries
    with 4 sections each (20 fused rows), as `tests/test_gradcache.py:_task`."""
    rng = np.random.default_rng(0)
    sec = rng.integers(4, VOCAB, size=(64, 8)).astype("int32")
    corpus = DeviceCorpus(input_ids=jnp.asarray(sec), attention_mask=jnp.ones((64, 8), "int32"))
    queries = QueryBatch(
        input_ids=jnp.asarray(rng.integers(4, VOCAB, size=(4, 6)).astype("int32")),
        attention_mask=jnp.ones((4, 6), "int32"),
        section_ids=jnp.asarray(rng.integers(0, 64, size=(4, 1)).astype("int32")),
    )
    if kind == "splade":
        model = JaxRanker(cfg=JaxEncCfg(dtype=jnp.float32, **SIZES), gradients=JaxRetrievalGradients(),
                          splade_encoder=True, splade_flops_weight=FLOPS_WEIGHT)
    else:
        pooler = JaxPoolerCfg(agg_method="mean", output_norm="l2", scaler=8.0)
        model = JaxRanker(cfg=JaxEncCfg(dtype=jnp.float32, pooler=pooler, **SIZES, **MOE),
                          gradients=JaxRetrievalGradients())
    emb = jnp.asarray(rng.normal(size=(64, 32)).astype("float32"))
    engines = HybridEngines(dense=build_dense_index(emb, dtype="float32"))
    batch, _ = jax.jit(lambda k, qv: device_collate(
        k, engines, corpus, queries, query_vectors=qv, prefetch=16, n_sections=4, max_pos_sections=1,
        in_batch_negatives=in_batch_negatives,
    ))(jax.random.PRNGKey(0), jnp.asarray(rng.normal(size=(4, 32)).astype("float32")))
    params = jax.device_get(model.init(jax.random.PRNGKey(1), batch, mode="evaluate"))
    return model, params, batch


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's value and gradients per case, and the port's from one group of
    two ranks running every case."""
    jax_out, port_cases, tasks, whole = {}, [], {}, {}
    for name, (kind, ibn, chunk) in CASES.items():
        if (kind, ibn) not in tasks:
            tasks[kind, ibn] = _jax_task(kind, ibn)
        model, params, batch = tasks[kind, ibn]
        loss, _, grads = _cached(model, params, batch, chunk)
        if (kind, ibn) not in whole:  # the control: one chunk of all 20 rows
            whole[kind, ibn] = float(_cached(model, params, batch, 20)[0])
        jax_out[name] = (float(loss), system_flax_to_state_dict(jax.device_get(grads)), whole[kind, ibn])
        fields = {k: np.asarray(v) for k, v in vars(batch).items()
                  if k not in ("extras", "diagnostics") and v is not None}
        state = {k: v.numpy() for k, v in system_flax_to_state_dict(params).items()}
        sizes = dict(SIZES, **MOE) if kind == "moe" else SIZES
        port_cases.append((kind, sizes, state, fields, dict(batch.extras), chunk))
    ranks = run_ranks(job_gradcache_dp, 2, tmp_path_factory.mktemp("gc"), port_cases)
    return jax_out, {name: [r[i] for r in ranks] for i, name in enumerate(CASES)}


@pytest.mark.parametrize("case", list(CASES))
def test_split_gradcache_matches_jax_on_the_global_batch(case: str, runs) -> None:
    jax_out, port = runs
    jloss, jgrads, other = jax_out[case]
    assert abs(other - jloss) > 10 * LOSS_ATOL  # the chunking moves the sown term past the tolerance
    for r in port[case]:
        assert r["loss"] == pytest.approx(jloss, abs=LOSS_ATOL)
        assert set(r["grads"]) == set(jgrads)
        for name, g in r["grads"].items():
            np.testing.assert_allclose(g, jgrads[name].numpy(), atol=ATOL, rtol=RTOL, err_msg=name)
    for name, g in port[case][0]["grads"].items():  # the average is the same on both ranks
        np.testing.assert_array_equal(g, port[case][1]["grads"][name], err_msg=name)
