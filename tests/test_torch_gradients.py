"""The four gradient estimators of the port against the JAX package: loss,
retriever scores, diagnostics, and the gradients with respect to the query
and section encodings and the reader's logits.

The batch has padding slots (-inf scores) in most rows, one row with a single
live slot, a row without positives, NaN raw scores and an empty lse group,
so every `where`-masked term is crossed in the backward pass; the gradients
must be finite and equal to JAX's. Everything is f32 and the two sides sum in
other orders: values and gradients within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_helpers import np_of
from vod_tpu.models import gradients as jgrad
from vod_tpu.types.batch import RealmBatch as JaxRealmBatch
from vod_tpu_torch.models import gradients as tgrad
from vod_tpu_torch.types.batch import RealmBatch

ATOL = 1e-5
B, D, H, L, V = 4, 5, 8, 6, 11


def _batch_arrays(seed: int = 0) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    score = rng.normal(size=(B, D)).astype(np.float32)
    score[0, 4] = score[1, 3:] = -np.inf  # padding slots
    score[2, 1:] = -np.inf  # a single live slot
    relevance = (rng.random((B, D)) < 0.4).astype(np.float32)
    relevance[:, 0] = 1.0
    relevance[3] = 0.0  # no positives
    relevance[np.isneginf(score)] = 0.0
    log_w = np.where(np.isneginf(score), -np.inf, rng.normal(size=(B, D))).astype(np.float32)
    sparse = rng.normal(size=(B, D)).astype(np.float32)
    sparse[rng.random((B, D)) < 0.3] = np.nan
    teacher = rng.normal(size=(B, D)).astype(np.float32)
    teacher[0, 2] = np.nan
    lse_pos = rng.normal(size=B).astype(np.float32)
    lse_pos[3] = -np.inf  # the empty positive group
    lm_ids = rng.integers(0, V, (B, D, L)).astype(np.int32)
    lm_mask = (np.arange(L)[None, None] < rng.integers(3, L + 1, (B, D, 1))).astype(np.int32)
    return dict(
        query__input_ids=np.zeros((B, 3), np.int32), query__attention_mask=np.ones((B, 3), np.int32),
        section__input_ids=np.zeros((B * D, 3), np.int32), section__attention_mask=np.ones((B * D, 3), np.int32),
        section__relevance=relevance, section__idx=np.arange(B * D, dtype=np.int32).reshape(B, D),
        section__score=score, section__sparse=sparse, section__dense=score + 0.5,
        section__teacher_score=teacher, section__log_weight=log_w,
        section__lse_pos=lse_pos, section__lse_neg=rng.normal(size=B).astype(np.float32),
        lm__input_ids=lm_ids, lm__attention_mask=lm_mask,
    )


def _inputs(seed: int = 0, flat: bool = False):
    rng = np.random.default_rng(seed + 100)
    q = rng.normal(size=(B, H)).astype(np.float32)
    s = rng.normal(size=(D, H) if flat else (B, D, H)).astype(np.float32)
    logits = (2 * rng.normal(size=(B * D, L, V))).astype(np.float32)
    return q, s, logits


def _run_both(jest, test, *, with_lm: bool, flat: bool = False, seed: int = 0):
    arrays = _batch_arrays(seed)
    q, s, logits = _inputs(seed, flat)
    extras = {"flat_sections": True} if flat else {}
    jb = JaxRealmBatch(**{k: jnp.asarray(v) for k, v in arrays.items()}, extras=extras)

    def jfn(qq, ss, ll):
        out = jest(batch=jb, query_encoding=qq, section_encoding=ss, lm_logits=ll if with_lm else None)
        return out.loss, (out.retriever_scores, out.diagnostics)

    (jloss, (jscores, jdiag)), jgrads = jax.jit(jax.value_and_grad(jfn, argnums=(0, 1, 2), has_aux=True))(
        jnp.asarray(q), jnp.asarray(s), jnp.asarray(logits)
    )
    tb = RealmBatch(**{k: torch.from_numpy(v) for k, v in arrays.items()}, extras=extras)
    tq, ts, tl = (torch.from_numpy(x).requires_grad_() for x in (q, s, logits))
    out = test(batch=tb, query_encoding=tq, section_encoding=ts, lm_logits=tl if with_lm else None)
    out.loss.backward()
    np.testing.assert_allclose(np_of(out.loss), np_of(jloss), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(np.isneginf(np_of(out.retriever_scores)), np.isneginf(np_of(jscores)))
    np.testing.assert_allclose(np_of(out.retriever_scores), np_of(jscores), atol=ATOL, rtol=0)
    assert set(out.diagnostics) == set(jdiag)
    for k in jdiag:
        np.testing.assert_allclose(np_of(out.diagnostics[k]), np_of(jdiag[k]), atol=ATOL, rtol=0)
    for name, t, j in zip(("query", "section", "lm_logits"), (tq, ts, tl), jgrads):
        if not with_lm and name == "lm_logits":
            assert t.grad is None
            continue
        g = np_of(t.grad)
        assert np.isfinite(g).all(), name
        np.testing.assert_allclose(g, np_of(j), atol=ATOL, rtol=0, err_msg=name)
    return out


@pytest.mark.parametrize("alpha", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("with_lm", [True, False], ids=["reader", "retriever-only"])
def test_vod_gradients_match_jax(alpha: float, with_lm: bool) -> None:
    _run_both(jgrad.VodGradients(alpha=alpha), tgrad.VodGradients(alpha=alpha), with_lm=with_lm)


def test_vod_gradients_proposal_temperature_and_flat_sections() -> None:
    """In-batch negatives: one shared [U, H] section pool."""
    _run_both(
        jgrad.VodGradients(alpha=0.5, proposal_temperature=0.7),
        tgrad.VodGradients(alpha=0.5, proposal_temperature=0.7),
        with_lm=False, flat=True, seed=1,
    )


@pytest.mark.parametrize(
    "kw",
    [{}, dict(guidance="sparse", guidance_weight=0.3), dict(guidance_weight=0.2, self_supervision_weight=0.5, score_decay=0.1)],
    ids=["plain", "sparse-guidance", "aux-losses"],
)
def test_retrieval_gradients_match_jax(kw: dict) -> None:
    out = _run_both(jgrad.RetrievalGradients(**kw), tgrad.RetrievalGradients(**kw), with_lm=False)
    assert {"kl_score", "kl_sparse", "kl_dense"} <= set(out.diagnostics)
    assert not any(v.requires_grad for k, v in out.diagnostics.items() if k.startswith("kl_"))


def test_retrieval_gradients_flat_sections_match_jax() -> None:
    _run_both(jgrad.RetrievalGradients(), tgrad.RetrievalGradients(), with_lm=False, flat=True, seed=2)


def test_marginal_likelihood_gradients_match_jax() -> None:
    _run_both(jgrad.MarginalLikelihoodGradients(), tgrad.MarginalLikelihoodGradients(), with_lm=True)
    q, s, _ = _inputs()
    tb = RealmBatch(**{k: torch.from_numpy(v) for k, v in _batch_arrays().items()})
    with pytest.raises(ValueError, match="lm_logits"):
        tgrad.MarginalLikelihoodGradients()(batch=tb, query_encoding=torch.from_numpy(q), section_encoding=torch.from_numpy(s))


@pytest.mark.parametrize(
    "kw", [dict(objective="margin_mse"), dict(objective="kl", temperature=2.0), dict(objective="margin_mse", ce_weight=0.5)],
    ids=["margin_mse", "kl", "margin_mse+ce"],
)
def test_distillation_gradients_match_jax(kw: dict) -> None:
    _run_both(jgrad.DistillationGradients(**kw), tgrad.DistillationGradients(**kw), with_lm=False)
