"""`hybrid_search_and_sample` and `device_collate` in the port against the JAX
package, with JAX's sampler draws fed in (`jax_labeled_noise`).

Non-padding slots are compared exactly: ids, labels, tokens, masks and
scores (the f32 scan and the binned kernel's plain version compute the same
f32 products as JAX on these inputs); log-weights and lse within 1e-5.
Padding slots fetch random real sections from each side's own generator, so
for them only the -inf score and a valid row id are checked.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_sample import jax_labeled_noise
from tests.torch_helpers import np_of
from vod_tpu.runtime.collate import DeviceCorpus as JaxCorpus
from vod_tpu.runtime.collate import QueryBatch as JaxQueryBatch
from vod_tpu.runtime.collate import device_collate as jax_collate
from vod_tpu.search import HybridEngines as JaxEngines
from vod_tpu.search import SearchQueries as JaxQueries
from vod_tpu.search import build_dense_index as jax_build
from vod_tpu.search.hybrid import hybrid_search_and_sample as jax_hss
from vod_tpu_torch.runtime import QueryBatch, build_device_corpus, build_lm_inputs, device_collate
from vod_tpu_torch.search import HybridEngines, SearchQueries, build_dense_index, hybrid_search_and_sample

ATOL = 1e-5
N, D, B, LS, LQ, LA, VOCAB = 256, 16, 4, 10, 6, 3, 97


def _data(seed: int = 0):
    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(N, D)).astype(np.float32)
    q = emb[rng.integers(0, N, B)] + 0.3 * rng.normal(size=(B, D)).astype(np.float32)
    gold = rng.integers(0, N, (B, 2)).astype(np.int32)
    gold[2, 1] = -1  # one gold id only
    tokens = dict(
        corpus_ids=rng.integers(1, VOCAB, (N, LS)).astype(np.int32),
        corpus_mask=(np.arange(LS)[None] < rng.integers(3, LS + 1, (N, 1))).astype(np.int32),
        q_ids=rng.integers(1, VOCAB, (B, LQ)).astype(np.int32),
        q_mask=(np.arange(LQ)[None] < rng.integers(2, LQ + 1, (B, 1))).astype(np.int32),
        a_ids=rng.integers(1, VOCAB, (B, LA)).astype(np.int32),
        a_mask=np.ones((B, LA), np.int32),
    )
    return emb, q, gold, tokens


def _engines(emb: np.ndarray, kernel: str):
    return (
        JaxEngines(dense=jax_build(jnp.asarray(emb), dtype="float32", kernel=kernel)),
        HybridEngines(dense=build_dense_index(emb, dtype="float32", kernel=kernel, device="cpu")),
    )


@pytest.mark.parametrize("kernel", ["scan", "fused"])
def test_hybrid_search_and_sample_matches_jax(kernel: str) -> None:
    """Search -> merge -> truncate -> sample; every gold id survives the
    truncation to `prefetch` with label 1, though the lookup scores it 0."""
    emb, q, gold, _ = _data(0)
    jeng, teng = _engines(emb, kernel)
    prefetch, total = 12, 6
    key = jax.random.PRNGKey(2)
    weights = {"dense": 1.0}
    js, jm = jax.jit(
        lambda r, e, qq: jax_hss(r, e, qq, prefetch=prefetch, total=total, max_pos_sections=2, weights=weights)
    )(key, jeng, JaxQueries(vector=jnp.asarray(q), section_ids=jnp.asarray(gold)))
    ts, tm = hybrid_search_and_sample(
        teng, SearchQueries(vector=torch.from_numpy(q), section_ids=torch.from_numpy(gold)),
        prefetch=prefetch, total=total, max_pos_sections=2, weights=weights,
        noise=jax_labeled_noise(key, B, prefetch),
    )
    np.testing.assert_array_equal(np_of(tm.indices), np_of(jm.indices))
    np.testing.assert_array_equal(np_of(tm.labels), np_of(jm.labels))
    np.testing.assert_allclose(np_of(tm.scores), np_of(jm.scores), atol=ATOL, rtol=0)
    for r in range(B):
        for g in gold[r][gold[r] >= 0]:
            row = np_of(tm.indices)[r].tolist()
            assert g in row and np_of(tm.labels)[r][row.index(g)] == 1
    np.testing.assert_array_equal(np_of(ts.batch.indices), np_of(js.batch.indices))
    np.testing.assert_array_equal(np_of(ts.batch.labels), np_of(js.batch.labels))
    np.testing.assert_allclose(np_of(ts.batch.scores), np_of(js.batch.scores), atol=ATOL, rtol=0)
    for name in ("log_weights", "lse_pos", "lse_neg", "max_sampling_id"):
        np.testing.assert_allclose(np_of(getattr(ts, name)), np_of(getattr(js, name)), atol=ATOL, rtol=0)
    np.testing.assert_allclose(np_of(ts.raw_scores["dense"]), np_of(js.raw_scores["dense"]), atol=ATOL, equal_nan=True)


def _collate_pair(kernel: str, prefetch: int, n_sections: int, with_lm: bool, in_batch: bool, seed: int = 1):
    emb, q, gold, t = _data(seed)
    jeng, teng = _engines(emb, kernel)
    key = jax.random.PRNGKey(seed)
    kw = dict(prefetch=prefetch, n_sections=n_sections, max_pos_sections=2, with_lm=with_lm,
              in_batch_negatives=in_batch, weights={"dense": 1.0})
    jcorpus = JaxCorpus(input_ids=jnp.asarray(t["corpus_ids"]), attention_mask=jnp.asarray(t["corpus_mask"]))
    jq = JaxQueryBatch(
        input_ids=jnp.asarray(t["q_ids"]), attention_mask=jnp.asarray(t["q_mask"]), section_ids=jnp.asarray(gold),
        answer_ids=jnp.asarray(t["a_ids"]), answer_mask=jnp.asarray(t["a_mask"]),
    )
    jb, _ = jax.jit(lambda r, e, c, qq, v: jax_collate(r, e, c, qq, query_vectors=v, **kw))(
        key, jeng, jcorpus, jq, jnp.asarray(q)
    )
    tcorpus = build_device_corpus(t["corpus_ids"], t["corpus_mask"], device="cpu")
    tq = QueryBatch(
        input_ids=torch.from_numpy(t["q_ids"]), attention_mask=torch.from_numpy(t["q_mask"]),
        section_ids=torch.from_numpy(gold), answer_ids=torch.from_numpy(t["a_ids"]),
        answer_mask=torch.from_numpy(t["a_mask"]),
    )
    key_sample, _ = jax.random.split(key)
    tb, _ = device_collate(
        teng, tcorpus, tq, generator=torch.Generator().manual_seed(0), query_vectors=torch.from_numpy(q),
        noise=jax_labeled_noise(key_sample, B, prefetch), **kw,
    )
    return jb, tb


@pytest.mark.parametrize(
    "kernel, prefetch, n_sections, with_lm",
    [("scan", 16, 6, True), ("fused", 16, 6, False), ("scan", 5, 8, True)],  # the last has padding slots
)
def test_device_collate_matches_jax(kernel: str, prefetch: int, n_sections: int, with_lm: bool) -> None:
    jb, tb = _collate_pair(kernel, prefetch, n_sections, with_lm, in_batch=False)
    pad = np.isneginf(np_of(jb.section__score))
    assert pad.any() == (prefetch < n_sections)
    np.testing.assert_array_equal(np.isneginf(np_of(tb.section__score)), pad)
    np.testing.assert_array_equal(np_of(tb.section__score), np_of(jb.section__score))
    np.testing.assert_array_equal(np_of(tb.section__relevance), np_of(jb.section__relevance))
    idx = np_of(tb.section__idx)
    np.testing.assert_array_equal(idx[~pad], np_of(jb.section__idx)[~pad])
    assert ((idx >= 0) & (idx < N)).all()
    live = ~pad.reshape(-1)
    for name in ("section__input_ids", "section__attention_mask"):
        np.testing.assert_array_equal(np_of(getattr(tb, name))[live], np_of(getattr(jb, name))[live])
    for name in ("query__input_ids", "query__attention_mask"):
        np.testing.assert_array_equal(np_of(getattr(tb, name)), np_of(getattr(jb, name)))
    for name in ("section__log_weight", "section__lse_pos", "section__lse_neg"):
        np.testing.assert_allclose(np_of(getattr(tb, name)), np_of(getattr(jb, name)), atol=ATOL, rtol=0)
    np.testing.assert_allclose(np_of(tb.section__dense), np_of(jb.section__dense), atol=ATOL, equal_nan=True)
    assert np.isnan(np_of(tb.section__sparse)).all() and np.isnan(np_of(jb.section__sparse)).all()
    if with_lm:
        for name in ("lm__input_ids", "lm__attention_mask", "lm__token_type_ids"):
            t, j = np_of(getattr(tb, name)), np_of(getattr(jb, name))
            assert t.shape == j.shape == (B, n_sections, LS + LQ + LA)
            np.testing.assert_array_equal(t[~pad], j[~pad])
    else:
        assert tb.lm__input_ids is None and jb.lm__input_ids is None


@pytest.mark.parametrize("with_lm", [False, True])
def test_device_collate_in_batch_negatives_matches_jax(with_lm: bool) -> None:
    """The shared pool: unique ids ascending, padding last; per-query scores,
    labels and log-weights gathered onto it."""
    jb, tb = _collate_pair("scan", 16, 4, with_lm, in_batch=True)
    assert tb.extras == {"flat_sections": True}
    pool_pad = np.isneginf(np_of(jb.section__score))[0]
    idx = np_of(tb.section__idx)
    np.testing.assert_array_equal(idx[:, ~pool_pad], np_of(jb.section__idx)[:, ~pool_pad])
    assert ((idx >= 0) & (idx < N)).all()
    np.testing.assert_array_equal(np_of(tb.section__input_ids)[~pool_pad], np_of(jb.section__input_ids)[~pool_pad])
    np.testing.assert_array_equal(np_of(tb.section__relevance), np_of(jb.section__relevance))
    for name in ("section__score", "section__log_weight", "section__lse_pos", "section__lse_neg"):
        np.testing.assert_allclose(np_of(getattr(tb, name)), np_of(getattr(jb, name)), atol=ATOL, rtol=0)
    if with_lm:
        np.testing.assert_array_equal(
            np_of(tb.lm__token_type_ids)[:, ~pool_pad], np_of(jb.lm__token_type_ids)[:, ~pool_pad]
        )
        np.testing.assert_array_equal(np_of(tb.lm__input_ids)[:, ~pool_pad], np_of(jb.lm__input_ids)[:, ~pool_pad])


def test_build_lm_inputs_matches_jax() -> None:
    from vod_tpu.runtime.collate import build_lm_inputs as jax_build_lm

    _, _, _, t = _data(3)
    sec = t["corpus_ids"][:8].reshape(B, 2, LS).copy()
    sec[0, 1, 4] = -1  # a negative id is masked out
    smask = t["corpus_mask"][:8].reshape(B, 2, LS)
    args = (sec, smask, t["q_ids"], t["q_mask"], t["a_ids"], t["a_mask"])
    for answers in (True, False):
        a = args if answers else args[:4] + (None, None)
        j = jax_build_lm(*[None if x is None else jnp.asarray(x) for x in a])
        tt = build_lm_inputs(*[None if x is None else torch.from_numpy(x) for x in a])
        for jx, tx in zip(j, tt):
            np.testing.assert_array_equal(np_of(tx), np_of(jx))
