"""The port's MaxSim late-interaction engine (`vod_tpu_torch/search/maxsim.py`)
against the JAX package, mirroring `tests/test_maxsim.py` (all but its
sharded case: the port has no mesh yet). The same numpy token embeddings go
to both packages' `build_maxsim_index`.

Tolerances: int8 codes equal exactly, and int8 MaxSim scores equal exactly
(integer products summed exactly on both sides, the per-token scaling and
the sum over query tokens in the same f32 order); f32 scores within 1e-5
(sums in other orders) and 1e-4 against the numpy reference; after a PCA
projection (columns equal up to sign) the codes are built from the port's
own basis, and scores agree with JAX's within 0.02 of their scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tests.torch_helpers import np_of
from vod_tpu.search.maxsim import build_maxsim_index as jax_build
from vod_tpu.search.maxsim import maxsim_rerank as jax_rerank
from vod_tpu_torch.search import (
    SearchQueries,
    build_dense_index,
    build_maxsim_index,
    dense_search,
    maxsim_rerank,
    maxsim_search,
)
from vod_tpu_torch.search.maxsim import MaxSimIndex, _score_gathered


def _np_maxsim(q, qm, d, dm):
    s = q @ d.T
    s = np.where(dm[None, :], s, -np.inf)
    best = np.where(dm.any(), s.max(axis=1), 0.0)
    return float(np.sum(np.where(qm, best, 0.0)))


def _toy(n=64, lt=6, lq=4, d=16, seed=0):
    rng = np.random.default_rng(seed)
    tok = rng.standard_normal((n, lt, d)).astype(np.float32)
    tok /= np.linalg.norm(tok, axis=-1, keepdims=True)
    dm = rng.random((n, lt)) > 0.2
    dm[:, 0] = True
    q = rng.standard_normal((2, lq, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    qm = np.ones((2, lq), bool)
    qm[1, -1] = False
    return tok, dm, q, qm, rng


def test_maxsim_rerank_matches_numpy_reference_and_jax():
    tok, dm, q, qm, rng = _toy()
    dm[5] = False  # a doc with no real token scores 0
    idx = build_maxsim_index(torch.from_numpy(tok), torch.from_numpy(dm), codec="float32")
    cand = rng.integers(0, tok.shape[0], (2, 8)).astype(np.int32)
    cand[0, -1], cand[1, 0] = -1, 5
    scores = np_of(maxsim_rerank(idx, torch.from_numpy(q), torch.from_numpy(qm), torch.from_numpy(cand)))
    for b in range(2):
        for c in range(8):
            cid = int(cand[b, c])
            if cid < 0:
                assert scores[b, c] == -np.inf
            else:
                assert np.isclose(scores[b, c], _np_maxsim(q[b], qm[b], tok[cid], dm[cid]), atol=1e-4)
    assert scores[1, 0] == 0.0
    jidx = jax_build(jnp.asarray(tok), jnp.asarray(dm), codec="float32")
    want = np_of(jax_rerank(jidx, jnp.asarray(q), jnp.asarray(qm), jnp.asarray(cand)))
    np.testing.assert_array_equal(np.isneginf(scores), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(scores[fin], want[fin], atol=1e-5, rtol=0)


def test_int8_codes_and_scores_equal_jax_exactly():
    tok, dm, q, qm, rng = _toy(n=128, d=32)
    cand = rng.integers(-1, 128, (2, 16)).astype(np.int32)
    idx = build_maxsim_index(torch.from_numpy(tok), torch.from_numpy(dm), codec="int8", offset=0)
    jidx = jax_build(jnp.asarray(tok), jnp.asarray(dm), codec="int8")
    np.testing.assert_array_equal(np_of(idx.token_codes), np_of(jidx.token_codes))
    np.testing.assert_array_equal(np_of(idx.scale), np_of(jidx.scale))
    got = np_of(maxsim_rerank(idx, torch.from_numpy(q), torch.from_numpy(qm), torch.from_numpy(cand)))
    want = np_of(jax_rerank(jidx, jnp.asarray(q), jnp.asarray(qm), jnp.asarray(cand)))
    np.testing.assert_array_equal(got, want)
    # `_score_gathered` on the gathered block is the same function on the card and the CPU
    local = torch.from_numpy(np.clip(cand, 0, 127)).long()
    block = _score_gathered(idx.token_codes[local], idx.token_mask[local], torch.from_numpy(q), torch.from_numpy(qm),
                            idx.scale)
    np.testing.assert_array_equal(np.where(cand >= 0, np_of(block), -np.inf), got)


def test_maxsim_int8_and_pca_codecs_track_f32():
    tok, dm, q, qm, rng = _toy(n=128)
    cand = torch.from_numpy(rng.integers(0, 128, (2, 16)).astype(np.int32))
    t, m, qq, qqm = map(torch.from_numpy, (tok, dm, q, qm))
    s_f = np_of(maxsim_rerank(build_maxsim_index(t, m, codec="float32"), qq, qqm, cand))
    s_i = np_of(maxsim_rerank(build_maxsim_index(t, m, codec="int8"), qq, qqm, cand))
    assert np.max(np.abs(s_f - s_i)) < 0.05 * np.max(np.abs(s_f))
    assert np.array_equal(s_f.argmax(axis=1), s_i.argmax(axis=1))
    pca = build_maxsim_index(t, m, codec="int8", proj_dim=8)
    assert pca.token_codes.shape[-1] == 8 and pca.proj is not None and pca.proj.shape == (16, 8)
    s_p = np_of(maxsim_rerank(pca, qq, qqm, cand))
    assert np.all(np.isfinite(s_p))
    jpca = jax_build(jnp.asarray(tok), jnp.asarray(dm), codec="float32", proj_dim=8)
    s_j = np_of(jax_rerank(jpca, jnp.asarray(q), jnp.asarray(qm), jnp.asarray(np_of(cand))))
    pf = np_of(maxsim_rerank(build_maxsim_index(t, m, codec="float32", proj_dim=8), qq, qqm, cand))
    # a PCA column may flip its sign; MaxSim scores are invariant to that
    np.testing.assert_allclose(pf, s_j, atol=0.02 * np.abs(s_j).max())
    np.testing.assert_allclose(s_p, pf, atol=0.05 * np.abs(pf).max())


def test_maxsim_two_stage_beats_pooled_on_multi_topic_docs():
    rng = np.random.default_rng(1)
    n, lt, d, b = 256, 4, 32, 16
    topics = rng.standard_normal((64, d)).astype(np.float32)
    topics /= np.linalg.norm(topics, axis=-1, keepdims=True)
    doc_topics = rng.integers(0, 64, (n, 2))
    tok = np.zeros((n, lt, d), np.float32)
    for i in range(n):
        for j in range(lt):
            tok[i, j] = topics[doc_topics[i, j % 2]] + 0.05 * rng.standard_normal(d)
    dm = np.ones((n, lt), bool)
    gold = rng.integers(0, n, b)
    q = np.zeros((b, 2, d), np.float32)
    for i, g in enumerate(gold):
        q[i, 0] = topics[doc_topics[g, 0]] + 0.05 * rng.standard_normal(d)
        q[i, 1] = topics[doc_topics[g, 1]] + 0.05 * rng.standard_normal(d)
    qm = np.ones((b, 2), bool)
    gt = np.array([np.argmax([_np_maxsim(q[i], qm[i], tok[j], dm[j]) for j in range(n)]) for i in range(b)])
    ms_idx = build_maxsim_index(torch.from_numpy(tok), torch.from_numpy(dm), codec="float32")
    pooled_idx = build_dense_index(torch.from_numpy(tok.mean(axis=1)), dtype="float32", device="cpu")
    first = lambda qq, k: dense_search(pooled_idx, qq, k)  # noqa: E731
    out = maxsim_search(first, ms_idx, SearchQueries(vector=torch.from_numpy(q.mean(axis=1))), torch.from_numpy(q),
                        torch.from_numpy(qm), 5, n_candidates=64)
    assert float(np.mean(np_of(out.indices)[:, 0] == gt)) >= 0.9
    assert np.all(np.diff(np_of(out.scores), axis=1) <= 1e-6)
    # top_k above the candidate count pads with -inf / -1
    small = maxsim_search(first, ms_idx, SearchQueries(vector=torch.from_numpy(q.mean(axis=1))), torch.from_numpy(q),
                          torch.from_numpy(qm), 6, n_candidates=4)
    assert (np_of(small.indices)[:, 4:] == -1).all() and np.isneginf(np_of(small.scores)[:, 4:]).all()


def test_ranker_token_embeddings_feed_maxsim():
    """`Ranker.encode_field_tokens` -> `build_maxsim_index`: L2-normalized
    tokens with padding zeroed, equal to JAX's on carried weights."""
    from vod_tpu.models import Ranker as JaxRanker
    from vod_tpu.models import RetrievalGradients as JaxRG
    from vod_tpu.models import TransformerEncoderConfig as JaxCfg
    from vod_tpu.models import VodPoolerConfig as JaxPool
    from vod_tpu_torch.models import (
        Ranker,
        RetrievalGradients,
        TransformerEncoderConfig,
        VodPoolerConfig,
        system_flax_to_state_dict,
    )

    widths = dict(vocab_size=64, hidden_size=32, num_layers=1, num_heads=2, intermediate_size=64)
    jmodel = JaxRanker(cfg=JaxCfg(dtype=jnp.float32, pooler=JaxPool(agg_method="mean", output_norm="l2"), **widths),
                       gradients=JaxRG())
    rng = np.random.default_rng(0)
    ids = rng.integers(1, 64, (3, 10)).astype(np.int32)
    mask = np.ones((3, 10), np.int32)
    mask[0, -2:] = 0
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(0), jnp.asarray(ids), jnp.asarray(mask),
                                        method=JaxRanker.encode_field))
    model = Ranker(TransformerEncoderConfig(dtype=torch.float32, pooler=VodPoolerConfig(agg_method="mean",
                                                                                        output_norm="l2"), **widths),
                   RetrievalGradients(), device="cpu")
    model.load_state_dict(system_flax_to_state_dict(params))
    with torch.no_grad():
        toks = model.encode_field_tokens(torch.from_numpy(ids), torch.from_numpy(mask))
    want = jmodel.apply(params, jnp.asarray(ids), jnp.asarray(mask), method=JaxRanker.encode_field_tokens)
    assert toks.shape == (3, 10, 32)
    np.testing.assert_allclose(np_of(toks), np_of(want), atol=1e-5)
    norms = np.linalg.norm(np_of(toks), axis=-1)
    assert np.allclose(norms[0, -2:], 0) and np.allclose(norms[mask > 0], 1.0, atol=1e-5)
    idx = build_maxsim_index(toks, torch.from_numpy(mask), codec="int8")
    assert isinstance(idx, MaxSimIndex) and idx.n_real == 3
    scores = maxsim_rerank(idx, toks, torch.from_numpy(mask), torch.tensor([[0, 1], [1, 2], [2, -1]]))
    assert np.isfinite(np_of(scores)[0]).all() and np.isneginf(np_of(scores)[2, 1])


def test_maxsim_bench_runs_small_on_the_cpu_and_defaults_to_the_card():
    from vod_tpu_torch.examples import maxsim_bench

    assert maxsim_bench.parser().parse_args([]).device == "cuda"
    out = maxsim_bench.main(["--device", "cpu", "--n", "3000", "--n-topics", "128", "--blocks", "1", "--reps", "1",
                             "--b", "16"])
    assert out["rerank_block_equal"] and out["rerank_max_abs_err"] == 0.0 and out["top1_scores_equal"]
    assert out["recall"] > out["recall_pooled"] and out["card"] == "cpu" and out["ms_per_block"] > 0
