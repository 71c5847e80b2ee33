"""The port's SPLADE encoder and its paths (`vod_tpu_torch/models/splade.py`,
the SPLADE `Ranker`, the FLOPS loss in the train step and under GradCache,
the learned-impact index and the periodic reindex) against the JAX package,
mirroring `tests/test_splade.py`. JAX's init weights are carried over by
`models/convert.py` (`splade_flax_to_state_dict`, `system_flax_to_state_dict`).

Tolerances, f32 activations (sums in other orders): impacts within atol
2e-5 and rtol 1e-5; losses within 1e-5; gradients within atol 2e-5 plus
rtol 1e-4 (`test_torch_gradcache.py`'s bound); terms of the top-k equal
wherever the k-th and (k+1)-th impacts differ by more than 1e-4, and the
learned index built from JAX's and the port's terms equal cell for cell
there; against `transformers`' `BertForMaskedLM`, JAX's bound (atol 2e-4,
rtol 1e-3: the erf GELU against the tanh one).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_helpers import CPU, np_of
from vod_tpu.models.encoder import TransformerEncoderConfig as JaxEncCfg
from vod_tpu.models.gradients import RetrievalGradients as JaxRetrievalGradients
from vod_tpu.models.splade import SpladeEncoder as JaxSplade
from vod_tpu.models.splade import encode_corpus_terms as jax_encode_corpus_terms
from vod_tpu.models.splade import port_splade_weights as jax_port_splade_weights
from vod_tpu.models.splade import splade_topk_terms as jax_topk_terms
from vod_tpu.models.systems import Ranker as JaxRanker
from vod_tpu.runtime.gradcache import gradcache_value_and_grad
from vod_tpu.runtime.train import RealmTrainStep as JaxStep
from vod_tpu.search.sparse import build_impact_index as jax_build_impact_index
from vod_tpu.types import RealmBatch as JaxRealmBatch
from vod_tpu_torch.models import (
    Ranker,
    RetrievalGradients,
    SpladeEncoder,
    TransformerEncoderConfig,
    collect_losses,
    encode_corpus_terms,
    flops_loss,
    port_splade_weights,
    splade_doc_terms,
    splade_flax_to_state_dict,
    splade_topk_terms,
    system_flax_to_state_dict,
)
from vod_tpu_torch.runtime import gradcache_backward, make_train_step
from vod_tpu_torch.search import SearchQueries, build_impact_index, sparse_search
from tests.test_torch_train import _to_torch_batch

ATOL, RTOL = 2e-5, 1e-5
LOSS_ATOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 2e-5, 1e-4
MARGIN = 1e-4
TINY = dict(hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64, max_position_embeddings=64)


def _cfgs(vocab: int = 256):
    return (JaxEncCfg(vocab_size=vocab, dtype=jnp.float32, **TINY),
            TransformerEncoderConfig(vocab_size=vocab, dtype=torch.float32, **TINY))


def _encoders(vocab: int = 256, seed: int = 0, flops_weight: float = 0.0):
    """JAX's SpladeEncoder with its init params, and the port's carrying them."""
    jcfg, tcfg = _cfgs(vocab)
    jmodel = JaxSplade(jcfg)
    ids = jnp.full((1, 4), 5, jnp.int32)
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(seed), ids, jnp.ones_like(ids))["params"])
    # a non-zero decoder bias, so the carried bias is exercised
    params["decoder_bias"] = np.random.default_rng(seed).normal(0, 0.5, vocab).astype(np.float32)
    model = SpladeEncoder(tcfg, flops_weight=flops_weight, device=CPU)
    model.load_state_dict(splade_flax_to_state_dict(params))
    return jmodel, params, model


def _tokens(rng, n: int, length: int, vocab: int, pad_from: int | None = None):
    ids = rng.integers(5, vocab, (n, length)).astype(np.int32)
    mask = np.ones((n, length), np.int32)
    if pad_from is not None:
        mask[:, pad_from:] = 0
    return ids, mask


def test_splade_impacts_nonnegative_padding_invariant_and_equal_to_jax():
    jmodel, params, model = _encoders()
    rng = np.random.default_rng(0)
    ids, mask = _tokens(rng, 3, 10, 256, pad_from=7)
    mask[2, 1:] = 0  # one valid token
    with torch.no_grad():
        imp = model(torch.from_numpy(ids), torch.from_numpy(mask))
    want = jmodel.apply({"params": params}, jnp.asarray(ids), jnp.asarray(mask))
    assert imp.shape == (3, 256) and imp.dtype == torch.float32 and (imp >= 0).all()
    np.testing.assert_allclose(np_of(imp), np_of(want), atol=ATOL, rtol=RTOL)
    ids2 = ids.copy()
    ids2[:, 7:] = rng.integers(5, 256, (3, 3))
    with torch.no_grad():
        imp2 = model(torch.from_numpy(ids2), torch.from_numpy(mask))
    np.testing.assert_array_equal(np_of(imp), np_of(imp2))


def test_splade_topk_terms_pads_zero_impacts_and_ties_to_the_lowest_id():
    imp = torch.tensor([[0.0, 2.0, 0.0, 1.0], [0.0, 0.0, 0.0, 0.0]])
    terms, weights = splade_topk_terms(imp, 3)
    assert terms.dtype == torch.int32 and terms.tolist() == [[1, 3, -1], [-1, -1, -1]]
    assert weights.tolist() == [[2.0, 1.0, 0.0], [0.0, 0.0, 0.0]]
    # exact ties (common with bf16 logits) break to the lowest id, as lax.top_k does
    tied = np.random.default_rng(1).integers(0, 4, (6, 50)).astype(np.float32) / 4
    t, w = splade_topk_terms(torch.from_numpy(tied), 12)
    jt, jw = jax_topk_terms(jnp.asarray(tied), 12)
    np.testing.assert_array_equal(np_of(t), np_of(jt))
    np.testing.assert_array_equal(np_of(w), np_of(jw))
    dt, dw = splade_doc_terms(tied, 12)
    assert isinstance(dt, np.ndarray) and np.array_equal(dt, np_of(jt)) and np.array_equal(dw, np_of(jw))


def test_splade_head_matches_torch_masked_lm_and_jax_port():
    """A random `BertForMaskedLM` through `port_splade_weights`: impacts equal
    max_t log1p(relu(logits)) over valid tokens, and JAX's port of the same
    checkpoint."""
    import transformers

    from vod_tpu.models.hf_import import config_from_hf as jax_config_from_hf
    from vod_tpu_torch.models import config_from_hf

    hf_cfg = transformers.BertConfig(vocab_size=128, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
                                     intermediate_size=64, max_position_embeddings=64, type_vocab_size=2)
    torch.manual_seed(0)
    tmodel = transformers.BertForMaskedLM(hf_cfg).eval()
    sd = tmodel.state_dict()
    cfg = config_from_hf(hf_cfg)
    model = SpladeEncoder(cfg, device=CPU)
    model.load_state_dict(port_splade_weights(sd, cfg))
    rng = np.random.default_rng(1)
    ids, mask = _tokens(rng, 3, 12, 128, pad_from=9)
    with torch.no_grad():
        logits = tmodel(input_ids=torch.from_numpy(ids).long(), attention_mask=torch.from_numpy(mask).long()).logits
        got = model(torch.from_numpy(ids), torch.from_numpy(mask))
    expect = (np.log1p(np.maximum(logits.numpy(), 0.0)) * mask[..., None]).max(axis=1)
    np.testing.assert_allclose(np_of(got), expect, atol=2e-4, rtol=1e-3)
    jcfg = jax_config_from_hf(hf_cfg)
    jparams = jax_port_splade_weights(sd, jcfg)
    jgot = JaxSplade(jcfg).apply({"params": jparams}, jnp.asarray(ids), jnp.asarray(mask))
    np.testing.assert_allclose(np_of(got), np_of(jgot), atol=ATOL, rtol=RTOL)


def _sparse_rows(terms: np.ndarray, weights: np.ndarray, n_terms: int) -> np.ndarray:
    out = np.zeros((terms.shape[0], n_terms), np.float32)
    rows = np.repeat(np.arange(terms.shape[0]), terms.shape[1])
    keep = terms.ravel() >= 0
    out[rows[keep], terms.ravel()[keep]] = weights.ravel()[keep]
    return out


def test_impact_index_search_matches_bruteforce_dot():
    rng = np.random.default_rng(2)
    n_docs, n_terms, k_doc, b, k_query = 40, 64, 8, 5, 6
    doc_terms = np.stack([rng.choice(n_terms, size=k_doc, replace=False) for _ in range(n_docs)])
    doc_w = rng.uniform(0.1, 2.0, (n_docs, k_doc)).astype(np.float32)
    doc_terms[:, -1] = -1
    q_terms = np.stack([rng.choice(n_terms, size=k_query, replace=False) for _ in range(b)]).astype(np.int32)
    q_w = rng.uniform(0.1, 2.0, (b, k_query)).astype(np.float32)
    expect = _sparse_rows(q_terms, q_w, n_terms) @ _sparse_rows(doc_terms, doc_w, n_terms).T
    index = build_impact_index(doc_terms, doc_w, n_terms=n_terms, max_postings=n_docs, device=CPU)
    jindex = jax_build_impact_index(doc_terms, doc_w, n_terms=n_terms, max_postings=n_docs)
    np.testing.assert_array_equal(np_of(index.postings_docs), np_of(jindex.postings_docs))
    np.testing.assert_array_equal(np_of(index.postings_impacts), np_of(jindex.postings_impacts))
    out = sparse_search(index, SearchQueries(terms=torch.from_numpy(q_terms), term_weights=torch.from_numpy(q_w)),
                        top_k=10)
    scores, idx = np_of(out.scores), np_of(out.indices)
    for i in range(b):
        order = np.argsort(-expect[i], kind="stable")
        hits = order[expect[i][order] > 0][:10]
        got = idx[i][idx[i] >= 0]
        assert len(got) == len(hits) and set(got) == set(hits)
        np.testing.assert_allclose(scores[i][: len(got)], expect[i, got], rtol=1e-5)
        assert got[0] == hits[0]


def test_impact_index_truncation_keeps_highest_impacts():
    doc_terms = np.asarray([[0], [0], [0], [1]])
    doc_w = np.asarray([[1.0], [3.0], [2.0], [5.0]], np.float32)
    index = build_impact_index(doc_terms, doc_w, n_terms=2, max_postings=2, device=CPU)
    assert index.postings_docs.tolist() == [[1, 2], [3, -1]]
    assert index.postings_impacts.tolist()[0] == [3.0, 2.0]


def _margin_ok(weights: np.ndarray, impacts: np.ndarray, k: int) -> np.ndarray:
    """Rows whose k-th impact exceeds the (k+1)-th by more than MARGIN: their
    top-k term set is decided outside the tolerance."""
    srt = -np.sort(-impacts, axis=-1)
    return (srt[:, k - 1] - srt[:, k]) > MARGIN


def test_encode_corpus_terms_and_learned_index_equal_jax():
    """Chunked corpus encode with top-k on the device -> `build_impact_index`
    -> `sparse_search` in the port, the same pipeline in JAX: the terms,
    their weights and the learned index agree, and search equals the
    brute-force dot of the sparsified vectors."""
    jmodel, params, model = _encoders(vocab=128, seed=1)
    rng = np.random.default_rng(4)
    n, length, k_doc, k_query = 30, 10, 16, 8
    c_ids, c_mask = _tokens(rng, n, length, 128)
    c_mask[::4, 6:] = 0
    apply_fn = lambda p, i, m: jmodel.apply({"params": p}, i, m)  # noqa: E731
    jterms, jweights = jax_encode_corpus_terms(apply_fn, params, jnp.asarray(c_ids), jnp.asarray(c_mask), k=k_doc,
                                               chunk=8)
    terms, weights = encode_corpus_terms(model, torch.from_numpy(c_ids), torch.from_numpy(c_mask), k=k_doc, chunk=7)
    assert terms.shape == (n, k_doc) and terms.dtype == np.int32 and weights.dtype == np.float32
    impacts = np_of(apply_fn(params, jnp.asarray(c_ids), jnp.asarray(c_mask)))
    ok = _margin_ok(jweights, impacts, k_doc)
    assert ok.mean() > 0.8
    np.testing.assert_array_equal(np.sort(terms[ok], axis=1), np.sort(jterms[ok], axis=1))
    np.testing.assert_allclose(weights, jweights, atol=ATOL, rtol=RTOL)
    index = build_impact_index(terms[ok], weights[ok], n_terms=128, max_postings=n, device=CPU)
    jindex = jax_build_impact_index(jterms[ok], jweights[ok], n_terms=128, max_postings=n)
    np.testing.assert_array_equal(np_of(index.postings_docs), np_of(jindex.postings_docs))
    np.testing.assert_allclose(np_of(index.postings_impacts), np_of(jindex.postings_impacts), atol=ATOL, rtol=RTOL)

    q_ids, q_mask = _tokens(rng, 3, length, 128)
    with torch.no_grad():
        q_terms, q_weights = splade_topk_terms(model(torch.from_numpy(q_ids), torch.from_numpy(q_mask)), k_query)
    full = build_impact_index(terms, weights, n_terms=128, max_postings=n, device=CPU)
    out = sparse_search(full, SearchQueries(terms=q_terms, term_weights=q_weights), top_k=5)
    expect = _sparse_rows(np_of(q_terms), np_of(q_weights), 128) @ _sparse_rows(terms, weights, 128).T
    idx, scores = np_of(out.indices), np_of(out.scores)
    for i in range(3):
        best = np.argsort(-expect[i], kind="stable")[:5]
        if expect[i, best[0]] > 0:
            assert idx[i, 0] == best[0]
            np.testing.assert_allclose(scores[i, 0], expect[i, best[0]], rtol=1e-4)


def test_flops_loss_zero_iff_inactive():
    imp = torch.zeros((4, 8))
    assert float(flops_loss(imp)) == 0.0
    imp[:, 3] = 1.0
    assert float(flops_loss(imp)) == pytest.approx(1.0)


def _ranker_batch(seed: int = 3, b: int = 2, d: int = 4, lq: int = 8, ls: int = 8, vocab: int = 256):
    rng = np.random.default_rng(seed)
    rel = np.zeros((b, d), np.float32)
    rel[:, 0] = 1.0
    s_mask = np.ones((b * d, ls), np.int32)
    s_mask[1::3, 5:] = 0
    return JaxRealmBatch(
        query__input_ids=jnp.asarray(rng.integers(5, vocab, (b, lq)).astype(np.int32)),
        query__attention_mask=jnp.ones((b, lq), jnp.int32),
        section__input_ids=jnp.asarray(rng.integers(5, vocab, (b * d, ls)).astype(np.int32)),
        section__attention_mask=jnp.asarray(s_mask),
        section__relevance=jnp.asarray(rel),
        section__idx=jnp.asarray(rng.integers(0, 1000, (b, d)).astype(np.int32)),
        section__score=jnp.asarray(rng.normal(size=(b, d)).astype(np.float32)),
        section__sparse=jnp.asarray(rng.normal(size=(b, d)).astype(np.float32)),
        section__dense=jnp.asarray(rng.normal(size=(b, d)).astype(np.float32)),
        section__log_weight=jnp.asarray(np.log(np.full((b, d), 1.0 / d, np.float32))),
        section__lse_pos=jnp.zeros((b,), jnp.float32),
        section__lse_neg=jnp.zeros((b,), jnp.float32),
    )


def _rankers(flops_weight: float):
    jcfg, tcfg = _cfgs()
    jmodel = JaxRanker(cfg=jcfg, gradients=JaxRetrievalGradients(), splade_encoder=True,
                       splade_flops_weight=flops_weight)
    jbatch = _ranker_batch()
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(0), jbatch))
    model = Ranker(tcfg, RetrievalGradients(), splade_encoder=True, splade_flops_weight=flops_weight, device=CPU)
    model.load_state_dict(system_flax_to_state_dict(params))
    return jmodel, params, jbatch, model, _to_torch_batch(jbatch)


def _assert_grads_close(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for name, g in got.items():
        np.testing.assert_allclose(np_of(g), np_of(want[name]), atol=GRAD_ATOL, rtol=GRAD_RTOL, err_msg=name)


def test_splade_ranker_loss_with_flops_equals_jax():
    """The train step's loss pass: the estimator's loss plus the sown FLOPS
    term over the fused query + section impacts, and its gradients, against
    JAX's `RealmTrainStep._loss` under `value_and_grad`; the FLOPS term is
    positive, and nothing is sown outside `collect_losses`."""
    jmodel, params, jbatch, model, batch = _rankers(1e-3)
    jstep = JaxStep(jmodel, None)
    (jloss, jout), jgrads = jax.value_and_grad(jstep._loss, has_aux=True)(params, jbatch)
    step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=0.0))
    loss, out = step.loss(batch)
    loss.backward()
    np.testing.assert_allclose(np_of(loss), np_of(jloss), atol=LOSS_ATOL, rtol=0)
    np.testing.assert_allclose(np_of(out.loss), np_of(jout.loss), atol=LOSS_ATOL, rtol=0)
    assert float(loss.detach() - out.loss.detach()) > 0.0  # the FLOPS term rides in the loss
    _assert_grads_close({n: p.grad for n, p in model.named_parameters()},
                        system_flax_to_state_dict(jax.device_get(jgrads)))
    assert float(model.encoder.transform.weight.grad.abs().max()) > 0.0
    assert model.encoder.sown is None
    with torch.no_grad():
        model.encode_field(batch.query__input_ids, batch.query__attention_mask)
    with collect_losses(model) as sown:
        model.encode_field(batch.query__input_ids, batch.query__attention_mask)
    assert len(sown) == 1 and float(sown[0]) > 0.0


@pytest.mark.parametrize("chunk_rows", [4, 10, 16])  # 10 rows: padded to 12 at 4, one chunk at 10 and 16
def test_splade_gradcache_equals_jax(chunk_rows: int):
    """The FLOPS term under GradCache is per chunk (padding rows included)
    and summed, as in JAX: loss and gradients equal JAX's
    `gradcache_value_and_grad`."""
    jmodel, params, jbatch, model, batch = _rankers(1e-2)
    @jax.jit
    def run(p, b):
        (loss, _), grads = gradcache_value_and_grad(jmodel, p, b, chunk_rows=chunk_rows)
        return loss, grads

    jloss, jgrads = run(params, jbatch)
    model.zero_grad(set_to_none=True)
    out = gradcache_backward(model, batch, chunk_rows=chunk_rows)
    np.testing.assert_allclose(np_of(out.loss), np_of(jloss), atol=LOSS_ATOL, rtol=0)
    _assert_grads_close({n: p.grad for n, p in model.named_parameters()},
                        system_flax_to_state_dict(jax.device_get(jgrads)))


def test_splade_live_retrieval_searches_the_query_impacts():
    """`splade_query_k`: the collate's sparse scores are the learned index's
    scores of the current encoder's top-k query terms; JAX's
    `splade_topk_terms` of the same impacts gives the same terms."""
    from vod_tpu_torch.ops.numpy_ops import normalize_scores
    from vod_tpu_torch.runtime import QueryBatch, build_device_corpus
    from vod_tpu_torch.search import HybridEngines

    jmodel, params, _, model, _ = _rankers(1e-3)
    rng = np.random.default_rng(7)
    ids, mask = _tokens(rng, 24, 8, 256)
    terms, weights = encode_corpus_terms(model.encode_field, torch.from_numpy(ids), torch.from_numpy(mask), k=32)
    index = build_impact_index(terms, weights, n_terms=256, max_postings=24, device=CPU)
    corpus = build_device_corpus(ids, mask, device=CPU)
    q_ids, q_mask = _tokens(rng, 3, 8, 256)
    queries = QueryBatch(torch.from_numpy(q_ids), torch.from_numpy(q_mask),
                         section_ids=torch.tensor([[0], [5], [9]], dtype=torch.int32))
    step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=0.0), splade_query_k=16, prefetch=8,
                           n_sections=4)
    batch = step.collate(HybridEngines(sparse=index), corpus, queries, torch.Generator().manual_seed(0), None)
    with torch.no_grad():
        q_terms, q_w = splade_topk_terms(model.encode_field(queries.input_ids, queries.attention_mask), 16)
    jq = jmodel.apply({"params": params["params"]}, jnp.asarray(q_ids), jnp.asarray(q_mask),
                      method=JaxRanker.encode_field)
    jt, _ = jax_topk_terms(jq, 16)
    np.testing.assert_array_equal(np.sort(np_of(q_terms), 1), np.sort(np_of(jt), 1))
    # the collate searches at the prefetch width and normalizes each row by its minimum
    direct = sparse_search(index, SearchQueries(terms=q_terms, term_weights=q_w), top_k=8)
    want = normalize_scores(direct.scores)
    for r in range(3):
        pos = {i: c for c, i in enumerate(direct.indices[r].tolist()) if i >= 0}
        for sid, raw in zip(batch.section__idx[r].tolist(), batch.section__sparse[r].tolist()):
            if sid in pos and not np.isnan(raw):
                assert raw == pytest.approx(float(want[r, pos[sid]]), abs=1e-6), (r, sid)
    assert not torch.isnan(batch.section__sparse).all()
    assert torch.isnan(batch.section__dense).all()


def _splade_raw(**trainer) -> dict:
    from tests.test_torch_cli import _raw

    return _raw(
        model={"splade_encoder": True, "splade_flops_weight": 1e-4, "splade_query_k": 16, "splade_doc_k": 24},
        collate={"temperature": 0.0},
        trainer={"optimizer": "sgd", "learning_rate": 0.5, "max_steps": 2, "period": 1,
                 "parameters": {"dense": {"mode": "constant", "value": 1.0},
                                "sparse": {"mode": "constant", "value": 1.0}}, **trainer},
    )


def test_splade_run_experiment_matches_jax(monkeypatch):
    """One SPLADE config through both runners (two periods, each rebuilding
    the learned index from the current encoder, no dense engine): JAX's
    initial weights carried across, sampling temperature 0, SGD; the two
    steps' losses (the FLOPS term included) agree within 1e-5."""
    from tests.test_exps import _toy_data
    from tests.helpers import tiny_tokenizer
    from tests.test_torch_cli import _capture_jax_init, _carry_into_port, _f32, _port_tok
    from vod_tpu.exps import cli as jax_cli
    from vod_tpu.exps.structconf import Experiment as JaxExperiment
    from vod_tpu_torch.exps import cli
    from vod_tpu_torch.exps.structconf import Experiment

    sections, queries = _toy_data(n_sections=24, n_queries=16)
    raw = _splade_raw()
    _f32(monkeypatch)
    seen = _capture_jax_init(monkeypatch)
    jlogs, tlogs = [], []
    jout = jax_cli.run_experiment(JaxExperiment.parse(raw), sections=sections, queries=queries,
                                  tokenizer=tiny_tokenizer(), on_log=lambda s, m: jlogs.append(m))
    _carry_into_port(monkeypatch, seen)
    out = cli.run_experiment(Experiment.parse(raw), sections=sections, queries=queries, tokenizer=_port_tok(),
                             on_log=lambda s, m: tlogs.append(m), device="cpu")
    assert isinstance(out["model"].encoder, SpladeEncoder) and out["step_fn"].splade_query_k == 16
    assert out["state"].step == 2 and len(out["history"]) == len(jout["history"]) == 2
    assert all("learned_terms" in h for h in out["history"])
    assert len(jlogs) == len(tlogs) == 2
    for j, t in zip(jlogs, tlogs):
        assert t["loss"] == pytest.approx(j["loss"], abs=LOSS_ATOL)


def test_splade_cli_runs_on_the_beir_fixture(tmp_path, capsys):
    """`python -m vod_tpu_torch.exps.cli` with a SPLADE ranker over
    `tests/fixtures/beir_tiny`: two periods, each reindexing the learned
    impacts; BM25 is built but not searched, as in JAX; finite losses."""
    from tests.test_torch_cli import _write_cli_inputs
    from vod_tpu_torch.exps import cli, recipes

    cfg = _write_cli_inputs(tmp_path)
    text = cfg.read_text().replace("extends: [model/realm-vod]\n", "")
    text = text.replace("model: {", "model: {kind: ranker, gradients: retrieval, splade_encoder: true, "
                                     "splade_flops_weight: 1.0e-4, splade_query_k: 16, splade_doc_k: 24, ")
    cfg.write_text(text)
    seen = []
    real = recipes.training_loop

    def loop(**kw):
        seen.append(kw["engines"])
        return real(**kw)

    recipes.training_loop = loop
    try:
        out = cli.main(["--config", str(cfg), "--device", "cpu"])
    finally:
        recipes.training_loop = real
    assert out["state"].step == 2 and [h["period"] for h in out["history"]] == [0, 1]
    assert all(e.dense is None and e.sparse is not None for e in seen) and seen[0] is not seen[1]
    assert int(seen[0].sparse.postings_docs.shape[0]) == out["model"].cfg.vocab_size
    logs = [line for line in capsys.readouterr().out.splitlines() if line.startswith("[")]
    assert len(logs) == 2 and all(np.isfinite(float(line.split("'loss': ")[1].split(",")[0])) for line in logs)
