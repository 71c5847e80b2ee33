"""The port's cross-encoder (`vod_tpu_torch/models/cross_encoder.py`), its
teacher scores for `DistillationGradients`, and pair tokenization in the
port's WordPiece tokenizer, against the JAX package, mirroring
`tests/test_cross_encoder.py` and the teacher cases of `tests/test_distill.py`.
JAX's init weights come over by `models/convert.py:cross_encoder_flax_to_state_dict`.

Tolerances, f32 (sums in other orders): scores within atol 2e-5 and rtol
1e-5; re-ranked ids equal wherever neighbouring scores differ by more than
1e-4; losses within 1e-5; against `transformers`' classifier, JAX's bound
(2e-4: the erf GELU against the tanh one). Token ids, masks and segment ids
equal exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helpers import _VOCAB, tiny_tokenizer
from tests.test_torch_train import _to_torch_batch
from tests.torch_helpers import CPU, np_of
from vod_tpu.models import cross_encoder as jce
from vod_tpu.models.encoder import TransformerEncoderConfig as JaxEncCfg
from vod_tpu.types import RealmBatch as JaxRealmBatch
from vod_tpu.types.retrieval import RetrievalBatch as JaxRetrievalBatch
from vod_tpu_torch.data.tokenizer import WordPieceTokenizer
from vod_tpu_torch.models import (
    CrossEncoder,
    DistillationGradients,
    Ranker,
    TransformerEncoderConfig,
    cross_encoder_flax_to_state_dict,
    cross_encoder_rerank,
    cross_encoder_scores,
    fill_teacher_scores,
    listwise_rerank_loss,
    port_bert_cross_encoder_weights,
    tokenize_pairs,
)
from vod_tpu_torch.types import RealmBatch, RetrievalBatch

ATOL, RTOL = 2e-5, 1e-5
LOSS_ATOL = 1e-5
MARGIN = 1e-4
TINY = dict(hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64, max_position_embeddings=64)


def _pair(vocab: int = 256, seed: int = 0, length: int = 12):
    jmodel = jce.CrossEncoder(JaxEncCfg(vocab_size=vocab, dtype=jnp.float32, **TINY))
    ids = jnp.full((2, length), 5, jnp.int32)
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(seed), ids, jnp.ones_like(ids), jnp.zeros_like(ids)))
    # a classifier that is not near zero, so the scores spread
    params["params"]["classifier"]["kernel"] = np.random.default_rng(seed).normal(0, 1, (32, 1)).astype(np.float32)
    model = CrossEncoder(TransformerEncoderConfig(vocab_size=vocab, dtype=torch.float32, **TINY), device=CPU)
    model.load_state_dict(cross_encoder_flax_to_state_dict(params))
    return jmodel, params, model


def _grid(rng, b: int, c: int, length: int, vocab: int = 256):
    ids = rng.integers(5, vocab, (b, c, length)).astype(np.int32)
    mask = np.ones((b, c, length), np.int32)
    mask[:, 1::2, length - 3:] = 0
    types = np.zeros((b, c, length), np.int32)
    types[..., length // 2:] = 1
    return ids, mask, types


def test_scores_equal_jax_in_chunks():
    jmodel, params, model = _pair()
    ids, mask, types = _grid(np.random.default_rng(0), 3, 5, 12)
    apply_fn = lambda p, i, m, t: jmodel.apply(p, i, m, t)  # noqa: E731
    want = jce.cross_encoder_scores(apply_fn, params, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(types),
                                    chunk=4)
    for chunk in (4, 7, 256):
        with torch.no_grad():
            got = cross_encoder_scores(model, *map(torch.from_numpy, (ids, mask, types)), chunk=chunk)
        assert got.shape == (3, 5) and got.dtype == torch.float32
        np.testing.assert_allclose(np_of(got), np_of(want), atol=ATOL, rtol=RTOL)
    with torch.no_grad():  # without segment ids, as JAX's zeros
        got = cross_encoder_scores(model, torch.from_numpy(ids), torch.from_numpy(mask))
    want = jce.cross_encoder_scores(lambda p, i, m: jmodel.apply(p, i, m), params, jnp.asarray(ids), jnp.asarray(mask))
    np.testing.assert_allclose(np_of(got), np_of(want), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("top_k", [4, 9])  # 9 > C: the tail pads with -inf / -1
def test_rerank_orders_by_cross_scores_keeps_padding_last_and_equals_jax(top_k: int):
    jmodel, params, model = _pair()
    rng = np.random.default_rng(1)
    b, c, length = 2, 6, 12
    ids, mask, types = _grid(rng, b, c, length)
    indices = np.asarray([[3, 9, 4, -1, 7, -1], [5, 2, 8, 1, -1, -1]], np.int32)
    first = rng.standard_normal((b, c)).astype(np.float32)
    cand = RetrievalBatch(scores=torch.from_numpy(first), indices=torch.from_numpy(indices))
    with torch.no_grad():
        out = cross_encoder_rerank(model, cand, *map(torch.from_numpy, (ids, mask, types)), top_k=top_k, chunk=4)
    jout = jce.cross_encoder_rerank(lambda p, i, m, t: jmodel.apply(p, i, m, t), params,
                                    JaxRetrievalBatch(scores=jnp.asarray(first), indices=jnp.asarray(indices)),
                                    jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(types), top_k=top_k, chunk=4)
    assert out.indices.shape == (b, top_k)
    s, js = np_of(out.scores), np_of(jout.scores)
    np.testing.assert_array_equal(np.isfinite(s), np.isfinite(js))
    np.testing.assert_allclose(s[np.isfinite(s)], js[np.isfinite(js)], atol=ATOL, rtol=RTOL)
    gaps = np.abs(np.diff(np.where(np.isfinite(js), js, -1e9), axis=1))
    clear = np.ones_like(js, bool)
    clear[:, 1:] &= gaps > MARGIN
    clear[:, :-1] &= gaps > MARGIN
    np.testing.assert_array_equal(np_of(out.indices)[clear], np_of(jout.indices)[clear])
    for r, n_real in enumerate((4, 4)):
        got = np_of(out.indices[r])
        assert (got[: min(n_real, top_k)] >= 0).all() and (got[n_real:] == -1).all()
        fin = s[r][np.isfinite(s[r])]
        assert (np.diff(fin) <= 1e-6).all()


def test_listwise_loss_masks_and_averages():
    scores = torch.tensor([[2.0, 1.0, 0.0], [5.0, -1.0, 3.0]])
    labels = torch.tensor([[1, 0, -1], [0, -1, 0]])
    loss = listwise_rerank_loss(scores, labels)
    assert float(loss) == pytest.approx(-np.log(np.exp(2.0) / (np.exp(2.0) + np.exp(1.0))), rel=1e-5)
    rng = np.random.default_rng(2)
    s = rng.normal(size=(5, 6)).astype(np.float32)
    lab = rng.integers(-1, 2, (5, 6)).astype(np.int32)
    want = jce.listwise_rerank_loss(jnp.asarray(s), jnp.asarray(lab))
    assert float(listwise_rerank_loss(torch.from_numpy(s), torch.from_numpy(lab))) == pytest.approx(
        float(want), abs=LOSS_ATOL)


def test_cross_encoder_trains_to_separate_pairs():
    """A tiny cross-encoder learns the pair relevance the dual encoder cannot
    express: positives repeat the query's marker token."""
    torch.manual_seed(0)
    model = CrossEncoder(TransformerEncoderConfig(vocab_size=64, dtype=torch.float32, **TINY), device=CPU,
                         generator=torch.Generator().manual_seed(0))
    b, c, length = 8, 4, 10

    def make_batch(seed):
        r = np.random.default_rng(seed)
        ids = r.integers(10, 60, (b, c, length)).astype(np.int64)
        labels = np.zeros((b, c), np.int64)
        pos, marker = r.integers(0, c, b), r.integers(1, 10, b)
        for i in range(b):
            ids[i, :, 0] = marker[i]
            ids[i, pos[i], 1] = marker[i]
            labels[i, pos[i]] = 1
        return torch.from_numpy(ids), torch.from_numpy(labels)

    mask = torch.ones((b * c, length), dtype=torch.int64)
    opt = torch.optim.Adam(model.parameters(), lr=3e-3)
    losses = []
    for i in range(30):
        ids, labels = make_batch(i % 5)
        loss = listwise_rerank_loss(model(ids.reshape(b * c, length), mask).reshape(b, c), labels)
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.5, losses[::10]


def test_tokenize_pairs_equal_jax_with_both_tokenizers():
    """The port's `tokenize_pairs` over its own WordPiece tokenizer (the
    `text_pair` path) equals JAX's over `BertTokenizerFast`, truncation
    included; so does it over `BertTokenizerFast` itself."""
    queries = ["what is the capital of france", "who jumps over the lazy dog cat red green blue"]
    sections = [["paris is the capital", "tokyo city"], ["the quick brown fox jumps over the lazy dog", ""]]
    for max_length in (16, 9, 256):
        want = jce.tokenize_pairs(tiny_tokenizer(), queries, sections, max_length=max_length)
        for tok in (WordPieceTokenizer(_VOCAB), tiny_tokenizer()):
            got = tokenize_pairs(tok, queries, sections, max_length=max_length)
            assert set(got) == set(want) == {"input_ids", "attention_mask", "token_type_ids"}
            for k in want:
                assert got[k].dtype == np.int32 and got[k].shape == (2, 2, max_length)
                np.testing.assert_array_equal(got[k], want[k], err_msg=f"{k} at {max_length}")
    tt = want["token_type_ids"]
    assert tt[0, 0, 0] == 0 and tt.max() == 1
    with pytest.raises(ValueError, match="rectangular"):
        tokenize_pairs(WordPieceTokenizer(_VOCAB), ["a"], [["x", "y"], ["z"]])


@pytest.mark.parametrize("max_length", [3, 5, 8, 13, 40])
def test_wordpiece_text_pair_equals_bert_tokenizer_fast(max_length: int):
    """`text_pair` in the port's tokenizer: `[CLS] a [SEP] b [SEP]`, segment
    ids 0/1, `longest_first` truncation, against `BertTokenizerFast` on 200
    random pairs a length."""
    hf, port = tiny_tokenizer(), WordPieceTokenizer(_VOCAB)
    rng = np.random.default_rng(max_length)
    words = _VOCAB[5:]
    a = [" ".join(rng.choice(words, rng.integers(0, 20))) for _ in range(200)]
    b = [" ".join(rng.choice(words, rng.integers(0, 20))) for _ in range(200)]
    kw = dict(max_length=max_length, truncation="longest_first", padding="max_length", return_tensors="np")
    want, got = hf(a, b, **kw), port(a, b, **kw)
    for k in ("input_ids", "token_type_ids", "attention_mask"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    lists = port(a[:3], b[:3])  # no padding: lists, as the fast tokenizer gives
    ref = hf(a[:3], b[:3])
    assert {k: lists[k] for k in ("input_ids", "token_type_ids")} == {k: ref[k] for k in ("input_ids", "token_type_ids")}


def test_bert_classifier_port_parity():
    import transformers

    from vod_tpu.models.hf_import import config_from_hf as jax_config_from_hf
    from vod_tpu_torch.models import config_from_hf

    hf_cfg = transformers.BertConfig(vocab_size=128, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
                                     intermediate_size=64, max_position_embeddings=64, type_vocab_size=2,
                                     hidden_act="gelu", hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
                                     num_labels=1)
    torch.manual_seed(0)
    tmodel = transformers.BertForSequenceClassification(hf_cfg).eval()
    sd = tmodel.state_dict()
    cfg = config_from_hf(hf_cfg)
    model = CrossEncoder(cfg, device=CPU)
    model.load_state_dict(port_bert_cross_encoder_weights(sd, cfg))
    rng = np.random.default_rng(0)
    ids = rng.integers(1, 128, (3, 12))
    mask = np.ones((3, 12), np.int64)
    mask[2, 8:] = 0
    types = np.zeros((3, 12), np.int64)
    types[:, 6:] = 1
    with torch.no_grad():
        ref = tmodel(input_ids=torch.from_numpy(ids), attention_mask=torch.from_numpy(mask),
                     token_type_ids=torch.from_numpy(types)).logits[:, 0]
        got = model(*map(torch.from_numpy, (ids, mask, types)))
    np.testing.assert_allclose(np_of(got), np_of(ref), atol=2e-4)
    jcfg = jax_config_from_hf(hf_cfg)
    jgot = jce.CrossEncoder(jcfg).apply({"params": jce.port_bert_cross_encoder_weights(sd, jcfg)},
                                        *(jnp.asarray(x.astype(np.int32)) for x in (ids, mask, types)))
    np.testing.assert_allclose(np_of(got), np_of(jgot), atol=ATOL, rtol=RTOL)


def _distill_batch(scores: np.ndarray, teacher=None) -> JaxRealmBatch:
    b, d = scores.shape
    rng = np.random.default_rng(5)
    return JaxRealmBatch(
        query__input_ids=jnp.asarray(rng.integers(5, 64, (b, 6)).astype(np.int32)),
        query__attention_mask=jnp.ones((b, 6), jnp.int32),
        section__input_ids=jnp.asarray(rng.integers(5, 64, (b * d, 6)).astype(np.int32)),
        section__attention_mask=jnp.ones((b * d, 6), jnp.int32),
        section__relevance=jnp.zeros((b, d), jnp.float32),
        section__idx=jnp.zeros((b, d), jnp.int32),
        section__score=jnp.asarray(scores),
        section__sparse=jnp.zeros((b, d), jnp.float32),
        section__teacher_score=None if teacher is None else jnp.asarray(teacher),
    )


def test_fill_teacher_scores_aligns_masks_padding_and_equals_jax():
    jmodel, params, model = _pair(vocab=64, length=8)
    b, d, length = 2, 3, 8
    ids, mask, types = _grid(np.random.default_rng(0), b, d, length, vocab=64)
    scores = np.zeros((b, d), np.float32)
    scores[1, 2] = -np.inf  # a padding slot
    jbatch = _distill_batch(scores)
    apply_fn = lambda p, i, m, t: jmodel.apply(p, i, m, t)  # noqa: E731
    want = jce.fill_teacher_scores(apply_fn, params, jbatch, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(types),
                                   chunk=4).section__teacher_score
    batch = _to_torch_batch(jbatch)
    out = fill_teacher_scores(model, batch, *map(torch.from_numpy, (ids, mask, types)), chunk=4)
    ts = np_of(out.section__teacher_score)
    assert ts.shape == (b, d) and np.isneginf(ts[1, 2]) and np.isfinite(ts[0]).all()
    assert not out.section__teacher_score.requires_grad and batch.section__teacher_score is None
    np.testing.assert_allclose(ts, np_of(want), atol=ATOL, rtol=RTOL)
    with torch.no_grad():
        direct = model(*(torch.from_numpy(x.reshape(-1, length)) for x in (ids, mask, types))).reshape(b, d)
    np.testing.assert_allclose(ts[0], np_of(direct[0]), rtol=1e-5)


def test_teacher_scores_feed_distillation_and_move_the_student():
    """A cross-encoder teacher fills the scores that `DistillationGradients`
    (margin MSE) reads; the loss equals JAX's on the same batch and student,
    and Adam on it shrinks the margin gap."""
    from vod_tpu.models.gradients import DistillationGradients as JaxDistill
    from vod_tpu.models.systems import Ranker as JaxRanker
    from vod_tpu_torch.models import system_flax_to_state_dict

    _, tparams, teacher = _pair(vocab=64, seed=3, length=12)
    b, d = 2, 4
    jbatch = _distill_batch(np.zeros((b, d), np.float32))
    pairs = np.concatenate([np.repeat(np.asarray(jbatch.query__input_ids)[:, None], d, 1),
                            np.asarray(jbatch.section__input_ids).reshape(b, d, -1)], axis=-1)
    types = np.concatenate([np.zeros((b, d, 6), np.int32), np.ones((b, d, 6), np.int32)], axis=-1)
    batch = fill_teacher_scores(teacher, _to_torch_batch(jbatch), torch.from_numpy(pairs),
                                torch.ones_like(torch.from_numpy(pairs)), torch.from_numpy(types))
    ts = batch.section__teacher_score
    batch = dataclasses.replace(batch, section__relevance=(ts == ts.amax(dim=1, keepdim=True)).to(torch.float32))
    cfg = dict(vocab_size=64, hidden_size=16, num_layers=1, num_heads=2, intermediate_size=32,
               max_position_embeddings=32)
    jstudent = JaxRanker(cfg=JaxEncCfg(dtype=jnp.float32, **cfg), gradients=JaxDistill("margin_mse"))
    jb = dataclasses.replace(jbatch, section__teacher_score=jnp.asarray(np_of(ts)),
                             section__relevance=jnp.asarray(np_of(batch.section__relevance)))
    sparams = jax.device_get(jstudent.init(jax.random.PRNGKey(2), jb))
    student = Ranker(TransformerEncoderConfig(dtype=torch.float32, **cfg), DistillationGradients("margin_mse"),
                     device=CPU)
    student.load_state_dict(system_flax_to_state_dict(sparams))
    first = student(batch).loss
    assert float(first) == pytest.approx(float(jstudent.apply(sparams, jb).loss), abs=LOSS_ATOL)
    opt = torch.optim.Adam(student.parameters(), lr=3e-3)
    losses = []
    for _ in range(30):
        loss = student(batch).loss
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(float(loss))
    assert losses[-1] < 0.5 * losses[0]
    assert isinstance(batch, RealmBatch)
