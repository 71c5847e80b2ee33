"""The port's generative evaluation (`runtime/generation.py`) against the JAX
package: `generation_metrics` on a hand-built batch whose answers are known,
and on random batches; `evaluate_generation` end to end over a collated
batch of the seq2seq REALM system of `tests/test_torch_seq2seq.py`.

The metrics are computed on the host from integer tokens on both sides, so
they agree exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_seq2seq import T, _realm_init
from tests.test_torch_train import _to_torch_batch
from vod_tpu.models.seq2seq import realm_generate as jax_realm_generate
from vod_tpu.runtime.generation import evaluate_generation as jax_evaluate_generation
from vod_tpu.runtime.generation import generation_metrics as jax_generation_metrics
from vod_tpu.types.batch import RealmBatch as JaxRealmBatch
from vod_tpu_torch.models import realm_generate
from vod_tpu_torch.runtime import evaluate_generation, generation_metrics
from vod_tpu_torch.types.batch import RealmBatch

EOS = 1


def _batches(score: np.ndarray, ids: np.ndarray, tt: np.ndarray, mask: np.ndarray):
    """The same batch for both packages; fields the metrics do not read are zeros."""
    b, d = score.shape
    fields = dict(
        query__input_ids=np.zeros((b, 2), np.int32), query__attention_mask=np.ones((b, 2), np.int32),
        section__input_ids=np.zeros((b * d, 2), np.int32), section__attention_mask=np.ones((b * d, 2), np.int32),
        section__relevance=np.zeros((b, d), np.float32), section__idx=np.zeros((b, d), np.int32),
        section__score=score, section__sparse=np.full((b, d), np.nan, np.float32),
        lm__input_ids=ids, lm__attention_mask=mask, lm__token_type_ids=tt,
    )
    jb = JaxRealmBatch(**{k: jnp.asarray(v) for k, v in fields.items()})
    tb = RealmBatch(**{k: torch.from_numpy(v) for k, v in fields.items()})
    return jb, tb


def test_generation_metrics_on_a_hand_built_batch() -> None:
    """Four queries of two sections, answers in the `token_type_ids == 2`
    segment. Query 0: exact (the top section is the second); 1: the
    generation stops at EOS and equals the gold, whose trailing EOS is
    stripped; 2: one token of two in common (F1 0.5); 3: the top finite
    section (the other is -inf) generated nothing before EOS against an
    empty gold (EM 1, F1 1)."""
    score = np.array([[0.1, 0.9], [2.0, -1.0], [0.0, 0.5], [-np.inf, 0.3]], np.float32)
    length = 6
    ids = np.zeros((4, 2, length), np.int32)
    tt = np.zeros((4, 2, length), np.int32)
    mask = np.ones((4, 2, length), np.int32)

    def answer(q, s, toks):
        ids[q, s, 2:2 + len(toks)] = toks
        tt[q, s, 2:2 + len(toks)] = 2
        mask[q, s, 2 + len(toks):] = 0

    answer(0, 1, [7, 8, 9])
    answer(0, 0, [5])
    answer(1, 0, [4, 4, EOS])
    answer(2, 1, [6, 3])
    answer(3, 1, [])
    gen = np.zeros((4, 2, 4), np.int32)
    gen[0, 1] = [7, 8, 9, EOS]
    gen[1, 0] = [4, 4, EOS, 12]
    gen[2, 1] = [6, 2, EOS, 0]
    gen[3, 1] = [EOS, 5, 5, 5]
    jb, tb = _batches(score, ids, tt, mask)
    want = jax_generation_metrics(jnp.asarray(gen.reshape(8, 4)), jb, eos_id=EOS)
    got = generation_metrics(torch.from_numpy(gen.reshape(8, 4)), tb, eos_id=EOS)
    assert got == want
    assert got == {"gen/exact_match": 0.75, "gen/token_f1": (1 + 1 + 0.5 + 1) / 4}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_generation_metrics_on_random_batches_match_jax(seed: int) -> None:
    rng = np.random.default_rng(seed)
    b, d, length, t = 6, 3, 10, 5
    score = rng.normal(size=(b, d)).astype(np.float32)
    score[rng.random((b, d)) < 0.2] = -np.inf
    ids = rng.integers(0, 6, size=(b, d, length)).astype(np.int32)
    tt = rng.integers(0, 3, size=(b, d, length)).astype(np.int32)
    mask = (rng.random((b, d, length)) < 0.85).astype(np.int32)
    gen = rng.integers(0, 6, size=(b * d, t)).astype(np.int32)
    jb, tb = _batches(score, ids, tt, mask)
    want = jax_generation_metrics(jnp.asarray(gen), jb, eos_id=EOS)
    got = generation_metrics(torch.from_numpy(gen), tb, eos_id=EOS)
    assert got == want
    assert 0.0 <= got["gen/exact_match"] <= 1.0 and 0.0 <= got["gen/token_f1"] <= 1.0


def test_evaluate_generation_matches_jax() -> None:
    """KV-cached greedy decoding of a collated batch, then the metrics; the
    tokens themselves are held to JAX's first (all steps clear the margin
    rule at this seed, `tests/test_torch_seq2seq.py`)."""
    _, jmodel, _, _, jbatch, params, tmodel = _realm_init(seed=1)
    tbatch = _to_torch_batch(jbatch)
    np.testing.assert_array_equal(
        realm_generate(tmodel, tbatch, max_new_tokens=T).numpy(),
        np.asarray(jax_realm_generate(jmodel, params, jbatch, max_new_tokens=T)),
    )
    want = jax_evaluate_generation(jmodel, params, [jbatch, jbatch], max_new_tokens=T, max_batches=1)
    got = evaluate_generation(tmodel, [tbatch, tbatch], max_new_tokens=T, max_batches=1)
    assert got == want and set(got) == {"gen/exact_match", "gen/token_f1"}
    assert evaluate_generation(tmodel, [], max_new_tokens=T) == {}
