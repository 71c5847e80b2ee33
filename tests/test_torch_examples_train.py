"""The port of `examples/train_periodic.py` and `data/loaders/local_text.py:
encode_passages` against the JAX package on the CPU.

`encode_passages` (and the vocabulary it reads) is equal to JAX's bit for
bit on harvested and in-test passages. `train_periodic`'s route is both
packages' `run_experiment` over the script's in-file rows and config, in
f32 at sampling temperature 0 (no random draw enters), with JAX's initial
parameters carried into the port (`models/convert.py`): the first loss is
held within 1e-5 (relative) of JAX's. The script's `main` then runs at toy
flags: its keys, and finite numbers. `tests/test_torch_examples_encoders.py`
holds the other two training scripts.
"""

import math

import numpy as np
import pytest

from tests.helpers import tiny_tokenizer
from tests.test_torch_cli import _capture_jax_init, _carry_into_port
from vod_tpu.data.loaders import local_text as jax_local_text
from vod_tpu.exps import cli as jax_cli
from vod_tpu.exps.structconf import Experiment as JaxExperiment
from vod_tpu_torch.data.loaders import local_text
from vod_tpu_torch.examples import train_periodic
from vod_tpu_torch.examples.toy_text import tiny_tokenizer as port_tiny_tokenizer
from vod_tpu_torch.exps import cli
from vod_tpu_torch.exps.structconf import Experiment

RTOL = 1e-5
IN_TEST = [{"id": "a", "content": "Paris is the capital of France; paris_2 PARIS tok9 é x"},
           {"id": "b", "content": ""}, {"id": "c", "content": " ".join(f"w{i % 7} Word{i}" for i in range(90))}]


def _finite(obj) -> None:
    if isinstance(obj, dict):
        for v in obj.values():
            _finite(v)
    elif isinstance(obj, list):
        for v in obj:
            _finite(v)
    elif isinstance(obj, float):
        assert math.isfinite(obj)


def test_encode_passages_equals_jax() -> None:
    passages = local_text.harvest_text_passages(300, passage_words=24) + IN_TEST
    assert len(passages) > 200
    vocab = local_text.build_word_vocab(passages, vocab_size=500)
    assert vocab == jax_local_text.build_word_vocab(passages, vocab_size=500)
    for max_length in (8, 24, 64):
        ids, mask = local_text.encode_passages(passages, vocab, max_length=max_length)
        want_ids, want_mask = jax_local_text.encode_passages(passages, vocab, max_length=max_length)
        assert ids.dtype == want_ids.dtype == np.int32 and mask.dtype == want_mask.dtype == np.int32
        np.testing.assert_array_equal(ids, want_ids)
        np.testing.assert_array_equal(mask, want_mask)


def test_train_periodic_first_loss_equals_jax(monkeypatch) -> None:
    from tests.test_torch_cli import _f32

    raw = train_periodic.experiment_dict(max_steps=1, period=1, log_interval=1)
    raw["collate"]["temperature"] = 0.0
    raw["sys"] = {"mesh_shape": [1]}
    _f32(monkeypatch)
    seen = _capture_jax_init(monkeypatch)
    jlogs, tlogs = [], []
    jax_cli.run_experiment(JaxExperiment.parse(raw), sections=train_periodic.SECTIONS,
                           queries=train_periodic.QUERIES, tokenizer=tiny_tokenizer(),
                           on_log=lambda s, m: jlogs.append(m))
    _carry_into_port(monkeypatch, seen)
    out = cli.run_experiment(Experiment.parse(raw), sections=train_periodic.SECTIONS, queries=train_periodic.QUERIES,
                             tokenizer=port_tiny_tokenizer(), on_log=lambda s, m: tlogs.append(m), device="cpu")
    assert out["state"].step == 1 and len(tlogs) == len(jlogs) == 1
    assert tlogs[0]["loss"] == pytest.approx(jlogs[0]["loss"], rel=RTOL)


def test_train_periodic_main_at_toy_flags() -> None:
    out = train_periodic.main(["--max-steps", "4", "--period", "2", "--log-interval", "2", "--device", "cpu"])
    assert list(out) == ["steps", "logs", "periods", "card"] and out["steps"] == 4
    assert [p["period"] for p in out["periods"]] == [0, 1] and len(out["logs"]) == 2
    _finite(out)
