"""The port's train step over a `Seq2SeqRealm` (BASELINE config #5's system)
against the JAX package, at `tests/test_torch_train.py`'s shapes with the T5
reader of `tests/test_torch_seq2seq.py`, in float32: one live-retrieval step
and one accumulated step against optax, the flax paths and decay mask of
every parameter, and the ported example `seq2seq_realm_bench` run whole at a
toy size on the CPU.

`RealmTrainStep` is generic over `model.evaluate`: it trains the seq2seq
system unchanged. Tolerances are `tests/test_torch_train.py`'s: the loss and
scores within 1e-5; after one AdamW step at lr 1e-3 the parameters within
2e-6 wherever the clipped gradient entry is at least 1e-6, and within lr
elsewhere.
"""

import json

import jax
import numpy as np
import optax
import pytest
import torch

from tests.test_torch_sample import jax_labeled_noise
from tests.test_torch_seq2seq import _realm_init
from tests.test_torch_train import (
    ATOL,
    B,
    LR,
    STEP,
    WEIGHTS,
    _arrays,
    _assert_state_close,
    _capture_grads,
    _jax_queries,
    _torch_queries,
)
from tests.torch_helpers import CPU, np_of
from vod_tpu.exps.cli import _decay_mask
from vod_tpu.runtime.train import make_train_step as jax_make_train_step
from vod_tpu_torch.examples import seq2seq_realm_bench
from vod_tpu_torch.models import flax_path
from vod_tpu_torch.runtime import adamw, build_device_corpus, decay_mask, make_train_step
from vod_tpu_torch.search import HybridEngines, build_dense_index


def _torch_env(a: dict):
    n, ls = a["corpus_ids"].shape
    corpus = build_device_corpus(a["corpus_ids"], np.ones((n, ls), np.int32), device=CPU)
    return corpus, HybridEngines(dense=build_dense_index(a["emb"], dtype="float32", device=CPU))


def test_seq2seq_flax_paths_and_decay_mask_match_jax() -> None:
    """Every port parameter names its flax path; the decay mask taken from
    those paths equals `vod_tpu/exps/cli.py:_decay_mask`. T5's RMSNorm
    scales (`ln0`..`ln2`, `final_norm`, leaf `weight`) and the relative-bias
    tables are not decayed; kernels and embeddings are."""
    *_, params, tmodel = _realm_init()
    paths, _ = zip(*jax.tree_util.tree_flatten_with_path(params)[0])
    keys = [jax.tree_util.keystr(p) for p in paths]
    names = [n for n, _ in tmodel.named_parameters()]
    assert sorted(flax_path(n) for n in names) == sorted(keys)
    jmask = dict(zip(keys, jax.tree_util.tree_leaves(_decay_mask(params))))
    tmask = decay_mask(tmodel)
    assert {n: jmask[flax_path(n)] for n in names} == tmask
    for name in ("reader.blocks.0.ln2.weight", "reader.final_norm.weight", "reader.encoder.blocks.1.ln0.weight",
                 "reader.blocks.0.relative_attention_bias", "reader.encoder.blocks.0.attention.relative_attention_bias"):
        assert not tmask[name], name
    for name in ("reader.lm_head.weight", "reader.dec_embed.weight", "reader.encoder.shared.weight",
                 "reader.blocks.1.cross_attention.q.weight", "reader.encoder.blocks.0.wi.weight"):
        assert tmask[name], name


@pytest.mark.parametrize("masked, weight_decay", [(True, 0.1), (False, 1e-4)], ids=["decay-mask", "no-mask"])
def test_seq2seq_train_step_matches_optax(masked: bool, weight_decay: float) -> None:
    """One step (encode -> search -> sample -> collate -> Seq2SeqRealm.evaluate
    -> backward -> clip -> AdamW) from the same weights and draws. `no-mask`
    is the example's `optax.adamw(lr)` (decay 1e-4, every parameter)."""
    a, jmodel, jcorpus, jeng, _, params, tmodel = _realm_init()
    tcorpus, teng = _torch_env(a)
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
    assert np.isfinite(np_of(tm["grad_norm"]))
    np.testing.assert_array_equal(np_of(trel), np_of(jrel))
    np.testing.assert_allclose(np_of(tscores), np_of(jscores), atol=ATOL, rtol=0)
    _assert_state_close(tmodel, new_params, grads)


def test_seq2seq_train_step_accum_matches_optax() -> None:
    """Two micro-batches, each collated with the pre-update weights;
    gradients averaged, then one clipped AdamW step."""
    a, jmodel, jcorpus, jeng, _, params, tmodel = _realm_init()
    a2 = _arrays(7)
    a2["corpus_ids"], a2["emb"] = a["corpus_ids"], a["emb"]
    tcorpus, teng = _torch_env(a)
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


def test_seq2seq_realm_bench_runs_on_the_cpu(capsys) -> None:
    """The example at config #5's widths (hidden 384, vocab 30,522) with a
    toy corpus and batch: the JAX script's JSON keys, twice (provisional,
    then after the reindex), finite numbers."""
    out = seq2seq_realm_bench.main(["--device", "cpu", "--corpus", "256", "--steps", "1", "--batch", "2",
                                    "--n_sections", "2", "--ls", "8", "--lq", "4", "--index_dtype", "int8"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    assert len(lines) == 2 and lines[-1] == out
    keys = {"ms_per_step", "params_m", "corpus", "batch", "n_sections", "loss", "index_dtype"}
    assert set(lines[0]) == keys and set(out) == keys | {"reindex_s"}
    assert out["corpus"] == 256 and out["batch"] == 2 and out["n_sections"] == 2 and out["index_dtype"] == "int8"
    assert np.isfinite(out["loss"]) and out["ms_per_step"] > 0 and out["reindex_s"] > 0
    assert out["params_m"] == 82.5  # the flax Seq2SeqRealm at these widths holds 82,512,000 parameters
    assert seq2seq_realm_bench.parser().parse_args([]).device == "cuda"
