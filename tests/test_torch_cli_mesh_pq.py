"""The port's CLI on two CPU ranks with `configs/msmarco_pq_realm.yaml`'s
overrides at toy widths: `strategy/dp`, its 4-bit PQ with an int8 refine
sharded over the batch's `dp` axis, `collate.in_batch_negatives`, and
`dense.autotune_target_recall: 0.9`; and the `ivfpq` preset under
`strategy/dp` (unsharded: the mesh reaches its build only with `sharded`,
as in JAX's factory).

The yaml is extended by its path and only its widths are cut (hidden 32,
one layer each for the encoder and the reader, 8 subquantizers of 4 dims,
refine at 16 of the 32 dims), over `tests/fixtures/beir_tiny`. Checked: both
ranks run every step with finite losses and end with equal parameters;
every period builds a `ShardedPQIndex` on each rank and autotunes it, and
both ranks pick the same operating point; the train step pools in-batch
negatives; the ivfpq run builds an `IVFPQIndex` each period on both ranks.
"""

from pathlib import Path

import math

import pytest

from tests.helpers import _VOCAB
from tests.test_torch_cli import _write_cli_inputs
from tests.torch_helpers import job_cli, job_sequence, run_ranks

ROOT = Path(__file__).resolve().parents[1]

PQ_YAML = """\
extends: ['{msmarco}', strategy/dp]
model: {{vocab_size: {vocab_size}, hidden_size: 32, num_layers: 1, num_heads: 2, intermediate_size: 64,
        lm_hidden_size: 32, lm_num_layers: 1}}
tokenizer: {{name_or_path: '{vocab}', max_length: 16}}
collate: {{prefetch_n_sections: 4, n_sections: 2, max_pos_sections: 1, in_batch_negatives: true}}
dataloader: {{batch_size: 2}}
search_defaults:
  dense: {{n_subquantizers: 8, refine_dim: 16, sharded: true, shard_axis: dp, autotune_target_recall: 0.9,
          autotune_queries: 4}}
trainer:
  max_steps: 2
  period: 1
  log_interval: 1
  accumulate_grad_batches: 1
  val_check_interval: null
  batch_size: {{effective: 4, per_device: 2}}
  checkpoint_path: '{run}'
datasets:
  queries:
    - {{identifier: tiny-train, name_or_path: beir, subsets: ['{beir}'], split: train, link: tiny-corpus}}
  sections:
    - {{identifier: tiny-corpus, name_or_path: beir, subsets: ['{beir}']}}
"""

IVFPQ_YAML = """\
extends: [strategy/dp, search/ivfpq]
model: {{kind: ranker, gradients: retrieval, vocab_size: {vocab_size}, hidden_size: 32, num_layers: 1, num_heads: 2,
        intermediate_size: 64}}
tokenizer: {{name_or_path: '{vocab}', max_length: 16}}
collate: {{prefetch_n_sections: 4, n_sections: 2, max_pos_sections: 1}}
dataloader: {{batch_size: 2}}
search_defaults:
  dense: {{refine_dim: 16, ivf_window: 16}}
trainer: {{max_steps: 2, period: 1, log_interval: 1, batch_size: {{effective: 4, per_device: 2}}}}
datasets:
  queries:
    - {{identifier: tiny-train, name_or_path: beir, subsets: ['{beir}'], split: train, link: tiny-corpus}}
  sections:
    - {{identifier: tiny-corpus, name_or_path: beir, subsets: ['{beir}']}}
"""


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory) -> dict:
    tmp = tmp_path_factory.mktemp("cli_mesh_pq")
    _write_cli_inputs(tmp)
    kw = dict(vocab_size=len(_VOCAB) + 26, vocab=tmp / "vocab", beir=tmp / "beir")
    pq, ivfpq = tmp / "pq.yaml", tmp / "ivfpq.yaml"
    pq.write_text(PQ_YAML.format(msmarco=ROOT / "configs" / "msmarco_pq_realm.yaml", run=tmp / "run", **kw))
    ivfpq.write_text(IVFPQ_YAML.format(**kw))
    out = run_ranks(job_sequence, 2, tmp, [(job_cli, (str(pq),)), (job_cli, (str(ivfpq),))], timeout=400)
    return {"pq": [r[0] for r in out], "ivfpq": [r[1] for r in out]}


def test_msmarco_overrides_train_on_two_ranks(two_ranks: dict) -> None:
    ranks = two_ranks["pq"]
    firsts = [r["first"] for r in ranks]
    assert [f["step"] for f in firsts] == [2, 2] and all(f["periods"] == 2 for f in firsts)
    assert all(math.isfinite(loss) for f in firsts for loss in f["losses"])
    assert firsts[0]["checksum"] == firsts[1]["checksum"]  # the same weights on both ranks
    assert all(f["in_batch_negatives"] for f in firsts)
    for r in ranks:  # BM25, then one dense build a period (the second job's builds follow in this list)
        assert r["built"][:3] == ["SparseIndex", "ShardedPQIndex", "ShardedPQIndex"], r["built"]
    # every period was tuned, and both ranks took the same point
    tuned = [f["autotune"] for f in firsts]
    assert all(p is not None and "k_factor" in p for p in tuned[0]) and tuned[0] == tuned[1]


def test_ivfpq_preset_trains_under_dp_without_sharding(two_ranks: dict) -> None:
    """The mesh reaches the ivfpq build only with `sharded` (JAX
    `factory.py:169`): the unsharded preset under `strategy/dp` builds an
    `IVFPQIndex` on each rank and trains."""
    firsts = [r["first"] for r in two_ranks["ivfpq"]]
    assert [f["step"] for f in firsts] == [2, 2] and firsts[0]["checksum"] == firsts[1]["checksum"]
    assert all(math.isfinite(loss) for f in firsts for loss in f["losses"])
    for r in two_ranks["ivfpq"]:
        assert r["built"] == ["SparseIndex", "IVFPQIndex", "IVFPQIndex"], r["built"]
