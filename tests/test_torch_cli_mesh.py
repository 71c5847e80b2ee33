"""The port's CLI under a process group (`vod_tpu_torch/exps/cli.py`): two
CPU ranks of one gloo group run `main` on `tests/fixtures/beir_tiny` with the
`strategy/dp` and `search/sharded` presets (the int8 index sharded over the
batch's `dp` axis, `kernel: fused`, the BM25 postings split over `dp` too),
checkpoint (rank 0 writes) and resume; the batch accounting takes the dp
degree as JAX's `cli.py:246-251` does; a shard axis missing from the mesh
raises JAX's `ValueError`; and the factory builds sharded PQ, IVF and
IVF-PQ on two ranks (in memory and, for PQ and IVF-PQ, from host slabs)."""

from pathlib import Path

import numpy as np
import pytest

from tests.helpers import _VOCAB
from tests.test_torch_cli import _write_cli_inputs
from tests.torch_helpers import job_cli, job_cli_refusal, job_sequence, run_ranks

MESH_YAML = """\
extends: [strategy/dp, search/sharded]
model: {{kind: ranker, gradients: retrieval, vocab_size: {vocab_size}, hidden_size: 32, num_layers: 1, num_heads: 2,
        intermediate_size: 64}}
tokenizer: {{name_or_path: '{vocab}', max_length: 16}}
collate: {{prefetch_n_sections: 4, n_sections: 2, max_pos_sections: 1}}
dataloader: {{batch_size: 2}}
search_defaults:
  dense: {{codec: int8, sharded: true, shard_axis: {axis}, kernel: fused}}
  sparse: {{max_postings: 16, sharded: true, shard_axis: dp}}
trainer:
  max_steps: 2
  period: 1
  log_interval: 1
  batch_size: {{effective: 8, per_device: 2}}
  learning_rate: 5.0e-5
  checkpoint_path: '{run}'
  parameters: {{dense: {{mode: constant, value: 1.0}}, sparse: {{mode: constant, value: 1.0}}}}
sys: {{mesh_shape: {shape}, mesh_axes: {axes}}}
datasets:
  queries:
    - {{identifier: tiny-train, name_or_path: beir, subsets: ['{beir}'], split: train, link: tiny-corpus}}
  sections:
    - {{identifier: tiny-corpus, name_or_path: beir, subsets: ['{beir}']}}
"""


def _configs(tmp: Path) -> tuple[Path, Path]:
    """The two-rank config over the fixture, and one whose shard axis is
    not in its mesh."""
    _write_cli_inputs(tmp)  # the BeIR directory and the vocabulary
    kw = dict(vocab_size=len(_VOCAB) + 26, vocab=tmp / "vocab", beir=tmp / "beir")
    good, bad = tmp / "mesh.yaml", tmp / "bad.yaml"
    good.write_text(MESH_YAML.format(axis="dp", run=tmp / "run", shape="[-1]", axes="[dp]", **kw))
    bad.write_text(MESH_YAML.format(axis="shard", run=tmp / "bad", shape="[2, 1]", axes="[dp, mp]", **kw))
    return good, bad


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory) -> dict:
    tmp = tmp_path_factory.mktemp("cli_mesh")
    good, bad = _configs(tmp)
    out = run_ranks(job_sequence, 2, tmp, [(job_cli, (str(good), (str(tmp / "run"), 3))),
                                           (job_cli_refusal, (str(bad),))], timeout=400)
    return {"tmp": tmp, "ranks": out}


def test_cli_trains_checkpoints_once_and_resumes_on_two_ranks(two_ranks: dict) -> None:
    tmp, ranks = two_ranks["tmp"], two_ranks["ranks"]
    firsts = [r[0]["first"] for r in ranks]
    seconds = [r[0]["second"] for r in ranks]
    assert [f["step"] for f in firsts] == [2, 2] and [s["step"] for s in seconds] == [3, 3]
    assert all(np.isfinite(loss) for f in firsts for loss in f["losses"])
    # both ranks end with the same weights
    assert firsts[0]["checksum"] == firsts[1]["checksum"] and seconds[0]["checksum"] == seconds[1]["checksum"]
    # the sharded engines were built on every rank, once a period
    for r in ranks:
        assert r[0]["built"].count("ShardedDenseIndex") == 3 and "ShardedSparseIndex" in r[0]["built"]
    # rank 0 prints and writes: one checkpoint a period, one config
    assert "done: 2 steps" in ranks[0][0]["stdout"] and "done:" not in ranks[1][0]["stdout"]
    assert sorted(p.name for p in (tmp / "run").iterdir()) == ["config.json", "period-0", "period-1", "period-2"]


def test_batch_accounting_counts_the_dp_degree_as_jax_does(two_ranks: dict) -> None:
    """effective 8, per_device 2, dp 2: accumulate = ceil(8 / (2 * 2)) = 2
    (`vod_tpu/exps/cli.py:246-251`)."""
    n_dp, effective, per_device = 2, 8, 2
    want = max(1, -(-effective // (n_dp * per_device)))
    assert [r[0]["first"]["accumulate"] for r in two_ranks["ranks"]] == [want, want] == [2, 2]


def test_a_shard_axis_missing_from_the_mesh_raises_as_jax_does(two_ranks: dict) -> None:
    """`tests/test_exps.py:401-403`: mesh_axes [dp, mp] with dense.shard_axis
    "shard" raises `ValueError("dense.sharded requires axis ...")`."""
    for r in two_ranks["ranks"]:
        assert r[1].startswith("ValueError: dense.sharded requires axis 'shard'"), r[1]


@pytest.mark.parametrize("codec", ["pq", "ivf", "ivfpq"])
def test_sharded_compressed_codecs_still_raise(codec: str, tmp_path) -> None:
    """Once a refusal (ROADMAP §A item 5b), now the build: `sharded: true`
    over a two-rank mesh gives each rank its shard, which answers like the
    unsharded index (every cell probed, the whole PQ pool kept)."""
    from tests.torch_helpers import job_factory_sharded

    x = np.random.default_rng(0).standard_normal((300, 16)).astype(np.float32)
    kw = {"pq": dict(n_subquantizers=4, coarse_dim=None, kmeans_iters=2),
          "ivf": dict(n_clusters=4, nprobe=4, dtype="float32"),
          "ivfpq": dict(n_clusters=4, nprobe=4, ivf_window=16, refine="int8", keep_codes=False, kmeans_iters=2,
                        max_windows=0)}[codec]
    calls = [(job_factory_sharded, (codec, x, kw))]
    if codec != "ivf":
        calls.append((job_factory_sharded, (codec, x, kw, True)))
    for rank in run_ranks(job_sequence, 2, tmp_path, calls):
        for res in rank:
            assert res["type"] == "Sharded" + res["plain_type"], res["type"]
            np.testing.assert_array_equal(res["ids"], res["plain_ids"])
