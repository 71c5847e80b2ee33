"""Batch-wide training terms over a data-parallel split (`runtime/
collate.py` in-batch negatives, `models/splade.py:flops_loss` through
`systems.collect_losses(group=...)`), and the learned reindex over a mesh
(`models/splade.py:encode_corpus_terms(mesh=...)`), on gloo groups of CPU
ranks against one process.

JAX's collate and loss see the global batch (one controller), so its pool of
in-batch negatives and its FLOPS term `sum_v (mean_b w_bv)^2` are the
global batch's; the one-process port equals JAX there
(`tests/test_torch_collate.py`, `tests/test_torch_splade.py`). So W ranks
are held to one process on the same global batches: SGD, 3 steps, the
logged losses within 1e-5 and the parameters within 1e-6 (sums in other
orders). The gradient of the FLOPS term reaches every rank W times through
the backward of the SUM `all_reduce` and the average over the axis divides
it back once: a term counted W times, or not at all on the other ranks,
would move the parameters by far more than 1e-6 at flops weight 1e-2.
"""

import numpy as np
import pytest
import torch

from tests.torch_helpers import job_corpus_terms, job_train_batchwide, run_ranks, splade_ranker, topic_ranker

SIZES = dict(vocab_size=64, hidden_size=32, num_layers=1, num_heads=2, intermediate_size=64)
STEP = dict(prefetch=16, n_sections=4, max_pos_sections=1, gradient_clip_val=1.0)


def _task(seed: int = 7, n: int = 64, ls: int = 8, lq: int = 6, b: int = 8, n_batches: int = 3):
    """`tests/test_torch_train_dp.py`'s separable topic task."""
    rng = np.random.default_rng(seed)
    topics = rng.integers(4, 64, size=(n, 3))
    sec = np.stack([rng.choice(topics[i], size=ls) for i in range(n)]).astype(np.int32)
    batches = []
    for s in range(n_batches):
        r = np.random.default_rng(100 + s)
        gold = r.integers(0, n, size=b)
        q = np.stack([r.choice(topics[g], size=lq) for g in gold]).astype(np.int32)
        batches.append((q, gold[:, None].astype(np.int32)))
    return sec, batches


def _state(kind: str) -> dict:
    model = splade_ranker(SIZES) if kind == "splade" else topic_ranker(SIZES)
    return {k: v.numpy() for k, v in model.state_dict().items()}


CASES = {
    "in-batch": ("topic", dict(STEP, in_batch_negatives=True)),
    "flops": ("splade", STEP),
    "flops+in-batch": ("splade", dict(STEP, in_batch_negatives=True)),
}


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case", list(CASES))
def test_w_ranks_train_as_one_process(case: str, world: int, tmp_path) -> None:
    kind, step = CASES[case]
    sec, batches = _task()
    state = _state(kind)
    one = job_train_batchwide(0, 1, kind, SIZES, state, sec, batches, step)
    many = run_ranks(job_train_batchwide, world, tmp_path, kind, SIZES, state, sec, batches, step)
    assert len(one["logs"]) == len(many[0]["logs"]) == 3 and all(r["logs"] == [] for r in many[1:])
    for lo, lw in zip(one["logs"], many[0]["logs"]):
        assert lw["loss"] == pytest.approx(lo["loss"], abs=1e-5)
    for r in many:
        for k, v in one["params"].items():
            np.testing.assert_allclose(r["params"][k], v, atol=1e-6, rtol=0, err_msg=k)
    if "in-batch" in case:
        # every rank scores its own rows against the global batch's pool (B * D sections)
        (q1, s1), (qw, sw) = one["shapes"][0], many[0]["shapes"][0]
        assert q1[0] == 8 and qw[0] == 8 // world and sw[0] == s1[0] == 8 * STEP["n_sections"]


def test_the_flops_term_is_the_global_batch_s(tmp_path) -> None:
    """The term computed over a split batch: every rank holds the value of
    the whole batch's, and its gradient, averaged over the ranks, is the
    whole batch's (the hand check of the W-fold backward)."""
    out = run_ranks(_job_flops, 2, tmp_path)
    for r in out:
        assert r["value"] == pytest.approx(r["want"], rel=1e-6)
        np.testing.assert_allclose(r["grad"], r["want_grad"], rtol=1e-5, atol=1e-8)


def _job_flops(rank: int, world: int) -> dict:
    import torch.distributed as dist

    from vod_tpu_torch.models.splade import flops_loss

    g = torch.Generator().manual_seed(0)
    full = torch.rand((8, 5), generator=g)
    w = torch.nn.Parameter(torch.ones(5))
    want = flops_loss(full * w)
    (want_grad,) = torch.autograd.grad(want, w)
    mine = full[rank * 4 : (rank + 1) * 4]
    value = flops_loss(mine * w, group=dist.group.WORLD)
    (grad,) = torch.autograd.grad(value, w)
    dist.all_reduce(grad)
    return dict(value=float(value), want=float(want), grad=(grad / world).numpy(), want_grad=want_grad.numpy())


def test_the_flops_term_counts_masked_rows_once() -> None:
    from vod_tpu_torch.models.splade import flops_loss

    x = torch.rand((6, 4), generator=torch.Generator().manual_seed(1))
    keep = torch.tensor([True, False, True, True, False, True])
    assert float(flops_loss(x, rows=keep)) == pytest.approx(float(flops_loss(x[keep])), rel=1e-6)


@pytest.mark.parametrize("world", [2, 4])
def test_learned_reindex_over_a_mesh_equals_one_process(world: int, tmp_path) -> None:
    """Each rank encodes its block of chunks; the gathered impact terms, and
    so the impact index every rank builds, are one process's."""
    from vod_tpu_torch.search import build_impact_index

    sec, _ = _task(n=53)
    state = _state("splade")
    want = job_corpus_terms(0, 1, SIZES, state, sec, 8, 6)
    for terms, weights in run_ranks(job_corpus_terms, world, tmp_path, SIZES, state, sec, 8, 6):
        np.testing.assert_array_equal(terms, want[0])
        np.testing.assert_array_equal(weights, want[1])
    a = build_impact_index(*want, n_terms=64, device="cpu")
    b = build_impact_index(terms, weights, n_terms=64, device="cpu")
    assert torch.equal(a.postings_docs, b.postings_docs) and torch.equal(a.postings_impacts, b.postings_impacts)
