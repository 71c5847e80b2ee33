"""Priority sampling and in-batch-negative flattening in the port against the
JAX package, with JAX's random draws fed in; then the statistical tests of
`tests/test_priority_sampling.py`, run on torch alone.

The JAX sampler draws Exp(1) noise inside each row from keys split once per
row (and, for the labeled variant, once more into positives and negatives).
`jax_noise` and `jax_labeled_noise` rebuild those draws with the same split
chain, and the port takes them as its `noise` argument. With the same noise
the samples are the same: ids, labels and padding are compared exactly;
log-weights and lse constants, which both sides compute in f32 through
log-softmaxes written alike but summed in another order, within 1e-5.
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_helpers import np_of
from vod_tpu.ops import sample as jsample
from vod_tpu.ops.in_batch_negatives import flatten_samples as jax_flatten
from vod_tpu.types.retrieval import RetrievalBatch as JaxBatch
from vod_tpu_torch.ops import sample
from vod_tpu_torch.ops.in_batch_negatives import flatten_samples, unique_pool
from vod_tpu_torch.types.retrieval import RetrievalBatch

ATOL = 1e-5


def jax_noise(key, b: int, n: int) -> torch.Tensor:
    """The Exp(1) draws of `vod_tpu.ops.sample.priority_sampling` on [b, n] scores."""
    draw = jax.jit(jax.vmap(lambda k: jax.random.exponential(k, (n,), jnp.float32)))
    return torch.from_numpy(np.array(draw(jax.random.split(key, b))))


def jax_labeled_noise(key, b: int, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The (positives', negatives') Exp(1) draws of `labeled_priority_sampling`
    (and so of `sample_search_results`) on [b, n] scores."""

    def row(k):
        kp, kn = jax.random.split(k)
        return jax.random.exponential(kp, (n,), jnp.float32), jax.random.exponential(kn, (n,), jnp.float32)

    ep, en = jax.jit(jax.vmap(row))(jax.random.split(key, b))
    return torch.from_numpy(np.array(ep)), torch.from_numpy(np.array(en))


def _scores(seed: int, b: int, n: int, inf_frac: float = 0.0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    s = rng.normal(size=(b, n)).astype(np.float32)
    s[rng.random((b, n)) < inf_frac] = -np.inf
    return s


@pytest.mark.parametrize(
    "temperature, max_support_size, inf_frac",
    [(1.0, -1, 0.0), (0.5, -1, 0.3), (2.0, 6, 0.0), (0.0, -1, 0.2)],
)
def test_priority_sampling_matches_jax(temperature: float, max_support_size: int, inf_frac: float) -> None:
    b, n, k = 5, 20, 8
    s = _scores(0, b, n, inf_frac)
    key = jax.random.PRNGKey(3)
    fn = jax.jit(lambda r, x: jsample.priority_sampling(r, x, k, temperature, max_support_size))
    ji, jw = fn(key, jnp.asarray(s))
    ti, tw = sample.priority_sampling(
        torch.from_numpy(s), k, temperature, max_support_size, noise=jax_noise(key, b, n)
    )
    np.testing.assert_array_equal(np_of(ti), np_of(ji))
    np.testing.assert_allclose(np_of(tw), np_of(jw), atol=ATOL, rtol=0)


def test_priority_sampling_one_row_matches_jax() -> None:
    s = _scores(1, 1, 15)[0]
    key = jax.random.PRNGKey(5)
    ji, jw = jax.jit(lambda r, x: jsample.priority_sampling(r, x, 6))(key, jnp.asarray(s))
    e = torch.from_numpy(np.array(jax.random.exponential(key, (15,), jnp.float32)))
    ti, tw = sample.priority_sampling(torch.from_numpy(s), 6, noise=e)
    np.testing.assert_array_equal(np_of(ti), np_of(ji))
    np.testing.assert_allclose(np_of(tw), np_of(jw), atol=ATOL, rtol=0)


@pytest.mark.parametrize(
    "normalized, k_positive, k_total, temperature, max_support_size",
    [(True, 2, 8, 1.0, None), (False, 3, 6, 0.7, None), (True, 1, 4, 1.0, 5), (True, 4, 12, 1.0, None)],
)
def test_labeled_priority_sampling_matches_jax(normalized, k_positive, k_total, temperature, max_support_size) -> None:
    """Rows with few positives, no positives, short finite negatives (the
    rebalancing), and -inf scores."""
    b, n = 6, 16
    s = _scores(2, b, n, 0.2)
    rng = np.random.default_rng(2)
    labels = (rng.random((b, n)) < 0.25).astype(np.int32)
    labels[1] = 0  # no positives
    labels[2, :12] = 1  # four negatives only
    s[3, labels[3] == 0] = -np.inf  # no finite negative
    key = jax.random.PRNGKey(7)
    fn = jax.jit(
        lambda r, x, l: jsample.labeled_priority_sampling(
            r, x, l, k_positive=k_positive, k_total=k_total, normalized=normalized,
            temperature=temperature, max_support_size=max_support_size,
        )
    )
    jz, jw, jl, jlse = fn(key, jnp.asarray(s), jnp.asarray(labels))
    tz, tw, tl, tlse = sample.labeled_priority_sampling(
        torch.from_numpy(s), torch.from_numpy(labels), k_positive=k_positive, k_total=k_total,
        normalized=normalized, temperature=temperature, max_support_size=max_support_size,
        noise=jax_labeled_noise(key, b, n),
    )
    np.testing.assert_array_equal(np_of(tz), np_of(jz))
    np.testing.assert_array_equal(np_of(tl), np_of(jl))
    np.testing.assert_array_equal(np.isneginf(np_of(tw)), np.isneginf(np_of(jw)))
    np.testing.assert_allclose(np_of(tw), np_of(jw), atol=ATOL, rtol=0)
    np.testing.assert_allclose(np_of(tlse), np_of(jlse), atol=ATOL, rtol=0)


def test_sample_search_results_matches_jax() -> None:
    """ids, scores, labels, log-weights, lse constants, raw engine scores and
    the `max_sampling_id` diagnostic, with padding slots in the candidates."""
    b, k, total = 4, 20, 8
    rng = np.random.default_rng(0)
    scores = rng.normal(size=(b, k)).astype(np.float32)
    indices = rng.integers(0, 1000, size=(b, k)).astype(np.int32)
    labels = (rng.uniform(size=(b, k)) > 0.8).astype(np.int32)
    scores[0, 14:] = -np.inf  # padded candidates
    indices[0, 14:] = -1
    labels[0, 14:] = -1
    scores[1, :] = np.where(labels[1] > 0, scores[1], -np.inf)  # only positives are finite
    raw = {"dense": scores + 1.0, "sparse": scores - 1.0}
    key = jax.random.PRNGKey(0)
    jres = JaxBatch(scores=jnp.asarray(scores), indices=jnp.asarray(indices), labels=jnp.asarray(labels))
    jout = jax.jit(
        lambda r, res, rw: jsample.sample_search_results(
            r, search_results=res, raw_scores=rw, total=total, max_pos_sections=2
        )
    )(key, jres, {n: jnp.asarray(v) for n, v in raw.items()})
    tres = RetrievalBatch(
        scores=torch.from_numpy(scores), indices=torch.from_numpy(indices), labels=torch.from_numpy(labels)
    )
    tout = sample.sample_search_results(
        search_results=tres, raw_scores={n: torch.from_numpy(v) for n, v in raw.items()},
        total=total, max_pos_sections=2, noise=jax_labeled_noise(key, b, k),
    )
    assert tout.batch.scores.shape == (b, total)
    np.testing.assert_array_equal(np_of(tout.batch.indices), np_of(jout.batch.indices))
    np.testing.assert_array_equal(np_of(tout.batch.labels), np_of(jout.batch.labels))
    np.testing.assert_array_equal(np_of(tout.batch.scores), np_of(jout.batch.scores))
    np.testing.assert_array_equal(np_of(tout.max_sampling_id), np_of(jout.max_sampling_id))
    for name in ("log_weights", "lse_pos", "lse_neg"):
        np.testing.assert_allclose(np_of(getattr(tout, name)), np_of(getattr(jout, name)), atol=ATOL, rtol=0)
    for name in raw:
        np.testing.assert_array_equal(np_of(tout.raw_scores[name]), np_of(jout.raw_scores[name]))


def test_flatten_samples_matches_jax() -> None:
    """The shared pool (unique ids ascending, -1 padding last) and the
    per-query channels gathered onto it."""
    b, k = 3, 12
    rng = np.random.default_rng(4)
    scores = rng.normal(size=(b, k)).astype(np.float32)
    indices = rng.integers(0, 9, size=(b, k)).astype(np.int32)
    labels = (rng.uniform(size=(b, k)) > 0.7).astype(np.int32)
    key = jax.random.PRNGKey(1)
    kw = dict(total=4, max_pos_sections=2)
    jres = JaxBatch(scores=jnp.asarray(scores), indices=jnp.asarray(indices), labels=jnp.asarray(labels))
    jflat = jax.jit(
        lambda r, res: jax_flatten(
            jsample.sample_search_results(r, search_results=res, raw_scores={"dense": res.scores}, **kw)
        )
    )(key, jres)
    tres = RetrievalBatch(
        scores=torch.from_numpy(scores), indices=torch.from_numpy(indices), labels=torch.from_numpy(labels)
    )
    tflat = flatten_samples(
        sample.sample_search_results(
            search_results=tres, raw_scores={"dense": tres.scores}, noise=jax_labeled_noise(key, b, k), **kw
        )
    )
    np.testing.assert_array_equal(np_of(tflat.pool_ids), np_of(jflat.pool_ids))
    np.testing.assert_array_equal(np_of(tflat.labels), np_of(jflat.labels))
    for name in ("scores", "log_weights"):
        np.testing.assert_allclose(np_of(getattr(tflat, name)), np_of(getattr(jflat, name)), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(np_of(tflat.raw_scores["dense"]), np_of(jflat.raw_scores["dense"]))


def test_unique_pool_pads_to_the_back() -> None:
    ids = torch.tensor([[5, -1, 3], [3, 9, -1]], dtype=torch.int32)
    assert unique_pool(ids).tolist() == [3, 5, 9, -1, -1, -1]
    assert unique_pool(torch.full((2, 2), -1)).tolist() == [-1] * 4


def test_samplers_need_noise_or_a_generator() -> None:
    with pytest.raises(ValueError, match="Generator"):
        sample.priority_sampling(torch.zeros(2, 5), 2)
    ids, _ = sample.priority_sampling(torch.zeros(2, 5), 2, generator=torch.Generator().manual_seed(0))
    assert ids.shape == (2, 2)


# ---- the statistical tests of tests/test_priority_sampling.py, on torch alone ----


def _softmax(x: np.ndarray) -> np.ndarray:
    """NaN/-inf-safe row-wise softmax in numpy."""
    x = np.where(np.isnan(x), -np.inf, np.asarray(x, dtype="float64"))
    m = np.max(x, axis=-1, keepdims=True)
    m = np.where(np.isfinite(m), m, 0.0)
    e = np.exp(x - m)
    return e / np.maximum(np.sum(e, axis=-1, keepdims=True), 1e-300)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize(
    "n_trials,n,k,inf_frac",
    [(100, 100, 10, 0), (1_000, 100, 10, 0), (100, 100, 100, 0), (1_000, 100, 10, 0.5), (1_000, 100, 10, 0.95)],
)
def test_priority_sampling(seed: int, n_trials: int, n: int, k: int, inf_frac: float) -> None:
    """The self-normalized estimate of E_p[f] is within O(1/sqrt(n_trials*k)) of the truth."""
    rng = np.random.default_rng(seed)
    f = rng.normal(size=n).astype("float32")
    unorm_log_p = rng.uniform(size=n).astype("float32")
    if inf_frac > 0:
        unorm_log_p[rng.uniform(size=n) < inf_frac] = -np.inf
    if np.all(unorm_log_p == -np.inf):
        m = rng.uniform(size=n) < (1 - inf_frac)
        unorm_log_p = np.where(m, unorm_log_p, rng.normal(size=n)).astype("float32")
    mu = np.sum(_softmax(unorm_log_p) * f)
    scores = torch.from_numpy(np.repeat(unorm_log_p[None], n_trials, axis=0))
    z, log_w = sample.priority_sampling(scores, k=k, generator=torch.Generator().manual_seed(seed))
    z, log_w = np_of(z), np_of(log_w)
    assert not np.any(np.isnan(log_w))
    assert z.shape == (n_trials, k)
    mu_hats = np.sum(_softmax(log_w) * np.take(f, z), axis=-1)
    atol = 10.0 / np.sqrt(n_trials * k)
    assert np.isclose(mu, np.mean(mu_hats), atol=atol), (mu, np.mean(mu_hats), atol)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("label_thres", [0.5, 0, 1])
def test_labeled_priority_sampling(seed: int, label_thres: float) -> None:
    """Positives and negatives are disjoint, and both label-conditional
    estimates are within O(1/sqrt(n_trials*k)) of the truth."""
    n_trials, n, k_positive, k_total = 3_000, 32, 4, 8
    rng = np.random.default_rng(seed)
    f = rng.normal(size=n).astype("float32")
    unorm_log_p = rng.uniform(size=n).astype("float32")
    unorm_log_p[unorm_log_p < 0.2] = -np.inf
    labels = np.where(rng.normal(size=n) > label_thres, 1, 0)
    mu_a = np.sum(_softmax(unorm_log_p[labels == 1]) * f[labels == 1]) if np.sum(labels == 1) > 0 else None
    mu_b = np.sum(_softmax(unorm_log_p[labels == 0]) * f[labels == 0]) if np.sum(labels == 0) > 0 else None
    z_, log_w_, ls_, lse_ = sample.labeled_priority_sampling(
        torch.from_numpy(np.repeat(unorm_log_p[None], n_trials, axis=0)),
        torch.from_numpy(np.repeat(labels[None], n_trials, axis=0)),
        k_positive=k_positive, k_total=k_total, normalized=False,
        generator=torch.Generator().manual_seed(seed),
    )
    z_, log_w_, ls_ = np_of(z_), np_of(log_w_), np_of(ls_)
    assert not np.any(np.isnan(log_w_))
    assert lse_.shape == (n_trials, 2)
    for i in range(0, n_trials, n_trials // 50):  # disjointness spot-check
        counts = collections.Counter(z_[i][z_[i] >= 0].tolist())
        assert not counts or max(counts.values()) == 1
    f_taken = np.take(f, np.clip(z_, 0, n - 1))
    if mu_a is not None:
        mu_a_hats = np.sum(_softmax(np.where(ls_ == 1, log_w_, -np.inf)) * f_taken, axis=-1)
        pos_atol = 10.0 / np.sqrt(n_trials * min(k_positive, np.sum(labels == 1)))
        assert np.isclose(mu_a, np.mean(mu_a_hats), atol=pos_atol), (mu_a, np.mean(mu_a_hats), pos_atol)
    if mu_b is not None:
        mu_b_hats = np.sum(_softmax(np.where((ls_ == 0) & (z_ >= 0), log_w_, -np.inf)) * f_taken, axis=-1)
        neg_atol = 10.0 / np.sqrt(n_trials * min(k_total - k_positive, np.sum(labels == 0)))
        assert np.isclose(mu_b, np.mean(mu_b_hats), atol=neg_atol), (mu_b, np.mean(mu_b_hats), neg_atol)


def test_labeled_sampling_rebalances_when_negatives_short() -> None:
    """With fewer finite negatives than k_total - k_positive, positives fill in."""
    scores = torch.tensor([1.0, 2.0, 3.0, 4.0, -np.inf, 0.5])
    labels = torch.tensor([1, 1, 1, 1, 0, 0])
    z, _, ls, _ = sample.labeled_priority_sampling(
        scores, labels, k_positive=1, k_total=4, normalized=True, generator=torch.Generator().manual_seed(0)
    )
    z, ls = np_of(z), np_of(ls)
    assert np.sum(ls == 1) == 3  # one finite negative -> three positives
    assert set(z[ls == 1].tolist()) <= {0, 1, 2, 3}
    assert np.sum((ls == 0) & (z >= 0)) == 1


def test_sample_search_results_shapes() -> None:
    b, k, total = 4, 20, 8
    rng = np.random.default_rng(0)
    scores = torch.from_numpy(rng.normal(size=(b, k)).astype("float32"))
    res = RetrievalBatch(
        scores=scores,
        indices=torch.from_numpy(rng.integers(0, 1000, size=(b, k)).astype("int32")),
        labels=torch.from_numpy((rng.uniform(size=(b, k)) > 0.8).astype("int32")),
    )
    out = sample.sample_search_results(
        search_results=res, raw_scores={"dense": scores + 1.0, "sparse": scores - 1.0},
        total=total, max_pos_sections=2, generator=torch.Generator().manual_seed(0),
    )
    assert out.batch.scores.shape == out.batch.indices.shape == out.log_weights.shape == (b, total)
    assert out.lse_pos.shape == (b,) and out.raw_scores["dense"].shape == (b, total)
    for i in range(b):  # sampled ids come from the candidate list
        got = set(np_of(out.batch.indices)[i][np_of(out.batch.indices)[i] >= 0].tolist())
        assert got <= set(np_of(res.indices)[i].tolist())
