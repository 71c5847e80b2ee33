"""The ports of `examples/serving_codec_bench.py` and
`examples/serving_latency_bench.py` (`vod_tpu_torch/examples/`) against the
JAX package's route, on the CPU.

The JAX scripts draw their corpus with `jax.random` on the device and use
the Pallas kernel without `interpret`, so they do not run here. Their route
is rebuilt from `vod_tpu` functions instead: the port's stores (pca128 int8
coarse codes, pca256 int8 refine rows, the projections and scales, made by
the port's `build_direct_stores` from a small spectrum-matched corpus) go
into JAX's `PQIndex` as numpy arrays, and JAX's `pq_search` with
`kernel="fused"` (its `fused_mips_binned` in interpret mode, as JAX runs it
on the CPU) is held to the port's `pq_search` on its plain path. Ids are
equal exactly (int8 scores are exact on both sides, and the re-rank sums
exact int8 products), and so is the recall. One HTTP round trip through the
port's `SearchServer` returns the direct call's ids. Each script's `main`
runs at toy flags and returns the JAX script's keys plus `card`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vod_tpu.search import SearchQueries as JaxQueries
from vod_tpu.search.dense import PQIndex as JaxPQIndex
from vod_tpu.search.dense import pq_search as jax_pq_search
from vod_tpu_torch.examples import serving_codec_bench, serving_latency_bench
from vod_tpu_torch.examples.synthetic import SlabCorpus, recall_at
from vod_tpu_torch.search import HybridEngines, SearchQueries
from vod_tpu_torch.search.dense import pq_search
from vod_tpu_torch.serving import SearchHttpClient, SearchServer

CPU = torch.device("cpu")
N, SLAB, K = 16_000, 2048, 10


@pytest.fixture(scope="module")
def stores():
    corpus = SlabCorpus(N, SLAB, 8, CPU)
    q = corpus.queries(64)
    return corpus, serving_codec_bench.build_direct_stores(corpus, 4096), q, corpus.exact_topk(q, K)


def _jax_index(st: dict, **kw) -> JaxPQIndex:
    a = {k: jnp.asarray(v.numpy()) for k, v in st.items()}
    return JaxPQIndex(
        codebooks=jnp.zeros((1, 1, 1), jnp.float32), codes=None, coarse_codes=a["coarse"], coarse_scale=a["scale_c"],
        proj=a["proj_c"], refine_codes=a["refine"], refine_scale=a["scale_r"], refine_proj=a["proj_r"], n_real=N,
        approx_recall=0.95, **kw,
    )


@pytest.mark.parametrize("kernel, k_factor, bins, tile", [
    ("fused", 16, 2048, 0), ("fused", 32, 2048, 16384), ("fused", 16, 4096, 16384), ("scan", 16, 0, 0),
])
def test_the_codec_route_equals_jax(stores, kernel: str, k_factor: int, bins: int, tile: int) -> None:
    _, st, q, gt = stores
    kw = dict(kernel=kernel, k_factor=k_factor, fused_bins=bins or 512, fused_tile=tile)
    want = np.asarray(jax_pq_search(_jax_index(st, **kw), JaxQueries(vector=jnp.asarray(q)), K).indices)
    got = pq_search(serving_codec_bench.direct_index(st, N, **kw), SearchQueries(vector=torch.from_numpy(q)), K)
    np.testing.assert_array_equal(got.indices.numpy(), want)
    assert recall_at(got.indices, gt, K) == recall_at(want, gt, K) > 0.5


def test_codec_main_returns_the_jax_scripts_keys() -> None:
    out = serving_codec_bench.main(["--device", "cpu", "--n", "16384", "--train", "4096", "--blocks", "2",
                                    "--reps", "1"])
    assert list(out) == ["n", "B", "coarse_dim", "refine_dim", "build_s", "results", "card"]
    assert out["card"] == "cpu" and len(out["results"]) == len(serving_codec_bench.VARIANTS)
    for row, (kern, kf, bins, tile) in zip(out["results"], serving_codec_bench.VARIANTS):
        assert list(row) == ["codec", "kernel", "k_factor", "fused_bins", "fused_tile", "recall", "ms_block", "qps"]
        assert (row["kernel"], row["k_factor"], row["fused_bins"], row["fused_tile"]) == (kern, kf, bins, tile)
        assert 0.5 < row["recall"] <= 1.0 and np.isfinite(row["ms_block"]) and row["qps"] > 0


def test_one_http_round_trip_returns_the_direct_ids() -> None:
    index, q_pool = serving_latency_bench.build_serving_index(16384, CPU, 4096)
    assert (index.kernel, index.fused_bins, index.fused_tile, index.k_factor) == ("fused", 2048, 16384, 16)
    direct = pq_search(index, SearchQueries(vector=torch.from_numpy(q_pool[:3])), K)
    with SearchServer(HybridEngines(dense=index), device=CPU) as srv:
        served = SearchHttpClient(srv.url).search(vector=q_pool[:3], top_k=K)
    np.testing.assert_array_equal(np.asarray(served.indices), direct.indices.numpy())


def test_latency_main_returns_the_jax_scripts_keys() -> None:
    out = serving_latency_bench.main(["--device", "cpu", "--n", "16384", "--train", "4096", "--requests", "8",
                                      "--clients", "2", "--window_ms", "5"])
    assert list(out) == ["n", "requests", "clients", "uncoalesced", "coalesced", "device_ms", "card"]
    assert out["uncoalesced"]["dispatches"] is None
    assert 0 < out["coalesced"]["dispatches"] <= out["coalesced"]["requests"]
    for label in ("uncoalesced", "coalesced"):
        assert all(np.isfinite(out[label][k]) for k in ("seq_p50_ms", "conc_p50_ms", "conc_p99_ms"))


def test_fused_tile_only_clamps_the_bins(stores) -> None:
    """`fused_tile` is the TPU kernel's VMEM tile: in the port it clamps the
    bins (as on the TPU) and nothing else, so the JAX script's tile 16384
    and the automatic tile give the same answers at bins 2048."""
    _, st, q, _ = stores
    qq = SearchQueries(vector=torch.from_numpy(q))
    auto = pq_search(serving_codec_bench.direct_index(st, N, kernel="fused", fused_bins=2048, fused_tile=0), qq, K)
    tiled = pq_search(serving_codec_bench.direct_index(st, N, kernel="fused", fused_bins=2048, fused_tile=16384),
                      qq, K)
    assert torch.equal(auto.indices, tiled.indices) and torch.equal(auto.scores, tiled.scores)
