"""The slice as a whole: encoder -> fused flat index + lookup -> hybrid merge ->
HTTP, in the JAX package and in the port (on the CPU), answering the same
requests. Merged ids and labels must be equal and scores within 1e-5 (f32
sums in another order). Also the port's MicroBatcher: bucketing, dispatch
counts, held-request ordering, errors and shutdown.
"""

import concurrent.futures
import json
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_helpers import CPU, unit_rows
from vod_tpu.models.encoder import TransformerEncoderConfig as JaxConfig
from vod_tpu.models.encoder import VodEncoder as JaxEncoder
from vod_tpu.models.pooler import VodPoolerConfig as JaxPoolerConfig
from vod_tpu.search import HybridEngines as JaxEngines
from vod_tpu.search import build_dense_index as jax_build
from vod_tpu.serving import SearchHttpClient as JaxClient
from vod_tpu.serving import SearchServer as JaxServer
from vod_tpu_torch.models import TransformerEncoderConfig, VodEncoder, VodPoolerConfig, flax_to_state_dict
from vod_tpu_torch.search import HybridEngines, build_dense_index
from vod_tpu_torch.search.io import decode_payload, encode_payload
from vod_tpu_torch.serving import MicroBatcher, SearchHttpClient, SearchServer, _bucket

SIZES = dict(vocab_size=61, hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64, max_position_embeddings=16)
POOLER = dict(agg_method="mean", output_norm="l2", scaler=10.0, learn_scaler=True)


def _encode_both(n_queries: int):
    """The same toy encoder in both packages; queries of 8 seeded tokens."""
    rng = np.random.default_rng(0)
    ids = rng.integers(0, SIZES["vocab_size"], size=(n_queries, 8)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[::3, 5:] = 0
    jmodel = JaxEncoder(JaxConfig(dtype=jnp.float32, pooler=JaxPoolerConfig(**POOLER), **SIZES))
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(ids), jnp.asarray(mask))
    jq = np.asarray(jmodel.apply(params, jnp.asarray(ids), jnp.asarray(mask)))
    tmodel = VodEncoder(
        TransformerEncoderConfig(dtype=torch.float32, pooler=VodPoolerConfig(**POOLER), **SIZES), device=CPU
    )
    tmodel.load_state_dict(flax_to_state_dict(jax.device_get(params)))
    with torch.no_grad():
        tq = tmodel(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    return jq, tq


def test_slice_end_to_end_matches_jax_over_http() -> None:
    rng = np.random.default_rng(1)
    n, d = 500, SIZES["hidden_size"]
    corpus = unit_rows(rng, n, d) * np.sqrt(10.0).astype(np.float32)
    jq, tq = _encode_both(6)
    np.testing.assert_allclose(tq, jq, atol=1e-5, rtol=0)
    gold = np.asarray([[3], [17], [-1], [250], [4], [-1]], dtype=np.int32)
    jeng = JaxEngines(dense=jax_build(jnp.asarray(corpus), dtype="float32", kernel="fused"))
    teng = HybridEngines(dense=build_dense_index(corpus, dtype="float32", kernel="fused", device="cpu"))
    with JaxServer(jeng) as jsrv, SearchServer(teng, device="cpu") as tsrv:
        for rows in (slice(0, 1), slice(1, 4), slice(0, 6)):
            j = JaxClient(jsrv.url).search(vector=jq[rows], section_ids=gold[rows], top_k=10)
            t = SearchHttpClient(tsrv.url).search(vector=tq[rows], section_ids=gold[rows], top_k=10)
            assert np.array_equal(j.indices, t.indices)
            assert np.array_equal(j.labels, t.labels)
            np.testing.assert_allclose(t.scores, j.scores, atol=1e-5, rtol=0)
            assert set(t.meta) == {"dense"}
            np.testing.assert_allclose(t.meta["dense"], j.meta["dense"], atol=1e-5, equal_nan=True)
            for r, g in enumerate(gold[rows][:, 0]):
                if g >= 0:
                    assert t.labels[r][t.indices[r].tolist().index(g)] == 1


def test_batched_server_equals_direct_over_fewer_dispatches() -> None:
    rng = np.random.default_rng(3)
    corpus = rng.normal(size=(200, 16)).astype("float32")
    engines = HybridEngines(dense=build_dense_index(corpus, dtype="float32", kernel="fused", device="cpu"))
    qs = [corpus[i : i + 1] + 0.01 for i in range(8)]
    with SearchServer(engines, device="cpu") as direct_srv:
        direct = [SearchHttpClient(direct_srv.url).search(vector=q, top_k=5) for q in qs]
    with SearchServer(engines, batch_window_ms=50.0, max_batch=16, device="cpu") as srv:
        client = SearchHttpClient(srv.url)
        srv.warmup({"vector": qs[0]}, top_k=5)
        with concurrent.futures.ThreadPoolExecutor(max_workers=8) as ex:
            outs = list(ex.map(lambda q: client.search(vector=q, top_k=5), qs))
        with urllib.request.urlopen(srv.url + "/stats", timeout=5) as r:
            stats = json.loads(r.read())
        assert urllib.request.urlopen(srv.url + "/ping", timeout=5).status == 200
    assert stats["batching"] is True and stats["requests"] == 8 and stats["dispatches"] < 8
    for dd, b in zip(direct, outs):
        assert np.array_equal(dd.indices, b.indices)
        # a batch of 8 may sum in another order than a batch of 1: f32 scores to 1e-5
        np.testing.assert_allclose(dd.scores, b.scores, atol=1e-5, rtol=0)


def test_server_errors_reach_the_client() -> None:
    corpus = np.eye(8, dtype=np.float32)
    engines = HybridEngines(dense=build_dense_index(corpus, dtype="float32", device="cpu"))
    with SearchServer(engines, device="cpu") as srv:
        client = SearchHttpClient(srv.url)
        assert client.ping()
        with pytest.raises(Exception):
            client.search(top_k=5)  # no engine matches an empty query


def test_server_refuses_engines_on_another_device() -> None:
    engines = HybridEngines(dense=build_dense_index(np.eye(4, dtype=np.float32), device="cpu"))
    with pytest.raises(ValueError, match="engines live on"):
        SearchServer(engines)  # the default device is cuda


def test_payload_roundtrip() -> None:
    x = np.random.default_rng(0).normal(size=(3, 4)).astype("float32")
    p = encode_payload({"vector": x, "top_k": 5, "none": None})
    assert "none" not in p
    d = decode_payload(json.loads(json.dumps(p)))
    assert np.array_equal(d["vector"], x) and d["top_k"] == 5


def test_bucket_ladder() -> None:
    assert [_bucket(n, 64) for n in (1, 2, 3, 5, 33, 64, 100)] == [1, 2, 4, 8, 64, 64, 64]


def test_microbatcher_coalesces_pads_and_splits() -> None:
    calls: list[tuple[int, int]] = []
    lock = threading.Lock()

    def fake_search(arrays, top_k):
        with lock:
            calls.append((arrays["vector"].shape[0], top_k))
        return {"sum": arrays["vector"].sum(axis=1)}

    mb = MicroBatcher(fake_search, max_batch=16, window_ms=50.0)
    try:
        rng = np.random.default_rng(0)
        reqs = [rng.normal(size=(1 + i % 2, 8)).astype("float32") for i in range(8)]
        with concurrent.futures.ThreadPoolExecutor(max_workers=8) as ex:
            outs = list(ex.map(lambda v: mb.submit({"vector": v}, 10), reqs))
        for v, out in zip(reqs, outs):  # each request gets exactly its own rows
            np.testing.assert_allclose(out["sum"], v.sum(axis=1), atol=1e-6)
        assert mb.requests == 8 and mb.dispatches < 8
        assert all(r & (r - 1) == 0 for r, _ in calls)  # power-of-two padded
        # a different top_k never shares a dispatch
        with concurrent.futures.ThreadPoolExecutor(max_workers=2) as ex:
            f1 = ex.submit(mb.submit, {"vector": reqs[0]}, 10)
            f2 = ex.submit(mb.submit, {"vector": reqs[1]}, 5)
            f1.result(timeout=10), f2.result(timeout=10)
        assert {k for _, k in calls} == {10, 5}
        # oversized requests bypass the queue but still count
        before_d, before_r = mb.dispatches, mb.requests
        big = mb.submit({"vector": rng.normal(size=(32, 8)).astype("float32")}, 10)
        assert big["sum"].shape == (32,)
        assert (mb.dispatches, mb.requests) == (before_d + 1, before_r + 1)
    finally:
        mb.close()


def test_microbatcher_held_requests_go_first() -> None:
    """An incompatible request pulled while collecting waits in the held list
    and is served in the next cycle, ahead of newer arrivals."""
    order: list[int] = []
    gate = threading.Event()

    def search(arrays, top_k):
        gate.wait(timeout=10)
        order.append(top_k)
        return {"x": arrays["vector"][:, 0]}

    mb = MicroBatcher(search, max_batch=4, window_ms=200.0)
    v = np.zeros((1, 2), np.float32)
    try:
        with concurrent.futures.ThreadPoolExecutor(max_workers=4) as ex:
            futs = [ex.submit(mb.submit, {"vector": v}, 10)]
            import time

            time.sleep(0.02)
            futs.append(ex.submit(mb.submit, {"vector": v}, 7))  # incompatible: held
            time.sleep(0.3)  # first batch's window closes; worker blocks in search
            futs.append(ex.submit(mb.submit, {"vector": v}, 10))
            gate.set()
            for f in futs:
                f.result(timeout=10)
        assert order[:2] == [10, 7]
    finally:
        mb.close()


def test_microbatcher_propagates_errors_and_closes() -> None:
    def boom(arrays, top_k):
        raise ValueError("engine exploded")

    mb = MicroBatcher(boom, max_batch=4, window_ms=1.0)
    with pytest.raises(ValueError, match="engine exploded"):
        mb.submit({"vector": np.zeros((1, 4), "float32")}, 10)
    mb.close()
    with pytest.raises(RuntimeError, match="batcher closed"):
        mb.submit({"vector": np.zeros((1, 4), "float32")}, 10)
