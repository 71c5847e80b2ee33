"""The ported search and serving demos (`vod_tpu_torch/examples/{search_flat,
search_sparse_bench,search_hybrid,serving_batch_bench,realm_dataloader}.py`)
against the JAX scripts on the CPU.

`search_flat` and `search_sparse_bench` draw their data with numpy seeds,
so both scripts run (the JAX one with `JAX_PLATFORMS=cpu`, its `main` under
a patched `sys.argv`) and their printed recall and ids must be equal:
`search_flat`'s bf16 scores sum exact products in f32 on both sides, and
BM25 runs the same analyzer and impacts. `serving_batch_bench` runs both
scripts too; their QPS are host walls, so only the request count and the
batcher's bound (dispatches <= requests) are compared. `search_hybrid` and
`realm_dataloader` sample with JAX's `PRNGKey(0)`: their routes are rebuilt
from `vod_tpu` functions on the JAX scripts' own data, and the port is fed
JAX's sampler draws (`jax_labeled_noise`); ids, labels and relevances are
equal exactly, scores and log-weights within 1e-5.
"""

import importlib.util
import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_sample import jax_labeled_noise
from vod_tpu_torch.examples import realm_dataloader, search_flat, search_hybrid, search_sparse_bench
from vod_tpu_torch.examples import serving_batch_bench

ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
ATOL = 1e-5


def _jax_script(name: str):
    spec = importlib.util.spec_from_file_location(f"jax_example_{name}", ROOT / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _run_jax(name: str, argv: list[str], monkeypatch, capsys) -> str:
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    capsys.readouterr()
    _jax_script(name).main()
    return capsys.readouterr().out


def test_search_flat_equals_jax(monkeypatch, capsys) -> None:
    argv = ["--n", "3000", "--d", "32", "--batch", "16"]
    out = _run_jax("search_flat", argv, monkeypatch, capsys)
    got = search_flat.main(argv + ["--device", "cpu"])
    assert list(got) == ["n", "d", "build_s", "search_ms", "recall", "top5_q0", "card"]
    assert got["recall"] == pytest.approx(float(re.search(r"recall@10 vs exact: ([0-9.]+)", out).group(1)), abs=5e-4)
    assert str(got["top5_q0"]) in out


def test_search_sparse_bench_equals_jax(monkeypatch, capsys) -> None:
    argv = ["--n_docs", "3000", "--batch", "16"]
    out = _run_jax("search_sparse_bench", argv, monkeypatch, capsys)
    got = search_sparse_bench.main(argv + ["--device", "cpu"])
    assert list(got) == ["native", "n_docs", "analyze_s", "postings_s", "search_ms", "top_ids_q0", "q0",
                         "top_doc_q0", "card"]
    assert f"native={got['native']}" in out
    assert f"top ids q0: {got['top_ids_q0']}" in out
    assert f"q0: {got['q0']} -> {got['top_doc_q0'][:80]}" in out


def test_serving_batch_bench_keeps_the_jax_scripts_counts(monkeypatch, capsys) -> None:
    argv = ["--n", "2000", "--d", "32", "--clients", "4", "--requests", "16", "--window_ms", "5"]
    out = _run_jax("serving_batch_bench", argv, monkeypatch, capsys)
    dispatches, requests = (int(x) for x in re.search(r"\((\d+) dispatches for (\d+) requests", out).groups())
    got = serving_batch_bench.main(argv + ["--device", "cpu"])
    assert list(got) == ["qps_off", "qps_on", "window_ms", "dispatches", "requests", "speedup", "card"]
    assert got["requests"] == requests == 16
    assert 0 < got["dispatches"] <= got["requests"] and 0 < dispatches <= requests
    assert got["qps_off"] > 0 and got["qps_on"] > 0


def test_search_hybrid_equals_jax() -> None:
    """The JAX script's engines and queries, merged and sampled by JAX with
    `PRNGKey(0)`, against the port's `run` given JAX's sampler draws."""
    from vod_tpu.native import analyze_texts, build_postings
    from vod_tpu.search import HybridEngines, SearchQueries, build_dense_index, hybrid_search_and_sample
    from vod_tpu.search.sparse import SparseIndex

    js = _jax_script("search_hybrid")
    assert js.DOCS == search_hybrid.DOCS
    rng = np.random.default_rng(0)
    n, d, vocab = len(js.DOCS), 64, 1 << 14
    dense = build_dense_index(jnp.asarray(rng.normal(size=(n, d)).astype("float32")), subset_ids=jnp.arange(n) % 2,
                              dtype="float32")
    ids, counts = analyze_texts(js.DOCS, vocab_size=vocab, max_terms=32)
    docs_arr, imps_arr = build_postings(ids, counts, n_terms=vocab, max_postings=8)
    sparse = SparseIndex(postings_docs=jnp.asarray(docs_arr), postings_impacts=jnp.asarray(imps_arr), n_docs=n)
    q_terms, _ = analyze_texts(["capital of france", "mountain near tokyo"], vocab_size=vocab, max_terms=8)
    queries = SearchQueries(vector=jnp.asarray(rng.normal(size=(2, d)).astype("float32")), terms=jnp.asarray(q_terms),
                            section_ids=jnp.asarray([[0, -1], [4, -1]], dtype="int32"))
    key = jax.random.PRNGKey(0)
    sampled, merged = jax.jit(lambda k: hybrid_search_and_sample(
        k, HybridEngines(dense=dense, sparse=sparse), queries, prefetch=6, total=4, max_pos_sections=1,
        weights={"dense": 0.5, "sparse": 1.0}))(key)
    got = search_hybrid.run(CPU, noise=jax_labeled_noise(key, 2, 6))
    np.testing.assert_array_equal(got["merged_ids"], np.asarray(merged.indices))
    np.testing.assert_array_equal(got["merged_labels"], np.asarray(merged.labels))
    np.testing.assert_allclose(got["merged_scores"], np.asarray(merged.scores), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(got["sampled_ids"], np.asarray(sampled.batch.indices))
    np.testing.assert_array_equal(got["sampled_labels"], np.asarray(sampled.batch.labels))
    np.testing.assert_allclose(got["log_weights"], np.asarray(sampled.log_weights), atol=ATOL, rtol=0)
    assert got["top_sections"] == [js.DOCS[0], js.DOCS[4]]


def test_realm_dataloader_equals_jax() -> None:
    """The JAX script's corpus, engines and first batch collated by JAX with
    `PRNGKey(0)`, against the port's `collate_one` given JAX's draws."""
    from tests.helpers import tiny_tokenizer
    from vod_tpu.configs.dataloaders import DataLoaderConfig
    from vod_tpu.data.corpus import tokenize_corpus
    from vod_tpu.dataloaders import RealmDataloader
    from vod_tpu.runtime import DeviceCorpus, device_collate
    from vod_tpu.search import HybridEngines, build_dense_index, build_sparse_index

    js = _jax_script("realm_dataloader")
    assert (js.SECTIONS, js.QUERIES) == (realm_dataloader.SECTIONS, realm_dataloader.QUERIES)
    tok = tiny_tokenizer()
    enc = tokenize_corpus(js.SECTIONS, tok, max_length=16, with_sparse_terms=True)
    corpus = DeviceCorpus(input_ids=jnp.asarray(enc["input_ids"]), attention_mask=jnp.asarray(enc["attention_mask"]),
                          subset_ids=jnp.asarray(enc["subset_ids"]))
    sparse = build_sparse_index([enc["terms"][i, : enc["term_counts"][i]].tolist() for i in range(len(js.SECTIONS))],
                                n_terms=1 << 18, max_postings=8)
    rng = np.random.default_rng(0)
    dense = build_dense_index(jnp.asarray(rng.normal(size=(4, 32)).astype("float32")), dtype="float32")
    dl = RealmDataloader(js.QUERIES, tok, config=DataLoaderConfig(batch_size=2, shuffle=False), id_map=enc["id_map"],
                         subset_id_map=enc["subset_id_map"], max_length=12, with_answers=True, with_sparse_terms=True)
    key = jax.random.PRNGKey(0)
    want, _ = jax.jit(lambda k, e, c, qb, v: device_collate(
        k, e, c, qb, query_vectors=v, prefetch=6, n_sections=3, max_pos_sections=1, with_lm=True))(
        key, HybridEngines(dense=dense, sparse=sparse), corpus, next(iter(dl.epoch(0))),
        jnp.asarray(rng.normal(size=(2, 32)).astype("float32")))
    got, port_tok, port_corpus = realm_dataloader.collate_one(
        CPU, noise=jax_labeled_noise(jax.random.split(key)[0], 2, 6))
    np.testing.assert_array_equal(port_corpus.input_ids.numpy(), enc["input_ids"])
    for name in realm_dataloader.FIELDS:
        assert getattr(got, name).numel() == np.asarray(getattr(want, name)).size, name
    for name in ("query__input_ids", "section__idx", "section__relevance"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)), err_msg=name)
    for name in ("section__score", "section__log_weight"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)), atol=ATOL, rtol=0)
    out = realm_dataloader.main(["--device", "cpu"])
    assert list(out) == ["shapes", "section_scores", "relevance", "retrieved_q0", "card"]
    assert out["retrieved_q0"][0] == port_tok.decode([t for t in enc["input_ids"][0] if t > 4])
