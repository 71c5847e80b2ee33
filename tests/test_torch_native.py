"""The port's own copy of the analyzer (`vod_tpu_torch/native/`) against the
JAX package's (`vod_tpu/native/`), exactly: term ids and counts, postings
doc ids and f32 impacts, FNV ids.

Each comparison runs on the native library and on the Python fallback; the
fallback is forced by patching the loader's `_get_lib` to return None (the
port's for the analyzer, both packages' for `build_postings`, whose two
paths order equal impacts differently at the truncation).
"""

import numpy as np
import pytest

from vod_tpu import native as jax_native
from vod_tpu.native import loader as jax_loader
from vod_tpu_torch import native
from vod_tpu_torch.native import loader

TEXTS = [
    "The running dogs were jumping over the lazy foxes, and it is raining again.",
    "Der Hund läuft schnell über die Straße; die Kinder spielen im Garten.",
    "Les enfants jouaient dans les jardins nationaux pendant les vacances.",
    "Generalization of connections: relational databases, 2024 edition (vol. 3).",
    "ÉDUCATION Nationale Française — Großstraße ÜBER МОСКВА и Река",
    "",
    "a an I x y z",
]


@pytest.fixture(params=["native", "fallback"])
def path(request, monkeypatch) -> str:
    if request.param == "fallback":
        monkeypatch.setattr(loader, "_get_lib", lambda: None)
    else:
        assert native.native_available(), "g++ could not build the port's analyzer"
    return request.param


@pytest.mark.parametrize("stem", [False, True], ids=["no-stem", "stem"])
@pytest.mark.parametrize("language", [None, "english", "german", "french"])
def test_analyze_texts_matches_jax(path: str, language, stem: bool) -> None:
    kw = dict(language=language, stem=stem, max_terms=7, vocab_size=1 << 12)
    ids, counts = native.analyze_texts(TEXTS, **kw)
    want_ids, want_counts = jax_native.analyze_texts(TEXTS, **kw)
    assert ids.dtype == np.int32 and counts.dtype == np.int32
    np.testing.assert_array_equal(counts, want_counts)
    np.testing.assert_array_equal(ids, want_ids)
    assert counts[-2] == 0 and counts.max() == 7  # the empty text; texts cut at max_terms


def test_analyze_options_match_jax(path: str) -> None:
    """Stopwords off, a longer minimum token length, the default vocabulary."""
    for kw in (dict(use_stopwords=False), dict(min_len=4), dict(max_terms=512)):
        got = native.analyze_texts(TEXTS, **kw)
        want = jax_native.analyze_texts(TEXTS, **kw)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_unicode_lowercase_matches_jax(path: str) -> None:
    """Non-ASCII uppercase text hashes to the same term ids on both paths and
    in both packages (full-Unicode lowercasing happens on the host)."""
    texts = ["ÉDUCATION Nationale Française", "МОСКВА и Река", "Großstraße ÜBER"]
    ids, counts = native.analyze_texts(texts, use_stopwords=False)
    want_ids, want_counts = jax_native.analyze_texts(texts, use_stopwords=False)
    np.testing.assert_array_equal(counts, want_counts)
    np.testing.assert_array_equal(ids, want_ids)
    lower_ids, _ = native.analyze_texts([t.lower() for t in texts], use_stopwords=False)
    np.testing.assert_array_equal(ids, lower_ids)


def _doc_lists(seed: int = 0, n: int = 200, n_terms: int = 64) -> list[list[int]]:
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, n_terms + 1)
    return [rng.choice(n_terms, size=int(rng.integers(1, 20)), p=p / p.sum()).tolist() for _ in range(n)]


@pytest.mark.parametrize("form", ["lists", "array-and-counts"])
def test_build_postings_matches_jax(monkeypatch, path: str, form: str) -> None:
    if path == "fallback":
        monkeypatch.setattr(jax_loader, "_get_lib", lambda: None)
    docs = _doc_lists()
    if form == "lists":
        args = (docs,)
    else:
        arr = np.full((len(docs), 24), -1, np.int32)
        for i, d in enumerate(docs):
            arr[i, : len(d)] = d
        args = (arr, np.asarray([len(d) for d in docs], np.int32))
    for kw in (dict(n_terms=64, max_postings=8), dict(n_terms=40, max_postings=256, k1=0.9, b=0.4)):
        got_docs, got_imps = native.build_postings(*args, **kw)
        want_docs, want_imps = jax_native.build_postings(*args, **kw)
        assert got_docs.shape == (kw["n_terms"], kw["max_postings"]) and got_imps.dtype == np.float32
        np.testing.assert_array_equal(got_docs, want_docs)
        np.testing.assert_array_equal(got_imps, want_imps)


def test_fnv1a_id_matches_jax() -> None:
    tokens = ["", "a", "hello", "straße", "москва", "x" * 300, "2024"]
    for vocab in (1 << 8, 1 << 18):
        assert [native.fnv1a_id(t, vocab) for t in tokens] == [jax_loader.fnv1a_id(t, vocab) for t in tokens]
    ids, counts = native.analyze_texts(["hello world"], use_stopwords=False)
    assert ids[0, : counts[0]].tolist() == [native.fnv1a_id("hello", 1 << 18), native.fnv1a_id("world", 1 << 18)]


def test_the_library_builds_inside_the_port() -> None:
    """The `.so` lands under `vod_tpu_torch/_build/native/`, keyed on the
    source's hash; the source is the JAX package's byte for byte."""
    import hashlib
    from pathlib import Path

    assert native.native_available()
    assert loader._SO_PATH.parts[-4:] == ("vod_tpu_torch", "_build", "native", "libvodanalyzer.so")
    assert loader._SO_PATH.is_file()
    src = Path(loader.__file__).with_name("analyzer.cpp").read_bytes()
    assert src == Path(jax_loader.__file__).with_name("analyzer.cpp").read_bytes()
    assert loader._SO_PATH.with_suffix(".sha256").read_text().strip() == hashlib.sha256(src).hexdigest()
