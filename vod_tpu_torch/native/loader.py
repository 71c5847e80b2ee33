"""Compile + load the C++ analyzer via ctypes, with pure-Python fallbacks
(the port's copy of `vod_tpu/native/loader.py`, which it does not import).

The reference leans on Elasticsearch (Java) for analysis/indexing; here the
native component is a small C++ library compiled in-tree (plain C ABI +
ctypes). The port builds `analyzer.cpp` with the reference's `g++` line,
keyed on the same source hash, into `vod_tpu_torch/_build/native/`; the
library is written under a temporary name and moved into place, so
processes that build at once never load a half-written file.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import subprocess
import threading
import typing as typ

import numpy as np

_HERE = pathlib.Path(__file__).parent
_SO_PATH = _HERE.parent / "_build" / "native" / "libvodanalyzer.so"
_LOCK = threading.Lock()
_LIB: typ.Optional[ctypes.CDLL] = None
_TRIED = False

_FNV_OFFSET = 1469598103934665603
_FNV_PRIME = 1099511628211
_MASK64 = (1 << 64) - 1

_STOPWORDS = {
    "a", "an", "and", "are", "as", "at", "be", "but", "by", "for", "if", "in",
    "into", "is", "it", "no", "not", "of", "on", "or", "such", "that", "the",
    "their", "then", "there", "these", "they", "this", "to", "was", "will", "with",
}

_TOKEN_RE = re.compile(r"[0-9a-z\u0080-\U0010FFFF]+")

# inverse of snowball.STEMMED_LANGUAGES (lang code -> name), for _py_analyze
_LANG_BY_CODE = {
    1: "english", 2: "german", 3: "spanish", 4: "french", 5: "russian", 6: "italian",
    7: "dutch", 8: "portuguese", 9: "swedish", 10: "norwegian", 11: "danish",
}


def _compile() -> typ.Optional[ctypes.CDLL]:
    src = _HERE / "analyzer.cpp"
    _SO_PATH.parent.mkdir(parents=True, exist_ok=True)
    # Rebuild keyed on the SOURCE CONTENT hash, not mtimes: a fresh checkout
    # gives source and artifact identical mtimes, which would silently keep a
    # stale binary. The build dir is gitignored — the .so is never committed.
    src_hash = hashlib.sha256(src.read_bytes()).hexdigest()
    hash_path = _SO_PATH.with_suffix(".sha256")
    stale = (
        not _SO_PATH.exists()
        or not hash_path.exists()
        or hash_path.read_text().strip() != src_hash
    )
    if stale:
        tmp = _SO_PATH.with_name(f"{_SO_PATH.name}.{os.getpid()}.tmp")
        cmd = [
            "g++", "-O3", "-std=c++17", "-shared", "-fPIC",
            str(src), "-o", str(tmp),
        ]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        except (OSError, subprocess.SubprocessError):
            tmp.unlink(missing_ok=True)
            return None
        os.replace(tmp, _SO_PATH)
        hash_tmp = hash_path.with_name(f"{hash_path.name}.{os.getpid()}.tmp")
        hash_tmp.write_text(src_hash)
        os.replace(hash_tmp, hash_path)
    try:
        lib = ctypes.CDLL(str(_SO_PATH))
    except OSError:
        return None
    lib.analyze_batch.argtypes = [
        ctypes.c_char_p,
        np.ctypeslib.ndpointer(np.int64, flags="C"),
        ctypes.c_int,
        np.ctypeslib.ndpointer(np.int32, flags="C"),
        np.ctypeslib.ndpointer(np.int32, flags="C"),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_char_p, ctypes.c_int,
    ]
    lib.porter_stem_token.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.porter_stem_token.restype = ctypes.c_int
    lib.snowball_stem_token.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
    lib.snowball_stem_token.restype = ctypes.c_int
    lib.build_postings.argtypes = [
        np.ctypeslib.ndpointer(np.int32, flags="C"),
        np.ctypeslib.ndpointer(np.int64, flags="C"),
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_float,
        np.ctypeslib.ndpointer(np.int32, flags="C"),
        np.ctypeslib.ndpointer(np.float32, flags="C"),
    ]
    return lib


def _get_lib() -> typ.Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    with _LOCK:
        if not _TRIED:
            _LIB = _compile()
            _TRIED = True
        return _LIB


def native_available() -> bool:
    return _get_lib() is not None


def fnv1a_id(token: str, vocab_size: int) -> int:
    """FNV-1a hash of a token into [0, vocab_size) — the analyzer's id function."""
    h = _FNV_OFFSET
    for byte in token.encode("utf-8"):
        h = ((h ^ byte) * _FNV_PRIME) & _MASK64
    return h & (vocab_size - 1)


def _py_analyze(
    text: str, vocab_size: int, min_len: int, use_stopwords: bool, max_terms: int,
    stem_lang: int = 0,
    extra_stops: typ.Optional[frozenset] = None,
) -> list[int]:
    out = []
    for token in _TOKEN_RE.findall(text.lower()):
        if len(token) < min_len:
            continue
        if use_stopwords and token in _STOPWORDS:
            continue
        if extra_stops is not None and token in extra_stops:
            continue
        if stem_lang:
            from .snowball import snowball_stem

            token = snowball_stem(token, _LANG_BY_CODE[stem_lang])
        h = _FNV_OFFSET
        for byte in token.encode("utf-8"):
            h = ((h ^ byte) * _FNV_PRIME) & _MASK64
        out.append(h & (vocab_size - 1))
        if len(out) >= max_terms:
            break
    return out


def analyze_texts(
    texts: typ.Sequence[str],
    *,
    vocab_size: int = 1 << 18,
    min_len: int = 2,
    use_stopwords: bool = True,
    max_terms: int = 512,
    language: typ.Optional[str] = None,
    stem: bool = False,
) -> tuple[np.ndarray, np.ndarray]:
    """Tokenize + hash a batch of texts.

    Returns (ids [n, max_terms] int32 padded -1, counts [n] int32). vocab_size
    must be a power of two (FNV hash mask). `language` selects that language's
    stopword list — filtered IN the analyzer, before stemming (the ES pipeline
    order lowercase -> stop -> stem, `es_body.py:32,101`); English is always
    filtered in-kernel. `stem=True` applies the language's stemmer: Porter for
    English (the round-4 default), Snowball de/es/fr/ru/it/nl/pt/sv/no/da (r5,
    `snowball.py`); other languages pass through unstemmed (documented
    contract — BM25 stays exact-surface for them).
    """
    assert vocab_size & (vocab_size - 1) == 0, "vocab_size must be a power of two"
    from .snowball import STEMMED_LANGUAGES

    n = len(texts)
    lib = _get_lib()
    out_ids = np.full((n, max_terms), -1, dtype=np.int32)
    counts = np.zeros((n,), dtype=np.int32)

    norm_lang = None
    extra_stop_words: typ.Optional[list[str]] = None
    if language is not None:
        from .stopwords import STOPWORDS, normalize_language

        norm_lang = normalize_language(language)
        if norm_lang != "english":
            extra_stop_words = STOPWORDS.get(norm_lang)
    stem_lang = STEMMED_LANGUAGES.get(norm_lang or "english", 0) if stem else 0

    if lib is not None:
        # Full-Unicode lowercasing happens HERE so native and fallback paths
        # hash identical term ids (the C++ kernel only lowercases ASCII; raw
        # "Éducation" would otherwise hash differently per environment).
        blobs = [t.lower().encode("utf-8", errors="ignore") for t in texts]
        offsets = np.zeros((n + 1,), dtype=np.int64)
        for i, blob in enumerate(blobs):
            offsets[i + 1] = offsets[i] + len(blob) + 1
        buf = b"\x00".join(blobs) + b"\x00"
        if extra_stop_words:
            stops_buf = b"\x00".join(w.encode("utf-8") for w in extra_stop_words) + b"\x00"
            n_extra = len(extra_stop_words)
        else:
            stops_buf, n_extra = None, 0
        lib.analyze_batch(
            buf, offsets, n, out_ids, counts, max_terms, vocab_size, min_len,
            int(use_stopwords), stem_lang, stops_buf, n_extra,
        )
        # native writes ids contiguously; pad the tail
        for i in range(n):
            out_ids[i, counts[i]:] = -1
    else:
        # language stopwords apply whenever `language` is given (independent
        # of the English in-kernel filter flag, matching the native path)
        extra = frozenset(extra_stop_words) if extra_stop_words else None
        for i, t in enumerate(texts):
            ids = _py_analyze(
                t, vocab_size, min_len, use_stopwords, max_terms, stem_lang, extra
            )
            counts[i] = len(ids)
            out_ids[i, : len(ids)] = ids
    return out_ids, counts


def build_postings(
    doc_term_ids: np.ndarray,  # [n, max_terms] int32 padded -1  (or list of lists)
    counts: typ.Optional[np.ndarray] = None,
    *,
    n_terms: int,
    max_postings: int = 2048,
    k1: float = 1.2,
    b: float = 0.75,
) -> tuple[np.ndarray, np.ndarray]:
    """Impact-ordered truncated BM25 postings. Returns (docs [T, P], impacts)."""
    if isinstance(doc_term_ids, np.ndarray) and counts is not None:
        n = doc_term_ids.shape[0]
        flat = []
        offsets = np.zeros((n + 1,), dtype=np.int64)
        for i in range(n):
            c = int(counts[i])
            flat.append(doc_term_ids[i, :c])
            offsets[i + 1] = offsets[i] + c
        flat_ids = np.concatenate(flat) if flat else np.zeros((0,), np.int32)
    else:  # list of lists
        docs = list(doc_term_ids)
        n = len(docs)
        offsets = np.zeros((n + 1,), dtype=np.int64)
        for i, dl in enumerate(docs):
            offsets[i + 1] = offsets[i] + len(dl)
        flat_ids = np.asarray(
            [t for dl in docs for t in dl], dtype=np.int32
        ) if n else np.zeros((0,), np.int32)
    flat_ids = np.ascontiguousarray(flat_ids, dtype=np.int32)

    p = max_postings
    out_docs = np.full((n_terms, p), -1, dtype=np.int32)
    out_imps = np.zeros((n_terms, p), dtype=np.float32)
    lib = _get_lib()
    if lib is not None and n > 0:
        lib.build_postings(flat_ids, offsets, n, n_terms, p, k1, b, out_docs, out_imps)
        return out_docs, out_imps

    # python fallback
    doc_lens = np.diff(offsets).astype(np.float64)
    avgdl = max(doc_lens.mean(), 1.0) if n else 1.0
    postings: dict[int, list[tuple[int, int]]] = {}
    for d in range(n):
        tf: dict[int, int] = {}
        for t in flat_ids[offsets[d]:offsets[d + 1]]:
            t = int(t)
            if 0 <= t < n_terms:
                tf[t] = tf.get(t, 0) + 1
        for t, c in tf.items():
            postings.setdefault(t, []).append((d, c))
    for t, plist in postings.items():
        df = len(plist)
        idf = np.log(1.0 + (n - df + 0.5) / (df + 0.5))
        scored = sorted(
            (
                (idf * c * (k1 + 1.0) / (c + k1 * (1 - b + b * doc_lens[d] / avgdl)), d)
                for d, c in plist
            ),
            key=lambda x: -x[0],
        )[:p]
        for j, (imp, d) in enumerate(scored):
            out_docs[t, j] = d
            out_imps[t, j] = imp
    return out_docs, out_imps
