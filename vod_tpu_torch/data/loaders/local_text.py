"""Local-filesystem text corpus loader (the port's copy of
`vod_tpu/data/loaders/local_text.py`): an offline source of real text.

Package documentation, docstrings, licenses and READMEs already on disk have
natural (Zipfian) statistics; this loader harvests them into passage rows
shaped like `SectionModel` (id/content/title). The default root is the
running interpreter's `purelib` directory (site-packages), where the JAX
package names one fixed path.
"""

from __future__ import annotations

import hashlib
import pathlib
import re
import sysconfig
import typing as typ

DEFAULT_ROOTS = (sysconfig.get_paths()["purelib"],)
_EXTS = (".md", ".rst", ".txt", ".py")
_WORD_RE = re.compile(r"[A-Za-z][A-Za-z0-9_]+")


def _iter_files(roots: typ.Sequence[str], exts: typ.Sequence[str]) -> typ.Iterator[pathlib.Path]:
    for root in roots:
        rp = pathlib.Path(root)
        if not rp.is_dir():
            continue
        for p in sorted(rp.rglob("*")):
            if p.suffix in exts and p.is_file():
                yield p


def harvest_text_passages(
    n_passages: int,
    *,
    roots: typ.Sequence[str] = DEFAULT_ROOTS,
    exts: typ.Sequence[str] = _EXTS,
    passage_words: int = 48,
    min_words: int = 16,
    max_bytes_per_file: int = 1 << 20,
    stride: typ.Optional[int] = None,
) -> list[dict]:
    """Harvest up to `n_passages` word-window passages from on-disk text.

    Each passage is `passage_words` consecutive word tokens from one file
    (code + prose both carry natural Zipfian statistics). Rows follow the
    section schema: {id, content, title, subset_id}. `stride` < passage_words
    yields overlapping windows — the same semantics as the sectioning
    pipeline's overlap (`data/sectioning.py`; reference sentence/window
    sectioning overlaps too) and the lever for corpora larger than the raw
    on-disk word count.
    """
    step = stride or passage_words
    out: list[dict] = []
    for p in _iter_files(roots, exts):
        try:
            text = p.read_bytes()[:max_bytes_per_file].decode("utf-8", errors="ignore")
        except OSError:
            continue
        words = _WORD_RE.findall(text)
        title = p.stem
        for s0 in range(0, max(0, len(words) - min_words), step):
            chunk = words[s0 : s0 + passage_words]
            if len(chunk) < min_words:
                break
            content = " ".join(chunk)
            pid = hashlib.blake2s(
                f"{p}:{s0}".encode(), digest_size=8
            ).hexdigest()
            out.append({"id": pid, "content": content, "title": title, "subset_id": None})
            if len(out) >= n_passages:
                return out
    return out


def build_word_vocab(
    passages: typ.Sequence[typ.Mapping], vocab_size: int = 32768
) -> dict[str, int]:
    """Frequency-ranked word vocab; ids 0=pad, 1=unk."""
    from collections import Counter

    counts: Counter = Counter()
    for row in passages:
        counts.update(w.lower() for w in _WORD_RE.findall(row["content"]))
    vocab = {"[PAD]": 0, "[UNK]": 1}
    for w, _ in counts.most_common(vocab_size - 2):
        vocab[w] = len(vocab)
    return vocab


def encode_passages(
    passages: typ.Sequence[typ.Mapping],
    vocab: typ.Mapping[str, int],
    max_length: int = 64,
):
    """Word-level encode into (ids [n, L] int32, mask [n, L] int32) arrays."""
    import numpy as np

    n = len(passages)
    ids = np.zeros((n, max_length), dtype=np.int32)
    mask = np.zeros((n, max_length), dtype=np.int32)
    unk = vocab["[UNK]"]
    for i, row in enumerate(passages):
        toks = [vocab.get(w.lower(), unk) for w in _WORD_RE.findall(row["content"])][:max_length]
        ids[i, : len(toks)] = toks
        mask[i, : len(toks)] = 1
    return ids, mask
