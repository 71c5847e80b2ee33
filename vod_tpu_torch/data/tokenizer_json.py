"""Byte-level BPE and Unigram tokenizers read from a local `tokenizer.json`
(or, for BPE, `vocab.json` with `merges.txt`), giving the ids, masks and
offsets that `transformers.AutoTokenizer` gives for the same directory: the
RoBERTa (BPE), XLM-R, CamemBERT and T5 (Unigram) families. Nothing here
imports `tokenizers` or `transformers`, which the card's machine lacks.

The pipeline is the `tokenizers` library's, step for step:
 1. added tokens are split off the raw text first (leftmost-longest, with
    their `lstrip` / `rstrip` / `single_word` flags), those marked
    `normalized` after normalization;
 2. the normalizer (`Sequence`, `NFC`/`NFD`/`NFKC`/`NFKD`, `Replace`,
    `Strip`, `StripAccents`, `Lowercase`, `Prepend`, `Precompiled`)
    rewrites each piece, every character keeping the original offsets it
    came from;
 3. the pre-tokenizer (`ByteLevel` with the GPT-2 regular expression and
    the byte-to-unicode map, `Metaspace` with its `prepend_scheme`,
    `WhitespaceSplit`, `Digits`, `Sequence`) cuts the pieces into words;
 4. the model: BPE merges by rank, Unigram's Viterbi over the scored
    pieces (unknown characters as `unk_id`, consecutive ones fused, or
    their bytes with `byte_fallback`), or `WordLevel`'s lookup;
 5. the post-processor (`RobertaProcessing` with `trim_offsets`,
    `TemplateProcessing`, `ByteLevel`) adds the special tokens; truncation
    (`longest_first` for pairs) and padding are `transformers`' calling
    convention.
Offsets are character offsets into the input text, special tokens (0, 0).

`tokenizer_config.json` names the class (`tokenizer_class`), whose special
tokens `transformers` sets: the RoBERTa family's `<mask>` strips the space
before it (`lstrip`). sentencepiece's `Precompiled` charsmap (the
normalizer of XLM-R's, CamemBERT's and T5's files) is read by
`data/precompiled.py`, per extended grapheme cluster
(`data/graphemes.py`); Unigram's `byte_fallback` gives unknown characters
their `<0xXX>` byte pieces; the `Digits` pre-tokenizer and the `WordLevel`
model are read too. Any other component raises `NotImplementedError`
naming ROADMAP §A item 8, which lists what is read.
"""

from __future__ import annotations

import functools
import itertools
import json
import pathlib
import re
import typing as typ
import unicodedata

import numpy as np

from .precompiled import CharsMap, apply_changes
from .tokenizer import _WHITESPACE as _WS_SET  # Rust's `char::is_whitespace`: what `tokenizers` strips
from .tokenizer import _longest_first, batch_output

Piece = tuple[str, list[tuple[int, int]]]  # normalized text, each character's original (start, end)

_NOT_READ = "is not read by vod_tpu_torch's tokenizers (ROADMAP §A item 8 lists the components that are)"
_WHITESPACE = "".join(sorted(_WS_SET))
_SPECIAL_ATTRS = ("bos_token", "eos_token", "unk_token", "sep_token", "pad_token", "cls_token", "mask_token")
_ROBERTA_SPECIALS = dict(bos_token="<s>", eos_token="</s>", unk_token="<unk>", sep_token="</s>", pad_token="<pad>",
                         cls_token="<s>", mask_token="<mask>")
# the special tokens `transformers` gives each class by default
_CLASS_SPECIALS: dict[str, dict[str, str]] = {
    "RobertaTokenizer": _ROBERTA_SPECIALS,
    "XLMRobertaTokenizer": _ROBERTA_SPECIALS,
    "CamembertTokenizer": _ROBERTA_SPECIALS,
    "T5Tokenizer": dict(eos_token="</s>", unk_token="<unk>", pad_token="<pad>"),
    "GPT2Tokenizer": dict(bos_token="<|endoftext|>", eos_token="<|endoftext|>", unk_token="<|endoftext|>"),
}
# the classes whose `<mask>` strips the space before it
_MASK_LSTRIP = {"RobertaTokenizer", "XLMRobertaTokenizer", "CamembertTokenizer"}
# the class whose `__init__` sets the post-processor's `add_prefix_space`
# and `trim_offsets` from its own arguments
_SETS_POST = {"RobertaTokenizer"}


def _class_key(name: typ.Optional[str]) -> typ.Optional[str]:
    return None if name is None else name.removesuffix("Fast")


# -- Unicode character classes without the `regex` module --------------------------------
# no letter or number lies past the supplementary ideographic planes
_LAST_ASSIGNED_LN = 0x323AF


def _category_classes() -> tuple[str, str]:
    """`re` character-class bodies of \\p{L} and \\p{N} (Python's Unicode tables)."""
    ranges: dict[str, list[list[int]]] = {"L": [], "N": []}
    for cp in range(_LAST_ASSIGNED_LN + 1):
        kind = unicodedata.category(chr(cp))[0]
        if kind in ranges:
            r = ranges[kind]
            if r and r[-1][1] == cp - 1:
                r[-1][1] = cp
            else:
                r.append([cp, cp])
    return tuple("".join(re.escape(chr(a)) if a == b else f"{re.escape(chr(a))}-{re.escape(chr(b))}"
                         for a, b in ranges[k]) for k in ("L", "N"))


@functools.cache
def _gpt2_pattern() -> re.Pattern:
    """GPT-2's pre-tokenizer expression, `'s|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+|
    ?\\p{N}+| ?[^\\s\\p{L}\\p{N}]+|\\s+(?!\\S)|\\s+`, over White_Space
    (built at first use, from a scan of the Unicode tables)."""
    (letters, numbers), ws = _category_classes(), re.escape(_WHITESPACE)
    return re.compile(rf"'s|'t|'re|'ve|'m|'ll|'d| ?[{letters}]+| ?[{numbers}]+| ?[^{ws}{letters}{numbers}]+"
                      rf"|[{ws}]+(?![^{ws}])|[{ws}]+")


def bytes_to_unicode() -> dict[int, str]:
    """GPT-2's map of the 256 byte values to printable characters."""
    bs = [*range(ord("!"), ord("~") + 1), *range(ord("¡"), ord("¬") + 1), *range(ord("®"), ord("ÿ") + 1)]
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


_BYTE_CHARS = bytes_to_unicode()
_SPACE_CHAR = _BYTE_CHARS[ord(" ")]


# -- normalizers -------------------------------------------------------------------------
def _unicode_form(form: str) -> typ.Callable[[Piece], Piece]:
    """NFC / NFD / NFKC / NFKD with `tokenizers`' alignments: each output
    character carries a change (0: it replaces the next input character,
    +1: it is inserted after the last one, -n: it also removes the n next),
    and the alignments follow the input in that order. A decomposition
    gives 0 then +1 each; a composite takes the sum of its parts' minus 1."""
    decompose = "NFKD" if "K" in form else "NFD"
    compose = form in ("NFC", "NFKC")

    def run(piece: Piece) -> Piece:
        text, align = piece
        if unicodedata.is_normalized(form, text):
            return piece
        chars: list[tuple[str, int]] = []
        for c in text:
            d = unicodedata.normalize(decompose, c)
            chars += [(d[0], 0)] + [(x, 1) for x in d[1:]]
        # canonical ordering: each run of non-starters sorted by combining class (stable)
        out: list[tuple[str, int]] = []
        run_: list[tuple[str, int]] = []
        for item in chars + [("", 0)]:
            if item[0] and unicodedata.combining(item[0]):
                run_.append(item)
                continue
            out += sorted(run_, key=lambda x: unicodedata.combining(x[0]))
            run_ = []
            if item[0]:
                out.append(item)
        if compose:
            out = _compose(out)
        return apply_changes(align, out)

    return run


def _compose(chars: list[tuple[str, int]]) -> list[tuple[str, int]]:
    """Canonical composition (the standard algorithm) of decomposed,
    reordered (character, change) pairs."""
    out: list[tuple[str, int]] = []
    starter: typ.Optional[int] = None
    last_ccc: typ.Optional[int] = None  # of the last character kept after the starter
    for c, change in chars:
        ccc = unicodedata.combining(c)
        if starter is not None and (last_ccc is None or (last_ccc != 0 and last_ccc < ccc)):
            composite = unicodedata.normalize("NFC", out[starter][0] + c)
            if len(composite) == 1:
                out[starter] = (composite, out[starter][1] + change - 1)
                continue
        if ccc == 0:
            starter, last_ccc = len(out), None
        else:
            last_ccc = ccc
        out.append((c, change))
    return out


def _replace(pattern: dict, content: str) -> typ.Callable[[Piece], Piece]:
    regex = re.compile(pattern["Regex"]) if "Regex" in pattern else re.compile(re.escape(pattern["String"]))

    def run(piece: Piece) -> Piece:
        text, align = piece
        out_t: list[str] = []
        out_a: list[tuple[int, int]] = []
        last = 0
        for m in regex.finditer(text):
            if m.end() == m.start():
                continue
            out_t.append(text[last : m.start()])
            out_a += align[last : m.start()]
            # the new characters take the alignment of the last one they replace
            out_t.append(content)
            out_a += [align[m.end() - 1]] * len(content)
            last = m.end()
        out_t.append(text[last:])
        out_a += align[last:]
        return "".join(out_t), out_a

    return run


def _prepend(text_: str, piece: Piece) -> Piece:
    """`text_` before a non-empty piece, aligned to its first character."""
    text, align = piece
    if not text:
        return piece
    return text_ + text, [align[0]] * len(text_) + align


def _lowercase(piece: Piece) -> Piece:
    text, align = piece
    out_t, out_a = [], []
    for c, a in zip(text, align):
        low = c.lower()
        out_t.append(low)
        out_a += [a] * len(low)
    return "".join(out_t), out_a


def _filter(keep: typ.Callable[[str], bool]) -> typ.Callable[[Piece], Piece]:
    def run(piece: Piece) -> Piece:
        text, align = piece
        idx = [i for i, c in enumerate(text) if keep(c)]
        return "".join(text[i] for i in idx), [align[i] for i in idx]

    return run


def _strip(left: bool, right: bool) -> typ.Callable[[Piece], Piece]:
    def run(piece: Piece) -> Piece:
        text, align = piece
        a, b = 0, len(text)
        while left and a < b and text[a] in _WS_SET:
            a += 1
        while right and b > a and text[b - 1] in _WS_SET:
            b -= 1
        return text[a:b], align[a:b]

    return run


def _normalizer(spec: typ.Optional[dict]) -> typ.Callable[[Piece], Piece]:
    if spec is None:
        return lambda p: p
    kind = spec["type"]
    if kind == "Sequence":
        steps = [_normalizer(s) for s in spec["normalizers"]]

        def seq(piece: Piece) -> Piece:
            for s in steps:
                piece = s(piece)
            return piece

        return seq
    if kind in ("NFC", "NFD", "NFKC", "NFKD"):
        return _unicode_form(kind)
    if kind == "Replace":
        return _replace(spec["pattern"], spec["content"])
    if kind == "Prepend":
        return lambda p: _prepend(spec["prepend"], p)
    if kind == "Lowercase":
        return _lowercase
    if kind == "Strip":
        return _strip(spec.get("strip_left", True), spec.get("strip_right", True))
    if kind == "StripAccents":
        return _filter(lambda c: not unicodedata.category(c).startswith("M"))
    if kind == "Precompiled":
        return CharsMap.from_base64(spec["precompiled_charsmap"] or "").normalize
    raise NotImplementedError(f"the {kind!r} normalizer {_NOT_READ}")


# -- pre-tokenizers ------------------------------------------------------------------------
def _split_on(piece: Piece, spans: typ.Iterable[tuple[int, int]]) -> list[Piece]:
    text, align = piece
    return [(text[a:b], align[a:b]) for a, b in spans if b > a]


def _split_behaviour(piece: Piece, matches: list[tuple[int, int]], behaviour: str) -> list[Piece]:
    """The pieces of `piece` around the delimiter spans `matches`:
    "Removed" drops them, "MergedWithNext" starts a piece with each."""
    spans: list[tuple[int, int]] = []
    last = 0
    for a, b in matches:
        spans.append((last, a))
        last = b if behaviour == "Removed" else a
    spans.append((last, len(piece[0])))
    return _split_on(piece, spans)


def _byte_level(add_prefix_space: bool, use_regex: bool) -> typ.Callable[[Piece], list[Piece]]:
    def run(piece: Piece) -> list[Piece]:
        if add_prefix_space and not piece[0].startswith(" "):
            piece = _prepend(" ", piece)
        words = _split_on(piece, (m.span() for m in _gpt2_pattern().finditer(piece[0]))) if use_regex else [piece]
        out = []
        for text, align in words:
            chars, aligns = [], []
            for c, a in zip(text, align):
                for b in c.encode("utf-8"):
                    chars.append(_BYTE_CHARS[b])
                    aligns.append(a)
            out.append(("".join(chars), aligns))
        return out

    return run


def _metaspace(replacement: str, prepend_scheme: str, split: bool) -> typ.Callable[[Piece], list[Piece]]:
    def run(piece: Piece) -> list[Piece]:
        text, align = piece
        piece = (text.replace(" ", replacement), align)
        first = bool(align) and align[0][0] == 0  # the piece starts the text
        if not piece[0].startswith(replacement) and (
                prepend_scheme == "always" or (prepend_scheme == "first" and first)):
            piece = _prepend(replacement, piece)
        if not split:
            return [piece] if piece[0] else []
        return _split_behaviour(piece, [(m.start(), m.end()) for m in re.finditer(re.escape(replacement), piece[0])],
                                "MergedWithNext")

    return run


def _digits(individual: bool) -> typ.Callable[[Piece], list[Piece]]:
    """Numeric characters (Rust's `char::is_numeric`: Nd, Nl, No) split off,
    each alone (`individual_digits`) or in runs, the rest kept between."""
    def numeric(c: str) -> bool:
        return unicodedata.category(c) in ("Nd", "Nl", "No")

    def run(piece: Piece) -> list[Piece]:
        spans, pos = [], 0
        for is_num, group in itertools.groupby(piece[0], numeric):
            n = len(list(group))
            spans += [(pos + i, pos + i + 1) for i in range(n)] if is_num and individual else [(pos, pos + n)]
            pos += n
        return _split_on(piece, spans)

    return run


def _pre_tokenizer(spec: typ.Optional[dict]) -> typ.Callable[[Piece], list[Piece]]:
    if spec is None:
        return lambda p: [p] if p[0] else []
    kind = spec["type"]
    if kind == "Sequence":
        steps = [_pre_tokenizer(s) for s in spec["pretokenizers"]]

        def seq(piece: Piece) -> list[Piece]:
            pieces = [piece]
            for s in steps:
                pieces = [q for p in pieces for q in s(p)]
            return pieces

        return seq
    if kind == "ByteLevel":
        return _byte_level(spec.get("add_prefix_space", True), spec.get("use_regex", True))
    if kind == "Metaspace":
        scheme = spec.get("prepend_scheme")
        if scheme is None:  # files older than `prepend_scheme`
            scheme = "always" if spec.get("add_prefix_space", True) else "never"
        return _metaspace(spec.get("replacement", "▁"), scheme, spec.get("split", True))
    if kind == "Digits":
        return _digits(spec.get("individual_digits", False))
    if kind == "WhitespaceSplit":
        return lambda p: _split_behaviour(p, [m.span() for m in re.finditer(f"[{re.escape(_WHITESPACE)}]+", p[0])],
                                          "Removed")
    raise NotImplementedError(f"the {kind!r} pre-tokenizer {_NOT_READ}")


# -- models --------------------------------------------------------------------------------
class _BPE:
    """BPE over one word: its characters, merged by rank."""

    def __init__(self, spec: dict):
        for key, ok in (("dropout", (None, 0, 0.0)), ("continuing_subword_prefix", (None, "")),
                        ("end_of_word_suffix", (None, "")), ("byte_fallback", (None, False))):
            if spec.get(key) not in ok:
                raise NotImplementedError(f"a BPE model with {key}={spec[key]!r} {_NOT_READ}")
        self.vocab: dict[str, int] = dict(spec["vocab"])
        merges = [tuple(m.split(" ", 1)) if isinstance(m, str) else tuple(m) for m in spec["merges"]]
        self.ranks = {m: i for i, m in reversed(list(enumerate(merges)))}
        self.unk = spec.get("unk_token")
        self.fuse_unk = bool(spec.get("fuse_unk", False))
        self.ignore_merges = bool(spec.get("ignore_merges", False))
        self.cache: dict[str, list[tuple[int, int, int]]] = {}

    def __call__(self, word: str) -> list[tuple[int, int, int]]:
        """(id, start, end) of each token of `word`, in its characters."""
        hit = self.cache.get(word)
        if hit is not None:
            return hit
        if self.ignore_merges and word in self.vocab:
            out = [(self.vocab[word], 0, len(word))]
        else:
            parts = list(word)
            while len(parts) > 1:
                best, at = None, -1
                for i in range(len(parts) - 1):
                    r = self.ranks.get((parts[i], parts[i + 1]))
                    if r is not None and (best is None or r < best):
                        best, at = r, i
                if best is None:
                    break
                pair = (parts[at], parts[at + 1])
                merged, i = [], 0
                while i < len(parts):
                    if i < len(parts) - 1 and (parts[i], parts[i + 1]) == pair:
                        merged.append(parts[i] + parts[i + 1])
                        i += 2
                    else:
                        merged.append(parts[i])
                        i += 1
                parts = merged
            out, pos = [], 0
            for p in parts:
                tid = self.vocab.get(p)
                if tid is None:
                    if self.unk is None:  # an unknown piece is dropped, as `tokenizers` drops it
                        pos += len(p)
                        continue
                    if self.fuse_unk and out and out[-1][0] == self.vocab[self.unk]:
                        out[-1] = (out[-1][0], out[-1][1], pos + len(p))
                        pos += len(p)
                        continue
                    tid = self.vocab[self.unk]
                out.append((tid, pos, pos + len(p)))
                pos += len(p)
        self.cache[word] = out
        return out


class _Unigram:
    """Unigram over one word: the best-scoring segmentation (Viterbi, as
    `tokenizers`' optimized encoder: the first candidate keeps a tie);
    characters that no piece covers become `unk_id`, consecutive ones fused."""

    _UNK_PENALTY = 10.0

    def __init__(self, spec: dict):
        self.byte_fallback = bool(spec.get("byte_fallback"))
        pieces = [(p, float(s)) for p, s in spec["vocab"]]
        self.vocab = {p: i for i, (p, _) in reversed(list(enumerate(pieces)))}
        self.scores = [s for _, s in pieces]
        self.unk_id = spec.get("unk_id")
        self.max_len = max((len(p) for p, _ in pieces), default=1)
        self.unk_score = min(self.scores, default=0.0) - self._UNK_PENALTY
        self.cache: dict[str, list[tuple[int, int, int]]] = {}

    def __call__(self, word: str) -> list[tuple[int, int, int]]:
        hit = self.cache.get(word)
        if hit is not None:
            return hit
        n = len(word)
        score = [0.0] * (n + 1)
        start: list[typ.Optional[int]] = [None] * (n + 1)
        ids = [0] * (n + 1)
        vocab, scores = self.vocab, self.scores
        for s in range(n):
            base = score[s]
            single = False
            for e in range(s + 1, min(n, s + self.max_len) + 1):
                tid = vocab.get(word[s:e])
                if tid is None:
                    continue
                cand = scores[tid] + base
                if start[e] is None or cand > score[e]:
                    score[e], start[e], ids[e] = cand, s, tid
                if e == s + 1:
                    single = True
            if not single:
                if self.unk_id is None:
                    raise ValueError(f"the Unigram model has no unk_id for {word[s]!r}")
                cand = self.unk_score + base
                if start[s + 1] is None or cand > score[s + 1]:
                    score[s + 1], start[s + 1], ids[s + 1] = cand, s, self.unk_id
        out: list[tuple[int, int, int]] = []
        e = n
        while e > 0:
            s = start[e]
            if ids[e] == self.unk_id and out and out[-1][0] == self.unk_id:
                out[-1] = (self.unk_id, s, out[-1][2])
            else:
                out.append((ids[e], s, e))
            e = s
        out.reverse()
        # a fused run of unknown characters that spells a piece is that piece;
        # with byte_fallback one that does not is its UTF-8 bytes' `<0xXX>`
        # pieces (each spanning the run), where all of them exist
        tokens = []
        for tid, s, e in out:
            if tid == self.unk_id:
                tid = vocab.get(word[s:e], tid)
                if tid == self.unk_id and self.byte_fallback:
                    byte_ids = [vocab.get(f"<0x{b:02X}>") for b in word[s:e].encode("utf-8")]
                    if None not in byte_ids:
                        tokens += [(b, s, e) for b in byte_ids]
                        continue
            tokens.append((tid, s, e))
        self.cache[word] = tokens
        return tokens


class _WordLevel:
    """A word is its vocabulary id, else the `unk_token`'s."""

    def __init__(self, spec: dict):
        self.vocab = {t: int(i) for t, i in spec["vocab"].items()}
        self.unk_id = self.vocab.get(spec.get("unk_token", "<unk>"))

    def __call__(self, word: str) -> list[tuple[int, int, int]]:
        tid = self.vocab.get(word, self.unk_id)
        if tid is None:
            raise ValueError(f"the WordLevel model has no unk_token for {word!r}")
        return [(tid, 0, len(word))]


# -- post-processors -------------------------------------------------------------------------
def _trim_offsets(tokens: list[tuple[int, str, tuple[int, int]]], add_prefix_space: bool) -> list:
    """ByteLevel's `process_offsets`: each token's offsets lose its leading
    and trailing spaces (but the first token's one added prefix space)."""
    out = []
    for i, (tid, value, (a, b)) in enumerate(tokens):
        lead = len(value) - len(value.lstrip(_SPACE_CHAR + _WHITESPACE))
        trail = len(value) - len(value.rstrip(_SPACE_CHAR + _WHITESPACE))
        if lead and (i == 0 or a == 0) and add_prefix_space and lead == 1:
            lead = 0
        if lead:
            a = min(a + lead, b)
        if trail and b >= trail:
            b = max(b - trail, a)
        out.append((tid, value, (a, b)))
    return out


class _Post:
    """The post-processor: `n_special(pair)` tokens, and `wrap(a, b)` from
    the sequences' (id, value, offsets) tokens to (ids, type ids, offsets).
    A template item is ("S", id, type) for a special token, or (name, type)
    for the sequence "A" or "B"."""

    def __init__(self, spec: typ.Optional[dict]):
        kind = None if spec is None else spec["type"]
        self.template: typ.Optional[tuple[list, list]] = None
        # `trim_offsets` (ByteLevel, RobertaProcessing): the `add_prefix_space` it reads, else None
        self.trim = spec.get("add_prefix_space", True) if kind in ("ByteLevel", "RobertaProcessing") and \
            spec.get("trim_offsets", True) else None
        if kind == "RobertaProcessing":  # <s> A </s> and <s> A </s></s> B </s>, type 0 throughout
            c, s = ("S", spec["cls"][1], 0), ("S", spec["sep"][1], 0)
            self.template = ([c, ("A", 0), s], [c, ("A", 0), s, s, ("B", 0), s])
        elif kind == "TemplateProcessing":
            specials = {k: v["ids"] for k, v in spec["special_tokens"].items()}

            def parse(items: list) -> list:
                out = []
                for it in items:
                    if "Sequence" in it:
                        out.append((it["Sequence"]["id"], it["Sequence"]["type_id"]))
                    else:
                        out += [("S", tid, it["SpecialToken"]["type_id"]) for tid in specials[it["SpecialToken"]["id"]]]
                return out

            self.template = (parse(spec["single"]), parse(spec["pair"]))
        elif kind not in (None, "ByteLevel"):
            raise NotImplementedError(f"the {kind!r} post-processor {_NOT_READ}")

    def n_special(self, pair: bool) -> int:
        return 0 if self.template is None else sum(1 for t in self.template[int(pair)] if t[0] == "S")

    def wrap(self, a: list, b: typ.Optional[list], add_special_tokens: bool) -> tuple[list, list, list]:
        if self.trim is not None:
            a = _trim_offsets(a, self.trim)
            b = None if b is None else _trim_offsets(b, self.trim)
        if not add_special_tokens or self.template is None:
            seqs = [(a, 0)] + ([] if b is None else [(b, 1)])
            ids = [t[0] for s, _ in seqs for t in s]
            types = [ty for s, ty in seqs for _ in s]
            offs = [t[2] for s, _ in seqs for t in s]
            return ids, types, offs
        ids, types, offs = [], [], []
        for item in self.template[0 if b is None else 1]:
            if item[0] == "S":
                ids.append(item[1])
                types.append(item[2])
                offs.append((0, 0))
            else:
                seq = a if item[0] == "A" else b
                ids += [t[0] for t in seq]
                types += [item[1]] * len(seq)
                offs += [t[2] for t in seq]
        return ids, types, offs


# -- the tokenizer ---------------------------------------------------------------------------
class _AddedToken(typ.NamedTuple):
    id: int
    content: str
    single_word: bool = False
    lstrip: bool = False
    rstrip: bool = False
    normalized: bool = False
    special: bool = True


def _is_word(c: str) -> bool:
    return c.isalnum() or c == "_"


class JsonTokenizer:
    """A tokenizer read from a `tokenizer.json` (see the module); `__call__`
    follows the `transformers` calling convention as `WordPieceTokenizer`
    does, and returns `token_type_ids` only when asked
    (`return_token_type_ids=True`), as these families' fast tokenizers do."""

    def __init__(self, spec: dict, config: typ.Optional[dict] = None):
        config = dict(config or {})
        self._spec, self._config = spec, config
        model = spec["model"]
        kind = model.get("type") or ("Unigram" if isinstance(model.get("vocab"), list) else "BPE")
        if kind == "BPE":
            self.model: typ.Callable[[str], list] = _BPE(model)
            vocab = dict(self.model.vocab)
        elif kind == "Unigram":
            self.model = _Unigram(model)
            vocab = dict(self.model.vocab)
        elif kind == "WordLevel":
            self.model = _WordLevel(model)
            vocab = dict(self.model.vocab)
        else:
            raise NotImplementedError(f"a tokenizer.json with a {kind!r} model {_NOT_READ}")
        self.model_type = kind
        self.tokenizer_class = config.get("tokenizer_class")
        self._model_vocab_size = len(vocab)
        # `tokenizers` gives an added token the model's id of its content, else
        # the next id past the model's vocabulary (special tokens first), what
        # the file says notwithstanding
        added, top = {}, len(vocab)
        spec_added = spec.get("added_tokens") or []
        for t in [t for t in spec_added if t.get("special")] + [t for t in spec_added if not t.get("special")]:
            if any(a.content == t["content"] for a in added.values()):
                continue
            tid = vocab.get(t["content"])
            if tid is None:
                tid, top = top, top + 1
            added[tid] = _AddedToken(tid, t["content"], bool(t.get("single_word", False)),
                                     bool(t.get("lstrip", False)), bool(t.get("rstrip", False)),
                                     bool(t.get("normalized", False)), bool(t.get("special", False)))
        for tid, t in (config.get("added_tokens_decoder") or {}).items():
            added[int(tid)] = _AddedToken(int(tid), t["content"], bool(t.get("single_word", False)),
                                          bool(t.get("lstrip", False)), bool(t.get("rstrip", False)),
                                          bool(t.get("normalized", False)), bool(t.get("special", False)))
        self.vocab = dict(vocab)
        for t in added.values():
            self.vocab[t.content] = t.id
        self.ids_to_tokens = {i: t for t, i in self.vocab.items()}
        cls_key = _class_key(self.tokenizer_class)
        specials = dict(_CLASS_SPECIALS.get(cls_key, {}))
        for attr in _SPECIAL_ATTRS:
            value = config.get(attr)
            if isinstance(value, dict):
                value = value.get("content")
            if value is not None:
                specials[attr] = value
        self._specials = {a: specials[a] for a in _SPECIAL_ATTRS if a in specials and specials[a] in self.vocab}
        for attr in _SPECIAL_ATTRS:
            setattr(self, attr, self._specials.get(attr))
            setattr(self, f"{attr}_id", self.vocab.get(self._specials[attr]) if attr in self._specials else None)
        if cls_key in _MASK_LSTRIP and self.mask_token is not None:
            mid = self.vocab[self.mask_token]
            added[mid] = _AddedToken(mid, self.mask_token, lstrip=True, rstrip=False, normalized=False, special=True)
        for attr, value in self._specials.items():  # special tokens are added tokens
            tid = self.vocab[value]
            if tid not in added:
                added[tid] = _AddedToken(tid, value, special=True)
        self.added = sorted(added.values(), key=lambda t: t.id)
        self._raw_re = self._added_re([t for t in self.added if not t.normalized])
        self._norm_re = self._added_re([t for t in self.added if t.normalized])
        self._added_by_content = {t.content: t for t in self.added}
        # `transformers` sets a pre-tokenizer's `add_prefix_space` from its
        # own argument (default False), and these classes the post-processor's
        pre, post = spec.get("pre_tokenizer"), spec.get("post_processor")
        prefix = bool(config.get("add_prefix_space", False))
        if pre is not None and "add_prefix_space" in pre:
            pre = dict(pre, add_prefix_space=prefix)
        if post is not None and cls_key in _SETS_POST:
            post = dict(post, **{k: v for k, v in (("add_prefix_space", prefix),
                                                   ("trim_offsets", bool(config.get("trim_offsets", True))))
                                 if k in post})
        self.normalizer = _normalizer(spec.get("normalizer"))
        self.pre_tokenizer = _pre_tokenizer(pre)
        self.post = _Post(post)

    @staticmethod
    def _added_re(tokens: list[_AddedToken]) -> typ.Optional[re.Pattern]:
        if not tokens:
            return None
        return re.compile("|".join(re.escape(t.content) for t in sorted(tokens, key=lambda t: -len(t.content))))

    # -- construction ------------------------------------------------------
    @classmethod
    def from_pretrained(cls, name_or_path: typ.Union[str, pathlib.Path]) -> "JsonTokenizer":
        """From a local directory holding `tokenizer.json` (and, where it has
        one, `tokenizer_config.json`). Nothing is downloaded."""
        p = pathlib.Path(name_or_path)
        with open(p / "tokenizer.json", encoding="utf-8") as f:
            spec = json.load(f)
        return cls(spec, _read_config(p))

    @classmethod
    def from_vocab_and_merges(cls, directory: typ.Union[str, pathlib.Path]) -> "JsonTokenizer":
        """A byte-level BPE from `vocab.json` and `merges.txt`, built as
        `transformers` converts a RoBERTa tokenizer: `ByteLevel`
        pre-tokenizer, `RobertaProcessing` with `trim_offsets`, and
        `add_prefix_space` from `tokenizer_config.json` (default False)."""
        p = pathlib.Path(directory)
        config = _read_config(p)
        config.setdefault("tokenizer_class", "RobertaTokenizerFast")
        with open(p / "vocab.json", encoding="utf-8") as f:
            vocab = json.load(f)
        with open(p / "merges.txt", encoding="utf-8") as f:
            lines = [ln.rstrip("\n") for ln in f]
        merges = [ln for i, ln in enumerate(lines) if ln and not (i == 0 and ln.startswith("#version"))]
        prefix = bool(config.get("add_prefix_space", False))
        specials = dict(_CLASS_SPECIALS.get(_class_key(config["tokenizer_class"]), _ROBERTA_SPECIALS))
        added = [dict(id=vocab[v], content=v, single_word=False, lstrip=False, rstrip=False, normalized=False,
                      special=True) for v in dict.fromkeys(specials.values()) if v in vocab]
        byte_level = {"type": "ByteLevel", "add_prefix_space": prefix, "trim_offsets": True, "use_regex": True}
        spec = {
            "version": "1.0", "truncation": None, "padding": None,
            "added_tokens": sorted(added, key=lambda t: t["id"]),
            "normalizer": None,
            "pre_tokenizer": byte_level,
            "post_processor": {"type": "RobertaProcessing", "trim_offsets": True, "add_prefix_space": prefix,
                               "sep": [specials["sep_token"], vocab[specials["sep_token"]]],
                               "cls": [specials["cls_token"], vocab[specials["cls_token"]]]},
            "decoder": byte_level,
            "model": {"type": "BPE", "dropout": None, "unk_token": None, "continuing_subword_prefix": "",
                      "end_of_word_suffix": "", "fuse_unk": False, "byte_fallback": False, "ignore_merges": False,
                      "vocab": vocab, "merges": merges},
        }
        return cls(spec, config)

    # -- vocabulary ----------------------------------------------------------
    @property
    def vocab_size(self) -> int:
        """The model's vocabulary, without added tokens (`transformers`'
        `vocab_size`; `len()` counts them)."""
        return self._model_vocab_size

    def __len__(self) -> int:
        return len(self.vocab)

    def get_vocab(self) -> dict[str, int]:
        return dict(self.vocab)

    @property
    def special_tokens_map(self) -> dict[str, str]:
        return dict(self._specials)

    @property
    def all_special_ids(self) -> list[int]:
        return sorted({self.vocab[v] for v in self._specials.values()})

    def convert_tokens_to_ids(self, tokens: typ.Union[str, typ.Sequence[str]]) -> typ.Union[int, list[int]]:
        if isinstance(tokens, str):
            return self.vocab.get(tokens, self.unk_token_id)
        return [self.vocab.get(t, self.unk_token_id) for t in tokens]

    def convert_ids_to_tokens(self, ids: typ.Union[int, typ.Sequence[int]]) -> typ.Union[str, list[str]]:
        if isinstance(ids, (int, np.integer)):
            return self.ids_to_tokens.get(int(ids))
        return [self.ids_to_tokens.get(int(i)) for i in ids]

    # -- the pipeline ----------------------------------------------------------
    def _split_added(self, piece: Piece, pattern: typ.Optional[re.Pattern]) -> list[tuple[typ.Optional[int], Piece]]:
        """`piece` cut around the added tokens that `pattern` finds, each
        match grown by its `lstrip` / `rstrip` whitespace: (token id or
        None, piece)."""
        text, align = piece
        if pattern is None or not text:
            return [(None, piece)]
        out: list[tuple[typ.Optional[int], Piece]] = []
        last = 0
        for m in pattern.finditer(text):
            tok = self._added_by_content[m.group()]
            a, b = m.span()
            if a < last:
                continue
            if tok.single_word and ((a > 0 and _is_word(text[a - 1])) or (b < len(text) and _is_word(text[b]))):
                continue
            if tok.lstrip:
                while a > last and text[a - 1] in _WS_SET:
                    a -= 1
            if tok.rstrip:
                while b < len(text) and text[b] in _WS_SET:
                    b += 1
            if last < a:
                out.append((None, (text[last:a], align[last:a])))
            out.append((tok.id, (text[a:b], align[a:b])))
            last = b
        if last < len(text):
            out.append((None, (text[last:], align[last:])))
        return out

    def _encode(self, text: str) -> list[tuple[int, str, tuple[int, int]]]:
        """(id, value, original offsets) of each token of one text, without
        the post-processor's special tokens."""
        splits: list[tuple[typ.Optional[int], Piece]] = []
        for tid, piece in self._split_added((text, [(i, i + 1) for i in range(len(text))]), self._raw_re):
            if tid is not None:
                splits.append((tid, piece))
            else:
                splits += self._split_added(self.normalizer(piece), self._norm_re)
        tokens: list[tuple[int, str, tuple[int, int]]] = []
        for tid, piece in splits:
            if tid is not None:
                tokens.append((tid, piece[0], (piece[1][0][0], piece[1][-1][1]) if piece[1] else (0, 0)))
                continue
            for word, align in self.pre_tokenizer(piece):
                for wid, a, b in self.model(word):
                    tokens.append((wid, word[a:b], (align[a][0], align[b - 1][1])))
        return tokens

    def tokenize(self, text: str) -> list[str]:
        return self.convert_ids_to_tokens([t[0] for t in self._encode(text)])

    def decode(self, ids: typ.Iterable[int], skip_special_tokens: bool = False) -> str:
        """Text of `ids` through the file's decoder: `ByteLevel` (the bytes
        the characters stand for, read as UTF-8), `Metaspace` (the
        replacement back to spaces, the first one dropped unless it was
        never prepended), or the tokens joined by spaces."""
        specials = {t.id for t in self.added if t.special} if skip_special_tokens else set()
        tokens = self.convert_ids_to_tokens([int(i) for i in ids if int(i) not in specials])
        spec = self._spec.get("decoder") or {}
        kind = spec.get("type")
        if kind == "ByteLevel":
            inverse = {c: b for b, c in _BYTE_CHARS.items()}
            text = "".join(tokens)
            return bytes(inverse[c] for c in text if c in inverse).decode("utf-8", errors="replace")
        if kind == "Metaspace":
            text = "".join(tokens).replace(spec.get("replacement", "▁"), " ")
            scheme = spec.get("prepend_scheme", "always" if spec.get("add_prefix_space", True) else "never")
            return text[1:] if scheme != "never" and text.startswith(" ") else text
        return " ".join(tokens)

    def save_pretrained(self, directory: typ.Union[str, pathlib.Path]) -> None:
        """`tokenizer.json` (the pipeline this tokenizer reads) and
        `tokenizer_config.json`, which `from_pretrained` and
        `transformers.AutoTokenizer` read back."""
        d = pathlib.Path(directory)
        d.mkdir(parents=True, exist_ok=True)
        (d / "tokenizer.json").write_text(json.dumps(self._spec, ensure_ascii=False))
        (d / "tokenizer_config.json").write_text(json.dumps(self._config, indent=2))

    def __call__(
        self,
        text: typ.Union[str, typ.Sequence[str]],
        text_pair: typ.Optional[typ.Union[str, typ.Sequence[str]]] = None,
        *,
        max_length: typ.Optional[int] = None,
        truncation: typ.Union[bool, str] = False,
        padding: typ.Union[bool, str] = False,
        add_special_tokens: bool = True,
        return_offsets_mapping: bool = False,
        return_token_type_ids: bool = False,
        return_tensors: typ.Optional[str] = None,
    ) -> dict[str, typ.Any]:
        """Encode one text or a list of texts, or pairs of them, as
        `WordPieceTokenizer.__call__` does, with this file's special tokens;
        a pair truncates `longest_first`."""
        single = isinstance(text, str)
        texts = [text] if single else list(text)
        pairs = None if text_pair is None else ([text_pair] if isinstance(text_pair, str) else list(text_pair))
        if pairs is not None and len(pairs) != len(texts):
            raise ValueError(f"{len(texts)} texts but {len(pairs)} text pairs")
        if truncation not in (False, True, "longest_first", "do_not_truncate"):
            raise ValueError(f"unsupported truncation {truncation!r}")
        truncate = truncation not in (False, "do_not_truncate") and max_length is not None
        n_special = self.post.n_special(pairs is not None) if add_special_tokens else 0
        budget = max(0, max_length - n_special) if truncate else None
        rows, types, offs = [], [], []
        for i, t in enumerate(texts):
            a = self._encode(t)
            b = None if pairs is None else self._encode(pairs[i])
            if budget is not None:
                if b is None:
                    a = a[:budget]
                elif len(a) + len(b) > budget:
                    n_a, n_b = _longest_first(len(a), len(b), budget)
                    a, b = a[:n_a], b[:n_b]
            ids, tt, off = self.post.wrap(a, b, add_special_tokens)
            rows.append(ids)
            types.append(tt)
            offs.append(off)
        return batch_output(rows, types, offs, pad_id=self.pad_token_id if self.pad_token_id is not None else 0,
                            single=single, max_length=max_length, padding=padding, return_tensors=return_tensors,
                            offsets=return_offsets_mapping, token_types=return_token_type_ids)


def _read_config(directory: pathlib.Path) -> dict:
    path = directory / "tokenizer_config.json"
    if not path.is_file():
        return {}
    with open(path, encoding="utf-8") as f:
        return json.load(f)
