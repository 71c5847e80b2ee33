"""A BERT WordPiece tokenizer read from `vocab.txt`, giving the ids, masks and
offsets that `transformers.BertTokenizerFast` gives for the same vocabulary
and the same normalizer flags (`do_lower_case`, `strip_accents`,
`tokenize_chinese_chars`; by default lower-cased with accents stripped, and
read from the directory's `tokenizer_config.json` where it has one). The
card's machine has no `transformers` and no `tokenizers`.

The pipeline is the fast tokenizer's:
 1. the special tokens (`[PAD] [UNK] [CLS] [SEP] [MASK]`) are matched in the
    raw text first and kept whole;
 2. normalization: NUL, U+FFFD and control or other `C*` characters (but
    tab, newline and carriage return) are dropped, whitespace becomes a
    space, each CJK ideograph is set apart by spaces (`tokenize_chinese_chars`),
    accents are stripped (NFD, then nonspacing marks `Mn` dropped;
    `strip_accents`, which follows `do_lower_case` when None), and each
    character is lower-cased on its own (`do_lower_case`);
 3. pre-tokenization: split on whitespace, each punctuation character
    (ASCII punctuation or Unicode `P*`) a word of its own;
 4. WordPiece: the longest vocabulary prefix first, then `##` pieces; a
    word of more than 100 characters, or one that does not decompose, is
    `[UNK]` as a whole;
 5. `[CLS] ... [SEP]`, truncation to `max_length`, padding with `[PAD]`.

Offsets are character offsets into the input text, as the fast tokenizer
gives them; `[CLS]`, `[SEP]` and padding have (0, 0). Text that is ASCII
with no control character and no `[` takes a faster route (a regular
expression and a per-word cache) to the same result. `decode` is the fast
tokenizer's WordPiece decoder, and `save_pretrained` writes what
`from_pretrained` reads.

`load_tokenizer` picks the port's tokenizer for a local directory by what
it holds, as `AutoTokenizer` would read it: `tokenizer.json` (byte-level BPE
and Unigram: `tokenizer_json.py`), `vocab.txt` (WordPiece), or `vocab.json`
with `merges.txt` (byte-level BPE). `batch_output` is the `transformers`
output of encoded rows, shared by both modules.
"""

from __future__ import annotations

import json
import pathlib
import re
import typing as typ
import unicodedata
from itertools import chain

import numpy as np

_SPECIAL_ATTRS = ("unk_token", "sep_token", "pad_token", "cls_token", "mask_token")
# White_Space characters (Rust's `char::is_whitespace`), which normalization
# maps to a space (the `C*` ones among them are dropped first)
_WHITESPACE = frozenset(
    "\t\n\x0b\x0c\r \x85\xa0\u1680\u2000\u2001\u2002\u2003\u2004\u2005\u2006\u2007\u2008\u2009\u200a"
    "\u2028\u2029\u202f\u205f\u3000"
)
_CJK = (
    (0x4E00, 0x9FFF), (0x3400, 0x4DBF), (0x20000, 0x2A6DF), (0x2A700, 0x2B73F), (0x2B740, 0x2B81F),
    (0x2B920, 0x2CEAF), (0xF900, 0xFAFF), (0x2F800, 0x2FA1F),
)
_ASCII_PUNCT = frozenset("!\"#$%&'()*+,-./:;<=>?@[\\]^_`{|}~")
_ASCII_CONTROL = re.compile(r"[\x00-\x08\x0b\x0c\x0e-\x1f\x7f\[]")
_ASCII_WORD = re.compile(r"[a-z0-9]+|[!-/:-@\[-`{-~]")
_ASCII_WORD_CASED = re.compile(r"[A-Za-z0-9]+|[!-/:-@\[-`{-~]")
# the normalizer flags a `tokenizer_config.json` may set (`BertTokenizerFast`'s)
_CONFIG_FLAGS = ("do_lower_case", "strip_accents", "tokenize_chinese_chars")


def _is_control(c: str) -> bool:
    return c not in "\t\n\r" and unicodedata.category(c)[0] == "C"


def _is_cjk(c: str) -> bool:
    o = ord(c)
    return any(lo <= o <= hi for lo, hi in _CJK)


def _is_punct(c: str) -> bool:
    return c in _ASCII_PUNCT or unicodedata.category(c)[0] == "P"


class WordPieceTokenizer:
    """The tokenizer of a BERT `vocab.txt` (uncased unless `do_lower_case` is
    False). `__call__` follows the `transformers` calling convention for the
    arguments the port uses."""

    def __init__(
        self,
        vocab: typ.Union[typ.Mapping[str, int], typ.Sequence[str]],
        *,
        unk_token: str = "[UNK]",
        sep_token: str = "[SEP]",
        pad_token: str = "[PAD]",
        cls_token: str = "[CLS]",
        mask_token: str = "[MASK]",
        max_input_chars_per_word: int = 100,
        do_lower_case: bool = True,
        strip_accents: typ.Optional[bool] = None,
        tokenize_chinese_chars: bool = True,
    ):
        if not isinstance(vocab, typ.Mapping):
            self._lines = list(vocab)
            vocab = {tok: i for i, tok in enumerate(self._lines)}  # a repeated token keeps its last line
        else:
            self._lines = None
        self.vocab: dict[str, int] = dict(vocab)
        self.ids_to_tokens = {i: t for t, i in self.vocab.items()}
        self.unk_token, self.sep_token, self.pad_token = unk_token, sep_token, pad_token
        self.cls_token, self.mask_token = cls_token, mask_token
        self.max_input_chars_per_word = max_input_chars_per_word
        self.do_lower_case = bool(do_lower_case)
        self.strip_accents = self.do_lower_case if strip_accents is None else bool(strip_accents)
        self.tokenize_chinese_chars = bool(tokenize_chinese_chars)
        self._ascii_word = _ASCII_WORD if self.do_lower_case else _ASCII_WORD_CASED
        for attr in _SPECIAL_ATTRS:
            if getattr(self, attr) not in self.vocab:
                raise ValueError(f"the vocabulary has no {attr} {getattr(self, attr)!r}")
        self.unk_token_id = self.vocab[unk_token]
        self.sep_token_id = self.vocab[sep_token]
        self.pad_token_id = self.vocab[pad_token]
        self.cls_token_id = self.vocab[cls_token]
        self.mask_token_id = self.vocab[mask_token]
        specials = sorted({getattr(self, a) for a in _SPECIAL_ATTRS}, key=len, reverse=True)
        self._special_re = re.compile("|".join(re.escape(s) for s in specials))
        self._word_cache: dict[str, tuple[list[int], list[int]]] = {}
        self._ids_cache: dict[str, list[int]] = {}  # the ids of `_word_cache`, for the fast route

    # -- construction ------------------------------------------------------
    @classmethod
    def from_vocab_file(cls, path: typ.Union[str, pathlib.Path], **kw: typ.Any) -> "WordPieceTokenizer":
        """One token per line, its id the line's number (a line keeps any
        trailing spaces; only its newline is removed)."""
        with open(path, encoding="utf-8") as f:
            tokens = [line.rstrip("\n") for line in f.readlines()]
        return cls(tokens, **kw)

    @classmethod
    def from_pretrained(cls, name_or_path: typ.Union[str, pathlib.Path], **kw: typ.Any) -> "WordPieceTokenizer":
        """From a local directory holding `vocab.txt`, or a `vocab.txt` path.
        A hub name is not looked up: nothing is downloaded. The normalizer
        flags come from the directory's `tokenizer_config.json` where it has
        one, and `kw` overrides them."""
        p = pathlib.Path(name_or_path)
        vocab = p / "vocab.txt" if p.is_dir() else p
        if not vocab.is_file():
            raise FileNotFoundError(
                f"no vocab.txt at {str(name_or_path)!r}: the tokenizer reads a local directory holding "
                "vocab.txt and uses no network, so a hub name needs its files on disk"
            )
        config = vocab.parent / "tokenizer_config.json"
        if config.is_file():
            with open(config, encoding="utf-8") as f:
                flags = {k: v for k, v in json.load(f).items() if k in _CONFIG_FLAGS}
            kw = {**flags, **kw}
        return cls.from_vocab_file(vocab, **kw)

    # -- vocabulary ----------------------------------------------------------
    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    def get_vocab(self) -> dict[str, int]:
        return dict(self.vocab)

    @property
    def special_tokens_map(self) -> dict[str, str]:
        return {attr: getattr(self, attr) for attr in _SPECIAL_ATTRS}

    def convert_tokens_to_ids(self, tokens: typ.Union[str, typ.Sequence[str]]) -> typ.Union[int, list[int]]:
        if isinstance(tokens, str):
            return self.vocab.get(tokens, self.unk_token_id)
        return [self.vocab.get(t, self.unk_token_id) for t in tokens]

    def convert_ids_to_tokens(self, ids: typ.Union[int, typ.Sequence[int]]) -> typ.Union[str, list[str]]:
        if isinstance(ids, (int, np.integer)):
            return self.ids_to_tokens.get(int(ids), self.unk_token)
        return [self.ids_to_tokens.get(int(i), self.unk_token) for i in ids]

    # -- the pipeline ----------------------------------------------------------
    def _wordpiece(self, word: str) -> tuple[list[int], list[int]]:
        """(ids, piece end positions in `word`) of one pre-tokenized word."""
        hit = self._word_cache.get(word)
        if hit is not None:
            return hit
        n = len(word)
        if n > self.max_input_chars_per_word:
            out = ([self.unk_token_id], [n])
        else:
            ids, ends, start = [], [], 0
            while start < n:
                end = n
                while start < end:
                    piece = word[start:end] if start == 0 else "##" + word[start:end]
                    tid = self.vocab.get(piece)
                    if tid is not None:
                        break
                    end -= 1
                else:
                    ids, ends = [self.unk_token_id], [n]
                    break
                ids.append(tid)
                ends.append(end)
                start = end
            out = (ids, ends)
        self._word_cache[word] = out
        self._ids_cache[word] = out[0]
        return out

    def _words(self, text: str, base: int) -> typ.Iterator[tuple[str, list[int]]]:
        """Normalized, pre-tokenized words of a text with no special token,
        each with the original offset (from `base`) of every character."""
        chars: list[str] = []
        where: list[int] = []
        for j, c in enumerate(text):
            if c == "\0" or c == "\ufffd" or _is_control(c):
                continue
            if c in _WHITESPACE:
                chars.append(" ")
                where.append(base + j)
                continue
            if self.tokenize_chinese_chars and _is_cjk(c):
                chars += [" ", c, " "]
                where += [base + j] * 3
                continue
            for d in unicodedata.normalize("NFD", c) if self.strip_accents else c:
                if self.strip_accents and unicodedata.category(d) == "Mn":
                    continue
                for low in d.lower() if self.do_lower_case else d:
                    chars.append(low)
                    where.append(base + j)
        word: list[str] = []
        pos: list[int] = []
        for c, w in zip(chars, where):
            if c == " " or c in _WHITESPACE:
                if word:
                    yield "".join(word), pos
                word, pos = [], []
            elif _is_punct(c):
                if word:
                    yield "".join(word), pos
                word, pos = [], []
                yield c, [w]
            else:
                word.append(c)
                pos.append(w)
        if word:
            yield "".join(word), pos

    def _encode(self, text: str, with_offsets: bool) -> tuple[list[int], list[tuple[int, int]]]:
        """Token ids (and offsets) of one text, without special tokens."""
        if text.isascii() and not _ASCII_CONTROL.search(text):
            ids: list[int] = []
            offsets: list[tuple[int, int]] = []
            if not with_offsets:
                words = self._ascii_word.findall(text.lower() if self.do_lower_case else text)
                try:
                    return list(chain.from_iterable(map(self._ids_cache.__getitem__, words))), offsets
                except KeyError:
                    for w in words:
                        self._wordpiece(w)
                    return list(chain.from_iterable(map(self._ids_cache.__getitem__, words))), offsets
            for m in self._ascii_word.finditer(text.lower() if self.do_lower_case else text):
                wids, ends = self._wordpiece(m.group())
                ids += wids
                s0 = m.start()
                offsets += [(s0 + (0 if i == 0 else ends[i - 1]), s0 + e) for i, e in enumerate(ends)]
            return ids, offsets
        ids, offsets = [], []
        segments: list[tuple[int, int, typ.Optional[str]]] = []
        last = 0
        for m in self._special_re.finditer(text):
            segments.append((last, m.start(), None))
            segments.append((m.start(), m.end(), m.group()))
            last = m.end()
        segments.append((last, len(text), None))
        for s0, s1, special in segments:
            if special is not None:
                ids.append(self.vocab[special])
                offsets.append((s0, s1))
                continue
            for word, pos in self._words(text[s0:s1], s0):
                wids, ends = self._wordpiece(word)
                ids += wids
                if with_offsets:
                    starts = [0] + ends[:-1]
                    offsets += [(pos[a], pos[b - 1] + 1) for a, b in zip(starts, ends)]
        return ids, offsets

    def tokenize(self, text: str) -> list[str]:
        return self.convert_ids_to_tokens(self._encode(text, False)[0])

    def decode(self, ids: typ.Iterable[int], skip_special_tokens: bool = False) -> str:
        """Text of `ids` as the fast tokenizer's WordPiece decoder gives it:
        `##` pieces joined to the word before them, the others after a space,
        then the spaces before punctuation and contractions cleaned up."""
        specials = {self.vocab[getattr(self, a)] for a in _SPECIAL_ATTRS} if skip_special_tokens else set()
        out = []
        for tok in self.convert_ids_to_tokens([int(i) for i in ids if int(i) not in specials]):
            out.append(tok[2:] if tok.startswith("##") else (" " + tok if out else tok))
        return _clean_up_tokenization("".join(out))

    def save_pretrained(self, directory: typ.Union[str, pathlib.Path]) -> None:
        """`vocab.txt` and `tokenizer_config.json` (the normalizer flags), which
        `from_pretrained` and `transformers.AutoTokenizer` read back."""
        d = pathlib.Path(directory)
        d.mkdir(parents=True, exist_ok=True)
        lines = self._lines
        if lines is None:  # a mapping's ids, each on its line (an id it skips: an unused token)
            lines = [self.ids_to_tokens.get(i, f"[unused-{i}]") for i in range(max(self.ids_to_tokens) + 1)]
        with open(d / "vocab.txt", "w", encoding="utf-8") as f:
            f.write("".join(f"{t}\n" for t in lines))
        config = {"tokenizer_class": "BertTokenizer", "do_lower_case": self.do_lower_case,
                  "strip_accents": self.strip_accents, "tokenize_chinese_chars": self.tokenize_chinese_chars,
                  **self.special_tokens_map}
        (d / "tokenizer_config.json").write_text(json.dumps(config, indent=2))

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
        return_tensors: typ.Optional[str] = None,
    ) -> dict[str, typ.Any]:
        """Encode one text or a list of texts, or pairs of them (`text_pair`:
        `[CLS] a [SEP] b [SEP]`, token types 0 then 1): `input_ids`,
        `token_type_ids`, `attention_mask` (and `offset_mapping`), as lists,
        or as int64 arrays (`return_tensors="np"`) or tensors (`"pt"`). A
        pair truncates `longest_first` as the fast tokenizer does: when both
        texts exceed half the budget each keeps half (the longer one the odd
        token), else the longer one is cut to what the shorter leaves."""
        single = isinstance(text, str)
        texts = [text] if single else list(text)
        pairs = None if text_pair is None else ([text_pair] if isinstance(text_pair, str) else list(text_pair))
        if pairs is not None and len(pairs) != len(texts):
            raise ValueError(f"{len(texts)} texts but {len(pairs)} text pairs")
        if truncation not in (False, True, "longest_first", "do_not_truncate"):
            raise ValueError(f"unsupported truncation {truncation!r}")
        if padding not in (False, True, "longest", "max_length", "do_not_pad"):
            raise ValueError(f"unsupported padding {padding!r}")
        truncate = truncation not in (False, "do_not_truncate") and max_length is not None
        n_special = (2 if pairs is None else 3) if add_special_tokens else 0
        budget = max(0, max_length - n_special) if truncate else None
        cls, sep = ([self.cls_token_id], [self.sep_token_id]) if add_special_tokens else ([], [])
        edge = [(0, 0)] if add_special_tokens else []
        rows, types, offs = [], [], []
        for i, t in enumerate(texts):
            ids, offsets = self._encode(t, return_offsets_mapping)
            if pairs is None:
                ids, offsets = ids[:budget], offsets[:budget]
                rows.append(cls + ids + sep)
                types.append([0] * len(rows[-1]))
                offs.append(edge + offsets + edge)
                continue
            ids_b, offsets_b = self._encode(pairs[i], return_offsets_mapping)
            if budget is not None and len(ids) + len(ids_b) > budget:
                n_a, n_b = _longest_first(len(ids), len(ids_b), budget)
                ids, offsets, ids_b, offsets_b = ids[:n_a], offsets[:n_a], ids_b[:n_b], offsets_b[:n_b]
            rows.append(cls + ids + sep + ids_b + sep)
            types.append([0] * (len(cls) + len(ids) + len(sep)) + [1] * (len(ids_b) + len(sep)))
            offs.append(edge + offsets + edge + offsets_b + edge)
        return batch_output(rows, types, offs, pad_id=self.pad_token_id, single=single, max_length=max_length,
                            padding=padding, return_tensors=return_tensors, offsets=return_offsets_mapping)


def batch_output(
    rows: list[list[int]],
    types: list[list[int]],
    offs: list[list[tuple[int, int]]],
    *,
    pad_id: int,
    single: bool,
    max_length: typ.Optional[int],
    padding: typ.Union[bool, str],
    return_tensors: typ.Optional[str],
    offsets: bool,
    token_types: bool = True,
) -> dict[str, typ.Any]:
    """The `transformers` output of encoded rows (ids, token types, offsets
    each): `input_ids`, `token_type_ids` (with `token_types`),
    `attention_mask` and `offset_mapping` (with `offsets`), padded with
    `pad_id` as `padding` says, as lists (one row's for a `single` text) or
    int64 arrays (`return_tensors="np"`) or tensors (`"pt"`)."""
    if padding not in (False, True, "longest", "max_length", "do_not_pad"):
        raise ValueError(f"unsupported padding {padding!r}")
    lengths = np.fromiter((len(r) for r in rows), dtype=np.int64, count=len(rows))
    if padding in (True, "longest") or (padding == "max_length" and max_length is None):
        width = int(lengths.max(initial=0))
    elif padding == "max_length":
        width = max_length
    else:
        width = None
    if width is None:
        if return_tensors is not None and len(set(lengths.tolist())) > 1:
            raise ValueError("rows of different lengths need padding to become a tensor")
        if return_tensors is None:
            out: dict[str, typ.Any] = {"input_ids": rows}
            if token_types:
                out["token_type_ids"] = types
            out["attention_mask"] = [[1] * int(n) for n in lengths]
            if offsets:
                out["offset_mapping"] = offs
            return {k: v[0] for k, v in out.items()} if single else out
        width = int(lengths.max(initial=0))
    ids_arr = np.full((len(rows), width), pad_id, dtype=np.int64)
    type_arr = np.zeros((len(rows), width), dtype=np.int64)
    for i, (r, tt) in enumerate(zip(rows, types)):
        ids_arr[i, : len(r)] = r
        type_arr[i, : len(tt)] = tt
    mask = (np.arange(width)[None, :] < lengths[:, None]).astype(np.int64)
    out = {"input_ids": ids_arr}
    if token_types:
        out["token_type_ids"] = type_arr
    out["attention_mask"] = mask
    if offsets:
        om = np.zeros((len(rows), width, 2), dtype=np.int64)
        for i, o in enumerate(offs):
            if o:
                om[i, : len(o)] = o
        out["offset_mapping"] = om
    if return_tensors is None:
        lists = {k: v.tolist() for k, v in out.items()}
        if offsets:
            lists["offset_mapping"] = [[tuple(p) for p in row] for row in lists["offset_mapping"]]
        return {k: v[0] for k, v in lists.items()} if single else lists
    if return_tensors == "pt":
        import torch

        return {k: torch.from_numpy(v) for k, v in out.items()}
    if return_tensors != "np":
        raise ValueError(f"unsupported return_tensors {return_tensors!r}")
    return out


def _clean_up_tokenization(text: str) -> str:
    """The WordPiece decoder's clean-up of spaces before punctuation and
    English contractions."""
    for a, b in ((" .", "."), (" ?", "?"), (" !", "!"), (" ,", ","), (" ' ", "'"), (" n't", "n't"), (" 'm", "'m"),
                 (" do not", " don't"), (" 's", "'s"), (" 've", "'ve"), (" 're", "'re")):
        text = text.replace(a, b)
    return text


def _longest_first(n_a: int, n_b: int, budget: int) -> tuple[int, int]:
    """The lengths a pair keeps under `longest_first` truncation to `budget`
    tokens (the `tokenizers` rule): the shorter text keeps all of itself when
    it fits in half, the longer the rest; else each keeps half, the longer
    one the odd token (the second of two equal ones)."""
    short, long_ = min(n_a, n_b), max(n_a, n_b)
    keep_long = short if short > budget else max(short, budget - short)
    keep_short = short
    if keep_short + keep_long > budget:
        keep_short = budget // 2
        keep_long = keep_short + budget % 2
    return (keep_short, keep_long) if n_a <= n_b else (keep_long, keep_short)


def load_tokenizer(name_or_path: typ.Union[str, pathlib.Path]) -> typ.Any:
    """The port's tokenizer for a local directory, by what it holds (as
    `transformers.AutoTokenizer` would read it; nothing is downloaded):
    `tokenizer.json` -> its model (`BPE` or `Unigram`: `tokenizer_json.
    JsonTokenizer`; `WordPiece`: `WordPieceTokenizer` from `vocab.txt`, or
    from the file's vocabulary and `BertNormalizer` flags); else
    `vocab.txt` -> `WordPieceTokenizer`; else `vocab.json` with
    `merges.txt` -> a byte-level BPE. A `vocab.txt` path is read as
    WordPiece."""
    p = pathlib.Path(name_or_path)
    if p.is_file():
        return WordPieceTokenizer.from_pretrained(p)
    if (p / "tokenizer.json").is_file():
        from .tokenizer_json import JsonTokenizer

        with open(p / "tokenizer.json", encoding="utf-8") as f:
            spec = json.load(f)
        if spec["model"].get("type") != "WordPiece":
            return JsonTokenizer.from_pretrained(p)
        if not (p / "vocab.txt").is_file():
            norm = spec.get("normalizer") or {}
            flags = {k: norm[j] for k, j in (("do_lower_case", "lowercase"), ("strip_accents", "strip_accents"),
                                             ("tokenize_chinese_chars", "handle_chinese_chars")) if j in norm}
            config = p / "tokenizer_config.json"
            if config.is_file():
                with open(config, encoding="utf-8") as f:
                    flags.update({k: v for k, v in json.load(f).items() if k in _CONFIG_FLAGS})
            return WordPieceTokenizer(spec["model"]["vocab"], **flags)
    if (p / "vocab.txt").is_file():
        return WordPieceTokenizer.from_pretrained(p)
    if (p / "vocab.json").is_file() and (p / "merges.txt").is_file():
        from .tokenizer_json import JsonTokenizer

        return JsonTokenizer.from_vocab_and_merges(p)
    raise FileNotFoundError(
        f"no tokenizer at {str(name_or_path)!r}: looked for tokenizer.json, vocab.txt, or vocab.json with "
        "merges.txt in a local directory (nothing is downloaded, so a hub name needs its files on disk)"
    )
