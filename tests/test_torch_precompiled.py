"""The port's `Precompiled` normalizer (`data/precompiled.py`), its grapheme
clusters (`data/graphemes.py`) and whole tokenizers that carry it
(`data/tokenizer_json.py`), against the `tokenizers` library and the
`regex` module, which the port imports neither of.

No real XLM-R or T5 `tokenizer.json` is on disk, so the tests build their
own charsmap: `data/precompiled.py:build_charsmap` writes a darts-clone
double array from a table of rules (NFKC of a few hundred code points,
multi-code-point sources such as `e` + U+0301 and a Hangul jamo sequence,
whitespace variants to U+0020, one character to nothing). The blob is
checked first: `tokenizers.normalizers.Precompiled(blob)` gives the rules'
outputs (for keys under the 6 bytes it looks up whole). Then, on seeded
random strings of code points assigned by Unicode 14.0 (no Indic
conjuncts, whose rule changed in 15.1): the port's clusters equal
`regex.findall(r"\\X", s)`; its normalized text equals the library's; and
tokenizers with `Precompiled` + `WhitespaceSplit`/`Metaspace` + a tiny
Unigram, with and without `byte_fallback`, under T5's and XLM-R's
post-processors, give ids, masks and offsets equal to `tokenizers`' and to
`transformers.AutoTokenizer`'s. Every comparison is exact.
"""

import base64
import json
import random
import unicodedata
from pathlib import Path

import pytest
import regex

from vod_tpu_torch.data.graphemes import graphemes
from vod_tpu_torch.data.precompiled import CharsMap, build_charsmap
from vod_tpu_torch.data.tokenizer import load_tokenizer
from vod_tpu_torch.data.tokenizer_json import JsonTokenizer

ROOT = Path(__file__).resolve().parent.parent
FIXTURE = ROOT / "tests" / "fixtures" / "beir_tiny"
JAMO = "가"  # ᄀ + ᅡ: 6 bytes, one cluster, looked up character by character


def _rules() -> dict[str, str]:
    rules = {}
    for cp in [*range(0xA0, 0x250), *range(0x2000, 0x2010), *range(0x2460, 0x2474), *range(0xFB00, 0xFB07),
               *range(0xFF01, 0xFF5F), *range(0x3131, 0x3140), *range(0x2070, 0x20A0), *range(0x2150, 0x2190),
               *range(0x1D400, 0x1D480)]:
        c = chr(cp)
        n = unicodedata.normalize("NFKC", c)
        if n != c:
            rules[c] = n
    rules.update({"é": "é", "ä": "ä", JAMO: "가", "　": " ", " ": " ", " ": " ",
                  "­": "", "ᄀ": "ㄱ"})
    return rules


RULES = _rules()
BLOB = build_charsmap(RULES)
POOL = list("abcdefxyzABC0123456789 .,!?-'") + [
    "  ", "\t", "\r\n", "\r", "\n", "\x00", "\x1f", "́", "̈", "é", "ä", "é", "ß", "ﬁ", "Ａ",
    "①", "　", " ", " ", "­", "‍", "‌", "ᄀ", "ᅡ", "ᆨ", JAMO, "가", "각", "ㄱ",
    "東", "京", "😀", "👍🏽", "👨‍👩‍👧", "❤️", "\U0001F1EB\U0001F1F7", "\U0001F1E9",
    "<s>", "</s>",
    "<unk>", "ǅ", "Ⅻ", "½", "²", "\U0001D400", "₅",
]


def _strings(seed: int, n: int) -> list[str]:
    rng = random.Random(seed)
    return ["".join(rng.choice(POOL) for _ in range(rng.randint(0, 14))) for _ in range(n)]


def test_blob_holds_the_rules() -> None:
    """The blob `build_charsmap` writes, as the library reads it: each key
    normalizes to its rule (keys of 6 bytes or more go character by
    character there), and the port's reader agrees on every key."""
    from tokenizers import normalizers

    pre, port = normalizers.Precompiled(BLOB), CharsMap(BLOB)
    assert len(RULES) > 200
    for key, value in RULES.items():
        if len(key.encode("utf-8")) < 6:
            assert pre.normalize_str(key) == value, key
        assert port.normalize_str(key) == pre.normalize_str(key), key
    assert port.normalize_str(JAMO) == pre.normalize_str(JAMO) == "ㄱᅡ"


def test_short_or_truncated_charsmaps_raise() -> None:
    for blob in (b"", b"\x01\x02\x03", (64).to_bytes(4, "little") + b"\0" * 8, (6).to_bytes(4, "little") + b"\0" * 8):
        with pytest.raises(ValueError, match="charsmap"):
            CharsMap(blob)


def test_grapheme_clusters_equal_regex() -> None:
    for s in _strings(1, 3000):
        assert graphemes(s) == regex.findall(r"\X", s), [hex(ord(c)) for c in s]


def test_normalized_text_equals_tokenizers() -> None:
    from tokenizers import normalizers

    pre, port = normalizers.Precompiled(BLOB), CharsMap(BLOB)
    for s in _strings(2, 3000):
        assert port.normalize_str(s) == pre.normalize_str(s), [hex(ord(c)) for c in s]


def _texts() -> list[str]:
    rows = [json.loads(line) for line in (FIXTURE / "corpus.jsonl").read_text().splitlines()]
    return [(r.get("title", "") + " " + r["text"]).strip() for r in rows]


@pytest.fixture(scope="module")
def trained_vocab() -> list:
    """A tiny Unigram's pieces, trained by the library on the fixture's text."""
    from tokenizers import Tokenizer, models, pre_tokenizers, trainers

    tok = Tokenizer(models.Unigram())
    tok.pre_tokenizer = pre_tokenizers.Metaspace()
    tok.train_from_iterator(_texts(), trainers.UnigramTrainer(vocab_size=150, special_tokens=["<pad>", "</s>", "<unk>"],
                                                             unk_token="<unk>"))
    return json.loads(tok.to_str())["model"]["vocab"]


def _family(name: str, vocab: list, byte_fallback: bool, tmp: Path) -> Path:
    """A directory holding T5's or XLM-R's pipeline around the charsmap."""
    from tokenizers import Regex, Tokenizer, models, normalizers, pre_tokenizers, processors

    vocab = [list(v) for v in vocab]
    if name == "xlmr":
        vocab = [["<s>", 0.0]] + vocab + [["<mask>", 0.0]]
    if byte_fallback:
        low = min(s for _, s in vocab) - 1.0
        vocab += [[f"<0x{b:02X}>", low] for b in range(256)]
    unk = [p for p, _ in vocab].index("<unk>")
    tok = Tokenizer(models.Unigram([tuple(v) for v in vocab], unk_id=unk, byte_fallback=byte_fallback))
    tok.normalizer = normalizers.Sequence([normalizers.Precompiled(BLOB), normalizers.Replace(Regex(" {2,}"), " ")])
    ids = {p: i for i, (p, _) in enumerate(vocab)}
    # the special tokens are added tokens, as in the families' own files
    tok.add_special_tokens(["<pad>", "</s>", "<unk>"] + (["<s>", "<mask>"] if name == "xlmr" else []))
    if name == "t5":
        tok.pre_tokenizer = pre_tokenizers.Sequence([pre_tokenizers.WhitespaceSplit(),
                                                     pre_tokenizers.Metaspace(prepend_scheme="always")])
        tok.post_processor = processors.TemplateProcessing(single="$A </s>", pair="$A </s> $B </s>",
                                                           special_tokens=[("</s>", ids["</s>"])])
        config = {"tokenizer_class": "T5TokenizerFast", "extra_ids": 0}
    else:
        tok.pre_tokenizer = pre_tokenizers.Metaspace(prepend_scheme="always")
        tok.post_processor = processors.TemplateProcessing(
            single="<s> $A </s>", pair="<s> $A </s> </s> $B </s>",
            special_tokens=[("<s>", ids["<s>"]), ("</s>", ids["</s>"])])
        config = {"tokenizer_class": "XLMRobertaTokenizerFast"}
    out = tmp / f"{name}-{byte_fallback}"
    out.mkdir()
    tok.save(str(out / "tokenizer.json"))
    (out / "tokenizer_config.json").write_text(json.dumps(config))
    raw = json.loads((out / "tokenizer.json").read_text())
    assert raw["normalizer"]["normalizers"][0]["type"] == "Precompiled"
    assert base64.b64decode(raw["normalizer"]["normalizers"][0]["precompiled_charsmap"]) == BLOB
    return out


@pytest.mark.parametrize("family", ["t5", "xlmr"])
@pytest.mark.parametrize("byte_fallback", [False, True], ids=["unk", "byte-fallback"])
def test_whole_tokenizer_equals_tokenizers_and_autotokenizer(family: str, byte_fallback: bool, trained_vocab,
                                                              tmp_path: Path) -> None:
    """Ids, masks and offsets of the port's reading of the directory against
    the library's `Tokenizer` and `AutoTokenizer` on the fixture's text and
    seeded random strings, with and without special tokens."""
    import transformers
    from tokenizers import Tokenizer

    directory = _family(family, trained_vocab, byte_fallback, tmp_path)
    port = load_tokenizer(directory)
    assert isinstance(port, JsonTokenizer) and port.model_type == "Unigram"
    lib = Tokenizer.from_file(str(directory / "tokenizer.json"))
    auto = transformers.AutoTokenizer.from_pretrained(str(directory))
    seen_bytes = False
    for text in _texts()[:6] + _strings(3 + byte_fallback, 300):
        enc = lib.encode(text)
        got = port(text, return_offsets_mapping=True)
        assert (got["input_ids"], got["offset_mapping"]) == (enc.ids, [tuple(o) for o in enc.offsets]), text
        want = auto(text, return_offsets_mapping=True)
        assert (got["input_ids"], got["attention_mask"], got["offset_mapping"]) == \
            (want["input_ids"], want["attention_mask"], want["offset_mapping"]), text
        bare = port(text, add_special_tokens=False)["input_ids"]
        assert bare == auto(text, add_special_tokens=False)["input_ids"], text
        seen_bytes |= any(port.convert_ids_to_tokens(i).startswith("<0x") for i in bare)
    assert seen_bytes == byte_fallback  # the pool's CJK and emoji have no piece
