"""The port's WordPiece tokenizer (`vod_tpu_torch/data/tokenizer.py`) against
`transformers.BertTokenizerFast` on the same `vocab.txt`: ids, token types,
attention masks and character offsets equal exactly, for the tiny vocabulary
of `tests/helpers.py` and for a `##` vocabulary built from
`tests/fixtures/beir_tiny`, with padding, truncation and
`add_special_tokens=False`, and on generated text mixing accented letters,
CJK ideographs, punctuation, whitespace, control characters and the special
tokens (hypothesis)."""

import json
import re
from pathlib import Path

import numpy as np
import pytest
import transformers
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from tests.helpers import _VOCAB, tiny_tokenizer
from vod_tpu_torch.data.tokenizer import WordPieceTokenizer

FIXTURE = Path(__file__).resolve().parent / "fixtures" / "beir_tiny"
CHARS = "abcdefghijklmnopqrstuvwxyz0123456789"


def _fixture_vocab() -> list[str]:
    """Specials, single characters and their `##` forms, a few suffixes, and
    the fixture's words that are not split further."""
    text = " ".join(
        json.loads(line)[k] for name in ("corpus.jsonl", "queries.jsonl")
        for line in (FIXTURE / name).read_text().splitlines() for k in ("text", "title") if k in json.loads(line)
    ).lower()
    words = sorted(set(re.findall(r"[a-z0-9]+", text)))
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", *CHARS, *("##" + c for c in CHARS), ".", ",", "?", "!"]
    vocab += ["##is", "##al", "##ion", "##ing", "cap", "##ital", "##s"]
    return vocab + [w for w in words if len(w) % 3 and w not in vocab]


def _pair(vocab: list[str], tmp_path: Path):
    path = tmp_path / "vocab.txt"
    path.write_text("\n".join(vocab))
    return transformers.BertTokenizerFast(vocab_file=str(path)), WordPieceTokenizer.from_pretrained(tmp_path)


TEXTS = [
    "The quick brown fox.", "what is the capital of France?", "", "Héllo wörld ÉCOLE naïve café",
    "tok1 tok12 tok123, [MASK] [SEP]x [CLS][PAD]", "日本語のテキスト 中文",
    "a\x00b\x01c\td\ne\u200bf\u2028g\xa0h", "\u0130stanbul \u03a3\u0391\u03a3 \u00df \ufb01", "x" * 150,
    "don't stop-me now!!! $5 <a> {b} ~c~", "paris " * 30, "\u2167 \u2460 \u00bd \u00b2",
    "\ufffd\ufeff abc", "Capitals: Paris, Tokyo and Berlin.", "  leading and trailing  ", "UPPER lower MiXeD",
]
CALLS = {
    "pad_truncate_np": dict(max_length=8, truncation=True, padding="max_length", return_tensors="np"),
    "longest_np": dict(padding=True, return_tensors="np"),
    "lists": dict(),
    "no_specials": dict(add_special_tokens=False),
    "truncate_lists": dict(max_length=5, truncation=True),
    "offsets_np": dict(return_offsets_mapping=True, max_length=12, truncation=True, padding="max_length",
                       return_tensors="np"),
}


def _assert_same(want, got) -> None:
    assert set(got) == set(want)
    for key in got:
        w = want[key]
        if isinstance(got[key], np.ndarray):
            np.testing.assert_array_equal(got[key], w, err_msg=key)
            assert got[key].dtype == w.dtype
        elif key == "offset_mapping":
            nested = bool(w) and isinstance(w[0], list)
            assert got[key] == ([[tuple(p) for p in row] for row in w] if nested else [tuple(p) for p in w])
        else:
            assert got[key] == w, key


@pytest.mark.parametrize("call", CALLS.values(), ids=CALLS.keys())
@pytest.mark.parametrize("vocab", ["tiny", "fixture"])
def test_batch_calls_equal_bert_fast(call: dict, vocab: str, tmp_path: Path) -> None:
    hf, port = _pair(_VOCAB if vocab == "tiny" else _fixture_vocab(), tmp_path)
    _assert_same(hf(TEXTS, **call), port(TEXTS, **call))


@pytest.mark.parametrize("vocab", ["tiny", "fixture"])
def test_single_text_offsets_equal_bert_fast(vocab: str, tmp_path: Path) -> None:
    hf, port = _pair(_VOCAB if vocab == "tiny" else _fixture_vocab(), tmp_path)
    for text in TEXTS:
        for kw in (dict(add_special_tokens=False, return_offsets_mapping=True), dict(return_offsets_mapping=True)):
            _assert_same(hf(text, **kw), port(text, **kw))
        assert port.tokenize(text) == hf.tokenize(text)


def test_vocabulary_surface_equals_bert_fast() -> None:
    hf, port = tiny_tokenizer(), WordPieceTokenizer(_VOCAB)
    assert port.get_vocab() == hf.get_vocab() and port.vocab_size == hf.vocab_size
    assert port.special_tokens_map == hf.special_tokens_map
    assert str(port.special_tokens_map) == str(hf.special_tokens_map)
    assert port.pad_token_id == hf.pad_token_id
    assert port.convert_tokens_to_ids("paris") == hf.convert_tokens_to_ids("paris")
    assert port.convert_tokens_to_ids(["fox", "nope"]) == hf.convert_tokens_to_ids(["fox", "nope"])


def test_the_fixture_vocab_splits_into_pieces(tmp_path: Path) -> None:
    """The `##` vocabulary really exercises the greedy longest-match pieces."""
    hf, port = _pair(_fixture_vocab(), tmp_path)
    toks = port.tokenize("Capitalisation of Berlin")
    assert any(t.startswith("##") for t in toks) and "[UNK]" not in toks
    assert toks == hf.tokenize("Capitalisation of Berlin")


def test_hub_name_without_files_raises_without_network(tmp_path: Path) -> None:
    with pytest.raises(FileNotFoundError, match="no network"):
        WordPieceTokenizer.from_pretrained("bert-base-uncased")
    with pytest.raises(ValueError, match="unk_token"):
        WordPieceTokenizer(["[PAD]", "[CLS]", "[SEP]", "[MASK]", "a"])


# accented letters, combining marks, CJK, punctuation (ASCII and general),
# whitespace of several kinds, control and format characters, digits
_ALPHABET = (
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789"
    + "".join(chr(c) for c in range(0x21, 0x30)) + " \t\n\r\x0b\x0c\x00\x01\x1f\x7f\x85\xa0"
    + "".join(chr(c) for c in range(0xC0, 0x180)) + "\u0301\u0308\u0327"
    + "".join(chr(c) for c in range(0x4E00, 0x4E20)) + "\u3001\u3002\u3000"
    + "".join(chr(c) for c in range(0x2010, 0x2028)) + "\u2028\u2029\u200b\ufeff\u00ad\ufffd"
)
_TEXT = st.lists(
    st.one_of(st.text(alphabet=_ALPHABET, max_size=12),
              st.sampled_from(["[MASK]", "[SEP]", "paris", "capital", "tok12", " ", "\t"])),
    max_size=10,
).map("".join)


@pytest.fixture(scope="module")
def fixture_pair(tmp_path_factory):
    return _pair(_fixture_vocab(), tmp_path_factory.mktemp("vocab"))


@settings(max_examples=150, deadline=None, derandomize=True,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(text=_TEXT, max_length=st.integers(3, 24))
def test_generated_text_equals_bert_fast(fixture_pair, text: str, max_length: int) -> None:
    hf, port = fixture_pair
    _assert_same(hf(text, add_special_tokens=False, return_offsets_mapping=True),
                 port(text, add_special_tokens=False, return_offsets_mapping=True))
    call = dict(max_length=max_length, truncation=True, padding="max_length", return_tensors="np")
    _assert_same(hf([text, text[::-1]], **call), port([text, text[::-1]], **call))
