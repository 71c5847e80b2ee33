"""The tokenizer's normalizer flags (`do_lower_case`, `strip_accents`,
`tokenize_chinese_chars`) and the config validation's number strings, held
to their references.

The port's `WordPieceTokenizer` is held to `transformers.BertTokenizerFast`
with each flag set, ids, token types, masks and offsets equal exactly; its
`TokenizerConfig.instantiate()` reads a directory's `tokenizer_config.json`
and gives the ids that JAX's `TokenizerConfig(...).instantiate()`
(`AutoTokenizer`) gives on the same directory. `configs/base.py:validate`
is held to pydantic's refusal of the int and float strings it once took.
"""

import json
from pathlib import Path

import numpy as np
import pydantic
import pytest
import transformers

from vod_tpu_torch.configs.base import validate
from vod_tpu_torch.data.tokenizer import WordPieceTokenizer

# 17 tokens: the specials, a cased and an uncased form of two words, and a few more
PROBE_VOCAB = [
    "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "Paris", "paris", "Café", "cafe",
    "Cafe", "café", ",", ".", "the", "The", "中", "##s",
]
TEXTS = [
    "Paris Café", "paris cafe", "PARIS CAFÉ", "The Cafe, the café.", "Paris中Cafés", "Café中 中the",
    "naïve École", "Café páris", "The\tParis\ncafe", "", "[CLS] Paris [MASK]",
]
FLAGS = {
    "cased": dict(do_lower_case=False),
    "cased_strip": dict(do_lower_case=False, strip_accents=True),
    "uncased_keep_accents": dict(do_lower_case=True, strip_accents=False),
    "no_chinese": dict(tokenize_chinese_chars=False),
    "cased_no_chinese": dict(do_lower_case=False, tokenize_chinese_chars=False),
    "defaults": dict(),
}


def _write(tmp_path: Path, flags: dict) -> Path:
    (tmp_path / "vocab.txt").write_text("\n".join(PROBE_VOCAB))
    (tmp_path / "tokenizer_config.json").write_text(json.dumps({**flags, "tokenizer_class": "BertTokenizer"}))
    return tmp_path


@pytest.mark.parametrize("name", sorted(FLAGS))
def test_flags_match_bert_tokenizer_fast(name: str, tmp_path: Path) -> None:
    flags = FLAGS[name]
    path = _write(tmp_path, flags)
    ref = transformers.BertTokenizerFast(vocab_file=str(path / "vocab.txt"), **flags)
    mine = WordPieceTokenizer.from_pretrained(path)
    for text in TEXTS:
        want = ref(text, return_offsets_mapping=True)
        got = mine(text, return_offsets_mapping=True)
        for key in ("input_ids", "token_type_ids", "attention_mask", "offset_mapping"):
            assert [tuple(x) if isinstance(x, (list, tuple)) else x for x in got[key]] == \
                [tuple(x) if isinstance(x, (list, tuple)) else x for x in want[key]], (name, text, key)
    batch = ["Paris Café", "The Cafe, the café."]
    want = ref(batch, padding="max_length", max_length=6, truncation=True, return_tensors="np")
    got = mine(batch, padding="max_length", max_length=6, truncation=True, return_tensors="np")
    for key in ("input_ids", "attention_mask"):
        np.testing.assert_array_equal(np.asarray(got[key]), want[key])


@pytest.mark.parametrize("name", sorted(FLAGS))
def test_instantiate_reads_tokenizer_config_as_jax(name: str, tmp_path: Path) -> None:
    """Both packages' `TokenizerConfig(name_or_path=dir).instantiate()` on the
    same directory give the same ids."""
    from vod_tpu.configs.dataloaders import TokenizerConfig as JaxTokenizerConfig
    from vod_tpu_torch.configs.dataloaders import TokenizerConfig

    path = _write(tmp_path, FLAGS[name])
    ref = JaxTokenizerConfig(name_or_path=str(path)).instantiate()
    mine = TokenizerConfig(name_or_path=str(path)).instantiate()
    for text in TEXTS:
        assert mine(text)["input_ids"] == ref(text)["input_ids"], (name, text)


def test_cased_probe_gives_jax_ids(tmp_path: Path) -> None:
    """The probe that found the fault: a cased vocabulary gives `Paris Café`."""
    from vod_tpu.configs.dataloaders import TokenizerConfig as JaxTokenizerConfig
    from vod_tpu_torch.configs.dataloaders import TokenizerConfig

    path = _write(tmp_path, {"do_lower_case": False})
    mine = TokenizerConfig(name_or_path=str(path)).instantiate()
    assert mine("Paris Café")["input_ids"] == [2, 5, 7, 3]
    assert JaxTokenizerConfig(name_or_path=str(path)).instantiate()("Paris Café")["input_ids"] == [2, 5, 7, 3]
    assert mine("paris cafe")["input_ids"] == [2, 6, 8, 3]


def test_uncased_vocab_without_config_is_unchanged(tmp_path: Path) -> None:
    """No `tokenizer_config.json`: lower-cased and accents stripped, as before."""
    (tmp_path / "vocab.txt").write_text("\n".join(PROBE_VOCAB))
    mine = WordPieceTokenizer.from_pretrained(tmp_path)
    assert (mine.do_lower_case, mine.strip_accents, mine.tokenize_chinese_chars) == (True, True, True)
    assert mine("Paris Café")["input_ids"] == [2, 6, 8, 3]
    ref = transformers.BertTokenizerFast(vocab_file=str(tmp_path / "vocab.txt"))
    for text in TEXTS:
        assert mine(text)["input_ids"] == ref(text)["input_ids"], text


def test_keyword_overrides_the_config_file(tmp_path: Path) -> None:
    path = _write(tmp_path, {"do_lower_case": False})
    assert WordPieceTokenizer.from_pretrained(path, do_lower_case=True)("Paris Café")["input_ids"] == [2, 6, 8, 3]


# values that pydantic 2 refuses and `validate` once accepted (ROADMAP §C.2)
REFUSED = [
    (int, "1."), (int, "0."), (int, "٣"), (int, "١٢"), (int, "１"), (int, "_1"), (int, "1__0"),
    (int, "1_"), (int, "1.0_0"), (int, "٣.٠"), (float, "٣"), (float, "١٢"), (float, "٣.٥"), (float, "１"),
]
ACCEPTED = [
    (int, "1"), (int, " 1 "), (int, "1.0"), (int, "-2.00"), (int, "+3"), (int, "1_000"), (int, "\xa01"),
    (float, "1."), (float, "1.5"), (float, "1e3"), (float, " 2.5 "), (float, "1_0.5"), (float, "\xa01.0\xa0"),
]


@pytest.mark.parametrize("tp,value", REFUSED, ids=[f"{t.__name__}-{v!r}" for t, v in REFUSED])
def test_validate_refuses_what_pydantic_refuses(tp: type, value: str) -> None:
    with pytest.raises(pydantic.ValidationError):
        pydantic.TypeAdapter(tp).validate_python(value)
    with pytest.raises(ValueError):
        validate(tp, value)


@pytest.mark.parametrize("tp,value", ACCEPTED, ids=[f"{t.__name__}-{v!r}" for t, v in ACCEPTED])
def test_validate_accepts_what_pydantic_accepts(tp: type, value: str) -> None:
    want = pydantic.TypeAdapter(tp).validate_python(value)
    got = validate(tp, value)
    assert type(got) is type(want) and got == want
