"""The port's tokenizer.json readers (`data/tokenizer_json.py`) and the
directory dispatch (`data/tokenizer.py:load_tokenizer`, behind
`configs/dataloaders.py:TokenizerConfig.instantiate`) against JAX's
`TokenizerConfig(...).instantiate()`, which is `transformers.AutoTokenizer`.

The tokenizers are trained here with the installed `tokenizers` trainers on
`tests/fixtures/beir_tiny`'s text: a byte-level BPE with RoBERTa's
post-processor (`RobertaTokenizerFast`), the same with `add_prefix_space`,
the same as `vocab.json` + `merges.txt`, and three Unigram ones over Metaspace
(`XLMRobertaTokenizerFast`: XLM-R's NFKC + whitespace-run normalizer with
`prepend_scheme: always`; NFD, accent strip, lower case with `first`; and
NFKD, strip, a prepended `▁`, whitespace splitting and an unsplit
Metaspace).
Ids, masks and offsets are compared exactly, on the fixture's texts, on edge
cases (accents composed and decomposed, CJK, emoji, whitespace runs,
special tokens inside the text, compatibility forms), on a seeded sweep of
random strings, and on pairs with truncation and padding. The CLI then takes
a step with a tiny random RoBERTa and the BPE directory with `tokenizers`
and `transformers` blocked.
"""

import json
import random
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from vod_tpu.configs.dataloaders import TokenizerConfig as JaxTokenizerConfig
from vod_tpu_torch.configs.dataloaders import TokenizerConfig
from vod_tpu_torch.data.tokenizer import WordPieceTokenizer, load_tokenizer
from vod_tpu_torch.data.tokenizer_json import JsonTokenizer

ROOT = Path(__file__).resolve().parent.parent
FIXTURE = ROOT / "tests" / "fixtures" / "beir_tiny"
SPECIALS = ["<s>", "<pad>", "</s>", "<unk>", "<mask>"]
EDGE = [
    "Paris is the capital of France.",
    "Café naïve über ÀÉÎÕÜ straße İstanbul ΣΑΣ",
    "Café naïve été ́ͅ",
    "東京は日本の首都です 北京",
    "I 😀 👍🏽 Paris 🗼!",
    "  two  spaces\t\ttabs\n\nnewlines   ",
    "a <mask> b<s>c</s> <pad>x  <mask>  y",
    "ﬁne Ａ① … don't we'll 3.14",
    "",
    "   ",
]
POOL = list("abcdeéfghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789 .,!?'-") + [
    "  ", "\t", "\n", "　", "\xa0", "ﬁ", "Ａ", "①", "東", "京", "😀", "👍🏽", "é", "́", "ß", "Σ",
    "<mask>", "<s>", "</s>", "İ", "​", "\x00", "ᄀ", "ᅡ",
]


def _fixture_texts() -> list[str]:
    rows = [json.loads(line) for line in (FIXTURE / "corpus.jsonl").read_text().splitlines()]
    rows += [json.loads(line) for line in (FIXTURE / "queries.jsonl").read_text().splitlines()]
    return [(r.get("title", "") + " " + r["text"]).strip() for r in rows]


@pytest.fixture(scope="module")
def dirs(tmp_path_factory) -> dict[str, Path]:
    from tokenizers import Regex, Tokenizer, models, normalizers, pre_tokenizers, processors, trainers

    out = tmp_path_factory.mktemp("tokenizers")
    texts = _fixture_texts()

    def save(tok, name: str, config: dict) -> Path:
        (out / name).mkdir()
        tok.save(str(out / name / "tokenizer.json"))
        (out / name / "tokenizer_config.json").write_text(json.dumps(config))
        return out / name

    bpe = Tokenizer(models.BPE())
    bpe.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    bpe.train_from_iterator(texts, trainers.BpeTrainer(vocab_size=400, special_tokens=SPECIALS,
                                                       initial_alphabet=pre_tokenizers.ByteLevel.alphabet()))
    bpe.post_processor = processors.RobertaProcessing(("</s>", 2), ("<s>", 0), trim_offsets=True,
                                                      add_prefix_space=False)
    roberta = {"tokenizer_class": "RobertaTokenizerFast"}
    found = {"bpe": save(bpe, "bpe", roberta),
             "bpe-prefix": save(bpe, "bpe-prefix", {**roberta, "add_prefix_space": True})}
    (out / "vocab-merges").mkdir()
    bpe.model.save(str(out / "vocab-merges"))
    (out / "vocab-merges" / "tokenizer_config.json").write_text(json.dumps(roberta))
    found["vocab-merges"] = out / "vocab-merges"
    for name, norm, pre in (
        ("unigram", normalizers.Sequence([normalizers.NFKC(), normalizers.Replace(Regex(" {2,}"), " ")]),
         pre_tokenizers.Metaspace(replacement="▁", prepend_scheme="always")),
        ("unigram-first",
         normalizers.Sequence([normalizers.NFD(), normalizers.StripAccents(), normalizers.Lowercase()]),
         pre_tokenizers.Metaspace(replacement="▁", prepend_scheme="first")),
        ("unigram-split", normalizers.Sequence([normalizers.NFKD(), normalizers.Strip(), normalizers.Prepend("▁")]),
         pre_tokenizers.Sequence([pre_tokenizers.WhitespaceSplit(),
                                  pre_tokenizers.Metaspace(prepend_scheme="never", split=False)])),
    ):
        uni = Tokenizer(models.Unigram())
        uni.normalizer = norm
        uni.pre_tokenizer = pre
        uni.train_from_iterator(texts, trainers.UnigramTrainer(vocab_size=120, special_tokens=SPECIALS,
                                                               unk_token="<unk>"))
        uni.post_processor = processors.TemplateProcessing(
            single="<s> $A </s>", pair="<s> $A </s> </s> $B </s>", special_tokens=[("<s>", 0), ("</s>", 2)])
        found[name] = save(uni, name, {"tokenizer_class": "XLMRobertaTokenizerFast"})
    return found


KINDS = ["bpe", "bpe-prefix", "vocab-merges", "unigram", "unigram-first", "unigram-split"]


def _both(dirs: dict, kind: str):
    return JaxTokenizerConfig(name_or_path=str(dirs[kind])).instantiate(), \
        TokenizerConfig(name_or_path=str(dirs[kind])).instantiate()


@pytest.mark.parametrize("kind", KINDS)
def test_ids_masks_and_offsets_equal_jax(kind: str, dirs) -> None:
    want, got = _both(dirs, kind)
    assert isinstance(got, JsonTokenizer) and got.model_type == ("Unigram" if "unigram" in kind else "BPE")
    rng = random.Random(0)
    sweep = ["".join(rng.choice(POOL) for _ in range(rng.randint(0, 20))) for _ in range(150)]
    for text in _fixture_texts() + EDGE + sweep:
        for special in (True, False):
            a = want(text, add_special_tokens=special, return_offsets_mapping=True)
            b = got(text, add_special_tokens=special, return_offsets_mapping=True)
            assert (b["input_ids"], b["attention_mask"], b["offset_mapping"]) == \
                (a["input_ids"], a["attention_mask"], a["offset_mapping"]), (text, special)
    assert sorted(want(EDGE[0])) == sorted(got(EDGE[0])) == ["attention_mask", "input_ids"]


@pytest.mark.parametrize("kind", KINDS)
def test_pairs_truncation_and_padding_equal_jax(kind: str, dirs) -> None:
    want, got = _both(dirs, kind)
    texts = _fixture_texts() + EDGE
    firsts, seconds = texts[: len(texts) // 2], texts[len(texts) // 2 : 2 * (len(texts) // 2)]
    for max_length in (6, 12, 40):
        kw = dict(max_length=max_length, truncation=True, padding="max_length", return_offsets_mapping=True,
                  return_tensors="np")
        for a, b in ((want(firsts, seconds, return_token_type_ids=True, **kw),
                      got(firsts, seconds, return_token_type_ids=True, **kw)),
                     (want(texts, **kw), got(texts, **kw))):
            assert set(a) == set(b)
            for key in a:
                assert b[key].dtype == np.int64
                np.testing.assert_array_equal(b[key], a[key], err_msg=f"{key} at {max_length}")


@pytest.mark.parametrize("kind", ["bpe", "unigram"])
def test_the_calling_surface_equals_jax(kind: str, dirs, tmp_path: Path) -> None:
    want, got = _both(dirs, kind)
    assert got.special_tokens_map == want.special_tokens_map
    assert (got.pad_token_id, got.vocab_size, len(got)) == (want.pad_token_id, want.vocab_size, len(want))
    assert got.get_vocab() == want.get_vocab()
    ids = want("Paris <mask> France")["input_ids"]
    assert got.convert_ids_to_tokens(ids) == want.convert_ids_to_tokens(ids)
    toks = want.convert_ids_to_tokens(ids)
    assert got.convert_tokens_to_ids(toks) == want.convert_tokens_to_ids(toks)
    assert got.convert_tokens_to_ids("never-a-token") == want.convert_tokens_to_ids("never-a-token")
    assert got.tokenize("Paris is") == want.tokenize("Paris is")
    for text in EDGE:
        ids = want(text)["input_ids"]
        for skip in (True, False):
            assert got.decode(ids, skip_special_tokens=skip) == want.decode(ids, skip_special_tokens=skip), text
    got.save_pretrained(tmp_path / "saved")  # what the port writes, both packages read back
    again = load_tokenizer(tmp_path / "saved")
    theirs = JaxTokenizerConfig(name_or_path=str(tmp_path / "saved")).instantiate()
    for text in EDGE:
        want_ids = want(text, return_offsets_mapping=True)
        assert again(text, return_offsets_mapping=True) == theirs(text, return_offsets_mapping=True) == want_ids
    pt = got(["Paris", "Tokyo is"], padding=True, return_tensors="pt")
    np.testing.assert_array_equal(pt["input_ids"].numpy(), want(["Paris", "Tokyo is"], padding=True,
                                                                 return_tensors="np")["input_ids"])


def test_directories_dispatch_by_what_they_hold(dirs, tmp_path: Path) -> None:
    from tests.helpers import tiny_tokenizer

    assert load_tokenizer(dirs["unigram"]).model_type == "Unigram"
    assert load_tokenizer(dirs["vocab-merges"]).model_type == "BPE"
    bert = tiny_tokenizer()
    bert.save_pretrained(tmp_path / "bert")
    assert isinstance(load_tokenizer(tmp_path / "bert"), WordPieceTokenizer)
    (tmp_path / "bert" / "vocab.txt").unlink()  # a WordPiece tokenizer.json alone
    port, text = load_tokenizer(tmp_path / "bert"), "Paris is the capital of France"
    assert isinstance(port, WordPieceTokenizer) and port(text)["input_ids"] == bert(text)["input_ids"]
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError, match="tokenizer.json, vocab.txt, or vocab.json with merges.txt"):
        TokenizerConfig(name_or_path=str(tmp_path / "empty")).instantiate()


@pytest.mark.parametrize("part,spec", [
    ("normalizer", {"type": "Precompiled", "precompiled_charsmap": "AAAA"}),
    ("pre_tokenizer", {"type": "Digits", "individual_digits": True}),
    ("model", {"type": "WordLevel", "vocab": {"a": 0}, "unk_token": "a"}),
    ("normalizer", {"type": "NotANormalizer"}),
])
def test_unread_components_raise_naming_the_item(part: str, spec: dict, dirs, tmp_path: Path) -> None:
    """A `Precompiled` charsmap shorter than its 4-byte header ("AAAA" is 3
    bytes) raises `ValueError`; the `Digits` pre-tokenizer and the
    `WordLevel` model give the ids and offsets of `tokenizers` on the same
    file; a component the port does not know raises `NotImplementedError`
    naming ROADMAP §A item 8."""
    raw = json.loads((dirs["unigram"] / "tokenizer.json").read_text())
    raw[part] = spec
    if spec["type"] == "Precompiled":
        with pytest.raises(ValueError, match="shorter than its 4-byte header"):
            JsonTokenizer(raw)
    elif spec["type"] in ("Digits", "WordLevel"):
        from tokenizers import Tokenizer

        lib, port = Tokenizer.from_str(json.dumps(raw)), JsonTokenizer(raw)
        for text in _fixture_texts() + EDGE + ["a1b22c333 4.5 ①②Ⅻ", "x9", "12 <s>3"]:
            enc, got = lib.encode(text), port(text, return_offsets_mapping=True)
            assert (got["input_ids"], got["offset_mapping"]) == (enc.ids, [tuple(o) for o in enc.offsets]), text
    else:
        with pytest.raises(NotImplementedError, match="§A item 8"):
            JsonTokenizer(raw)


def test_cli_steps_with_a_roberta_encoder_and_the_bpe_directory(dirs, tmp_path: Path) -> None:
    """`model.name_or_path` a tiny random RoBERTa checkpoint, the tokenizer
    the BPE directory; one step through `main` with `tokenizers`,
    `transformers` and JAX blocked."""
    import torch
    import transformers

    from tests.test_torch_cli import BLOCKED

    vocab = len(_both(dirs, "bpe")[0])
    torch.manual_seed(0)
    transformers.RobertaModel(transformers.RobertaConfig(
        vocab_size=vocab, max_position_embeddings=514, type_vocab_size=1, pad_token_id=1, hidden_size=32,
        num_hidden_layers=1, num_attention_heads=2, intermediate_size=64)).save_pretrained(tmp_path / "roberta")
    beir = tmp_path / "beir"
    (beir / "qrels").mkdir(parents=True)
    for name in ("corpus.jsonl", "queries.jsonl"):
        (beir / name).write_text((FIXTURE / name).read_text())
    (beir / "qrels" / "train.tsv").write_text((FIXTURE / "qrels" / "test.tsv").read_text())
    cfg = tmp_path / "exp.yaml"
    cfg.write_text(f"""\
model: {{kind: ranker, gradients: retrieval, name_or_path: '{tmp_path / "roberta"}', vocab_size: {vocab},
        hidden_size: 32, num_layers: 1, num_heads: 2, intermediate_size: 64}}
tokenizer: {{name_or_path: '{dirs["bpe"]}', max_length: 16}}
collate: {{prefetch_n_sections: 4, n_sections: 2, max_pos_sections: 1}}
dataloader: {{batch_size: 2}}
search_defaults:
  dense: {{codec: flat, dtype: float32, approx_recall: null}}
trainer: {{max_steps: 1, period: 1, log_interval: 1, batch_size: {{effective: 2, per_device: 2}}}}
sys: {{mesh_shape: [1]}}
datasets:
  queries:
    - {{identifier: tiny-train, name_or_path: beir, subsets: ['{beir}'], split: train, link: tiny-corpus}}
  sections:
    - {{identifier: tiny-corpus, name_or_path: beir, subsets: ['{beir}']}}
""")
    code = (
        "import sys\n"
        f"for name in {BLOCKED!r}:\n"
        "    sys.modules[name] = None\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        "from vod_tpu_torch.exps.cli import main\n"
        f"out = main(['--config', {str(cfg)!r}, '--device', 'cpu'])\n"
        "assert out['state'].step == 1, out['state']\n"
        "from vod_tpu_torch.data.tokenizer_json import JsonTokenizer\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().endswith("ok")
    logs = [line for line in res.stdout.splitlines() if line.startswith("[")]
    assert len(logs) == 1 and np.isfinite(float(logs[0].split("'loss': ")[1].split(",")[0]))
