"""The port's data layer (`vod_tpu_torch/data/`, `dataloaders/`) against the
JAX package's, mirroring `tests/test_data.py`: rosetta adapters (the same
adapter found, the same canonical rows), isolation, the BeIR local loader,
`harvest_text_passages`, sectioning, subsampling (HF `datasets`' shuffle),
`tokenize_corpus` / `tokenize_queries` and `RealmDataloader` batches. Every
comparison is exact (`==` on rows, `array_equal` on arrays). The JAX side
tokenizes with `transformers.BertTokenizerFast`; the port with its own
`WordPieceTokenizer` on the same vocabulary."""

import json
from pathlib import Path

import datasets
import numpy as np
import pytest
import torch

from tests.helpers import _VOCAB, tiny_tokenizer
from vod_tpu.configs.dataloaders import DataLoaderConfig as JaxDLConfig
from vod_tpu.configs.dataloaders import SamplerFactoryConfig as JaxSampler
from vod_tpu.data import corpus as jax_corpus
from vod_tpu.data import postprocessing as jax_post
from vod_tpu.data import preprocessing as jax_pre
from vod_tpu.data import sectioning as jax_sectioning
from vod_tpu.data.loaders import local_text as jax_local
from vod_tpu.data.loaders.beir import BeirDatasetLoader as JaxBeir
from vod_tpu.data.rosetta import adapters as jax_adapters
from vod_tpu.dataloaders import RealmDataloader as JaxRealmDataloader
from vod_tpu.dataloaders import TokenizerCollate as JaxCollate
from vod_tpu.dataloaders.samplers import dl_sampler_factory as jax_sampler_factory
from vod_tpu_torch.configs.dataloaders import DataLoaderConfig, SamplerFactoryConfig
from vod_tpu_torch.configs.datasets import QueriesDatasetConfig, SectionsDatasetConfig
from vod_tpu_torch.data import corpus, postprocessing, preprocessing, sectioning
from vod_tpu_torch.data.interface import load_queries, load_sections
from vod_tpu_torch.data.loaders import local_text
from vod_tpu_torch.data.loaders.beir import BeirDatasetLoader
from vod_tpu_torch.data.rosetta import adapters
from vod_tpu_torch.data.rosetta.models import QueryModel, SectionModel
from vod_tpu_torch.data.tokenizer import WordPieceTokenizer
from vod_tpu_torch.dataloaders import RealmDataloader, TokenizerCollate
from vod_tpu_torch.dataloaders.samplers import dl_sampler_factory

FIXTURE = str(Path(__file__).resolve().parent / "fixtures" / "beir_tiny")
CPU = torch.device("cpu")


def _port_tok() -> WordPieceTokenizer:
    return WordPieceTokenizer(_VOCAB)


ROWS = {
    "mcqa_index": ({"question": "what is the capital of france", "choices": ["paris", "rome"], "answer": 0}, "queries"),
    "mcqa_letter": ({"question": "capital of italy", "options": ["paris", "rome"], "answer": "B", "id": "m1"},
                    "queries"),
    "trivia": ({"question": "who", "answer": {"value": "x", "aliases": ["y", "x"]}, "qid": 3}, "queries"),
    "text_to_text": ({"source": "translate: hello", "target": "bonjour"}, "queries"),
    "aliased_query": ({"question": "q1", "answer": "a1", "qid": 7}, "queries"),
    "aliased_answers": ({"prompt": "q2", "answers": ["a", "b"], "uid": "u"}, "queries"),
    "identity_query": ({"id": "q", "query": "x", "answers": ["a"], "answer_scores": [1], "retrieval_ids": ["s"],
                        "retrieval_scores": [2], "subset_ids": [], "extra": 1}, "queries"),
    "identity_int_id_falls_through": ({"id": 5, "query": "x"}, "queries"),
    "missing_fields": ({"text": "only a query", "_id": "z"}, "queries"),
    "bad_lengths": ({"id": "q", "query": "x", "answers": ["a"], "answer_scores": []}, "queries"),
    "bool_mcqa_answer": ({"question": "q", "choices": ["a", "b"], "answer": True, "id": "b"}, "queries"),
    "section_aliased": ({"passage": "some text here", "doc_id": 42, "heading": "t"}, "sections"),
    "section_identity": ({"id": "s1", "content": "direct", "title": None}, "sections"),
    "section_contents": ({"contents": "body", "pid": "p", "subset_id": "x"}, "sections"),
    "section_no_content": ({"id": "s", "heading": "t"}, "sections"),
    "squad": ({"question": "q", "context": "c", "answers": {"text": ["a"]}, "title": "t", "id": "sq"},
              "queries_with_context"),
    "mcqa_contexts": ({"question": "q", "choices": ["a", "b"], "answer": 1, "context": "ctx", "id": "mc"},
                      "queries_with_context"),
    "identity_contexts": ({"query": "q", "contexts": ["c1", "c2"], "titles": ["t1", "t2"], "id": "ic"},
                          "queries_with_context"),
    "squad_missing_answers": ({"question": "q", "context": "c", "id": "x"}, "queries_with_context"),
}


@pytest.mark.parametrize("row,kind", ROWS.values(), ids=ROWS.keys())
def test_find_adapter_and_translation_equal_jax(row: dict, kind: str) -> None:
    want = jax_adapters.find_adapter(row, kind)
    got = adapters.find_adapter(row, kind)
    assert (got and got.__name__) == (want and want.__name__)
    if got is None:
        return
    out, ref = got.translate_row(row).to_dict(), want.translate_row(row).model_dump()
    if "id" not in row and not any(k in row for k in ("_id", "qid", "uid", "pid", "doc_id")):
        out.pop("id"), ref.pop("id")  # a fresh uuid on each side
    assert out == ref


def test_query_and_section_models_match_the_jax_schema() -> None:
    out = adapters.find_adapter(ROWS["aliased_query"][0], "queries").translate_row(ROWS["aliased_query"][0])
    assert isinstance(out, QueryModel) and out.id == "7" and out.answers == ["a1"]
    sec = adapters.AliasedSectionAdapter.translate_row(ROWS["section_aliased"][0])
    assert isinstance(sec, SectionModel) and sec.id == "42" and sec.title == "t"
    assert list(QueryModel(query="x").to_dict()) == list(jax_adapters.QueryModel(query="x").model_dump())


def test_squad_isolation_equals_jax() -> None:
    rows = [
        {"question": "capital of france", "context": "paris is the capital of france", "answers": {"text": ["paris"]}},
        {"question": "capital of japan", "context": "tokyo is the capital of japan", "answers": {"text": ["tokyo"]}},
        {"question": "france capital again", "context": "paris is the capital of france",
         "answers": {"text": ["paris"]}},
    ]
    for r in rows:
        r["id"] = r["question"]
    got = preprocessing.isolate_qa_and_sections(adapters.SquadQueryWithContextsAdapter.translate(rows))
    want = jax_pre.isolate_qa_and_sections(jax_adapters.SquadQueryWithContextsAdapter.translate(rows))
    assert got == tuple(want) and len(got[1]) == 2
    assert adapters.transform(rows, "queries") == tuple(jax_adapters.transform(rows, "queries"))


@pytest.mark.parametrize("what,split", [("sections", "test"), ("queries", "test")])
def test_beir_local_loader_equals_jax(what: str, split: str) -> None:
    got = BeirDatasetLoader(what)(subsets=[FIXTURE], split=split)
    assert got == JaxBeir(what)(subsets=[FIXTURE], split=split)
    assert len(got) == (5 if what == "sections" else 3)


def test_beir_hub_subset_raises_zero_egress() -> None:
    with pytest.raises(RuntimeError, match="zero-egress"):
        BeirDatasetLoader("queries")(subsets=["scifact"])
    with pytest.raises(ValueError, match="Unknown BeIR subset"):
        BeirDatasetLoader("queries")(subsets=["nope"])


def test_load_through_configs_equals_jax() -> None:
    from vod_tpu.configs.datasets import QueriesDatasetConfig as JQ
    from vod_tpu.configs.datasets import SectionsDatasetConfig as JS
    from vod_tpu.data.interface import load_queries as jax_load_queries
    from vod_tpu.data.interface import load_sections as jax_load_sections

    qkw = dict(identifier="q", subsets=[FIXTURE], split="test", link="s")
    skw = dict(identifier="s", subsets=[FIXTURE])
    got_q = load_queries(QueriesDatasetConfig(name_or_path=BeirDatasetLoader("queries"), **qkw))
    got_s = load_sections(SectionsDatasetConfig(name_or_path=BeirDatasetLoader("sections"), **skw))
    assert got_q == jax_load_queries(JQ(name_or_path=JaxBeir("queries"), **qkw))
    assert got_s == jax_load_sections(JS(name_or_path=JaxBeir("sections"), **skw))
    # the repo's configs name the BeIR loader `beir`
    assert load_queries(QueriesDatasetConfig(name_or_path="beir", **qkw)) == got_q
    assert load_sections(SectionsDatasetConfig(name_or_path="beir", **skw)) == got_s
    with pytest.raises(RuntimeError, match="zero-egress"):
        load_sections(SectionsDatasetConfig(identifier="s", name_or_path="BeIR/scifact"))


def test_subsampling_keeps_hf_shuffle_rows() -> None:
    rows = BeirDatasetLoader("sections")(subsets=[FIXTURE])
    cfg = SectionsDatasetConfig(identifier="s", name_or_path=lambda **kw: rows, options={"subset_size": 3, "seed": 7})
    want = datasets.Dataset.from_list(rows).shuffle(seed=7).select(range(3)).to_list()
    assert load_sections(cfg) == want


def test_harvest_text_passages_equals_jax(tmp_path: Path) -> None:
    rng = np.random.default_rng(0)
    words = [f"w{i}ord" for i in range(300)]
    for i, ext in enumerate((".md", ".py", ".txt", ".bin")):
        (tmp_path / f"f{i}{ext}").write_text(" ".join(rng.choice(words, size=200 + 37 * i)))
    (tmp_path / "sub").mkdir()
    (tmp_path / "sub" / "g.rst").write_text("Alpha beta_gamma 3delta " * 40)
    kw = dict(roots=[str(tmp_path)], passage_words=24, min_words=8, stride=10)
    got = local_text.harvest_text_passages(60, **kw)
    assert got == jax_local.harvest_text_passages(60, **kw) and len(got) == 60
    assert local_text.harvest_text_passages(10**6, **kw) == jax_local.harvest_text_passages(10**6, **kw)
    assert local_text.build_word_vocab(got, 50) == jax_local.build_word_vocab(got, 50)


def test_fixed_length_sectionizer_equals_jax() -> None:
    text = " ".join(["the quick brown fox jumps over the lazy dog"] * 10) + ", Paris!"
    for kw in (dict(section_length=20, stride=10), dict(section_length=12), dict(section_length=200)):
        want = jax_sectioning.FixedLengthSectionizer(tiny_tokenizer(), **kw)(text, prefix="title: ")
        assert sectioning.FixedLengthSectionizer(_port_tok(), **kw)(text, prefix="title: ") == want
        assert sectioning.FixedLengthSectionizer(tiny_tokenizer(), **kw)(text, prefix="title: ") == want
    assert sectioning.SentenceSectionizer()("a b. c d. ") == ["a b", "c d"]


def test_extract_sections_sentence_mode_equals_jax() -> None:
    rows = [{"id": "a", "content": "one. two. three", "title": "t"}, {"id": "b", "content": "single", "title": None}]
    want = jax_post.extract_sections(datasets.Dataset.from_list(rows), {"mode": "sentence"}).to_list()
    assert postprocessing.extract_sections(rows, {"mode": "sentence"}) == want
    assert postprocessing.combine_datasets([rows, rows[:1]]) == rows + rows[:1]


SECTIONS = [
    {"id": "s0", "content": "paris is the capital of france", "title": "france", "subset_id": "fr"},
    {"id": "s1", "content": "Tokyo is the capital of Japan!", "title": "japan", "subset_id": "jp"},
    {"id": "s2", "content": "the quick brown fox, tok1 tok2", "title": None, "subset_id": None},
]
QUERIES = [
    {"id": f"q{i}", "query": f"what is the capital of {c} tok{i % 8}?", "answers": [c, "rome"],
     "answer_scores": [float(i % 2), 1.0 - i % 2], "retrieval_ids": [f"s{i % 3}", "nope"],
     "retrieval_scores": [1.0, 1.0],
     "subset_ids": ["fr"] if i % 2 else [], "answer": "a" if i % 3 else "b"}
    for i, c in enumerate(["france", "japan", "italy", "spain", "england", "germany"] * 3)
]


def test_tokenize_corpus_and_queries_equal_jax() -> None:
    kw = dict(max_length=16, with_sparse_terms=True)
    want = jax_corpus.tokenize_corpus(SECTIONS, tiny_tokenizer(), **kw)
    for tok in (_port_tok(), tiny_tokenizer()):
        got = corpus.tokenize_corpus(SECTIONS, tok, **kw)
        assert set(got) == set(want)
        for k in want:
            if isinstance(want[k], np.ndarray):
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
                assert got[k].dtype == want[k].dtype
            else:
                assert got[k] == want[k], k
    qkw = dict(max_length=12, id_map=want["id_map"], subset_id_map=want["subset_id_map"], with_answers=True,
               with_sparse_terms=True, answer_max_length=4)
    wq = jax_corpus.tokenize_queries(QUERIES, tiny_tokenizer(), **qkw)
    gq = corpus.tokenize_queries(QUERIES, _port_tok(), **qkw)
    assert set(gq) == set(wq)
    for k in wq:
        np.testing.assert_array_equal(gq[k], wq[k], err_msg=k)


SAMPLERS = {
    "shuffle": None,
    "in_order": "no_shuffle",
    "lookup": {"mode": "lookup", "key": "answer", "lookup": {"a": 3.0}},
    "inverse_frequency": {"mode": "inverse_frequency", "key": "answer"},
}


@pytest.mark.parametrize("sampler", SAMPLERS.values(), ids=SAMPLERS.keys())
def test_realm_dataloader_batches_equal_jax(sampler) -> None:
    ids = corpus.tokenize_corpus(SECTIONS, _port_tok(), max_length=16)
    cfg = dict(batch_size=4, shuffle=sampler != "no_shuffle")
    if isinstance(sampler, dict):
        cfg["sampler"] = sampler
    kw = dict(id_map=ids["id_map"], subset_id_map=ids["subset_id_map"], max_length=12, with_answers=True,
              with_sparse_terms=True, answer_max_length=4)
    jax_dl = JaxRealmDataloader(QUERIES, tiny_tokenizer(), config=JaxDLConfig(**cfg), **kw)
    dl = RealmDataloader(QUERIES, _port_tok(), config=DataLoaderConfig(**cfg), device="cpu", **kw)
    assert len(dl) == len(jax_dl) == 4
    for seed in (0, 3):
        want, got = list(jax_dl.epoch(seed)), list(dl.epoch(seed))
        assert len(got) == len(want) == 4
        for g, w in zip(got, want):
            for name in ("input_ids", "attention_mask", "section_ids", "subset_ids", "terms", "answer_ids",
                         "answer_mask"):
                t, ref = getattr(g, name), np.asarray(getattr(w, name))
                if name == "subset_ids" and (ref < 0).all():
                    assert t is None  # declared difference: no restriction, no array
                    continue
                assert t.device == CPU and t.dtype == torch.int32, name
                np.testing.assert_array_equal(t.numpy(), ref, err_msg=name)
            assert g.shard is None and w.shard is None
    stream = dl.forever(seed=1)
    first = [next(stream).input_ids for _ in range(5)]
    jax_stream = jax_dl.forever(seed=1)
    for g in first:
        np.testing.assert_array_equal(g.numpy(), np.asarray(next(jax_stream).input_ids))


def test_samplers_and_tokenizer_collate_equal_jax() -> None:
    specs = [dict(mode="lookup", key="answer", lookup={"a": 2.0}), dict(mode="inverse_frequency", key="answer")]
    for spec in specs:
        np.testing.assert_array_equal(dl_sampler_factory(SamplerFactoryConfig(**spec))(QUERIES),
                                      jax_sampler_factory(JaxSampler(**spec))(QUERIES))
    both = dl_sampler_factory([SamplerFactoryConfig(**s) for s in specs])(QUERIES)
    np.testing.assert_array_equal(both, jax_sampler_factory([JaxSampler(**s) for s in specs])(QUERIES))
    got = TokenizerCollate(_port_tok(), "{{ title }}: {{ content }}", max_length=10, prefix="section.")(SECTIONS)
    want = JaxCollate(tiny_tokenizer(), "{{ title }}: {{ content }}", max_length=10, prefix="section.")(SECTIONS)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_dataloader_packs_one_host_buffer() -> None:
    """A batch's arrays share one buffer (one copy to the card)."""
    from vod_tpu_torch.dataloaders.realm_dataloader import to_device

    arrays = {"a": np.arange(6).reshape(2, 3), "b": None, "c": np.ones((2, 2), dtype=np.int64)}
    out = to_device(arrays, CPU)
    assert set(out) == {"a", "c"} and out["a"].untyped_storage().data_ptr() == out["c"].untyped_storage().data_ptr()
    np.testing.assert_array_equal(out["a"].numpy(), arrays["a"])
    assert json.dumps(out["c"].tolist()) == "[[1, 1], [1, 1]]"


def test_batch_with_no_subset_restriction_carries_none() -> None:
    """Declared difference: where JAX carries an all -1 `subset_ids` array
    (which sends `dense_search` to the filtered scan), the port carries None,
    so a `kernel: fused` index reaches the kernel; the other fields equal."""
    rows = [{**q, "subset_ids": []} for q in QUERIES]
    ids = corpus.tokenize_corpus(SECTIONS, _port_tok(), max_length=16)
    kw = dict(id_map=ids["id_map"], subset_id_map=ids["subset_id_map"], max_length=12, with_sparse_terms=True)
    got = next(RealmDataloader(rows, _port_tok(), config=DataLoaderConfig(batch_size=4), device="cpu", **kw).epoch(0))
    want = next(JaxRealmDataloader(rows, tiny_tokenizer(), config=JaxDLConfig(batch_size=4), **kw).epoch(0))
    assert got.subset_ids is None and (np.asarray(want.subset_ids) == -1).all()
    np.testing.assert_array_equal(got.input_ids.numpy(), np.asarray(want.input_ids))
    np.testing.assert_array_equal(got.terms.numpy(), np.asarray(want.terms))
