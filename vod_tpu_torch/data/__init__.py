"""Dataset layer (the port's copy of `vod_tpu/data/`): rosetta schema adapters,
sectioning, loaders, the tokenizers (WordPiece, and byte-level BPE and Unigram
from a `tokenizer.json`) and host corpus tokenization.
Shards are lists of row dicts."""

from .rosetta.models import QueryModel, QueryWithContextsModel, SectionModel
from .rosetta.adapters import find_adapter, transform
from .preprocessing import isolate_qa_and_sections
from .sectioning import FixedLengthSectionizer, SentenceSectionizer
from .interface import load_dataset, load_queries, load_sections
from .corpus import tokenize_corpus, tokenize_queries
from .tokenizer import WordPieceTokenizer, load_tokenizer
from .tokenizer_json import JsonTokenizer

__all__ = [
    "FixedLengthSectionizer",
    "JsonTokenizer",
    "QueryModel",
    "QueryWithContextsModel",
    "SectionModel",
    "SentenceSectionizer",
    "WordPieceTokenizer",
    "find_adapter",
    "isolate_qa_and_sections",
    "load_dataset",
    "load_queries",
    "load_sections",
    "load_tokenizer",
    "tokenize_corpus",
    "tokenize_queries",
    "transform",
]
