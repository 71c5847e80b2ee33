"""The toy WordPiece vocabulary of the demo scripts (`realm_dataloader`,
`train_periodic`): the JAX scripts read it through `transformers`'
`BertTokenizerFast` (`tests/helpers.py:tiny_tokenizer`); the port writes the
same lines to a `vocab.txt` and reads it with its own WordPiece."""

from __future__ import annotations

import pathlib
import tempfile

from vod_tpu_torch.data.tokenizer import WordPieceTokenizer

VOCAB = [
    "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]",
    "the", "quick", "brown", "fox", "jumps", "over", "lazy", "dog", "cat",
    "what", "is", "a", "who", "where", "when", "why", "how", "did", "do",
    "paris", "france", "capital", "of", "city", "tokyo", "japan", "berlin",
    "germany", "rome", "italy", "madrid", "spain", "london", "england",
    "answer", "question", "context", "title", "section", "query", "text",
    "alpha", "beta", "gamma", "delta", "epsilon", "zeta", "eta", "theta",
    "one", "two", "three", "four", "five", "six", "seven", "eight", "nine",
    "red", "green", "blue", "yellow", "black", "white", "big", "small",
] + [f"tok{i}" for i in range(64)]


def tiny_tokenizer() -> WordPieceTokenizer:
    """The toy vocabulary written to a temporary `vocab.txt` and read back."""
    with tempfile.TemporaryDirectory() as tmp:
        path = pathlib.Path(tmp) / "vocab.txt"
        path.write_text("\n".join(VOCAB))
        return WordPieceTokenizer.from_vocab_file(path)
