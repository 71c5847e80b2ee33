"""The REALM data path, text -> tokenize -> device collate -> RealmBatch: the port of `examples/realm_dataloader.py`.

    python -m vod_tpu_torch.examples.realm_dataloader                 # on the card
    python -m vod_tpu_torch.examples.realm_dataloader --device cpu

Four sections and two queries are tokenized by the port's WordPiece over the
toy vocabulary (`toy_text.tiny_tokenizer`, a `vocab.txt` in place of the JAX
script's `transformers` tokenizer), the sections held on the device
(`DeviceCorpus`) with a BM25 index over their analyzed terms and a flat f32
index of random embeddings (numpy `default_rng(0)`), and one `RealmDataloader`
batch collated by `device_collate` (prefetch 6, 3 sections, 1 positive, with
the reader inputs). The sampler draws from a `torch.Generator` (seed 0), the
port's own draws, not JAX's `PRNGKey(0)`. `main` returns the printed shapes
and arrays (as lists) and `card`.
"""

from __future__ import annotations

import argparse
import typing as typ

import numpy as np
import torch

from vod_tpu_torch.configs.dataloaders import DataLoaderConfig
from vod_tpu_torch.data.corpus import tokenize_corpus
from vod_tpu_torch.dataloaders import RealmDataloader
from vod_tpu_torch.examples.mips_kernel_bench import card_name
from vod_tpu_torch.examples.synthetic import device_of
from vod_tpu_torch.examples.toy_text import tiny_tokenizer
from vod_tpu_torch.runtime import DeviceCorpus, device_collate
from vod_tpu_torch.search import HybridEngines, build_dense_index, build_sparse_index

SECTIONS = [
    {"id": "s0", "content": "paris is the capital of france", "title": "france"},
    {"id": "s1", "content": "tokyo is the capital of japan", "title": "japan"},
    {"id": "s2", "content": "berlin is the capital of germany", "title": "germany"},
    {"id": "s3", "content": "rome is the capital of italy", "title": "italy"},
]
QUERIES = [
    {"id": "q0", "query": "what is the capital of france", "answers": ["paris"],
     "answer_scores": [1.0], "retrieval_ids": ["s0"], "retrieval_scores": [1.0], "subset_ids": []},
    {"id": "q1", "query": "what is the capital of japan", "answers": ["tokyo"],
     "answer_scores": [1.0], "retrieval_ids": ["s1"], "retrieval_scores": [1.0], "subset_ids": []},
]
FIELDS = ["query__input_ids", "section__input_ids", "section__score", "section__relevance", "section__idx",
          "section__log_weight", "lm__input_ids"]


def collate_one(device: torch.device, noise: typ.Optional[tuple[torch.Tensor, torch.Tensor]] = None):
    """(the collated RealmBatch, the tokenizer, the corpus); `noise`
    replaces the sampler's draws."""
    tok = tiny_tokenizer()
    enc = tokenize_corpus(SECTIONS, tok, max_length=16, with_sparse_terms=True)
    corpus = DeviceCorpus(
        input_ids=torch.from_numpy(enc["input_ids"]).to(device),
        attention_mask=torch.from_numpy(enc["attention_mask"]).to(device),
        subset_ids=torch.from_numpy(enc["subset_ids"]).to(device),
    )
    sparse = build_sparse_index(
        [enc["terms"][i, : enc["term_counts"][i]].tolist() for i in range(len(SECTIONS))],
        n_terms=1 << 18, max_postings=8, device=device,
    )
    rng = np.random.default_rng(0)
    dense = build_dense_index(rng.normal(size=(4, 32)).astype("float32"), dtype="float32", device=device)
    engines = HybridEngines(dense=dense, sparse=sparse)
    dl = RealmDataloader(
        QUERIES, tok, config=DataLoaderConfig(batch_size=2, shuffle=False), id_map=enc["id_map"],
        subset_id_map=enc["subset_id_map"], max_length=12, with_answers=True, with_sparse_terms=True, device=device,
    )
    qb = next(iter(dl.epoch(0)))
    batch, _ = device_collate(
        engines, corpus, qb, generator=torch.Generator(device=device).manual_seed(0),
        query_vectors=torch.from_numpy(rng.normal(size=(2, 32)).astype("float32")).to(device),
        prefetch=6, n_sections=3, max_pos_sections=1, with_lm=True, noise=noise,
    )
    return batch, tok, corpus


def main(argv: typ.Optional[list[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    device = device_of(ap.parse_args(argv).device)
    batch, tok, corpus = collate_one(device)
    out: dict[str, typ.Any] = {"shapes": {name: list(getattr(batch, name).shape) for name in FIELDS}}
    print("RealmBatch:")
    for name, shape in out["shapes"].items():
        print(f"  {name:24s} {tuple(shape)}")
    out["section_scores"] = batch.section__score.cpu().tolist()
    out["relevance"] = batch.section__relevance.cpu().tolist()
    ids = corpus.input_ids.cpu().numpy()
    out["retrieved_q0"] = [tok.decode([t for t in ids[i] if t > 4]) for i in batch.section__idx.cpu().numpy()[0]]
    print("section scores:\n", np.round(np.asarray(out["section_scores"]), 3))
    print("relevance:\n", np.asarray(out["relevance"]))
    print("retrieved for q0:", out["retrieved_q0"])
    out["card"] = card_name(device)
    return out


if __name__ == "__main__":
    main()
