"""Embedding pipeline: encoder -> corpus embeddings -> the embedding cache ->
index -> query. The port of `examples/predict_and_index.py`.

    python -m vod_tpu_torch.examples.predict_and_index            # on the card
    python -m vod_tpu_torch.examples.predict_and_index --device cpu

A `Ranker` at the JAX script's widths (hidden 64, 2 layers, mean-l2 pooling,
bf16 activations, weights from a seeded generator) embeds 512 random
16-token sections (`compute_embeddings`); `cached_embeddings` then writes
them to a store keyed by (dataset, weights, dim) under a temporary directory
and a second call reads them back; last, a flat bf16 index answers the
first four rows as queries. Prints the shapes, the cache round trip's
largest difference (0 by construction) and the self-query top-5 ids (row i
should retrieve itself first); `main` returns them.
"""

from __future__ import annotations

import argparse
import tempfile
import typing as typ

import torch

from vod_tpu_torch.models import Ranker, RetrievalGradients, TransformerEncoderConfig, VodPoolerConfig
from vod_tpu_torch.runtime import build_device_corpus
from vod_tpu_torch.runtime.predict import cached_embeddings, compute_embeddings
from vod_tpu_torch.search import SearchQueries, build_dense_index, dense_search


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def main(argv: typ.Optional[list[str]] = None) -> dict:
    args = parser().parse_args(argv)
    device = torch.device(args.device)
    n, ls, vocab = args.n, 16, 1000
    cfg = TransformerEncoderConfig(
        vocab_size=vocab, hidden_size=64, num_layers=2, num_heads=2, intermediate_size=128,
        pooler=VodPoolerConfig(agg_method="mean", output_norm="l2"),
    )
    g = torch.Generator(device=device).manual_seed(0)
    model = Ranker(cfg, RetrievalGradients(), device=device, generator=g).eval()
    corpus = build_device_corpus(
        torch.randint(1, vocab, (n, ls), generator=g, device=device, dtype=torch.int32),
        torch.ones((n, ls), dtype=torch.int32, device=device), device=device,
    )
    emb = compute_embeddings(model.encode_field, corpus, chunk=128)
    print(f"embeddings: {tuple(emb.shape)} {emb.dtype}", flush=True)

    with tempfile.TemporaryDirectory() as cache_dir:
        emb2 = cached_embeddings(model.encode_field, model, corpus, cache_dir=cache_dir, dataset_fingerprint="demo",
                                 chunk=128)
        emb3 = cached_embeddings(  # the second call reads the store back
            model.encode_field, model, corpus, cache_dir=cache_dir, dataset_fingerprint="demo", chunk=128)
        diff = float((emb2 - emb3).abs().max())
        print("cache roundtrip max diff:", diff, flush=True)

    index = build_dense_index(emb, dtype="bfloat16", device=device)
    out = dense_search(index, SearchQueries(vector=emb[:4]), top_k=5)
    top5 = out.indices.cpu().tolist()
    print("self-query top-5 (row i should retrieve itself first):", top5, flush=True)
    return {"shape": tuple(emb.shape), "cache_max_diff": diff, "top5": top5}


if __name__ == "__main__":
    main()
