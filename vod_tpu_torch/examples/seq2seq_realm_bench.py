"""Seq2seq-reader REALM train-step timing at BASELINE config #5's shape: the
port of `examples/seq2seq_realm_bench.py`.

    python -m vod_tpu_torch.examples.seq2seq_realm_bench                       # on the card
    python -m vod_tpu_torch.examples.seq2seq_realm_bench --corpus 1048576 --steps 50 --index_dtype int8
    python -m vod_tpu_torch.examples.seq2seq_realm_bench --device cpu --corpus 512 --steps 1 --batch 2 \\
        --n_sections 2 --ls 8 --lq 4                                           # a toy run on the CPU

One live-retrieval step: encode the queries with the current retriever,
dense search over the corpus index, priority-sample sections, assemble
[context; question; answer] reader inputs, the T5 encoder-decoder reader's
teacher-forced forward and backward through the VOD estimator, clip, AdamW.
The retriever is e5-small-shaped (hidden 384, 6 layers, 6 heads), the reader
t5-small-shaped at the same widths, vocabulary 30,522. Corpus tokens and the
initial embeddings are made on the device from seeded generators (7 and 8);
query batches from numpy seeds, as the JAX script makes them. The index
keeps `build_dense_index`'s default kernel, as the JAX script does.

After `--steps` timed steps (3 untimed warm-up steps first) it prints a
provisional JSON line, re-embeds the corpus with the current encoder,
rebuilds the index and takes one more step (the periodic reindex), then
prints the final JSON line with the JAX script's keys; `main` returns it.
"""

from __future__ import annotations

import argparse
import json
import time
import typing as typ

import numpy as np
import torch

from vod_tpu_torch.models import TransformerEncoderConfig, VodGradients, VodPoolerConfig
from vod_tpu_torch.models.seq2seq import Seq2SeqRealm
from vod_tpu_torch.models.t5_encoder import T5EncoderConfig
from vod_tpu_torch.runtime import DeviceCorpus, QueryBatch, adamw, compute_embeddings, make_train_step
from vod_tpu_torch.search import HybridEngines, build_dense_index

VOCAB, HIDDEN, ANSWER_TOKENS = 30522, 384, 12
STEP = dict(prefetch=64, max_pos_sections=2, with_lm=True, gradient_clip_val=1.0)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--corpus", type=int, default=200_000)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--n_sections", type=int, default=8)
    ap.add_argument("--ls", type=int, default=64, help="section tokens")
    ap.add_argument("--lq", type=int, default=24, help="query tokens")
    ap.add_argument(
        "--index_dtype", default="bfloat16", choices=["bfloat16", "int8", "float32"],
        help="dense index codec; int8 halves index memory at >=1M corpora",
    )
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def make_model(device: typ.Any, generator: typ.Optional[torch.Generator] = None) -> Seq2SeqRealm:
    """The config #5 system: an e5-small-shaped retriever (mean pooling, l2,
    scaler 10) and a t5-small-shaped reader, bf16 activations, VOD(alpha 0.5)."""
    enc_cfg = TransformerEncoderConfig(
        vocab_size=VOCAB, hidden_size=HIDDEN, num_layers=6, num_heads=6, intermediate_size=1536,
        pooler=VodPoolerConfig(agg_method="mean", output_norm="l2", scaler=10.0),
    )
    reader_cfg = T5EncoderConfig(
        vocab_size=VOCAB, hidden_size=HIDDEN, num_layers=6, num_heads=6, head_dim=64, intermediate_size=1536,
    )
    return Seq2SeqRealm(enc_cfg, reader_cfg, VodGradients(alpha=0.5), device=device, generator=generator)


def make_corpus(n: int, ls: int, device: typ.Any) -> DeviceCorpus:
    """`n` sections of `ls` random ids in [4, VOCAB), made on the device."""
    g = torch.Generator(device=device).manual_seed(7)
    return DeviceCorpus(
        input_ids=torch.randint(4, VOCAB, (n, ls), generator=g, device=device, dtype=torch.int32),
        attention_mask=torch.ones((n, ls), dtype=torch.int32, device=device),
        subset_ids=torch.zeros((n,), dtype=torch.int32, device=device),
    )


def make_embeddings(n: int, device: typ.Any) -> torch.Tensor:
    """The initial index rows: standard normal [n, HIDDEN] f32, made on the device."""
    g = torch.Generator(device=device).manual_seed(8)
    return torch.randn((n, HIDDEN), generator=g, device=device)


def make_queries(seed: int, n: int, b: int, lq: int, device: typ.Any) -> QueryBatch:
    """The JAX script's query batch of numpy seed `seed`: `b` queries of `lq`
    ids, one gold section each, answers of 12 ids."""
    r = np.random.default_rng(seed)
    gold = r.integers(0, n, size=b)
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a).astype(np.int32)).to(device)
    return QueryBatch(
        input_ids=to(r.integers(4, VOCAB, size=(b, lq))),
        attention_mask=torch.ones((b, lq), dtype=torch.int32, device=device),
        section_ids=to(gold[:, None]),
        answer_ids=to(r.integers(4, VOCAB, size=(b, ANSWER_TOKENS))),
        answer_mask=torch.ones((b, ANSWER_TOKENS), dtype=torch.int32, device=device),
    )


def main(argv: typ.Optional[list[str]] = None) -> dict:
    args = parser().parse_args(argv)
    device = torch.device(args.device)
    n, b, d = args.corpus, args.batch, args.n_sections
    print(f"# corpus {n} sections x {args.ls} tokens; B={b}, D={d}, on {device}", flush=True)
    corpus = make_corpus(n, args.ls, device)
    engines = HybridEngines(dense=build_dense_index(make_embeddings(n, device), dtype=args.index_dtype, device=device))
    model = make_model(device)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"# params: {n_params / 1e6:.1f}M", flush=True)
    step_fn = make_train_step(model, adamw(model, 5e-5, weight_decay=1e-4, mask=False), n_sections=d, **STEP)
    generator = torch.Generator(device=device).manual_seed(1)
    weights = {"dense": 1.0}
    queries = lambda seed: make_queries(seed, n, b, args.lq, device)

    t0 = time.time()
    metrics, _, _ = step_fn.train_step(engines, corpus, queries(1), generator, weights)
    float(metrics["loss"])
    print(f"# first step: {time.time() - t0:.1f}s", flush=True)
    for i in range(3):  # untimed warm-up steps
        metrics, _, _ = step_fn.train_step(engines, corpus, queries(9000 + i), generator, weights)
    float(metrics["loss"])

    t0 = time.time()
    for i in range(args.steps):
        metrics, _, _ = step_fn.train_step(engines, corpus, queries(2 + i), generator, weights)
    loss = float(metrics["loss"])  # waits for the last step
    dt = (time.time() - t0) / args.steps
    print(f"# steady state: {dt * 1e3:.1f} ms/step (loss={loss:.3f})", flush=True)
    result = {"ms_per_step": round(dt * 1e3, 1), "params_m": round(n_params / 1e6, 1), "corpus": n, "batch": b,
              "n_sections": d, "loss": loss, "index_dtype": args.index_dtype}
    print(json.dumps(result), flush=True)  # provisional: the reindex below may not finish

    # the periodic reindex: re-embed the corpus with the current encoder and swap the index
    t0 = time.time()
    with torch.no_grad():
        emb = compute_embeddings(model.encode_field, corpus, chunk=2048 if n <= 262_144 else 8192)
    engines = HybridEngines(dense=build_dense_index(emb, dtype=args.index_dtype, device=device))
    del emb
    metrics, _, _ = step_fn.train_step(engines, corpus, queries(999), generator, weights)
    float(metrics["loss"])  # the new index is live
    reindex_s = time.time() - t0
    print(f"# reindex (re-embed + rebuild + first step): {reindex_s:.1f}s", flush=True)
    result = dict(result, reindex_s=round(reindex_s, 1))
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
