"""Real-text retrieval at 1M passages: the port of `examples/real_text_1m_bench.py`.

    python -m vod_tpu_torch.examples.real_text_1m_bench              # on the card: 1,048,576 passages
    python -m vod_tpu_torch.examples.real_text_1m_bench --device cpu --n 4096 --steps 3 --batch 16 --q 64 --dim 192

The whole pipeline on real text with no download:
  1. harvest passages from the interpreter's site-packages (package docs,
     docstrings, READMEs: 48-word windows, stride 32,
     `data/loaders/local_text.py`) and fingerprint them;
  2. word-encode them and train the dual encoder contrastively (a query
     window against the batch's passages, AdamW), then embed the corpus in
     chunks of 8,192;
  3. the top-64 variance share over a 50,000-row sample, exact f32 ground
     truth on the device, and the encoder's self-retrieval hit@10;
  4. recall@10, block QPS (the 2,048 queries as one block) and B = 64
     serving QPS for `int8`, `pq96x4fs+ref` and `serving-direct`, each built
     through `DenseFactoryConfig`;
  5. stemmed against unstemmed BM25 gold-hit@10 over the whole corpus, on the
     query windows as they are and inflected (content words pluralized).

The passages depend on the packages installed where it runs: two runs are
comparable only on the same `corpus_fingerprint` (a blake2b digest of the
passages' ids and contents, in order). Batches and query windows come from
numpy seeds as in the JAX script; the weights and the PQ training from
seeded `torch.Generator`s, the port's own draws. QPS comes from CUDA events
around distinct query blocks (`examples/synthetic.py`), where the JAX
script differenced two walls to cancel a relay's round trip. The embeddings
are cached in `cache_dir` (default: the temporary directory) as
`realtext_emb_{n}_{dim}_{steps}.npz` with the corpus fingerprint, and are
recomputed when the shape or the fingerprint differs. Prints one JSON line
(the JAX script's keys, `corpus_fingerprint`, `harvest_root`, the stages'
seconds, the losses it logs by step and `card`); `main` returns it.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import pathlib
import sys
import tempfile
import time
import typing as typ

import numpy as np
import torch

from vod_tpu_torch.configs.search import DenseFactoryConfig
from vod_tpu_torch.data.loaders import local_text
from vod_tpu_torch.examples.mips_kernel_bench import card_name
from vod_tpu_torch.examples.real_embedding_eval import contrastive_loss, make_pair_batch
from vod_tpu_torch.examples.synthetic import block_ms, device_of, recall_at, serving_ms, sync
from vod_tpu_torch.models import Ranker, RetrievalGradients, TransformerEncoderConfig, VodPoolerConfig
from vod_tpu_torch.native import analyze_texts
from vod_tpu_torch.runtime import adamw
from vod_tpu_torch.search import SearchQueries, build_dense_index, build_sparse_index_native
from vod_tpu_torch.search.dense import dense_search
from vod_tpu_torch.search.factory import build_dense_from_config
from vod_tpu_torch.search.hybrid import _dense_dispatch as search_index  # the search of the index's type
from vod_tpu_torch.search.sparse import sparse_search

K = 10
HARVEST_KW = dict(passage_words=48, stride=32, max_bytes_per_file=4 << 20)
VOCAB = 32768
MAX_LENGTH = 48
Q_LEN = 16
EMBED_CHUNK = 8192
CODECS = {
    "int8": DenseFactoryConfig(codec="int8"),
    # faiss PQ{M}x4fs + Refine analogue (exhaustive fast-scan + exact rerank)
    "pq96x4fs+ref": DenseFactoryConfig(
        codec="pq", n_subquantizers=96, code_bits=4, coarse_dim=None,
        refine="int8", refine_dim=192, k_factor=8, train_size=200_000,
    ),
    # the serving codec: coarse int8 scan -> exact rerank, no ADC stage
    "serving-direct": DenseFactoryConfig(
        codec="pq", coarse_dim=96, refine="int8", refine_dim=192,
        keep_codes=False, k_factor=8, train_size=200_000, approx_recall=0.95,
    ),
}


def log(msg: str) -> None:
    print(f"# {msg}", file=sys.stderr, flush=True)


def harvest(n: int, roots: typ.Sequence[str] = local_text.DEFAULT_ROOTS) -> list[dict]:
    t0 = time.perf_counter()
    passages = local_text.harvest_text_passages(n, roots=roots, **HARVEST_KW)
    log(f"harvested {len(passages)} passages in {time.perf_counter() - t0:.0f}s")
    return passages


def corpus_fingerprint(passages: typ.Sequence[typ.Mapping]) -> str:
    """blake2b (32 hex digits) over the passages' ids and contents, in order."""
    h = hashlib.blake2b(digest_size=16)
    for p in passages:
        h.update(p["id"].encode())
        h.update(b"\x00")
        h.update(p["content"].encode())
        h.update(b"\x01")
    return h.hexdigest()


def query_windows(passages, rng: np.random.Generator, n_q: int, width: int = 16) -> tuple[np.ndarray, list[str]]:
    """Held-out word windows: (rows, texts). Texts feed BM25; the encoded ids
    feed the dense side — one query set for both."""
    rows = rng.choice(len(passages), size=n_q, replace=False)
    texts = []
    for r in rows:
        words = passages[r]["content"].split()
        w = min(width, max(4, len(words) // 3))
        s0 = int(rng.integers(0, max(1, len(words) - w)))
        texts.append(" ".join(words[s0 : s0 + w]))
    return rows, texts


def encoder_config(dim: int, *, hidden: int = 256, layers: int = 4, heads: int = 4, intermediate: int = 512,
                   dtype: torch.dtype = torch.bfloat16) -> TransformerEncoderConfig:
    """The JAX script's encoder (its widths by default; bf16 activations, the
    JAX config's default)."""
    return TransformerEncoderConfig(
        vocab_size=VOCAB, hidden_size=hidden, num_layers=layers, num_heads=heads, intermediate_size=intermediate,
        max_position_embeddings=MAX_LENGTH, dtype=dtype,
        pooler=VodPoolerConfig(agg_method="mean", projection_size=dim, output_norm="l2", scaler=10.0,
                               learn_scaler=True),
    )


def train(model: Ranker, ids_np: np.ndarray, mask_np: np.ndarray, steps: int, batch: int,
          device: torch.device) -> list[float]:
    """`steps` AdamW steps (optax `adamw(3e-4, weight_decay=0.01)`) on pair
    batches seeded `1000 + s`; returns every step's loss."""
    opt = adamw(model, 3e-4, weight_decay=0.01, mask=False)
    losses = []
    for s in range(steps):
        qi, qm, si, sm = (torch.from_numpy(a).to(device) for a in make_pair_batch(1000 + s, batch, ids_np, mask_np))
        loss = contrastive_loss(model, qi, qm, si, sm)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
        if s % 100 == 0 or s == steps - 1:
            log(f"  step {s}: loss {float(losses[-1]):.4f}")
    return torch.stack(losses).float().cpu().tolist() if losses else []


def embed(model: Ranker, ids_np: np.ndarray, mask_np: np.ndarray, device: torch.device,
          chunk: int = EMBED_CHUNK) -> np.ndarray:
    """`encode_field` over chunks of `chunk` rows, f32 `[n, dim]`."""
    with torch.no_grad():
        return np.concatenate([
            model.encode_field(torch.from_numpy(ids_np[s0 : s0 + chunk]).to(device),
                               torch.from_numpy(mask_np[s0 : s0 + chunk]).to(device)).float().cpu().numpy()
            for s0 in range(0, len(ids_np), chunk)
        ])


def encode_queries(texts: typ.Sequence[str], vocab: typ.Mapping[str, int]) -> tuple[np.ndarray, np.ndarray]:
    """Query windows through the corpus vocabulary: whitespace words,
    lowercased, unknown -> 1, at most 16."""
    q_ids = np.zeros((len(texts), Q_LEN), np.int32)
    q_mask = np.zeros((len(texts), Q_LEN), np.int32)
    for i, text in enumerate(texts):
        toks = [vocab.get(w.lower(), 1) for w in text.split()][:Q_LEN]
        q_ids[i, : len(toks)] = toks
        q_mask[i, : len(toks)] = 1
    return q_ids, q_mask


def train_and_embed(passages, args: argparse.Namespace, cache: pathlib.Path, fingerprint: str,
                    device: torch.device, stages: dict) -> tuple[np.ndarray, np.ndarray, np.ndarray, list, list]:
    """Contrastive train + chunked embed, cached by config and corpus. Returns
    (emb, q_emb, query rows, query texts, losses); `stages` receives the
    seconds of each stage run."""
    rng = np.random.default_rng(0)
    qrows, qtexts = query_windows(passages, rng, args.q)
    if cache.exists():
        z = np.load(cache)
        if z["emb"].shape == (len(passages), args.dim) and str(z["fingerprint"]) == fingerprint:
            log(f"embeddings loaded from {cache}")
            return z["emb"], z["q_emb"], qrows, qtexts, []
        log("cache shape or corpus mismatch; recomputing")

    t0 = time.perf_counter()
    vocab = local_text.build_word_vocab(passages[:300_000], vocab_size=VOCAB)
    ids_np, mask_np = local_text.encode_passages(passages, vocab, max_length=MAX_LENGTH)
    stages["vocab_encode_s"] = time.perf_counter() - t0
    log(f"encoded {len(passages)} passages in {stages['vocab_encode_s']:.0f}s")

    model = Ranker(encoder_config(args.dim), RetrievalGradients(), device=device,
                   generator=torch.Generator(device=device).manual_seed(0))
    log(f"training encoder: {args.steps} steps x batch {args.batch}")
    t0 = time.perf_counter()
    losses = train(model, ids_np, mask_np, args.steps, args.batch, device)
    sync(device)
    stages["train_s"] = time.perf_counter() - t0
    log(f"trained in {stages['train_s']:.0f}s")

    t0 = time.perf_counter()
    emb = embed(model, ids_np, mask_np, device)
    stages["embed_s"] = time.perf_counter() - t0
    log(f"embedded {emb.shape} in {stages['embed_s']:.0f}s")
    q_emb = embed(model, *encode_queries(qtexts, vocab), device)
    np.savez(cache, emb=emb, q_emb=q_emb, fingerprint=np.array(fingerprint))
    log(f"cached embeddings -> {cache}")
    return emb, q_emb, qrows, qtexts, losses


def inflect(text: str) -> str:
    """Pluralize content words: alphabetic, longer than 3, not ending in s."""
    return " ".join(w + "s" if w.isalpha() and len(w) > 3 and not w.endswith("s") else w for w in text.split())


def bm25_gold_hits(contents: typ.Sequence[str], qtexts: typ.Sequence[str], qrows: np.ndarray, stem: bool,
                   device: torch.device) -> dict:
    """BM25 through the native analyzer (vocab 2^18, 64 terms a passage, 32 a
    query, `max_postings` 2048): build seconds and gold-hit@10 on the query
    windows as they are and inflected."""
    t0 = time.perf_counter()
    d_ids, d_counts = analyze_texts(contents, vocab_size=1 << 18, max_terms=64, stem=stem)
    doc_terms = [d_ids[i, : d_counts[i]].tolist() for i in range(len(contents))]
    sidx = build_sparse_index_native(doc_terms, n_terms=1 << 18, max_postings=2048, device=device)
    sync(device)
    out = {"build_s": time.perf_counter() - t0}
    for suffix, texts in (("", qtexts), ("_inflected", [inflect(t) for t in qtexts])):
        q_ids, _ = analyze_texts(texts, vocab_size=1 << 18, max_terms=32, stem=stem)
        got = sparse_search(sidx, SearchQueries(terms=torch.from_numpy(q_ids).to(device)), K).indices.cpu().numpy()
        out[f"gold_hit10{suffix}"] = float(np.mean([qrows[i] in set(got[i].tolist()) for i in range(len(qrows))]))
    return out


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1_048_576)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--q", type=int, default=2048)
    ap.add_argument("--dim", type=int, default=384)
    ap.add_argument("--skip_bm25", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def main(argv: typ.Optional[list[str]] = None, *, cache_dir: typ.Union[str, pathlib.Path, None] = None,
         roots: typ.Sequence[str] = local_text.DEFAULT_ROOTS) -> dict:
    args = parser().parse_args(argv)
    device = device_of(args.device)
    stages: dict[str, float] = {}

    t0 = time.perf_counter()
    passages = harvest(args.n, roots)
    fingerprint = corpus_fingerprint(passages)
    stages["harvest_s"] = time.perf_counter() - t0
    log(f"corpus fingerprint {fingerprint} ({len(passages)} passages under {', '.join(map(str, roots))})")
    cache = pathlib.Path(cache_dir or tempfile.gettempdir())
    cache = cache / f"realtext_emb_{len(passages)}_{args.dim}_{args.steps}.npz"
    emb, q_emb, qrows, qtexts, losses = train_and_embed(passages, args, cache, fingerprint, device, stages)
    results: dict[str, typ.Any] = {"n": len(passages), "dim": args.dim, "q": args.q, "corpus": "real-text",
                                   "corpus_fingerprint": fingerprint, "harvest_root": list(map(str, roots))}

    # spectrum: the property that separates real embeddings from PRNG slabs
    sample = emb[np.random.default_rng(1).choice(len(emb), min(50_000, len(emb)), replace=False)]
    eig = np.sort(np.linalg.eigvalsh(np.cov(sample.T)))[::-1]
    shares = np.cumsum(eig) / eig.sum()
    results["top64_variance_share"] = float(shares[min(63, len(shares) - 1)])
    log(f"spectrum: top64 variance share {results['top64_variance_share']:.4f}")

    # exact f32 ground truth on the device
    t0 = time.perf_counter()
    jq = torch.from_numpy(q_emb).to(device)
    flat = build_dense_index(emb, dtype="float32", approx_recall=None, device=device)
    gt_i = dense_search(flat, SearchQueries(vector=jq), K).indices.cpu().numpy()
    stages["ground_truth_s"] = time.perf_counter() - t0
    self_hit = float(np.mean([qrows[i] in set(gt_i[i].tolist()) for i in range(args.q)]))
    results["encoder_self_hit10"] = self_hit
    log(f"encoder self-retrieval hit@10 (exact): {self_hit:.3f}")
    del flat

    for name, cfg in CODECS.items():
        t0 = time.perf_counter()
        index = build_dense_from_config(cfg, emb, generator=torch.Generator(device=device).manual_seed(0),
                                        device=device)
        sync(device)
        build_s = time.perf_counter() - t0

        def search(v: torch.Tensor) -> torch.Tensor:
            return search_index(index, SearchQueries(vector=v), K).indices

        rec = recall_at(search(jq), gt_i, K)
        qps = args.q / (block_ms(search, [jq, jq + 1e-5], device) / 1e3)
        sv_ms = serving_ms(search, q_emb, device, b=64)
        results[name] = {"recall10": rec, "block_qps": qps, "serve64_qps": 64 / (sv_ms / 1e3), "build_s": build_s}
        log(f"{name}: recall@10 {rec:.4f}, block QPS {qps:,.0f}, B=64 serving {64 / (sv_ms / 1e3):,.0f} QPS "
            f"(build {build_s:.1f}s)")
        del index

    if not args.skip_bm25:
        # Stemmed vs unstemmed BM25 gold-hit@10 over the whole corpus, on TWO
        # query sets: verbatim windows (exact match is optimal; stemming can
        # only add collisions) and inflected windows (pluralized content
        # words: the regime stemming exists for).
        contents = [p["content"] for p in passages]
        for stem in (False, True):
            key = "bm25_stemmed" if stem else "bm25_unstemmed"
            results[key] = bm25_gold_hits(contents, qtexts, qrows, stem, device)
            log(f"{key}: gold-hit@10 {results[key]['gold_hit10']:.4f}, inflected "
                f"{results[key]['gold_hit10_inflected']:.4f} (build {results[key]['build_s']:.1f}s)")

    results["stages_s"] = stages
    results["losses"] = {s: loss for s, loss in enumerate(losses) if s % 100 == 0 or s == len(losses) - 1}
    results["card"] = card_name(device)
    print(json.dumps(results), flush=True)
    return results


if __name__ == "__main__":
    main()
