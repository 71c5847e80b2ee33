"""Real-embedding PQ evaluation (configs #2/#4 shape, offline): the port of `examples/real_embedding_eval.py`.

    python -m vod_tpu_torch.examples.real_embedding_eval              # on the card: 200,000 passages, 300 steps
    python -m vod_tpu_torch.examples.real_embedding_eval --device cpu --n 1024 --steps 2 --batch 16 --q 64 \
        --dim 128 --max_len 16 --n_candidates 256

Real embeddings end to end, with no download:
  1. harvest real text passages from the local filesystem (the interpreter's
     site-packages, `data/loaders/local_text.py`), a word vocabulary and
     word-level ids (`encode_passages`);
  2. train the dual encoder contrastively for `--steps` AdamW steps (query =
     a word window of its passage, in-batch negatives);
  3. embed the corpus in chunks of 4096;
  4. report the spectrum (top-k variance shares);
  5. build flat bf16, int8 and PQ(+OPQ) indexes and the round-3 codec ladder
     (`build_pq_index`) and measure recall@10 against exact f32 search and
     QPS on held-out query windows.
The passages depend on the packages installed where it runs, so recalls
are comparable only on one machine. Batches and query windows come from
numpy seeds as in the JAX script (pair batch s: seed 1000 + s; the eval
rows from seed 0); the weights, the PQ codebooks and k-means from seeded
`torch.Generator`s, the port's own draws. QPS: the queries as one block,
timed `--reps` times back to back between CUDA events (host clock on the
CPU), the minimum kept; the JAX script differenced two batch sizes to
cancel a relay's round trip. Prints one JSON line with the JAX script's keys
plus `card`; `main` returns it.
"""

from __future__ import annotations

import argparse
import json
import time
import typing as typ

import numpy as np
import torch

from vod_tpu_torch.data.loaders.local_text import build_word_vocab, encode_passages, harvest_text_passages
from vod_tpu_torch.examples.mips_kernel_bench import card_name
from vod_tpu_torch.examples.synthetic import block_ms, device_of, recall_at, sync
from vod_tpu_torch.models import Ranker, RetrievalGradients, TransformerEncoderConfig, VodPoolerConfig
from vod_tpu_torch.runtime import adamw
from vod_tpu_torch.search import SearchQueries, build_dense_index, build_pq_index
from vod_tpu_torch.search.dense import dense_search, pq_search

VOCAB = 32768
Q_LEN = 16


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=200_000, help="corpus passages")
    ap.add_argument("--steps", type=int, default=300, help="contrastive train steps")
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--q", type=int, default=4096, help="eval queries")
    ap.add_argument("--dim", type=int, default=384, help="embedding dim (e5-small shape)")
    ap.add_argument("--max_len", type=int, default=48)
    ap.add_argument("--n_candidates", type=int, default=4096, help="PQ rescore pool")
    ap.add_argument("--out", type=str, default=None, help="save embeddings .npy")
    ap.add_argument("--dtype", default="bfloat16", help="activations: bfloat16 (default) or float32")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def encoder_config(args: argparse.Namespace) -> TransformerEncoderConfig:
    return TransformerEncoderConfig(
        vocab_size=VOCAB, hidden_size=256, num_layers=4, num_heads=4, intermediate_size=512,
        max_position_embeddings=args.max_len, dtype=getattr(torch, args.dtype),
        pooler=VodPoolerConfig(agg_method="mean", projection_size=args.dim, output_norm="l2", scaler=10.0,
                               learn_scaler=True),
    )


def query_window(ids_row: np.ndarray, mask_row: np.ndarray, r: np.random.Generator) -> tuple[np.ndarray, int]:
    """A word window of a passage (4-16 words, a third of it), drawn by `r`."""
    length = int(mask_row.sum())
    w = min(Q_LEN, max(4, length // 3))
    s0 = int(r.integers(0, max(1, length - w)))
    return ids_row[s0 : s0 + w], w


def make_pair_batch(seed: int, b: int, ids_np: np.ndarray, mask_np: np.ndarray) -> tuple[np.ndarray, ...]:
    """The JAX script's pair batch: b passages and a query window of each."""
    r = np.random.default_rng(seed)
    rows = r.integers(0, len(ids_np), size=b)
    q_ids = np.zeros((b, Q_LEN), np.int32)
    q_mask = np.zeros((b, Q_LEN), np.int32)
    for i, row in enumerate(rows):
        win, w = query_window(ids_np[row], mask_np[row], r)
        q_ids[i, :w] = win
        q_mask[i, :w] = 1
    return q_ids, q_mask, ids_np[rows], mask_np[rows]


def contrastive_loss(model: Ranker, qi: torch.Tensor, qm: torch.Tensor, si: torch.Tensor,
                     sm: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy of each query against the batch's passages."""
    qe = model.encode_field(qi, qm)
    se = model.encode_field(si, sm)
    logits = (qe @ se.T).to(torch.float32)
    return torch.nn.functional.cross_entropy(logits, torch.arange(int(qi.shape[0]), device=qi.device))


def main(argv: typ.Optional[list[str]] = None) -> dict:
    args = parser().parse_args(argv)
    device = device_of(args.device)
    t0 = time.perf_counter()
    print(f"# harvesting {args.n} real passages from site-packages ...", flush=True)
    passages = harvest_text_passages(args.n, passage_words=args.max_len)
    print(f"# got {len(passages)} passages in {time.perf_counter() - t0:.0f}s", flush=True)
    vocab = build_word_vocab(passages, vocab_size=VOCAB)
    ids_np, mask_np = encode_passages(passages, vocab, max_length=args.max_len)

    model = Ranker(encoder_config(args), RetrievalGradients(), device=device,
                   generator=torch.Generator(device=device).manual_seed(0))
    opt = adamw(model, 3e-4, weight_decay=0.01, mask=False)
    rng = np.random.default_rng(0)

    def on_device(*arrays: np.ndarray) -> list[torch.Tensor]:
        return [torch.from_numpy(a).to(device) for a in arrays]

    print(f"# training encoder: {args.steps} steps x batch {args.batch}", flush=True)
    t0 = time.perf_counter()
    for s in range(args.steps):
        loss = contrastive_loss(model, *on_device(*make_pair_batch(1000 + s, args.batch, ids_np, mask_np)))
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        if s % 50 == 0 or s == args.steps - 1:
            print(f"#   step {s}: loss {float(loss.detach()):.4f}", flush=True)
    sync(device)
    train_s = time.perf_counter() - t0

    print("# embedding corpus", flush=True)
    t0 = time.perf_counter()
    with torch.no_grad():
        emb = np.concatenate([
            model.encode_field(*on_device(ids_np[s0 : s0 + 4096], mask_np[s0 : s0 + 4096])).float().cpu().numpy()
            for s0 in range(0, len(passages), 4096)
        ])
    embed_s = time.perf_counter() - t0
    if args.out:
        np.save(args.out, emb)

    sample = emb[rng.choice(len(emb), size=min(50_000, len(emb)), replace=False)]
    eig = np.sort(np.linalg.eigvalsh(np.cov(sample.T)))[::-1]
    shares = np.cumsum(eig) / eig.sum()
    spectrum = {f"top{k}_variance_share": float(shares[k - 1]) for k in (16, 32, 64, 128) if k <= len(shares)}
    print(f"# spectrum: {spectrum}", flush=True)

    qrows = rng.choice(len(passages), size=args.q, replace=False)
    q_ids = np.zeros((args.q, Q_LEN), np.int32)
    q_mask = np.zeros((args.q, Q_LEN), np.int32)
    for i, row in enumerate(qrows):
        win, w = query_window(ids_np[row], mask_np[row], rng)
        q_ids[i, :w] = win
        q_mask[i, :w] = 1
    with torch.no_grad():
        q_emb = model.encode_field(*on_device(q_ids, q_mask)).float().cpu().numpy()
    if args.out:  # the query side beside it, so codec sweeps can skip retraining
        np.save(args.out.replace(".npy", "_queries.npy"), q_emb)

    jq = torch.from_numpy(q_emb).to(device)
    flat_exact = build_dense_index(emb, dtype="float32", approx_recall=None, device=device)
    gt = dense_search(flat_exact, SearchQueries(vector=jq), 10).indices.cpu().numpy()
    del flat_exact
    self_hit = float(np.mean([qrows[i] in set(gt[i].tolist()) for i in range(args.q)]))
    print(f"# encoder self-retrieval hit@10 (exact): {self_hit:.3f}", flush=True)

    def recall_and_qps(index: typ.Any, search_fn: typ.Callable, name: str) -> tuple[float, float]:
        def search(v: torch.Tensor) -> torch.Tensor:
            return search_fn(index, SearchQueries(vector=v), 10).indices

        rec = recall_at(search(jq), gt, 10)
        qps = args.q / (block_ms(search, [jq], device, args.reps) / 1e3)
        print(f"# {name}: recall@10 {rec:.4f}, ~{qps:,.0f} QPS", flush=True)
        return rec, qps

    results: dict[str, typ.Any] = {"n": len(passages), "dim": args.dim, "self_hit10": self_hit, "train_s": train_s,
                                   "embed_s": embed_s, **spectrum}
    bf16 = build_dense_index(emb, dtype="bfloat16", device=device)
    results["bf16_recall10"], results["bf16_qps"] = recall_and_qps(bf16, dense_search, "flat bf16")
    del bf16
    int8 = build_dense_index(emb, dtype="int8", device=device)
    results["int8_recall10"], results["int8_qps"] = recall_and_qps(int8, dense_search, "int8")
    del int8

    def gen() -> torch.Generator:
        return torch.Generator(device=device).manual_seed(0)

    t0 = time.perf_counter()
    pq = build_pq_index(emb, n_subquantizers=32, coarse_dim=64, n_candidates=args.n_candidates,
                        train_size=min(200_000, len(emb)), kmeans_iters=8, use_opq=True, opq_iters=3,
                        generator=gen(), device=device)
    sync(device)
    results["pq_build_s"] = time.perf_counter() - t0
    results["pq_recall10"], results["pq_qps"] = recall_and_qps(pq, pq_search, "pq32+opq (coarse64)")
    results["pq_bytes_per_vec"] = 32 + 64  # codes + int8 coarse
    del pq

    # the round-3 codec ladder: exhaustive ADC + exact re-rank;
    # bytes/vec = M (codes) [+ coarse_dim] [+ dim for the int8 refine]
    train_n = min(200_000, len(emb))
    for name, kw, bytes_pv in [
        ("pq32x8-exh", dict(n_subquantizers=32, coarse_dim=None), 32),
        ("pq64x8-exh", dict(n_subquantizers=64, coarse_dim=None), 64),
        ("pq64x8-exh+opq", dict(n_subquantizers=64, coarse_dim=None, use_opq=True, opq_iters=3), 64),
        ("pq32x8-exh+ref8", dict(n_subquantizers=32, coarse_dim=None, refine="int8", k_factor=8), 32 + args.dim),
        ("pq64x8-exh+ref8", dict(n_subquantizers=64, coarse_dim=None, refine="int8", k_factor=8), 64 + args.dim),
        ("pq32+coarse64+ref8", dict(n_subquantizers=32, coarse_dim=64, n_candidates=args.n_candidates,
                                    refine="int8", k_factor=8), 32 + 64 + args.dim),
        # 4-bit fast-scan (faiss PQ{M}x4fs): equal code bytes, 16x smaller decode tables
        ("pq64x4fs-exh+ref8", dict(n_subquantizers=64, code_bits=4, coarse_dim=None, refine="int8", k_factor=8),
         32 + args.dim),
        ("pq128x4fs-exh+ref8", dict(n_subquantizers=128, code_bits=4, coarse_dim=None, refine="int8", k_factor=8),
         64 + args.dim),
        ("pq128x4fs-exh+pca128ref16", dict(n_subquantizers=128, code_bits=4, coarse_dim=None, refine="int8",
                                           refine_dim=128, k_factor=16), 64 + 128),
    ]:
        t0 = time.perf_counter()
        idx = build_pq_index(emb, train_size=train_n, kmeans_iters=8, generator=gen(), device=device, **kw)
        sync(device)
        build_s = time.perf_counter() - t0
        rec, qps = recall_and_qps(idx, pq_search, f"{name} ({bytes_pv}B/vec, build {build_s:.1f}s)")
        key = name.replace("+", "_").replace("-", "_")
        results[f"{key}_recall10"], results[f"{key}_qps"] = rec, qps
        results[f"{key}_bytes_per_vec"] = bytes_pv
        del idx
    results["card"] = card_name(device)
    print(json.dumps(results), flush=True)
    return results


if __name__ == "__main__":
    main()
