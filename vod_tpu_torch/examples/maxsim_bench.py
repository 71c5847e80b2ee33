"""Late-interaction (MaxSim) two-stage serving benchmark: the port of `examples/maxsim_bench.py`.

    python -m vod_tpu_torch.examples.maxsim_bench        # on the card: 1M docs x 32 tokens x 128-d int8
    python -m vod_tpu_torch.examples.maxsim_bench --device cpu --n 4000 --n-topics 256 --blocks 2

Store: `--n` docs of `--lt` tokens of `--d`-dim int8 token embeddings (4 GiB
at the defaults, ColBERTv2's 128-d token width) and a pooled int8
first-stage index (`build_dense_index`, the exact scan). Queries: `--b` of
`--lq` tokens. Measures:
  * recall@k of the two-stage search (pooled top `--n-candidates` -> MaxSim
    rerank, `maxsim_search`) against brute-force MaxSim over every doc;
  * recall@k of the pooled first stage alone;
  * ms per `--b`-query block of the two-stage search.

Token model, as in the JAX script: each doc draws its tokens from 4 of
`--n-topics` unit topic directions plus noise 0.25; each query takes `--lq`
tokens of one doc (plus noise 0.1), so pooled means blur what MaxSim keeps.
Everything is drawn on the device from seeded `torch.Generator`s (topics seed
1, slab i seed 100 + i; the query picks from numpy seed 0), so the numbers
are the port's own, not the JAX script's draws.

The brute-force scan and the rerank compute the same int8 interaction
(integer products summed exactly in f32, `search/maxsim.py`), so their
scores of a doc are bit-equal; one rerank block is also held against
`_score_gathered` on the CPU, which must agree exactly.

Timing: `--blocks` two-stage searches of distinct query blocks between two
CUDA events (host clock on the CPU), the minimum over `--reps` rounds.
Prints one JSON line (the JAX script's keys plus the measurements and
`card`); `main` returns the same dict.
"""

from __future__ import annotations

import argparse
import json
import time
import typing as typ

import numpy as np
import torch

from vod_tpu_torch.examples.mips_kernel_bench import card_name
from vod_tpu_torch.search import SearchQueries, build_dense_index, dense_search, maxsim_rerank, maxsim_search
from vod_tpu_torch.search.dense import _scan_topk
from vod_tpu_torch.search.maxsim import (
    MaxSimIndex,
    _score_gathered,
    int8_interaction,
    quantize_query_tokens,
    sum_query_tokens,
)

SLAB = 65_536  # docs made at a time (fewer for a smaller store, in multiples of 1024)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--lt", type=int, default=32)
    ap.add_argument("--lq", type=int, default=8)
    ap.add_argument("--d", type=int, default=128)
    ap.add_argument("--b", type=int, default=64)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--n-candidates", type=int, default=256)
    ap.add_argument("--n-topics", type=int, default=4096)
    ap.add_argument("--blocks", type=int, default=8)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def _slab(i: int, slab: int, topics: torch.Tensor, lt: int, device: torch.device) -> torch.Tensor:
    """[slab, Lt, D] unit token vectors: each doc's tokens from 4 topics + noise."""
    g = torch.Generator(device=device).manual_seed(100 + i)
    n_topics, d = topics.shape
    doc_topics = torch.randint(0, n_topics, (slab, 4), generator=g, device=device)
    tok_topic = doc_topics[:, torch.randint(0, 4, (lt,), generator=g, device=device)]  # [slab, Lt]
    x = topics[tok_topic] + 0.25 * torch.randn((slab, lt, d), generator=g, device=device)
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def brute_force_topk(index: MaxSimIndex, q_tok: torch.Tensor, qm: torch.Tensor, k: int,
                     chunk: int = 8192) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact MaxSim top-k over every doc of an int8 store: the rerank's
    interaction with every doc a candidate of every query (bit-equal scores),
    streamed in doc chunks. Returns (scores, row ids) `[B, k]`."""
    n_rows, lt, r = index.token_codes.shape
    b, lq, _ = q_tok.shape
    q_i8, q_row = quantize_query_tokens(q_tok.to(torch.float32), index.scale)
    flat_q = q_i8.reshape(b * lq, r)

    def score_chunk(start: int) -> torch.Tensor:
        d = index.token_codes[start : start + chunk]
        c = int(d.shape[0])
        inter = int8_interaction(flat_q, d.reshape(c * lt, r), "qr,tr->qt").reshape(b, lq, c, lt)
        inter = inter * q_row[:, :, :, None]
        inter = torch.where(index.token_mask[start : start + chunk][None, None], inter, torch.finfo(torch.float32).min)
        best = torch.amax(inter, dim=-1).permute(0, 2, 1)  # [B, c, Lq]
        best = torch.where(index.token_mask[start : start + chunk].any(-1)[None, :, None], best, 0.0)
        return sum_query_tokens(best, qm.to(torch.bool)[:, None, :])

    return _scan_topk(score_chunk, n_rows, index.n_real, b, k, chunk, q_tok.device)


def _recall(got: torch.Tensor, want: torch.Tensor, k: int) -> float:
    g, w = got.cpu().numpy(), want.cpu().numpy()
    return float(np.mean([len(set(g[i]) & set(w[i])) / k for i in range(g.shape[0])]))


def main(argv: typ.Optional[list[str]] = None) -> dict:
    args = parser().parse_args(argv)
    device = torch.device(args.device)
    n, lt, lq, d, b, k = args.n, args.lt, args.lq, args.d, args.b, args.k
    slab = min(SLAB, -(-n // 1024) * 1024)
    n_pad = -(-n // slab) * slab
    gt_chunk = min(8192, slab)

    g = torch.Generator(device=device).manual_seed(1)
    topics = torch.randn((args.n_topics, d), generator=g, device=device)
    topics = topics / torch.linalg.vector_norm(topics, dim=-1, keepdim=True)

    # the int8 token store and the pooled vectors, slab by slab on the device
    scale = torch.full((1, d), 1.2 / 127.0, device=device)  # unit tokens: |coord| <~ 1.2 after noise
    t0 = time.perf_counter()
    codes = torch.empty((n_pad, lt, d), dtype=torch.int8, device=device)
    pooled = torch.empty((n_pad, d), dtype=torch.float32, device=device)
    for i in range(n_pad // slab):
        x = _slab(i, slab, topics, lt, device)
        codes[i * slab : (i + 1) * slab] = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
        p = x.mean(dim=1)
        pooled[i * slab : (i + 1) * slab] = p / torch.clamp(torch.linalg.vector_norm(p, dim=-1, keepdim=True), min=1e-9)
    index = MaxSimIndex(token_codes=codes, token_mask=torch.ones((n_pad, lt), dtype=torch.bool, device=device),
                        scale=scale, n_real=n)
    pooled_idx = build_dense_index(pooled[:n], dtype="int8", device=device)
    del pooled
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    build_s = time.perf_counter() - t0

    # queries: lq tokens of a random doc of slab 0 (+ noise), and their pooled mean
    rng = np.random.default_rng(0)
    gold = torch.from_numpy(rng.integers(0, min(n, slab), b)).to(device)
    sel = torch.from_numpy(rng.integers(0, lt, (b, lq))).to(device)
    s0 = _slab(0, slab, topics, lt, device)[gold]  # [B, Lt, D]
    gq = torch.Generator(device=device).manual_seed(2)
    q_tok = torch.gather(s0, 1, sel[..., None].expand(b, lq, d)) + 0.1 * torch.randn((b, lq, d), generator=gq,
                                                                                     device=device)
    q_tok = q_tok / torch.linalg.vector_norm(q_tok, dim=-1, keepdim=True)
    qm = torch.ones((b, lq), dtype=torch.bool, device=device)

    def pool(qt: torch.Tensor) -> torch.Tensor:
        p = qt.mean(dim=1)
        return p / torch.linalg.vector_norm(p, dim=-1, keepdim=True)

    t0 = time.perf_counter()
    gt_s, gt_i = brute_force_topk(index, q_tok, qm, k, chunk=gt_chunk)
    gt_ids = gt_i.cpu()
    gt_scan_s = time.perf_counter() - t0

    def first(qq: SearchQueries, kk: int):
        return dense_search(pooled_idx, qq, kk)

    def two_stage(qt: torch.Tensor):
        return maxsim_search(first, index, SearchQueries(vector=pool(qt)), qt, qm, k, n_candidates=args.n_candidates)

    out = two_stage(q_tok)
    recall = _recall(out.indices, gt_ids, k)
    recall_pooled = _recall(first(SearchQueries(vector=pool(q_tok)), k).indices, gt_ids, k)
    # the top-1 of the brute-force scan and of the rerank score the same doc the same
    same = out.indices[:, 0] == gt_i[:, 0]
    top1_equal = bool(torch.equal(out.scores[:, 0][same], gt_s[:, 0][same]))

    # one rerank block on the card against the plain function on CPU copies
    cand = first(SearchQueries(vector=pool(q_tok)), args.n_candidates).indices
    block = maxsim_rerank(index, q_tok, qm, cand)
    local = torch.clamp(cand.long(), 0, n - 1).cpu()
    plain = _score_gathered(codes[local.to(device)].cpu(), index.token_mask[local.to(device)].cpu(), q_tok.cpu(),
                            qm.cpu(), scale.cpu())
    plain = torch.where(cand.cpu() >= 0, plain, float("-inf"))
    rerank_equal = bool(torch.equal(block.cpu(), plain))
    rerank_max_abs_err = float((block.cpu() - plain).abs().nan_to_num(0.0).max())

    # timing: distinct query blocks back to back
    pools = []
    for i in range(args.blocks):
        gi = torch.Generator(device=device).manual_seed(1000 + i)
        qt = q_tok + 1e-3 * torch.randn(q_tok.shape, generator=gi, device=device)
        pools.append(qt / torch.linalg.vector_norm(qt, dim=-1, keepdim=True))
    two_stage(pools[0])
    best = float("inf")
    for _ in range(args.reps):
        if device.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize(device)
            start.record()
            for qt in pools:
                two_stage(qt)
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / len(pools))
        else:
            t = time.perf_counter()
            for qt in pools:
                two_stage(qt).indices.sum().item()
            best = min(best, (time.perf_counter() - t) * 1e3 / len(pools))
    gib = n_pad * lt * d / 2**30
    result = {
        "metric": (f"{n}-doc MaxSim two-stage serving ({lt} tok x {d}d int8 store {gib:.1f} GiB, "
                   f"C={args.n_candidates}): recall@{k}={recall:.3f} vs brute-force MaxSim "
                   f"(pooled-only {recall_pooled:.3f}); {best:.3f} ms per {b}-query block"),
        "value": b / (best / 1e3),
        "unit": f"serving QPS (B={b})",
        "vs_baseline": recall,
        "recall": recall,
        "recall_pooled": recall_pooled,
        "ms_per_block": best,
        "store_gib": gib,
        "build_s": build_s,
        "gt_scan_s": gt_scan_s,
        "top1_scores_equal": top1_equal,
        "rerank_block_equal": rerank_equal,
        "rerank_max_abs_err": rerank_max_abs_err,
        "card": card_name(device),
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
