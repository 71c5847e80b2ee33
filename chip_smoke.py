#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`vod_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout, on a machine with one H100

It imports nothing of JAX or of the JAX package, and fails (exit 1, no result
line) where there is no CUDA device or no checkout around it. Phases, each
checked, none caught:

 1. the card: name and power limit (nvidia-smi), CUDA version;
 2. build both hand-written kernels from `vod_tpu_torch/csrc/`, one `nvcc`
    each, started together, with the time taken, registers and shared memory;
 3. `fused_mips_binned` against its plain PyTorch version on the card at
    N = 2^20, D = 768, bins 512 and 1024, B = 1, 64 and 2048, k = 40 (the
    tensor-core body), and on rows off the 16-byte grid (bf16 2 bytes off at
    B = 64, 1024 bins and B = 2048, 512 bins; int8 4 bytes off at B = 64,
    512 bins: the CUDA-core body), each call checked to take the body that
    `_binned_body` names: bf16 scores within twice the f32 sum-order bound
    and ids equal wherever the margin exceeds it; int8 ids and scores exactly
    equal (every cell); tensor-core edge cases B = 3 and 65 with
    n_real = N - 77 (a ragged last stride); n_real masking; duplicate rows tie
    to the lowest id. Then times on both bodies: kernel, plain version, the
    library yardstick (`torch.topk(q @ Vᵀ, k)` in bf16,
    `torch.topk(torch._int_mm(q, Vᵀ), k)` in int8), and the bound;
 3b. `fused_mips_topk` against its plain PyTorch version on the card at
    N = 2^20, D = 768: bf16 at B = 1, 64 and 2048 with k = 10 and 128 (the
    tensor-core body), f32 at B = 64 with k = 128 and bf16 rows 2 bytes off
    the 16-byte grid at B = 64, k = 10 and B = 2048, k = 128 (the CUDA-core
    body), each call checked to take the body that `_topk_body` names. One
    PyTorch read of the corpus is timed beside them. Scores within
    twice the f32 sum-order bound, ids equal wherever the margin exceeds it;
    tensor-core edge cases B = 3 and 65 with k = 1 and n_real = N - 77 (a
    ragged last tile); n_real masking at N - 12345; n_real = 3 leaves slots
    3-9 at -1/-inf; three equal rows in different splits tie to the lowest
    id. Then times: kernel, plain version, the library yardstick
    `torch.topk(q @ Vᵀ, k)`, and the bound;
 4. the serving path, end to end (the main path: launch counts are zeroed just
    before it and read just after): an e5-base-width `VodEncoder` (bf16
    activations, f32 params, seed 0) encodes 64 queries of 64 seeded tokens;
    a 1,000,000 x 768 unit-norm corpus made on the card from a seeded
    generator is indexed as flat bf16 (kernel "fused", f32 re-rank, 1024 bins)
    and as int8 (kernel "fused"); two `SearchServer`s (2 ms batch window,
    max batch 64) answer concurrent HTTP requests with gold lookups and
    held-out requests (corpus rows + 0.1 noise). Checked: ids in [0, N) or -1,
    gold ids with label 1, fewer dispatches than requests, kernel launches,
    all on the tensor-core body, recall@10 against exact f32 search, served ids == direct `dense_search`;
    then request latency at one client and under 32 concurrent clients;
 4b. the kernel shootout, end to end (the exact kernel's main path: launch
    counts are zeroed just before it and read just after):
    `vod_tpu_torch.examples.mips_kernel_bench.main` at 1M x 768 bf16,
    2048-query blocks, k = 10: the exact scan, `fused_mips_binned` and
    `fused_mips_topk` timed for QPS, each with recall@10 against exact search.
    Checked: exact-kernel recall >= 0.999, binned recall >= 0.975, and
    launches of both kernels, all on their tensor-core bodies;
 5. the train path, end to end (the main path of this slice: launch counts
    are zeroed just before `training_loop` and read just after
    `validation_loop`): the REALM configuration of
    `configs/msmarco_pq_realm.yaml` at full width (a `VodEncoder` of hidden
    384, 6 layers, 6 heads; a `CausalLM` reader of the same widths, untied
    head, bf16 activations; `VodGradients(alpha=0.5)`; random weights from a
    seeded generator) over 2^20 sections of 200 random tokens resident on
    the card and a flat bf16 index of 2^20 x 384 random unit rows with kernel
    "fused" at 512 bins (the config's PQ codec is not ported). First one
    train-path `fused_mips_binned` call (B = 32, D = 384, 512 bins, k = 100)
    is held against its plain version and timed. Then `training_loop` runs
    2 warm-up and 10 timed optimizer steps (B = 32 per micro-batch,
    accumulation 2, prefetch 100, 8 sections, clip 1.0, AdamW lr 5e-5 with
    the decay mask), and `validation_loop` 2 batches. Checked: every loss
    and gradient norm finite, every optimizer group updated, exactly two
    `fused_mips_binned` launches per optimizer step (one a validation
    batch), all on the tensor-core body. Printed: the median ms per
    optimizer step (CUDA events), queries and reader sequences per second,
    peak memory, each step's loss, the monitor's mrr / ndcg_10 / hitrate_3,
    one micro-batch's time by stage, the f32 reader head's products timed
    alone, and one optimizer step under `torch.profiler` (device busy share,
    the kernels that took the most). Last, one more optimizer step runs with
    every synchronizing CUDA call made an error (checked: the step never
    waits for the card), timing the host's enqueue beside the card's finish;
 6. periodic training, end to end (its own main path: launch counts are
    zeroed just before `periodic_training` and read just after): phase 5's
    model widths and corpus cut (freed and made anew, seed 3), with the
    index codec of `configs/msmarco_pq_realm.yaml` exactly (`PERIODIC_DENSE`:
    4-bit PQ-128, exhaustive ADC, int8 refine over 128 PCA dims, k_factor 32,
    train_size 1,000,000), 2 periods of 3 optimizer steps: each period
    re-embeds the 2^20 sections and rebuilds the index. Printed per period:
    re-embed ms and sections/s, build ms by stage, index bytes, ms per
    optimizer step; then peak memory. Checked: finite losses; period 1's
    embeddings differ from period 0's, and so do the codes; `[N, 64]` uint8
    codes and `[N, 128]` int8 refine rows; no kernel launch (the
    exhaustive-ADC codec runs none, in JAX either); a direct `pq_search` of
    one collated batch's query vectors returns the ids and scores the
    collate retrieved; recall@10 of the last index against an exact f32
    scan of the same embeddings on 256 held-out queries, above
    `PERIODIC["recall_floor"]`. Then the PQ coarse route (its own main path:
    counts zeroed before, read after) on the last period's embeddings: the
    `pq` preset (OPQ, 32 subquantizers, coarse_dim 64) and the factory
    default (coarse_dim 32), both `kernel: fused` at 512 bins, searched at
    B = 32 and 64. Checked: 4 launches, all `wgmma`; each kernel call (int8,
    D = 32 and 64, k = bins) equal in every cell to its plain version; then
    timed beside the plain version, `torch.topk(torch._int_mm(q, Vᵀ), k)`
    and the bound, and split into the host's time to enqueue a call and the
    device time of its kernels (`torch.profiler`);
 7. the `kernels` JSON line, the card line, and the last line
    `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import concurrent.futures
import gc
import json
import math
import statistics
import sys
import time
import urllib.request
from pathlib import Path

ROOT = Path(__file__).resolve().parent
D = 768
N_KERNEL = 1 << 20
BATCHES = (1, 64, 2048)  # a one-query dispatch, the serving batch, a bulk search
K_POOL = 40  # min(k_factor * top_k, bins): the kernel's k on the served path
EXACT_KS = (10, 128)  # the shootout's k, and the exact kernel's widest list
TOP_K = 10
N_SERVE = 1_000_000
N_QUERIES, QUERY_TOKENS = 64, 64
# Recall@10 floor of the flat index (bf16 store, 1024 bins, 40-wide pool, f32
# re-rank). Bin collisions alone cost about (k-1)/(2*bins) = 9/2048 = 0.44%:
# expected recall 0.9956, i.e. ~3 misses in 640 (query, neighbour) pairs. The
# floor allows 12 misses, far outside that count's binomial spread.
RECALL_FLOOR = 0.98
# Published data-sheet peaks per H100 model, dense (no sparsity):
# (HBM bytes/s, bf16 FLOP/s, int8 OP/s, f32 FLOP/s outside the tensor cores).
# Matched on nvidia-smi's name, first hit wins.
DATASHEETS = (
    ("PCIe", (2.0e12, 756e12, 1513e12, 51e12)),
    ("NVL", (3.9e12, 835e12, 1670e12, 60e12)),
    ("H100", (3.35e12, 989e12, 1979e12, 67e12)),  # H100 SXM5
)
SHOOTOUT_ARGS = ["--n", str(1 << 20), "--d", "768", "--blk", "2048", "--nblocks", "8", "--k", "10"]
EXACT_RECALL_FLOOR = 0.999  # only bf16 near-ties between two f32 sum orders may differ
# 1 - (k-1)/(2*bins) = 1 - 9/1024 = 0.991 expected at 512 bins; the floor leaves
# room for the sampling spread of 256 queries
BINNED_RECALL_FLOOR = 0.975


# Phase 5: the REALM train path of configs/msmarco_pq_realm.yaml, cut as the
# module docstring says (corpus 2^20 sections, Lq 32, La 16, two gold ids).
TRAIN = dict(
    n=1 << 20, d=384, layers=6, heads=6, inter=1536, vocab=30522, ls=200, lq=32, la=16, b=32, accum=2,
    warmup=2, timed=10, val_batches=2, prefetch=100, n_sections=8, max_pos=2, bins=512, lr=5e-5,
)

# Phase 6: periodic training with the index codec of configs/msmarco_pq_realm.yaml
# (`search_defaults.dense`, exactly), at phase 5's widths and corpus cut (2^20
# sections of 200 random ids; MS MARCO has 8.8M): two periods of `steps`
# optimizer steps, so the index is built twice from two encoders. Then the PQ
# coarse route on the last period's embeddings: the `pq` preset
# (configs/presets/search/pq.yaml) and the factory default (coarse_dim 32),
# both with `kernel: fused` at 512 bins, searched at B = 32 and 64.
PERIODIC_DENSE = dict(
    codec="pq", n_subquantizers=128, code_bits=4, coarse_dim=None, refine="int8", refine_dim=128, k_factor=32,
    train_size=1_000_000,
)
PERIODIC = dict(
    TRAIN, periods=2, steps=3, held_out=256, dense=PERIODIC_DENSE, coarse_batches=(32, 64),
    coarse={
        "pq-preset": dict(codec="pq", n_subquantizers=32, use_opq=True, coarse_dim=64, n_candidates=4096,
                          kernel="fused", fused_bins=512),
        "factory-default": dict(codec="pq", kernel="fused", fused_bins=512),
    },
    # Recall@10 floor of the last period's index against exact f32 search of
    # the same embeddings. With random weights the embeddings are nearly
    # isotropic around their mean, which 4-bit PQ in 3-dim subspaces and an
    # int8 refine over 128 of 384 PCA dims serve poorly: 0.2328 on the first
    # card run (256 queries, 2,560 pairs; a binomial spread of ~0.008). A
    # broken codec, scan or re-rank gives ~0 (10 random ids of 2^20).
    recall_floor=0.15,
)


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def log(*parts) -> None:
    print(*parts, flush=True)


def time_ms(fn, reps: int) -> float:
    """Mean ms per call over `reps` calls after one warm-up, by CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def check_against_plain(label: str, ks, ki, rs, ri, qq, vv, tol: float) -> tuple[float, int]:
    """Kernel (ks, ki) against plain (rs, ri): the same slots are empty (-inf),
    finite scores agree within `tol`, and an id may differ only where its exact
    score lies within the band of the plain score. Returns (max error, swaps)."""
    import torch

    finite = torch.isfinite(rs)
    check(torch.equal(torch.isfinite(ks), finite), f"{label}: empty slots differ")
    err = (ks[finite] - rs[finite]).abs().max().item() if finite.any() else 0.0
    check(err <= tol, f"{label}: max score error {err:.3g} > {tol:.3g}")
    check(torch.equal(ki[~finite], ri[~finite]), f"{label}: ids of empty slots differ")
    rows, cols = (ki != ri).nonzero(as_tuple=True)
    if len(rows):  # a swap is allowed only inside the tolerance band
        exact = (qq[rows].double() * vv[ki[rows, cols].long()].double()).sum(-1)
        gap = (exact - rs[rows, cols].double()).abs().max().item()
        check(gap <= 2 * tol, f"{label}: id swap outside the band ({gap:.3g})")
    return err, len(rows)


def percentile(xs: list[float], p: float) -> float:
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(round(p / 100 * (len(xs) - 1))))]


def realm_setup(dev, t: dict, seed: int):
    """A `Realm` at the widths of `t` (retriever and reader, bf16 activations,
    random weights from a generator seeded `seed`), a corpus of t["n"]
    sections of t["ls"] random ids resident on `dev`, and a maker of query
    batches (t["b"] queries of t["lq"] ids, two gold ids, answers of t["la"]).
    Returns (model, corpus, query_batch, generator)."""
    import torch

    from vod_tpu_torch.models import CausalLMConfig, Realm, TransformerEncoderConfig, VodGradients, VodPoolerConfig
    from vod_tpu_torch.runtime import QueryBatch, build_device_corpus

    n, d, b = t["n"], t["d"], t["b"]
    g = torch.Generator(device=dev).manual_seed(seed)
    widths = dict(vocab_size=t["vocab"], hidden_size=d, num_layers=t["layers"], num_heads=t["heads"],
                  intermediate_size=t["inter"])
    enc_cfg = TransformerEncoderConfig(  # ModelConfig's pooler defaults: mean, l2, scaler 10, learned
        max_position_embeddings=512, dtype=torch.bfloat16,
        pooler=VodPoolerConfig(agg_method="mean", output_norm="l2", scaler=10.0, learn_scaler=True), **widths,
    )
    model = Realm(enc_cfg, CausalLMConfig(dtype=torch.bfloat16, **widths),
                  VodGradients(alpha=0.5, proposal_temperature=1.0), device=dev, generator=g)

    def lengths_mask(rows: int, width: int):
        """Rows of random length, from a third of `width` to all of it."""
        lengths = torch.randint(max(1, width // 3), width + 1, (rows, 1), generator=g, device=dev)
        return (torch.arange(width, device=dev)[None] < lengths).to(torch.int32)

    corpus = build_device_corpus(
        torch.randint(1000, t["vocab"], (n, t["ls"]), generator=g, device=dev, dtype=torch.int32),
        lengths_mask(n, t["ls"]), device=dev,
    )

    def query_batch() -> QueryBatch:
        return QueryBatch(
            input_ids=torch.randint(1000, t["vocab"], (b, t["lq"]), generator=g, device=dev, dtype=torch.int32),
            attention_mask=lengths_mask(b, t["lq"]),
            section_ids=torch.randint(0, n, (b, 2), generator=g, device=dev, dtype=torch.int32),
            answer_ids=torch.randint(1000, t["vocab"], (b, t["la"]), generator=g, device=dev, dtype=torch.int32),
            answer_mask=lengths_mask(b, t["la"]),
        )

    return model, corpus, query_batch, g


def step_recorder():
    """A training-loop callback that records CUDA events around each
    optimizer step, its metrics (tensors on the card, read after the loop)
    and its `fused_mips_binned` launches by body."""
    import torch

    from vod_tpu_torch.ops.mips import fused_mips_binned
    from vod_tpu_torch.runtime.callbacks import Callback

    class StepRecorder(Callback):
        def __init__(self):
            self.events, self.metrics, self.launches = [], [], []

        def on_train_batch_start(self, **kw):
            self.events.append([torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)])
            self.events[-1][0].record()
            self._before = dict(fused_mips_binned.body_launches)

        def on_train_batch_end(self, *, metrics, **kw):
            self.events[-1][1].record()
            self.metrics.append(metrics)
            self.launches.append({k: v - self._before[k] for k, v in fused_mips_binned.body_launches.items()})

    return StepRecorder()


def train_phase(dev, card: str, hbm: float, peak_bf16: float, peak_f32: float, t: dict) -> dict:
    """Phase 5: the REALM train path at the sizes in `t` (module constant
    TRAIN). Returns the train-path kernel call's numbers and launches."""
    import torch

    from vod_tpu_torch.ops.mips import _binned_body, fused_mips_binned, fused_mips_binned_reference
    from vod_tpu_torch.runtime import (
        ParameterSchedule, TrainerState, adamw, make_train_step, training_loop, validation_loop,
    )
    from vod_tpu_torch.search import HybridEngines, build_dense_index

    n, d, b = t["n"], t["d"], t["b"]
    t0 = time.perf_counter()
    model, corpus, query_batch, g = realm_setup(dev, t, seed=2)
    n_params = sum(p.numel() for p in model.parameters())
    vecs = torch.randn((n, d), generator=g, device=dev)
    index = build_dense_index(vecs / vecs.norm(dim=-1, keepdim=True), dtype="bfloat16", kernel="fused", device=dev)
    del vecs
    check(index.fused_bins == t["bins"], "the index does not run the kernel at 512 bins")
    engines = HybridEngines(dense=index)

    steps = t["warmup"] + t["timed"]
    train_batches = [query_batch() for _ in range(steps * t["accum"])]
    val_batches = [query_batch() for _ in range(t["val_batches"])]
    torch.cuda.synchronize()
    log(f"train setup: Realm {n_params / 1e6:.1f}M params; corpus {n} x {t['ls']} tokens and a flat bf16 "
        f"{index.vectors.shape[0]} x {d} index (kernel fused, {index.fused_bins} bins) in "
        f"{time.perf_counter() - t0:.2f} s")

    # one train-path kernel call (the first micro-batch's queries) against its plain version
    with torch.no_grad():
        q = model.encode_field(train_batches[0].input_ids, train_batches[0].attention_mask).to(torch.bfloat16)
    vv, k, bins = index.vectors, min(t["prefetch"], t["bins"]), t["bins"]
    body = _binned_body(vv.dtype, d, bins, (vv.data_ptr(), q.data_ptr()))
    check(body == "wgmma", f"the train-path call takes the {body} body, not wgmma")
    before = fused_mips_binned.body_launches["wgmma"]
    ks, ki = fused_mips_binned(vv, q, k=k, bins=bins, n_real=index.n_real)
    check(fused_mips_binned.body_launches["wgmma"] == before + 1, "the train-path call did not launch on wgmma")
    rs, ri = fused_mips_binned_reference(vv, q, k=k, bins=bins, n_real=index.n_real)
    tol = 2 * d * 2.0**-24 * q.float().norm(dim=-1).max().item() * vv.float().norm(dim=-1).max().item()
    err, swaps = check_against_plain(f"train-path binned B={b} D={d}", ks, ki, rs, ri, q, vv, tol)
    check(ki.max().item() < index.n_real, "train-path binned: a masked row was returned")
    ms = time_ms(lambda: fused_mips_binned(vv, q, k=k, bins=bins, n_real=index.n_real), 20)
    plain_ms = time_ms(lambda: fused_mips_binned_reference(vv, q, k=k, bins=bins, n_real=index.n_real), 2)
    library_ms = time_ms(lambda: torch.topk(q @ vv[: index.n_real].T, k, dim=-1), 20)
    nbytes = (index.n_real + b) * d * 2 + b * k * 8
    ops = 2 * b * index.n_real * d
    bound = max(nbytes / hbm, ops / peak_bf16) * 1e3
    bound_by = "bytes" if nbytes / hbm >= ops / peak_bf16 else "operations"
    log(f"check train-path binned bf16 B={b} D={d} bins={bins} k={k} (wgmma): max |kernel - plain| = {err:.3g} "
        f"(tol {tol:.3g}), {swaps} id swaps inside the band; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"library {library_ms:.4f} ms, bound {bound:.4f} ms ({bound_by}) [{card}]")

    optimizer = adamw(model, t["lr"], weight_decay=0.0)  # TrainerConfig's decay, with the decay mask
    step_fn = make_train_step(
        model, optimizer, prefetch=t["prefetch"], n_sections=t["n_sections"], max_pos_sections=t["max_pos"],
        temperature=1.0, with_lm=True, gradient_clip_val=1.0, accumulate_grad_batches=t["accum"],
    )
    start_params = [[p.detach().clone() for p in grp["params"]] for grp in optimizer.param_groups]
    recorder = step_recorder()
    state = TrainerState(max_steps=steps, parameters={"dense": ParameterSchedule(value=1.0)})
    torch.cuda.synchronize()
    base_mem = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    fused_mips_binned.launches = 0
    fused_mips_binned.body_launches.update(wgmma=0, fma=0)  # main path starts
    t_main = time.perf_counter()
    state, last = training_loop(
        step_fn=step_fn, engines=engines, corpus=corpus, train_queries=train_batches, state=state, generator=g,
        log_interval=10**9, callbacks=[recorder],
    )
    val = validation_loop(step_fn=step_fn, engines=engines, corpus=corpus, val_queries=val_batches, generator=g,
                          weights=state.get_parameters())
    torch.cuda.synchronize()
    launches = fused_mips_binned.launches  # main path ends
    body_launches = dict(fused_mips_binned.body_launches)
    wall = time.perf_counter() - t_main
    peak_mem = torch.cuda.max_memory_allocated(dev)

    check(state.step == steps and len(recorder.metrics) == steps, f"{state.step} optimizer steps, not {steps}")
    losses = [float(m["loss"]) for m in recorder.metrics]
    norms = [float(m["grad_norm"]) for m in recorder.metrics]
    check(all(math.isfinite(x) for x in losses + norms), f"a loss or gradient norm is not finite: {losses} {norms}")
    check(all(x == {"wgmma": t["accum"], "fma": 0} for x in recorder.launches),
          f"an optimizer step did not launch fused_mips_binned once per micro-batch on wgmma: {recorder.launches}")
    check(body_launches == {"wgmma": steps * t["accum"] + t["val_batches"], "fma": 0} and launches == body_launches["wgmma"],
          f"train path launches {launches}, by body {body_launches}")
    for grp, before in zip(optimizer.param_groups, start_params):
        check(any(not torch.equal(p, p0) for p, p0 in zip(grp["params"], before)), f"group {grp['name']} never moved")
    check(math.isfinite(val["loss"]), "validation loss is not finite")
    step_ms = [s.elapsed_time(e) for s, e in recorder.events]
    timed_ms = step_ms[t["warmup"]:]
    median_ms = statistics.median(timed_ms)
    queries_per_s = b * t["accum"] / (median_ms / 1e3)
    log(f"train loop: {steps} optimizer steps ({t['warmup']} warm-up) + {t['val_batches']} validation batches "
        f"in {wall:.2f} s; fused_mips_binned launches {launches}, by body {body_launches} (2 per step, 1 per "
        f"validation batch)")
    log(f"train step [{card}]: median {median_ms:.4f} ms per optimizer step over {len(timed_ms)} timed steps "
        f"(min {min(timed_ms):.4f}, max {max(timed_ms):.4f}); {queries_per_s:.4f} queries/s, "
        f"{queries_per_s * t['n_sections']:.4f} reader sequences/s; peak memory {peak_mem / 2**30:.4f} GiB "
        f"({base_mem / 2**30:.4f} GiB allocated before the loop)")
    log(f"train losses: {json.dumps([round(x, 6) for x in losses])}; grad norms: {json.dumps([round(x, 6) for x in norms])}")
    log(f"train monitor (last step): mrr {last['mrr']:.6f}, ndcg_10 {last['ndcg_10']:.6f}, "
        f"hitrate_3 {last['hitrate_3']:.6f}; validation: {json.dumps(val)}")

    # one micro-batch by stage, and the reader's f32 head alone (after the main path)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    ev[0].record()
    batch = step_fn.collate(engines, corpus, train_batches[0], g, {"dense": 1.0})
    ev[1].record()
    out = model(batch, mode="evaluate")
    ev[2].record()
    out.loss.backward()
    ev[3].record()
    step_fn.apply_gradients()
    ev[4].record()
    torch.cuda.synchronize()
    stages = dict(zip(("collate", "forward", "backward", "clip_adamw"), (ev[i].elapsed_time(ev[i + 1]) for i in range(4))))
    rows = b * t["n_sections"] * (t["ls"] + t["lq"] + t["la"])
    h = torch.randn((rows, d), generator=g, device=dev)
    w = model.lm.lm_head.weight.detach()
    gl = torch.randn((rows, t["vocab"]), generator=g, device=dev)
    head_ms = time_ms(lambda: (h @ w.T, gl @ w, gl.T @ h), 3)
    head_flops = 3 * 2 * rows * d * t["vocab"]
    del h, gl, batch, out
    log(f"train micro-batch by stage [{card}]: {json.dumps({k: round(v, 4) for k, v in stages.items()})} ms; "
        f"f32 reader head (forward + both backward products, {rows} x {d} x {t['vocab']}, TF32 off): "
        f"{head_ms:.4f} ms = {head_flops / head_ms / 1e9:.2f} TFLOP/s (f32 peak {peak_f32 / 1e12:.0f})")
    profile = profile_step(step_fn, engines, corpus, train_batches[: t["accum"]], g)
    log(f"train step profile [{card}]: {json.dumps(profile)}")
    # the step never waits for the card: one more optimizer step with any
    # synchronizing call made an error; the host's time to enqueue it beside
    # the step's time to finish on the card
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        step_fn.train_step_accum(engines, corpus, train_batches[: t["accum"]], g, {"dense": 1.0})
        host_ms = (time.perf_counter() - t0) * 1e3
    except RuntimeError as exc:
        fail(f"the train step waits for the card: {exc}")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    done_ms = (time.perf_counter() - t0) * 1e3
    profile.update(enqueue_ms=host_ms, finish_ms=done_ms)
    log(f"train step without a sync [{card}]: the host enqueued one optimizer step in {host_ms:.4f} ms; "
        f"the card finished it {done_ms:.4f} ms after the start")
    return dict(
        train_launches=launches, train_body_launches=body_launches, train_max_abs_err=err,
        train_call=dict(shape=f"bfloat16 B={b} N={index.n_real} D={d} bins={bins} k={k}", ms=ms, plain_ms=plain_ms,
                        library_ms=library_ms, bound_ms=bound, bound_by=bound_by),
        train_step=dict(median_ms=median_ms, step_ms=step_ms, queries_per_s=queries_per_s, peak_mem_bytes=peak_mem,
                        losses=losses, grad_norms=norms, stages_ms=stages, head_ms=head_ms, profile=profile),
    )


def host_and_device_ms(fn, reps: int) -> tuple[float, float, dict]:
    """Per call of `fn`: the host's time to enqueue it (no profiler, no
    synchronize inside the loop), and the device time of the CUDA kernels it
    launches from `torch.profiler` over `reps` more calls, in all and by
    kernel name. When the host's time is the larger, CUDA events around a
    run of calls measure the host, not the card."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_name = {e.key[:60]: e.self_device_time_total / 1e3 / reps
               for e in prof.key_averages() if e.device_type == DeviceType.CUDA}
    return host_ms, sum(by_name.values()), by_name


def profile_step(step_fn, engines, corpus, micro_batches, generator) -> dict:
    """One optimizer step under `torch.profiler`: the host wall time, the
    device time its kernels took (their share of the wall is the busy share;
    the profiler's own host cost makes it a lower bound) and the kernels that
    took the most, by name. Runs after the main path, so its launches are
    not counted there."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_fn.train_step_accum(engines, corpus, micro_batches, generator, {"dense": 1.0})
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device_ms = {  # the kernels themselves, not the host ops that launched them
        e.key[:80]: e.self_device_time_total / 1e3 for e in prof.key_averages() if e.device_type == DeviceType.CUDA
    }
    busy = sum(device_ms.values())
    top = sorted(device_ms.items(), key=lambda kv: -kv[1])[:12]
    return dict(wall_ms=wall_ms, device_ms=busy, busy_share=busy / wall_ms if busy else None,
                top_kernels_ms={k: round(v, 4) for k, v in top})


def periodic_phase(dev, card: str, hbm: float, peak_int8: float, t: dict) -> dict:
    """Phase 6: periodic training over the PQ codec at the sizes in `t`
    (module constant PERIODIC), then the PQ coarse route (the `pq` preset and
    the factory default, both `kernel: fused`) on period 1's embeddings.
    Returns the coarse route's kernel calls and launches, and the periodic
    run's numbers."""
    import torch

    from vod_tpu_torch.configs import DenseFactoryConfig
    from vod_tpu_torch.exps import PeriodicTrainingConfig, periodic_training, recipes
    from vod_tpu_torch.ops.mips import _binned_body, fused_mips_binned, fused_mips_binned_reference
    from vod_tpu_torch.runtime import ParameterSchedule, TrainerState, adamw, make_train_step
    from vod_tpu_torch.search import SearchQueries, build_dense_from_config, dense as dense_module
    from vod_tpu_torch.search import hybrid as hybrid_module
    from vod_tpu_torch.search import pq_search

    n, b, periods, steps = t["n"], t["b"], t["periods"], t["steps"]
    t0 = time.perf_counter()
    model, corpus, query_batch, g = realm_setup(dev, t, seed=3)
    batches = [[query_batch() for _ in range(steps * t["accum"])] for _ in range(periods)]
    held_out = [query_batch() for _ in range(-(-t["held_out"] // b))]
    torch.cuda.synchronize()
    log(f"periodic setup: Realm {sum(p.numel() for p in model.parameters()) / 1e6:.1f}M params; corpus {n} x "
        f"{t['ls']} tokens in {time.perf_counter() - t0:.2f} s")

    # what the run builds and retrieves, recorded for the checks after it
    builds, collate_calls = [], []
    real_build, real_search = recipes.build_dense_from_config, hybrid_module.pq_search

    def recording_build(cfg, vectors, **kw):
        index = real_build(cfg, vectors, **kw)
        # period 0: a row sample (to see the encoder move); the last period: all rows
        builds.append((vectors if len(builds) == periods - 1 else vectors[:4096].clone(), index))
        return index

    def recording_search(index, queries, top_k, **kw):
        out = real_search(index, queries, top_k, **kw)
        if len(builds) == periods and not collate_calls:  # the last period's first retrieval
            collate_calls.append((index, queries.vector.clone(), top_k, out.indices.clone(), out.scores.clone()))
        return out

    recipes.build_dense_from_config, hybrid_module.pq_search = recording_build, recording_search
    optimizer = adamw(model, t["lr"], weight_decay=0.0)
    step_fn = make_train_step(
        model, optimizer, prefetch=t["prefetch"], n_sections=t["n_sections"], max_pos_sections=t["max_pos"],
        temperature=1.0, with_lm=True, gradient_clip_val=1.0, accumulate_grad_batches=t["accum"],
    )
    recorder = step_recorder()
    state = TrainerState(max_steps=periods * steps, period=steps, parameters={"dense": ParameterSchedule(value=1.0)})
    config = PeriodicTrainingConfig(dense=DenseFactoryConfig(**t["dense"]), log_interval=steps)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    fused_mips_binned.launches = 0
    fused_mips_binned.body_launches.update(wgmma=0, fma=0)  # main path starts
    t_main = time.perf_counter()
    try:
        state, history = periodic_training(
            step_fn=step_fn, corpus=corpus, state=state, train_queries_fn=lambda p: batches[p], generator=g,
            config=config, callbacks=[recorder],
        )
    finally:
        recipes.build_dense_from_config, hybrid_module.pq_search = real_build, real_search
    torch.cuda.synchronize()
    periodic_launches = dict(fused_mips_binned.body_launches)  # main path ends
    wall = time.perf_counter() - t_main
    peak_mem = torch.cuda.max_memory_allocated(dev)

    check(state.step == periods * steps and len(history) == periods and len(builds) == periods,
          f"periodic run: {state.step} steps, {len(history)} periods, {len(builds)} builds")
    losses = [float(m["loss"]) for m in recorder.metrics]
    check(len(losses) == periods * steps and all(math.isfinite(x) for x in losses), f"periodic losses {losses}")
    step_ms = [s.elapsed_time(e) for s, e in recorder.events]
    # the codec of this path (exhaustive ADC) runs no Pallas kernel in JAX and no CUDA kernel here
    check(periodic_launches == {"wgmma": 0, "fma": 0}, f"the exhaustive-ADC path launched {periodic_launches}")
    (emb0, index0), (emb1, index1) = builds[0], builds[-1]
    check(float((emb1[: len(emb0)] - emb0).abs().max()) > 1e-4, "period 1's embeddings equal period 0's")
    n_pad = -(-n // 8192) * 8192 if n > 131072 else -(-n // 128) * 128
    m_sub, r_dim = t["dense"]["n_subquantizers"], t["dense"]["refine_dim"]
    for ix in (index0, index1):
        check(ix.codes.shape == (n_pad, m_sub // 2) and ix.codes.dtype == torch.uint8, f"codes {ix.codes.shape}")
        check(ix.refine_codes.shape == (n_pad, r_dim) and ix.refine_codes.dtype == torch.int8,
              f"refine rows {ix.refine_codes.shape} {ix.refine_codes.dtype}")
        check(ix.coarse_codes is None and ix.kernel == "scan", "the periodic index is not the exhaustive-ADC codec")
    check(not torch.equal(index0.codes, index1.codes), "period 1's codes equal period 0's")
    for p, h in enumerate(history):
        emb_ms = h["reembed_s"] * 1e3
        log(f"periodic period {p} [{card}]: re-embed {emb_ms:.4f} ms ({n / h['reembed_s']:.4f} sections/s); build "
            f"{json.dumps({k: round(v, 4) for k, v in h['build_ms'].items()})} ms; index {h['index_bytes']} bytes; "
            f"ms per optimizer step {json.dumps([round(x, 4) for x in step_ms[p * steps:(p + 1) * steps]])}; "
            f"loss {h['train'].get('loss', float('nan')):.6f}")
    log(f"periodic run: {periods} periods of {steps} optimizer steps in {wall:.2f} s; peak memory "
        f"{peak_mem / 2**30:.4f} GiB; fused_mips_binned launches {periodic_launches}")

    # the collate's retrieval against a direct pq_search of the same query vectors
    ix, qv, top_k, ids, scores = collate_calls[0]
    direct = pq_search(ix, SearchQueries(vector=qv), top_k)
    check(torch.equal(direct.indices, ids), "a direct pq_search does not return the ids the collate retrieved")
    check(torch.equal(direct.scores, scores), "a direct pq_search does not return the collate's scores")

    # recall@10 of the last period's index against an exact f32 scan of the same embeddings
    with torch.no_grad():
        q_held = torch.cat([model.encode_field(qb.input_ids, qb.attention_mask) for qb in held_out])[: t["held_out"]]
    torch.backends.cuda.matmul.allow_tf32 = False
    exact = torch.cat([torch.topk(qs @ emb1.T, 10, dim=-1).indices for qs in q_held.split(64)])
    got = pq_search(index1, SearchQueries(vector=q_held), 10).indices

    def recall(ids_) -> float:
        ref = exact[: len(ids_)].cpu()
        return sum(len(set(a.tolist()) & set(e.tolist())) for a, e in zip(ids_.cpu(), ref)) / ref.numel()

    recall10 = recall(got)
    log(f"periodic recall@10 of period {periods - 1}'s index vs exact f32 search, {len(q_held)} held-out queries: "
        f"{recall10:.4f} (floor {t['recall_floor']})")
    check(recall10 >= t["recall_floor"], f"periodic recall@10 {recall10:.4f} < floor {t['recall_floor']}")
    del builds, index0, emb0, collate_calls, ix, direct, optimizer, step_fn, model, corpus, batches
    torch.cuda.empty_cache()

    # the PQ coarse route: both coarse configs on the last period's embeddings
    calls, real_kernel = [], dense_module.fused_mips_binned

    def recording_kernel(vectors, queries, **kw):
        out = real_kernel(vectors, queries, **kw)
        calls.append((vectors, queries.clone(), kw, out))
        return out

    coarse, coarse_recall = {}, {}
    for name, cfg in t["coarse"].items():
        t1 = time.perf_counter()
        coarse[name] = build_dense_from_config(DenseFactoryConfig(**cfg), emb1, generator=g, device=dev)
        torch.cuda.synchronize()
        log(f"coarse index {name}: {json.dumps(cfg)} built in {time.perf_counter() - t1:.2f} s; coarse codes "
            f"{tuple(coarse[name].coarse_codes.shape)}")
    dense_module.fused_mips_binned = recording_kernel
    fused_mips_binned.launches = 0
    fused_mips_binned.body_launches.update(wgmma=0, fma=0)  # main path (coarse route) starts
    try:
        for name, ix in coarse.items():
            for bq in t["coarse_batches"]:
                out = pq_search(ix, SearchQueries(vector=q_held[:bq]), 10)
                if bq == max(t["coarse_batches"]):
                    coarse_recall[name] = recall(out.indices)
    finally:
        dense_module.fused_mips_binned = real_kernel
    torch.cuda.synchronize()
    coarse_launches = fused_mips_binned.launches  # main path ends
    coarse_bodies = dict(fused_mips_binned.body_launches)
    n_calls = len(t["coarse"]) * len(t["coarse_batches"])
    check(len(calls) == n_calls and coarse_launches == n_calls, f"coarse route: {len(calls)} calls, {coarse_launches} launches")
    check(coarse_bodies == {"wgmma": n_calls, "fma": 0}, f"the coarse route's launches by body: {coarse_bodies}")
    log(f"coarse route: fused_mips_binned launches {coarse_launches}, by body {coarse_bodies}; recall@10 at "
        f"B={max(t['coarse_batches'])}: {json.dumps({k: round(v, 4) for k, v in coarse_recall.items()})}")

    # each coarse kernel call against its plain version (int8: every cell bit for bit) and timed
    shapes = []
    for vv, qq, kw, (ks, ki) in calls:
        bq, dc = (int(x) for x in qq.shape)
        check(_binned_body(vv.dtype, dc, kw["bins"], (vv.data_ptr(), qq.data_ptr())) == "wgmma", "coarse call off wgmma")
        check(kw["k"] == kw["bins"], f"coarse call k={kw['k']} != bins={kw['bins']}")
        rs, ri = fused_mips_binned_reference(vv, qq, **kw)
        check(torch.equal(ks, rs) and torch.equal(ki, ri), f"coarse int8 B={bq} D={dc}: kernel != plain")
        ms = time_ms(lambda: fused_mips_binned(vv, qq, **kw), 20)
        host_ms, device_ms, by_kernel = host_and_device_ms(lambda: fused_mips_binned(vv, qq, **kw), 20)
        binned_ms = sum(v for key, v in by_kernel.items() if "binned_wgmma_kernel" in key)
        check(binned_ms > 0, f"the profiler saw no binned_wgmma_kernel: {by_kernel}")
        plain_ms = time_ms(lambda: fused_mips_binned_reference(vv, qq, **kw), 2)
        library_ms = time_ms(lambda: torch.topk(torch._int_mm(qq, vv.T), kw["k"], dim=-1), 20)
        nbytes = (int(vv.shape[0]) + bq) * dc + bq * kw["k"] * 8
        ops = 2 * bq * int(vv.shape[0]) * dc
        bound = max(nbytes / hbm, ops / peak_int8) * 1e3
        shapes.append(dict(dtype="int8", body="wgmma", B=bq, N=int(vv.shape[0]), D=dc, bins=kw["bins"], k=kw["k"],
                           ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound,
                           bound_by="bytes" if nbytes / hbm >= ops / peak_int8 else "operations",
                           host_ms=host_ms, device_ms=device_ms, binned_kernel_ms=binned_ms, device_by_kernel=by_kernel))
        log(f"check coarse int8 B={bq} N={vv.shape[0]} D={dc} bins={kw['bins']} k={kw['k']} (wgmma): all cells equal; "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library {library_ms:.4f} ms, bound {bound:.4f} ms "
            f"({shapes[-1]['bound_by']}) [{card}]")
        log(f"  split of that call [{card}]: host enqueue {host_ms:.4f} ms, device {device_ms:.4f} ms (profiler), of "
            f"which binned_wgmma_kernel {binned_ms:.4f} ms; by kernel {json.dumps({k: round(v, 4) for k, v in by_kernel.items()})}")
    return dict(
        coarse_launches=coarse_launches, coarse_body_launches=coarse_bodies, coarse_shapes=shapes,
        coarse_recall_at_10=coarse_recall,
        periodic=dict(
            periods=[dict(reembed_ms=h["reembed_s"] * 1e3, sections_per_s=n / h["reembed_s"], build_ms=h["build_ms"],
                          index_bytes=h["index_bytes"], period_s=h["period_s"]) for h in history],
            step_ms=step_ms, losses=losses, peak_mem_bytes=peak_mem, recall_at_10=recall10,
            launches=periodic_launches,
        ),
    )


def main() -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: this script runs the port on an NVIDIA GPU")
    kernel_names = ("fused_mips_binned", "fused_mips_topk")
    if not all((ROOT / "vod_tpu_torch" / "csrc" / f"{name}.cu").is_file() for name in kernel_names):
        fail(f"no vod_tpu_torch checkout around {ROOT}")
    sys.path.insert(0, str(ROOT))
    from vod_tpu_torch.examples import mips_kernel_bench
    from vod_tpu_torch.models import TransformerEncoderConfig, VodEncoder, VodPoolerConfig
    from vod_tpu_torch.ops import cuda_build
    from vod_tpu_torch.ops.mips import (
        _binned_body,
        _topk_body,
        fused_mips_binned,
        fused_mips_binned_reference,
        fused_mips_topk,
        fused_mips_topk_reference,
    )
    from vod_tpu_torch.ops.pq import quantize_int8
    from vod_tpu_torch.search import HybridEngines, SearchQueries, build_dense_index, dense_search
    from vod_tpu_torch.search.dense import quantize_queries_int8
    from vod_tpu_torch.serving import SearchHttpClient, SearchServer

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False  # exact f32 ground truth
    torch.backends.cudnn.allow_tf32 = False

    # 1. the card
    card = mips_kernel_bench.card_name(dev)
    kind = torch.cuda.get_device_name(0)
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}; devices: {torch.cuda.device_count()}")
    sheet = next((v for key, v in DATASHEETS if key in kind), None)
    check(sheet is not None, f"no data-sheet peaks for {kind!r}")
    hbm, peak_bf16, peak_int8, peak_f32 = sheet

    # 2. kernel builds, one nvcc per source, all started together
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(kernel_names)) as ex:
        builds = list(ex.map(cuda_build.build, kernel_names))
    for name, (path, seconds, nvcc_log) in zip(kernel_names, builds):
        regs = [ln.split("info    : ")[-1] for ln in nvcc_log.splitlines() if "registers" in ln]
        log(f"build: {name}: nvcc {seconds:.2f} s -> {path.relative_to(ROOT)}; " + " | ".join(regs))
    log(f"build: both kernels in {time.perf_counter() - t0:.2f} s")

    # 3. kernel vs plain version at the headline shape
    g = torch.Generator(device=dev).manual_seed(0)
    v32 = torch.randn((N_KERNEL, D), generator=g, device=dev)
    v32 /= v32.norm(dim=-1, keepdim=True)
    src = torch.randint(0, N_KERNEL, (2048,), generator=g, device=dev)
    q32 = v32[src] + 0.1 * torch.randn((2048, D), generator=g, device=dev)
    q32 /= q32.norm(dim=-1, keepdim=True)
    vb = v32.to(torch.bfloat16)
    vi8, scale = quantize_int8(v32, dim=0)
    qi8, _ = quantize_queries_int8(q32, scale)
    del v32
    qb = q32.to(torch.bfloat16)
    # the same rows off the 16-byte grid (bf16 2 bytes, int8 4 bytes): the body
    # rules send them to the CUDA-core bodies
    vb_odd = torch.empty(N_KERNEL * D + 1, dtype=torch.bfloat16, device=dev)[1:].view(N_KERNEL, D)
    vb_odd.copy_(vb)
    vi8_odd = torch.empty(N_KERNEL * D + 4, dtype=torch.int8, device=dev)[4:].view(N_KERNEL, D)
    vi8_odd.copy_(vi8)
    # twice the f32 sum-order bound gamma_D * |q| * |v| for the bf16 inputs
    tol = 2 * D * 2.0**-24 * qb.float().norm(dim=-1).max().item() * vb.float().norm(dim=-1).max().item()
    max_err = 0.0

    def binned_body_of(vv, qs, bins: int, expect: str) -> str:
        """The body a binned call takes, named by the wrapper's rule."""
        body = _binned_body(vv.dtype, D, bins, (vv.data_ptr(), qs.to(vv.dtype).data_ptr()))
        check(body == expect, f"binned {vv.dtype} at offset {vv.storage_offset()}: body {body}, not {expect}")
        return body

    def binned_call(vv, qs, bins: int, expect: str, **kw):
        """One `fused_mips_binned` call, checked to launch once on the named body."""
        body = binned_body_of(vv, qs, bins, expect)
        before = fused_mips_binned.body_launches[body]
        out = fused_mips_binned(vv, qs, bins=bins, **kw)
        check(fused_mips_binned.body_launches[body] == before + 1, f"binned {vv.dtype}: not on the {body} body")
        return out

    # (dtype, corpus, queries, B, bins, body, n_real): the twelve headline
    # shapes, the CUDA-core body on rows off the grid, the tensor-core edge cases
    binned_cases = [
        (dt, vv, qq, b, bins, "wgmma", N_KERNEL)
        for dt, vv, qq in (("bfloat16", vb, qb), ("int8", vi8, qi8)) for b in BATCHES for bins in (512, 1024)
    ] + [
        ("bfloat16", vb_odd, qb, 64, 1024, "fma", N_KERNEL),
        ("bfloat16", vb_odd, qb, 2048, 512, "fma", N_KERNEL),
        ("int8", vi8_odd, qi8, 64, 512, "fma", N_KERNEL),
    ] + [
        (dt, vv, qq, b, bins, "wgmma", N_KERNEL - 77)
        for dt, vv, qq, bins in (("bfloat16", vb, qb, 1024), ("int8", vi8, qi8, 512)) for b in (3, 65)
    ]
    for dtype, vv, qq, b, bins, expect, n_real in binned_cases:
        label = f"{dtype} B={b} bins={bins} n_real={n_real} ({expect})"
        if dtype == "bfloat16":
            ks, ki = binned_call(vv, qq[:b], bins, expect, k=K_POOL, n_real=n_real)
            err, swaps = check_against_plain(
                label, ks, ki, *fused_mips_binned_reference(vv, qq[:b], k=K_POOL, bins=bins, n_real=n_real),
                qq[:b], vv, tol,
            )
            max_err = max(max_err, err)
            log(f"check {label}: max |kernel - plain| = {err:.3g} (tol {tol:.3g}), {swaps} id swaps inside the band")
        else:
            ks, ki = binned_call(vv, qq[:b], bins, expect, k=bins, n_real=n_real)  # every cell
            rs, ri = fused_mips_binned_reference(vv, qq[:b], k=bins, bins=bins, n_real=n_real)
            check(torch.equal(ks, rs) and torch.equal(ki, ri), f"{label}: kernel != plain")
            log(f"check {label}: all {b}x{bins} cells equal (ids and int32 scores)")
        check(ki.max().item() < n_real, f"{label}: a masked row was returned")
    n_real = N_KERNEL - 12345
    for vv, qq in ((vb, qb[:64]), (vi8, qi8[:64])):
        ks, ki = binned_call(vv, qq, 1024, "wgmma", k=K_POOL, n_real=n_real)
        rs, ri = fused_mips_binned_reference(vv, qq, k=K_POOL, bins=1024, n_real=n_real)
        check(ki.max().item() < n_real, f"n_real masking ({vv.dtype}): a masked row was returned")
        if vv.dtype == torch.int8:
            check(torch.equal(ki, ri) and torch.equal(ks, rs), "n_real masking (int8): kernel != plain")
        else:  # the two sum orders may swap ids inside the band
            check_against_plain(f"n_real masking ({vv.dtype})", ks, ki, rs, ri, qq, vv, tol)
    saved = vi8[[7 + 512 * 3, 7 + 512 * 20]].clone()
    vi8[7 + 512 * 3] = vi8[7]
    vi8[7 + 512 * 20] = vi8[7]
    qdup = qi8[:64].clone()
    qdup[0] = vi8[7]
    ks, ki = binned_call(vi8, qdup, 512, "wgmma", k=512)
    rs, ri = fused_mips_binned_reference(vi8, qdup, k=512, bins=512)
    check(ki[0, 0].item() == 7 and torch.equal(ki, ri) and torch.equal(ks, rs), "duplicate rows: tie not to lowest id")
    vi8[[7 + 512 * 3, 7 + 512 * 20]] = saved
    log(f"check edges: n_real={n_real} masked in bf16 and int8; duplicate rows tie to the lowest id")

    shapes = []
    for dtype, vv, qq, b, bins, expect, n_real in binned_cases:
        if n_real != N_KERNEL:
            continue
        qs = qq[:b]
        body = binned_body_of(vv, qs, bins, expect)
        reps = 20 if b <= 64 else 3
        ms = time_ms(lambda: fused_mips_binned(vv, qs, k=K_POOL, bins=bins), reps)
        plain_ms = time_ms(lambda: fused_mips_binned_reference(vv, qs, k=K_POOL, bins=bins), 2)
        # the library yardstick: exact top-k over one library product
        # (cuBLAS bf16 GEMM, or cuBLASLt int8 x int8 -> int32 through
        # `torch._int_mm`, which takes only more than 16 rows; it reads the
        # aligned int8 corpus, since cuBLASLt may refuse rows off the grid)
        library_ms = None
        if dtype == "bfloat16":
            library_ms = time_ms(lambda: torch.topk(qs @ vv.T, K_POOL, dim=-1), reps)
        elif b > 16:
            library_ms = time_ms(lambda: torch.topk(torch._int_mm(qs, vi8.T), K_POOL, dim=-1), reps)
        peak = peak_bf16 if dtype == "bfloat16" else peak_int8
        nbytes = (N_KERNEL + b) * D * vv.element_size() + b * K_POOL * 8
        ops = 2 * b * N_KERNEL * D
        bound = max(nbytes / hbm, ops / peak) * 1e3
        shapes.append(dict(
            dtype=dtype, body=body, B=b, N=N_KERNEL, D=D, bins=bins, k=K_POOL, ms=ms, plain_ms=plain_ms,
            library_ms=library_ms, bound_ms=bound,
            bound_by="bytes" if nbytes / hbm >= ops / peak else "operations",
        ))
        log(f"time {dtype} B={b} bins={bins} ({body}): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"library {library_ms if library_ms is None else round(library_ms, 4)} ms, "
            f"bound {bound:.4f} ms ({shapes[-1]['bound_by']}) [{card}]")
    del vi8, qi8, vi8_odd, binned_cases

    # 3b. the exact kernel vs its plain version at the headline shape
    v32 = vb.float()  # the f32 case: the bf16 corpus widened, summed in full f32
    exact_cases = [("bfloat16", vb, qb, b, k, "wgmma") for b in BATCHES for k in EXACT_KS] + [
        ("float32", v32, q32, 64, 128, "fma"),
        ("bfloat16", vb_odd, qb, 64, 10, "fma"),
        ("bfloat16", vb_odd, qb, 2048, 128, "fma"),
    ]
    exact_err = 0.0

    def body_of(vv, qs, expect: str) -> str:
        """The body a call takes, named by the wrapper's rule and confirmed by
        the per-body launch count."""
        body = _topk_body(vv.dtype, D, (vv.data_ptr(), qs.to(vv.dtype).data_ptr()))
        check(body == expect, f"{vv.dtype} at offset {vv.storage_offset()}: body {body}, not {expect}")
        return body

    # the tensor-core body's edge cases: a ragged query tile, k = 1, a ragged last row tile
    edge_cases = [("bfloat16", vb, qb, b, 1, "wgmma", N_KERNEL - 77) for b in (3, 65)]
    for dtype, vv, qq, b, k, expect, n_real in [c + (N_KERNEL,) for c in exact_cases] + edge_cases:
        body = body_of(vv, qq[:b], expect)
        before = fused_mips_topk.body_launches[body]
        ks, ki = fused_mips_topk(vv, qq[:b], k=k, n_real=n_real)
        check(fused_mips_topk.body_launches[body] == before + 1, f"exact {dtype} B={b}: not on the {body} body")
        err, swaps = check_against_plain(
            f"exact {dtype} B={b} k={k} n_real={n_real}", ks, ki,
            *fused_mips_topk_reference(vv, qq[:b], k=k, n_real=n_real), qq[:b].to(vv.dtype), vv, tol,
        )
        check(ki.max().item() < n_real, f"exact {dtype} B={b} n_real={n_real}: a masked row was returned")
        exact_err = max(exact_err, err)
        log(f"check exact {dtype} B={b} k={k} n_real={n_real} ({body}): max |kernel - plain| = {err:.3g} "
            f"(tol {tol:.3g}), {swaps} id swaps inside the band")
    for n_real, k in ((N_KERNEL - 12345, 10), (3, 10)):
        ks, ki = fused_mips_topk(vb, qb[:64], k=k, n_real=n_real)
        check_against_plain(f"exact n_real={n_real}", ks, ki,
                            *fused_mips_topk_reference(vb, qb[:64], k=k, n_real=n_real), qb[:64], vb, tol)
        check(ki.max().item() < n_real, f"exact n_real={n_real}: a masked row was returned")
    check(bool((ki[:, 3:] == -1).all()) and bool(torch.isneginf(ks[:, 3:]).all()),
          "exact n_real=3: slots 3-9 are not -1/-inf")
    # equal rows in different splits at B = 64 (~8k rows a split) and B = 2048 (262,144)
    dups = (7, 7 + 2 * N_KERNEL // 7, 7 + 2 * N_KERNEL // 3)
    saved = vb[list(dups[1:])].clone()
    vb[list(dups[1:])] = vb[7].clone()
    for b in (64, 2048):
        qdup = qb[:b].clone()
        qdup[0] = vb[7]
        ks, ki = fused_mips_topk(vb, qdup, k=10)
        check_against_plain(f"exact duplicates B={b}", ks, ki, *fused_mips_topk_reference(vb, qdup, k=10), qdup, vb, tol)
        check(ki[0, :3].tolist() == list(dups), f"exact duplicates B={b}: {ki[0, :3].tolist()} != {list(dups)}")
    vb[list(dups[1:])] = saved
    log(f"check exact edges: n_real={N_KERNEL - 12345} masked; n_real=3 leaves slots 3-9 at -1/-inf; "
        f"rows {dups} tie in that order at B=64 and 2048")

    # one PyTorch read of the corpus: the rate at which the card streams these bytes
    read_ms = time_ms(lambda: vb.sum(dtype=torch.float32), 20)
    log(f"time corpus read (bf16 {N_KERNEL} x {D}, {vb.numel() * 2 / 1e9:.4f} GB): {read_ms:.4f} ms [{card}]")
    exact_shapes = []
    for dtype, vv, qq, b, k, expect in exact_cases:
        qs = qq[:b].to(vv.dtype)
        body = body_of(vv, qs, expect)
        reps = 20 if b <= 64 else 3
        ms = time_ms(lambda: fused_mips_topk(vv, qs, k=k), reps)
        plain_ms = time_ms(lambda: fused_mips_topk_reference(vv, qs, k=k), 2)
        library_ms = time_ms(lambda: torch.topk(qs @ vv.T, k, dim=-1), reps)
        nbytes = (N_KERNEL + b) * D * vv.element_size() + b * k * 8
        ops = 2 * b * N_KERNEL * D
        peak = peak_bf16 if dtype == "bfloat16" else peak_f32
        bound = max(nbytes / hbm, ops / peak) * 1e3
        exact_shapes.append(dict(
            dtype=dtype, body=body, B=b, N=N_KERNEL, D=D, k=k, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
            bound_ms=bound, bound_by="bytes" if nbytes / hbm >= ops / peak else "operations",
        ))
        log(f"time exact {dtype} B={b} k={k} ({body}): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"library {library_ms:.4f} ms, bound {bound:.4f} ms ({exact_shapes[-1]['bound_by']}) [{card}]")
    del vb, vb_odd, qb, q32, v32, exact_cases, edge_cases, vv, qq, qs
    torch.cuda.empty_cache()

    # 4. the serving path (main path)
    cfg = TransformerEncoderConfig(  # configs/presets/encoder/e5-base.yaml + pooler/mean-l2.yaml
        vocab_size=30522, hidden_size=768, num_layers=12, num_heads=12, intermediate_size=3072,
        max_position_embeddings=512, dtype=torch.bfloat16,
        pooler=VodPoolerConfig(agg_method="mean", output_norm="l2", scaler=10.0, learn_scaler=True),
    )
    encoder = VodEncoder(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0)).eval()
    gs = torch.Generator(device=dev).manual_seed(1)
    corpus = torch.randn((N_SERVE, D), generator=gs, device=dev)
    corpus /= corpus.norm(dim=-1, keepdim=True)
    t0 = time.perf_counter()
    flat = build_dense_index(corpus, dtype="bfloat16", kernel="fused", refine="float32", device=dev)
    flat = flat.replace(fused_bins=1024)
    int8 = build_dense_index(corpus, dtype="int8", kernel="fused", device=dev)
    torch.cuda.synchronize()
    log(f"indexes: flat bf16 + f32 refine ({flat.vectors.shape[0]} rows, 1024 bins), int8 (512 bins); "
        f"built in {time.perf_counter() - t0:.2f} s")
    held_src = torch.randperm(N_SERVE, generator=gs, device=dev)[:N_QUERIES]
    held = corpus[held_src] + 0.1 * torch.randn((N_QUERIES, D), generator=gs, device=dev)
    held = held / held.norm(dim=-1, keepdim=True)
    exact_ids = torch.topk(held @ corpus.T, TOP_K, dim=-1).indices.cpu().numpy()
    ids = torch.randint(1000, cfg.vocab_size, (N_QUERIES, QUERY_TOKENS), generator=gs, device=dev)
    lengths = torch.randint(8, QUERY_TOKENS + 1, (N_QUERIES, 1), generator=gs, device=dev)
    mask = (torch.arange(QUERY_TOKENS, device=dev)[None] < lengths).to(torch.int32)
    gold = torch.randint(0, N_SERVE, (N_QUERIES, 1), generator=gs, device=dev).to(torch.int32).cpu().numpy()
    held_np = held.cpu().numpy()
    del corpus
    direct = {}  # the port's own dense_search on the held-out vectors, called directly
    for name, ix in (("flat", flat), ("int8", int8)):
        out = dense_search(ix, SearchQueries(vector=held), top_k=TOP_K)
        direct[name] = (out.indices.cpu().numpy(), out.scores.cpu().numpy())

    def post_all(client, payloads, workers):
        lat = []

        def one(p):
            t = time.perf_counter()
            out = client.search(top_k=TOP_K, **p)
            lat.append(time.perf_counter() - t)
            return out

        with concurrent.futures.ThreadPoolExecutor(workers) as ex:
            outs = list(ex.map(one, payloads))
        return outs, lat

    fused_mips_binned.launches = 0
    fused_mips_binned.body_launches.update(wgmma=0, fma=0)  # main path starts
    t_main = time.perf_counter()
    with torch.inference_mode():
        qv = encoder(ids, mask)
    torch.cuda.synchronize()
    check(qv.shape == (N_QUERIES, D) and bool(torch.isfinite(qv).all()), "encoder output not finite [64, 768]")
    norms = qv.norm(dim=-1)
    check(bool(((norms - 10.0**0.5).abs() < 1e-3).all()), "pooled norms are not sqrt(10)")
    qv_np = qv.cpu().numpy()
    log(f"encode: {N_QUERIES} x {QUERY_TOKENS} tokens through the e5-base-width encoder -> {tuple(qv.shape)}")
    servers = [
        SearchServer(HybridEngines(dense=ix), batch_window_ms=2, max_batch=64, device=dev) for ix in (flat, int8)
    ]
    results = {}
    for name, ix, srv in (("flat", flat, servers[0]), ("int8", int8, servers[1])):
        with srv:
            srv.warmup({"vector": qv_np[:1], "section_ids": gold[:1]}, top_k=TOP_K)
            srv.warmup({"vector": held_np[:1]}, top_k=TOP_K)
            client = SearchHttpClient(srv.url)
            check(client.ping(), f"{name}: server not ready")
            with urllib.request.urlopen(srv.url + "/stats", timeout=30) as r:
                before = json.loads(r.read())
            enc_payloads = [
                {"vector": qv_np[i : i + 4], "section_ids": gold[i : i + 4]} for i in range(0, N_QUERIES, 4)
            ]
            held_payloads = [{"vector": held_np[i : i + 4]} for i in range(0, N_QUERIES, 4)]
            enc_out, _ = post_all(client, enc_payloads, 16)
            held_out, _ = post_all(client, held_payloads, 16)
            with urllib.request.urlopen(srv.url + "/stats", timeout=30) as r:
                after = json.loads(r.read())
            stats = {k: after[k] - before[k] for k in ("requests", "dispatches")}
            n_req = len(enc_payloads) + len(held_payloads)
            check(stats["requests"] == n_req and stats["dispatches"] < n_req, f"{name}: no batching {stats}")
            for i, out in enumerate(enc_out):
                got = out.indices
                check(bool(((got >= 0) & (got < N_SERVE) | (got == -1)).all()), f"{name}: id out of range")
                for r in range(got.shape[0]):
                    g_id = int(gold[4 * i + r, 0])
                    row = got[r].tolist()
                    check(g_id in row and out.labels[r][row.index(g_id)] == 1, f"{name}: gold id lost")
            served = np.concatenate([o.indices for o in held_out], axis=0)
            check(bool(((served >= 0) & (served < N_SERVE)).all()), f"{name}: held-out id out of range")
            direct_ids, direct_s = direct[name]
            for r, c in zip(*(served != direct_ids).nonzero()):  # only an f32 tie may swap two ids
                pos = direct_ids[r].tolist().index(served[r, c]) if served[r, c] in direct_ids[r] else None
                check(pos is not None and abs(direct_s[r, pos] - direct_s[r, c]) < 1e-5,
                      f"{name}: served ids != direct dense_search ids (row {r})")
            recall = float(sum(len(set(served[r]) & set(exact_ids[r])) for r in range(N_QUERIES)) / (N_QUERIES * TOP_K))
            top1 = float((served[:, 0] == held_src.cpu().numpy()).mean())
            results[name] = dict(recall_at_10=recall, top1_is_source=top1, stats=stats)
            log(f"serve {name}: {n_req} requests in {stats['dispatches']} dispatches; recall@10 {recall:.4f}; "
                f"top-1 = source row for {top1:.3f}; served ids == direct dense_search")
            check(top1 == 1.0, f"{name}: a held-out query lost its source row")
            if name == "flat":
                check(recall >= RECALL_FLOOR, f"flat recall@10 {recall:.4f} < floor {RECALL_FLOOR}")
                single = [{"vector": held_np[i % N_QUERIES : i % N_QUERIES + 1]} for i in range(100)]
                _, lat1 = post_all(client, single, 1)
                many = [{"vector": held_np[i % N_QUERIES : i % N_QUERIES + 1]} for i in range(320)]
                t = time.perf_counter()
                _, lat32 = post_all(client, many, 32)
                wall = time.perf_counter() - t
                results["latency"] = dict(
                    one_client_ms=dict(n=100, p50=statistics.median(lat1) * 1e3, p90=percentile(lat1, 90) * 1e3),
                    clients_32_ms=dict(n=320, p50=statistics.median(lat32) * 1e3, p95=percentile(lat32, 95) * 1e3),
                    clients_32_qps=320 / wall,
                )
                log(f"latency flat [{card}]: {json.dumps(results['latency'])}")
    torch.cuda.synchronize()
    launches = fused_mips_binned.launches  # main path ends
    binned_body_launches = dict(fused_mips_binned.body_launches)
    log(f"main path: {time.perf_counter() - t_main:.2f} s; fused_mips_binned launches {launches}, "
        f"by body {binned_body_launches}")
    check(launches > 0, "the main path never launched fused_mips_binned")
    check(binned_body_launches == {"wgmma": launches, "fma": 0},
          "the serving path's fused_mips_binned calls did not all take the tensor-core body")

    # 4b. the kernel shootout (the exact kernel's main path)
    fused_mips_binned.launches = 0
    fused_mips_binned.body_launches.update(wgmma=0, fma=0)
    fused_mips_topk.launches = 0
    fused_mips_topk.body_launches.update(wgmma=0, fma=0)  # main path starts
    t_main = time.perf_counter()
    shootout = mips_kernel_bench.main(SHOOTOUT_ARGS)
    torch.cuda.synchronize()
    shootout_launches = {"fused_mips_topk": fused_mips_topk.launches, "fused_mips_binned": fused_mips_binned.launches}
    body_launches = dict(fused_mips_topk.body_launches)
    shootout_binned_bodies = dict(fused_mips_binned.body_launches)
    log(f"main path (shootout): {time.perf_counter() - t_main:.2f} s; launches {shootout_launches}, "
        f"fused_mips_topk by body {body_launches}, fused_mips_binned by body {shootout_binned_bodies}")
    check(shootout_launches["fused_mips_topk"] > 0, "the shootout never launched fused_mips_topk")
    check(body_launches == {"wgmma": shootout_launches["fused_mips_topk"], "fma": 0},
          "the shootout's fused_mips_topk calls did not all take the tensor-core body")
    check(shootout_launches["fused_mips_binned"] > 0, "the shootout never launched fused_mips_binned")
    check(shootout_binned_bodies == {"wgmma": shootout_launches["fused_mips_binned"], "fma": 0},
          "the shootout's fused_mips_binned calls did not all take the tensor-core body")
    check(shootout["exact_kernel_recall"] >= EXACT_RECALL_FLOOR,
          f"exact kernel recall@10 {shootout['exact_kernel_recall']} < {EXACT_RECALL_FLOOR}")
    check(shootout["binned_recall"] >= BINNED_RECALL_FLOOR,
          f"binned recall@10 {shootout['binned_recall']} < {BINNED_RECALL_FLOOR}")
    check(all(math.isfinite(shootout[f"{r}_qps"]) and shootout[f"{r}_qps"] > 0
              for r in ("scan", "binned", "exact_kernel")), "a shootout route has no QPS")

    # 5. the train path (the main path of the REALM train step)
    del flat, int8, servers, encoder, ix, srv
    torch.cuda.empty_cache()
    train = train_phase(dev, card, hbm, peak_bf16, peak_f32, TRAIN)

    # 6. periodic training over the PQ codec, then the PQ coarse route
    gc.collect()
    torch.cuda.empty_cache()
    periodic = periodic_phase(dev, card, hbm, peak_int8, PERIODIC)

    # 7. result lines
    main = next(s for s in shapes if s["dtype"] == "bfloat16" and s["B"] == 64 and s["bins"] == 1024
                and s["body"] == "wgmma")
    exact_main = next(s for s in exact_shapes if s["dtype"] == "bfloat16" and s["B"] == 2048 and s["k"] == 10
                      and s["body"] == "wgmma")
    kernels = [dict(
        name="fused_mips_binned", route="cuda", source="vod_tpu_torch/csrc/fused_mips_binned.cu",
        replaces="vod_tpu/ops/mips_pallas.py:151", launches=launches, max_abs_err=max(max_err, train["train_max_abs_err"]),
        ms=main["ms"], plain_ms=main["plain_ms"], bound_ms=main["bound_ms"], bound_by=main["bound_by"],
        library_ms=main["library_ms"], shape=f"bfloat16 B=64 N={N_KERNEL} D={D} bins=1024 k={K_POOL}",
        shapes=shapes, serving=results, shootout_launches=shootout_launches["fused_mips_binned"],
        body=main["body"], body_launches=binned_body_launches, shootout_body_launches=shootout_binned_bodies,
        train_launches=train["train_launches"], train_body_launches=train["train_body_launches"],
        train_max_abs_err=train["train_max_abs_err"], train_call=train["train_call"], train_step=train["train_step"],
        coarse_launches=periodic["coarse_launches"], coarse_body_launches=periodic["coarse_body_launches"],
        coarse_shapes=periodic["coarse_shapes"], coarse_recall_at_10=periodic["coarse_recall_at_10"],
        periodic=periodic["periodic"],
        body_ms={body: {f"{s['dtype']} B={s['B']} bins={s['bins']}": s["ms"] for s in shapes if s["body"] == body}
                 for body in ("wgmma", "fma")},
    ), dict(
        name="fused_mips_topk", route="cuda", source="vod_tpu_torch/csrc/fused_mips_topk.cu",
        replaces="vod_tpu/ops/mips_pallas.py:57", launches=shootout_launches["fused_mips_topk"],
        max_abs_err=exact_err, ms=exact_main["ms"], plain_ms=exact_main["plain_ms"],
        bound_ms=exact_main["bound_ms"], bound_by=exact_main["bound_by"], library_ms=exact_main["library_ms"],
        shape=f"bfloat16 B=2048 N={N_KERNEL} D={D} k=10", shapes=exact_shapes, shootout=shootout,
        body=exact_main["body"], body_launches=body_launches, corpus_read_ms=read_ms,
        body_ms={body: {f"{s['dtype']} B={s['B']} k={s['k']}": s["ms"] for s in exact_shapes if s["body"] == body}
                 for body in ("wgmma", "fma")},
    )]
    log(json.dumps({"kernels": kernels}))
    log(mips_kernel_bench.card_name(dev))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
