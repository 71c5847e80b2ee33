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
 6. periodic training with `configs/msmarco_pq_realm.yaml` as a whole, end
    to end (its own main path: launch counts are zeroed just before
    `periodic_training` and read just after): phase 5's model widths and
    corpus cut (freed and made anew, seed 3), the yaml's dense codec exactly
    (`PERIODIC_DENSE`: 4-bit PQ-128, exhaustive ADC, int8 refine over 128 PCA
    dims, k_factor 32, train_size 1,000,000), its sparse engine
    (`PERIODIC_SPARSE`: BM25, max_postings 4096, k1 1.2, b 0.75) and its
    weight schedules (`PERIODIC_PARAMETERS`: dense linear from 0.0 over
    20,000 steps, sparse constant 1.0, through `TrainerState.parameters`),
    2 periods of 3 optimizer steps: each period re-embeds the 2^20 sections
    and rebuilds the PQ index; the BM25 index is built once before the
    first period and searched in every one. The text is synthetic, from the
    seed (`TEXT`: a Zipf vocabulary of 100,000 words, sections of 40-80
    words, queries of 4-8 words of their first gold section and 0-2 random
    ones), analyzed by the port's native analyzer as the JAX CLI does
    (vocabulary 2^18, 512 terms a section, 32 a query); the sections' token
    ids stay random. Printed: the analyzer's texts/s for sections and
    queries, the postings build and upload ms, width and bytes; per period
    re-embed ms and sections/s, build ms by stage, index bytes, ms per
    optimizer step; then peak memory. Checked: `native_available()`; finite
    losses; the logged weights (dense < 1e-3, sparse 1.0); period 1's
    embeddings differ from period 0's, and so do the codes; `[N, 64]` uint8
    codes and `[N, 128]` int8 refine rows; no kernel launch (the
    exhaustive-ADC codec runs none, in JAX either); the collate's in-loop
    `pq_search` and `sparse_search` against direct calls of the same
    queries, and one collated batch's `section__sparse` / `section__dense`
    against direct searches, normalized; recall@10 of each period's index
    (period 0's taken at its period's start, from the untrained encoder)
    against an exact f32 scan on 256 held-out queries, above
    `PERIODIC["recall_floor"]`; the share of those queries whose first gold
    id is in BM25's top 100, above `PERIODIC["bm25_recall_floor"]`;
    `sparse_search` on the card against the same call on CPU copies for 64
    queries (scores within `sparse_tol`, ids equal outside that band), then
    timed at B = 32 and 64 (CUDA events, and the host/device split); one
    more hybrid optimizer step with every synchronizing call made an error;
    a `SearchServer` over the last period's engines (PQ + BM25 + lookup, the
    yaml's weights) answering 64 held-out requests (vectors, terms, gold
    ids) at one client and at 32: every answer equal to a direct
    `hybrid_search` of the request within `serve_tol`, gold ids with label
    1, p50 and p95. Then the PQ coarse route (its own main path: counts
    zeroed before, read after) on the last period's embeddings: the `pq`
    preset (OPQ, 32 subquantizers, coarse_dim 64) and the factory default
    (coarse_dim 32), both `kernel: fused` at 512 bins, searched at B = 32
    and 64. Checked: 4 launches, all `wgmma`; each kernel call (int8, D = 32
    and 64, k = bins) equal in every cell to its plain version; then timed
    beside the plain version, `torch.topk(torch._int_mm(q, Vᵀ), k)` and the
    bound, and split into the host's time to enqueue a call and the device
    time of its kernels (`torch.profiler`);
 7a. the causal reader's generation (its own main path: counts zeroed
    before, read after; run right after phase 5, on its trained `Realm`, flat
    bf16 index and 2 validation batches of B = 32, D = 8): each batch
    collated with live retrieval, each row's reader tokens compacted to a
    right-padded prompt (up to 248 tokens), and `Realm.generate` of 16
    tokens over its 256 rows. Checked: one `fused_mips_binned` launch per
    batch, all on the tensor-core body; every token in [0, V); on 16 rows of
    different prompt lengths, each step's logits (prefill, then each decode
    step) within GENERATION["tol"] of the teacher-forced forward over prompt
    + generated tokens, and each token its argmax wherever the top-2 margin
    exceeds that; the same steps with write positions one too far read
    above that tolerance (the check can see a fault); one decode step with
    every synchronizing call made an error. Printed: `Realm.generate` ms and
    new tokens/s, prefill ms, the median decode step (CUDA events), one
    step's host enqueue beside its kernels' device time (`torch.profiler`),
    peak memory;
 7b. the seq2seq REALM of BASELINE config #5 (`SEQ2SEQ`; the retriever and
    reader of `vod_tpu_torch.examples.seq2seq_realm_bench`: hidden 384, 6
    layers, 6 heads, 1536, vocab 30,522, bf16 activations; VOD alpha 0.5),
    after phase 6: 2^20 sections of 64 random ids and an int8 index with
    kernel "fused" at 512 bins; the first step's kernel call (int8, k = 64)
    against its plain version, cell for cell, and timed beside
    `torch.topk(torch._int_mm(q, Vᵀ), k)` and the bound; then 3 warm-up and
    10 timed train steps (B = 32, D = 8, queries of 24, answers of 12,
    prefetch 64, AdamW 5e-5, clip 1.0) as one main path, then as another: 2
    batches collated, `evaluate_generation` (16 greedy tokens) and
    `realm_beam_generate` (4 beams, 16 tokens) over the first 8 queries x 8
    sections. Checked: finite losses and gradient norms, the optimizer group
    moved, one `fused_mips_binned` launch per train step and per collated
    batch, all on the tensor-core body; EM and F1 in [0, 1]; greedy
    decode-step logits within SEQ2SEQ["tol"] of the teacher-forced
    `Seq2SeqLM.forward` and tokens its argmax outside the margin, and above
    that tolerance with decode positions one too far; the beam winners'
    scores equal their recomputed mean log-probs within SEQ2SEQ["beam_tol"];
    one decode step with every synchronizing call made an error. Printed:
    median ms per step, queries/s, params, peak memory, greedy and beam ms
    and tokens/s;
 8a. IVF-PQ serving at full width (`IVFPQ_SERVE`): 2^20 x 768 unit rows
    around 4,096 seeded centres and 256 held-out queries, made on the card;
    the `ivfpq` preset (int8 refine rows at 128 PCA dims scored directly,
    nprobe 32, no codes) and `from_faiss_factory("OPQ32_512,IVFauto,PQ32x8")`
    (the ADC path), each built through `build_dense_from_config` with its
    build time by stage; the preset through `cache_dir`, then built again
    and loaded from the cache (checked: every field `torch.equal`, the same
    answers; build and load times). Checked: every cell probed with f32
    rows gives the exact top-10 wherever the margin exceeds the f32 bound;
    recall@10 at the configs' nprobe above `recall_floor` and
    `adc_recall_floor`; the card's answers equal the CPU path's on the same
    index within `cpu_tol`; `ivfpq_search` under sync-debug "error". Timed
    at B = 32 and 64 (CUDA events, and the host's enqueue beside the device
    time). A `SearchServer` over the preset answers encoded queries with
    gold lookups (phase 4's encoder) and held-out vectors: gold ids with
    label 1, served ids equal to direct `ivfpq_search` calls; p50 at one
    client and QPS at 32, beside phase 4's flat server. Autotuning:
    `autotune_after_build` on the preset (recall only; the Pareto front
    printed); then the default grid of the PQ direct serving codec
    (coarse_dim 64, int8 refine at 128 dims, no codes) swept with timing,
    its own main path (counts zeroed before the sweep, read after): its 3
    fused points launch `fused_mips_binned` at int8, D = 64, 2048 bins,
    tile 16384, 4 times each, all `wgmma`; one call is held against the
    plain version in every cell and timed beside `topk(_int_mm)` and the
    bound at B = 64 and 256;
 8b. periodic training over the preset from host slabs (`IVFPQ_PERIODIC`,
    its own main path): phase 5's model widths over 2^18 sections,
    `embed_hbm_budget_bytes` half the embeddings, `autotune_target_recall`
    0.9, 2 periods of 3 steps. Checked: every period embeds into host RAM,
    builds through `build_dense_from_host` and records `autotune`; finite
    losses and gradient norms; no kernel launch (the IVF-PQ path runs none,
    in JAX either); one more optimizer step under sync-debug "error".
    Printed: per-period re-embed, build ms by stage, autotune summary, ms
    per step, the step median and peak memory; then phase 8's wall time;
 9. the script's wall time, the `kernels` JSON line, the card line, and
    the last line `{"ok": true, "device": {...}}`.
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
# The yaml's `search_defaults.sparse` and `trainer.parameters` (the dense
# weight ramps from 0.0 over 20,000 steps, so phase 6 runs at dense ~0).
# Phase 6's text, all from the seed (no download): a vocabulary of 100,000
# distinct lowercase words of 3-10 letters, drawn by rank from a Zipf law of
# exponent 1.0; sections of 40-80 words (MS MARCO passages average about 56);
# queries of 4-8 words of their first gold section and 0-2 random words (MS
# MARCO queries average about 6). Analyzed as vod_tpu/exps/cli.py does:
# vocabulary 2^18, 512 terms a section and 32 a query, no language, no stem.
# The sections' token ids stay random: no tokenizer exists offline.
TEXT = dict(words=100_000, zipf=1.0, section_words=(40, 80), gold_words=(4, 8), random_words=(0, 2),
            vocab_size=1 << 18, section_terms=512, query_terms=32)
PERIODIC_SPARSE = dict(max_postings=4096)
PERIODIC_PARAMETERS = dict(
    dense=dict(mode="linear", start=0.0, value=1.0, period=20000), sparse=dict(mode="constant", value=1.0),
)
PERIODIC = dict(
    TRAIN, periods=2, steps=3, held_out=256, dense=PERIODIC_DENSE, coarse_batches=(32, 64),
    coarse={
        "pq-preset": dict(codec="pq", n_subquantizers=32, use_opq=True, coarse_dim=64, n_candidates=4096,
                          kernel="fused", fused_bins=512),
        "factory-default": dict(codec="pq", kernel="fused", fused_bins=512),
    },
    # Recall@10 floor of each period's index against exact f32 search of the
    # same embeddings. The random-weight encoder's embeddings lie almost on
    # one direction (mean cosine 0.994 to their mean), which 4-bit PQ in
    # 3-dim subspaces and an int8 refine over 128 of 384 PCA dims resolve
    # poorly: 0.1070 (period 0, the untrained encoder) and 0.1039 (period 1,
    # after three steps at the yaml's weights, dense ~0) on an H100 80GB HBM3
    # at 700 W (256 queries, 2,560 pairs; a binomial spread of ~0.006). Three steps at dense weight 1.0 gave 0.21-0.25 at period 1.
    # A broken codec, scan or re-rank gives ~0 (10 random ids of 2^20).
    recall_floor=0.05,
    text=TEXT, sparse=PERIODIC_SPARSE, parameters=PERIODIC_PARAMETERS, sparse_batches=(32, 64), serve=64,
    # BM25 scores on the card and on the CPU, and two calls on the card: a
    # doc's <= 32 contributions are summed by `scatter_add_` atomics in an
    # order that changes from run to run, a few ulps (3.8e-6 each below 64)
    sparse_tol=1e-5,
    # served vs direct hybrid answers: as sparse_tol, plus the PQ scan's
    # products at another batch size (weighted by the dense weight, < 1e-3)
    serve_tol=1e-4,
    # the share of held-out queries whose first gold id is in BM25's top 100:
    # 0.7812 on an H100 80GB HBM3 at 700 W (256 queries; a binomial spread
    # of ~0.026). Queries of mostly common words, and common words' postings
    # cut to the 4,096 highest impacts, lose the rest; a broken analyzer,
    # build or scorer finds ~100 / 2^20 of them
    bm25_recall_floor=0.7,
)

# Phase 7a: the causal reader's generation at phase 5's widths, from phase 5's
# trained Realm: its 2 validation micro-batches (B = 32, D = 8) collated with
# live retrieval, each row's reader tokens compacted to a right-padded prompt,
# then `Realm.generate` of 16 tokens over the 256 rows of each batch. `tol`:
# the bound on |decode-step logits - teacher-forced logits|, near exact: on an
# H100 the two paths read 0 in every run (random weights give logits of ~0.4).
GENERATION = dict(max_new_tokens=16, check_rows=16, tol=1e-3, step_reps=20)

# Phase 7b: BASELINE config #5 (bench.py's `bench_realm`: examples/seq2seq_realm_bench.py
# --corpus 1048576 --index_dtype int8): an e5-small-shaped retriever and a
# t5-small-shaped reader (`vod_tpu_torch.examples.seq2seq_realm_bench`),
# 2^20 sections of 64 random ids, queries of 24, answers of 12, B = 32, D = 8,
# prefetch 64, AdamW 5e-5 (decay 1e-4, no mask), clip 1.0. Cut: the index
# runs `kernel="fused"` at 512 bins (the JAX script leaves the scan), 3 + 10
# steps (the bench runs 50), no reindex (phase 6 holds the re-embed). Then
# greedy generation over 2 collated batches and a beam search over the first
# 8 queries x 8 sections. `tol`: the bound on |decode-step logits -
# teacher-forced logits| of the T5 reader (bf16: the two paths multiply at
# other shapes; an H100 reads 0.0119); `beam_tol`: on |beam winner's score -
# its recomputed mean log-prob| (read 0.0003, and 0.0007 on weights trained
# otherwise). Each is about three times the larger reading.
SEQ2SEQ = dict(n=1 << 20, ls=64, lq=24, b=32, d=8, bins=512, lr=5e-5, warmup=3, timed=10, gen_batches=2,
               max_new_tokens=16, num_beams=4, beam_queries=8, tol=0.035, beam_tol=2e-3)


# Phase 8a: IVF-PQ serving at full width. The corpus: 2^20 unit rows of 768
# around 4,096 seeded unit centres (MS MARCO has 8.8M passages; cut to what
# builds in seconds), each centre plus noise 0.1 in a space whose scale decays
# as exp(-i / 64) (98% of the variance in the top 128 dims, as embedding
# spectra concentrate), rotated at random. Two indexes through the factory:
# the `ivfpq` preset (configs/presets/search/ivfpq.yaml: refine rows scored
# directly) and the reference's default factory string (OPQ + IVFauto + ADC
# codes). Then the default grid of the PQ direct serving codec (coarse_dim 64,
# int8 refine at 128 PCA dims, keep_codes False), whose fused points launch
# `fused_mips_binned` at int8, 2048 bins, tile 16384.
IVFPQ_PRESET = dict(codec="ivfpq", nprobe=32, refine="int8", refine_dim=128, keep_codes=False)
IVFPQ_SERVE = dict(
    n=1 << 20, centres=4096, noise=0.1, decay=64.0, held_out=256, batches=(32, 64), preset=IVFPQ_PRESET,
    factory="OPQ32_512,IVFauto,PQ32x8", target_recall=0.9,
    pq_direct=dict(coarse_dim=64, refine="int8", refine_dim=128, keep_codes=False),
    # card vs CPU: twice the f32 sum-order bound 2 * gamma_D of unit vectors
    # (D = 768: 9.2e-5); the int8 sums are exact on both sides
    cpu_tol=2e-4,
    # recall@10 floors against exact f32 search (256 queries, 2,560 pairs; a
    # binomial spread of ~0.01): the preset read 0.9254 at nprobe 32 and the
    # faiss default 0.3660 at nprobe 8 (32 subquantizers of 24 dims each) on
    # an H100 80GB HBM3 at 700 W. A broken layout, probe list or product
    # finds ~0 (10 random ids of 2^20)
    recall_floor=0.85, adc_recall_floor=0.25,
)
# Phase 8b: periodic training over the `ivfpq` preset from host slabs at phase
# 5's model widths: 2^18 sections of 200 random ids (phase 6 holds the 2^20
# re-embed), `embed_hbm_budget_bytes` half the [N, 384] f32 embeddings, so the
# host-slab branch builds every period, and the knobs re-tuned each period
# against a recall target of 0.9; 2 periods of 3 optimizer steps.
IVFPQ_PERIODIC = dict(TRAIN, n=1 << 18, periods=2, steps=3, dense=dict(IVFPQ_PRESET, autotune_target_recall=0.9))


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


def train_phase(dev, card: str, hbm: float, peak_bf16: float, peak_f32: float, t: dict) -> tuple[dict, dict]:
    """Phase 5: the REALM train path at the sizes in `t` (module constant
    TRAIN). Returns the train-path kernel call's numbers and launches, and
    the trained system with its index, corpus, validation queries and
    generator (phase 7a's setup)."""
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
    result = dict(
        train_launches=launches, train_body_launches=body_launches, train_max_abs_err=err,
        train_call=dict(shape=f"bfloat16 B={b} N={index.n_real} D={d} bins={bins} k={k}", ms=ms, plain_ms=plain_ms,
                        library_ms=library_ms, bound_ms=bound, bound_by=bound_by),
        train_step=dict(median_ms=median_ms, step_ms=step_ms, queries_per_s=queries_per_s, peak_mem_bytes=peak_mem,
                        losses=losses, grad_norms=norms, stages_ms=stages, head_ms=head_ms, profile=profile),
    )
    # phase 7a generates from this trained system
    context = dict(model=model, step_fn=step_fn, engines=engines, corpus=corpus, queries=val_batches, generator=g)
    return result, context


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


class SyntheticText:
    """Phase 6's seeded text (module constant TEXT): every section's words as
    rank ids into a vocabulary of distinct lowercase words, drawn from a Zipf
    law, and the section texts cut from one numpy byte buffer (each word
    padded with spaces to WIDTH bytes, so a section is one slice)."""

    WIDTH = 11  # 10 letters and a space

    def __init__(self, n: int, t: dict, seed: int):
        import numpy as np

        self.t, self.rng = t, np.random.default_rng(seed)
        words: list[str] = []
        seen: set[str] = set()
        while len(words) < t["words"]:
            lens = self.rng.integers(3, 11, t["words"])
            letters = self.rng.integers(ord("a"), ord("z") + 1, (t["words"], 10), dtype=np.uint8)
            for length, row in zip(lens.tolist(), letters):
                w = row[:length].tobytes().decode()
                if w not in seen and len(words) < t["words"]:
                    seen.add(w)
                    words.append(w)
        self.words = words
        table = np.full((len(words), self.WIDTH), ord(" "), np.uint8)
        for i, w in enumerate(words):
            table[i, : len(w)] = np.frombuffer(w.encode(), np.uint8)
        p = 1.0 / np.arange(1, len(words) + 1) ** t["zipf"]
        self.cdf = np.cumsum(p) / p.sum()
        lo, hi = t["section_words"]
        self.offsets = np.concatenate([[0], np.cumsum(self.rng.integers(lo, hi + 1, n))])
        self.ids = self.draw(int(self.offsets[-1]))
        self.buf = table[self.ids].tobytes().decode("ascii")

    def draw(self, size: int):
        """`size` word ranks from the Zipf law."""
        import numpy as np

        return np.minimum(np.searchsorted(self.cdf, self.rng.random(size), side="right"), len(self.words) - 1)

    def sections(self) -> list[str]:
        w, off = self.WIDTH, self.offsets.tolist()
        return [self.buf[w * a : w * b] for a, b in zip(off[:-1], off[1:])]

    def query(self, gold: int) -> str:
        """4-8 words of section `gold` (distinct positions) and 0-2 random words."""
        import numpy as np

        (lo, hi), (rlo, rhi) = self.t["gold_words"], self.t["random_words"]
        own = self.ids[self.offsets[gold] : self.offsets[gold + 1]]
        picked = self.rng.choice(own, size=int(self.rng.integers(lo, hi + 1)), replace=False)
        extra = self.draw(int(self.rng.integers(rlo, rhi + 1)))
        return " ".join(self.words[i] for i in np.concatenate([picked, extra]).tolist())


def check_sparse_close(label: str, got, want, tol: float) -> tuple[float, int]:
    """Two BM25 results of the same queries: the same empty slots, scores
    within `tol`, and ids equal wherever the score margin to both neighbours
    exceeds it (inside that band the atomics' sum order may swap two ids).
    Returns (max score error, ids that differ inside the band)."""
    import torch

    gs, gi, ws, wi = got.scores.cpu(), got.indices.cpu(), want.scores.cpu(), want.indices.cpu()
    finite = torch.isfinite(ws)
    check(torch.equal(torch.isfinite(gs), finite), f"{label}: empty slots differ")
    err = (gs[finite] - ws[finite]).abs().max().item() if finite.any() else 0.0
    check(err <= tol, f"{label}: max score error {err:.3g} > {tol:.3g}")
    inf = torch.full((ws.shape[0], 1), float("inf"))
    after = torch.cat([ws[:, :-1] - ws[:, 1:], inf], dim=-1)
    before = torch.cat([inf, after[:, :-1]], dim=-1)
    clear = (torch.minimum(after, before) > tol) & finite
    check(torch.equal(gi[clear], wi[clear]) and torch.equal(gi[~finite], wi[~finite]), f"{label}: ids differ")
    return err, int((gi != wi).sum())


def check_collated(label: str, idx, raw, direct, tol: float) -> None:
    """One collated batch's raw engine scores (`section__<engine>`) against a
    direct search of the same queries at the prefetch width, normalized: a
    sampled id the search returned carries its score within `tol`, any other
    id NaN; only an id within `tol` of the row's last score may sit on
    either side of the cut."""
    import torch

    from vod_tpu_torch.ops.numpy_ops import normalize_scores

    ids, s, idx, raw = direct.indices.cpu(), normalize_scores(direct.scores).cpu(), idx.cpu(), raw.cpu()
    for r in range(idx.shape[0]):
        pos = {i: c for c, i in enumerate(ids[r].tolist()) if i >= 0}
        last = float(s[r][torch.isfinite(s[r])].min())
        for c, sid in enumerate(idx[r].tolist()):
            v = float(raw[r, c])
            want = float(s[r, pos[sid]]) if sid in pos else math.nan
            if sid in pos and not math.isnan(v):
                check(abs(v - want) <= tol, f"{label}: row {r} id {sid}: {v} != {want}")
            elif sid in pos:
                check(want - last <= tol, f"{label}: row {r} id {sid} retrieved, but NaN in the batch")
            else:
                check(math.isnan(v) or v - last <= tol, f"{label}: row {r} id {sid} not retrieved, but {v} in the batch")


def post_all(client, payloads: list, workers: int, top_k: int = TOP_K) -> tuple[list, list]:
    """Send every payload through `client` from `workers` threads; returns
    (answers in order, each request's latency in seconds)."""
    lat = []

    def one(p):
        t = time.perf_counter()
        out = client.search(top_k=top_k, **p)
        lat.append(time.perf_counter() - t)
        return out

    with concurrent.futures.ThreadPoolExecutor(workers) as ex:
        outs = list(ex.map(one, payloads))
    return outs, lat


def index_recall(index, vectors, queries) -> tuple[float, float]:
    """Recall@10 of `pq_search` on `index` against an exact f32 scan of the
    `vectors` it was built from, and the mean cosine of those vectors to
    their mean direction (how far they are from isotropic)."""
    import torch

    from vod_tpu_torch.search import SearchQueries, pq_search

    torch.backends.cuda.matmul.allow_tf32 = False
    exact = torch.cat([torch.topk(qs @ vectors.T, 10, dim=-1).indices for qs in queries.split(64)]).cpu()
    got = pq_search(index, SearchQueries(vector=queries), 10).indices.cpu()
    hits = sum(len(set(a.tolist()) & set(e.tolist())) for a, e in zip(got, exact))
    mean_dir = torch.nn.functional.normalize(vectors.mean(0), dim=0)
    spread = (torch.nn.functional.normalize(vectors, dim=-1) @ mean_dir).mean().item()
    return hits / exact.numel(), spread


def periodic_phase(dev, card: str, hbm: float, peak_int8: float, t: dict) -> dict:
    """Phase 6: periodic training with the configuration of
    `configs/msmarco_pq_realm.yaml` as a whole at the sizes in `t` (module
    constant PERIODIC): the PQ codec rebuilt every period, the BM25 engine
    built once before the first period from the synthetic text, the engine
    weights from the yaml's schedules; then the BM25 checks and timings, a
    `SearchServer` over the last period's engines, and the PQ coarse route
    (the `pq` preset and the factory default, both `kernel: fused`) on
    period 1's embeddings. Returns the coarse route's kernel calls and
    launches, and the periodic run's numbers."""
    import dataclasses

    import torch

    from vod_tpu_torch.configs import DenseFactoryConfig, SparseFactoryConfig
    from vod_tpu_torch.exps import PeriodicTrainingConfig, periodic_training, recipes
    from vod_tpu_torch.native import analyze_texts, native_available
    from vod_tpu_torch.ops.mips import _binned_body, fused_mips_binned, fused_mips_binned_reference
    from vod_tpu_torch.runtime import ParameterSchedule, TrainerState, adamw, make_train_step
    from vod_tpu_torch.runtime.callbacks import Callback
    from vod_tpu_torch.search import (
        HybridEngines, SearchQueries, SparseIndex, build_dense_from_config, build_sparse_from_config,
        dense as dense_module, hybrid_search, pq_search, sparse_search,
    )
    from vod_tpu_torch.search import hybrid as hybrid_module
    from vod_tpu_torch.serving import SearchHttpClient, SearchServer

    n, b, periods, steps, tx = t["n"], t["b"], t["periods"], t["steps"], t["text"]
    check(native_available(), "the port's analyzer did not build with g++: the BM25 build would run the Python loops")
    t0 = time.perf_counter()
    model, corpus, query_batch, g = realm_setup(dev, t, seed=3)
    batches = [[query_batch() for _ in range(steps * t["accum"])] for _ in range(periods)]
    held_out = [query_batch() for _ in range(-(-t["held_out"] // b))]
    torch.cuda.synchronize()
    log(f"periodic setup: Realm {sum(p.numel() for p in model.parameters()) / 1e6:.1f}M params; corpus {n} x "
        f"{t['ls']} tokens in {time.perf_counter() - t0:.2f} s")

    # the text: sections analyzed as the CLI does, then every query from its first gold section
    t0 = time.perf_counter()
    text = SyntheticText(n, tx, seed=4)
    texts = text.sections()
    text_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sec_terms, sec_counts = analyze_texts(texts, vocab_size=tx["vocab_size"], max_terms=tx["section_terms"])
    sec_analyze_s = time.perf_counter() - t0
    del texts
    every = [qb for per in batches for qb in per] + held_out
    q_texts = [text.query(gold) for gold in torch.cat([qb.section_ids[:, 0] for qb in every]).tolist()]
    t0 = time.perf_counter()
    q_terms, q_counts = analyze_texts(q_texts, vocab_size=tx["vocab_size"], max_terms=tx["query_terms"])
    q_analyze_s = time.perf_counter() - t0
    q_terms = torch.from_numpy(q_terms).to(dev).split([qb.input_ids.shape[0] for qb in every])
    with_terms = iter([dataclasses.replace(qb, terms=terms) for qb, terms in zip(every, q_terms)])
    batches = [[next(with_terms) for _ in per] for per in batches]
    held_out = list(with_terms)
    analyzer = dict(
        text_s=text_s, sections=n, section_words=int(text.offsets[-1]), section_analyze_s=sec_analyze_s,
        sections_per_s=n / sec_analyze_s, section_terms_mean=float(sec_counts.mean()), queries=len(q_texts),
        query_analyze_s=q_analyze_s, queries_per_s=len(q_texts) / q_analyze_s, query_terms_mean=float(q_counts.mean()),
    )
    del text, q_texts
    log(f"periodic text: {n} sections of {analyzer['section_words'] / n:.2f} words and {len(every) * b} queries "
        f"made in {text_s:.2f} s; analyzed [{card} host]: sections {sec_analyze_s:.4f} s = "
        f"{analyzer['sections_per_s']:.4f} texts/s ({analyzer['section_terms_mean']:.2f} terms each), queries "
        f"{q_analyze_s:.4f} s = {analyzer['queries_per_s']:.4f} texts/s "
        f"({analyzer['query_terms_mean']:.2f} terms each)")

    # the BM25 index, built once before the first period, as the JAX CLI passes it in
    sparse_cfg = SparseFactoryConfig() + t["sparse"]
    sparse_build: dict[str, float] = {}
    t0 = time.perf_counter()
    doc_terms = [sec_terms[i, :c].tolist() for i, c in enumerate(sec_counts.tolist())]  # as the JAX CLI passes them
    del sec_terms, sec_counts
    sparse_build["lists_ms"] = (time.perf_counter() - t0) * 1e3
    sparse_ix = build_sparse_from_config(sparse_cfg, doc_terms, n_terms=tx["vocab_size"], device=dev,
                                         timings=sparse_build)
    sparse_build["total_ms"] = (time.perf_counter() - t0) * 1e3
    del doc_terms
    gc.collect()
    width = int(sparse_ix.postings_docs.shape[1])
    postings_bytes = sum(x.numel() * x.element_size() for x in (sparse_ix.postings_docs, sparse_ix.postings_impacts))
    check(isinstance(sparse_ix, SparseIndex) and sparse_ix.postings_docs.shape == (tx["vocab_size"], width)
          and width <= sparse_cfg.max_postings, f"postings {tuple(sparse_ix.postings_docs.shape)}")
    log(f"periodic BM25 index [{card}]: postings {tx['vocab_size']} x {width} (max_postings "
        f"{sparse_cfg.max_postings}), {postings_bytes} bytes on the card; build "
        f"{json.dumps({k: round(v, 4) for k, v in sparse_build.items()})} ms")

    # what the run builds and retrieves, recorded for the checks after it
    builds, collate_calls, sparse_calls, sparse_periods = [], [], [], []
    real_build, real_search = recipes.build_dense_from_config, hybrid_module.pq_search
    real_sparse = hybrid_module.sparse_search

    def recording_build(cfg, vectors, **kw):
        index = real_build(cfg, vectors, **kw)
        builds.append((vectors, index))  # period 0's rows are cut to a sample once its recall is taken
        return index

    def recording_search(index, queries, top_k, **kw):
        out = real_search(index, queries, top_k, **kw)
        if len(builds) == periods and not collate_calls:  # the last period's first retrieval
            collate_calls.append((index, queries.vector.clone(), top_k, out.indices.clone(), out.scores.clone()))
        return out

    def recording_sparse(index, queries, top_k):
        out = real_sparse(index, queries, top_k)
        sparse_periods.append(len(builds) - 1)
        if len(builds) == periods and not sparse_calls:
            sparse_calls.append((queries.terms.clone(), top_k, out))
        return out

    recipes.build_dense_from_config, hybrid_module.pq_search = recording_build, recording_search
    hybrid_module.sparse_search = recording_sparse
    optimizer = adamw(model, t["lr"], weight_decay=0.0)
    step_fn = make_train_step(
        model, optimizer, prefetch=t["prefetch"], n_sections=t["n_sections"], max_pos_sections=t["max_pos"],
        temperature=1.0, with_lm=True, gradient_clip_val=1.0, accumulate_grad_batches=t["accum"],
    )
    recorder = step_recorder()
    recalls: dict[int, tuple[float, float]] = {}

    class FirstIndexRecall(Callback):
        """At the first period's start (after its build, before its steps):
        recall@10 of the period-0 index, from the untrained encoder, against
        an exact scan of its embeddings; then only a row sample is kept."""

        def on_fit_start(self, *, model, state, **kw):
            if state.pidx == 0 and 0 not in recalls:
                with torch.no_grad():
                    q0 = torch.cat([model.encode_field(qb.input_ids, qb.attention_mask) for qb in held_out])
                recalls[0] = index_recall(builds[0][1], builds[0][0], q0[: t["held_out"]])
                builds[0] = (builds[0][0][:4096].clone(), builds[0][1])

    schedules = {name: ParameterSchedule(**kw) for name, kw in t["parameters"].items()}
    state = TrainerState(max_steps=periods * steps, period=steps, parameters=schedules)
    config = PeriodicTrainingConfig(dense=DenseFactoryConfig(**t["dense"]), log_interval=steps)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    fused_mips_binned.launches = 0
    fused_mips_binned.body_launches.update(wgmma=0, fma=0)  # main path starts
    t_main = time.perf_counter()
    try:
        state, history = periodic_training(
            step_fn=step_fn, corpus=corpus, state=state, train_queries_fn=lambda p: batches[p], generator=g,
            sparse_engine=sparse_ix, config=config, callbacks=[recorder, FirstIndexRecall()],
        )
    finally:
        recipes.build_dense_from_config, hybrid_module.pq_search = real_build, real_search
        hybrid_module.sparse_search = real_sparse
    torch.cuda.synchronize()
    periodic_launches = dict(fused_mips_binned.body_launches)  # main path ends
    wall = time.perf_counter() - t_main
    peak_mem = torch.cuda.max_memory_allocated(dev)

    check(state.step == periods * steps and len(history) == periods and len(builds) == periods,
          f"periodic run: {state.step} steps, {len(history)} periods, {len(builds)} builds")
    losses = [float(m["loss"]) for m in recorder.metrics]
    check(len(losses) == periods * steps and all(math.isfinite(x) for x in losses), f"periodic losses {losses}")
    logged = {k: v for k, v in history[-1]["train"].items() if k.startswith("parameters/")}
    check(logged.get("parameters/dense", 1.0) < 1e-3 and logged.get("parameters/sparse") == 1.0,
          f"the yaml's schedules were not followed: {logged}")
    step_ms = [s.elapsed_time(e) for s, e in recorder.events]
    # the codec of this path (exhaustive ADC) runs no Pallas kernel in JAX and no CUDA kernel here
    check(periodic_launches == {"wgmma": 0, "fma": 0}, f"the exhaustive-ADC path launched {periodic_launches}")
    check(sparse_periods == sorted(list(range(periods)) * (steps * t["accum"])),
          f"the BM25 index was not searched once a micro-batch in every period: {sparse_periods}")
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
        emb_ms, period_steps = h["reembed_s"] * 1e3, [round(x, 4) for x in step_ms[p * steps:(p + 1) * steps]]
        log(f"periodic period {p} [{card}]: re-embed {emb_ms:.4f} ms ({n / h['reembed_s']:.4f} sections/s); build "
            f"{json.dumps({k: round(v, 4) for k, v in h['build_ms'].items()})} ms; index {h['index_bytes']} bytes; "
            f"ms per optimizer step (dense + BM25) {json.dumps(period_steps)}; loss "
            f"{h['train'].get('loss', float('nan')):.6f}; weights {json.dumps(logged if p == periods - 1 else None)}")
    log(f"periodic run: {periods} periods of {steps} optimizer steps in {wall:.2f} s; peak memory "
        f"{peak_mem / 2**30:.4f} GiB; fused_mips_binned launches {periodic_launches}")

    # the collate's retrievals against direct searches of the same queries
    ix, qv, top_k, ids, scores = collate_calls[0]
    direct = pq_search(ix, SearchQueries(vector=qv), top_k)
    check(torch.equal(direct.indices, ids), "a direct pq_search does not return the ids the collate retrieved")
    check(torch.equal(direct.scores, scores), "a direct pq_search does not return the collate's scores")
    terms, top_k, in_loop = sparse_calls[0]
    sparse_tol = t["sparse_tol"]
    direct_sparse = sparse_search(sparse_ix, SearchQueries(terms=terms), top_k)
    check_sparse_close("the collate's sparse_search vs a direct one", direct_sparse, in_loop, sparse_tol)
    engines = HybridEngines(dense=index1, sparse=sparse_ix)
    weights = state.get_parameters()
    qb = held_out[0]
    batch = step_fn.collate(engines, corpus, qb, g, weights)
    with torch.no_grad():
        qv = model.encode_field(qb.input_ids, qb.attention_mask)
    check_collated("section__sparse", batch.section__idx, batch.section__sparse,
                   sparse_search(sparse_ix, SearchQueries(terms=qb.terms), t["prefetch"]), sparse_tol)
    check_collated("section__dense", batch.section__idx, batch.section__dense,
                   pq_search(index1, SearchQueries(vector=qv), t["prefetch"]), sparse_tol)
    check(bool(torch.isfinite(batch.section__sparse).any()), "no sampled section carries a BM25 score")
    del batch
    log("periodic collate: the in-loop pq_search and sparse_search equal direct calls; one collated batch's "
        "section__sparse and section__dense equal direct searches, normalized")

    # recall@10 of each period's index against an exact f32 scan of the same embeddings
    with torch.no_grad():
        q_held = torch.cat([model.encode_field(qb.input_ids, qb.attention_mask) for qb in held_out])[: t["held_out"]]
    recalls[periods - 1] = index_recall(index1, emb1, q_held)
    exact = torch.cat([torch.topk(qs @ emb1.T, 10, dim=-1).indices for qs in q_held.split(64)])

    def recall(ids_) -> float:
        ref = exact[: len(ids_)].cpu()
        return sum(len(set(a.tolist()) & set(e.tolist())) for a, e in zip(ids_.cpu(), ref)) / ref.numel()

    (recall0, spread0), (recall10, spread1) = recalls[0], recalls[periods - 1]
    log(f"periodic recall@10 vs exact f32 search, {len(q_held)} held-out queries (floor {t['recall_floor']}): "
        f"period 0's index (untrained encoder) {recall0:.4f}, period {periods - 1}'s {recall10:.4f}; mean cosine "
        f"of the embeddings to their mean direction {spread0:.4f} and {spread1:.4f}")
    for p, r in recalls.items():
        check(r[0] >= t["recall_floor"], f"period {p}'s recall@10 {r[0]:.4f} < floor {t['recall_floor']}")

    # BM25 alone: recall of the first gold id, the card against the CPU, times
    held_terms = torch.cat([qb.terms for qb in held_out])[: t["held_out"]]
    held_gold = torch.cat([qb.section_ids for qb in held_out])[: t["held_out"]]
    top100 = sparse_search(sparse_ix, SearchQueries(terms=held_terms), 100).indices
    bm25_recall = (top100 == held_gold[:, :1]).any(-1).float().mean().item()
    log(f"periodic BM25 recall: the first gold id in BM25's top 100 for {bm25_recall:.4f} of {len(held_terms)} "
        f"held-out queries (floor {t['bm25_recall_floor']})")
    check(bm25_recall >= t["bm25_recall_floor"], f"BM25 recall@100 {bm25_recall:.4f} < floor {t['bm25_recall_floor']}")
    cpu_ix = SparseIndex(sparse_ix.postings_docs.cpu(), sparse_ix.postings_impacts.cpu(), n_docs=sparse_ix.n_docs)
    q64 = held_terms[:64]
    sparse_err, sparse_swaps = check_sparse_close(
        "sparse_search card vs CPU", sparse_search(sparse_ix, SearchQueries(terms=q64), 100),
        sparse_search(cpu_ix, SearchQueries(terms=q64.cpu()), 100), sparse_tol,
    )
    del cpu_ix
    gc.collect()
    log(f"check sparse_search card vs CPU, 64 queries, k=100: max |card - CPU| = {sparse_err:.3g} (tol {sparse_tol}), "
        f"{sparse_swaps} ids swapped inside the band")
    sparse_times = {}
    for bq in t["sparse_batches"]:
        sq = SearchQueries(terms=held_terms[:bq])
        ms = time_ms(lambda: sparse_search(sparse_ix, sq, t["prefetch"]), 20)
        host_ms, device_ms, by_kernel = host_and_device_ms(lambda: sparse_search(sparse_ix, sq, t["prefetch"]), 20)
        top = dict(sorted(by_kernel.items(), key=lambda kv: -kv[1])[:5])
        sparse_times[bq] = dict(ms=ms, host_ms=host_ms, device_ms=device_ms, top_kernels_ms=top)
        log(f"time sparse_search B={bq} L={tx['query_terms']} P={width} k={t['prefetch']} [{card}]: {ms:.4f} ms "
            f"(CUDA events); host enqueue {host_ms:.4f} ms, device {device_ms:.4f} ms (profiler); top kernels "
            f"{json.dumps({k: round(v, 4) for k, v in top.items()})}")

    # one more hybrid optimizer step, with any synchronizing call made an error
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        step_fn.train_step_accum(engines, corpus, batches[-1][: t["accum"]], g, weights)
        enqueue_ms = (time.perf_counter() - t0) * 1e3
    except RuntimeError as exc:
        fail(f"the hybrid train step waits for the card: {exc}")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    finish_ms = (time.perf_counter() - t0) * 1e3
    log(f"hybrid train step without a sync [{card}]: the host enqueued one optimizer step (PQ + BM25) in "
        f"{enqueue_ms:.4f} ms; the card finished it {finish_ms:.4f} ms after the start")

    # a SearchServer over the last period's engines: held-out vectors, terms and gold lookups
    n_req = t["serve"]
    vec, terms_np, gold_np = (x[:n_req].cpu().numpy() for x in (q_held, held_terms, held_gold))
    payloads = [{"vector": vec[i : i + 1], "terms": terms_np[i : i + 1], "section_ids": gold_np[i : i + 1]}
                for i in range(n_req)]
    direct = []
    for i in range(n_req):
        sq = SearchQueries(vector=q_held[i : i + 1], terms=held_terms[i : i + 1], section_ids=held_gold[i : i + 1])
        m, _ = hybrid_search(engines, sq, TOP_K, weights)
        direct.append(m)
    serve_err = 0.0
    with SearchServer(engines, weights=weights, batch_window_ms=2, max_batch=64, device=dev) as srv:
        srv.warmup(payloads[0], top_k=TOP_K)
        client = SearchHttpClient(srv.url)
        one, lat1 = post_all(client, payloads, 1)
        many, lat32 = post_all(client, payloads * 5, 32)
    for i, out in enumerate(one + many):
        want = direct[i % n_req]
        err, _ = check_sparse_close(f"served request {i % n_req}", want.replace(
            scores=torch.from_numpy(out.scores), indices=torch.from_numpy(out.indices)), want, t["serve_tol"])
        serve_err = max(serve_err, err)
        row = out.indices[0].tolist()
        for gid in gold_np[i % n_req]:
            check(gid in row and out.labels[0][row.index(gid)] == 1, f"served request {i % n_req}: gold id {gid} lost")
    serving = dict(
        requests=n_req, max_abs_err=serve_err,
        one_client_ms=dict(n=len(lat1), p50=statistics.median(lat1) * 1e3, p95=percentile(lat1, 95) * 1e3),
        clients_32_ms=dict(n=len(lat32), p50=statistics.median(lat32) * 1e3, p95=percentile(lat32, 95) * 1e3),
    )
    log(f"serve PQ + BM25 + lookup [{card}]: every answer equals a direct hybrid_search (max score diff "
        f"{serve_err:.3g}, tol {t['serve_tol']}); gold ids with label 1; latency {json.dumps(serving)}")
    sparse = dict(
        analyzer=analyzer, build_ms=sparse_build, postings_width=width, postings_bytes=postings_bytes,
        bm25_recall_at_100=bm25_recall, card_vs_cpu_max_abs_err=sparse_err, card_vs_cpu_swaps=sparse_swaps,
        search=sparse_times, step_ms_median=statistics.median(step_ms), weights=logged,
        no_sync_step=dict(enqueue_ms=enqueue_ms, finish_ms=finish_ms), serving=serving,
    )
    log(f"periodic sparse summary [{card}]: {json.dumps(sparse)}")
    del builds, index0, emb0, collate_calls, sparse_calls, ix, direct, optimizer, step_fn, model, corpus, batches
    del engines, sparse_ix, in_loop, direct_sparse
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
            recall_at_10_period_0=recall0, mean_cosine_to_mean=[spread0, spread1],
            launches=periodic_launches, sparse=sparse,
        ),
    )


def compact_prompts(batch):
    """`batch` with each row's valid reader tokens moved to its front, in
    order: the collate concatenates padded [context; question; answer]
    segments, and the causal reader continues a right-padded prompt after its
    valid prefix (`lm_generate`)."""
    import dataclasses

    import torch

    order = torch.argsort((batch.lm__attention_mask == 0).to(torch.int32), dim=-1, stable=True)
    take = lambda x: torch.gather(x, -1, order)
    mask = take(batch.lm__attention_mask)
    return dataclasses.replace(batch, lm__input_ids=take(batch.lm__input_ids) * mask, lm__attention_mask=mask,
                               lm__token_type_ids=take(batch.lm__token_type_ids))


def check_against_forced(label: str, steps, forced, toks, live, tol: float) -> tuple[float, int]:
    """Decode-step logits `steps` [R, T, V] within `tol` of the teacher-forced
    logits `forced` (same shape), and each live token of `toks` [R, T] the
    argmax of `forced` wherever its top-2 margin exceeds `tol`. Returns (max
    error, tokens compared)."""
    err = (steps - forced).abs().max().item()
    check(err <= tol, f"{label}: max |decode step - teacher-forced| logits {err:.4g} > {tol}")
    top2 = forced.topk(2, dim=-1)
    clear = ((top2.values[..., 0] - top2.values[..., 1]) > tol) & live
    bad = (toks.long() != top2.indices[..., 0]) & clear
    check(not bad.any().item(), f"{label}: {int(bad.sum())} tokens differ from the teacher-forced argmax")
    return err, int(clear.sum())


def causal_generation_phase(dev, card: str, t: dict, *, model, step_fn, engines, corpus, queries, generator) -> dict:
    """Phase 7a: the causal reader's generation (module constant GENERATION)
    on phase 5's trained `Realm`, its index and its validation queries. Main
    path (counts zeroed before, read after): each batch collated with live
    retrieval (one `fused_mips_binned` call), its reader tokens compacted,
    `Realm.generate` over every row. Then, on the first batch: prefill and
    each decode step timed, the steps' logits held against the teacher-forced
    forward on rows of different prompt lengths, one step under sync-debug
    "error", and one step's host enqueue beside its device time."""
    import torch

    from vod_tpu_torch.ops.mips import fused_mips_binned

    n_new, vocab, lm = t["max_new_tokens"], model.lm_cfg.vocab_size, model.lm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    fused_mips_binned.launches = 0
    fused_mips_binned.body_launches.update(wgmma=0, fma=0)  # main path starts
    t0 = time.perf_counter()
    batches, tokens = [], []
    for q in queries:
        batches.append(compact_prompts(step_fn.collate(engines, corpus, q, generator, {"dense": 1.0})))
        tokens.append(model(batches[-1], mode="generate", max_new_tokens=n_new))
    torch.cuda.synchronize()
    launches, body_launches = fused_mips_binned.launches, dict(fused_mips_binned.body_launches)  # main path ends
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    check(body_launches == {"wgmma": len(queries), "fma": 0} and launches == len(queries),
          f"7a: fused_mips_binned launches {launches}, by body {body_launches}; want one wgmma launch a batch")
    for batch, toks in zip(batches, tokens):
        rows = batch.lm__input_ids.shape[0] * batch.lm__input_ids.shape[1]
        check(tuple(toks.shape) == (rows, n_new) and toks.dtype == torch.int32, f"7a: tokens {tuple(toks.shape)}")
        check(((toks >= 0) & (toks < vocab)).all().item(), "7a: a generated token lies outside [0, V)")

    batch, toks = batches[0], tokens[0]
    ids = batch.lm__input_ids.reshape(-1, batch.lm__input_ids.shape[-1])
    mask = batch.lm__attention_mask.reshape(ids.shape)
    n, length = ids.shape
    lengths = mask.sum(-1)
    first_row_of: dict = {}
    for r, size in enumerate(lengths.tolist()):
        first_row_of.setdefault(size, r)
    check(len(first_row_of) >= t["check_rows"], f"7a: only {len(first_row_of)} distinct prompt lengths")
    rows = torch.tensor(sorted(first_row_of.values())[: t["check_rows"]], device=dev)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(n_new + 3)]
    with torch.no_grad():
        ev[0].record()
        model(batch, mode="generate", max_new_tokens=n_new)
        ev[1].record()
        logits, cache = lm.prefill(ids, mask, length + n_new, last_only=True)
        ev[2].record()
        steps = [logits[rows, 0]]
        for i in range(n_new - 1):
            logits, cache = lm.decode_step(toks[:, i], cache)
            ev[i + 3].record()
            steps.append(logits[rows])
        torch.cuda.synchronize()
        generate_ms, prefill_ms = ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])
        step_ms = [ev[i + 2].elapsed_time(ev[i + 3]) for i in range(n_new - 1)]
        # the teacher-forced forward over each checked row's prompt + its generated tokens
        rl = lengths[rows]
        r_idx = torch.arange(len(rows), device=dev)[:, None]
        at = rl[:, None] + torch.arange(n_new, device=dev)[None]
        full = torch.zeros((len(rows), length + n_new), dtype=ids.dtype, device=dev)
        full[:, :length] = ids[rows]
        full[r_idx, at] = toks[rows].to(ids.dtype)
        full_mask = (torch.arange(length + n_new, device=dev)[None] < (rl + n_new)[:, None]).to(torch.int32)
        forced = lm(full, full_mask)[r_idx, at - 1]
        err, compared = check_against_forced("7a causal reader", torch.stack(steps, dim=1), forced, toks[rows],
                                             torch.ones_like(toks[rows], dtype=torch.bool), t["tol"])
        # the check's control: the same steps with each row's write position one too far (K/V, mask and
        # position embedding at pos + 1) must read above `tol`
        _, cache_off = lm.prefill(ids, mask, length + n_new + 1, last_only=True)
        cache_off["pos"] = cache_off["pos"] + 1
        off = [steps[0]]
        for i in range(n_new - 1):
            logits, cache_off = lm.decode_step(toks[:, i], cache_off)
            off.append(logits[rows])
        fault_err = (torch.stack(off, dim=1) - forced).abs().max().item()
        check(fault_err > t["tol"], f"7a: write positions off by one read {fault_err:.4g}, within tol {t['tol']}")
        del forced, full, cache_off, off
        # one decode step never waits for the card; then its host enqueue beside its device time
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            lm.decode_step(toks[:, -1], cache)
        except RuntimeError as exc:
            fail(f"7a: a decode step waits for the card: {exc}")
        finally:
            torch.cuda.set_sync_debug_mode("default")
        enqueue_ms, device_ms, by_name = host_and_device_ms(lambda: lm.decode_step(toks[:, -1], cache), t["step_reps"])
    median_step = statistics.median(step_ms)
    out = dict(
        launches=launches, body_launches=body_launches, batches=len(queries), rows=n, prompt_tokens=length,
        max_new_tokens=n_new, main_path_s=wall, generate_ms=generate_ms, new_tokens_per_s=n * n_new / generate_ms * 1e3,
        prefill_ms=prefill_ms, decode_step_ms=dict(median=median_step, min=min(step_ms), max=max(step_ms)),
        step_enqueue_ms=enqueue_ms, step_device_ms=device_ms,
        step_top_kernels_ms={k: round(v, 4) for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]},
        peak_mem_bytes=peak, max_logit_err=err, tol=t["tol"], rows_checked=len(rows), tokens_compared=compared,
        fault_logit_err=fault_err,
    )
    log(f"7a causal generation [{card}]: {len(queries)} batches x {n} rows (prompts of up to {length} tokens, "
        f"{len(first_row_of)} distinct lengths) in {wall:.2f} s; fused_mips_binned launches {launches}, by body "
        f"{body_launches}; Realm.generate of {n_new} tokens {generate_ms:.4f} ms = {out['new_tokens_per_s']:.1f} "
        f"new tokens/s; prefill {prefill_ms:.4f} ms; decode step median {median_step:.4f} ms (min {min(step_ms):.4f}, "
        f"max {max(step_ms):.4f}); one step enqueued in {enqueue_ms:.4f} ms on the host against {device_ms:.4f} ms "
        f"of kernels; peak {peak / 2**30:.4f} GiB")
    log(f"7a checks: decode-step logits within {err:.4g} of the teacher-forced forward (tol {t['tol']}) on "
        f"{len(rows)} rows of different prompt lengths; {compared} tokens clear of the margin, all equal to its "
        f"argmax; write positions off by one read {fault_err:.4g}; a decode step made no synchronizing call; "
        f"top kernels of a step: "
        f"{json.dumps(out['step_top_kernels_ms'])}")
    return out


def seq2seq_phase(dev, card: str, hbm: float, peak_int8: float, t: dict) -> dict:
    """Phase 7b: the seq2seq REALM of BASELINE config #5 at the sizes in `t`
    (module constant SEQ2SEQ). Main path of the train step (counts zeroed
    before, read after): warm-up and timed optimizer steps on an int8 fused
    index. Main path of generation (counts zeroed again): collate the
    generation batches, `evaluate_generation`, and `realm_beam_generate`
    over the first queries. Then greedy decoding held against the
    teacher-forced reader, the beam winner's score recomputed, one decode
    step under sync-debug "error", and greedy and beam timed. Before the
    train path, the kernel call of its first step (int8, B = 32, D = 384,
    512 bins, k = 64) is held cell for cell against the plain version and
    timed beside the library call and the bound."""
    import dataclasses

    import torch

    from vod_tpu_torch.examples import seq2seq_realm_bench as config5
    from vod_tpu_torch.models import realm_beam_generate, realm_generate
    from vod_tpu_torch.models.seq2seq import _reader_inputs
    from vod_tpu_torch.ops.mips import _binned_body, fused_mips_binned, fused_mips_binned_reference
    from vod_tpu_torch.runtime import adamw, evaluate_generation, make_train_step
    from vod_tpu_torch.search import HybridEngines, build_dense_index
    from vod_tpu_torch.search.dense import quantize_queries_int8

    n, b, d, n_new, eos = t["n"], t["b"], t["d"], t["max_new_tokens"], 1
    t0 = time.perf_counter()
    model = config5.make_model(dev, torch.Generator(device=dev).manual_seed(5))
    n_params = sum(p.numel() for p in model.parameters())
    corpus = config5.make_corpus(n, t["ls"], dev)
    index = build_dense_index(config5.make_embeddings(n, dev), dtype="int8", kernel="fused", device=dev)
    check(index.fused_bins == t["bins"] and index.vectors.dtype == torch.int8, "7b: not an int8 index at 512 bins")
    engines = HybridEngines(dense=index)
    optimizer = adamw(model, t["lr"], weight_decay=1e-4, mask=False)  # optax.adamw(5e-5)
    step_fn = make_train_step(model, optimizer, n_sections=d, **config5.STEP)
    g = torch.Generator(device=dev).manual_seed(6)
    steps = t["warmup"] + t["timed"]
    train_q = [config5.make_queries(2 + i, n, b, t["lq"], dev) for i in range(steps)]
    gen_q = [config5.make_queries(1000 + i, n, b, t["lq"], dev) for i in range(t["gen_batches"])]
    start = [[p.detach().clone() for p in grp["params"]] for grp in optimizer.param_groups]
    torch.cuda.synchronize()
    log(f"7b setup: Seq2SeqRealm {n_params / 1e6:.1f}M params; corpus {n} x {t['ls']} tokens and an int8 "
        f"{index.vectors.shape[0]} x {index.vectors.shape[1]} index (kernel fused, {index.fused_bins} bins) in "
        f"{time.perf_counter() - t0:.2f} s")

    # one train-path kernel call (the first step's queries, encoded and quantized as the int8 index does) against
    # its plain version: int8 sums are exact, so every cell must be equal
    with torch.no_grad():
        q_f = model.encode_field(train_q[0].input_ids, train_q[0].attention_mask)
    qq, _ = quantize_queries_int8(q_f, index.scale)
    vv, bins, dim = index.vectors, t["bins"], int(index.vectors.shape[1])
    k = min(config5.STEP["prefetch"], bins)  # dense_search's k at top_k = prefetch
    kw = dict(k=k, bins=bins, n_real=index.n_real)
    check(_binned_body(vv.dtype, dim, bins, (vv.data_ptr(), qq.data_ptr())) == "wgmma", "7b: the call is off wgmma")
    before = fused_mips_binned.body_launches["wgmma"]
    ks, ki = fused_mips_binned(vv, qq, **kw)
    check(fused_mips_binned.body_launches["wgmma"] == before + 1, "7b: the train-path call did not launch on wgmma")
    rs, ri = fused_mips_binned_reference(vv, qq, **kw)
    check(torch.equal(ks, rs) and torch.equal(ki, ri), f"7b train-path int8 B={b} D={dim}: kernel != plain")
    check(bool((ki >= 0).all()) and ki.max().item() < index.n_real, "7b train-path int8: an empty slot or masked row")
    err = (ks.double() - rs.double()).abs().max().item()
    ms = time_ms(lambda: fused_mips_binned(vv, qq, **kw), 20)
    plain_ms = time_ms(lambda: fused_mips_binned_reference(vv, qq, **kw), 2)
    library_ms = time_ms(lambda: torch.topk(torch._int_mm(qq, vv[: index.n_real].T), k, dim=-1), 20)
    nbytes = (index.n_real + b) * dim + b * k * 8
    ops = 2 * b * index.n_real * dim
    bound = max(nbytes / hbm, ops / peak_int8) * 1e3
    bound_by = "bytes" if nbytes / hbm >= ops / peak_int8 else "operations"
    call = dict(shape=f"int8 B={b} N={index.n_real} D={dim} bins={bins} k={k}", max_abs_err=err, ms=ms,
                plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound, bound_by=bound_by)
    del q_f, qq, ks, ki, rs, ri
    log(f"check 7b train-path binned int8 B={b} D={dim} bins={bins} k={k} (wgmma): all cells equal (max |kernel - "
        f"plain| = {err:.3g}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library {library_ms:.4f} ms, bound "
        f"{bound:.4f} ms ({bound_by}) [{card}]")

    torch.cuda.reset_peak_memory_stats(dev)
    fused_mips_binned.launches = 0
    fused_mips_binned.body_launches.update(wgmma=0, fma=0)  # main path (train) starts
    events, metrics, per_step = [], [], []
    t0 = time.perf_counter()
    for q in train_q:
        before = dict(fused_mips_binned.body_launches)
        events.append([torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)])
        events[-1][0].record()
        m, _, _ = step_fn.train_step(engines, corpus, q, g, {"dense": 1.0})
        events[-1][1].record()
        metrics.append(m)
        per_step.append({k: v - before[k] for k, v in fused_mips_binned.body_launches.items()})
    torch.cuda.synchronize()
    train_launches, train_body = fused_mips_binned.launches, dict(fused_mips_binned.body_launches)  # ends
    train_wall = time.perf_counter() - t0
    train_peak = torch.cuda.max_memory_allocated(dev)
    losses = [float(m["loss"]) for m in metrics]
    norms = [float(m["grad_norm"]) for m in metrics]
    check(all(math.isfinite(x) for x in losses + norms), f"7b: a loss or gradient norm is not finite: {losses} {norms}")
    check(all(x == {"wgmma": 1, "fma": 0} for x in per_step), f"7b: launches per step {per_step}")
    check(train_launches == steps and train_body == {"wgmma": steps, "fma": 0},
          f"7b: train path launches {train_launches}, by body {train_body}")
    for grp, before in zip(optimizer.param_groups, start):
        check(any(not torch.equal(p, p0) for p, p0 in zip(grp["params"], before)),
              f"7b: group {grp['name']} never moved")
    del start
    step_ms = [s.elapsed_time(e) for s, e in events]
    median_ms = statistics.median(step_ms[t["warmup"]:])
    log(f"7b train [{card}]: {steps} steps ({t['warmup']} warm-up) in {train_wall:.2f} s; median {median_ms:.4f} ms "
        f"per step over {t['timed']} (min {min(step_ms[t['warmup']:]):.4f}, max {max(step_ms[t['warmup']:]):.4f}); "
        f"{b / median_ms * 1e3:.4f} queries/s; peak {train_peak / 2**30:.4f} GiB; fused_mips_binned launches "
        f"{train_launches}, by body {train_body}; losses {json.dumps([round(x, 6) for x in losses])}")

    optimizer.zero_grad(set_to_none=True)
    torch.cuda.reset_peak_memory_stats(dev)
    fused_mips_binned.launches = 0
    fused_mips_binned.body_launches.update(wgmma=0, fma=0)  # main path (generation) starts
    t0 = time.perf_counter()
    batches = [step_fn.collate(engines, corpus, q, g, {"dense": 1.0}) for q in gen_q]
    gen_metrics = evaluate_generation(model, batches, max_new_tokens=n_new, eos_id=eos)
    bq = t["beam_queries"]
    beam_batch = dataclasses.replace(batches[0], **{f"lm__{k}": getattr(batches[0], f"lm__{k}")[:bq]
                                                    for k in ("input_ids", "attention_mask", "token_type_ids")})
    beam_toks, beam_scores = realm_beam_generate(model, beam_batch, num_beams=t["num_beams"], max_new_tokens=n_new,
                                                 eos_id=eos)
    torch.cuda.synchronize()
    gen_launches, gen_body = fused_mips_binned.launches, dict(fused_mips_binned.body_launches)  # ends
    gen_wall = time.perf_counter() - t0
    gen_peak = torch.cuda.max_memory_allocated(dev)
    check(gen_launches == len(gen_q) and gen_body == {"wgmma": len(gen_q), "fma": 0},
          f"7b: generation path launches {gen_launches}, by body {gen_body}")
    check(all(0.0 <= v <= 1.0 for v in gen_metrics.values()) and len(gen_metrics) == 2, f"7b: metrics {gen_metrics}")
    check(tuple(beam_toks.shape) == (bq * d, n_new) and bool(torch.isfinite(beam_scores).all()), "7b: beam output")

    # greedy decoding against the teacher-forced reader; the beam winner's score recomputed
    reader = model.reader
    enc_ids, enc_mask = _reader_inputs(batches[0])
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    with torch.no_grad():
        ev[0].record()
        toks = realm_generate(model, batches[0], max_new_tokens=n_new, eos_id=eos)
        ev[1].record()
        realm_beam_generate(model, beam_batch, num_beams=t["num_beams"], max_new_tokens=n_new, eos_id=eos)
        ev[2].record()
        torch.cuda.synchronize()
        greedy_ms, beam_ms = ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])
        cache = reader.init_cache(reader.encode(enc_ids, enc_mask), n_new)
        prev = torch.zeros_like(toks[:, 0])
        steps_logits = []
        for i in range(n_new):
            logits, cache = reader.decode_step(prev, i, enc_mask, cache)
            steps_logits.append(logits)
            prev = toks[:, i]
        dec_in = torch.cat([torch.zeros_like(toks[:, :1]), toks[:, :-1]], dim=1)
        forced = reader(enc_ids, enc_mask, dec_in, torch.ones_like(dec_in))
        hit = (toks == eos).to(torch.int32)
        live = (torch.cumsum(hit, dim=1) - hit) == 0  # up to and including each row's first EOS
        err, compared = check_against_forced("7b greedy", torch.stack(steps_logits, dim=1), forced, toks, live,
                                             t["tol"])
        # the check's control: the same steps one position too far (the self-attention slot and the
        # relative-bias row of pos + 1; slot 0 left unwritten) must read above `tol`
        cache_off = reader.init_cache(reader.encode(enc_ids, enc_mask), n_new + 1)
        tok, off = torch.zeros_like(toks[:, 0]), []
        for i in range(n_new):
            logits, cache_off = reader.decode_step(tok, i + 1, enc_mask, cache_off)
            off.append(logits)
            tok = toks[:, i]
        fault_err = (torch.stack(off, dim=1) - forced).abs().max().item()
        check(fault_err > t["tol"], f"7b: decode positions off by one read {fault_err:.4g}, within tol {t['tol']}")
        del forced, steps_logits, cache_off, off
        b_ids, b_mask = _reader_inputs(beam_batch)
        b_dec = torch.cat([torch.zeros_like(beam_toks[:, :1]), beam_toks[:, :-1]], dim=1)
        logp = torch.log_softmax(reader(b_ids, b_mask, b_dec, torch.ones_like(b_dec)), dim=-1)
        tok_logp = torch.gather(logp, -1, beam_toks.long()[..., None])[..., 0]
        b_hit = beam_toks == eos
        b_len = torch.where(b_hit.any(-1), b_hit.to(torch.int32).argmax(-1) + 1, n_new)
        valid = torch.arange(n_new, device=dev)[None] < b_len[:, None]
        recomputed = (tok_logp * valid).sum(-1) / b_len.to(torch.float32)  # length_penalty 1.0
        beam_err = (recomputed - beam_scores).abs().max().item()
        check(beam_err <= t["beam_tol"],
              f"7b: beam winners' scores differ from their recomputed log-probs by {beam_err:.4g}")
        del logp
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            reader.decode_step(prev, n_new - 1, enc_mask, cache)
        except RuntimeError as exc:
            fail(f"7b: a decode step waits for the card: {exc}")
        finally:
            torch.cuda.set_sync_debug_mode("default")
    rows = enc_ids.shape[0]
    out = dict(
        launches=dict(train=train_launches, generation=gen_launches),
        body_launches=dict(train=train_body, generation=gen_body),
        params_m=n_params / 1e6, median_step_ms=median_ms, step_ms=step_ms, queries_per_s=b / median_ms * 1e3,
        losses=losses, grad_norms=norms, train_peak_mem_bytes=train_peak, generation_peak_mem_bytes=gen_peak,
        generation_metrics=gen_metrics, generation_path_s=gen_wall,
        greedy=dict(rows=rows, ms=greedy_ms, new_tokens_per_s=rows * n_new / greedy_ms * 1e3, max_logit_err=err,
                    tokens_compared=compared, fault_logit_err=fault_err),
        beam=dict(rows=bq * d, beams=t["num_beams"], ms=beam_ms, new_tokens_per_s=bq * d * n_new / beam_ms * 1e3,
                  score_err=beam_err),
        tol=t["tol"], beam_tol=t["beam_tol"], train_call=call,
    )
    log(f"7b generation [{card}]: {len(gen_q)} batches collated + evaluate_generation + beam search in "
        f"{gen_wall:.2f} s; fused_mips_binned launches {gen_launches}, by body {gen_body}; {json.dumps(gen_metrics)}; "
        f"greedy {rows} rows x {n_new} tokens {greedy_ms:.4f} ms = {out['greedy']['new_tokens_per_s']:.1f} tokens/s; "
        f"beam ({t['num_beams']} beams) {bq * d} rows {beam_ms:.4f} ms = {out['beam']['new_tokens_per_s']:.1f} "
        f"tokens/s; peak {gen_peak / 2**30:.4f} GiB")
    log(f"7b checks: greedy decode-step logits within {err:.4g} of the teacher-forced reader (tol {t['tol']}), "
        f"{compared} tokens clear of the margin all equal to its argmax; decode positions off by one read "
        f"{fault_err:.4g}; beam winners' scores within {beam_err:.4g} "
        f"of their recomputed mean log-probs (tol {t['beam_tol']}); a decode step made no synchronizing call")
    return out


def clustered_corpus(n: int, d: int, t: dict, g, dev):
    """Phase 8's corpus: n unit rows, each one of t["centres"] seeded unit
    centres plus noise, in a space whose per-dimension scale decays as
    exp(-i / t["decay"]) (embedding spectra concentrate; a 128-dim PCA keeps
    most of the variance), then rotated at random. Also a maker of held-out
    queries drawn the same way. Made on the card from `g`."""
    import torch

    scale = torch.exp(-torch.arange(d, device=dev, dtype=torch.float32) / t["decay"])
    rot, _ = torch.linalg.qr(torch.randn((d, d), generator=g, device=dev))
    centres = torch.nn.functional.normalize(torch.randn((t["centres"], d), generator=g, device=dev) * scale, dim=-1)

    def draw(rows: int):
        which = torch.randint(0, t["centres"], (rows,), generator=g, device=dev)
        x = centres[which] + t["noise"] * torch.randn((rows, d), generator=g, device=dev) * scale
        return torch.nn.functional.normalize(x, dim=-1) @ rot

    corpus = torch.empty((n, d), device=dev)
    for s in range(0, n, 1 << 17):
        corpus[s : s + (1 << 17)] = draw(min(1 << 17, n - s))
    return corpus, draw


def exact_ids(queries, corpus, k: int):
    """Exact f32 top-k ids (TF32 off) and the sorted f32 scores, by chunks of 64 queries."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    outs = [torch.topk(qs @ corpus.T, k + 1, dim=-1) for qs in queries.split(64)]
    return torch.cat([o.indices for o in outs]), torch.cat([o.values for o in outs])


def recall_at(got, want, k: int = TOP_K) -> float:
    got, want = got[:, :k].cpu(), want[:, :k].cpu()
    return sum(len(set(a.tolist()) & set(e.tolist())) for a, e in zip(got, want)) / want.numel()


def ivfpq_serving_phase(dev, card: str, hbm: float, peak_int8: float, t: dict, flat_latency: dict) -> dict:
    """Phase 8a: IVF-PQ serving at full width (module constant IVFPQ_SERVE):
    phase 4's e5-base-width encoder, a clustered 2^20 x 768 corpus, the
    `ivfpq` preset and the reference's default factory string built through
    `build_dense_from_config` (the preset through the index cache, then
    loaded from it), their checks, a `SearchServer`, and autotuning: the
    preset's operating points, then the default grid of the PQ direct serving
    codec, whose fused points launch `fused_mips_binned` at int8, 2048 bins,
    tile 16384 (their own main path: counts zeroed before the sweep, read
    after); one such call is held cell for cell against the plain version
    and timed. Returns the numbers."""
    import dataclasses
    import tempfile

    import numpy as np
    import torch

    from vod_tpu_torch.configs import DenseFactoryConfig
    from vod_tpu_torch.models import TransformerEncoderConfig, VodEncoder, VodPoolerConfig
    from vod_tpu_torch.ops.mips import _binned_body, fused_mips_binned, fused_mips_binned_reference
    from vod_tpu_torch.search import (
        HybridEngines, IVFPQIndex, SearchQueries, build_dense_from_config, build_pq_index, dense as dense_module,
        ivfpq_search,
    )
    from vod_tpu_torch.search.autotune import autotune, autotune_after_build, default_grid
    from vod_tpu_torch.serving import SearchHttpClient, SearchServer

    n, d = t["n"], D
    g = torch.Generator(device=dev).manual_seed(8)
    t0 = time.perf_counter()
    corpus, draw = clustered_corpus(n, d, t, g, dev)
    held = draw(t["held_out"])
    exact, exact_s = exact_ids(held, corpus, TOP_K)
    torch.cuda.synchronize()
    log(f"8a corpus: {n} x {d} unit rows around {t['centres']} centres (noise {t['noise']}, spectrum decay "
        f"{t['decay']}), {t['held_out']} held-out queries and their exact top-10, in {time.perf_counter() - t0:.2f} s")

    # the two indexes, each through the factory; the preset through the cache
    cache = tempfile.TemporaryDirectory(prefix="vod-ivfpq-cache-")
    configs = {
        "preset": DenseFactoryConfig(**t["preset"]),
        "faiss-default": DenseFactoryConfig.from_faiss_factory(t["factory"]),
    }
    indexes, build_ms = {}, {}
    for name, cfg in configs.items():
        build_ms[name] = {}
        kw = dict(cache_dir=cache.name, data_fingerprint="phase-8a") if name == "preset" else {}
        t1 = time.perf_counter()
        indexes[name] = build_dense_from_config(cfg, corpus, generator=g, device=dev, timings=build_ms[name], **kw)
        torch.cuda.synchronize()
        build_ms[name]["total_ms"] = (time.perf_counter() - t1) * 1e3
        ix = indexes[name]
        check(isinstance(ix, IVFPQIndex), f"{name}: built {type(ix).__name__}, not IVFPQIndex")
        log(f"8a index {name} [{card}]: {json.dumps(dataclasses.asdict(cfg))}; {ix.centroids.shape[0]} cells, "
            f"{ix.row_ids.shape[0]} slots, max_windows {ix.max_windows}, codes "
            f"{None if ix.codes is None else tuple(ix.codes.shape)}, refine "
            f"{None if ix.refine_codes is None else tuple(ix.refine_codes.shape)}; build ms by stage "
            f"{json.dumps({k: round(v, 4) for k, v in build_ms[name].items()})}")
    preset, adc = indexes["preset"], indexes["faiss-default"]
    check(preset.codes is None and preset.refine_codes.dtype == torch.int8 and preset.refine_codes.shape[1] == 128,
          "the preset is not IVF + int8 refine rows at 128 PCA dims")
    check(adc.codes is not None and adc.refine_codes is None and adc.rotation is not None,
          "the factory default is not OPQ + IVF + ADC codes")
    check(preset.centroids.shape[0] == adc.centroids.shape[0] == round(n**0.5), "IVFauto did not give sqrt(N) cells")

    # the cache: a second build loads the first
    load_ms: dict[str, float] = {}
    t1 = time.perf_counter()
    loaded = build_dense_from_config(configs["preset"], corpus, generator=g, cache_dir=cache.name,
                                     data_fingerprint="phase-8a", device=dev, timings=load_ms)
    torch.cuda.synchronize()
    load_total = (time.perf_counter() - t1) * 1e3
    check(set(load_ms) == {"load_ms"}, f"the second build did not load the cache: {load_ms}")
    for f in dataclasses.fields(IVFPQIndex):
        a, b = getattr(preset, f.name), getattr(loaded, f.name)
        same = torch.equal(a, b) and a.device == b.device if isinstance(a, torch.Tensor) else a == b
        check(same, f"the cached index's field {f.name} differs")
    cache_bytes = sum(p.stat().st_size for p in Path(cache.name).rglob("*") if p.is_file())
    q64 = SearchQueries(vector=held[:64])
    a, b = ivfpq_search(preset, q64, TOP_K), ivfpq_search(loaded, q64, TOP_K)
    check(torch.equal(a.indices, b.indices) and torch.equal(a.scores, b.scores), "the cached index answers otherwise")
    del loaded
    cache.cleanup()
    log(f"8a cache [{card}]: build {build_ms['preset']['total_ms']:.4f} ms (saving included), load "
        f"{load_total:.4f} ms ({cache_bytes} bytes on disk); every field torch.equal, answers identical")

    # exact with every cell probed and f32 refine rows (the preset's layout, f32 rows)
    f32_rows = torch.where((preset.row_ids >= 0)[:, None], corpus[preset.row_ids.clamp(min=0).long()], 0.0)
    full = preset.replace(refine_codes=f32_rows, refine_scale=None, refine_proj=None,
                          nprobe=int(preset.centroids.shape[0]), max_windows=0)
    got = ivfpq_search(full, q64, TOP_K).indices
    bound = 2 * d * 2.0**-24  # twice gamma_D for unit rows and queries
    gap = (exact_s[:64, :TOP_K] - exact_s[:64, 1 : TOP_K + 1]) > bound  # slot j clear of slot j + 1
    margin = gap.clone()
    margin[:, 1:] &= gap[:, :-1]  # ... and of slot j - 1
    check(bool((got[margin] == exact[:64, :TOP_K][margin]).all()), "full probe with f32 rows is not exact")
    log(f"8a full probe, f32 rows: exact top-10 ids at {int(margin.sum())} of {margin.numel()} slots whose margin "
        f"exceeds the f32 bound {bound:.3g}")
    del f32_rows, full

    # recall at the configs' nprobe; the card against the CPU; no host sync
    recalls, cpu_err, search_ms = {}, {}, {}
    for name, ix in indexes.items():
        got = ivfpq_search(ix, SearchQueries(vector=held), TOP_K)
        recalls[name] = recall_at(got.indices, exact)
        cpu_ix = dataclasses.replace(ix, **{f.name: getattr(ix, f.name).cpu() for f in dataclasses.fields(ix)
                                            if isinstance(getattr(ix, f.name), torch.Tensor)})
        want = ivfpq_search(cpu_ix, SearchQueries(vector=held[:64].cpu()), TOP_K)
        card_out = ivfpq_search(ix, q64, TOP_K)
        cpu_err[name], swaps = check_sparse_close(f"8a {name} card vs CPU", card_out, want, t["cpu_tol"])
        del cpu_ix
        ivfpq_search(ix, q64, TOP_K)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            ivfpq_search(ix, q64, TOP_K)
        except RuntimeError as exc:
            fail(f"8a {name}: ivfpq_search waits for the card: {exc}")
        finally:
            torch.cuda.set_sync_debug_mode("default")
        search_ms[name] = {}
        for bq in t["batches"]:
            sq = SearchQueries(vector=held[:bq])
            ms = time_ms(lambda: ivfpq_search(ix, sq, TOP_K), 10)
            host_ms, device_ms, by_kernel = host_and_device_ms(lambda: ivfpq_search(ix, sq, TOP_K), 10)
            top = dict(sorted(by_kernel.items(), key=lambda kv: -kv[1])[:5])
            search_ms[name][bq] = dict(ms=ms, host_ms=host_ms, device_ms=device_ms, top_kernels_ms=top)
            log(f"time 8a ivfpq_search {name} B={bq} nprobe={ix.nprobe} [{card}]: {ms:.4f} ms (CUDA events); host "
                f"enqueue {host_ms:.4f} ms, device {device_ms:.4f} ms (profiler); top kernels "
                f"{json.dumps({k: round(v, 4) for k, v in top.items()})}")
        log(f"8a {name}: recall@10 {recalls[name]:.4f} at nprobe {ix.nprobe} ({t['held_out']} held-out queries); card "
            f"vs CPU at B=64: max |diff| {cpu_err[name]:.3g} (tol {t['cpu_tol']}), {swaps} ids swapped inside the "
            f"band; no host sync under sync-debug \"error\"")
    check(recalls["preset"] >= t["recall_floor"], f"8a preset recall@10 {recalls['preset']:.4f} < {t['recall_floor']}")
    check(recalls["faiss-default"] >= t["adc_recall_floor"],
          f"8a faiss-default recall@10 {recalls['faiss-default']:.4f} < {t['adc_recall_floor']}")

    # a SearchServer over the preset: encoded queries with gold lookups, held-out vectors
    cfg = TransformerEncoderConfig(  # phase 4's encoder
        vocab_size=30522, hidden_size=768, num_layers=12, num_heads=12, intermediate_size=3072,
        max_position_embeddings=512, dtype=torch.bfloat16,
        pooler=VodPoolerConfig(agg_method="mean", output_norm="l2", scaler=10.0, learn_scaler=True),
    )
    encoder = VodEncoder(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0)).eval()
    ids = torch.randint(1000, cfg.vocab_size, (N_QUERIES, QUERY_TOKENS), generator=g, device=dev)
    with torch.inference_mode():
        qv = encoder(ids, torch.ones_like(ids, dtype=torch.int32)).float().cpu().numpy()
    del encoder
    gold = torch.randint(0, n, (N_QUERIES, 1), generator=g, device=dev).to(torch.int32).cpu().numpy()
    held_np = held[:N_QUERIES].cpu().numpy()
    direct = ivfpq_search(preset, SearchQueries(vector=held[:N_QUERIES]), TOP_K)
    direct_ids, direct_s = direct.indices.cpu().numpy(), direct.scores.cpu().numpy()
    with SearchServer(HybridEngines(dense=preset), batch_window_ms=2, max_batch=64, device=dev) as srv:
        srv.warmup({"vector": qv[:1], "section_ids": gold[:1]}, top_k=TOP_K)
        srv.warmup({"vector": held_np[:1]}, top_k=TOP_K)
        client = SearchHttpClient(srv.url)
        enc_out, _ = post_all(client, [{"vector": qv[i : i + 4], "section_ids": gold[i : i + 4]}
                                       for i in range(0, N_QUERIES, 4)], 16)
        held_out, _ = post_all(client, [{"vector": held_np[i : i + 4]} for i in range(0, N_QUERIES, 4)], 16)
        single = [{"vector": held_np[i % N_QUERIES : i % N_QUERIES + 1]} for i in range(100)]
        _, lat1 = post_all(client, single, 1)
        many = [{"vector": held_np[i % N_QUERIES : i % N_QUERIES + 1]} for i in range(320)]
        t1 = time.perf_counter()
        _, lat32 = post_all(client, many, 32)
        wall = time.perf_counter() - t1
    for i, out in enumerate(enc_out):
        for r in range(out.indices.shape[0]):
            row = out.indices[r].tolist()
            g_id = int(gold[4 * i + r, 0])
            check(g_id in row and out.labels[r][row.index(g_id)] == 1, "8a serve: gold id lost")
    served = np.concatenate([o.indices for o in held_out], axis=0)
    for r, c in zip(*(served != direct_ids).nonzero()):  # only equal (int8) scores may swap two ids
        pos = direct_ids[r].tolist().index(served[r, c]) if served[r, c] in direct_ids[r] else None
        check(pos is not None and abs(direct_s[r, pos] - direct_s[r, c]) < 1e-5,
              f"8a serve: served ids != direct ivfpq_search ids (row {r})")
    latency = dict(
        one_client_ms=dict(n=100, p50=statistics.median(lat1) * 1e3, p90=percentile(lat1, 90) * 1e3),
        clients_32_ms=dict(n=320, p50=statistics.median(lat32) * 1e3, p95=percentile(lat32, 95) * 1e3),
        clients_32_qps=320 / wall,
    )
    log(f"8a serve ivfpq preset [{card}]: served ids == direct ivfpq_search; gold ids with label 1; latency "
        f"{json.dumps(latency)}; phase 4's flat server {json.dumps(flat_latency)}")

    # autotuning: the preset's operating points (recall only), on the corpus rows
    t1 = time.perf_counter()
    tune_cfg = dataclasses.replace(configs["preset"], autotune_target_recall=t["target_recall"])
    tuned, info = autotune_after_build(preset, tune_cfg, corpus, generator=g)
    log(f"8a autotune preset [{card}]: {time.perf_counter() - t1:.2f} s; chosen {json.dumps(info['params'])} at "
        f"recall {info['recall']} (target {info['target']}); front {json.dumps(info['front'])}")
    check(info["front"] and tuned.nprobe == info["params"]["nprobe"], "8a autotune: no front or no knob applied")
    del indexes, adc, tuned
    torch.cuda.empty_cache()

    # the PQ direct serving codec's default grid (its own main path)
    t1 = time.perf_counter()
    pq = build_pq_index(corpus, **t["pq_direct"], generator=g, device=dev)
    torch.cuda.synchronize()
    pq_build_s = time.perf_counter() - t1
    grid = default_grid(pq)
    fused_points = [p for p in grid if p.get("fused")]
    check(len(fused_points) == 3 and all(p["fused_bins"] == 2048 and p["fused_tile"] == 16384 for p in fused_points)
          and pq.coarse_codes.shape[0] % 16384 == 0, f"the direct codec's grid {grid}")
    calls, real_kernel = [], dense_module.fused_mips_binned

    def recording_kernel(vectors, queries, **kw):
        out = real_kernel(vectors, queries, **kw)
        calls.append((vectors, queries.clone(), kw, out))
        return out

    dense_module.fused_mips_binned = recording_kernel
    fused_mips_binned.launches = 0
    fused_mips_binned.body_launches.update(wgmma=0, fma=0)  # main path (the autotune sweep) starts
    try:
        _, chosen, front = autotune(pq, held, exact[:, :TOP_K].cpu().numpy(), target_recall=t["target_recall"],
                                    top_k=TOP_K, measure_time=True)
    finally:
        dense_module.fused_mips_binned = real_kernel
    torch.cuda.synchronize()
    sweep_launches = fused_mips_binned.launches  # main path ends
    sweep_bodies = dict(fused_mips_binned.body_launches)
    per_point = 1 + 3  # the recall call and three timed repeats
    check(sweep_launches == len(calls) == per_point * len(fused_points),
          f"the sweep launched fused_mips_binned {sweep_launches} times ({len(calls)} calls)")
    check(sweep_bodies == {"wgmma": sweep_launches, "fma": 0}, f"the sweep's launches by body: {sweep_bodies}")
    front_rows = [dict(params=p.params, recall=p.recall, qps=p.qps) for p in front]
    log(f"8a autotune PQ direct codec [{card}]: built in {pq_build_s:.2f} s; {len(grid)} points, fused_mips_binned "
        f"launches {sweep_launches} by body {sweep_bodies}; chosen {json.dumps(chosen.params)} at recall "
        f"{chosen.recall:.4f}; front {json.dumps(front_rows)}")

    # one fused call of the sweep against its plain version, cell for cell, and timed
    vv, qq, kw, (ks, ki) = calls[0]
    check(kw["bins"] == 2048 and kw["tile"] == 16384 and vv.dtype == torch.int8, f"the fused call's knobs {kw}")
    rs, ri = fused_mips_binned_reference(vv, qq, **kw)
    check(torch.equal(ks, rs) and torch.equal(ki, ri), "8a fused call: kernel != plain")
    every = dict(kw, k=kw["bins"])
    ks, ki = fused_mips_binned(vv, qq, **every)
    rs, ri = fused_mips_binned_reference(vv, qq, **every)
    check(torch.equal(ks, rs) and torch.equal(ki, ri), "8a fused call, every cell: kernel != plain")
    shapes = []
    for bq in (64, int(qq.shape[0])):
        qs = qq[:bq]
        dc = int(qs.shape[1])
        check(_binned_body(vv.dtype, dc, kw["bins"], (vv.data_ptr(), qs.data_ptr())) == "wgmma", "8a call off wgmma")
        ms = time_ms(lambda: fused_mips_binned(vv, qs, **kw), 20)
        host_ms, device_ms, by_kernel = host_and_device_ms(lambda: fused_mips_binned(vv, qs, **kw), 20)
        binned_ms = sum(v for key, v in by_kernel.items() if "binned_wgmma_kernel" in key)
        check(binned_ms > 0, f"the profiler saw no binned_wgmma_kernel: {by_kernel}")
        plain_ms = time_ms(lambda: fused_mips_binned_reference(vv, qs, **kw), 2)
        library_ms = time_ms(lambda: torch.topk(torch._int_mm(qs, vv.T), kw["k"], dim=-1), 20)
        nbytes = (int(vv.shape[0]) + bq) * dc + bq * kw["k"] * 8
        ops = 2 * bq * int(vv.shape[0]) * dc
        bound = max(nbytes / hbm, ops / peak_int8) * 1e3
        shapes.append(dict(dtype="int8", body="wgmma", B=bq, N=int(vv.shape[0]), D=dc, bins=kw["bins"],
                           tile=kw["tile"], k=kw["k"], ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                           bound_ms=bound, bound_by="bytes" if nbytes / hbm >= ops / peak_int8 else "operations",
                           host_ms=host_ms, device_ms=device_ms, binned_kernel_ms=binned_ms))
        log(f"check 8a fused int8 B={bq} N={vv.shape[0]} D={dc} bins=2048 tile=16384 k={kw['k']} (wgmma): every cell "
            f"equal; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library {library_ms:.4f} ms, bound {bound:.4f} ms "
            f"({shapes[-1]['bound_by']}); host enqueue {host_ms:.4f} ms, device {device_ms:.4f} ms, of which "
            f"binned_wgmma_kernel {binned_ms:.4f} ms [{card}]")
    del calls, pq, corpus, held, exact
    torch.cuda.empty_cache()
    return dict(
        build_ms=build_ms, cache=dict(load_ms=load_total, bytes=cache_bytes), recall_at_10=recalls,
        card_vs_cpu_max_abs_err=cpu_err, search=search_ms, serving=latency, flat_serving=flat_latency,
        autotune_preset=info, autotune_pq=dict(chosen=chosen.params, recall=chosen.recall, front=front_rows),
        autotune_launches=sweep_launches, autotune_body_launches=sweep_bodies, autotune_shapes=shapes,
    )


def ivfpq_periodic_phase(dev, card: str, t: dict) -> dict:
    """Phase 8b: periodic training over the `ivfpq` preset from host slabs
    (module constant IVFPQ_PERIODIC): phase 5's model at full width over
    t["n"] sections, `embed_hbm_budget_bytes` under the [N, H] f32
    embeddings, `autotune_target_recall` set, its own main path (counts
    zeroed before `periodic_training`, read after; the IVF-PQ path launches
    no kernel, in JAX either). Then one optimizer step under sync-debug
    "error". Returns the numbers."""
    import torch

    from vod_tpu_torch.configs import DenseFactoryConfig
    from vod_tpu_torch.exps import PeriodicTrainingConfig, periodic_training, recipes
    from vod_tpu_torch.ops.mips import fused_mips_binned
    from vod_tpu_torch.runtime import TrainerState, adamw, make_train_step
    from vod_tpu_torch.search import HybridEngines, IVFPQIndex
    from vod_tpu_torch.search.autotune import apply_runtime_params

    n, periods, steps = t["n"], t["periods"], t["steps"]
    t0 = time.perf_counter()
    model, corpus, query_batch, g = realm_setup(dev, t, seed=9)
    batches = [[query_batch() for _ in range(steps * t["accum"])] for _ in range(periods)]
    emb_bytes = n * t["d"] * 4
    dense = DenseFactoryConfig(**t["dense"])
    config = PeriodicTrainingConfig(dense=dense, embed_hbm_budget_bytes=emb_bytes // 2, log_interval=steps)
    torch.cuda.synchronize()
    log(f"8b setup: corpus {n} x {t['ls']} tokens, embeddings {emb_bytes} bytes over the budget "
        f"{config.embed_hbm_budget_bytes}; {time.perf_counter() - t0:.2f} s")
    builds, real_build = [], recipes.build_dense_from_host

    def recording_build(cfg, vectors_np, **kw):
        index = real_build(cfg, vectors_np, **kw)
        builds.append(index)
        return index

    recipes.build_dense_from_host = recording_build
    optimizer = adamw(model, t["lr"], weight_decay=0.0)
    step_fn = make_train_step(
        model, optimizer, prefetch=t["prefetch"], n_sections=t["n_sections"], max_pos_sections=t["max_pos"],
        temperature=1.0, with_lm=True, gradient_clip_val=1.0, accumulate_grad_batches=t["accum"],
    )
    recorder = step_recorder()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    fused_mips_binned.launches = 0
    fused_mips_binned.body_launches.update(wgmma=0, fma=0)  # main path starts
    t_main = time.perf_counter()
    try:
        state, history = periodic_training(
            step_fn=step_fn, corpus=corpus, state=TrainerState(max_steps=periods * steps, period=steps),
            train_queries_fn=lambda p: batches[p], generator=g, config=config, callbacks=[recorder],
        )
    finally:
        recipes.build_dense_from_host = real_build
    torch.cuda.synchronize()
    launches = dict(fused_mips_binned.body_launches)  # main path ends
    wall = time.perf_counter() - t_main
    peak_mem = torch.cuda.max_memory_allocated(dev)
    check(launches == {"wgmma": 0, "fma": 0}, f"the IVF-PQ periodic path launched {launches}")
    check(state.step == periods * steps and len(history) == periods == len(builds),
          f"8b: {state.step} steps, {len(history)} periods, {len(builds)} host builds")
    check(all(isinstance(ix, IVFPQIndex) and ix.codes is None for ix in builds), "8b: not the ivfpq preset")
    losses = [float(m["loss"]) for m in recorder.metrics]
    norms = [float(m["grad_norm"]) for m in recorder.metrics]
    check(len(losses) == periods * steps and all(math.isfinite(x) for x in losses + norms),
          f"8b losses {losses}, gradient norms {norms}")
    check(all(h["host_build"] and "autotune" in h for h in history), "8b: a period did not build from host slabs "
          "or did not autotune")
    check(not torch.equal(builds[0].refine_codes, builds[1].refine_codes), "8b: period 1's rows equal period 0's")
    step_ms = [s.elapsed_time(e) for s, e in recorder.events]
    for p, h in enumerate(history):
        log(f"8b period {p} [{card}]: re-embed to host {h['reembed_s'] * 1e3:.4f} ms ({n / h['reembed_s']:.4f} "
            f"sections/s); host-slab build {json.dumps({k: round(v, 4) for k, v in h['build_ms'].items()})} ms; "
            f"index {h['index_bytes']} bytes; autotune {json.dumps(h['autotune'])}; ms per optimizer step "
            f"{json.dumps([round(x, 4) for x in step_ms[p * steps:(p + 1) * steps]])}")
    log(f"8b run: {periods} periods of {steps} steps in {wall:.2f} s; step median {statistics.median(step_ms):.4f} ms; "
        f"peak memory {peak_mem / 2**30:.4f} GiB; losses {json.dumps([round(x, 6) for x in losses])}")

    # one more optimizer step over the last period's tuned index, never waiting for the card
    tuned = apply_runtime_params(builds[-1], history[-1]["autotune"]["params"])
    engines = HybridEngines(dense=tuned)
    step_fn.train_step_accum(engines, corpus, batches[-1][: t["accum"]], g, {"dense": 1.0})
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t1 = time.perf_counter()
        step_fn.train_step_accum(engines, corpus, batches[-1][: t["accum"]], g, {"dense": 1.0})
        enqueue_ms = (time.perf_counter() - t1) * 1e3
    except RuntimeError as exc:
        fail(f"the IVF-PQ train step waits for the card: {exc}")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    finish_ms = (time.perf_counter() - t1) * 1e3
    log(f"8b train step without a sync [{card}]: enqueued in {enqueue_ms:.4f} ms, finished {finish_ms:.4f} ms after "
        f"the start (nprobe {tuned.nprobe})")
    del builds, engines, tuned, model, corpus, step_fn, optimizer
    return dict(
        periods=[dict(reembed_ms=h["reembed_s"] * 1e3, build_ms=h["build_ms"], index_bytes=h["index_bytes"],
                      autotune=h["autotune"], period_s=h["period_s"]) for h in history],
        step_ms=step_ms, step_median_ms=statistics.median(step_ms), losses=losses, grad_norms=norms,
        peak_mem_bytes=peak_mem, launches=launches, no_sync_step=dict(enqueue_ms=enqueue_ms, finish_ms=finish_ms),
    )


def main() -> None:
    started = time.perf_counter()
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
    train, trained = train_phase(dev, card, hbm, peak_bf16, peak_f32, TRAIN)

    # 7a. the causal reader's generation, from phase 5's trained system (run before phase 6 frees it)
    generation = causal_generation_phase(dev, card, GENERATION, **trained)
    del trained

    # 6. periodic training over the PQ codec, then the PQ coarse route
    gc.collect()
    torch.cuda.empty_cache()
    periodic = periodic_phase(dev, card, hbm, peak_int8, PERIODIC)

    # 7b. the seq2seq REALM of BASELINE config #5: train steps, greedy and beam generation
    gc.collect()
    torch.cuda.empty_cache()
    seq2seq = seq2seq_phase(dev, card, hbm, peak_int8, SEQ2SEQ)

    # 8. IVF-PQ: serving at full width (8a), periodic training from host slabs (8b)
    gc.collect()
    torch.cuda.empty_cache()
    t8 = time.perf_counter()
    ivfpq = ivfpq_serving_phase(dev, card, hbm, peak_int8, IVFPQ_SERVE, results["latency"])
    gc.collect()
    torch.cuda.empty_cache()
    ivfpq["periodic"] = ivfpq_periodic_phase(dev, card, IVFPQ_PERIODIC)
    ivfpq["wall_s"] = time.perf_counter() - t8
    log(f"phase 8 wall time: {ivfpq['wall_s']:.1f} s")

    # 9. result lines
    main = next(s for s in shapes if s["dtype"] == "bfloat16" and s["B"] == 64 and s["bins"] == 1024
                and s["body"] == "wgmma")
    exact_main = next(s for s in exact_shapes if s["dtype"] == "bfloat16" and s["B"] == 2048 and s["k"] == 10
                      and s["body"] == "wgmma")
    kernels = [dict(
        name="fused_mips_binned", route="cuda", source="vod_tpu_torch/csrc/fused_mips_binned.cu",
        replaces="vod_tpu/ops/mips_pallas.py:151", launches=launches,
        max_abs_err=max(max_err, train["train_max_abs_err"], seq2seq["train_call"]["max_abs_err"]),
        ms=main["ms"], plain_ms=main["plain_ms"], bound_ms=main["bound_ms"], bound_by=main["bound_by"],
        library_ms=main["library_ms"], shape=f"bfloat16 B=64 N={N_KERNEL} D={D} bins=1024 k={K_POOL}",
        shapes=shapes, serving=results, shootout_launches=shootout_launches["fused_mips_binned"],
        body=main["body"], body_launches=binned_body_launches, shootout_body_launches=shootout_binned_bodies,
        train_launches=train["train_launches"], train_body_launches=train["train_body_launches"],
        train_max_abs_err=train["train_max_abs_err"], train_call=train["train_call"], train_step=train["train_step"],
        coarse_launches=periodic["coarse_launches"], coarse_body_launches=periodic["coarse_body_launches"],
        coarse_shapes=periodic["coarse_shapes"], coarse_recall_at_10=periodic["coarse_recall_at_10"],
        periodic=periodic["periodic"],
        generation_launches=generation["launches"], generation_body_launches=generation["body_launches"],
        generation=generation, seq2seq_launches=seq2seq["launches"],
        seq2seq_body_launches=seq2seq["body_launches"], seq2seq_call=seq2seq["train_call"], seq2seq=seq2seq,
        body_ms={body: {f"{s['dtype']} B={s['B']} bins={s['bins']}": s["ms"] for s in shapes if s["body"] == body}
                 for body in ("wgmma", "fma")},
        autotune_launches=ivfpq["autotune_launches"], autotune_body_launches=ivfpq["autotune_body_launches"],
        autotune_shapes=ivfpq["autotune_shapes"], ivfpq=ivfpq,
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
    log(f"chip_smoke wall time: {time.perf_counter() - started:.1f} s, the kernels' build included")
    log(json.dumps({"kernels": kernels}))
    log(mips_kernel_bench.card_name(dev))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
