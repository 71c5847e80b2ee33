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
    2 periods of 3 optimizer steps: each period re-embeds the 2^19 sections
    (2^20 before phase 16 was added) and rebuilds the PQ index; the BM25 index is built once before the
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
 9. the experiment CLI from text to a train step (`CLI`), in process
    through `vod_tpu_torch.exps.cli.main`, each `main` its own main path
    (counts zeroed before, read after): 2^15 passages harvested from the
    interpreter's site-packages, 8,192 generated queries and a 30,522-entry
    vocab.txt written as a BeIR directory, and a YAML extending
    `configs/msmarco_pq_realm.yaml` (flat bf16 `kernel: fused` at 512 bins,
    6 steps, period 3); `main(["--config", yaml])`, then
    `main(["--resume_from", run, "--max_steps", "9"])`. Checked: the parsed
    `Experiment` and `config.json` equal the yaml with the overrides; no
    section tokenizes to all `[UNK]`; finite losses; the logged weights
    follow the yaml's schedules; period 1's index differs from period 0's;
    2 `fused_mips_binned` launches a step, all `wgmma`; one CLI-loop call
    (B = 32, D = 384, N = 2^15, 512 bins, k = 100) against its plain
    version; BM25's top 100 holds the gold passage for at least
    `CLI["bm25_recall_floor"]` of 256 held-out queries; the resume starts at
    step 6 and ends at 9; one optimizer step with its dataloader batches
    under sync-debug "error". Printed: harvest s, tokenizer and analyzer
    sections/s, BM25 build ms, per period re-embed s, index build ms, step
    median and the dataloader's wait share, peak memory, the phase's wall;
10. the large-encoder path of the CLI (`LARGE`), in process through
    `vod_tpu_torch.exps.cli.main`, its own main path (counts zeroed before,
    read after): `configs/scifact_ranker.yaml`'s body under `extends:
    [arch/v5e-1-large-qlora, optimizer/adafactor]` (e5-large at hidden 1024,
    24 layers, 16 heads, FFN 4096; LoRA r 8 over an int8-frozen base;
    remat; GradCache at 128 rows; B = 32 as 8 micro-batches of 4;
    Adafactor), `model.name_or_path` a directory the phase writes
    (e5-large-v2's config.json beside 1.34 GB of seeded random f32 weights
    in `model.safetensors`; `hf_fallback: error`), over 2^13 harvested
    passages (2^14 before phase 17; a flat bf16 `kernel: fused` index at D = 1024; 6 steps, a
    period every 3). Checked: the parsed config; the written tensors load
    bit for bit; at step 0 the LoRA encoder's pooled output equals the same
    checkpoint's without adapters; finite losses; 8 `fused_mips_binned`
    launches a step, all `wgmma`; after training every int8 code unchanged
    (and equal to the written tensor's quantization) and every LoRA and
    pooler leaf moved; one D = 1024 call against its plain version; on one
    micro-batch GradCache's gradients (at 128 and 8 rows a chunk) within
    `LARGE["grad_rel_limit"]` (relative L2) of the monolithic backward's,
    with a control (another micro-batch) far above it; one Adafactor update
    on the card against the same update on the CPU; one optimizer step with
    its dataloader batches under sync-debug "error". Printed: the
    `kbit_memory_bytes` split, peak memory of the run, of the monolithic
    backward and of GradCache, re-embed s per period, the step median, the
    phase's wall;
11a. SPLADE through the experiment CLI (`SPLADE`), in process through
    `vod_tpu_torch.exps.cli.main`, its own main path (counts zeroed before,
    read after): `configs/scifact_ranker.yaml`'s body with
    `model.splade_encoder` at bert-base-uncased's widths (hidden 768, 12
    layers, 12 heads, FFN 3,072, vocab 30,522), `model.name_or_path` a
    `BertForMaskedLM` checkpoint the phase writes (seeded random f32
    weights; the CLI grafts the backbone only), splade_query_k 64,
    splade_doc_k 128, splade_max_postings 4096, FLOPS weight 1e-4, over 2^15
    harvested passages (6 steps, a period every 3). Checked: the parsed
    config; no kernel launch (SPLADE reaches neither kernel, in JAX either);
    no dense engine in either period and a learned index of a row per
    vocabulary term rebuilt at each boundary; the backbone at step 0 is the
    checkpoint's and the MLM head is not; every parameter moved; on one
    collated batch the FLOPS term is finite, positive, inside the loss and
    the fused query + section pass's; the collated `section__sparse` equals
    a direct `sparse_search` of the queries' top-64 terms; one chunk's
    impacts on the card within `SPLADE["impact_tol"]` of the CPU's, with a
    control above it; one optimizer step with its dataloader batch under
    sync-debug "error". Printed: impact re-embed s per period, the learned
    table's width and bytes, terms per section and per query, the step
    median, peak memory, enqueue beside finish;
11b. the second stage over 11a's index (`SECOND_STAGE`): a cross-encoder
    at ms-marco-MiniLM-L-6-v2's architecture (a checkpoint the phase writes)
    re-ranks the top 32 of 64 held-out queries at max_length 256 through
    `benchmark_retrieval(reranker=...)` (and `cross_encoder_rerank` orders
    by the same scores), then fills the teacher scores of one collated
    batch (-inf exactly at padding) for one `DistillationGradients(margin_mse)`
    loss and backward of the SPLADE student; then
    `vod_tpu_torch.examples.maxsim_bench` at its defaults (1M x 32 x 128-d
    int8, 4 GiB): one `maxsim_rerank` block equal to `_score_gathered` on
    the CPU, the brute-force scan's top-1 scored as the rerank scores it,
    two-stage recall@10 at least the pooled-only one. No kernel launch;
11c. the dynamic store and the cache (`DYNAMIC`): capacity 2^20 x 768 in
    bf16 and int8, filled from 2^19 rows of phase 4's corpus in 8 adds, 10%
    deleted, 1% updated, one add overflowing by 4,096 rows (dropped and
    counted), compacted; `dynamic_search` at B = 64, k = 10 against an exact
    f64 search over the live rows (int8: equal; bf16: within the f32
    sum-order bound, ids equal outside it), ms per op printed; then
    `cached_embeddings` of 11a's 2^15 passages at e5-base's width: the miss
    writes the store, the hit reads it back bit for bit, a zeroed row
    forces a recompute; ms of each;
12. multi-device on `torch.distributed` (`SHARDED`, `MULTI_CLI`):
12a. sharded search (`sharded_search_rank` on each rank): the 2^20 x 768
    int8 corpus of phase 4's size, seeded, sharded over a "shard" axis
    (`build_sharded_dense_index`, `kernel: fused`, 512 bins), 64 held-out
    queries, k = 10; first at world size 1 under NCCL in this process, then
    on two ranks of the one card under gloo through torchrun (this script
    with `--rank-job`), 2^19 rows a rank. Checked on each rank: the
    per-shard `fused_mips_binned` call takes the `wgmma` body and equals its
    plain version in every id and score; `sharded_dense_search` launches it
    once (its own main path) and equals the merge of the ranks' plain
    per-shard answers, the same on every rank; recall@10 against exact f32
    search at least `INT8_RECALL_FLOOR`; with n_real cut to put every real
    row on rank 0, the other shards' kernel calls return -1 and the int8
    sentinel and the search only real rows. Printed: the per-shard kernel,
    its plain version, `torch.topk(torch._int_mm(q, Vᵀ), k)` and the bound
    (one rank at a time), the merge (the collective, labelled by backend)
    and the whole search;
12b. the experiment CLI under torchrun with two ranks of the one card
    (gloo; NCCL refuses two ranks on one GPU): each rank runs
    `vod_tpu_torch.exps.cli.main` (`cli_rank`, which wraps what the CLI
    calls to record) with `configs/scifact_ranker.yaml` at its own widths
    under `extends: [strategy/dp, search/sharded]` (int8 sharded over `dp`,
    `kernel: fused`) over phase 9's harvest, 6 steps with a period every
    3, then `--resume_from` to step 9. Checked: finite losses; both ranks'
    parameters equal after every step (a checksum broadcast from rank 0);
    at least one `wgmma` launch of `fused_mips_binned` a step on each rank,
    on its 16 rows of a `ShardedDenseIndex`; rank 0 writes each period's
    checkpoint and rank 1 none, both load it on resume; the first step's
    mean loss over the ranks equals one process's loss of the same global
    batch within `MULTI_CLI["loss_rtol"]`; both ranks exit 0. Printed: the
    step median, the collectives' bytes a step and their share of it, the
    re-embeds, the sharded builds, each rank's peak memory;
12c. with two or more cards, 12b again under NCCL at world size = the
    cards' count; with one, a line says it did not run and why;
13. the sharded compressed indexes and batch-wide training over a
    data-parallel group (`COMPRESSED`, `PQ_CLI`, `SPLADE_DP`), each path
    checked to launch neither kernel (JAX launches none there):
13a. `compressed_search_rank` on each rank, at world size 1 under NCCL in
    this process, then on two gloo ranks of the card: phase 8a's corpus
    cut to 2^19 x 768 (2^20 before phase 17) through the factory with
    `sharded: true` (msmarco_pq_realm.yaml's 4-bit PQ with an int8 refine,
    the `ivf` preset, the `ivfpq` preset with its coarse k-means over the
    ranks) and MaxSim at `maxsim_bench`'s widths over 2^19 documents (1M
    before phase 17), 64 held-out queries, k = 10. Checked: an `all_reduce` (MAX) of
    -inf on a CUDA tensor; the ranks' answers equal; IVF and untruncated
    IVF-PQ give the unsharded ids outside the score band; PQ and the
    preset's IVF-PQ reach the unsharded recall@10 less 0.01; `kmeans_sharded`
    within 1e-4 (relative) of `kmeans` from the same rows after one
    iteration, and its objective after all within 1e-4; the sharded IVF-PQ
    autotune meets its target; MaxSim equals the unsharded rerank exactly.
    Printed per engine: build, per-shard search, merge and whole search ms
    (host beside card);
13b. configs/msmarco_pq_realm.yaml through the CLI on two gloo ranks
    (`batchwide_cli_rank`) under `strategy/dp` with its PQ sharded over
    `dp`, in-batch negatives and autotuning, phase 9's harvest at length 96,
    a batch of 4 (cut from 32), 6 steps and a resume to step 9. Checked:
    finite losses; parameters equal on both ranks after every step; a
    sharded PQ built and tuned each period, to one point on both ranks; the
    first batch pools the global batch's sections; the collate's sharded
    search equals a direct call; the first step's loss within 1e-3 relative
    of one process's on the same global batch;
13c. phase 11a's SPLADE composition under `strategy/dp` on two gloo ranks
    (over 2^13 passages, 2^14 before phase 17): as 13b, the first loss with the FLOPS term; the period-0 impact terms
    and learned index re-embedded over the ranks equal one process's;
13d. with two or more cards, 13a under NCCL at world size = their count;
    with one, a line says it did not run and why;
14. model parallelism (`MOE_CLI`, `PARALLEL`):
14a. the MoE encoder through the CLI, in process through `cli.main` (each
    `main` its own main path: launch counts zeroed just before it and read
    just after): phase 9's inputs and `configs/msmarco_pq_realm.yaml` with
    `model: {moe_experts: 8, moe_top_k: 2}` over 2^14 harvested passages, 3
    optimizer steps and a checkpoint, then a resume to step 6. Checked:
    every encoder layer an 8-expert top-2 `MoEFFN`; every loss finite, with
    the weighted aux term in it (its value and share printed); every
    layer's `wi` and `wo` moved; the checkpoint written; two
    `fused_mips_binned` launches a step, all `wgmma`, and the loop's first
    call against its plain version at its shape, timed beside the library
    and the bound. Printed: each step's ms on the card (CUDA events) beside
    the host's call, and one layer's MoE FFN forward beside a dense FFN of
    its width;
14b. `parallel_rank` on two gloo ranks of the card (`--rank-job parallel`,
    torchrun) at e5-large's widths in bf16, B = 8, T = 512: the
    tensor-parallel encoder forward (`shard_params_tp`), GPipe forward and
    gradients (`pp_encoder_forward`), ring attention (`sp_encoder_forward`)
    and an 8-expert top-2 `MoEFFN` split over the ranks
    (`shard_params_ep`). Checked: with f32 activations, tp, pp and sp
    within 1e-3 of the same port's one-rank f32 forward; with bf16 ones, pp
    within 6e-2 of the one-rank bf16 forward, tp and sp no farther from the
    f32 forward than the bf16 forward is, plus 6e-2; ep within 6e-2 of the
    replicated module (its aux within 1e-5); pp's gradients finite on the
    rank's own layers. Printed: each bf16 leg's ms beside the one-rank
    forward's, its distances from the bf16 and the f32 forwards, and the
    collectives' share of a call;
14c. with two or more cards, 14b under NCCL at world size = their count;
    with one, a line says it did not run and why;
15. the slice of the leftovers (`PROFILED_CLI`, `ROBERTA_CLI`, `TOKENIZE`;
    15d in 13c's job, `SPLADE_DP["gradcache_rows"]`):
15a. the CLI with `sys.profile_dir` (`profiled_cli_phase`, its own main
    path): phase 14a's inputs without MoE, two periods of 6 steps. Checked:
    one trace file (none for the second period), which parses, with one
    `train_step` span for each step of the window [3, 6), and as many
    `binned_wgmma_kernel` events and `fused_mips_binned` spans as the loop
    launched in those steps (2 a step). Printed from the trace: the device's
    busy share over the window, the kernels that took the most, and the
    device's longest idle gaps with the host op that overlaps each the most;
15b. a roberta-base-width encoder (a `RobertaModel` checkpoint of seeded
    random weights the phase writes) through the CLI with scifact's body
    and a byte-level BPE of 50,265 entries that the phase builds from the
    harvest (vocab.json + merges.txt, read by the port's own tokenizer), 3
    steps (its own main path). Checked: finite losses, the backbone loaded
    with its one token type, every `fused_mips_binned` launch at D = 768 on
    `wgmma` and the loop's first call held to its plain version, timed
    beside the library and the bound;
15c. the host tokenizers' sections/s (WordPiece, byte-level BPE, Unigram)
    on the same passages, cold; `block_topk` over [64, 2^20] f32 on the card
    against `torch.topk` and against the CPU (ids and scores exactly
    equal), timed;
15d. in 13c's rank job after its CLI run: two GradCache steps with the
    FLOPS term over the split batch (100 rows a chunk). Checked: the first
    loss over the ranks within 1e-3 (relative) of one process's GradCache
    on the global batch, the parameters equal on both ranks after each
    step;
16. the root `examples/` scripts' ports (`EXAMPLES`):
16a. `serving_latency_bench` and `serving_codec_bench` (`serving_examples_phase`,
    each its own main path) at full width and 2^20 rows: every
    `fused_mips_binned` launch on `wgmma`, launches counted per script; the
    codec sweep's rows above a recall floor; one coarse call at bins 2048
    and one at 4096 equal to the plain version on the card, timed beside
    the library and the bound. Printed: p50/p99 with the batcher on and
    off, each sweep row's recall@10 and ms a block;
16b. the other 17 scripts' `main`s at small sizes (`small_examples_phase`):
    finite numbers and each one's floor; `hub_checkpoint_eval` skips without
    a cache and runs over a checkpoint written into a local HF cache;
16c. `Precompiled` tokenization on the host (`precompiled_phase`): a
    Unigram `tokenizer.json` with and without a `Precompiled` charsmap, its
    sections/s beside the plain one's on the same harvested passages;
17. the last two root scripts' ports (`REALTEXT`):
17a. `real_text_1m_bench` (`realtext_phase`, its own main path) at its
    widths over 2^18 passages harvested from the machine's site-packages, in
    a fresh cache directory: finite numbers, the loss falling, each codec's
    recall@10 at its floor, stemmed BM25 above unstemmed on inflected
    queries, no kernel launch. Printed: the corpus fingerprint, each stage's
    seconds, recall and QPS per codec, the four gold-hit numbers;
17b. `hybrid_sharded_bench` (`hybrid_sharded_phase`) at the JAX script's
    size on two gloo ranks of the card that the script launches: the
    filter and the agreement (the script's checks), rank 0's kernel
    launches (none). Printed: QPS and the unsharded / sharded time ratio;
18. the script's wall time, the `kernels` JSON line, the card line, and
    the last line `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import functools
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
# Recall@10 floor of int8 `fused_mips_binned` at 512 bins, k = 10, against
# exact f32 search (phase 12a): 0.9578 over one shard of 2^20 x 768 on an
# H100 80GB HBM3 at 700 W (640 pairs, 27 misses): the bins' ~0.9% and the
# int8 rounding of near-tied neighbours. The floor allows 45 misses, outside
# that count's binomial spread (sd ~5).
INT8_RECALL_FLOOR = 0.93


# Phase 5: the REALM train path of configs/msmarco_pq_realm.yaml, cut as the
# module docstring says (corpus 2^20 sections, Lq 32, La 16, two gold ids).
TRAIN = dict(
    n=1 << 20, d=384, layers=6, heads=6, inter=1536, vocab=30522, ls=200, lq=32, la=16, b=32, accum=2,
    warmup=2, timed=10, val_batches=2, prefetch=100, n_sections=8, max_pos=2, bins=512, lr=5e-5,
)

# Phase 6: periodic training with the index codec of configs/msmarco_pq_realm.yaml
# (`search_defaults.dense`, exactly), at phase 5's widths and a corpus of 2^19
# sections of 200 random ids (MS MARCO has 8.8M): two periods of `steps`
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
# Cut for phase 16: 2^20 -> 2^19 sections (each period's re-embed took 62 s
# of the 129.6 s run at 2^20 on an H100 80GB HBM3 at 700 W).
PERIODIC = dict(
    TRAIN, n=1 << 19, periods=2, steps=3, held_out=256, dense=PERIODIC_DENSE, coarse_batches=(32, 64),
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
# 5's model widths: 2^18 sections of 200 random ids (phase 6 holds the 2^19
# re-embed), `embed_hbm_budget_bytes` half the [N, 384] f32 embeddings, so the
# host-slab branch builds every period, and the knobs re-tuned each period
# against a recall target of 0.9; 2 periods of 3 optimizer steps.
IVFPQ_PERIODIC = dict(TRAIN, n=1 << 18, periods=2, steps=3, dense=dict(IVFPQ_PRESET, autotune_target_recall=0.9))

# Phase 9: the experiment CLI from text to a train step. Everything comes
# from the card machine's own files, nothing downloaded: 2^15 passages of 48
# words harvested from the running interpreter's site-packages (stride 48,
# windows that do not overlap), 8,192 train queries of 6-10 consecutive
# words of one seeded passage each (that passage their qrel) and 256 more
# held out for BM25, a vocab.txt of 30,522 entries (the five specials, a-z
# and 0-9 with their ## forms, ASCII punctuation, then the corpus's most
# frequent lower-cased words), and a YAML that extends
# configs/msmarco_pq_realm.yaml by its path and overrides only
# `datasets`, `tokenizer.name_or_path`, `tokenizer.max_length`,
# `search_defaults.dense` (flat bf16, kernel fused at 512 bins; the yaml's
# PQ-only keys stay and the flat codec ignores them), `trainer` (6 steps,
# period 3, log every step, a checkpoint path) and `sys.mesh_shape` ([1]).
# `tokenizer.max_length` 200 -> 96: the CLI pads sections and queries to
# it, so at 200 the reader's rows hold 200 + 200 + 64 tokens and its f32
# logits [256, 463, 30522] (14.5 GB a copy) ran the card out of memory in
# the first step; at 96 the rows hold 256 tokens, phase 5's 248. Harvested
# passages of 48 words average about 74 tokens, so few are truncated (the
# phase prints the share). The harvest is cut from 2^17 to 2^16 so that
# phase 13 fits the script's time (12b and 13b take phase 9's harvest too),
# and from 2^16 to 2^15 so that phase 15 does.
CLI = dict(
    n=1 << 15, passage_words=48, stride=48, queries=8192, held_out=256, query_words=(6, 10), vocab=30522,
    max_length=96, max_steps=6, period=3, resume_steps=9, bins=512, seed=11,
    # the share of held-out queries whose gold passage is in BM25's top 100:
    # 0.9453 on an H100 80GB HBM3 at 700 W (256 literal spans; a binomial
    # spread of ~0.014; at 2^18 passages, before phase 10 took the time that
    # halved the corpus). A broken analyzer, build or scorer finds ~100 / 2^15
    bm25_recall_floor=0.85,
)

# Phase 10: `configs/scifact_ranker.yaml`'s body extended by the qlora arch
# preset and the Adafactor preset (`extends: [scifact_ranker,
# arch/v5e-1-large-qlora, optimizer/adafactor]`): e5-large at hidden 1024,
# 24 layers, 16 heads, FFN 4096 (the preset's widths; `hf` below is
# e5-large-v2's published config.json, which the phase writes beside seeded
# random weights, since no pretrained weights are in the repository), LoRA
# r 8 and alpha 16 over an int8-frozen base, remat, GradCache at 128 rows,
# a batch of 32 as 8 micro-batches of 4, Adafactor. Cuts, each an override
# in the phase's YAML: `search_defaults.dense` gains `kernel: fused`;
# `trainer` runs 6 steps, a period every 3; the corpus is 2^13 harvested
# passages (SciFact's is 5,183, FiQA's 57,638; 2^15 before phase 16, cut to
# make room for it: each period's re-embed took 25.9 s at 2^15 on an H100 80GB HBM3 at
# 700 W; 2^14 before phase 17, cut to make room for it: 13.0 s a re-embed
# at 2^14, the whole script 1,101.3 s with phase 17 at 2^14).
LARGE = dict(
    n=1 << 13, passage_words=48, stride=48, queries=2048, held_out=0, query_words=(6, 10), vocab=30522,
    max_steps=6, period=3, bins=512, seed=13, max_length=200, micro_batch=4, accumulate=8, chunk_rows=128,
    lora_rank=8, probe_rows=8, gradcache_probe_chunk=8, model_overrides={},
    hf=dict(architectures=["BertModel"], model_type="bert", vocab_size=30522, hidden_size=1024, num_hidden_layers=24,
            num_attention_heads=16, intermediate_size=4096, max_position_embeddings=512, type_vocab_size=2,
            layer_norm_eps=1e-12, hidden_act="gelu", hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1,
            initializer_range=0.02, pad_token_id=0, position_embedding_type="absolute", torch_dtype="float32"),
    # GradCache against the monolithic backward on one micro-batch, relative
    # L2 of the trainable gradients: 0 at 128 rows a chunk (one chunk: the
    # same products) and 0.00645 at 8 rows on an H100 80GB HBM3 at 700 W,
    # the control (another micro-batch's gradients) 1.23
    grad_rel_limit=0.025,
)


# Phase 11a: `configs/scifact_ranker.yaml`'s body with a SPLADE encoder at
# naver/splade-cocondenser-ensembledistil's architecture, a `BertForMaskedLM`
# of bert-base-uncased's widths (`hf`: its published config.json, which the
# phase writes beside seeded random f32 weights in that key layout, since no
# pretrained weights are in the repository), `model.name_or_path` pointing at
# it (the CLI grafts the backbone only, as JAX's does). The SPLADE knobs are
# JAX's defaults (`vod_tpu/exps/structconf.py`: splade_query_k 64,
# splade_doc_k 128, splade_max_postings 4096) and splade_flops_weight 1e-4
# (`tests/test_splade.py`). Cuts, each an override in the phase's YAML: 2^15
# harvested passages, 6 steps, a period every 3, `sys.mesh_shape`
# [1]. `chunk_rows` None keeps the config's fused step (no GradCache).
# `impact_tol` bounds one chunk's impacts on the card against the CPU's, both
# in bf16 activations through 12 layers.
SPLADE = dict(
    n=1 << 15, passage_words=48, stride=48, queries=2048, held_out=64, query_words=(6, 10), vocab=30522,
    max_steps=6, period=3, seed=17, max_length=200, query_k=64, doc_k=128, max_postings=4096, flops_weight=1e-4,
    chunk_rows=None, probe_rows=8, impact_tol=0.05,
    hf=dict(architectures=["BertForMaskedLM"], model_type="bert", vocab_size=30522, hidden_size=768,
            num_hidden_layers=12, num_attention_heads=12, intermediate_size=3072, max_position_embeddings=512,
            type_vocab_size=2, layer_norm_eps=1e-12, hidden_act="gelu", hidden_dropout_prob=0.1,
            attention_probs_dropout_prob=0.1, initializer_range=0.02, pad_token_id=0,
            position_embedding_type="absolute", torch_dtype="float32"),
)
# Phase 11b: a cross-encoder at cross-encoder/ms-marco-MiniLM-L-6-v2's
# architecture (`hf`: a `BertForSequenceClassification` of hidden 384, 6
# layers, 12 heads, FFN 1,536, one label; seeded random weights) re-ranks the
# top 32 of 64 held-out queries at `tokenize_pairs`' default max_length 256,
# then teaches one collated batch; MaxSim at `examples/maxsim_bench.py`'s
# defaults (1M docs x 32 tokens x 128-d int8, B = 64, Lq = 8, 256 candidates,
# k = 10).
SECOND_STAGE = dict(
    seed=19, queries=64, batch=32, top_k=32, max_length=256, maxsim_args=[],
    hf=dict(architectures=["BertForSequenceClassification"], model_type="bert", vocab_size=30522, hidden_size=384,
            num_hidden_layers=6, num_attention_heads=12, intermediate_size=1536, max_position_embeddings=512,
            type_vocab_size=2, layer_norm_eps=1e-12, hidden_act="gelu", hidden_dropout_prob=0.1,
            attention_probs_dropout_prob=0.1, initializer_range=0.02, pad_token_id=0, num_labels=1,
            position_embedding_type="absolute", torch_dtype="float32"),
)
# Phase 11c: the mutable dense store at capacity 2^20 x 768 (bf16, int8),
# filled from 2^19 rows of phase 4's corpus in 8 adds, 10% deleted, 1%
# updated, one add overflowing by 4,096 rows, compacted, searched at B = 64,
# k = 10; the embedding cache over phase 11a's 2^15 passages.
DYNAMIC = dict(capacity=1 << 20, fill=1 << 19, overflow=4096, b=64, k=10, seed=23, embed_chunk=512, hole_row=12345,
               encoder=dict(vocab_size=30522, hidden_size=768, num_layers=12, num_heads=12, intermediate_size=3072))


# Phase 12: multi-device on torch.distributed. 12a: phase 4's serving corpus
# size (2^20 x 768, seeded unit rows) as an int8 index sharded over the ranks
# of a "shard" axis (`kernel: fused`, 512 bins), B = 64 held-out queries (a
# corpus row + 0.1 noise), k = 10: first at world size 1 under NCCL in this
# process, then two ranks on the one card under gloo (NCCL refuses two ranks
# on one GPU), each holding 2^19 rows. `pad_cut`: n_real is cut to rows_per_shard - pad_cut, which puts
# every real row on rank 0 and leaves the other shards padding only.
SHARDED = dict(n=1 << 20, d=768, b=64, k=10, bins=512, seed=29, ranks=2, recall_floor=INT8_RECALL_FLOOR,
               pad_cut=1000, timeout=420)
# 12b: `configs/scifact_ranker.yaml` at its own widths (hidden 256, 4 layers,
# 4 heads, FFN 1024, max_length 200, B = 32 global, 8 sections of a prefetch
# of 100, lr 1e-4, clip 1.0) composed with `strategy/dp` and `search/sharded`
# (int8, sharded over `dp`, `kernel: fused`), over phase 9's harvest (2^15
# passages, 8,192 queries), under torchrun with two ranks on the one card
# (gloo): 6 steps with a period every 3, then a resume to step 9. The first
# step's loss is held against one process's loss of the same global batch
# within `loss_rtol` (relative). 12c runs it again under NCCL at world size
# = the cards' count when there are two or more.
MULTI_CLI = dict(CLI, held_out=0, max_length=200, max_steps=6, period=3, resume_steps=9, seed=31, ranks=2,
                 loss_rtol=1e-3, timeout=900)

# Phase 13: the sharded compressed indexes and batch-wide training over a
# data-parallel group. 13a: phase 8a's corpus cut to 2^19 x 768 unit rows
# around 4,096 centres, 64 held-out queries, k = 10, through the factory with
# `sharded: true` over a "shard" axis of every rank: msmarco_pq_realm.yaml's
# codec (`pq`: 4-bit PQ of 128 subquantizers, exhaustive ADC, int8 refine at
# 128 PCA dims, k_factor 32), the `ivf` preset, the `ivfpq` preset (its
# coarse k-means over the axis, `kmeans_sharded`), and MaxSim at
# `maxsim_bench`'s widths (2^19 docs x 32 tokens x 128-d int8, 256
# candidates a query); first at world size 1 under NCCL in this process,
# then two gloo ranks on the one card. `tol`: the score band inside which
# IVF and untruncated IVF-PQ may order ids otherwise (f32 sums of bf16 /
# int8 products: exact products, sums in one order on both sides, so 1e-4
# is loose); `recall_slack`: how far the sharded PQ and truncated IVF-PQ
# recall@10 may fall under the unsharded index's (their per-shard pools
# differ from the global pool by design); `kmeans_rtol`: how far
# `kmeans_sharded` may be from `kmeans` from the same initial rows, after one
# iteration (the Frobenius relative distance of the centroids: the segment
# sums meet in another order) and after all 10 (the relative distance of the
# k-means objective: on the card `index_add_` sums in no fixed order, so a
# row on a tie changes cells and the iterates drift apart, one process's
# from itself too; the centroids' distances are printed beside a control,
# `kmeans` run twice). Cut for phase 17: the corpus from 2^20 to 2^19 rows
# and MaxSim's documents from 1,000,000 to 2^19 (the whole script read
# 1,015.4 s before phase 17, which took 101.3 s alone, on an H100 80GB HBM3
# at 700 W).
COMPRESSED = dict(
    n=1 << 19, d=768, centres=4096, noise=0.1, decay=64.0, b=64, k=10, seed=37, ranks=2, timeout=600,
    pq=dict(codec="pq", n_subquantizers=128, code_bits=4, coarse_dim=None, refine="int8", refine_dim=128,
            k_factor=32, train_size=1_000_000),
    ivf=dict(codec="ivf", nprobe=32),
    ivfpq=IVFPQ_PRESET,
    maxsim=dict(n=1 << 19, lt=32, d=128, lq=8, n_candidates=256, n_topics=4096),
    tol=1e-4, recall_slack=0.01, kmeans_rtol=1e-4, target_recall=0.9,
)
# 13b: configs/msmarco_pq_realm.yaml at its own widths (hidden 384, 6
# layers, the 384 x 6 reader) through the CLI on two gloo ranks, with
# `strategy/dp`, `search_defaults.dense.sharded: true` over `dp` (the yaml's
# own PQ), `collate.in_batch_negatives: true` and
# `dense.autotune_target_recall: 0.9`, over phase 9's harvest and length
# (`tokenizer.max_length` 96): 6 steps, a period every 3, then a resume to
# step 9. Cut: `dataloader.batch_size` 32 -> 4. In-batch negatives make the
# reader read every (query, pooled section) pair: B x (B x D) rows, 8,192 of
# 256 tokens at B = 32 (f32 logits of 256 GB); at 4 a rank holds 2 x 32 rows.
PQ_CLI = dict(CLI, held_out=0, max_steps=6, period=3, resume_steps=9, seed=41, ranks=2, batch_size=4,
              target_recall=0.9, loss_rtol=1e-3, timeout=900)
# 13c: phase 11a's composition (scifact's body, the bert-base SPLADE encoder
# from a written checkpoint, 6 steps, a period every 3) over 2^13 passages
# (2^15 before phase 16 and 2^14 before phase 17, each cut to make room for
# the new phase: each rank's re-embeds took 12.2-12.8 s at 2^15, one
# process's 10.9 s, and 6.2-6.8 s at 2^14, on an H100 80GB HBM3 at 700 W)
# under `strategy/dp` on two gloo ranks: the FLOPS term over the global batch and
# the learned reindex split over the ranks. One process peaked at 56.0322
# GiB in 11a; a rank holds half the rows (16 queries and 128 sections), and
# the activations dominate, so about 30 GiB a rank: both fit in 80 GB at
# phase 11a's length (200).
# 15d rides this job (`gradcache_rows`): after the CLI run, two GradCache
# steps with the FLOPS term over the split batch at 100 rows a chunk (the
# global 32 queries and 256 sections: the chunks straddle the ranks and the
# query/section boundary, and the last is padded), held to one process's
# GradCache on the global batch within `loss_rtol`.
SPLADE_DP = dict(SPLADE, n=1 << 13, seed=43, ranks=2, loss_rtol=1e-3, timeout=900, gradcache_rows=100)
# Phase 14a: phase 9's inputs and YAML (`configs/msmarco_pq_realm.yaml` at
# hidden 384, 6 layers, 6 heads, intermediate 1536; flat bf16, `kernel:
# fused`, 512 bins; `tokenizer.max_length` 96) with `model: {moe_experts: 8,
# moe_top_k: 2}`: every encoder FFN a routed MoE (capacity factor 1.25, aux
# weight 1e-2). Cuts: phase 9's harvest -> 2^14 passages and 8,192 -> 2,048
# train queries, 3 steps (one period) and a resume to step 6, so that phase
# 14 fits the script's time. A fused row of 96 tokens fills ceil(2 · 96 / 8
# · 1.25) = 30 slots an expert: the dispatch of a 288-row pass is
# [288, 96, 8, 30].
MOE_CLI = dict(CLI, n=1 << 14, queries=2048, held_out=0, max_steps=3, period=3, resume_steps=6, seed=45,
               moe_experts=8, moe_top_k=2, ffn_rows=256, ffn_reps=10)
# Phase 14b: e5-large's widths (hidden 1024, 24 layers, 16 heads,
# intermediate 4096: the encoder of `arch/v5e-8-fsdp-tp`) in bf16 with
# seeded random weights, at B = 8 and T = 512, on two gloo ranks of the one
# card (NCCL refuses two ranks on one GPU); 14c the same under NCCL where
# the machine has two or more cards. Each leg is held to the same port's
# one-rank forward within JAX's dryrun tolerance (6e-2 absolute in bf16,
# `__graft_entry__.py:240`, set there at hidden 64). The bf16 tp and sp
# legs re-associate bf16 sums (split products, an f32 ring), and at this
# width they land 2-3 bf16 ulps (0.0625-0.094 where |h| >= 4) from the bf16
# forward at every depth from 4 to 24 layers, as far as the bf16 forward
# itself lands from an f32 one (0.072-0.081; an H100 80GB HBM3 at 700 W).
# So each leg also runs with f32 activations, held to the f32 forward
# within `f32_tol`; bf16 pp and ep are held to 6e-2, and bf16 tp and sp to
# the f32 forward, no farther than the bf16 forward is plus 6e-2. ep runs
# 8 experts, top-2, on [8, 512, 1024].
PARALLEL = dict(vocab=30522, hidden=1024, layers=24, heads=16, inter=4096, b=8, t=512, experts=8, top_k=2,
                pad_from=384, seed=47, ranks=2, tol=6e-2, f32_tol=1e-3, reps=2, timeout=600)
# Phase 15a: phase 14a's inputs without MoE (configs/msmarco_pq_realm.yaml at
# its widths, 2^14 harvested passages, 2,048 train queries, length 96) with
# `sys.profile_dir`: two periods of 6 steps, so that the trace window (the
# loop-local steps [3, 6), JAX's default) lies in the first period and the
# second could hold one too (the recipe traces the first period only).
PROFILED_CLI = dict(CLI, n=1 << 14, queries=2048, held_out=0, max_steps=12, period=6, seed=53, window=(3, 6),
                    top_kernels=8, top_gaps=6)
# Phase 15b: roberta-base's architecture (`hf`: its published config.json,
# written beside seeded random f32 weights in `RobertaModel`'s key layout)
# through the CLI with `configs/scifact_ranker.yaml`'s body (B = 32, 8
# sections of a prefetch of 100, length 200), `model.name_or_path` the
# checkpoint and a byte-level BPE of roberta-base's vocabulary size built
# by this script from the harvest (vocab.json + merges.txt; nothing is
# fetched). Cuts: 2^14 harvested passages, 2,048 queries, 3 steps in one
# period; `search_defaults.dense` gains `kernel: fused` (512 bins).
ROBERTA_CLI = dict(
    n=1 << 14, passage_words=48, stride=48, queries=2048, held_out=0, query_words=(6, 10), vocab=30522,
    max_steps=3, period=3, bins=512, seed=59, max_length=200,
    hf=dict(architectures=["RobertaModel"], model_type="roberta", vocab_size=50265, hidden_size=768,
            num_hidden_layers=12, num_attention_heads=12, intermediate_size=3072, max_position_embeddings=514,
            type_vocab_size=1, layer_norm_eps=1e-5, hidden_act="gelu", hidden_dropout_prob=0.1,
            attention_probs_dropout_prob=0.1, initializer_range=0.02, pad_token_id=1, bos_token_id=0,
            eos_token_id=2, position_embedding_type="absolute", torch_dtype="float32"),
)
# Phase 15c: the host tokenizers' throughput on the same 2,048 harvested
# passages (WordPiece from phase 15a's vocab.txt, the byte-level BPE of 15b,
# a Unigram of `unigram_size` pieces this script scores from the harvest's
# word counts, over XLM-R's normalizer and Metaspace), each cold (a fresh
# tokenizer: no word cache), padded to 200; then `block_topk` over a
# [64, 2^20] f32 row block on the card against `torch.topk` and against
# itself on the CPU, k = 100.
TOKENIZE = dict(texts=2048, max_length=200, unigram_size=32000, topk_rows=64, topk_width=1 << 20, topk_k=100,
                topk_block=1024, seed=61)


# Phase 16: the root examples/ scripts' ports. 16a: the two serving scripts
# at full width (D = 768 sources, pca128 int8 coarse, pca256 int8 refine,
# B = 64, bins 2048 and 4096) and 2^20 rows of depth (the msmarco cell has
# 8,841,823); `recall_floor` holds the codec sweep's rows (0.9656 each on an
# H100 80GB HBM3 at 700 W). 16b: the other 17 scripts at small sizes, each
# checked for finite numbers and its floors (`SMALL_FLOORS`); 16c:
# Precompiled tokenization on the host beside Unigram without it.
EXAMPLES = dict(
    n=1 << 20, train=65_536, latency_requests=128, latency_clients=16, window_ms=25.0, codec_blocks=9, codec_reps=3,
    recall_floor=0.93, small_n=1 << 18, small_train=65_536, flat_recall_floor=0.97, real_recall_floor=0.97,
    real_n=8192, hub=dict(hidden_size=64, num_hidden_layers=3, num_attention_heads=2, intermediate_size=128,
                          max_position_embeddings=512, type_vocab_size=2, vocab_size=30522, model_type="bert"),
    texts=2048, unigram_size=8000, seed=59,
)
# Phase 16b's recall floors per sweep row, each a few points under the recall
# the row reached at `small_n` rows on an H100 80GB HBM3 at 700 W (in
# brackets), with room for the card's k-means and training noise.
SMALL_FLOORS = dict(
    pq_codec_sweep={"int8-flat": 0.97,  # [0.9955]
                    "pq64x8-exh": 0.74,  # [0.7926]
                    "pq64x8-exh+ref16": 0.97, "pq64x8-exh+ref32": 0.97,  # [0.9959, 0.9961]
                    "pq64-exh+ref32-d128": 0.87, "pq32-exh+ref32-d128": 0.87},  # [0.9113, 0.9113]
    pq_geometry_sweep={"pq16+pca128:exh+ref": 0.77, "pq32+pca128:exh+ref": 0.90},  # [0.8188, 0.9391]
    pq_decode_variants_bench={"bf16-oh": 0.57, "i8-oh/bf16-scan": 0.57, "i8-oh/i8-scan": 0.57},  # [0.6125 each]
    pq4_adc_variants_bench={"prod": 0.97, "blockdiag": 0.97, "direct": 0.97},  # pool recall [1.0 each]
    pq4_fastscan_bench={"pq64x8-i8": 0.57, "pq128x4-i8": 0.54, "pq128x4-g8": 0.54,  # ADC [0.6125, 0.5813,
                        "pq128x4-lutmm": 0.54},  # 0.5813, 0.5844]; the pool of 160 holds >= 0.96 [0.9938-1.0]
    pq_8m8_bench={"pq64:exh-onehot": 0.57, "pq64+pca128:dual0.3": 0.84,  # [0.6125, 0.8875]
                  "pq64+pca128:dual0.5": 0.77, "pq64+pca128:exh": 0.57,  # [0.8141, 0.6125]
                  "pq64+pca128:exh+ref8": 0.93, "pq64+pca128:exh+ref": 0.93, "int8-flat": 0.96},  # [0.9656,
    # 0.9719, 0.9906]
    ivfpq_8m_bench={16: 0.83, 64: 0.93},  # by nprobe [0.8734, 0.9625]
    ivfpq_crossover_bench={"serving-direct": 0.93, "ivfpq-soar-np16": 0.83, "ivfpq-soar-np64": 0.92},  # [0.9656,
    # 0.8719, 0.9609]
    real_embedding_eval=0.6,  # every other recall key [0.6574-0.9959]
)


# Phase 17: the last two root scripts' ports. 17a: `real_text_1m_bench` at
# its widths (dim 384, the 4 x 256 encoder, batch 512, 300 steps, 2,048
# queries) over 2^18 harvested passages (its default is 2^20, run by hand:
# the harvest, vocabulary and encode of 2^20 take about 70 s of host time),
# in a fresh cache directory so that the encoder trains and embeds; each
# codec's recall@10 at least its `recall_floors` entry, a few points under
# the recall it reached in its first run (in brackets; 262,144 passages of
# the card machine's site-packages, fingerprint b811966c..., on an H100 80GB
# HBM3 at 700 W). 17b:
# `hybrid_sharded_bench` at the JAX script's full size (100,000 x 256,
# 30,000 terms, B = 256) on two gloo ranks of the card.
REALTEXT = dict(n=1 << 18, recall_floors={"int8": 0.97,  # [0.9903]
                                          "pq96x4fs+ref": 0.93, "serving-direct": 0.92})  # [0.9517, 0.9486]


def _rows_at_least(rows: list, label: str, key: str, floors: dict) -> bool:
    """Every row has a floor under its `label` and reaches it in `key`."""
    return all(r[label] in floors and r[key] >= floors[r[label]] for r in rows)


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


def harvest_beir(root: Path, t: dict) -> dict:
    """A BeIR-format directory of t["n"] harvested passages and generated
    literal-span queries under `root`, and a vocab directory (phases 9 and
    10). Returns the paths, the held-out queries (text, gold passage id) and
    the harvest's numbers."""
    import collections
    import re
    import sysconfig

    import numpy as np

    from vod_tpu_torch.data.loaders import local_text

    files = [0]
    real_iter = local_text._iter_files

    def counting_iter(*args, **kw):
        for path in real_iter(*args, **kw):
            files[0] += 1
            yield path

    local_text._iter_files = counting_iter
    try:
        t0 = time.perf_counter()
        rows = local_text.harvest_text_passages(
            t["n"], roots=[sysconfig.get_paths()["purelib"]], passage_words=t["passage_words"], stride=t["stride"],
        )
        harvest_s = time.perf_counter() - t0
    finally:
        local_text._iter_files = real_iter
    check(len(rows) == t["n"] and len({r["id"] for r in rows}) == t["n"],
          f"harvested {len(rows)} passages with distinct ids, not {t['n']}")

    rng = np.random.default_rng(t["seed"])
    lo, hi = t["query_words"]
    queries = []
    for j, i in enumerate(rng.choice(t["n"], size=t["queries"] + t["held_out"], replace=False).tolist()):
        words = rows[i]["content"].split(" ")
        length = int(rng.integers(lo, hi + 1))
        start = int(rng.integers(0, len(words) - length + 1))
        queries.append((f"q{j}", " ".join(words[start : start + length]), rows[i]["id"]))
    train, held = queries[: t["queries"]], queries[t["queries"]:]

    beir = root / "beir"
    (beir / "qrels").mkdir(parents=True)
    with open(beir / "corpus.jsonl", "w") as f:
        f.writelines(json.dumps({"_id": r["id"], "title": r["title"], "text": r["content"]}) + "\n" for r in rows)
    with open(beir / "queries.jsonl", "w") as f:
        f.writelines(json.dumps({"_id": qid, "text": text}) + "\n" for qid, text, _ in train)
    with open(beir / "qrels" / "train.tsv", "w") as f:
        f.write("query-id\tcorpus-id\tscore\n")
        f.writelines(f"{qid}\t{gold}\t1\n" for qid, _, gold in train)

    # vocab.txt: every word decomposes into the single characters, and the
    # most frequent lower-cased words (as the tokenizer splits them) are whole
    chars = "abcdefghijklmnopqrstuvwxyz0123456789"
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", *chars, *("##" + c for c in chars),
             *"!\"#$%&'()*+,-./:;<=>?@[\\]^_`{|}~"]
    counts: collections.Counter = collections.Counter()
    word = re.compile(r"[a-z0-9]+")
    for r in rows:
        counts.update(word.findall(f"{r['title']} {r['content']}".lower()))
    seen = set(vocab)
    for w, _ in counts.most_common():
        if len(vocab) >= t["vocab"]:
            break
        if w not in seen:
            seen.add(w)
            vocab.append(w)
    # a small corpus has fewer distinct words: BERT's own filler entries fill the rest
    vocab += [f"[unused{i}]" for i in range(t["vocab"] - len(vocab))]
    vocab_dir = root / "vocab"
    vocab_dir.mkdir()
    (vocab_dir / "vocab.txt").write_text("\n".join(vocab) + "\n")
    check(len(vocab) == t["vocab"], f"vocab.txt has {len(vocab)} entries, not {t['vocab']}")
    return dict(beir=beir, vocab_dir=vocab_dir, held=held, harvest_s=harvest_s, files=files[0])


def cli_inputs(root: Path, t: dict) -> dict:
    """Phase 9's inputs under `root` (module constant CLI): `harvest_beir`'s
    directories and the YAML. Returns the paths, the held-out queries (text,
    gold passage id), the expected overrides and the harvest's numbers."""
    h = harvest_beir(root, t)
    beir, vocab_dir = h["beir"], h["vocab_dir"]
    run = root / "run"
    base = ROOT / "configs" / "msmarco_pq_realm.yaml"
    datasets = {
        "queries": [{"identifier": "harvest-train", "name_or_path": "beir", "subsets": [str(beir)], "split": "train",
                     "link": "harvest-corpus"}],
        "sections": [{"identifier": "harvest-corpus", "name_or_path": "beir", "subsets": [str(beir)]}],
    }
    dense = dict(codec="flat", dtype="bfloat16", kernel="fused", fused_bins=t["bins"])
    trainer = dict(max_steps=t["max_steps"], period=t["period"], log_interval=1, checkpoint_path=str(run))
    yaml_path = root / "exp.yaml"
    yaml_path.write_text(
        f"extends: ['{base}']\n"
        "datasets:\n"
        "  queries:\n"
        f"    - {{identifier: harvest-train, name_or_path: beir, subsets: ['{beir}'], split: train, "
        "link: harvest-corpus}\n"
        "  sections:\n"
        f"    - {{identifier: harvest-corpus, name_or_path: beir, subsets: ['{beir}']}}\n"
        f"tokenizer: {{name_or_path: '{vocab_dir}', max_length: {t['max_length']}}}\n"
        "search_defaults:\n"
        f"  dense: {{codec: flat, dtype: bfloat16, kernel: fused, fused_bins: {t['bins']}}}\n"
        f"trainer: {{max_steps: {t['max_steps']}, period: {t['period']}, log_interval: 1, checkpoint_path: '{run}'}}\n"
        "sys: {mesh_shape: [1]}\n"
    )
    return dict(yaml=yaml_path, run=run, base=base, held=h["held"], harvest_s=h["harvest_s"], files=h["files"],
                overrides=dict(datasets=datasets, dense=dense, trainer=trainer, sys={"mesh_shape": [1]},
                               tokenizer={"name_or_path": str(vocab_dir), "max_length": t["max_length"]}))


def cli_phase(dev, card: str, hbm: float, peak_bf16: float, t: dict) -> dict:
    """Phase 9: the experiment CLI on the card (module constant CLI), in
    process through `vod_tpu_torch.exps.cli.main`, the function `python -m
    vod_tpu_torch.exps.cli` runs: `main(["--config", yaml])` (2 periods of 3
    optimizer steps, each period re-embedding the 2^15 sections), then
    `main(["--resume_from", run, "--max_steps", "9"])` (one more period).
    Each `main` is a main path of its own: launch counts are zeroed just
    before it and read just after. The runner's stages are timed by
    wrapping the functions it calls (restored after). Returns the numbers."""
    import tempfile

    import numpy as np
    import torch

    import vod_tpu_torch.native as native
    from vod_tpu_torch.data.tokenizer import WordPieceTokenizer
    from vod_tpu_torch.dataloaders import prefetch
    from vod_tpu_torch.exps import cli, recipes
    from vod_tpu_torch.exps.structconf import DatasetsConfig, Experiment
    from vod_tpu_torch.ops.mips import _binned_body, fused_mips_binned, fused_mips_binned_reference
    from vod_tpu_torch.runtime.train import RealmTrainStep
    from vod_tpu_torch.search import SearchQueries, factory, sparse_search
    from vod_tpu_torch.search import dense as dense_mod

    started = time.perf_counter()
    tmp = tempfile.TemporaryDirectory()
    root = Path(tmp.name)
    inputs = cli_inputs(root, t)
    log(f"9 inputs: {t['n']} passages of <= {t['passage_words']} words harvested from {inputs['files']} files in "
        f"{inputs['harvest_s']:.2f} s; {t['queries']} train queries and {t['held_out']} held out of "
        f"{t['query_words'][0]}-{t['query_words'][1]} words; vocab.txt of {t['vocab']} entries; "
        f"{time.perf_counter() - started:.2f} s in all")

    # the parsed config: the yaml with exactly these overrides
    exp = Experiment.from_file(str(inputs["yaml"]))
    want = Experiment.from_file(str(inputs["base"])).to_dict()
    o = inputs["overrides"]
    want["datasets"] = DatasetsConfig.parse(o["datasets"]).to_dict()
    want["tokenizer"].update(o["tokenizer"])
    want["search_defaults"]["dense"].update(o["dense"])
    want["trainer"].update(o["trainer"])
    want["sys"].update(o["sys"])
    check(exp.to_dict() == want, "the parsed Experiment is not the yaml with the phase's overrides")
    m, tr, col = exp.model, exp.trainer, exp.collate
    check((m.kind, m.gradients, m.vod_alpha, m.hidden_size, m.num_layers, m.num_heads, m.intermediate_size,
           m.lm_hidden_size, m.lm_num_layers, m.vocab_size) == ("realm", "vod", 0.5, 384, 6, 6, 1536, 384, 6, 30522)
          and (exp.dataloader.batch_size, tr.accumulate_grad_batches, col.prefetch_n_sections, col.n_sections,
               tr.gradient_clip_val, tr.learning_rate, exp.search_defaults.sparse.max_postings)
          == (32, 2, 100, 8, 1.0, 5e-5, 4096) and exp.tokenizer.max_length == t["max_length"],
          "the parsed Experiment lost a width of configs/msmarco_pq_realm.yaml")

    # instrumentation: each wrapper records and calls the real function
    rec: dict = dict(logs=[], steps=[], waits=[], loops=[], builds=[], tok=[], ana=[], loaders=[], call=None)
    real = dict(
        run=cli.run_experiment, tokenize_corpus=cli.tokenize_corpus, corpus=cli.build_device_corpus,
        loader=cli.RealmDataloader, tok=WordPieceTokenizer.__call__, ana=native.analyze_texts,
        sparse=factory.build_sparse_from_config, dense=recipes.build_dense_from_config,
        loop=recipes.training_loop, prefetch=prefetch.prefetch_iterator, step=RealmTrainStep.train_step_accum,
        kernel=dense_mod.fused_mips_binned,
    )

    def run_experiment(exp_, *, on_log=None, **kw):
        def both(step, metrics):
            rec["logs"].append((step, dict(metrics)))
            on_log(step, metrics)

        return real["run"](exp_, on_log=both, **kw)

    def tokenize_corpus(*args, **kw):
        rec["enc"] = real["tokenize_corpus"](*args, **kw)
        return rec["enc"]

    def build_device_corpus(*args, **kw):
        rec["corpus"] = real["corpus"](*args, **kw)
        return rec["corpus"]

    def realm_dataloader(*args, **kw):
        rec["loaders"].append(real["loader"](*args, **kw))
        return rec["loaders"][-1]

    def tok_call(self, text, **kw):
        t0 = time.perf_counter()
        out = real["tok"](self, text, **kw)
        if not isinstance(text, str) and len(text) > 1000:
            rec["tok"].append((len(text), time.perf_counter() - t0))
        return out

    def analyze(texts, **kw):
        t0 = time.perf_counter()
        out = real["ana"](texts, **kw)
        if len(texts) > 1000:
            rec["ana"].append((len(texts), time.perf_counter() - t0))
        return out

    def build_sparse(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rec["sparse"] = real["sparse"](*args, **kw)
        torch.cuda.synchronize()
        rec["sparse_ms"] = (time.perf_counter() - t0) * 1e3
        return rec["sparse"]

    def build_dense(cfg, emb, **kw):
        index = real["dense"](cfg, emb, **kw)
        rec["builds"].append(index.vectors[:4096].float().cpu())
        return index

    def loop(**kw):
        rec["engines"], rec["generator"] = kw["engines"], kw["generator"]
        t0 = time.perf_counter()
        out = real["loop"](**kw)
        rec["loops"].append(time.perf_counter() - t0)
        return out

    def timed_prefetch(it, size=2):
        inner = real["prefetch"](it, size)
        waits = []
        rec["waits"].append(waits)
        while True:
            t0 = time.perf_counter()
            try:
                item = next(inner)
            except StopIteration:
                return
            waits.append(time.perf_counter() - t0)
            yield item

    def step(self, engines, corpus, micro, generator, weights, **kw):
        events = [torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)]
        before = dict(fused_mips_binned.body_launches)
        events[0].record()
        out = real["step"](self, engines, corpus, micro, generator, weights, **kw)
        events[1].record()
        rec["steps"].append((events, {k: v - before[k] for k, v in fused_mips_binned.body_launches.items()},
                             int(micro[0].input_ids.shape[0])))
        return out

    def kernel(vectors, queries, **kw):
        if rec["call"] is None:
            rec["call"] = (vectors, queries.detach().clone(), dict(kw))
        return real["kernel"](vectors, queries, **kw)

    patches = [
        (cli, "run_experiment", run_experiment), (cli, "tokenize_corpus", tokenize_corpus),
        (cli, "build_device_corpus", build_device_corpus), (cli, "RealmDataloader", realm_dataloader),
        (WordPieceTokenizer, "__call__", tok_call), (native, "analyze_texts", analyze),
        (factory, "build_sparse_from_config", build_sparse), (recipes, "build_dense_from_config", build_dense),
        (recipes, "training_loop", loop), (prefetch, "prefetch_iterator", timed_prefetch),
        (RealmTrainStep, "train_step_accum", step), (dense_mod, "fused_mips_binned", kernel),
    ]
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
    for obj, name, fn in patches:
        setattr(obj, name, fn)
    try:
        # run 1: the config file, 2 periods of 3 steps (main path)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        fused_mips_binned.launches = 0
        fused_mips_binned.body_launches.update(wgmma=0, fma=0)  # main path starts
        t_run = time.perf_counter()
        out1 = cli.main(["--config", str(inputs["yaml"])])
        torch.cuda.synchronize()
        launches1, bodies1 = fused_mips_binned.launches, dict(fused_mips_binned.body_launches)  # main path ends
        run1_s = time.perf_counter() - t_run
        peak1 = torch.cuda.max_memory_allocated(dev)
        logs1, steps1, waits1, loops1 = rec["logs"], rec["steps"], rec["waits"], rec["loops"]
        hist1, state1 = out1["history"], out1["state"]
        enc, sparse_ix, call, builds = rec["enc"], rec["sparse"], rec["call"], rec["builds"]
        tok_rate = [n / s for n, s in rec["tok"]]
        ana_rate = [n / s for n, s in rec["ana"]]
        sparse_ms = rec["sparse_ms"]
        saved_cfg = json.loads((inputs["run"] / "config.json").read_text())
        del out1
        rec.update(logs=[], steps=[], waits=[], loops=[], builds=[], tok=[], ana=[], loaders=[], engines=None,
                   corpus=None, enc=None, sparse=None)

        # run 2: resume from the run directory to step 9 (main path)
        torch.cuda.synchronize()
        fused_mips_binned.launches = 0
        fused_mips_binned.body_launches.update(wgmma=0, fma=0)  # main path starts
        t_run = time.perf_counter()
        out2 = cli.main(["--resume_from", str(inputs["run"]), "--max_steps", str(t["resume_steps"])])
        torch.cuda.synchronize()
        launches2, bodies2 = fused_mips_binned.launches, dict(fused_mips_binned.body_launches)  # main path ends
        run2_s = time.perf_counter() - t_run
        peak = torch.cuda.max_memory_allocated(dev)
    finally:
        for obj, name, fn in saved:
            setattr(obj, name, fn)

    # run 1: the corpus, the logs, the launches, the index
    ids = enc["input_ids"]
    inner = ids > 3  # neither [PAD] [UNK] [CLS] nor [SEP]
    check(bool((inner.any(1)).all()), "a tokenized section is all [UNK]")
    unk_share = float((ids == 1).sum() / max(1, int((ids > 3).sum() + (ids == 1).sum())))
    truncated = float((enc["attention_mask"].sum(1) == t["max_length"]).mean())
    mean_tokens = float(enc["attention_mask"].sum(1).mean())
    check(state1.step == t["max_steps"] and [h["period"] for h in hist1] == [0, 1],
          f"run 1 ended at step {state1.step}, periods {[h['period'] for h in hist1]}")
    check([s for s, _ in logs1] == list(range(1, t["max_steps"] + 1)), f"run 1 logged steps {[s for s, _ in logs1]}")
    dense_sched = exp.trainer.parameters["dense"].instantiate()
    for s, metrics in logs1:
        check(math.isfinite(metrics["loss"]) and math.isfinite(metrics["grad_norm"]), f"step {s}: loss not finite")
        check(metrics["parameters/dense"] == dense_sched(s - 1) and metrics["parameters/sparse"] == 1.0,
              f"step {s}: logged weights {metrics['parameters/dense']}, {metrics['parameters/sparse']} are not the "
              "yaml's schedules")
    check(len(builds) == 2 and not torch.equal(builds[0], builds[1]), "period 1's index equals period 0's")
    check(bodies1 == {"wgmma": 2 * t["max_steps"], "fma": 0} and launches1 == 2 * t["max_steps"],
          f"run 1 launched fused_mips_binned {launches1} times, by body {bodies1}, not twice a step on wgmma")
    check(all(b == {"wgmma": 2, "fma": 0} for _, b, _ in steps1), "an optimizer step did not launch twice on wgmma")

    # one CLI-loop call (the first micro-batch's) against the plain version
    vv, q, kw = call
    b, d = q.shape
    k, bins, n_real = kw["k"], kw["bins"], kw["n_real"]
    check((b, d, vv.shape[0], bins, k) == (32, 384, t["n"], t["bins"], 100),
          f"the CLI-loop call is B={b} D={d} N={vv.shape[0]} bins={bins} k={k}")
    body = _binned_body(vv.dtype, d, bins, (vv.data_ptr(), q.data_ptr()))
    check(body == "wgmma", f"the CLI-loop call takes the {body} body")
    ks, ki = fused_mips_binned(vv, q, **kw)
    rs, ri = fused_mips_binned_reference(vv, q, **kw)
    tol = 2 * d * 2.0**-24 * q.float().norm(dim=-1).max().item() * vv.float().norm(dim=-1).max().item()
    err, swaps = check_against_plain(f"CLI-loop binned B={b} D={d}", ks, ki, rs, ri, q, vv, tol)
    ms = time_ms(lambda: fused_mips_binned(vv, q, **kw), 20)
    plain_ms = time_ms(lambda: fused_mips_binned_reference(vv, q, **kw), 2)
    library_ms = time_ms(lambda: torch.topk(q @ vv[:n_real].T, k, dim=-1), 20)
    nbytes, ops = (n_real + b) * d * 2 + b * k * 8, 2 * b * n_real * d
    bound = max(nbytes / hbm, ops / peak_bf16) * 1e3
    bound_by = "bytes" if nbytes / hbm >= ops / peak_bf16 else "operations"
    log(f"check CLI-loop binned bf16 B={b} D={d} N={n_real} bins={bins} k={k} ({body}): max |kernel - plain| = "
        f"{err:.3g} (tol {tol:.3g}), {swaps} id swaps inside the band; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"library {library_ms:.4f} ms, bound {bound:.4f} ms ({bound_by}) [{card}]")
    del call, vv, q, ks, ki, rs, ri

    # BM25 over the held-out queries: their gold passage in the top 100
    held_terms, _ = native.analyze_texts([text for _, text, _ in inputs["held"]], vocab_size=1 << 18, max_terms=32)
    gold = torch.tensor([enc["id_map"][g] for _, _, g in inputs["held"]], device=dev)
    top100 = sparse_search(sparse_ix, SearchQueries(terms=torch.as_tensor(held_terms, device=dev)), 100).indices
    bm25_recall = (top100 == gold[:, None]).any(-1).float().mean().item()
    log(f"9 BM25: the gold passage in the top 100 for {bm25_recall:.4f} of {len(gold)} held-out queries "
        f"(floor {t['bm25_recall_floor']})")
    check(bm25_recall >= t["bm25_recall_floor"], f"BM25 recall@100 {bm25_recall:.4f} < {t['bm25_recall_floor']}")
    del sparse_ix, top100, enc

    # run 2: resumed at step 6, ended at 9, one period
    state2, hist2, logs2, steps2 = out2["state"], out2["history"], rec["logs"], rec["steps"]
    waits2, loops2 = rec["waits"], rec["loops"]
    last_ckpt = inputs["run"] / f"period-{t['max_steps'] // t['period'] - 1}"
    saved_state = json.loads((last_ckpt / "trainer_state.json").read_text())
    check(saved_state["step"] == t["max_steps"], f"the checkpoint holds step {saved_state['step']}")
    check(state2.step == t["resume_steps"] and [h["period"] for h in hist2] == [t["max_steps"] // t["period"]]
          and [s for s, _ in logs2] == list(range(t["max_steps"] + 1, t["resume_steps"] + 1)),
          f"the resume logged steps {[s for s, _ in logs2]} and ended at {state2.step}")
    check(all(math.isfinite(mm["loss"]) for _, mm in logs2), "a resumed loss is not finite")
    check(bodies2 == {"wgmma": 2 * len(logs2), "fma": 0} and launches2 == 2 * len(logs2),
          f"run 2 launched fused_mips_binned {launches2} times, by body {bodies2}")
    check(saved_cfg == json.loads(json.dumps(want)), "run 1's config.json is not the parsed Experiment")
    resumed_cfg = json.loads((inputs["run"] / "config.json").read_text())
    want["trainer"]["max_steps"] = t["resume_steps"]
    check(resumed_cfg == json.loads(json.dumps(want)), "the resume's config.json is not run 1's with max_steps 9")
    resumed_batch = rec["loaders"][0].config.batch_size

    # one optimizer step, its dataloader batches included, with every
    # synchronizing CUDA call made an error
    step_fn, loader = out2["step_fn"], rec["loaders"][0]
    weights = state2.get_parameters()
    batches = loader.epoch(seed=12345)
    step_fn.train_step_accum(rec["engines"], rec["corpus"], [next(batches), next(batches)], rec["generator"], weights)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        micro = [next(batches), next(batches)]
        step_fn.train_step_accum(rec["engines"], rec["corpus"], micro, rec["generator"], weights)
        enqueue_ms = (time.perf_counter() - t0) * 1e3
    except RuntimeError as exc:
        fail(f"the CLI's step or its dataloader waits for the card: {exc}")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    finish_ms = (time.perf_counter() - t0) * 1e3
    del out2, step_fn, loader, rec, micro, batches
    gc.collect()
    torch.cuda.empty_cache()
    tmp.cleanup()

    def period_numbers(hist, steps, waits, loops):
        out = []
        for p, h in enumerate(hist):
            ms_ = [s_.elapsed_time(e_) for (s_, e_), _, _ in steps[p * t["period"] : (p + 1) * t["period"]]]
            out.append(dict(
                period=h["period"], reembed_s=h["reembed_s"], build_ms=h["build_ms"]["total_ms"], step_ms=ms_,
                median_step_ms=statistics.median(ms_), loop_s=loops[p], first_wait_s=waits[p][0],
                loader_wait_share=sum(waits[p]) / loops[p], steady_wait_share=sum(waits[p][1:]) / loops[p],
            ))
        return out

    periods = period_numbers(hist1, steps1, waits1, loops1) + period_numbers(hist2, steps2, waits2, loops2)
    wall = time.perf_counter() - started
    result = dict(
        harvest_s=inputs["harvest_s"], harvest_files=inputs["files"], tokenizer_sections_per_s=tok_rate,
        analyzer_sections_per_s=ana_rate, unk_share=unk_share, truncated_share=truncated, mean_tokens=mean_tokens,
        bm25_build_ms=sparse_ms, bm25_recall_at_100=bm25_recall,
        run1_s=run1_s, run2_s=run2_s, periods=periods, peak_mem_bytes=peak, run1_peak_mem_bytes=peak1,
        losses=[mm["loss"] for _, mm in logs1 + logs2], resumed_batch=resumed_batch,
        launches=launches1, body_launches=bodies1, resume_launches=launches2, resume_body_launches=bodies2,
        max_abs_err=err, call=dict(shape=f"bfloat16 B={b} N={n_real} D={d} bins={bins} k={k}", ms=ms,
                                   plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound, bound_by=bound_by),
        sync_free_step=dict(enqueue_ms=enqueue_ms, finish_ms=finish_ms), wall_s=wall,
    )
    log(f"9 host stages [{card}]: harvest {inputs['harvest_s']:.2f} s; tokenizer "
        f"{', '.join(f'{r:.1f}' for r in tok_rate)} sections/s (the corpus in each run); analyzer "
        f"{', '.join(f'{r:.1f}' for r in ana_rate)} sections/s; [UNK] share {unk_share:.6f}; sections of "
        f"{mean_tokens:.2f} tokens on average, {truncated:.4f} of them cut at {t['max_length']}; BM25 build "
        f"{sparse_ms:.1f} ms")
    for p in periods:
        log(f"9 period {p['period']} [{card}]: re-embed {p['reembed_s']:.2f} s, index build {p['build_ms']:.2f} ms, "
            f"steps {json.dumps([round(x, 4) for x in p['step_ms']])} ms (median {p['median_step_ms']:.4f}), "
            f"dataloader wait {p['loader_wait_share']:.4f} of the loop's {p['loop_s']:.2f} s "
            f"({p['steady_wait_share']:.4f} after the first batch's {p['first_wait_s']:.3f} s)")
    log(f"9 runs [{card}]: run 1 {run1_s:.2f} s ({launches1} fused_mips_binned launches, by body {bodies1}); resume "
        f"{run2_s:.2f} s ({launches2}, by body {bodies2}; loader batch {resumed_batch}: config.json names "
        f"trainer.batch_size's fields, so per_device drives the loader, as in JAX); losses "
        f"{json.dumps([round(x, 6) for x in result['losses']])}; peak memory {peak / 2**30:.4f} GiB")
    log(f"9 step without a sync [{card}]: two dataloader batches and one optimizer step enqueued in "
        f"{enqueue_ms:.2f} ms, finished {finish_ms:.2f} ms after the start")
    log(f"phase 9 wall time: {wall:.1f} s")
    return result


def write_hf_checkpoint(directory: Path, t: dict, dev, head: str = "") -> dict:
    """A checkpoint directory: `config.json` with t["hf"] and
    `model.safetensors` of seeded random f32 weights drawn on the card,
    written by the port's own writer. `head` picks the key layout:
    "" is `BertModel`'s (phase 10: e5-large-v2), "mlm" `BertForMaskedLM`'s
    (`bert.*` without a pooler, and `cls.predictions.*`), "classifier"
    `BertForSequenceClassification`'s (`bert.*` with the pooler, and
    `classifier.*`), "roberta" `RobertaModel`'s (`roberta.*` with the
    pooler; phase 15b). Returns CPU copies of the tensors the load checks
    read, under their `BertModel` names (and the heads' own)."""
    import torch

    from vod_tpu_torch.models.hf_import import write_safetensors

    hf = t["hf"]
    h, inter = hf["hidden_size"], hf["intermediate_size"]
    g = torch.Generator(device=dev).manual_seed(t["seed"])
    prefix = {"": "", "roberta": "roberta."}.get(head, "bert.")

    def rnd(*shape, mean: float = 0.0):
        return (mean + 0.02 * torch.randn(shape, generator=g, device=dev)).cpu()

    tensors = {
        "embeddings.word_embeddings.weight": rnd(hf["vocab_size"], h),
        "embeddings.position_embeddings.weight": rnd(hf["max_position_embeddings"], h),
        "embeddings.token_type_embeddings.weight": rnd(hf["type_vocab_size"], h),
        "embeddings.LayerNorm.weight": rnd(h, mean=1.0),
        "embeddings.LayerNorm.bias": rnd(h),
    }
    for i in range(hf["num_hidden_layers"]):
        p = f"encoder.layer.{i}."
        for name, (out_f, in_f) in (("attention.self.query", (h, h)), ("attention.self.key", (h, h)),
                                    ("attention.self.value", (h, h)), ("attention.output.dense", (h, h)),
                                    ("intermediate.dense", (inter, h)), ("output.dense", (h, inter))):
            tensors[p + name + ".weight"] = rnd(out_f, in_f)
            tensors[p + name + ".bias"] = rnd(out_f)
        for name in ("attention.output.LayerNorm", "output.LayerNorm"):
            tensors[p + name + ".weight"] = rnd(h, mean=1.0)
            tensors[p + name + ".bias"] = rnd(h)
    if head != "mlm":
        tensors["pooler.dense.weight"] = rnd(h, h)
        tensors["pooler.dense.bias"] = rnd(h)
    tensors = {prefix + k: v for k, v in tensors.items()}
    if head == "mlm":
        tensors.update({
            "cls.predictions.transform.dense.weight": rnd(h, h), "cls.predictions.transform.dense.bias": rnd(h),
            "cls.predictions.transform.LayerNorm.weight": rnd(h, mean=1.0),
            "cls.predictions.transform.LayerNorm.bias": rnd(h), "cls.predictions.bias": rnd(hf["vocab_size"]),
        })
    elif head == "classifier":
        tensors.update({"classifier.weight": rnd(hf.get("num_labels", 1), h),
                        "classifier.bias": rnd(hf.get("num_labels", 1))})
    directory.mkdir(parents=True)
    (directory / "config.json").write_text(json.dumps(hf, indent=2))
    write_safetensors(directory / "model.safetensors", tensors)
    last = hf["num_hidden_layers"] - 1
    keep = ("embeddings.word_embeddings.weight", "encoder.layer.0.attention.output.LayerNorm.weight",
            f"encoder.layer.{last}.attention.self.query.weight", f"encoder.layer.{last}.attention.self.query.bias",
            "encoder.layer.1.intermediate.dense.bias", "encoder.layer.2.output.dense.weight")
    out = {k: tensors[prefix + k] for k in keep}
    out.update({k: v for k, v in tensors.items() if k.startswith(("cls.", "classifier."))})
    return out


def large_cli_phase(dev, card: str, hbm: float, peak_bf16: float, t: dict) -> dict:
    """Phase 10: the large-encoder training path of the experiment CLI
    (module constant LARGE), in process through `vod_tpu_torch.exps.cli.main`
    as phase 9: e5-large's widths loaded from a local HF checkpoint that the
    phase writes, LoRA over an int8-frozen base with remat, GradCache,
    Adafactor, live dense ∥ BM25 retrieval whose dense side runs
    `fused_mips_binned` at D = 1024, and a re-embed through the kbit view
    each period. `main` is its main path: launch counts are zeroed just
    before it and read just after. Returns the numbers."""
    import tempfile

    import torch

    from vod_tpu_torch.exps import cli, recipes
    from vod_tpu_torch.exps.structconf import Experiment
    from vod_tpu_torch.models import QuantizedLeaf, flax_layout, kbit_memory_bytes, kbit_params, quantize_leaf
    from vod_tpu_torch.ops.mips import _binned_body, fused_mips_binned, fused_mips_binned_reference
    from vod_tpu_torch.runtime import Adafactor, gradcache_backward
    from vod_tpu_torch.runtime.train import RealmTrainStep
    from vod_tpu_torch.search import dense as dense_mod

    started = time.perf_counter()
    tmp = tempfile.TemporaryDirectory()
    root = Path(tmp.name)
    h = harvest_beir(root, t)
    t0 = time.perf_counter()
    written = write_hf_checkpoint(root / "e5-large", t, dev)
    ckpt_s = time.perf_counter() - t0
    ckpt_bytes = (root / "e5-large" / "model.safetensors").stat().st_size
    hf = t["hf"]
    model_over = "".join(f", {k}: {v}" for k, v in t["model_overrides"].items())
    yaml_path = root / "exp.yaml"
    yaml_path.write_text(
        f"extends: ['{ROOT / 'configs' / 'scifact_ranker.yaml'}', arch/v5e-1-large-qlora, optimizer/adafactor]\n"
        f"model: {{name_or_path: '{root / 'e5-large'}'{model_over}}}\n"
        f"tokenizer: {{name_or_path: '{h['vocab_dir']}'}}\n"
        "search_defaults:\n"
        f"  dense: {{codec: flat, dtype: bfloat16, kernel: fused, fused_bins: {t['bins']}}}\n"
        f"trainer: {{max_steps: {t['max_steps']}, period: {t['period']}, log_interval: 1}}\n"
        "datasets:\n"
        "  queries:\n"
        f"    - {{identifier: harvest-train, name_or_path: beir, subsets: ['{h['beir']}'], split: train, "
        "link: harvest-corpus}\n"
        "  sections:\n"
        f"    - {{identifier: harvest-corpus, name_or_path: beir, subsets: ['{h['beir']}']}}\n"
    )
    log(f"10 inputs: {t['n']} passages harvested from {h['files']} files in {h['harvest_s']:.2f} s; a checkpoint of "
        f"{ckpt_bytes / 1e9:.3f} GB (e5-large-v2's config.json, seeded random f32 weights) written in {ckpt_s:.2f} s")

    # the parsed config: scifact's body under the qlora and adafactor presets
    exp = Experiment.from_file(str(yaml_path))
    m, tr, col = exp.model, exp.trainer, exp.collate
    check((m.kind, m.gradients, m.agg_method, m.output_norm, m.scaler, m.learn_scaler) ==
          ("ranker", "retrieval", "mean", "l2", 10.0, True)
          and (m.hidden_size, m.num_layers, m.num_heads, m.intermediate_size, m.vocab_size) ==
          (hf["hidden_size"], hf["num_hidden_layers"], hf["num_attention_heads"], hf["intermediate_size"],
           hf["vocab_size"])
          and (m.lora_rank, m.lora_alpha, m.kbit, m.remat, m.hf_fallback) == (t["lora_rank"], 16.0, True, True, "error")
          and (tr.optimizer, tr.gradcache_chunk_rows, tr.batch_size.effective, tr.batch_size.per_device,
               tr.learning_rate, tr.gradient_clip_val) == ("adafactor", t["chunk_rows"], 32, t["micro_batch"], 1e-4, 1.0)
          and (col.prefetch_n_sections, col.n_sections, col.max_pos_sections) == (100, 8, 2)
          and exp.tokenizer.max_length == t["max_length"] and exp.search_defaults.sparse.max_postings == 2048
          and exp.search_defaults.dense.kernel == "fused",
          "the parsed Experiment is not scifact_ranker under the qlora and adafactor presets")

    # step 0: the LoRA encoder, loaded, encodes as the same checkpoint loaded
    # into an encoder without adapters; both hold the written tensors
    gi = torch.Generator(device=dev).manual_seed(t["seed"])
    ids = torch.randint(1000, hf["vocab_size"], (t["probe_rows"], t["max_length"]), generator=gi, device=dev)
    mask = (torch.arange(t["max_length"], device=dev)[None]
            < torch.randint(16, t["max_length"] + 1, (t["probe_rows"], 1), generator=gi, device=dev)).to(torch.int32)
    pooled = {}
    for name, mcfg in (("lora", m), ("plain", m.replace(lora_rank=0, kbit=False))):
        model = cli._maybe_port_hf_encoder(
            cli.build_model(mcfg, device=dev, generator=torch.Generator(device=dev).manual_seed(exp.sys.seed)), mcfg)
        bb = model.encoder.backbone
        last = hf["num_hidden_layers"] - 1
        for got, key in ((bb.embeddings.word_embeddings.weight, "embeddings.word_embeddings.weight"),
                         (bb.layers[0].attention_norm.weight, "encoder.layer.0.attention.output.LayerNorm.weight"),
                         (bb.layers[last].attention.query.weight, f"encoder.layer.{last}.attention.self.query.weight")):
            check(torch.equal(got.detach().cpu(), written[key]), f"{name}: {key} is not the written tensor")
        with torch.no_grad():
            pooled[name] = model.encode_field(ids, mask)
        del model, bb
    # lora_b is 0, so each adapter adds exact zeros to its base's output
    step0_err = (pooled["lora"] - pooled["plain"]).abs().max().item()
    check(step0_err <= 1e-6, f"step 0: the LoRA encoder's pooled output differs from the plain one by {step0_err:.3g}")
    del pooled
    gc.collect()
    torch.cuda.empty_cache()
    log(f"10 step 0: the written tensors loaded bit for bit; LoRA encoder == plain encoder on {t['probe_rows']} rows "
        f"(max |diff| {step0_err})")

    # instrumentation: each wrapper records and calls the real function
    rec: dict = dict(logs=[], steps=[], loaders=[], call=None)
    real = dict(run=cli.run_experiment, loader=cli.RealmDataloader, kbit=cli.kbit_prepare,
                loop=recipes.training_loop, step=RealmTrainStep.train_step_accum, kernel=dense_mod.fused_mips_binned)

    def run_experiment(exp_, *, on_log=None, **kw):
        def both(step, metrics):
            rec["logs"].append((step, dict(metrics)))
            on_log(step, metrics)

        return real["run"](exp_, on_log=both, **kw)

    def realm_dataloader(*args, **kw):
        rec["loaders"].append(real["loader"](*args, **kw))
        return rec["loaders"][-1]

    def kbit_prepare(model, mask):
        kb = real["kbit"](model, mask)
        rec["codes"] = {n: v.codes.clone() for n, v in kb.frozen.items() if isinstance(v, QuantizedLeaf)}
        rec["init"] = {n: p.detach().clone() for n, p in kb.trainable.items()}
        rec["kbit_bytes"] = dict(kbit_memory_bytes(kb), quantized_leaves=len(rec["codes"]),
                                 float_leaves=len(kb.frozen) - len(rec["codes"]), trainable_leaves=len(kb.trainable),
                                 trainable_params=sum(p.numel() for p in kb.trainable.values()))
        return kb

    def loop(**kw):
        rec["engines"], rec["generator"], rec["corpus"] = kw["engines"], kw["generator"], kw["corpus"]
        return real["loop"](**kw)

    def step(self, engines, corpus, micro, generator, weights, **kw):
        events = [torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)]
        before = dict(fused_mips_binned.body_launches)
        events[0].record()
        out = real["step"](self, engines, corpus, micro, generator, weights, **kw)
        events[1].record()
        rec["steps"].append((events, {k: v - before[k] for k, v in fused_mips_binned.body_launches.items()},
                             len(micro)))
        return out

    def kernel(vectors, queries, **kw):
        if rec["call"] is None:
            rec["call"] = (vectors, queries.detach().clone(), dict(kw))
        return real["kernel"](vectors, queries, **kw)

    patches = [(cli, "run_experiment", run_experiment), (cli, "RealmDataloader", realm_dataloader),
               (cli, "kbit_prepare", kbit_prepare), (recipes, "training_loop", loop),
               (RealmTrainStep, "train_step_accum", step), (dense_mod, "fused_mips_binned", kernel)]
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
    for obj, name, fn in patches:
        setattr(obj, name, fn)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        fused_mips_binned.launches = 0
        fused_mips_binned.body_launches.update(wgmma=0, fma=0)  # main path starts
        t_run = time.perf_counter()
        out = cli.main(["--config", str(yaml_path)])
        torch.cuda.synchronize()
        launches, bodies = fused_mips_binned.launches, dict(fused_mips_binned.body_launches)  # main path ends
        run_s = time.perf_counter() - t_run
        peak_run = torch.cuda.max_memory_allocated(dev)
    finally:
        for obj, name, fn in saved:
            setattr(obj, name, fn)

    model, step_fn, hist, state = out["model"], out["step_fn"], out["history"], out["state"]
    logs, steps = rec["logs"], rec["steps"]
    check(state.step == t["max_steps"] and [hh["period"] for hh in hist] == [0, 1],
          f"ended at step {state.step}, periods {[hh['period'] for hh in hist]}")
    check([s_ for s_, _ in logs] == list(range(1, t["max_steps"] + 1)), f"logged steps {[s_ for s_, _ in logs]}")
    check(all(math.isfinite(mm["loss"]) and math.isfinite(mm["grad_norm"]) for _, mm in logs), "a loss is not finite")
    check(step_fn.accumulate_grad_batches == t["accumulate"] and step_fn.gradcache_chunk_rows == t["chunk_rows"]
          and type(step_fn.optimizer).__name__ == "Adafactor" and model.cfg.remat and model.cfg.lora_rank == t["lora_rank"],
          "the step is not 8 micro-batches through GradCache with Adafactor, remat and LoRA")
    per_step = t["accumulate"]
    check(bodies == {"wgmma": per_step * t["max_steps"], "fma": 0} and launches == per_step * t["max_steps"],
          f"main launched fused_mips_binned {launches} times, by body {bodies}, not {per_step} a step on wgmma")
    check(all(b_ == {"wgmma": per_step, "fma": 0} for _, b_, _ in steps), "a step did not launch once a micro-batch")

    # the kbit state after training: codes unchanged, every adapter and the pooler moved
    kb = kbit_params(model)
    check(kb is not None and set(kb.trainable) == set(rec["init"]), "the trained model lost its kbit split")
    unchanged = all(torch.equal(kb.frozen[n].codes, c) for n, c in rec["codes"].items())
    check(unchanged, "an int8 code changed in training")
    moved = sorted(n for n, p in kb.trainable.items() if not torch.equal(p.detach(), rec["init"][n]))
    check(moved == sorted(kb.trainable), f"trainable groups that did not move: {sorted(set(kb.trainable) - set(moved))}")
    check(len(kb.trainable) == 4 * hf["num_hidden_layers"] + 1, f"{len(kb.trainable)} trainable leaves")
    last = hf["num_hidden_layers"] - 1
    for name, key in ((f"encoder.backbone.layers.{last}.attention.query.weight",
                       f"encoder.layer.{last}.attention.self.query.weight"),
                      ("encoder.backbone.layers.2.output.base.weight", "encoder.layer.2.output.dense.weight"),
                      ("encoder.backbone.embeddings.word_embeddings.weight", "embeddings.word_embeddings.weight")):
        want = quantize_leaf(flax_layout(model, name).to_flax(written[key].to(dev)))
        check(torch.equal(kb.frozen[name].codes, want.codes) and torch.equal(kb.frozen[name].scale, want.scale),
              f"{name}: the codes are not the written tensor's")
    for name, key in (("encoder.backbone.layers.0.attention_norm.weight",
                       "encoder.layer.0.attention.output.LayerNorm.weight"),
                      ("encoder.backbone.layers.1.intermediate.base.bias", "encoder.layer.1.intermediate.dense.bias")):
        check(torch.equal(kb.frozen[name].cpu(), written[key]), f"{name} is not the written tensor")
    del rec["codes"], rec["init"], written

    # one CLI-loop call (the first micro-batch's) against the plain version
    vv, q, kw = rec["call"]
    b, d = q.shape
    k, bins, n_real = kw["k"], kw["bins"], kw["n_real"]
    check((b, d, vv.shape[0], bins, k) == (t["micro_batch"], hf["hidden_size"], t["n"], t["bins"], 100),
          f"the CLI-loop call is B={b} D={d} N={vv.shape[0]} bins={bins} k={k}")
    body = _binned_body(vv.dtype, d, bins, (vv.data_ptr(), q.data_ptr()))
    check(body == "wgmma", f"the D={d} call takes the {body} body")
    ks, ki = fused_mips_binned(vv, q, **kw)
    rs, ri = fused_mips_binned_reference(vv, q, **kw)
    tol = 2 * d * 2.0**-24 * q.float().norm(dim=-1).max().item() * vv.float().norm(dim=-1).max().item()
    err, swaps = check_against_plain(f"CLI-loop binned B={b} D={d}", ks, ki, rs, ri, q, vv, tol)
    ms = time_ms(lambda: fused_mips_binned(vv, q, **kw), 20)
    plain_ms = time_ms(lambda: fused_mips_binned_reference(vv, q, **kw), 2)
    library_ms = time_ms(lambda: torch.topk(q @ vv[:n_real].T, k, dim=-1), 20)
    nbytes, ops = (n_real + b) * d * 2 + b * k * 8, 2 * b * n_real * d
    bound = max(nbytes / hbm, ops / peak_bf16) * 1e3
    bound_by = "bytes" if nbytes / hbm >= ops / peak_bf16 else "operations"
    log(f"check large CLI-loop binned bf16 B={b} D={d} N={n_real} bins={bins} k={k} ({body}): max |kernel - plain| = "
        f"{err:.3g} (tol {tol:.3g}), {swaps} id swaps inside the band; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"library {library_ms:.4f} ms, bound {bound:.4f} ms ({bound_by}) [{card}]")
    del rec["call"], vv, q, ks, ki, rs, ri

    # GradCache against the monolithic backward on one micro-batch at full width
    engines, corpus, generator = rec["engines"], rec["corpus"], rec["generator"]
    weights = state.get_parameters()
    batches = rec["loaders"][0].epoch(seed=4242)
    collated = [step_fn.collate(engines, corpus, next(batches), generator, weights) for _ in range(2)]
    params = list(kb.trainable.values())

    def grads(fn) -> tuple[list, int]:
        model.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        fn()
        torch.cuda.synchronize()
        return [p.grad.detach().clone() for p in params], torch.cuda.max_memory_allocated(dev)

    def rel_l2(a, b_) -> float:
        num = torch.sqrt(sum(((x.double() - y.double()) ** 2).sum() for x, y in zip(a, b_)))
        den = torch.sqrt(sum((y.double() ** 2).sum() for y in b_))
        return (num / den).item()

    rows = int(collated[0].query__input_ids.shape[0] + collated[0].section__input_ids.shape[0])
    mono, peak_mono = grads(lambda: model(collated[0]).loss.backward())
    cached, peak_cache = grads(lambda: gradcache_backward(model, collated[0], chunk_rows=t["chunk_rows"]))
    chunked, peak_chunked = grads(lambda: gradcache_backward(model, collated[0], chunk_rows=t["gradcache_probe_chunk"]))
    other, _ = grads(lambda: model(collated[1]).loss.backward())
    rel = {"chunk_rows": rel_l2(cached, mono), "probe_chunk": rel_l2(chunked, mono), "control": rel_l2(other, mono)}
    log(f"10 GradCache vs monolithic on one micro-batch ({rows} rows x {collated[0].section__input_ids.shape[1]} "
        f"tokens): relative L2 of the trainable gradients {rel['chunk_rows']:.3g} at {t['chunk_rows']} rows a chunk, "
        f"{rel['probe_chunk']:.3g} at {t['gradcache_probe_chunk']}; control (another micro-batch) {rel['control']:.3g}; "
        f"limit {t['grad_rel_limit']}; peak memory monolithic {peak_mono / 2**30:.4f} GiB, GradCache "
        f"{peak_cache / 2**30:.4f} GiB ({t['chunk_rows']} rows), {peak_chunked / 2**30:.4f} GiB "
        f"({t['gradcache_probe_chunk']} rows) [{card}]")
    check(rel["chunk_rows"] <= t["grad_rel_limit"] and rel["probe_chunk"] <= t["grad_rel_limit"],
          f"GradCache's gradients differ from the monolithic ones by {rel}")
    check(rel["control"] > 10 * t["grad_rel_limit"], f"the control reads {rel['control']:.3g}: the check is blind")

    # one Adafactor update on the card against the same update on the CPU in f32
    card_p = [torch.nn.Parameter(p.detach().clone()) for p in params]
    cpu_p = [torch.nn.Parameter(p.detach().cpu().clone()) for p in params]
    for group, grads_ in ((card_p, mono), (cpu_p, [g_.cpu() for g_ in mono])):
        for p, g_ in zip(group, grads_):
            p.grad = g_
        Adafactor(group, tr.learning_rate, weight_decay=tr.weight_decay or None).step()
    ada_err = max((a.detach().cpu() - b_.detach()).abs().max().item() for a, b_ in zip(card_p, cpu_p))
    ada_scale = max(b_.detach().abs().max().item() for b_ in cpu_p)
    log(f"10 Adafactor on the card vs the CPU, one update of {len(params)} leaves: max |diff| {ada_err:.3g} "
        f"(largest parameter {ada_scale:.3g})")
    check(ada_err <= 1e-6 * ada_scale, f"Adafactor on the card differs from the CPU by {ada_err:.3g}")
    del card_p, cpu_p, mono, cached, chunked, other, collated
    model.zero_grad(set_to_none=True)

    # one optimizer step, its 8 dataloader batches included, with every
    # synchronizing CUDA call made an error
    step_fn.train_step_accum(engines, corpus, [next(batches) for _ in range(per_step)], generator, weights)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        micro = [next(batches) for _ in range(per_step)]
        step_fn.train_step_accum(engines, corpus, micro, generator, weights)
        enqueue_ms = (time.perf_counter() - t0) * 1e3
    except RuntimeError as exc:
        fail(f"the large CLI's step or its dataloader waits for the card: {exc}")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    finish_ms = (time.perf_counter() - t0) * 1e3
    kbit_bytes = rec["kbit_bytes"]
    del out, model, step_fn, kb, params, rec, micro, batches, engines, corpus
    gc.collect()
    torch.cuda.empty_cache()
    tmp.cleanup()

    periods = []
    for p_, hh in enumerate(hist):
        ms_ = [s_.elapsed_time(e_) for (s_, e_), _, _ in steps[p_ * t["period"] : (p_ + 1) * t["period"]]]
        periods.append(dict(period=hh["period"], reembed_s=hh["reembed_s"], build_ms=hh["build_ms"]["total_ms"],
                            step_ms=ms_, median_step_ms=statistics.median(ms_)))
    all_steps = [x for p_ in periods for x in p_["step_ms"]]
    wall = time.perf_counter() - started
    result = dict(
        harvest_s=h["harvest_s"], checkpoint_s=ckpt_s, checkpoint_bytes=ckpt_bytes, run_s=run_s, periods=periods,
        median_step_ms=statistics.median(all_steps), losses=[mm["loss"] for _, mm in logs], kbit_bytes=kbit_bytes,
        peak_mem_bytes=peak_run, gradcache_peak_mem_bytes=peak_cache, monolithic_peak_mem_bytes=peak_mono,
        probe_chunk_peak_mem_bytes=peak_chunked, grad_rel_l2=rel, step0_max_abs_diff=step0_err,
        adafactor_max_abs_diff=ada_err, launches=launches, body_launches=bodies, max_abs_err=err,
        call=dict(shape=f"bfloat16 B={b} N={n_real} D={d} bins={bins} k={k}", ms=ms, plain_ms=plain_ms,
                  library_ms=library_ms, bound_ms=bound, bound_by=bound_by),
        sync_free_step=dict(enqueue_ms=enqueue_ms, finish_ms=finish_ms), wall_s=wall,
    )
    log(f"10 kbit [{card}]: {json.dumps(kbit_bytes)} (bytes: trainable leaves, frozen codes + scales + float leaves)")
    for p_ in periods:
        log(f"10 period {p_['period']} [{card}]: re-embed {p_['reembed_s']:.2f} s ({t['n']} sections of "
            f"{t['max_length']} tokens through the kbit view), index build {p_['build_ms']:.2f} ms, steps "
            f"{json.dumps([round(x, 4) for x in p_['step_ms']])} ms (median {p_['median_step_ms']:.4f})")
    log(f"10 run [{card}]: main {run_s:.2f} s ({launches} fused_mips_binned launches, by body {bodies}); step median "
        f"{result['median_step_ms']:.4f} ms (B = 32 as {per_step} micro-batches of {t['micro_batch']}); losses "
        f"{json.dumps([round(x, 6) for x in result['losses']])}; peak memory {peak_run / 2**30:.4f} GiB")
    log(f"10 step without a sync [{card}]: {per_step} dataloader batches and one optimizer step enqueued in "
        f"{enqueue_ms:.2f} ms, finished {finish_ms:.2f} ms after the start")
    log(f"phase 10 wall time: {wall:.1f} s")
    return result


def splade_cli_phase(dev, card: str, t: dict) -> tuple[dict, dict]:
    """Phase 11a: a SPLADE ranker trained through the experiment CLI (module
    constant SPLADE), in process through `vod_tpu_torch.exps.cli.main`: a
    `BertForMaskedLM` checkpoint of bert-base-uncased's widths that the phase
    writes (seeded random weights), grafted as the backbone; live
    learned-sparse retrieval (the queries' top `splade_query_k` impact terms
    searched in the learned impact postings) and a learned reindex at each
    period boundary. `main` is its main path: launch counts are zeroed just
    before it and read just after (the SPLADE path reaches neither kernel).
    Returns the numbers, and what phases 11b and 11c reuse."""
    import tempfile

    import torch

    from vod_tpu_torch.data.corpus import _render
    from vod_tpu_torch.exps import cli, recipes
    from vod_tpu_torch.exps.structconf import Experiment
    from vod_tpu_torch.models import SpladeEncoder, collect_losses, flops_loss, splade_topk_terms
    from vod_tpu_torch.models.systems import fused_rows
    from vod_tpu_torch.ops.mips import fused_mips_binned, fused_mips_topk
    from vod_tpu_torch.runtime.train import RealmTrainStep
    from vod_tpu_torch.search import SearchQueries, SparseIndex, sparse_search

    started = time.perf_counter()
    tmp = tempfile.TemporaryDirectory()
    root = Path(tmp.name)
    h = harvest_beir(root, t)
    t0 = time.perf_counter()
    written = write_hf_checkpoint(root / "splade", t, dev, head="mlm")
    ckpt_s = time.perf_counter() - t0
    ckpt_bytes = (root / "splade" / "model.safetensors").stat().st_size
    hf = t["hf"]
    gradcache = f", gradcache_chunk_rows: {t['chunk_rows']}" if t["chunk_rows"] else ""
    yaml_path = root / "exp.yaml"
    yaml_path.write_text(
        f"extends: ['{ROOT / 'configs' / 'scifact_ranker.yaml'}']\n"
        f"model: {{splade_encoder: true, splade_flops_weight: {t['flops_weight']}, splade_query_k: {t['query_k']}, "
        f"splade_doc_k: {t['doc_k']}, splade_max_postings: {t['max_postings']}, vocab_size: {hf['vocab_size']}, "
        f"hidden_size: {hf['hidden_size']}, num_layers: {hf['num_hidden_layers']}, "
        f"num_heads: {hf['num_attention_heads']}, intermediate_size: {hf['intermediate_size']}, "
        f"name_or_path: '{root / 'splade'}', hf_fallback: error}}\n"
        f"tokenizer: {{name_or_path: '{h['vocab_dir']}', max_length: {t['max_length']}}}\n"
        f"trainer: {{max_steps: {t['max_steps']}, period: {t['period']}, log_interval: 1{gradcache}}}\n"
        "sys: {mesh_shape: [1]}\n"
        "datasets:\n"
        "  queries:\n"
        f"    - {{identifier: harvest-train, name_or_path: beir, subsets: ['{h['beir']}'], split: train, "
        "link: harvest-corpus}\n"
        "  sections:\n"
        f"    - {{identifier: harvest-corpus, name_or_path: beir, subsets: ['{h['beir']}']}}\n"
    )
    log(f"11a inputs: {t['n']} passages harvested from {h['files']} files in {h['harvest_s']:.2f} s; a "
        f"BertForMaskedLM checkpoint of {ckpt_bytes / 1e9:.3f} GB (bert-base-uncased's widths, seeded random f32 "
        f"weights) written in {ckpt_s:.2f} s")

    # the parsed config: scifact's body with the SPLADE encoder at those widths
    exp = Experiment.from_file(str(yaml_path))
    m, tr, col = exp.model, exp.trainer, exp.collate
    check((m.kind, m.gradients, m.splade_encoder, m.splade_flops_weight, m.splade_query_k, m.splade_doc_k,
           m.splade_max_postings) == ("ranker", "retrieval", True, t["flops_weight"], t["query_k"], t["doc_k"],
                                      t["max_postings"])
          and (m.hidden_size, m.num_layers, m.num_heads, m.intermediate_size, m.vocab_size) ==
          (hf["hidden_size"], hf["num_hidden_layers"], hf["num_attention_heads"], hf["intermediate_size"],
           hf["vocab_size"])
          and (exp.dataloader.batch_size, col.prefetch_n_sections, col.n_sections, col.max_pos_sections,
               tr.learning_rate, tr.gradient_clip_val, tr.gradcache_chunk_rows) ==
          (32, 100, 8, 2, 1e-4, 1.0, t["chunk_rows"])
          and exp.tokenizer.max_length == t["max_length"] and exp.search_defaults.sparse.max_postings == 2048,
          "the parsed Experiment is not scifact_ranker with the SPLADE encoder")

    # instrumentation: each wrapper records and calls the real function
    rec: dict = dict(logs=[], steps=[], loaders=[], engines=[], encodes=[])
    real = dict(run=cli.run_experiment, tokenize_corpus=cli.tokenize_corpus, loader=cli.RealmDataloader,
                graft=cli._maybe_port_hf_encoder, loop=recipes.training_loop, terms=recipes.encode_corpus_terms,
                step=RealmTrainStep.train_step_accum)

    def run_experiment(exp_, *, on_log=None, **kw):
        def both(step, metrics):
            rec["logs"].append((step, dict(metrics)))
            on_log(step, metrics)

        return real["run"](exp_, on_log=both, **kw)

    def tokenize_corpus(sections, *args, **kw):
        rec["sections"] = list(sections)
        rec["enc"] = real["tokenize_corpus"](sections, *args, **kw)
        return rec["enc"]

    def realm_dataloader(*args, **kw):
        rec["loaders"].append(real["loader"](*args, **kw))
        return rec["loaders"][-1]

    def graft(model, cfg):
        out = real["graft"](model, cfg)
        rec["init"] = {n: p.detach().clone() for n, p in out.named_parameters()}
        return out

    def loop(**kw):
        rec["engines"].append(kw["engines"])
        rec["generator"], rec["corpus"] = kw["generator"], kw["corpus"]
        return real["loop"](**kw)

    def encode_terms(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real["terms"](*args, **kw)
        rec["encodes"].append(time.perf_counter() - t0)
        return out

    def step(self, engines, corpus, micro, generator, weights, **kw):
        events = [torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)]
        events[0].record()
        out = real["step"](self, engines, corpus, micro, generator, weights, **kw)
        events[1].record()
        rec["steps"].append(events)
        return out

    patches = [(cli, "run_experiment", run_experiment), (cli, "tokenize_corpus", tokenize_corpus),
               (cli, "RealmDataloader", realm_dataloader), (cli, "_maybe_port_hf_encoder", graft),
               (recipes, "training_loop", loop), (recipes, "encode_corpus_terms", encode_terms),
               (RealmTrainStep, "train_step_accum", step)]
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
    for obj, name, fn in patches:
        setattr(obj, name, fn)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        fused_mips_binned.launches = 0
        fused_mips_binned.body_launches.update(wgmma=0, fma=0)
        fused_mips_topk.launches = 0
        fused_mips_topk.body_launches.update(wgmma=0, fma=0)  # main path starts
        t_run = time.perf_counter()
        out = cli.main(["--config", str(yaml_path)])
        torch.cuda.synchronize()
        launches = {"fused_mips_binned": fused_mips_binned.launches, "fused_mips_topk": fused_mips_topk.launches}
        run_s = time.perf_counter() - t_run  # main path ends
        peak_run = torch.cuda.max_memory_allocated(dev)
    finally:
        for obj, name, fn in saved:
            setattr(obj, name, fn)

    model, step_fn, hist, state = out["model"], out["step_fn"], out["history"], out["state"]
    logs, engines, corpus, generator = rec["logs"], rec["engines"], rec["corpus"], rec["generator"]
    check(state.step == t["max_steps"] and [hh["period"] for hh in hist] == [0, 1],
          f"ended at step {state.step}, periods {[hh['period'] for hh in hist]}")
    check([s_ for s_, _ in logs] == list(range(1, t["max_steps"] + 1)), f"logged steps {[s_ for s_, _ in logs]}")
    check(all(math.isfinite(mm["loss"]) and math.isfinite(mm["grad_norm"]) for _, mm in logs), "a loss is not finite")
    check(isinstance(model.encoder, SpladeEncoder) and step_fn.splade_query_k == t["query_k"]
          and model.encoder.flops_weight == t["flops_weight"], "the CLI did not build the SPLADE ranker")
    check(launches == {"fused_mips_binned": 0, "fused_mips_topk": 0},
          f"the SPLADE path launched a kernel: {launches} (it reaches neither, in JAX either)")
    # no dense engine; the learned index rebuilt at each boundary from the current encoder
    check(len(engines) == 2 and all(e.dense is None and isinstance(e.sparse, SparseIndex) for e in engines),
          "a period trained with a dense engine or without a learned index")
    check(engines[0].sparse is not engines[1].sparse
          and not torch.equal(engines[0].sparse.postings_impacts, engines[1].sparse.postings_impacts),
          "period 1's learned index equals period 0's")
    check(all(int(e.sparse.postings_docs.shape[0]) == hf["vocab_size"] for e in engines),
          "the learned index does not have a row per vocabulary term")
    # the graft: the backbone is the checkpoint's, the MLM head keeps its init (backbone-only, as JAX's CLI)
    init = rec["init"]
    check(torch.equal(init["encoder.backbone.embeddings.word_embeddings.weight"].cpu(),
                      written["embeddings.word_embeddings.weight"])
          and torch.equal(init["encoder.backbone.layers.2.output.weight"].cpu(),
                          written["encoder.layer.2.output.dense.weight"]),
          "the backbone at step 0 is not the checkpoint's")
    check(not torch.equal(init["encoder.transform.weight"].cpu(), written["cls.predictions.transform.dense.weight"]),
          "the MLM head was loaded: the CLI grafts the backbone only, as JAX's does")
    moved = [n for n, p in model.named_parameters() if not torch.equal(p.detach(), init[n])]
    check(len(moved) == len(init), f"parameters that did not move: {sorted(set(init) - set(moved))[:5]}")
    del init, rec["init"]

    # one collated batch: the FLOPS term over the one fused pass, inside the loss;
    # the collate's sparse scores against a direct search of the same query terms
    weights = state.get_parameters()
    loader = rec["loaders"][0]
    batches = loader.epoch(seed=4242)
    qb = next(batches)
    batch = step_fn.collate(engines[-1], corpus, qb, generator, weights)
    with torch.no_grad():
        total, est = step_fn.loss(batch)
        with collect_losses(model) as sown:
            model(batch)
        ids, mask, _ = fused_rows(batch)
        fused_flops = t["flops_weight"] * flops_loss(model.encoder(ids, mask))
        impacts = model.encode_field(qb.input_ids, qb.attention_mask)
        q_terms, q_w = splade_topk_terms(impacts, t["query_k"])
        direct = sparse_search(engines[-1].sparse, SearchQueries(terms=q_terms, term_weights=q_w,
                                                                 subset_ids=qb.subset_ids), col.prefetch_n_sections)
    flops = float(total - est.loss)
    check(len(sown) == 1 and math.isfinite(flops) and flops > 0.0, f"the FLOPS term {flops} is not finite and positive")
    check(abs(float(sown[0]) - flops) <= 1e-5 * abs(float(total)) + 1e-7
          and abs(float(sown[0]) - float(fused_flops)) <= 1e-6 * float(fused_flops) + 1e-9,
          f"the loss's FLOPS term {flops} is not the fused pass's {float(fused_flops)}")
    finite = torch.isfinite(direct.scores)
    sparse_tol = 1e-5 * float(direct.scores[finite].abs().max()) + 1e-6
    check_collated("11a collated learned-sparse scores", batch.section__idx, batch.section__sparse, direct, sparse_tol)
    check(bool(torch.isnan(batch.section__dense).all()), "a dense score reached the SPLADE batch")
    terms_per_query = float((q_terms >= 0).sum(-1).float().mean())
    log(f"11a loss pass: loss {float(total):.6f} = estimator {float(est.loss):.6f} + FLOPS {flops:.6g} (the fused "
        f"pass's {float(fused_flops):.6g}); collated sparse scores == a direct sparse_search of the queries' top "
        f"{t['query_k']} terms within {sparse_tol:.3g}")
    del total, est, sown, batch, direct, impacts

    # one chunk's impacts on the card against the same chunk on the CPU, through
    # the CLI's initial encoder (after 6 steps at random weights the trained
    # impacts hardly depend on the section: a control could not see a fault)
    start = cli._maybe_port_hf_encoder(
        cli.build_model(m, device=dev, generator=torch.Generator(device=dev).manual_seed(exp.sys.seed)), m).encoder
    cpu_enc = SpladeEncoder(start.cfg, device="cpu")
    cpu_enc.load_state_dict({k: v.cpu() for k, v in start.state_dict().items()})
    rows = t["probe_rows"]
    with torch.no_grad():
        on_card = start(corpus.input_ids[:rows], corpus.attention_mask[:rows]).cpu()
        other = start(corpus.input_ids[rows : 2 * rows], corpus.attention_mask[rows : 2 * rows]).cpu()
        on_cpu = cpu_enc(corpus.input_ids[:rows].cpu(), corpus.attention_mask[:rows].cpu())
    impact_err = (on_card - on_cpu).abs().max().item()
    control = (other - on_cpu).abs().max().item()
    log(f"11a impacts card vs CPU (the initial encoder, {rows} sections x {t['max_length']} tokens, bf16 "
        f"activations): max |diff| {impact_err:.4g} (limit {t['impact_tol']}; largest impact "
        f"{on_cpu.max().item():.4g}); control (other sections) {control:.4g}")
    check(impact_err <= t["impact_tol"], f"impacts on the card differ from the CPU's by {impact_err:.4g}")
    check(control > 4 * t["impact_tol"], f"the control reads {control:.4g}: the check is blind")
    del cpu_enc, start

    # one optimizer step, its dataloader batch included, with every synchronizing CUDA call made an error
    step_fn.train_step(engines[-1], corpus, next(batches), generator, weights)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        step_fn.train_step(engines[-1], corpus, next(batches), generator, weights)
        enqueue_ms = (time.perf_counter() - t0) * 1e3
    except RuntimeError as exc:
        fail(f"the SPLADE step or its dataloader waits for the card: {exc}")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    finish_ms = (time.perf_counter() - t0) * 1e3

    periods = []
    for p_, hh in enumerate(hist):
        ms_ = [s_.elapsed_time(e_) for s_, e_ in rec["steps"][p_ * t["period"] : (p_ + 1) * t["period"]]]
        periods.append(dict(period=hh["period"], reembed_s=hh["reembed_s"], encode_terms_s=rec["encodes"][p_],
                            build_ms=hh["build_ms"]["total_ms"], index_bytes=hh["index_bytes"],
                            learned_terms=hh["learned_terms"], step_ms=ms_, median_step_ms=statistics.median(ms_)))
    all_steps = [x for p_ in periods for x in p_["step_ms"]]
    result = dict(
        harvest_s=h["harvest_s"], checkpoint_bytes=ckpt_bytes, run_s=run_s, periods=periods,
        median_step_ms=statistics.median(all_steps), losses=[mm["loss"] for _, mm in logs], launches=launches,
        peak_mem_bytes=peak_run, flops_term=flops, terms_per_query=terms_per_query,
        terms_per_doc=[p_["learned_terms"]["doc_terms_mean"] for p_ in periods], impact_max_abs_err=impact_err,
        impact_control=control, sync_free_step=dict(enqueue_ms=enqueue_ms, finish_ms=finish_ms),
    )
    for p_ in periods:
        lt = p_["learned_terms"]
        log(f"11a period {p_['period']} [{card}]: impact re-embed {p_['reembed_s']:.2f} s ({t['n']} sections of "
            f"{t['max_length']} tokens, top {t['doc_k']} terms each on the card), learned table "
            f"[{hf['vocab_size']}, {lt['width']}] of {p_['index_bytes'] / 2**20:.2f} MiB built in "
            f"{p_['build_ms']:.2f} ms, {lt['doc_terms_mean']:.2f} terms a section; steps "
            f"{json.dumps([round(x, 4) for x in p_['step_ms']])} ms (median {p_['median_step_ms']:.4f})")
    log(f"11a run [{card}]: main {run_s:.2f} s (no kernel launch: {launches}); step median "
        f"{result['median_step_ms']:.4f} ms (B = 32, 8 sections, {t['max_length']} tokens); losses "
        f"{json.dumps([round(x, 6) for x in result['losses']])}; peak memory {peak_run / 2**30:.4f} GiB; "
        f"{terms_per_query:.2f} terms a query")
    log(f"11a step without a sync [{card}]: a dataloader batch and one optimizer step enqueued in {enqueue_ms:.2f} ms, "
        f"finished {finish_ms:.2f} ms after the start")
    ctx = dict(model=model, step_fn=step_fn, engines=engines[-1], corpus=corpus, generator=generator, weights=weights,
               id_map=rec["enc"]["id_map"], held=h["held"], tokenizer=exp.tokenizer.instantiate(), exp=exp,
               texts=_render(exp.templates.section, rec["sections"]), tmp=tmp)
    result["wall_s"] = time.perf_counter() - started
    log(f"phase 11a wall time: {result['wall_s']:.1f} s")
    return result, ctx


def second_stage_phase(dev, card: str, t: dict, ctx: dict) -> dict:
    """Phase 11b: the second stage over phase 11a's learned index (module
    constant SECOND_STAGE): a cross-encoder at ms-marco-MiniLM-L-6-v2's
    architecture re-ranks 64 held-out queries' first-stage results through
    `benchmark_retrieval(reranker=...)` and fills the teacher scores of one
    collated batch for one `DistillationGradients(margin_mse)` loss and
    backward of the SPLADE student; then `vod_tpu_torch.examples.
    maxsim_bench` at the JAX script's defaults. None of it reaches a kernel
    (checked). Returns the numbers."""
    import torch

    from vod_tpu_torch.examples import maxsim_bench
    from vod_tpu_torch.models import (
        CrossEncoder,
        DistillationGradients,
        config_from_hf,
        cross_encoder_rerank,
        cross_encoder_scores,
        fill_teacher_scores,
        port_bert_cross_encoder_weights,
        splade_topk_terms,
        tokenize_pairs,
    )
    from vod_tpu_torch.models.hf_import import load_hf_state_dict
    from vod_tpu_torch.ops.mips import fused_mips_binned, fused_mips_topk
    from vod_tpu_torch.runtime import QueryBatch, benchmark_retrieval
    from vod_tpu_torch.search import SearchQueries, hybrid_search
    from vod_tpu_torch.types import RetrievalBatch

    started = time.perf_counter()
    root = Path(ctx["tmp"].name)
    model, tok, texts, exp = ctx["model"], ctx["tokenizer"], ctx["texts"], ctx["exp"]
    written = write_hf_checkpoint(root / "cross-encoder", t, dev, head="classifier")
    cfg = config_from_hf(t["hf"], dtype=torch.bfloat16)
    ce = CrossEncoder(cfg, device=dev)
    ce.load_state_dict(port_bert_cross_encoder_weights(load_hf_state_dict(root / "cross-encoder"), cfg))
    ce.eval()
    check(torch.equal(ce.classifier.weight.detach().cpu(), written["classifier.weight"])
          and torch.equal(ce.backbone.embeddings.word_embeddings.weight.detach().cpu(),
                          written["embeddings.word_embeddings.weight"]),
          "the cross-encoder is not the written checkpoint")

    # the held-out queries: their learned terms from the trained encoder, their gold passage
    held = ctx["held"][: t["queries"]]
    qk = exp.model.splade_query_k
    batches, qtexts = [], []
    for i in range(0, len(held), t["batch"]):
        part = held[i : i + t["batch"]]
        enc = tok([text for _, text, _ in part], max_length=exp.tokenizer.max_length, truncation=True,
                  padding="max_length", return_tensors="pt")
        ids = enc["input_ids"].to(dev, torch.int32)
        mask = enc["attention_mask"].to(dev, torch.int32)
        with torch.no_grad():
            terms, tw = splade_topk_terms(model.encode_field(ids, mask), qk)
        gold = torch.tensor([[ctx["id_map"][g]] for _, _, g in part], device=dev, dtype=torch.int32)
        batches.append(QueryBatch(ids, mask, section_ids=gold, terms=terms, term_weights=tw))
        qtexts.append([text for _, text, _ in part])

    timings = []

    def pairs_of(bi: int, indices: torch.Tensor) -> dict:
        rows = indices.cpu().tolist()
        pairs = tokenize_pairs(tok, qtexts[bi], [[texts[c] if c >= 0 else "" for c in row] for row in rows],
                               max_length=t["max_length"])
        return {k: torch.from_numpy(v).to(dev) for k, v in pairs.items()}

    def reranker(bi: int, merged: RetrievalBatch) -> torch.Tensor:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p = pairs_of(bi, merged.indices)
        t1 = time.perf_counter()
        s = cross_encoder_scores(ce, p["input_ids"], p["attention_mask"], p["token_type_ids"])
        torch.cuda.synchronize()
        timings.append((t1 - t0, time.perf_counter() - t1, int(merged.indices.numel())))
        return torch.where(merged.indices >= 0, s, float("-inf"))

    fused_mips_binned.launches = 0
    fused_mips_topk.launches = 0
    bench = benchmark_retrieval(ctx["engines"], batches, top_k=t["top_k"], reranker=reranker,
                                metrics=("ndcg_10", "mrr_10", "hitrate_3", "recall_10"))
    check(set(bench) == {"score", "sparse", "rerank"} and all(math.isfinite(v) for m_ in bench.values()
                                                              for v in m_.values()),
          f"the benchmark's keys or metrics are wrong: {bench}")
    # cross_encoder_rerank of one batch orders by the same scores
    qb0 = batches[0]
    merged, _ = hybrid_search(ctx["engines"], SearchQueries(terms=qb0.terms, term_weights=qb0.term_weights,
                                                            section_ids=qb0.section_ids), t["top_k"])
    p = pairs_of(0, merged.indices)
    with torch.no_grad():
        rr = cross_encoder_rerank(ce, merged, p["input_ids"], p["attention_mask"], p["token_type_ids"], top_k=10)
        s = torch.where(merged.indices >= 0, cross_encoder_scores(ce, p["input_ids"], p["attention_mask"],
                                                                  p["token_type_ids"]), float("-inf"))
    ref = torch.sort(s, dim=-1, descending=True, stable=True)
    check(torch.equal(rr.scores, ref.values[:, :10]) and torch.equal(rr.indices, torch.gather(merged.indices, -1,
                                                                                               ref.indices[:, :10])),
          "cross_encoder_rerank does not order by the cross-encoder's scores")
    tok_s = sum(a for a, _, _ in timings)
    ce_s = sum(b_ for _, b_, _ in timings)
    n_pairs = sum(c for _, _, c in timings)
    log(f"11b cross-encoder rerank [{card}]: {len(held)} held-out queries x top {t['top_k']} (+ the gold lookup): "
        f"{n_pairs} pairs of {t['max_length']} tokens, tokenized in {tok_s:.3f} s ({n_pairs / tok_s:.0f} pairs/s), "
        f"scored in {ce_s * 1e3:.2f} ms ({n_pairs / ce_s:.0f} pairs/s); metrics {json.dumps(bench)}")

    # the teacher: one collated batch of the held-out queries, its sections scored by the cross-encoder
    step_fn = ctx["step_fn"]
    qb = QueryBatch(batches[0].input_ids, batches[0].attention_mask, section_ids=batches[0].section_ids)
    batch = step_fn.collate(ctx["engines"], ctx["corpus"], qb, ctx["generator"], ctx["weights"])
    p = pairs_of(0, torch.where(torch.isneginf(batch.section__score), -1, batch.section__idx))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    filled = fill_teacher_scores(ce, batch, p["input_ids"], p["attention_mask"], p["token_type_ids"])
    torch.cuda.synchronize()
    teacher_ms = (time.perf_counter() - t0) * 1e3
    ts = filled.section__teacher_score
    pad = torch.isneginf(batch.section__score)
    check(torch.equal(torch.isneginf(ts), pad) and bool(torch.isfinite(ts[~pad]).all()),
          "teacher scores are not -inf exactly at padding")
    model.zero_grad(set_to_none=True)
    out = DistillationGradients("margin_mse")(batch=filled, **model.encode(filled))
    out.loss.backward()
    grads = [p_.grad for p_ in model.parameters() if p_.grad is not None]
    check(math.isfinite(float(out.loss.detach())) and len(grads) == len(list(model.parameters()))
          and all(bool(torch.isfinite(g_).all()) for g_ in grads)
          and float(model.encoder.transform.weight.grad.abs().max()) > 0,
          "the distillation loss or its gradients are not finite")
    model.zero_grad(set_to_none=True)
    log(f"11b teacher [{card}]: {int((~pad).sum())} sampled sections of {ts.shape[0]} queries scored in "
        f"{teacher_ms:.2f} ms; margin-MSE distillation loss {float(out.loss.detach()):.6f}, its backward through the "
        f"SPLADE student finite")
    del batch, filled, out, grads, ce
    gc.collect()
    torch.cuda.empty_cache()

    # MaxSim two-stage serving at the JAX script's defaults
    t0 = time.perf_counter()
    ms = maxsim_bench.main(t["maxsim_args"])
    maxsim_s = time.perf_counter() - t0
    check(ms["rerank_block_equal"] and ms["rerank_max_abs_err"] == 0.0,
          "a maxsim_rerank block on the card differs from _score_gathered on the CPU")
    check(ms["top1_scores_equal"], "the rerank and the brute-force scan score the same doc differently")
    check(ms["recall"] >= ms["recall_pooled"] and math.isfinite(ms["ms_per_block"]),
          f"two-stage recall {ms['recall']} below pooled-only {ms['recall_pooled']}")
    kernel_launches = {"fused_mips_binned": fused_mips_binned.launches, "fused_mips_topk": fused_mips_topk.launches}
    check(kernel_launches == {"fused_mips_binned": 0, "fused_mips_topk": 0},
          f"the second stage launched a kernel: {kernel_launches} (it reaches neither, in JAX either)")
    log(f"11b MaxSim [{card}]: {ms['store_gib']:.2f} GiB int8 store built in {ms['build_s']:.2f} s, brute-force scan "
        f"{ms['gt_scan_s']:.2f} s; recall@10 two-stage {ms['recall']:.4f}, pooled-only {ms['recall_pooled']:.4f}; "
        f"{ms['ms_per_block']:.4f} ms per 64-query block; one rerank block == _score_gathered on the CPU "
        f"(max |diff| {ms['rerank_max_abs_err']}); {maxsim_s:.1f} s in all")
    wall = time.perf_counter() - started
    log(f"phase 11b wall time: {wall:.1f} s")
    return dict(benchmark=bench, rerank_pairs=n_pairs, rerank_tokenize_s=tok_s, rerank_score_ms=ce_s * 1e3,
                teacher_ms=teacher_ms, maxsim=ms, launches=kernel_launches, wall_s=wall)


def dynamic_cache_phase(dev, card: str, t: dict, corpus) -> dict:
    """Phase 11c: the mutable dense store at capacity 2^20 x 768 in bf16 and
    int8, filled from phase 4's serving corpus (made anew from its seed) in 8
    adds, with deletes, updates, an overflowing add and a compaction, then
    searched at B = 64 against an exact search over the live rows; and
    `cached_embeddings` of phase 11a's 2^15 tokenized passages at e5-base's
    width: a miss, a hit, and a hole that forces a recompute. Returns the
    numbers."""
    import tempfile

    import torch

    from vod_tpu_torch.models import Ranker, RetrievalGradients, TransformerEncoderConfig, VodPoolerConfig
    from vod_tpu_torch.ops.numpy_ops import topk_lowest_first
    from vod_tpu_torch.runtime import cached_embeddings
    from vod_tpu_torch.search import (
        SearchQueries,
        dynamic_add,
        dynamic_compact,
        dynamic_delete,
        dynamic_from_dense,
        dynamic_search,
        dynamic_update,
    )
    from vod_tpu_torch.search.dense import quantize_queries_int8
    from vod_tpu_torch.types.lazy import TensorStoreFactory

    started = time.perf_counter()
    gs = torch.Generator(device=dev).manual_seed(1)
    rows = torch.randn((N_SERVE, D), generator=gs, device=dev)  # phase 4's corpus: the same seed, the same draw
    rows /= rows.norm(dim=-1, keepdim=True)
    fill, step = t["fill"], t["fill"] // 8
    g = torch.Generator(device=dev).manual_seed(t["seed"])
    deleted = torch.randperm(fill, generator=g, device=dev)[: fill // 10].to(torch.int32)
    live = torch.ones(fill, dtype=torch.bool, device=dev)
    live[deleted.long()] = False
    live_ids = live.nonzero().squeeze(-1).to(torch.int32)
    updated = live_ids[torch.randperm(live_ids.numel(), generator=g, device=dev)[: fill // 100]]
    new_rows = torch.randn((updated.numel(), D), generator=g, device=dev)
    new_rows /= new_rows.norm(dim=-1, keepdim=True)
    src = live_ids[torch.randperm(live_ids.numel(), generator=g, device=dev)[: t["b"]]].long()
    queries = rows[src] + 0.1 * torch.randn((t["b"], D), generator=g, device=dev)
    queries /= queries.norm(dim=-1, keepdim=True)
    n_extra = t["capacity"] - fill + t["overflow"]
    extra = torch.randn((n_extra, D), generator=g, device=dev)
    extra /= extra.norm(dim=-1, keepdim=True)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    stores = {}
    for dtype in ("bfloat16", "int8"):
        ms: dict = {}
        index, ms["from_dense"] = timed(lambda: dynamic_from_dense(rows[:step], t["capacity"], dtype=dtype))
        adds = []
        for i in range(1, 8):
            (index, ids), a_ms = timed(lambda: dynamic_add(index, rows[i * step : (i + 1) * step]))
            check(torch.equal(ids, torch.arange(i * step, (i + 1) * step, device=dev, dtype=torch.int32)),
                  f"{dtype}: add {i} assigned other ids")
            adds.append(a_ms)
        ms["add"] = statistics.median(adds)
        check(index.n_active == fill and int(index.n_alive) == fill and index.capacity == t["capacity"],
              f"{dtype}: {index.n_active} rows after 8 adds")
        index, ms["delete"] = timed(lambda: dynamic_delete(index, deleted))
        check(int(index.n_alive) == fill - deleted.numel(), f"{dtype}: the delete left {int(index.n_alive)} alive")
        (index, found), ms["update"] = timed(lambda: dynamic_update(index, updated, new_rows))
        check(bool(found.all()), f"{dtype}: an update missed a live id")
        (index, ids), ms["overflow_add"] = timed(lambda: dynamic_add(index, extra))
        dropped = int((ids == -1).sum())
        check(dropped == t["overflow"] and bool((ids[: n_extra - t["overflow"]] >= 0).all())
              and index.n_active == t["capacity"], f"{dtype}: the overflow dropped {dropped} rows")
        index, ms["compact"] = timed(lambda: dynamic_compact(index))
        n_live = t["capacity"] - deleted.numel()
        check(index.n_active == n_live and int(index.n_alive) == n_live, f"{dtype}: compaction kept {index.n_active}")
        sq = SearchQueries(vector=queries)
        out, _ = timed(lambda: dynamic_search(index, sq, t["k"]))
        ms["search"] = time_ms(lambda: dynamic_search(index, sq, t["k"]), 10)
        # an exact search over the live rows (all at the front after compaction), in f64
        v = index.vectors[:n_live]
        if index.scale is not None:
            q_i8, q_row = quantize_queries_int8(queries, index.scale)
            ref = (q_i8.double() @ v.double().T).float() * q_row
        else:
            ref = (queries.to(v.dtype).double() @ v.double().T).float()
        rs, rpos = topk_lowest_first(ref, t["k"])
        ri = index.ids[:n_live][rpos]
        del ref, v
        if dtype == "int8":
            check(torch.equal(out.scores, rs) and torch.equal(out.indices, ri),
                  "int8 dynamic_search != the exact search over the live rows")
            err, swaps = 0.0, 0
        else:
            tol = 2 * D * 2.0**-24 * float(queries.norm(dim=-1).max()) * 1.01
            inf = torch.full((t["b"], 1), float("inf"), device=dev)
            gap = torch.cat([rs[:, :-1] - rs[:, 1:], inf], dim=-1)
            clear = torch.minimum(gap, torch.cat([inf, gap[:, :-1]], dim=-1)) > tol
            err = (out.scores - rs).abs().max().item()
            swaps = int((out.indices != ri).sum())
            check(err <= tol and torch.equal(out.indices[clear], ri[clear]),
                  f"bf16 dynamic_search differs from the exact search: max |diff| {err:.3g} (tol {tol:.3g})")
        check(bool(torch.isin(out.indices, deleted).logical_not().all()), f"{dtype}: a deleted id was returned")
        stores[dtype] = dict(ms=ms, dropped=dropped, max_abs_err=err, swaps=swaps, live=n_live)
        log(f"11c dynamic {dtype} [{card}]: capacity {t['capacity']} x {D}; ms per op: " +
            ", ".join(f"{k} {v:.3f}" for k, v in ms.items()) + f" (adds of {step} rows; delete {deleted.numel()}; "
            f"update {updated.numel()}; overflow add of {n_extra} rows dropped {dropped}; search B={t['b']} "
            f"k={t['k']}); search == exact over {n_live} live rows" +
            (" exactly" if dtype == "int8" else f" within {err:.3g}, {swaps} id swaps inside the band"))
        del index, out
    del rows, extra, new_rows
    gc.collect()
    torch.cuda.empty_cache()

    # the embedding cache at e5-base's width over phase 11a's corpus
    cfg = TransformerEncoderConfig(  # configs/presets/encoder/e5-base.yaml + pooler/mean-l2.yaml, as phase 4
        max_position_embeddings=512, dtype=torch.bfloat16,
        pooler=VodPoolerConfig(agg_method="mean", output_norm="l2", scaler=10.0, learn_scaler=True), **t["encoder"],
    )
    ranker = Ranker(cfg, RetrievalGradients(), device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    calls = []

    def encode(ids, mask):
        calls.append(int(ids.shape[0]))
        return ranker.encode_field(ids, mask)

    tmp = tempfile.TemporaryDirectory()
    kw = dict(cache_dir=tmp.name, dataset_fingerprint="harvest-2^15", chunk=t["embed_chunk"])
    miss, miss_ms = timed(lambda: cached_embeddings(encode, ranker, corpus, **kw))
    n_miss = len(calls)
    calls.clear()
    hit, hit_ms = timed(lambda: cached_embeddings(encode, ranker, corpus, **kw))
    check(calls == [1] and torch.equal(hit, miss), "the hit did not read the store back bit for bit")
    store_dir = next((Path(tmp.name) / "vectors").iterdir())
    store = TensorStoreFactory.from_path(store_dir).open()
    vecs = store.read()
    vecs[t["hole_row"]] = 0.0
    store.write(vecs)
    calls.clear()
    again, again_ms = timed(lambda: cached_embeddings(encode, ranker, corpus, **kw))
    healed = store.read()
    check(len(calls) == n_miss and bool((abs(healed).sum(-1) > 0).all()),
          "a zeroed row did not force a recompute of the store")
    recompute_err = (again - miss).abs().max().item()
    log(f"11c cache [{card}]: cached_embeddings of {corpus.size} sections at e5-base's width: miss (encode + write "
        f"{miss.numel() * 4 / 2**20:.1f} MiB) {miss_ms:.1f} ms, hit {hit_ms:.1f} ms (bit for bit); a zeroed row "
        f"forced a recompute in {again_ms:.1f} ms (max |recompute - miss| {recompute_err:.3g})")
    tmp.cleanup()
    del ranker, miss, hit, again
    gc.collect()
    torch.cuda.empty_cache()
    wall = time.perf_counter() - started
    log(f"phase 11c wall time: {wall:.1f} s")
    return dict(stores=stores, cache=dict(miss_ms=miss_ms, hit_ms=hit_ms, recompute_ms=again_ms,
                                          recompute_max_abs_diff=recompute_err), wall_s=wall)


def wall_ms(fn, reps: int) -> float:
    """Mean host wall ms per call over `reps` calls after one warm-up, the
    card synchronized before and after (for calls whose collectives block
    the host, where CUDA events would see only the card)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def sharded_search_rank(dev, card: str, hbm: float, peak_int8: float, t: dict) -> dict:
    """Phase 12a on this rank of the process group (every rank runs it; at
    world size 1 too): the int8 corpus sharded over a "shard" axis of all
    ranks, `kernel: fused`. Checked: this rank's per-shard `fused_mips_binned`
    call takes the `wgmma` body and equals its plain version in every id and
    score; `sharded_dense_search` (its own main path: one launch on this
    rank, on `wgmma`) equals the merge of the ranks' plain per-shard answers
    and is the same on every rank; recall@10 against exact f32 search clears
    `t["recall_floor"]`; with n_real cut so that every real row lies on rank
    0, the other shards return -1 / the int8 sentinel and the search only
    real rows. Timed, one rank at a time: the per-shard kernel, its plain
    version, the library call and the bound; together: the merge (the
    collective and the top-k) and the whole search. Returns the numbers."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from vod_tpu_torch.ops.mips import _INT32_MIN, _binned_body, fused_mips_binned, fused_mips_binned_reference
    from vod_tpu_torch.parallel import all_gather_tensor, axis_group, barrier, make_mesh
    from vod_tpu_torch.search import SearchQueries
    from vod_tpu_torch.search.dense import quantize_queries_int8
    from vod_tpu_torch.search.sharded import build_sharded_dense_index, merge_across_shards, sharded_dense_search

    world, rank = dist.get_world_size(), dist.get_rank()
    backend = dist.get_backend()
    n, d, b, k, bins = t["n"], t["d"], t["b"], t["k"], t["bins"]
    mesh = make_mesh((world,), ("shard",))
    group = axis_group(mesh, "shard")
    g = torch.Generator(device=dev).manual_seed(t["seed"])  # the same corpus on every rank
    corpus = torch.randn((n, d), generator=g, device=dev)
    corpus /= corpus.norm(dim=-1, keepdim=True)
    src = torch.randint(0, n, (b,), generator=g, device=dev)
    q = corpus[src] + 0.1 * torch.randn((b, d), generator=g, device=dev)
    q /= q.norm(dim=-1, keepdim=True)
    exact = torch.topk(q @ corpus.T, k, dim=-1).indices
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index = build_sharded_dense_index(corpus, mesh, axis="shard", dtype="int8", kernel="fused", approx_recall=0.95)
    torch.cuda.synchronize()
    build_ms = (time.perf_counter() - t0) * 1e3
    del corpus
    rows = index.rows_per_shard
    check(rows == n // world and index.local_real == rows and index.vectors.dtype == torch.int8,
          f"12a rank {rank}: shard of {tuple(index.vectors.shape)}, {index.local_real} real rows")
    q_i8, q_scale = quantize_queries_int8(q, index.scale)

    # this rank's per-shard call against its plain version
    body = _binned_body(torch.int8, d, bins, (index.vectors.data_ptr(), q_i8.data_ptr()))
    check(body == "wgmma", f"12a rank {rank}: the per-shard call's body is {body}")
    before = fused_mips_binned.body_launches["wgmma"]
    ks, ki = fused_mips_binned(index.vectors, q_i8, k=k, n_real=index.local_real)
    check(fused_mips_binned.body_launches["wgmma"] == before + 1, f"12a rank {rank}: not on the wgmma body")
    rs, ri = fused_mips_binned_reference(index.vectors, q_i8, k=k, n_real=index.local_real)
    check(torch.equal(ks, rs) and torch.equal(ki, ri), f"12a rank {rank}: per-shard kernel != plain (int8)")

    # the search: this rank's main path
    fused_mips_binned.launches = 0
    fused_mips_binned.body_launches.update(wgmma=0, fma=0)
    out = sharded_dense_search(index, SearchQueries(vector=q), k)
    torch.cuda.synchronize()
    launches = dict(fused_mips_binned.body_launches)
    check(launches == {"wgmma": 1, "fma": 0}, f"12a rank {rank}: the search launched {launches}")

    # the merge of the ranks' plain per-shard answers, and every rank's answer
    offset = index.shard * rows
    plain_s = torch.where(ri >= 0, rs.to(torch.float32) * q_scale, float("-inf"))
    plain_i = torch.where(ri >= 0, ri + offset, -1)
    want_s, want_i = merge_across_shards(plain_s, plain_i, group)
    check(torch.equal(out.indices, want_i.to(torch.int32)) and torch.equal(out.scores, want_s),
          f"12a rank {rank}: the merged answer != the merge of the plain per-shard answers")
    every = all_gather_tensor(out.indices.contiguous(), group)
    check(all(torch.equal(every[r], every[0]) for r in range(world)), "12a: the ranks' merged answers differ")
    got = out.indices.cpu().numpy()
    want = exact.cpu().numpy()
    recall = float(sum(len(set(got[r]) & set(want[r])) for r in range(b)) / (b * k))
    check(recall >= t["recall_floor"], f"12a: recall@10 {recall:.4f} < floor {t['recall_floor']}")

    # every real row on rank 0: the other shards are padding only
    cut = dataclasses.replace(index, n_real=rows - t["pad_cut"])
    before = fused_mips_binned.body_launches["wgmma"]
    cs, ci = fused_mips_binned(cut.vectors, q_i8, k=k, n_real=cut.local_real)
    check(fused_mips_binned.body_launches["wgmma"] == before + 1, f"12a rank {rank}: cut call not on wgmma")
    crs, cri = fused_mips_binned_reference(cut.vectors, q_i8, k=k, n_real=cut.local_real)
    check(torch.equal(cs, crs) and torch.equal(ci, cri), f"12a rank {rank}: cut per-shard kernel != plain")
    if rank > 0:
        check(cut.local_real == 0 and bool((ci == -1).all()) and bool((cs == _INT32_MIN).all()),
              f"12a rank {rank}: a shard of padding only returned rows")
    cut_out = sharded_dense_search(cut, SearchQueries(vector=q), k)
    check(bool(torch.isfinite(cut_out.scores).all()) and int(cut_out.indices.max()) < cut.n_real
          and int(cut_out.indices.min()) >= 0, f"12a rank {rank}: the cut search returned padding")

    # times: the per-shard calls one rank at a time, the collectives together
    nbytes = rows * d + b * d + b * k * 8
    ops = 2 * b * rows * d
    bound = max(nbytes / hbm, ops / peak_int8) * 1e3
    times: dict = {}
    for r in range(world):
        barrier("12a-time")
        if r == rank:
            times = dict(
                ms=time_ms(lambda: fused_mips_binned(index.vectors, q_i8, k=k, n_real=index.local_real), 20),
                plain_ms=time_ms(lambda: fused_mips_binned_reference(index.vectors, q_i8, k=k,
                                                                     n_real=index.local_real), 2),
                library_ms=time_ms(lambda: torch.topk(torch._int_mm(q_i8, index.vectors.T), k, dim=-1), 20),
            )
        barrier("12a-time")
    merge_ms = wall_ms(lambda: merge_across_shards(plain_s, plain_i, group), 20)
    search_ms = wall_ms(lambda: sharded_dense_search(index, SearchQueries(vector=q), k), 20)
    return dict(rank=rank, world=world, backend=backend, rows=rows, local_real=index.local_real, build_ms=build_ms,
                launches=launches, recall_at_10=recall, **times, bound_ms=bound,
                bound_by="bytes" if nbytes / hbm >= ops / peak_int8 else "operations",
                merge_ms=merge_ms, search_ms=search_ms, max_abs_err=0.0, card=card)


def cli_rank(dev, card: str, t: dict, out_dir: Path) -> dict:
    """Phase 12b on this rank: `vod_tpu_torch.exps.cli.main` with the phase's
    YAML, then `main(["--resume_from", run, "--max_steps", ...])`, in the
    process group this rank joined (so `main` keeps it). Instrumented by
    wrapping what the CLI calls: each optimizer step's wall ms, its
    `fused_mips_binned` launches by body, its collectives (bytes, host
    seconds) and a checksum of the parameters broadcast from rank 0 and
    held against this rank's; the re-embeds and the sharded builds; the
    trainer-state writes (rank 0's checkpoints); the checksum after the
    resume's load. The first step's collated batch (and, on rank 0, the
    weights before it) go to `out_dir` for the one-process check."""
    import torch
    import torch.distributed as dist

    from vod_tpu_torch.exps import cli, recipes
    from vod_tpu_torch.ops.mips import fused_mips_binned, fused_mips_binned_reference
    from vod_tpu_torch.parallel import barrier
    from vod_tpu_torch.runtime.state import TrainerState
    from vod_tpu_torch.runtime.train import RealmTrainStep
    from vod_tpu_torch.search import sharded as sharded_mod

    rank, world = dist.get_rank(), dist.get_world_size()
    rec: dict = dict(steps=[], reembed_s=[], builds=[], writes=0, resume_ok=None, coll=[0, 0.0, 0], first=True)
    real = dict(step=RealmTrainStep.train_step_accum, collate=RealmTrainStep.collate, embed=recipes.compute_embeddings,
                build=recipes.build_dense_from_config, save=TrainerState.save, load=cli.load_checkpoint,
                all_reduce=dist.all_reduce, broadcast=dist.broadcast, kernel=sharded_mod.fused_mips_binned)

    def kernel(vectors, queries, **kw):
        if "call" not in rec:  # the loop's first per-shard call, timed after the runs
            rec["call"] = (vectors, queries.clone(), kw)
        return real["kernel"](vectors, queries, **kw)

    def counted(fn):
        def wrapped(tensor, *args, **kw):
            t0 = time.perf_counter()
            out = fn(tensor, *args, **kw)
            rec["coll"][0] += tensor.numel() * tensor.element_size()
            rec["coll"][1] += time.perf_counter() - t0
            rec["coll"][2] += 1
            return out

        return wrapped

    def checksum(model) -> tuple[bool, float]:
        s = torch.stack([p.detach().double().sum() for p in model.parameters()]).sum().reshape(1)
        s0 = s.clone()
        real["broadcast"](s0, src=0)  # rank 0's, uncounted
        return bool(torch.equal(s, s0)), float(s)

    def collate(self, *args, **kw):
        batch = real["collate"](self, *args, **kw)
        if rec["first"]:
            torch.save({k: v.cpu() if isinstance(v, torch.Tensor) else v for k, v in vars(batch).items()},
                       out_dir / f"batch-rank{rank}.pt")
        return batch

    def step(self, engines, corpus, micro, generator, weights, **kw):
        if rec["first"] and rank == 0:
            torch.save({k: v.cpu() for k, v in self.model.state_dict().items()}, out_dir / "state0.pt")
        before = dict(fused_mips_binned.body_launches)
        c0 = list(rec["coll"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real["step"](self, engines, corpus, micro, generator, weights, **kw)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        ok, cs = checksum(self.model)
        rec["steps"].append(dict(
            ms=ms, launches={k: v - before[k] for k, v in fused_mips_binned.body_launches.items()},
            loss=float(out[0]["loss"]), checksum_ok=ok, checksum=cs, rows=int(micro[0].input_ids.shape[0]),
            coll_bytes=rec["coll"][0] - c0[0], coll_s=rec["coll"][1] - c0[1], coll_calls=rec["coll"][2] - c0[2],
            index=type(engines.dense).__name__, local_real=int(getattr(engines.dense, "local_real", -1)),
        ))
        rec["first"] = False
        return out

    def embed(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real["embed"](*args, **kw)
        torch.cuda.synchronize()
        rec["reembed_s"].append(time.perf_counter() - t0)
        return out

    def build(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        index = real["build"](*args, **kw)
        torch.cuda.synchronize()
        rec["builds"].append(dict(ms=(time.perf_counter() - t0) * 1e3, type=type(index).__name__,
                                  rows=int(index.vectors.shape[0]), local_real=int(getattr(index, "local_real", -1))))
        return index

    def save(self, path):
        rec["writes"] += 1
        return real["save"](self, path)

    def load(*args, **kw):
        state = real["load"](*args, **kw)
        rec["resume_ok"] = checksum(kw["model"])[0]
        return state

    dist.all_reduce, dist.broadcast = counted(real["all_reduce"]), counted(real["broadcast"])
    RealmTrainStep.train_step_accum, RealmTrainStep.collate = step, collate
    recipes.compute_embeddings, recipes.build_dense_from_config = embed, build
    TrainerState.save, cli.load_checkpoint = save, load
    sharded_mod.fused_mips_binned = kernel
    torch.cuda.reset_peak_memory_stats(dev)
    first = cli.main(["--config", t["yaml"], "--backend", t["backend"]])
    resumed = cli.main(["--resume_from", t["run"], "--max_steps", str(t["resume_steps"]), "--backend", t["backend"]])
    n_params = sum(p.numel() for p in first["model"].parameters())

    # the loop's per-shard call against its plain version, then timed one rank at a time
    v, q, kw = rec["call"]
    ks, ki = real["kernel"](v, q, **kw)
    rs, ri = fused_mips_binned_reference(v, q, **kw)
    check(torch.equal(ks, rs) and torch.equal(ki, ri), f"12b rank {rank}: the loop's per-shard call != plain")
    b, d = (int(x) for x in q.shape)
    nbytes = int(v.shape[0]) * d + b * d + b * kw["k"] * 8
    ops = 2 * b * int(v.shape[0]) * d
    call = dict(shape=f"int8 B={b} D={d} rows={int(v.shape[0])} n_real={kw['n_real']} k={kw['k']}",
                bound_ms=max(nbytes / t["hbm"], ops / t["peak_int8"]) * 1e3,
                bound_by="bytes" if nbytes / t["hbm"] >= ops / t["peak_int8"] else "operations")
    for r in range(world):
        barrier("12b-time")
        if r == rank:
            call.update(
                ms=time_ms(lambda: real["kernel"](v, q, **kw), 20),
                plain_ms=time_ms(lambda: fused_mips_binned_reference(v, q, **kw), 3),
                library_ms=time_ms(lambda: torch.topk(torch._int_mm(q, v.T), kw["k"], dim=-1), 20) if b > 16 else None,
            )
        barrier("12b-time")
    return dict(rank=rank, call=call, steps=rec["steps"], reembed_s=rec["reembed_s"], builds=rec["builds"], writes=rec["writes"],
                resume_ok=rec["resume_ok"], first_step=first["state"].step, resumed_step=resumed["state"].step,
                periods=[len(first["history"]), len(resumed["history"])], n_params=n_params,
                peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30, backend=dist.get_backend())


def compressed_search_rank(dev, card: str, t: dict) -> dict:
    """Phase 13a on this rank of the process group (every rank runs it; at
    world size 1 too), module constant COMPRESSED. First the collective the
    MaxSim merge needs: an `all_reduce` (MAX) of a CUDA tensor holding -inf.
    Then, for each of pq, ivf and ivfpq: the factory's sharded build over a
    "shard" axis of every rank (the unsharded index it shards is kept for
    the checks), and the search through the hybrid's dispatch, the main path
    of that engine (no kernel launches on it: JAX's sharded compressed
    searches are plain XLA). Checked: every rank holds the same answer; IVF
    and the untruncated IVF-PQ give the unsharded index's ids where the score
    margin exceeds `t["tol"]`; PQ and the preset's (truncated) IVF-PQ reach
    the unsharded recall@10 less `t["recall_slack"]`; `kmeans_sharded` from
    the first 1,024 rows against `kmeans` from the same rows (see
    `COMPRESSED`); the sharded
    IVF-PQ autotune meets its target; MaxSim's sharded rerank equals the
    unsharded one exactly. Timed: each build; each shard's part of the search
    (CUDA events, one rank at a time), the merge (host wall), the whole
    search (host wall, and the card's kernel time from the profiler).
    Returns the numbers."""
    import importlib

    import torch
    import torch.distributed as dist

    from vod_tpu_torch.configs import DenseFactoryConfig
    from vod_tpu_torch.examples.maxsim_bench import _slab
    from vod_tpu_torch.ops.kmeans import infer_n_clusters, kmeans, kmeans_sharded
    from vod_tpu_torch.ops.mips import fused_mips_binned, fused_mips_topk
    from vod_tpu_torch.parallel import all_gather_tensor, axis_group, barrier, make_mesh
    from vod_tpu_torch.search import SearchQueries, build_dense_from_config, ivf_search, ivfpq_search, pq_search
    from vod_tpu_torch.search import sharded as sm
    from vod_tpu_torch.search.hybrid import _dense_dispatch
    from vod_tpu_torch.search.maxsim import MaxSimIndex, maxsim_rerank

    autotune = importlib.import_module("vod_tpu_torch.search.autotune")
    world, rank = dist.get_world_size(), dist.get_rank()
    backend = dist.get_backend()
    k = t["k"]
    mesh = make_mesh((world,), ("shard",))
    group = axis_group(mesh, "shard")
    probe = torch.tensor([float("-inf"), float(rank)], device=dev)
    dist.all_reduce(probe, op=dist.ReduceOp.MAX, group=group)
    check(bool(torch.isneginf(probe[0])) and float(probe[1]) == world - 1,
          f"13a rank {rank}: all_reduce(MAX) over {backend} on a CUDA tensor gave {probe.tolist()}")

    g = torch.Generator(device=dev).manual_seed(t["seed"])  # the same corpus on every rank
    corpus, draw = clustered_corpus(t["n"], t["d"], t, g, dev)
    q = draw(t["b"])
    exact, _ = exact_ids(q, corpus, k)
    qs = SearchQueries(vector=q)
    out: dict = dict(rank=rank, world=world, backend=backend, card=card)

    def zero_launches() -> None:
        for kern in (fused_mips_binned, fused_mips_topk):
            kern.launches = 0
            kern.body_launches.update(wgmma=0, fma=0)

    def launches() -> dict:
        return {"fused_mips_binned": fused_mips_binned.launches, "fused_mips_topk": fused_mips_topk.launches}

    def one_rank_at_a_time(fn, reps: int) -> float:
        ms = 0.0
        for r in range(world):
            barrier("13a-time")
            if r == rank:
                ms = time_ms(fn, reps)
            barrier("13a-time")
        return ms

    # the unsharded index each build shards, caught on its way into the shard function
    caught: dict = {}
    real = {name: getattr(sm, name) for name in ("shard_pq_index", "shard_ivf_index", "shard_ivfpq_index")}

    def catching(name):
        def shard(index, *args, **kw):
            caught["full"] = index
            return real[name](index, *args, **kw)

        return shard

    def ivfpq_part(ix, qq, kk):
        pool = sm.ivfpq_shard_pool(ix, qq, kk)
        return pool.scores, pool.indices

    plain = dict(pq=pq_search, ivf=ivf_search, ivfpq=ivfpq_search)
    local = dict(pq=sm.pq_shard_topk, ivf=sm.ivf_shard_topk, ivfpq=ivfpq_part)
    for name in real:
        setattr(sm, name, catching(name))
    try:
        for engine in ("pq", "ivf", "ivfpq"):
            cfg = DenseFactoryConfig(**t[engine], sharded=True, shard_axis="shard")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ix = build_dense_from_config(cfg, corpus, mesh=mesh, device=dev)
            torch.cuda.synchronize()
            build_ms = (time.perf_counter() - t0) * 1e3
            full = caught.pop("full")
            zero_launches()  # the engine's main path: the search through the hybrid's dispatch
            got = _dense_dispatch(ix, qs, k)
            torch.cuda.synchronize()
            path_launches = launches()
            check(path_launches == {"fused_mips_binned": 0, "fused_mips_topk": 0},
                  f"13a {engine} rank {rank}: the sharded search launched {path_launches}")
            every = all_gather_tensor(got.indices.contiguous(), group)
            check(all(torch.equal(every[r], every[0]) for r in range(world)), f"13a {engine}: the ranks' answers differ")
            want = plain[engine](full, qs, k)
            rec, rec_plain = recall_at(got.indices, exact), recall_at(want.indices, exact)
            res = dict(type=type(ix).__name__, build_ms=build_ms, recall_at_10=rec, unsharded_recall_at_10=rec_plain,
                       launches=path_launches)
            if engine == "ivf":
                res["max_score_err"], res["band_swaps"] = check_sparse_close(f"13a ivf rank {rank}", got, want, t["tol"])
            else:
                check(rec >= rec_plain - t["recall_slack"],
                      f"13a {engine}: recall@10 {rec:.4f} < the unsharded {rec_plain:.4f} - {t['recall_slack']}")
            if engine == "ivfpq":
                untruncated = full.replace(max_windows=0)
                u_got = _dense_dispatch(real["shard_ivfpq_index"](untruncated, mesh, axis="shard"), qs, k)
                res["untruncated_max_score_err"], res["untruncated_band_swaps"] = check_sparse_close(
                    f"13a ivfpq untruncated rank {rank}", u_got, ivfpq_search(untruncated, qs, k), t["tol"])
                res["untruncated_recall_at_10"] = recall_at(u_got.indices, exact)
                # the coarse quantizer's k-means over the axis against one process's, from the same rows
                c = infer_n_clusters(t["n"])
                init = corpus[:c].clone()

                def lloyd(fn, iters: int, *args) -> tuple:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    cent, assign = fn(corpus, c, *args, n_iters=iters, init=init,
                                      generator=torch.Generator(device=dev).manual_seed(t["seed"]))
                    torch.cuda.synchronize()
                    return cent, assign, (time.perf_counter() - t0) * 1e3

                def rel(a, b_) -> float:
                    return float(torch.linalg.vector_norm(a - b_) / torch.linalg.vector_norm(b_))

                def objective(cent, assign) -> float:
                    return float(sum(((corpus[s0:s0 + 131072] - cent[assign[s0:s0 + 131072].long()]) ** 2).sum()
                                     for s0 in range(0, t["n"], 131072))) / t["n"]

                sharded_kmeans = functools.partial(kmeans_sharded, axis="shard")
                one_s, _, _ = lloyd(lambda x, k_, *a, **kw: sharded_kmeans(x, k_, mesh, **kw), 1)
                one_u, _, _ = lloyd(kmeans, 1)
                res["kmeans_one_iter_rel"] = rel(one_s, one_u)
                cs, a_s, res["kmeans_sharded_ms"] = lloyd(lambda x, k_, *a, **kw: sharded_kmeans(x, k_, mesh, **kw),
                                                          cfg.kmeans_iters)
                cu, a_u, res["kmeans_ms"] = lloyd(kmeans, cfg.kmeans_iters)
                cu2, _, _ = lloyd(kmeans, cfg.kmeans_iters)  # the control: one process against itself
                res["kmeans_rel"], res["kmeans_control_rel"] = rel(cs, cu), rel(cu2, cu)
                res["kmeans_moved_rows"] = int((a_s != a_u).sum())
                j_s, j_u = objective(cs, a_s), objective(cu, a_u)
                res["kmeans_objective_rel"] = abs(j_s - j_u) / j_u
                check(res["kmeans_one_iter_rel"] <= t["kmeans_rtol"] and res["kmeans_objective_rel"] <= t["kmeans_rtol"],
                      f"13a rank {rank}: kmeans_sharded against kmeans: one iteration {res['kmeans_one_iter_rel']:.3g}, "
                      f"the objective after {cfg.kmeans_iters} {res['kmeans_objective_rel']:.3g} (relative)")
                del cs, cu, cu2, a_s, a_u, one_s, one_u
                # the autotuner over the sharded index, in lockstep on every rank
                tcfg = dataclasses.replace(cfg, autotune_target_recall=t["target_recall"], autotune_measure_time=False)
                tuned, info = autotune.autotune_after_build(ix, tcfg, corpus,
                                                            generator=torch.Generator(device=dev).manual_seed(1))
                _, info_plain = autotune.autotune_after_build(full, tcfg, corpus,
                                                              generator=torch.Generator(device=dev).manual_seed(1))
                check(info["met"] and tuned.nprobe == info["params"]["nprobe"],
                      f"13a rank {rank}: the sharded IVF-PQ autotune did not meet its target: {info['params']} "
                      f"{info['recall']}")
                res.update(autotune=info["params"], autotune_recall=info["recall"],
                           autotune_unsharded=info_plain["params"], autotune_unsharded_recall=info_plain["recall"])
            # times: this shard's part one rank at a time, the merge and the whole search together
            part = local[engine]
            res["shard_ms"] = one_rank_at_a_time(lambda: part(ix, qs, k), 10)
            loc_s, loc_i = part(ix, qs, k)
            keep = int(loc_s.shape[-1]) * (2 if getattr(ix, "spilled", False) else 1)
            res["merge_ms"] = wall_ms(lambda: sm.merge_across_shards(loc_s, loc_i, group, keep=keep), 20)
            res["search_ms"] = wall_ms(lambda: _dense_dispatch(ix, qs, k), 10)
            res["search_host_ms"], res["search_device_ms"], _ = host_and_device_ms(lambda: _dense_dispatch(ix, qs, k), 5)
            out[engine] = res
            del ix, full, got, want
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        for name, fn in real.items():
            setattr(sm, name, fn)
    del corpus

    # MaxSim at maxsim_bench's defaults: the int8 token store, sharded by rows
    tm = t["maxsim"]
    n, lt, d = tm["n"], tm["lt"], tm["d"]
    gm = torch.Generator(device=dev).manual_seed(1)
    topics = torch.nn.functional.normalize(torch.randn((tm["n_topics"], d), generator=gm, device=dev), dim=-1)
    slab = 65_536
    n_pad = -(-n // slab) * slab
    scale = torch.full((1, d), 1.2 / 127.0, device=dev)
    codes = torch.empty((n_pad, lt, d), dtype=torch.int8, device=dev)
    for i in range(n_pad // slab):
        x = _slab(i, slab, topics, lt, dev)
        codes[i * slab : (i + 1) * slab] = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    store = MaxSimIndex(token_codes=codes, token_mask=torch.ones((n_pad, lt), dtype=torch.bool, device=dev),
                        scale=scale, n_real=n)
    b, c = t["b"], tm["n_candidates"]
    src = torch.randint(0, n, (b,), generator=gm, device=dev)
    q_tok = codes[src][:, : tm["lq"]].to(torch.float32) * scale + 0.1 * torch.randn((b, tm["lq"], d), generator=gm,
                                                                                   device=dev)
    q_mask = torch.ones((b, tm["lq"]), dtype=torch.bool, device=dev)
    cand = torch.randint(0, n, (b, c), generator=gm, device=dev)
    cand[:, 0] = src
    cand[:, -8:] = -1
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    six = sm.shard_maxsim_index(store, mesh, axis="shard")
    torch.cuda.synchronize()
    build_ms = (time.perf_counter() - t0) * 1e3
    zero_launches()
    got = sm.sharded_maxsim_rerank(six, q_tok, q_mask, cand)  # the MaxSim main path
    torch.cuda.synchronize()
    path_launches = launches()
    check(path_launches == {"fused_mips_binned": 0, "fused_mips_topk": 0}, f"13a maxsim: launched {path_launches}")
    want = maxsim_rerank(store, q_tok, q_mask, cand)
    check(torch.equal(got, want), f"13a rank {rank}: the sharded MaxSim scores != the unsharded ones")
    part = sm.maxsim_shard_scores(six, q_tok, q_mask, cand)
    out["maxsim"] = dict(
        type=type(six).__name__, rows=six.rows_per_shard, build_ms=build_ms, launches=path_launches,
        top1_is_source=float((torch.gather(cand, 1, got.argmax(-1, keepdim=True))[:, 0] == src).float().mean()),
        shard_ms=one_rank_at_a_time(lambda: sm.maxsim_shard_scores(six, q_tok, q_mask, cand), 10),
        merge_ms=wall_ms(lambda: dist.all_reduce(part.clone(), op=dist.ReduceOp.MAX, group=group), 20),
        search_ms=wall_ms(lambda: sm.sharded_maxsim_rerank(six, q_tok, q_mask, cand), 10),
    )
    out["maxsim"]["search_host_ms"], out["maxsim"]["search_device_ms"], _ = host_and_device_ms(
        lambda: sm.sharded_maxsim_rerank(six, q_tok, q_mask, cand), 5)
    out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    return out


def batchwide_cli_rank(dev, card: str, t: dict, out_dir: Path) -> dict:
    """Phase 13b (`t["kind"]` "pq") or 13c ("splade") on this rank:
    `vod_tpu_torch.exps.cli.main` with the phase's YAML (13b then the
    resume), in the process group this rank joined. Instrumented by wrapping
    what the CLI calls: each optimizer step's wall ms, loss, launches of both
    kernels, collectives (bytes, host seconds) and a checksum of the
    parameters against rank 0's; the dense builds and re-embeds; 13b the
    first in-loop `sharded_pq_search` call, run again directly after the
    runs; 13c the first impact re-embed (its inputs and terms) and learned
    table (to `out_dir`). The first step's collated batch (and, on rank 0,
    the weights before it) go to `out_dir` for the one-process checks. With
    `t["gradcache_rows"]`, phase 15d's GradCache steps follow the CLI run
    (`gradcache_dp_steps`)."""
    import torch
    import torch.distributed as dist

    from vod_tpu_torch.exps import cli, recipes
    from vod_tpu_torch.ops.mips import fused_mips_binned, fused_mips_topk
    from vod_tpu_torch.runtime.train import RealmTrainStep
    from vod_tpu_torch.search import hybrid as hybrid_mod

    rank, world = dist.get_rank(), dist.get_world_size()
    rec: dict = dict(steps=[], builds=[], reembed_s=[], coll=[0, 0.0, 0], first=True, micro=0)
    real = dict(step=RealmTrainStep.train_step_accum, collate=RealmTrainStep.collate, all_reduce=dist.all_reduce,
                broadcast=dist.broadcast, search=hybrid_mod.sharded_pq_search, build=recipes.build_dense_from_config,
                embed=recipes.compute_embeddings, terms=recipes.encode_corpus_terms, impact=recipes.build_impact_index)

    def counted(fn):
        def wrapped(tensor, *args, **kw):
            t0 = time.perf_counter()
            out = fn(tensor, *args, **kw)
            rec["coll"][0] += tensor.numel() * tensor.element_size()
            rec["coll"][1] += time.perf_counter() - t0
            rec["coll"][2] += 1
            return out

        return wrapped

    def checksum(model) -> bool:
        s = torch.stack([p.detach().double().sum() for p in model.parameters()]).sum().reshape(1)
        s0 = s.clone()
        real["broadcast"](s0, src=0)  # rank 0's, uncounted
        return bool(torch.equal(s, s0))

    def collate(self, *args, **kw):
        batch = real["collate"](self, *args, **kw)
        if rec["first"]:  # each micro-batch of the first step
            torch.save({k: v.cpu() if isinstance(v, torch.Tensor) else v for k, v in vars(batch).items()},
                       out_dir / f"batch-rank{rank}-{rec['micro']}.pt")
            rec["micro"] += 1
        return batch

    def step(self, engines, corpus, micro, generator, weights, **kw):
        if rec["first"] and rank == 0:
            torch.save({k: v.cpu() for k, v in self.model.state_dict().items()}, out_dir / "state0.pt")
        before = (fused_mips_binned.launches, fused_mips_topk.launches)
        c0 = list(rec["coll"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real["step"](self, engines, corpus, micro, generator, weights, **kw)
        torch.cuda.synchronize()
        rec["steps"].append(dict(
            ms=(time.perf_counter() - t0) * 1e3, loss=float(out[0]["loss"]), checksum_ok=checksum(self.model),
            launches=[fused_mips_binned.launches - before[0], fused_mips_topk.launches - before[1]],
            rows=int(micro[0].input_ids.shape[0]), micro=len(micro), coll_bytes=rec["coll"][0] - c0[0],
            coll_s=rec["coll"][1] - c0[1], dense=type(engines.dense).__name__, sparse=type(engines.sparse).__name__,
        ))
        rec["first"] = False
        return out

    def search(index, queries, top_k, **kw):
        out = real["search"](index, queries, top_k, **kw)
        if "search" not in rec:
            rec["search"] = (index, queries, top_k, kw, out.scores.clone(), out.indices.clone())
        return out

    def timed(name, key):
        def wrapped(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real[name](*args, **kw)
            torch.cuda.synchronize()
            rec[key].append(time.perf_counter() - t0)
            return out

        return wrapped

    def build(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        index = real["build"](*args, **kw)
        torch.cuda.synchronize()
        rec["builds"].append(dict(ms=(time.perf_counter() - t0) * 1e3, type=type(index).__name__))
        return index

    def terms(encode_fn, input_ids, attention_mask, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real["terms"](encode_fn, input_ids, attention_mask, **kw)
        torch.cuda.synchronize()
        rec["reembed_s"].append(time.perf_counter() - t0)
        if len(rec["reembed_s"]) == 1:
            saved = dict(terms=torch.from_numpy(out[0]), weights=torch.from_numpy(out[1]), k=kw["k"],
                         chunk=kw["chunk"])
            if rank == 0:
                saved.update(input_ids=input_ids.cpu(), attention_mask=attention_mask.cpu())
            torch.save(saved, out_dir / f"terms-rank{rank}.pt")
        return out

    def impact(*args, **kw):
        index = real["impact"](*args, **kw)
        if "impact" not in rec:
            rec["impact"] = True
            torch.save(dict(docs=index.postings_docs.cpu(), impacts=index.postings_impacts.cpu(), n_terms=kw["n_terms"],
                            max_postings=kw["max_postings"]), out_dir / f"impact-rank{rank}.pt")
        return index

    dist.all_reduce, dist.broadcast = counted(real["all_reduce"]), counted(real["broadcast"])
    RealmTrainStep.train_step_accum, RealmTrainStep.collate = step, collate
    hybrid_mod.sharded_pq_search = search
    recipes.build_dense_from_config, recipes.compute_embeddings = build, timed("embed", "reembed_s")
    recipes.encode_corpus_terms, recipes.build_impact_index = terms, impact
    torch.cuda.reset_peak_memory_stats(dev)
    for kern in (fused_mips_binned, fused_mips_topk):
        kern.launches = 0
    first = cli.main(["--config", t["yaml"], "--backend", t["backend"]])
    gradcache = None
    if t.get("gradcache_rows"):  # phase 15d
        gradcache = gradcache_dp_steps(dev, first, t, out_dir, real["step"], checksum)
    resumed = None
    if t.get("run"):
        resumed = cli.main(["--resume_from", t["run"], "--max_steps", str(t["resume_steps"]), "--backend",
                            t["backend"]])
    path_launches = [fused_mips_binned.launches, fused_mips_topk.launches]
    res = dict(rank=rank, world=world, backend=dist.get_backend(), steps=rec["steps"], builds=rec["builds"],
               reembed_s=rec["reembed_s"], first_step=first["state"].step, launches=path_launches,
               resumed_step=None if resumed is None else resumed["state"].step,
               autotune=[h.get("autotune", {}).get("params") for h in first["history"]],
               autotune_met=[h.get("autotune", {}).get("met") for h in first["history"]],
               n_params=sum(p.numel() for p in first["model"].parameters()),
               peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30, card=card, gradcache=gradcache)
    if "search" in rec:  # the collate's sharded PQ search, run again directly (a collective: every rank)
        index, queries, top_k, kw, scores, ids = rec["search"]
        again = real["search"](index, queries, top_k, **kw)
        res["direct_equal"] = bool(torch.equal(again.indices, ids) and torch.equal(again.scores, scores))
        res["search_index"] = dict(type=type(index).__name__, rows=index.rows_per_shard, local_real=index.local_real)
    return res


def one_process_batch(out_dir: Path, world: int, dev, micro: int = 0):
    """Micro-batch `micro` of the first step as one process collates it,
    from the ranks' rows: the per-query fields concatenated in rank order; a
    pooled section field (in-batch negatives: the same pool on every rank)
    taken once."""
    import torch

    from vod_tpu_torch.types.batch import RealmBatch

    parts = [torch.load(out_dir / f"batch-rank{r}-{micro}.pt", weights_only=False) for r in range(world)]
    flat = parts[0]["extras"].get("flat_sections", False)
    fields = {}
    for k, v in parts[0].items():
        if not isinstance(v, torch.Tensor):
            fields[k] = v
        elif flat and k in ("section__input_ids", "section__attention_mask"):
            check(all(torch.equal(p[k], v) for p in parts), f"the ranks' pooled {k} differ")
            fields[k] = v.to(dev)
        else:
            fields[k] = torch.cat([p[k] for p in parts]).to(dev)
    return RealmBatch(**fields)


def batchwide_phase(dev, card: str, ta: dict, tb: dict, tc: dict) -> dict:
    """Phase 13: the sharded compressed indexes (13a, `COMPRESSED`) and
    batch-wide training over a data-parallel group (13b `PQ_CLI`, 13c
    `SPLADE_DP`). 13a: `compressed_search_rank` at world size 1 under NCCL in
    this process, then on `ta["ranks"]` gloo ranks of the one card. 13b / 13c:
    the CLI under torchrun on two gloo ranks of the card, `batchwide_cli_rank`
    on each. Checked: every step's loss finite and both ranks' parameters
    equal after it; no kernel launch on any phase-13 path (JAX launches none
    there); the first step's loss over the ranks within the tolerance of one
    process's on the same global batch (13c: the FLOPS term included); 13b:
    a `ShardedPQIndex` built every period, tuned every period to the same
    point on both ranks, in-batch negatives pooled over the global batch
    (each rank's rows against one pool), the collate's sharded search equal
    to a direct call, the resume; 13c: the learned reindex split over the
    ranks equals one process's. 13d: with two or more cards, 13a under NCCL
    at world size = their count. Returns the numbers."""
    import tempfile

    import torch

    from vod_tpu_torch.exps import cli
    from vod_tpu_torch.exps.structconf import Experiment
    from vod_tpu_torch.models import collect_losses
    from vod_tpu_torch.models.splade import encode_corpus_terms
    from vod_tpu_torch.parallel import init_distributed
    from vod_tpu_torch.runtime.gradcache import gradcache_backward
    from vod_tpu_torch.search import build_impact_index

    started = time.perf_counter()
    tmp = tempfile.TemporaryDirectory()
    root = Path(tmp.name)
    out: dict = {}
    engines = ("pq", "ivf", "ivfpq", "maxsim")

    def log_13a(r: dict, label: str) -> None:
        for e in engines:
            x = r[e]
            extra = ""
            if e != "maxsim":
                extra = f"; recall@10 {x['recall_at_10']:.4f} (unsharded {x['unsharded_recall_at_10']:.4f})"
            if e == "ivfpq":
                extra += (f", untruncated {x['untruncated_recall_at_10']:.4f}; kmeans_sharded {x['kmeans_sharded_ms']:.1f}"
                          f" ms, kmeans {x['kmeans_ms']:.1f} ms; relative distance after one iteration "
                          f"{x['kmeans_one_iter_rel']:.3g}, after all {x['kmeans_rel']:.3g} (kmeans against itself "
                          f"{x['kmeans_control_rel']:.3g}), objective {x['kmeans_objective_rel']:.3g}, "
                          f"{x['kmeans_moved_rows']} rows in other cells; autotune {x['autotune']} "
                          f"(recall {x['autotune_recall']}), unsharded {x['autotune_unsharded']} "
                          f"({x['autotune_unsharded_recall']})")
            log(f"13a {label} {e} ({x['type']}): build {x['build_ms']:.1f} ms; per-shard {x['shard_ms']:.4f} ms, merge "
                f"{x['merge_ms']:.4f} ms, search {x['search_ms']:.4f} ms (host enqueue {x['search_host_ms']:.4f}, card "
                f"{x['search_device_ms']:.4f}){extra} [{card}]")
        log(f"13a {label}: peak {r['peak_gib']:.4f} GiB")

    # 13a at world size 1: a real NCCL group in this process
    check(init_distributed(num_processes=1, process_id=0, device="cuda", init_method=f"file://{root / 'pg'}")
          == (0, 1), "13a: the world-size-1 group did not form")
    try:
        out["w1"] = compressed_search_rank(dev, card, ta)
    finally:  # a failed check exits at once, not after NCCL's watchdog times out
        torch.distributed.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    log_13a(out["w1"], f"world 1 ({out['w1']['backend']})")

    # 13a over two ranks of the one card (gloo)
    ranks, wall = torchrun("compressed", ta["ranks"], root, dict(ta, backend="gloo"), ta["timeout"])
    out["gloo"] = ranks
    for r in ranks:
        check(r["backend"] == "gloo", f"13a rank {r['rank']}: backend {r['backend']}")
        log_13a(r, f"rank {r['rank']}/{r['world']} (gloo, both on one card)")
    log(f"13a over {ta['ranks']} gloo ranks: torchrun wall {wall:.1f} s")

    def datasets(h: dict) -> str:
        return ("datasets:\n"
                "  queries:\n"
                f"    - {{identifier: harvest-train, name_or_path: beir, subsets: ['{h['beir']}'], split: train, "
                "link: harvest-corpus}\n"
                "  sections:\n"
                f"    - {{identifier: harvest-corpus, name_or_path: beir, subsets: ['{h['beir']}']}}\n")

    def run_ranks(job: str, t: dict, d: Path) -> tuple[list, float]:
        ranks, wall = torchrun(job, t["ranks"], d, t, t["timeout"])
        for r in ranks:
            label = f"13{'b' if job == 'pq_cli' else 'c'} rank {r['rank']}"
            check(r["backend"] == "gloo" and r["first_step"] == t["max_steps"], f"{label}: {r['first_step']} steps")
            check(all(math.isfinite(s["loss"]) for s in r["steps"]), f"{label}: a loss is not finite")
            check(all(s["checksum_ok"] for s in r["steps"]), f"{label}: parameters differ from rank 0's after a step")
            check(r["launches"] == [0, 0] and all(s["launches"] == [0, 0] for s in r["steps"]),
                  f"{label}: a kernel launched on the path: {r['launches']}")
        return ranks, wall

    def first_loss_check(label: str, ranks: list, d: Path, exp, sown: bool) -> dict:
        model = cli.build_model(exp.model, proposal_temperature=exp.collate.temperature, device=dev,
                                generator=torch.Generator(device=dev).manual_seed(exp.sys.seed))
        model.load_state_dict(torch.load(d / "state0.pt", weights_only=True))
        losses = []
        for i in range(ranks[0]["steps"][0]["micro"]):  # the step's loss: the mean over its micro-batches
            batch = one_process_batch(d, len(ranks), dev, i)
            with torch.no_grad(), collect_losses(model) as terms:
                losses.append(float(model(batch, mode="evaluate").loss + (sum(terms) if terms else 0.0)))
            check(not sown or len(terms) == 1, f"{label}: the one-process pass sowed {len(terms)} terms")
            del batch
        single = sum(losses) / len(losses)
        first = sum(r["steps"][0]["loss"] for r in ranks) / len(ranks)
        rel = abs(first - single) / max(abs(single), 1e-12)
        check(rel <= (tb if label == "13b" else tc)["loss_rtol"],
              f"{label}: first-step loss {first:.6f} over the ranks != one process's {single:.6f}")
        del model
        gc.collect()
        torch.cuda.empty_cache()
        return dict(first_loss=first, one_process_loss=single, first_loss_rel=rel)

    def step_summary(label: str, ranks: list, period: int) -> None:
        for r in ranks:
            steady = [s["ms"] for i, s in enumerate(r["steps"]) if i % period != 0] or [s["ms"] for s in r["steps"]]
            r["step_median_ms"] = statistics.median(steady)
            r["coll_share"] = sum(s["coll_s"] for s in r["steps"]) * 1e3 / sum(s["ms"] for s in r["steps"])
            r["coll_bytes_step"] = statistics.median([s["coll_bytes"] for s in r["steps"]])
            log(f"{label} rank {r['rank']} (gloo, both on one card): {len(r['steps'])} steps, median {r['step_median_ms']:.2f}"
                f" ms (first of each period left out), {r['coll_bytes_step']:,} bytes of collectives a step "
                f"({r['coll_share']:.3f} of the step, host wall); re-embeds {[round(x, 2) for x in r['reembed_s']]} s; "
                f"builds {[(b_['type'], round(b_['ms'], 1)) for b_ in r['builds']]}; peak {r['peak_gib']:.4f} GiB; "
                f"losses {[round(s['loss'], 5) for s in r['steps']]}; {r['n_params']:,} parameters [{card}]")

    # 13b: configs/msmarco_pq_realm.yaml through the CLI on two gloo ranks
    d = root / "pq"
    h = harvest_beir(d, tb)
    run = d / "run"
    yaml_path = d / "exp.yaml"
    yaml_path.write_text(
        f"extends: ['{ROOT / 'configs' / 'msmarco_pq_realm.yaml'}', strategy/dp]\n"
        f"tokenizer: {{name_or_path: '{h['vocab_dir']}', max_length: {tb['max_length']}}}\n"
        "collate: {in_batch_negatives: true}\n"
        f"dataloader: {{batch_size: {tb['batch_size']}}}\n"
        "search_defaults:\n"
        f"  dense: {{sharded: true, shard_axis: dp, autotune_target_recall: {tb['target_recall']}}}\n"
        f"trainer: {{max_steps: {tb['max_steps']}, period: {tb['period']}, log_interval: 1, checkpoint_path: '{run}', "
        f"batch_size: {{effective: {2 * tb['batch_size']}, per_device: {tb['batch_size']}}}}}\n"
        + datasets(h)
    )
    exp = Experiment.from_file(str(yaml_path))
    m, col, dn = exp.model, exp.collate, exp.search_defaults.dense
    check((m.kind, m.gradients, m.hidden_size, m.num_layers, m.lm_hidden_size, m.lm_num_layers) ==
          ("realm", "vod", 384, 6, 384, 6)
          and (dn.codec, dn.n_subquantizers, dn.code_bits, dn.coarse_dim, dn.refine, dn.refine_dim, dn.k_factor) ==
          ("pq", 128, 4, None, "int8", 128, 32)
          and (dn.sharded, dn.shard_axis, dn.autotune_target_recall, col.in_batch_negatives, col.n_sections) ==
          (True, "dp", tb["target_recall"], True, 8)
          and (list(exp.sys.mesh_shape), list(exp.sys.mesh_axes)) == ([-1], ["dp"])
          and (exp.tokenizer.max_length, exp.trainer.accumulate_grad_batches) == (tb["max_length"], 2),
          "13b: the parsed Experiment is not msmarco_pq_realm under the phase's overrides")
    log(f"13b inputs: {tb['n']} passages harvested in {h['harvest_s']:.2f} s; {tb['queries']} queries")
    ranks, wall = run_ranks("pq_cli", dict(tb, backend="gloo", yaml=str(yaml_path), run=str(run)), d)
    for r in ranks:
        label = f"13b rank {r['rank']}"
        check(r["resumed_step"] == tb["resume_steps"], f"{label}: resumed to {r['resumed_step']}")
        check(len(r["steps"]) == tb["resume_steps"] and all(s["micro"] == 2 and s["rows"] == tb["batch_size"] //
                                                            tb["ranks"] for s in r["steps"]),
              f"{label}: steps over {[(s['micro'], s['rows']) for s in r['steps']]}")
        check(all(s["dense"] == "ShardedPQIndex" for s in r["steps"]) and len(r["builds"]) == 3
              and all(b_["type"] == "ShardedPQIndex" for b_ in r["builds"]), f"{label}: builds {r['builds']}")
        check(all(a is not None for a in r["autotune"]), f"{label}: a period was not tuned: {r['autotune']}")
        check(r["direct_equal"], f"{label}: the collate's sharded_pq_search != a direct call")
    check(ranks[0]["autotune"] == ranks[1]["autotune"], "13b: the ranks took different operating points")
    batch0 = torch.load(d / "batch-rank0-0.pt", weights_only=False)
    check(batch0["extras"].get("flat_sections", False) and batch0["section__input_ids"].shape[0]
          == tb["batch_size"] * exp.collate.n_sections, "13b: the first batch does not pool the global batch's sections")
    out["pq_cli"] = dict(ranks=ranks, wall_s=wall, **first_loss_check("13b", ranks, d, exp, sown=False))
    step_summary("13b", ranks, tb["period"])
    log(f"13b: autotune {ranks[0]['autotune']} (target met: {ranks[0]['autotune_met']}); the collate's sharded search equals a direct call on both ranks "
        f"({ranks[0]['search_index']}); first-step loss over the ranks {out['pq_cli']['first_loss']:.6f}, one process "
        f"{out['pq_cli']['one_process_loss']:.6f} (rel {out['pq_cli']['first_loss_rel']:.2e}); torchrun wall "
        f"{wall:.1f} s [{card}]")

    # 13c: phase 11a's SPLADE composition under strategy/dp on two gloo ranks
    d = root / "splade"
    h = harvest_beir(d, tc)
    write_hf_checkpoint(d / "ckpt", tc, dev, head="mlm")
    hf = tc["hf"]
    yaml_path = d / "exp.yaml"
    yaml_path.write_text(
        f"extends: ['{ROOT / 'configs' / 'scifact_ranker.yaml'}', strategy/dp]\n"
        f"model: {{splade_encoder: true, splade_flops_weight: {tc['flops_weight']}, splade_query_k: {tc['query_k']}, "
        f"splade_doc_k: {tc['doc_k']}, splade_max_postings: {tc['max_postings']}, vocab_size: {hf['vocab_size']}, "
        f"hidden_size: {hf['hidden_size']}, num_layers: {hf['num_hidden_layers']}, "
        f"num_heads: {hf['num_attention_heads']}, intermediate_size: {hf['intermediate_size']}, "
        f"name_or_path: '{d / 'ckpt'}', hf_fallback: error}}\n"
        f"tokenizer: {{name_or_path: '{h['vocab_dir']}', max_length: {tc['max_length']}}}\n"
        f"trainer: {{max_steps: {tc['max_steps']}, period: {tc['period']}, log_interval: 1}}\n"
        + datasets(h)
    )
    exp = Experiment.from_file(str(yaml_path))
    check(exp.model.splade_encoder and exp.model.splade_flops_weight == tc["flops_weight"]
          and (list(exp.sys.mesh_shape), list(exp.sys.mesh_axes)) == ([-1], ["dp"]) and exp.dataloader.batch_size == 32,
          "13c: the parsed Experiment is not 11a's SPLADE composition under strategy/dp")
    ranks, wall = run_ranks("splade_cli", dict(tc, backend="gloo", yaml=str(yaml_path)), d)
    for r in ranks:
        check(len(r["steps"]) == tc["max_steps"] and all(s["rows"] == 32 // tc["ranks"] for s in r["steps"])
              and all(s["sparse"] == "SparseIndex" for s in r["steps"]), f"13c rank {r['rank']}: steps {r['steps']}")
    out["splade_cli"] = dict(ranks=ranks, wall_s=wall, **first_loss_check("13c", ranks, d, exp, sown=True))
    # the learned reindex split over the ranks against one process's, from the same weights
    saved = [torch.load(d / f"terms-rank{r}.pt", weights_only=False) for r in range(tc["ranks"])]
    model = cli.build_model(exp.model, proposal_temperature=exp.collate.temperature, device=dev,
                            generator=torch.Generator(device=dev).manual_seed(exp.sys.seed))
    model.load_state_dict(torch.load(d / "state0.pt", weights_only=True))
    t0 = time.perf_counter()
    terms, weights = encode_corpus_terms(model.encode_field, saved[0]["input_ids"].to(dev),
                                         saved[0]["attention_mask"].to(dev), k=saved[0]["k"], chunk=saved[0]["chunk"])
    one_s = time.perf_counter() - t0
    for s_ in saved:
        check(torch.equal(s_["terms"], torch.from_numpy(terms)) and torch.equal(s_["weights"], torch.from_numpy(weights)),
              "13c: the impact terms re-embedded over the ranks != one process's")
    table = [torch.load(d / f"impact-rank{r}.pt", weights_only=False) for r in range(tc["ranks"])]
    learned = build_impact_index(terms, weights, n_terms=table[0]["n_terms"], max_postings=table[0]["max_postings"],
                                 device="cpu")
    for tb_ in table:
        check(torch.equal(tb_["docs"], learned.postings_docs) and torch.equal(tb_["impacts"], learned.postings_impacts),
              "13c: a rank's learned impact index != the one-process index")
    # 15d: GradCache with the FLOPS term over the split batch against one process's GradCache
    for r in ranks:
        check(len(r["gradcache"]) == 2 and all(math.isfinite(s_["loss"]) and s_["checksum_ok"] for s_ in r["gradcache"]),
              f"15d rank {r['rank']}: GradCache steps {r['gradcache']}")
    model.load_state_dict(torch.load(d / "state-gradcache.pt", weights_only=True))
    batch = one_process_batch(d, tc["ranks"], dev, 0)
    t0 = time.perf_counter()
    single = float(gradcache_backward(model, batch, chunk_rows=tc["gradcache_rows"]).loss)
    torch.cuda.synchronize()
    gc_one_ms = (time.perf_counter() - t0) * 1e3
    gc_first = sum(r["gradcache"][0]["loss"] for r in ranks) / len(ranks)
    gc_rel = abs(gc_first - single) / max(abs(single), 1e-12)
    check(gc_rel <= tc["loss_rtol"], f"15d: GradCache's first loss over the ranks {gc_first:.6f} != one process's "
          f"{single:.6f} (rel {gc_rel:.2e})")
    gradcache = dict(first_loss=gc_first, one_process_loss=single, first_loss_rel=gc_rel, chunk_rows=tc["gradcache_rows"],
                     losses=[[s_["loss"] for s_ in r["gradcache"]] for r in ranks],
                     step_ms=[[s_["ms"] for s_ in r["gradcache"]] for r in ranks], one_process_ms=gc_one_ms)
    log(f"15d [{card}]: GradCache at {tc['gradcache_rows']} rows a chunk with the FLOPS term over two gloo ranks: "
        f"first loss over the ranks {gc_first:.6f}, one process's GradCache on the global batch {single:.6f} (rel "
        f"{gc_rel:.2e}); losses {gradcache['losses']}; steps {[[round(x, 1) for x in r] for r in gradcache['step_ms']]} "
        f"ms, one process {gc_one_ms:.1f} ms; parameters equal on both ranks after each step")
    del model, batch
    gc.collect()
    torch.cuda.empty_cache()
    out["splade_cli"].update(one_process_reembed_s=one_s, table_width=int(learned.postings_docs.shape[1]),
                             gradcache=gradcache)
    step_summary("13c", ranks, tc["period"])
    log(f"13c: the learned index ({learned.postings_docs.shape[1]} postings a term) over the ranks equals one "
        f"process's (one-process re-embed {one_s:.2f} s); first-step loss (FLOPS term included) over the ranks "
        f"{out['splade_cli']['first_loss']:.6f}, one process {out['splade_cli']['one_process_loss']:.6f} (rel "
        f"{out['splade_cli']['first_loss_rel']:.2e}); torchrun wall {wall:.1f} s [{card}]")

    # 13d: NCCL at world size 2 or more needs as many cards
    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        ranks, wall = torchrun("compressed", n_cards, root, dict(ta, backend="nccl"), ta["timeout"])
        out["nccl"] = ranks
        for r in ranks:
            log_13a(r, f"rank {r['rank']}/{r['world']} (nccl, {n_cards} cards)")
    else:
        out["nccl"] = None
        log(f"13d not run: NCCL at world size 2 or more needs 2 or more cards, and this machine has {n_cards}")
    tmp.cleanup()
    out["wall_s"] = time.perf_counter() - started
    log(f"phase 13 wall time: {out['wall_s']:.1f} s")
    return out


def moe_cli_phase(dev, card: str, hbm: float, peak_bf16: float, t: dict) -> dict:
    """Phase 14a: the MoE encoder through the CLI (module constant MOE_CLI),
    in process through `vod_tpu_torch.exps.cli.main`: `main(["--config",
    yaml])` (3 optimizer steps and a checkpoint), then `main(["--resume_from",
    run, "--max_steps", "6"])`. Each `main` is a main path of its own:
    launch counts are zeroed just before it and read just after. Returns
    the numbers."""
    import tempfile

    import torch

    from vod_tpu_torch.exps import cli
    from vod_tpu_torch.models.encoder import _dense, _gelu
    from vod_tpu_torch.ops.mips import _binned_body, fused_mips_binned, fused_mips_binned_reference
    from vod_tpu_torch.parallel.moe import MoEFFN
    from vod_tpu_torch.runtime.train import RealmTrainStep
    from vod_tpu_torch.search import dense as dense_mod

    started = time.perf_counter()
    tmp = tempfile.TemporaryDirectory()
    root = Path(tmp.name)
    inputs = cli_inputs(root, t)
    with open(inputs["yaml"], "a") as f:
        f.write(f"model: {{moe_experts: {t['moe_experts']}, moe_top_k: {t['moe_top_k']}}}\n")
    log(f"14a inputs: {t['n']} harvested passages, {t['queries']} train queries, in "
        f"{time.perf_counter() - started:.2f} s")

    rec: dict = dict(steps=[], losses=[], call=None, initial=None)
    real = dict(build=cli.build_model, step=RealmTrainStep.train_step_accum, loss=RealmTrainStep.loss,
                kernel=dense_mod.fused_mips_binned)

    def build_model(cfg, **kw):
        model = real["build"](cfg, **kw)
        if rec["initial"] is None:
            rec["initial"] = {n: p.detach().clone() for n, p in model.named_parameters() if ".moe." in n}
        return model

    def step(self, engines, corpus, micro, generator, weights, **kw):
        events = [torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)]
        before = fused_mips_binned.launches
        events[0].record()
        t0 = time.perf_counter()
        out = real["step"](self, engines, corpus, micro, generator, weights, **kw)
        host = (time.perf_counter() - t0) * 1e3
        events[1].record()
        rec["steps"].append((events, host, fused_mips_binned.launches - before))
        return out

    def loss(self, batch, dp=None):
        total, out = real["loss"](self, batch, dp)
        rec["losses"].append((total.detach(), out.loss.detach()))
        return total, out

    def kernel(vectors, queries, **kw):
        if rec["call"] is None:
            rec["call"] = (vectors, queries.detach().clone(), dict(kw))
        return real["kernel"](vectors, queries, **kw)

    patches = [(cli, "build_model", build_model), (RealmTrainStep, "train_step_accum", step),
               (RealmTrainStep, "loss", loss), (dense_mod, "fused_mips_binned", kernel)]
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
    for obj, name, fn in patches:
        setattr(obj, name, fn)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        fused_mips_binned.launches = 0
        fused_mips_binned.body_launches.update(wgmma=0, fma=0)  # main path starts
        t_run = time.perf_counter()
        out1 = cli.main(["--config", str(inputs["yaml"])])
        torch.cuda.synchronize()
        launches1, bodies1 = fused_mips_binned.launches, dict(fused_mips_binned.body_launches)  # main path ends
        run1_s = time.perf_counter() - t_run
        peak = torch.cuda.max_memory_allocated(dev)
        steps1, losses1, initial = rec["steps"], rec["losses"], rec["initial"]
        model = out1["model"]
        rec.update(steps=[], losses=[])

        fused_mips_binned.launches = 0
        fused_mips_binned.body_launches.update(wgmma=0, fma=0)  # main path starts
        t_run = time.perf_counter()
        out2 = cli.main(["--resume_from", str(inputs["run"]), "--max_steps", str(t["resume_steps"])])
        torch.cuda.synchronize()
        launches2, bodies2 = fused_mips_binned.launches, dict(fused_mips_binned.body_launches)  # main path ends
        run2_s = time.perf_counter() - t_run
        steps2, losses2 = rec["steps"], rec["losses"]
    finally:
        for obj, name, fn in saved:
            setattr(obj, name, fn)

    layers = model.encoder.backbone.layers
    check(len(layers) == 6 and all(isinstance(layer.moe, MoEFFN) and layer.moe.n_experts == t["moe_experts"]
                                   and layer.moe.top_k == t["moe_top_k"] for layer in layers),
          "14a: the encoder's layers are not 8-expert top-2 MoE FFNs")
    check(out1["state"].step == t["max_steps"] and out2["state"].step == t["resume_steps"],
          f"14a: the runs ended at steps {out1['state'].step} and {out2['state'].step}")
    check((inputs["run"] / "period-0" / "trainer_state.json").is_file(), "14a: no checkpoint after run 1")
    totals = [(float(a), float(b)) for a, b in losses1 + losses2]
    check(all(math.isfinite(a) and math.isfinite(b) for a, b in totals), f"14a: a loss is not finite: {totals}")
    aux = [a - b for a, b in totals]
    check(all(x > 0.0 for x in aux), f"14a: the MoE aux term is missing from a loss: {aux}")
    share = [x / a for x, (a, _) in zip(aux, totals)]
    moved = {n: float((p.detach() - initial[n]).abs().max()) for n, p in model.named_parameters() if n in initial}
    check(all(moved[f"encoder.backbone.layers.{i}.moe.{w}"] > 0 for i in range(len(layers)) for w in ("wi", "wo")),
          f"14a: an expert weight did not move: {moved}")
    check(launches1 == bodies1["wgmma"] == 2 * t["max_steps"] and bodies1["fma"] == 0,
          f"14a run 1 launched fused_mips_binned {launches1} times, by body {bodies1}, not twice a step on wgmma")
    check(launches2 == bodies2["wgmma"] == 2 * (t["resume_steps"] - t["max_steps"]),
          f"14a run 2 launched fused_mips_binned {launches2} times, by body {bodies2}")
    step_ms = [(s.elapsed_time(e), host) for (s, e), host, _ in steps1 + steps2]

    # the loop's first call against the plain version, at its shape
    vv, q, kw = rec["call"]
    b, d = q.shape
    body = _binned_body(vv.dtype, d, kw["bins"], (vv.data_ptr(), q.data_ptr()))
    check(body == "wgmma", f"14a: the loop's call takes the {body} body")
    ks, ki = fused_mips_binned(vv, q, **kw)
    rs, ri = fused_mips_binned_reference(vv, q, **kw)
    tol = 2 * d * 2.0**-24 * q.float().norm(dim=-1).max().item() * vv.float().norm(dim=-1).max().item()
    err, swaps = check_against_plain(f"14a loop binned B={b} D={d}", ks, ki, rs, ri, q, vv, tol)
    n_real, k = kw["n_real"], kw["k"]
    ms = time_ms(lambda: fused_mips_binned(vv, q, **kw), 20)
    plain_ms = time_ms(lambda: fused_mips_binned_reference(vv, q, **kw), 2)
    library_ms = time_ms(lambda: torch.topk(q @ vv[:n_real].T, k, dim=-1), 20)
    nbytes, ops = (n_real + b) * d * 2 + b * k * 8, 2 * b * n_real * d
    bound = max(nbytes / hbm, ops / peak_bf16) * 1e3
    bound_by = "bytes" if nbytes / hbm >= ops / peak_bf16 else "operations"
    log(f"14a loop call bf16 B={b} D={d} N={n_real} bins={kw['bins']} k={k} ({body}): max |kernel - plain| = "
        f"{err:.3g} (tol {tol:.3g}), {swaps} id swaps inside the band; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"library {library_ms:.4f} ms, bound {bound:.4f} ms ({bound_by}) [{card}]")
    del vv, q, ks, ki, rs, ri

    # one layer's MoE FFN beside a dense FFN of its width, forward (CUDA events)
    moe = layers[0].moe
    h_in = torch.randn((t["ffn_rows"], t["max_length"], moe.gate.shape[0]), device=dev,
                       generator=torch.Generator(device=dev).manual_seed(t["seed"])).to(torch.bfloat16)
    dense_up = torch.nn.Linear(moe.gate.shape[0], moe.intermediate_size, device=dev)
    dense_down = torch.nn.Linear(moe.intermediate_size, moe.gate.shape[0], device=dev)
    with torch.no_grad():
        moe_ms = time_ms(lambda: moe(h_in), t["ffn_reps"])
        dense_ms = time_ms(lambda: _dense(_gelu(_dense(h_in, dense_up, torch.bfloat16)), dense_down, torch.bfloat16),
                           t["ffn_reps"])
    del h_in, dense_up, dense_down
    wall = time.perf_counter() - started
    result = dict(
        run1_s=run1_s, run2_s=run2_s, launches=launches1, body_launches=bodies1, resume_launches=launches2,
        resume_body_launches=bodies2, losses=[a for a, _ in totals], aux=aux, aux_share=share,
        step_ms=[s for s, _ in step_ms], step_host_ms=[h for _, h in step_ms], peak_mem_bytes=peak,
        max_abs_err=err, call=dict(shape=f"bfloat16 B={b} N={n_real} D={d} bins={kw['bins']} k={k}", ms=ms,
                                   plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound, bound_by=bound_by),
        moe_ffn_ms=moe_ms, dense_ffn_ms=dense_ms, ffn_shape=f"[{t['ffn_rows']}, {t['max_length']}, {d}] bf16",
        wall_s=wall,
    )
    log(f"14a runs [{card}]: run 1 {run1_s:.2f} s ({launches1} fused_mips_binned launches, by body {bodies1}); "
        f"resume {run2_s:.2f} s ({launches2}, by body {bodies2}); losses {json.dumps([round(a, 6) for a, _ in totals])}"
        f"; MoE aux in each {json.dumps([round(x, 6) for x in aux])} ({', '.join(f'{s:.4f}' for s in share)} of "
        f"the loss); peak memory {peak / 2**30:.4f} GiB")
    log(f"14a steps [{card}]: card {json.dumps([round(s, 3) for s, _ in step_ms])} ms (CUDA events), host call "
        f"{json.dumps([round(h, 3) for _, h in step_ms])} ms; one layer's FFN forward on {result['ffn_shape']}: "
        f"MoE {moe_ms:.4f} ms, dense {dense_ms:.4f} ms ({moe_ms / dense_ms:.2f}x)")
    log(f"phase 14a wall time: {wall:.1f} s")
    del out1, out2, model, layers, moe
    gc.collect()
    torch.cuda.empty_cache()
    tmp.cleanup()
    return result


def parallel_rank(dev, card: str, t: dict) -> dict:
    """One rank of phase 14b/14c (module constant PARALLEL): the tp, pp and
    sp legs at e5-large's widths and depth, with bf16 activations (timed)
    and with f32 ones, each against this rank's own one-rank forward of the
    same seeded weights in the same dtype; each bf16 leg also against the
    f32 forward, beside the bf16 forward's own distance from it; then the
    ep leg. Returns each leg's largest differences, its ms (CUDA events, the
    mean of `reps` calls after a warm-up) beside the one-rank forward's, and
    the collectives' share of one instrumented call (each collective timed
    between two synchronizes, over that call's wall time)."""
    import torch
    import torch.distributed as dist

    from vod_tpu_torch.models.encoder import TransformerEncoder, TransformerEncoderConfig, _materialise
    from vod_tpu_torch.parallel import (
        MoEFFN,
        axis_index,
        make_mesh,
        pp_encoder_forward,
        shard_params_ep,
        shard_params_tp,
        sp_encoder_forward,
    )

    rank, world = dist.get_rank(), dist.get_world_size()
    g = torch.Generator(device=dev).manual_seed(t["seed"] + 1)
    ids = torch.randint(1, t["vocab"], (t["b"], t["t"]), generator=g, device=dev)
    mask = torch.ones((t["b"], t["t"]), dtype=torch.int32, device=dev)
    mask[1, t["pad_from"]:] = 0  # a padded row
    x_moe = torch.randn((t["b"], t["t"], t["hidden"]), generator=g, device=dev).to(torch.bfloat16)
    meshes = {axis: make_mesh((world,), (axis,)) for axis in ("tp", "sp", "pp", "ep")}
    per, r_sp = t["t"] // world, axis_index(meshes["sp"], "sp")
    cfg = TransformerEncoderConfig(vocab_size=t["vocab"], hidden_size=t["hidden"], num_layers=t["layers"],
                                   num_heads=t["heads"], intermediate_size=t["inter"])

    coll = [0.0, 0]
    real = dict(all_reduce=dist.all_reduce, broadcast=dist.broadcast, p2p=dist.batch_isend_irecv)

    def counted(fn):
        def wrapped(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            if isinstance(out, list):
                for req in out:
                    req.wait()
            torch.cuda.synchronize()
            coll[0] += time.perf_counter() - t0
            coll[1] += 1
            return out

        return wrapped

    def measured(fn, reps: int) -> dict:
        """ms a call, and the collectives' share of one instrumented call and their count."""
        ms = time_ms(fn, reps)
        coll[:] = [0.0, 0]
        dist.all_reduce, dist.broadcast, dist.batch_isend_irecv = (counted(real["all_reduce"]),
                                                                   counted(real["broadcast"]), counted(real["p2p"]))
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            dist.all_reduce, dist.broadcast, dist.batch_isend_irecv = (real["all_reduce"], real["broadcast"],
                                                                       real["p2p"])
        return dict(ms=ms, coll_share=coll[0] / wall, collectives=coll[1])

    def encoder(dtype):
        enc = TransformerEncoder(dataclasses.replace(cfg, dtype=dtype), device="meta")
        _materialise(enc, dev, torch.Generator(device=dev).manual_seed(t["seed"]))
        return enc

    def legs_in(dtype, timed: bool) -> dict:
        """The one-rank forward and the three legs' outputs (sp's: this rank's block)."""
        enc = encoder(dtype)
        out: dict = dict(legs={})
        with torch.no_grad():
            out["ref"] = enc(ids, mask).float()
            tp_enc = shard_params_tp(encoder(dtype), meshes["tp"], "tp")
            calls = dict(tp=lambda: tp_enc(ids, mask),
                         sp=lambda: sp_encoder_forward(enc, ids, mask, mesh=meshes["sp"], axis="sp"),
                         pp=lambda: pp_encoder_forward(enc, ids, mask, mesh=meshes["pp"], axis="pp"))
            for name, fn in calls.items():
                out["legs"][name] = dict(out=fn().float(), **(measured(fn, t["reps"]) if timed else {}))
            out["legs"]["tp"]["split"] = sum(hasattr(p, "tp_group") for p in tp_enc.parameters())
            if timed:
                out["one_rank_ms"] = time_ms(lambda: enc(ids, mask), t["reps"])
        if timed:  # pp's backward: each stage's gradients on its own layers only
            h = pp_encoder_forward(enc, ids, mask, mesh=meshes["pp"], axis="pp")
            h.float().pow(2).mean().backward()
            stage = axis_index(meshes["pp"], "pp")
            own = range(stage * t["layers"] // world, (stage + 1) * t["layers"] // world)
            grads = {n: p.grad for n, p in enc.named_parameters()}
            mine = {n for n in grads if not n.startswith("layers.") or int(n.split(".")[1]) in own}
            out["grads_finite"] = all(grads[n] is not None and bool(torch.isfinite(grads[n]).all()) for n in mine)
            out["other_stages_none"] = all(grads[n] is None for n in grads if n not in mine)
        return out

    def err(a: torch.Tensor, name: str, ref: torch.Tensor) -> float:
        return float((a - (ref[:, r_sp * per : (r_sp + 1) * per] if name == "sp" else ref)).abs().max())

    bf, f32 = legs_in(torch.bfloat16, True), legs_in(torch.float32, False)
    legs = {}
    for name, leg in bf["legs"].items():
        legs[name] = {k: v for k, v in leg.items() if k != "out"} | dict(
            err=err(leg["out"], name, bf["ref"]), err_f32=err(leg["out"], name, f32["ref"]),
            f32_err=err(f32["legs"][name]["out"], name, f32["ref"]))
    legs["pp"].update(grads_finite=bf["grads_finite"], other_stages_none=bf["other_stages_none"])
    bf16_vs_f32 = float((bf["ref"] - f32["ref"]).abs().max())
    one_ms = bf["one_rank_ms"]
    del bf, f32

    def moe_module():
        moe = MoEFFN(t["hidden"], t["experts"], t["inter"], t["top_k"], dtype=torch.bfloat16, device=dev)
        moe.reset_parameters(torch.Generator(device=dev).manual_seed(t["seed"] + 2))
        return moe

    with torch.no_grad():
        rep = moe_module()
        y_rep, aux_rep = rep(x_moe)
        moe_one_ms = time_ms(lambda: rep(x_moe), t["reps"])
        ep = shard_params_ep(moe_module(), meshes["ep"], "ep")
        y_ep, aux_ep = ep(x_moe)
        legs["ep"] = dict(err=float((y_ep.float() - y_rep.float()).abs().max()),
                          aux_err=float((aux_ep - aux_rep).abs()), one_rank_ms=moe_one_ms,
                          local_experts=int(ep.wi.shape[0]), **measured(lambda: ep(x_moe), t["reps"]))
    print(f"[rank {rank}] bf16 forward from f32 {bf16_vs_f32:.4g}; {json.dumps(legs)[:1500]}", flush=True)
    return dict(rank=rank, world=world, backend=dist.get_backend(), card=card, one_rank_ms=one_ms, legs=legs,
                bf16_vs_f32=bf16_vs_f32, peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30)


def model_parallel_phase(dev, card: str, t: dict) -> dict:
    """Phase 14b/14c: `parallel_rank` on `t["ranks"]` gloo ranks of the one
    card under torchrun (`--rank-job parallel`), then under NCCL over every
    card where the machine has two or more. Checked: with f32 activations,
    the tp, pp and sp legs within `t["f32_tol"]` of the one-rank f32
    forward; with bf16 ones, pp within `t["tol"]` (JAX's dryrun bound) of
    the one-rank bf16 forward, and tp and sp, which re-associate bf16 sums,
    no farther from the f32 forward than the bf16 forward is, plus
    `t["tol"]`; ep within `t["tol"]` of the replicated module and its aux
    within 1e-5; pp's gradients finite on the rank's own layers and absent
    on the others'; every rank exits 0. Returns the numbers."""
    import tempfile

    import torch

    started = time.perf_counter()
    tmp = tempfile.TemporaryDirectory()
    root = Path(tmp.name)
    out: dict = {}

    def run(world: int, backend: str) -> list:
        ranks, wall = torchrun("parallel", world, root, dict(t, backend=backend), t["timeout"])
        for r in ranks:
            log(f"14 rank {r['rank']}/{r['world']} ({backend}) [{card}], {t['layers']} layers: one-rank bf16 forward "
                f"{r['one_rank_ms']:.3f} ms, {r['bf16_vs_f32']:.4g} from the f32 one; "
                + "; ".join(f"{n} {leg['ms']:.3f} ms (bf16 err {leg['err']:.4g}, from f32 {leg['err_f32']:.4g}; f32 "
                            f"err {leg['f32_err']:.3g}; {leg['collectives']} collectives, {leg['coll_share']:.3f} of "
                            "a call)" for n, leg in r["legs"].items() if n != "ep"))
            e = r["legs"]["ep"]
            log(f"14 rank {r['rank']}/{r['world']} ({backend}) [{card}]: ep {e['ms']:.3f} ms beside one rank's "
                f"{e['one_rank_ms']:.3f} ms (err {e['err']:.4g}, aux err {e['aux_err']:.3g}, {e['local_experts']} "
                f"experts a rank, {e['collectives']} collectives, {e['coll_share']:.3f} of a call); peak "
                f"{r['peak_gib']:.3f} GiB")
        for r in ranks:
            where, legs = f"14 {backend} rank {r['rank']}", r["legs"]
            for name in ("tp", "sp", "pp"):
                check(legs[name]["f32_err"] <= t["f32_tol"], f"{where}: the f32 {name} leg is "
                      f"{legs[name]['f32_err']:.4g} from the one-rank f32 forward (tol {t['f32_tol']})")
            check(legs["pp"]["err"] <= t["tol"], f"{where}: the bf16 pp leg is {legs['pp']['err']:.4g} from the "
                  f"one-rank bf16 forward (tol {t['tol']})")
            for name in ("tp", "sp"):
                check(legs[name]["err_f32"] <= r["bf16_vs_f32"] + t["tol"], f"{where}: the bf16 {name} leg is "
                      f"{legs[name]['err_f32']:.4g} from the f32 forward, the bf16 forward {r['bf16_vs_f32']:.4g}")
            check(legs["pp"]["grads_finite"] and legs["pp"]["other_stages_none"],
                  f"{where}: pp's gradients are not finite, or not only its own layers'")
            check(legs["tp"]["split"] > 0 and legs["ep"]["local_experts"] == t["experts"] // world,
                  f"{where}: the tp or ep split did not happen")
            check(legs["ep"]["err"] <= t["tol"] and legs["ep"]["aux_err"] <= 1e-5, f"{where}: ep differs from "
                  "the replicated module")
        log(f"14 over {world} {backend} ranks: torchrun wall {wall:.1f} s")
        return ranks

    out["gloo"] = run(t["ranks"], "gloo")
    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        out["nccl"] = run(n_cards, "nccl")
    else:
        out["nccl"] = None
        log(f"14c not run: NCCL at world size 2 or more needs 2 or more cards, and this machine has {n_cards}")
    tmp.cleanup()
    out["wall_s"] = time.perf_counter() - started
    log(f"phase 14b/14c wall time: {out['wall_s']:.1f} s")
    return out


def trace_breakdown(path: Path, top_kernels: int, top_gaps: int) -> dict:
    """The first trace-based breakdown of a CLI step, from one Chrome trace of
    `training_loop(profile_dir=...)`: the steps' spans, the device's busy
    share over the window (from the first step's start to the later of the
    last step's end and the last device event's), the kernels that took the
    most (summed by name), and the device's longest idle gaps, each with the
    host op that overlaps it the most."""
    events = json.loads(path.read_text())["traceEvents"]
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    steps = sorted((e for e in spans if e["name"] == "train_step" and e.get("cat") == "user_annotation"),
                   key=lambda e: e["ts"])
    calls = [e for e in spans if e["name"] == "fused_mips_binned" and e.get("cat") == "user_annotation"]
    device = sorted((e for e in spans if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")), key=lambda e: e["ts"])
    kernels = [e for e in device if e.get("cat") == "kernel"]
    check(steps and kernels, f"15a: the trace holds {len(steps)} step spans and {len(kernels)} kernels")
    lo = steps[0]["ts"]
    hi = max(steps[-1]["ts"] + steps[-1]["dur"], max(e["ts"] + e["dur"] for e in device))
    busy, gaps, cur = 0.0, [], None  # union of the device intervals inside the window
    for e in device:
        a, b = max(e["ts"], lo), min(e["ts"] + e["dur"], hi)
        if b <= a:
            continue
        if cur is None or a > cur[1]:
            if cur is not None:
                busy += cur[1] - cur[0]
                gaps.append((cur[1], a))
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    busy += cur[1] - cur[0]
    by_name: dict = {}
    for e in kernels:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
    host = [e for e in spans if e.get("cat") in ("cpu_op", "user_annotation") and e["name"] != "train_step"]

    def host_op(a: float, b: float) -> str:
        """The host op that overlaps the gap [a, b) the most (the shorter on a tie)."""
        best = max(((min(b, e["ts"] + e["dur"]) - max(a, e["ts"]), -e["dur"], e["name"]) for e in host
                    if e["ts"] < b and e["ts"] + e["dur"] > a), default=None)
        return best[2][:80] if best else "(no host op)"

    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:top_gaps]
    return dict(
        steps=len(steps), step_ms=[e["dur"] / 1e3 for e in steps], fused_mips_binned_spans=len(calls),
        binned_wgmma_kernels=sum("binned_wgmma_kernel" in e["name"] for e in kernels), kernels=len(kernels),
        window_ms=(hi - lo) / 1e3, busy_ms=busy / 1e3, busy_share=busy / (hi - lo),
        top_kernels_ms=[(n[:80], d / 1e3) for n, d in sorted(by_name.items(), key=lambda kv: -kv[1])[:top_kernels]],
        longest_gaps_ms=[((b - a) / 1e3, host_op(a, b)) for a, b in longest],
        gaps_total_ms=sum(b - a for a, b in gaps) / 1e3,
    )


def profiled_cli_phase(dev, card: str, t: dict) -> dict:
    """Phase 15a: the experiment CLI with `sys.profile_dir` (module constant
    PROFILED_CLI), in process through `cli.main` (its own main path: launch
    counts zeroed just before it and read just after): two periods of 6
    optimizer steps, the loop's trace window at its default (3, 6). Checked:
    one trace file, which parses; one `train_step` span for each of the
    window's 3 steps; its `binned_wgmma_kernel` events equal to the loop's
    own launch counter over those steps (2 a step), and its
    `fused_mips_binned` spans too; none for the second period. Printed: the
    trace's breakdown (`trace_breakdown`). Returns the numbers."""
    import tempfile

    import torch

    from vod_tpu_torch.exps import cli
    from vod_tpu_torch.ops.mips import fused_mips_binned
    from vod_tpu_torch.runtime.train import RealmTrainStep

    started = time.perf_counter()
    tmp = tempfile.TemporaryDirectory()
    root = Path(tmp.name)
    inputs = cli_inputs(root, t)
    trace_dir = root / "trace"
    text = inputs["yaml"].read_text()
    check(text.count("sys: {mesh_shape: [1]}\n") == 1, "15a: phase 9's YAML has no sys line to extend")
    inputs["yaml"].write_text(text.replace("sys: {mesh_shape: [1]}\n",
                                          f"sys: {{mesh_shape: [1], profile_dir: '{trace_dir}'}}\n"))
    rec: dict = dict(steps=[])
    real_step = RealmTrainStep.train_step_accum

    def step(self, engines, corpus, micro, generator, weights, **kw):
        before = dict(fused_mips_binned.body_launches)
        out = real_step(self, engines, corpus, micro, generator, weights, **kw)
        rec["steps"].append({k: v - before[k] for k, v in fused_mips_binned.body_launches.items()})
        return out

    RealmTrainStep.train_step_accum = step
    try:
        torch.cuda.synchronize()
        fused_mips_binned.launches = 0
        fused_mips_binned.body_launches.update(wgmma=0, fma=0)  # main path starts
        t_run = time.perf_counter()
        out = cli.main(["--config", str(inputs["yaml"])])
        torch.cuda.synchronize()
        launches, bodies = fused_mips_binned.launches, dict(fused_mips_binned.body_launches)  # main path ends
        run_s = time.perf_counter() - t_run
    finally:
        RealmTrainStep.train_step_accum = real_step
    lo, hi = t["window"]
    check(out["state"].step == t["max_steps"] and [h["period"] for h in out["history"]] == [0, 1],
          f"15a: the run ended at step {out['state'].step}, periods {[h['period'] for h in out['history']]}")
    check(launches == bodies["wgmma"] == 2 * t["max_steps"] and all(b == {"wgmma": 2, "fma": 0} for b in rec["steps"]),
          f"15a: fused_mips_binned launched {launches} times, by body {bodies}, not twice a step on wgmma")
    files = sorted(trace_dir.iterdir()) if trace_dir.is_dir() else []
    check(len(files) == 1 and files[0].name.startswith("trace-rank0-") and files[0].suffix == ".json",
          f"15a: the traces written are {[f.name for f in files]}, not one for the first period")
    parse_t0 = time.perf_counter()
    bd = trace_breakdown(files[0], t["top_kernels"], t["top_gaps"])
    parse_s = time.perf_counter() - parse_t0
    window_launches = sum(b["wgmma"] for b in rec["steps"][lo:hi])
    check(bd["steps"] == hi - lo, f"15a: {bd['steps']} step spans, not {hi - lo}")
    check(bd["binned_wgmma_kernels"] == window_launches == 2 * (hi - lo) == bd["fused_mips_binned_spans"],
          f"15a: the trace holds {bd['binned_wgmma_kernels']} binned_wgmma_kernel events and "
          f"{bd['fused_mips_binned_spans']} fused_mips_binned spans; the loop launched {window_launches} in the window")
    size_mb = files[0].stat().st_size / 2**20
    del out
    gc.collect()
    torch.cuda.empty_cache()
    tmp.cleanup()
    wall = time.perf_counter() - started
    log(f"15a [{card}]: the CLI with sys.profile_dir ran {t['max_steps']} steps in two periods in {run_s:.2f} s; one "
        f"trace ({size_mb:.1f} MiB, parsed in {parse_s:.2f} s) with {bd['steps']} train_step spans "
        f"({', '.join(f'{x:.2f}' for x in bd['step_ms'])} ms on the host), {bd['binned_wgmma_kernels']} "
        f"binned_wgmma_kernel events = {window_launches} launches of the loop in steps [{lo}, {hi}), "
        f"{bd['fused_mips_binned_spans']} fused_mips_binned spans; no trace for the second period")
    log(f"15a breakdown [{card}]: window {bd['window_ms']:.2f} ms, device busy {bd['busy_ms']:.2f} ms "
        f"({bd['busy_share']:.4f}), idle {bd['gaps_total_ms']:.2f} ms in gaps; {bd['kernels']} kernels; largest "
        + "; ".join(f"{n} {d:.3f} ms" for n, d in bd["top_kernels_ms"]))
    log("15a longest device gaps [" + card + "]: " + "; ".join(f"{d:.3f} ms over {op}" for d, op in bd["longest_gaps_ms"]))
    log(f"phase 15a wall time: {wall:.1f} s")
    return dict(run_s=run_s, launches=launches, body_launches=bodies, window_launches=window_launches,
                trace_mib=size_mb, parse_s=parse_s, wall_s=wall, **bd)


def write_byte_bpe(directory: Path, texts: list, size: int) -> dict:
    """A byte-level BPE of `size` entries from `texts`, by this script's own
    code: RoBERTa's special tokens (`<s> <pad> </s> <unk>` first, `<mask>`
    last), the 256 byte characters, then, word by word from the most
    frequent (GPT-2's pre-tokenizer pieces in byte characters), each prefix
    of the word as a token with the merge that makes it from the one before
    (`<unusedN>` fill the rest, if the words run out). Writes `vocab.json`,
    `merges.txt` and a `tokenizer_config.json` naming `RobertaTokenizerFast`;
    returns the counts."""
    import collections

    from vod_tpu_torch.data.tokenizer_json import _gpt2_pattern, bytes_to_unicode

    chars = bytes_to_unicode()
    counts: collections.Counter = collections.Counter()
    for text in texts:
        for piece in _gpt2_pattern().findall(text):
            counts["".join(chars[b] for b in piece.encode("utf-8"))] += 1
    vocab = {tok: i for i, tok in enumerate(["<s>", "<pad>", "</s>", "<unk>", *[chars[b] for b in range(256)]])}
    merges = []
    for word, _ in counts.most_common():
        for j in range(2, len(word) + 1):
            if len(vocab) >= size - 1:
                break
            if word[:j] not in vocab:
                vocab[word[:j]] = len(vocab)
                merges.append(f"{word[: j - 1]} {word[j - 1]}")
        if len(vocab) >= size - 1:
            break
    filler = size - 1 - len(vocab)
    vocab.update({f"<unused{i}>": len(vocab) + i for i in range(filler)})
    vocab["<mask>"] = size - 1
    directory.mkdir(parents=True)
    (directory / "vocab.json").write_text(json.dumps(vocab, ensure_ascii=False))
    (directory / "merges.txt").write_text("#version: 0.2\n" + "\n".join(merges) + "\n")
    (directory / "tokenizer_config.json").write_text(json.dumps({"tokenizer_class": "RobertaTokenizerFast"}))
    return dict(vocab=len(vocab), merges=len(merges), filler=filler, words=len(counts))


def write_unigram(directory: Path, texts: list, size: int) -> dict:
    """A Unigram `tokenizer.json` of `size` pieces from `texts`, by this
    script's own code: XLM-R's special tokens, the characters seen and the
    most frequent `▁`-prefixed words and words, each scored by the log of
    its count's share; XLM-R's NFKC and space-run normalizer, `Metaspace`
    (prepend "always") and `<s> $A </s>` templates; `tokenizer_config.json`
    names `XLMRobertaTokenizerFast`. Returns the counts."""
    import collections

    counts: collections.Counter = collections.Counter()
    for text in texts:
        words = text.split()
        counts.update("▁" + w for w in words)
        counts.update(words)
        counts.update(text)
    specials = ["<s>", "<pad>", "</s>", "<unk>"]
    chars = sorted({c for c in counts if len(c) == 1 and not c.isspace()} | {"▁"})
    pieces = chars + [w for w, _ in counts.most_common() if len(w) > 1][: max(0, size - 5 - len(chars))]
    total = sum(counts[p] for p in pieces)
    vocab = [[tok, 0.0] for tok in specials] + [[p, math.log(max(counts[p], 1) / total)] for p in pieces] + [["<mask>", 0.0]]
    ids = {tok: i for i, (tok, _) in enumerate(vocab)}
    spec = {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": [dict(id=ids[tok], content=tok, single_word=False, lstrip=False, rstrip=False,
                              normalized=False, special=True) for tok in (*specials, "<mask>")],
        "normalizer": {"type": "Sequence", "normalizers": [
            {"type": "NFKC"}, {"type": "Replace", "pattern": {"Regex": " {2,}"}, "content": " "}]},
        "pre_tokenizer": {"type": "Metaspace", "replacement": "▁", "prepend_scheme": "always", "split": True},
        "post_processor": {"type": "TemplateProcessing",
                           "single": [{"SpecialToken": {"id": "<s>", "type_id": 0}},
                                      {"Sequence": {"id": "A", "type_id": 0}},
                                      {"SpecialToken": {"id": "</s>", "type_id": 0}}],
                           "pair": [{"SpecialToken": {"id": "<s>", "type_id": 0}},
                                    {"Sequence": {"id": "A", "type_id": 0}},
                                    {"SpecialToken": {"id": "</s>", "type_id": 0}},
                                    {"SpecialToken": {"id": "</s>", "type_id": 0}},
                                    {"Sequence": {"id": "B", "type_id": 0}},
                                    {"SpecialToken": {"id": "</s>", "type_id": 0}}],
                           "special_tokens": {tok: {"id": tok, "ids": [ids[tok]], "tokens": [tok]}
                                              for tok in ("<s>", "</s>")}},
        "decoder": {"type": "Metaspace", "replacement": "▁", "prepend_scheme": "always", "split": True},
        "model": {"type": "Unigram", "unk_id": ids["<unk>"], "vocab": vocab, "byte_fallback": False},
    }
    directory.mkdir(parents=True)
    (directory / "tokenizer.json").write_text(json.dumps(spec, ensure_ascii=False))
    (directory / "tokenizer_config.json").write_text(json.dumps({"tokenizer_class": "XLMRobertaTokenizerFast"}))
    return dict(pieces=len(vocab), chars=len(chars))


def roberta_cli_phase(dev, card: str, hbm: float, peak_bf16: float, t: dict) -> dict:
    """Phase 15b: a roberta-base-width encoder through the CLI (module
    constant ROBERTA_CLI), in process through `cli.main` (its own main path:
    launch counts zeroed just before it and read just after), its tokenizer
    the byte-level BPE that `write_byte_bpe` builds from the harvest, read by
    the port's own code (`load_tokenizer`: vocab.json + merges.txt).
    Checked: the tokenizer is the port's BPE with roberta-base's size; the
    checkpoint's backbone loaded (one token type); every loss finite; every
    `fused_mips_binned` launch at D = 768 on `wgmma`, at least one a step,
    and the loop's first call held to its plain version at its shape, timed
    beside the library and the bound. Returns the numbers and the harvest's
    directory (phase 15c reads its passages)."""
    import tempfile

    import torch

    from vod_tpu_torch.data.tokenizer_json import JsonTokenizer
    from vod_tpu_torch.exps import cli
    from vod_tpu_torch.exps.structconf import Experiment
    from vod_tpu_torch.ops.mips import _binned_body, fused_mips_binned, fused_mips_binned_reference
    from vod_tpu_torch.runtime.train import RealmTrainStep
    from vod_tpu_torch.search import dense as dense_mod

    started = time.perf_counter()
    tmp = tempfile.TemporaryDirectory()
    root = Path(tmp.name)
    h = harvest_beir(root, t)
    texts = [f"{r['title']} {r['text']}" for r in map(json.loads, (h["beir"] / "corpus.jsonl").read_text().splitlines())]
    hf = t["hf"]
    t0 = time.perf_counter()
    bpe = write_byte_bpe(root / "bpe", texts, hf["vocab_size"])
    bpe_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    write_hf_checkpoint(root / "ckpt", t, dev, head="roberta")
    ckpt_s = time.perf_counter() - t0
    yaml_path = root / "exp.yaml"
    yaml_path.write_text(
        f"extends: ['{ROOT / 'configs' / 'scifact_ranker.yaml'}']\n"
        f"model: {{name_or_path: '{root / 'ckpt'}', hf_fallback: error, vocab_size: {hf['vocab_size']}, "
        f"hidden_size: {hf['hidden_size']}, num_layers: {hf['num_hidden_layers']}, "
        f"num_heads: {hf['num_attention_heads']}, intermediate_size: {hf['intermediate_size']}}}\n"
        f"tokenizer: {{name_or_path: '{root / 'bpe'}', max_length: {t['max_length']}}}\n"
        "search_defaults:\n"
        f"  dense: {{codec: flat, dtype: bfloat16, kernel: fused, fused_bins: {t['bins']}}}\n"
        f"trainer: {{max_steps: {t['max_steps']}, period: {t['period']}, log_interval: 1}}\n"
        "sys: {mesh_shape: [1]}\n"
        "datasets:\n"
        "  queries:\n"
        f"    - {{identifier: harvest-train, name_or_path: beir, subsets: ['{h['beir']}'], split: train, "
        "link: harvest-corpus}\n"
        "  sections:\n"
        f"    - {{identifier: harvest-corpus, name_or_path: beir, subsets: ['{h['beir']}']}}\n"
    )
    exp = Experiment.from_file(str(yaml_path))
    tok = exp.tokenizer.instantiate()
    check(isinstance(tok, JsonTokenizer) and tok.model_type == "BPE" and len(tok) == hf["vocab_size"]
          and tok.pad_token_id == 1 and tok.mask_token_id == hf["vocab_size"] - 1,
          f"15b: the tokenizer is {type(tok).__name__} of {len(tok)} entries")
    log(f"15b inputs: {t['n']} passages harvested in {h['harvest_s']:.2f} s; byte-level BPE of {bpe['vocab']} entries "
        f"({bpe['merges']} merges from {bpe['words']} distinct words, {bpe['filler']} filler) in {bpe_s:.2f} s; "
        f"roberta-base checkpoint written in {ckpt_s:.2f} s")

    rec: dict = dict(steps=[], losses=[], call=None, model=None)
    real = dict(step=RealmTrainStep.train_step_accum, kernel=dense_mod.fused_mips_binned, build=cli.build_model)

    def step(self, engines, corpus, micro, generator, weights, **kw):
        events = [torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)]
        before = dict(fused_mips_binned.body_launches)
        events[0].record()
        metrics, rel, scores = real["step"](self, engines, corpus, micro, generator, weights, **kw)
        events[1].record()
        rec["steps"].append((events, {k: v - before[k] for k, v in fused_mips_binned.body_launches.items()}))
        rec["losses"].append(metrics["loss"].detach())
        return metrics, rel, scores

    def kernel(vectors, queries, **kw):
        if rec["call"] is None:
            rec["call"] = (vectors, queries.detach().clone(), dict(kw))
        return real["kernel"](vectors, queries, **kw)

    patches = [(RealmTrainStep, "train_step_accum", step), (dense_mod, "fused_mips_binned", kernel)]
    for obj, name, fn in patches:
        setattr(obj, name, fn)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        fused_mips_binned.launches = 0
        fused_mips_binned.body_launches.update(wgmma=0, fma=0)  # main path starts
        t_run = time.perf_counter()
        out = cli.main(["--config", str(yaml_path)])
        torch.cuda.synchronize()
        launches, bodies = fused_mips_binned.launches, dict(fused_mips_binned.body_launches)  # main path ends
        run_s = time.perf_counter() - t_run
        peak = torch.cuda.max_memory_allocated(dev)
    finally:
        for obj, name, fn in [(RealmTrainStep, "train_step_accum", real["step"]),
                              (dense_mod, "fused_mips_binned", real["kernel"])]:
            setattr(obj, name, fn)
    model = out["model"]
    enc = model.encoder.backbone
    check(out["state"].step == t["max_steps"], f"15b: the run ended at step {out['state'].step}")
    check(enc.embeddings.token_type_embeddings.weight.shape[0] == 1 and len(enc.layers) == hf["num_hidden_layers"]
          and enc.embeddings.word_embeddings.weight.shape == (hf["vocab_size"], hf["hidden_size"]),
          "15b: the encoder is not the checkpoint's roberta-base backbone")
    losses = [float(x) for x in rec["losses"]]
    check(len(losses) == t["max_steps"] and all(math.isfinite(x) for x in losses), f"15b: losses {losses}")
    check(launches > 0 and bodies == {"wgmma": launches, "fma": 0}
          and all(b["wgmma"] >= 1 and b["fma"] == 0 for _, b in rec["steps"]),
          f"15b: fused_mips_binned launched {launches} times, by body {bodies}, per step "
          f"{[b for _, b in rec['steps']]}")
    step_ms = [s.elapsed_time(e) for (s, e), _ in rec["steps"]]

    vv, q, kw = rec["call"]
    b, d = q.shape
    check(d == hf["hidden_size"], f"15b: the loop's call is at D = {d}")
    body = _binned_body(vv.dtype, d, kw["bins"], (vv.data_ptr(), q.data_ptr()))
    check(body == "wgmma", f"15b: the loop's call takes the {body} body")
    ks, ki = fused_mips_binned(vv, q, **kw)
    rs, ri = fused_mips_binned_reference(vv, q, **kw)
    tol = 2 * d * 2.0**-24 * q.float().norm(dim=-1).max().item() * vv.float().norm(dim=-1).max().item()
    err, swaps = check_against_plain(f"15b loop binned B={b} D={d}", ks, ki, rs, ri, q, vv, tol)
    n_real, k = kw["n_real"], kw["k"]
    ms = time_ms(lambda: fused_mips_binned(vv, q, **kw), 20)
    plain_ms = time_ms(lambda: fused_mips_binned_reference(vv, q, **kw), 2)
    library_ms = time_ms(lambda: torch.topk(q @ vv[:n_real].T, k, dim=-1), 20)
    nbytes, ops = (n_real + b) * d * 2 + b * k * 8, 2 * b * n_real * d
    bound = max(nbytes / hbm, ops / peak_bf16) * 1e3
    bound_by = "bytes" if nbytes / hbm >= ops / peak_bf16 else "operations"
    log(f"15b loop call bf16 B={b} D={d} N={n_real} bins={kw['bins']} k={k} ({body}): max |kernel - plain| = "
        f"{err:.3g} (tol {tol:.3g}), {swaps} id swaps inside the band; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"library {library_ms:.4f} ms, bound {bound:.4f} ms ({bound_by}) [{card}]")
    del vv, q, ks, ki, rs, ri, out, model, enc, rec
    gc.collect()
    torch.cuda.empty_cache()
    wall = time.perf_counter() - started
    log(f"15b run [{card}]: {t['max_steps']} steps in {run_s:.2f} s ({launches} fused_mips_binned launches, by body "
        f"{bodies}); steps {json.dumps([round(x, 3) for x in step_ms])} ms (CUDA events); losses "
        f"{json.dumps([round(x, 6) for x in losses])}; peak memory {peak / 2**30:.4f} GiB")
    log(f"phase 15b wall time: {wall:.1f} s")
    return dict(run_s=run_s, launches=launches, body_launches=bodies, losses=losses, step_ms=step_ms,
                peak_mem_bytes=peak, max_abs_err=err, bpe=bpe, wall_s=wall, texts=texts, tmp=tmp, root=root,
                call=dict(shape=f"bfloat16 B={b} N={n_real} D={d} bins={kw['bins']} k={k}", ms=ms, plain_ms=plain_ms,
                          library_ms=library_ms, bound_ms=bound, bound_by=bound_by))


def tokenize_topk_phase(dev, card: str, hbm: float, t: dict, texts: list, root: Path) -> dict:
    """Phase 15c (module constant TOKENIZE): the host tokenizers' throughput
    on the same passages (sections/s; WordPiece from `harvest_beir`'s
    vocab.txt under `root`, the byte-level BPE of 15b, a Unigram of
    `write_unigram`), each built fresh so that its first pass is timed
    cold, padded to `max_length`; then `block_topk` on the card over a
    [rows, width] f32 block against `torch.topk` (scores exactly equal) and
    against itself on the CPU (ids and scores exactly equal; both select the
    lowest id among ties). Returns the numbers."""
    import torch

    from vod_tpu_torch.data.tokenizer import WordPieceTokenizer, load_tokenizer
    from vod_tpu_torch.ops.topk import block_topk

    started = time.perf_counter()
    sample = texts[: t["texts"]]
    uni = write_unigram(root / "unigram", texts, t["unigram_size"])
    rates = {}
    for name, path in (("wordpiece", root / "vocab"), ("bpe", root / "bpe"), ("unigram", root / "unigram")):
        tok = load_tokenizer(path)
        check((name == "wordpiece") == isinstance(tok, WordPieceTokenizer), f"15c: {name} read as {type(tok).__name__}")
        t0 = time.perf_counter()
        enc = tok(sample, max_length=t["max_length"], truncation=True, padding="max_length", return_tensors="np")
        seconds = time.perf_counter() - t0
        check(enc["input_ids"].shape == (len(sample), t["max_length"]), f"15c: {name} gave {enc['input_ids'].shape}")
        tokens = int(enc["attention_mask"].sum())
        rates[name] = dict(sections_per_s=len(sample) / seconds, tokens_per_section=tokens / len(sample))
    log(f"15c host tokenizers [{card}]: " + "; ".join(
        f"{n} {r['sections_per_s']:.1f} sections/s ({r['tokens_per_section']:.1f} tokens each)" for n, r in rates.items())
        + f" over {len(sample)} harvested passages, cold, padded to {t['max_length']} (Unigram of {uni['pieces']} pieces)")

    g = torch.Generator(device=dev).manual_seed(t["seed"])
    x = torch.randn((t["topk_rows"], t["topk_width"]), generator=g, device=dev)
    k, block = t["topk_k"], t["topk_block"]
    s, i = block_topk(x, k, block=block)
    ts, ti = torch.topk(x, k)
    cs, ci = block_topk(x.cpu(), k, block=block)
    check(torch.equal(s, ts) and torch.equal(i, ti), "15c: block_topk on the card != torch.topk")
    check(torch.equal(s.cpu(), cs) and torch.equal(i.cpu(), ci), "15c: block_topk on the card != on the CPU")
    ms = time_ms(lambda: block_topk(x, k, block=block), 10)
    topk_ms = time_ms(lambda: torch.topk(x, k), 10)
    nbytes = x.numel() * 4 + x.shape[0] * k * 12
    bound = nbytes / hbm * 1e3
    log(f"15c block_topk [{card}]: [{t['topk_rows']}, {t['topk_width']}] f32, k = {k}, blocks of {block}: ids and "
        f"scores equal torch.topk's and the CPU's; {ms:.4f} ms, torch.topk {topk_ms:.4f} ms, bound {bound:.4f} ms (bytes)")
    del x, s, i, ts, ti
    torch.cuda.empty_cache()
    wall = time.perf_counter() - started
    log(f"phase 15c wall time: {wall:.1f} s")
    return dict(tokenizers=rates, unigram=uni, block_topk=dict(ms=ms, torch_topk_ms=topk_ms, bound_ms=bound,
                                                               shape=f"[{t['topk_rows']}, {t['topk_width']}] f32 k={k}"),
                wall_s=wall)


def gradcache_dp_steps(dev, run: dict, t: dict, out_dir: Path, train_step, checksum) -> list:
    """Phase 15d on this rank (rides 13c's rank job, after its CLI run): two
    optimizer steps of the CLI's train step with GradCache at
    `t["gradcache_rows"]` rows a chunk over the split batch, on the first
    step's collated micro-batch (saved by the job) in place of live
    retrieval; the SPLADE encoder sows its FLOPS term, so each global chunk's
    statistics meet over the ranks. Rank 0 saves the weights before them
    for the one-process check. Returns each step's loss, ms and whether the
    parameters equal rank 0's after it."""
    import types

    import torch
    import torch.distributed as dist

    from vod_tpu_torch.parallel import data_parallel, make_mesh
    from vod_tpu_torch.types.batch import RealmBatch

    rank, world = dist.get_rank(), dist.get_world_size()
    step_fn, model = run["step_fn"], run["model"]
    saved = torch.load(out_dir / f"batch-rank{rank}-0.pt", weights_only=False)
    batch = RealmBatch(**{k: v.to(dev) if isinstance(v, torch.Tensor) else v for k, v in saved.items()})
    if rank == 0:
        torch.save({k: v.cpu() for k, v in model.state_dict().items()}, out_dir / "state-gradcache.pt")
    dist.barrier()
    dp = data_parallel(make_mesh((world,), ("dp",)), "dp", int(batch.query__input_ids.shape[0]) * world)
    step_fn.gradcache_chunk_rows = t["gradcache_rows"]
    step_fn.collate = lambda *args, **kw: batch  # the saved micro-batch in place of live retrieval
    out = []
    try:
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics, _, _ = train_step(step_fn, None, None, [types.SimpleNamespace(input_ids=batch.query__input_ids)],
                                       torch.Generator(device=dev), {}, dp=dp)
            torch.cuda.synchronize()
            out.append(dict(loss=float(metrics["loss"]), ms=(time.perf_counter() - t0) * 1e3,
                            checksum_ok=checksum(model)))
    finally:
        del step_fn.collate
        step_fn.gradcache_chunk_rows = None
    return out


def rank_job(job: str, out_dir: Path, params: dict) -> None:
    """One rank of a phase-12, 13 or 14 group under torchrun (`chip_smoke.py --rank-job
    <job> <out_dir> <params json>`): joins the group from torchrun's
    environment on `cuda:{LOCAL_RANK % device_count}` with `params["backend"]`,
    runs the job and writes its result to `out_dir/<job>-rank<r>.json`. A
    failed check exits non-zero, and torchrun then fails the group."""
    import torch

    from vod_tpu_torch.examples import mips_kernel_bench
    from vod_tpu_torch.parallel import init_distributed, rank_device

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank, world = init_distributed(backend=params["backend"], device="cuda")
    dev = rank_device()
    card = mips_kernel_bench.card_name(dev)
    try:
        if job == "sharded":
            res = sharded_search_rank(dev, card, params["hbm"], params["peak_int8"], params)
        elif job == "compressed":
            res = compressed_search_rank(dev, card, params)
        elif job in ("pq_cli", "splade_cli"):
            res = batchwide_cli_rank(dev, card, params, out_dir)
        elif job == "parallel":
            res = parallel_rank(dev, card, params)
        else:
            res = cli_rank(dev, card, params, out_dir)
        (out_dir / f"{job}-rank{rank}.json").write_text(json.dumps(res))
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def torchrun(job: str, world: int, out_dir: Path, params: dict, timeout: int) -> tuple[list, float]:
    """`python -m torch.distributed.run --standalone --nproc_per_node <world>
    chip_smoke.py --rank-job <job> ...` (torchrun), its output to a log under
    `out_dir`; the whole process group is killed at `timeout`. Fails unless
    every rank exits 0 and writes its result. Returns (the ranks' results,
    wall seconds)."""
    import os
    import signal
    import subprocess

    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", f"--nproc_per_node={world}",
           str(ROOT / "chip_smoke.py"), "--rank-job", job, str(out_dir), json.dumps(params)]
    log_path = out_dir / f"{job}-{params['backend']}.log"
    t0 = time.perf_counter()
    with open(log_path, "w") as f:
        proc = subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT, cwd=ROOT, start_new_session=True)
        try:
            rc = proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
            rc = "timeout"
    wall = time.perf_counter() - t0
    text = log_path.read_text(errors="replace")
    if rc != 0:
        print(text[-8000:], file=sys.stderr, flush=True)
        fail(f"torchrun {job} over {world} ranks ({params['backend']}): exit {rc}")
    for line in text.splitlines():
        if line.startswith("[rank") or ("'loss'" in line and line.startswith("[")):
            log(f"  {job}/{params['backend']}: {line[:300]}")
    return [json.loads((out_dir / f"{job}-rank{r}.json").read_text()) for r in range(world)], wall


def multi_device_phase(dev, card: str, hbm: float, peak_int8: float, t: dict, tc: dict) -> dict:
    """Phase 12: multi-device on torch.distributed (`SHARDED`, `MULTI_CLI`).
    12a: `sharded_search_rank` at world size 1 under NCCL in this process,
    then on `t["ranks"]` ranks of the one card under gloo (torchrun). 12b:
    the experiment CLI under torchrun with `tc["ranks"]` ranks of the one
    card (gloo), `cli_rank` on each. Checked: every loss finite; both ranks'
    parameters equal after every step; at least one `fused_mips_binned`
    launch a step on each rank, all `wgmma`, on a `ShardedDenseIndex` shard;
    rank 0 writes each checkpoint (one a period) and rank 1 none, and both
    ranks load it on resume; the first step's mean loss over the ranks
    equals one process's loss of the same global batch (the ranks'
    collated rows, the weights before the step) within `tc["loss_rtol"]`;
    both ranks exit 0. 12c: with two or more cards, 12b again under NCCL at
    world size = the cards' count; with one, a line says why it did not run.
    Returns the numbers."""
    import tempfile

    import torch

    from vod_tpu_torch.exps import cli
    from vod_tpu_torch.exps.structconf import Experiment
    from vod_tpu_torch.parallel import init_distributed
    from vod_tpu_torch.types.batch import RealmBatch

    started = time.perf_counter()
    tmp = tempfile.TemporaryDirectory()
    root = Path(tmp.name)
    out: dict = {}

    # 12a at world size 1: a real NCCL group in this process
    check(init_distributed(num_processes=1, process_id=0, device="cuda", init_method=f"file://{root / 'pg'}")
          == (0, 1), "12a: the world-size-1 group did not form")
    try:
        out["w1"] = sharded_search_rank(dev, card, hbm, peak_int8, t)
    finally:  # a failed check exits at once, not after NCCL's watchdog times out
        torch.distributed.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    w1 = out["w1"]
    log(f"12a world 1 ({w1['backend']}): {w1['rows']} rows a shard, build {w1['build_ms']:.1f} ms; per-shard kernel "
        f"{w1['ms']:.4f} ms, plain {w1['plain_ms']:.4f} ms, library {w1['library_ms']:.4f} ms, bound "
        f"{w1['bound_ms']:.4f} ms ({w1['bound_by']}); merge {w1['merge_ms']:.4f} ms, search {w1['search_ms']:.4f} ms; "
        f"recall@10 {w1['recall_at_10']:.4f} [{card}]")

    # 12a over two ranks of the one card (gloo)
    params = dict(t, backend="gloo", hbm=hbm, peak_int8=peak_int8)
    ranks, wall = torchrun("sharded", t["ranks"], root, params, t["timeout"])
    out["gloo"] = ranks
    for r in ranks:
        check(r["backend"] == "gloo" and r["rows"] == t["n"] // t["ranks"], f"12a rank {r['rank']}: {r['rows']} rows")
        log(f"12a rank {r['rank']}/{r['world']} (gloo, both on one card): {r['rows']} rows a shard, build "
            f"{r['build_ms']:.1f} ms; per-shard kernel {r['ms']:.4f} ms (wgmma), plain {r['plain_ms']:.4f} ms, library "
            f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}); merge over gloo "
            f"{r['merge_ms']:.4f} ms, search {r['search_ms']:.4f} ms; recall@10 {r['recall_at_10']:.4f} [{card}]")
    log(f"12a over {t['ranks']} gloo ranks: torchrun wall {wall:.1f} s")

    # 12b: the CLI under torchrun, two ranks of the one card (gloo)
    tc = dict(tc)
    h = harvest_beir(root / "cli", tc)
    run = root / "cli" / "run"
    yaml_path = root / "cli" / "exp.yaml"
    yaml_path.write_text(
        f"extends: ['{ROOT / 'configs' / 'scifact_ranker.yaml'}', strategy/dp, search/sharded]\n"
        f"tokenizer: {{name_or_path: '{h['vocab_dir']}', max_length: {tc['max_length']}}}\n"
        "search_defaults:\n"
        "  dense: {codec: int8, sharded: true, shard_axis: dp, kernel: fused}\n"
        f"trainer: {{max_steps: {tc['max_steps']}, period: {tc['period']}, log_interval: 1, "
        f"checkpoint_path: '{run}'}}\n"
        "datasets:\n"
        "  queries:\n"
        f"    - {{identifier: harvest-train, name_or_path: beir, subsets: ['{h['beir']}'], split: train, "
        "link: harvest-corpus}\n"
        "  sections:\n"
        f"    - {{identifier: harvest-corpus, name_or_path: beir, subsets: ['{h['beir']}']}}\n"
    )
    exp = Experiment.from_file(str(yaml_path))
    m, col, tr, dn = exp.model, exp.collate, exp.trainer, exp.search_defaults.dense
    check((m.kind, m.gradients, m.hidden_size, m.num_layers, m.num_heads, m.intermediate_size) ==
          ("ranker", "retrieval", 256, 4, 4, 1024)
          and (exp.tokenizer.max_length, exp.dataloader.batch_size, col.n_sections, col.prefetch_n_sections,
               tr.learning_rate, tr.gradient_clip_val) == (200, 32, 8, 100, 1e-4, 1.0)
          and (list(exp.sys.mesh_shape), list(exp.sys.mesh_axes)) == ([-1], ["dp"])
          and (dn.codec, dn.sharded, dn.shard_axis, dn.kernel) == ("int8", True, "dp", "fused"),
          "12b: the parsed Experiment is not scifact_ranker under strategy/dp and search/sharded")
    log(f"12b inputs: {tc['n']} passages harvested in {h['harvest_s']:.2f} s; {tc['queries']} queries")

    def run_cli(world: int, backend: str) -> dict:
        import shutil

        shutil.rmtree(run, ignore_errors=True)  # a run of its own: 12c starts from step 0 too
        params = dict(tc, backend=backend, yaml=str(yaml_path), run=str(run), hbm=hbm, peak_int8=peak_int8)
        ranks, wall = torchrun("cli", world, root / "cli", params, tc["timeout"])
        n_steps = tc["resume_steps"]
        for r in ranks:
            label = f"12b rank {r['rank']}/{world} ({backend})"
            check(r["backend"] == backend and r["first_step"] == tc["max_steps"]
                  and r["resumed_step"] == tc["resume_steps"], f"{label}: steps {r['first_step']}, {r['resumed_step']}")
            check(len(r["steps"]) == n_steps, f"{label}: {len(r['steps'])} optimizer steps, not {n_steps}")
            check(all(math.isfinite(s["loss"]) for s in r["steps"]), f"{label}: a loss is not finite")
            check(all(s["checksum_ok"] for s in r["steps"]), f"{label}: parameters differ from rank 0's after a step")
            check(all(s["launches"]["wgmma"] >= 1 and s["launches"]["fma"] == 0 for s in r["steps"]),
                  f"{label}: a step without a wgmma launch of fused_mips_binned: {[s['launches'] for s in r['steps']]}")
            # the resume reads config.json, where every batch field counts as set: per_device drives the loader
            rows = [exp.dataloader.batch_size // world] * tc["max_steps"] + [
                exp.trainer.batch_size.per_device // world] * (tc["resume_steps"] - tc["max_steps"])
            check([s["rows"] for s in r["steps"]] == rows and all(s["index"] == "ShardedDenseIndex"
                                                                  for s in r["steps"]),
                  f"{label}: steps over {[s['rows'] for s in r['steps']]} rows, not {rows} of a sharded index")
            check(all(b_["type"] == "ShardedDenseIndex" for b_ in r["builds"]) and len(r["builds"]) == 3,
                  f"{label}: builds {r['builds']}")
            check(r["writes"] == (3 if r["rank"] == 0 else 0), f"{label}: {r['writes']} checkpoint writes")
            check(r["resume_ok"] is True, f"{label}: the resumed parameters differ from rank 0's")
        check(sorted(p.name for p in run.iterdir()) == ["config.json", "period-0", "period-1", "period-2"],
              f"12b: the run directory holds {sorted(p.name for p in run.iterdir())}")
        return dict(ranks=ranks, wall_s=wall)

    def one_process_loss(world: int) -> float:
        """The first step's loss of one process over the ranks' rows."""
        parts = [torch.load(root / "cli" / f"batch-rank{r}.pt", weights_only=False) for r in range(world)]
        fields = {k: torch.cat([p[k] for p in parts]).to(dev) if isinstance(parts[0][k], torch.Tensor) else parts[0][k]
                  for k in parts[0]}
        model = cli.build_model(exp.model, proposal_temperature=exp.collate.temperature, device=dev,
                                generator=torch.Generator(device=dev).manual_seed(exp.sys.seed))
        model.load_state_dict(torch.load(root / "cli" / "state0.pt", weights_only=True))
        with torch.no_grad():
            return float(model(RealmBatch(**fields), mode="evaluate").loss)

    out["cli"] = run_cli(tc["ranks"], "gloo")
    ranks = out["cli"]["ranks"]
    first = sum(r["steps"][0]["loss"] for r in ranks) / len(ranks)
    single = one_process_loss(tc["ranks"])
    rel = abs(first - single) / max(abs(single), 1e-12)
    check(rel <= tc["loss_rtol"], f"12b: first-step loss {first:.6f} over the ranks != one process's {single:.6f}")
    out["cli"].update(first_loss=first, one_process_loss=single, first_loss_rel=rel)
    for r in ranks:
        steady = [s["ms"] for i, s in enumerate(r["steps"]) if i % tc["period"] != 0]
        share = sum(s["coll_s"] for s in r["steps"]) * 1e3 / sum(s["ms"] for s in r["steps"])
        r.update(step_median_ms=statistics.median(steady), coll_bytes_step=statistics.median(
            [s["coll_bytes"] for s in r["steps"]]), coll_share=share)
        log(f"12b rank {r['rank']} (gloo, both on one card): step median {r['step_median_ms']:.2f} ms (first of each "
            f"period left out), {r['coll_bytes_step']:,} bytes of collectives a step ({share:.3f} of the step, gloo, "
            f"host wall); re-embeds {[round(x, 2) for x in r['reembed_s']]} s; sharded builds "
            f"{[round(b_['ms'], 1) for b_ in r['builds']]} ms; peak {r['peak_gib']:.4f} GiB; launches a step "
            f"{[s['launches']['wgmma'] for s in r['steps']]}; losses {[round(s['loss'], 5) for s in r['steps']]} "
            f"[{card}]")
    for r in ranks:
        c = r["call"]
        log(f"12b rank {r['rank']} loop call ({c['shape']}, equal to plain): kernel {c['ms']:.4f} ms, plain "
            f"{c['plain_ms']:.4f} ms, library {c['library_ms']} ms, bound {c['bound_ms']:.4f} ms ({c['bound_by']}) "
            f"[{card}]")
    log(f"12b: first-step loss over the ranks {first:.6f}, one process {single:.6f} (rel {rel:.2e}); "
        f"{r['n_params']:,} parameters; torchrun wall {out['cli']['wall_s']:.1f} s")

    # 12c: NCCL at world size 2 or more needs as many cards
    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        out["nccl"] = run_cli(n_cards, "nccl")
        log(f"12c: the CLI under NCCL over {n_cards} cards: torchrun wall {out['nccl']['wall_s']:.1f} s")
    else:
        out["nccl"] = None
        log(f"12c not run: NCCL at world size 2 or more needs 2 or more cards, and this machine has {n_cards}")
    tmp.cleanup()
    out["wall_s"] = time.perf_counter() - started
    log(f"phase 12 wall time: {out['wall_s']:.1f} s")
    return out



def _finite_numbers(label: str, obj) -> int:
    """Every number in a script's returned structure is finite; returns their count."""
    if isinstance(obj, bool) or obj is None or isinstance(obj, str):
        return 0
    if isinstance(obj, (int, float)):
        check(math.isfinite(obj), f"{label}: a non-finite number {obj}")
        return 1
    if isinstance(obj, dict):
        return sum(_finite_numbers(label, v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return sum(_finite_numbers(label, v) for v in obj)
    return 0


def serving_examples_phase(dev, card: str, hbm: float, peak_int8: float, t: dict) -> dict:
    """Phase 16a (module constant EXAMPLES): the ports of
    `serving_latency_bench` and `serving_codec_bench`, their `main`s in
    process at full width and 2^20 rows, each its own main path (launch
    counts zeroed just before it, read just after). Checked: each launched
    `fused_mips_binned`, every launch on `wgmma`; the codec sweep's rows
    recall at least `recall_floor`; one recorded coarse call at each of bins
    2048 and 4096 equal to `fused_mips_binned_reference` on the card in
    every returned id and int32 score, timed beside the plain version, the
    library (`topk(_int_mm)`) and the bound. Printed: p50/p99 with the batcher
    on and off, each sweep row's recall and ms. Returns the numbers."""
    import torch

    from vod_tpu_torch.examples import serving_codec_bench, serving_latency_bench
    from vod_tpu_torch.ops.mips import _binned_body, fused_mips_binned, fused_mips_binned_reference
    from vod_tpu_torch.search import dense as dense_module

    started = time.perf_counter()
    calls, real_kernel = [], dense_module.fused_mips_binned

    def recording_kernel(vectors, queries, **kw):
        out = real_kernel(vectors, queries, **kw)
        if len(calls) < 4096:
            calls.append((vectors, queries.clone(), kw, out))
        return out

    runs = {}
    for name, script, argv in (
        ("serving_latency_bench", serving_latency_bench,
         ["--n", str(t["n"]), "--train", str(t["train"]), "--requests", str(t["latency_requests"]),
          "--clients", str(t["latency_clients"]), "--window_ms", str(t["window_ms"])]),
        ("serving_codec_bench", serving_codec_bench,
         ["--n", str(t["n"]), "--train", str(t["train"]), "--blocks", str(t["codec_blocks"]),
          "--reps", str(t["codec_reps"])]),
    ):
        dense_module.fused_mips_binned = recording_kernel
        first = len(calls)
        torch.cuda.synchronize()
        fused_mips_binned.launches = 0
        fused_mips_binned.body_launches.update(wgmma=0, fma=0)  # main path starts
        t0 = time.perf_counter()
        try:
            result = script.main(argv + ["--device", "cuda"])
        finally:
            dense_module.fused_mips_binned = real_kernel
        torch.cuda.synchronize()
        launches, bodies = fused_mips_binned.launches, dict(fused_mips_binned.body_launches)  # main path ends
        wall = time.perf_counter() - t0
        check(launches > 0 and bodies == {"wgmma": launches, "fma": 0},
              f"16a {name}: fused_mips_binned launches {launches}, by body {bodies}")
        check(_finite_numbers(name, result) > 0, f"16a {name}: no numbers returned")
        runs[name] = dict(result=result, launches=launches, body_launches=bodies, wall_s=wall,
                          calls=calls[first:])
        log(f"16a {name} [{card}]: {wall:.1f} s; fused_mips_binned launches {launches}, by body {bodies}")

    lat = runs["serving_latency_bench"]["result"]
    for label in ("uncoalesced", "coalesced"):
        r = lat[label]
        log(f"16a latency {label} (window {0.0 if label == 'uncoalesced' else t['window_ms']} ms) [{card}]: sequential "
            f"p50 {r['seq_p50_ms']:.4f} ms; {lat['clients']} clients p50 {r['conc_p50_ms']:.4f} ms, p99 "
            f"{r['conc_p99_ms']:.4f} ms; dispatches {r['dispatches']} for requests {r['requests']}")
    log(f"16a latency device ms per dispatch [{card}]: {json.dumps(lat['device_ms'])}")
    codec = runs["serving_codec_bench"]["result"]
    for row in codec["results"]:
        tag = row["kernel"] + (f" bins={row['fused_bins']} tile={row['fused_tile'] or 'auto'}"
                               if row["kernel"] == "fused" else "")
        check(row["recall"] >= t["recall_floor"], f"16a codec {tag} kf={row['k_factor']}: recall {row['recall']}")
        log(f"16a codec B={codec['B']} N={codec['n']} kf={row['k_factor']} [{tag}] [{card}]: recall@10 "
            f"{row['recall']:.4f}, {row['ms_block']:.4f} ms a block, {row['qps']:.1f} QPS")

    # one coarse kernel call at each bin count, held to the plain version on the card
    shapes = []
    for bins in (2048, 4096):
        vv, qq, kw, (ks, ki) = next(c for c in runs["serving_codec_bench"]["calls"]
                                    if c[2]["bins"] == bins and c[1].shape[0] == codec["B"])
        bq, dc = (int(x) for x in qq.shape)
        body = _binned_body(vv.dtype, dc, kw["bins"], (vv.data_ptr(), qq.data_ptr()))
        check(body == "wgmma", f"16a coarse call at bins {bins}: body {body}")
        rs, ri = fused_mips_binned_reference(vv, qq, **kw)
        check(torch.equal(ks, rs) and torch.equal(ki, ri), f"16a coarse int8 B={bq} bins={bins}: kernel != plain")
        ms = time_ms(lambda: fused_mips_binned(vv, qq, **kw), 20)
        plain_ms = time_ms(lambda: fused_mips_binned_reference(vv, qq, **kw), 2)
        library_ms = time_ms(lambda: torch.topk(torch._int_mm(qq, vv.T), kw["k"], dim=-1), 20)
        nbytes = (int(vv.shape[0]) + bq) * dc + bq * kw["k"] * 8
        ops = 2 * bq * int(vv.shape[0]) * dc
        bound = max(nbytes / hbm, ops / peak_int8) * 1e3
        shapes.append(dict(dtype="int8", body="wgmma", B=bq, N=int(vv.shape[0]), D=dc, bins=kw["bins"], k=kw["k"],
                           ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound,
                           bound_by="bytes" if nbytes / hbm >= ops / peak_int8 else "operations"))
        log(f"check 16a coarse int8 B={bq} N={vv.shape[0]} D={dc} bins={bins} k={kw['k']} (wgmma): ids and scores "
            f"equal the plain version; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library {library_ms:.4f} ms, "
            f"bound {bound:.4f} ms ({shapes[-1]['bound_by']}) [{card}]")
    for r in runs.values():
        r.pop("calls")
    del calls
    torch.cuda.empty_cache()
    wall = time.perf_counter() - started
    log(f"phase 16a wall time: {wall:.1f} s")
    return dict(runs=runs, shapes=shapes, wall_s=wall)


def small_examples_phase(dev, card: str, t: dict) -> dict:
    """Phase 16b (module constant EXAMPLES): the other 17 scripts' `main`s in
    process on the card at small sizes. Checked for each: it returns
    numbers, all finite; the floors where a script has one (search_flat's
    recall against numpy's exact ranking, real_embedding_eval's flat and
    int8 recall and its other recalls, hub_checkpoint_eval's skip without a
    cache and its run over a checkpoint the phase writes into a local HF
    cache layout; each sweep row's recall at its `SMALL_FLOORS` entry).
    Returns each script's wall time and result."""
    import importlib
    import os
    import tempfile

    import torch

    from vod_tpu_torch.ops.mips import fused_mips_binned

    started = time.perf_counter()
    tmp = tempfile.TemporaryDirectory()
    root = Path(tmp.name)
    n, tr = str(t["small_n"]), str(t["small_train"])
    emb = root / "emb.npy"
    hf_home = root / "hf"
    snapshot = hf_home / "hub" / "models--vod--tiny-bert" / "snapshots" / "0"
    write_hf_checkpoint(snapshot, dict(hf=t["hub"], seed=t["seed"]), dev)
    (hf_home / "hub" / "models--vod--tiny-bert" / "refs").mkdir(parents=True)
    (hf_home / "hub" / "models--vod--tiny-bert" / "refs" / "main").write_text("0")
    (snapshot / "vocab.txt").write_text("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
                                                  + [f"w{i}" for i in range(t["hub"]["vocab_size"] - 5)]))
    beir = str(ROOT / "tests" / "fixtures" / "beir_tiny")
    sweep = ["--n", n, "--train", tr, "--block", "1024", "--blocks", "2", "--reps", "1"]
    f = SMALL_FLOORS
    scripts = [
        ("search_flat", [], lambda r: r["recall"] >= t["flat_recall_floor"]),
        ("search_hybrid", [], lambda r: [row[0] for row in r["merged_labels"]] == [1, 1]),
        ("search_sparse_bench", [], lambda r: r["native"]),
        ("serving_batch_bench", [], lambda r: 0 < r["dispatches"] <= r["requests"]),
        ("realm_dataloader", [], lambda r: r["shapes"]["section__score"] == [2, 3]),
        ("train_periodic", [], lambda r: r["steps"] == 30),
        ("gradcache_bench", ["--b", "64", "--n_sections", "4", "--chunk", "64", "--ls", "64", "--n_corpus", "4096",
                             "--also_monolithic"], lambda r: all("loss1" in c for c in r["configs"])),
        ("real_embedding_eval", ["--n", str(t["real_n"]), "--steps", "20", "--batch", "128", "--q", "512",
                                 "--n_candidates", "1024", "--out", str(emb)],
         lambda r: min(r["bf16_recall10"], r["int8_recall10"]) >= t["real_recall_floor"]
         and min(v for k, v in r.items() if k.endswith("recall10")) >= f["real_embedding_eval"]),
        ("pq_codec_sweep", ["--emb", str(emb), "--q", "512", "--configs", "int8-flat,pq64x8-exh,d128"],
         lambda r: _rows_at_least(r, "name", "recall10", f["pq_codec_sweep"])),
        ("hub_checkpoint_eval", ["--model", "vod/tiny-bert", "--beir", beir, "--max_length", "64"],
         lambda r: "skipped" not in r and 0.0 <= r["recall_10"] <= 1.0),
        ("pq_geometry_sweep", sweep + ["--m_list", "16,32", "--k_factors", "16", "--kmeans_iters", "4"],
         lambda r: _rows_at_least(r, "codec", "recall10", f["pq_geometry_sweep"])),
        ("pq_decode_variants_bench", sweep + ["--chunks", "16384", "--kmeans_iters", "4"],
         lambda r: _rows_at_least(r, "variant", "recall10", f["pq_decode_variants_bench"])),
        ("pq4_adc_variants_bench", sweep + ["--chunk", "65536", "--big", "2048"],
         lambda r: _rows_at_least([x for x in r if "pool_recall10" in x], "variant", "pool_recall10",
                                  f["pq4_adc_variants_bench"])),
        ("pq4_fastscan_bench", sweep + ["--chunks", "32768", "--kmeans_iters", "4"],
         lambda r: _rows_at_least(r, "variant", "adc_recall10", f["pq4_fastscan_bench"])
         and min(x["pool160_containment"] for x in r) >= 0.96),
        ("pq_8m8_bench", sweep + ["--kmeans_iters", "4"],
         lambda r: _rows_at_least(r, "codec", "recall10", f["pq_8m8_bench"])),
        ("ivfpq_8m_bench", sweep + ["--c", "512", "--nprobes", "16,64", "--kmeans_iters", "4", "--spill"],
         lambda r: _rows_at_least(r, "nprobe", "recall10", f["ivfpq_8m_bench"])),
        ("ivfpq_crossover_bench", ["--n", n, "--train", tr, "--c", "512", "--nprobes", "16,64", "--blocks", "3",
                                   "--reps", "1", "--http_requests", "8"],
         lambda r: _rows_at_least(r["points"], "engine", "recall10", f["ivfpq_crossover_bench"])),
    ]
    out = {}
    hf_before = os.environ.get("HF_HOME")
    for name, argv, floor in scripts:
        module = importlib.import_module(f"vod_tpu_torch.examples.{name}")
        if name == "hub_checkpoint_eval":  # the skip path first: an empty cache
            os.environ["HF_HOME"] = str(root / "empty-hf")
            skip = module.main(argv + ["--device", "cuda"])
            check(set(skip) == {"skipped"}, f"16b hub_checkpoint_eval without a cache: {skip}")
            os.environ["HF_HOME"] = str(hf_home)
        fused_mips_binned.launches = 0
        t0 = time.perf_counter()
        try:
            result = module.main(argv + ["--device", "cuda"])
        finally:
            if hf_before is None:
                os.environ.pop("HF_HOME", None)
            else:
                os.environ["HF_HOME"] = hf_before
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        count = _finite_numbers(name, result)
        check(count > 0, f"16b {name}: no numbers returned")
        check(bool(floor(result)), f"16b {name}: its floor failed: {json.dumps(result)[:600]}")
        out[name] = dict(wall_s=wall, result=result, launches=fused_mips_binned.launches)
        log(f"16b {name} [{card}]: {wall:.1f} s, {count} finite numbers, floor held; fused_mips_binned launches "
            f"{fused_mips_binned.launches}")
        gc.collect()
        torch.cuda.empty_cache()
    tmp.cleanup()
    wall = time.perf_counter() - started
    log(f"phase 16b wall time: {wall:.1f} s")
    return dict(scripts=out, wall_s=wall)



def precompiled_phase(card: str, t: dict) -> dict:
    """Phase 16c (module constant EXAMPLES): `Precompiled` tokenization on the
    host. A Unigram `tokenizer.json` (`write_unigram`, over harvested
    passages) and a copy whose normalizer starts with a `Precompiled`
    charsmap of NFKC over the Basic Multilingual Plane
    (`data/precompiled.py:build_charsmap`), each read fresh by the port
    and timed cold over the same passages. Checked: the charsmap normalizes
    a known string, and both tokenizers give the same shapes. Printed:
    sections/s of each. Returns the numbers."""
    import base64
    import tempfile
    import unicodedata

    from vod_tpu_torch.data.loaders.local_text import harvest_text_passages
    from vod_tpu_torch.data.precompiled import CharsMap, build_charsmap
    from vod_tpu_torch.data.tokenizer import load_tokenizer

    started = time.perf_counter()
    texts = [p["content"] for p in harvest_text_passages(t["texts"])]
    rules = {}
    for cp in range(0xA0, 0x10000):
        c = chr(cp)
        if unicodedata.category(c) in ("Cs", "Co", "Cn"):
            continue
        n = unicodedata.normalize("NFKC", c)
        if n != c:
            rules[c] = n
    t0 = time.perf_counter()
    blob = build_charsmap(rules)
    build_s = time.perf_counter() - t0
    check(CharsMap(blob).normalize_str("ﬁ① Ａ\u00a0x") == "fi1 A x", "16c: the charsmap does not normalize")
    tmp = tempfile.TemporaryDirectory()
    root = Path(tmp.name)
    uni = write_unigram(root / "unigram", texts, t["unigram_size"])
    spec = json.loads((root / "unigram" / "tokenizer.json").read_text())
    spec["normalizer"]["normalizers"][0] = {"type": "Precompiled",
                                            "precompiled_charsmap": base64.b64encode(blob).decode()}
    (root / "precompiled").mkdir()
    (root / "precompiled" / "tokenizer.json").write_text(json.dumps(spec, ensure_ascii=False))
    (root / "precompiled" / "tokenizer_config.json").write_text(
        (root / "unigram" / "tokenizer_config.json").read_text())
    rates, shapes = {}, {}
    for name in ("unigram", "precompiled"):
        tok = load_tokenizer(root / name)
        t0 = time.perf_counter()
        enc = tok(texts, max_length=200, truncation=True, padding="max_length", return_tensors="np")
        seconds = time.perf_counter() - t0
        shapes[name] = enc["input_ids"].shape
        rates[name] = dict(sections_per_s=len(texts) / seconds,
                           tokens_per_section=int(enc["attention_mask"].sum()) / len(texts))
    check(shapes["unigram"] == shapes["precompiled"] == (len(texts), 200), f"16c: shapes {shapes}")
    tmp.cleanup()
    wall = time.perf_counter() - started
    log(f"16c Precompiled [{card} host]: a charsmap of {len(rules)} NFKC rules ({len(blob)} bytes, built in "
        f"{build_s:.2f} s); over {len(texts)} harvested passages, cold, padded to 200: Unigram "
        f"{rates['unigram']['sections_per_s']:.1f} sections/s ({rates['unigram']['tokens_per_section']:.1f} tokens "
        f"each), with Precompiled {rates['precompiled']['sections_per_s']:.1f} sections/s "
        f"({rates['precompiled']['tokens_per_section']:.1f} tokens each); Unigram of {uni['pieces']} pieces")
    log(f"phase 16c wall time: {wall:.1f} s")
    return dict(rules=len(rules), blob_bytes=len(blob), tokenizers=rates, wall_s=wall)


def realtext_phase(card: str, t: dict) -> dict:
    """Phase 17a (module constant REALTEXT): `real_text_1m_bench.main` over
    `t["n"]` harvested passages at the script's widths, in a fresh cache
    directory, its own main path (launch counts zeroed just before it, read
    just after). Checked: every number finite; all `t["n"]` passages
    harvested; the loss's last value under its first; each codec's
    recall@10 at least its floor; stemmed BM25 finds more gold passages than
    unstemmed on the inflected queries; neither kernel launched (the codecs
    scan, as in JAX). Printed: the corpus fingerprint, each stage's
    seconds, each codec's recall, block and B = 64 QPS and build seconds,
    and the four gold-hit numbers. Returns the result and the launches."""
    import tempfile

    import torch

    from vod_tpu_torch.examples import real_text_1m_bench
    from vod_tpu_torch.ops.mips import fused_mips_binned, fused_mips_topk

    started = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="realtext_") as cache:
        fused_mips_binned.launches = 0
        fused_mips_topk.launches = 0  # main path starts
        r = real_text_1m_bench.main(["--n", str(t["n"]), "--device", "cuda"], cache_dir=cache)
        torch.cuda.synchronize()
        launches = {"fused_mips_binned": fused_mips_binned.launches, "fused_mips_topk": fused_mips_topk.launches}
    count = _finite_numbers("17a", r)
    check(r["n"] == t["n"], f"17a: harvested {r['n']} passages, not {t['n']}")
    log(f"17a real text [{card}]: {r['n']} passages, corpus fingerprint {r['corpus_fingerprint']} (under "
        f"{', '.join(r['harvest_root'])}); stages (s) {json.dumps(r['stages_s'])}; {count} finite numbers")
    losses = r["losses"]
    check(list(losses) == [0, 100, 200, 299] and losses[299] < losses[0], f"17a: the loss did not fall: {losses}")
    log(f"17a losses by step {', '.join(f'{s}: {v:.4f}' for s, v in losses.items())}; top-64 variance share "
        f"{r['top64_variance_share']:.4f}; encoder self-hit@10 {r['encoder_self_hit10']:.4f}")
    for name, floor in t["recall_floors"].items():
        c = r[name]
        check(c["recall10"] >= floor, f"17a {name}: recall@10 {c['recall10']} < {floor}")
        log(f"17a {name} [{card}]: recall@10 {c['recall10']:.4f} (floor {floor}), block QPS {c['block_qps']:.1f}, "
            f"B=64 serving QPS {c['serve64_qps']:.1f}, build {c['build_s']:.2f} s")
    plain, stemmed = r["bm25_unstemmed"], r["bm25_stemmed"]
    log(f"17a BM25 gold-hit@10 [{card}]: unstemmed {plain['gold_hit10']:.4f} / inflected "
        f"{plain['gold_hit10_inflected']:.4f} (build {plain['build_s']:.1f} s); stemmed {stemmed['gold_hit10']:.4f} / "
        f"inflected {stemmed['gold_hit10_inflected']:.4f} (build {stemmed['build_s']:.1f} s)")
    check(stemmed["gold_hit10_inflected"] > plain["gold_hit10_inflected"],
          "17a: stemming did not help the inflected queries")
    check(launches == {"fused_mips_binned": 0, "fused_mips_topk": 0}, f"17a launched a kernel: {launches}")
    wall = time.perf_counter() - started
    log(f"phase 17a wall time: {wall:.1f} s; launches {launches}")
    return dict(result=r, launches=launches, wall_s=wall)


def hybrid_sharded_phase(card: str) -> dict:
    """Phase 17b: `hybrid_sharded_bench.main` at the JAX script's full size,
    its two ranks launched by the script on the card (gloo: NCCL refuses two
    ranks on one GPU). The script checks the subset filter on every id and
    the sharded ids' agreement with the unsharded ones (>= 0.9); checked
    here too, with rank 0's launches of either kernel (none: every query
    carries a subset filter). Printed: QPS, the unsharded / sharded time
    ratio (not bounded on a card), each run's seconds. Returns the result."""
    from vod_tpu_torch.examples import hybrid_sharded_bench

    started = time.perf_counter()
    r = hybrid_sharded_bench.main(["--device", "cuda"])
    _finite_numbers("17b", r)
    check(r["agreement"] >= hybrid_sharded_bench.MIN_AGREEMENT, f"17b: agreement {r['agreement']}")
    check(r["kernel_launches"] == {"fused_mips_binned": 0, "fused_mips_topk": 0},
          f"17b: rank 0 launched a kernel: {r['kernel_launches']}")
    wall = time.perf_counter() - started
    log(f"17b hybrid sharded [{card}]: {r['metric']}; {r['value']:.1f} {r['unit']}; vs_baseline (unsharded / "
        f"sharded time) {r['vs_baseline']:.4f}; unsharded s {r['unsharded_s']}, sharded s {r['sharded_s']}")
    log(f"phase 17b wall time: {wall:.1f} s")
    return dict(result=r, wall_s=wall)


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
    if len(sys.argv) == 5 and sys.argv[1] == "--rank-job":  # one rank of phase 12, 13 or 14, under torchrun
        rank_job(sys.argv[2], Path(sys.argv[3]), json.loads(sys.argv[4]))
        return
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

    # 9. the experiment CLI from text to a train step (its own main paths)
    gc.collect()
    torch.cuda.empty_cache()
    cli = cli_phase(dev, card, hbm, peak_bf16, CLI)

    # 10. the large-encoder path of the CLI (its own main path)
    gc.collect()
    torch.cuda.empty_cache()
    large = large_cli_phase(dev, card, hbm, peak_bf16, LARGE)

    # 11. SPLADE through the CLI (11a), the second stage over its index (11b),
    # the dynamic store and the embedding cache (11c)
    gc.collect()
    torch.cuda.empty_cache()
    t11 = time.perf_counter()
    splade, ctx = splade_cli_phase(dev, card, SPLADE)
    second_stage = second_stage_phase(dev, card, SECOND_STAGE, ctx)
    corpus11 = ctx["corpus"]
    ctx["tmp"].cleanup()
    del ctx
    gc.collect()
    torch.cuda.empty_cache()
    dynamic = dynamic_cache_phase(dev, card, DYNAMIC, corpus11)
    del corpus11
    phase11_s = time.perf_counter() - t11
    log(f"phase 11 wall time: {phase11_s:.1f} s")

    # 12. multi-device on torch.distributed: sharded search at world size 1
    # (NCCL) and over two ranks of the card (gloo) (12a), the CLI under
    # torchrun (12b), NCCL over two or more cards where there are (12c)
    gc.collect()
    torch.cuda.empty_cache()
    multi = multi_device_phase(dev, card, hbm, peak_int8, SHARDED, MULTI_CLI)
    shard_keys = ("rank", "world", "backend", "rows", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                  "merge_ms", "search_ms", "recall_at_10", "build_ms")
    sharded = dict(
        shards=[{k: r[k] for k in shard_keys} for r in [multi["w1"], *multi["gloo"]]],
        cli=dict(first_loss=multi["cli"]["first_loss"], one_process_loss=multi["cli"]["one_process_loss"],
                 ranks=[{k: r[k] for k in ("rank", "step_median_ms", "coll_bytes_step", "coll_share", "reembed_s",
                                            "peak_gib", "n_params", "call")} | {"build_ms": [b_["ms"] for b_ in r["builds"]]}
                        for r in multi["cli"]["ranks"]], wall_s=multi["cli"]["wall_s"]),
        nccl_cards=None if multi["nccl"] is None else len(multi["nccl"]["ranks"]), wall_s=multi["wall_s"],
    )
    sharded_launches = dict(
        w1_nccl=multi["w1"]["launches"], gloo_ranks=[r["launches"] for r in multi["gloo"]],
        cli_ranks_per_step=[[s["launches"]["wgmma"] for s in r["steps"]] for r in multi["cli"]["ranks"]],
    )

    # 13. the sharded compressed indexes (13a) and batch-wide training over a
    # data-parallel group through the CLI (13b msmarco_pq_realm, 13c SPLADE);
    # NCCL over two or more cards where there are (13d)
    gc.collect()
    torch.cuda.empty_cache()
    batchwide = batchwide_phase(dev, card, COMPRESSED, PQ_CLI, SPLADE_DP)
    compressed_keys = ("type", "build_ms", "shard_ms", "merge_ms", "search_ms", "search_host_ms", "search_device_ms")
    phase13 = dict(
        compressed=[dict(rank=r["rank"], world=r["world"], backend=r["backend"], peak_gib=r["peak_gib"],
                         **{e: {k: v for k, v in r[e].items() if k in compressed_keys or "recall" in k
                                or k.startswith(("kmeans", "autotune", "untruncated"))}
                            for e in ("pq", "ivf", "ivfpq", "maxsim")})
                    for r in [batchwide["w1"], *batchwide["gloo"]]],
        pq_cli={k: batchwide["pq_cli"][k] for k in ("first_loss", "one_process_loss", "first_loss_rel", "wall_s")}
        | dict(ranks=[{k: r[k] for k in ("rank", "step_median_ms", "coll_share", "coll_bytes_step", "reembed_s",
                                         "peak_gib", "autotune", "n_params")} for r in batchwide["pq_cli"]["ranks"]]),
        splade_cli={k: batchwide["splade_cli"][k] for k in ("first_loss", "one_process_loss", "first_loss_rel",
                                                              "wall_s", "one_process_reembed_s", "table_width")}
        | dict(ranks=[{k: r[k] for k in ("rank", "step_median_ms", "coll_share", "coll_bytes_step", "reembed_s",
                                         "peak_gib", "n_params")} for r in batchwide["splade_cli"]["ranks"]]),
        nccl_cards=None if batchwide["nccl"] is None else len(batchwide["nccl"]), wall_s=batchwide["wall_s"],
    )
    # every phase-13 path launched neither kernel (checked in the phase)
    phase13_launches = dict(
        compressed=[{e: r[e]["launches"] for e in ("pq", "ivf", "ivfpq", "maxsim")}
                    for r in [batchwide["w1"], *batchwide["gloo"]]],
        pq_cli=[r["launches"] for r in batchwide["pq_cli"]["ranks"]],
        splade_cli=[r["launches"] for r in batchwide["splade_cli"]["ranks"]],
    )

    # 14. the MoE encoder through the CLI (14a); model parallelism on two gloo
    # ranks of the card (14b); under NCCL over two or more cards where there are (14c)
    gc.collect()
    torch.cuda.empty_cache()
    t14 = time.perf_counter()
    moe_cli = moe_cli_phase(dev, card, hbm, peak_bf16, MOE_CLI)
    gc.collect()
    torch.cuda.empty_cache()
    model_parallel = model_parallel_phase(dev, card, PARALLEL)
    leg_keys = ("err", "ms", "coll_share", "collectives")
    phase14 = dict(
        moe_cli={k: moe_cli[k] for k in ("run1_s", "run2_s", "losses", "aux", "aux_share", "step_ms", "step_host_ms",
                                         "moe_ffn_ms", "dense_ffn_ms", "ffn_shape", "peak_mem_bytes", "wall_s")},
        parallel=[dict(rank=r["rank"], world=r["world"], backend=r["backend"], one_rank_ms=r["one_rank_ms"],
                       bf16_vs_f32=r["bf16_vs_f32"], peak_gib=r["peak_gib"],
                       legs={n: {k: leg[k] for k in (*leg_keys, "err_f32", "f32_err", "one_rank_ms", "aux_err")
                                 if k in leg} for n, leg in r["legs"].items()})
                  for r in model_parallel["gloo"] + (model_parallel["nccl"] or [])],
        nccl_cards=None if model_parallel["nccl"] is None else len(model_parallel["nccl"]),
        wall_s=time.perf_counter() - t14,
    )
    log(f"phase 14 wall time: {phase14['wall_s']:.1f} s")

    # 15. profiler traces through the CLI (15a), a roberta-base-width encoder
    # with the port's byte-level BPE through the CLI (15b), the host
    # tokenizers' throughput and block_topk on the card (15c); 15d (GradCache
    # with the FLOPS term over two ranks) ran in 13c's rank job
    gc.collect()
    torch.cuda.empty_cache()
    t15 = time.perf_counter()
    profiled = profiled_cli_phase(dev, card, PROFILED_CLI)
    gc.collect()
    torch.cuda.empty_cache()
    roberta = roberta_cli_phase(dev, card, hbm, peak_bf16, ROBERTA_CLI)
    tokenize = tokenize_topk_phase(dev, card, hbm, TOKENIZE, roberta.pop("texts"), roberta["root"])
    roberta.pop("tmp").cleanup()
    del roberta["root"]
    phase15 = dict(profiled_cli={k: v for k, v in profiled.items() if k not in ("launches", "body_launches")},
                   roberta_cli={k: v for k, v in roberta.items() if k not in ("launches", "body_launches", "call")},
                   tokenize=tokenize, gradcache_dp=batchwide["splade_cli"]["gradcache"],
                   wall_s=time.perf_counter() - t15)
    log(f"phase 15 wall time: {phase15['wall_s']:.1f} s")

    # 16. the root examples/ scripts' ports: the two serving scripts on the
    # binned kernel at full width (16a), the other 17 at small sizes (16b),
    # Precompiled tokenization on the host (16c)
    gc.collect()
    torch.cuda.empty_cache()
    t16 = time.perf_counter()
    serving16 = serving_examples_phase(dev, card, hbm, peak_int8, EXAMPLES)
    small16 = small_examples_phase(dev, card, EXAMPLES)
    precompiled16 = precompiled_phase(card, EXAMPLES)
    phase16 = dict(
        serving={name: {k: r[k] for k in ("result", "launches", "body_launches", "wall_s")}
                 for name, r in serving16["runs"].items()},
        coarse_shapes=serving16["shapes"],
        scripts={name: dict(wall_s=r["wall_s"], launches=r["launches"]) for name, r in small16["scripts"].items()},
        precompiled=precompiled16, wall_s=time.perf_counter() - t16,
    )
    log(f"phase 16 wall time: {phase16['wall_s']:.1f} s")

    # 17. the last two root scripts' ports: real text at 2^18 passages (17a),
    # the sharded hybrid on two gloo ranks of the card (17b)
    gc.collect()
    torch.cuda.empty_cache()
    t17 = time.perf_counter()
    realtext17 = realtext_phase(card, REALTEXT)
    hybrid17 = hybrid_sharded_phase(card)
    phase17 = dict(realtext=realtext17["result"], hybrid=hybrid17["result"], wall_s=time.perf_counter() - t17)
    phase17_launches = dict(realtext=realtext17["launches"], hybrid_rank0=hybrid17["result"]["kernel_launches"])
    log(f"phase 17 wall time: {phase17['wall_s']:.1f} s")

    # 18. result lines
    main = next(s for s in shapes if s["dtype"] == "bfloat16" and s["B"] == 64 and s["bins"] == 1024
                and s["body"] == "wgmma")
    exact_main = next(s for s in exact_shapes if s["dtype"] == "bfloat16" and s["B"] == 2048 and s["k"] == 10
                      and s["body"] == "wgmma")
    kernels = [dict(
        name="fused_mips_binned", route="cuda", source="vod_tpu_torch/csrc/fused_mips_binned.cu",
        replaces="vod_tpu/ops/mips_pallas.py:151", launches=launches,
        max_abs_err=max(max_err, train["train_max_abs_err"], seq2seq["train_call"]["max_abs_err"], cli["max_abs_err"],
                        large["max_abs_err"], moe_cli["max_abs_err"], roberta["max_abs_err"]),
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
        cli_launches=cli["launches"], cli_body_launches=cli["body_launches"],
        cli_resume_launches=cli["resume_launches"], cli_resume_body_launches=cli["resume_body_launches"],
        cli_call=cli["call"], cli=cli,
        large_launches=large["launches"], large_body_launches=large["body_launches"], large_call=large["call"],
        large=large, splade_launches=splade["launches"]["fused_mips_binned"],
        second_stage_launches=second_stage["launches"]["fused_mips_binned"],
        phase11=dict(splade=splade, second_stage=second_stage, dynamic=dynamic, wall_s=phase11_s),
        sharded_launches=sharded_launches, sharded=sharded, phase13_launches=phase13_launches, phase13=phase13,
        moe_cli_launches=moe_cli["launches"], moe_cli_body_launches=moe_cli["body_launches"],
        moe_cli_resume_launches=moe_cli["resume_launches"], moe_cli_call=moe_cli["call"], phase14=phase14,
        profiled_cli_launches=profiled["launches"], profiled_cli_body_launches=profiled["body_launches"],
        roberta_cli_launches=roberta["launches"], roberta_cli_body_launches=roberta["body_launches"],
        roberta_cli_call=roberta["call"], phase15=phase15,
        examples_launches={name: r["launches"] for name, r in serving16["runs"].items()},
        examples_body_launches={name: r["body_launches"] for name, r in serving16["runs"].items()},
        examples_coarse_shapes=serving16["shapes"], phase16=phase16,
        phase17_launches=phase17_launches, phase17=phase17,
    ), dict(
        name="fused_mips_topk", route="cuda", source="vod_tpu_torch/csrc/fused_mips_topk.cu",
        replaces="vod_tpu/ops/mips_pallas.py:57", launches=shootout_launches["fused_mips_topk"],
        max_abs_err=exact_err, ms=exact_main["ms"], plain_ms=exact_main["plain_ms"],
        bound_ms=exact_main["bound_ms"], bound_by=exact_main["bound_by"], library_ms=exact_main["library_ms"],
        shape=f"bfloat16 B=2048 N={N_KERNEL} D={D} k=10", shapes=exact_shapes, shootout=shootout,
        body=exact_main["body"], body_launches=body_launches, corpus_read_ms=read_ms,
        body_ms={body: {f"{s['dtype']} B={s['B']} k={s['k']}": s["ms"] for s in exact_shapes if s["body"] == body}
                 for body in ("wgmma", "fma")},
        phase13_launches=phase13_launches, phase17_launches=phase17_launches,
    )]
    log(f"chip_smoke wall time: {time.perf_counter() - started:.1f} s, the kernels' build included")
    log(json.dumps({"kernels": kernels}))
    log(mips_kernel_bench.card_name(dev))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
