"""Training: the live-retrieval train step and the host-side loops (port of
`vod_tpu/runtime/train.py`).

One optimizer step does, for each micro-batch: encode the queries under
`torch.no_grad()` with the current (pre-update) weights -> hybrid search over
the device index (the dense search runs `fused_mips_binned` on the card for
`kernel="fused"`) -> merge -> labeled priority sampling -> gather section
tokens -> `model.evaluate` (fused encoder pass, reader, gradient estimator)
-> `backward()`. The micro-batches' gradients are summed and divided by their
count, scaled to a global norm of at most `gradient_clip_val`, and the
optimizer steps.

Where the JAX step passes parameters and optimizer state in and out, here
they live in the model and the optimizer. The step never waits for the card:
its metrics stay tensors on the card until the loop logs them.

The loss differentiated is the estimator's plus every auxiliary loss the
model sows in that pass (`systems.collect_losses`: the SPLADE FLOPS term),
as JAX's `mutable=["losses"]` collects them; the query encode of live
retrieval sows nothing. With `splade_query_k` the live retrieval is
learned-sparse: the current encoder's query impacts are cut to their top-k
(terms, weights) and searched in the sparse engine's impact postings
instead of a dense query vector.

With `gradcache_chunk_rows` (a `Ranker` only) each micro-batch's backward
runs through `runtime/gradcache.py` at one chunk's activation memory, with
the same gradients. A kbit-prepared model (`models/kbit.py`) holds only its
trainable leaves as parameters, so the optimizer, built over
`model.parameters()`, and the clip see only those; its frozen base
dequantizes inside each layer's forward.

Data parallel: the loops take a `mesh` (`parallel/mesh.py`) and the axis
`dp_axis` whose ranks split each batch (`shard_batch`). The step then takes
a `DataParallel`: the collate draws for the global batch and keeps this
rank's rows, the sharded engines gather the queries where the index shards
over the batch's axis, and the gradients are averaged over the axis once
per optimizer step (one `all_reduce` of all of them), before the clip. The
average of the ranks' mean losses is the global batch's mean where every
rank's loss averages the same number of rows (each row has a positive, as
the gold lookup gives every training row). The logged loss, the
estimator's diagnostics and the monitor are reduced over the axis before a
log (`aggregate_metrics_psum`, `RetrievalMonitor.compute(group=...)`), and
rank 0 calls `on_log`. Parameters sharded by `parallel/mesh.py:
shard_params` (FSDP2 DTensors) have their norm summed over their shards.

Batch-wide terms over a split batch. In-batch negatives pool the global
batch's sections (`collate.py`): each rank encodes the whole pool and
scores its own queries against it, so the gradient a pooled section gets
from another rank's queries reaches that rank's copy, and the average over
the axis adds them once. A sown auxiliary loss (SPLADE's FLOPS term, `sum_v
(mean_b w_bv)^2` over the global batch) takes its sums and row count over
the axis through a differentiable `all_reduce`
(`systems.collect_losses(group=...)`): every rank holds the global term,
and since the backward of a SUM `all_reduce` is another one, each rank's
rows receive the term's gradient W times, which the average over the axis
divides back to once, JAX's gradient. With in-batch negatives the pooled
sections count for the term only in the rank's own block of the pool (each
is encoded on every rank). GradCache with a sown loss over a split batch
takes JAX's chunks of the global batch's rows: each rank encodes its pieces
of each global chunk and the chunk's sums are reduced over the axis
(`runtime/gradcache.py`).

Profiler traces: `training_loop(profile_dir=...)` records the loop-local
steps `[profile_steps[0], profile_steps[1])` with `torch.profiler` (CPU
activity, and CUDA activity when the model lives on the card) and writes one
Chrome/Perfetto trace JSON per rank under `profile_dir` (JAX writes
`plugins/profile/*/*.xplane.pb`). Inside the window each optimizer step is
one `train_step` span, and each `fused_mips_binned` call one span of its
own, which ties the ctypes-launched kernel to its call. Without
`profile_dir` the loop makes no profiler and no span.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import time
import typing as typ

import numpy as np
import torch
from torch import nn

from vod_tpu_torch.models.monitoring import RetrievalMonitor, aggregate_metrics_psum
from vod_tpu_torch.models.splade import splade_topk_terms
from vod_tpu_torch.models.systems import collect_losses
from vod_tpu_torch.parallel.distributed import all_reduce_, is_main_process
from vod_tpu_torch.parallel.mesh import DataParallel, data_parallel, shard_batch
from vod_tpu_torch.search.hybrid import HybridEngines
from vod_tpu_torch.types.batch import RealmBatch
from .callbacks import call_callbacks
from .collate import DeviceCorpus, QueryBatch, device_collate
from .gradcache import gradcache_backward
from .state import TrainerState

Noise = typ.Optional[tuple[torch.Tensor, torch.Tensor]]


def _local(g: torch.Tensor) -> torch.Tensor:
    """The tensor this rank holds of `g` (a DTensor's local shard)."""
    return g.to_local() if hasattr(g, "to_local") else g


def _global_norm(grads: typ.Sequence[torch.Tensor], groups: typ.Optional[typ.Sequence[typ.Any]] = None) -> torch.Tensor:
    """L2 norm of all `grads`; a sharded (DTensor) gradient's squares are
    summed over its shards first, and so are those of a gradient split over
    the process group `groups[i]` (a tensor-parallel block; None: whole)."""
    groups = [None] * len(grads) if groups is None else list(groups)
    plain = [g for g, grp in zip(grads, groups) if not hasattr(g, "to_local") and grp is None]
    split = [(g, grp) for g, grp in zip(grads, groups) if not hasattr(g, "to_local") and grp is not None]
    sharded = [g for g in grads if hasattr(g, "to_local")]
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in plain])) if plain else None
    if not sharded and not split:
        return norm
    buckets = [(sharded[0].device_mesh.get_group(), sharded)] if sharded else []
    by_group: dict[int, tuple[typ.Any, list[torch.Tensor]]] = {}
    for g, grp in split:
        by_group.setdefault(id(grp), (grp, []))[1].append(g)
    buckets += list(by_group.values())
    sq = norm**2 if norm is not None else torch.zeros((), device=grads[0].device)
    for group, part in buckets:
        sq = sq + all_reduce_(torch.stack([torch.linalg.vector_norm(_local(g)) ** 2 for g in part]).sum(), group=group)
    return torch.sqrt(sq)


def clip_by_global_norm(grads: typ.Sequence[torch.Tensor], max_norm: typ.Optional[float],
                        groups: typ.Optional[typ.Sequence[typ.Any]] = None) -> torch.Tensor:
    """Scale `grads` in place by min(1, max_norm / max(|g|, 1e-9)), where |g|
    is their global L2 norm (optax's formula; `clip_grad_norm_` divides by
    |g| + 1e-6 instead). `groups[i]`: the process group `grads[i]` is split
    over (a tensor-parallel block), whose squares count once over it.
    Returns |g| before scaling, on the card."""
    norm = _global_norm(grads, groups)
    if max_norm:
        scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
        for g in grads:
            _local(g).mul_(scale)
    return norm


def average_gradients(params: typ.Sequence[torch.Tensor], group: typ.Any, size: int) -> None:
    """Average the parameters' gradients (each rank's local tensors) over
    `group` in one `all_reduce` of their concatenation."""
    grads = [_local(p.grad) for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1).to(torch.float32) for g in grads])
    all_reduce_(flat, group=group)
    flat.div_(size)
    offset = 0
    for g in grads:
        n = g.numel()
        g.copy_(flat[offset : offset + n].view_as(g))
        offset += n


class RealmTrainStep:
    """The train, accumulation and eval steps of a `Ranker` or `Realm` with
    the optimizer that updates it."""

    def __init__(
        self,
        model: nn.Module,
        optimizer: torch.optim.Optimizer,
        *,
        prefetch: int = 100,
        n_sections: int = 8,
        max_pos_sections: int = 2,
        temperature: float = 1.0,
        max_support_size: typ.Optional[int] = None,
        with_lm: bool = False,
        gradient_clip_val: typ.Optional[float] = None,
        in_batch_negatives: bool = False,
        accumulate_grad_batches: int = 1,
        splade_query_k: typ.Optional[int] = None,
        gradcache_chunk_rows: typ.Optional[int] = None,
    ):
        if gradcache_chunk_rows is not None and with_lm:
            # GradCache caches the pooled [rows, H] encodings; the Realm reader
            # consumes full lm logits, which would defeat the memory saving
            raise ValueError("gradcache_chunk_rows requires a retriever-only (Ranker) system")
        self.model = model
        self.gradcache_chunk_rows = gradcache_chunk_rows
        self.splade_query_k = splade_query_k
        self.optimizer = optimizer
        self.prefetch = prefetch
        self.n_sections = n_sections
        self.max_pos_sections = max_pos_sections
        self.temperature = temperature
        self.max_support_size = max_support_size
        self.with_lm = with_lm
        self.gradient_clip_val = gradient_clip_val
        self.in_batch_negatives = in_batch_negatives
        self.accumulate_grad_batches = accumulate_grad_batches

    # -- collate + forward -------------------------------------------------
    def collate(
        self,
        engines: HybridEngines,
        corpus: DeviceCorpus,
        queries: QueryBatch,
        generator: torch.Generator,
        weights: typ.Optional[dict[str, float]],
        noise: Noise = None,
        dp: typ.Optional[DataParallel] = None,
    ) -> RealmBatch:
        """Live retrieval: the queries encoded with the current weights, outside
        the gradient (learned-sparse: their top-k impact terms), then the
        device collate (`dp`: this rank's place in a data-parallel batch)."""
        q_vec = None
        if self.splade_query_k is not None:
            with torch.no_grad():
                impacts = self.model.encode_field(queries.input_ids, queries.attention_mask)
            terms, term_weights = splade_topk_terms(impacts, self.splade_query_k)
            queries = dataclasses.replace(queries, terms=terms, term_weights=term_weights)
        elif engines.dense is not None:
            with torch.no_grad():
                q_vec = self.model.encode_field(queries.input_ids, queries.attention_mask)
        batch, _ = device_collate(
            engines, corpus, queries,
            generator=generator,
            query_vectors=q_vec,
            prefetch=self.prefetch,
            n_sections=self.n_sections,
            max_pos_sections=self.max_pos_sections,
            temperature=self.temperature,
            max_support_size=self.max_support_size,
            weights=weights or None,
            with_lm=self.with_lm,
            in_batch_negatives=self.in_batch_negatives,
            noise=noise,
            rows=None if dp is None else dp.rows,
            batch_axis=None if dp is None or not dp.split else dp.axis,
            group=None if dp is None or not dp.split else dp.group,
        )
        return batch

    def loss(self, batch: RealmBatch, dp: typ.Optional[DataParallel] = None) -> tuple[torch.Tensor, typ.Any]:
        """(the estimator's loss plus the auxiliary losses the model sows in
        this pass, the estimator's output). Over a split batch (`dp`) the
        sown losses are the global batch's (see the module)."""
        group = rows = None
        if dp is not None and dp.split:
            group = dp.group
            if batch.extras.get("flat_sections", False):
                # the fused pass holds this rank's queries, then the whole pool:
                # the pool counts in its block of it only
                b, u = int(batch.query__input_ids.shape[0]), int(batch.section__input_ids.shape[0])
                block = torch.arange(u, device=batch.section__input_ids.device) * dp.size // u == dp.index
                rows = torch.cat([torch.ones((b,), dtype=torch.bool, device=block.device), block])
        with collect_losses(self.model, group=group, rows=rows) as sown:
            out = self.model(batch, mode="evaluate")
        return out.loss + sum(sown) if sown else out.loss, out

    def apply_gradients(self) -> torch.Tensor:
        """Clip the accumulated gradients and step the optimizer; parameters
        that took no part in the loss get a zero gradient, so decay and the
        moments move them as optax does. Returns the global gradient norm
        before clipping."""
        params = [p for g in self.optimizer.param_groups for p in g["params"]]
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        norm = clip_by_global_norm([p.grad for p in params], self.gradient_clip_val,
                                   [getattr(p, "tp_group", None) for p in params])
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        return norm

    # -- public ------------------------------------------------------------
    def train_step(
        self,
        engines: HybridEngines,
        corpus: DeviceCorpus,
        queries: QueryBatch,
        generator: torch.Generator,
        weights: typ.Optional[dict[str, float]],
        *,
        noise: Noise = None,
        dp: typ.Optional[DataParallel] = None,
    ) -> tuple[dict[str, torch.Tensor], torch.Tensor, torch.Tensor]:
        """One optimizer step on one batch: `train_step_accum` over one
        micro-batch. Returns (metrics: loss, grad_norm and the estimator's
        diagnostics, all tensors on the card; the batch's relevances [B, D];
        the retriever's scores [B, D])."""
        return self.train_step_accum(
            engines, corpus, [queries], generator, weights, noise=None if noise is None else [noise], dp=dp
        )

    def train_step_accum(
        self,
        engines: HybridEngines,
        corpus: DeviceCorpus,
        micro_batches: typ.Sequence[QueryBatch],
        generator: torch.Generator,
        weights: typ.Optional[dict[str, float]],
        *,
        noise: typ.Optional[typ.Sequence[Noise]] = None,
        dp: typ.Optional[DataParallel] = None,
    ) -> tuple[dict[str, torch.Tensor], torch.Tensor, torch.Tensor]:
        """One optimizer step over several micro-batches: each is collated and
        encoded with the pre-update weights, the gradients are summed and
        divided by their count, the loss is averaged. Returns (metrics,
        relevances and scores of all micro-batches stacked along rows); over
        one micro-batch the metrics also hold the estimator's diagnostics, as
        the JAX `train_step`'s do. With `dp` the gradients are then averaged
        over its axis, once, before the clip; the metrics stay this rank's."""
        n_micro = len(micro_batches)
        self.optimizer.zero_grad(set_to_none=True)
        loss_sum = torch.zeros((), device=micro_batches[0].input_ids.device)
        rels, scores = [], []
        for i, q in enumerate(micro_batches):
            batch = self.collate(engines, corpus, q, generator, weights, None if noise is None else noise[i], dp)
            if self.gradcache_chunk_rows is not None:
                out = gradcache_backward(self.model, batch, chunk_rows=self.gradcache_chunk_rows, dp=dp)
                loss = out.loss
            else:
                loss, out = self.loss(batch, dp)
                loss.backward()
            loss_sum = loss_sum + loss.detach()
            rels.append(batch.section__relevance)
            scores.append(out.retriever_scores.detach())
        params = [p for g in self.optimizer.param_groups for p in g["params"]]
        for p in params:
            if p.grad is not None:
                _local(p.grad).div_(n_micro)
        if dp is not None:
            for p in params:  # a parameter outside this loss still takes part in the reduction
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            average_gradients(params, dp.group, dp.size)
        norm = self.apply_gradients()
        metrics = {"loss": loss_sum / n_micro, "grad_norm": norm}
        if n_micro == 1:
            metrics.update({k: v.detach() for k, v in out.diagnostics.items()})
        return metrics, torch.cat(rels), torch.cat(scores)

    @torch.no_grad()
    def eval_step(
        self,
        engines: HybridEngines,
        corpus: DeviceCorpus,
        queries: QueryBatch,
        generator: torch.Generator,
        weights: typ.Optional[dict[str, float]],
        *,
        dp: typ.Optional[DataParallel] = None,
    ) -> tuple[dict[str, torch.Tensor], torch.Tensor, torch.Tensor]:
        """Collate and evaluate without a gradient. Returns (metrics, relevances, scores)."""
        batch = self.collate(engines, corpus, queries, generator, weights, dp=dp)
        loss, out = self.loss(batch, dp)
        metrics = {"loss": loss, **out.diagnostics}
        return metrics, batch.section__relevance, out.retriever_scores


def make_train_step(model: nn.Module, optimizer: torch.optim.Optimizer, **kw: typ.Any) -> RealmTrainStep:
    return RealmTrainStep(model, optimizer, **kw)


def training_loop(
    *,
    step_fn: RealmTrainStep,
    engines: HybridEngines,
    corpus: DeviceCorpus,
    train_queries: typ.Iterable[QueryBatch],
    state: TrainerState,
    generator: torch.Generator,
    val_queries: typ.Optional[typ.Sequence[QueryBatch]] = None,
    val_check_interval: typ.Optional[int] = None,
    log_interval: int = 50,
    metrics: typ.Sequence[str] = ("mrr", "ndcg_10", "hitrate_3"),
    on_log: typ.Optional[typ.Callable[[int, dict], None]] = None,
    on_checkpoint: typ.Optional[typ.Callable[[nn.Module, torch.optim.Optimizer, TrainerState], None]] = None,
    callbacks: typ.Sequence[typ.Any] = (),
    prefetch_batches: int = 2,
    until_step: typ.Optional[int] = None,
    mesh: typ.Any = None,
    dp_axis: str = "dp",
    profile_dir: typ.Optional[str] = None,
    profile_steps: tuple[int, int] = (3, 6),
) -> tuple[TrainerState, dict]:
    """One period of training: until `until_step` (default
    `state.next_period_start_step`) or until the query iterator is exhausted.
    With `accumulate_grad_batches` > 1 each optimizer step takes that many
    batches; a short tail is dropped, never stepped. Metrics stay on the card
    until a log step (every `log_interval` steps, and the last). With `mesh`,
    every rank iterates the same global batches and keeps its rows over
    `dp_axis` (see the module); the logged metrics are the axis's, and rank 0
    calls `on_log`. With `profile_dir`, the loop-local steps
    `[profile_steps[0], profile_steps[1])` are traced (see the module).
    Returns (state, the last logged metrics)."""
    until = until_step if until_step is not None else state.next_period_start_step
    call_callbacks(callbacks, "on_fit_start", model=step_fn.model, state=state)
    monitor = RetrievalMonitor(list(metrics))
    last_logged: dict = {}
    t0 = time.time()
    n_done = 0
    if prefetch_batches > 0:
        from vod_tpu_torch.dataloaders.prefetch import prefetch_iterator

        train_queries = prefetch_iterator(iter(train_queries), size=prefetch_batches)
    accum = max(1, int(step_fn.accumulate_grad_batches))
    train_iter = iter(train_queries)
    group = _dp_group(mesh, dp_axis)
    trace = _StepTrace(profile_dir, profile_steps, step_fn.model) if profile_dir is not None else None
    try:
        for queries in train_iter:
            if state.step >= until or state.completed:
                break
            span = trace.step() if trace is not None else contextlib.nullcontext()
            weights = state.get_parameters()
            dp = data_parallel(mesh, dp_axis, int(queries.input_ids.shape[0]))
            if accum > 1:
                micro = [queries]
                for _ in range(accum - 1):
                    nxt = next(train_iter, None)
                    if nxt is None:
                        break
                    micro.append(nxt)
                if len(micro) < accum:
                    # pending gradients at iterator exhaustion are never applied;
                    # break before on_train_batch_start so start/end hooks pair
                    break
                call_callbacks(callbacks, "on_train_batch_start", batch=queries, step=state.step)
                micro = [shard_batch(q, mesh, dp_axis) for q in micro]
                with span:
                    m, rel, scores = step_fn.train_step_accum(engines, corpus, micro, generator, weights, dp=dp)
            else:
                call_callbacks(callbacks, "on_train_batch_start", batch=queries, step=state.step)
                with span:
                    m, rel, scores = step_fn.train_step(
                        engines, corpus, shard_batch(queries, mesh, dp_axis), generator, weights, dp=dp
                    )
            monitor.update(relevances=rel, scores=scores)
            call_callbacks(callbacks, "on_train_batch_end", metrics=m, step=state.step)
            state.step += 1
            state.update_steps += 1
            n_done += 1
            if state.step % log_interval == 0 or state.step >= until:
                if group is not None:
                    m = aggregate_metrics_psum(m, group)
                last_logged = {
                    **{k: float(v) for k, v in m.items()},
                    **monitor.compute(group),
                    "steps_per_sec": n_done / max(time.time() - t0, 1e-6),
                    "step": state.step,
                    **{f"parameters/{k}": v for k, v in weights.items()},
                }
                if on_log and is_main_process():
                    on_log(state.step, last_logged)
            if val_check_interval and val_queries is not None and state.step % val_check_interval == 0:
                val_metrics = validation_loop(
                    step_fn=step_fn, engines=engines, corpus=corpus, val_queries=val_queries,
                    generator=generator, weights=state.get_parameters(), metrics=metrics, mesh=mesh,
                    dp_axis=dp_axis,
                )
                if on_log and is_main_process():
                    on_log(state.step, {f"val/{k}": v for k, v in val_metrics.items()})
                if on_checkpoint:
                    on_checkpoint(step_fn.model, step_fn.optimizer, state)
    except KeyboardInterrupt:
        pass
    finally:
        if trace is not None:  # the loop may end inside the window
            trace.stop()
    call_callbacks(callbacks, "on_fit_end", model=step_fn.model, state=state)
    return state, last_logged


class _StepTrace:
    """The profiler window of `training_loop`: `step()` is called at the top
    of each loop step, starts the trace before the loop-local step `steps[0]`,
    stops it before `steps[1]` (JAX's window), and returns the step's span
    (a `record_function("train_step")` inside the window, else a null
    context). `stop()` ends a trace still open and writes it."""

    def __init__(self, profile_dir: str, steps: tuple[int, int], model: nn.Module):
        self.dir, self.steps, self.n, self.prof = profile_dir, (int(steps[0]), int(steps[1])), 0, None
        self.cuda = any(p.device.type == "cuda" for p in model.parameters())

    def step(self) -> typ.ContextManager:
        if self.n == self.steps[0] and self.prof is None:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self.cuda:
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=activities)
            self.prof.start()
        elif self.n == self.steps[1] and self.prof is not None:
            self.stop()
        self.n += 1
        if self.prof is None:
            return contextlib.nullcontext()
        return torch.profiler.record_function("train_step")

    def stop(self) -> None:
        if self.prof is None:
            return
        prof, self.prof = self.prof, None
        prof.stop()
        rank = torch.distributed.get_rank() if torch.distributed.is_initialized() else 0
        os.makedirs(self.dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(self.dir, f"trace-rank{rank}-{time.time_ns()}.json"))


def validation_loop(
    *,
    step_fn: RealmTrainStep,
    engines: HybridEngines,
    corpus: DeviceCorpus,
    val_queries: typ.Sequence[QueryBatch],
    generator: torch.Generator,
    weights: typ.Optional[dict[str, float]],
    metrics: typ.Sequence[str] = ("mrr", "ndcg_10", "hitrate_3"),
    mesh: typ.Any = None,
    dp_axis: str = "dp",
) -> dict[str, float]:
    """Evaluation without a gradient over the validation queries: the
    monitor's means and the mean loss; with `mesh`, each batch's rows split
    over `dp_axis` and both reduced over it, as in `training_loop`."""
    group = _dp_group(mesh, dp_axis)
    monitor = RetrievalMonitor(list(metrics))
    losses = []
    for queries in val_queries:
        dp = data_parallel(mesh, dp_axis, int(queries.input_ids.shape[0]))
        m, rel, scores = step_fn.eval_step(
            engines, corpus, shard_batch(queries, mesh, dp_axis), generator, weights, dp=dp
        )
        monitor.update(relevances=rel, scores=scores)
        losses.append(m["loss"])
    out = monitor.compute(group) if losses else monitor.compute()
    if losses and group is not None:
        losses = list(aggregate_metrics_psum({"loss": torch.stack([x.detach() for x in losses])}, group).values())
    out["loss"] = float(np.mean([float(x) for x in losses])) if losses else math.nan
    return out


def _dp_group(mesh: typ.Any, dp_axis: typ.Optional[str]) -> typ.Any:
    """The process group of the data-parallel axis, or None without one of size > 1."""
    from vod_tpu_torch.parallel.mesh import axis_group, axis_size

    return axis_group(mesh, dp_axis) if axis_size(mesh, dp_axis) > 1 else None
