"""Shared helpers for the parity tests of the PyTorch port (`tests/test_torch_*.py`).

Inputs are made with numpy from a seed and handed to both packages; JAX runs
on the CPU (conftest pins it there) and the port runs with `device="cpu"`.
The suite runs several pytest workers at once, so PyTorch gets one thread.
"""

from __future__ import annotations

import time
import typing as typ

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

CPU = torch.device("cpu")


def np_of(x) -> np.ndarray:
    """numpy copy of a JAX array or a torch tensor."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def unit_rows(rng: np.random.Generator, n: int, d: int) -> np.ndarray:
    v = rng.standard_normal((n, d)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


@pytest.fixture
def cuda_device() -> torch.device:
    """The first card; skips the test where there is none (decided at run time,
    never at import, so every worker collects the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA; run on the card")
    return torch.device("cuda", 0)


# ---- multi-rank runs: a gloo group of CPU ranks --------------------------------
#
# A job is a function of this module (so that a child imports no JAX) called as
# `job(rank, world, *args)` in each of `world` processes joined in one gloo
# group through a file in the test's tmp_path. The children come from a fork
# server that has imported torch and the port once, so each group starts in
# about a second; each child runs one torch thread.

_SPAWNS = iter(range(1 << 30))
_PRELOAD = ["torch", "numpy", "tests.torch_helpers", "vod_tpu_torch.exps.cli", "vod_tpu_torch.search.sharded"]


def _rank_main(job, rank: int, world: int, init_file: str, args: tuple, results, device: str,
               backend: typ.Optional[str]) -> None:
    import traceback

    torch.set_num_threads(1)
    try:
        from vod_tpu_torch.parallel import init_distributed

        init_distributed(num_processes=world, process_id=rank, device=device, backend=backend,
                         init_method=f"file://{init_file}")
        out = job(rank, world, *args)
        results.put((rank, None, out))
    except BaseException:  # noqa: BLE001 - the parent raises it
        results.put((rank, traceback.format_exc(), None))
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def run_ranks(job, world: int, tmp_path, *args, timeout: float = 300.0, device: str = "cpu",
              backend: typ.Optional[str] = None) -> list:
    """Run `job(rank, world, *args)` on `world` ranks of one group (CPU ranks
    under gloo unless `device` / `backend` say otherwise); returns their
    results in rank order and raises the first rank's error."""
    import multiprocessing as mp
    import queue as queue_mod

    ctx = mp.get_context("forkserver")
    ctx.set_forkserver_preload(_PRELOAD)
    init_file = str(tmp_path / f"pg-{next(_SPAWNS)}")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, args=(job, r, world, init_file, args, results, device, backend))
             for r in range(world)]
    for p in procs:
        p.start()
    got: dict[int, typ.Any] = {}
    deadline = time.monotonic() + timeout
    try:
        while len(got) < world:
            try:
                rank, err, out = results.get(timeout=1.0)
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs) if r not in got and p.exitcode is not None]
                if dead or time.monotonic() > deadline:
                    why = f"exited ({[procs[r].exitcode for r in dead]})" if dead else f"gave no result in {timeout} s"
                    raise RuntimeError(f"ranks {dead or sorted(set(range(world)) - set(got))} of {world} {why}")
                continue
            if err is not None:
                raise RuntimeError(f"rank {rank} of {world} failed:\n{err}")
            got[rank] = out
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
    return [got[r] for r in range(world)]


def _tensors(d: typ.Optional[dict]) -> dict:
    """Arrays as tensors; other values as they are."""
    return {k: torch.as_tensor(v) if isinstance(v, np.ndarray) else v for k, v in (d or {}).items()}


def job_sharded_dense(rank: int, world: int, vectors, mesh_shape, axis_names, axis: str, build_kw: dict,
                      queries: dict, top_k: int, batch_axis: typ.Optional[str] = None) -> tuple:
    """Build this rank's shard of `vectors` and search `queries` (all of them,
    or with `batch_axis` this rank's block of their rows). Returns (scores,
    ids, the shard's real rows)."""
    from vod_tpu_torch.parallel import make_mesh, shard_batch
    from vod_tpu_torch.search.base import SearchQueries
    from vod_tpu_torch.search.sharded import build_sharded_dense_index, sharded_dense_search

    mesh = make_mesh(mesh_shape, axis_names)
    index = build_sharded_dense_index(vectors, mesh, axis=axis, device="cpu", **_tensors(build_kw))
    q = SearchQueries(**_tensors(queries))
    if batch_axis is not None:
        q = shard_batch(q, mesh, batch_axis)
    r = sharded_dense_search(index, q, top_k, batch_axis=batch_axis)
    return np_of(r.scores), np_of(r.indices), index.local_real


def job_sharded_sparse(rank: int, world: int, table: dict, axis: str, queries: dict, top_k: int,
                       batch_axis: typ.Optional[str] = None) -> tuple:
    """Split the BM25 table `table` (the fields of a `SparseIndex`) over the
    ranks and search. Returns (scores, ids, this rank's postings width)."""
    from vod_tpu_torch.parallel import make_mesh, shard_batch
    from vod_tpu_torch.search.base import SearchQueries
    from vod_tpu_torch.search.sharded import shard_sparse_index, sharded_sparse_search
    from vod_tpu_torch.search.sparse import SparseIndex

    mesh = make_mesh((world,), (axis,))
    index = shard_sparse_index(SparseIndex(**{**_tensors(table), "n_docs": table["n_docs"]}), mesh, axis=axis)
    q = SearchQueries(**_tensors(queries))
    if batch_axis is not None:
        q = shard_batch(q, mesh, batch_axis)
    r = sharded_sparse_search(index, q, top_k, batch_axis=batch_axis)
    return np_of(r.scores), np_of(r.indices), int(index.postings_docs.shape[1])


def job_basics(rank: int, world: int, n_rows: int) -> dict:
    """`process_slice`, `global_batch_from_local`, `all_gather_tensor`,
    `barrier` and `is_main_process` on this rank."""
    from vod_tpu_torch.parallel import (
        all_gather_tensor,
        barrier,
        global_batch_from_local,
        is_main_process,
        make_mesh,
        process_slice,
        world_size,
    )

    sl = process_slice(n_rows)
    rows = torch.arange(n_rows, dtype=torch.float32)[sl].reshape(-1, 1) * 10 + rank  # rank-tagged rows
    barrier("test")
    gathered = all_gather_tensor(torch.tensor([rank, 7 * rank], dtype=torch.bfloat16))
    meshes = {"1d": make_mesh((-1,), ("dp",)), "2d": make_mesh((2, -1) if world % 2 == 0 else (-1, 1), ("dp", "fsdp"))}
    return dict(slice=(sl.start, sl.stop), world=world_size(), main=is_main_process(),
                meshes={k: list(m.shape) for k, m in meshes.items()},
                batch=np_of(global_batch_from_local(rows)), gathered=np_of(gathered.to(torch.float32)))


def job_aggregate(rank: int, world: int, values: dict) -> dict:
    """`aggregate_metrics_psum` of this rank's block of each value's rows."""
    from vod_tpu_torch.models.monitoring import aggregate_metrics_psum

    mine = {k: torch.as_tensor(np.array_split(v, world)[rank]) for k, v in values.items()}
    return {k: float(v) for k, v in aggregate_metrics_psum(mine).items()}


def topic_ranker(sizes: dict, state: typ.Optional[dict] = None, seed: int = 0):
    """A float32 `Ranker` (mean pooling, l2, learned scaler 8) of `sizes`,
    from `state` (numpy arrays) or seeded weights."""
    from vod_tpu_torch.models import Ranker, RetrievalGradients, TransformerEncoderConfig, VodPoolerConfig

    cfg = TransformerEncoderConfig(dtype=torch.float32, pooler=VodPoolerConfig(
        agg_method="mean", output_norm="l2", scaler=8.0, learn_scaler=True), **sizes)
    model = Ranker(cfg, RetrievalGradients(), device=CPU, generator=torch.Generator().manual_seed(seed))
    if state is not None:
        model.load_state_dict({k: torch.as_tensor(v) for k, v in state.items()})
    return model


def job_train_dp(rank: int, world: int, sizes: dict, state: dict, sec: np.ndarray, batches: list, index: str,
                 step_kw: dict, optimizer: str, val_batches: int = 0, emb: typ.Optional[np.ndarray] = None) -> dict:
    """`training_loop` (and `validation_loop` over the first `val_batches`
    batches) of a topic `Ranker` from `state` over the global `batches`
    [(query ids, gold ids)], on a dp mesh of the world (no mesh at world 1).
    `index`: "flat" (a replicated f32 index) or "sharded" (sharded over dp).
    `emb` replaces the model's embeddings of `sec` as the index's vectors.
    Returns the logs (rank 0), the final parameters and the validation
    metrics."""
    from vod_tpu_torch.parallel import make_mesh
    from vod_tpu_torch.runtime import QueryBatch, TrainerState, adamw, build_device_corpus, make_train_step
    from vod_tpu_torch.runtime.train import training_loop, validation_loop
    from vod_tpu_torch.search import HybridEngines, build_dense_index
    from vod_tpu_torch.search.sharded import build_sharded_dense_index

    mesh = make_mesh((world,), ("dp",)) if world > 1 else None
    model = topic_ranker(sizes, state)
    corpus = build_device_corpus(sec, np.ones_like(sec), device=CPU)
    if emb is None:
        with torch.no_grad():
            emb = model.encode_field(corpus.input_ids, corpus.attention_mask)
    emb = torch.as_tensor(emb)
    if index == "sharded" and mesh is not None:
        dense = build_sharded_dense_index(emb, mesh, axis="dp", dtype="float32", approx_recall=None)
    else:
        dense = build_dense_index(emb, dtype="float32", approx_recall=None, device=CPU)
    engines = HybridEngines(dense=dense)
    opt = adamw(model, 1e-3, weight_decay=0.0) if optimizer == "adam" else torch.optim.SGD(model.parameters(), lr=0.5)
    step = make_train_step(model, opt, **step_kw)
    qs = [QueryBatch(torch.from_numpy(i), torch.ones_like(torch.from_numpy(i)), section_ids=torch.from_numpy(g))
          for i, g in batches]
    logs: list = []
    gen = torch.Generator().manual_seed(5)
    state_, last = training_loop(
        step_fn=step, engines=engines, corpus=corpus, train_queries=qs, state=TrainerState(max_steps=len(qs)),
        generator=gen, log_interval=1, prefetch_batches=0, metrics=("mrr", "hitrate_3"), mesh=mesh,
        on_log=lambda s, m: logs.append(m),
    )
    val = None
    if val_batches:
        val = validation_loop(step_fn=step, engines=engines, corpus=corpus, val_queries=qs[:val_batches],
                              generator=gen, weights=None, metrics=("mrr", "hitrate_3"), mesh=mesh)
    return dict(logs=logs, last=last, steps=state_.step, val=val,
                params={k: np_of(v) for k, v in model.state_dict().items()})


def job_embeddings(rank: int, world: int, sizes: dict, state: dict, sec: np.ndarray, chunk: int) -> np.ndarray:
    """`compute_embeddings` of a topic `Ranker` over `sec`, its chunks split
    over a dp mesh of the world."""
    from vod_tpu_torch.parallel import make_mesh
    from vod_tpu_torch.runtime import build_device_corpus
    from vod_tpu_torch.runtime.predict import compute_embeddings

    model = topic_ranker(sizes, state)
    corpus = build_device_corpus(sec, np.ones_like(sec), device=CPU)
    return np_of(compute_embeddings(model.encode_field, corpus, chunk=chunk, mesh=make_mesh((world,), ("dp",))))


def job_fsdp_step(rank: int, world: int, sizes: dict, state: dict, sec: np.ndarray, batch: tuple) -> dict:
    """One `RealmTrainStep.train_step` (AdamW, clip 1.0) of a topic `Ranker`
    whose parameters FSDP2 shards over an `fsdp` mesh of the world
    (`shard_params`); the batch is whole on every rank, as JAX's fsdp-only
    mesh leaves it. Returns the loss, the gradient norm, the full
    parameters and the shard dims."""
    from vod_tpu_torch.parallel import fsdp_sharding, make_mesh, shard_params
    from vod_tpu_torch.runtime import QueryBatch, adamw, build_device_corpus, make_train_step
    from vod_tpu_torch.search import HybridEngines, build_dense_index

    model = topic_ranker(sizes, state)
    corpus = build_device_corpus(sec, np.ones_like(sec), device=CPU)
    with torch.no_grad():
        emb = model.encode_field(corpus.input_ids, corpus.attention_mask)
    engines = HybridEngines(dense=build_dense_index(emb, dtype="float32", approx_recall=None, device=CPU))
    dims = {}
    if world > 1:
        mesh = make_mesh((world,), ("fsdp",))
        dims = fsdp_sharding(model, mesh)
        shard_params(model, mesh)
    step = make_train_step(model, adamw(model, 1e-3, weight_decay=0.01), prefetch=16, n_sections=4,
                           max_pos_sections=1, gradient_clip_val=1.0)
    ids, gold = batch
    m, _, _ = step.train_step(engines, corpus, QueryBatch(torch.from_numpy(ids), torch.ones_like(torch.from_numpy(ids)),
                                                          section_ids=torch.from_numpy(gold)),
                              torch.Generator().manual_seed(3), None)
    full = {k: np_of(v.full_tensor() if hasattr(v, "full_tensor") else v) for k, v in model.state_dict().items()}
    return dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]), params=full, dims=dims,
                sharded=sorted(k for k, p in model.named_parameters() if hasattr(p, "to_local")))


def job_cli(rank: int, world: int, config: str, resume: typ.Optional[tuple] = None) -> dict:
    """`cli.main` on this rank (`--device cpu`), then, with `resume` = (run
    dir, max steps), `main(--resume_from ...)`. Returns the runs' steps,
    losses, the accumulation, the engines' types and a parameter checksum."""
    import contextlib
    import io

    from vod_tpu_torch.exps import cli, recipes
    from vod_tpu_torch.search import factory

    built: list = []

    def spy(real):
        def wrapped(*a, **kw):
            index = real(*a, **kw)
            built.append(type(index).__name__)
            return index

        return wrapped

    recipes.build_dense_from_config = spy(recipes.build_dense_from_config)
    factory.build_sparse_from_config = spy(factory.build_sparse_from_config)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        first = cli.main(["--config", config, "--device", "cpu"])
        second = None
        if resume is not None:
            second = cli.main(["--resume_from", resume[0], "--max_steps", str(resume[1]), "--device", "cpu"])

    def summary(res: dict) -> dict:
        hist = res["history"]
        return dict(step=res["state"].step, periods=len(hist), accumulate=res["step_fn"].accumulate_grad_batches,
                    losses=[h["train"].get("loss") for h in hist],
                    checksum=float(sum(p.detach().double().sum() for p in res["model"].parameters())),
                    autotune=[h.get("autotune", {}).get("params") for h in hist],
                    in_batch_negatives=res["step_fn"].in_batch_negatives)

    return dict(first=summary(first), second=None if second is None else summary(second), stdout=out.getvalue(),
                built=built)


def job_sequence(rank: int, world: int, calls: list) -> list:
    """Several jobs, one after the other, in one group: [(job, args), ...]."""
    return [job(rank, world, *args) for job, args in calls]


def job_shard_batch(rank: int, world: int, leaves: dict) -> dict:
    """`shard_batch` of a dict of arrays over a dp mesh of the world, and of
    a `QueryBatch` made of the first two leaves."""
    from vod_tpu_torch.parallel import make_mesh, shard_batch
    from vod_tpu_torch.runtime import QueryBatch

    mesh = make_mesh((world,), ("dp",))
    out = shard_batch({k: torch.as_tensor(v) for k, v in leaves.items()}, mesh, "dp")
    ids, mask = (torch.as_tensor(v) for v in list(leaves.values())[:2])
    qb = shard_batch(QueryBatch(ids, mask), mesh, "dp")
    return dict(leaves={k: np_of(v) for k, v in out.items()}, query=np_of(qb.input_ids),
                none_kept=qb.section_ids is None)


def job_cli_refusal(rank: int, world: int, config: str) -> str:
    """The error `cli.main` raises for `config` on this rank ("" if none)."""
    from vod_tpu_torch.exps import cli

    try:
        cli.main(["--config", config, "--device", "cpu"])
    except Exception as exc:  # noqa: BLE001 - the test reads it
        return f"{type(exc).__name__}: {exc}"
    return ""


def job_shard_kernel(rank: int, world: int, n: int, d: int, b: int, k: int) -> dict:
    """On this rank's card: an int8 corpus of `n` seeded unit rows sharded
    over the world (`kernel: fused`); this shard's `fused_mips_binned` call
    against its plain version (and on a cut that leaves the shards after
    rank 0 padding only), its body and launches, and the merged answer."""
    import dataclasses

    from vod_tpu_torch.ops.mips import _binned_body, fused_mips_binned, fused_mips_binned_reference
    from vod_tpu_torch.parallel import make_mesh, rank_device
    from vod_tpu_torch.search import SearchQueries
    from vod_tpu_torch.search.dense import quantize_queries_int8
    from vod_tpu_torch.search.sharded import build_sharded_dense_index, sharded_dense_search

    dev = rank_device()
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((n, d), generator=g, device=dev)
    x /= x.norm(dim=-1, keepdim=True)
    q = x[:b] + 0.1 * torch.randn((b, d), generator=g, device=dev)
    index = build_sharded_dense_index(x, make_mesh((world,), ("shard",)), axis="shard", dtype="int8", kernel="fused")
    q8, _ = quantize_queries_int8(q, index.scale)
    out = {"body": _binned_body(torch.int8, d, 512, (index.vectors.data_ptr(), q8.data_ptr()))}
    for name, ix in (("full", index), ("cut", dataclasses.replace(index, n_real=index.rows_per_shard - 100))):
        before = fused_mips_binned.body_launches["wgmma"]
        ks, ki = fused_mips_binned(ix.vectors, q8, k=k, n_real=ix.local_real)
        out[name] = dict(launched=fused_mips_binned.body_launches["wgmma"] - before, local_real=ix.local_real,
                         equal=bool(all(torch.equal(a, b_) for a, b_ in zip(
                             (ks, ki), fused_mips_binned_reference(ix.vectors, q8, k=k, n_real=ix.local_real)))),
                         empty=bool((ki == -1).all()), ids=np_of(sharded_dense_search(ix, SearchQueries(vector=q),
                                                                                      k).indices))
    return out


# ---- the sharded compressed engines, k-means, autotuning, batch-wide training ---


def _index_from_fields(kind: str, fields: dict):
    """The port's unsharded index of `kind` from a JAX index's fields (numpy)."""
    from vod_tpu_torch.models import convert
    from vod_tpu_torch.search.maxsim import MaxSimIndex

    if kind == "ivfpq":
        return convert.ivfpq_index_from_fields(fields, device=CPU)
    if kind == "maxsim":
        return MaxSimIndex(**_tensors(fields))
    return convert.dense_index_from_fields(fields, device=CPU)


def job_sharded_engine(rank: int, world: int, kind: str, fields: dict, axis: str, queries: dict, top_k: int,
                       batch_axis: typ.Optional[str] = None, shard_kw: typ.Optional[dict] = None) -> dict:
    """Shard the port's copy of a JAX index (`kind`: "pq", "ivf" or "ivfpq")
    over the world's `axis` and search `queries` (with `batch_axis`, this
    rank's block of their rows). Returns the answer, this rank's arrays and
    the unsharded index's answer."""
    from vod_tpu_torch.parallel import make_mesh, shard_batch
    from vod_tpu_torch.search import dense, ivfpq, sharded
    from vod_tpu_torch.search.base import SearchQueries

    mesh = make_mesh((world,), (axis,))
    index = _index_from_fields(kind, fields)
    shard, search, plain = {
        "pq": (sharded.shard_pq_index, sharded.sharded_pq_search, dense.pq_search),
        "ivf": (sharded.shard_ivf_index, sharded.sharded_ivf_search, dense.ivf_search),
        "ivfpq": (sharded.shard_ivfpq_index, sharded.sharded_ivfpq_search, ivfpq.ivfpq_search),
    }[kind]
    shard_kw = dict(shard_kw or {})
    if "corpus_shard" in shard_kw:
        shard_kw["corpus_shard"] = torch.as_tensor(shard_kw["corpus_shard"])
    ix = shard(index, mesh, axis=axis, **shard_kw)
    q = SearchQueries(**_tensors(queries))
    whole = plain(index, q, top_k) if kind != "pq" or "corpus_shard" not in shard_kw else None
    if batch_axis is not None:
        q = shard_batch(q, mesh, batch_axis)
    r = search(ix, q, top_k, batch_axis=batch_axis)
    arrays = {k: np_of(v) for k, v in vars(ix).items() if isinstance(v, torch.Tensor)}
    return dict(scores=np_of(r.scores), ids=np_of(r.indices), arrays=arrays,
                meta={k: v for k, v in vars(ix).items() if isinstance(v, (int, float, bool, str)) or v is None},
                plain=None if whole is None else (np_of(whole.scores), np_of(whole.indices)))


def job_sharded_maxsim(rank: int, world: int, fields: dict, q_tokens, q_mask, cand) -> dict:
    """The port's sharded MaxSim rerank of a JAX store's copy, beside its
    unsharded rerank."""
    from vod_tpu_torch.parallel import make_mesh
    from vod_tpu_torch.search.maxsim import maxsim_rerank
    from vod_tpu_torch.search.sharded import shard_maxsim_index, sharded_maxsim_rerank

    index = _index_from_fields("maxsim", fields)
    ix = shard_maxsim_index(index, make_mesh((world,), ("shard",)), axis="shard")
    args = (torch.as_tensor(q_tokens), torch.as_tensor(q_mask), torch.as_tensor(cand))
    return dict(sharded=np_of(sharded_maxsim_rerank(ix, *args)), plain=np_of(maxsim_rerank(index, *args)),
                rows=ix.rows_per_shard)


def job_kmeans_sharded(rank: int, world: int, x, k: int, init, seed: int, n_iters: int) -> dict:
    """`kmeans_sharded` over the world and, in the same process, the
    unsharded `kmeans`, both from generator `seed` (and `init` if given)."""
    from vod_tpu_torch.ops.kmeans import kmeans, kmeans_sharded
    from vod_tpu_torch.parallel import make_mesh

    x = torch.as_tensor(x)
    init = None if init is None else torch.as_tensor(init)
    c, a = kmeans_sharded(x, k, make_mesh((world,), ("shard",)), axis="shard", n_iters=n_iters, init=init,
                          generator=torch.Generator().manual_seed(seed))
    pc, pa = kmeans(x, k, n_iters=n_iters, init=init, generator=torch.Generator().manual_seed(seed))
    return dict(centroids=np_of(c), assign=np_of(a), plain_centroids=np_of(pc), plain_assign=np_of(pa))


def job_autotune_sharded(rank: int, world: int, kind: str, fields: dict, queries, gt, target: float, top_k: int,
                         fcfg: dict, seed: int) -> dict:
    """The port's sharded copy of a JAX index (and the unsharded copy) tuned
    by `autotune` over `queries` / `gt` (untimed), and the sharded copy by
    `autotune_after_build(fcfg)` over the queries as the corpus (timed: each
    rank times its own sweep, every rank takes rank 0's choice)."""
    import importlib

    from vod_tpu_torch.configs.search import DenseFactoryConfig
    from vod_tpu_torch.parallel import make_mesh
    from vod_tpu_torch.search import sharded

    at = importlib.import_module("vod_tpu_torch.search.autotune")
    mesh = make_mesh((world,), ("shard",))
    shard = {"pq": sharded.shard_pq_index, "ivf": sharded.shard_ivf_index, "ivfpq": sharded.shard_ivfpq_index}[kind]
    index = shard(_index_from_fields(kind, fields), mesh, axis="shard")
    q = torch.as_tensor(queries)
    tuned, chosen, _ = at.autotune(index, q, gt, target_recall=target, top_k=top_k, measure_time=False)
    _, plain, _ = at.autotune(_index_from_fields(kind, fields), q, gt, target_recall=target, top_k=top_k,
                              measure_time=False)
    _, info = at.autotune_after_build(index, DenseFactoryConfig(**fcfg), q, generator=torch.Generator().manual_seed(seed))
    return dict(grid=at.default_grid(index), chosen=chosen.params, recall=chosen.recall, plain=plain.params,
                plain_recall=plain.recall, timed=info["params"],
                meta={k: v for k, v in vars(tuned).items() if isinstance(v, int) and not isinstance(v, bool)})


def splade_ranker(sizes: dict, state: typ.Optional[dict] = None, seed: int = 0, flops_weight: float = 1e-2):
    """A float32 SPLADE `Ranker` of `sizes` (FLOPS term at `flops_weight`)."""
    from vod_tpu_torch.models import Ranker, RetrievalGradients, TransformerEncoderConfig

    model = Ranker(TransformerEncoderConfig(dtype=torch.float32, **sizes), RetrievalGradients(), splade_encoder=True,
                   splade_flops_weight=flops_weight, device=CPU, generator=torch.Generator().manual_seed(seed))
    if state is not None:
        model.load_state_dict({k: torch.as_tensor(v) for k, v in state.items()})
    return model


def job_train_batchwide(rank: int, world: int, model_kind: str, sizes: dict, state: dict, sec: np.ndarray,
                        batches: list, step_kw: dict) -> dict:
    """`training_loop` over the global `batches` [(query ids, gold ids)] on a
    dp mesh of the world (no mesh at world 1), SGD: a topic `Ranker`
    ("topic") over a replicated f32 index, or a SPLADE `Ranker` ("splade")
    over its learned impact index (its FLOPS term sown). Returns the logged
    losses (rank 0), the parameters and the first step's collated batch
    shapes."""
    from vod_tpu_torch.models.splade import encode_corpus_terms
    from vod_tpu_torch.parallel import make_mesh
    from vod_tpu_torch.runtime import QueryBatch, TrainerState, build_device_corpus, make_train_step
    from vod_tpu_torch.runtime.train import RealmTrainStep, training_loop
    from vod_tpu_torch.search import HybridEngines, build_dense_index, build_impact_index

    mesh = make_mesh((world,), ("dp",)) if world > 1 else None
    corpus = build_device_corpus(sec, np.ones_like(sec), device=CPU)
    if model_kind == "splade":
        model = splade_ranker(sizes, state)
        terms, weights = encode_corpus_terms(model.encode_field, corpus.input_ids, corpus.attention_mask, k=8,
                                             chunk=16, mesh=mesh)
        engines = HybridEngines(sparse=build_impact_index(terms, weights, n_terms=sizes["vocab_size"], device=CPU))
        step_kw = dict(step_kw, splade_query_k=8)
    else:
        model = topic_ranker(sizes, state)
        with torch.no_grad():
            emb = model.encode_field(corpus.input_ids, corpus.attention_mask)
        engines = HybridEngines(dense=build_dense_index(emb, dtype="float32", approx_recall=None, device=CPU))
    step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=0.5), **step_kw)
    shapes: list = []
    real_loss = RealmTrainStep.loss

    def loss(self, batch, dp=None):
        shapes.append((tuple(batch.query__input_ids.shape), tuple(batch.section__input_ids.shape)))
        return real_loss(self, batch, dp)

    RealmTrainStep.loss = loss
    qs = [QueryBatch(torch.from_numpy(i), torch.ones_like(torch.from_numpy(i)), section_ids=torch.from_numpy(g))
          for i, g in batches]
    logs: list = []
    try:
        training_loop(step_fn=step, engines=engines, corpus=corpus, train_queries=qs,
                      state=TrainerState(max_steps=len(qs)), generator=torch.Generator().manual_seed(5),
                      log_interval=1, prefetch_batches=0, metrics=("mrr",), mesh=mesh,
                      on_log=lambda s, m: logs.append(m))
    finally:
        RealmTrainStep.loss = real_loss
    return dict(logs=logs, shapes=shapes, params={k: np_of(v) for k, v in model.state_dict().items()})


def job_corpus_terms(rank: int, world: int, sizes: dict, state: dict, sec: np.ndarray, k: int, chunk: int) -> tuple:
    """`encode_corpus_terms` of a SPLADE `Ranker` over `sec`, its chunks
    split over a dp mesh of the world (no mesh at world 1)."""
    from vod_tpu_torch.models.splade import encode_corpus_terms
    from vod_tpu_torch.parallel import make_mesh
    from vod_tpu_torch.runtime import build_device_corpus

    model = splade_ranker(sizes, state)
    corpus = build_device_corpus(sec, np.ones_like(sec), device=CPU)
    return encode_corpus_terms(model.encode_field, corpus.input_ids, corpus.attention_mask, k=k, chunk=chunk,
                               mesh=make_mesh((world,), ("dp",)) if world > 1 else None)


def job_factory_sharded(rank: int, world: int, codec: str, x: np.ndarray, cfg_kw: dict, host: bool = False) -> dict:
    """The factory's build of `codec` with `sharded: true` over the world's
    "shard" axis (`build_dense_from_host` with `host`), and the unsharded
    build's answer to the first rows of `x` beside the sharded one's."""
    from vod_tpu_torch.configs import DenseFactoryConfig
    from vod_tpu_torch.parallel import make_mesh
    from vod_tpu_torch.search import SearchQueries, build_dense_from_config, build_dense_from_host
    from vod_tpu_torch.search.hybrid import _dense_dispatch

    cfg = DenseFactoryConfig(codec=codec, sharded=True, **cfg_kw)
    build = build_dense_from_host if host else build_dense_from_config
    sharded = build(cfg, x, mesh=make_mesh((world,), ("shard",)), device="cpu")
    plain = build(cfg, x, device="cpu")
    q = SearchQueries(vector=torch.as_tensor(x[:4]))
    return dict(type=type(sharded).__name__, plain_type=type(plain).__name__,
                ids=np_of(_dense_dispatch(sharded, q, 5).indices), plain_ids=np_of(_dense_dispatch(plain, q, 5).indices))


def job_compressed_on_card(rank: int, world: int, n: int, d: int, b: int, k: int) -> dict:
    """Each compressed engine (pq, ivf, ivfpq: built on the CPU from seeded
    clustered rows; MaxSim: a seeded int8 store) sharded over the world's
    "shard" axis twice, from the CPU copy and from a copy moved to this
    rank's card; both searched. Returns both answers by engine."""
    import dataclasses

    from vod_tpu_torch.parallel import make_mesh, rank_device
    from vod_tpu_torch.search import SearchQueries, build_ivf_index, build_ivfpq_index, build_pq_index, sharded
    from vod_tpu_torch.search.maxsim import MaxSimIndex

    dev = rank_device()
    mesh = make_mesh((world,), ("shard",))
    rng = np.random.default_rng(0)
    centres = unit_rows(rng, 32, d)
    x = (centres[rng.integers(0, 32, n)] + 0.2 * rng.standard_normal((n, d))).astype(np.float32)
    q = torch.from_numpy(x[:b] + 0.05 * rng.standard_normal((b, d)).astype(np.float32))
    gen = torch.Generator().manual_seed(0)
    built = {
        "pq": (build_pq_index(x, n_subquantizers=8, code_bits=4, coarse_dim=None, refine="int8", refine_dim=16,
                              k_factor=8, kmeans_iters=3, generator=gen, device=CPU),
               sharded.shard_pq_index, sharded.sharded_pq_search),
        "ivf": (build_ivf_index(x, n_clusters=16, nprobe=4, dtype="bfloat16", generator=gen, device=CPU),
                sharded.shard_ivf_index, sharded.sharded_ivf_search),
        "ivfpq": (build_ivfpq_index(x, n_clusters=16, nprobe=4, window=64, refine="int8", refine_dim=16,
                                    keep_codes=False, rerank="int8", k_factor=4, generator=gen, device=CPU),
                  sharded.shard_ivfpq_index, sharded.sharded_ivfpq_search),
    }

    def to(index, device):
        return dataclasses.replace(index, **{f.name: getattr(index, f.name).to(device) for f in dataclasses.fields(index)
                                             if isinstance(getattr(index, f.name), torch.Tensor)})

    out = {}
    for name, (index, shard, search) in built.items():
        answers = []
        for device in (CPU, dev):
            r = search(shard(to(index, device), mesh, axis="shard"), SearchQueries(vector=q.to(device)), k)
            answers.append((np_of(r.scores), np_of(r.indices)))
        out[name] = answers
    codes = torch.randint(-127, 128, (n // 8, 8, 16), generator=gen, dtype=torch.int8)
    store = MaxSimIndex(token_codes=codes, token_mask=torch.rand((n // 8, 8), generator=gen) < 0.9,
                        scale=torch.full((1, 16), 0.01), n_real=n // 8)
    qt, qm = torch.randn((b, 4, 16), generator=gen), torch.ones((b, 4), dtype=torch.bool)
    cand = torch.randint(0, n // 8, (b, 32), generator=gen)
    out["maxsim"] = [np_of(sharded.sharded_maxsim_rerank(sharded.shard_maxsim_index(to(store, device), mesh, axis="shard"),
                                                         qt.to(device), qm.to(device), cand.to(device)))
                     for device in (CPU, dev)]
    return out


# ---- model parallelism: MoE / ep, ring attention, GPipe, tensor parallelism --------


def moe_module(state: dict, top_k: int, capacity_factor: float):
    """A float32 `MoEFFN` from `state` ({gate, wi, wo} as numpy arrays)."""
    from vod_tpu_torch.parallel.moe import MoEFFN

    h, e = state["gate"].shape
    moe = MoEFFN(h, e, state["wi"].shape[2], top_k, capacity_factor, torch.float32, device=CPU)
    moe.load_state_dict(_tensors(state))
    return moe


def job_moe_ep(rank: int, world: int, state: dict, x: np.ndarray, top_k: int, capacity_factor: float) -> dict:
    """An `MoEFFN` with its experts split over an `ep` mesh of the world
    (`shard_params_ep`); tokens replicated. Returns the output, the aux,
    this rank's expert block, the gradients of sum(y²) + aux (the gate's,
    this rank's `wi`/`wo` blocks', x's) and `ep_sharding`'s dims."""
    from vod_tpu_torch.parallel import ep_sharding, make_mesh, shard_params_ep

    mesh = make_mesh((world,), ("ep",))
    moe = moe_module(state, top_k, capacity_factor)
    dims = ep_sharding(moe, mesh, "ep")
    shard_params_ep(moe, mesh, "ep")
    xt = torch.from_numpy(x).requires_grad_(True)
    y, aux = moe(xt)
    (y.pow(2).sum() + aux).backward()
    return dict(y=np_of(y), aux=float(aux), dims=dims, wi=np_of(moe.wi), x_grad=np_of(xt.grad),
                grads={n: np_of(p.grad) for n, p in moe.named_parameters()})


def plain_encoder(sizes: dict, state: dict):
    """A float32 `TransformerEncoder` of `sizes` from `state` (numpy arrays
    under `backbone.*`, `convert.flax_to_state_dict`'s names)."""
    from vod_tpu_torch.models.encoder import TransformerEncoder, TransformerEncoderConfig

    enc = TransformerEncoder(TransformerEncoderConfig(dtype=torch.float32, **sizes), device=CPU)
    enc.load_state_dict({k.removeprefix("backbone."): torch.as_tensor(v) for k, v in state.items()
                         if k.startswith("backbone.")})
    return enc


def job_ring(rank: int, world: int, q: np.ndarray, k: np.ndarray, v: np.ndarray, mask: np.ndarray) -> dict:
    """`ring_attention` over an `sp` mesh of the world on this rank's block
    of the sequence; returns its output block and the gradients of
    sum(out²) summed over the ranks for its q, k and v blocks."""
    from vod_tpu_torch.parallel import make_mesh, ring_attention

    mesh = make_mesh((world,), ("sp",))
    per = q.shape[1] // world
    block = slice(rank * per, (rank + 1) * per)
    qt, kt, vt = (torch.from_numpy(np.ascontiguousarray(a[:, block])).requires_grad_(True) for a in (q, k, v))
    out = ring_attention(qt, kt, vt, mesh=mesh, axis="sp", kv_mask=torch.from_numpy(mask[:, block]))
    out.pow(2).sum().backward()
    return dict(out=np_of(out), q=np_of(qt.grad), k=np_of(kt.grad), v=np_of(vt.grad))


def job_sp_encoder(rank: int, world: int, sizes: dict, state: dict, ids: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """This rank's block of `sp_encoder_forward` over an `sp` mesh of the world."""
    from vod_tpu_torch.parallel import make_mesh, sp_encoder_forward

    enc = plain_encoder(sizes, state)
    with torch.no_grad():
        return np_of(sp_encoder_forward(enc, torch.from_numpy(ids), torch.from_numpy(mask),
                                        mesh=make_mesh((world,), ("sp",)), axis="sp"))


def job_pp(rank: int, world: int, sizes: dict, state: dict, ids: np.ndarray, mask: np.ndarray,
           n_micro: typ.Optional[int]) -> dict:
    """`pp_encoder_forward` over a `pp` mesh of the world, then mean(h²)
    differentiated: the output and every parameter's gradient this rank
    holds (None for the layers of other stages)."""
    from vod_tpu_torch.parallel import make_mesh, pp_encoder_forward

    enc = plain_encoder(sizes, state)
    h = pp_encoder_forward(enc, torch.from_numpy(ids), torch.from_numpy(mask), mesh=make_mesh((world,), ("pp",)),
                           axis="pp", n_micro=n_micro)
    h.pow(2).mean().backward()
    return dict(h=np_of(h), grads={f"backbone.{n}": None if p.grad is None else np_of(p.grad)
                                   for n, p in enc.named_parameters()})


def realm_system(sizes: dict, lm_sizes: dict, state: dict):
    """A float32 `Realm` (VOD gradients, alpha 0.5) of `_toy_setup`'s layout from `state`."""
    from vod_tpu_torch.models import CausalLMConfig, Realm, TransformerEncoderConfig, VodGradients, VodPoolerConfig

    cfg = TransformerEncoderConfig(dtype=torch.float32, pooler=VodPoolerConfig(
        agg_method="mean", output_norm="l2", scaler=8.0, learn_scaler=True), **sizes)
    model = Realm(cfg, CausalLMConfig(dtype=torch.float32, **lm_sizes), VodGradients(alpha=0.5), device=CPU)
    model.load_state_dict({k: torch.as_tensor(v) for k, v in state.items()})
    return model


def job_tp(rank: int, world: int, sizes: dict, lm_sizes: dict, state: dict, batch: dict, extras: dict,
           mesh_shape: tuple, axes: tuple, combined: bool) -> dict:
    """A `Realm` from `state` split by `shard_params_tp` over the mesh's `tp`
    axis (or by `shard_params_combined`), its evaluate loss on the whole
    `batch` (a `RealmBatch`'s fields) differentiated. Returns the loss, the
    retriever scores, the query encodings, each parameter's local gradient
    and the split dims."""
    from vod_tpu_torch.parallel import combined_sharding, make_mesh, shard_params_combined, shard_params_tp, tp_sharding
    from vod_tpu_torch.types.batch import RealmBatch

    mesh = make_mesh(mesh_shape, axes)
    model = realm_system(sizes, lm_sizes, state)
    plan = combined_sharding(model, mesh) if combined else tp_sharding(model, mesh)
    (shard_params_combined if combined else shard_params_tp)(model, mesh)
    b = RealmBatch(**_tensors(batch), extras=extras)
    out = model(b, mode="evaluate")
    out.loss.backward()
    with torch.no_grad():
        enc = model.encode_field(b.query__input_ids, b.query__attention_mask)
    return dict(loss=float(out.loss), scores=np_of(out.retriever_scores), enc=np_of(enc), plan=plan,
                grads={n: np_of(p.grad.to_local() if hasattr(p.grad, "to_local") else p.grad)
                       for n, p in model.named_parameters()})


def job_multichip_dryrun(rank: int, world: int, dtype: str) -> dict:
    """`examples/multichip_dryrun.py:dryrun` on this rank (the CPU)."""
    from vod_tpu_torch.examples.multichip_dryrun import dryrun

    return dryrun(world, CPU, getattr(torch, dtype))


def job_gradcache_dp(rank: int, world: int, cases: list) -> list:
    """GradCache over a batch split by a `dp` mesh of the world, one call per
    case `(kind, sizes, state, fields, extras, chunk_rows)`: a float32 SPLADE
    or MoE `Ranker` from `state`, this rank's rows of the global batch
    `fields` (numpy; the sections of its queries, or the whole pool with
    `extras["flat_sections"]`). Returns per case the loss and the gradients
    averaged over the axis (`average_gradients`)."""
    import torch.distributed as dist

    from vod_tpu_torch.models import Ranker, RetrievalGradients, TransformerEncoderConfig, VodPoolerConfig
    from vod_tpu_torch.parallel import data_parallel, make_mesh
    from vod_tpu_torch.runtime.gradcache import gradcache_backward
    from vod_tpu_torch.runtime.train import average_gradients
    from vod_tpu_torch.types.batch import RealmBatch

    mesh = make_mesh((world,), ("dp",))
    out = []
    for kind, sizes, state, fields, extras, chunk_rows in cases:
        pooler = VodPoolerConfig(agg_method="mean", output_norm="l2", scaler=8.0)
        if kind == "splade":
            model = splade_ranker(sizes, state)
        else:
            cfg = TransformerEncoderConfig(dtype=torch.float32, pooler=pooler, **sizes)
            model = Ranker(cfg, RetrievalGradients(), device=CPU)
            model.load_state_dict({k: torch.as_tensor(v) for k, v in state.items()})
        b = fields["query__input_ids"].shape[0]
        dp = data_parallel(mesh, "dp", b)
        per = b // world
        mine = {}
        for k, v in fields.items():
            if k.startswith("section__input_ids") or k.startswith("section__attention_mask"):
                n = v.shape[0] // b
                v = v if extras.get("flat_sections", False) else v[rank * per * n : (rank + 1) * per * n]
            else:
                v = v[rank * per : (rank + 1) * per]
            mine[k] = torch.from_numpy(np.ascontiguousarray(v))
        model.zero_grad(set_to_none=True)
        res = gradcache_backward(model, RealmBatch(**mine, extras=dict(extras)), chunk_rows=chunk_rows, dp=dp)
        params = list(model.parameters())
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        average_gradients(params, dp.group, world)
        loss = res.loss.detach().clone()
        dist.all_reduce(loss)
        out.append(dict(loss=float(loss) / world, grads={n: np_of(p.grad) for n, p in model.named_parameters()}))
    return out

