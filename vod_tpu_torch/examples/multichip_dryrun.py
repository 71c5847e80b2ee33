"""A multi-process dryrun of model parallelism (port of
`__graft_entry__.py:dryrun_multichip`).

N processes join one `torch.distributed` group. The ranks form a
(dp, fsdp, tp) mesh by JAX's rule (dp 2 where N is even, then tp 2 where
the rest is even, fsdp the rest) and take one live-retrieval train step of
the toy Realm (VOD gradients, the LM reader): parameters split by
`shard_params_combined` (TP where JAX's TP rule splits, FSDP2 for the rest),
a PQ index (int8 refine) and BM25 postings sharded over fsdp, the batch
split over dp. Then three legs, each on a mesh of its own and held to the
same package's sequential forward, with JAX's assertions:
  * pp: the encoder's layers pipelined over a pp axis of 2 (`pp_encoder_forward`),
    forward and gradients (finite, the forward within `tol`);
  * sp: the encoder with ring attention over an sp axis of 2 (`sp_encoder_forward`);
  * ep: an `MoEFFN` (4 experts, top-2) with its experts split over an ep axis
    (the largest of 4, 3, 2, 1 that divides N), against the replicated
    module within 1e-5, its aux and gradients finite.

Usage:
  python -m vod_tpu_torch.examples.multichip_dryrun --launch 4 --device cpu   # 4 workers on the CPU (gloo)
  python -m vod_tpu_torch.examples.multichip_dryrun --launch 2 --device cuda --backend gloo   # 2 ranks on one card
  python -m vod_tpu_torch.examples.multichip_dryrun                           # one process, no mesh

The activations are bf16 (the toy config's, as in JAX) and the sequential
comparisons hold within 6e-2 (`--dtype float32`: f32, the same bound).
Each worker prints one JSON line of its results; rank 0 then prints
MULTICHIP-DRYRUN-OK.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import typing as typ

import numpy as np
import torch

VOCAB, LQ, LS, LA, N_CORPUS, HIDDEN = 512, 12, 16, 4, 256, 64


def _check(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


def mesh_shape(n: int) -> tuple[int, int, int]:
    """JAX's (dp, fsdp, tp) for n devices (`__graft_entry__.py:147-151`)."""
    dp = 2 if n % 2 == 0 else 1
    rest = n // dp
    tp = 2 if rest % 2 == 0 else 1
    return dp, rest // tp, tp


def toy_setup(b: int, device: torch.device, dtype: torch.dtype) -> tuple:
    """`__graft_entry__.py:_toy_setup`: the Realm (hidden 64, 2 layers, 2 heads,
    intermediate 128, vocab 512), a 256-section corpus (4 subsets) and `b`
    queries with two gold sections and an answer each."""
    from vod_tpu_torch.models import CausalLMConfig, Realm, TransformerEncoderConfig, VodGradients, VodPoolerConfig
    from vod_tpu_torch.runtime import QueryBatch, build_device_corpus

    rng = np.random.default_rng(0)
    widths = dict(vocab_size=VOCAB, hidden_size=HIDDEN, num_layers=2, num_heads=2, intermediate_size=128)
    cfg = TransformerEncoderConfig(dtype=dtype, pooler=VodPoolerConfig(
        agg_method="mean", output_norm="l2", scaler=8.0, learn_scaler=True), **widths)
    model = Realm(cfg, CausalLMConfig(dtype=dtype, **widths), VodGradients(alpha=0.5), device=device,
                  generator=torch.Generator(device).manual_seed(0))
    corpus = build_device_corpus(rng.integers(1, VOCAB, (N_CORPUS, LS)).astype(np.int32),
                                 np.ones((N_CORPUS, LS), np.int32), (np.arange(N_CORPUS) % 4).astype(np.int32),
                                 device=device)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    queries = QueryBatch(
        input_ids=t(rng.integers(1, VOCAB, (b, LQ)).astype(np.int32)), attention_mask=t(np.ones((b, LQ), np.int32)),
        section_ids=t(rng.integers(0, N_CORPUS, (b, 2)).astype(np.int32)),
        answer_ids=t(rng.integers(1, VOCAB, (b, LA)).astype(np.int32)), answer_mask=t(np.ones((b, LA), np.int32)),
        terms=t(np.random.default_rng(3).integers(0, 64, (b, 4)).astype(np.int32)),
    )
    return model, cfg, corpus, queries


def _mesh(shape: tuple, names: tuple, world: int) -> typ.Any:
    from vod_tpu_torch.parallel import make_mesh

    return make_mesh(shape, names) if world > 1 else None


def train_leg(world: int, device: torch.device, dtype: torch.dtype, b: typ.Optional[int] = None) -> dict:
    """The sharded train step over `b` queries (default: 2 per dp rank).
    Returns this rank's loss and the gradient norm."""
    from vod_tpu_torch.parallel import shard_batch, shard_params_combined
    from vod_tpu_torch.parallel.mesh import data_parallel
    from vod_tpu_torch.runtime import adamw, make_train_step
    from vod_tpu_torch.search import HybridEngines, build_pq_index
    from vod_tpu_torch.search.sharded import same_on_every_rank, shard_pq_index, shard_sparse_index
    from vod_tpu_torch.search.sparse import build_sparse_index_native

    shape = mesh_shape(world)
    mesh = _mesh(shape, ("dp", "fsdp", "tp"), world)
    b = 2 * shape[0] if b is None else b
    model, _, corpus, queries = toy_setup(b, device, dtype)
    emb = np.random.default_rng(1).normal(size=(N_CORPUS, HIDDEN)).astype(np.float32)
    doc_terms = [[int(x) for x in np.random.default_rng(i).integers(0, 64, size=6)] for i in range(N_CORPUS)]
    pq = build_pq_index(emb, n_subquantizers=8, coarse_dim=None, kmeans_iters=2, refine="int8", k_factor=4,
                        generator=torch.Generator(device).manual_seed(7), device=device)
    sparse = build_sparse_index_native(doc_terms, n_terms=64, max_postings=64, device=device)
    if mesh is None:
        engines = HybridEngines(dense=pq, sparse=sparse)
    else:
        pq = same_on_every_rank(pq, None)  # card builds differ between ranks in float sum order
        engines = HybridEngines(dense=shard_pq_index(pq, mesh, axis="fsdp"),
                                sparse=shard_sparse_index(sparse, mesh, axis="fsdp"))
        shard_params_combined(model, mesh)
    step = make_train_step(model, adamw(model, 1e-3, weight_decay=1e-4, mask=False), prefetch=16, n_sections=4,
                           max_pos_sections=2, with_lm=True, gradient_clip_val=1.0)
    dp = data_parallel(mesh, "dp", b)
    local = shard_batch(queries, mesh, "dp") if mesh is not None else queries
    metrics, _, _ = step.train_step(engines, corpus, local, torch.Generator(device).manual_seed(1),
                                    {"dense": 1.0, "sparse": 0.5}, dp=dp)
    loss = float(metrics["loss"])
    _check(np.isfinite(loss), f"non-finite loss in the multichip dryrun: {loss}")
    tp_split = sum(hasattr(p, "tp_group") for p in model.parameters())
    return dict(mesh=dict(zip(("dp", "fsdp", "tp"), shape)), loss=loss, grad_norm=float(metrics["grad_norm"]),
                tp_split=tp_split)


def model_legs(world: int, device: torch.device, dtype: torch.dtype, tol: float = 6e-2) -> dict:
    """The pp, sp and ep legs against the sequential forward."""
    from vod_tpu_torch.models.encoder import TransformerEncoder, init_weights
    from vod_tpu_torch.parallel import MoEFFN, axis_index, pp_encoder_forward, shard_params_ep, sp_encoder_forward

    b = 2 * mesh_shape(world)[0]
    _, cfg, _, queries = toy_setup(b, device, dtype)
    enc = TransformerEncoder(cfg, device=device)
    init_weights(enc, torch.Generator(device).manual_seed(2))
    ids, am = queries.input_ids, queries.attention_mask
    with torch.no_grad():
        ref = enc(ids, am)
    out: dict = {}

    pp = 2 if world % 2 == 0 else 1
    h_pp = pp_encoder_forward(enc, ids, am, mesh=_mesh((pp, world // pp), ("pp", "dp"), world), axis="pp")
    loss_pp = h_pp.float().pow(2).sum()
    loss_pp.backward()
    _check(torch.isfinite(loss_pp), "non-finite pp loss")
    _check(all(torch.isfinite(p.grad).all() for p in enc.parameters() if p.grad is not None), "non-finite pp grads")
    out["pp"] = dict(size=pp, err=float((h_pp.detach().float() - ref.float()).abs().max()))
    _check(out["pp"]["err"] <= tol, f"pp forward != sequential: {out['pp']['err']}")

    sp = 2 if world % 2 == 0 and ids.shape[1] % 2 == 0 else 1
    mesh_sp = _mesh((sp, world // sp), ("sp", "dp"), world)
    with torch.no_grad():
        h_sp = sp_encoder_forward(enc, ids, am, mesh=mesh_sp, axis="sp")
    per = ids.shape[1] // sp
    r = axis_index(mesh_sp, "sp") if mesh_sp is not None else 0
    out["sp"] = dict(size=sp, err=float((h_sp.float() - ref[:, r * per : (r + 1) * per].float()).abs().max()))
    _check(out["sp"]["err"] <= tol, f"sp forward != sequential: {out['sp']['err']}")

    ep = min(4, world)
    while world % ep:
        ep -= 1
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((b, 8, HIDDEN)).astype(np.float32)).to(device)
    moe = MoEFFN(HIDDEN, 4, 128, top_k=2, device=device)
    moe.reset_parameters(torch.Generator(device).manual_seed(3))
    with torch.no_grad():
        y_rep, _ = moe(x)
    shard_params_ep(moe, _mesh((ep, world // ep), ("ep", "dp"), world), axis="ep")
    y_ep, aux = moe(x)
    _check(torch.isfinite(aux), "non-finite moe aux loss")
    (y_ep.pow(2).sum() + aux).backward()
    _check(all(torch.isfinite(p.grad).all() for p in moe.parameters()), "non-finite moe grads")
    out["ep"] = dict(size=ep, err=float((y_ep.detach() - y_rep).abs().max()), aux=float(aux.detach()))
    _check(out["ep"]["err"] <= 1e-5, f"ep != replicated: {out['ep']['err']}")
    return out


def dryrun(world: int, device: torch.device, dtype: torch.dtype = torch.bfloat16) -> dict:
    """Every leg on this rank of a group of `world` (no group at 1)."""
    return dict(train=train_leg(world, device, dtype), legs=model_legs(world, device, dtype))


def worker(args: argparse.Namespace) -> None:
    from vod_tpu_torch.parallel import init_distributed, is_main_process, rank_device

    if torch.device(args.device).type == "cpu":
        torch.set_num_threads(1)
    rank, world = 0, 1
    if args.processes > 1:
        rank, world = init_distributed(args.coordinator, args.processes, args.process_id, backend=args.backend,
                                       device=args.device)
    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[args.dtype]
    res = dryrun(world, rank_device(args.device), dtype)
    print(json.dumps(dict(rank=rank, world=world, **res)), flush=True)
    if torch.distributed.is_initialized():
        torch.distributed.barrier()
    if is_main_process():
        t, legs = res["train"], res["legs"]
        print(f"multichip_dryrun({world}): mesh={t['mesh']} loss={t['loss']:.4f} pp={legs['pp']['size']} "
              f"sp={legs['sp']['size']} ep={legs['ep']['size']} OK", flush=True)
        print("MULTICHIP-DRYRUN-OK", flush=True)
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


def launch(args: argparse.Namespace) -> int:
    """Start `args.launch` workers against a fresh localhost port and wait for
    them; returns the largest exit code."""
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    extra = ["--device", args.device, "--dtype", args.dtype] + (["--backend", args.backend] if args.backend else [])
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "vod_tpu_torch.examples.multichip_dryrun", "--processes", str(args.launch),
             "--process_id", str(i), "--coordinator", f"localhost:{port}", *extra],
            cwd=pathlib.Path(__file__).resolve().parents[2],
        )
        for i in range(args.launch)
    ]
    try:
        return max(p.wait(timeout=args.timeout) for p in procs)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()


def main(argv: typ.Optional[list[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--launch", type=int, default=None, help="start N workers and wait")
    ap.add_argument("--processes", type=int, default=1)
    ap.add_argument("--process_id", type=int, default=None)
    ap.add_argument("--coordinator", type=str, default=None)
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--backend", default=None, help="default: nccl on cuda, gloo on cpu")
    ap.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"))
    ap.add_argument("--timeout", type=float, default=600.0, help="seconds to wait for the workers")
    args = ap.parse_args(argv)
    if args.launch:
        sys.exit(launch(args))
    worker(args)


if __name__ == "__main__":
    main()
