"""A localhost dryrun of the multi-process path (port of
`examples/multiprocess_dryrun.py`).

N processes join one `torch.distributed` group over localhost, each
contributes its contiguous slice of a dataset (`process_slice`), the global
batch is assembled from the ranks' rows (`global_batch_from_local`), and a
data-parallel linear model takes five SGD steps: each rank differentiates its
own rows and the gradients are averaged over the group
(`runtime/train.py:average_gradients`). Three checks: the averaged steps equal
single-process SGD on the global batch (numpy), rank 0 saves the checkpoint
(`runtime/checkpoint.py`, the others wait at a barrier), and every rank
restores it.

Usage:
  python -m vod_tpu_torch.examples.multiprocess_dryrun --launch 2               # 2 workers on the card (nccl)
  python -m vod_tpu_torch.examples.multiprocess_dryrun --launch 2 --device cpu  # 2 workers on the CPU (gloo)
  python -m vod_tpu_torch.examples.multiprocess_dryrun --processes 2 --process_id 0 \\
      --coordinator localhost:9876                                              # one worker

Two ranks on one card need `--backend gloo` (NCCL refuses two ranks on one GPU).
"""

from __future__ import annotations

import argparse
import pathlib
import subprocess
import sys
import tempfile
import typing


def worker(args: argparse.Namespace) -> None:
    import numpy as np
    import torch

    from vod_tpu_torch.parallel import (
        barrier,
        global_batch_from_local,
        init_distributed,
        is_main_process,
        make_mesh,
        process_slice,
        rank_device,
    )
    from vod_tpu_torch.runtime.checkpoint import load_checkpoint, save_checkpoint
    from vod_tpu_torch.runtime.state import TrainerState
    from vod_tpu_torch.runtime.train import average_gradients

    torch.set_num_threads(1)
    rank, world = init_distributed(args.coordinator, args.processes, args.process_id, backend=args.backend,
                                   device=args.device)
    assert world == args.processes, (world, args.processes)
    dev = rank_device(args.device)
    print(f"[p{rank}] joined: {world} processes ({torch.distributed.get_backend()}, {dev})", flush=True)
    mesh = make_mesh((world,), ("dp",))

    # --- per-process data feeding: each rank owns a contiguous slice ---------
    n_rows, dim = 64, 16
    rng = np.random.default_rng(0)  # the same seed: the full dataset is known everywhere
    full_x = rng.standard_normal((n_rows, dim)).astype(np.float32)
    full_y = rng.standard_normal((n_rows, 1)).astype(np.float32)
    sl = process_slice(n_rows)
    x = torch.from_numpy(full_x[sl]).to(dev)
    y = torch.from_numpy(full_y[sl]).to(dev)
    gx = global_batch_from_local(x, mesh.get_group("dp"))
    assert np.array_equal(gx.cpu().numpy(), full_x), "global batch != the ranks' rows in rank order"

    # --- five data-parallel SGD steps ---------------------------------------
    model = torch.nn.Linear(dim, 1).to(dev)
    torch.nn.init.zeros_(model.weight)
    torch.nn.init.zeros_(model.bias)
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    losses = []
    for _ in range(5):
        opt.zero_grad(set_to_none=True)
        loss = torch.mean((model(x) - y) ** 2)
        loss.backward()
        average_gradients(list(model.parameters()), mesh.get_group("dp"), world)
        opt.step()
        losses.append(float(loss.detach()))
    assert losses[-1] < losses[0], losses
    print(f"[p{rank}] loss {losses[0]:.4f} -> {losses[-1]:.4f}", flush=True)

    # numpy reference: the averaged gradients of equal slices are the global
    # batch's mean gradient
    w = np.zeros((dim, 1), np.float32)
    b = np.zeros((1,), np.float32)
    for _ in range(5):
        err = full_x @ w + b - full_y
        w = w - 0.1 * (2.0 / n_rows) * (full_x.T @ err)
        b = b - 0.1 * (2.0 / n_rows) * err.sum(axis=0)
    got_w = model.weight.detach().cpu().numpy().T
    assert np.allclose(got_w, w, atol=1e-5), "data-parallel SGD != single-process SGD"

    # --- rank 0 saves, every rank restores ----------------------------------
    ckpt = pathlib.Path(args.ckpt_dir or tempfile.gettempdir()) / "mp_dryrun_ckpt"
    save_checkpoint(ckpt, model=model, optimizer=opt, state=TrainerState(step=5))
    fresh = torch.nn.Linear(dim, 1).to(dev)
    state = load_checkpoint(ckpt, model=fresh, optimizer=torch.optim.SGD(fresh.parameters(), lr=0.1))
    assert state.step == 5
    assert torch.equal(fresh.weight, model.weight) and torch.equal(fresh.bias, model.bias)
    barrier("before-exit")
    if is_main_process():
        print("MULTIPROCESS-DRYRUN-OK", flush=True)
    torch.distributed.destroy_process_group()


def launch(args: argparse.Namespace) -> int:
    """Start `args.launch` workers against a fresh localhost port and wait for
    them; returns the largest exit code."""
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="mp_dryrun_")
    extra = ["--device", args.device] + (["--backend", args.backend] if args.backend else [])
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "vod_tpu_torch.examples.multiprocess_dryrun", "--processes", str(args.launch),
             "--process_id", str(i), "--coordinator", f"localhost:{port}", "--ckpt_dir", ckpt_dir, *extra],
            cwd=pathlib.Path(__file__).resolve().parents[2],
        )
        for i in range(args.launch)
    ]
    try:
        return max(p.wait(timeout=600) for p in procs)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()


def main(argv: typing.Optional[list[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--launch", type=int, default=None, help="start N workers and wait")
    ap.add_argument("--processes", type=int, default=2)
    ap.add_argument("--process_id", type=int, default=None)
    ap.add_argument("--coordinator", type=str, default=None)
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--backend", default=None, help="default: nccl on cuda, gloo on cpu")
    ap.add_argument("--ckpt_dir", type=str, default=None)
    args = ap.parse_args(argv)
    if args.launch:
        sys.exit(launch(args))
    worker(args)


if __name__ == "__main__":
    main()
