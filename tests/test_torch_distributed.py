"""The port's process group (`vod_tpu_torch/parallel/distributed.py`) and its
multi-process dryrun (`vod_tpu_torch/examples/multiprocess_dryrun.py`)
against the JAX package's `vod_tpu/parallel/distributed.py`: joining from
torchrun's environment and from JAX's flags, `process_slice`'s contiguous
ceil blocks, `global_batch_from_local` in rank order, the collectives and
`barrier`, on gloo groups of CPU ranks."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.torch_helpers import job_basics, run_ranks
from vod_tpu_torch.parallel import init_distributed, is_main_process, process_slice, rank_device

ROOT = Path(__file__).resolve().parent.parent


def _jax_process_slice(n: int, pi: int, pc: int) -> slice:
    """`vod_tpu/parallel/distributed.py:process_slice` at process `pi` of `pc`."""
    per = -(-n // pc)
    return slice(pi * per, min((pi + 1) * per, n))


@pytest.mark.parametrize("world", [2, 3])
def test_slices_batches_and_collectives_on_a_group(world: int, tmp_path) -> None:
    n = 10
    out = run_ranks(job_basics, world, tmp_path, n)
    for rank, res in enumerate(out):
        want = _jax_process_slice(n, rank, world)
        assert res["slice"] == (want.start, want.stop)
        assert res["world"] == world and res["main"] == (rank == 0)
        # the ranks' rows, in rank order: row i tagged by the rank that holds it
        owner = np.concatenate([np.full(len(range(*_jax_process_slice(n, r, world).indices(n))), r)
                                for r in range(world)])
        np.testing.assert_array_equal(res["batch"][:, 0], np.arange(n) * 10 + owner)
        np.testing.assert_array_equal(res["gathered"], [[r, 7 * r] for r in range(world)])
        assert res["meshes"] == {"1d": [world], "2d": [2, world // 2] if world % 2 == 0 else [world, 1]}


def test_without_a_group_everything_is_one_process(monkeypatch) -> None:
    for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
                 "JAX_PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    assert init_distributed() == (0, 1)
    assert init_distributed(num_processes=1, process_id=0) == (0, 1)
    assert is_main_process() and not torch.distributed.is_initialized()
    assert process_slice(10) == _jax_process_slice(10, 0, 1)
    with pytest.raises(ValueError, match="coordinator"):
        init_distributed(num_processes=2, process_id=0)
    if not torch.cuda.is_available():  # a CUDA rank never falls back to the CPU
        with pytest.raises(RuntimeError, match="GPU"):
            init_distributed("localhost:1", 2, 0, device="cuda")
        with pytest.raises(RuntimeError, match="GPU"):
            rank_device("cuda")
        assert not torch.distributed.is_initialized()
    assert rank_device("cpu") == torch.device("cpu")


_ENV_RANK = """
import sys, torch
sys.path.insert(0, {root!r})
torch.set_num_threads(1)
from vod_tpu_torch.parallel import init_distributed, all_reduce_, barrier
rank, world = init_distributed(device="cpu")
t = torch.tensor([rank + 1.0])
all_reduce_(t)
barrier()
print("RANK", rank, world, torch.distributed.get_backend(), float(t[0]), flush=True)
torch.distributed.destroy_process_group()
"""


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("how", ["torchrun-env", "jax-env"])
def test_init_from_the_environment(how: str) -> None:
    """torchrun's RANK / WORLD_SIZE / LOCAL_RANK / MASTER_ADDR, or JAX's
    JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID: each of two
    processes joins a gloo group on the CPU."""
    port = _free_port()
    procs = []
    for rank in range(2):
        env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_"))}
        if how == "torchrun-env":
            env.update(RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                       MASTER_PORT=str(port))
        else:
            env.update(JAX_COORDINATOR_ADDRESS=f"localhost:{port}", JAX_NUM_PROCESSES="2", JAX_PROCESS_ID=str(rank))
        procs.append(subprocess.Popen([sys.executable, "-c", _ENV_RANK.format(root=str(ROOT))], env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = [p.communicate(timeout=120) for p in procs]
    for rank, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, err[-2000:]
        assert f"RANK {rank} 2 gloo 3.0" in out


def test_the_ported_dryrun_example_runs_two_ranks() -> None:
    """`--launch 2 --device cpu`: two processes join over JAX's flags
    (`--coordinator`, `--num_processes`, `--process_id`), their averaged
    gradients equal single-process SGD on the global batch, rank 0 saves and
    every rank restores."""
    res = subprocess.run(
        [sys.executable, "-m", "vod_tpu_torch.examples.multiprocess_dryrun", "--launch", "2", "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_"))},
    )
    assert res.returncode == 0, res.stderr[-3000:]
    assert "MULTIPROCESS-DRYRUN-OK" in res.stdout
    assert "[p0] joined: 2 processes (gloo, cpu)" in res.stdout and "[p1] joined" in res.stdout
