"""The port of `__graft_entry__.py:dryrun_multichip`
(`vod_tpu_torch/examples/multichip_dryrun.py`) on W = 4 gloo ranks of the
CPU: a (dp 2, fsdp 1, tp 2) mesh by JAX's rule, one train step of the toy
Realm with `shard_params_combined`, sharded PQ and BM25, then the pp, sp and
ep legs with JAX's assertions.

In f32 the sharded step equals the same step in one process: the mean of
the two dp halves' losses within 1e-5 of the one-process loss over the
same 4 queries, and the gradient norm (which sums each tensor-parallel
block's squares once over the tp axis) within 1e-5 relative.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from tests.torch_helpers import CPU, job_multichip_dryrun, run_ranks

ROOT = Path(__file__).resolve().parents[1]


def test_dryrun_at_w4_passes_every_leg_and_equals_one_process(tmp_path) -> None:
    from vod_tpu_torch.examples.multichip_dryrun import train_leg

    got = run_ranks(job_multichip_dryrun, 4, tmp_path, "float32", timeout=240)
    for res in got:
        assert res["train"]["mesh"] == {"dp": 2, "fsdp": 1, "tp": 2} and res["train"]["tp_split"] > 0
        legs = res["legs"]
        assert (legs["pp"]["size"], legs["sp"]["size"], legs["ep"]["size"]) == (2, 2, 4)
        assert legs["pp"]["err"] <= 1e-4 and legs["sp"]["err"] <= 1e-4 and legs["ep"]["err"] <= 1e-5
    # ranks 0, 1 hold the first dp block (tp 0, 1), ranks 2, 3 the second
    assert got[0]["train"]["loss"] == got[1]["train"]["loss"] and got[2]["train"]["loss"] == got[3]["train"]["loss"]
    one = train_leg(1, CPU, torch.float32, b=4)
    np.testing.assert_allclose(np.mean([got[0]["train"]["loss"], got[2]["train"]["loss"]]), one["loss"], atol=1e-5,
                               rtol=0)
    for res in got:
        np.testing.assert_allclose(res["train"]["grad_norm"], one["grad_norm"], rtol=1e-5, atol=0)


def test_dryrun_launches_two_workers_from_the_command_line() -> None:
    out = subprocess.run([sys.executable, "-m", "vod_tpu_torch.examples.multichip_dryrun", "--launch", "2",
                          "--device", "cpu", "--timeout", "240"], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, (out.stdout[-2000:], out.stderr[-2000:])
    assert "MULTICHIP-DRYRUN-OK" in out.stdout
    assert "mesh={'dp': 2, 'fsdp': 1, 'tp': 1}" in out.stdout
