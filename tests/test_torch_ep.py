"""Expert parallelism (`vod_tpu_torch/parallel/moe.py:shard_params_ep`) at
W = 2 and 4 gloo ranks against the replicated `MoEFFN` and against JAX's
(replicated, and split over a 4-device `ep` mesh, as
`tests/test_parallel.py:260` runs it).

Tokens are replicated over the axis: each rank runs its block of experts,
and the partial outputs are summed. Tolerances, f32: outputs and aux within
1e-5; the gradients of sum(y²) + aux (the gate's and x's on every rank, the
expert blocks' on their rank) within 1e-4 of `jax.grad`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_helpers import job_moe_ep, moe_module, np_of, run_ranks
from vod_tpu.parallel import make_mesh as jax_make_mesh
from vod_tpu.parallel.moe import MoEFFN as JaxMoEFFN
from vod_tpu.parallel.moe import shard_params_ep as jax_shard_params_ep

ATOL, GRAD_ATOL = 1e-5, 1e-4
CASES = {"top2": (2, 1.25), "top1-tight": (1, 0.5)}


@pytest.fixture(scope="module")
def jax_runs():
    """Per case: the params, the input, JAX's replicated and ep-split output
    and aux, and JAX's gradients."""
    out = {}
    x = np.random.default_rng(5).standard_normal((4, 8, 32)).astype(np.float32)
    for name, (k, cf) in CASES.items():
        moe = JaxMoEFFN(n_experts=4, intermediate_size=48, top_k=k, capacity_factor=cf, dtype=jnp.float32)
        params = jax.device_get(moe.init(jax.random.PRNGKey(3), jnp.asarray(x)))
        y, aux = moe.apply(params, jnp.asarray(x))
        split = jax_shard_params_ep(params, jax_make_mesh((4, 2), ("ep", "dp")), axis="ep")
        y_ep, aux_ep = jax.jit(moe.apply)(split, jnp.asarray(x))

        def loss(p, xx):
            yy, a = moe.apply(p, xx)
            return jnp.sum(yy**2) + a

        gp, gx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))
        out[name] = dict(state={n: np.asarray(v) for n, v in params["params"].items()}, x=x, y=np.asarray(y),
                         aux=float(aux), y_ep=np.asarray(y_ep), aux_ep=float(aux_ep),
                         grads={n: np.asarray(v) for n, v in gp["params"].items()}, x_grad=np.asarray(gx))
    return out


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case", CASES)
def test_ep_equals_replicated_and_jax(case: str, world: int, jax_runs, tmp_path) -> None:
    run = jax_runs[case]
    k, cf = CASES[case]
    np.testing.assert_allclose(run["y_ep"], run["y"], atol=ATOL, rtol=0)  # JAX: split == replicated
    rep_y, rep_aux = moe_module(run["state"], k, cf)(torch.from_numpy(run["x"]))
    np.testing.assert_allclose(np_of(rep_y), run["y"], atol=ATOL, rtol=0)
    got = run_ranks(job_moe_ep, world, tmp_path, run["state"], run["x"], k, cf, timeout=120)
    per = 4 // world
    for r, res in enumerate(got):
        assert res["dims"] == {"gate": None, "wi": 0, "wo": 0}
        np.testing.assert_array_equal(res["wi"], run["state"]["wi"][r * per : (r + 1) * per])
        np.testing.assert_allclose(res["y"], np_of(rep_y), atol=ATOL, rtol=0)
        np.testing.assert_allclose(res["y"], run["y"], atol=ATOL, rtol=0)
        np.testing.assert_allclose(res["aux"], float(rep_aux), atol=ATOL, rtol=0)
        np.testing.assert_allclose(res["aux"], run["aux"], atol=ATOL, rtol=0)
        np.testing.assert_allclose(res["grads"]["gate"], run["grads"]["gate"], atol=GRAD_ATOL, rtol=0)
        np.testing.assert_allclose(res["x_grad"], run["x_grad"], atol=GRAD_ATOL, rtol=0)
        for name in ("wi", "wo"):
            np.testing.assert_allclose(res["grads"][name], run["grads"][name][r * per : (r + 1) * per],
                                       atol=GRAD_ATOL, rtol=0, err_msg=name)


def test_ep_rule_without_the_axis_replicates() -> None:
    """As JAX's: no `ep` axis on the mesh, nothing is split, and
    `shard_params_ep` leaves the module whole."""
    from vod_tpu_torch.parallel import ep_sharding, shard_params_ep

    state = {"gate": np.zeros((8, 4), np.float32), "wi": np.zeros((4, 8, 6), np.float32),
             "wo": np.zeros((4, 6, 8), np.float32)}
    moe = moe_module(state, 1, 1.0)
    assert ep_sharding(moe, None) == {"gate": None, "wi": None, "wo": None}
    assert shard_params_ep(moe, None) is moe and moe.ep is None and tuple(moe.wi.shape) == (4, 8, 6)
