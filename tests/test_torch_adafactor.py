"""The port's Adafactor (`vod_tpu_torch/runtime/optim.py`) against
`optax.adafactor(lr, weight_decay_rate=wd or None)`, as the JAX CLI builds
it, over several steps of seeded numpy gradients: factored leaves (both of
the two largest axes at least 128) and unfactored ones, a scalar, a zero
leaf (the 1e-3 parameter-scale floor), weight decay and an lr schedule; then
over an encoder whose leaves the flax layout factors otherwise than torch's
would (an attention kernel [H, heads, head_dim]).

Tolerance: parameters within atol 1e-7 plus rtol 1e-5 after each step (f32
on both sides; JAX's `pow` and torch's may differ by an ulp, and the means
sum in other orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.torch_helpers import CPU, np_of
from vod_tpu.models.encoder import TransformerEncoderConfig as JaxConfig
from vod_tpu.models.encoder import VodEncoder as JaxEncoder
from vod_tpu.models.pooler import VodPoolerConfig as JaxPoolerConfig
from vod_tpu_torch.models import TransformerEncoderConfig, VodEncoder, VodPoolerConfig, flax_to_state_dict
from vod_tpu_torch.runtime import Adafactor, adafactor

ATOL, RTOL = 1e-7, 1e-5
SHAPES = {"factored": (256, 130), "factored_3d": (3, 200, 160), "rows_128": (140, 128), "small_2d": (7, 5),
          "narrow": (4, 300), "vector": (64,), "scalar": (), "zero": (130, 129)}


def _params(seed: int = 0) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    out = {k: np.asarray(0.1 * rng.standard_normal(s), np.float32) for k, s in SHAPES.items()}
    out["zero"][:] = 0.0
    return out


def _run(lr, weight_decay, steps: int = 6, seed: int = 0):
    params = _params(seed)
    tx = optax.adafactor(lr, weight_decay_rate=weight_decay or None)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(np.array(v))) for k, v in params.items()}
    opt = Adafactor(list(tp.values()), lr(0) if callable(lr) else lr, weight_decay=weight_decay or None)
    rng = np.random.default_rng(seed + 1)
    for t in range(steps):
        grads = {k: np.asarray(rng.standard_normal(v.shape) * (0.0 if k == "zero" and t == 0 else 1.0), np.float32)
                 for k, v in params.items()}
        updates, state = tx.update({k: jnp.asarray(v) for k, v in grads.items()}, state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = torch.from_numpy(grads[k])
        if callable(lr):
            for group in opt.param_groups:
                group["lr"] = float(lr(t))
        opt.step()
        for k in params:
            np.testing.assert_allclose(np_of(tp[k]), np.asarray(jp[k]), atol=ATOL, rtol=RTOL, err_msg=f"{k} step {t}")
    return opt, tp


@pytest.mark.parametrize("weight_decay", [0.0, 0.01], ids=["no-decay", "decay"])
@pytest.mark.parametrize("schedule", [False, True], ids=["constant", "linear"])
def test_adafactor_matches_optax(weight_decay: float, schedule: bool) -> None:
    lr = optax.linear_schedule(1e-2, 1e-3, 6) if schedule else 1e-2
    opt, tp = _run(lr, weight_decay)
    state = opt.state[tp["factored"]]
    assert state["count"] == 6 and state["v_row"].shape == (130,) and state["v_col"].shape == (256,)
    assert set(opt.state[tp["small_2d"]]) == {"count", "v"} and opt.state[tp["narrow"]]["v"].shape == (4, 300)
    assert opt.state[tp["factored_3d"]]["v_row"].shape == (3, 160)  # the two largest axes, 1 and 2


def test_zero_leaf_takes_the_floor() -> None:
    """A leaf at 0 (a fresh LoRA `lora_b`) moves by lr * 1e-3 * the clipped
    update, not by 0."""
    opt, tp = _run(1e-2, 0.0, steps=2)
    moved = np_of(tp["zero"])
    assert 0 < np.abs(moved).max() <= 2 * 1e-2 * 1e-3 * np.sqrt(moved.size) + 1e-12


def test_state_round_trips_through_a_checkpoint(tmp_path) -> None:
    opt, tp = _run(1e-2, 0.01, steps=2)
    torch.save(opt.state_dict(), tmp_path / "opt.pt")
    params = [torch.nn.Parameter(p.detach().clone()) for p in tp.values()]
    fresh = Adafactor(params, 1e-2, weight_decay=0.01)
    fresh.load_state_dict(torch.load(tmp_path / "opt.pt", weights_only=True))
    for p, q in zip(tp.values(), params):
        a, b = opt.state[p], fresh.state[q]
        assert a["count"] == b["count"] and all(torch.equal(a[k], b[k]) for k in a if k != "count")


def test_adafactor_over_an_encoder_factors_flax_leaves() -> None:
    """hidden 256, 2 heads: the query kernel is [256, 2, 128] in flax, which
    factors over its axes 2 and 0 (128 and 256), where torch's [256, 256]
    weight would factor otherwise (moments [2, 128] and [256, 2]); the out
    kernel [2, 128, 256] likewise."""
    sizes = dict(vocab_size=130, hidden_size=256, num_layers=1, num_heads=2, intermediate_size=512,
                 max_position_embeddings=16)
    pooler = dict(agg_method="mean", output_norm="l2", scaler=10.0, learn_scaler=True)
    jmodel = JaxEncoder(JaxConfig(dtype=jnp.float32, pooler=JaxPoolerConfig(**pooler), **sizes))
    ids = np.random.default_rng(0).integers(0, 130, (2, 8)).astype(np.int32)
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(0), jnp.asarray(ids), jnp.ones((2, 8), jnp.int32)))
    model = VodEncoder(TransformerEncoderConfig(dtype=torch.float32, pooler=VodPoolerConfig(**pooler), **sizes),
                       device=CPU)
    model.load_state_dict(flax_to_state_dict(params))
    tx = optax.adafactor(1e-2, weight_decay_rate=0.01)
    state = tx.init(params)
    opt = adafactor(model, 1e-2, weight_decay=0.01)
    rng = np.random.default_rng(3)
    for _ in range(3):
        grads = jax.tree.map(lambda x: rng.standard_normal(np.shape(x)).astype(np.float32), params)
        updates, state = tx.update(grads, state, params)
        params = jax.device_get(optax.apply_updates(params, updates))
        tgrads = flax_to_state_dict(grads)
        for name, p in model.named_parameters():
            p.grad = tgrads[name].clone()
        opt.step()
    want = flax_to_state_dict(params)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(np_of(p), np_of(want[name]), atol=ATOL, rtol=RTOL, err_msg=name)
    q = opt.state[model.backbone.layers[0].attention.query.weight]
    assert q["v_row"].shape == (2, 128) and q["v_col"].shape == (256, 2)
