"""GPipe (`vod_tpu_torch/parallel/pipeline.py`) on S = 2 and 4 gloo ranks
against JAX's sequential encoder (`tests/test_parallel.py:184-222`): four
layers, a batch of 8 with one row whose keys are all masked.

Each rank holds its stage's layers; the forward returns the whole batch on
every rank. Tolerances, f32: the forward within 1e-5, with the default
`n_micro` (S) and with 8; the gradients of mean(h²), each stage's layers on
their rank and the embeddings on every rank, within 1e-4 of JAX's
sequential gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_parallel import _encoder_setup
from tests.torch_helpers import job_pp, plain_encoder, run_ranks
from vod_tpu_torch.models import flax_to_state_dict

ATOL, GRAD_ATOL = 1e-5, 1e-4


@pytest.fixture(scope="module")
def case():
    cfg, enc, params, ids, mask, ref = _encoder_setup(num_layers=4, seq=16)
    grads = jax.grad(lambda p: jnp.mean(enc.apply({"params": p}, ids, mask) ** 2))(params)
    sizes = dict(vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size, num_layers=cfg.num_layers,
                 num_heads=cfg.num_heads, intermediate_size=cfg.intermediate_size)
    state = {k: v.numpy() for k, v in flax_to_state_dict({"backbone": jax.device_get(params)}).items()}
    want = {k: v.numpy() for k, v in flax_to_state_dict({"backbone": jax.device_get(grads)}).items()}
    return sizes, state, np.asarray(ids), np.asarray(mask), ref, want


@pytest.mark.parametrize("n_micro", [None, 8], ids=["n_micro=S", "n_micro=8"])
@pytest.mark.parametrize("stages", [2, 4])
def test_pp_encoder_forward_and_grads_match_jax(stages: int, n_micro, case, tmp_path) -> None:
    sizes, state, ids, mask, ref, want = case
    got = run_ranks(job_pp, stages, tmp_path, sizes, state, ids, mask, n_micro, timeout=120)
    per = sizes["num_layers"] // stages
    for rank, res in enumerate(got):
        np.testing.assert_allclose(res["h"], ref, atol=ATOL, rtol=0)
        mine = {f"backbone.layers.{i}." for i in range(rank * per, (rank + 1) * per)}
        for name, g in res["grads"].items():
            if ".layers." in name and not any(name.startswith(p) for p in mine):
                assert g is None, name  # another stage's layer
                continue
            np.testing.assert_allclose(g, want[name], atol=GRAD_ATOL, rtol=0, err_msg=name)


def test_pp_on_one_rank_and_its_refusals(case) -> None:
    from vod_tpu_torch.parallel import pp_encoder_forward, stack_pipeline_stages

    sizes, state, ids, mask, ref, _ = case
    enc = plain_encoder(sizes, state)
    with torch.no_grad():
        h = pp_encoder_forward(enc, torch.from_numpy(ids), torch.from_numpy(mask), n_micro=4)
    np.testing.assert_allclose(h.numpy(), ref, atol=ATOL, rtol=0)
    with pytest.raises(ValueError, match="does not divide into 3 microbatches"):
        pp_encoder_forward(enc, torch.from_numpy(ids), torch.from_numpy(mask), n_micro=3)
    with pytest.raises(ValueError, match="equal stages"):
        stack_pipeline_stages(list(enc.layers), 3)

    class TwoStages:  # a pp axis of size 2, and no process group
        mesh_dim_names = ("pp",)

        @staticmethod
        def size(i):
            return 2

    with pytest.raises(RuntimeError, match="process group"):
        pp_encoder_forward(enc, torch.from_numpy(ids), torch.from_numpy(mask), mesh=TwoStages())
