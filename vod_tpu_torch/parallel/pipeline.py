"""Pipeline parallelism: the GPipe schedule over a mesh axis (port of
`vod_tpu/parallel/pipeline.py`).

Rank s of the `pp` axis holds stage s, layers `[s·L/S, (s+1)·L/S)`. The
schedule is JAX's trapezoid: `n_micro + S - 1` ticks; at tick t stage 0
takes microbatch `min(t, n_micro - 1)` and every other stage takes what the
stage before it sent at tick t - 1; stage s works on microbatch t - s, whose
side inputs (`const`, e.g. the attention mask) it reads at
`clip(t - s, 0, n_micro - 1)`; each output goes one rank on by `ppermute`.
The last stage emits microbatch m at tick m + S - 1, and those outputs are
summed over the axis, so every rank returns the whole batch.

Every rank runs the same graph, as JAX's scan does: each tick computes on
every rank (the bubbles compute on zeros or stale inputs, and their results
are masked), and stage 0's injection is a `torch.where`, not a branch, so
the backward issues the same collectives in the same order on each rank.
Gradients flow back through the shifts: each rank holds the gradients of
its own stage's layers, and the pipeline input's gradient (stage 0's) is
summed over the axis, so every rank holds the embeddings' whole gradient.
"""

from __future__ import annotations

import typing as typ

import torch

from .distributed import copy_over, ppermute, sum_over
from .mesh import axis_group_of, axis_index, axis_size


def stack_pipeline_stages(layers: typ.Sequence[typ.Any], n_stages: int) -> list[list[typ.Any]]:
    """The L layers in `n_stages` equal stages, in order: stage s holds
    layers `[s·L/S, (s+1)·L/S)`."""
    n_layers = len(layers)
    if n_layers % n_stages:
        raise ValueError(f"{n_layers} layers do not split into {n_stages} equal stages")
    per = n_layers // n_stages
    return [list(layers[s * per : (s + 1) * per]) for s in range(n_stages)]


def _micro(t: typ.Any, n_micro: int) -> typ.Any:
    if t is None:
        return None
    if isinstance(t, (tuple, list)):
        return type(t)(_micro(c, n_micro) for c in t)
    return t.reshape((n_micro, t.shape[0] // n_micro) + tuple(t.shape[1:]))


def _pick(t: typ.Any, i: int) -> typ.Any:
    if t is None:
        return None
    if isinstance(t, (tuple, list)):
        return type(t)(_pick(c, i) for c in t)
    return t[i]


def pipeline_apply(
    stage_params: typ.Any,
    x: torch.Tensor,
    stage_fn: typ.Callable[[typ.Any, torch.Tensor, typ.Any], torch.Tensor],
    *,
    mesh: typ.Any = None,
    axis: str = "pp",
    n_micro: typ.Optional[int] = None,
    const: typ.Any = None,
) -> torch.Tensor:
    """Run `x` `[B, ...]` (the same on every rank) through the stages of
    `axis`: this rank's `stage_fn(stage_params, x_mb, const_mb)` is its
    stage, and must return a tensor of `x_mb`'s shape. `n_micro`
    (default: the stage count) must divide B; `const` is None, a tensor or
    a tuple of tensors with leading axis B. Returns the last stage's
    `[B, ...]` on every rank."""
    group = axis_group_of(mesh, axis, "a pipeline")
    stages = axis_size(mesh, axis)
    stage = axis_index(mesh, axis)
    n_micro = stages if n_micro is None else n_micro
    b = x.shape[0]
    if b % n_micro:
        raise ValueError(f"batch {b} does not divide into {n_micro} microbatches")
    x_mb = copy_over(_micro(x, n_micro), group)
    const_mb = _micro(const, n_micro)
    first = torch.full((), stage == 0, dtype=torch.bool, device=x.device)
    last = torch.full((), stage == stages - 1, dtype=torch.bool, device=x.device)
    ticks = n_micro + stages - 1
    buf = torch.zeros_like(x_mb[0])
    outs = []
    for t in range(ticks):
        inp = torch.where(first, x_mb[min(t, n_micro - 1)], buf)
        out = stage_fn(stage_params, inp, _pick(const_mb, min(max(t - stage, 0), n_micro - 1)))
        outs.append(out)
        if t < ticks - 1:  # JAX also shifts after the last tick; nothing reads that result
            buf = ppermute(out, group, 1)
    y = torch.stack(outs[stages - 1 :])
    y = sum_over(torch.where(last, y, torch.zeros_like(y)), group)  # one rank contributes
    return y.reshape((b,) + tuple(y.shape[2:]))


def pp_encoder_forward(
    model: torch.nn.Module,
    input_ids: torch.Tensor,
    attention_mask: torch.Tensor,
    *,
    mesh: typ.Any = None,
    axis: str = "pp",
    n_micro: typ.Optional[int] = None,
) -> torch.Tensor:
    """`TransformerEncoder.forward` with its layers pipelined over `axis`:
    the embeddings run on every rank, and the `num_layers` layers split
    into `S` equal stages, this rank running its own. Returns `[B, T, H]`
    on every rank, the same values as the sequential forward."""
    axis_group_of(mesh, axis, "a pipeline")
    h = model.embeddings(input_ids, None)
    mask = attention_mask[:, None, None, :] > 0
    stages = stack_pipeline_stages(list(model.layers), axis_size(mesh, axis))

    def stage_fn(layers: list, x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
        for layer in layers:
            x = layer(x, m)
        return x

    return pipeline_apply(stages[axis_index(mesh, axis)], h, stage_fn, mesh=mesh, axis=axis, n_micro=n_micro,
                          const=mask)
