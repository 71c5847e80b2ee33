"""Sequence parallelism: ring attention over a mesh axis (port of
`vod_tpu/parallel/ring.py`).

Each rank of the `sp` axis holds one block of the sequence. Its queries stay
put while the K/V blocks travel around the ring, one rank a step, and a
streaming softmax (running max `m`, denominator `l`, numerator `acc`, all in
f32) folds in one block per step. After W steps every query has seen every
key: the result is exact attention, not an approximation, and no rank holds
the `[T, T]` scores or the whole K/V.

What one step rotates (K, V and the key mask) travels as one packed f32
tensor, so each step makes one collective call (`distributed.ppermute`).
The masked scores are the finite `finfo(f32).min`, as the flax attention
fills them: a query whose keys are all masked gets the mean of V, as the
sequential forward gives an all-padding row. The running max is held out of
the gradient (the output does not depend on it); the gradients reach K and
V of other ranks through the shifts' backward.

`sp_encoder_forward` runs the encoder with every attention computed this
way: the embeddings, the FFN and the LayerNorms work on each rank's block
alone. Declared difference: where JAX returns one array sharded over the
axis, the port returns each rank's block. The parameters' gradients are
each rank's part, over its block's tokens: their sum over the axis is the
whole gradient.
"""

from __future__ import annotations

import typing as typ

import torch

from .distributed import ppermute
from .mesh import axis_group_of, axis_index, axis_size


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    mesh: typ.Any = None,
    axis: str = "sp",
    kv_mask: typ.Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """softmax(QKᵀ/√d)·V over the whole sequence, from this rank's blocks:
    q, k, v `[B, T/W, H, Dh]` and `kv_mask` `[B, T/W]` (True = attend; None:
    all). Returns this rank's block of the output, `[B, T/W, H, Dh]` in
    q's dtype. Every rank of the axis must call it with blocks of one shape."""
    group = axis_group_of(mesh, axis, "a ring")
    steps = axis_size(mesh, axis)
    b, tq, h, dh = q.shape
    tk = k.shape[1]
    if kv_mask is None:
        kv_mask = torch.ones((b, tk), dtype=torch.bool, device=k.device)
    qf = q.to(torch.float32) * dh**-0.5
    neg = torch.finfo(torch.float32).min
    acc = torch.zeros((b, tq, h, dh), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, tq), float("-inf"), dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, tq), dtype=torch.float32, device=q.device)
    width = h * dh
    packed = torch.cat([k.to(torch.float32).reshape(b, tk, width), v.to(torch.float32).reshape(b, tk, width),
                        kv_mask.to(torch.float32)[..., None]], dim=-1)
    for step in range(steps):
        if step:
            packed = ppermute(packed, group, 1)
        k_c = packed[..., :width].reshape(b, tk, h, dh)
        v_c = packed[..., width : 2 * width].reshape(b, tk, h, dh)
        s = torch.einsum("bqhd,bkhd->bhqk", qf, k_c)
        s = torch.where(packed[..., -1][:, None, None, :] > 0.5, s, neg)
        m_new = torch.maximum(m, s.amax(dim=-1)).detach()  # >= neg: always finite
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)  # first step: exp(-inf) = 0
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr.permute(0, 2, 1)[..., None] + torch.einsum("bhqk,bkhd->bqhd", p, v_c)
        m = m_new
    return (acc / torch.clamp(l.permute(0, 2, 1)[..., None], min=1e-30)).to(q.dtype)


def sp_encoder_forward(
    model: torch.nn.Module,
    input_ids: torch.Tensor,
    attention_mask: torch.Tensor,
    *,
    mesh: typ.Any = None,
    axis: str = "sp",
) -> torch.Tensor:
    """`TransformerEncoder.forward` with each attention a `ring_attention`
    over `axis`. `input_ids` and `attention_mask` are the whole `[B, T]` on
    every rank; returns this rank's block of the last hidden states,
    `[B, T/W, H]` in `cfg.dtype` (positions `[r·T/W, (r+1)·T/W)`)."""
    from vod_tpu_torch.models.encoder import _dense, _gelu

    cfg = model.cfg
    if cfg.moe_experts > 0 or cfg.lora_rank > 0:
        raise ValueError(
            "sp_encoder_forward reproduces the dense FFN layout only; moe_experts/lora_rank configs are not supported"
        )
    axis_group_of(mesh, axis, "a ring")
    w, r = axis_size(mesh, axis), axis_index(mesh, axis)
    b, t = input_ids.shape
    if t % w:
        raise ValueError(f"sequence length {t} does not shard over {axis}={w}")
    per = t // w
    dt = cfg.dtype
    emb = model.embeddings
    ids = input_ids[:, r * per : (r + 1) * per]
    pos = torch.arange(r * per, (r + 1) * per, device=ids.device)
    h = emb.word_embeddings(ids).to(dt) + emb.position_embeddings(pos).to(dt)[None]
    if emb.token_type_embeddings is not None:
        h = h + emb.token_type_embeddings(torch.zeros_like(ids)).to(dt)
    h = emb.LayerNorm(h)
    kv_mask = attention_mask[:, r * per : (r + 1) * per] > 0
    depth = cfg.hidden_size // cfg.num_heads
    for layer in model.layers:
        att = layer.attention
        q, k, v = (_dense(h, lin, dt).view(b, per, -1, depth) for lin in (att.query, att.key, att.value))
        o = ring_attention(q, k, v, mesh=mesh, axis=axis, kv_mask=kv_mask)
        h = layer.attention_norm(h + _dense(o.reshape(b, per, -1), att.out, dt))
        h = layer.output_norm(h + _dense(_gelu(_dense(h, layer.intermediate, dt)), layer.output, dt))
    return h
