"""Late-interaction (ColBERT MaxSim) reranking engine (port of
`vod_tpu/search/maxsim.py`).

One embedding per token, scored

    maxsim(q, d) = sum_i  max_j  <q_i, d_j>

over static `[N, Lt, R]` token rectangles with a validity mask, stored int8
(a symmetric scale per dimension) or as floats, optionally projected onto
the top PCA directions first (`ops/pq.py:train_projection`). The rerank is a
second stage over any first-stage engine (`maxsim_search`).

The int8 interaction is exact: the codec scale folds into row-quantized
query tokens, and the int8 x int8 products are summed in float32 with TF32
off, exact while 127² · R < 2^24 (float64 beyond), where JAX accumulates in
int32. Scales divide by a tensor, never by a Python scalar, which CUDA
turns into a product with the reciprocal; the sum over query tokens runs
left to right. So a score is the same on the card, the CPU and in JAX.
Docs with no real token score 0, not -inf.
"""

from __future__ import annotations

import dataclasses
import typing as typ

import torch
import torch.nn.functional as F

from vod_tpu_torch.ops.mips import set_full_f32_matmul
from vod_tpu_torch.ops.numpy_ops import topk_lowest_first
from vod_tpu_torch.types.retrieval import RetrievalBatch
from .base import SearchQueries


@dataclasses.dataclass
class MaxSimIndex:
    """Token-level embedding store in the original row-id space."""

    token_codes: torch.Tensor  # [N, Lt, R] int8 (or f32/bf16 when scale is None)
    token_mask: torch.Tensor  # [N, Lt] bool, True = real token
    scale: typ.Optional[torch.Tensor] = None  # [1, R] f32 for the int8 codec
    proj: typ.Optional[torch.Tensor] = None  # [D, R] truncated PCA (None = identity)
    n_real: int = 0
    offset: int = 0


def build_maxsim_index(
    token_embeddings: torch.Tensor,  # [N, Lt, D] f32
    token_mask: torch.Tensor,  # [N, Lt] bool/int
    *,
    codec: str = "int8",
    proj_dim: typ.Optional[int] = None,
    train_size: int = 262_144,
    offset: int = 0,
) -> MaxSimIndex:
    """Quantize per-token embeddings into a MaxSim store, on their device.
    `proj_dim` projects the tokens onto the top PCA directions of a sample of
    real tokens first; masked token slots are zeroed."""
    from vod_tpu_torch.ops import pq as pq_ops

    n, lt, d = token_embeddings.shape
    x = token_embeddings.to(torch.float32)
    mask = token_mask.to(torch.bool)
    proj = None
    if proj_dim is not None and proj_dim < d:
        flat = x.reshape(n * lt, d)
        # PCA on a sample of real tokens (padding rows would bias the basis)
        order = torch.argsort((~mask.reshape(n * lt)).to(torch.int8), stable=True)
        proj, _mean = pq_ops.train_projection(flat[order[: min(train_size, n * lt)]], proj_dim)
        set_full_f32_matmul()
        x = x @ proj
    x = torch.where(mask[..., None], x, torch.zeros((), device=x.device))
    if codec == "int8":
        absmax = torch.amax(torch.abs(x.reshape(-1, x.shape[-1])), dim=0, keepdim=True)
        scale = torch.clamp(absmax, min=1e-8) / torch.full_like(absmax, 127.0)
        codes = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
        return MaxSimIndex(token_codes=codes, token_mask=mask, scale=scale, proj=proj, n_real=n, offset=offset)
    if codec in ("bfloat16", "float32"):
        return MaxSimIndex(token_codes=x.to(getattr(torch, codec)), token_mask=mask, proj=proj, n_real=n,
                           offset=offset)
    raise ValueError(f"unknown maxsim codec {codec!r}")


def quantize_query_tokens(q: torch.Tensor, scale: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Fold the codec scale into the (projected) query tokens `[B, Lq, R]` and
    quantize each token row: (codes int8, row scale `[B, Lq, 1]` f32)."""
    qf = q * scale
    absmax = torch.amax(torch.abs(qf), dim=-1, keepdim=True)
    q_row = torch.clamp(absmax, min=1e-8) / torch.full_like(absmax, 127.0)
    return torch.clamp(torch.round(qf / q_row), -127, 127).to(torch.int8), q_row


def int8_interaction(q_i8: torch.Tensor, d_codes: torch.Tensor, pattern: str) -> torch.Tensor:
    """The exact integer products of int8 query and doc tokens under the
    einsum `pattern`, as f32: summed in f32 with TF32 off while 127² · R <
    2^24 (every partial sum is an integer below 2^24), else in f64."""
    set_full_f32_matmul()
    dt = torch.float32 if 127 * 127 * int(q_i8.shape[-1]) < 2**24 else torch.float64
    return torch.einsum(pattern, q_i8.to(dt), d_codes.to(dt)).to(torch.float32)


def sum_query_tokens(best: torch.Tensor, qm: torch.Tensor) -> torch.Tensor:
    """Sum `best` `[..., Lq]` over the real query tokens, left to right (the
    same f32 result on every device)."""
    acc = torch.zeros(best.shape[:-1], dtype=best.dtype, device=best.device)
    for i in range(best.shape[-1]):
        acc = acc + torch.where(qm[..., i], best[..., i], torch.zeros((), device=best.device))
    return acc


def _score_gathered(
    d_codes: torch.Tensor,  # [B, C, Lt, R]
    d_mask: torch.Tensor,  # [B, C, Lt]
    q: torch.Tensor,  # [B, Lq, R] f32 (already projected)
    qm: torch.Tensor,  # [B, Lq] bool
    scale: typ.Optional[torch.Tensor],
) -> torch.Tensor:
    """Sum-max interaction scores `[B, C]` of gathered candidate token blocks."""
    if scale is not None:
        q_i8, q_row = quantize_query_tokens(q, scale)
        inter = int8_interaction(q_i8, d_codes, "bqr,bctr->bcqt") * q_row[:, None, :, :]
    else:
        set_full_f32_matmul()
        inter = torch.einsum("bqr,bctr->bcqt", q.to(d_codes.dtype), d_codes).to(torch.float32)
    inter = torch.where(d_mask[:, :, None, :], inter, torch.finfo(torch.float32).min)
    best = torch.amax(inter, dim=-1)  # [B, C, Lq]
    # docs with zero real tokens contribute 0, not -inf * Lq
    best = torch.where(torch.any(d_mask, dim=-1)[:, :, None], best, torch.zeros((), device=best.device))
    return sum_query_tokens(best, qm[:, None, :])


def maxsim_rerank(
    index: MaxSimIndex,
    query_tokens: torch.Tensor,  # [B, Lq, D] f32
    query_mask: torch.Tensor,  # [B, Lq] bool/int
    candidate_ids: torch.Tensor,  # [B, C] int row ids (-1 = padding)
) -> torch.Tensor:
    """MaxSim scores `[B, C]` of each candidate; `-inf` for `-1` padding."""
    q = query_tokens.to(torch.float32)
    if index.proj is not None:
        set_full_f32_matmul()
        q = q @ index.proj
    local = torch.clamp(candidate_ids.long() - index.offset, 0, index.n_real - 1)
    scores = _score_gathered(index.token_codes[local], index.token_mask[local], q, query_mask.to(torch.bool),
                             index.scale)
    return torch.where(candidate_ids >= 0, scores, float("-inf"))


def maxsim_search(
    first_stage: typ.Callable[[SearchQueries, int], RetrievalBatch],
    index: MaxSimIndex,
    queries: SearchQueries,
    query_tokens: torch.Tensor,
    query_mask: torch.Tensor,
    top_k: int,
    *,
    n_candidates: typ.Optional[int] = None,
) -> RetrievalBatch:
    """Two-stage late-interaction search: `first_stage(queries, k)` (any
    engine's search) proposes `n_candidates` (default 4 * top_k), MaxSim
    re-scores them, and the final order is the MaxSim order."""
    cand = first_stage(queries, n_candidates or 4 * top_k)
    scores = maxsim_rerank(index, query_tokens, query_mask, cand.indices)
    k_eff = min(top_k, int(scores.shape[-1]))
    top_s, sel = topk_lowest_first(scores, k_eff)
    top_i = torch.gather(cand.indices, -1, sel)
    if k_eff < top_k:
        top_s = F.pad(top_s, (0, top_k - k_eff), value=float("-inf"))
        top_i = F.pad(top_i, (0, top_k - k_eff), value=-1)
    ok = torch.isfinite(top_s)
    return RetrievalBatch(scores=torch.where(ok, top_s, float("-inf")), indices=torch.where(ok, top_i, -1))
