"""Dynamic (mutable) dense index: add, delete, update and compact without a
rebuild (port of `vod_tpu/search/dynamic.py`).

The store is allocated at a fixed capacity (rounded up to 128 rows); rows
carry explicit point ids (`ids`, -1 for an empty slot) so deletes, updates
and compaction never change an id handed out earlier; deletes are tombstones
(`alive`), and `dynamic_compact` moves the live rows to the front in their
order, ids kept. An add past capacity drops the rows that do not fit and
reports them as -1, never overwriting live data. An int8 store quantizes
every row with the scale frozen when it was made (from the first corpus in
`dynamic_from_dense`).

Declared differences from the JAX package:
 - the ops update the store's tensors in place and return the index with
   its new counts, as JAX's donated buffers are consumed: keep only the
   returned index;
 - `n_active` and `next_id` are Python ints, where JAX keeps traced scalars
   so that an update never recompiles; an op that needs a count from the
   card (`count` as a tensor, `dynamic_update`'s matches, `dynamic_compact`)
   reads it once;
 - deletes and updates match ids by sorting (`torch.isin`, `searchsorted`)
   where JAX compares every id with every slot (`[K, C]`), which does not
   fit at a million slots; the result is the same (an update writes the
   first live slot holding the id);
 - `dynamic_search` selects exactly (the declared difference of every flat
   scan of the port: `approx_max_k` is TPU hardware), so the store has no
   `approx_recall`, and it scans only the slots ever written, the rest
   being dead.
"""

from __future__ import annotations

import dataclasses
import typing as typ

import torch

from vod_tpu_torch.ops import pq as pq_ops
from vod_tpu_torch.ops.mips import set_full_f32_matmul
from vod_tpu_torch.types.retrieval import RetrievalBatch
from .base import SearchQueries
from .dense import _int8_dot, _scan_topk, quantize_queries_int8


@dataclasses.dataclass
class DynamicDenseIndex:
    vectors: torch.Tensor  # [C, D] f32/bf16, or int8 codes (frozen scale)
    ids: torch.Tensor  # [C] int32 point ids, -1 = empty slot
    alive: torch.Tensor  # [C] bool
    subset_ids: torch.Tensor  # [C] int32, -1 = none
    n_active: int = 0  # high-water mark: slots ever written
    next_id: int = 0  # the next auto-assigned id
    scale: typ.Optional[torch.Tensor] = None  # [1, D] f32 when int8
    capacity: int = 0

    @property
    def n_alive(self) -> torch.Tensor:
        return torch.sum(self.alive.to(torch.int32))

    def replace(self, **changes: typ.Any) -> "DynamicDenseIndex":
        return dataclasses.replace(self, **changes)


def dynamic_index_init(
    capacity: int,
    dim: int,
    *,
    dtype: str = "bfloat16",
    scale: typ.Optional[torch.Tensor] = None,
    start_id: int = 0,
    device: typ.Union[str, torch.device] = "cuda",
) -> DynamicDenseIndex:
    """An empty store on `device`. dtype "int8" needs `scale` (`[1, D]` f32,
    e.g. from `ops.pq.quantize_int8` of a representative sample), frozen for
    the store's lifetime."""
    capacity = -(-capacity // 128) * 128
    if dtype == "int8":
        if scale is None:
            raise ValueError("int8 dynamic index requires a frozen quantization scale")
        vectors = torch.zeros((capacity, dim), dtype=torch.int8, device=device)
        scale = scale.to(device=device, dtype=torch.float32)
    else:
        vectors = torch.zeros((capacity, dim), dtype=getattr(torch, dtype), device=device)
        scale = None
    return DynamicDenseIndex(
        vectors=vectors,
        ids=torch.full((capacity,), -1, dtype=torch.int32, device=device),
        alive=torch.zeros((capacity,), dtype=torch.bool, device=device),
        subset_ids=torch.full((capacity,), -1, dtype=torch.int32, device=device),
        n_active=0,
        next_id=start_id,
        scale=scale,
        capacity=capacity,
    )


def dynamic_from_dense(
    vectors: torch.Tensor,
    capacity: int,
    *,
    dtype: str = "bfloat16",
    subset_ids: typ.Optional[torch.Tensor] = None,
    start_id: int = 0,
) -> DynamicDenseIndex:
    """A mutable store on `vectors`' device, filled with them (ids = start_id
    + row); an int8 scale is frozen from these vectors."""
    scale = None
    if dtype == "int8":
        _, scale = pq_ops.quantize_int8(vectors.to(torch.float32), dim=0)
    index = dynamic_index_init(capacity, int(vectors.shape[-1]), dtype=dtype, scale=scale, start_id=start_id,
                               device=vectors.device)
    index, _ = dynamic_add(index, vectors, subset_ids=subset_ids)
    return index


def _encode_rows(index: DynamicDenseIndex, vectors: torch.Tensor) -> torch.Tensor:
    if index.scale is not None:
        q = vectors.to(torch.float32) / torch.clamp(index.scale, min=1e-12)
        return torch.clamp(torch.round(q), -127, 127).to(torch.int8)
    return vectors.to(index.vectors.dtype)


def dynamic_add(
    index: DynamicDenseIndex,
    vectors: torch.Tensor,  # [M, D]
    *,
    ids: typ.Optional[torch.Tensor] = None,  # [M] int32; None = auto-assign
    subset_ids: typ.Optional[torch.Tensor] = None,  # [M] int32
    count: typ.Optional[typ.Union[int, torch.Tensor]] = None,  # valid rows (<= M); None = all M
) -> tuple[DynamicDenseIndex, torch.Tensor]:
    """Append the first `count` rows. Returns (the index, the assigned ids
    `[M]`: -1 where a row was past `count` or dropped for capacity). Rows
    beyond capacity are dropped, never written over live data; auto-assigned
    ids advance by `count` either way, as in JAX."""
    m = int(vectors.shape[0])
    device = index.vectors.device
    n_valid = m if count is None else min(m, int(count))
    n_write = max(0, min(n_valid, index.capacity - index.n_active))
    lane = torch.arange(m, dtype=torch.int32, device=device)
    new_ids = ids.to(device=device, dtype=torch.int32) if ids is not None else index.next_id + lane
    assigned = torch.where(lane < n_write, new_ids, -1)
    s0, s1 = index.n_active, index.n_active + n_write
    index.vectors[s0:s1] = _encode_rows(index, vectors[:n_write].to(device))
    index.ids[s0:s1] = new_ids[:n_write]
    index.alive[s0:s1] = True
    index.subset_ids[s0:s1] = -1 if subset_ids is None else subset_ids[:n_write].to(device=device, dtype=torch.int32)
    return index.replace(n_active=s1, next_id=index.next_id + (0 if ids is not None else n_valid)), assigned


def dynamic_delete(index: DynamicDenseIndex, ids: torch.Tensor) -> DynamicDenseIndex:
    """Tombstone the given point ids (`[K]` int32, negative = padding).
    Unknown ids are ignored."""
    ids = torch.as_tensor(ids, dtype=torch.int32, device=index.ids.device)
    hit = torch.isin(index.ids, ids) & (index.ids >= 0)  # a negative query id is padding, never a hit
    index.alive &= ~hit
    return index


def dynamic_update(
    index: DynamicDenseIndex,
    ids: torch.Tensor,  # [K] int32 (negative = padding)
    vectors: torch.Tensor,  # [K, D]
    *,
    subset_ids: typ.Optional[torch.Tensor] = None,
) -> tuple[DynamicDenseIndex, torch.Tensor]:
    """Overwrite live points in place by id. Returns (index, found `[K]`);
    missing ids are ignored (insert them with `dynamic_add`)."""
    device = index.ids.device
    ids = torch.as_tensor(ids, dtype=torch.int32, device=device)
    # the first live slot of each id: live slots sorted by id, lowest slot first among equals
    key = torch.where(index.alive, index.ids.to(torch.int64), torch.iinfo(torch.int64).max)
    sorted_key, order = torch.sort(key, stable=True)
    at = torch.clamp(torch.searchsorted(sorted_key, ids.to(torch.int64)), max=index.capacity - 1)
    found = (sorted_key[at] == ids) & (ids >= 0)
    sel = found.nonzero().squeeze(-1)
    pos = order[at[sel]]
    index.vectors[pos] = _encode_rows(index, vectors.to(device)[sel])
    if subset_ids is not None:
        index.subset_ids[pos] = torch.as_tensor(subset_ids, device=device).to(torch.int32)[sel]
    return index, found


def dynamic_compact(index: DynamicDenseIndex) -> DynamicDenseIndex:
    """Move the live rows to the front in their order, reclaiming tombstoned
    slots. Point ids are kept, so searches before and after agree."""
    order = torch.argsort((~index.alive).to(torch.int8), stable=True)
    return index.replace(
        vectors=index.vectors[order],
        ids=index.ids[order],
        alive=index.alive[order],
        subset_ids=index.subset_ids[order],
        n_active=int(index.n_alive),
    )


def dynamic_search(
    index: DynamicDenseIndex,
    queries: SearchQueries,
    top_k: int,
    *,
    chunk: int = 131072,
) -> RetrievalBatch:
    """Exhaustive MIPS over the live rows; returns point ids (not slots) with
    the usual `-inf` / `-1` padding, lowest slot first among equal scores."""
    q = queries.vector
    if q is None:
        raise ValueError("dynamic_search requires queries.vector")
    b = int(q.shape[0])
    device = index.vectors.device
    n = index.capacity
    chunk = min(chunk, n)
    while n % chunk != 0:
        chunk -= 128
    n_scan = -(-max(index.n_active, 1) // chunk) * chunk  # slots past n_active were never written
    allowed = queries.subset_ids

    if index.scale is not None:
        q_i8, q_row = quantize_queries_int8(q, index.scale)
    else:
        set_full_f32_matmul()
        q_32 = q.to(index.vectors.dtype).to(torch.float32)

    def score_chunk(start: int) -> torch.Tensor:
        v = index.vectors[start : start + chunk]
        s = _int8_dot(q_i8, v) * q_row if index.scale is not None else q_32 @ v.to(torch.float32).T
        s = torch.where(index.alive[start : start + chunk][None, :], s, float("-inf"))
        if allowed is not None:
            sub = index.subset_ids[start : start + chunk]
            ok = (sub[None, None, :] == allowed[:, :, None]).any(dim=1) | (allowed < 0).all(dim=-1, keepdim=True)
            s = torch.where(ok, s, float("-inf"))
        return s

    top_s, top_pos = _scan_topk(score_chunk, n_scan, n_scan, b, top_k, chunk, device)
    ok = torch.isfinite(top_s)
    top_ids = torch.where(ok, index.ids[torch.clamp(top_pos, 0, n - 1).long()], -1)
    return RetrievalBatch(scores=torch.where(ok, top_s, float("-inf")), indices=top_ids)
