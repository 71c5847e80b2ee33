"""Sharded search over the ranks of a mesh axis (port of
`vod_tpu/search/sharded.py`: dense, BM25, PQ, IVF, IVF-PQ and MaxSim).

Each rank holds one shard and searches it; local ids are offset into the
global id space, and one gather of k (score, id) pairs a shard over the
axis's process group feeds the global top-k, so the merge never moves score
matrices. The merge takes the lowest-first top-k over `[shard 0's k | shard
1's k | ...]`, as `lax.top_k` does: among equal scores the lower shard, and so
the lower global id, wins. Ids are -1 where the score is not finite.

Dense (`ShardedDenseIndex`): the rows are split into contiguous blocks of
`rows_per_shard`, padded so every shard's count is a multiple of 128 (1024
for `kernel="fused"`, the kernel's row tile). The int8 codec's column scale
is the whole corpus's: each rank takes the absmax of its block and the axis
all-reduces the maximum. The scan honours subset ids and per-query
`corpus_shard` routing; `kernel="fused"` (with neither and `approx_recall`
set) runs `fused_mips_binned` on each shard, with the shard's count of real
rows, `clip(n_real - rank * rows, 0, rows)`, computed on the host, and the
queries padded to a multiple of 16; a shard made only of padding returns
-inf / -1. It has no exact-f32 re-rank, as in JAX.

BM25 (`ShardedSparseIndex`): each rank keeps the postings of a contiguous doc
range of one globally built table, so idf, average length and truncation
stay global and the sharded answer equals the unsharded one. Doc ids stay
global.

PQ (`ShardedPQIndex`): the rows of a built `PQIndex` in contiguous blocks
(`rows_per_shard`, a multiple of 128), codebooks and projections on every
rank. Each shard runs the two-stage search of JAX's sharded PQ on its rows:
exhaustive ADC (the int8 one-hot scan under refine), or the int8 coarse
scan (never the fused kernel: JAX's sharded coarse stage is a scan) then the
ADC rescore, or coarse straight to the refine store (`codes=None`); with
refine, the shard's pool of `min(k_factor * k, rows)` is rescored exactly.
The coarse budget a shard is `min(rows, max(128, ceil(n_candidates / S)))`.
Every shard gives its k exact-scored pairs to the merge. Ids carry no
offset, as in JAX (`ShardedPQIndex` has none).

IVF (`ShardedIVFIndex`): the cells, padded to a multiple of S with `row_ids
= -1`, in contiguous blocks; every rank probes the same cells from the
replicated centroids and scores the probed cells it owns; `offset` is added
after the merge.

IVF-PQ (`ShardedIVFPQIndex`): cells go round-robin (`c % S`); each rank
keeps its cells' windows as a window layout of its own (`win_start` /
`win_count` over every cell, zero counts for the cells of other shards),
padded to the largest shard's slot count, and runs `ivfpq_search` on it for
a pool of `k_factor * k` (with a rerank store) or k; a spilled index
gathers twice the pool and drops the second copy of a row after the merge;
the rerank, on the store every rank holds, runs once after the merge.
`win_start`, `win_count` and `row_ids` are JAX's slice for the shard, bit
for bit.

MaxSim (`ShardedMaxSimIndex`): the token store in contiguous row blocks;
each rank scores the candidates it owns, -inf for the others, and an
`all_reduce` (MAX) over the axis gives exactly `maxsim_rerank`'s scores.

The compressed indexes are sharded from one built index, the same on every
rank: `same_on_every_rank` gives every rank the axis's rank 0's copy first
(the factory does so), since two builds on the card may differ by the order
of their float sums.

Queries: JAX is one controller and hands every shard the whole query batch.
Here each rank passes its queries; `batch_axis` names the mesh axis the
batch's rows are split over. When it is the index's axis (a batch split over
`dp` searching an index sharded over `dp`), the ranks first gather the
queries over the axis, search their shards for every row, merge, and keep
their own rows. Otherwise the ranks of one shard group hold the same rows.
Every shape a rank gathers (k, the PQ pools, the IVF-PQ pool) follows from
the shared `rows_per_shard` / `slots_per_shard`, never from a rank's own
count of real rows, so a shard of padding only gathers as the others do.

Declared difference: the per-shard selection is exact (`approx_recall` only
gates the fused kernel of the dense shard, and the PQ candidate shares), as
in the port's unsharded scans.
"""

from __future__ import annotations

import dataclasses
import typing as typ

import numpy as np
import torch
import torch.distributed as dist

from vod_tpu_torch.ops import pq as pq_ops
from vod_tpu_torch.ops.mips import fused_mips_binned, set_full_f32_matmul
from vod_tpu_torch.ops.numpy_ops import topk_lowest_first
from vod_tpu_torch.parallel.distributed import all_gather_tensor, all_reduce_, global_rank
from vod_tpu_torch.parallel.mesh import axis_group, axis_index, axis_size
from vod_tpu_torch.types.retrieval import RetrievalBatch
from .base import SearchQueries
from .dense import (
    IVFIndex,
    PQIndex,
    _int8_adc_scan_inputs,
    _int8_dot,
    _int8_onehot_adc_chunk,
    _refine_rerank,
    _scan_collect_topk,
    _scan_topk,
    _unpack_codes4,
    _zero_cols,
    decode_rows,
    quantize_queries_int8,
)
from .ivfpq import IVFPQIndex, _dedup_equal_rows, ivfpq_search, rerank_candidates
from .maxsim import MaxSimIndex, _score_gathered
from .sparse import SparseIndex, bm25_topk


class _RowBlocks:
    """A shard of contiguous `rows_per_shard` rows of an `n_real`-row index."""

    n_real: int
    rows_per_shard: int
    axis: str
    mesh: typ.Any

    @property
    def shard(self) -> int:
        return axis_index(self.mesh, self.axis)

    @property
    def local_real(self) -> int:
        """This shard's real rows (padding lives on the last shards)."""
        return int(min(max(self.n_real - self.shard * self.rows_per_shard, 0), self.rows_per_shard))


@dataclasses.dataclass
class ShardedDenseIndex(_RowBlocks):
    """This rank's shard of a flat (bf16/f32) or int8 dense index."""

    vectors: torch.Tensor  # [rows_per_shard, D] this shard's rows
    scale: typ.Optional[torch.Tensor] = None  # [1, D] f32, the whole corpus's (int8 codec)
    subset_ids: typ.Optional[torch.Tensor] = None  # [rows_per_shard] int32
    corpus_shard: typ.Optional[torch.Tensor] = None  # [rows_per_shard] int32 corpus id per row (routing)
    n_real: int = 0  # real rows of the whole corpus
    rows_per_shard: int = 0
    axis: str = "shard"
    mesh: typ.Any = None
    approx_recall: typ.Optional[float] = 0.95
    kernel: str = "scan"  # "scan" | "fused"


def _axis_size(mesh: typ.Any, axis: str) -> int:
    """The size of the mesh's `axis`; raises when the mesh has no such axis."""
    if axis not in (getattr(mesh, "mesh_dim_names", None) or ()):
        raise ValueError(f"mesh axes {list(getattr(mesh, 'mesh_dim_names', None) or ())} have no {axis!r}")
    return axis_size(mesh, axis)


def _local_block(x: typ.Any, lo: int, hi: int, rows: int, device: torch.device, dtype: typ.Any = None) -> torch.Tensor:
    """Rows [lo, hi) of `x` (tensor or array) on `device`, zero-padded to `rows`."""
    n = int(x.shape[0])
    part = x[min(lo, n) : min(hi, n)]
    t = torch.as_tensor(np.ascontiguousarray(part) if isinstance(part, np.ndarray) else part, device=device)
    if dtype is not None:
        t = t.to(dtype)
    if t.shape[0] < rows:
        t = torch.cat([t, t.new_zeros((rows - t.shape[0],) + tuple(t.shape[1:]))])
    return t


def build_sharded_dense_index(
    vectors: typ.Union[torch.Tensor, np.ndarray],
    mesh: typ.Any,
    *,
    axis: str = "shard",
    dtype: str = "bfloat16",
    subset_ids: typ.Union[torch.Tensor, np.ndarray, None] = None,
    corpus_shard: typ.Union[torch.Tensor, np.ndarray, None] = None,
    approx_recall: typ.Optional[float] = 0.95,
    kernel: str = "scan",
    device: typ.Union[str, torch.device, None] = None,
) -> ShardedDenseIndex:
    """This rank's shard of the corpus `vectors` [N, D] (the same global
    matrix on every rank of the axis; only this rank's block is moved to
    `device`, default the vectors' device, a numpy matrix's "cuda")."""
    if kernel not in ("scan", "fused"):
        raise ValueError(f"kernel must be 'scan' or 'fused', got {kernel!r}")
    if device is None:
        device = vectors.device if isinstance(vectors, torch.Tensor) else "cuda"
    device = torch.device(device)
    n_shards = _axis_size(mesh, axis)
    n_real = int(vectors.shape[0])
    mult = n_shards * (1024 if kernel == "fused" else 128)
    rows = -(-n_real // mult) * mult // n_shards
    me = axis_index(mesh, axis)
    lo, hi = me * rows, (me + 1) * rows
    block = _local_block(vectors, lo, hi, rows, device, torch.float32 if dtype == "int8" else None)
    scale = None
    if dtype == "int8":
        # the column scale of the whole corpus: every block's absmax, max-reduced
        absmax = torch.amax(torch.abs(block), dim=0, keepdim=True)
        all_reduce_(absmax, op=dist.ReduceOp.MAX, group=axis_group(mesh, axis))
        scale = torch.clamp(absmax, min=1e-8) / torch.full_like(absmax, 127.0)
        block = torch.clamp(torch.round(block / scale), -127, 127).to(torch.int8)
    elif dtype in ("bfloat16", "float32"):
        block = block.to(getattr(torch, dtype))
    else:
        raise ValueError(f"dtype must be 'float32', 'bfloat16' or 'int8', got {dtype!r}")

    def shard_1d(x: typ.Any) -> typ.Optional[torch.Tensor]:
        return None if x is None else _local_block(x, lo, hi, rows, device, torch.int32)

    return ShardedDenseIndex(
        vectors=block.contiguous(), scale=scale, subset_ids=shard_1d(subset_ids),
        corpus_shard=shard_1d(corpus_shard), n_real=n_real, rows_per_shard=rows, axis=axis, mesh=mesh,
        approx_recall=approx_recall, kernel=kernel,
    )


def merge_across_shards(
    top_s: torch.Tensor, top_i: torch.Tensor, group: typ.Any, keep: typ.Optional[int] = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Gather k (score, global id) pairs from every shard of `group` and take
    the global top-`keep` (default k), lowest position first on ties; id -1
    where the score is not finite."""
    b, k = top_s.shape
    all_s = all_gather_tensor(top_s.to(torch.float32).contiguous(), group)  # [S, B, k]
    all_i = all_gather_tensor(top_i.to(torch.int32).contiguous(), group)
    all_s = all_s.permute(1, 0, 2).reshape(b, -1)
    all_i = all_i.permute(1, 0, 2).reshape(b, -1)
    out_s, pos = topk_lowest_first(all_s, min(keep or k, int(all_s.shape[-1])))
    out_i = torch.gather(all_i, -1, pos)
    return out_s, torch.where(torch.isfinite(out_s), out_i, -1)


def _gather_rows(x: typ.Optional[torch.Tensor], group: typ.Any) -> typ.Optional[torch.Tensor]:
    """The axis's rows of `x`, in rank order (every rank's block the same size)."""
    if x is None:
        return None
    every = all_gather_tensor(x.contiguous(), group)
    return every.reshape((-1,) + tuple(x.shape[1:]))


def _global_queries(
    queries: SearchQueries, group: typ.Any, gather: bool
) -> tuple[SearchQueries, typ.Optional[slice]]:
    """The queries every shard must answer, and this rank's rows of them
    (None: all of them)."""
    if not gather:
        return queries, None
    b = int(next(v for v in (queries.vector, queries.terms) if v is not None).shape[0])
    me = dist.get_rank(group)
    q = SearchQueries(**{f.name: _gather_rows(getattr(queries, f.name), group) for f in dataclasses.fields(queries)})
    return q, slice(me * b, (me + 1) * b)


def sharded_dense_search(
    index: ShardedDenseIndex,
    queries: SearchQueries,
    top_k: int,
    *,
    chunk: int = 131072,
    batch_axis: typ.Optional[str] = None,
) -> RetrievalBatch:
    """Each shard's top-k (scan or fused kernel), then the merge over the
    index's axis. `batch_axis`: the mesh axis the query rows are split over
    (see the module's docstring)."""
    if queries.vector is None:
        raise ValueError("dense_search requires queries.vector")
    group = axis_group(index.mesh, index.axis)
    queries, mine = _global_queries(queries, group, batch_axis == index.axis and axis_size(index.mesh, index.axis) > 1)
    rows = index.rows_per_shard
    g_offset = index.shard * rows
    local_real = index.local_real
    q = queries.vector
    b = int(q.shape[0])
    allow, route = queries.subset_ids, queries.shard
    q_row_scale = None
    if index.scale is not None:
        q_eff, q_row_scale = quantize_queries_int8(q, index.scale)
    else:
        q_eff = q.to(index.vectors.dtype)

    if index.kernel == "fused" and allow is None and route is None and index.approx_recall is not None:
        qk = q_eff.contiguous()
        b_pad = (-b) % 16
        if b_pad:
            qk = torch.cat([qk, qk.new_zeros((b_pad, int(qk.shape[1])))])
        top_s, top_i = fused_mips_binned(index.vectors, qk, k=top_k, n_real=local_real)
        top_s, top_i = top_s[:b], top_i[:b]
        if q_row_scale is not None:
            top_s = torch.where(top_i >= 0, top_s.to(torch.float32) * q_row_scale, float("-inf"))
    else:
        chunk = min(chunk, rows)
        while rows % chunk != 0:
            chunk -= 128
        set_full_f32_matmul()
        compute = torch.float64 if q_row_scale is not None else torch.float32
        q_c = q_eff.to(compute)

        def score_chunk(start: int) -> torch.Tensor:
            v = index.vectors[start : start + chunk].to(compute)
            s = (q_c @ v.T).to(torch.float32)  # int8 products summed in float64 are exact
            if q_row_scale is not None:
                s = s * q_row_scale
            if allow is not None and index.subset_ids is not None:
                sb = index.subset_ids[start : start + chunk]
                ok = (sb[None, None, :] == allow[:, :, None]).any(dim=1) | (allow < 0).all(dim=-1, keepdim=True)
                s = torch.where(ok, s, float("-inf"))
            if route is not None and index.corpus_shard is not None:
                # multi-corpus routing: a row is visible only to queries that target its corpus
                cs = index.corpus_shard[start : start + chunk]
                s = torch.where((route[:, None] < 0) | (cs[None, :] == route[:, None]), s, float("-inf"))
            return s

        top_s, top_i = _scan_topk(score_chunk, rows, local_real, b, top_k, chunk, index.vectors.device)
    top_i = torch.where(top_i >= 0, top_i + g_offset, -1)
    out_s, out_i = merge_across_shards(top_s, top_i, group)
    if mine is not None:
        out_s, out_i = out_s[mine], out_i[mine]
    return RetrievalBatch(scores=out_s, indices=out_i.to(torch.int32))


# ---- BM25 ---------------------------------------------------------------------


@dataclasses.dataclass
class ShardedSparseIndex:
    """This rank's doc range of a BM25 impact table (global doc ids)."""

    postings_docs: torch.Tensor  # [T, P_s] int32 global doc ids of this range, -1 padding
    postings_impacts: torch.Tensor  # [T, P_s] f32
    subset_ids: typ.Optional[torch.Tensor] = None  # [N] int32, replicated (read by global doc id)
    n_docs: int = 0
    offset: int = 0
    axis: str = "shard"
    mesh: typ.Any = None


def shard_sparse_index(
    index: SparseIndex,
    mesh: typ.Any,
    *,
    axis: str = "shard",
    device: typ.Union[str, torch.device, None] = None,
) -> ShardedSparseIndex:
    """This rank's part of a globally built `SparseIndex` (the same on every
    rank): each term's postings of the rank's contiguous doc range, moved to
    the front in their order (a stable sort on "outside the range"), cut to
    the widest range's count over all shards, as JAX stacks them."""
    device = torch.device(device) if device is not None else index.postings_docs.device
    n_shards = axis_size(mesh, axis)
    docs = index.postings_docs.cpu().numpy()
    imps = index.postings_impacts.cpu().numpy()
    n_docs = index.n_docs
    per = -(-n_docs // n_shards)
    owner = np.where(docs >= 0, docs // max(per, 1), -1)
    width = max(1, max(int((owner == s).sum(axis=1).max(initial=0)) for s in range(n_shards)))
    me = axis_index(mesh, axis)
    mask = owner == me
    order = np.argsort(~mask, axis=1, kind="stable")  # in-range first
    d = np.where(np.take_along_axis(mask, order, axis=1), np.take_along_axis(docs, order, axis=1), -1)
    i = np.where(np.take_along_axis(mask, order, axis=1), np.take_along_axis(imps, order, axis=1), 0.0)
    return ShardedSparseIndex(
        postings_docs=torch.as_tensor(np.ascontiguousarray(d[:, :width]), device=device),
        postings_impacts=torch.as_tensor(np.ascontiguousarray(i[:, :width]).astype(np.float32), device=device),
        subset_ids=None if index.subset_ids is None else index.subset_ids.to(device),
        n_docs=n_docs, offset=index.offset, axis=axis, mesh=mesh,
    )


def sharded_sparse_search(
    index: ShardedSparseIndex,
    queries: SearchQueries,
    top_k: int,
    *,
    batch_axis: typ.Optional[str] = None,
) -> RetrievalBatch:
    """Each rank scores its doc range's postings, then the merge over the
    axis; `batch_axis` as in `sharded_dense_search`."""
    if queries.terms is None:
        raise ValueError("sparse_search requires queries.terms")
    group = axis_group(index.mesh, index.axis)
    queries, mine = _global_queries(queries, group, batch_axis == index.axis and axis_size(index.mesh, index.axis) > 1)
    loc_s, loc_d = bm25_topk(
        index.postings_docs, index.postings_impacts, queries.terms, queries.term_weights, top_k,
        doc_subset_ids=index.subset_ids, query_subset_ids=queries.subset_ids,
    )
    loc_d = torch.where(torch.isfinite(loc_s), loc_d, -1)
    out_s, out_d = merge_across_shards(loc_s, loc_d, group)
    if mine is not None:
        out_s, out_d = out_s[mine], out_d[mine]
    ok = torch.isfinite(out_s)
    return RetrievalBatch(
        scores=torch.where(ok, out_s, float("-inf")), indices=torch.where(ok, out_d + index.offset, -1).to(torch.int32)
    )


# ---- one index on every rank --------------------------------------------------

_BCAST_BYTES = 1 << 28


def same_on_every_rank(index: typ.Any, group: typ.Any) -> typ.Any:
    """`index` with every tensor overwritten, in place, by the group's rank
    0's (broadcasts of its bytes, 256 MiB at a time): ranks that each built
    the index then shard one index."""
    if not dist.is_initialized() or dist.get_world_size(group) == 1:
        return index
    src = global_rank(group, 0)
    for v in vars(index).values():
        if not isinstance(v, torch.Tensor) or not v.numel():
            continue
        buf = v if v.is_contiguous() else v.contiguous()
        flat = buf.view(-1).view(torch.uint8)
        for s0 in range(0, int(flat.numel()), _BCAST_BYTES):
            dist.broadcast(flat[s0 : s0 + _BCAST_BYTES], src=src, group=group)
        if buf is not v:
            v.copy_(buf)
    return index


def _search_setup(index: typ.Any, queries: SearchQueries, batch_axis: typ.Optional[str]):
    """(group, shards, the queries to answer, this rank's rows of them)."""
    group = axis_group(index.mesh, index.axis)
    shards = axis_size(index.mesh, index.axis)
    queries, mine = _global_queries(queries, group, batch_axis == index.axis and shards > 1)
    return group, shards, queries, mine


def _pad_k(s: torch.Tensor, i: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Scores and ids padded with -inf / -1 to k columns."""
    if s.shape[-1] >= k:
        return s, i
    pad = k - int(s.shape[-1])
    return (torch.nn.functional.pad(s, (0, pad), value=float("-inf")),
            torch.nn.functional.pad(i, (0, pad), value=-1))


def _finish(out_s: torch.Tensor, out_i: torch.Tensor, mine: typ.Optional[slice]) -> RetrievalBatch:
    ok = torch.isfinite(out_s)
    out_s, out_i = torch.where(ok, out_s, float("-inf")), torch.where(ok, out_i, -1)
    if mine is not None:
        out_s, out_i = out_s[mine], out_i[mine]
    return RetrievalBatch(scores=out_s, indices=out_i.to(torch.int32))


# ---- PQ -----------------------------------------------------------------------


@dataclasses.dataclass
class ShardedPQIndex(_RowBlocks):
    """This rank's rows of a PQ index; codebooks and projections whole."""

    codebooks: torch.Tensor  # [M, n_codes, dsub]
    codes: typ.Optional[torch.Tensor]  # [rows_per_shard, M or M//2]; None = direct (coarse -> refine)
    coarse_codes: typ.Optional[torch.Tensor] = None  # [rows_per_shard, dc up to 16s] int8; None = exhaustive
    coarse_scale: typ.Optional[torch.Tensor] = None
    proj: typ.Optional[torch.Tensor] = None
    rotation: typ.Optional[torch.Tensor] = None
    subset_ids: typ.Optional[torch.Tensor] = None  # [rows_per_shard] int32
    corpus_shard: typ.Optional[torch.Tensor] = None  # [rows_per_shard] int32 (routing)
    refine_codes: typ.Optional[torch.Tensor] = None  # [rows_per_shard, R]
    refine_scale: typ.Optional[torch.Tensor] = None
    refine_proj: typ.Optional[torch.Tensor] = None
    n_real: int = 0
    rows_per_shard: int = 0
    axis: str = "shard"
    mesh: typ.Any = None
    n_candidates: int = 1024
    approx_recall: typ.Optional[float] = 0.95
    k_factor: int = 4
    code_bits: int = 8

    def replace(self, **changes: typ.Any) -> "ShardedPQIndex":
        return dataclasses.replace(self, **changes)


def shard_pq_index(
    index: PQIndex,
    mesh: typ.Any,
    *,
    axis: str = "shard",
    corpus_shard: typ.Union[torch.Tensor, np.ndarray, None] = None,
    device: typ.Union[str, torch.device, None] = None,
) -> ShardedPQIndex:
    """This rank's block of a built `PQIndex` (the same on every rank of the
    axis): its first `n_real` rows re-padded so the rows divide into S
    blocks of a multiple of 128, as JAX re-pads them."""
    store = index.codes if index.codes is not None else index.coarse_codes
    device = torch.device(device) if device is not None else store.device
    n_shards = _axis_size(mesh, axis)
    n = index.n_real
    mult = n_shards * 128
    rows = -(-n // mult) * mult // n_shards
    lo = axis_index(mesh, axis) * rows

    def block(x: typ.Any, dtype: typ.Any = None) -> typ.Optional[torch.Tensor]:
        return None if x is None else _local_block(x[:n], lo, lo + rows, rows, device, dtype).contiguous()

    def whole(x: typ.Optional[torch.Tensor]) -> typ.Optional[torch.Tensor]:
        return None if x is None else x.to(device)

    return ShardedPQIndex(
        codebooks=index.codebooks.to(device), codes=block(index.codes), coarse_codes=block(index.coarse_codes),
        coarse_scale=whole(index.coarse_scale), proj=whole(index.proj), rotation=whole(index.rotation),
        subset_ids=block(index.subset_ids, torch.int32), corpus_shard=block(corpus_shard, torch.int32),
        refine_codes=block(index.refine_codes), refine_scale=whole(index.refine_scale),
        refine_proj=whole(index.refine_proj), n_real=n, rows_per_shard=rows, axis=axis, mesh=mesh,
        n_candidates=index.n_candidates, approx_recall=index.approx_recall, k_factor=index.k_factor,
        code_bits=index.code_bits,
    )


def sharded_pq_search(
    index: ShardedPQIndex,
    queries: SearchQueries,
    top_k: int,
    *,
    chunk: int = 131072,
    batch_axis: typ.Optional[str] = None,
) -> RetrievalBatch:
    """Each shard's two-stage PQ search over its rows (see the module), its
    k exact-scored pairs merged over the axis; `batch_axis` as in
    `sharded_dense_search`."""
    if queries.vector is None:
        raise ValueError("pq_search requires queries.vector")
    group, _, queries, mine = _search_setup(index, queries, batch_axis)
    loc_s, loc_i = pq_shard_topk(index, queries, top_k, chunk=chunk)
    out_s, out_i = merge_across_shards(loc_s, loc_i, group, keep=top_k)
    return _finish(*_pad_k(out_s, out_i, top_k), mine)


def pq_shard_topk(
    index: ShardedPQIndex, queries: SearchQueries, top_k: int, *, chunk: int = 131072
) -> tuple[torch.Tensor, torch.Tensor]:
    """This shard's part of `sharded_pq_search` for every query row: its k
    exact-scored (score, global id) pairs, -inf / -1 where it has none."""
    n_shards = axis_size(index.mesh, index.axis)
    rows = index.rows_per_shard
    exhaustive = index.coarse_codes is None
    direct = index.codes is None
    do_refine = index.refine_codes is not None
    if direct and (exhaustive or not do_refine):
        raise ValueError("ShardedPQIndex with codes=None requires coarse + refine stores")
    if exhaustive:
        # the chunk caps bound the decoded [chunk, D] temp
        chunk = min(chunk, 32768 if do_refine and index.code_bits == 8 else 65536)
    chunk = min(chunk, rows)
    while rows % chunk != 0:
        chunk -= 128
    q = queries.vector
    b = int(q.shape[0])
    dev = q.device
    # a proportional share of the candidate budget a shard
    n_cand = min(rows, max(128, -(-index.n_candidates // n_shards)))
    k_local = min(top_k, rows if exhaustive else n_cand)
    n_pool = min(index.k_factor * top_k, rows) if do_refine else k_local
    allow, route = queries.subset_ids, queries.shard
    filtered = (allow is not None and index.subset_ids is not None) or route is not None
    local_real = index.local_real
    set_full_f32_matmul()
    q_eff = q.to(torch.float32)
    if index.rotation is not None:
        q_eff = q_eff @ index.rotation

    def mask_chunk(s: torch.Tensor, start: int) -> torch.Tensor:
        if allow is not None and index.subset_ids is not None:
            sb = index.subset_ids[start : start + chunk]
            ok = (sb[None, None, :] == allow[:, :, None]).any(dim=1) | (allow < 0).all(dim=-1, keepdim=True)
            s = torch.where(ok, s, float("-inf"))
        if route is not None and index.corpus_shard is not None:
            cs = index.corpus_shard[start : start + chunk]
            s = torch.where((route[:, None] < 0) | (cs[None, :] == route[:, None]), s, float("-inf"))
        return s

    unpack = _unpack_codes4 if index.code_bits == 4 else (lambda c: c)
    if exhaustive:
        if do_refine:
            cb_i8, q_i8, q_row = _int8_adc_scan_inputs(index.codebooks, q_eff)

            def score_chunk(start: int) -> torch.Tensor:
                c = unpack(index.codes[start : start + chunk])
                return mask_chunk(_int8_onehot_adc_chunk(cb_i8, q_i8, q_row, c), start)
        else:

            def score_chunk(start: int) -> torch.Tensor:
                dec = decode_rows(index.codebooks, unpack(index.codes[start : start + chunk]))
                return mask_chunk(q_eff @ dec.T, start)

        if index.approx_recall is not None and n_pool > 64:
            pool_s, pool_i = _scan_collect_topk(score_chunk, rows, local_real, b, n_pool, chunk, dev,
                                                approx_recall=index.approx_recall, concentrated=filtered)
        else:
            pool_s, pool_i = _scan_topk(score_chunk, rows, local_real, b, n_pool, chunk, dev)
    else:
        # the int8 coarse scan, the same math as the unsharded one
        q_proj = (q_eff @ index.proj) * index.coarse_scale
        q_cr = torch.clamp(torch.amax(torch.abs(q_proj), dim=-1, keepdim=True), min=1e-8) / 127.0
        q_ci8 = torch.clamp(torch.round(q_proj / q_cr), -127, 127).to(torch.int8)
        q_ci8 = _zero_cols(q_ci8, int(index.coarse_codes.shape[1])).contiguous()

        def score_chunk(start: int) -> torch.Tensor:
            return mask_chunk(_int8_dot(q_ci8, index.coarse_codes[start : start + chunk]) * q_cr, start)

        cand_s, cand_i = _scan_collect_topk(score_chunk, rows, local_real, b, n_pool if direct else n_cand, chunk,
                                            dev, approx_recall=index.approx_recall, concentrated=filtered)
        if direct:
            pool_s, pool_i = cand_s, cand_i
        else:
            # the ADC rescore of the shard's candidates
            cand_codes = unpack(index.codes[torch.clamp(cand_i, 0, rows - 1).long()])
            adc = pq_ops.adc_score_codes(pq_ops.adc_lut(index.codebooks, q_eff), cand_codes)
            adc = torch.where(torch.isfinite(cand_s), adc, float("-inf"))
            pool_s, pos = topk_lowest_first(adc, min(n_pool, int(adc.shape[-1])))
            pool_i = torch.gather(cand_i, -1, pos)
    if do_refine:
        loc_s, loc_i = _refine_rerank(index, q, pool_s, pool_i, min(k_local, int(pool_s.shape[-1])))
    else:
        loc_s, loc_i = pool_s[:, :k_local], pool_i[:, :k_local]
    return loc_s, torch.where(torch.isfinite(loc_s), loc_i + index.shard * rows, -1)


# ---- IVF ----------------------------------------------------------------------


@dataclasses.dataclass
class ShardedIVFIndex:
    """This rank's block of IVF cells; the centroids whole."""

    centroids: torch.Tensor  # [C_pad, D] f32, every cell (padding cells zero)
    vectors: torch.Tensor  # [cells_per_shard, S, D]
    row_ids: torch.Tensor  # [cells_per_shard, S] int32, -1 pad
    subset_ids: typ.Optional[torch.Tensor] = None  # [cells_per_shard, S]
    c_real: int = 0
    cells_per_shard: int = 0
    nprobe: int = 8
    offset: int = 0
    axis: str = "shard"
    mesh: typ.Any = None

    def replace(self, **changes: typ.Any) -> "ShardedIVFIndex":
        return dataclasses.replace(self, **changes)


def _cells(x: torch.Tensor, lo: int, count: int, fill: typ.Any, device: torch.device) -> torch.Tensor:
    """Cells [lo, lo + count) of `x`, cells past its end filled with `fill`."""
    part = x[min(lo, x.shape[0]) : lo + count].to(device)
    if part.shape[0] < count:
        part = torch.cat([part, part.new_full((count - part.shape[0],) + tuple(part.shape[1:]), fill)])
    return part.contiguous()


def shard_ivf_index(
    index: IVFIndex, mesh: typ.Any, *, axis: str = "shard", device: typ.Union[str, torch.device, None] = None
) -> ShardedIVFIndex:
    """This rank's cells of a built `IVFIndex` (the same on every rank): the
    cells padded to a multiple of S (row ids -1), in contiguous blocks."""
    device = torch.device(device) if device is not None else index.vectors.device
    n_shards = _axis_size(mesh, axis)
    c = int(index.vectors.shape[0])
    cpd = -(-c // n_shards)
    lo = axis_index(mesh, axis) * cpd
    return ShardedIVFIndex(
        centroids=_cells(index.centroids, 0, cpd * n_shards, 0, device), vectors=_cells(index.vectors, lo, cpd, 0, device),
        row_ids=_cells(index.row_ids, lo, cpd, -1, device),
        subset_ids=None if index.subset_ids is None else _cells(index.subset_ids, lo, cpd, -1, device),
        c_real=c, cells_per_shard=cpd, nprobe=index.nprobe, offset=index.offset, axis=axis, mesh=mesh,
    )


def sharded_ivf_search(
    index: ShardedIVFIndex, queries: SearchQueries, top_k: int, *, batch_axis: typ.Optional[str] = None
) -> RetrievalBatch:
    """Every rank probes the same cells; each scores the probed cells it
    owns; the merge over the axis, then `offset`."""
    if queries.vector is None:
        raise ValueError("sharded_ivf_search requires queries.vector")
    group, _, queries, mine = _search_setup(index, queries, batch_axis)
    top_s, top_i = ivf_shard_topk(index, queries, top_k)
    out_s, out_i = _pad_k(*merge_across_shards(top_s, top_i, group, keep=top_k), top_k)
    return _finish(out_s, torch.where(out_i >= 0, out_i + index.offset, -1), mine)


def ivf_shard_topk(index: ShardedIVFIndex, queries: SearchQueries, top_k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """This shard's part of `sharded_ivf_search`: the top-k (score, row id)
    pairs of the probed cells it owns, -inf / -1 where it has none."""
    q = queries.vector
    b = int(q.shape[0])
    cpd = index.cells_per_shard
    me = axis_index(index.mesh, index.axis)
    nprobe = min(index.nprobe, index.c_real)
    allowed = queries.subset_ids
    set_full_f32_matmul()
    cscores = q.to(torch.float32) @ index.centroids.T
    cell_ids = torch.arange(int(cscores.shape[-1]), device=q.device)
    cscores = torch.where(cell_ids[None, :] < index.c_real, cscores, float("-inf"))
    _, probe = topk_lowest_first(cscores, nprobe)  # [B, P], the same on every rank
    q_v = q.to(index.vectors.dtype).to(torch.float32)  # products of the slab dtype, summed in f32
    slab_rows = int(index.vectors.shape[1])
    probe_s, probe_i = [], []
    for p in range(nprobe):
        cell = probe[:, p]
        owned = torch.div(cell, cpd, rounding_mode="floor") == me
        local = torch.clamp(cell - me * cpd, 0, cpd - 1)
        slab = index.vectors[local].to(torch.float32)  # [B, S, D]
        rid = index.row_ids[local]
        sc = torch.einsum("bd,bsd->bs", q_v, slab)
        sc = torch.where(owned[:, None] & (rid >= 0), sc, float("-inf"))
        if allowed is not None and index.subset_ids is not None:
            sub = index.subset_ids[local]
            ok = (sub[:, :, None] == allowed[:, None, :]).any(dim=-1) | (allowed < 0).all(dim=-1, keepdim=True)
            sc = torch.where(ok, sc, float("-inf"))
        ts, tp = topk_lowest_first(sc, min(top_k, slab_rows))
        probe_s.append(ts)
        probe_i.append(torch.gather(rid, -1, tp))
    all_s = torch.stack(probe_s, dim=1).reshape(b, -1)
    all_i = torch.stack(probe_i, dim=1).reshape(b, -1)
    top_s, pos = topk_lowest_first(all_s, min(top_k, int(all_s.shape[-1])))
    return top_s, torch.where(torch.isfinite(top_s), torch.gather(all_i, -1, pos), -1)


# ---- IVF-PQ -------------------------------------------------------------------


@dataclasses.dataclass
class ShardedIVFPQIndex:
    """This rank's window layout of an IVF-PQ index over its cells (`c % S
    == rank`); centroids, codebooks and the rerank store whole."""

    centroids: torch.Tensor  # [C, D]
    codebooks: torch.Tensor
    codes: typ.Optional[torch.Tensor]  # [slots_per_shard, Mc]; None = refine rows score
    row_ids: torch.Tensor  # [slots_per_shard] int32 original ids, -1 padding
    win_start: torch.Tensor  # [C] int32 this shard's window starts
    win_count: torch.Tensor  # [C] int32, zero for the cells of other shards
    rotation: typ.Optional[torch.Tensor] = None
    subset_ids: typ.Optional[torch.Tensor] = None  # [slots_per_shard]
    refine_codes: typ.Optional[torch.Tensor] = None  # [slots_per_shard, R]
    refine_scale: typ.Optional[torch.Tensor] = None
    refine_proj: typ.Optional[torch.Tensor] = None
    rerank_codes: typ.Optional[torch.Tensor] = None  # [n_real, R2], whole on every rank
    rerank_scale: typ.Optional[torch.Tensor] = None
    rerank_proj: typ.Optional[torch.Tensor] = None
    k_factor: int = 16
    n_real: int = 0
    offset: int = 0
    slots_per_shard: int = 0  # the busiest shard's windows times `window`
    axis: str = "shard"
    mesh: typ.Any = None
    window: int = 512
    nprobe: int = 32
    max_windows: int = 0  # a shard's window budget
    code_bits: int = 8
    approx_recall: typ.Optional[float] = 0.95
    spilled: bool = False

    def replace(self, **changes: typ.Any) -> "ShardedIVFPQIndex":
        return dataclasses.replace(self, **changes)


def shard_ivfpq_index(
    index: IVFPQIndex,
    mesh: typ.Any,
    *,
    axis: str = "shard",
    max_windows_local: typ.Optional[int] = None,
    device: typ.Union[str, torch.device, None] = None,
) -> ShardedIVFPQIndex:
    """This rank's window layout of a built `IVFPQIndex` (the same on every
    rank): its cells' windows in cell order, padded to the busiest shard's
    slot count. The window budget a shard: untruncated stays untruncated,
    else `ceil(3 * max_windows / (2 * S))` (a 1.5x slack for skew), at most
    the busiest shard's windows."""
    device = torch.device(device) if device is not None else index.row_ids.device
    n_shards = _axis_size(mesh, axis)
    me = axis_index(mesh, axis)
    window = index.window
    c = int(index.centroids.shape[0])
    wc = index.win_count.cpu().numpy().astype(np.int64)
    ws = index.win_start.cpu().numpy().astype(np.int64)
    shard_of = np.arange(c) % n_shards
    n_w_local = np.bincount(shard_of, weights=wc, minlength=n_shards).astype(np.int64)
    n_w_max = int(n_w_local.max())
    slots = n_w_max * window
    cells = np.where(shard_of == me)[0]
    cum = np.concatenate([[0], np.cumsum(wc[cells])])
    wc_l = np.zeros((c,), np.int32)
    ws_l = np.zeros((c,), np.int32)
    wc_l[cells] = wc[cells]
    ws_l[cells] = cum[:-1]
    # this shard's slots in the unsharded layout, cell by cell
    lens = wc[cells] * window
    starts = np.repeat(ws[cells] * window - cum[:-1] * window, lens)
    sel = torch.from_numpy(starts + np.arange(int(lens.sum()), dtype=np.int64)).to(index.row_ids.device)

    def gather(x: typ.Optional[torch.Tensor], fill: typ.Any) -> typ.Optional[torch.Tensor]:
        if x is None:
            return None
        out = torch.full((slots,) + tuple(x.shape[1:]), fill, dtype=x.dtype, device=device)
        out[: int(sel.numel())] = x[sel].to(device)
        return out

    def whole(x: typ.Optional[torch.Tensor]) -> typ.Optional[torch.Tensor]:
        return None if x is None else x.to(device)

    n_total_w = int(wc.sum())
    if max_windows_local is None:
        if index.max_windows <= 0 or index.max_windows >= n_total_w:
            max_windows_local = n_w_max
        else:
            max_windows_local = min(n_w_max, max(1, -(-3 * index.max_windows // (2 * n_shards))))
    return ShardedIVFPQIndex(
        centroids=whole(index.centroids), codebooks=whole(index.codebooks), codes=gather(index.codes, 0),
        row_ids=gather(index.row_ids, -1), win_start=torch.from_numpy(ws_l).to(device),
        win_count=torch.from_numpy(wc_l).to(device), rotation=whole(index.rotation),
        subset_ids=gather(index.subset_ids, -1), refine_codes=gather(index.refine_codes, 0),
        refine_scale=whole(index.refine_scale), refine_proj=whole(index.refine_proj),
        rerank_codes=whole(index.rerank_codes), rerank_scale=whole(index.rerank_scale),
        rerank_proj=whole(index.rerank_proj), k_factor=index.k_factor, n_real=index.n_real, offset=index.offset,
        slots_per_shard=slots, axis=axis, mesh=mesh, window=window, nprobe=index.nprobe,
        max_windows=int(max_windows_local), code_bits=index.code_bits, approx_recall=index.approx_recall,
        spilled=index.spilled,
    )


def sharded_ivfpq_search(
    index: ShardedIVFPQIndex, queries: SearchQueries, top_k: int, *, batch_axis: typ.Optional[str] = None
) -> RetrievalBatch:
    """Every rank probes the same cells; its window table yields only its
    own windows; `ivfpq_search` on its layout gives a pool (k_factor * k
    with a rerank store, else k), merged over the axis (twice the pool when
    spilled, then deduplicated); the rerank runs once, after the merge."""
    if queries.vector is None:
        raise ValueError("ivfpq_search requires queries.vector")
    group, _, queries, mine = _search_setup(index, queries, batch_axis)
    q = queries.vector
    do_rerank = index.rerank_codes is not None
    pool = max(1, index.k_factor) * top_k if do_rerank else top_k
    out = ivfpq_shard_pool(index, queries, top_k)
    out_s, out_i = merge_across_shards(out.scores, out.indices, group, keep=2 * pool if index.spilled else pool)
    if index.spilled:
        out_s, out_i = _dedup_equal_rows(out_s, out_i.to(torch.int32), pool)
    if do_rerank:
        out_s, out_i = rerank_candidates(
            q, out_s, out_i.to(torch.int32), top_k, rerank_codes=index.rerank_codes,
            rerank_scale=index.rerank_scale, rerank_proj=index.rerank_proj, offset=index.offset,
        )
    return _finish(*_pad_k(out_s[:, :top_k], out_i[:, :top_k], top_k), mine)


def ivfpq_shard_pool(index: ShardedIVFPQIndex, queries: SearchQueries, top_k: int) -> RetrievalBatch:
    """This shard's part of `sharded_ivfpq_search`: `ivfpq_search` on its
    window layout for the pool (k_factor * k with a rerank store, else k)."""
    pool = max(1, index.k_factor) * top_k if index.rerank_codes is not None else top_k
    local = IVFPQIndex(
        centroids=index.centroids, codebooks=index.codebooks, codes=index.codes, row_ids=index.row_ids,
        win_start=index.win_start, win_count=index.win_count, rotation=index.rotation, subset_ids=index.subset_ids,
        refine_codes=index.refine_codes, refine_scale=index.refine_scale, refine_proj=index.refine_proj,
        n_real=index.n_real, offset=index.offset, window=index.window, nprobe=index.nprobe,
        max_windows=index.max_windows, code_bits=index.code_bits, approx_recall=index.approx_recall,
        spilled=index.spilled,
    )
    return ivfpq_search(local, SearchQueries(vector=queries.vector, subset_ids=queries.subset_ids), pool)


# ---- MaxSim -------------------------------------------------------------------


@dataclasses.dataclass
class ShardedMaxSimIndex(_RowBlocks):
    """This rank's rows of a MaxSim token store."""

    token_codes: torch.Tensor  # [rows_per_shard, Lt, R]
    token_mask: torch.Tensor  # [rows_per_shard, Lt] bool
    scale: typ.Optional[torch.Tensor] = None
    proj: typ.Optional[torch.Tensor] = None
    n_real: int = 0
    rows_per_shard: int = 0
    offset: int = 0
    axis: str = "shard"
    mesh: typ.Any = None


def shard_maxsim_index(
    index: MaxSimIndex, mesh: typ.Any, *, axis: str = "shard", device: typ.Union[str, torch.device, None] = None
) -> ShardedMaxSimIndex:
    """This rank's block of a `MaxSimIndex`: `ceil(n / S)` rows a shard,
    the last padded with empty rows."""
    device = torch.device(device) if device is not None else index.token_codes.device
    n_shards = _axis_size(mesh, axis)
    n = index.n_real
    rows = -(-n // n_shards)
    lo = axis_index(mesh, axis) * rows
    return ShardedMaxSimIndex(
        token_codes=_local_block(index.token_codes[:n], lo, lo + rows, rows, device).contiguous(),
        token_mask=_local_block(index.token_mask[:n], lo, lo + rows, rows, device).contiguous(),
        scale=None if index.scale is None else index.scale.to(device),
        proj=None if index.proj is None else index.proj.to(device),
        n_real=n, rows_per_shard=rows, offset=index.offset, axis=axis, mesh=mesh,
    )


def sharded_maxsim_rerank(
    index: ShardedMaxSimIndex,
    query_tokens: torch.Tensor,  # [B, Lq, D] f32
    query_mask: torch.Tensor,  # [B, Lq]
    candidate_ids: torch.Tensor,  # [B, C] global ids, -1 padding
) -> torch.Tensor:
    """MaxSim scores [B, C], exactly `maxsim_rerank`'s: each rank scores the
    candidates it owns, -inf for the others, and an `all_reduce` (MAX) over
    the axis gives every rank the owner's score (each id has one owner)."""
    scores = maxsim_shard_scores(index, query_tokens, query_mask, candidate_ids)
    return all_reduce_(scores, op=dist.ReduceOp.MAX, group=axis_group(index.mesh, index.axis))


def maxsim_shard_scores(
    index: ShardedMaxSimIndex, query_tokens: torch.Tensor, query_mask: torch.Tensor, candidate_ids: torch.Tensor
) -> torch.Tensor:
    """This shard's part of `sharded_maxsim_rerank`: the scores of the
    candidates it owns, -inf for the others."""
    rows = index.rows_per_shard
    q = query_tokens.to(torch.float32)
    if index.proj is not None:
        set_full_f32_matmul()
        q = q @ index.proj
    local = candidate_ids.long() - index.offset - index.shard * rows
    own = (local >= 0) & (local < rows) & (candidate_ids >= 0)
    safe = torch.clamp(local, 0, rows - 1)
    scores = _score_gathered(index.token_codes[safe], index.token_mask[safe], q, query_mask.to(torch.bool),
                             index.scale)
    return torch.where(own, scores, float("-inf")).contiguous()
