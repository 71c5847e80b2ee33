"""Sharded search over the ranks of a mesh axis (port of the dense and BM25
parts of `vod_tpu/search/sharded.py`).

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

Queries: JAX is one controller and hands every shard the whole query batch.
Here each rank passes its queries; `batch_axis` names the mesh axis the
batch's rows are split over. When it is the index's axis (a batch split over
`dp` searching an index sharded over `dp`), the ranks first gather the
queries over the axis, search their shards for every row, merge, and keep
their own rows. Otherwise the ranks of one shard group hold the same rows.

Declared difference: the per-shard selection is exact (`approx_recall` only
gates the fused kernel), as in the port's unsharded scan. Sharded PQ, IVF,
IVF-PQ and MaxSim are not ported (ROADMAP §A item 5b).
"""

from __future__ import annotations

import dataclasses
import typing as typ

import numpy as np
import torch
import torch.distributed as dist

from vod_tpu_torch.ops.mips import fused_mips_binned, set_full_f32_matmul
from vod_tpu_torch.ops.numpy_ops import topk_lowest_first
from vod_tpu_torch.parallel.distributed import all_gather_tensor, all_reduce_
from vod_tpu_torch.parallel.mesh import axis_group, axis_index, axis_size
from vod_tpu_torch.types.retrieval import RetrievalBatch
from .base import SearchQueries
from .dense import _pad_rows, _scan_topk, quantize_queries_int8
from .sparse import SparseIndex, bm25_topk


@dataclasses.dataclass
class ShardedDenseIndex:
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

    @property
    def shard(self) -> int:
        return axis_index(self.mesh, self.axis)

    @property
    def local_real(self) -> int:
        """This shard's real rows (padding lives on the last shards)."""
        return int(min(max(self.n_real - self.shard * self.rows_per_shard, 0), self.rows_per_shard))


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
    n_shards = axis_size(mesh, axis)
    if n_shards == 1 and axis not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"mesh axes {list(mesh.mesh_dim_names)} have no {axis!r}")
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
