"""Lloyd k-means for IVF coarse quantizers and PQ codebooks (port of
`vod_tpu/ops/kmeans.py`).

Assignment is chunked over rows so the `[n, k]` distance matrix never
materialises; the centroid update is a segment sum (`index_add_`). Both run
batched over a leading group axis, which is how `ops/pq.py:train_pq` trains
several PQ subspaces at once (the JAX version `vmap`s `kmeans` there).

Random draws: the JAX version picks its initial rows with
`jax.random.choice` and re-seeds empty clusters from `jax.random.randint`,
each iteration from its own split key. Here both come from the
`torch.Generator` the caller gives, on the data's device: the initial rows
first (unless `init` is given), then one `[k]` draw of re-seed rows per
iteration, whether or not a cluster went empty. Given JAX's initial
centroids as `init`, the port follows JAX's iterates exactly as long as no
cluster goes empty.

`kmeans_sharded` runs the same iterations over the ranks of a mesh axis:
each rank assigns its block of the rows and sums them by cluster, and one
`all_reduce` (SUM) of the `[k, d]` sums and `[k]` counts an iteration
crosses the group; the centroids stay the same on every rank. It draws what
`kmeans` draws, in that order, so from one generator state the sharded run
follows the unsharded one (up to the order of the float sums: a row on a
tie may change cells).
"""

from __future__ import annotations

import typing as typ

import torch

from .mips import set_full_f32_matmul

# distance elements per assignment chunk: the row chunk grows to this budget
# (the assignment is the same at any chunk size; fewer chunks, fewer launches)
_ASSIGN_ELEMS = 1 << 26


def _assign_batched(x: torch.Tensor, centroids: torch.Tensor, chunk: int) -> torch.Tensor:
    """Nearest centroid per row of each group: x [g, n, d], centroids [g, k, d]
    -> [g, n] int64, by ||c||^2 - 2 x.c (||x||^2 is irrelevant for the argmin),
    the first centroid on ties."""
    set_full_f32_matmul()
    g, n, _ = x.shape
    k = int(centroids.shape[1])
    c = centroids.to(torch.float32)
    c_sq = torch.sum(c * c, dim=-1)  # [g, k]
    rows = max(chunk, _ASSIGN_ELEMS // max(1, g * k))
    out = []
    for start in range(0, n, rows):
        ip = torch.bmm(x[:, start : start + rows].to(torch.float32), c.transpose(1, 2))  # [g, r, k]
        out.append(torch.argmin(c_sq[:, None, :] - 2.0 * ip, dim=-1))
    return torch.cat(out, dim=1) if out else torch.zeros((g, 0), dtype=torch.int64, device=x.device)


def _assign_chunked(x: torch.Tensor, centroids: torch.Tensor, chunk: int = 4096) -> torch.Tensor:
    """Nearest-centroid assignment of the rows of x [n, d]: [n] int32."""
    return _assign_batched(x[None], centroids[None], chunk)[0].to(torch.int32)


def _init_rows(n: int, n_clusters: int, groups: int, generator: torch.Generator, device: torch.device) -> torch.Tensor:
    """Initial row ids [groups, k]: distinct rows, or with replacement when
    n < k (duplicates get re-seeded by the empty-cluster rule)."""
    if n < n_clusters:
        return torch.randint(0, n, (groups, n_clusters), generator=generator, device=device)
    return torch.stack([torch.randperm(n, generator=generator, device=device)[:n_clusters] for _ in range(groups)])


def kmeans_batched(
    x: torch.Tensor,  # [g, n, d]
    n_clusters: int,
    n_iters: int = 10,
    chunk: int = 4096,
    init: typ.Optional[torch.Tensor] = None,  # [g, k, d]
    *,
    generator: torch.Generator,
    assign: bool = True,
) -> tuple[torch.Tensor, typ.Optional[torch.Tensor]]:
    """`kmeans` over each of `g` independent row sets at once. Returns
    (centroids [g, k, d] f32, assignments [g, n] int32, or None when
    `assign=False`)."""
    if generator is None:
        raise ValueError("kmeans needs a torch.Generator for its initial rows and empty-cluster re-seeds")
    g, n, d = x.shape
    x = x.to(torch.float32)
    dev = x.device
    groups = torch.arange(g, device=dev)[:, None]
    if init is not None:
        centroids = init.to(torch.float32).to(dev)
    else:
        centroids = x[groups, _init_rows(n, n_clusters, g, generator, dev)]
    flat_x = x.reshape(g * n, d)
    for _ in range(n_iters):
        a = _assign_batched(x, centroids, chunk)
        seg = (a + groups * n_clusters).reshape(-1)
        sums = torch.zeros((g * n_clusters, d), dtype=torch.float32, device=dev).index_add_(0, seg, flat_x)
        counts = torch.zeros((g * n_clusters,), dtype=torch.float32, device=dev).index_add_(
            0, seg, torch.ones((g * n,), dtype=torch.float32, device=dev)
        )
        sums, counts = sums.view(g, n_clusters, d), counts.view(g, n_clusters)
        new_c = sums / torch.clamp(counts[..., None], min=1.0)
        # re-seed empty clusters from random rows
        reseed = torch.randint(0, n, (g, n_clusters), generator=generator, device=dev)
        centroids = torch.where((counts > 0)[..., None], new_c, x[groups, reseed])
    final = _assign_batched(x, centroids, chunk).to(torch.int32) if assign else None
    return centroids, final


def kmeans(
    x: torch.Tensor,
    n_clusters: int,
    n_iters: int = 10,
    chunk: int = 4096,
    init: typ.Optional[torch.Tensor] = None,
    *,
    generator: torch.Generator,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Lloyd k-means. Returns (centroids [k, d] f32, assignments [n] i32).

    Init: a random sample of distinct rows (with replacement when n < k), or
    `init` [k, d] to warm-start. Empty clusters are re-seeded from random rows
    each iteration."""
    centroids, assign = kmeans_batched(
        x[None], n_clusters, n_iters, chunk, None if init is None else init[None], generator=generator
    )
    return centroids[0], assign[0]


def infer_n_clusters(n_vectors: int) -> int:
    """`IVFauto` heuristic: ~sqrt(n), clamped to [1, 65536]."""
    return int(max(1, min(2**16, round(float(n_vectors) ** 0.5))))


def kmeans_sharded(
    x: torch.Tensor,
    n_clusters: int,
    mesh: typ.Any,
    *,
    axis: str = "shard",
    n_iters: int = 10,
    chunk: int = 4096,
    init: typ.Optional[torch.Tensor] = None,
    generator: torch.Generator,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Lloyd k-means over the ranks of the mesh's `axis` (faiss's
    multi-GPU clustering). `x` [n, d] is the whole training set, the same on
    every rank; rank i assigns and sums rows [i * r, (i + 1) * r), r =
    ceil(n / ranks). An empty cluster is re-seeded from a global random row:
    its owner gives the row through a second sum, taken only in an
    iteration where a cluster went empty (the counts are the same on every
    rank, so every rank takes it). `generator` must be in the same state on
    every rank (seeded on the same device type). Returns (centroids [k, d]
    f32, the same on every rank; assignments [n] int32, gathered)."""
    from vod_tpu_torch.parallel.distributed import all_gather_tensor, all_reduce_
    from vod_tpu_torch.parallel.mesh import axis_group, axis_index, axis_size

    if generator is None:
        raise ValueError("kmeans needs a torch.Generator for its initial rows and empty-cluster re-seeds")
    if axis not in (getattr(mesh, "mesh_dim_names", None) or ()):
        raise ValueError(f"the mesh has no axis {axis!r}")
    n, d = (int(s) for s in x.shape)
    x = x.to(torch.float32)
    dev = x.device
    if init is not None:
        centroids = init.to(torch.float32).to(dev)
    else:
        centroids = x[_init_rows(n, n_clusters, 1, generator, dev)[0]]
    size, me = axis_size(mesh, axis), axis_index(mesh, axis)
    group = axis_group(mesh, axis)
    rows = -(-n // size)
    lo = min(me * rows, n)
    xl = x[lo : min(lo + rows, n)]
    m = int(xl.shape[0])
    ones = torch.ones((m, 1), dtype=torch.float32, device=dev)
    for _ in range(n_iters):
        a = _assign_chunked(xl, centroids, chunk).long()
        # the sums and the counts in one buffer, one all_reduce
        acc = torch.zeros((n_clusters, d + 1), dtype=torch.float32, device=dev).index_add_(0, a, torch.cat([xl, ones], 1))
        all_reduce_(acc, group=group)
        sums, counts = acc[:, :d], acc[:, d]
        new_c = sums / torch.clamp(counts[:, None], min=1.0)
        reseed = torch.randint(0, n, (1, n_clusters), generator=generator, device=dev)[0]
        empty = counts <= 0
        if bool(empty.any()):
            loc = reseed - lo
            own = (loc >= 0) & (loc < m)
            seed_rows = torch.where(own[:, None], xl[torch.clamp(loc, 0, max(m - 1, 0))], 0.0) if m else \
                torch.zeros((n_clusters, d), dtype=torch.float32, device=dev)
            all_reduce_(seed_rows, group=group)
            new_c = torch.where(empty[:, None], seed_rows, new_c)
        centroids = new_c
    local = torch.full((rows,), -1, dtype=torch.int32, device=dev)
    local[:m] = _assign_chunked(xl, centroids, chunk)
    return centroids, all_gather_tensor(local, group).reshape(-1)[:n]
