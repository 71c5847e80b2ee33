"""Operating-point autotuning for the device search engines (port of
`vod_tpu/search/autotune.py`; faiss `ParameterSpace` / `OperatingPoints`).

Given a built index, a query sample and exact ground truth, sweep the
runtime knobs (the ones that need no rebuild), measure recall@k and
optionally wall time per setting, keep the Pareto front and pick the
cheapest setting that meets a recall target.

Runtime knobs per engine:
  * `IVFPQIndex` - `nprobe` (the window budget `max_windows` rescaled from
    the index's built nprobe -> budget ratio, capped at the total window
    count so probing every cell stays exact); with a rerank store, also
    `k_factor` crossed with nprobe;
  * `IVFIndex` - `nprobe`;
  * `PQIndex` - `k_factor` and, in coarse mode, `n_candidates`; the direct
    serving codec (keep_codes=False) also sweeps the coarse stage through
    `fused_mips_binned` (`fused`, `fused_bins` 2048, `fused_tile` 16384);
  * a flat `DenseIndex` - nothing to tune (a single point).

Wall time is taken on the host clock around each search with the device
synchronized before and after (`torch.cuda.synchronize`), the minimum over
repeats after one warm-up; the JAX package's relay nudges (distinct inputs
per repeat, a forced fetch) have no counterpart here. The sharded engines
are not ported.
"""

from __future__ import annotations

import dataclasses
import time
import typing as typ

import numpy as np
import torch

from .base import SearchQueries
from .dense import DenseIndex, IVFIndex, PQIndex, _sync, build_dense_index, dense_search, ivf_search, pq_search
from .ivfpq import IVFPQIndex, ivfpq_search


@dataclasses.dataclass(frozen=True)
class OperatingPoint:
    """One measured (params, recall, speed) setting (faiss `OperatingPoint`)."""

    params: dict[str, int]
    recall: float
    wall_s: typ.Optional[float] = None  # per evaluated query batch; None if untimed

    @property
    def qps(self) -> typ.Optional[float]:
        return None if not self.wall_s else round(self._n_queries / self.wall_s, 1)

    _n_queries: int = 0


def _recall_at_k(got: np.ndarray, gt: np.ndarray, k: int) -> float:
    got, gt = got[:, :k], gt[:, :k]
    return float(
        np.mean([len(set(got[i][got[i] >= 0].tolist()) & set(gt[i].tolist())) / k for i in range(got.shape[0])])
    )


def apply_runtime_params(index: typ.Any, params: dict[str, int]) -> typ.Any:
    """A copy of `index` with the runtime knobs in `params` applied (the same
    tensors; only static fields change)."""
    if not params:
        return index
    if isinstance(index, IVFPQIndex):
        nprobe = int(params["nprobe"])
        # rescale the per-probe window budget from the built ratio; cap at the
        # total window count so nprobe == n_cells degenerates to exact search
        per_probe = index.max_windows / max(index.nprobe, 1)
        total_windows = int(index.win_count.sum())
        mw = int(min(total_windows, max(1, round(per_probe * nprobe))))
        kw = {"nprobe": nprobe, "max_windows": mw}
        if "k_factor" in params:  # IndexRefine pool width (rerank store only)
            kw["k_factor"] = int(params["k_factor"])
        return index.replace(**kw)
    if isinstance(index, IVFIndex):
        return index.replace(nprobe=int(params["nprobe"]))
    if isinstance(index, PQIndex):
        kw = {}
        if "k_factor" in params:
            kw["k_factor"] = int(params["k_factor"])
        if "n_candidates" in params:
            if index.coarse_codes is None:
                raise ValueError("n_candidates only applies to coarse-mode PQ indexes")
            kw["n_candidates"] = int(params["n_candidates"])
        # fused=1 routes the coarse stage through `fused_mips_binned`
        if "fused" in params:
            kw["kernel"] = "fused" if params["fused"] else "scan"
        if "fused_bins" in params:
            kw["fused_bins"] = int(params["fused_bins"])
        if "fused_tile" in params:
            kw["fused_tile"] = int(params["fused_tile"])
        return index.replace(**kw)
    raise TypeError(f"no runtime knobs for {type(index).__name__}")


def default_grid(index: typ.Any) -> list[dict[str, int]]:
    """The faiss-`ParameterSpace`-shaped default sweep for this engine."""
    if isinstance(index, (IVFPQIndex, IVFIndex)):
        c = int(index.centroids.shape[0])
        probes = [{"nprobe": p} for p in (1, 2, 4, 8, 16, 32, 64, 128, 256) if p <= c]
        if getattr(index, "rerank_codes", None) is not None:
            # IndexRefine pool width crossed with nprobe
            return [{**p, "k_factor": f} for p in probes for f in (4, 16, 32)]
        return probes
    if isinstance(index, PQIndex):
        ks: list[dict[str, int]] = (
            [{"k_factor": f} for f in (1, 2, 4, 8, 16, 32)] if index.refine_codes is not None else [{}]
        )
        # n_candidates only gates the ADC stage; in coarse -> refine direct
        # mode (codes None) the pool is k_factor * k straight from the coarse scan
        if index.coarse_codes is not None and index.codes is not None:
            n = int(index.coarse_codes.shape[0])
            cands = [c for c in (256, 1024, 4096, 16384) if c <= n]
            ks = [{**k, "n_candidates": c} for k in ks for c in cands]
        elif index.coarse_codes is not None and index.refine_codes is not None:
            # the direct serving codec: also the fused coarse kernel at bins
            # 2048, tile 16384 (the scan where the tile does not divide the
            # rows); the one knob not cost-monotone in recall, so timed sweeps
            # pick it on wall and untimed ones as the lowest recall meeting the target
            ks = ks + [
                {**k, "fused": 1, "fused_bins": 2048, "fused_tile": 16384} for k in ks if k.get("k_factor", 1) >= 8
            ]
        return ks
    return [{}]  # flat / anything else: a single operating point


def _search_fn(index: typ.Any) -> typ.Callable[[typ.Any, torch.Tensor, int], torch.Tensor]:
    if isinstance(index, IVFPQIndex):
        return lambda ix, q, k: ivfpq_search(ix, SearchQueries(vector=q), k).indices
    if isinstance(index, IVFIndex):
        return lambda ix, q, k: ivf_search(ix, SearchQueries(vector=q), k).indices
    if isinstance(index, PQIndex):
        return lambda ix, q, k: pq_search(ix, SearchQueries(vector=q), k).indices
    if isinstance(index, DenseIndex):
        return lambda ix, q, k: dense_search(ix, SearchQueries(vector=q), k).indices
    raise TypeError(f"unsupported index type {type(index).__name__}")


def sweep_operating_points(
    index: typ.Any,
    queries: torch.Tensor,
    gt_indices: np.ndarray,
    *,
    top_k: int = 10,
    grid: typ.Optional[typ.Sequence[dict[str, int]]] = None,
    measure_time: bool = True,
    time_repeats: int = 3,
) -> list[OperatingPoint]:
    """Measure every grid setting; returns points sorted by ascending recall.
    `gt_indices`: [B, >= top_k] exact ids (one flat f32 scan)."""
    grid = list(grid) if grid is not None else default_grid(index)
    fn = _search_fn(index)
    b = int(queries.shape[0])
    points: list[OperatingPoint] = []
    for params in grid:
        ix = apply_runtime_params(index, params)
        got = fn(ix, queries, top_k).cpu().numpy()  # also the warm-up of the timed repeats
        recall = _recall_at_k(got, np.asarray(gt_indices), top_k)
        wall = None
        if measure_time:
            wall = float("inf")
            for _ in range(time_repeats):
                _sync(queries.device)
                t0 = time.perf_counter()
                fn(ix, queries, top_k)
                _sync(queries.device)
                wall = min(wall, time.perf_counter() - t0)
        points.append(OperatingPoint(params=dict(params), recall=recall, wall_s=wall, _n_queries=b))
    return sorted(points, key=lambda p: (p.recall, -(p.wall_s or 0.0)))


def pareto_front(points: typ.Sequence[OperatingPoint]) -> list[OperatingPoint]:
    """Keep points not dominated in (recall up, wall_s down), faiss
    `OperatingPoints::optimal`. Untimed points always survive: nothing can
    dominate them on the speed axis."""
    out: list[OperatingPoint] = []
    best_wall = float("inf")
    # descending recall: a timed point survives iff it is strictly faster
    # than every point with >= its recall
    for p in sorted(points, key=lambda p: -p.recall):
        if p.wall_s is None:
            out.append(p)
            continue
        if p.wall_s < best_wall:
            out.append(p)
            best_wall = p.wall_s
    return sorted(out, key=lambda p: p.recall)


def select_operating_point(points: typ.Sequence[OperatingPoint], target_recall: float) -> OperatingPoint:
    """Cheapest point meeting `target_recall`; the best-recall point if none
    does. For untimed points the lowest recall meeting the target is the
    cost proxy (every knob here has cost monotone in recall)."""
    meeting = [p for p in points if p.recall >= target_recall]
    if not meeting:
        return max(points, key=lambda p: p.recall)
    timed = [p for p in meeting if p.wall_s is not None]
    if timed:
        return min(timed, key=lambda p: (p.wall_s, p.recall))
    return min(meeting, key=lambda p: p.recall)


def _exact_topk_host(emb: np.ndarray, q: np.ndarray, k: int, chunk: int = 1_000_000) -> np.ndarray:
    """Exact top-k ids by a blocked host product (ground truth for the
    host-slab path, where the [N, H] matrix lives in host RAM)."""
    nq = q.shape[0]
    qf = q.astype(np.float32)
    best_s = np.full((nq, k), -np.inf, np.float32)
    best_i = np.full((nq, k), -1, np.int64)
    for start in range(0, emb.shape[0], chunk):
        s = qf @ emb[start : start + chunk].astype(np.float32).T
        ck = min(k, s.shape[1])
        part = np.argpartition(-s, ck - 1, axis=1)[:, :ck]
        all_s = np.concatenate([best_s, np.take_along_axis(s, part, 1)], axis=1)
        all_i = np.concatenate([best_i, part.astype(np.int64) + start], axis=1)
        order = np.argsort(-all_s, axis=1, kind="stable")[:, :k]
        best_s = np.take_along_axis(all_s, order, 1)
        best_i = np.take_along_axis(all_i, order, 1)
    return best_i


def _sample_seed(generator: torch.Generator) -> int:
    """The seed of the query sample's numpy draw, from `generator` (JAX
    draws it from its key)."""
    return int(torch.randint(0, 2**31 - 1, (), generator=generator, device=generator.device))


def autotune_after_build(
    index: typ.Any,
    fcfg: typ.Any,
    emb: typ.Union[torch.Tensor, np.ndarray],
    *,
    generator: torch.Generator,
) -> tuple[typ.Any, typ.Optional[dict]]:
    """Config-driven tuning right after a periodic rebuild
    (`DenseFactoryConfig.autotune_*`).

    `emb` is the embedding matrix the index was built from: a device tensor
    (in-memory path) or a host numpy array (host-slab path). The queries are
    a sample of its rows; the ground truth an exact f32 scan on the device or
    a blocked product on the host, where `emb` lives. Returns
    `(tuned_index, info | None)`; None = the engine has no runtime knobs."""
    if getattr(fcfg, "autotune_target_recall", None) is None:
        return index, None
    if not isinstance(index, (PQIndex, IVFIndex, IVFPQIndex)):
        return index, None
    n = int(emb.shape[0])
    nq = min(int(fcfg.autotune_queries), n)
    k = min(int(fcfg.autotune_top_k), n)
    sel = np.random.default_rng(_sample_seed(generator)).choice(n, size=nq, replace=False)
    if isinstance(emb, np.ndarray):
        q_np = emb[sel]
        gt = _exact_topk_host(emb, q_np, k)
        device = next(v.device for v in vars(index).values() if isinstance(v, torch.Tensor))
        queries = torch.as_tensor(q_np, dtype=torch.float32, device=device)
    else:
        queries = emb[torch.as_tensor(sel, device=emb.device)].to(torch.float32)
        flat = build_dense_index(emb, dtype="float32", approx_recall=None, device=emb.device)
        gt = dense_search(flat, SearchQueries(vector=queries), k).indices.cpu().numpy()
        del flat
    target = float(fcfg.autotune_target_recall)
    tuned, chosen, front = autotune(
        index, queries, gt, target_recall=target, top_k=k, measure_time=bool(fcfg.autotune_measure_time)
    )
    info = {
        "params": dict(chosen.params),
        "recall": round(chosen.recall, 4),
        "target": target,
        "met": bool(chosen.recall >= target),
        "front": [
            {"params": dict(p.params), "recall": round(p.recall, 4), **({"qps": p.qps} if p.qps is not None else {})}
            for p in front
        ],
    }
    return tuned, info


def autotune(
    index: typ.Any,
    queries: torch.Tensor,
    gt_indices: np.ndarray,
    *,
    target_recall: float = 0.95,
    top_k: int = 10,
    grid: typ.Optional[typ.Sequence[dict[str, int]]] = None,
    measure_time: bool = True,
) -> tuple[typ.Any, OperatingPoint, list[OperatingPoint]]:
    """One call: sweep -> Pareto -> select -> apply. Returns `(tuned_index,
    chosen_point, pareto_points)`; the tuned index shares `index`'s tensors."""
    points = sweep_operating_points(index, queries, gt_indices, top_k=top_k, grid=grid, measure_time=measure_time)
    front = pareto_front(points)
    chosen = select_operating_point(front, target_recall)
    return apply_runtime_params(index, chosen.params), chosen, front
