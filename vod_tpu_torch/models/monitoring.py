"""Retrieval metrics and a streaming mean monitor (port of
`vod_tpu/models/monitoring.py`).

Metrics (mrr, hitrate, precision, recall, kldiv, min, max, entropy, ndcg) are
computed per row on `[B, D]` relevances and scores, sorted by descending
score and cut at the name's `_<topk>` suffix; NaN marks an undefined row.
`RetrievalMonitor` keeps its running sums on the scores' device: `update`
never waits for the device, only `compute()` copies to the host. Over a
process group, `compute(group=...)` and `aggregate_metrics_psum` reduce the
ranks' (sum, count) pairs with one `all_reduce`, as JAX's `psum` does over a
mesh axis.
"""

from __future__ import annotations

import re
import typing as typ

import torch

from vod_tpu_torch.ops.numpy_ops import masked_log_softmax

_NEG_INF = float("-inf")


def _rank_inputs(
    relevances: torch.Tensor, scores: torch.Tensor, topk: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Mask NaN/+inf scores, sort by descending score (stable), truncate."""
    n_positives = (relevances > 0).sum(-1).to(torch.float32)
    bad = torch.isnan(scores) | torch.isposinf(scores)
    scores = torch.where(bad, _NEG_INF, scores)
    relevances = torch.where(bad, torch.zeros_like(relevances), relevances)
    order = torch.argsort(-scores, dim=-1, stable=True)
    rr = torch.gather(relevances, -1, order)
    rs = torch.gather(scores, -1, order)
    if topk > 0:
        rr, rs = rr[..., :topk], rs[..., :topk]
    return rr, rs, n_positives


def _mrr(rr, rs, n_pos):
    k = rr.shape[-1]
    ids = torch.arange(k, device=rr.device)
    first = torch.where(rr > 0, ids, k).argmin(-1)
    hit = (rr > 0).any(-1)
    return torch.where(hit, 1.0 / (1.0 + first.to(torch.float32)), 0.0)


def _hitrate(rr, rs, n_pos):
    return (rr > 0).any(-1).to(torch.float32)


def _precision(rr, rs, n_pos):
    n_rel = (rr > 0).sum(-1)
    n_ret = torch.isfinite(rs).sum(-1)
    return n_rel / torch.clamp(n_ret, min=1)


def _recall(rr, rs, n_pos):
    n_rel = (rr > 0).sum(-1).to(torch.float32)
    return torch.where(n_pos > 0, n_rel / torch.clamp(n_pos, min=1.0), float("nan"))


def _kldiv(rr, rs, n_pos):
    data_lp = masked_log_softmax(torch.where(rr > 0, 0.0, _NEG_INF))
    model_lp = masked_log_softmax(torch.where(torch.isfinite(rs), rs, _NEG_INF))
    ok = torch.isfinite(data_lp) & torch.isfinite(model_lp)
    kl = torch.where(ok, torch.exp(data_lp) * (data_lp - model_lp), 0.0).sum(-1)
    return torch.where((rr > 0).sum(-1) > 0, kl, float("nan"))


def _min(rr, rs, n_pos):
    return torch.where(torch.isfinite(rs), rs, float("inf")).amin(-1)


def _max(rr, rs, n_pos):
    return torch.where(torch.isfinite(rs), rs, _NEG_INF).amax(-1)


def _entropy(rr, rs, n_pos):
    lp = masked_log_softmax(torch.where(torch.isfinite(rs), rs, _NEG_INF))
    return torch.where(torch.isfinite(rs), -torch.exp(lp) * lp, 0.0).sum(-1)


def _ndcg(rr, rs, n_pos):
    rr = rr.to(torch.float32)
    k = rr.shape[-1]
    log2_ranks = torch.log2(torch.arange(2, k + 2, device=rr.device, dtype=torch.float32))
    dcg = (rr / log2_ranks).sum(-1)
    idcg = (torch.sort(rr, dim=-1, descending=True).values / log2_ranks).sum(-1)
    return torch.where(idcg > 0, dcg / idcg, 0.0)


_METRICS: dict[str, typ.Callable] = {
    "mrr": _mrr,
    "hitrate": _hitrate,
    "precision": _precision,
    "recall": _recall,
    "kldiv": _kldiv,
    "min": _min,
    "max": _max,
    "entropy": _entropy,
    "ndcg": _ndcg,
}

_NAME_RE = re.compile(r"^(?P<name>[a-z_]+?)(?:_(?P<topk>\d+))?$")


def parse_metric_name(name: str) -> tuple[str, int]:
    """`'ndcg_10' -> ('ndcg', 10)`; no suffix -> topk=0 (all)."""
    m = _NAME_RE.match(name)
    if m is None or m.group("name") not in _METRICS:
        raise ValueError(f"Unknown metric: {name!r} (known: {sorted(_METRICS)})")
    return m.group("name"), int(m.group("topk") or 0)


def retrieval_metrics(
    metrics: typ.Sequence[str], *, relevances: torch.Tensor, scores: torch.Tensor
) -> dict[str, torch.Tensor]:
    """Per-row metric values [B] (NaN = undefined row)."""
    out = {}
    for name in metrics:
        base, topk = parse_metric_name(name)
        out[name] = _METRICS[base](*_rank_inputs(relevances, scores, topk))
    return out


def aggregate_metrics_psum(values: dict[str, torch.Tensor], group: typ.Any = None) -> dict[str, torch.Tensor]:
    """NaN-aware mean over the ranks of `group` (JAX: over a mesh axis): the
    masked sums and the counts of every value, all-reduced in one call.
    Without a process group it is the NaN-aware mean of each value alone."""
    from vod_tpu_torch.parallel.distributed import all_reduce_

    names = list(values)
    if not names:
        return {}
    vs = [torch.as_tensor(values[n], dtype=torch.float32) for n in names]
    dev = vs[0].device
    stats = torch.stack(
        [torch.stack([torch.where(torch.isnan(v), 0.0, v).sum(), (~torch.isnan(v)).sum().to(torch.float32)])
         for v in (x.to(dev) for x in vs)]
    )  # [M, 2]
    all_reduce_(stats, group=group)
    means = stats[:, 0] / torch.clamp(stats[:, 1], min=1.0)
    return dict(zip(names, means.unbind()))


class RetrievalMonitor:
    """Streaming NaN-aware mean of per-row metrics over batches. The running
    (sum, count) pairs stay on the scores' device; `compute()` is the only
    call that copies to the host."""

    def __init__(self, metrics: typ.Sequence[str]):
        self.metrics = list(metrics)
        for m in self.metrics:
            parse_metric_name(m)
        self.reset()

    def reset(self) -> None:
        self._state: typ.Optional[dict[str, tuple[torch.Tensor, torch.Tensor]]] = None

    @torch.no_grad()
    def update(self, *, relevances: torch.Tensor, scores: torch.Tensor) -> None:
        vals = retrieval_metrics(self.metrics, relevances=relevances, scores=scores)
        if self._state is None:
            zero = lambda: torch.zeros((), dtype=torch.float32, device=scores.device)  # noqa: E731
            self._state = {m: (zero(), zero()) for m in self.metrics}
        for m, v in vals.items():
            ok = ~torch.isnan(v)
            s, c = self._state[m]
            s.add_(torch.where(ok, v, 0.0).sum())
            c.add_(ok.sum())

    def compute(self, group: typ.Any = None) -> dict[str, float]:
        """The means; with `group`, of every rank's rows (the ranks' sums and
        counts all-reduced first; every rank of the group must call it)."""
        if group is not None:
            from vod_tpu_torch.parallel.distributed import all_reduce_

            if self._state is None:  # this rank saw no batch: it still joins the reduction
                raise ValueError("RetrievalMonitor.compute(group=...) before any update")
            stats = torch.stack([torch.stack(sc) for sc in self._state.values()])
            all_reduce_(stats, group=group)
            host_stats = stats.cpu().tolist()  # the only host sync
            return {m: s / c if c > 0 else float("nan") for m, (s, c) in zip(self._state, host_stats)}
        if self._state is None:
            return {m: float("nan") for m in self.metrics}
        host = {m: (float(s), float(c)) for m, (s, c) in self._state.items()}  # the only host sync
        return {m: s / c if c > 0 else float("nan") for m, (s, c) in host.items()}
