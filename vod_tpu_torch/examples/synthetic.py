"""Shared parts of the 8.8M research scripts (the ports of `serving_*_bench`,
`pq_*`, `pq4_*` and `ivfpq_*`): the spectrum-matched synthetic corpus, its
exact ground truth, the query pools, recall and block timing.

The corpus never exists whole in float32 (8.8M x 768 f32 is 27 GB): it is
made slab by slab on the device, each slab `randn(slab, D) * spec @ basis`,
row-normalised, with `spec = exp(-arange(D) / 35)` (the decaying spectrum of
real embeddings) mixed by a random rotation `basis` (QR of a Gaussian).
Each slab comes from its own seeded `torch.Generator` (seed `seed0 + i`),
the basis from seed 99, so a slab can be made again for the exact ground
truth. These are the port's own draws: the JAX scripts drew theirs with
`jax.random` keys, and the numbers of the two packages differ.
"""

from __future__ import annotations

import math
import time
import typing as typ

import numpy as np
import torch

from vod_tpu_torch.ops.mips import set_full_f32_matmul
from vod_tpu_torch.ops.numpy_ops import topk_lowest_first
from vod_tpu_torch.search.dense import _sync as sync  # noqa: F401 - the scripts' device sync

D = 768
MSMARCO_N = 8_841_823  # msmarco passage count, the scripts' default corpus size
N_SLABS = 8  # the JAX scripts' slab count


def slab_rows(n: int, align: int = 8192) -> int:
    """The JAX scripts' slab height: ceil(ceil(n / N_SLABS) / align) * align."""
    return -(-(-(-n // N_SLABS)) // align) * align


def quantize_with(x: torch.Tensor, proj: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int8 rows `clip(round((x @ proj) / scale), -127, 127)`."""
    return torch.clamp(torch.round((x @ proj) / scale), -127, 127).to(torch.int8)


def column_scale(rows: torch.Tensor) -> torch.Tensor:
    """Per-column symmetric int8 scale `max(absmax, 1e-8) / 127`, `[1, C]`."""
    absmax = torch.amax(torch.abs(rows), dim=0, keepdim=True)
    return torch.clamp(absmax, min=1e-8) / torch.full_like(absmax, 127.0)


class SlabCorpus:
    """`n` spectrum-matched unit rows of width `d` in `n_slabs` slabs of
    `slab` rows (the last slab's rows past `n` are padding)."""

    def __init__(self, n: int, slab: int, n_slabs: int, device: torch.device, *, d: int = D, seed0: int = 1000):
        set_full_f32_matmul()
        self.n, self.slab, self.n_slabs, self.d, self.seed0 = n, slab, n_slabs, d, seed0
        self.n_pad = slab * n_slabs
        self.device = device
        self.spec = torch.exp(-torch.arange(d, device=device, dtype=torch.float32) / 35.0)
        g = torch.Generator(device=device).manual_seed(99)
        self.basis = torch.linalg.qr(torch.randn((d, d), generator=g, device=device))[0].to(torch.float32)

    def slab_of(self, i: int, rows: typ.Optional[int] = None) -> torch.Tensor:
        """Slab `i` (or its first `rows` rows) as `[rows, d]` f32 unit rows."""
        g = torch.Generator(device=self.device).manual_seed(self.seed0 + i)
        z = torch.randn((self.slab, self.d), generator=g, device=self.device) * self.spec
        if rows is not None:
            z = z[:rows]
        x = z @ self.basis
        return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)

    def fill(self, *specs: tuple[int, torch.dtype, typ.Callable[[torch.Tensor], torch.Tensor]]) -> list[torch.Tensor]:
        """One `[n_pad, width]` store per `(width, dtype, encode)` spec, slab
        i's rows `encode(slab_of(i))` (each slab made once for all stores)."""
        outs = [torch.zeros((self.n_pad, w), dtype=dt, device=self.device) for w, dt, _ in specs]
        for i in range(self.n_slabs):
            x = self.slab_of(i)
            for out, (_, _, encode) in zip(outs, specs):
                out[i * self.slab : (i + 1) * self.slab] = encode(x)
        return outs

    def queries(self, n_eval: int, seed: int = 0) -> np.ndarray:
        """The scripts' eval queries: the first `n_eval` rows of slab 0 plus
        0.1 spectrum-shaped noise rotated by the basis (numpy seed `seed`),
        normalised. `[n_eval, d]` f32."""
        s0 = self.slab_of(0, n_eval).cpu().numpy()
        rng = np.random.default_rng(seed)
        noise = (rng.standard_normal((n_eval, self.d)).astype(np.float32) * self.spec.cpu().numpy()) @ (
            self.basis.cpu().numpy())
        q = s0 + 0.1 * noise
        return (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)

    def exact_topk(self, q: np.ndarray, k: int) -> np.ndarray:
        """Exact f32 top-k row ids of `q` over the real rows, by a running
        top-k over the slabs made again (lowest id first on ties)."""
        jq = torch.from_numpy(q).to(self.device)
        top_s = torch.full((q.shape[0], k), float("-inf"), device=self.device)
        top_i = torch.full((q.shape[0], k), -1, dtype=torch.int64, device=self.device)
        for i in range(self.n_slabs):
            s = jq @ self.slab_of(i).T
            rows = i * self.slab + torch.arange(self.slab, device=self.device)
            s = torch.where(rows[None] < self.n, s, float("-inf"))
            c_s, c_pos = topk_lowest_first(s, k)
            all_s = torch.cat([top_s, c_s], dim=-1)
            all_i = torch.cat([top_i, c_pos + i * self.slab], dim=-1)
            top_s, pos = topk_lowest_first(all_s, k)
            top_i = torch.gather(all_i, -1, pos)
        return top_i.cpu().numpy()


def make_queries(q: np.ndarray, nq: int, seed: int = 0) -> np.ndarray:
    """`nq` perturbed copies of the eval queries (1e-3 noise, numpy seed
    `seed`), normalised: distinct query blocks for timing."""
    r = np.random.default_rng(seed)
    base = np.tile(q, (-(-nq // q.shape[0]), 1))[:nq]
    out = base + 1e-3 * r.standard_normal((nq, q.shape[1])).astype(np.float32)
    return (out / np.linalg.norm(out, axis=1, keepdims=True)).astype(np.float32)


def recall_at(got: typ.Any, gt: np.ndarray, k: int) -> float:
    """Mean |got_i[:k'] ∩ gt_i| / k over rows (`got` may hold more than k ids)."""
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    return float(np.mean([len(set(got[i].tolist()) & set(gt[i].tolist())) / k for i in range(gt.shape[0])]))


def block_ms(fn: typ.Callable[[torch.Tensor], typ.Any], pools: typ.Sequence[torch.Tensor], device: torch.device,
             reps: int = 3) -> float:
    """ms per call of `fn` over distinct staged query blocks: every pool run
    back to back between two CUDA events (host clock and a final read on the
    CPU), the minimum over `reps` rounds, after one warm-up call per pool
    shape. No host sync inside a timed round."""
    for p in {tuple(p.shape): p for p in pools}.values():
        fn(p)
    best = math.inf
    for _ in range(reps):
        if device.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize(device)
            start.record()
            for p in pools:
                fn(p)
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / len(pools))
        else:
            t = time.perf_counter()
            outs = [fn(p) for p in pools]
            _ = [o.reshape(-1)[0].item() for o in outs if isinstance(o, torch.Tensor)]
            best = min(best, (time.perf_counter() - t) * 1e3 / len(pools))
    return best


def device_of(name: str) -> torch.device:
    """The `--device` argument: `cuda` needs a card and never falls back."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs a CUDA card (use --device cpu for the plain path)")
    return device


def serving_ms(search: typ.Callable[[torch.Tensor], typ.Any], q: np.ndarray, device: torch.device, *, b: int = 64,
               blocks: int = 9, reps: int = 3, seed0: int = 200) -> float:
    """ms per `b`-query dispatch over `blocks` distinct blocks (`block_ms`)."""
    pools = [torch.from_numpy(make_queries(q, b, seed=seed0 + j)).to(device) for j in range(blocks)]
    return block_ms(search, pools, device, reps)


def throughput_qps(search: typ.Callable[[torch.Tensor], typ.Any], q: np.ndarray, device: torch.device, *,
                   block: int = 2048, blocks: int = 4, reps: int = 3, seed0: int = 50) -> float:
    """Queries per second over `blocks` distinct `block`-query blocks run back
    to back (`block_ms`): the JAX scripts' 4 x 2048 throughput mode."""
    return block / (serving_ms(search, q, device, b=block, blocks=blocks, reps=reps, seed0=seed0) / 1e3)


def add_timing_args(ap: typ.Any, *, block: int = 2048, blocks: int = 4) -> None:
    """The sweeps' shared timing flags."""
    ap.add_argument("--block", type=int, default=block, help="throughput block (queries)")
    ap.add_argument("--blocks", type=int, default=blocks, help="distinct blocks per timed round")
    ap.add_argument("--reps", type=int, default=3, help="timed rounds (the minimum is kept)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
