"""Product quantization: codebook training, encoding, ADC scoring, OPQ and the
score-aware (anisotropic) variant (port of `vod_tpu/ops/pq.py`).

Retrieval over a PQ index (`search/dense.py:pq_search`) is an exhaustive ADC
scan (decode + product), or a coarse int8 scan followed by an ADC rescore of
the candidates; this module trains and applies the codecs. Every product is
plain PyTorch: the JAX version runs them as plain XLA.

Random draws: where the JAX version splits a key per subspace (`train_pq`)
or folds in an iteration (`train_opq`), the port draws in sequence from the
one `torch.Generator` it is given. Warm starts (`init_codebooks`) draw no
initial rows, so a warm-started `train_pq` follows JAX's iterates as long as
no cluster goes empty. `train_projection`'s eigenvectors may come out with
other signs than LAPACK gives JAX.

Float32 products here run in full f32 (TF32 off, `ops.mips.set_full_f32_matmul`).
"""

from __future__ import annotations

import typing as typ

import torch

from .kmeans import kmeans_batched
from .mips import set_full_f32_matmul

AnisoEta = typ.Union[None, float, typ.Literal["auto"]]


def _group_size(m: int, n: int, n_codes: int) -> int:
    """Subspaces trained together: bounds the per-group temps at ~1 GB."""
    g = max(1, min(m, (1 << 30) // max(1, n * n_codes * 4)))
    while m % g != 0:
        g -= 1
    return g


def train_pq(
    x: torch.Tensor,  # [n, d] training vectors
    n_subquantizers: int,
    n_codes: int = 256,
    n_iters: int = 10,
    init_codebooks: typ.Optional[torch.Tensor] = None,
    *,
    generator: torch.Generator,
) -> torch.Tensor:
    """Train PQ codebooks: k-means per subspace, `g` subspaces at a time.
    Returns [M, n_codes, d/M] f32. `init_codebooks` warm-starts each
    subspace's k-means (the OPQ alternation)."""
    n, d = x.shape
    m = n_subquantizers
    if d % m != 0:
        raise ValueError(f"dim {d} not divisible by n_subquantizers {m}")
    dsub = d // m
    x_sub = x.to(torch.float32).reshape(n, m, dsub).permute(1, 0, 2)  # [M, n, dsub]
    g = _group_size(m, n, n_codes)
    out = []
    for s in range(0, m, g):
        init = None if init_codebooks is None else init_codebooks[s : s + g]
        c, _ = kmeans_batched(
            x_sub[s : s + g].contiguous(), n_codes, n_iters, init=init, generator=generator, assign=False
        )
        out.append(c)
    return torch.cat(out, dim=0)


def _nearest_codes(codebooks: torch.Tensor, xc: torch.Tensor) -> torch.Tensor:
    """Nearest codeword per subspace: xc [c, M, dsub] -> [c, M] int64."""
    cb = codebooks.to(torch.float32)
    c_sq = torch.sum(cb * cb, dim=-1)  # [M, n_codes]
    ip = torch.bmm(xc.to(torch.float32).permute(1, 0, 2), cb.transpose(1, 2))  # [M, c, n_codes]
    return torch.argmin(c_sq[:, None, :] - 2.0 * ip, dim=-1).T


def encode_pq(codebooks: torch.Tensor, x: torch.Tensor, chunk: int = 8192) -> torch.Tensor:
    """Encode vectors to PQ codes. Returns [n, M] uint8."""
    set_full_f32_matmul()
    n, _ = x.shape
    m, _, dsub = codebooks.shape
    parts = [_nearest_codes(codebooks, x[s : s + chunk].reshape(-1, m, dsub)) for s in range(0, n, chunk)]
    return torch.cat(parts).to(torch.uint8) if parts else torch.zeros((0, m), dtype=torch.uint8, device=x.device)


def adc_lut(codebooks: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """Inner-product ADC lookup tables: lut[b, m, c] = q_b[m] . codebook[m, c]."""
    set_full_f32_matmul()
    b, _ = queries.shape
    m, _, dsub = codebooks.shape
    q_sub = queries.to(torch.float32).reshape(b, m, dsub).permute(1, 0, 2)  # [M, B, dsub]
    return torch.bmm(q_sub, codebooks.to(torch.float32).transpose(1, 2)).permute(1, 0, 2)


def adc_score_codes(lut: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """Score gathered codes against per-query LUTs.

    lut: [B, M, n_codes]; codes: [B, K, M] (candidate codes per query).
    Returns [B, K] approximate inner products."""
    gathered = torch.gather(lut.transpose(1, 2), 1, codes.long())  # [B, K, M]
    return torch.sum(gathered, dim=-1)


def train_projection(x: torch.Tensor, out_dim: int) -> tuple[torch.Tensor, torch.Tensor]:
    """PCA projection for the coarse scan and the truncated refine store.
    Returns (projection [d, out_dim] f32, mean [d]): the eigenvectors of the
    centered covariance, largest eigenvalue first. A column may have the
    other sign than JAX's."""
    set_full_f32_matmul()
    mean = torch.mean(x, dim=0)
    xc = (x - mean).to(torch.float32)
    cov = (xc.T @ xc) / xc.shape[0]
    _, eigvecs = torch.linalg.eigh(cov)  # ascending
    return eigvecs.flip(-1)[:, :out_dim].contiguous(), mean


def quantize_int8(x: torch.Tensor, dim: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantisation along `dim`: scale = max(absmax, 1e-8) / 127.
    Returns (codes int8, scale f32). `torch.round` rounds half to even, as
    `jnp.round` does. The scale divides by a tensor: CUDA turns a division
    by a Python scalar into a product with its reciprocal, one ulp off."""
    absmax = torch.amax(torch.abs(x), dim=dim, keepdim=True)
    scale = torch.clamp(absmax, min=1e-8) / torch.full_like(absmax, 127.0)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_scale(scale: torch.Tensor) -> torch.Tensor:
    """The scale of `quantize_int8`'s codes as stored (an identity, as in JAX)."""
    return scale


def decode_pq(codebooks: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """Reconstruct vectors from PQ codes: [n, M] -> [n, d] f32."""
    m, _, dsub = codebooks.shape
    gathered = codebooks[torch.arange(m, device=codes.device)[None, :], codes.long()]  # [n, M, dsub]
    return gathered.reshape(codes.shape[0], m * dsub).to(torch.float32)


def train_opq(
    x: torch.Tensor,  # [n, d]
    n_subquantizers: int,
    n_codes: int = 256,
    n_iters: int = 5,
    kmeans_iters: int = 4,
    *,
    generator: torch.Generator,
) -> tuple[torch.Tensor, torch.Tensor]:
    """OPQ: alternate a learned rotation R with PQ codebooks (faiss
    `OPQ{M}_{d}`). Each round refreshes the codebooks on the rotated data,
    warm-started from the previous round, then solves the orthogonal
    Procrustes problem R = U V^T from the SVD of X^T Q(XR); a final k-means
    polish of twice the iterations sharpens the codebooks. Returns (rotation
    [d, d] f32, codebooks [M, n_codes, d/M])."""
    set_full_f32_matmul()
    _, d = x.shape
    x = x.to(torch.float32)
    r = torch.eye(d, dtype=torch.float32, device=x.device)
    codebooks = None
    for _ in range(n_iters):
        xr = x @ r
        codebooks = train_pq(
            xr, n_subquantizers, n_codes=n_codes, n_iters=kmeans_iters, init_codebooks=codebooks, generator=generator
        )
        recon = decode_pq(codebooks, encode_pq(codebooks, xr))
        u, _, vt = torch.linalg.svd(x.T @ recon, full_matrices=False)
        r = u @ vt
    codebooks = train_pq(
        x @ r, n_subquantizers, n_codes=n_codes, n_iters=2 * kmeans_iters, init_codebooks=codebooks,
        generator=generator,
    )
    return r, codebooks


def participation_ratio(x: torch.Tensor) -> float:
    """Effective dimension of a vector set, (sum lam)^2 / sum lam^2 over the
    eigenvalues of the uncentered second moment of its first 32,768 rows."""
    set_full_f32_matmul()
    xs = x[: min(x.shape[0], 32_768)].to(torch.float32)
    cov = (xs.T @ xs) / xs.shape[0]
    lam = torch.clamp(torch.linalg.eigvalsh(cov), min=0.0)
    return float(torch.sum(lam) ** 2 / torch.clamp(torch.sum(lam * lam), min=1e-30))


def anisotropic_eta(threshold: float, dim: float) -> float:
    """ScaNN's parallel/orthogonal weight ratio from a score threshold T:
    h_par/h_perp = (d - 1) T^2 / (1 - T^2), at least 1."""
    t2 = float(threshold) ** 2
    return max(1.0, (dim - 1) * t2 / max(1.0 - t2, 1e-6))


def resolve_aniso_eta(aniso_eta: AnisoEta, train: torch.Tensor) -> typ.Optional[float]:
    """None = anisotropic training off; a float = an explicit ratio; 'auto' =
    the theorem at T = 0.3 and the training sample's participation ratio."""
    if aniso_eta is None:
        return None
    if aniso_eta == "auto":
        return anisotropic_eta(0.3, participation_ratio(train))
    return float(aniso_eta)


def train_pq_codebooks(
    train: torch.Tensor,  # [n, d]
    n_subquantizers: int,
    *,
    n_codes: int,
    kmeans_iters: int,
    use_opq: bool,
    opq_iters: int = 4,
    aniso_eta: AnisoEta = None,
    generator: torch.Generator,
) -> tuple[typ.Optional[torch.Tensor], torch.Tensor, typ.Optional[float]]:
    """The PQ / OPQ [/ anisotropic] training recipe every dense builder shares.
    Returns (rotation or None, codebooks, resolved eta or None); encode the
    database with `encode_pq_auto` and that eta."""
    rotation = None
    if use_opq:
        rotation, codebooks = train_opq(
            train, n_subquantizers, n_codes=n_codes, n_iters=opq_iters,
            kmeans_iters=max(2, kmeans_iters // 2), generator=generator,
        )
        set_full_f32_matmul()
        train_rot = train.to(torch.float32) @ rotation
    else:
        codebooks = train_pq(train, n_subquantizers, n_codes=n_codes, n_iters=kmeans_iters, generator=generator)
        train_rot = train
    eta = resolve_aniso_eta(aniso_eta, train_rot)
    if eta is not None:
        codebooks = train_pq_anisotropic(
            train_rot, n_subquantizers, n_codes=n_codes, eta=eta, n_iters=max(2, kmeans_iters // 2),
            init_codebooks=codebooks, generator=generator,
        )
    return rotation, codebooks, eta


def encode_pq_auto(codebooks: torch.Tensor, x: torch.Tensor, eta: typ.Optional[float] = None) -> torch.Tensor:
    """Database encoding under `train_pq_codebooks`'s objective; `eta` is the
    resolved float it returned (None = plain nearest codeword)."""
    if eta is None:
        return encode_pq(codebooks, x)
    return encode_pq_anisotropic(codebooks, x, eta)


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-9)


def _aniso_loss(x: torch.Tensor, u: torch.Tensor, recon: torch.Tensor, eta: float) -> torch.Tensor:
    """Mean anisotropic loss ||r_perp||^2 + eta ||r_par||^2 over rows."""
    r = x - recon
    par = torch.sum(r * u, dim=-1)
    return torch.mean(torch.sum(r * r, dim=-1) + (eta - 1.0) * par * par)


def _aniso_assign_chunk(
    cb: torch.Tensor,  # [M, K, dsub]
    xc: torch.Tensor,  # [chunk, M, dsub]
    uc: torch.Tensor,  # [chunk, M, dsub]
    codes0: torch.Tensor,  # [chunk, M] int64 warm start
    eta: float,
    sweeps: int,
) -> torch.Tensor:
    """Block-coordinate-descent anisotropic code assignment for one chunk: each
    subspace step scores all K codewords with the other subspaces' parallel
    projection t_rest held fixed,
        loss_k = ||x_m - C_k||^2 + (eta-1) (t_rest + <x_m - C_k, u_m>)^2."""
    m = cb.shape[0]
    em1 = float(eta) - 1.0
    ar = torch.arange(m, device=cb.device)
    codes = codes0.clone()
    for _ in range(sweeps):
        t = torch.sum(torch.sum((xc - cb[ar[None, :], codes]) * uc, dim=-1), dim=-1)
        for mi in range(m):
            cm = cb[mi]  # [K, dsub]
            xm, um = xc[:, mi], uc[:, mi]
            a = torch.sum(cm * cm, dim=-1)[None, :] - 2.0 * (xm @ cm.T)
            b = torch.sum(xm * um, dim=-1, keepdim=True) - um @ cm.T  # [chunk, K]
            b_cur = torch.sum((xm - cm[codes[:, mi]]) * um, dim=-1)
            t_rest = t - b_cur
            new_code = torch.argmin(a + em1 * (t_rest[:, None] + b) ** 2, dim=-1)
            codes[:, mi] = new_code
            t = t_rest + torch.gather(b, 1, new_code[:, None])[:, 0]
    return codes


def encode_pq_anisotropic(
    codebooks: torch.Tensor,
    x: torch.Tensor,
    eta: float,
    sweeps: int = 2,
    chunk: int = 16_384,
) -> torch.Tensor:
    """Encode database vectors under the anisotropic criterion, by coordinate
    descent from the nearest-codeword codes. Returns [n, M] uint8."""
    set_full_f32_matmul()
    n, d = x.shape
    m = codebooks.shape[0]
    dsub = d // m
    x = x.to(torch.float32)
    u = _unit(x)
    cb = codebooks.to(torch.float32)
    parts = []
    for s in range(0, n, chunk):
        xc, uc = x[s : s + chunk].reshape(-1, m, dsub), u[s : s + chunk].reshape(-1, m, dsub)
        parts.append(_aniso_assign_chunk(cb, xc, uc, _nearest_codes(cb, xc), eta, sweeps))
    return torch.cat(parts).to(torch.uint8)


def train_pq_anisotropic(
    x: torch.Tensor,  # [n, d] training vectors
    n_subquantizers: int,
    n_codes: int = 256,
    eta: float = 32.0,
    n_iters: int = 4,
    init_iters: int = 4,
    sweeps: int = 1,
    chunk: int = 16_384,
    init_codebooks: typ.Optional[torch.Tensor] = None,
    *,
    generator: typ.Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Score-aware (anisotropic) PQ codebooks for MIPS (ScaNN, Guo et al.,
    ICML 2020): the loss ||r_perp||^2 + eta ||r_par||^2, r = x - x_hat, by
    alternating coordinate-descent assignment (`_aniso_assign_chunk`) with the
    exact per-codeword weighted least squares

        [n_k I + (eta-1) sum u u^T] c = sum x_m + (eta-1) sum (t_rest + u^T x_m) u.

    Returns [M, n_codes, d/M]. Without `init_codebooks` it starts from a
    `train_pq` of `init_iters` iterations (drawing from `generator`)."""
    set_full_f32_matmul()
    n, d = x.shape
    m = n_subquantizers
    if d % m != 0:
        raise ValueError(f"dim {d} not divisible by n_subquantizers {m}")
    dsub = d // m
    x = x.to(torch.float32)
    xs = x.reshape(n, m, dsub)
    us = _unit(x).reshape(n, m, dsub)
    if init_codebooks is None:
        codebooks = train_pq(x, m, n_codes=n_codes, n_iters=init_iters, generator=generator)
    else:
        codebooks = init_codebooks.to(torch.float32)
    em1 = float(eta) - 1.0
    dev = x.device
    ar = torch.arange(m, device=dev)
    eye = torch.eye(dsub, dtype=torch.float32, device=dev)
    starts = range(0, n, chunk)
    codes_all = [_nearest_codes(codebooks, xs[s : s + chunk]) for s in starts]
    for _ in range(n_iters):
        codes_all = [
            _aniso_assign_chunk(codebooks, xs[s : s + chunk], us[s : s + chunk], c, eta, sweeps)
            for s, c in zip(starts, codes_all)
        ]
        uu = torch.zeros((m, n_codes, dsub, dsub), dtype=torch.float32, device=dev)
        rhs = torch.zeros((m, n_codes, dsub), dtype=torch.float32, device=dev)
        cnt = torch.zeros((m, n_codes), dtype=torch.float32, device=dev)
        for s, codes in zip(starts, codes_all):
            xc, uc = xs[s : s + chunk], us[s : s + chunk]
            b = torch.sum((xc - codebooks[ar[None, :], codes]) * uc, dim=-1)  # [chunk, M]
            t_rest = torch.sum(b, dim=-1, keepdim=True) - b
            coef = t_rest + torch.sum(uc * xc, dim=-1)  # [chunk, M]
            for mi in range(m):
                onehot = torch.nn.functional.one_hot(codes[:, mi], n_codes).to(torch.float32)  # [chunk, K]
                um = uc[:, mi]
                outer = (um[:, :, None] * um[:, None, :]).reshape(-1, dsub * dsub)
                uu[mi] += (onehot.T @ outer).reshape(n_codes, dsub, dsub)
                rhs[mi] += onehot.T @ (xc[:, mi] + em1 * coef[:, mi, None] * um)
                cnt[mi] += torch.sum(onehot, dim=0)
        lhs = cnt[..., None, None] * eye + em1 * uu
        # empty codewords keep their previous centroid (lhs would be singular)
        lhs = torch.where(cnt[..., None, None] > 0, lhs, eye)
        rhs = torch.where(cnt[..., None] > 0, rhs, codebooks)
        codebooks = torch.linalg.solve(lhs, rhs[..., None])[..., 0]
    return codebooks
