"""Tests of the port that need the card: the CUDA kernels against their plain
versions, the search path on the card against the same path on the CPU, and
one small live-retrieval train step on the card.

They skip where there is no NVIDIA GPU. This file imports no JAX, so it runs
on a machine that has only PyTorch, without the repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q -rs
"""

import numpy as np
import pytest
import torch

from tests.torch_helpers import cuda_device, unit_rows  # noqa: F401  (fixture)
from vod_tpu_torch.ops.mips import (
    _binned_body,
    fused_mips_binned,
    fused_mips_binned_reference,
    _topk_body,
    fused_mips_topk,
    fused_mips_topk_reference,
)
from vod_tpu_torch.search import HybridEngines, SearchQueries, build_dense_index, dense_search

pytestmark = pytest.mark.cuda


def test_binned_kernel_matches_plain_on_card(cuda_device) -> None:
    """int8 exact; f32/bf16 scores within an f32 sum-order bound and ids equal
    wherever the margin exceeds it; n_real masking; duplicate-row ties."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    n, d, b = 8192, 96, 80
    v = torch.randn((n, d), generator=g, device=cuda_device)
    v = v / v.norm(dim=-1, keepdim=True)
    q = torch.randn((b, d), generator=g, device=cuda_device)
    q = q / q.norm(dim=-1, keepdim=True)
    tol = 2 * d * 2.0**-24  # |q| = |v| = 1: twice the f32 sum-order bound gamma_D
    before = fused_mips_binned.launches
    for dtype in (torch.float32, torch.bfloat16):
        for bins, n_real in ((512, n), (1024, n - 77)):
            kw = dict(k=40, bins=bins, n_real=n_real)
            ks, ki = fused_mips_binned(v.to(dtype), q, **kw)
            rs, ri = fused_mips_binned_reference(v.to(dtype), q, **kw)
            assert (ks - rs).abs().max().item() <= tol
            assert ki.max().item() < n_real
            diff = ki != ri
            if diff.any():  # a swap is allowed only inside the tolerance band
                vf = v.to(dtype).float()
                exact = (q.to(dtype).float()[:, None, :] * vf[ki.long()]).sum(-1)
                assert ((exact - rs).abs()[diff] <= 2 * tol).all()
    qi = torch.randint(-127, 128, (b, d), generator=g, device=cuda_device, dtype=torch.int8)
    vi = torch.randint(-127, 128, (n, d), generator=g, device=cuda_device, dtype=torch.int8)
    vi[5 + 512] = vi[5]  # duplicate rows in one bin
    vi[5 + 7 * 512] = vi[5]
    qi[0] = vi[5]  # ... that win it for query 0
    for n_real in (n, 1000, 3):
        ks, ki = fused_mips_binned(vi, qi, k=512, bins=512, n_real=n_real)
        rs, ri = fused_mips_binned_reference(vi, qi, k=512, bins=512, n_real=n_real)
        assert torch.equal(ks, rs) and torch.equal(ki, ri)
    ks, ki = fused_mips_binned(vi, qi, k=4, bins=512)
    assert ki[0, 0].item() == 5
    torch.cuda.synchronize()
    assert fused_mips_binned.launches == before + 8  # 4 float calls, 4 int8 calls


@pytest.mark.parametrize(
    "dtype, d, bins, body",
    [(dt, d, bins, "wgmma") for dt in ("bfloat16", "int8") for d in (64, 96) for bins in (128, 512, 1024)]
    + [
        ("bfloat16", 36, 512, "fma"),  # D % 8 != 0: no TMA
        ("bfloat16", 64, 64, "fma"),  # bins % 128 != 0
        ("float32", 96, 512, "fma"),  # f32 stays on CUDA cores
        ("int8", 36, 512, "fma"),  # D % 16 != 0: __dp4a
    ],
)
def test_binned_kernel_bodies_match_plain_on_card(cuda_device, dtype: str, d: int, bins: int, body: str) -> None:
    """Each body of the binned kernel against the plain version, every cell:
    int8 scores and ids equal; f32/bf16 scores within an f32 sum-order bound
    and ids equal wherever the margin exceeds it; n_real masking (a ragged last
    stride, and fewer real rows than bins); equal rows in one bin, in different
    splits, tie to the lowest id; one launch counted per call, on the body the
    dispatch rule names."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    n = 8192
    if dtype == "int8":
        v = torch.randint(-127, 128, (n, d), generator=g, device=cuda_device, dtype=torch.int8)
        q = torch.randint(-127, 128, (130, d), generator=g, device=cuda_device, dtype=torch.int8)
    else:
        v = torch.randn((n, d), generator=g, device=cuda_device)
        v = (v / v.norm(dim=-1, keepdim=True)).to(getattr(torch, dtype))
        q = torch.randn((130, d), generator=g, device=cuda_device)
        q = q / q.norm(dim=-1, keepdim=True)
    dups = (5, 5 + bins, 5 + 3 * bins)  # one bin, one stride apart and more: different splits at every B
    v[list(dups[1:])] = v[5].clone()
    q[0] = v[5].to(q.dtype)  # ... that win bin 5 for query 0
    tol = 2 * d * 2.0**-24 * 1.01  # twice gamma_D * |q| * |v|; bf16 rounding moves a norm by < 0.5%
    assert _binned_body(v.dtype, d, bins, (v.data_ptr(), q.to(v.dtype).data_ptr())) == body
    before = fused_mips_binned.launches, dict(fused_mips_binned.body_launches)
    calls = 0
    for b in (1, 7, 80, 130):
        qb = q[:b]
        for n_real in (n, n - 77, 3):
            kw = dict(k=bins, bins=bins, n_real=n_real)  # every cell
            ks, ki = fused_mips_binned(v, qb, **kw)
            rs, ri = fused_mips_binned_reference(v, qb, **kw)
            calls += 1
            assert ki.max().item() < n_real
            if dtype == "int8":
                assert torch.equal(ks, rs) and torch.equal(ki, ri)
            else:
                finite = torch.isfinite(rs)
                assert torch.equal(torch.isfinite(ks), finite) and torch.equal(ki[~finite], ri[~finite])
                assert (ks[finite] - rs[finite]).abs().max().item() <= tol
                diff = ki != ri
                if diff.any():  # a swap is allowed only inside the tolerance band
                    exact = (qb.to(v.dtype).double()[:, None, :] * v[ki.long()].double()).sum(-1)
                    assert ((exact - rs.double()).abs()[diff] <= 2 * tol).all()
            if n_real == 3:
                assert (ki[:, 3:] == -1).all()
            if n_real > dups[-1]:
                assert ki[0, 0].item() == 5
    torch.cuda.synchronize()
    assert fused_mips_binned.launches == before[0] + calls
    assert fused_mips_binned.body_launches[body] == before[1][body] + calls
    other = "fma" if body == "wgmma" else "wgmma"
    assert fused_mips_binned.body_launches[other] == before[1][other]


@pytest.mark.parametrize(
    "dtype, d, body",
    [
        ("float32", 96, "fma"),  # f32 stays on CUDA cores
        ("bfloat16", 64, "wgmma"),  # one 64-wide TMA box of K
        ("bfloat16", 96, "wgmma"),  # a ragged second box, zero-filled past D
        ("bfloat16", 36, "fma"),  # D % 8 != 0: no TMA
    ],
)
def test_topk_kernel_matches_plain_on_card(cuda_device, dtype: str, d: int, body: str) -> None:
    """Each body of the exact kernel against the plain version: scores within
    an f32 sum-order bound and ids equal wherever the margin exceeds it; n_real
    masking (a ragged last tile); empty slots -1/-inf; duplicate rows in
    different splits tie to the lowest id; one launch counted per call, on the
    body the dispatch rule names."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    n = 8192
    v = torch.randn((n, d), generator=g, device=cuda_device)
    v = v / v.norm(dim=-1, keepdim=True)
    for j in (1005, 5005):  # in different splits at every B: a split holds at most 256 rows here
        v[j] = v[5]
    q = torch.randn((130, d), generator=g, device=cuda_device)
    q = q / q.norm(dim=-1, keepdim=True)
    q[0] = v[5]
    tol = 2 * d * 2.0**-24 * 1.01  # twice gamma_D * |q| * |v|; bf16 rounding moves a norm by < 0.5%
    vv = v.to(getattr(torch, dtype))
    assert _topk_body(vv.dtype, d, (vv.data_ptr(), q.to(vv.dtype).data_ptr())) == body
    before = fused_mips_topk.launches, dict(fused_mips_topk.body_launches)
    calls = 0
    for b in (1, 7, 80, 130):
        qb = q[:b]
        for k in (1, 10, 128):
            for n_real in (n, n - 77, 3):
                ks, ki = fused_mips_topk(vv, qb, k=k, n_real=n_real)
                rs, ri = fused_mips_topk_reference(vv, qb, k=k, n_real=n_real)
                calls += 1
                finite = torch.isfinite(rs)
                assert torch.equal(torch.isfinite(ks), finite)
                assert (ks[finite] - rs[finite]).abs().max().item() <= tol
                assert ki.max().item() < n_real and torch.equal(ki[~finite], ri[~finite])
                if n_real == 3 and k > 3:
                    assert (ki[:, 3:] == -1).all() and torch.isneginf(ks[:, 3:]).all()
                diff = ki != ri
                if diff.any():  # a swap is allowed only inside the tolerance band
                    exact = (qb.to(vv.dtype).double()[:, None, :] * vv[ki.long()].double()).sum(-1)
                    assert ((exact - rs.double()).abs()[diff] <= 2 * tol).all()
                if n_real > 5005:
                    assert ki[0, : min(k, 3)].tolist() == [5, 1005, 5005][:k]
    torch.cuda.synchronize()
    assert fused_mips_topk.launches == before[0] + calls
    assert fused_mips_topk.body_launches[body] == before[1][body] + calls
    other = "fma" if body == "wgmma" else "wgmma"
    assert fused_mips_topk.body_launches[other] == before[1][other]


@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
def test_dense_search_on_card_matches_cpu(cuda_device, dtype: str) -> None:
    rng = np.random.default_rng(1)
    v = unit_rows(rng, 20000, 64)
    q = v[rng.integers(0, 20000, 16)] + 0.1 * unit_rows(rng, 16, 64)
    out = {}
    for dev in ("cpu", cuda_device):
        ix = build_dense_index(v, dtype=dtype, kernel="fused", refine="float32", device=dev)
        ix = ix.replace(fused_bins=1024)
        out[str(dev)] = dense_search(ix, SearchQueries(vector=torch.from_numpy(q).to(dev)), top_k=10)
    cpu, card = out["cpu"], out[str(cuda_device)]
    torch.testing.assert_close(card.scores.cpu(), cpu.scores, atol=1e-5, rtol=0)
    assert torch.equal(card.indices.cpu()[:, 0], cpu.indices[:, 0])
    assert (card.indices.cpu() == cpu.indices).float().mean().item() >= 0.99


def _held_against_plain(ks, ki, rs, ri, q, v, tol: float) -> None:
    """Kernel (ks, ki) against plain (rs, ri): the same empty slots, scores
    within `tol`, and an id may differ only where its exact score lies within
    the band of the plain score."""
    finite = torch.isfinite(rs)
    assert torch.equal(torch.isfinite(ks), finite) and torch.equal(ki[~finite], ri[~finite])
    assert (ks[finite] - rs[finite]).abs().max().item() <= tol
    diff = ki != ri
    if diff.any():
        exact = (q.to(v.dtype).double()[:, None, :] * v[ki.long()].double()).sum(-1)
        assert ((exact - rs.double()).abs()[diff] <= 2 * tol).all()


def test_binned_wgmma_at_the_train_path_shape(cuda_device) -> None:
    """The train path's call: bf16, D = 384, 512 bins, B = 32, k = 100, on the
    tensor-core body; ids and ties, not only scores: equal rows in one bin
    and in different splits tie to the lowest id, and rows past n_real stay out."""
    g = torch.Generator(device=cuda_device).manual_seed(3)
    n, d, b, bins = 1 << 17, 384, 32, 512
    v = torch.randn((n, d), generator=g, device=cuda_device)
    v = (v / v.norm(dim=-1, keepdim=True)).to(torch.bfloat16)
    dups = (9, 9 + bins, 9 + 100 * bins)
    v[list(dups[1:])] = v[9].clone()
    q = torch.randn((b, d), generator=g, device=cuda_device)
    q = q / q.norm(dim=-1, keepdim=True)
    q[0] = v[9].float()
    tol = 2 * d * 2.0**-24 * 1.01
    assert _binned_body(v.dtype, d, bins, (v.data_ptr(), q.to(v.dtype).data_ptr())) == "wgmma"
    before = dict(fused_mips_binned.body_launches)
    for n_real in (n, n - 77):
        ks, ki = fused_mips_binned(v, q, k=100, bins=bins, n_real=n_real)
        rs, ri = fused_mips_binned_reference(v, q, k=100, bins=bins, n_real=n_real)
        _held_against_plain(ks, ki, rs, ri, q, v, tol)
        assert ki.max().item() < n_real and ki[0, 0].item() == 9
    assert fused_mips_binned.body_launches["wgmma"] == before["wgmma"] + 2
    assert fused_mips_binned.body_launches["fma"] == before["fma"]


def test_train_step_on_card(cuda_device, monkeypatch) -> None:
    """One small live-retrieval Realm step on the card (bf16 activations, a
    bf16 index with kernel "fused" at D = 64): finite loss and gradient norm,
    the encoder, the reader and each optimizer group moved, and the step's `fused_mips_binned` call launched
    once on the tensor-core body and held against the plain version."""
    from vod_tpu_torch.models import CausalLMConfig, Realm, TransformerEncoderConfig, VodGradients, VodPoolerConfig
    from vod_tpu_torch.runtime import QueryBatch, adamw, build_device_corpus, make_train_step
    from vod_tpu_torch.search import dense as dense_module

    g = torch.Generator(device=cuda_device).manual_seed(0)
    sizes = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=2, intermediate_size=128)
    pooler = VodPoolerConfig(agg_method="mean", output_norm="l2", scaler=10.0, learn_scaler=True)
    model = Realm(TransformerEncoderConfig(pooler=pooler, **sizes), CausalLMConfig(**sizes),
                  VodGradients(alpha=0.5), device=cuda_device, generator=g)
    n, b = 4096, 8
    corpus = build_device_corpus(torch.randint(1, 512, (n, 24), generator=g, device=cuda_device),
                                 torch.ones((n, 24), dtype=torch.int32, device=cuda_device))
    emb = torch.randn((n, 64), generator=g, device=cuda_device)
    index = build_dense_index(emb / emb.norm(dim=-1, keepdim=True), kernel="fused", device=cuda_device)
    queries = QueryBatch(
        input_ids=torch.randint(1, 512, (b, 8), generator=g, device=cuda_device),
        attention_mask=torch.ones((b, 8), dtype=torch.int32, device=cuda_device),
        section_ids=torch.randint(0, n, (b, 2), generator=g, device=cuda_device, dtype=torch.int32),
        answer_ids=torch.randint(1, 512, (b, 4), generator=g, device=cuda_device),
        answer_mask=torch.ones((b, 4), dtype=torch.int32, device=cuda_device),
    )
    calls = []

    def recording(vectors, q, **kw):
        out = fused_mips_binned(vectors, q, **kw)
        calls.append((vectors, q.clone(), kw, out))
        return out

    monkeypatch.setattr(dense_module, "fused_mips_binned", recording)
    step = make_train_step(model, adamw(model, 5e-5, weight_decay=0.0), prefetch=32, n_sections=4,
                           max_pos_sections=2, with_lm=True, gradient_clip_val=1.0)
    before_params = {k: p.detach().clone() for k, p in model.named_parameters()}
    before = dict(fused_mips_binned.body_launches)
    metrics, rel, scores = step.train_step(HybridEngines(dense=index), corpus, queries, g, {"dense": 1.0})
    torch.cuda.synchronize()
    assert torch.isfinite(metrics["loss"]) and torch.isfinite(metrics["grad_norm"])
    assert rel.shape == scores.shape == (b, 4)
    moved = {k for k, p in model.named_parameters() if not torch.equal(p, before_params[k])}
    assert any(k.startswith("encoder.") for k in moved) and any(k.startswith("lm.") for k in moved)
    assert all(any(id(p) in map(id, grp["params"]) for k, p in model.named_parameters() if k in moved)
               for grp in step.optimizer.param_groups)  # every parameter group took a step
    assert fused_mips_binned.body_launches["wgmma"] == before["wgmma"] + 1
    assert fused_mips_binned.body_launches["fma"] == before["fma"]
    (vectors, q, kw, (ks, ki)), = calls
    rs, ri = fused_mips_binned_reference(vectors, q, **kw)
    tol = 2 * 64 * 2.0**-24 * q.float().norm(dim=-1).max().item() * 1.01
    _held_against_plain(ks, ki, rs, ri, q, vectors, tol)


@pytest.mark.parametrize("d", [32, 64])
def test_binned_int8_wgmma_at_the_pq_coarse_widths(cuda_device, d: int) -> None:
    """The PQ coarse stage's kernel calls: int8 at D = coarse_dim (32, the
    factory default, where three quarters of each 128-byte TMA box of K is
    zero fill; 64, the `pq` preset), k = bins = 512, B = 32 and 64: every cell
    bit for bit against the plain version, on the tensor-core body, with a
    ragged last stride and equal rows in different splits."""
    g = torch.Generator(device=cuda_device).manual_seed(d)
    n, bins = 1 << 16, 512
    v = torch.randint(-127, 128, (n, d), generator=g, device=cuda_device, dtype=torch.int8)
    q = torch.randint(-127, 128, (64, d), generator=g, device=cuda_device, dtype=torch.int8)
    v[[5 + bins, 5 + 100 * bins]] = v[5].clone()
    q[0] = v[5]
    assert _binned_body(torch.int8, d, bins, (v.data_ptr(), q.data_ptr())) == "wgmma"
    before = dict(fused_mips_binned.body_launches)
    for b in (32, 64):
        for n_real in (n, n - 77):
            kw = dict(k=bins, bins=bins, tile=1024, n_real=n_real)
            ks, ki = fused_mips_binned(v, q[:b], **kw)
            rs, ri = fused_mips_binned_reference(v, q[:b], **kw)
            assert torch.equal(ks, rs) and torch.equal(ki, ri)
            assert ki[0, 0].item() == 5 and ki.max().item() < n_real
    assert fused_mips_binned.body_launches["wgmma"] == before["wgmma"] + 4
    assert fused_mips_binned.body_launches["fma"] == before["fma"]


@pytest.mark.parametrize("coarse_dim", [30, 64])
def test_pq_coarse_search_on_card_matches_cpu(cuda_device, coarse_dim: int) -> None:
    """A PQ index with a fused coarse stage, built on the CPU and copied to the
    card: `pq_search` on the card launches `fused_mips_binned` once, on
    `wgmma` (coarse_dim 30 is padded to 32), and returns the CPU's ids."""
    import dataclasses

    from vod_tpu_torch.search import build_pq_index, pq_search

    rng = np.random.default_rng(2)
    v = unit_rows(rng, 8192, 96)
    q = v[rng.integers(0, 8192, 40)] + 0.1 * unit_rows(rng, 40, 96)
    ix = build_pq_index(v, n_subquantizers=8, coarse_dim=coarse_dim, n_candidates=512, refine="int8", k_factor=4,
                        kernel="fused", kmeans_iters=4, generator=torch.Generator().manual_seed(0), device="cpu")
    card = dataclasses.replace(ix, **{f.name: getattr(ix, f.name).to(cuda_device) for f in dataclasses.fields(ix)
                                      if isinstance(getattr(ix, f.name), torch.Tensor)})
    before = dict(fused_mips_binned.body_launches)
    got = pq_search(card, SearchQueries(vector=torch.from_numpy(q).to(cuda_device)), top_k=10)
    want = pq_search(ix, SearchQueries(vector=torch.from_numpy(q)), top_k=10)
    assert fused_mips_binned.body_launches["wgmma"] == before["wgmma"] + 1
    assert torch.equal(got.indices.cpu(), want.indices)
    torch.testing.assert_close(got.scores.cpu(), want.scores, atol=1e-5, rtol=1e-5)


def test_native_analyzer_builds_on_the_card_machine(cuda_device) -> None:
    """The machine with the card builds the port's analyzer with `g++`, so the
    BM25 build there never falls back to the Python loops."""
    from vod_tpu_torch.native import analyze_texts, fnv1a_id, native_available

    assert native_available()
    ids, counts = analyze_texts(["Hello hello World"], use_stopwords=False)
    assert counts.tolist() == [3] and ids[0, 0] == ids[0, 1] == fnv1a_id("hello", 1 << 18)


def test_sparse_search_on_card_matches_cpu(cuda_device) -> None:
    """BM25 on the card against the same call on the CPU, on seeded postings
    (repeated and invalid terms, a subset filter, k above L*P): the same
    empty slots; scores within 1e-5 (the card's `scatter_add_` sums a doc's
    <= L contributions in atomics' order, a few ulps of scores below 40);
    ids equal wherever the margin to the next score exceeds that."""
    from vod_tpu_torch.search import build_sparse_index_native, sparse_search

    rng = np.random.default_rng(4)
    n, n_terms = 5000, 512
    p = 1.0 / np.arange(1, n_terms + 1)
    docs = [rng.choice(n_terms, size=int(rng.integers(10, 60)), p=p / p.sum()).tolist() for _ in range(n)]
    subsets = (np.arange(n) % 5).astype(np.int32)
    terms = rng.choice(n_terms, size=(48, 8), p=p / p.sum()).astype(np.int32)
    terms[0, 1] = terms[0, 0]
    terms[1, 3:] = -1
    terms[2, 0] = n_terms + 7
    allowed = np.full((48, 2), -1, np.int32)
    allowed[::3, 0] = 2
    out = {}
    for dev in ("cpu", cuda_device):
        ix = build_sparse_index_native(docs, n_terms=n_terms, max_postings=256, subset_ids=subsets, device=dev)
        for k in (100, 8 * 256 + 5):
            q = SearchQueries(terms=torch.from_numpy(terms).to(dev), subset_ids=torch.from_numpy(allowed).to(dev))
            out[str(dev), k] = sparse_search(ix, q, k)
    for k in (100, 8 * 256 + 5):
        cpu, card = out["cpu", k], out[str(cuda_device), k]
        finite = torch.isfinite(cpu.scores)
        assert torch.equal(torch.isfinite(card.scores.cpu()), finite)
        assert (card.scores.cpu()[finite] - cpu.scores[finite]).abs().max().item() <= 1e-5
        margin = torch.cat([cpu.scores[:, :-1] - cpu.scores[:, 1:], torch.full((48, 1), float("inf"))], dim=-1)
        gap_before = torch.cat([torch.full((48, 1), float("inf")), margin[:, :-1]], dim=-1)
        clear = (torch.minimum(margin, gap_before) > 1e-5) & finite
        assert torch.equal(card.indices.cpu()[clear], cpu.indices[clear])
        assert torch.equal(card.indices.cpu()[~finite], cpu.indices[~finite])


# ---- the readers' generation on the card ------------------------------------------


def _margin_equal(got: torch.Tensor, want: torch.Tensor, scores: torch.Tensor, tol: float) -> int:
    """Tokens equal per row up to the first step whose top-2 margin of
    `scores` [B, T, V] is under `tol`; returns the number compared."""
    top2 = scores.float().topk(2, dim=-1).values
    close = (top2[..., 0] - top2[..., 1]) < tol
    compared = 0
    for r in range(got.shape[0]):
        n = int(close[r].nonzero()[0, 0]) if close[r].any() else got.shape[1]
        assert torch.equal(got[r, :n].cpu(), want[r, :n].cpu()), r
        compared += n
    return compared


def _causal_lm(device, dtype=torch.float32):
    from vod_tpu_torch.models import CausalLM, CausalLMConfig

    cfg = CausalLMConfig(vocab_size=512, hidden_size=128, num_layers=2, num_heads=4, intermediate_size=256,
                         max_position_embeddings=128, dtype=dtype)
    return CausalLM(cfg, device=device, generator=torch.Generator(device=device).manual_seed(0))


def _seq2seq_lm(device, dtype=torch.float32):
    from vod_tpu_torch.models import Seq2SeqLM, T5EncoderConfig

    cfg = T5EncoderConfig(vocab_size=512, hidden_size=128, num_layers=2, num_heads=4, head_dim=32,
                          intermediate_size=256, dtype=dtype)
    return Seq2SeqLM(cfg, device=device, generator=torch.Generator(device=device).manual_seed(0))


def _prompts(device, b: int = 6, length: int = 40):
    g = torch.Generator(device=device).manual_seed(1)
    ids = torch.randint(2, 512, (b, length), generator=g, device=device, dtype=torch.int32)
    lengths = torch.tensor([40, 33, 5, 17, 40, 26], device=device)[:b]
    mask = (torch.arange(length, device=device)[None] < lengths[:, None]).to(torch.int32)
    return ids * mask, mask


@pytest.mark.parametrize("dtype, tol", [(torch.float32, 1e-4), (torch.bfloat16, 0.1)])
def test_causal_prefill_decode_matches_teacher_forced_on_card(cuda_device, dtype, tol: float) -> None:
    """`lm_generate` on the card over right-padded prompts: each step's logits
    (from prefill, then each decode step) within `tol` of the teacher-forced
    forward over prompt + generated tokens (f32: sum order; bf16: a few ulps
    of the hidden states through the f32 head), and each token the argmax of
    those logits wherever their top-2 margin exceeds `tol`."""
    from vod_tpu_torch.models import lm_generate

    model = _causal_lm(cuda_device, dtype)
    ids, mask = _prompts(cuda_device)
    t = 12
    toks = lm_generate(model, ids, mask, max_new_tokens=t)
    with torch.no_grad():
        logits, cache = model.prefill(ids, mask, ids.shape[1] + t, last_only=True)
        steps = [logits[:, 0]]
        for i in range(t - 1):
            logits, cache = model.decode_step(toks[:, i], cache)
            steps.append(logits)
        steps = torch.stack(steps, dim=1)
        lengths = mask.sum(-1)
        full = torch.zeros((ids.shape[0], ids.shape[1] + t), dtype=torch.int32, device=cuda_device)
        full[:, : ids.shape[1]] = ids
        rows = torch.arange(ids.shape[0], device=cuda_device)[:, None]
        at = lengths[:, None] + torch.arange(t, device=cuda_device)[None]
        full[rows, at] = toks
        full_mask = (torch.arange(full.shape[1], device=cuda_device)[None] < (lengths + t)[:, None]).to(torch.int32)
        forced = model(full, full_mask)[rows, at - 1]  # the logits before each generated token
    assert (steps - forced).abs().max().item() <= tol
    assert _margin_equal(toks, forced.argmax(-1), forced, tol) > 0


def test_seq2seq_decode_matches_teacher_forced_on_card(cuda_device) -> None:
    """Greedy `generate` on the card: each cached step's logits within 1e-4
    (f32) of the teacher-forced `Seq2SeqLM.forward` over BOS + the tokens."""
    from vod_tpu_torch.models import generate

    model = _seq2seq_lm(cuda_device)
    ids, mask = _prompts(cuda_device)
    t = 12
    toks = generate(model, ids, mask, max_new_tokens=t, eos_id=-1)
    with torch.no_grad():
        mem = model.encode(ids, mask)
        cache = model.init_cache(mem, t)
        prev = torch.zeros(ids.shape[0], dtype=torch.int32, device=cuda_device)
        steps = []
        for i in range(t):
            logits, cache = model.decode_step(prev, i, mask, cache)
            steps.append(logits)
            prev = toks[:, i]
        dec_in = torch.cat([torch.zeros_like(toks[:, :1]), toks[:, :-1]], dim=1)
        forced = model(ids, mask, dec_in, torch.ones_like(dec_in))
    assert (torch.stack(steps, dim=1) - forced).abs().max().item() <= 1e-4
    assert _margin_equal(toks, forced.argmax(-1), forced, 1e-4) > 0


def test_decode_steps_never_wait_for_the_card(cuda_device) -> None:
    """One decode step of each reader with every synchronizing CUDA call made
    an error (after a first step, which builds the T5 bucket tables)."""
    from vod_tpu_torch.models import lm_generate

    causal, s2s = _causal_lm(cuda_device, torch.bfloat16), _seq2seq_lm(cuda_device, torch.bfloat16)
    ids, mask = _prompts(cuda_device)
    with torch.no_grad():
        logits, cache = causal.prefill(ids, mask, ids.shape[1] + 4, last_only=True)
        tok = logits[:, 0].argmax(-1).to(torch.int32)
        cache = causal.decode_step(tok, cache)[1]
        mem = s2s.encode(ids, mask)
        s2s_cache = s2s.init_cache(mem, 4)
        s2s_cache = s2s.decode_step(tok, 0, mask, s2s_cache)[1]
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            causal.decode_step(tok, cache)
            s2s.decode_step(tok, 1, mask, s2s_cache)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert lm_generate(causal, ids, mask, max_new_tokens=3).shape == (ids.shape[0], 3)


def test_beam_search_on_card_matches_cpu(cuda_device) -> None:
    """`beam_generate` (4 beams, an EOS the beams reach) on the card against
    the same call on the CPU at f32: tokens equal, scores within 1e-4."""
    from vod_tpu_torch.models import beam_generate

    cpu = _seq2seq_lm("cpu")
    card = _seq2seq_lm(cuda_device)
    card.load_state_dict(cpu.state_dict())
    ids, mask = _prompts("cpu")
    kw = dict(num_beams=4, max_new_tokens=10, eos_id=7)
    want_t, want_s = beam_generate(cpu, ids, mask, **kw)
    got_t, got_s = beam_generate(card, ids.to(cuda_device), mask.to(cuda_device), **kw)
    assert torch.equal(got_t.cpu(), want_t)
    assert (got_s.cpu() - want_s).abs().max().item() <= 1e-4


def _ivfpq_cpu_and_card(cuda_device, **kw):
    """An IVF-PQ index built on the CPU (2^14 x 64 rows around 64 centres),
    and the same tensors copied to the card."""
    import dataclasses

    from vod_tpu_torch.search import build_ivfpq_index

    rng = np.random.default_rng(4)
    centres = unit_rows(rng, 64, 64)
    v = centres[rng.integers(0, 64, 1 << 14)] + 0.3 * unit_rows(rng, 1 << 14, 64)
    v = (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)
    q = v[rng.integers(0, 1 << 14, 70)] + 0.1 * unit_rows(rng, 70, 64)
    ix = build_ivfpq_index(v, n_clusters=64, nprobe=8, window=128, kmeans_iters=4,
                           generator=torch.Generator().manual_seed(0), device="cpu", **kw)
    card = dataclasses.replace(ix, **{f.name: getattr(ix, f.name).to(cuda_device) for f in dataclasses.fields(ix)
                                      if isinstance(getattr(ix, f.name), torch.Tensor)})
    return ix, card, torch.from_numpy(q.astype(np.float32))


IVFPQ_CARD_MODES = {
    "serving-int8-pca": dict(refine="int8", refine_dim=32, keep_codes=False),
    "adc8": dict(n_subquantizers=16),
    "spilled-adc4-rerank": dict(n_subquantizers=16, code_bits=4, spill=True, rerank="int8", k_factor=4),
}


@pytest.mark.parametrize("mode", list(IVFPQ_CARD_MODES))
def test_ivfpq_search_on_card_matches_cpu(cuda_device, mode: str) -> None:
    """`ivfpq_search` on the card returns the CPU path's answers: int8
    products exact on both, bf16 ADC decode products summed in f32 in another
    order (scores within 1e-5; ids equal wherever the margin exceeds that)."""
    from vod_tpu_torch.search import SearchQueries, ivfpq_search

    ix, card, q = _ivfpq_cpu_and_card(cuda_device, **IVFPQ_CARD_MODES[mode])
    for b in (1, 64, 70):
        want = ivfpq_search(ix, SearchQueries(vector=q[:b]), 10)
        got = ivfpq_search(card, SearchQueries(vector=q[:b].to(cuda_device)), 10)
        torch.testing.assert_close(got.scores.cpu(), want.scores, atol=1e-5, rtol=0)
        gi, wi, ws = got.indices.cpu(), want.indices, want.scores
        for r, c in (gi != wi).nonzero().tolist():
            where = (wi[r] == gi[r, c]).nonzero()
            other = ws[r, where[0, 0]] if len(where) else ws[r, -1]
            assert abs(other - ws[r, c]).item() <= 2e-5


@pytest.mark.parametrize("mode", ["serving-int8-pca", "adc8"])
def test_ivfpq_search_never_waits_for_the_card(cuda_device, mode: str) -> None:
    """The collate calls `ivfpq_search` inside the train step: with every
    synchronizing CUDA call an error, a search (after a warm-up) runs."""
    from vod_tpu_torch.search import SearchQueries, ivfpq_search

    _, card, q = _ivfpq_cpu_and_card(cuda_device, **IVFPQ_CARD_MODES[mode])
    qs = SearchQueries(vector=q[:64].to(cuda_device))
    ivfpq_search(card, qs, 10)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = ivfpq_search(card, qs, 10)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert out.indices.shape == (64, 10) and bool((out.indices >= 0).all())


def test_binned_int8_wgmma_at_2048_bins(cuda_device) -> None:
    """The autotune grid's fused point on the PQ serving codec: int8 coarse
    codes at D = 64, bins 2048, tile 16384, B = 64, k = 80 (k_factor 8 x 10)
    and every cell (k = bins), bit for bit against the plain version, on the
    tensor-core body, with a ragged last stride and equal rows in one bin."""
    g = torch.Generator(device=cuda_device).manual_seed(2048)
    n, d, bins = 1 << 17, 64, 2048
    v = torch.randint(-127, 128, (n, d), generator=g, device=cuda_device, dtype=torch.int8)
    q = torch.randint(-127, 128, (64, d), generator=g, device=cuda_device, dtype=torch.int8)
    v[[11 + bins, 11 + 40 * bins]] = v[11].clone()
    q[0] = v[11]
    assert _binned_body(torch.int8, d, bins, (v.data_ptr(), q.data_ptr())) == "wgmma"
    before = dict(fused_mips_binned.body_launches)
    for k, n_real in ((80, n), (bins, n), (bins, n - 77)):
        kw = dict(k=k, bins=bins, tile=16384, n_real=n_real)
        ks, ki = fused_mips_binned(v, q, **kw)
        rs, ri = fused_mips_binned_reference(v, q, **kw)
        assert torch.equal(ks, rs) and torch.equal(ki, ri)
        assert ki[0, 0].item() == 11 and ki.max().item() < n_real
    assert fused_mips_binned.body_launches["wgmma"] == before["wgmma"] + 3
    assert fused_mips_binned.body_launches["fma"] == before["fma"]


def test_cli_main_on_card_launches_the_kernel_each_micro_batch(cuda_device, tmp_path) -> None:
    """The experiment CLI on the card at toy widths: `main` over a BeIR
    directory of 4,096 generated sections with a flat bf16 `kernel: fused`
    index: finite losses, and `fused_mips_binned` launched once per
    micro-batch (2 per optimizer step), all on the tensor-core body."""
    import json

    from vod_tpu_torch.exps import cli

    rng = np.random.default_rng(0)
    words = [f"w{i}" for i in range(500)]
    beir = tmp_path / "beir"
    (beir / "qrels").mkdir(parents=True)
    texts = [" ".join(rng.choice(words, size=24)) for _ in range(4096)]
    (beir / "corpus.jsonl").write_text("".join(json.dumps({"_id": f"d{i}", "title": "t", "text": x}) + "\n"
                                               for i, x in enumerate(texts)))
    (beir / "queries.jsonl").write_text("".join(json.dumps({"_id": f"q{i}", "text": texts[i][:40]}) + "\n"
                                                for i in range(64)))
    (beir / "qrels" / "train.tsv").write_text("".join(f"q{i}\td{i}\t1\n" for i in range(64)))
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "t", *words]
    (tmp_path / "vocab").mkdir()
    (tmp_path / "vocab" / "vocab.txt").write_text("\n".join(vocab))
    cfg = tmp_path / "exp.yaml"
    cfg.write_text(f"""\
extends: [model/realm-vod]
model: {{vocab_size: {len(vocab)}, hidden_size: 64, num_layers: 1, num_heads: 2, intermediate_size: 128,
        lm_hidden_size: 64, lm_num_layers: 1}}
tokenizer: {{name_or_path: '{tmp_path / "vocab"}', max_length: 32}}
collate: {{prefetch_n_sections: 16, n_sections: 4, max_pos_sections: 1}}
dataloader: {{batch_size: 8}}
search_defaults: {{dense: {{codec: flat, dtype: bfloat16, kernel: fused}}}}
trainer: {{max_steps: 2, period: 1, log_interval: 1, accumulate_grad_batches: 2}}
datasets:
  queries: [{{identifier: q, name_or_path: beir, subsets: ['{beir}'], split: train, link: s}}]
  sections: [{{identifier: s, name_or_path: beir, subsets: ['{beir}']}}]
""")
    before = dict(fused_mips_binned.body_launches)
    out = cli.main(["--config", str(cfg)])
    torch.cuda.synchronize()
    after = dict(fused_mips_binned.body_launches)
    assert out["state"].step == 2 and next(out["model"].parameters()).is_cuda
    assert all(np.isfinite(h["train"]["loss"]) for h in out["history"])
    assert after["wgmma"] - before["wgmma"] == 2 * 2 and after["fma"] == before["fma"]


def _lora_encoder(device, cfg_kw: dict, state: dict = None):
    from vod_tpu_torch.models import TransformerEncoderConfig, VodEncoder, VodPoolerConfig

    cfg = TransformerEncoderConfig(pooler=VodPoolerConfig(agg_method="mean", output_norm="l2", scaler=10.0,
                                                          learn_scaler=True), **cfg_kw)
    enc = VodEncoder(cfg, device=device, generator=torch.Generator(device=device).manual_seed(0))
    if state is not None:
        enc.load_state_dict(state)
    return enc


def test_kbit_lora_remat_on_card_matches_cpu(cuda_device) -> None:
    """A LoRA encoder with nonzero adapters, int8-frozen by `kbit_prepare`, with
    remat, on the card and on the CPU from the same weights: codes and scales
    equal exactly, f32 encodings within 1e-4 and the trainable gradients
    within 1e-4 of their largest entry (TF32 off; other sum orders)."""
    from vod_tpu_torch.models import QuantizedLeaf, kbit_prepare, lora_trainable_mask

    torch.backends.cuda.matmul.allow_tf32 = False
    kw = dict(vocab_size=300, hidden_size=128, num_layers=2, num_heads=4, intermediate_size=256, lora_rank=4,
              remat=True, dtype=torch.float32)
    cpu = _lora_encoder("cpu", kw)
    with torch.no_grad():
        for name, p in cpu.named_parameters():
            if name.endswith("lora_b"):
                p.normal_(0.0, 0.05, generator=torch.Generator().manual_seed(1))
    card = _lora_encoder(cuda_device, kw, {k: v.to(cuda_device) for k, v in cpu.state_dict().items()})
    kbs = [kbit_prepare(m, lora_trainable_mask(m)) for m in (cpu, card)]
    n_quantized = 0
    for name, leaf in kbs[0].frozen.items():
        other = kbs[1].frozen[name]
        if isinstance(leaf, QuantizedLeaf):
            n_quantized += 1
            assert torch.equal(leaf.codes, other.codes.cpu()) and torch.equal(leaf.scale, other.scale.cpu()), name
        else:
            assert torch.equal(leaf, other.cpu()), name
    assert n_quantized == 3 + 2 * 9
    g = torch.Generator().manual_seed(2)
    ids = torch.randint(0, 300, (6, 40), generator=g)
    mask = torch.ones_like(ids)
    mask[3:, 25:] = 0
    w = torch.randn((6, 128), generator=g)
    outs, grads = [], []
    for m, dev in ((cpu, "cpu"), (card, cuda_device)):
        out = m(ids.to(dev), mask.to(dev))
        (out * w.to(dev)).sum().backward()
        outs.append(out.detach().cpu())
        grads.append({n: p.grad.cpu() for n, p in m.named_parameters()})
    assert (outs[0] - outs[1]).abs().max().item() <= 1e-4
    for name, gc in grads[0].items():
        assert (gc - grads[1][name]).abs().max().item() <= 1e-4 * max(gc.abs().max().item(), 1e-6), name


def test_gradcache_on_card_matches_monolithic(cuda_device) -> None:
    """One collated micro-batch of a small bf16 Ranker on the card (LoRA over
    an int8 base, remat): GradCache's gradients at 8 rows a chunk against the
    monolithic backward, relative L2 within 1e-2 (bf16 activations: the chunk
    shapes change the products' blocking), and a control (another
    micro-batch's gradients) far above it."""
    from vod_tpu_torch.models import (
        Ranker,
        RetrievalGradients,
        TransformerEncoderConfig,
        VodPoolerConfig,
        kbit_prepare,
        lora_trainable_mask,
    )
    from vod_tpu_torch.runtime import QueryBatch, build_device_corpus, gradcache_backward, make_train_step

    g = torch.Generator(device=cuda_device).manual_seed(0)
    cfg = TransformerEncoderConfig(vocab_size=512, hidden_size=128, num_layers=2, num_heads=2, intermediate_size=256,
                                   lora_rank=8, remat=True,
                                   pooler=VodPoolerConfig(agg_method="mean", output_norm="l2", scaler=10.0,
                                                          learn_scaler=True))
    model = Ranker(cfg, RetrievalGradients(), device=cuda_device, generator=g)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("lora_b"):
                p.normal_(0.0, 0.02, generator=g)
    kbit_prepare(model, lora_trainable_mask(model))
    n = 2048
    corpus = build_device_corpus(torch.randint(1, 512, (n, 32), generator=g, device=cuda_device),
                                 torch.ones((n, 32), dtype=torch.int32, device=cuda_device), device=cuda_device)
    emb = torch.randn((n, 128), generator=g, device=cuda_device)
    engines = HybridEngines(dense=build_dense_index(emb / emb.norm(dim=-1, keepdim=True), kernel="fused",
                                                    device=cuda_device))
    step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=0.0), prefetch=32, n_sections=8,
                           max_pos_sections=2, gradcache_chunk_rows=8)

    def queries(seed):
        gq = torch.Generator(device=cuda_device).manual_seed(seed)
        return QueryBatch(input_ids=torch.randint(1, 512, (4, 16), generator=gq, device=cuda_device),
                          attention_mask=torch.ones((4, 16), dtype=torch.int32, device=cuda_device),
                          section_ids=torch.randint(0, n, (4, 2), generator=gq, device=cuda_device,
                                                    dtype=torch.int32))

    def grads(fn):
        model.zero_grad(set_to_none=True)
        fn()
        return torch.cat([p.grad.float().reshape(-1) for p in model.parameters()])

    batches = [step.collate(engines, corpus, queries(s), g, {"dense": 1.0}) for s in (1, 2)]
    mono = grads(lambda: model(batches[0]).loss.backward())
    cached = grads(lambda: gradcache_backward(model, batches[0], chunk_rows=8))
    other = grads(lambda: model(batches[1]).loss.backward())
    rel = ((cached - mono).norm() / mono.norm()).item()
    control = ((other - mono).norm() / mono.norm()).item()
    assert rel <= 1e-2 and control > 10 * 1e-2, (rel, control)


def test_adafactor_on_card_matches_plain(cuda_device) -> None:
    """Three Adafactor steps on the card against the same steps on the CPU
    (factored and unfactored leaves, a zero leaf, weight decay): parameters
    within 1e-6 of their largest entry."""
    from vod_tpu_torch.runtime import Adafactor

    g = torch.Generator().manual_seed(0)
    shapes = [(256, 130), (3, 200, 160), (7, 5), (64,), (), (8, 4096)]
    init = [0.1 * torch.randn(s, generator=g) for s in shapes] + [torch.zeros(130, 129)]
    sides = []
    for dev in ("cpu", cuda_device):
        params = [torch.nn.Parameter(p.clone().to(dev)) for p in init]
        sides.append((params, Adafactor(params, 1e-2, weight_decay=0.01)))
    for _ in range(3):
        grads = [torch.randn(p.shape, generator=g) for p in init]
        for params, opt in sides:
            for p, gr in zip(params, grads):
                p.grad = gr.to(p.device)
            opt.step()
    for a, b in zip(*(s[0] for s in sides)):
        assert (a.detach() - b.detach().cpu()).abs().max().item() <= 1e-6 * max(a.abs().max().item(), 1e-3)


def test_binned_wgmma_at_d1024(cuda_device) -> None:
    """The large-encoder CLI loop's call: bf16, D = 1024 (16 boxes of K),
    N = 2^15, 512 bins, B = 4, k = 100, on the tensor-core body, held against
    the plain version (scores within twice the f32 sum-order bound, ids equal
    outside that band), with equal rows tied to the lowest id."""
    g = torch.Generator(device=cuda_device).manual_seed(1024)
    n, d, b, bins = 1 << 15, 1024, 4, 512
    v = torch.randn((n, d), generator=g, device=cuda_device)
    v = (v / v.norm(dim=-1, keepdim=True)).to(torch.bfloat16)
    v[[5 + bins, 5 + 30 * bins]] = v[5].clone()
    q = torch.randn((b, d), generator=g, device=cuda_device)
    q = q / q.norm(dim=-1, keepdim=True)
    q[0] = v[5].float()
    tol = 2 * d * 2.0**-24 * 1.01
    assert _binned_body(v.dtype, d, bins, (v.data_ptr(), q.to(v.dtype).data_ptr())) == "wgmma"
    before = dict(fused_mips_binned.body_launches)
    for n_real in (n, n - 77):
        ks, ki = fused_mips_binned(v, q, k=100, bins=bins, n_real=n_real)
        rs, ri = fused_mips_binned_reference(v, q, k=100, bins=bins, n_real=n_real)
        _held_against_plain(ks, ki, rs, ri, q, v, tol)
        assert ki.max().item() < n_real and ki[0, 0].item() == 5
    assert fused_mips_binned.body_launches["wgmma"] == before["wgmma"] + 2
    assert fused_mips_binned.body_launches["fma"] == before["fma"]


def _splade_ranker(device, dtype=torch.float32, vocab: int = 512, seed: int = 0):
    from vod_tpu_torch.models import Ranker, RetrievalGradients, TransformerEncoderConfig

    cfg = TransformerEncoderConfig(vocab_size=vocab, hidden_size=64, num_layers=2, num_heads=2, intermediate_size=128,
                                   dtype=dtype)
    return Ranker(cfg, RetrievalGradients(), splade_encoder=True, splade_flops_weight=1e-3, device=device,
                  generator=torch.Generator(device=device).manual_seed(seed))


def test_splade_on_card_matches_cpu(cuda_device) -> None:
    """SPLADE impacts (f32) on the card against the same weights on the CPU
    within 1e-4; bf16 on the card: non-negative, finite, padding-invariant;
    the FLOPS term is collected in the loss pass and under GradCache."""
    from vod_tpu_torch.models import collect_losses
    from vod_tpu_torch.runtime import gradcache_backward
    from vod_tpu_torch.types import RealmBatch

    model = _splade_ranker(cuda_device)
    cpu = _splade_ranker("cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    g = torch.Generator(device=cuda_device).manual_seed(1)
    ids = torch.randint(5, 512, (6, 24), generator=g, device=cuda_device)
    mask = (torch.arange(24, device=cuda_device)[None] < torch.tensor([[24], [20], [9], [1], [24], [16]],
                                                                        device=cuda_device)).to(torch.int32)
    with torch.no_grad():
        card, host = model.encode_field(ids, mask), cpu.encode_field(ids.cpu(), mask.cpu())
    assert (card.cpu() - host).abs().max().item() <= 1e-4
    bf = _splade_ranker(cuda_device, torch.bfloat16)
    with torch.no_grad():
        a = bf.encode_field(ids, mask)
        b = bf.encode_field(torch.where(mask > 0, ids, 7), mask)
    assert bool(torch.isfinite(a).all()) and bool((a >= 0).all()) and torch.equal(a, b)
    b_, d = 2, 4
    rel = torch.zeros((b_, d), device=cuda_device)
    rel[:, 0] = 1.0
    batch = RealmBatch(
        query__input_ids=ids[:b_], query__attention_mask=mask[:b_],
        section__input_ids=torch.randint(5, 512, (b_ * d, 24), generator=g, device=cuda_device),
        section__attention_mask=torch.ones((b_ * d, 24), dtype=torch.int32, device=cuda_device),
        section__relevance=rel, section__idx=torch.zeros((b_, d), dtype=torch.int32, device=cuda_device),
        section__score=torch.zeros((b_, d), device=cuda_device),
        section__sparse=torch.zeros((b_, d), device=cuda_device),
        section__log_weight=torch.full((b_, d), -1.3863, device=cuda_device),
    )
    with collect_losses(model) as sown:
        out = model(batch)
    assert len(sown) == 1 and float(sown[0].detach()) > 0.0
    model.zero_grad(set_to_none=True)
    cached = gradcache_backward(model, batch, chunk_rows=4)  # 10 rows padded to 12
    # the chunks' FLOPS terms (each over its own 4 rows) ride in the GradCache loss
    assert float(cached.loss) > float(out.loss.detach()) and np.isfinite(float(cached.loss))
    assert all(p.grad is not None and bool(torch.isfinite(p.grad).all()) for p in model.parameters())


def test_splade_train_step_on_card_never_waits(cuda_device) -> None:
    """Learned-sparse live retrieval on the card: query impacts -> top-k
    terms -> the learned index, one optimizer step under sync-debug "error"
    after a warm-up; the parameters move."""
    from vod_tpu_torch.models import encode_corpus_terms
    from vod_tpu_torch.runtime import QueryBatch, build_device_corpus, make_train_step
    from vod_tpu_torch.search import build_impact_index

    model = _splade_ranker(cuda_device, torch.bfloat16)
    g = torch.Generator(device=cuda_device).manual_seed(2)
    n = 512
    corpus = build_device_corpus(torch.randint(5, 512, (n, 32), generator=g, device=cuda_device),
                                 torch.ones((n, 32), dtype=torch.int32, device=cuda_device), device=cuda_device)
    terms, weights = encode_corpus_terms(model.encode_field, corpus.input_ids, corpus.attention_mask, k=64)
    engines = HybridEngines(sparse=build_impact_index(terms, weights, n_terms=512, max_postings=256,
                                                      device=cuda_device))
    step = make_train_step(model, torch.optim.AdamW(model.parameters(), lr=1e-3), prefetch=32, n_sections=8,
                           splade_query_k=32, gradient_clip_val=1.0)

    def queries(seed):
        gq = torch.Generator(device=cuda_device).manual_seed(seed)
        return QueryBatch(input_ids=torch.randint(5, 512, (4, 16), generator=gq, device=cuda_device),
                          attention_mask=torch.ones((4, 16), dtype=torch.int32, device=cuda_device),
                          section_ids=torch.randint(0, n, (4, 1), generator=gq, device=cuda_device,
                                                    dtype=torch.int32))

    step.train_step(engines, corpus, queries(1), g, {"sparse": 1.0})
    before = model.encoder.transform.weight.detach().clone()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        metrics, _, _ = step.train_step(engines, corpus, queries(2), g, {"sparse": 1.0})
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert np.isfinite(float(metrics["loss"])) and not torch.equal(before, model.encoder.transform.weight)


def test_maxsim_and_dynamic_int8_on_card_equal_cpu(cuda_device) -> None:
    """int8 MaxSim rerank scores and int8 dynamic-store search (ids and
    scores) on the card equal the CPU path bit for bit."""
    from vod_tpu_torch.search import (
        build_maxsim_index,
        dynamic_add,
        dynamic_delete,
        dynamic_from_dense,
        dynamic_search,
        maxsim_rerank,
    )

    g = torch.Generator(device=cuda_device).manual_seed(3)
    tok = torch.randn((512, 16, 128), generator=g, device=cuda_device)
    mask = torch.rand((512, 16), generator=g, device=cuda_device) > 0.3
    q = torch.randn((8, 8, 128), generator=g, device=cuda_device)
    qm = torch.ones((8, 8), dtype=torch.bool, device=cuda_device)
    cand = torch.randint(-1, 512, (8, 64), generator=g, device=cuda_device, dtype=torch.int32)
    idx = build_maxsim_index(tok, mask, codec="int8")
    idx_cpu = build_maxsim_index(tok.cpu(), mask.cpu(), codec="int8")
    assert torch.equal(idx.token_codes.cpu(), idx_cpu.token_codes)
    assert torch.equal(maxsim_rerank(idx, q, qm, cand).cpu(), maxsim_rerank(idx_cpu, q.cpu(), qm.cpu(), cand.cpu()))
    x = unit_rows(np.random.default_rng(4), 3000, 96)
    stores = [dynamic_from_dense(torch.from_numpy(x).to(dev), capacity=4096, dtype="int8")
              for dev in (cuda_device, "cpu")]
    extra = torch.from_numpy(unit_rows(np.random.default_rng(5), 2000, 96))
    out = []
    for s in stores:
        dev = s.vectors.device
        s, ids = dynamic_add(s, extra.to(dev))
        assert int((ids == -1).sum()) == 3000 + 2000 - 4096
        s = dynamic_delete(s, torch.arange(0, 3000, 7, dtype=torch.int32, device=dev))
        r = dynamic_search(s, SearchQueries(vector=torch.from_numpy(x[:32]).to(dev)), top_k=10)
        out.append((r.indices.cpu(), r.scores.cpu()))
    assert torch.equal(out[0][0], out[1][0]) and torch.equal(out[0][1], out[1][1])


def test_cross_encoder_and_cache_on_card(cuda_device, tmp_path) -> None:
    """Cross-encoder scores (f32) on the card within 1e-4 of the CPU's;
    `cached_embeddings` on the card: the miss writes, the hit reads back bit
    for bit."""
    from vod_tpu_torch.models import CrossEncoder, TransformerEncoderConfig, cross_encoder_scores
    from vod_tpu_torch.runtime import build_device_corpus, cached_embeddings

    cfg = TransformerEncoderConfig(vocab_size=512, hidden_size=64, num_layers=2, num_heads=2, intermediate_size=128,
                                   dtype=torch.float32)
    model = CrossEncoder(cfg, device=cuda_device, generator=torch.Generator(device=cuda_device).manual_seed(6))
    cpu = CrossEncoder(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    g = torch.Generator(device=cuda_device).manual_seed(7)
    ids = torch.randint(5, 512, (3, 5, 20), generator=g, device=cuda_device)
    types = (torch.arange(20, device=cuda_device) >= 8).to(torch.int32).expand(3, 5, 20)
    mask = torch.ones_like(ids)
    with torch.no_grad():
        card = cross_encoder_scores(model, ids, mask, types, chunk=4)
        host = cross_encoder_scores(cpu, ids.cpu(), mask.cpu(), types.cpu())
    assert (card.cpu() - host).abs().max().item() <= 1e-4
    ranker = _splade_ranker(cuda_device, torch.bfloat16)
    corpus = build_device_corpus(ids.reshape(15, 20), mask.reshape(15, 20), device=cuda_device)
    miss = cached_embeddings(ranker.encode_field, ranker, corpus, cache_dir=str(tmp_path), dataset_fingerprint="d")
    hit = cached_embeddings(ranker.encode_field, ranker, corpus, cache_dir=str(tmp_path), dataset_fingerprint="d")
    assert hit.device == miss.device and torch.equal(hit, miss)


@pytest.mark.parametrize("world, backend", [(1, "nccl"), (2, "gloo")], ids=["w1-nccl", "w2-gloo-one-card"])
def test_per_shard_binned_call_matches_plain_on_card(cuda_device, world: int, backend: str, tmp_path) -> None:
    """The sharded int8 index's per-shard `fused_mips_binned` call on the card
    (`search/sharded.py`): at world size 1 under NCCL, and on two ranks of the
    one card under gloo (NCCL refuses two ranks on one GPU). Each rank's
    call takes the `wgmma` body and equals its plain version; a shard of
    padding only (n_real cut to put every real row on rank 0) returns -1 and
    the int8 sentinel; every rank merges the same answer."""
    from tests.torch_helpers import job_shard_kernel, run_ranks

    n = 1 << 16
    out = run_ranks(job_shard_kernel, world, tmp_path, n, 256, 64, 10, device="cuda", backend=backend)
    for rank, r in enumerate(out):
        assert r["body"] == "wgmma"
        assert r["full"]["launched"] == 1 and r["full"]["equal"] and r["full"]["local_real"] == n // world
        assert r["cut"]["launched"] == 1 and r["cut"]["equal"]
        assert r["cut"]["empty"] == (rank > 0)
        np.testing.assert_array_equal(r["full"]["ids"], out[0]["full"]["ids"])
        np.testing.assert_array_equal(r["cut"]["ids"], out[0]["cut"]["ids"])
        assert (r["cut"]["ids"] < n // world - 100).all() and (r["cut"]["ids"] >= 0).all()


@pytest.mark.parametrize("world, backend", [(1, "nccl"), (2, "gloo")], ids=["nccl-1", "gloo-2"])
def test_sharded_compressed_engines_on_card_match_cpu(cuda_device, world: int, backend: str, tmp_path) -> None:
    """The sharded PQ, IVF, IVF-PQ and MaxSim searches (`search/sharded.py`)
    on the card against the same shards on the CPU: at world size 1 under
    NCCL, and on two ranks of the one card under gloo. int8 products are
    exact on both devices, so the PQ, IVF-PQ and MaxSim answers are equal;
    IVF's bf16 products are summed in f32 in another order: scores within
    1e-4 and ids equal where the margin to both neighbours exceeds it."""
    from tests.torch_helpers import job_compressed_on_card, run_ranks

    out = run_ranks(job_compressed_on_card, world, tmp_path, 4096, 64, 16, 10, device="cuda", backend=backend)
    for r in out:
        for name in ("pq", "ivfpq"):
            (cs, ci), (gs, gi) = r[name]
            np.testing.assert_array_equal(gi, ci, err_msg=name)
            np.testing.assert_allclose(gs, cs, atol=1e-5, rtol=0, err_msg=name)
        (cs, ci), (gs, gi) = r["ivf"]
        np.testing.assert_allclose(gs, cs, atol=1e-4, rtol=0)
        gap = np.minimum(np.abs(np.diff(cs, axis=1, prepend=np.inf)), np.abs(np.diff(cs, axis=1, append=-np.inf)))
        np.testing.assert_array_equal(gi[gap > 1e-4], ci[gap > 1e-4])
        np.testing.assert_array_equal(r["maxsim"][1], r["maxsim"][0])
        np.testing.assert_array_equal(r["ivfpq"][1][1], out[0]["ivfpq"][1][1])  # the same merged answer on every rank


def test_moe_ffn_on_card_matches_cpu(cuda_device) -> None:
    """`MoEFFN` in f32 on the card against the same module on the CPU: the
    same experts routed (the smallest top-2 gap printed), outputs and aux
    within 1e-5, gradients within 1e-4 (TF32 off)."""
    from tests.torch_helpers import moe_module
    from vod_tpu_torch.ops.numpy_ops import topk_lowest_first

    rng = np.random.default_rng(0)
    state = {"gate": (rng.standard_normal((64, 8)) / 8).astype(np.float32),
             "wi": (rng.standard_normal((8, 64, 96)) / 8).astype(np.float32),
             "wo": (rng.standard_normal((8, 96, 64)) / 8).astype(np.float32)}
    x = rng.standard_normal((4, 24, 64)).astype(np.float32)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        outs = []
        for dev in (torch.device("cpu"), cuda_device):
            moe = moe_module(state, 2, 1.0).to(dev)
            xt = torch.from_numpy(x).to(dev).requires_grad_(True)
            probs = torch.softmax(torch.einsum("bth,he->bte", xt.detach(), moe.gate.detach()), -1)
            y, aux = moe(xt)
            (y.pow(2).sum() + aux).backward()
            outs.append((topk_lowest_first(probs, 2)[1].cpu(), probs.cpu(), y.detach().cpu(), aux.detach().cpu(),
                         {n: p.grad.cpu() for n, p in moe.named_parameters()}, xt.grad.cpu()))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    (e0, p0, y0, a0, g0, x0), (e1, _, y1, a1, g1, x1) = outs
    srt = p0.sort(-1, descending=True).values
    print(f"smallest gap between the 2nd and 3rd gate probability: {float((srt[..., 1] - srt[..., 2]).min()):.3e}")
    assert torch.equal(e0, e1)
    torch.testing.assert_close(y1, y0, atol=1e-5, rtol=0)
    torch.testing.assert_close(a1, a0, atol=1e-5, rtol=0)
    for name in g0:
        torch.testing.assert_close(g1[name], g0[name], atol=1e-4, rtol=0)
    torch.testing.assert_close(x1, x0, atol=1e-4, rtol=0)


def test_ring_and_pipeline_at_w1_on_card_equal_the_plain_encoder(cuda_device) -> None:
    """`sp_encoder_forward` and `pp_encoder_forward` with no mesh (one rank)
    on the card against the encoder's own forward, bf16 and f32."""
    from vod_tpu_torch.models.encoder import TransformerEncoder, TransformerEncoderConfig, init_weights
    from vod_tpu_torch.parallel import pp_encoder_forward, sp_encoder_forward

    g = torch.Generator(device=cuda_device).manual_seed(0)
    ids = torch.randint(1, 512, (8, 64), generator=g, device=cuda_device)
    mask = (torch.rand((8, 64), generator=g, device=cuda_device) > 0.2).to(torch.int32)
    mask[0] = 0
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 6e-2)):
        enc = TransformerEncoder(TransformerEncoderConfig(vocab_size=512, hidden_size=128, num_layers=4, num_heads=4,
                                                          intermediate_size=256, dtype=dtype), device=cuda_device)
        init_weights(enc, torch.Generator(device=cuda_device).manual_seed(1))
        with torch.no_grad():
            ref = enc(ids, mask).float()
            sp = sp_encoder_forward(enc, ids, mask).float()
            pp = pp_encoder_forward(enc, ids, mask, n_micro=4).float()
        assert (sp - ref).abs().max().item() <= tol
        assert (pp - ref).abs().max().item() <= (1e-5 if dtype == torch.float32 else tol)


def test_block_topk_on_card_equals_torch_topk_and_the_cpu(cuda_device) -> None:
    """`ops/topk.py:block_topk` over wide f32 rows: the values equal
    `torch.topk`'s and the CPU's exactly, and the ids equal the CPU's (both
    take the lowest index among ties; the rows hold ties on purpose)."""
    from vod_tpu_torch.ops.topk import block_topk

    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn((8, 300_001), generator=g, device=cuda_device)
    x[:, 1000:1100] = x[:, :100]  # duplicated values: ties inside and across blocks
    for k, block in ((10, 1024), (100, 4096)):
        s, i = block_topk(x, k, block=block)
        ts, _ = torch.topk(x, k)
        cs, ci = block_topk(x.cpu(), k, block=block)
        assert torch.equal(s, ts) and torch.equal(s.cpu(), cs) and torch.equal(i.cpu(), ci)
        assert torch.equal(torch.gather(x, -1, i), s)
