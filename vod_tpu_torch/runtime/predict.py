"""Embedding computation: re-embed a tokenized corpus with the current encoder
(port of `vod_tpu/runtime/predict.py`), and the fingerprint-keyed embedding
cache on disk (`cached_embeddings`).

`encode_fn(input_ids, attention_mask) -> [b, H]` is typically a system's
`encode_field`; a kbit-prepared model (`models/kbit.py`) dequantizes inside
its layers' forward, so its re-embed runs through the kbit view, as JAX's
`full_params` gives it. It runs under `torch.no_grad()`, chunk by chunk; the result
stays on the corpus's device, in f32 (or `dtype`), and feeds the index build
directly. Nothing here waits for the device.

Over a mesh (`mesh`, `dp_axis`), the chunks go to the axis's ranks in
contiguous blocks (JAX shards the chunk axis over `dp`), each rank embeds
its block, and the blocks are gathered to every rank (JAX returns one
global array): every rank ends with the whole `[N, H]` matrix.
"""

from __future__ import annotations

import typing as typ

import numpy as np
import torch

from .collate import DeviceCorpus

EncodeFn = typ.Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


@torch.no_grad()
def compute_embeddings(
    encode_fn: EncodeFn,
    corpus: DeviceCorpus,
    *,
    chunk: int = 512,
    dtype: torch.dtype = torch.float32,
    mesh: typ.Any = None,
    dp_axis: str = "dp",
) -> torch.Tensor:
    """Embed every corpus row. Returns [N, H] on the corpus's device (with
    `mesh`: the chunks split over `dp_axis`, the result on every rank)."""
    from vod_tpu_torch.parallel.mesh import axis_group, axis_index, axis_size

    dp = axis_size(mesh, dp_axis)
    if dp > 1:
        from vod_tpu_torch.parallel.distributed import all_gather_tensor

        n = corpus.size
        per = -(-(-(-n // chunk)) // dp) * chunk  # rows of a rank's block of chunks
        lo = axis_index(mesh, dp_axis) * per
        hi = min(lo + per, n)
        probe = encode_fn(corpus.input_ids[:1], corpus.attention_mask[:1])
        block = torch.zeros((per, int(probe.shape[-1])), dtype=dtype, device=probe.device)
        for s in range(lo, hi, chunk):
            e = min(s + chunk, hi)
            block[s - lo : e - lo] = encode_fn(corpus.input_ids[s:e], corpus.attention_mask[s:e]).to(dtype)
        return all_gather_tensor(block, axis_group(mesh, dp_axis)).reshape(dp * per, -1)[:n]
    out: typ.Optional[torch.Tensor] = None
    n = corpus.size
    for s in range(0, n, chunk):
        vecs = encode_fn(corpus.input_ids[s : s + chunk], corpus.attention_mask[s : s + chunk])
        if out is None:
            out = torch.empty((n, int(vecs.shape[-1])), dtype=dtype, device=vecs.device)
        out[s : s + vecs.shape[0]] = vecs.to(dtype)
    if out is None:
        raise ValueError("compute_embeddings needs a non-empty corpus")
    return out


@torch.no_grad()
def compute_embeddings_to_host(
    encode_fn: EncodeFn,
    ids_np: typ.Any,  # numpy [N, L] host token ids
    mask_np: typ.Optional[typ.Any] = None,  # numpy [N, L]; None = ids != 0
    *,
    chunk: int = 512,
    slab: int = 131_072,
    out: typ.Optional[np.ndarray] = None,  # preallocated numpy [N, H] to fill
    out_dtype: typ.Any = None,  # numpy dtype, default float32
    device: typ.Union[str, torch.device] = "cuda",
) -> np.ndarray:
    """Embed a corpus larger than device memory: host token slabs go to
    `device` one at a time, chunk by chunk through the encoder, and the
    vectors come back to host RAM. Returns numpy [N, H]."""
    n = int(ids_np.shape[0])
    out_np = out
    for s0 in range(0, n, slab):
        ids = torch.as_tensor(np.asarray(ids_np[s0 : s0 + slab]), device=device).to(torch.int32)
        if mask_np is not None:
            mask = torch.as_tensor(np.asarray(mask_np[s0 : s0 + slab]), device=device).to(torch.int32)
        else:
            mask = (ids != 0).to(torch.int32)
        vecs = torch.cat([encode_fn(ids[c : c + chunk], mask[c : c + chunk]) for c in range(0, ids.shape[0], chunk)])
        if out_np is None:
            out_np = np.empty((n, int(vecs.shape[-1])), out_dtype or np.float32)
        out_np[s0 : s0 + vecs.shape[0]] = vecs.to(torch.float32).cpu().numpy()
    return out_np


def cached_embeddings(
    encode_fn: EncodeFn,
    params: typ.Any,
    corpus: DeviceCorpus,
    *,
    cache_dir: str,
    dataset_fingerprint: str,
    chunk: int = 512,
) -> torch.Tensor:
    """`compute_embeddings` behind a store on disk keyed by (dataset, weights,
    dim): `params` is what `fingerprint_params` hashes (the model whose
    `encode_fn` this is). A store that exists is read back (float32, to the
    corpus's device) unless the zero-vector probe finds a hole or the store
    cannot be decoded (`types/lazy.py:UnreadableStore`); then the embeddings
    are computed and written over it."""
    from vod_tpu_torch.types.lazy import TensorStoreFactory, UnreadableStore
    from vod_tpu_torch.utils.cache import cached_artifact_path
    from vod_tpu_torch.utils.fingerprint import fingerprint, fingerprint_params

    with torch.no_grad():
        dim = int(encode_fn(corpus.input_ids[:1], corpus.attention_mask[:1]).shape[-1])
    fp = fingerprint({"dataset": dataset_fingerprint, "params": fingerprint_params(params), "dim": dim})
    factory = TensorStoreFactory(cached_artifact_path(cache_dir, "vectors", fp), (corpus.size, dim))
    if factory.exists():
        try:
            vecs = factory.open().read()
        except UnreadableStore:
            vecs = None
        # zero-vector probe: a row of zeros is a hole, and the store is recomputed
        if vecs is not None and not (np.abs(vecs).sum(axis=-1) == 0).any():
            return torch.from_numpy(vecs).to(corpus.input_ids.device)
    emb = compute_embeddings(encode_fn, corpus, chunk=chunk)
    factory.instantiate().write(emb.cpu().numpy())
    return emb
