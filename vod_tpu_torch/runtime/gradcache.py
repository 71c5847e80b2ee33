"""GradCache: one chunk's activation memory for the dual encoder's gradients
(port of `vod_tpu/runtime/gradcache.py`; Gao et al. 2021, arXiv:2101.06983).

The train step's memory wall is the encoder pass over the fused query +
section rows, not the loss, which only reads the pooled `[rows, H]`
encodings. GradCache splits the backward pass in three with the same
gradients:
  1. a chunked forward under `torch.no_grad()` over the rows of the fused
     pass (`systems.fused_rows`) gives the pooled encodings E, and the
     auxiliary losses the encoder sows in each chunk;
  2. the estimator's loss is differentiated with respect to E (a leaf), and
     any parameter the loss reaches outside the encoder gets its gradient
     here;
  3. each chunk is run again with the graph and `torch.autograd.backward`
     pulls the cached cotangent dE_chunk, and 1 for the chunk's auxiliary
     losses, through to the encoder's parameters, adding into their `.grad`.

Auxiliary losses (the SPLADE FLOPS term) are batch statistics: as in JAX,
each chunk's is evaluated over that chunk and the chunks' are summed, a
different regularizer than the fused pass's. Their value depends on every
row of a chunk, so when the encoder sows one the rows are padded, as JAX
pads them, to a multiple of `chunk_rows` (id 0 with one valid token each, a
zero cotangent). An encoder that sows nothing runs a short last chunk
instead: a padding row adds exactly zero to its gradients.

Over a batch split by a data-parallel axis (`dp`), an encoder that sows
takes JAX's chunks of the global batch's fused rows (all B queries, then
all sections, padded to a multiple of `chunk_rows`), which no rank holds
whole: a rank holds its own queries and their sections, or, with in-batch
negatives, its queries and the whole pool. For each global chunk every rank
encodes its piece of it, in the same order, and the sowers sum their
statistics and row counts over the axis before the square or the product
(`systems.collect_losses(group=, rows=)`), so every rank holds the global
chunk's term. The rows that count are the rank's own: its queries and
sections, the pool's rows of its block only (PR 15's rule: each rank
encodes the whole pool), and JAX's padding rows on rank 0 only. A rank
with no row in a chunk encodes one padding row that counts nowhere, so that
each rank joins each chunk's reductions. The backward of a SUM `all_reduce`
is another one: each rank's rows get the term's gradient W times, and the
average over the axis divides it back to once.
"""

from __future__ import annotations

import dataclasses
import typing as typ

import torch
import torch.nn.functional as F
from torch import nn

from vod_tpu_torch.models.systems import collect_losses, fused_rows
from vod_tpu_torch.types.batch import RealmBatch, RealmOutput


def gradcache_backward(model: nn.Module, batch: RealmBatch, *, chunk_rows: int, dp: typ.Any = None) -> RealmOutput:
    """The retriever loss's gradients at one chunk's activation memory: for a
    Ranker-like `model` (`encode_field`, `gradients`), adds d loss / d param
    into every parameter's `.grad`, as `model(batch).loss.backward()` would
    (plus the sown auxiliary losses, chunk by chunk). `dp`: this rank's
    place in a data-parallel batch (`parallel/mesh.py:DataParallel`), whose
    split puts a sown loss over the global batch's chunks (see the module).
    Returns the estimator's output with `loss` the differentiated total (its
    graph already spent)."""
    ids, mask, b = fused_rows(batch)
    rows = int(ids.shape[0])
    sows = any(hasattr(m, "sown") for m in model.modules())
    if sows and dp is not None and dp.split:
        return _split_backward(model, batch, ids, mask, b, chunk_rows, dp)
    if sows and rows % chunk_rows:
        pad = chunk_rows - rows % chunk_rows
        ids = F.pad(ids, (0, 0, 0, pad))
        mask = F.pad(mask, (0, 0, 0, pad))
        mask[rows:, 0] = 1  # one valid token: an all-padding row would pool to NaN gradients
    starts = range(0, int(ids.shape[0]), chunk_rows)

    # pass 1: the pooled encodings and the chunks' auxiliary losses, no graph kept
    aux = torch.zeros((), device=ids.device)
    with torch.no_grad(), collect_losses(model) as sown:
        enc = torch.cat([model.encode_field(ids[s : s + chunk_rows], mask[s : s + chunk_rows]) for s in starts])
        for a in sown:
            aux = aux + a

    # pass 2: the loss and its cotangent on the encodings
    enc.requires_grad_(True)
    section = enc[b:rows]
    if not batch.extras.get("flat_sections", False):
        section = section.reshape(b, section.shape[0] // b, -1)
    out = model.gradients(batch=batch, query_encoding=enc[:b], section_encoding=section)
    out.loss.backward()
    d_enc = enc.grad

    # pass 3: each chunk again with its graph, pulled back by its cotangent
    # (and by 1 for the chunk's auxiliary losses)
    for s in starts:
        with collect_losses(model) as sown:
            pooled = model.encode_field(ids[s : s + chunk_rows], mask[s : s + chunk_rows])
        torch.autograd.backward([pooled, *sown], [d_enc[s : s + chunk_rows], *(torch.ones_like(a) for a in sown)])
    return dataclasses.replace(out, loss=out.loss.detach() + aux) if sows else out


def _pieces(batch: RealmBatch, b: int, rows: int, chunk_rows: int, dp: typ.Any) -> tuple[list, int]:
    """Each global chunk's piece on this rank: (indices into the local rows,
    then `pad` JAX padding rows at `rows`, then one spare row at `rows + pad`;
    the bool mask of the piece's rows that count). Also returns `pad`."""
    dev = batch.query__input_ids.device
    w, r = dp.size, dp.index
    n_sec = rows - b
    q_glob = r * b + torch.arange(b, device=dev)
    sec = torch.arange(n_sec, device=dev)
    if batch.extras.get("flat_sections", False):  # the whole pool, of which this rank's block counts
        sec_glob, sec_counts, total = w * b + sec, sec * w // n_sec == r, w * b + n_sec
    else:
        sec_glob, sec_counts, total = w * b + r * n_sec + sec, torch.ones_like(sec, dtype=torch.bool), w * (b + n_sec)
    glob = torch.cat([q_glob, sec_glob])
    counts = torch.cat([torch.ones((b,), dtype=torch.bool, device=dev), sec_counts])
    n_chunks = -(-total // chunk_rows)
    pad = n_chunks * chunk_rows - total
    pieces = []
    for c in range(n_chunks):
        lo = c * chunk_rows
        local = torch.nonzero((glob >= lo) & (glob < lo + chunk_rows)).flatten()
        idx, keep = [local], [counts[local]]
        if c == n_chunks - 1 and pad and r == 0:
            idx.append(rows + torch.arange(pad, device=dev))
            keep.append(torch.ones((pad,), dtype=torch.bool, device=dev))
        if sum(int(i.numel()) for i in idx) == 0:
            idx.append(torch.full((1,), rows + pad, device=dev))
            keep.append(torch.zeros((1,), dtype=torch.bool, device=dev))
        pieces.append((torch.cat(idx), torch.cat(keep)))
    return pieces, pad


def _split_backward(model: nn.Module, batch: RealmBatch, ids: torch.Tensor, mask: torch.Tensor, b: int,
                    chunk_rows: int, dp: typ.Any) -> RealmOutput:
    """`gradcache_backward` of a sowing encoder over a split batch: the
    global batch's chunks, each rank encoding its piece of each."""
    rows = int(ids.shape[0])
    pieces, pad = _pieces(batch, b, rows, chunk_rows, dp)
    # JAX's padding rows, then the spare row: id 0 with one valid token
    ids = F.pad(ids, (0, 0, 0, pad + 1))
    mask = F.pad(mask, (0, 0, 0, pad + 1))
    mask[rows:, 0] = 1

    # pass 1: the pooled encodings and the global chunks' auxiliary losses
    aux = torch.zeros((), device=ids.device)
    parts = []
    with torch.no_grad():
        for idx, keep in pieces:
            with collect_losses(model, group=dp.group, rows=keep) as sown:
                parts.append(model.encode_field(ids[idx], mask[idx]))
            for a in sown:
                aux = aux + a
    enc = torch.zeros((rows + pad + 1, parts[0].shape[-1]), dtype=parts[0].dtype, device=ids.device)
    for (idx, _), part in zip(pieces, parts):
        enc[idx] = part
    enc = enc[:rows]

    # pass 2: the loss and its cotangent on this rank's encodings
    enc.requires_grad_(True)
    section = enc[b:]
    if not batch.extras.get("flat_sections", False):
        section = section.reshape(b, section.shape[0] // b, -1)
    out = model.gradients(batch=batch, query_encoding=enc[:b], section_encoding=section)
    out.loss.backward()
    d_enc = F.pad(enc.grad, (0, 0, 0, pad + 1))  # padding and spare rows: a zero cotangent

    # pass 3: each piece again with its graph, in the same order on every rank
    for idx, keep in pieces:
        with collect_losses(model, group=dp.group, rows=keep) as sown:
            pooled = model.encode_field(ids[idx], mask[idx])
        torch.autograd.backward([pooled, *sown], [d_enc[idx], *(torch.ones_like(a) for a in sown)])
    return dataclasses.replace(out, loss=out.loss.detach() + aux)
