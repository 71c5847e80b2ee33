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
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from vod_tpu_torch.models.systems import collect_losses, fused_rows
from vod_tpu_torch.types.batch import RealmBatch, RealmOutput


def gradcache_backward(model: nn.Module, batch: RealmBatch, *, chunk_rows: int) -> RealmOutput:
    """The retriever loss's gradients at one chunk's activation memory: for a
    Ranker-like `model` (`encode_field`, `gradients`), adds d loss / d param
    into every parameter's `.grad`, as `model(batch).loss.backward()` would
    (plus the sown auxiliary losses, chunk by chunk). Returns the estimator's
    output with `loss` the differentiated total (its graph already spent)."""
    ids, mask, b = fused_rows(batch)
    rows = int(ids.shape[0])
    sows = any(hasattr(m, "sown") for m in model.modules())
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
