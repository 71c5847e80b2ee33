"""GradCache: one chunk's activation memory for the dual encoder's gradients
(port of `vod_tpu/runtime/gradcache.py`; Gao et al. 2021, arXiv:2101.06983).

The train step's memory wall is the encoder pass over the fused query +
section rows, not the loss, which only reads the pooled `[rows, H]`
encodings. GradCache splits the backward pass in three with the same
gradients:
  1. a chunked forward under `torch.no_grad()` over the rows of the fused
     pass (`systems.fused_rows`) gives the pooled encodings E;
  2. the estimator's loss is differentiated with respect to E (a leaf), and
     any parameter the loss reaches outside the encoder gets its gradient
     here;
  3. each chunk is run again with the graph and
     `torch.autograd.backward(E_chunk, dE_chunk)` pulls the cached cotangent
     through to the encoder's parameters, adding into their `.grad`.

Declared difference: JAX pads the rows to a multiple of `chunk_rows` (one
valid token in each padding row, a zero cotangent) so that its `lax.scan`
has one shape; here the last chunk is short. A padding row adds exactly
zero to every gradient, so the two give the same gradients.
"""

from __future__ import annotations

import torch
from torch import nn

from vod_tpu_torch.models.systems import fused_rows
from vod_tpu_torch.types.batch import RealmBatch, RealmOutput


def gradcache_backward(model: nn.Module, batch: RealmBatch, *, chunk_rows: int) -> RealmOutput:
    """The retriever loss's gradients at one chunk's activation memory: for a
    Ranker-like `model` (`encode_field`, `gradients`), adds d loss / d param
    into every parameter's `.grad`, as `model(batch).loss.backward()` would.
    Returns the estimator's output (its graph already spent by the backward)."""
    ids, mask, b = fused_rows(batch)
    starts = range(0, ids.shape[0], chunk_rows)

    # pass 1: the pooled encodings, no graph kept
    with torch.no_grad():
        enc = torch.cat([model.encode_field(ids[s : s + chunk_rows], mask[s : s + chunk_rows]) for s in starts])

    # pass 2: the loss and its cotangent on the encodings
    enc.requires_grad_(True)
    section = enc[b:]
    if not batch.extras.get("flat_sections", False):
        section = section.reshape(b, section.shape[0] // b, -1)
    out = model.gradients(batch=batch, query_encoding=enc[:b], section_encoding=section)
    out.loss.backward()
    d_enc = enc.grad

    # pass 3: each chunk again with its graph, pulled back by its cotangent
    for s in starts:
        pooled = model.encode_field(ids[s : s + chunk_rows], mask[s : s + chunk_rows])
        torch.autograd.backward(pooled, d_enc[s : s + chunk_rows])
    return out
