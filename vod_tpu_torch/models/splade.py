"""SPLADE learned-sparse encoder (port of `vod_tpu/models/splade.py`).

Queries and documents become vocabulary-space impact vectors

    w_v(x) = max_t log(1 + relu(MLM(x)_{t,v}))          (max over tokens t)

so scoring is a dot product in vocabulary space, served by the impact
postings of `search/sparse.py` (`build_impact_index`, `sparse_search`).

The head is BERT's MLM head: `transform` (Dense + GELU), `transform_norm`,
and a decoder tied to the word embeddings with its own `decoder_bias` (the
`BertForMaskedLM` layout, which `port_splade_weights` reads). The logits are
computed in the activation dtype, masked by the attention mask and
max-pooled over tokens before `log1p(relu(.))` runs in f32: that function
does not decrease, so this is the same value JAX computes by applying it
to every token first, and the gradient reaches the same tied tokens. It
keeps one `[B, T, V]` tensor in the activation dtype instead of several
in f32 (a `[288, 200, 30522]` micro-batch is 3.5 GB in bf16).

With `flops_weight > 0` the forward appends `flops_weight * flops_loss`
to `sown` when a caller collects losses (`systems.collect_losses`): flax's
`sow` into `"losses"`, which is only kept where that collection is mutable.
Over a data-parallel split the collector names the axis's group, and the
term's mean is the global batch's (`flops_loss(group=...)`).

`encode_corpus_terms` sparsifies chunk by chunk on the device, so the
dense `[N, V]` impacts never exist at once (over a mesh, each rank encodes
its block of chunks and the parts are gathered); `splade_topk_terms` breaks ties
to the lowest term id, as `lax.top_k` does.
"""

from __future__ import annotations

import typing as typ

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from vod_tpu_torch.ops.numpy_ops import topk_lowest_first
from .encoder import TransformerEncoder, TransformerEncoderConfig, _dense, _gelu, _LayerNorm, _materialise


def flops_loss(
    impacts: torch.Tensor, *, group: typ.Any = None, rows: typ.Optional[torch.Tensor] = None
) -> torch.Tensor:
    """SPLADE FLOPS regularizer `sum_v (mean_b w_{b,v})^2`. With `group`,
    the mean is over the rows of every rank of the group (their sums and
    count summed by a differentiable `all_reduce`); `rows` masks the rows
    of `impacts` that count (None: all)."""
    if group is None and rows is None:
        return torch.sum(torch.mean(impacts, dim=0) ** 2)
    if rows is None:
        total = torch.cat([impacts.sum(0), impacts.new_full((1,), float(impacts.shape[0]))])
    else:
        keep = rows.to(impacts.dtype)
        total = torch.cat([(impacts * keep[:, None]).sum(0), keep.sum().reshape(1)])
    if group is not None and dist.is_initialized() and dist.get_world_size(group) > 1:
        from torch.distributed.nn.functional import all_reduce

        total = all_reduce(total, group=group)
    return torch.sum((total[:-1] / total[-1]) ** 2)


class SpladeEncoder(nn.Module):
    """Backbone + tied MLM head -> `[B, V]` non-negative f32 impacts.

    Parameters live on `device` (default "cuda"), random-initialised from
    `generator` (BERT's scheme; `decoder_bias` starts at 0)."""

    def __init__(
        self,
        cfg: TransformerEncoderConfig,
        *,
        flops_weight: float = 0.0,
        device: typ.Union[str, torch.device] = "cuda",
        generator: typ.Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.cfg = cfg
        self.flops_weight = flops_weight
        # set by `systems.collect_losses`
        self.sown: typ.Optional[list[torch.Tensor]] = None
        self.sown_group: typ.Any = None
        self.sown_rows: typ.Optional[torch.Tensor] = None
        h = cfg.hidden_size
        self.backbone = TransformerEncoder(cfg, device="meta")
        self.transform = nn.Linear(h, h, device="meta")
        self.transform_norm = _LayerNorm(h, cfg.layer_norm_eps, cfg.dtype, device="meta")
        self.decoder_bias = nn.Parameter(torch.empty(cfg.vocab_size, device="meta"))
        _materialise(self, device, generator)
        with torch.no_grad():
            self.decoder_bias.zero_()

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        dt = self.cfg.dtype
        h = self.backbone(input_ids, attention_mask)  # [B, T, H]
        h = self.transform_norm(_gelu(_dense(h, self.transform, dt)))
        # tied decoder: logits = h @ E^T + b in the activation dtype (two roundings, as in JAX)
        emb = self.backbone.embeddings.word_embeddings.weight
        logits = h @ emb.to(dt).T + self.decoder_bias.to(dt)  # [B, T, V]
        # padding tokens never win the max (a row of padding max-pools to 0)
        logits = logits.masked_fill(~(attention_mask[..., None] > 0), float("-inf"))
        impacts = torch.log1p(torch.relu(torch.amax(logits, dim=1).to(torch.float32)))  # [B, V]
        if self.flops_weight > 0.0 and self.sown is not None:
            self.sown.append(self.flops_weight * flops_loss(impacts, group=self.sown_group, rows=self.sown_rows))
        return impacts


def splade_topk_terms(impacts: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Sparsify `[B, V]` impacts to the top-k terms: (terms `[B, k]` int32,
    -1 where the impact is 0; weights `[B, k]` f32, 0 there). Ties go to the
    lowest term id. Feeds `SearchQueries(terms=..., term_weights=...)`."""
    w, t = topk_lowest_first(impacts, k)
    ok = w > 0.0
    return torch.where(ok, t, -1).to(torch.int32), torch.where(ok, w, torch.zeros_like(w))


def port_splade_weights(
    state_dict: typ.Mapping[str, torch.Tensor], cfg: TransformerEncoderConfig
) -> dict[str, torch.Tensor]:
    """A torch `BertForMaskedLM` state_dict -> `SpladeEncoder.state_dict`.
    The backbone goes through `hf_import.port_bert_weights`; the MLM head
    maps `cls.predictions.transform.*` and the decoder bias
    (`cls.predictions.bias` or `cls.predictions.decoder.bias`). The decoder
    weight is the word embeddings and is not carried separately."""
    from .hf_import import port_bert_weights

    sd = dict(state_dict)

    def g(key: str) -> torch.Tensor:
        return sd[key].detach().to(torch.float32).contiguous()

    out = {f"backbone.{k}": v for k, v in port_bert_weights(sd, cfg).items()}
    bias_key = "cls.predictions.bias" if "cls.predictions.bias" in sd else "cls.predictions.decoder.bias"
    out.update({
        "transform.weight": g("cls.predictions.transform.dense.weight"),
        "transform.bias": g("cls.predictions.transform.dense.bias"),
        "transform_norm.weight": g("cls.predictions.transform.LayerNorm.weight"),
        "transform_norm.bias": g("cls.predictions.transform.LayerNorm.bias"),
        "decoder_bias": g(bias_key),
    })
    return out


def splade_doc_terms(impacts: typ.Any, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Top-k sparsification of a chunk of document impacts `[N, V]` for
    index building: host (terms `[N, k]` int32 / -1, weights `[N, k]` f32)."""
    terms, weights = splade_topk_terms(torch.as_tensor(impacts), k)
    return terms.cpu().numpy(), weights.cpu().numpy()


@torch.no_grad()
def encode_corpus_terms(
    encode_fn: typ.Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    input_ids: torch.Tensor,  # [N, L] tokenized corpus
    attention_mask: torch.Tensor,
    *,
    k: int,
    chunk: int = 256,
    mesh: typ.Any = None,
    dp_axis: str = "dp",
) -> tuple[np.ndarray, np.ndarray]:
    """Chunked corpus encoding with top-k sparsification on the device: the
    dense `[N, V]` impacts never exist at once, only one chunk's. Returns host
    (terms `[N, k]` int32 / -1, weights `[N, k]` f32) for
    `build_impact_index`. `encode_fn(ids, mask) -> [b, V]` is typically the
    SPLADE Ranker's `encode_field`. With `mesh`, the chunks are split over
    `dp_axis` in contiguous blocks (the chunks one process would encode) and
    the parts gathered, so every rank returns the whole corpus's terms."""
    from vod_tpu_torch.parallel.mesh import axis_group, axis_index, axis_size

    n = int(input_ids.shape[0])
    dp = axis_size(mesh, dp_axis)
    per = -(-(-(-n // chunk)) // dp) * chunk if dp > 1 else n  # rows of a rank's block of chunks
    lo = axis_index(mesh, dp_axis) * per if dp > 1 else 0
    hi = min(lo + per, n)
    terms = torch.full((per, k), -1, dtype=torch.int32, device=input_ids.device)
    weights = torch.zeros((per, k), dtype=torch.float32, device=input_ids.device)
    for s in range(lo, hi, chunk):
        e = min(s + chunk, hi)
        terms[s - lo : e - lo], weights[s - lo : e - lo] = splade_topk_terms(
            encode_fn(input_ids[s:e], attention_mask[s:e]), k)
    if dp > 1:
        from vod_tpu_torch.parallel.distributed import all_gather_tensor

        group = axis_group(mesh, dp_axis)
        terms = all_gather_tensor(terms, group).reshape(-1, k)[:n]
        weights = all_gather_tensor(weights, group).reshape(-1, k)[:n]
    return terms.cpu().numpy(), weights.cpu().numpy()
