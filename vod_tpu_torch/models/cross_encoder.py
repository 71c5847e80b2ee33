"""Cross-encoder (monoBERT-style) joint relevance reranker (port of
`vod_tpu/models/cross_encoder.py`).

The pair `[CLS] q [SEP] d [SEP]` goes through one encoder, so every layer
sees both texts; a tanh pooler over `[CLS]` and a scalar classifier give the
score (`BertForSequenceClassification(num_labels=1)`'s layout, which
`port_bert_cross_encoder_weights` reads). The `[B, C]` candidate grid
flattens to `[B*C, L]` rows, scored in chunks; the scores re-rank any first
stage (`cross_encoder_rerank`) or fill the teacher scores that
`DistillationGradients` reads (`fill_teacher_scores`).

`tokenize_pairs` runs on the host through the tokenizer's `text_pair` path:
the port's own WordPiece tokenizer (`data/tokenizer.py`) or a `transformers`
tokenizer.
"""

from __future__ import annotations

import dataclasses
import typing as typ

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vod_tpu_torch.ops.numpy_ops import topk_lowest_first
from vod_tpu_torch.types.retrieval import RetrievalBatch
from .encoder import TransformerEncoder, TransformerEncoderConfig, _materialise

ScoreFn = typ.Callable[..., torch.Tensor]


class CrossEncoder(nn.Module):
    """Backbone + HF-style tanh pooler + scalar relevance head: `forward(ids,
    mask, token_type_ids=None) -> [B]` f32 scores. Parameters live on
    `device` (default "cuda"), random-initialised from `generator`."""

    def __init__(
        self,
        cfg: TransformerEncoderConfig,
        *,
        device: typ.Union[str, torch.device] = "cuda",
        generator: typ.Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.cfg = cfg
        self.backbone = TransformerEncoder(cfg, device="meta")
        self.hf_pooler = nn.Linear(cfg.hidden_size, cfg.hidden_size, device="meta")
        self.classifier = nn.Linear(cfg.hidden_size, 1, device="meta")
        _materialise(self, device, generator)

    def forward(
        self,
        input_ids: torch.Tensor,  # [B, L]
        attention_mask: torch.Tensor,  # [B, L]
        token_type_ids: typ.Optional[torch.Tensor] = None,  # [B, L] 0 = query, 1 = section
    ) -> torch.Tensor:
        h = self.backbone(input_ids, attention_mask, token_type_ids)
        # the pooler and the head are f32 Dense layers over [CLS] cast to f32
        pooled = torch.tanh(F.linear(h[:, 0].to(torch.float32), self.hf_pooler.weight, self.hf_pooler.bias))
        return F.linear(pooled, self.classifier.weight, self.classifier.bias)[:, 0]


def cross_encoder_scores(
    score_fn: ScoreFn,
    pair_input_ids: torch.Tensor,  # [B, C, L] tokenized [CLS] q [SEP] d [SEP]
    pair_attention_mask: torch.Tensor,  # [B, C, L]
    pair_token_type_ids: typ.Optional[torch.Tensor] = None,  # [B, C, L]
    *,
    chunk: int = 256,
) -> torch.Tensor:
    """Raw scores `[B, C]` of a candidate grid: the `[B*C, L]` pairs scored
    `chunk` rows at a time by `score_fn(ids, mask[, types]) -> [rows]`
    (typically a `CrossEncoder`)."""
    b, c, length = pair_input_ids.shape
    ids = pair_input_ids.reshape(b * c, length)
    mask = pair_attention_mask.reshape(b * c, length)
    types = None if pair_token_type_ids is None else pair_token_type_ids.reshape(b * c, length)
    out = []
    for s in range(0, b * c, chunk):
        args = (ids[s : s + chunk], mask[s : s + chunk]) + (() if types is None else (types[s : s + chunk],))
        out.append(score_fn(*args).to(torch.float32))
    return torch.cat(out).reshape(b, c)


def cross_encoder_rerank(
    score_fn: ScoreFn,
    candidates: RetrievalBatch,  # [B, C] first-stage results
    pair_input_ids: torch.Tensor,  # [B, C, L]
    pair_attention_mask: torch.Tensor,
    pair_token_type_ids: typ.Optional[torch.Tensor],
    top_k: int,
    *,
    chunk: int = 256,
) -> RetrievalBatch:
    """Re-score first-stage candidates with the cross-encoder and keep the
    `top_k` by its scores. `-1` candidates score `-inf` and sort last; with
    `top_k > C` the tail is `-inf` / `-1`."""
    c = int(pair_input_ids.shape[1])
    scores = cross_encoder_scores(score_fn, pair_input_ids, pair_attention_mask, pair_token_type_ids, chunk=chunk)
    scores = torch.where(candidates.indices >= 0, scores, float("-inf"))
    k_eff = min(top_k, c)
    top_s, pos = topk_lowest_first(scores, k_eff)
    top_i = torch.gather(candidates.indices, -1, pos)
    if k_eff < top_k:
        top_s = F.pad(top_s, (0, top_k - k_eff), value=float("-inf"))
        top_i = F.pad(top_i, (0, top_k - k_eff), value=-1)
    ok = torch.isfinite(top_s)
    return RetrievalBatch(scores=torch.where(ok, top_s, float("-inf")), indices=torch.where(ok, top_i, -1))


def fill_teacher_scores(
    score_fn: ScoreFn,
    batch: typ.Any,  # RealmBatch
    pair_input_ids: torch.Tensor,  # [B, D, L] (query, section) pairs in batch order
    pair_attention_mask: torch.Tensor,
    pair_token_type_ids: typ.Optional[torch.Tensor] = None,
    *,
    chunk: int = 256,
) -> typ.Any:
    """The batch with `section__teacher_score` set to a frozen cross-encoder's
    scores of its sampled sections (`-inf` where `section__score` is, i.e. at
    padding): the on-the-fly teacher of `DistillationGradients`. The scores
    are computed without a gradient."""
    with torch.no_grad():
        scores = cross_encoder_scores(score_fn, pair_input_ids, pair_attention_mask, pair_token_type_ids, chunk=chunk)
    scores = torch.where(torch.isneginf(batch.section__score), float("-inf"), scores)
    return dataclasses.replace(batch, section__teacher_score=scores)


def listwise_rerank_loss(scores: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Multi-positive listwise CE, `-log sum_pos p` under a softmax over the
    valid candidates (`labels`: 1 positive, 0 negative, -1 padding), averaged
    over the rows that hold a positive."""
    valid = labels >= 0
    masked = torch.where(valid, scores, float("-inf"))
    log_z = torch.logsumexp(masked, dim=-1)
    log_pos = torch.logsumexp(torch.where(labels > 0, masked, float("-inf")), dim=-1)
    has_pos = torch.any(labels > 0, dim=-1)
    loss = torch.where(has_pos, log_z - log_pos, torch.zeros_like(log_z))
    return torch.sum(loss) / torch.clamp(torch.sum(has_pos), min=1).to(loss.dtype)


def port_bert_cross_encoder_weights(
    state_dict: typ.Mapping[str, torch.Tensor], cfg: TransformerEncoderConfig
) -> dict[str, torch.Tensor]:
    """A torch `BertForSequenceClassification` state_dict -> the port's
    `CrossEncoder.state_dict`: the backbone through `port_bert_weights`, the
    HF pooler (`bert.pooler.dense`) and the scalar `classifier` as they are."""
    from .hf_import import port_bert_weights

    sd = dict(state_dict)

    def g(key: str) -> torch.Tensor:
        return sd[key].detach().to(torch.float32).contiguous()

    out = {f"backbone.{k}": v for k, v in port_bert_weights(sd, cfg).items()}
    out.update({
        "hf_pooler.weight": g("bert.pooler.dense.weight"),
        "hf_pooler.bias": g("bert.pooler.dense.bias"),
        "classifier.weight": g("classifier.weight"),
        "classifier.bias": g("classifier.bias"),
    })
    return out


def tokenize_pairs(
    tokenizer: typ.Any,
    queries: typ.Sequence[str],
    sections: typ.Sequence[typ.Sequence[str]],
    *,
    max_length: int = 256,
) -> dict[str, np.ndarray]:
    """Host-side pair tokenization: `[B, C, L]` int32 arrays for
    `cross_encoder_rerank`. Each query is paired with each of its C candidate
    texts through the tokenizer's `text_pair` path (`[SEP]` placement, segment
    ids 0/1, `longest_first` truncation). The candidate lists must be
    rectangular (pad short ones with "")."""
    b = len(queries)
    c = len(sections[0]) if b else 0
    if any(len(s) != c for s in sections):
        raise ValueError("candidate lists must be rectangular; pad with empty strings")
    flat_q = [q for q, secs in zip(queries, sections) for _ in secs]
    flat_d = [d for secs in sections for d in secs]
    enc = tokenizer(
        flat_q, flat_d, max_length=max_length, truncation="longest_first", padding="max_length", return_tensors="np",
    )
    out = {
        "input_ids": np.asarray(enc["input_ids"]).astype(np.int32).reshape(b, c, -1),
        "attention_mask": np.asarray(enc["attention_mask"]).astype(np.int32).reshape(b, c, -1),
    }
    if "token_type_ids" in enc:
        out["token_type_ids"] = np.asarray(enc["token_type_ids"]).astype(np.int32).reshape(b, c, -1)
    return out
