"""Gradient estimators: functions of (batch, encodings[, lm_logits]) that
return a `RealmOutput` whose loss `backward()` differentiates (port of
`vod_tpu/models/gradients.py`).

  * `RetrievalGradients`: KL to binary relevance, REINFORCE-style weight
    `w = (p_model - 1[pos]) / Np` (detached), optional auxiliary losses, and
    detached KL diagnostics against the sampling distributions;
  * `MarginalLikelihoodGradients`: `-log sum_z p_ret(z|q) p_lm(x|z)` with
    length-normalized shifted LM log-probs;
  * `DistillationGradients`: cross-encoder teacher margins or listwise KL;
  * `VodGradients`: the Rényi bound of arXiv:2210.06345 with the
    importance correction from the priority-sampling weights.

`jax.lax.stop_gradient` is `.detach()` here. Padding slots (score -inf) are
kept out with `torch.where`, whose backward pass sends no gradient to the
branch it did not select, as `jnp.where` does; so the gradients stay finite
where a row has padding slots.
"""

from __future__ import annotations

import typing as typ

import torch

from vod_tpu_torch.ops.numpy_ops import masked_log_softmax
from vod_tpu_torch.types.batch import RealmBatch, RealmOutput

GuidanceType = typ.Literal["sparse", "zero"]
_NEG_INF = float("-inf")


def _compute_retriever_scores(
    query_encoding: torch.Tensor,  # [B, H]
    section_encoding: torch.Tensor,  # [B, D, H] or [BD_flat, H]
    mask: torch.Tensor,  # [B, D] True = padding
) -> torch.Tensor:
    if section_encoding.ndim == 2:
        scores = torch.einsum("bh,dh->bd", query_encoding, section_encoding)
    elif section_encoding.ndim == 3:
        scores = torch.einsum("bh,bdh->bd", query_encoding, section_encoding)
    else:
        raise ValueError(f"Invalid section encoding shape: {tuple(section_encoding.shape)}")
    return torch.where(mask, _NEG_INF, scores)


def _padding_mask(batch: RealmBatch) -> torch.Tensor:
    return torch.isneginf(batch.section__score)


def _kld(p_logits: torch.Tensor, q_logits: torch.Tensor) -> torch.Tensor:
    """KL(q || p) over finite entries."""
    p_def = torch.isfinite(p_logits)
    q_def = torch.isfinite(q_logits)
    p_lp = masked_log_softmax(torch.where(p_def, p_logits, _NEG_INF))
    q_lp = masked_log_softmax(torch.where(q_def, q_logits, _NEG_INF))
    terms = torch.where(p_def & q_def, torch.exp(q_lp) * (q_lp - p_lp), 0.0)
    return terms.sum(-1)


def _huber(x: torch.Tensor, y: torch.Tensor, mask: torch.Tensor, delta: float = 1.0) -> torch.Tensor:
    d = torch.where(mask, x - y, 0.0)
    n = torch.clamp(mask.sum().to(d.dtype), min=1.0)
    loss = torch.where(d.abs() <= delta, 0.5 * d**2, delta * (d.abs() - 0.5 * delta))
    return torch.where(mask, loss, 0.0).sum() / n


class Gradients:
    """Base estimator."""

    def __call__(
        self,
        *,
        batch: RealmBatch,
        query_encoding: torch.Tensor,
        section_encoding: torch.Tensor,
        lm_logits: typ.Optional[torch.Tensor] = None,
    ) -> RealmOutput:
        raise NotImplementedError


class RetrievalGradients(Gradients):
    """KL divergence between the model and binary relevance targets."""

    def __init__(
        self,
        guidance: GuidanceType = "zero",
        guidance_weight: float = 0.0,
        self_supervision_weight: float = 0.0,
        score_decay: float = 0.0,
    ):
        self.guidance = guidance
        self.guidance_weight = guidance_weight
        self.self_supervision_weight = self_supervision_weight
        self.score_decay = score_decay

    def __call__(
        self,
        *,
        batch: RealmBatch,
        query_encoding: torch.Tensor,
        section_encoding: torch.Tensor,
        lm_logits: typ.Optional[torch.Tensor] = None,
    ) -> RealmOutput:
        is_padding = _padding_mask(batch)
        retriever_scores = _compute_retriever_scores(query_encoding, section_encoding, is_padding)
        retriever_logprobs = masked_log_softmax(retriever_scores)

        targets = torch.where(is_padding, 0.0, (batch.section__relevance > 0).to(torch.float32))
        n_positives = targets.sum(-1)
        # rows without positives fall back to the candidate count
        n_pos_safe = torch.where(n_positives == 0, (~is_padding).sum(-1).to(torch.float32), n_positives)

        # KL loss: grad = 1/Np sum (p_i - 1[pos]) grad log p_i
        ref_probs = torch.exp(retriever_logprobs).detach()
        w = (ref_probs - targets) / torch.clamp(n_pos_safe[:, None], min=1.0)
        row_loss = torch.where(is_padding, 0.0, w.detach() * retriever_logprobs).sum(-1)
        has_pos = n_positives > 0
        n_rows = torch.clamp(has_pos.sum().to(torch.float32), min=1.0)
        loss = torch.where(has_pos, row_loss, 0.0).sum() / n_rows

        diagnostics: dict[str, torch.Tensor] = {}
        if self.guidance_weight > 0:
            ref = batch.section__sparse if self.guidance == "sparse" else torch.zeros_like(retriever_scores)
            mask = torch.isfinite(retriever_logprobs) & torch.isfinite(ref)
            g = _huber(retriever_logprobs, ref, mask)
            loss = loss + self.guidance_weight * g
            diagnostics[f"{self.guidance}_guidance"] = g
        if self.self_supervision_weight > 0:
            pos_lp = torch.where(targets > 0, retriever_logprobs, _NEG_INF)
            best = pos_lp.argmax(-1)
            ce_rows = -torch.gather(masked_log_softmax(pos_lp), -1, best[:, None])[:, 0]
            ss = torch.where(has_pos, ce_rows, 0.0).sum() / n_rows
            loss = loss + self.self_supervision_weight * ss
            diagnostics["self_supervision"] = ss
        if self.score_decay > 0:
            fin = torch.isfinite(retriever_scores)
            sd = torch.where(fin, retriever_scores**2, 0.0).sum() / torch.clamp(fin.sum().to(torch.float32), min=1.0)
            loss = loss + self.score_decay * sd
            diagnostics["score_decay"] = sd

        # KL diagnostics against the sampling distributions
        for key, ref_scores in {
            "kl_score": batch.section__score,
            "kl_sparse": batch.section__sparse,
            "kl_dense": batch.section__dense,
        }.items():
            if ref_scores is None:
                continue
            ref_scores = torch.where(torch.isnan(ref_scores), _NEG_INF, ref_scores)
            diagnostics[key] = _kld(retriever_logprobs, ref_scores).mean().detach()

        return RealmOutput(loss=loss, retriever_scores=retriever_scores, diagnostics=diagnostics)


def _lm_logprobs(input_ids: torch.Tensor, attention_mask: torch.Tensor, lm_logits: torch.Tensor) -> torch.Tensor:
    """Length-normalized sequence log-probs [B, D] of [B, D, L] ids under
    [B, D, L, V] logits. The log-softmax runs on the flattened [B*D, L-1, V]
    view, and the targets are gathered from it: at the reader's full width
    one such f32 tensor is several GB, so no other copy is kept. Target ids
    below 0 (masked anyway) are read at 0 to keep the gather in range."""
    b, d, length = input_ids.shape
    tgt = input_ids.reshape(b * d, length)[:, 1:]
    m = attention_mask.reshape(b * d, length)[:, 1:].to(torch.float32)
    logits = lm_logits.reshape(b * d, length, -1)[:, :-1, :]
    logp = torch.log_softmax(logits, dim=-1)
    tok = torch.gather(logp, -1, tgt.clamp(min=0).long().unsqueeze(-1))[..., 0] * m
    return (tok.sum(-1) / torch.clamp(m.sum(-1), min=1.0)).reshape(b, d)


def _reader_logprobs(batch: RealmBatch, lm_logits: torch.Tensor, b: int, d: int) -> torch.Tensor:
    ids = batch.lm__input_ids.reshape(b, d, -1)
    mask = batch.lm__attention_mask.reshape(b, d, -1)
    return _lm_logprobs(ids, mask, lm_logits.reshape(b, d, *lm_logits.shape[-2:]))


class MarginalLikelihoodGradients(Gradients):
    """-log p(x) with `log p(x) = logsumexp_z(log p_ret(z|q) + log p_lm(x|z))`."""

    def __call__(
        self,
        *,
        batch: RealmBatch,
        query_encoding: torch.Tensor,
        section_encoding: torch.Tensor,
        lm_logits: typ.Optional[torch.Tensor] = None,
    ) -> RealmOutput:
        if lm_logits is None:
            raise ValueError("MarginalLikelihoodGradients requires lm_logits")
        is_padding = _padding_mask(batch)
        retriever_scores = _compute_retriever_scores(query_encoding, section_encoding, is_padding)
        retriever_logprobs = masked_log_softmax(retriever_scores)
        b, d = retriever_scores.shape
        logp_x_z = _reader_logprobs(batch, lm_logits, b, d)
        joint = torch.where(is_padding, _NEG_INF, retriever_logprobs + logp_x_z)
        loss = -torch.logsumexp(joint, dim=-1).mean()
        return RealmOutput(loss=loss, retriever_scores=retriever_scores, diagnostics={})


class DistillationGradients(Gradients):
    """Cross-encoder -> dual-encoder distillation from
    `batch.section__teacher_score` ([B, D], -inf/nan = missing):
    `margin_mse` (anchor at the teacher's best positive; match the margins to
    every valid negative) or `kl` (KL(softmax(t / T) || softmax(f)) over the
    valid candidates). `ce_weight > 0` mixes in the `RetrievalGradients` loss."""

    def __init__(
        self,
        objective: typ.Literal["margin_mse", "kl"] = "margin_mse",
        temperature: float = 1.0,
        ce_weight: float = 0.0,
    ):
        self.objective = objective
        self.temperature = temperature
        self.ce_weight = ce_weight
        self._ce = RetrievalGradients() if ce_weight > 0 else None

    def __call__(
        self,
        *,
        batch: RealmBatch,
        query_encoding: torch.Tensor,
        section_encoding: torch.Tensor,
        lm_logits: typ.Optional[torch.Tensor] = None,
    ) -> RealmOutput:
        t = batch.section__teacher_score
        if t is None:
            raise ValueError("DistillationGradients requires batch.section__teacher_score")
        is_padding = _padding_mask(batch)
        f = _compute_retriever_scores(query_encoding, section_encoding, is_padding)
        valid = ~is_padding & torch.isfinite(t)
        t = torch.where(valid, t, _NEG_INF)

        diagnostics: dict[str, torch.Tensor] = {}
        if self.objective == "margin_mse":
            is_pos = (batch.section__relevance > 0) & valid
            has_pos = is_pos.any(-1)
            anchor = torch.where(is_pos, t, _NEG_INF).argmax(-1)  # the positive the teacher ranks highest
            f_p = torch.gather(f, -1, anchor[:, None])
            t_p = torch.gather(t, -1, anchor[:, None])
            pairs = valid & ~is_pos & has_pos[:, None]
            d = torch.where(pairs, (f_p - f) - (t_p - t), 0.0)
            n_pairs = torch.clamp(pairs.sum().to(torch.float32), min=1.0)
            loss = (d**2).sum() / n_pairs
            diagnostics["margin_mse_pairs"] = n_pairs
        elif self.objective == "kl":
            teacher_lp = masked_log_softmax(t / self.temperature)
            student_lp = masked_log_softmax(torch.where(valid, f, _NEG_INF))
            terms = torch.where(valid, torch.exp(teacher_lp) * (teacher_lp - student_lp), 0.0)
            has_any = valid.any(-1)
            rows = torch.where(has_any, terms.sum(-1), 0.0)
            loss = rows.sum() / torch.clamp(has_any.sum().to(torch.float32), min=1.0)
        else:
            raise ValueError(f"Unknown distillation objective: {self.objective}")

        if self._ce is not None:
            ce_out = self._ce(batch=batch, query_encoding=query_encoding, section_encoding=section_encoding)
            loss = loss + self.ce_weight * ce_out.loss
            diagnostics["ce_loss"] = ce_out.loss

        return RealmOutput(loss=loss, retriever_scores=f, diagnostics=diagnostics)


class VodGradients(Gradients):
    """The VOD estimator (arXiv:2210.06345).

    With priority-sampled sections and self-normalized weights
    `w_i = exp(section__log_weight_i)` per label group, the groups are first
    recombined with their proposal masses, `log w~_i = log w_i + lse_g(i)`.
    Importance-corrected posterior weights are `v_i = softmax_i(log w~_i +
    f_i - beta * s_i)` (f = retriever scores, s = `section__score`), and the
    Rényi bound is

        L_alpha = 1/(1-alpha) * log sum_i v_i * exp((1-alpha) * log p_lm(x|z_i))

    (alpha -> 0: the marginal-likelihood bound; alpha = 1: the ELBO). Without a
    reader: KL to relevance with the partition function estimated over the
    sampled support, `log Z_hat = logsumexp_i(log w~_i + f_i - beta * s_i)`.
    """

    def __init__(self, alpha: float = 0.0, proposal_temperature: float = 1.0):
        self.alpha = alpha
        # beta: the sampler's `temperature`; keep it in sync with the collate
        self.proposal_temperature = proposal_temperature

    def __call__(
        self,
        *,
        batch: RealmBatch,
        query_encoding: torch.Tensor,
        section_encoding: torch.Tensor,
        lm_logits: typ.Optional[torch.Tensor] = None,
    ) -> RealmOutput:
        is_padding = _padding_mask(batch)
        f = _compute_retriever_scores(query_encoding, section_encoding, is_padding)
        log_w = batch.section__log_weight
        s = batch.section__score
        if log_w is None:
            raise ValueError("VodGradients requires section__log_weight (priority sampling)")
        if batch.section__lse_pos is not None and batch.section__lse_neg is not None:
            is_pos = batch.section__relevance > 0
            lse_g = torch.where(is_pos, batch.section__lse_pos[..., None], batch.section__lse_neg[..., None])
            log_w = log_w + torch.where(torch.isfinite(lse_g), lse_g, 0.0)
        beta = self.proposal_temperature
        corr = torch.where(is_padding, _NEG_INF, log_w + f - beta * torch.where(is_padding, 0.0, s))

        if lm_logits is not None:
            b, d = f.shape
            logp_x_z = _reader_logprobs(batch, lm_logits, b, d)
            v = masked_log_softmax(corr)
            one_m_alpha = 1.0 - self.alpha
            if abs(one_m_alpha) < 1e-6:  # alpha = 1: ELBO = sum_i v_i log p(x|z_i)
                bound = torch.where(is_padding, 0.0, torch.exp(v) * logp_x_z).sum(-1)
            else:
                terms = torch.where(is_padding, _NEG_INF, v + one_m_alpha * logp_x_z)
                bound = torch.logsumexp(terms, dim=-1) / one_m_alpha
            loss = -bound.mean()
        else:
            targets = torch.where(is_padding, 0.0, (batch.section__relevance > 0).to(torch.float32))
            n_pos = targets.sum(-1)
            log_z = torch.logsumexp(torch.where(is_padding, _NEG_INF, corr), dim=-1)
            logp = f - log_z[:, None]
            pos_term = torch.where(targets > 0, logp, 0.0).sum(-1) / torch.clamp(n_pos, min=1.0)
            has_pos = n_pos > 0
            loss = torch.where(has_pos, -pos_term, 0.0).sum() / torch.clamp(has_pos.sum().to(torch.float32), min=1.0)

        return RealmOutput(loss=loss, retriever_scores=f, diagnostics={})
