"""Generation-quality evaluation of seq2seq REALM systems (port of
`vod_tpu/runtime/generation.py`).

KV-cached greedy decoding (`models/seq2seq.py:realm_generate`) feeds
answer-level metrics: per query, the generation conditioned on the section
the retriever scored highest is compared with that section's gold answer
(the `token_type_ids == 2` segment of `lm__input_ids`, compacted as the
teacher-forced reader trains on it) by exact match and token F1. The
decoding stays on the device; the comparison reads the tokens back once per
batch.
"""

from __future__ import annotations

import collections
import typing as typ

import numpy as np
import torch

from vod_tpu_torch.models.seq2seq import compact_answer_segment, realm_generate
from vod_tpu_torch.types.batch import RealmBatch


def generation_metrics(generated: torch.Tensor, batch: RealmBatch, *, eos_id: int = 1) -> dict[str, float]:
    """Exact match and token F1 of each query's top-section generation
    against its gold answer. `generated` [B*D, T] follows the flattened
    (query, section) layout; the section with the highest finite
    `section__score` represents its query. EM compares the tokens before the
    first EOS with the gold tokens (a trailing EOS stripped); F1 is the
    bag-of-tokens overlap."""
    b, d = batch.section__score.shape
    t = generated.shape[-1]
    score = batch.section__score
    best = torch.argmax(torch.where(torch.isfinite(score), score, float("-inf")), dim=-1)
    pick = lambda x: torch.gather(x, 1, best[:, None, None].expand(-1, 1, x.shape[-1]))[:, 0]
    gen_best = pick(generated.reshape(b, d, t))
    gold_ids, gold_m = compact_answer_segment(
        batch.lm__input_ids, batch.lm__token_type_ids, batch.lm__attention_mask, t
    )
    gen_mask = torch.cumsum((gen_best == eos_id).to(torch.int32), dim=-1) == 0  # before the first EOS

    gen_np, gm_np = gen_best.cpu().numpy(), gen_mask.cpu().numpy()
    gold_np, goldm_np = pick(gold_ids).cpu().numpy(), pick(gold_m).cpu().numpy()
    em, f1 = [], []
    for i in range(b):
        g = gen_np[i][gm_np[i]].tolist()
        a = gold_np[i][goldm_np[i] > 0].tolist()
        while a and a[-1] == eos_id:  # the gold answer may end with EOS
            a = a[:-1]
        em.append(float(g == a))
        if not g and not a:
            f1.append(1.0)
        elif not g or not a:
            f1.append(0.0)
        else:
            common = sum((collections.Counter(g) & collections.Counter(a)).values())
            p, r = common / len(g), common / len(a)
            f1.append(2 * p * r / (p + r) if common else 0.0)
    return {"gen/exact_match": float(np.mean(em)), "gen/token_f1": float(np.mean(f1))}


def evaluate_generation(
    model: typ.Any,  # Seq2SeqRealm
    batches: typ.Iterable[RealmBatch],
    *,
    max_new_tokens: int = 16,
    eos_id: int = 1,
    max_batches: typ.Optional[int] = None,
) -> dict[str, float]:
    """KV-cached greedy generation over collated batches, with the answer
    metrics averaged over queries."""
    sums: dict[str, float] = {}
    count = 0
    for i, batch in enumerate(batches):
        if max_batches is not None and i >= max_batches:
            break
        toks = realm_generate(model, batch, max_new_tokens=max_new_tokens)
        nb = batch.section__score.shape[0]
        for key, value in generation_metrics(toks, batch, eos_id=eos_id).items():
            sums[key] = sums.get(key, 0.0) + value * nb
        count += nb
    return {k: v / max(count, 1) for k, v in sums.items()}
