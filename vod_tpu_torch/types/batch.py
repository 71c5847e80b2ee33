"""Typed batches for retrieval-augmented training (port of `vod_tpu/types/batch.py`).

`RealmBatch` holds a tokenized training batch and `RealmOutput` a model's
output. Field names follow the `<group>__<name>` convention of the JAX
package, so the estimators, monitors and loops read the same names.
"""

from __future__ import annotations

import dataclasses
import typing as typ

import torch


@dataclasses.dataclass
class RealmBatch:
    """A tokenized batch for retrieval-augmented tasks.

    Shapes (B = batch, D = sections per query, Lq/Ls/Lm = sequence lengths):
      query__*            : [B, Lq]
      section__input_ids  : [B*D, Ls] (flattened section tokens)
      section__{score,...}: [B, D]
      lm__*               : [B, D, Lm]
    With in-batch negatives (`extras["flat_sections"]`), the sections are one
    shared pool: `section__input_ids` is [U, Ls] and the per-query channels
    are [B, U].
    """

    query__input_ids: torch.Tensor
    query__attention_mask: torch.Tensor
    section__input_ids: torch.Tensor
    section__attention_mask: torch.Tensor
    section__relevance: torch.Tensor  # [B, D] float labels (>0 = positive)
    section__idx: torch.Tensor  # [B, D] global section row ids
    section__score: torch.Tensor  # [B, D] merged hybrid score (-inf = padding)
    section__sparse: torch.Tensor  # [B, D] raw sparse-engine score (nan = missing)
    section__dense: typ.Optional[torch.Tensor] = None  # [B, D] raw dense score
    section__teacher_score: typ.Optional[torch.Tensor] = None  # [B, D] distillation teacher
    section__log_weight: typ.Optional[torch.Tensor] = None  # [B, D] priority-sampling weights
    section__lse_pos: typ.Optional[torch.Tensor] = None  # [B]
    section__lse_neg: typ.Optional[torch.Tensor] = None  # [B]
    lm__input_ids: typ.Optional[torch.Tensor] = None
    lm__attention_mask: typ.Optional[torch.Tensor] = None
    lm__token_type_ids: typ.Optional[torch.Tensor] = None  # 0/1/2 = context/question/answer
    extras: dict = dataclasses.field(default_factory=dict)
    diagnostics: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class RealmOutput:
    """Model output: the loss, the retriever's scores [B, D] and diagnostics."""

    loss: torch.Tensor
    retriever_scores: torch.Tensor
    diagnostics: dict = dataclasses.field(default_factory=dict)
