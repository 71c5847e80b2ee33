"""VOD systems: `Ranker` (dual encoder) and `Realm` (ranker + reader LM)
(port of `vod_tpu/models/systems.py`).

`encode` runs query and section tokens through ONE encoder pass (the shorter
side is padded to the longer) and splits the pooled embeddings; `Realm` adds
reader logits over the flattened `lm__input_ids`; `evaluate` hands both to
the gradient estimator; `Realm.generate` decodes greedily from the reader.
`forward(batch, mode=...)` dispatches like the flax `__call__`.

A `Ranker(splade_encoder=True)` encodes with `SpladeEncoder`: its encodings
are `[*, V]` vocabulary impacts, which the same gradient estimators score.
Auxiliary losses (the SPLADE FLOPS term) are kept only inside
`collect_losses(model)`, flax's `mutable=["losses"]`: the train step opens it
around the loss pass, and the query encode of live retrieval runs outside it.
"""

from __future__ import annotations

import contextlib
import typing as typ

import torch
import torch.nn.functional as F
from torch import nn

from vod_tpu_torch.types.batch import RealmBatch, RealmOutput
from .encoder import DebugEncoder, TransformerEncoderConfig, VodEncoder
from .gradients import Gradients
from .lm import CausalLM, CausalLMConfig, lm_generate


def _pad_to(x: torch.Tensor, length: int) -> torch.Tensor:
    return x if x.shape[-1] == length else F.pad(x, (0, length - x.shape[-1]))


def fused_rows(batch: RealmBatch) -> tuple[torch.Tensor, torch.Tensor, int]:
    """The query rows then the section rows, the shorter side padded to the
    longer: (ids, mask, number of queries)."""
    q_ids, q_mask = batch.query__input_ids, batch.query__attention_mask
    s_ids, s_mask = batch.section__input_ids, batch.section__attention_mask
    length = max(q_ids.shape[-1], s_ids.shape[-1])
    ids = torch.cat([_pad_to(q_ids, length), _pad_to(s_ids, length)], dim=0)
    mask = torch.cat([_pad_to(q_mask, length), _pad_to(s_mask, length)], dim=0)
    return ids, mask, int(q_ids.shape[0])


def _fused_encode(encoder: nn.Module, batch: RealmBatch) -> dict[str, torch.Tensor]:
    """One encoder pass over query + section tokens. With in-batch negatives
    (`extras["flat_sections"]`) the section pool is shared and its encoding
    stays [U, H]; otherwise it is [B, D, H]."""
    ids, mask, b = fused_rows(batch)
    pooled = encoder(ids, mask)
    query_encoding, section_encoding = pooled[:b], pooled[b:]
    if not batch.extras.get("flat_sections", False):
        section_encoding = section_encoding.reshape(b, section_encoding.shape[0] // b, -1)
    return {"query_encoding": query_encoding, "section_encoding": section_encoding}


@contextlib.contextmanager
def collect_losses(
    model: nn.Module, *, group: typ.Any = None, rows: typ.Optional[torch.Tensor] = None
) -> typ.Iterator[list[torch.Tensor]]:
    """While open, every submodule of `model` that sows an auxiliary loss
    (it has a `sown` slot) appends it to the list yielded. `group`: the
    process group over which a batch statistic sums (a data-parallel axis
    splitting the batch); `rows`: a bool mask of the rows of the next
    forward that count toward it (None: all)."""
    sowers = [m for m in model.modules() if hasattr(m, "sown")]
    losses: list[torch.Tensor] = []
    for m in sowers:
        m.sown, m.sown_group, m.sown_rows = losses, group, rows
    try:
        yield losses
    finally:
        for m in sowers:
            m.sown, m.sown_group, m.sown_rows = None, None, None


def _encoder(cfg: TransformerEncoderConfig, debug: bool, device: typ.Any, generator: typ.Any) -> nn.Module:
    return (DebugEncoder if debug else VodEncoder)(cfg, device=device, generator=generator)


class Ranker(nn.Module):
    """Dual-encoder ranker with a shared encoder. Parameters live on `device`
    (default "cuda"), random-initialised from `generator`."""

    def __init__(
        self,
        cfg: TransformerEncoderConfig,
        gradients: Gradients,
        *,
        debug_encoder: bool = False,
        splade_encoder: bool = False,
        splade_flops_weight: float = 0.0,
        device: typ.Union[str, torch.device] = "cuda",
        generator: typ.Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.cfg = cfg
        self.gradients = gradients
        if splade_encoder:
            from .splade import SpladeEncoder

            self.encoder = SpladeEncoder(cfg, flops_weight=splade_flops_weight, device=device, generator=generator)
        else:
            self.encoder = _encoder(cfg, debug_encoder, device, generator)

    def encode(self, batch: RealmBatch) -> dict[str, torch.Tensor]:
        return _fused_encode(self.encoder, batch)

    def encode_field(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        """Single-field encoding (the query side of live retrieval)."""
        return self.encoder(input_ids, attention_mask)

    def encode_field_tokens(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        """Per-token embeddings `[B, T, H]` for late-interaction (MaxSim)
        indexing (`search.maxsim.build_maxsim_index`); `VodEncoder` only."""
        return self.encoder.tokens(input_ids, attention_mask)

    def evaluate(self, batch: RealmBatch) -> RealmOutput:
        return self.gradients(batch=batch, **self.encode(batch))

    def forward(self, batch: RealmBatch, mode: str = "evaluate") -> typ.Any:
        if mode == "encode":
            return self.encode(batch)
        if mode == "evaluate":
            return self.evaluate(batch)
        raise ValueError(f"Unknown mode: {mode}")


class Realm(nn.Module):
    """Ranker + autoregressive reader. The encoder is initialised first, then
    the reader, both from `generator`, on `device` (default "cuda")."""

    def __init__(
        self,
        cfg: TransformerEncoderConfig,
        lm_cfg: CausalLMConfig,
        gradients: Gradients,
        *,
        debug_encoder: bool = False,
        device: typ.Union[str, torch.device] = "cuda",
        generator: typ.Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.cfg = cfg
        self.lm_cfg = lm_cfg
        self.gradients = gradients
        self.encoder = _encoder(cfg, debug_encoder, device, generator)
        self.lm = CausalLM(lm_cfg, device=device, generator=generator)

    def encode(self, batch: RealmBatch) -> dict[str, torch.Tensor]:
        return _fused_encode(self.encoder, batch)

    def encode_field(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        return self.encoder(input_ids, attention_mask)

    def forward_lm(self, batch: RealmBatch) -> torch.Tensor:
        """Reader logits over the `[B*D, L]`-flattened reader inputs."""
        ids, mask = batch.lm__input_ids, batch.lm__attention_mask
        return self.lm(ids.reshape(-1, ids.shape[-1]), mask.reshape(-1, mask.shape[-1]))

    def evaluate(self, batch: RealmBatch) -> RealmOutput:
        enc = self.encode(batch)
        return self.gradients(batch=batch, lm_logits=self.forward_lm(batch), **enc)

    def generate(self, batch: RealmBatch, max_new_tokens: int = 16) -> torch.Tensor:
        """Greedy KV-cached decoding from the reader over the flattened
        [context; question] prompts: [B*D, max_new_tokens] int32. Like the
        flax `generate`, it has no EOS handling."""
        ids, mask = batch.lm__input_ids, batch.lm__attention_mask
        return lm_generate(self.lm, ids.reshape(-1, ids.shape[-1]), mask.reshape(-1, mask.shape[-1]),
                           max_new_tokens=max_new_tokens)

    def forward(self, batch: RealmBatch, mode: str = "evaluate", **kw: typ.Any) -> typ.Any:
        if mode == "encode":
            return self.encode(batch)
        if mode == "evaluate":
            return self.evaluate(batch)
        if mode == "generate":
            return self.generate(batch, **kw)
        raise ValueError(f"Unknown mode: {mode}")
