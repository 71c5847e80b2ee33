"""Causal language model, the REALM reader, in the GPT-2 layout (port of
`vod_tpu/models/lm.py`).

A pre-LN decoder: `x + attn(ln1 x)`, `x + mlp(ln2 x)`, learned positions,
a final `ln_f`, and an untied (or tied) output head. Parameters are f32 and
activations run in `cfg.dtype` (bf16 by default), as the flax module keeps
them. Parity traps with the flax module, each handled where it arises:
  * attention scores are taken in `cfg.dtype`, cast to f32 and divided by
    sqrt(head_dim); masked positions are filled with `finfo(f32).min`, not
    -inf, so a row whose keys are all masked attends uniformly; the
    probabilities are cast back to `cfg.dtype`;
  * GELU is the tanh approximation (flax `nn.gelu`);
  * `ln_f` runs in `cfg.dtype`, its result is cast to f32, and the head is an
    f32 product.
Attention is plain matmul + softmax: `scaled_dot_product_attention` masks
differently.

Generation (`lm_generate`) is KV-cached: `prefill` runs the prompt once,
teacher-forced, and fills per-layer K/V caches of `max_len` slots; each new
token is then one [B, 1] `decode_step`. Right-padded prompts continue after
their own valid prefix: each row keeps its write position `pos` on the card
([B], int32), K/V are scattered at (row, pos), and `kv_mask` hides the
padding slots prefill cached. Where JAX runs the steps under one `lax.scan`,
the port runs a Python loop that never reads a value back from the card and
never ends early. The caches are written in place.

`port_gpt2_weights` maps a HF GPT-2 state dict onto `CausalLM.state_dict`.
"""

from __future__ import annotations

import dataclasses
import math
import typing as typ

import torch
import torch.nn.functional as F
from torch import nn

from .encoder import _dense, _gelu, _LayerNorm, _materialise


@dataclasses.dataclass(frozen=True)
class CausalLMConfig:
    vocab_size: int = 30522
    hidden_size: int = 256
    num_layers: int = 4
    num_heads: int = 4
    intermediate_size: int = 1024
    max_position_embeddings: int = 1024
    layer_norm_eps: float = 1e-5
    tie_word_embeddings: bool = False
    dtype: torch.dtype = torch.bfloat16  # activations; parameters are f32

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


class _DecoderLayer(nn.Module):
    def __init__(self, cfg: CausalLMConfig, device: typ.Any = None):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        self.ln1 = _LayerNorm(h, cfg.layer_norm_eps, cfg.dtype, device)
        self.ln2 = _LayerNorm(h, cfg.layer_norm_eps, cfg.dtype, device)
        self.query = nn.Linear(h, h, device=device)
        self.key = nn.Linear(h, h, device=device)
        self.value = nn.Linear(h, h, device=device)
        self.out = nn.Linear(h, h, device=device)
        self.fc_in = nn.Linear(h, cfg.intermediate_size, device=device)
        self.fc_out = nn.Linear(cfg.intermediate_size, h, device=device)

    def _heads(self, x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
        cfg = self.cfg
        return _dense(x, layer, cfg.dtype).view(*x.shape[:-1], cfg.num_heads, cfg.head_dim)

    def _attend(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """q [B, Lq, Hh, D], k/v [B, Lk, Hh, D], mask [B, 1, Lq, Lk] bool."""
        cfg, dt = self.cfg, self.cfg.dtype
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32) / math.sqrt(cfg.head_dim)
        scores = torch.where(mask, scores, torch.finfo(torch.float32).min)
        probs = torch.softmax(scores, dim=-1).to(dt)
        o = torch.einsum("bhqk,bkhd->bqhd", probs, v)
        return _dense(o.reshape(*o.shape[:2], -1), self.out, dt)

    def _mlp(self, h: torch.Tensor) -> torch.Tensor:
        dt = self.cfg.dtype
        return h + _dense(_gelu(_dense(self.ln2(h), self.fc_in, dt)), self.fc_out, dt)

    def forward(
        self, h: torch.Tensor, mask: torch.Tensor
    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Full-sequence pass: h [B, L, H] -> (h, k, v); k/v [B, L, Hh, D] in
        `cfg.dtype` (prefill's caches; the train forward keeps them for
        backward anyway)."""
        x = self.ln1(h)
        q, k, v = self._heads(x, self.query), self._heads(x, self.key), self._heads(x, self.value)
        return self._mlp(h + self._attend(q, k, v, mask)), k, v

    def step(
        self, h: torch.Tensor, pos: torch.Tensor, cache_k: torch.Tensor, cache_v: torch.Tensor, kv_mask: torch.Tensor
    ) -> torch.Tensor:
        """One-token decode: h [B, 1, H]; caches [B, Lmax, Hh, D], written in
        place at (row, pos[row]); `kv_mask` [B, Lmax] already holds the new
        token's slot."""
        x = self.ln1(h)
        at = pos.to(torch.int64)[:, None, None, None].expand(-1, 1, *cache_k.shape[2:])
        cache_k.scatter_(1, at, self._heads(x, self.key).to(cache_k.dtype))
        cache_v.scatter_(1, at, self._heads(x, self.value).to(cache_v.dtype))
        mask = kv_mask[:, None, None, :] > 0
        return self._mlp(h + self._attend(self._heads(x, self.query), cache_k, cache_v, mask))


class CausalLM(nn.Module):
    """`forward(input_ids, attention_mask)` returns next-token logits [B, L, V]
    in f32. Parameters live on `device` (default "cuda") and are
    random-initialised from `generator` (default: seed 0 on that device);
    load real weights with `load_state_dict(convert.lm_flax_to_state_dict(...))`."""

    def __init__(
        self,
        cfg: CausalLMConfig,
        *,
        device: typ.Union[str, torch.device] = "cuda",
        generator: typ.Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.cfg = cfg
        meta = "meta"
        self.wte = nn.Embedding(cfg.vocab_size, cfg.hidden_size, device=meta)
        self.wpe = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size, device=meta)
        self.layers = nn.ModuleList(_DecoderLayer(cfg, meta) for _ in range(cfg.num_layers))
        self.ln_f = _LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, cfg.dtype, meta)
        self.lm_head = (
            None if cfg.tie_word_embeddings else nn.Linear(cfg.hidden_size, cfg.vocab_size, bias=False, device=meta)
        )
        _materialise(self, device, generator)

    def _logits(self, h: torch.Tensor) -> torch.Tensor:
        h = self.ln_f(h).to(torch.float32)
        head = self.wte.weight if self.lm_head is None else self.lm_head.weight
        return F.linear(h, head.to(torch.float32))

    def _embed(self, input_ids: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        dt = self.cfg.dtype
        return self.wte(input_ids).to(dt) + self.wpe(positions).to(dt)

    def _prompt(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(embedded prompt [B, L, H], causal & key mask [B, 1, L, L])."""
        length = input_ids.shape[-1]
        h = self._embed(input_ids, torch.arange(length, device=input_ids.device)[None])
        causal = torch.ones((length, length), dtype=torch.bool, device=input_ids.device).tril()
        return h, causal[None, None] & (attention_mask[:, None, None, :] > 0)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        h, mask = self._prompt(input_ids, attention_mask)
        for layer in self.layers:
            h, _, _ = layer(h, mask)
        return self._logits(h)

    # ---- incremental decoding -------------------------------------------

    def prefill(
        self, input_ids: torch.Tensor, attention_mask: torch.Tensor, max_len: int, *, last_only: bool = False
    ) -> tuple[torch.Tensor, dict]:
        """Teacher-forced pass over the prompt that also fills the K/V caches.

        Returns (logits [B, L, V] f32, cache): the cache holds per layer
        `layer_i: {k, v}` [B, max_len, Hh, D] in `cfg.dtype` (the padding
        slots' K/V included), `kv_mask` [B, max_len] int32 and `pos` [B]
        int32, each row's valid prompt length. With `last_only` the logits
        are those of each row's last valid position only, [B, 1, V]: the
        same numbers, without the [B, L, V] f32 tensor."""
        cfg = self.cfg
        b, length = input_ids.shape
        h, mask = self._prompt(input_ids, attention_mask)
        cache: dict = {}
        for i, layer in enumerate(self.layers):
            h, k, v = layer(h, mask)
            ck = torch.zeros((b, max_len, cfg.num_heads, cfg.head_dim), dtype=cfg.dtype, device=h.device)
            cv = torch.zeros_like(ck)
            ck[:, :length] = k
            cv[:, :length] = v
            cache[f"layer_{i}"] = {"k": ck, "v": cv}
        kv_mask = torch.zeros((b, max_len), dtype=torch.int32, device=h.device)
        kv_mask[:, :length] = attention_mask
        cache["kv_mask"] = kv_mask
        cache["pos"] = (attention_mask > 0).sum(dim=-1).to(torch.int32)
        if last_only:
            last = cache["pos"].to(torch.int64) - 1
            h = h[torch.arange(b, device=h.device), last][:, None]
        return self._logits(h), cache

    def decode_step(self, tok: torch.Tensor, cache: dict) -> tuple[torch.Tensor, dict]:
        """One decode step: tok [B] -> (logits [B, V] f32, cache); the caches
        and `kv_mask` are written in place, `pos` advances by one."""
        pos = cache["pos"]
        kv_mask = cache["kv_mask"].scatter_(1, pos.to(torch.int64)[:, None], 1)
        h = self._embed(tok[:, None], pos[:, None])
        new_cache: dict = {"kv_mask": kv_mask, "pos": pos + 1}
        for i, layer in enumerate(self.layers):
            c = cache[f"layer_{i}"]
            h = layer.step(h, pos, c["k"], c["v"], kv_mask)
            new_cache[f"layer_{i}"] = c
        return self._logits(h)[:, 0, :], new_cache


# ---- generation ----------------------------------------------------------


@torch.no_grad()
def lm_generate(
    model: CausalLM,
    input_ids: torch.Tensor,
    attention_mask: typ.Optional[torch.Tensor] = None,
    *,
    max_new_tokens: int = 32,
    eos_id: typ.Optional[int] = None,
    pad_id: int = 0,
    temperature: float = 0.0,
    top_k: typ.Optional[int] = None,
    top_p: typ.Optional[float] = None,
    generator: typ.Optional[torch.Generator] = None,
    noise: typ.Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """KV-cached decoder-only generation, greedy or (temperature > 0) sampled
    with optional top-k / nucleus filtering (Gumbel `noise` [T, B, V], else
    draws from `generator`). Each right-padded row continues after its own
    valid prefix: its first new token comes from the logits at its last valid
    position. Rows that emitted `eos_id` keep emitting `pad_id`. Returns the
    new tokens only, [B, max_new_tokens] int32.

    The logits after the last token are never read, so the last decode step
    that JAX's scan runs is not run here."""
    from .seq2seq import pick_tokens  # shared with the seq2seq reader

    if attention_mask is None:
        attention_mask = torch.ones_like(input_ids)
    b, length = input_ids.shape
    logits, cache = model.prefill(input_ids, attention_mask, length + max_new_tokens, last_only=True)
    logits = logits[:, 0]
    finished = torch.zeros((b,), dtype=torch.bool, device=input_ids.device)
    toks = []
    for t in range(max_new_tokens):
        nxt = pick_tokens(logits, t, temperature=temperature, top_k=top_k, top_p=top_p, generator=generator,
                          noise=noise)
        nxt = torch.where(finished, pad_id, nxt).to(torch.int32)
        if eos_id is not None:
            finished = finished | (nxt == eos_id)
        toks.append(nxt)
        if t + 1 < max_new_tokens:
            logits, cache = model.decode_step(nxt, cache)
    return torch.stack(toks, dim=1)


# ---- HF GPT-2 checkpoints ------------------------------------------------


def gpt2_config_from_hf(hf_config: typ.Any, dtype: torch.dtype = torch.float32) -> CausalLMConfig:
    """HF `GPT2Config` -> `CausalLMConfig` (tied head, GPT-2's layer-norm eps)."""
    return CausalLMConfig(
        vocab_size=hf_config.vocab_size,
        hidden_size=hf_config.n_embd,
        num_layers=hf_config.n_layer,
        num_heads=hf_config.n_head,
        intermediate_size=hf_config.n_inner or 4 * hf_config.n_embd,
        max_position_embeddings=hf_config.n_positions,
        layer_norm_eps=getattr(hf_config, "layer_norm_epsilon", 1e-5),
        tie_word_embeddings=True,
        dtype=dtype,
    )


def port_gpt2_weights(state_dict: typ.Mapping[str, typ.Any], cfg: CausalLMConfig) -> dict[str, torch.Tensor]:
    """HF GPT-2 state dict -> `CausalLM.state_dict` (lossless). Takes bare
    (`wte.weight`) and prefixed (`transformer.wte.weight`) keys. GPT-2's
    `Conv1D` stores weights [in, out] and `nn.Linear` wants [out, in]; forks
    in the Linear layout are told apart by shape."""
    sd = dict(state_dict)
    if any(k.startswith("transformer.") for k in sd):
        sd = {k[len("transformer."):]: v for k, v in sd.items() if k.startswith("transformer.")}
    h, inter = cfg.hidden_size, cfg.intermediate_size

    def t(key: str) -> torch.Tensor:
        v = sd[key]
        return torch.as_tensor(v.detach().cpu() if hasattr(v, "detach") else v, dtype=torch.float32).clone()

    def lin(key: str, d_in: int, d_out: int) -> torch.Tensor:
        w = t(key)
        if tuple(w.shape) == (d_in, d_out):  # Conv1D layout
            return w.T.contiguous()
        if tuple(w.shape) == (d_out, d_in):  # Linear layout
            return w
        raise ValueError(f"{key}: shape {tuple(w.shape)}, expected ({d_in},{d_out}) or transposed")

    out = {"wte.weight": t("wte.weight"), "wpe.weight": t("wpe.weight"),
           "ln_f.weight": t("ln_f.weight"), "ln_f.bias": t("ln_f.bias")}
    for i in range(cfg.num_layers):
        p, q = f"h.{i}.", f"layers.{i}."
        wqkv, bqkv = lin(p + "attn.c_attn.weight", h, 3 * h), t(p + "attn.c_attn.bias")  # [3H, H]
        for j, name in enumerate(("query", "key", "value")):
            out[q + f"{name}.weight"] = wqkv[j * h:(j + 1) * h].clone()
            out[q + f"{name}.bias"] = bqkv[j * h:(j + 1) * h].clone()
        for ln in ("1", "2"):
            out[q + f"ln{ln}.weight"], out[q + f"ln{ln}.bias"] = t(p + f"ln_{ln}.weight"), t(p + f"ln_{ln}.bias")
        for name, key, d_in, d_out in (("out", "attn.c_proj", h, h), ("fc_in", "mlp.c_fc", h, inter),
                                       ("fc_out", "mlp.c_proj", inter, h)):
            out[q + f"{name}.weight"] = lin(p + key + ".weight", d_in, d_out)
            out[q + f"{name}.bias"] = t(p + key + ".bias")
    return out


def load_hf_causal_lm(name_or_path: str, dtype: torch.dtype = torch.float32) -> tuple[CausalLMConfig, dict]:
    """Load a local GPT-2-family checkpoint with `transformers` and port it:
    returns (config, `CausalLM.state_dict`). Needs `transformers` (ImportError
    where it is missing) and the checkpoint on disk or in the HF cache."""
    import transformers

    hf = transformers.AutoModelForCausalLM.from_pretrained(name_or_path)
    if getattr(hf.config, "model_type", None) != "gpt2":
        raise ValueError(f"decoder-only port supports the gpt2 layout; got {hf.config.model_type!r}")
    cfg = gpt2_config_from_hf(hf.config, dtype=dtype)
    return cfg, port_gpt2_weights(hf.state_dict(), cfg)
