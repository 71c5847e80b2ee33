"""Structured experiment config: dict/YAML -> validated `Experiment` (the
port's copy of `vod_tpu/exps/structconf.py`): `__vars__` product expansion,
dataset-list parsing with link validation and orphan-section dropping,
`extends` preset composition, and the `Experiment` schema. YAML is read by
the port's own reader (`utils/yaml.py`), the models are `StrictModel`s
(`configs/base.py`).
"""

from __future__ import annotations

import copy
import dataclasses
import itertools
import json
import pathlib
import re
import typing as typ

from vod_tpu_torch.configs import (
    DataLoaderConfig,
    QueriesDatasetConfig,
    RealmCollateConfig,
    SearchFactoryDefaults,
    SectionsDatasetConfig,
    StrictModel,
    SysConfig,
    TemplatesConfig,
    TokenizerConfig,
    TrainerConfig,
)
from vod_tpu_torch.utils import yaml

_VARS_KEY = "__vars__"


def expand_vars(configs: typ.Sequence[typ.Mapping[str, typ.Any]]) -> list[dict[str, typ.Any]]:
    """Expand `__vars__` product placeholders:

    [{"name": "{lang}-ds", "__vars__": {"lang": ["en", "fr"]}}] ->
    [{"name": "en-ds"}, {"name": "fr-ds"}]
    """
    out: list[dict] = []
    for cfg in configs:
        if not isinstance(cfg, dict) or _VARS_KEY not in cfg:
            out.append(dict(cfg) if isinstance(cfg, dict) else cfg)
            continue
        cfg = dict(cfg)
        variables = cfg.pop(_VARS_KEY)

        def _sub(v: typ.Any, target: str, value: typ.Any) -> typ.Any:
            if isinstance(v, str):
                return re.sub(rf"\{{\s*{target}\s*\}}", str(value), v)
            if isinstance(v, dict):
                return {k: _sub(x, target, value) for k, x in v.items()}
            if isinstance(v, list):
                return [_sub(x, target, value) for x in v]
            return v

        keys = list(variables.keys())
        for combo in itertools.product(*variables.values()):
            new = copy.deepcopy(cfg)
            for key, val in zip(keys, combo):
                new = {k: _sub(v, key, val) for k, v in new.items()}
            out.append(new)
    return out


class ModelConfig(StrictModel):
    """Flagship-model knobs (encoder + optional reader). The port would raise
    `NotImplementedError` for an option it has not ported (`exps/cli.py:
    check_ported`); every option is ported."""

    kind: typ.Literal["ranker", "realm"] = "ranker"
    gradients: typ.Literal["retrieval", "marginal_likelihood", "vod", "distillation"] = "retrieval"
    vod_alpha: float = 0.0
    distill_objective: typ.Literal["margin_mse", "kl"] = "margin_mse"
    distill_temperature: float = 1.0
    distill_ce_weight: float = 0.0
    vocab_size: int = 30522
    hidden_size: int = 256
    num_layers: int = 4
    num_heads: int = 4
    intermediate_size: int = 1024
    agg_method: str = "mean"
    output_norm: typ.Optional[str] = "l2"
    scaler: float = 10.0
    learn_scaler: bool = True
    lm_hidden_size: int = 256
    lm_num_layers: int = 4
    debug_encoder: bool = False  # embedding-only encoder
    splade_encoder: bool = False
    splade_flops_weight: float = 0.0
    splade_query_k: int = 64
    splade_doc_k: int = 128
    splade_max_postings: int = 4096
    name_or_path: typ.Optional[str] = None  # HF encoder checkpoint
    hf_fallback: typ.Literal["error", "random"] = "error"  # cache miss behavior
    reader: typ.Literal["causal", "seq2seq"] = "causal"
    lm_name_or_path: typ.Optional[str] = None  # HF GPT-2-family reader checkpoint
    remat: bool = False
    lora_rank: int = 0
    lora_alpha: float = 16.0
    kbit: bool = False
    moe_experts: int = 0
    moe_top_k: int = 1
    moe_capacity_factor: float = 1.25


class DatasetsConfig(StrictModel):
    """Query + section shard lists with `__vars__` expansion + link validation."""

    queries: list[QueriesDatasetConfig] = dataclasses.field(default_factory=list)
    sections: list[SectionsDatasetConfig] = dataclasses.field(default_factory=list)

    @classmethod
    def parse(cls, raw: typ.Mapping[str, typ.Any]) -> "DatasetsConfig":
        queries = [QueriesDatasetConfig(**d) for d in expand_vars(raw.get("queries", []))]
        sections = [SectionsDatasetConfig(**d) for d in expand_vars(raw.get("sections", []))]
        # link validation + orphan-section dropping
        section_ids = {s.identifier for s in sections}
        for q in queries:
            if q.link is not None and q.link not in section_ids:
                raise ValueError(f"Query shard {q.identifier!r} links to unknown section shard {q.link!r}")
        linked = {q.link for q in queries if q.link is not None}
        if linked:
            sections = [s for s in sections if s.identifier in linked]
        return cls(queries=queries, sections=sections)


class Experiment(StrictModel):
    """The full experiment config."""

    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    datasets: DatasetsConfig = dataclasses.field(default_factory=DatasetsConfig)
    search_defaults: SearchFactoryDefaults = dataclasses.field(default_factory=SearchFactoryDefaults)
    collate: RealmCollateConfig = dataclasses.field(default_factory=RealmCollateConfig)
    dataloader: DataLoaderConfig = dataclasses.field(default_factory=DataLoaderConfig)
    tokenizer: TokenizerConfig = dataclasses.field(default_factory=TokenizerConfig)
    templates: TemplatesConfig = dataclasses.field(default_factory=TemplatesConfig)
    trainer: TrainerConfig = dataclasses.field(default_factory=TrainerConfig)
    sys: SysConfig = dataclasses.field(default_factory=SysConfig)

    @classmethod
    def parse(cls, raw: typ.Mapping[str, typ.Any]) -> "Experiment":
        raw = dict(raw)
        if "datasets" in raw and not isinstance(raw["datasets"], DatasetsConfig):
            raw["datasets"] = DatasetsConfig.parse(raw["datasets"])
        return cls.model_validate(raw)

    @classmethod
    def from_file(cls, path: str) -> "Experiment":
        return cls.parse(load_raw_config(path))


def deep_merge(dst: dict, src: typ.Mapping) -> dict:
    """Recursive dict merge, `src` wins (the preset composition operator)."""
    for k, v in src.items():
        if isinstance(v, typ.Mapping) and isinstance(dst.get(k), dict):
            deep_merge(dst[k], v)
        else:
            dst[k] = copy.deepcopy(v)
    return dst


def _read_raw(path: pathlib.Path) -> dict:
    text = path.read_text()
    if path.suffix in (".yaml", ".yml"):
        return yaml.safe_load(text) or {}
    return json.loads(text)


def preset_root() -> pathlib.Path:
    return pathlib.Path(__file__).resolve().parents[2] / "configs" / "presets"


def load_raw_config(path: str, _seen: typ.Optional[frozenset] = None) -> dict:
    """Load a YAML/JSON config, resolving its `extends` preset composition:
    fragments deep-merge in order, the document's own keys winning last,

        extends: [model/realm, encoder/e5-small, search/pq, datasets/msmarco]

    Each name resolves to (1) a path relative to the current file, (2) an
    absolute path, or (3) `configs/presets/<name>.yaml`. Fragments may extend
    further fragments; cycles are an error.
    """
    p = pathlib.Path(path).resolve()
    seen = _seen or frozenset()
    if str(p) in seen:
        raise ValueError(f"extends cycle through {p}")
    seen = seen | {str(p)}

    raw = _read_raw(p)
    bases = raw.pop("extends", [])
    if isinstance(bases, str):
        bases = [bases]
    merged: dict = {}
    for name in bases:
        candidates = [
            p.parent / name,
            p.parent / f"{name}.yaml",
            pathlib.Path(name),
            preset_root() / f"{name}.yaml",
            preset_root() / name,
        ]
        frag_path = next((c for c in candidates if c.is_file()), None)
        if frag_path is None:
            raise FileNotFoundError(
                f"extends fragment {name!r} (from {p}) not found; looked in {p.parent} and {preset_root()}"
            )
        deep_merge(merged, load_raw_config(str(frag_path), seen))
    deep_merge(merged, raw)
    return merged
