"""The port's config schema (`vod_tpu_torch/configs/`, `exps/structconf.py`)
against the JAX package's pydantic models: every config file and preset
composition gives `to_dict()` == `model_dump()` exactly; fields-set
semantics, `apply_diff`, `realize`, `expand_vars`, link errors, unknown keys,
bad literals and lax coercion behave alike; `config.json` written by either
package is read by the other; `LRScheduleConfig` equals the optax schedule at
every update count within 2.5e-7 of the learning rate (relative: optax
evaluates in f32, whose rounding reaches 1.2e-7 of the value here; the
port evaluates in f64)."""

import itertools
import json
from pathlib import Path

import numpy as np
import pydantic
import pytest

from vod_tpu.configs import base as jax_base
from vod_tpu.configs import search as jax_search
from vod_tpu.configs import trainer as jax_trainer
from vod_tpu.configs.datasets import QueriesDatasetConfig as JaxQueries
from vod_tpu.exps import structconf as jax_sc
from vod_tpu_torch.configs import AllowMutations, apply_diff, trainer
from vod_tpu_torch.configs.datasets import QueriesDatasetConfig
from vod_tpu_torch.configs.search import DenseFactoryConfig, SearchFactoryDefaults
from vod_tpu_torch.exps import structconf as sc

ROOT = Path(__file__).resolve().parent.parent
PRESETS = sorted(sc.preset_root().rglob("*.yaml"))


def test_preset_root_is_the_repos() -> None:
    assert sc.preset_root() == jax_sc.preset_root() == ROOT / "configs" / "presets"


@pytest.mark.parametrize("path", sorted((ROOT / "configs").glob("*.yaml")), ids=lambda p: p.name)
def test_config_file_equals_jax(path: Path) -> None:
    got = sc.Experiment.from_file(str(path))
    assert got.to_dict() == jax_sc.Experiment.from_file(str(path)).model_dump()
    assert sc.load_raw_config(str(path)) == jax_sc.load_raw_config(str(path))


@pytest.mark.parametrize("preset", PRESETS, ids=lambda p: str(p.relative_to(sc.preset_root())))
def test_each_preset_composes_as_in_jax(preset: Path, tmp_path: Path) -> None:
    f = tmp_path / "exp.yaml"
    f.write_text(f"extends: ['{preset}']\n")
    assert sc.Experiment.from_file(str(f)).to_dict() == jax_sc.Experiment.from_file(str(f)).model_dump()


def test_every_arch_task_composition_equals_jax(tmp_path: Path) -> None:
    archs = sorted(p.stem for p in (sc.preset_root() / "arch").glob("*.yaml"))
    tasks = sorted(p.stem for p in (sc.preset_root() / "task").glob("*.yaml"))
    assert len(archs) >= 5 and len(tasks) >= 2
    for i, (arch, task) in enumerate(itertools.product(archs, tasks)):
        f = tmp_path / f"exp{i}.yaml"
        f.write_text(f"extends: [task/{task}, arch/{arch}]\n")
        got, want = sc.Experiment.from_file(str(f)), jax_sc.Experiment.from_file(str(f))
        assert got.to_dict() == want.model_dump(), (arch, task)
        assert got.trainer.batch_size.fields_set == want.trainer.batch_size.model_fields_set


RAWS = {
    "explicit_batch": {"trainer": {"batch_size": {"effective": 32, "per_device": 8}, "max_steps": "5"}},
    "effective_only": {"trainer": {"batch_size": {"effective": 16}}},
    "coerced": {"trainer": {"learning_rate": "1e-4", "max_steps": 5.0, "gradient_clip_val": 1},
                "collate": {"do_sample": "yes", "temperature": 2}, "model": {"learn_scaler": 0}},
    "search": {"search_defaults": {"dense": {"codec": "pq", "aniso_eta": "auto", "approx_recall": None,
                                             "n_subquantizers": 8.0}, "sparse": {"max_postings": 4096}}},
    "nested": {"trainer": {"lr_schedule": {"kind": "cosine", "warmup_steps": 10},
                           "parameters": {"dense": {"mode": "linear", "value": 1}}},
               "dataloader": {"sampler": {"mode": "inverse_frequency", "key": "answer"}}},
    "datasets": {"datasets": {"queries": [{"identifier": "{x}-q", "name_or_path": "beir", "link": "{x}-s",
                                           "__vars__": {"x": ["a", "b"]}}],
                              "sections": [{"identifier": "{x}-s", "name_or_path": "beir", "subsets": ["{x}"],
                                            "__vars__": {"x": ["a", "b", "c"]}}]}},
}


@pytest.mark.parametrize("raw", RAWS.values(), ids=RAWS.keys())
def test_parse_and_fields_set_equal_jax(raw: dict) -> None:
    got, want = sc.Experiment.parse(raw), jax_sc.Experiment.parse(raw)
    assert got.to_dict() == want.model_dump()
    assert got.fields_set == want.model_fields_set
    for name in got.fields_set:
        g, w = getattr(got, name), getattr(want, name)
        assert g.fields_set == w.model_fields_set, name
        assert g.to_dict(exclude_unset=True) == w.model_dump(exclude_unset=True), name
    assert json.loads(got.to_json()) == json.loads(want.model_dump_json(indent=2))


BAD = {
    "extra_top": {"nope": 1},
    "extra_model": {"model": {"hidden": 3}},
    "extra_nested": {"trainer": {"batch_size": {"per_dev": 3}}},
    "extra_dense": {"search_defaults": {"dense": {"codecs": "pq"}}},
    "bad_literal": {"model": {"kind": "bert"}},
    "bad_dense_literal": {"search_defaults": {"dense": {"code_bits": 6}}},
    "string_for_literal_int": {"search_defaults": {"dense": {"code_bits": "8"}}},
    "fractional_int": {"trainer": {"max_steps": 5.5}},
    "int_for_str": {"tokenizer": {"name_or_path": 5}},
    "bad_bool": {"collate": {"do_sample": 2}},
    "bad_float": {"trainer": {"learning_rate": "fast"}},
    "list_for_str_list": {"trainer": {"metrics": "mrr"}},
    "null_for_int": {"trainer": {"max_steps": None}},
}


@pytest.mark.parametrize("raw", BAD.values(), ids=BAD.keys())
def test_invalid_configs_raise_value_error_in_both(raw: dict) -> None:
    with pytest.raises(ValueError):
        jax_sc.Experiment.parse(raw)
    with pytest.raises(ValueError):
        sc.Experiment.parse(raw)


def test_expand_vars_and_link_validation_equal_jax() -> None:
    cfgs = [{"identifier": "{lang}-qa", "split": "train-{lang}", "__vars__": {"lang": ["en", "fr"]}},
            {"identifier": "plain"}]
    assert sc.expand_vars(cfgs) == jax_sc.expand_vars(cfgs)
    raw = {"queries": [{"identifier": "q1", "name_or_path": "x", "link": "s1"}],
           "sections": [{"identifier": "s1", "name_or_path": "y"}, {"identifier": "orphan", "name_or_path": "z"}]}
    assert sc.DatasetsConfig.parse(raw).to_dict() == jax_sc.DatasetsConfig.parse(raw).model_dump()
    bad = {"queries": [{"identifier": "q", "name_or_path": "x", "link": "nope"}], "sections": []}
    for mod in (sc, jax_sc):
        with pytest.raises(ValueError, match="unknown section shard"):
            mod.DatasetsConfig.parse(bad)


def test_config_json_reads_across_both_ways(tmp_path: Path) -> None:
    raw = {**RAWS["coerced"], **RAWS["nested"], "search_defaults": RAWS["search"]["search_defaults"],
           "datasets": RAWS["datasets"]["datasets"]}
    (tmp_path / "jax.json").write_text(jax_sc.Experiment.parse(raw).model_dump_json(indent=2))
    (tmp_path / "port.json").write_text(sc.Experiment.parse(raw).to_json(indent=2))
    from_jax = sc.Experiment.from_file(str(tmp_path / "jax.json"))
    from_port = jax_sc.Experiment.from_file(str(tmp_path / "port.json"))
    assert from_jax.to_dict() == from_port.model_dump() == jax_sc.Experiment.parse(raw).model_dump()
    # a config.json names every field, in both packages
    assert from_jax.trainer.batch_size.fields_set == from_port.trainer.batch_size.model_fields_set == {
        "effective", "per_device"}


def test_apply_diff_and_realize_equal_jax() -> None:
    t, jt = trainer.TrainerConfig(), jax_trainer.TrainerConfig()
    diff = {"batch_size": {"per_device": 4}, "learning_rate": None, "parameters": {"d": {"value": 2}}}
    assert apply_diff(t, diff).to_dict() == jax_base.apply_diff(jt, diff).model_dump()
    model_diff = trainer.TrainerConfig(max_steps=7, batch_size={"effective": 64})
    jax_diff = jax_trainer.TrainerConfig(max_steps=7, batch_size={"effective": 64})
    assert apply_diff(t, model_diff).to_dict() == jax_base.apply_diff(jt, jax_diff).model_dump()
    for d in ({"dense": {"codec": "pq", "n_subquantizers": 16}, "sparse": None}, {"sparse": {"k1": 0.9}}, None):
        got, want = SearchFactoryDefaults().realize(d), jax_search.SearchFactoryDefaults().realize(d)
        for name in ("dense", "sparse"):
            g, w = getattr(got, name), getattr(want, name)
            assert (g is None and w is None) or SearchFactoryDefaults(**{name: g}).to_dict()[name] == w.model_dump()
    assert (DenseFactoryConfig() + {"codec": "ivfpq"}).codec == "ivfpq"


def test_frozen_and_allow_mutations() -> None:
    t = trainer.TrainerConfig()
    with pytest.raises(ValueError, match="frozen"):
        t.max_steps = 3
    with pytest.raises(pydantic.ValidationError):
        jax_trainer.TrainerConfig().max_steps = 3
    with AllowMutations(t):
        t.max_steps = 3
    assert t.max_steps == 3
    with pytest.raises(ValueError):
        t.max_steps = 4


def test_dataset_fingerprint_and_callable_source_equal_jax() -> None:
    kw = dict(identifier="q", name_or_path="beir", subsets=["scifact"], split="test", link="s",
              options={"subset_size": 10, "seed": 3})
    assert QueriesDatasetConfig(**kw).fingerprint() == JaxQueries(**kw).fingerprint()

    def loader(subsets=None, split="train"):
        return []

    assert QueriesDatasetConfig(identifier="q", name_or_path=loader).name_or_path is loader


def test_schedule_config_equals_jax() -> None:
    for kw in ({"mode": "linear", "start": 0.0, "value": 1.0, "period": 20}, {"mode": "step", "period": 3},
               {"mode": "exponential", "start": 0.5, "value": 2.0, "period": 10, "offset": 2}):
        got, want = trainer.ScheduleConfig(**kw).instantiate(), jax_trainer.ScheduleConfig(**kw).instantiate()
        assert [got(s) for s in range(30)] == [want(s) for s in range(30)]


SCHEDULES = [
    dict(kind="constant"), dict(kind="constant", warmup_steps=5),
    dict(kind="linear"), dict(kind="linear", warmup_steps=7, end_factor=0.1),
    dict(kind="linear", warmup_steps=3, decay_steps=20, end_factor=0.5),
    dict(kind="cosine", warmup_steps=0, end_factor=0.1), dict(kind="cosine", warmup_steps=10),
    dict(kind="cosine", warmup_steps=4, decay_steps=30, end_factor=0.3),
]


@pytest.mark.parametrize("kw", SCHEDULES, ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_lr_schedule_equals_optax_at_every_update(kw: dict) -> None:
    lr, max_steps = 3e-4, 50
    got = trainer.LRScheduleConfig(**kw).instantiate(lr, max_steps)
    want = jax_trainer.LRScheduleConfig(**kw).instantiate(lr, max_steps)
    if not callable(want):
        assert got == want
        return
    counts = range(max_steps + 6)
    np.testing.assert_allclose([got(c) for c in counts], [float(want(c)) for c in counts], atol=2.5e-7 * lr, rtol=0)
