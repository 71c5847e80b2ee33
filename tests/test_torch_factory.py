"""The port's dense factory (`vod_tpu_torch/configs/search.py`,
`search/factory.py`) against the JAX package's.

`from_faiss_factory` gives equal fields for every factory string the JAX
package's own tests translate; the defaults are equal; flat and int8 builds
give the JAX build's arrays exactly; pq and ivf builds give the JAX index's
structure (their training draws differ); what is not ported raises
`NotImplementedError`.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from tests.torch_helpers import np_of
from vod_tpu.configs.search import DenseFactoryConfig as JaxConfig
from vod_tpu.search.factory import build_dense_from_config as jax_build
from vod_tpu_torch.configs import DenseFactoryConfig
from vod_tpu_torch.search import DenseIndex, IVFIndex, PQIndex, build_dense_from_config
from vod_tpu_torch.search.factory import build_dense_from_host

ROOT = Path(__file__).resolve().parent.parent

# every factory string of tests/test_search.py, test_ivfpq.py and test_data.py
FACTORIES = [
    ("OPQ32_64,IVFauto,PQ32x8", None), ("OPQ32_64,PQ32x8", None), ("IVF256,Flat", None), ("IVFauto,Flat", None),
    ("IVF512,PQ64x4", None), ("OPQ32_128,IVFauto,PQ32x8,RFlat", None), ("IVFauto,PQ16x8,Refine(SQ8)", None),
    ("IVFauto,PQ32x8", None), ("PQ16x8,Refine(SQ8)", None), ("OPQ64_128,PQ128x4fs", None), ("PQ64x4fs,RFlat", None),
    ("OPQ32_512,IVFauto,PQ32x8", None), ("IVF4096,PQ64x4fs,Refine(SQ8)", None), ("PQ32x8", None),
    ("OPQ32_512,IVFauto,PQ32x8", 1_000_000), ("Flat", None), ("HNSW32", 5000),
]


@pytest.mark.parametrize("factory, train_size", FACTORIES, ids=[f"{f}-{t}" for f, t in FACTORIES])
def test_from_faiss_factory_matches_jax(factory: str, train_size) -> None:
    got = DenseFactoryConfig.from_faiss_factory(factory, train_size=train_size)
    assert dataclasses.asdict(got) == JaxConfig.from_faiss_factory(factory, train_size=train_size).model_dump()


def test_defaults_and_diffs_match_jax() -> None:
    assert dataclasses.asdict(DenseFactoryConfig()) == JaxConfig().model_dump()
    diff = {"codec": "pq", "coarse_dim": None, "refine": "int8", "k_factor": 32}
    assert dataclasses.asdict(DenseFactoryConfig() + diff) == (JaxConfig() + diff).model_dump()
    with pytest.raises(TypeError):
        DenseFactoryConfig() + {"no_such_field": 1}
    with pytest.raises(ValueError, match="codec"):
        DenseFactoryConfig(codec="hnsw")


def test_msmarco_pq_realm_codec_is_the_yaml() -> None:
    """The config the card smoke run builds its periodic index from is
    exactly `configs/msmarco_pq_realm.yaml`'s `search_defaults.dense`."""
    import chip_smoke

    dense = yaml.safe_load((ROOT / "configs" / "msmarco_pq_realm.yaml").read_text())["search_defaults"]["dense"]
    assert chip_smoke.PERIODIC_DENSE == dense
    assert dataclasses.asdict(DenseFactoryConfig(**dense)) == JaxConfig(**dense).model_dump()


def _vectors() -> np.ndarray:
    return np.random.default_rng(0).standard_normal((300, 16)).astype(np.float32)


@pytest.mark.parametrize("diff", [dict(codec="flat", dtype="float32"), dict(codec="flat", refine="float32"),
                                  dict(codec="int8", kernel="fused", k_factor=8)], ids=["flat-f32", "flat-refine", "int8"])
def test_flat_and_int8_builds_match_jax(diff: dict) -> None:
    x = _vectors()
    want = jax_build(JaxConfig(**diff), jnp.asarray(x))
    got = build_dense_from_config(DenseFactoryConfig(**diff), x, device="cpu")
    assert isinstance(got, DenseIndex)
    for name in ("vectors", "scale", "refine_rows"):
        w, g = getattr(want, name), getattr(got, name)
        assert (w is None) == (g is None), name
        if w is not None:
            np.testing.assert_array_equal(np_of(g.float()), np.asarray(w, dtype=np.float32), err_msg=name)
    for name in ("n_real", "approx_recall", "kernel", "k_factor"):
        assert getattr(got, name) == getattr(want, name), name


@pytest.mark.parametrize("diff", [dict(codec="pq", n_subquantizers=8, code_bits=4, coarse_dim=None, refine="int8",
                                       refine_dim=8, k_factor=8, kmeans_iters=2),
                                  dict(codec="pq", n_subquantizers=4, use_opq=True, opq_iters=1, coarse_dim=12,
                                       kmeans_iters=2, kernel="fused"),
                                  dict(codec="ivf", n_clusters=8, nprobe=3, kmeans_iters=2, dtype="float32")],
                         ids=["pq4-exhaustive", "opq-coarse", "ivf"])
def test_pq_and_ivf_builds_have_the_jax_structure(diff: dict) -> None:
    x = _vectors()
    want = jax_build(JaxConfig(**diff), jnp.asarray(x), rng=jax.random.PRNGKey(0))
    got = build_dense_from_config(DenseFactoryConfig(**diff), x, generator=torch.Generator().manual_seed(0), device="cpu")
    assert type(got).__name__ == type(want).__name__ and isinstance(got, (PQIndex, IVFIndex))
    for f in dataclasses.fields(got):
        w, g = getattr(want, f.name), getattr(got, f.name)
        if isinstance(g, torch.Tensor):
            shape = list(np.shape(w))
            if f.name == "coarse_codes":  # the port's zero columns up to a multiple of 16
                shape[-1] = -(-shape[-1] // 16) * 16
            if f.name in ("vectors", "row_ids"):  # IVF slabs: the cell size follows the clustering
                shape[1] = g.shape[1]
            assert list(g.shape) == shape and str(g.dtype).split(".")[-1] == str(np.asarray(w).dtype), f.name
        else:
            assert g == w or (w is None and g is None), f.name


def test_unported_builds_raise(tmp_path) -> None:
    """As in JAX, `sharded` without a mesh builds the plain index and a mesh
    without `sharded` is ignored. Sharded pq, once a refusal (ROADMAP §A
    item 5b), now builds: over a one-rank mesh it is the whole index as one
    shard and answers as the unsharded index does."""
    from tests.torch_helpers import job_factory_sharded, run_ranks

    x = _vectors()
    for cfg, kw in ((DenseFactoryConfig(sharded=True), {}), (DenseFactoryConfig(), {"mesh": object()})):
        assert type(build_dense_from_config(cfg, x, device="cpu", **kw)) is DenseIndex
        assert type(build_dense_from_host(dataclasses.replace(cfg, codec="int8"), x, device="cpu", **kw)) is DenseIndex
    (res,) = run_ranks(job_factory_sharded, 1, tmp_path, "pq", x, dict(n_subquantizers=4, kmeans_iters=1))
    assert (res["type"], res["plain_type"]) == ("ShardedPQIndex", "PQIndex")
    np.testing.assert_array_equal(res["ids"], res["plain_ids"])


def test_builders_default_to_the_card() -> None:
    import inspect

    from vod_tpu_torch.search import build_ivf_index, build_pq_index

    for fn in (build_dense_from_config, build_pq_index, build_ivf_index):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
