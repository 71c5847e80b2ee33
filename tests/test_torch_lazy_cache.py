"""The port's lazy arrays and zarr stores (`vod_tpu_torch/types/lazy.py`), its
artifact cache (`utils/cache.py`), fingerprints of weights, datasets and
tokenizers (`utils/fingerprint.py`) and the embedding cache
(`runtime/predict.py:cached_embeddings`) against the JAX package, mirroring
the fingerprint case of `tests/test_data.py` and the `cached_embeddings`
path of `examples/predict_and_index.py`.

Equalities here are exact: the store's bytes, `factory.json` and the spec,
the fingerprints of carried weights (JAX's key), the embeddings read back.
The port's raw chunks are read by `tensorstore` through the JAX package's
`TensorStoreFactory.open`; JAX's blosc-compressed store is one the port
cannot decode, which `cached_embeddings` treats as a miss.
"""

import importlib
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helpers import _VOCAB, tiny_tokenizer
from tests.torch_helpers import np_of
from vod_tpu.runtime import DeviceCorpus as JaxCorpus
from vod_tpu.runtime.predict import cached_embeddings as jax_cached_embeddings
from vod_tpu.types import lazy as jlazy
from vod_tpu_torch.data.tokenizer import WordPieceTokenizer
from vod_tpu_torch.runtime import build_device_corpus, cached_embeddings
from vod_tpu_torch.types import LazyArray, TensorStoreFactory, UnreadableStore, as_lazy_array
from vod_tpu_torch.utils import (
    CacheManager,
    cached_artifact_path,
    fingerprint,
    fingerprint_dataset,
    fingerprint_params,
    fingerprint_tokenizer,
)

jfp = importlib.import_module("vod_tpu.utils.fingerprint")  # the package exports a function of that name


def test_factory_json_spec_and_store_round_trip_through_tensorstore(tmp_path: Path):
    x = np.random.default_rng(0).standard_normal((2500, 4)).astype(np.float32)
    f = TensorStoreFactory(tmp_path / "s", (2500, 4))
    jf = jlazy.TensorStoreFactory(tmp_path / "s", (2500, 4))
    assert f.to_json() == jf.to_json() and f.spec(create=True) == jf.spec(create=True) and f.spec() == jf.spec()
    assert not f.exists()
    f.instantiate().write(x)
    assert f.exists() and json.loads((tmp_path / "s" / "factory.json").read_text()) == jf.to_json()
    zarray = json.loads((tmp_path / "s" / ".zarray").read_text())
    assert zarray["compressor"] is None and zarray["chunks"] == [1024, 4] and zarray["dtype"] == "<f4"
    assert sorted(p.name for p in (tmp_path / "s").iterdir()) == [".zarray", "0.0", "1.0", "2.0", "factory.json"]
    # the JAX package (tensorstore) reads the port's store back exactly
    np.testing.assert_array_equal(np.asarray(jf.open().read().result()), x)
    g = TensorStoreFactory.from_path(tmp_path / "s")
    assert g.to_json() == f.to_json()
    store = g.open()
    np.testing.assert_array_equal(store.read(), x)
    np.testing.assert_array_equal(store[1000:1100], x[1000:1100])
    np.testing.assert_array_equal(store[[3, 2047, 2499]], x[[3, 2047, 2499]])
    (tmp_path / "s" / "1.0").unlink()  # a missing chunk reads as the fill value
    assert (store[1024:2048] == 0).all() and (store[:1024] == x[:1024]).all()
    f.instantiate()  # a new store deletes the old chunks
    assert (f.open().read() == 0).all()


def test_a_compressed_store_is_unreadable_not_wrong(tmp_path: Path):
    jf = jlazy.TensorStoreFactory(tmp_path / "j", (10, 3))
    jf.instantiate().write(np.ones((10, 3), np.float32)).result()
    assert json.loads((tmp_path / "j" / ".zarray").read_text())["compressor"]["id"] == "blosc"
    with pytest.raises(UnreadableStore, match="blosc"):
        TensorStoreFactory.from_path(tmp_path / "j").open()


def test_lazy_array_over_arrays_tensors_and_factories(tmp_path: Path):
    x = np.arange(24, dtype=np.float32).reshape(6, 4)
    f = TensorStoreFactory(tmp_path / "s", (6, 4), chunk_rows=4)
    f.instantiate().write(x)
    for src in (x, torch.from_numpy(x), f):
        lazy = as_lazy_array(src)
        assert isinstance(lazy, LazyArray) and as_lazy_array(lazy) is lazy
        assert lazy.shape == (6, 4) and len(lazy) == 6
        np.testing.assert_array_equal(lazy[1:5], x[1:5])
        np.testing.assert_array_equal(lazy.to_numpy(), x)
    np.testing.assert_array_equal(np.asarray(jlazy.LazyArray(jlazy.TensorStoreFactory(tmp_path / "s", (6, 4),
                                                                                      chunk_rows=4))[2:3]), x[2:3])


def test_cache_manager_and_artifact_paths(tmp_path: Path):
    with CacheManager() as d:
        tmp = d
        assert d.is_dir()
    assert not tmp.exists()
    cm = CacheManager(tmp_path / "c")
    (tmp_path / "c" / "old").write_text("x")
    assert cm.path("a", "b.bin").parent.is_dir()
    CacheManager(tmp_path / "c", delete_existing=True)
    assert not (tmp_path / "c" / "old").exists()
    p = cached_artifact_path(tmp_path, "vectors", "abc", ".zarr")
    assert p == jlazy.pathlib.Path(tmp_path) / "vectors" / "abc.zarr" and p.parent.is_dir()


def test_fingerprints_of_dicts_datasets_and_tokenizers_equal_jax():
    a = {"w": np.arange(4.0), "b": {"x": np.ones(2)}}
    b = {"w": np.arange(4.0), "b": {"x": np.ones(2)}}
    assert fingerprint_params(a) == fingerprint_params(b) == jfp.fingerprint_params(a)
    b["w"] = b["w"] + 1
    assert fingerprint_params(a) != fingerprint_params(b) and fingerprint_params(b) == jfp.fingerprint_params(b)
    assert fingerprint({"k": 1}) != fingerprint({"k": 2}) and fingerprint({"k": 1}) == jfp.fingerprint({"k": 1})
    rows = [{"id": "a", "text": "x"}, {"id": "b", "text": "y"}]
    assert fingerprint_dataset(rows) == jfp.fingerprint_dataset(rows)

    class WithFp(list):
        _fingerprint = "abc123"

    assert fingerprint_dataset(WithFp(rows)) == jfp.fingerprint_dataset(WithFp(rows)) != fingerprint_dataset(rows)
    hf = tiny_tokenizer()
    assert fingerprint_tokenizer(hf) == jfp.fingerprint_tokenizer(hf)
    port = WordPieceTokenizer(_VOCAB)
    # declared: the class name is part of the key
    assert fingerprint_tokenizer(port) != fingerprint_tokenizer(hf)
    assert fingerprint_tokenizer(port) == fingerprint_tokenizer(WordPieceTokenizer(_VOCAB))


def _rankers(splade: bool = False):
    from vod_tpu.models import Ranker as JaxRanker
    from vod_tpu.models import RetrievalGradients as JaxRG
    from vod_tpu.models import TransformerEncoderConfig as JaxCfg
    from vod_tpu.models import VodPoolerConfig as JaxPool
    from vod_tpu_torch.models import (
        Ranker,
        RetrievalGradients,
        TransformerEncoderConfig,
        VodPoolerConfig,
        system_flax_to_state_dict,
    )

    widths = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64)
    pool = dict(agg_method="mean", output_norm="l2", scaler=10.0, learn_scaler=True)
    jmodel = JaxRanker(cfg=JaxCfg(dtype=jnp.float32, pooler=JaxPool(**pool), **widths), gradients=JaxRG(),
                       splade_encoder=splade)
    ids = jnp.ones((1, 8), jnp.int32)
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(0), ids, ids, method=JaxRanker.encode_field))
    model = Ranker(TransformerEncoderConfig(dtype=torch.float32, pooler=VodPoolerConfig(**pool), **widths),
                   RetrievalGradients(), splade_encoder=splade, device="cpu")
    model.load_state_dict(system_flax_to_state_dict(params))
    return jmodel, params, model


@pytest.mark.parametrize("splade", [False, True])
def test_fingerprint_params_of_carried_weights_equals_jax(splade: bool):
    _, params, model = _rankers(splade)
    assert fingerprint_params(model) == jfp.fingerprint_params(params)
    with torch.no_grad():
        next(model.parameters())[0] += 1.0
    assert fingerprint_params(model) != jfp.fingerprint_params(params)


def test_cached_embeddings_miss_hit_hole_and_jax_key(tmp_path: Path):
    """A miss computes and writes the store under JAX's key; a hit reads it
    back bit for bit without encoding the corpus; a zero row (a hole) forces a
    recompute; a store JAX wrote (blosc) under the same key is a miss."""
    jmodel, params, model = _rankers()
    rng = np.random.default_rng(0)
    ids = rng.integers(1, 64, (300, 8)).astype(np.int32)
    mask = np.ones((300, 8), np.int32)
    corpus = build_device_corpus(ids, mask, device="cpu")
    calls = []

    def encode(i, m):
        calls.append(int(i.shape[0]))
        return model.encode_field(i, m)

    kw = dict(cache_dir=str(tmp_path), dataset_fingerprint="demo", chunk=128)
    miss = cached_embeddings(encode, model, corpus, **kw)
    assert calls == [1, 128, 128, 44]  # the probe, then three chunks
    dirs = list((tmp_path / "vectors").iterdir())
    assert len(dirs) == 1
    calls.clear()
    hit = cached_embeddings(encode, model, corpus, **kw)
    assert calls == [1] and torch.equal(hit, miss) and hit.dtype == torch.float32
    # JAX's key for the same weights: JAX finds the port's store (a hit, read by tensorstore)
    japply = lambda p, i, m: jmodel.apply(p, i, m, method=type(jmodel).encode_field)  # noqa: E731
    jcorpus = JaxCorpus(input_ids=jnp.asarray(ids), attention_mask=jnp.asarray(mask))
    jhit = jax_cached_embeddings(japply, params, jcorpus, **kw)
    np.testing.assert_array_equal(np_of(jhit), np_of(miss))
    assert list((tmp_path / "vectors").iterdir()) == dirs
    # a hole: a zeroed chunk file reads as zero rows, and the store is recomputed
    (dirs[0] / "0.0").write_bytes(bytes((dirs[0] / "0.0").stat().st_size))
    calls.clear()
    again = cached_embeddings(encode, model, corpus, **kw)
    assert calls == [1, 128, 128, 44] and torch.equal(again, miss)
    np.testing.assert_array_equal(TensorStoreFactory.from_path(dirs[0]).open().read(), np_of(miss))
    # JAX's own (compressed) store under that key: unreadable here, so a miss
    jlazy.TensorStoreFactory(dirs[0], tuple(miss.shape)).instantiate().write(np_of(miss)).result()
    calls.clear()
    assert torch.equal(cached_embeddings(encode, model, corpus, **kw), miss) and len(calls) == 4
    assert json.loads((dirs[0] / ".zarray").read_text())["compressor"] is None


def test_predict_and_index_example_defaults_to_the_card_and_runs_on_the_cpu():
    from vod_tpu_torch.examples import predict_and_index
    from vod_tpu_torch.models import CrossEncoder, SpladeEncoder
    from vod_tpu_torch.search import dynamic_index_init

    for fn in (SpladeEncoder, CrossEncoder, dynamic_index_init):
        assert __import__("inspect").signature(fn).parameters["device"].default == "cuda", fn
    assert predict_and_index.parser().parse_args([]).device == "cuda"
    out = predict_and_index.main(["--device", "cpu", "--n", "256"])
    assert out["shape"] == (256, 64) and out["cache_max_diff"] == 0.0
    assert [row[0] for row in out["top5"]] == [0, 1, 2, 3]
