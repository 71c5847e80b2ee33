"""The port of `examples/real_text_1m_bench.py` against the JAX script and
package on the CPU, at toy sizes.

- The harvest and the query windows over a temporary root of seeded text
  files: the same passages, rows and texts as the JAX script's `harvest`
  and `query_windows` (its harvest pointed at the same root).
- Three AdamW steps of the contrastive encoder at hidden 32, 2 layers, dim
  16, batch 8, f32, from JAX's initial `Ranker` parameters
  (`models/convert.py:system_flax_to_state_dict`) against the JAX script's
  step rebuilt from `vod_tpu` and optax: losses within 1e-5 (relative),
  embeddings afterwards within 1e-4 (absolute).
- The three codecs through each package's `build_dense_from_config` on a
  seeded 8,192 x 192 set (192: the PQ codecs' 96 subquantizers and
  192-dim refine need a width that 96 divides and 192 fits): int8's ids
  equal JAX's; the PQ codecs, whose training draws differ, within 0.03 of
  JAX's recall@10.
- BM25 with and without stemming, on the windows as they are and inflected:
  gold-hit@10 equal to the JAX script's route.
- `main` at toy flags: the JAX script's keys, `card` and the corpus
  fingerprint, finite numbers, the passage count when the root yields fewer
  than `--n`, and the embedding cache reused on the same corpus and
  recomputed on another.
"""

import functools
import importlib.util
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vod_tpu_torch.data.loaders import local_text
from vod_tpu_torch.examples import real_text_1m_bench as rt
from vod_tpu_torch.examples.real_embedding_eval import make_pair_batch
from vod_tpu_torch.models import Ranker, RetrievalGradients, system_flax_to_state_dict
from vod_tpu_torch.search.factory import build_dense_from_config

ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
LOSS_RTOL = 1e-5
EMB_ATOL = 1e-4
PQ_RECALL_MARGIN = 0.03
JAX_KEYS = ["n", "dim", "q", "corpus", "top64_variance_share", "encoder_self_hit10", "int8", "pq96x4fs+ref",
            "serving-direct", "bm25_unstemmed", "bm25_stemmed"]
STEMS = ["model", "index", "search", "train", "vector", "query", "token", "layer", "batch", "shard", "score",
         "weight", "kernel", "passage", "corpus", "encoder", "reader", "answer", "config", "stage", "chunk",
         "matrix", "tensor", "cluster", "center", "window", "record", "stream", "number", "letter"]
SUFFIXES = ["", "s", "ing", "ed", "er", "ation", "ly", "ness"]


def _jax_script(name: str):
    spec = importlib.util.spec_from_file_location(f"jax_example_{name}", ROOT / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def write_text_root(root: Path, files: int = 10, words: int = 2000, seed: int = 0) -> Path:
    """`files` seeded text files (.txt, .md, .rst, .py) of Zipf-drawn word
    forms (stems and their inflections), in two directories."""
    rng = np.random.default_rng(seed)
    vocab = [s + x for s in STEMS for x in SUFFIXES] + [f"w{i}x" for i in range(400)]
    p = 1.0 / np.arange(1, len(vocab) + 1)
    p /= p.sum()
    exts = [".txt", ".md", ".rst", ".py"]
    for f in range(files):
        path = root / f"pkg{f % 2}" / f"doc{f}{exts[f % len(exts)]}"
        path.parent.mkdir(parents=True, exist_ok=True)
        picks = rng.choice(len(vocab), size=words, p=p)
        path.write_text(" ".join(vocab[i] for i in picks) + "\n")
    return root


@pytest.fixture(scope="module")
def text_root(tmp_path_factory) -> Path:
    return write_text_root(tmp_path_factory.mktemp("text_root"))


@pytest.fixture(scope="module")
def jax_rt():
    return _jax_script("real_text_1m_bench")


def _jax_harvest(jax_rt, monkeypatch, root: Path, n: int) -> list:
    import vod_tpu.data.loaders.local_text as jax_local_text

    monkeypatch.setattr(jax_local_text, "harvest_text_passages",
                        functools.partial(jax_local_text.harvest_text_passages, roots=[str(root)]))
    return jax_rt.harvest(n)


@pytest.mark.parametrize("n", [100, 1 << 20])
def test_harvest_and_query_windows_equal_jax(n: int, text_root: Path, jax_rt, monkeypatch) -> None:
    got = rt.harvest(n, roots=[str(text_root)])
    want = _jax_harvest(jax_rt, monkeypatch, text_root, n)
    assert got == want and 0 < len(got) <= n
    rows, texts = rt.query_windows(got, np.random.default_rng(0), 64)
    want_rows, want_texts = jax_rt.query_windows(want, np.random.default_rng(0), 64)
    assert np.array_equal(rows, want_rows) and texts == want_texts


def test_corpus_fingerprint_follows_ids_contents_and_order(text_root: Path) -> None:
    passages = rt.harvest(50, roots=[str(text_root)])
    fp = rt.corpus_fingerprint(passages)
    assert fp == rt.corpus_fingerprint([dict(p) for p in passages]) and len(fp) == 32
    changed = [dict(p) for p in passages]
    changed[7]["content"] += " extra"
    assert rt.corpus_fingerprint(changed) != fp
    assert rt.corpus_fingerprint(passages[::-1]) != fp
    assert rt.corpus_fingerprint(passages[:-1]) != fp


def _jax_pair_batch(seed: int, b: int, ids_np: np.ndarray, mask_np: np.ndarray):
    """The JAX script's nested `make_pair_batch`, as numpy arrays."""
    r = np.random.default_rng(seed)
    rows = r.integers(0, len(ids_np), size=b)
    q_ids = np.zeros((b, 16), np.int32)
    q_mask = np.zeros((b, 16), np.int32)
    for i, row in enumerate(rows):
        length = int(mask_np[row].sum())
        w = min(16, max(4, length // 3))
        s0 = int(r.integers(0, max(1, length - w)))
        q_ids[i, :w] = ids_np[row, s0 : s0 + w]
        q_mask[i, :w] = 1
    return q_ids, q_mask, ids_np[rows], mask_np[rows]


def test_three_train_steps_and_the_embeddings_equal_jax(text_root: Path) -> None:
    from vod_tpu.models import Ranker as JaxRanker
    from vod_tpu.models import RetrievalGradients as JaxRetrievalGradients
    from vod_tpu.models import TransformerEncoderConfig as JaxEncoderConfig
    from vod_tpu.models import VodPoolerConfig as JaxPoolerConfig

    passages = rt.harvest(400, roots=[str(text_root)])
    vocab = local_text.build_word_vocab(passages, vocab_size=rt.VOCAB)
    ids, mask = local_text.encode_passages(passages, vocab, max_length=rt.MAX_LENGTH)
    widths = dict(hidden=32, layers=2, heads=2, intermediate=64)
    dim, batch, steps = 16, 8, 3
    cfg = JaxEncoderConfig(vocab_size=rt.VOCAB, hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64,
                           max_position_embeddings=rt.MAX_LENGTH, dtype=jnp.float32,
                           pooler=JaxPoolerConfig(agg_method="mean", projection_size=dim, output_norm="l2",
                                                  scaler=10.0, learn_scaler=True))
    jmodel = JaxRanker(cfg=cfg, gradients=JaxRetrievalGradients())
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(0), jnp.asarray(ids[:2]), jnp.asarray(mask[:2]),
                                        method=JaxRanker.encode_field))
    model = Ranker(rt.encoder_config(dim, dtype=torch.float32, **widths), RetrievalGradients(), device=CPU)
    model.load_state_dict(system_flax_to_state_dict(params))

    tx = optax.adamw(3e-4, weight_decay=0.01)
    opt_state = tx.init(params)

    @jax.jit
    def step(params, opt_state, qi, qm, si, sm):
        def loss_fn(p):
            qe = jmodel.apply(p, qi, qm, method=JaxRanker.encode_field)
            se = jmodel.apply(p, si, sm, method=JaxRanker.encode_field)
            return optax.softmax_cross_entropy_with_integer_labels(qe @ se.T, jnp.arange(qi.shape[0])).mean()

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    want_losses = []
    for s in range(steps):
        arrays = _jax_pair_batch(1000 + s, batch, ids, mask)
        for a, b in zip(arrays, make_pair_batch(1000 + s, batch, ids, mask)):
            assert np.array_equal(a, b)
        params, opt_state, loss = step(params, opt_state, *map(jnp.asarray, arrays))
        want_losses.append(float(loss))

    got_losses = rt.train(model, ids, mask, steps, batch, CPU)
    assert got_losses == pytest.approx(want_losses, rel=LOSS_RTOL)

    got = rt.embed(model, ids, mask, CPU, chunk=128)
    want = np.asarray(jmodel.apply(params, jnp.asarray(ids), jnp.asarray(mask), method=JaxRanker.encode_field))
    assert got.shape == (len(passages), dim)
    np.testing.assert_allclose(got, want, rtol=0, atol=EMB_ATOL)
    q_ids, q_mask = rt.encode_queries(["Model indexes QUERY zzz", "token"], vocab)
    assert q_ids[0, :4].tolist() == [vocab.get("model", 1), vocab.get("indexes", 1), vocab.get("query", 1), 1]
    assert q_mask.sum(axis=1).tolist() == [4, 1]


def _codec_data(n: int = 8192, d: int = 192, nq: int = 128, seed: int = 0):
    """Unit rows with a decaying spectrum, and queries near corpus rows."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32) * np.exp(-np.arange(d) / 24.0).astype(np.float32)
    x = x @ np.linalg.qr(rng.standard_normal((d, d)))[0].astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = x[rng.choice(n, nq, replace=False)] + 0.05 * rng.standard_normal((nq, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    gt = np.argsort(-(q @ x.T), axis=1, kind="stable")[:, : rt.K]
    return x, q.astype(np.float32), gt


def _jax_codec_ids(name: str, x: np.ndarray, q: np.ndarray) -> np.ndarray:
    from vod_tpu.configs.search import DenseFactoryConfig as JaxFactoryConfig
    from vod_tpu.search import SearchQueries as JaxQueries
    from vod_tpu.search.dense import DenseIndex, IVFIndex, PQIndex, dense_search, ivf_search, pq_search
    from vod_tpu.search.factory import build_dense_from_config as jax_build
    from vod_tpu.search.ivfpq import IVFPQIndex, ivfpq_search

    cfg = JaxFactoryConfig(**{f: getattr(rt.CODECS[name], f) for f in ("codec", "n_subquantizers", "code_bits",
                                                                        "coarse_dim", "refine", "refine_dim",
                                                                        "k_factor", "train_size", "keep_codes",
                                                                        "approx_recall")})
    index = jax_build(cfg, jnp.asarray(x), rng=jax.random.PRNGKey(0))
    search = (pq_search if isinstance(index, PQIndex) else ivfpq_search if isinstance(index, IVFPQIndex)
              else ivf_search if isinstance(index, IVFIndex) else dense_search)
    assert isinstance(index, (DenseIndex, PQIndex, IVFIndex, IVFPQIndex))
    return np.asarray(search(index, JaxQueries(vector=jnp.asarray(q)), top_k=rt.K).indices)


def _recall(got: np.ndarray, gt: np.ndarray) -> float:
    return float(np.mean([len(set(got[i].tolist()) & set(gt[i].tolist())) / rt.K for i in range(len(gt))]))


@pytest.mark.parametrize("name", list(rt.CODECS))
def test_codecs_against_jax(name: str) -> None:
    x, q, gt = _codec_data()
    index = build_dense_from_config(rt.CODECS[name], x, generator=torch.Generator().manual_seed(0), device=CPU)
    got = rt.search_index(index, rt.SearchQueries(vector=torch.from_numpy(q)), rt.K).indices.numpy()
    want = _jax_codec_ids(name, x, q)
    if name == "int8":
        assert np.array_equal(got, want)
    else:  # the PQ training draws differ (ROADMAP §C): recall within the margin
        assert abs(_recall(got, gt) - _recall(want, gt)) <= PQ_RECALL_MARGIN, (_recall(got, gt), _recall(want, gt))
    assert _recall(got, gt) > 0.8


def _jax_gold_hits(contents, qtexts, qrows, stem: bool) -> dict:
    """The JAX script's BM25 block for one stem setting."""
    from vod_tpu.native import analyze_texts
    from vod_tpu.search import SearchQueries as JaxQueries
    from vod_tpu.search import build_sparse_index_native
    from vod_tpu.search.sparse import sparse_search

    def inflect(text: str) -> str:
        return " ".join(
            w + "s" if w.isalpha() and len(w) > 3 and not w.endswith("s") else w
            for w in text.split()
        )

    d_ids, d_counts = analyze_texts(contents, vocab_size=1 << 18, max_terms=64, stem=stem)
    doc_terms = [d_ids[i, : d_counts[i]].tolist() for i in range(len(contents))]
    sidx = build_sparse_index_native(doc_terms, n_terms=1 << 18, max_postings=2048)
    out = {}
    for suffix, texts in {"": qtexts, "_inflected": [inflect(t) for t in qtexts]}.items():
        q_ids, _ = analyze_texts(texts, vocab_size=1 << 18, max_terms=32, stem=stem)
        got = np.asarray(sparse_search(sidx, JaxQueries(terms=jnp.asarray(q_ids)), top_k=rt.K).indices)
        out[f"gold_hit10{suffix}"] = float(np.mean([qrows[i] in set(got[i].tolist()) for i in range(len(qrows))]))
    return out


@pytest.mark.parametrize("stem", [False, True], ids=["unstemmed", "stemmed"])
def test_bm25_gold_hits_equal_jax(stem: bool, text_root: Path) -> None:
    passages = rt.harvest(600, roots=[str(text_root)])
    qrows, qtexts = rt.query_windows(passages, np.random.default_rng(0), 128)
    contents = [p["content"] for p in passages]
    got = rt.bm25_gold_hits(contents, qtexts, qrows, stem, CPU)
    want = _jax_gold_hits(contents, qtexts, qrows, stem)
    assert list(got) == ["build_s", "gold_hit10", "gold_hit10_inflected"]
    assert {k: got[k] for k in want} == want
    assert rt.inflect("the models index tokens x1 abc") == "the models indexs tokens x1 abc"


def _finite(obj) -> None:
    if isinstance(obj, dict):
        for v in obj.values():
            _finite(v)
    elif isinstance(obj, list):
        for v in obj:
            _finite(v)
    elif isinstance(obj, float):
        assert math.isfinite(obj)


def test_main_at_toy_flags(text_root: Path, tmp_path: Path, capsys) -> None:
    argv = ["--n", str(1 << 20), "--steps", "3", "--batch", "16", "--q", "64", "--dim", "192", "--device", "cpu"]
    out = rt.main(argv, cache_dir=tmp_path, roots=[str(text_root)])
    passages = rt.harvest(1 << 20, roots=[str(text_root)])
    assert list(out)[: len(JAX_KEYS) + 2] == JAX_KEYS[:4] + ["corpus_fingerprint", "harvest_root"] + JAX_KEYS[4:]
    assert out["n"] == len(passages) < (1 << 20) and out["card"] == "cpu"
    assert out["corpus_fingerprint"] == rt.corpus_fingerprint(passages)
    assert out["harvest_root"] == [str(text_root)]
    for name in rt.CODECS:
        assert list(out[name]) == ["recall10", "block_qps", "serve64_qps", "build_s"]
        assert 0.5 < out[name]["recall10"] <= 1.0
    assert set(out["stages_s"]) == {"harvest_s", "vocab_encode_s", "train_s", "embed_s", "ground_truth_s"}
    assert list(out["losses"]) == [0, 2]
    _finite(out)
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith('{"n": ')
    cache = tmp_path / f"realtext_emb_{out['n']}_192_3.npz"
    assert str(np.load(cache)["fingerprint"]) == out["corpus_fingerprint"]

    # the same corpus: the cache is read, the encoder neither trained nor run
    again = rt.main(argv + ["--skip_bm25"], cache_dir=tmp_path, roots=[str(text_root)])
    assert again["losses"] == {} and "train_s" not in again["stages_s"]
    assert again["encoder_self_hit10"] == out["encoder_self_hit10"]
    assert again["int8"]["recall10"] == out["int8"]["recall10"]
    assert "bm25_stemmed" not in again

    # another corpus of the same size: the fingerprint differs and the cache is rebuilt
    other = write_text_root(tmp_path / "other", seed=1)
    third = rt.main(argv + ["--skip_bm25"], cache_dir=tmp_path, roots=[str(other)])
    assert third["n"] == out["n"] and list(third["losses"]) == [0, 2]
    assert third["corpus_fingerprint"] != out["corpus_fingerprint"]
    assert str(np.load(tmp_path / f"realtext_emb_{third['n']}_192_3.npz")["fingerprint"]) == \
        third["corpus_fingerprint"]


def test_without_a_card_it_raises() -> None:
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        rt.main(["--n", "10"])
