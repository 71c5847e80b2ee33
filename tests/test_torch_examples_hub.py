"""The port of `examples/hub_checkpoint_eval.py` against the JAX script.

Skip path: with an empty `HF_HOME` the port's script prints `SKIPPED`,
exits 0 and imports no `transformers` (blocked in `sys.modules` in a
subprocess, as `tests/test_torch_cli.py` does). Run path: a tiny
random-init BERT checkpoint and its vocabulary, saved here by `transformers`
into a temporary Hugging Face cache layout (`hub/models--<org>--<name>/
snapshots/<hash>/`, `refs/main`), evaluated on `tests/fixtures/beir_tiny`
by the port's script and by the JAX script's route: `recall_10` and
`ndcg_10` are equal (both round to 4 places; the f32 encoders agree to
~1e-6, far inside the fixture's score gaps). The JAX script's own run path
fails on its parameter tree (ROADMAP §C.2), so its route is rebuilt from
`vod_tpu` functions with that one repair.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

from vod_tpu_torch.examples import hub_checkpoint_eval

ROOT = Path(__file__).resolve().parent.parent
FIXTURE = ROOT / "tests" / "fixtures" / "beir_tiny"
MODEL = "vod-test/tiny-bert"


@pytest.fixture(scope="module")
def hf_home(tmp_path_factory) -> Path:
    import torch
    import transformers

    from tests.helpers import _VOCAB

    home = tmp_path_factory.mktemp("hf")
    repo = home / "hub" / ("models--" + MODEL.replace("/", "--"))
    snapshot = repo / "snapshots" / "0123456789abcdef"
    snapshot.mkdir(parents=True)
    (repo / "refs").mkdir()
    (repo / "refs" / "main").write_text("0123456789abcdef")
    torch.manual_seed(0)
    cfg = transformers.BertConfig(vocab_size=len(_VOCAB), hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
                                  intermediate_size=64, max_position_embeddings=512)
    transformers.BertModel(cfg).save_pretrained(snapshot)
    (snapshot / "vocab.txt").write_text("\n".join(_VOCAB))
    transformers.BertTokenizerFast(vocab_file=str(snapshot / "vocab.txt")).save_pretrained(snapshot)
    return home


def test_skips_without_a_cache_and_without_transformers(tmp_path: Path) -> None:
    code = (
        "import sys\n"
        "for name in ('transformers', 'tokenizers', 'jax', 'vod_tpu', 'datasets'):\n"
        "    sys.modules[name] = None\n"
        "from vod_tpu_torch.examples import hub_checkpoint_eval\n"
        "out = hub_checkpoint_eval.main(['--device', 'cuda'])\n"
        "assert set(out) == {'skipped'}, out\n"
    )
    env = dict(os.environ, HF_HOME=str(tmp_path / "empty"))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.startswith("SKIPPED: ")
    res = subprocess.run([sys.executable, "-m", "vod_tpu_torch.examples.hub_checkpoint_eval"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and res.stdout.startswith("SKIPPED: "), res.stderr[-2000:]


def _jax_route(snapshot: Path, max_length: int, chunk: int) -> dict:
    """The JAX script's run path, line for line, on the snapshot directory,
    except one repair: the script hands `Ranker.apply` the bare backbone
    tree that `load_hf_encoder` returns, which flax refuses
    (`ScopeCollectionNotFound`; ROADMAP §C.2), so the backbone is grafted
    where the JAX CLI grafts it (`exps/cli.py:_maybe_port_hf_encoder`)."""
    import jax.numpy as jnp
    import numpy as np
    import transformers

    from vod_tpu.data.loaders.beir import BeirDatasetLoader
    from vod_tpu.models import Ranker, RetrievalGradients, VodPoolerConfig
    from vod_tpu.models.hf_import import load_hf_encoder
    from vod_tpu.runtime.predict import compute_embeddings_to_host
    from vod_tpu.search import SearchQueries, build_dense_index
    from vod_tpu.search.dense import dense_search

    cfg, backbone = load_hf_encoder(str(snapshot), pooler=VodPoolerConfig(agg_method="mean", output_norm="l2"))
    params = {"params": {"encoder": {"backbone": backbone}}}
    model = Ranker(cfg=cfg, gradients=RetrievalGradients())
    tok = transformers.AutoTokenizer.from_pretrained(str(snapshot))
    q_rows = BeirDatasetLoader("queries")([str(FIXTURE)], split="test")
    sec_rows = BeirDatasetLoader("sections")([str(FIXTURE)], split="test")
    sec_id_to_row = {r["id"]: i for i, r in enumerate(sec_rows)}

    def encode_texts(texts: list) -> np.ndarray:
        enc = tok(texts, padding="max_length", truncation=True, max_length=max_length, return_tensors="np")
        apply = lambda p, i, m: model.apply(p, i, m, method=Ranker.encode_field)  # noqa: E731
        return compute_embeddings_to_host(apply, params, enc["input_ids"].astype(np.int32),
                                          enc["attention_mask"].astype(np.int32), chunk=chunk)

    emb = encode_texts([((r.get("title") or "") + " " + r["content"]).strip() for r in sec_rows])
    q_emb = encode_texts([r["query"] for r in q_rows])
    index = build_dense_index(jnp.asarray(emb), dtype="float32", approx_recall=None)
    got = np.asarray(dense_search(index, SearchQueries(vector=jnp.asarray(q_emb)), top_k=10).indices)
    recalls, ndcgs = [], []
    for i, r in enumerate(q_rows):
        gold = {sec_id_to_row[g] for g in r["retrieval_ids"] if g in sec_id_to_row}
        if not gold:
            continue
        hits = [int(x) in gold for x in got[i]]
        recalls.append(sum(hits) / min(len(gold), 10))
        dcg = sum(h / np.log2(rank + 2) for rank, h in enumerate(hits))
        idcg = sum(1 / np.log2(rank + 2) for rank in range(min(len(gold), 10)))
        ndcgs.append(dcg / idcg)
    return {"n_queries": len(recalls), "n_sections": len(sec_rows),
            "recall_10": round(float(np.mean(recalls)), 4), "ndcg_10": round(float(np.mean(ndcgs)), 4)}


def test_recall_and_ndcg_equal_the_jax_route(hf_home: Path, monkeypatch) -> None:
    snapshot = next((hf_home / "hub" / ("models--" + MODEL.replace("/", "--")) / "snapshots").iterdir())
    want = _jax_route(snapshot, 32, 4)
    monkeypatch.setenv("HF_HOME", str(hf_home))
    got = hub_checkpoint_eval.main(["--model", MODEL, "--beir", str(FIXTURE), "--max_length", "32", "--chunk", "4",
                                    "--device", "cpu"])
    assert list(got) == ["model", "beir", "n_queries", "n_sections", "recall_10", "ndcg_10", "embed_s", "card"]
    assert (got["model"], got["beir"]) == (MODEL, str(FIXTURE))
    for key, value in want.items():
        assert got[key] == value, key
    assert got["n_queries"] > 0 and 0.0 < got["ndcg_10"] <= 1.0
