"""The ports of `examples/gradcache_bench.py` and
`examples/real_embedding_eval.py` against the JAX package on the CPU.

For each the JAX route is rebuilt from `vod_tpu` functions at toy widths in
f32 (the scripts' own configs otherwise), JAX's initial parameters are
carried into the port (`models/convert.py:system_flax_to_state_dict`), and
the first loss is held within 1e-5 (relative) of JAX's: `gradcache_bench`'s
GradCache step with in-batch negatives, JAX's sampler draws fed to the port;
`real_embedding_eval`'s contrastive loss on its first pair batch. Each
script's `main` then runs at toy flags: its keys, and finite numbers.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.test_torch_sample import jax_labeled_noise
from vod_tpu_torch.data.loaders import local_text
from vod_tpu_torch.examples import gradcache_bench, real_embedding_eval
from vod_tpu_torch.models import Ranker, RetrievalGradients, system_flax_to_state_dict
from vod_tpu_torch.runtime import DeviceCorpus
from vod_tpu_torch.search import HybridEngines, build_dense_index

CPU = torch.device("cpu")
RTOL = 1e-5


def _finite(obj) -> None:
    if isinstance(obj, dict):
        for v in obj.values():
            _finite(v)
    elif isinstance(obj, list):
        for v in obj:
            _finite(v)
    elif isinstance(obj, float):
        assert math.isfinite(obj)


def _gradcache_args(*extra: str):
    return gradcache_bench.parser().parse_args(
        ["--b", "4", "--n_sections", "2", "--chunk", "4", "--ls", "8", "--n_corpus", "64", "--vocab", "64",
         "--hidden", "32", "--layers", "1", "--heads", "2", "--inter", "64", "--dtype", "float32", "--device", "cpu",
         *extra])


def test_gradcache_bench_first_loss_equals_jax() -> None:
    from vod_tpu.models import Ranker as JaxRanker
    from vod_tpu.models import RetrievalGradients as JaxRetrievalGradients
    from vod_tpu.models import TransformerEncoderConfig as JaxEncoderConfig
    from vod_tpu.models import VodPoolerConfig as JaxPoolerConfig
    from vod_tpu.runtime import DeviceCorpus as JaxCorpus
    from vod_tpu.runtime import QueryBatch as JaxQueryBatch
    from vod_tpu.runtime import device_collate as jax_collate
    from vod_tpu.runtime.train import make_train_step as jax_make_train_step
    from vod_tpu.search import HybridEngines as JaxEngines
    from vod_tpu.search import build_dense_index as jax_build

    args = _gradcache_args()
    data = gradcache_bench.make_data(args)
    cfg = JaxEncoderConfig(vocab_size=args.vocab, hidden_size=args.hidden, num_layers=args.layers,
                           num_heads=args.heads, intermediate_size=args.inter, dtype=jnp.float32,
                           pooler=JaxPoolerConfig(agg_method="mean", output_norm="l2", scaler=20.0))
    jmodel = JaxRanker(cfg=cfg, gradients=JaxRetrievalGradients())
    ids = jnp.asarray(data["corpus_ids"])
    jcorpus = JaxCorpus(input_ids=ids, attention_mask=jnp.ones_like(ids))
    jeng = JaxEngines(dense=jax_build(jnp.asarray(data["emb"]), dtype="bfloat16"))

    def jqb(seed: int, b: int = args.b) -> JaxQueryBatch:
        a = gradcache_bench.query_arrays(seed, args)
        return JaxQueryBatch(input_ids=jnp.asarray(a["input_ids"][:b]), attention_mask=jnp.ones((b, 32), "int32"),
                             section_ids=jnp.asarray(a["section_ids"][:b]))

    b0, _ = jax.jit(lambda k, qv: jax_collate(k, jeng, jcorpus, jqb(5, 2), query_vectors=qv, prefetch=16,
                                              n_sections=args.n_sections, max_pos_sections=2,
                                              in_batch_negatives=True))(jax.random.PRNGKey(0), jeng.dense.vectors[:2])
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(1), b0, mode="evaluate"))
    tx = optax.adafactor(1e-5)
    jstep = jax_make_train_step(jmodel, tx, prefetch=16, n_sections=args.n_sections, max_pos_sections=2,
                                gradient_clip_val=1.0, in_batch_negatives=True, gradcache_chunk_rows=args.chunk)
    key = jax.random.PRNGKey(2)
    _, _, jm, _, _ = jstep.train_step(jax.tree.map(jnp.copy, params), tx.init(params), jeng, jcorpus, jqb(1), key, {})

    model = Ranker(gradcache_bench.encoder_config(args), RetrievalGradients(), device=CPU)
    model.load_state_dict(system_flax_to_state_dict(params))
    t_ids = torch.from_numpy(data["corpus_ids"])
    engines = HybridEngines(dense=build_dense_index(data["emb"], dtype="bfloat16", device=CPU))
    step = gradcache_bench.train_step_fn(model, args, args.chunk)
    tm, _, _ = step.train_step(engines, DeviceCorpus(input_ids=t_ids, attention_mask=torch.ones_like(t_ids)),
                               gradcache_bench.to_query_batch(gradcache_bench.query_arrays(1, args), CPU),
                               torch.Generator().manual_seed(0), {},
                               noise=jax_labeled_noise(jax.random.split(key)[0], args.b, 16))
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=RTOL)


def test_gradcache_bench_main_at_toy_flags() -> None:
    out = gradcache_bench.main(["--b", "4", "--n_sections", "2", "--chunk", "4", "--ls", "8", "--n_corpus", "64",
                                "--vocab", "64", "--hidden", "32", "--layers", "1", "--heads", "2", "--inter", "64",
                                "--device", "cpu", "--also_monolithic"])
    assert list(out) == ["params_m", "rows", "configs", "card"] and out["rows"] == 12
    assert [c["name"] for c in out["configs"]] == ["gradcache", "monolithic"]
    for c in out["configs"]:
        assert {"loss0", "loss1", "step_s", "first_s"} <= set(c)
    _finite(out)


def test_real_embedding_eval_first_loss_equals_jax() -> None:
    from vod_tpu.models import Ranker as JaxRanker
    from vod_tpu.models import RetrievalGradients as JaxRetrievalGradients
    from vod_tpu.models import TransformerEncoderConfig as JaxEncoderConfig
    from vod_tpu.models import VodPoolerConfig as JaxPoolerConfig

    args = real_embedding_eval.parser().parse_args(["--max_len", "16", "--dim", "64", "--dtype", "float32"])
    passages = local_text.harvest_text_passages(200, passage_words=args.max_len)
    vocab = local_text.build_word_vocab(passages, vocab_size=real_embedding_eval.VOCAB)
    ids, mask = local_text.encode_passages(passages, vocab, max_length=args.max_len)
    cfg = JaxEncoderConfig(vocab_size=real_embedding_eval.VOCAB, hidden_size=256, num_layers=4, num_heads=4,
                           intermediate_size=512, max_position_embeddings=args.max_len, dtype=jnp.float32,
                           pooler=JaxPoolerConfig(agg_method="mean", projection_size=args.dim, output_norm="l2",
                                                  scaler=10.0, learn_scaler=True))
    jmodel = JaxRanker(cfg=cfg, gradients=JaxRetrievalGradients())
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(0), jnp.asarray(ids[:2]), jnp.asarray(mask[:2]),
                                        method=JaxRanker.encode_field))
    qi, qm, si, sm = real_embedding_eval.make_pair_batch(1000, 16, ids, mask)

    def loss_fn(p):
        qe = jmodel.apply(p, jnp.asarray(qi), jnp.asarray(qm), method=JaxRanker.encode_field)
        se = jmodel.apply(p, jnp.asarray(si), jnp.asarray(sm), method=JaxRanker.encode_field)
        return optax.softmax_cross_entropy_with_integer_labels(qe @ se.T, jnp.arange(16)).mean()

    model = Ranker(real_embedding_eval.encoder_config(args), RetrievalGradients(), device=CPU)
    model.load_state_dict(system_flax_to_state_dict(params))
    got = real_embedding_eval.contrastive_loss(model, *(torch.from_numpy(a) for a in (qi, qm, si, sm)))
    assert float(got.detach()) == pytest.approx(float(jax.jit(loss_fn)(params)), rel=RTOL)


def test_real_embedding_eval_main_at_toy_flags(tmp_path) -> None:
    out = real_embedding_eval.main(["--n", "600", "--steps", "2", "--batch", "16", "--q", "64", "--dim", "128",
                                    "--max_len", "16", "--n_candidates", "256", "--reps", "1", "--device", "cpu",
                                    "--out", str(tmp_path / "emb.npy")])
    head = ["n", "dim", "self_hit10", "train_s", "embed_s", "top16_variance_share", "top32_variance_share",
            "top64_variance_share", "top128_variance_share", "bf16_recall10", "bf16_qps", "int8_recall10", "int8_qps",
            "pq_build_s", "pq_recall10", "pq_qps", "pq_bytes_per_vec"]
    assert list(out)[: len(head)] == head and list(out)[-1] == "card"
    assert len(out) == len(head) + 9 * 3 + 1  # the ladder's recall, QPS and bytes, then the card
    assert np.load(tmp_path / "emb.npy").shape == (600, 128)
    assert np.load(tmp_path / "emb_queries.npy").shape == (64, 128)
    _finite(out)
    assert out["bf16_recall10"] > 0.9 and out["int8_recall10"] > 0.9
