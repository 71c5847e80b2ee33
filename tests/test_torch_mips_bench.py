"""The port's kernel shootout (`vod_tpu_torch.examples.mips_kernel_bench`) as a
whole, on the CPU, against the same routes of the JAX package.

The JAX script itself cannot run here (it calls Pallas without `interpret`),
so this test rebuilds its data from the same numpy seeds and runs its routes:
exact `dense_search` for ground truth, the scan, and `fused_mips_binned` and
`fused_mips_topk` in interpret mode. Each recall of the port must equal the
one computed from JAX: both rank the same bf16 data by f32 sums, and at this
size no two top-10 scores lie within the ~1e-6 that two sum orders can differ.
"""

import jax
import jax.numpy as jnp
import numpy as np

from vod_tpu.ops.mips_pallas import fused_mips_binned, fused_mips_topk
from vod_tpu.search import SearchQueries, build_dense_index
from vod_tpu.search.dense import dense_search
from vod_tpu_torch.examples import mips_kernel_bench

N, D, BLK, K = 4096, 32, 64, 10
JAX_KEYS = ["n", "d", "blk", "nblocks", "k", "scan_qps", "scan_recall", "binned_qps", "binned_recall",
            "exact_kernel_qps", "exact_kernel_recall"]


def _jax_recalls() -> dict:
    """`examples/mips_kernel_bench.py`'s data and recalls at the test's flags."""
    rng = np.random.default_rng(0)
    corpus_np = rng.standard_normal(size=(N, D), dtype=np.float32)
    corpus_np /= np.linalg.norm(corpus_np, axis=-1, keepdims=True)
    corpus = jnp.asarray(corpus_np, dtype=jnp.bfloat16)
    r = np.random.default_rng(99)  # qblocks(99, 1)
    q = corpus_np[r.integers(0, N, size=BLK)]
    q = q + 0.05 * r.standard_normal((BLK, D), dtype=np.float32)
    q_eval = jnp.asarray((q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32), dtype=jnp.bfloat16)

    search = jax.jit(lambda ix, qq: dense_search(ix, SearchQueries(vector=qq), top_k=K).indices)
    gt = np.asarray(search(build_dense_index(corpus, dtype="bfloat16", approx_recall=None), q_eval))

    def recall(ids) -> float:
        ids = np.asarray(ids)
        return float(np.mean([len(set(ids[i]) & set(gt[i])) / K for i in range(BLK)]))

    return {
        "scan_recall": recall(search(build_dense_index(corpus, dtype="bfloat16"), q_eval)),
        "binned_recall": recall(fused_mips_binned(corpus, q_eval, k=K, n_real=N, interpret=True)[1]),
        "exact_kernel_recall": recall(fused_mips_topk(corpus, q_eval, k=K, qblock=256, n_real=N, interpret=True)[1]),
    }


def test_shootout_matches_the_jax_routes() -> None:
    out = mips_kernel_bench.main(
        ["--n", str(N), "--d", str(D), "--blk", str(BLK), "--nblocks", "2", "--k", str(K),
         "--device", "cpu", "--reps", "1"]
    )
    assert list(out) == JAX_KEYS + ["card"]
    assert out["card"] == "cpu"
    assert all(out[key] > 0 for key in ("scan_qps", "binned_qps", "exact_kernel_qps"))
    expected = _jax_recalls()
    for key, value in expected.items():
        assert out[key] == value, (key, out[key], value)
    assert out["exact_kernel_recall"] == 1.0 and out["binned_recall"] < 1.0


def test_skip_exact_kernel_drops_its_keys() -> None:
    out = mips_kernel_bench.main(
        ["--n", "2048", "--d", "16", "--blk", "32", "--nblocks", "1", "--device", "cpu", "--reps", "1",
         "--skip-exact-kernel"]
    )
    assert list(out) == JAX_KEYS[:-2] + ["card"]
