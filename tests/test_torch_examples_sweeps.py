"""The ported PQ / IVF-PQ research sweeps end to end on the CPU at toy flags
(`main(argv)` of each `vod_tpu_torch/examples/` script): each row carries
the JAX script's keys in its order plus `card`, every number is finite, and
each recall lies in (0, 1]. `pq_codec_sweep` also runs beside the JAX script
on the same saved embeddings: its `int8-flat` row ranks the same numbers on
both sides, so its recall equals JAX's to the 4 places the JAX script
prints (the PQ rows draw their codebooks from each package's own
generator). The routes themselves are
held to JAX's in `tests/test_torch_examples_pq.py`.
"""

import importlib.util
import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest

from vod_tpu_torch.examples import (
    ivfpq_8m_bench,
    ivfpq_crossover_bench,
    pq4_adc_variants_bench,
    pq4_fastscan_bench,
    pq_8m8_bench,
    pq_codec_sweep,
    pq_decode_variants_bench,
    pq_geometry_sweep,
)

ROOT = Path(__file__).resolve().parent.parent
TIMING = ["--block", "128", "--blocks", "1", "--reps", "1", "--device", "cpu"]
TOY = ["--n", "12000", "--d", "64", "--train", "4096"] + TIMING


def _finite(obj) -> None:
    if isinstance(obj, dict):
        for v in obj.values():
            _finite(v)
    elif isinstance(obj, list):
        for v in obj:
            _finite(v)
    elif isinstance(obj, float):
        assert math.isfinite(obj)


def _rows_have(rows: list[dict], keys: list[str]) -> None:
    _finite(rows)
    for row in rows:
        assert list(row) == keys + ["card"] and row["card"] == "cpu", row
        for k in keys:
            if "recall" in k or "containment" in k:
                assert 0.0 < row[k] <= 1.0, row


def test_pq_decode_variants_bench() -> None:
    rows = pq_decode_variants_bench.main(TOY + ["--m", "16", "--chunks", "8192", "--kmeans_iters", "2"])
    assert [r["variant"] for r in rows] == list(pq_decode_variants_bench.VARIANTS)
    _rows_have(rows, ["variant", "chunk", "n", "recall10", "qps"])


def test_pq4_fastscan_bench() -> None:
    rows = pq4_fastscan_bench.main(["--n", "12000", "--d", "128", "--train", "4096",
                                    "--chunks", "16384", "--pool", "40", "--kmeans_iters", "2"] + TIMING)
    assert [r["variant"] for r in rows] == ["pq64x8-i8", "pq128x4-i8", "pq128x4-g8", "pq128x4-lutmm"]
    _rows_have(rows, ["variant", "chunk", "n", "bytes_per_vec", "adc_recall10", "pool40_containment", "qps"])
    assert rows[1]["adc_recall10"] == rows[2]["adc_recall10"]  # the grouped decode selects the same rows


def test_pq4_adc_variants_bench() -> None:
    rows = pq4_adc_variants_bench.main(["--n", "12000", "--d", "128", "--train", "4096",
                                        "--chunk", "16384", "--pool", "40", "--big", "256"] + TIMING)
    serving = [r for r in rows if r["mode"].startswith("serving")]
    _rows_have(serving, ["variant", "mode", "chunk", "pool_recall10", "ms_per_block", "qps"])
    _rows_have([r for r in rows if r["mode"].startswith("throughput")], ["variant", "mode", "chunk", "qps"])
    assert [r["variant"] for r in rows] == ["prod", "blockdiag", "direct"] * 2 + ["prod", "blockdiag"]
    assert serving[0]["pool_recall10"] == serving[1]["pool_recall10"]  # blockdiag selects prod's rows


def test_pq_geometry_sweep() -> None:
    rows = pq_geometry_sweep.main(TOY + ["--m_list", "8,16", "--k_factors", "16", "--refine_dim", "32",
                                         "--kmeans_iters", "2"])
    assert [(r["dsub"], r["bytes_per_vec"]) for r in rows] == [(8, 40), (4, 48)]
    _rows_have(rows, ["codec", "dsub", "n", "bytes_per_vec", "k_factor", "recall10", "qps", "build_s"])


@pytest.mark.parametrize("bits", ["8", "4"])
def test_pq_8m8_bench(bits: str) -> None:
    rows = pq_8m8_bench.main(TOY + ["--m", "16", "--refine_dim", "32", "--code_bits", bits, "--kmeans_iters", "2"])
    proto = [r for r in rows if "onehot" in r["codec"] or "dual" in r["codec"]]
    assert len(proto) == (3 if bits == "8" else 0)
    _rows_have(proto, ["codec", "n", "bytes_per_vec", "recall10", "qps"])
    _rows_have([r for r in rows if r["codec"].endswith(("exh", "ref8", "ref"))],
               ["codec", "n", "bytes_per_vec", "hbm_gb", "recall10", "qps", "build_s", "k_factor"])
    _rows_have(rows[-1:], ["codec", "n", "bytes_per_vec", "hbm_gb", "recall10", "qps", "build_s"])


@pytest.mark.parametrize("spill", [False, True])
def test_ivfpq_8m_bench(spill: bool) -> None:
    rows = ivfpq_8m_bench.main(TOY + ["--c", "64", "--window", "64", "--refine_dim", "32", "--nprobes", "4,16",
                                      "--kmeans_iters", "2"] + (["--spill"] if spill else []))
    assert [r["nprobe"] for r in rows] == [4, 16]
    _rows_have(rows, ["nprobe", "max_windows", "scan_frac", "recall10", "serving_ms_per_64", "serving_qps",
                      "throughput_qps"])


def test_ivfpq_crossover_bench() -> None:
    out = ivfpq_crossover_bench.main(["--n", "12000", "--c", "64", "--train", "4096",
                                      "--nprobes", "4,16", "--batches", "1,8", "--blocks", "1", "--reps", "1",
                                      "--http_requests", "2", "--device", "cpu"])
    assert list(out)[:3] == ["n", "points", "verdict"] and list(out)[-1] == "card"
    assert [p["engine"] for p in out["points"]] == ["serving-direct", "ivfpq-soar-np4", "ivfpq-soar-np16"]
    _finite(out)
    for p in out["points"]:
        assert list(p) == ["engine", "recall10", "ms_b1", "ms_b8"] and 0 < p["recall10"] <= 1
    assert "http_serving-direct" in out and len([k for k in out if k.startswith("http_")]) == 2


def _jax_script(name: str):
    spec = importlib.util.spec_from_file_location(f"jax_example_{name}", ROOT / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_pq_codec_sweep_equals_the_jax_scripts_int8_row(tmp_path: Path, monkeypatch, capsys) -> None:
    rng = np.random.default_rng(0)
    emb = rng.normal(size=(2000, 64)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    np.save(tmp_path / "emb.npy", emb)
    np.save(tmp_path / "emb_queries.npy", emb[:64] + 0.2 * rng.normal(size=(64, 64)).astype(np.float32))
    rows = pq_codec_sweep.main(["--emb", str(tmp_path / "emb.npy"), "--q", "64", "--reps", "1", "--device", "cpu",
                                "--configs", "int8-flat,d64", "--aniso"])
    assert [r["name"] for r in rows] == ["int8-flat", "pq64-exh+ref32-d64", "pq64-exh+ref32-d64+aniso"]
    _rows_have(rows, ["name", "bytes_per_vec", "recall10", "qps", "build_s"])
    monkeypatch.setattr(sys, "argv", ["pq_codec_sweep.py", "--emb", str(tmp_path / "emb.npy"), "--q", "64",
                                      "--configs", "int8-flat"])
    capsys.readouterr()
    _jax_script("pq_codec_sweep").main()
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert [r["name"] for r in want] == ["int8-flat"]
    assert rows[0]["recall10"] == pytest.approx(want[0]["recall10"], abs=5e-5)  # JAX rounds to 4 places
    assert rows[0]["bytes_per_vec"] == want[0]["bytes_per_vec"]
