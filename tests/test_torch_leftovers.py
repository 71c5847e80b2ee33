"""The last modules of the port's item-7 list against the JAX package's:
`ops/topk.py:block_topk`, `ops/pq.py:dequantize_scale`,
`runtime/callbacks.py` (`ExportModule`, `load_export`, `PprintBatch`), and
`utils/{pretty,arguantic,exceptions,chrono,validation}.py`.

`block_topk` runs `tests/test_topk.py`'s cases and rows full of ties: the
values equal JAX's exactly, and so do the ids, since both select the lowest
index first among equal values. The printers' plain-text output (`rich`
off on both sides) equals JAX's character for character on the same batch.
"""

import dataclasses
import io
import json
import contextlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_gradcache import _task
from tests.test_torch_train import _to_torch_batch
from tests.torch_helpers import CPU, np_of


@pytest.mark.parametrize("shape,k,block", [((4, 5000), 1, 512), ((4, 5000), 10, 512), ((4, 5000), 100, 512),
                                           ((1, 5), 3, 2), ((3, 700), 20, 1024), ((2, 4097), 64, 256)])
def test_block_topk_equals_jax(shape: tuple, k: int, block: int) -> None:
    from vod_tpu.ops.topk import block_topk as jax_block_topk
    from vod_tpu_torch.ops.topk import block_topk

    rng = np.random.default_rng(0)
    x = rng.normal(size=shape).astype(np.float32)
    if shape == (1, 5):  # `tests/test_topk.py`'s padding and -inf case
        x = np.asarray([[1.0, -np.inf, 3.0, 2.0, -np.inf]], np.float32)
    for data in (x, np.round(x * 2) / 2):  # the second has ties everywhere
        js, ji = jax_block_topk(jnp.asarray(data), k, block=block)
        ts, ti = block_topk(torch.from_numpy(data), k, block=block)
        np.testing.assert_array_equal(np_of(ts), np.asarray(js))
        np.testing.assert_array_equal(np_of(ti), np.asarray(ji))


def test_dequantize_scale_is_jax_s() -> None:
    from vod_tpu.ops.pq import dequantize_scale as jax_dequantize
    from vod_tpu.ops.pq import quantize_int8 as jax_quantize
    from vod_tpu_torch.ops.pq import dequantize_scale, quantize_int8

    x = np.random.default_rng(1).normal(size=(16, 8)).astype(np.float32)
    _, scale = quantize_int8(torch.from_numpy(x))
    want = jax_dequantize(jax_quantize(jnp.asarray(x))[1])
    np.testing.assert_array_equal(np_of(dequantize_scale(scale)), np.asarray(want))


def _plain(module, fn, *args, **kw) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        old = module._console
        module._console = lambda: None
        try:
            fn(*args, **kw)
        finally:
            module._console = old
    return buf.getvalue()


def test_pprint_batch_and_metrics_print_what_jax_prints() -> None:
    from vod_tpu.runtime.callbacks import PprintBatch as JaxPprintBatch
    from vod_tpu.utils import pretty as jax_pretty
    from vod_tpu_torch.runtime.callbacks import PprintBatch
    from vod_tpu_torch.utils import pretty

    _, _, jbatch = _task(b=4)
    batch = _to_torch_batch(jbatch)
    batch.section__score[0, 1] = float("-inf")
    jbatch = dataclasses.replace(jbatch, section__score=jnp.asarray(np_of(batch.section__score)))
    for stats in (True, False):
        want = _plain(jax_pretty, jax_pretty.pprint_batch, jbatch, header="first", stats=stats)
        assert _plain(pretty, pretty.pprint_batch, batch, header="first", stats=stats) == want
        assert ("(1 non-finite)" in want) == stats  # the -inf score, counted
    metrics = {"mrr": 0.25, "ndcg_10": np.float32(0.5), "note": "x"}
    assert _plain(pretty, pretty.pprint_metrics, metrics) == _plain(jax_pretty, jax_pretty.pprint_metrics, metrics)
    seen = []
    cb = PprintBatch(printer=seen.append)
    cb.on_train_batch_start(batch=batch)
    cb.on_train_batch_start(batch=batch)
    assert seen == [batch]
    want = _plain(jax_pretty, lambda: JaxPprintBatch().on_train_batch_start(batch=jbatch))
    assert _plain(pretty, lambda: PprintBatch().on_train_batch_start(batch=batch)) == want
    assert pretty.human_format_nb(1234567) == jax_pretty.human_format_nb(1234567) == "1.23M"
    assert pretty.human_format_bytes(3 << 20) == jax_pretty.human_format_bytes(3 << 20)
    assert pretty.repr_array(torch.zeros(2, 3, dtype=torch.int32)) == "Tensor[2, 3] int32 @cpu"


def test_pprint_params_counts_each_submodule() -> None:
    from vod_tpu_torch.utils import pretty

    model = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.Linear(4, 2))
    out = _plain(pretty, pretty.pprint_params, model)
    assert pretty.pprint_params(model) == {"0": 16, "1": 10}
    assert out.splitlines()[-1].split() == ["TOTAL", "26"]


@pytest.mark.parametrize("scheme", ["path", "file"])
def test_export_round_trip(scheme: str, tmp_path: Path) -> None:
    from tests.test_torch_tokenizer import _fixture_vocab
    from vod_tpu_torch.data.tokenizer import WordPieceTokenizer, load_tokenizer
    from vod_tpu_torch.exps.structconf import ModelConfig
    from vod_tpu_torch.runtime.callbacks import ExportModule, load_export

    model = torch.nn.ModuleDict({"encoder": torch.nn.Linear(4, 3), "head": torch.nn.Linear(3, 2)}).to(CPU)
    tok = WordPieceTokenizer(_fixture_vocab())
    dest = tmp_path / "remote"
    url = str(dest) if scheme == "path" else dest.as_uri()
    export = ExportModule(tmp_path / "export", submodules=["encoder"], upload_to=url)
    export.on_fit_end(model=model, tokenizer=tok, config=ModelConfig(hidden_size=16))
    for root in (tmp_path / "export", dest / "export"):
        state = load_export(root)
        assert set(state) == {"encoder.weight", "encoder.bias"}
        assert torch.equal(state["encoder.weight"], model["encoder"].weight.detach())
        assert load_tokenizer(root / "tokenizer")("Paris")["input_ids"] == tok("Paris")["input_ids"]
        assert json.loads((root / "config.json").read_text())["hidden_size"] == 16
    other = torch.nn.ModuleDict({"encoder": torch.nn.Linear(4, 3), "head": torch.nn.Linear(3, 2)})
    assert load_export(tmp_path / "export", other) is other
    assert torch.equal(other["encoder"].bias, model["encoder"].bias.detach())
    with pytest.raises(ValueError, match="lacks"):
        load_export(tmp_path / "export", torch.nn.ModuleDict({"head": torch.nn.Linear(3, 2)}))


def test_export_to_another_scheme_needs_fsspec(tmp_path: Path, monkeypatch) -> None:
    import sys

    from vod_tpu_torch.runtime.callbacks import ExportModule

    export = ExportModule(tmp_path / "export")
    export.on_fit_end(params={"w": torch.ones(2)})
    monkeypatch.setitem(sys.modules, "fsspec", None)
    with pytest.raises(ValueError, match="gs:// URL needs fsspec"):
        export.upload("gs://bucket/path")


def test_arguantic_parses_as_jax_s() -> None:
    import typing as typ

    from vod_tpu.utils import Arguantic as JaxArguantic
    from vod_tpu_torch.utils import Arguantic

    class JaxArgs(JaxArguantic):
        """Toy args."""

        k: int = 10
        scale: float = 0.5
        name: str = "flat"
        on: bool = False
        limit: typ.Optional[int] = None

    class Args(Arguantic):
        """Toy args."""

        k: int = 10
        scale: float = 0.5
        name: str = "flat"
        on: bool = False
        limit: typ.Optional[int] = None

    for argv in ([], ["--k", "3", "--on", "yes", "--limit", "7", "--scale", "1e-2", "--name", "ivf"], ["--on", "0"]):
        assert dataclasses.asdict(Args.parse(argv)) == JaxArgs.parse(argv).model_dump()
    with pytest.raises(SystemExit):
        Args.parse(["--k", "three"])
    with pytest.raises(ValueError):
        Args.parse(["--limit", "seven"])


def test_chrono_block_timer_and_exception_dumps(tmp_path: Path) -> None:
    from vod_tpu_torch.utils.chrono import BlockTimer, Chrono
    from vod_tpu_torch.utils.exceptions import dump_exceptions_to_file

    c = Chrono(window=2)
    assert np.isnan(c.get_avg_lap_time())
    for _ in range(3):
        c.start()
        c.stop()
    assert len(c._laps) == 2 and c.get_avg_laps_per_second() > 0
    diag: dict = {}
    with BlockTimer("search_time", diag):
        pass
    assert diag["search_time"] >= 0.0

    @dump_exceptions_to_file
    def ok(x):
        return x + 1

    def boom(x, y=2):
        raise RuntimeError("nope")

    assert ok(1) == 2
    with pytest.raises(RuntimeError, match="nope"):
        dump_exceptions_to_file(boom, directory=tmp_path / "exc")(1, y=3)
    (dump,) = (tmp_path / "exc").iterdir()
    text = dump.read_text()
    assert dump.name.startswith("test_chrono_block_timer_and_exception_dumps.<locals>.boom-")
    assert "RuntimeError('nope')" in text and "args: (1,)" in text and "'y': 3" in text


def test_check_array_and_realm_batch_errors_match_jax() -> None:
    from vod_tpu.utils.validation import ShapeError as JaxShapeError
    from vod_tpu.utils.validation import check_array as jax_check_array
    from vod_tpu.utils.validation import check_realm_batch as jax_check_batch
    from vod_tpu_torch.utils.validation import ShapeError, check_array, check_realm_batch

    x = np.zeros((2, 3), np.int32)
    cases = [dict(shape=("B", "D")), dict(shape=(2, None), dtype="int32"), dict(shape=(3, 3)), dict(dtype="float32"),
             dict(shape=("B",)), dict(shape=("B", "B"))]
    for kw in cases:
        try:
            want = jax_check_array(jnp.asarray(x), name="x", **kw)
        except JaxShapeError as exc:
            with pytest.raises(ShapeError, match=str(exc).replace("(", r"\(").replace(")", r"\)")):
                check_array(torch.from_numpy(x), name="x", **kw)
        else:
            assert check_array(torch.from_numpy(x), name="x", **kw) == want
    _, _, jbatch = _task(b=4)
    assert check_realm_batch(_to_torch_batch(jbatch)) == jax_check_batch(jbatch)
    cut = dataclasses.replace(jbatch, section__input_ids=jbatch.section__input_ids[:-1])
    with pytest.raises(JaxShapeError) as want:
        jax_check_batch(cut)
    with pytest.raises(ShapeError) as got:
        check_realm_batch(_to_torch_batch(cut))
    assert str(got.value) == str(want.value)
