"""The port stands alone: no JAX, flax, optax or vod_tpu import anywhere in
`vod_tpu_torch/` or `chip_smoke.py`; its entry points default to the card;
and `chip_smoke.py` fails, printing no result, where there is no card.

The interpreter here imports jax at start-up, so checking `"jax" in
sys.modules` would prove nothing: the subprocess instead blocks the forbidden
packages in `sys.modules` before it imports every module of the port.
"""

import ast
import inspect
import json
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PACKAGE = ROOT / "vod_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "vod_tpu")


def _port_modules() -> list[str]:
    return sorted(
        m.name for m in pkgutil.walk_packages([str(PACKAGE)], prefix="vod_tpu_torch.")
    ) + ["vod_tpu_torch"]


def _sources() -> list[Path]:
    return sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_import_in_source(path: Path) -> None:
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names = [node.module]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path.name}:{node.lineno} imports {name}"


def test_every_module_imports_with_jax_and_vod_tpu_blocked() -> None:
    modules = _port_modules()
    assert {
        "vod_tpu_torch.ops.mips", "vod_tpu_torch.serving", "vod_tpu_torch.models.encoder",
        "vod_tpu_torch.examples.mips_kernel_bench", "vod_tpu_torch.models.seq2seq", "vod_tpu_torch.models.t5_encoder",
        "vod_tpu_torch.runtime.generation", "vod_tpu_torch.examples.seq2seq_realm_bench",
        "vod_tpu_torch.search.ivfpq", "vod_tpu_torch.search.autotune", "vod_tpu_torch.utils.fingerprint",
        "vod_tpu_torch.exps.cli", "vod_tpu_torch.exps.structconf", "vod_tpu_torch.utils.yaml",
        "vod_tpu_torch.utils.template", "vod_tpu_torch.configs.base", "vod_tpu_torch.configs.trainer",
        "vod_tpu_torch.configs.dataloaders", "vod_tpu_torch.configs.datasets", "vod_tpu_torch.configs.support",
        "vod_tpu_torch.data.tokenizer", "vod_tpu_torch.data.corpus", "vod_tpu_torch.data.interface",
        "vod_tpu_torch.data.rosetta.adapters", "vod_tpu_torch.data.loaders.beir",
        "vod_tpu_torch.data.loaders.local_text", "vod_tpu_torch.dataloaders.realm_dataloader",
        "vod_tpu_torch.dataloaders.samplers", "vod_tpu_torch.dataloaders.tokenizer_collate",
        "vod_tpu_torch.models.splade", "vod_tpu_torch.models.cross_encoder", "vod_tpu_torch.search.maxsim",
        "vod_tpu_torch.search.dynamic", "vod_tpu_torch.types.lazy", "vod_tpu_torch.utils.cache",
        "vod_tpu_torch.examples.maxsim_bench", "vod_tpu_torch.examples.predict_and_index",
        "vod_tpu_torch.parallel.distributed", "vod_tpu_torch.parallel.mesh", "vod_tpu_torch.search.sharded",
        "vod_tpu_torch.examples.multiprocess_dryrun", "vod_tpu_torch.data.tokenizer_json",
        "vod_tpu_torch.ops.topk", "vod_tpu_torch.runtime.callbacks", "vod_tpu_torch.utils.pretty",
        "vod_tpu_torch.utils.arguantic", "vod_tpu_torch.utils.exceptions", "vod_tpu_torch.utils.chrono",
        "vod_tpu_torch.utils.validation",
    } <= set(modules)
    code = (
        "import sys, importlib\n"
        f"for name in {FORBIDDEN!r}:\n"
        "    sys.modules[name] = None\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "from vod_tpu_torch.ops import cuda_build\n"
        "assert not cuda_build.libraries, 'importing the port loaded a kernel'\n"
        "print('ok', len(sys.modules))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.startswith("ok")


def test_entry_points_default_to_cuda() -> None:
    from vod_tpu_torch.models import DebugEncoder, VodEncoder
    from vod_tpu_torch.search import build_dense_index
    from vod_tpu_torch.serving import SearchServer

    for fn in (build_dense_index, VodEncoder, DebugEncoder, SearchServer):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    from vod_tpu_torch.examples import mips_kernel_bench, seq2seq_realm_bench

    assert mips_kernel_bench.parser().parse_args([]).device == "cuda"
    assert seq2seq_realm_bench.parser().parse_args([]).device == "cuda"


def test_chip_smoke_fails_without_a_card(tmp_path: Path) -> None:
    """Without CUDA the script exits non-zero and prints no result line; alone
    in a directory (no checkout around it) it fails too."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py would run for real")
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"), (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd is tmp_path:
            script.write_text((ROOT / "chip_smoke.py").read_text())
        out = subprocess.run(
            [sys.executable, str(script)], cwd=cwd, capture_output=True, text=True, timeout=300
        )
        assert out.returncode != 0
        for line in out.stdout.splitlines():
            if line.startswith("{"):
                assert "ok" not in json.loads(line), line


EXAMPLES = ("serving_latency_bench", "serving_codec_bench", "search_flat", "search_hybrid", "search_sparse_bench",
            "serving_batch_bench", "realm_dataloader", "train_periodic", "gradcache_bench", "real_embedding_eval",
            "hub_checkpoint_eval", "pq_codec_sweep", "pq_geometry_sweep", "pq_decode_variants_bench",
            "pq4_adc_variants_bench", "pq4_fastscan_bench", "pq_8m8_bench", "ivfpq_8m_bench", "ivfpq_crossover_bench",
            "real_text_1m_bench", "hybrid_sharded_bench")
TOKENIZER_LIBRARIES = ("regex", "tokenizers", "transformers")


def test_the_walk_reaches_the_example_scripts_and_the_precompiled_reader() -> None:
    modules = set(_port_modules())
    assert {f"vod_tpu_torch.examples.{name}" for name in EXAMPLES} <= modules
    assert {"vod_tpu_torch.data.precompiled", "vod_tpu_torch.data.graphemes", "vod_tpu_torch.examples.synthetic",
            "vod_tpu_torch.examples.toy_text"} <= modules


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_tokenizer_library_import_in_source(path: Path) -> None:
    """The port reads tokenizers and grapheme clusters with its own code: the
    card's machine needs neither `regex` nor `tokenizers` (nor `transformers`)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names = [node.module]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in TOKENIZER_LIBRARIES, f"{path.name}:{node.lineno} imports {name}"


def test_every_module_imports_with_the_tokenizer_libraries_blocked() -> None:
    code = (
        "import sys, importlib\n"
        f"for name in {FORBIDDEN + TOKENIZER_LIBRARIES!r}:\n"
        "    sys.modules[name] = None\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.startswith("ok")


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_scripts_default_to_the_card(name: str) -> None:
    """Every ported script's `--device` defaults to cuda, and asking for the
    card where there is none fails rather than falling back to the CPU."""
    import importlib

    import torch

    module = importlib.import_module(f"vod_tpu_torch.examples.{name}")
    if hasattr(module, "parser"):
        assert module.parser().parse_args([]).device == "cuda"
    elif hasattr(module, "Args"):
        assert module.Args.parse([]).device == "cuda"
    else:
        assert "--device" in inspect.getsource(module.main) and '"cuda"' in inspect.getsource(module.main)
    if not torch.cuda.is_available() and name != "hub_checkpoint_eval":  # that one skips before the device
        with pytest.raises(RuntimeError, match="needs a CUDA card"):
            module.main(["--device", "cuda"])


PORTED_SCRIPTS = sorted(p.stem for p in (PACKAGE / "examples").glob("*.py") if (ROOT / "examples" / p.name).exists())
# JAX-only notions that the port leaves out: `--local_devices` sets the virtual
# CPU devices of each JAX process; the port runs one device per process.
JAX_ONLY_FLAGS = {"multiprocess_dryrun": {"--local_devices"}}


def _declared_flags(path: Path) -> set[str]:
    """The option strings a script declares: its `add_argument` names and, for
    an `Arguantic` class, `--<field>` per annotated field."""
    flags = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "add_argument":
            flags |= {a.value for a in node.args if isinstance(a, ast.Constant) and str(a.value).startswith("-")}
        elif isinstance(node, ast.ClassDef) and any(getattr(b, "id", getattr(b, "attr", None)) == "Arguantic"
                                                     for b in node.bases):
            flags |= {f"--{s.target.id}" for s in node.body if isinstance(s, ast.AnnAssign)}
    return flags


@pytest.mark.parametrize("name", PORTED_SCRIPTS)
def test_example_scripts_take_the_jax_scripts_flags(name: str) -> None:
    """Every flag of a root `examples/` script, spelled as there (argparse does
    not equate `_` and `-`), is one its port's parser accepts."""
    import dataclasses
    import importlib

    module = importlib.import_module(f"vod_tpu_torch.examples.{name}")
    if hasattr(module, "parser"):
        accepted = set(module.parser()._option_string_actions)
    elif hasattr(module, "Args"):
        accepted = {f"--{f.name}" for f in dataclasses.fields(module.Args) if f.init and not f.name.startswith("_")}
    else:
        accepted = _declared_flags(PACKAGE / "examples" / f"{name}.py")
    want = _declared_flags(ROOT / "examples" / f"{name}.py") - JAX_ONLY_FLAGS.get(name, set())
    assert want <= accepted, sorted(want - accepted)
