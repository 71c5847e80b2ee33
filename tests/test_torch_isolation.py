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
