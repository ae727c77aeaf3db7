"""The port stands alone: no module of `repro_torch`, not
`chip_smoke.py`, and not the distributed tests' rank worker imports jax
or any module of the reference package `repro` (checked on the syntax
tree, so lazy imports count too)."""
import ast
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py", ROOT / "tests" / "torch_dp_worker.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch's CPU ops on one intra-op thread for this file (the suite runs
    in several worker processes on a few cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value)


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in FORBIDDEN


def test_port_files_exist():
    names = {p.name for p in PORT_FILES}
    assert {"chip_smoke.py", "qlinear.py", "engine.py", "ops.py"} <= names
    assert len(PORT_FILES) > 20


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_checker_catches_forbidden_imports(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("def f():\n    from repro.core import quantize\n"
                 "    import jax.numpy as jnp\n"
                 "    import importlib\n"
                 "    importlib.import_module('repro.serve')\n")
    assert [m for m in _imported_modules(f) if _forbidden(m)] == \
        ["repro.core", "jax.numpy", "repro.serve"]
    assert not _forbidden("repro_torch.core")
