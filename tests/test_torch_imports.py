"""The port's central rule: `lodestar_tpu_torch/` and `chip_smoke.py`
import no JAX and nothing of the JAX package `lodestar_tpu` (the tests
alone import both).  Every module is parsed with `ast`, so an import
inside a function counts as much as one at the top.
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "lodestar_tpu_torch").rglob("*.py")) + sorted((ROOT / "tools").glob("*.py")) + [
    ROOT / "chip_smoke.py"
]
FORBIDDEN = ("jax", "jaxlib", "lodestar_tpu")


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in FORBIDDEN


def imports_of(path: Path):
    """(line, module) of every absolute import in the file; a relative
    import stays inside the port's package."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module
        elif (
            isinstance(node, ast.Call)
            and getattr(node.func, "attr", getattr(node.func, "id", None)) in ("import_module", "__import__")
            and node.args
            and isinstance(node.args[0], ast.Constant)
            and isinstance(node.args[0].value, str)
        ):
            yield node.lineno, node.args[0].value


def test_the_port_has_modules_to_check():
    assert len(FILES) > 20 and (ROOT / "chip_smoke.py") in FILES


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    bad = [f"{path.relative_to(ROOT)}:{line} imports {mod}" for line, mod in imports_of(path) if _forbidden(mod)]
    assert not bad, "\n".join(bad)


def test_the_guard_catches_each_form(tmp_path):
    src = tmp_path / "m.py"
    src.write_text(
        "import os\nimport jax.numpy as jnp\nfrom lodestar_tpu.crypto import bls\n"
        "from lodestar_tpu_torch.kernels import verify\nfrom . import core\n"
        "def f():\n    import jaxlib\n    return __import__('lodestar_tpu.bls')\n"
    )
    found = sorted(mod for _, mod in imports_of(src) if _forbidden(mod))
    assert found == ["jax.numpy", "jaxlib", "lodestar_tpu.bls", "lodestar_tpu.crypto"]
