"""The PyTorch port imports neither JAX nor the JAX package.

Every ``.py`` file under ``poly_commit_tpu_torch/`` (the entry point
``demo.py`` included) and ``chip_smoke.py`` is
parsed with ``ast``; an ``import`` or ``from ... import`` of ``jax``,
``jaxlib`` or ``poly_commit_tpu`` (the package itself or any module of it,
but not ``poly_commit_tpu_torch``) fails its case. Relative imports stay
inside the port. The file list is sorted, so every test worker collects the
same cases.
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "poly_commit_tpu")
FILES = sorted(p.relative_to(ROOT).as_posix()
               for p in (ROOT / "poly_commit_tpu_torch").rglob("*.py")) + ["chip_smoke.py"]


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


def imports_of(source: str) -> list:
    """The absolute module names a source imports, at any depth of its code."""
    names = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.append(node.module)
    return names


def test_the_guard_tells_the_packages_apart():
    src = ("import jax.numpy as jnp\nfrom jaxlib import xla_client\n"
           "from poly_commit_tpu.core import field\nimport poly_commit_tpu_torch.core.ff\n"
           "from . import ff\ndef f():\n    import poly_commit_tpu\n")
    bad = [n for n in imports_of(src) if _forbidden(n)]
    assert bad == ["jax.numpy", "jaxlib", "poly_commit_tpu.core", "poly_commit_tpu"]


@pytest.mark.parametrize("path", FILES)
def test_port_file_imports_no_jax(path):
    bad = [n for n in imports_of((ROOT / path).read_text()) if _forbidden(n)]
    assert not bad, f"{path} imports {bad}"


def test_the_entry_point_is_checked():
    """The port's entry point, run as python -m poly_commit_tpu_torch.demo,
    is among the parsed files."""
    assert "poly_commit_tpu_torch/demo.py" in FILES
