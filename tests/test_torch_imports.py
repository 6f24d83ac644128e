"""The port stands alone: no module of ``tpu_kubernetes_torch`` and none of
``chip_smoke.py``, ``mutation_check.py``, ``decode_attention_ab.py``,
``decode_attention_trace.py`` and ``ops_ab.py`` imports JAX, Flax, Optax,
Orbax or anything of the JAX package ``tpu_kubernetes``. Names are matched
exactly, module by module, because ``tpu_kubernetes_torch`` starts with
the JAX package's name."""

import ast
import importlib
import pkgutil
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "tpu_kubernetes"}
SOURCES = sorted((ROOT / "tpu_kubernetes_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "mutation_check.py",
    ROOT / "decode_attention_ab.py", ROOT / "decode_attention_trace.py",
    ROOT / "ops_ab.py",
]


def _imported(tree: ast.AST):
    """Every module name an import statement of ``tree`` names."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_and_no_jax_package_imports(path):
    bad = [n for n in _imported(ast.parse(path.read_text(), str(path)))
           if _forbidden(n)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_matching_is_exact():
    assert _forbidden("tpu_kubernetes")
    assert _forbidden("tpu_kubernetes.ops.norms")
    assert _forbidden("jax.numpy") and _forbidden("jaxlib")
    assert not _forbidden("tpu_kubernetes_torch.ops")
    assert not _forbidden("jaxtyping_like_name")
    found = list(_imported(ast.parse(
        "import tpu_kubernetes_torch\nfrom tpu_kubernetes import ops\n"
        "importlib.import_module('jax')\n")))
    assert found == ["tpu_kubernetes_torch", "tpu_kubernetes", "jax"]


def test_every_module_imports_without_a_card_or_compiler():
    """Importing builds nothing: the kernels are compiled at first use."""
    import tpu_kubernetes_torch

    names = [m.name for m in pkgutil.walk_packages(
        tpu_kubernetes_torch.__path__, "tpu_kubernetes_torch.")]
    assert "tpu_kubernetes_torch.ops.flash_attention" in names
    for name in names:
        importlib.import_module(name)
