"""Nothing under portbench/ imports JAX, the JAX package or the script
that drives it on the card; the reference imports nothing of the port.
Names are compared whole: ``repro_torch`` is not ``repro``."""
import ast
import pathlib

import pytest

from portbench.core import env

ROOT = pathlib.Path(__file__).resolve().parent
SOURCES = sorted(p for p in ROOT.rglob("*.py") if "__pycache__" not in p.parts)


def imported_tops(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module:
            out.add(node.module.split(".", 1)[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) \
                in ("import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, str):
            out.add(node.args[0].value.split(".", 1)[0])
    return out


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_no_reference_package(path):
    bad = imported_tops(path) & set(env.FORBIDDEN)
    assert not bad, f"{path.name} imports {sorted(bad)}"


@pytest.mark.parametrize("path", sorted((ROOT / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert "repro_torch" not in imported_tops(path)


def test_guard_compares_whole_top_level_names():
    clean = ["torch", "repro_torch", "repro_torch.models", "jaxtyping",
             "reprox", "flaxen", "chip_smoke_x"]
    assert env.forbidden_loaded(clean) == []
    assert env.forbidden_loaded(clean + ["repro.models", "jax"]) == \
        ["jax", "repro.models"]
    assert env.forbidden_loaded(["jaxlib.xla_client", "flax", "chip_smoke"]) \
        == ["chip_smoke", "flax", "jaxlib.xla_client"]
    assert isinstance(env.forbidden_loaded(), list)     # sys.modules itself


def test_the_guard_catches_an_import(tmp_path):
    p = tmp_path / "probe.py"
    p.write_text("import jax.numpy as jnp\nfrom repro.models import x\n"
                 "import importlib\nimportlib.import_module('chip_smoke')\n"
                 "import repro_torch\n")
    assert imported_tops(p) & set(env.FORBIDDEN) == \
        {"jax", "repro", "chip_smoke"}
