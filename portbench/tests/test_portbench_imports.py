"""No module of the benchmark imports JAX or the JAX package, comparing
each import's top-level name whole (``fastconsensus_tpu_torch`` is the
port, ``fastconsensus_tpu`` the JAX package); the plain reference imports
nothing of the port."""

import ast
from pathlib import Path

import pytest

from conftest import ROOT

PB = ROOT / "portbench"
JAX = {"jax", "jaxlib", "flax", "fastconsensus_tpu"}


def imported_tops(path: Path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and \
                node.module:
            yield node.module.split(".")[0]


def modules(under: Path):
    return sorted(p for p in under.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", modules(PB), ids=lambda p: p.name)
def test_no_jax(path):
    assert not set(imported_tops(path)) & JAX


@pytest.mark.parametrize("path", modules(PB / "reference"),
                         ids=lambda p: p.name)
def test_reference_is_independent_of_the_port(path):
    tops = set(imported_tops(path))
    assert "fastconsensus_tpu_torch" not in tops
    assert "fastconsensus_tpu" not in tops
    # only the reference's own modules of the benchmark
    text = path.read_text()
    for line in text.splitlines():
        if line.startswith(("from portbench", "import portbench")):
            assert line.startswith("from portbench.reference")


def test_top_level_names_are_compared_whole(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import fastconsensus_tpu_torch.engine\n"
                 "from fastconsensus_tpu.ops import x\n")
    assert list(imported_tops(f)) == ["fastconsensus_tpu_torch",
                                      "fastconsensus_tpu"]
    from portbench import harness

    assert "fastconsensus_tpu_torch" not in harness.FORBIDDEN
    assert "fastconsensus_tpu" in harness.FORBIDDEN
