"""Nothing under benchmark/ imports JAX or the JAX package, and nothing reads
the JAX package's benchmark files; the reference imports nothing of the
program."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FILES = sorted(BENCH.rglob("*.py"))
RUN_FILES = [p for p in FILES if "tests" not in p.relative_to(BENCH).parts]


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=[str(p.relative_to(BENCH)) for p in FILES])
def test_no_jax_module(path):
    found = top_level_imports(path) & {"jax", "jaxlib", "flax", "tpufem"}
    assert not found, f"{path} imports {found}"


@pytest.mark.parametrize("path", RUN_FILES, ids=[str(p.relative_to(BENCH)) for p in RUN_FILES])
def test_no_jax_benchmark_files(path):
    strings = [n.value for n in ast.walk(ast.parse(path.read_text()))
               if isinstance(n, ast.Constant) and isinstance(n.value, str)]
    for s in strings:
        assert "bench.py" not in s and "BENCH_" not in s and "scripts/" not in s, (path, s)


def test_whole_names_compared():
    # the port's name begins with the JAX package's: it passes, `tpufem` does not
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        p = Path(d) / "m.py"
        p.write_text("import tpufem_torch.fem\nfrom tpufem_torch import device\n")
        assert top_level_imports(p) == {"tpufem_torch"}
        p.write_text("import tpufem.fem\n")
        assert top_level_imports(p) == {"tpufem"}


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_is_independent(path):
    assert "tpufem_torch" not in top_level_imports(path)
