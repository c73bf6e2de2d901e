"""The import guard: nothing under ``port_bench/`` imports JAX or the JAX
package, the reference imports nothing of the port, and the run's guard
compares top-level names whole."""

import ast
from pathlib import Path

from port_bench.harness import guard

ROOT = Path(__file__).resolve().parents[1]
JAX = {"jax", "jaxlib", "flax", "moss_speech_decoder_cosy_tpu"}
PORT = "moss_speech_decoder_cosy_torch"


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def test_no_module_imports_jax():
    files = sorted(ROOT.rglob("*.py"))
    assert len(files) > 10
    for f in files:
        assert not set(_imports(f)) & JAX, f


def test_reference_imports_nothing_of_the_port():
    files = sorted((ROOT / "reference").rglob("*.py")) + sorted(
        ROOT.glob("tests/*/reference/*.py"))
    assert any("tests" in f.parts for f in files)
    for f in files:
        tops = set(_imports(f))
        assert PORT not in tops and not tops & JAX, f
        assert tops <= {"__future__", "math", "typing", "contextlib",
                        "numpy", "torch", "importlib", "pathlib"}, (f, tops)


def test_guard_compares_whole_top_level_names():
    assert guard.forbidden_loaded([PORT, PORT + ".ops", "numpy"]) == set()
    assert guard.forbidden_loaded(["jax.numpy"]) == {"jax"}
    assert guard.forbidden_loaded(["moss_speech_decoder_cosy_tpu.ops"]) == {
        "moss_speech_decoder_cosy_tpu"}
    assert guard.forbidden_loaded(["jaxtyping", "flaxen"]) == set()
