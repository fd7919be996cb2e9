"""What the benchmark may import and read: never JAX or the JAX package
(top-level module names compared whole: the port's name begins with the
JAX package's), the reference nothing of the program, and no file of the
JAX package's TPU benchmark."""

import ast
import re
import subprocess
import sys
from pathlib import Path

import pytest

from harness import manifest

SOURCES = sorted(manifest.BENCH.rglob("*.py"))
FORBIDDEN = {"jax", "jaxlib", "flax", "crucible_tpu"}
TPU_FILES = re.compile(r"bench\.py|BENCH_r|BASELINE\.json|MULTICHIP_r|TPU_GOLDEN_r")


def _imports(path: Path) -> set[str]:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                tops.add(str(node.args[0].value).split(".")[0])
    return tops


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(manifest.BENCH)))
def test_no_jax(path):
    assert not _imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((manifest.BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_stands_alone(path):
    assert not _imports(path) & (FORBIDDEN | {"crucible_tpu_torch", "harness"})


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(manifest.BENCH)))
def test_no_tpu_benchmark_files(path):
    text = path.read_text()
    if path.parent.name == "tests":
        text = text.replace(TPU_FILES.pattern, "")
    assert not TPU_FILES.search(text)


def test_top_level_names_compared_whole():
    """The run's look at ``sys.modules``: the port passes, the JAX package
    and JAX fail, by the whole top-level name."""
    import types

    from harness import core

    fake = {"crucible_tpu_torch_probe.x": [], "crucible_tpu.models": ["crucible_tpu"],
            "jaxlib.xla": ["jaxlib"], "jaxy": []}
    for name, want in fake.items():
        sys.modules[name] = types.ModuleType(name)
        try:
            assert core.forbidden_modules() == want, name
        finally:
            del sys.modules[name]


def test_run_without_a_card_fails():
    """The command exits non-zero and prints no result where torch finds no
    CUDA device (here) — the check is made inside the test."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "rtiow_book1.render",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=manifest.ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "{" not in out.stdout
    assert "no CUDA device" in out.stderr


def test_unknown_cell_fails():
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "no_such.cell",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=manifest.ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""


def test_program_from_the_checkout_only(monkeypatch):
    """A run measures the checkout's program, never an installed copy."""
    import crucible_tpu_torch

    from harness import core

    core.program_in_checkout()
    monkeypatch.setattr(crucible_tpu_torch, "__file__", "/elsewhere/crucible_tpu_torch/__init__.py")
    with pytest.raises(core.RunError):
        core.program_in_checkout()
