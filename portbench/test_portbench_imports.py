"""No module of the benchmark imports JAX or the JAX package (top-level
names compared whole: ``repro_torch`` begins with ``repro``), and the
reference imports nothing of the port."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "portbench").rglob("*.py"))


def imported(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module:
            yield node.module


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro(path):
    bad = [n for n in imported(path)
           if n.split(".")[0] in ("jax", "jaxlib", "flax", "repro")]
    assert not bad, f"{path}: imports {bad}"


def test_reference_imports_nothing_of_the_port():
    for path in (ROOT / "portbench" / "reference").rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom):
                assert node.level <= 1, path      # within reference/ only
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                names = [a.name for a in node.names] \
                    if isinstance(node, ast.Import) else [node.module or ""]
                for n in names:
                    assert not n.startswith("repro_torch"), path
                    assert not n.startswith("portbench"), path


def test_no_result_without_a_card(tmp_path):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    res = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "qwen1.5-32b-q4.chat1", "--seed", "2147483700", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=120)
    assert res.returncode != 0 and res.stdout.strip() == ""


def test_no_result_without_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and portbench/."""
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; sys.argv = ['run.py', '--workload', "
            "'qwen1.5-32b-q4.chat1', '--seed', '1', '--seconds', '1']; "
            "sys.path.insert(0, 'portbench'); import torch; "
            "torch.cuda.is_available = lambda: True; "
            "torch.cuda.device_count = lambda: 1; "
            "import runpy; runpy.run_path('portbench/run.py', "
            "run_name='__main__')")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode != 0 and res.stdout.strip() == "", res.stderr


def test_forbidden_modules_are_named():
    sys.path.insert(0, str(ROOT / "portbench"))
    try:
        import importlib
        run = importlib.import_module("run")
        sys.modules["repro.fake"] = sys
        try:
            assert "repro.fake" in run.forbidden_modules()
        finally:
            del sys.modules["repro.fake"]
        assert "repro_torch" not in run.forbidden_modules()
    finally:
        sys.path.remove(str(ROOT / "portbench"))
        sys.modules.pop("run", None)
