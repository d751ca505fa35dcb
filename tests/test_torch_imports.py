"""Import hygiene of the port: ``src/repro_torch`` and ``chip_smoke.py``
import neither JAX nor anything of the JAX package ``repro``."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """This file's tests run torch on one thread: under the test runner's
    parallel workers, torch's default of a thread a core has every
    worker's threads spin against the others', and these shapes gain
    nothing from more threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top == "jax" or top == "repro"


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module and _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path}: imports {bad}"


def test_serve_entry_point_leaves_jax_unloaded():
    code = ("import sys, repro_torch.launch.serve; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert not any(m == 'repro' or m.startswith('repro.') "
            "for m in sys.modules), 'repro imported'")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_train_entry_point_leaves_jax_unloaded():
    code = ("import sys, repro_torch.launch.train, repro_torch.launch.specs; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert not any(m == 'repro' or m.startswith('repro.') "
            "for m in sys.modules), 'repro imported'")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_walk_covers_every_port_module():
    """The import check above walks every module of the port, the q4
    streaming slice's (quant, store, prefetcher, kernel B3) and the
    speculative slice's (decoder, kernel B5, the qwen1.5 configs), the
    tiered slice's (faults, the recall-cost terms), the ring slice's
    (schedule, profiles, Halda, cluster selection, elastic re-plan,
    failover, the ring layout), the moe slice's (the mixtral,
    phi3.5-moe and minitron configs, the simulator, baselines and
    profiler), the last families' (the minicpm3, qwen2-vl,
    recurrentgemma and whisper configs) and the trainer's (optimizer,
    checkpoints, train step, train driver, shape stand-ins, the plain
    kernels under their JAX names) and the ring across ranks' (the
    partition specs, the named-axis collectives; its streamed windows
    and its failover live in ``runtime/streaming.py``,
    ``runtime/serve.py``, ``runtime/failover.py`` and
    ``launch/mesh.py``) and the GSPMD layer's (the rank model and its
    serve steps, the dry run; its train step lives in
    ``runtime/train.py``) included."""
    names = {str(p.relative_to(ROOT / "src" / "repro_torch"))
             for p in FILES if p.name != "chip_smoke.py"}
    for want in ("quant/__init__.py", "quant/grouped.py",
                 "kernels/q4_matmul.py", "runtime/paramstore.py",
                 "runtime/streaming.py", "runtime/iopolicy.py",
                 "runtime/memory.py", "runtime/serve.py",
                 "runtime/speculative.py", "kernels/flash_decode.py",
                 "configs/qwen15_32b.py", "configs/qwen15_05b_draft.py",
                 "runtime/faults.py", "core/latency.py",
                 "core/ring.py", "core/profiles.py", "core/halda.py",
                 "core/cluster.py", "runtime/elastic.py",
                 "runtime/failover.py", "launch/mesh.py",
                 "configs/mixtral.py", "configs/phi35_moe.py",
                 "configs/minitron_8b.py", "core/simulator.py",
                 "core/baselines.py", "core/profiler.py",
                 "configs/minicpm3.py", "configs/qwen2_vl_2b.py",
                 "configs/recurrentgemma_9b.py", "configs/whisper_tiny.py",
                 "runtime/optim.py", "runtime/checkpoint.py",
                 "runtime/train.py", "launch/train.py", "launch/specs.py",
                 "kernels/ref.py", "runtime/sharding.py",
                 "runtime/collectives.py", "runtime/gspmd.py",
                 "launch/dryrun.py"):
        assert want in names


def test_dryrun_entry_point_leaves_jax_unloaded():
    code = ("import sys, repro_torch.launch.dryrun, "
            "repro_torch.runtime.gspmd; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert not any(m == 'repro' or m.startswith('repro.') "
            "for m in sys.modules), 'repro imported'")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
