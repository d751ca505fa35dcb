"""The port's dry run (``repro_torch.launch.dryrun``) against the JAX
package's (``repro.launch.dryrun``).

* The decode path of every (arch x shape) cell on both production meshes
  equals the JAX ``decode_path``'s (it reads only ``mesh.shape``, so a
  stand-in with ``shape`` is enough), and the port plans a cell down the
  path it names.
* ``memory.argument_bytes`` equals the JAX record's on the three single
  mesh cells that compile with jax 0.9.0 (CI pins 0.4.37) and that this file
  runs: qwen2-vl-2b x decode_32k (the ring), mamba2-780m and
  mixtral-8x7b x long_500k (GSPMD decode at batch 1). The JAX
  ``run_cell`` runs in a subprocess: its 512-device flag must come
  before JAX starts, and the suite's conftest pins 8. The two sum the
  same arguments: the ring's tokens and cache (the JAX step also takes
  the lengths as an argument of their own and jit drops the cache's
  unread copy; the port's step reads the cache's), GSPMD's parameters,
  cache and tokens.
* Train and prefill cells, which do not compile with jax 0.9.0: the
  parameter, moment, cache and input bytes of a device equal the shard
  sizes the JAX specs (``param_shardings``, ``cache_shardings``,
  ``data_sharding``, ``embeds_sharding`` and the tokens' sanitized batch
  spec, over an ``AbstractMesh``) give for the JAX ``specs`` shapes.
* The port's dry run over the cells here takes under 30 s.
"""
import json
import math
import os
import subprocess
import sys
import time
import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, PartitionSpec as P

from repro.configs import ASSIGNED_ARCHS, SHAPES, get_config
from repro.launch import specs as JSP
from repro.runtime import sharding as JSH
from repro_torch.launch import dryrun as TD

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_CELLS = [("qwen2-vl-2b", "decode_32k"), ("mamba2-780m", "long_500k"),
             ("mixtral-8x7b", "long_500k")]
MESHES = {"single": {"data": 16, "model": 16},
          "multi": {"pod": 2, "data": 16, "model": 16}}
PLANNED = {}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """This file's tests run torch on one thread (the suite's parallel
    workers would otherwise spin against each other)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_dryrun():
    """``repro.launch.dryrun``, imported with the environment it edits
    (its 512-device flag) put back: nothing else here starts JAX."""
    before = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun
    if before is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = before
    return dryrun


def plan(arch, shape, mesh_kind):
    """The port's record of a cell (planned once a module, timed)."""
    key = (arch, shape, mesh_kind)
    if key not in PLANNED:
        t0 = time.perf_counter()
        rec = TD.run_cell(arch, shape, mesh_kind)
        PLANNED[key] = (rec, time.perf_counter() - t0)
    return PLANNED[key][0]


def test_decode_path_matches_jax_on_every_cell(jax_dryrun):
    n = 0
    for arch in ASSIGNED_ARCHS:
        cfg = get_config(arch)
        for shape in cfg.shapes():
            for mesh in MESHES.values():
                stand_in = types.SimpleNamespace(shape=dict(mesh))
                want = jax_dryrun.decode_path(cfg, shape, stand_in)
                got = TD.decode_path(TD.get_config(arch),
                                     TD.SHAPES[shape.name], mesh)
                assert got == want, (arch, shape.name, mesh)
                n += 1
    assert n == 66


@pytest.fixture(scope="module")
def jax_records():
    code = (
        "import json, sys\n"
        "from repro.launch import dryrun as D\n"
        f"cells = {JAX_CELLS!r}\n"
        "out = [D.run_cell(a, s, 'single') for a, s in cells]\n"
        "json.dump([{k: r[k] for k in ('arch', 'shape', 'mesh', 'kind',"
        " 'path', 'mesh_kind', 'ok', 'model', 'memory')} for r in out],"
        " sys.stdout)\n")
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("i", range(len(JAX_CELLS)),
                         ids=[f"{a}-{s}" for a, s in JAX_CELLS])
def test_argument_bytes_equal_the_jax_record(jax_records, i):
    want = jax_records[i]
    got = plan(want["arch"], want["shape"], "single")
    for k in ("arch", "shape", "mesh", "kind", "path", "mesh_kind", "ok",
              "model"):
        assert got[k] == want[k], k
    assert got["memory"]["argument_bytes"] == \
        want["memory"]["argument_bytes"]


def _entry_size(mesh, e):
    if e is None:
        return 1
    return math.prod(mesh[a] for a in (e if isinstance(e, tuple) else (e,)))


def _bytes(leaves, shardings, mesh):
    """One device's bytes of ``leaves`` (ShapeDtypeStructs) under the
    JAX ``shardings`` (a matching tree)."""
    total = 0
    for leaf, sh in zip(jax.tree.leaves(leaves), jax.tree.leaves(
            shardings, is_leaf=lambda x: hasattr(x, "spec"))):
        spec = tuple(sh.spec) + (None,) * leaf.ndim
        n = 1
        for d, e in zip(leaf.shape, spec):
            assert d % _entry_size(mesh, e) == 0
            n *= d // _entry_size(mesh, e)
        total += n * np.dtype(leaf.dtype).itemsize
    return total


def _batch_bytes(mesh, jm, batch, kind):
    out = 0
    for name, leaf in batch.items():
        if name == "embeds":
            spec = JSH.embeds_sharding(jm).spec
        elif kind == "train":
            spec = JSH.data_sharding(jm, leaf.ndim).spec
        else:             # the prefill's tokens: the sanitized batch spec
            spec = JSH.sanitize(P(JSH.batch_axes(jm)), leaf.shape, jm)
        out += _bytes([leaf], [types.SimpleNamespace(spec=spec)], mesh)
    return out


SPEC_CELLS = [("whisper-tiny", "train_4k", "single"),
              ("minitron-8b", "train_4k", "multi"),
              ("qwen2-vl-2b", "prefill_32k", "single"),
              ("mixtral-8x7b", "prefill_32k", "multi"),
              ("recurrentgemma-9b", "prefill_32k", "single")]


@pytest.mark.parametrize("arch,shape,mk", SPEC_CELLS,
                         ids=[f"{a}-{s}-{m}" for a, s, m in SPEC_CELLS])
def test_train_and_prefill_bytes_equal_the_jax_shards(arch, shape, mk):
    cfg = get_config(arch)
    spec = SHAPES[shape]
    mesh = MESHES[mk]
    jm = AbstractMesh(tuple(mesh.values()), tuple(mesh))
    params = JSP.params_shapes(cfg)
    pbytes = _bytes(params, JSH.param_shardings(cfg, jm, params), mesh)
    batch = JSP.batch_shapes(cfg, spec)
    got = plan(arch, shape, mk)["memory"]
    assert got["params_bytes"] == pbytes
    assert got["input_bytes"] == _batch_bytes(mesh, jm, batch, spec.kind)
    if spec.kind == "train":
        opt = JSP.opt_shapes(params)
        mu = _bytes(opt.mu, JSH.param_shardings(cfg, jm, opt.mu), mesh)
        assert got["moments_bytes"] == 2 * mu + 4       # mu, nu, the step
        assert got["cache_bytes"] == 0
    else:
        cache = JSP.cache_shapes(cfg, spec.global_batch,
                                 JSP.decode_context(cfg, spec))
        assert got["cache_bytes"] == _bytes(
            cache, JSH.cache_shardings(cfg, jm, cache), mesh)
        assert got["moments_bytes"] == 0
    assert got["argument_bytes"] == sum(
        got[k] for k in ("params_bytes", "moments_bytes", "cache_bytes",
                         "input_bytes"))


def test_the_planned_cells_took_under_30_s():
    for arch, shape in JAX_CELLS:
        plan(arch, shape, "single")
    for arch, shape, mk in SPEC_CELLS:
        plan(arch, shape, mk)
    total = sum(s for _, s in PLANNED.values())
    assert total < 30.0, {k: round(s, 2) for k, (_, s) in PLANNED.items()}
    for rec, _ in PLANNED.values():
        assert rec["ok"] and rec["collectives"]
        assert "compile_s" not in rec


def test_cli_plans_a_cell_and_writes_its_record(tmp_path):
    out = tmp_path / "d.json"
    assert TD.main(["--arch", "whisper-tiny", "--shape", "decode_32k",
                    "--mesh", "both", "--out", str(out)]) == 0
    recs = json.loads(out.read_text())
    assert [r["mesh_kind"] for r in recs] == ["single", "multi"]
    assert all(r["path"] == "gspmd-decode" for r in recs)
    assert recs[1]["mesh"] == {"pod": 2, "data": 16, "model": 16}


def test_production_meshes_and_the_drivers_prod_mesh():
    """``make_production_mesh`` is the JAX function's mesh (its shape and
    axis names; ``jax.make_mesh`` would need its 256 devices here) as an
    ordered dict; the serve driver's ``--mesh prod`` sets the JAX
    driver's 16 stages x tp 16 (a world of 256 ranks: parsed here, not
    run)."""
    from repro_torch.launch import mesh as TM
    from repro_torch.launch import serve as TS

    for multi in (False, True):
        got = TM.make_production_mesh(multi_pod=multi)
        want = AbstractMesh((2, 16, 16) if multi else (16, 16),
                            ("pod", "data", "model") if multi
                            else ("data", "model"))
        assert list(got.items()) == list(want.shape.items())
    assert TM.make_debug_mesh(4, 2, multi_pod=True) == {
        "pod": 2, "data": 4, "model": 2}
    args = TS.parse_args(["--smoke", "--mesh", "prod", "--device", "cpu"])
    assert (args.stages, args.tp) == (16, 16)
    lay = TM.dry_rank_layout(TM.make_production_mesh(multi_pod=True),
                             rank=300)
    assert (lay.pod, lay.stage, lay.member) == (1, 2, 12)
    assert lay.mesh == {"pod": 2, "data": 16, "model": 16}
    assert lay.pods_axis.size == 2 and lay.ring.size == 16
