"""The port's partition specs (``repro_torch.runtime.sharding`` and the
ring's in ``repro_torch.runtime.serve``) against the JAX package's, leaf
by leaf: every config of ``ASSIGNED_ARCHS`` at its published shapes
(``jax.eval_shape``), its params (``fsdp`` and ``zero1``), its ZeRO-1
moments and its cache (bf16, and int8 where the config has it), over every
mesh 8 CPU devices make and over the production meshes (16, 16) and (2,
16, 16), for which ``jax.sharding.AbstractMesh`` stands in; the ring's
param and cache specs over the meshes the ring runs on. Then a rank's
part: ``local_shard`` against the shard ``jax.device_put`` puts on each
device of the mesh, and ``assemble`` back to the full array.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding

from repro.configs import get_config
from repro.models import init_cache, init_params
from repro.runtime import serve as JS
from repro.runtime import sharding as JSH
from repro_torch import bridge
from repro_torch.configs import ASSIGNED_ARCHS
from repro_torch.configs import get_config as t_get_config
from repro_torch.runtime import serve as RS
from repro_torch.runtime import sharding as S


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """This file's tests run torch on one thread (the suite's parallel
    workers would otherwise spin against each other)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


MESHES = [((8, 1), ("data", "model")), ((4, 2), ("data", "model")),
          ((2, 4), ("data", "model")), ((1, 8), ("data", "model")),
          ((2, 2, 2), ("pod", "data", "model")),
          ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]


def _jmesh(shape, names):
    if np.prod(shape) <= jax.device_count():
        return jax.make_mesh(shape, names)
    return AbstractMesh(shape, names)


def _norm(entry):
    """One spec entry as the port writes it: a 1-tuple is its axis, an
    empty tuple is None."""
    if isinstance(entry, (tuple, list)):
        entry = tuple(entry)
        if not entry:
            return None
        return entry[0] if len(entry) == 1 else entry
    return entry


def _spec(spec, n):
    return tuple(_norm(e) for e in (tuple(spec) + (None,) * n)[:n])


@functools.lru_cache(maxsize=None)
def _shapes(arch):
    cfg = get_config(arch)
    params = jax.eval_shape(lambda: init_params(cfg, jax.random.PRNGKey(0)))
    caches = [jax.eval_shape(lambda: init_cache(cfg, 32, 256))]
    return cfg, params, caches


def _as_port(tree):
    """The abstract tree as nested dicts of shaped leaves (the port's
    rules read shapes only)."""
    if isinstance(tree, dict):
        return {k: _as_port(v) for k, v in tree.items()}
    return tree


def _pairs(jtree, port: dict):
    flat = jax.tree_util.tree_flatten_with_path(jtree)[0]
    assert len(flat) == len(port)
    return [(jax.tree_util.keystr(p), leaf, path, got)
            for (p, leaf), (path, got) in zip(flat, port.items())]


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_param_and_moment_specs_equal_jax(arch):
    cfg, params, _ = _shapes(arch)
    tcfg = t_get_config(arch)
    tree = _as_port(params)
    for shape, names in MESHES:
        jm = _jmesh(shape, names)
        mesh = dict(zip(names, shape))
        for style in ("fsdp", "zero1"):
            want = JSH.param_shardings(cfg, jm, params, style=style)
            got = S.param_shardings(tcfg, mesh, tree, style=style)
            for jpath, js, path, ts in _pairs(want, got):
                assert S.leaf_key(path) == S.leaf_key(jpath)
                n = len(ts.spec)
                assert _spec(js.spec, n) == _spec(ts.spec, n), \
                    (arch, shape, style, path)
        want = JSH.zero1_moment_shardings(cfg, jm, params)
        got = S.zero1_moment_shardings(tcfg, mesh, tree)
        for jpath, js, path, ts in _pairs(want, got):
            n = len(ts.spec)
            assert _spec(js.spec, n) == _spec(ts.spec, n), (arch, shape,
                                                             path)


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_cache_specs_equal_jax(arch):
    cfg, _, caches = _shapes(arch)
    tcfg = t_get_config(arch)
    for cache in caches:
        tree = _as_port(cache)
        for shape, names in MESHES:
            jm = _jmesh(shape, names)
            mesh = dict(zip(names, shape))
            want = JSH.cache_shardings(cfg, jm, cache)
            got = S.cache_shardings(tcfg, mesh, tree)
            for jpath, js, path, ts in _pairs(want, got):
                n = len(ts.spec)
                assert _spec(js.spec, n) == _spec(ts.spec, n), \
                    (arch, shape, path)


def test_small_rules_equal_jax():
    for shape, names in MESHES:
        jm = _jmesh(shape, names)
        mesh = dict(zip(names, shape))
        assert S.batch_axes(mesh) == JSH.batch_axes(jm)
        for nd, mrope in ((2, False), (3, True), (3, False)):
            assert _spec(S.data_sharding(mesh, nd, mrope=mrope).spec, nd) \
                == _spec(JSH.data_sharding(jm, nd, mrope=mrope).spec, nd)
        assert _spec(S.embeds_sharding(mesh).spec, 3) == \
            _spec(JSH.embeds_sharding(jm).spec, 3)
        assert S.replicated(mesh).spec == tuple(JSH.replicated(jm).spec)
        for spec, shp in ((("data", "model"), (12, 10)),
                          ((("pod", "data"), None), (6, 3)),
                          ((("pod", "data"), "model"), (4, 16)),
                          (("model",), (7,))):
            if any(a not in mesh for e in spec
                   for a in ((e,) if isinstance(e, str) else e or ())):
                continue
            assert _spec(S.sanitize(spec, shp, mesh), len(shp)) == _spec(
                JSH.sanitize(jax.sharding.PartitionSpec(*spec), shp, jm),
                len(shp))


def test_moe_ep_override_equals_jax():
    cfg, tcfg = get_config("mixtral-8x7b"), t_get_config("mixtral-8x7b")
    jm, mesh = _jmesh((2, 4), ("data", "model")), {"data": 2, "model": 4}
    try:
        for value in (None, True, False):
            JSH.set_moe_ep(value)
            S.set_moe_ep(value)
            assert S.moe_ep(tcfg, mesh) == JSH.moe_ep(cfg, jm)
            for path, nd in (("['blocks']['moe']['w_gate']", 4),
                             ("['blocks']['moe']['w_down']", 4)):
                assert _spec(S.param_spec(tcfg, mesh, path, nd), nd) == \
                    _spec(JSH.param_spec(cfg, jm, path, nd), nd)
    finally:
        JSH.set_moe_ep(None)
        S.set_moe_ep(None)


RING_ARCHS = ["qwen2.5-14b", "mixtral-8x7b", "minicpm3-4b", "qwen2-vl-2b",
              "mamba2-780m", "qwen1.5-32b", "phi3.5-moe-42b-a6.6b"]


@pytest.mark.parametrize("arch", RING_ARCHS)
def test_ring_specs_equal_jax(arch):
    """The ring's specs (layer axis over "data", FFN and experts over
    "model", the head vocab-sharded, the KV sequence over "model") on
    ring-ordered trees of the reduced config, float and q4 ring banks
    (``quantize_ring_params`` at the real tp)."""
    cfg = dataclasses.replace(get_config(arch).reduced(), n_layers=8)
    tcfg = dataclasses.replace(t_get_config(arch).reduced(), n_layers=8)
    params = init_params(cfg, jax.random.PRNGKey(0))
    for shape, names in MESHES[:5]:
        jm = jax.make_mesh(shape, names)
        mesh = dict(zip(names, shape))
        M, tp = mesh["data"], mesh["model"]
        trees = [params]
        if cfg.family != "ssm":
            trees.append(JS.quantize_ring_params(dict(params), cfg,
                                                 tp=tp)[0])
        for tree in trees:
            pr = JS.pad_vocab(dict(tree), cfg, tp)
            pr["blocks"] = JS.pad_and_permute(tree["blocks"], cfg, M, 1)
            want = JS.ring_param_specs(cfg, jm, pr)
            got = RS.ring_param_specs(tcfg, mesh, bridge.tree_from_numpy(
                jax.tree.map(np.asarray, pr), device="cpu"))
            for jpath, js, path, spec in _pairs(want, got):
                n = len(spec)
                assert _spec(js, n) == _spec(spec, n), (arch, shape, path)
        cache = init_cache(cfg, 8, 32)
        cache["layers"] = JS.pad_and_permute(cache["layers"], cfg, M, 1)
        want = JS.ring_cache_specs(cfg, jm, cache)
        tcache = {"len": torch.zeros(8, dtype=torch.int32),
                  "layers": {n: torch.zeros(a.shape)
                             for n, a in cache["layers"].items()}}
        got = RS.ring_cache_specs(tcfg, mesh, tcache)
        for jpath, js, path, spec in _pairs(want, got):
            n = len(spec)
            assert _spec(js, n) == _spec(spec, n), (arch, shape, path)


@pytest.mark.parametrize("shape,names", MESHES[:5])
def test_local_shard_equals_device_put(shape, names):
    """``local_shard`` cuts what ``jax.device_put`` places on the device
    at each mesh coordinate; ``assemble`` rebuilds the array; a
    replica that differs is refused."""
    jm = jax.make_mesh(shape, names)
    mesh = dict(zip(names, shape))
    rng = np.random.default_rng(0)
    full = rng.standard_normal((8, 16, 4, 6)).astype(np.float32)
    devs = np.asarray(jm.devices)
    specs = [("data", None, "model"), (None, "model", "data", None),
             ((("pod", "data") if "pod" in mesh else "data"), "model"),
             ("model", None, None, None), ()]
    for spec in specs:
        spec = S.sanitize(spec, full.shape, mesh)
        arr = jax.device_put(full, NamedSharding(
            jm, jax.sharding.PartitionSpec(*spec)))
        parts = {}
        for shard in arr.addressable_shards:
            idx = tuple(int(i) for i in np.argwhere(devs == shard.device)[0])
            coords = dict(zip(names, idx))
            got = S.local_shard(torch.from_numpy(full), spec, mesh, coords)
            np.testing.assert_array_equal(got.numpy(), np.asarray(shard.data))
            parts[idx] = got
        back = S.assemble(parts, spec, mesh)
        np.testing.assert_array_equal(back.numpy(), full)
        if any(e is not None for e in spec) and len(parts) > 1 and \
                np.prod([S.axis_size(mesh, e) for e in spec]) < len(parts):
            key = next(iter(parts))
            parts[key] = parts[key] + 1
            with pytest.raises(ValueError, match="replicas"):
                S.assemble(parts, spec, mesh)
    with pytest.raises(ValueError, match="does not split"):
        S.local_shard(torch.zeros(3, 5), ("data",), {"data": 2}, {"data": 0})


def test_flatten_order_and_quantized_leaves():
    """The port flattens a tree in ``jax.tree_util``'s order, a packed q4
    leaf as its packed bytes then its scale under the leaf's key."""
    cfg = dataclasses.replace(get_config("qwen2.5-14b").reduced(),
                              n_layers=2)
    qp, _ = JS.quantize_ring_params(dict(init_params(
        cfg, jax.random.PRNGKey(0))), cfg, tp=2)
    tree = bridge.tree_from_numpy(jax.tree.map(np.asarray, qp),
                                  device="cpu")
    jflat = jax.tree_util.tree_flatten_with_path(qp)[0]
    tflat = list(S.flatten_with_path(tree))
    assert len(jflat) == len(tflat)
    for (jp, jl), (tp_, tl) in zip(jflat, tflat):
        assert S.leaf_key(jax.tree_util.keystr(jp)) == S.leaf_key(tp_)
        assert tuple(jl.shape) == tuple(tl.shape)
