"""The port's shape stand-ins (``launch.specs``, meta tensors) against the
JAX package's (``repro.launch.specs``, ``ShapeDtypeStruct``s) for every
arch and shape cell, and the plain kernels under their JAX names
(``kernels.ref``) against ``repro.kernels.ref`` on one small input each.

Tolerances: shapes and dtypes equal; the oracles within 1e-5 of max|ref|
(f32 on both sides, another order of summation), the SSD ones within
2e-4 (the bound ``tests/test_kernels.py`` holds the Pallas scan to).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ASSIGNED_ARCHS, get_config
from repro.configs.base import SHAPES
from repro.kernels import ref as jref
from repro.launch import specs as JS
from repro.quant.grouped import quantize_q4 as j_quantize_q4
from repro_torch.configs import get_config as t_get_config
from repro_torch.kernels import ref as tref
from repro_torch.launch import specs as TS
from repro_torch.runtime.checkpoint import tree_leaves
from test_torch_train import one_torch_thread  # noqa: F401  (autouse)

CELLS = [(a, s.name) for a in ASSIGNED_ARCHS for s in get_config(a).shapes()]
DTYPES = {jnp.dtype(jnp.bfloat16): torch.bfloat16,
          jnp.dtype(jnp.float32): torch.float32,
          jnp.dtype(jnp.int32): torch.int32,
          jnp.dtype(jnp.int8): torch.int8}


def _same(jtree, ttree):
    want = jax.tree.leaves(jtree)
    got = tree_leaves(ttree)
    assert len(want) == len(got)
    for a, b in zip(want, got):
        assert b.device.type == "meta"
        assert tuple(b.shape) == tuple(a.shape)
        assert b.dtype == DTYPES[jnp.dtype(a.dtype)]


def _q4_leaves(tree):
    """A tree whose ``QuantizedTensor``s are their (packed, scale)."""
    if isinstance(tree, dict):
        return {k: _q4_leaves(v) for k, v in tree.items()}
    if hasattr(tree, "packed"):
        return (tree.packed, tree.scale)
    return tree


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_params_and_opt_shapes(arch):
    jp = JS.params_shapes(get_config(arch))
    tp = TS.params_shapes(t_get_config(arch))
    _same(jp, tp)
    _same(JS.opt_shapes(jp), TS.opt_shapes(tp))


@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_shapes(arch, shape):
    jcfg, tcfg = get_config(arch), t_get_config(arch)
    cell = SHAPES[shape]
    assert TS.decode_context(tcfg, cell) == JS.decode_context(jcfg, cell)
    _same(JS.batch_shapes(jcfg, cell), TS.batch_shapes(tcfg, cell))
    if cell.kind != "train":
        ctx = JS.decode_context(jcfg, cell)
        _same(JS.cache_shapes(jcfg, cell.global_batch, ctx),
              TS.cache_shapes(tcfg, cell.global_batch, ctx))
    want = JS.input_specs(arch, shape)
    got = TS.input_specs(arch, shape)
    assert sorted(got) == sorted(want)
    _same(want["batch"], got["batch"])


@pytest.mark.parametrize("arch", ["qwen2.5-14b", "mamba2-780m"])
def test_ring_shapes(arch):
    jcfg, tcfg = get_config(arch), t_get_config(arch)
    for quant in (0, 4):
        want = JS.ring_params_shapes(jcfg, 4, 2, 16, quant=quant)
        got = TS.ring_params_shapes(tcfg, 4, 2, 16, quant=quant)
        _same(want, _q4_leaves(got))
    _same(JS.cache_shapes(jcfg, 2, 64, ring=(4, 2)),
          TS.cache_shapes(tcfg, 2, 64, ring=(4, 2)))


# --------------------------------------------------------------------------- #
#  kernels/ref.py: the plain versions under the JAX names
# --------------------------------------------------------------------------- #

def _close(want, got, tol=1e-5):
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    assert want.shape == got.shape
    assert float(np.abs(want - got).max()) <= tol * float(
        np.abs(want).max())


def _pages(rng, B=2, nb=3, bs=4, hk=2, D=16):
    P = B * nb + 1
    k = rng.standard_normal((P, bs, hk, D)).astype(np.float32)
    v = rng.standard_normal((P, bs, hk, D)).astype(np.float32)
    table = rng.permutation(P)[:B * nb].reshape(B, nb).astype(np.int32)
    kv_len = np.array([9, 12], np.int32)
    return k, v, table, kv_len


def _int8(rng, pages):
    scale = (np.abs(pages).max(-1) / 127).astype(np.float32)
    q = np.round(pages / scale[..., None]).astype(np.int8)
    return q, scale


def _both(fn, *args, **kw):
    """``fn`` of both modules on the same numpy arguments."""
    j = getattr(jref, fn)(*(jnp.asarray(a) for a in args), **kw)
    t = getattr(tref, fn)(*(torch.from_numpy(np.array(a)) for a in args),
                          **kw)
    return j, t


def test_ref_exports_match_jax():
    rng = np.random.default_rng(0)
    assert sorted(tref.__all__) == sorted(
        n for n in dir(jref) if n.endswith("_ref"))
    # q4: the port's packing is the JAX package's (tests/test_torch_quant)
    w = rng.standard_normal((128, 24)).astype(np.float32)
    qt = j_quantize_q4(jnp.asarray(w), 64)
    x = rng.standard_normal((3, 128)).astype(np.float32)
    want = jref.q4_matmul_ref(jnp.asarray(x), qt.packed, qt.scale, group=64)
    got = tref.q4_matmul_ref(
        torch.from_numpy(x), torch.from_numpy(np.array(qt.packed)),
        torch.from_numpy(np.asarray(qt.scale).view(np.int16).copy()).view(
            torch.bfloat16), group=64)
    _close(want, got)
    # attention over a contiguous cache, T = 1 and T = 3
    k = rng.standard_normal((2, 12, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 12, 2, 16)).astype(np.float32)
    kv_len = np.array([7, 12], np.int32)
    _close(*_both("flash_decode_ref", rng.standard_normal(
        (2, 4, 16)).astype(np.float32), k, v, kv_len, window=5))
    _close(*_both("flash_verify_ref", rng.standard_normal(
        (2, 3, 4, 16)).astype(np.float32), k, v, kv_len))
    # paged attention, float and int8 pages
    kp, vp, table, kl = _pages(rng)
    q1 = rng.standard_normal((2, 4, 16)).astype(np.float32)
    q3 = rng.standard_normal((2, 3, 4, 16)).astype(np.float32)
    _close(*_both("paged_decode_ref", q1, kp, vp, table, kl))
    _close(*_both("paged_verify_ref", q3, kp, vp, table, kl, window=6))
    _close(*_both("paged_prefill_ref", q3, kp, vp, table, kl))
    (kq, ks), (vq, vs) = _int8(rng, kp), _int8(rng, vp)
    _close(*_both("paged_decode_quant_ref", q1, kq, vq, ks, vs, table, kl))
    _close(*_both("paged_verify_quant_ref", q3, kq, vq, ks, vs, table, kl))
    # the SSD scans
    B, S, nh, P, N = 2, 20, 3, 4, 8
    xs = rng.standard_normal((B, S, nh, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, nh)))).astype(
        np.float32)
    A = -np.exp(rng.standard_normal(nh)).astype(np.float32)
    Bm = rng.standard_normal((B, S, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, N)).astype(np.float32)
    for fn, kw in (("ssd_scan_ref", {"chunk": 8}), ("ssd_sequential_ref",
                                                    {})):
        (jy, jh), (ty, th) = _both(fn, xs, dt, A, Bm, Cm, **kw)
        _close(jy, ty, 2e-4)
        _close(jh, th, 2e-4)
