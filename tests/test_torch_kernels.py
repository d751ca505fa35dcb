"""The port's paged-attention dispatch against the JAX Pallas kernels.

The same numpy inputs, drawn from a seed, go through the Pallas kernels
(``interpret=True``, as ``tests/test_kernels.py`` runs them on the CPU),
the JAX oracles in ``repro.kernels.ref`` and ``repro_torch.kernels.ops``
on CPU tensors (the plain torch versions). Tolerance atol = rtol = 1e-5:
every side computes in f32, with another order of summation.

The CUDA kernels themselves need the card: ``chip_smoke.py`` holds each
against its plain version there.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.paged_decode import paged_verify as j_paged_verify
from repro.kernels.paged_decode import \
    paged_verify_quant as j_paged_verify_quant
from repro.kernels.paged_prefill import paged_prefill as j_paged_prefill
from repro_torch.kernels import ops

TOL = dict(rtol=1e-5, atol=1e-5)


def _case(seed, *, B, T, H, h_kv, D, P, bs, nb, kv_len, sink_rows=()):
    """q, pages and a table whose entries past ceil(kv_len/bs) are stale
    page ids; rows in ``sink_rows`` get kv_len = T on an all-sink table
    (an inactive slot)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, H, D)).astype(np.float32)
    kp = rng.standard_normal((P, bs, h_kv, D)).astype(np.float32)
    vp = rng.standard_normal((P, bs, h_kv, D)).astype(np.float32)
    table = rng.permutation(np.arange(1, P))[:B * nb].reshape(B, nb)
    table = table.astype(np.int32)
    kv = np.asarray(kv_len, np.int32)
    for b in sink_rows:
        table[b] = 0
        kv[b] = T
    return q, kp, vp, table, kv


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


CASES = [
    # T, H, h_kv: GQA n_rep 1 and 5; kv_len leaves stale entries past it
    dict(B=3, T=1, H=4, h_kv=4, D=16, P=40, bs=8, nb=6,
         kv_len=[1, 20, 48]),
    dict(B=3, T=4, H=10, h_kv=2, D=16, P=40, bs=8, nb=6,
         kv_len=[4, 27, 41], sink_rows=(0,)),
    dict(B=2, T=1, H=10, h_kv=2, D=32, P=20, bs=4, nb=8,
         kv_len=[5, 30], sink_rows=(1,)),
    dict(B=2, T=4, H=4, h_kv=4, D=32, P=20, bs=4, nb=8,
         kv_len=[9, 32]),
    # a prompt chunk at B = 1: int8 admission runs B4 at this geometry
    dict(B=1, T=13, H=10, h_kv=2, D=16, P=40, bs=4, nb=16, kv_len=[37]),
]


@pytest.mark.parametrize("window", [None, 6])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_paged_verify_matches_pallas(case, window):
    q, kp, vp, table, kv = _case(case, **CASES[case])
    before = ops.launch_counts()
    out = ops.paged_verify(_t(q), _t(kp), _t(vp), _t(table), _t(kv),
                           window=window).numpy()
    assert ops.launch_counts() == before          # CPU: plain version
    jargs = tuple(jnp.asarray(a) for a in (q, kp, vp, table, kv))
    pallas = j_paged_verify(*jargs, window=window, interpret=True)
    oracle = ref.paged_verify_ref(*jargs, window=window)
    np.testing.assert_allclose(out, np.asarray(pallas), **TOL)
    np.testing.assert_allclose(out, np.asarray(oracle), **TOL)
    assert np.isfinite(out).all()
    if CASES[case]["T"] == 1:
        dec = ops.paged_decode(_t(q[:, 0]), _t(kp), _t(vp), _t(table),
                               _t(kv), window=window).numpy()
        np.testing.assert_array_equal(dec, out[:, 0])


PREFILL_CASES = [
    # one chunk of S rows at the end of kv_len; the table is sized for
    # the full context, so most of its pages are dead for the chunk
    dict(B=1, T=16, H=10, h_kv=2, D=16, P=40, bs=4, nb=16, kv_len=[40]),
    dict(B=1, T=5, H=4, h_kv=4, D=16, P=40, bs=8, nb=8, kv_len=[13]),
    dict(B=2, T=8, H=4, h_kv=2, D=32, P=40, bs=4, nb=10,
         kv_len=[8, 37]),
]


@pytest.mark.parametrize("window", [None, 8])
@pytest.mark.parametrize("case", range(len(PREFILL_CASES)))
def test_paged_prefill_matches_pallas(case, window):
    q, kp, vp, table, kv = _case(10 + case, **PREFILL_CASES[case])
    out = ops.paged_prefill(_t(q), _t(kp), _t(vp), _t(table), _t(kv),
                            window=window).numpy()
    jargs = tuple(jnp.asarray(a) for a in (q, kp, vp, table, kv))
    pallas = j_paged_prefill(*jargs, window=window, interpret=True)
    oracle = ref.paged_prefill_ref(*jargs, window=window)
    np.testing.assert_allclose(out, np.asarray(pallas), **TOL)
    np.testing.assert_allclose(out, np.asarray(oracle), **TOL)
    assert ops.launch_counts() == {k: 0 for k in ops.launch_counts()}


def _quantize(pages, rng):
    scale = (np.abs(pages).max(-1) / 127.0).astype(np.float32)
    scale *= rng.uniform(0.9, 1.1, scale.shape).astype(np.float32)
    qp = np.clip(np.rint(pages / scale[..., None]), -127, 127)
    return qp.astype(np.int8), scale


@pytest.mark.parametrize("scale_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_paged_verify_quant_matches_pallas(case, scale_dtype):
    q, kp, vp, table, kv = _case(20 + case, **CASES[case])
    rng = np.random.default_rng(case)
    kq, ks = _quantize(kp, rng)
    vq, vs = _quantize(vp, rng)
    # scales stored in the pool dtype; both sides read the same values
    ks_t = _t(ks).to(getattr(torch, scale_dtype))
    vs_t = _t(vs).to(getattr(torch, scale_dtype))
    out = ops.paged_verify_quant(_t(q), _t(kq), _t(vq), ks_t, vs_t,
                                 _t(table), _t(kv)).numpy()
    ks_j = jnp.asarray(ks).astype(scale_dtype)
    vs_j = jnp.asarray(vs).astype(scale_dtype)
    jargs = (jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq), ks_j, vs_j,
             jnp.asarray(table), jnp.asarray(kv))
    pallas = j_paged_verify_quant(*jargs, interpret=True)
    oracle = ref.paged_verify_quant_ref(*jargs)
    np.testing.assert_allclose(out, np.asarray(pallas), **TOL)
    np.testing.assert_allclose(out, np.asarray(oracle), **TOL)
    if CASES[case]["T"] == 1:
        dec = ops.paged_decode_quant(_t(q[:, 0]), _t(kq), _t(vq), ks_t,
                                     vs_t, _t(table), _t(kv)).numpy()
        np.testing.assert_array_equal(dec, out[:, 0])
    assert ops.launch_counts() == {k: 0 for k in ops.launch_counts()}


def test_use_kernels_false_and_cuda_tensor_without_card():
    """``use_kernels(False)`` forces the plain version; a kernel wrapper
    given a CPU tensor raises instead of computing anything."""
    from repro_torch.kernels import paged_decode as pd

    q, kp, vp, table, kv = _case(30, **CASES[0])
    args = (_t(q), _t(kp), _t(vp), _t(table), _t(kv))
    ops.use_kernels(False)
    try:
        assert not ops.kernels_active(args[0])
        forced = ops.paged_verify(*args).numpy()
    finally:
        ops.use_kernels(True)
    np.testing.assert_array_equal(forced, ops.paged_verify(*args).numpy())
    with pytest.raises(ValueError, match="CUDA"):
        pd.paged_verify(*args)


def test_build_is_keyed_by_source_and_needs_nvcc(monkeypatch):
    """The library lands in the git-ignored build/kernels/ under a name
    keyed by the source hash; without nvcc the build raises."""
    from pathlib import Path

    from repro_torch.kernels import _build

    root = Path(__file__).resolve().parents[1]
    lib = _build.library_path()
    assert lib.parent == root / "build" / "kernels"
    assert lib.name.startswith("paged_attention_") and lib.suffix == ".so"
    assert "build/" in (root / ".gitignore").read_text().split()
    monkeypatch.setenv("NVCC", "/nonexistent/nvcc")
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setattr(_build.os.path, "isfile", lambda _: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()
