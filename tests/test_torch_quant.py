"""The port's grouped quantization against the JAX package's.

The same numpy weights, drawn from a seed, go through
``repro.quant.grouped`` and ``repro_torch.quant.grouped``. Packed bytes and
bf16 scale bits must be identical (so a layer store written by either
package loads in the other), and the dequantized weights equal exactly:
both sides compute ``q * scale`` in f32 from the same codes. Leaf and
group choices of ``quantize_tree`` and ``quantize_ring_params`` must be
the same too.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import init_params as j_init_params
from repro.quant import grouped as J
from repro.runtime import serve as j_serve
from repro_torch import bridge
from repro_torch.quant import grouped as T
from repro_torch.runtime import serve as t_serve


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


def _bits16(a) -> np.ndarray:
    """bf16 bits of a JAX array or a torch tensor, as uint16."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(a).view(np.uint16)


def _same_quant(jq, tq):
    assert (jq.bits, jq.group, tuple(jq.shape)) == \
        (tq.bits, tq.group, tuple(tq.shape))
    np.testing.assert_array_equal(np.asarray(jq.packed), tq.packed.numpy())
    np.testing.assert_array_equal(_bits16(jq.scale), _bits16(tq.scale))


SHAPES = [((128, 24), 64), ((3, 256, 16), 32), ((64, 8), 16),
          ((2, 2, 128, 40), 64), ((192, 5), 64)]


@pytest.mark.parametrize("bits", [4, 2])
@pytest.mark.parametrize("case", range(len(SHAPES)))
def test_packed_bytes_and_scale_bits_equal_jax(case, bits):
    shape, group = SHAPES[case]
    rng = np.random.default_rng(case)
    w = rng.standard_normal(shape).astype(np.float32)
    w[..., :group, 0] = 0.0            # an all-zero group: the 1e-8 floor
    w[..., 1, 1] = 3.5 * np.abs(w).max()   # amax/7-sized ties round to even
    jq = (J.quantize_q4 if bits == 4 else J.quantize_q2)(jnp.asarray(w),
                                                         group)
    tq = (T.quantize_q4 if bits == 4 else T.quantize_q2)(torch.as_tensor(w),
                                                         group)
    _same_quant(jq, tq)
    jd = (J.dequantize_q4 if bits == 4 else J.dequantize_q2)(jq)
    np.testing.assert_array_equal(T.dequantize_leaf(tq).numpy(),
                                  np.asarray(jd))
    unpack_j = J.unpack_q4 if bits == 4 else J.unpack_q2
    unpack_t = T.unpack_q4 if bits == 4 else T.unpack_q2
    np.testing.assert_array_equal(unpack_t(tq.packed).numpy(),
                                  np.asarray(unpack_j(jq.packed)))


def test_bf16_weights_quantize_alike():
    """A bf16 weight (the serve dtype) quantizes to the same bytes: both
    sides widen it to f32 exactly first."""
    w = np.random.default_rng(9).standard_normal((256, 48)).astype(
        np.float32)
    jw = jnp.asarray(w, jnp.bfloat16)
    tw = torch.as_tensor(w).to(torch.bfloat16)
    np.testing.assert_array_equal(_bits16(jw), _bits16(tw))
    _same_quant(J.quantize_q4(jw, 64), T.quantize_q4(tw, 64))


def test_int8_bit_ops_match_jnp():
    """Packing relies on int8 ``&``, ``<<`` (wrapping) and ``>>``
    (sign-propagating): the same bits as jnp over every int8 value."""
    v = np.arange(-128, 128, dtype=np.int8)
    t, j = torch.as_tensor(v), jnp.asarray(v)
    for f in (lambda a: a & 0xF, lambda a: a << 4, lambda a: a >> 4,
              lambda a: (a >> 4) & 0xF, lambda a: (a & 0xF) | (a << 4)):
        np.testing.assert_array_equal(f(t).numpy(), np.asarray(f(j)))


def test_quantize_rejects_bad_groups():
    with pytest.raises(ValueError, match="multiple of the group"):
        T.quantize_q4(torch.zeros(96, 8), 64)
    with pytest.raises(ValueError, match="4 rows a byte"):
        T.quantize_q2(torch.zeros(18, 8), 2)


@pytest.fixture(scope="module")
def jparams():
    cfg = dataclasses.replace(get_config("qwen2.5-14b").reduced(),
                              n_layers=2)
    return cfg, j_init_params(cfg, jax.random.PRNGKey(0))


def _walk(tree, prefix=""):
    """{path: (bits, group) or None} over a tree of either package."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_walk(v, f"{prefix}{k}/"))
        elif hasattr(v, "packed"):
            out[prefix + k] = (int(v.bits), int(v.group))
        else:
            out[prefix + k] = None
    return out


def _leaf(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


@pytest.mark.parametrize("stacked", [True, False])
@pytest.mark.parametrize("bits", [4, 2])
def test_quantize_tree_picks_same_leaves(jparams, stacked, bits):
    cfg, params = jparams
    tparams = bridge.tree_from_numpy(jax.tree.map(np.asarray, params),
                                     device="cpu")
    src_j = params["blocks"] if stacked else params
    src_t = tparams["blocks"] if stacked else tparams
    jq = J.quantize_tree(src_j, bits=bits, stacked=stacked)
    tq = T.quantize_tree(src_t, bits=bits, stacked=stacked)
    picks = _walk(jq)
    assert _walk(tq) == picks
    assert any(picks.values()) and not all(picks.values())
    for path, pick in picks.items():
        if pick:
            _same_quant(_leaf(jq, path), _leaf(tq, path))


@pytest.mark.parametrize("tp", [1, 16])
def test_quantize_ring_params_picks_same_leaves_and_groups(jparams, tp):
    """At tp=16 the reduced model's w_down (K = 128) cannot keep its
    scale rows divisible by tp at any group, so both packages leave it
    unquantized and name it."""
    cfg, params = jparams
    tparams = bridge.tree_from_numpy(jax.tree.map(np.asarray, params),
                                     device="cpu")
    jq, jskip = j_serve.quantize_ring_params(dict(params), cfg, tp=tp)
    tq, tskip = t_serve.quantize_ring_params(tparams, cfg, tp=tp)
    assert tskip == jskip
    assert _walk(tq["blocks"]) == _walk(jq["blocks"])
    assert ("ffn/w_down (K=128)" in tskip) == (tp == 16)
    for path, pick in _walk(jq["blocks"]).items():
        if pick:
            _same_quant(_leaf(jq["blocks"], path), _leaf(tq["blocks"], path))
    assert set(tq) == set(jq)          # the head passes through


def test_tree_helpers():
    """``map_tree`` slices a stacked ``QuantizedTensor`` and keeps its
    (K, N); ``dequantize_tree`` leaves plain leaves alone; ``nbytes``
    counts the packed footprint."""
    w = torch.randn(3, 128, 16)
    qt = T.quantize_q4(w, 64)
    tree = {"a": {"w": qt, "b": torch.ones(3, 16)}}
    one = T.map_tree(lambda t: t[1], tree)
    assert one["a"]["w"].shape == (128, 16)
    assert one["a"]["w"].packed.shape == (64, 16)
    assert one["a"]["b"].shape == (16,)
    assert qt.nbytes == 3 * 64 * 16 + 3 * 2 * 16 * 2
    deq = T.dequantize_tree(one)
    assert deq["a"]["b"] is one["a"]["b"]
    torch.testing.assert_close(deq["a"]["w"], T.dequantize_q4(qt)[1],
                               rtol=0, atol=0)
    assert [t.shape for t in T.tree_tensors(tree)] == \
        [(3, 16), (3, 64, 16), (3, 2, 16)]
