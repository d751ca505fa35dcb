"""The port's AdamW and checkpoints against the JAX package's
(``repro.runtime.optim``, ``repro.runtime.checkpoint``), on the CPU.

Tolerances, each with its reason:

* AdamW: f32 leaves and every moment within 1e-6 of the JAX optimizer's
  over 5 steps (f32 on both sides; the same ops in the same order, which
  XLA may fuse and round differently); a bf16 leaf within one bf16 ulp
  (the f32 update is cast back, and an update a rounding away from a
  bf16 boundary may round either way); ``global_norm`` within 1e-6
  relative;
* checkpoints: bit-equal, in both directions (the same npz layout).
"""
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import init_params as j_init_params
from repro.runtime import checkpoint as JC
from repro.runtime.optim import AdamW as JAdamW
from repro.runtime.optim import global_norm as j_global_norm
from repro_torch import bridge
from repro_torch.launch import train as LT
from repro_torch.runtime import checkpoint as C
from repro_torch.runtime.optim import AdamState, AdamW, global_norm
from test_torch_train import one_torch_thread  # noqa: F401  (autouse)

CPU = torch.device("cpu")
OPT = dict(lr=1e-2, weight_decay=0.1, clip_norm=0.5, warmup_steps=3)


def _tree(rng):
    return {"w": rng.standard_normal((6, 5)).astype(np.float32),
            "b": {"v": rng.standard_normal((7,)).astype(np.float32),
                  "h": rng.standard_normal((4, 3)).astype(ml_dtypes.bfloat16)}}


def _t(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _np(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def test_adamw_matches_jax_over_five_steps():
    rng = np.random.default_rng(0)
    jp = jax.tree.map(jnp.asarray, _tree(rng))
    jopt_def = JAdamW(**OPT)
    jst = jopt_def.init(jp)
    tp = [_t(a) for a in jax.tree.leaves(jp)]
    opt_def = AdamW(**OPT)
    st = opt_def.init(tp)
    for _ in range(5):
        # gradients large enough that clipping is in play every step
        g = jax.tree.map(lambda a: jnp.asarray(
            rng.standard_normal(a.shape) * 3.0, a.dtype), jp)
        assert float(j_global_norm(g)) > OPT["clip_norm"]
        jp, jst = jopt_def.update(g, jst, jp)
        tp, st = opt_def.update([_t(a) for a in jax.tree.leaves(g)], st, tp)
    assert int(st.step) == int(jst.step) == 5
    for a, b in zip(jax.tree.leaves(jp), tp):
        if b.dtype == torch.bfloat16:
            ulp = np.abs(np.asarray(a, np.float32)) * 2.0 ** -7 + 1e-30
            assert (np.abs(np.asarray(a, np.float32) - b.float().numpy())
                    <= ulp).all()
        else:
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                       atol=1e-6)
    for ja, ta in ((jst.mu, st.mu), (jst.nu, st.nu)):
        for a, b in zip(jax.tree.leaves(ja), ta):
            assert b.dtype == torch.float32
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                       atol=1e-6)


def test_global_norm_and_schedule_match_jax():
    rng = np.random.default_rng(1)
    tree = _tree(rng)
    want = float(j_global_norm(jax.tree.map(jnp.asarray, tree)))
    got = float(global_norm([_t(a) for a in jax.tree.leaves(tree)]))
    assert got == pytest.approx(want, rel=1e-6)
    j, t = JAdamW(**OPT), AdamW(**OPT)
    for s in (0, 1, 2, 3, 7):
        assert float(t.schedule(torch.tensor(s, dtype=torch.int32))) == \
            pytest.approx(float(j.schedule(jnp.asarray(s, jnp.int32))),
                          rel=1e-7)


# --------------------------------------------------------------------------- #
#  the JAX package's checkpoint tests, mirrored
# --------------------------------------------------------------------------- #

TREE = {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
        "b": {"c": torch.ones((2,), dtype=torch.bfloat16),
              "d": torch.tensor(3, dtype=torch.int32)}}


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def test_roundtrip(tmp_path):
    p = C.save(str(tmp_path / "x.npz"), TREE, step=7)
    out = C.restore(p, _map(torch.zeros_like, TREE))
    for a, b in zip(C.tree_leaves(TREE), C.tree_leaves(out)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.float().numpy(), b.float().numpy())
    assert C.read_step(p) == 7


def test_shape_mismatch_rejected(tmp_path):
    p = C.save(str(tmp_path / "x.npz"), TREE)
    bad = dict(TREE)
    bad["a"] = torch.zeros((4, 4))
    with pytest.raises(ValueError):
        C.restore(p, bad)


def test_leaf_count_mismatch_rejected(tmp_path):
    p = C.save(str(tmp_path / "x.npz"), TREE)
    with pytest.raises(ValueError):
        C.restore(p, {"a": TREE["a"]})


def test_no_tmp_residue(tmp_path):
    C.save(str(tmp_path / "x.npz"), TREE)
    assert [f for f in os.listdir(tmp_path) if f.endswith(".tmp")] == []


def test_manager_rotation_and_resume(tmp_path):
    mgr = C.CheckpointManager(str(tmp_path), keep=2)
    assert mgr.latest() is None
    for s in (1, 2, 3, 4):
        mgr.save(s, _map(lambda x, s=s: x + s, TREE))
    assert mgr.all_steps() == [3, 4]         # rotated
    step, out = mgr.restore_latest(_map(torch.zeros_like, TREE))
    assert step == 4
    np.testing.assert_allclose(out["a"].numpy(), TREE["a"].numpy() + 4)


# --------------------------------------------------------------------------- #
#  across the two packages: (params, AdamState), f32 and bf16 leaves
# --------------------------------------------------------------------------- #

def _state(dtype):
    """A reduced qwen2.5-14b (2 layers) with ``dtype`` weights and the
    f32 AdamW state after one JAX update, in both packages."""
    import dataclasses
    cfg = dataclasses.replace(get_config("qwen2.5-14b").reduced(),
                              n_layers=2)
    jp = j_init_params(cfg, jax.random.PRNGKey(0), dtype=dtype)
    opt = JAdamW(lr=1e-3)
    keys = iter(jax.random.split(jax.random.PRNGKey(1), 64))
    grads = jax.tree.map(lambda a: jax.random.normal(next(keys), a.shape,
                                                     a.dtype), jp)
    jp, jst = opt.update(grads, opt.init(jp), jp)
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), device=CPU,
                                  dtype=torch.float32 if dtype == jnp.float32
                                  else torch.bfloat16)
    return jp, jst, tp


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
def test_checkpoints_cross_packages_bit_equal(tmp_path, dtype):
    jp, jst, tp = _state(dtype)
    tst = bridge.opt_state_from_tree(tp, jax.tree.map(np.asarray, jst),
                                     AdamState)
    # the port writes, the JAX package restores
    C.save(str(tmp_path / "port.npz"), LT.state_tree(tp, tst), step=1)
    like = jax.tree.map(jnp.zeros_like, (jp, jst))
    got = JC.restore(str(tmp_path / "port.npz"), like)
    want = jax.tree.leaves((jp, jst))
    assert len(jax.tree.leaves(got)) == len(want)
    for a, b in zip(want, jax.tree.leaves(got)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(_bits(a), _bits(b))
    assert JC.read_step(str(tmp_path / "port.npz")) == 1
    # the JAX package writes, the port restores
    JC.save(str(tmp_path / "jax.npz"), (jp, jst), step=1)
    tree = C.restore(str(tmp_path / "jax.npz"), LT.state_like(tp))
    for a, b in zip(want, C.tree_leaves(tree)):
        assert tuple(b.shape) == a.shape
        np.testing.assert_array_equal(_bits(a), _bits(_np(b)))


def test_corrupted_member_refused(tmp_path):
    """The checkpoint reads back through ``np.load`` and ``zipfile``'s
    own check, and a flipped byte in a leaf is refused on restore."""
    import zipfile

    tree = {"w": torch.randn(50, 40), "s": torch.tensor(2.5)}
    p = C.save(str(tmp_path / "x.npz"), tree, step=1)
    with np.load(p) as data:
        np.testing.assert_array_equal(data["leaf_00001"], tree["w"].numpy())
    with zipfile.ZipFile(p) as zf:
        assert zf.testzip() is None
        info = zf.getinfo("leaf_00001.npy")
    raw = bytearray(open(p, "rb").read())
    raw[info.header_offset + 200] ^= 0xFF            # inside w's data
    open(p, "wb").write(bytes(raw))
    with pytest.raises(zipfile.BadZipFile, match="CRC"):
        C.restore(p, tree)
