"""The port's train driver (``python -m repro_torch.launch.train``)
against the JAX package's (``repro.launch.train``), on the CPU, at the
smoke config.

Tolerances, each with its reason:

* per-step losses within 1e-4 relative of the JAX train step's on the
  same weights and batches (f32 on both sides; each step's small
  differences compound through the updates);
* a run cut at step 3 and resumed to 6 equals 6 straight to 1e-6
  relative (the same ops on the same values; the checkpoint is exact);
* a checkpoint written by the JAX loop resumes in the port: the restored
  leaves bit-equal, the next step's loss within 1e-4 of the JAX step's.
"""
import argparse

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config
from repro.data import SyntheticCorpus as JCorpus
from repro.data import batches as j_batches
from repro.launch import train as JT
from repro.models import init_params as j_init_params
from repro.runtime.checkpoint import CheckpointManager as JManager
from repro.runtime.optim import AdamW as JAdamW
from repro.runtime.train import make_train_step as j_make_train_step
from repro_torch import bridge
from repro_torch.launch import train as LT
from repro_torch.runtime.checkpoint import tree_leaves
from test_torch_train import one_torch_thread  # noqa: F401  (autouse)

ARCH = "qwen2.5-14b"
FLAGS = ["--smoke", "--device", "cpu", "--batch", "4", "--seq", "32",
         "--lr", "3e-3"]


def _args(tmp_path, *extra) -> argparse.Namespace:
    return LT.parse_args(FLAGS + ["--ckpt-dir", str(tmp_path)] +
                         list(extra))


def _jax_world(seed=0):
    cfg = get_config(ARCH).reduced()
    params = j_init_params(cfg, jax.random.PRNGKey(seed))
    opt_def = JAdamW(lr=3e-3, warmup_steps=20)
    step = jax.jit(j_make_train_step(cfg, opt_def, grad_dtype=None,
                                     remat=False))
    it = j_batches(JCorpus(vocab=cfg.vocab, seed=seed), 4, 32, seed=seed)
    return cfg, params, opt_def, step, it


def _jax_losses(n, skip=0, state=None):
    cfg, params, opt_def, step, it = _jax_world()
    opt = opt_def.init(params)
    if state is not None:
        params, opt = state
    for _ in range(skip):
        next(it)
    out = []
    for _ in range(n):
        batch = {k: jnp.asarray(v) for k, v in next(it).items()}
        params, opt, m = step(params, opt, batch)
        out.append(float(m["loss"]))
    return out


def test_driver_defaults_to_cuda(tmp_path):
    assert LT.parse_args([]).device == "cuda"
    args = LT.parse_args([])
    assert (args.arch, args.steps, args.batch, args.seq, args.lr,
            args.ckpt_every) == ("qwen2.5-14b", 200, 8, 128, 3e-3, 50)


def test_losses_match_the_jax_step(tmp_path, capsys):
    _, jp, _, _, _ = _jax_world()
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp),
                                  device="cpu")
    res = LT.run(_args(tmp_path, "--steps", "4", "--ckpt-every", "100"),
                 params=tp)
    want = _jax_losses(4)
    np.testing.assert_allclose(res["losses"], want, rtol=1e-4)
    out = capsys.readouterr().out
    assert "arch=qwen2.5-14b-smoke params=" in out
    assert "step     1 loss" in out and "done" in out


def test_resume_equals_straight_run(tmp_path):
    straight = LT.run(_args(tmp_path / "a", "--steps", "6",
                            "--ckpt-every", "100"))
    first = LT.run(_args(tmp_path / "b", "--steps", "3",
                         "--ckpt-every", "3"))
    resumed = LT.run(_args(tmp_path / "b", "--steps", "6",
                           "--ckpt-every", "3", "--resume"))
    assert resumed["start"] == 3 and int(resumed["opt"].step) == 6
    np.testing.assert_allclose(first["losses"] + resumed["losses"],
                               straight["losses"], rtol=1e-6)
    for a, b in zip(tree_leaves(bridge.tree_from_params(straight["params"])),
                    tree_leaves(bridge.tree_from_params(resumed["params"]))):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0, atol=1e-6)


def test_port_resumes_a_jax_checkpoint(tmp_path, capsys):
    JT.main(["--arch", ARCH, "--smoke", "--steps", "3", "--batch", "4",
             "--seq", "32", "--ckpt-every", "3", "--ckpt-dir",
             str(tmp_path)])
    cfg = get_config(ARCH).reduced()
    like = j_init_params(cfg, jax.random.PRNGKey(0))
    step, state = JManager(str(tmp_path)).restore_latest(
        (like, JAdamW().init(like)))
    assert step == 3
    res = LT.run(_args(tmp_path, "--steps", "5", "--ckpt-every", "100",
                       "--resume"))
    assert "resumed from step 3" in capsys.readouterr().out
    np.testing.assert_allclose(res["losses"],
                               _jax_losses(2, skip=3, state=state),
                               rtol=1e-4)
    # the restored leaves are the JAX checkpoint's, bit for bit
    res0 = LT.run(_args(tmp_path, "--steps", "3", "--resume"))
    assert res0["losses"] == []
    got = LT.state_tree(res0["params"], res0["opt"])
    for a, b in zip(jax.tree.leaves(state), tree_leaves(got)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
