"""The port's training path (``runtime.train``: ``lm_loss``,
``make_train_step``) against the JAX package's, on the CPU, one reduced
config of each family at 2 layers in f32 (recurrentgemma-9b at 4: one
group of its 3-block pattern and a tail layer).

Tolerances, each with its reason:

* the loss within 1e-5 relative and every gradient leaf within 1e-4 of
  that leaf's max|ref| (f32 on both sides; the port's no-cache forward
  sums attention, the MoE gather and the SSD scan in the reference's
  order but not XLA's fusions); a leaf whose JAX gradient is 0 is 0 in
  the port;
* a train step: loss within 1e-5 relative; the gradient norm within
  1e-5 relative with ``grad_dtype=None``, within one bf16 ulp (2^-8) with
  ``"bfloat16"`` (an element's rounding may flip); the first moment, the
  clipped gradient over 10, within 1e-4 of each leaf's max|ref| (one
  bf16 ulp, 2^-7, with ``"bfloat16"``); every parameter within 0.1 lr of
  the JAX step's (Adam's first update is g / (|g| + eps) times lr: an
  element whose gradient is near eps = 1e-8 moves by a sizeable part of
  lr with any rounding of that gradient; the optimizer alone is held to
  1e-6 in ``tests/test_torch_optim_ckpt.py``);
* microbatch against full batch, the mirrored
  ``tests/test_models.py::test_grad_accumulation_equivalence``: its
  bounds (loss 1e-5 relative, parameters 5e-5);
* remat on and off, and B6's ``autograd.Function`` against autograd
  through ``ssd_chunked``: equal to 1e-6 of max|ref| (the same ops on
  the same inputs, recomputed).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import init_params as j_init_params
from repro.runtime.optim import AdamW as JAdamW
from repro.runtime.train import lm_loss as j_lm_loss
from repro.runtime.train import make_train_step as j_make_train_step
from repro_torch import bridge
from repro_torch.configs import get_config as t_get_config
from repro_torch.kernels import flash_decode as _fd
from repro_torch.kernels import ops
from repro_torch.kernels import paged_decode as _pd
from repro_torch.kernels import paged_prefill as _pp
from repro_torch.kernels import q4_matmul as _q4
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.quant.grouped import quantize_q4
from repro_torch.runtime.checkpoint import tree_leaves
from repro_torch.runtime.optim import AdamW
from repro_torch.runtime.train import (lm_loss, make_train_step,
                                       make_trainable)

CPU = torch.device("cpu")
FAMILIES = ["qwen2.5-14b", "mixtral-8x7b", "minicpm3-4b", "qwen2-vl-2b",
            "mamba2-780m", "recurrentgemma-9b", "whisper-tiny"]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Each test of this file runs torch on one thread: under the test
    runner's parallel workers, torch's default of a thread a core has
    every worker's threads spin against the others' (a 10 s case took
    150-230 s), and these shapes gain nothing from more threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, n_layers=None):
    n = n_layers or (4 if arch == "recurrentgemma-9b" else 2)
    return (dataclasses.replace(get_config(arch).reduced(), n_layers=n),
            dataclasses.replace(t_get_config(arch).reduced(), n_layers=n))


def _batch(cfg, B=2, S=16, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.frontend:
        out["embeds"] = (rng.standard_normal(
            (B, cfg.n_frontend_tokens, cfg.d_model)) * 0.02).astype(
                np.float32)
    return out


def _world(arch, n_layers=None):
    jcfg, tcfg = _cfgs(arch, n_layers)
    jp = j_init_params(jcfg, jax.random.PRNGKey(0))
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), device=CPU)
    return jcfg, tcfg, jp, tp


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _close_leaves(want_tree, got_tree, tol):
    want = [np.asarray(a) for a in jax.tree.leaves(want_tree)]
    got = [t.detach().float().numpy() for t in tree_leaves(got_tree)]
    assert len(want) == len(got)
    for a, b in zip(want, got):
        assert a.shape == b.shape
        m = float(np.abs(a).max())
        if m == 0:
            assert float(np.abs(b).max()) == 0
        else:
            assert float(np.abs(a - b).max()) <= tol * m


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_grads_match_jax(arch):
    jcfg, tcfg, jp, tp = _world(arch)
    batch = _batch(jcfg)
    emb = batch.get("embeds")

    def jl(p):
        return j_lm_loss(p, jcfg, jnp.asarray(batch["tokens"]),
                         jnp.asarray(batch["labels"]),
                         embeds=None if emb is None else jnp.asarray(emb))
    want, jg = jax.jit(jax.value_and_grad(jl))(jp)
    make_trainable(tp)
    tb = _t(batch)
    loss = lm_loss(tp, tcfg, tb["tokens"], tb["labels"],
                   embeds=tb.get("embeds"))
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(want), rel=1e-5)
    _close_leaves(jg, bridge.grads_tree(tp), 1e-4)


@pytest.mark.parametrize("grad_dtype", [None, "bfloat16"],
                         ids=["f32", "bf16"])
def test_train_step_matches_jax(grad_dtype):
    jcfg, tcfg, jp, tp = _world("qwen2.5-14b")
    batch = _batch(jcfg, seed=1)
    jopt = JAdamW(lr=1e-3, warmup_steps=1)
    jstep = jax.jit(j_make_train_step(jcfg, jopt, grad_dtype=grad_dtype))
    jp2, jst, jm = jstep(jp, jopt.init(jp), jax.tree.map(jnp.asarray, batch))
    opt = AdamW(lr=1e-3, warmup_steps=1)
    step = make_train_step(tcfg, opt, grad_dtype=grad_dtype)
    tp, st, m = step(tp, opt.init(list(tp.parameters())), _t(batch))
    assert int(m["step"]) == int(jm["step"]) == 1
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    rel = 1e-5 if grad_dtype is None else 2.0 ** -8
    assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                  rel=rel)
    _close_leaves(jst.mu, bridge.opt_state_tree(tp, st).mu,
                  1e-4 if grad_dtype is None else 2.0 ** -7)
    worst = max(float(np.abs(np.asarray(a) - b.numpy()).max()) for a, b in
                zip(jax.tree.leaves(jp2),
                    tree_leaves(bridge.tree_from_params(tp))))
    assert worst <= 0.1 * 1e-3, worst


def test_grad_accumulation_equivalence():
    _, cfg = _cfgs("minitron-8b")
    gen = torch.Generator().manual_seed(0)
    params = TM.init_params(cfg, gen, device=CPU)
    opt_def = AdamW(lr=1e-3)
    batch = _t(_batch(cfg, B=8, S=16, seed=2))
    full = make_train_step(cfg, opt_def, grad_dtype=None, remat=False)
    micro = make_train_step(cfg, opt_def, grad_dtype=None, remat=False,
                            microbatch=2)
    p0 = bridge.tree_from_params(params, leaf=lambda t: t.detach().clone())
    p1, _, m1 = full(params, opt_def.init(list(params.parameters())), batch)
    t1 = bridge.tree_from_params(p1, leaf=lambda t: t.detach().clone())
    bridge.load_params_tree(params, p0)
    p2, _, m2 = micro(params, opt_def.init(list(params.parameters())), batch)
    t2 = bridge.tree_from_params(p2)
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), rel=1e-5)
    diff = max(float((a - b).abs().max())
               for a, b in zip(tree_leaves(t1), tree_leaves(t2)))
    assert diff < 5e-5, diff


def test_microbatch_matches_jax():
    jcfg, tcfg, jp, tp = _world("qwen2.5-14b")
    batch = _batch(jcfg, B=4, seed=3)
    jopt = JAdamW(lr=1e-3)
    jstep = jax.jit(j_make_train_step(jcfg, jopt, grad_dtype=None,
                                      remat=False, microbatch=2))
    jp2, jst, jm = jstep(jp, jopt.init(jp), jax.tree.map(jnp.asarray,
                                                         batch))
    opt = AdamW(lr=1e-3)
    step = make_train_step(tcfg, opt, grad_dtype=None, remat=False,
                           microbatch=2)
    tp, st, m = step(tp, opt.init(list(tp.parameters())), _t(batch))
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                  rel=1e-5)
    _close_leaves(jst.mu, bridge.opt_state_tree(tp, st).mu, 1e-4)


@pytest.mark.parametrize("arch", ["qwen2.5-14b", "mamba2-780m"])
def test_remat_on_and_off(arch):
    _, cfg = _cfgs(arch)
    gen = torch.Generator().manual_seed(1)
    params = TM.init_params(cfg, gen, device=CPU)
    leaves = make_trainable(params)
    batch = _t(_batch(cfg, seed=4))
    grads = {}
    for remat in (False, True):
        loss = lm_loss(params, cfg, batch["tokens"], batch["labels"],
                       remat=remat)
        grads[remat] = (float(loss.detach()),
                        torch.autograd.grad(loss, leaves))
    assert grads[True][0] == pytest.approx(grads[False][0], rel=1e-6)
    for a, b in zip(grads[False][1], grads[True][1]):
        assert float((a - b).abs().max()) <= 1e-6 * float(a.abs().max())


def test_loss_decreases_dense():
    """``tests/test_models.py::test_loss_decreases_dense``, mirrored."""
    _, cfg = _cfgs("qwen2.5-14b")
    params = TM.init_params(cfg, torch.Generator().manual_seed(0),
                            device=CPU)
    opt_def = AdamW(lr=3e-3, warmup_steps=5)
    opt = opt_def.init(list(params.parameters()))
    step = make_train_step(cfg, opt_def, grad_dtype=None, remat=False)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, 64, (4, 33)).astype(np.int32))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    losses = []
    for _ in range(25):
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] * 0.7, losses[:3] + losses[-3:]


def test_quantized_leaf_refused():
    _, cfg = _cfgs("qwen2.5-14b")
    params = TM.init_params(cfg, torch.Generator().manual_seed(0),
                            device=CPU)
    ffn = params.blocks[0].ffn
    params.blocks[0].ffn = TM.GLU(ffn.w_gate, quantize_q4(ffn.w_up.detach()),
                                  ffn.w_down)
    with pytest.raises(ValueError, match="QuantizedTensor"):
        make_trainable(params)
    step = make_train_step(cfg, AdamW(), grad_dtype=None)
    batch = _t(_batch(cfg))
    with pytest.raises(ValueError, match="QuantizedTensor"):
        step(params, AdamW().init(list(params.parameters())), batch)


# --------------------------------------------------------------------------- #
#  B6 under autograd, and the kernels that have no backward
# --------------------------------------------------------------------------- #

def _ssd_inputs(seed=0, B=2, S=40, nh=3, P=4, N=8):
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.standard_normal((B, S, nh, P)), dtype=torch.float32)
    dt = torch.tensor(np.log1p(np.exp(rng.standard_normal((B, S, nh)))),
                      dtype=torch.float32)
    A = -torch.tensor(np.exp(rng.standard_normal(nh)), dtype=torch.float32)
    Bm = torch.tensor(rng.standard_normal((B, S, N)), dtype=torch.float32)
    Cm = torch.tensor(rng.standard_normal((B, S, N)), dtype=torch.float32)
    return [t.requires_grad_(True) for t in (x, dt, A, Bm, Cm)]


def _plain_scan(x, dt, A, Bm, Cm, *, chunk):
    """A stand-in for the kernel: the plain scan's values, no graph."""
    with torch.no_grad():
        return TL.ssd_chunked(x, dt, A, Bm, Cm, chunk=chunk)


@pytest.mark.parametrize("outputs", ["y_and_h", "y_only"])
def test_ssd_autograd_function_matches_plain(outputs):
    ins = _ssd_inputs()
    rng = np.random.default_rng(5)
    want_out = TL.ssd_chunked(*ins, chunk=16)
    got_out = _ssd.SSDScan.apply(_plain_scan, *ins, 16)
    assert got_out[0].grad_fn is not None
    cot = [torch.tensor(rng.standard_normal(o.shape), dtype=torch.float32)
           for o in want_out]
    n = 2 if outputs == "y_and_h" else 1

    def vjp(out):
        return torch.autograd.grad([o for o in out[:n]], ins, cot[:n])
    for a, b in zip(vjp(want_out), vjp(got_out)):
        assert float((a - b).abs().max()) <= 1e-6 * float(a.abs().max())


def test_ssd_scan_on_the_kernel_route_keeps_the_gradient(monkeypatch):
    """``ops.ssd_scan`` on the kernel's route (the kernel stood in for by
    a graph-free plain scan) returns outputs with a ``grad_fn`` whose
    gradients equal the plain path's, and counts no launch of its own."""
    ins = _ssd_inputs(seed=1)
    want = torch.autograd.grad(TL.ssd_chunked(*ins)[0].sum(), ins)
    monkeypatch.setattr(ops, "kernels_active", lambda t: True)
    monkeypatch.setattr(_ssd, "ssd_scan", _plain_scan)
    y, _ = ops.ssd_scan(*ins)
    got = torch.autograd.grad(y.sum(), ins)
    for a, b in zip(want, got):
        assert float((a - b).abs().max()) <= 1e-6 * float(a.abs().max())


def _refuse(*a, **k):
    raise AssertionError("the kernel was launched")


#: a case -> (the kernel's module, the kernel's name there, the ``ops``
#: wrapper, its arguments from ``q`` as (args, keywords))
WRAPPERS = {
    "q4_matmul": (_q4, "q4_matmul", "q4_matmul", lambda q: ((
        q[0, 0], torch.zeros((8, 4), dtype=torch.int8),
        torch.zeros((1, 4))), {})),
    "flash_verify": (_fd, "flash_verify", "flash_verify", lambda q: ((
        q, q, q, torch.tensor([4])), {})),
    "flash_verify_scale_by_keyword": (
        _fd, "flash_verify", "flash_verify", lambda q: ((
            q.detach(), q.detach(), q.detach(), torch.tensor([4])),
            {"k_scale": q[0, ..., 0], "v_scale": q[0, ..., 0]})),
    "flash_decode": (_fd, "flash_verify", "flash_decode", lambda q: ((
        q[:, 0], q, q, torch.tensor([4])), {})),
    "paged_verify": (_pd, "paged_verify", "paged_verify", lambda q: ((
        q, q[0], q[0], torch.zeros((1, 1), dtype=torch.int32),
        torch.tensor([4])), {})),
    "paged_prefill": (_pp, "paged_prefill", "paged_prefill", lambda q: ((
        q, q[0], q[0], torch.zeros((1, 1), dtype=torch.int32),
        torch.tensor([4])), {})),
    "paged_verify_quant": (
        _pd, "paged_verify_quant", "paged_verify_quant", lambda q: ((
            q, q[0], q[0], q[0, ..., 0], q[0, ..., 0],
            torch.zeros((1, 1), dtype=torch.int32), torch.tensor([4])),
            {})),
}


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_kernel_wrapper_refuses_an_input_that_requires_grad(monkeypatch,
                                                            name):
    mod, attr, wrapper, args = WRAPPERS[name]
    fn = getattr(ops, wrapper)
    monkeypatch.setattr(ops, "kernels_active", lambda t: True)
    monkeypatch.setattr(mod, attr, _refuse)
    q = torch.zeros((1, 4, 2, 16), requires_grad=True)
    a, kw = args(q)
    with pytest.raises(RuntimeError, match="no backward"):
        fn(*a, **kw)
    launched = []
    monkeypatch.setattr(mod, attr, lambda *a, **k: launched.append(1)
                        or torch.zeros((1, 1, 2, 16)))
    with torch.no_grad():
        fn(*a, **kw)
    a, kw = args(q.detach())
    fn(*a, **kw)
    assert launched == [1, 1]
