"""The port's train step across ranks (``runtime.train.RankTrainStep``,
the JAX package's ``jitted_train_step``) against both one-process
``make_train_step``s on the same weights.

Eight rank processes (``launch.mesh.RankWorld``, one world for the
module, gloo on the CPU) run ``runtime.train.rank_train_job``: each cuts
its part of the JAX ``init_params`` (carried across by ``bridge``) under
``param_shardings`` in the ``fsdp`` or ``zero1`` style and takes 2 steps
on seed-made batches (B = 8, S = 6, f32 weights, ``grad_dtype`` f32,
AdamW at lr 1e-3 with one warmup step and weight decay 0.1). The dense,
moe and ssm families at the (4, 2) mesh in both styles, the dense family
at (2, 2, 2) with pods (zero1) and with 2 microbatches (fsdp). Held:

  * each step's loss and gradient norm within 1e-5 relative of the
    port's one-process step and of the JAX step;
  * the parameters after 2 steps, put back together from every rank's
    part (``sharding.assemble``, which also holds the replicas equal),
    within 0.1 lr of both: Adam's update is lr g / (|g| + eps), so an
    element whose gradient is near eps (exactly 0 in exact arithmetic for
    the key bias, whose shift every score of a query shares) moves by a
    sizeable part of lr with any rounding of it; the bound and its
    reason are ``tests/test_torch_train.py``'s. The first moment, where
    that amplification does not enter, within 1e-4 of each leaf's
    max|ref| of the one-process step's (that file's bound for it: the
    ssm's ``a_log`` gradient is five orders under its largest element,
    and the ranks sum it in another order);
  * each moment part's shape: the JAX ``param_shardings`` (fsdp) or
    ``zero1_moment_shardings`` (zero1) part of its leaf;
  * zero1's collectives over "data" a step: one gradient reduce-scatter
    and one parameter all-gather (the forward gathers nothing over it).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import init_params as j_init_params
from repro.runtime import sharding as JS
from repro.runtime.optim import AdamW as JAdamW
from repro.runtime.train import make_train_step as j_make_train_step
from repro_torch import bridge
from repro_torch.configs import get_config as t_get_config
from repro_torch.launch.mesh import RankWorld
from repro_torch.runtime import sharding as S
from repro_torch.runtime.optim import AdamW
from repro_torch.runtime.train import make_train_step

LR, B, SEQ, STEPS = 1e-3, 8, 6, 2
JOB = "repro_torch.runtime.train:rank_train_job"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """This file's tests run torch on one thread (the suite's parallel
    workers would otherwise spin against each other)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world():
    w = RankWorld(8, device="cpu", threads=1, timeout_s=180)
    yield w
    w.close()


def _opts():
    kw = dict(lr=LR, warmup_steps=1, weight_decay=0.1)
    return JAdamW(**kw), AdamW(**kw)


def _batches(cfg):
    rng = np.random.default_rng(3)
    out = []
    for _ in range(STEPS):
        toks = rng.integers(0, cfg.vocab, (B, SEQ + 1)).astype(np.int32)
        out.append({"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    return out


@functools.lru_cache(maxsize=None)
def references(arch, microbatch):
    """The JAX and the port's one-process steps: (configs, the JAX
    weights, batches, each side's metrics per step, parameters and first
    moment after the steps)."""
    jcfg = dataclasses.replace(get_config(arch).reduced(), n_layers=2)
    tcfg = dataclasses.replace(t_get_config(arch).reduced(), n_layers=2)
    jp = j_init_params(jcfg, jax.random.PRNGKey(0))
    batches = _batches(jcfg)
    jopt, opt = _opts()
    jstep = jax.jit(j_make_train_step(jcfg, jopt, grad_dtype="float32",
                                      microbatch=microbatch))
    p, st, jm = jp, jopt.init(jp), []
    for b in batches:
        p, st, m = jstep(p, st, jax.tree.map(jnp.asarray, b))
        jm.append({k: float(v) for k, v in m.items()})
    jax_after = jax.tree.map(np.asarray, p)
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp),
                                  device="cpu")
    step = make_train_step(tcfg, opt, grad_dtype="float32",
                           microbatch=microbatch)
    tst, tm = opt.init(list(tp.parameters())), []
    for b in batches:
        tp, tst, m = step(tp, tst, {k: torch.from_numpy(v)
                                    for k, v in b.items()})
        tm.append({k: float(v) for k, v in m.items()})
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jp, batches=batches, jm=jm,
                tm=tm, jax_after=jax_after,
                port_after=bridge.tree_from_params(tp),
                port_mu=bridge.opt_state_tree(tp, tst).mu)


def _flat(tree):
    return dict(S.flatten_with_path(tree))


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def _jax_specs(jcfg, mesh, like, style):
    jm = jax.make_mesh(tuple(mesh.values()), tuple(mesh))
    sh = JS.param_shardings(jcfg, jm, like, style=style)
    mu = sh if style == "fsdp" else \
        JS.zero1_moment_shardings(jcfg, jm, like)

    def flat(t):
        return {jax.tree_util.keystr(p): tuple(s.spec) for p, s in
                jax.tree_util.tree_flatten_with_path(t)[0]}
    return flat(sh), flat(mu)


def _assemble(res, mesh, key, path, spec):
    parts = {}
    for r in res:
        at = {"pod": r["pod"], "data": r["stage"], "model": r["member"]}
        parts[tuple(at[a] for a in mesh)] = torch.from_numpy(r[key][path])
    return S.assemble(parts, spec, mesh).numpy()


def run_case(world, arch, style, shape, microbatch=None):
    ref = references(arch, microbatch)
    mesh = dict(zip(("pod", "data", "model")[-len(shape):], shape))
    tree = bridge.tree_from_numpy(jax.tree.map(np.asarray, ref["jp"]),
                                  device="cpu")
    _, opt = _opts()
    res = world.run(JOB, cfg=ref["tcfg"], n_stages=mesh["data"],
                    tp=mesh["model"], pods=mesh.get("pod", 1), params=tree,
                    batches=ref["batches"], style=style, optimizer=opt,
                    microbatch=microbatch, grad_dtype="float32")
    for r in res:
        assert r["metrics"] == res[0]["metrics"]       # equal on every rank
    for s in range(STEPS):
        got = res[0]["metrics"][s]
        for want in (ref["tm"][s], ref["jm"][s]):
            assert got["step"] == want["step"] == s + 1
            for k in ("loss", "grad_norm"):
                assert got[k] == pytest.approx(want[k], rel=1e-5), (s, k)
    like = jax.tree.map(lambda t: np.zeros(t.shape, np.float32), tree)
    pspec, mspec = _jax_specs(ref["jcfg"], mesh, like, style)
    port, jaxp = _flat(ref["port_after"]), _flat(ref["jax_after"])
    port_mu = _flat(ref["port_mu"])
    for path in port:
        got = _assemble(res, mesh, "params", path, pspec[path])
        for want in (port[path].numpy(), jaxp[path]):
            assert np.abs(got - want).max() <= 0.1 * LR, path
        mu = _assemble(res, mesh, "mu", path, mspec[path])
        want = port_mu[path].numpy()
        assert np.abs(mu - want).max() <= 1e-4 * np.abs(want).max(), path
        part = S.local_shard(torch.zeros(want.shape), mspec[path], mesh,
                             {a: 0 for a in mesh})
        assert all(r["mu"][path].shape == tuple(part.shape) for r in res)
    return res


CASES = [(a, s) for a in ("qwen2.5-14b", "mixtral-8x7b", "mamba2-780m")
         for s in ("fsdp", "zero1")]


@pytest.mark.parametrize("arch,style", CASES,
                         ids=[f"{a}-{s}" for a, s in CASES])
def test_train_step_across_ranks_matches_both(world, arch, style):
    res = run_case(world, arch, style, (4, 2))
    if style == "zero1":
        for r in res:
            for counts in r["collectives"]:
                assert counts["reduce-scatter[data]"]["count"] == 1
                assert counts["all-gather[data]"]["count"] == 1
    else:
        # fsdp gathers each layer's sharded leaves over "data" in the
        # forward and reduce-scatters their gradients in the backward
        c = res[0]["collectives"][0]
        assert c["all-gather[data]"]["count"] > 1
        assert c["reduce-scatter[data]"]["count"] == \
            c["all-gather[data]"]["count"]


def test_zero1_on_the_pod_mesh(world):
    res = run_case(world, "qwen2.5-14b", "zero1", (2, 2, 2))
    c = res[0]["collectives"][0]
    assert c["reduce-scatter[data]"]["count"] == 1
    assert c["all-gather[data]"]["count"] == 1
    assert c["all-reduce[pod]"]["count"] >= 1          # gradients over pods


def test_fsdp_with_microbatches(world):
    run_case(world, "qwen2.5-14b", "fsdp", (4, 2), microbatch=4)


@pytest.mark.parametrize("style", ["fsdp", "zero1"])
def test_rank_side_comparison_with_a_one_step_reference(world, style):
    """``runtime.train.reference_diffs``, which the card's check of a full
    width step reads (the ranks compare their own parts, so a large
    model's parts need not travel back): against one step of the port's
    one-process ``make_train_step`` (no weight decay, so the first moment
    is (1 - b1) g and the update lr g / (|g| + eps)) its numbers equal
    the ones the assembled parts give, the first moment of every leaf is
    within 1e-4 of its max|ref| and no parameter is beyond 0.1 lr. Then
    a reference moved by 0.5 lr at the embedding's largest gradient and
    a first moment scaled by 1 + 1e-3 in the head: exactly that element
    is reported, with its |g| in units of eps, and only the head's first
    moment is beyond 1e-4."""
    ref = references("qwen2.5-14b", None)
    opt = AdamW(lr=LR, warmup_steps=1)
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, ref["jp"]),
                                  device="cpu")
    step = make_train_step(ref["tcfg"], opt, grad_dtype="float32")
    batch = ref["batches"][0]
    tp, st, _ = step(tp, opt.init(list(tp.parameters())),
                     {k: torch.from_numpy(v) for k, v in batch.items()})
    after_tree = _clone(bridge.tree_from_params(tp))
    mu_tree = _clone(bridge.opt_state_tree(tp, st).mu)
    after, mu = _flat(after_tree), _flat(mu_tree)
    tree = bridge.tree_from_numpy(jax.tree.map(np.asarray, ref["jp"]),
                                  device="cpu")
    mesh = {"data": 4, "model": 2}
    like = jax.tree.map(lambda t: np.zeros(t.shape, np.float32), ref["jp"])
    pspec, mspec = _jax_specs(ref["jcfg"], mesh, like, style)

    def run(reference):
        return world.run(JOB, cfg=ref["tcfg"], n_stages=4, tp=2,
                         params=tree, batches=[batch], style=style,
                         optimizer=opt, grad_dtype="float32",
                         reference=reference)
    res = run((after_tree, mu_tree))
    worst = 0.0
    for path in after:
        got = _assemble(res, mesh, "params", path, pspec[path])
        worst = max(worst, float(np.abs(got - after[path].numpy()).max()))
        m = _assemble(res, mesh, "mu", path, mspec[path])
        want = mu[path].numpy()
        d = max(r["mu_diff"][path][0] for r in res)
        top = max(r["mu_diff"][path][1] for r in res)
        assert d == float(np.abs(m - want).max()), path
        assert top == float(np.abs(want).max()), path
        assert d <= 1e-4 * top, path
    assert max(r["max_param_diff"] for r in res) == worst
    assert worst <= 0.1 * LR
    assert all(r["param_over"] == {} for r in res)

    emb = next(p for p in after if "embed" in p and "un" not in p)
    head = next(p for p in after if "unembed" in p)
    at = np.unravel_index(int(mu[emb].abs().argmax()), mu[emb].shape)
    moved, scaled = _clone(after_tree), _clone(mu_tree)
    _flat(moved)[emb][at] += 0.5 * LR
    _flat(scaled)[head].mul_(1 + 1e-3)
    res = run((moved, scaled))
    over = [r["param_over"] for r in res if r["param_over"]]
    assert [list(o) for o in over] == [[emb]]
    o = over[0][emb]
    g_eps = float(mu[emb][at].abs()) / ((1 - opt.b1) * opt.eps)
    assert o["n"] == 1 and o["max_lr"] == pytest.approx(0.5, rel=1e-3)
    assert o["g_eps"] == o["g_eps_max"] == pytest.approx(g_eps, rel=1e-6)
    assert g_eps >= 99                # a clear gradient: the clear check
    assert max(r["max_param_diff_clear"] for r in res) >= 0.4 * LR
    far = {p for p in mu if max(r["mu_diff"][p][0] for r in res)
           > 1e-4 * max(r["mu_diff"][p][1] for r in res)}
    assert far == {head}
