"""The port's GSPMD layer across ranks (``runtime.gspmd``) against the
JAX package's ``prefill`` and ``decode_step`` on the same weights.

Eight rank processes (``launch.mesh.RankWorld``: one world a module, gloo
on the CPU, torch on one thread a rank) run
``runtime.gspmd.rank_gspmd_job`` at the (4, 2) ("data", "model") mesh:
each rank cuts its part of the JAX ``init_params`` (carried across by
``bridge``) under ``param_shardings`` (fsdp), prefills its rows of the
seed-made prompts into its part of a fresh cache, then takes 3 greedy
decode steps. The JAX package runs ``prefill`` and ``decode_step`` on
one device. Every family at B = 1 and 2 (which do not split over 4
stages: the batch is replicated over "data") and B = 8, 2 layers (the
hybrid family 3: one of each of its blocks). Held:

  * logits of the prefill and of every step (each batch part's member 0,
    gathered over the vocab shards) within max|d|/max|ref| < 2e-4 of the
    JAX logits (f32 on both sides; the members sum their halves of each
    split product in rank order, where XLA sums the whole), greedy
    tokens equal;
  * after the steps, each rank's cache part within 2e-4 of max|ref| of
    ``local_shard`` of the JAX cache under the spec the JAX
    ``sharding.cache_shardings`` gives at ``jax.make_mesh`` of the same
    shape (``len`` exactly);
  * the replicated activations (x after every layer, the merged
    attention, the final hiddens) equal to the bit across a stage's
    members on every rank;
  * each rank's parameter bytes: exactly its shard of every leaf.

The dense, moe, ssm and vlm families are here; MLA, hybrid, audio, the
(2, 2, 2) pod mesh and the negative control in
``test_torch_gspmd_more.py``.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import model as JM
from repro.runtime import sharding as JS
from repro_torch import bridge
from repro_torch.configs import get_config as t_get_config
from repro_torch.launch.mesh import RankWorld
from repro_torch.runtime import sharding as S

KEY = jax.random.PRNGKey(0)
SP, CTX, STEPS = 5, 32, 3
REL = 2e-4
JOB = "repro_torch.runtime.gspmd:rank_gspmd_job"
NAMES = {2: ("data", "model"), 3: ("pod", "data", "model")}


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


def n_layers(arch):
    return 3 if arch == "recurrentgemma-9b" else 2


def cfgs(arch, **over):
    over.setdefault("n_layers", n_layers(arch))
    return (dataclasses.replace(get_config(arch).reduced(), **over),
            dataclasses.replace(t_get_config(arch).reduced(), **over))


def frontend(cfg, B, seed=2):
    """vlm patch embeddings or whisper's frames (B, F, d), or None."""
    if not cfg.frontend:
        return None
    return np.random.default_rng(seed).standard_normal(
        (B, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def jax_run(jcfg, B):
    """The JAX weights, prompts, frontend inputs, and the reference:
    logits of the prefill and of each decode step, tokens, final cache."""
    jp = JM.init_params(jcfg, KEY)
    prompts = np.random.default_rng(1).integers(
        3, jcfg.vocab, (B, SP)).astype(np.int32)
    em = frontend(jcfg, B)
    cache = JM.init_cache(jcfg, B, CTX, dtype=jnp.float32)
    kw = {} if em is None else {"embeds": jnp.asarray(em)}
    lg, cache = JM.prefill(jp, jcfg, jnp.asarray(prompts), cache, **kw)
    logits = [np.asarray(lg[:, -1:], np.float32)]
    tok = jnp.argmax(lg[:, -1], -1)[:, None].astype(jnp.int32)
    toks = [np.asarray(tok[:, 0])]
    for _ in range(STEPS):
        lg, cache = JM.decode_step(jp, jcfg, cache, tok)
        logits.append(np.asarray(lg, np.float32))
        tok = jnp.argmax(lg[:, -1], -1)[:, None].astype(jnp.int32)
        toks.append(np.asarray(tok[:, 0]))
    return jp, prompts, em, logits, np.stack(toks), cache


def run_gspmd(world, arch, B, shape=(4, 2), **job):
    """Both sides of one case: (JAX reference, the ranks' results, the
    port's tree)."""
    jcfg, tcfg = cfgs(arch)
    jp, prompts, em, logits, toks, jcache = jax_run(jcfg, B)
    tree = bridge.tree_from_numpy(jax.tree.map(np.asarray, jp),
                                  device="cpu")
    names = NAMES[len(shape)]
    mesh = dict(zip(names, shape))
    res = world.run(JOB, cfg=tcfg, n_stages=mesh["data"], tp=mesh["model"],
                    pods=mesh.get("pod", 1), params=tree, steps=STEPS,
                    prompts=prompts, embeds=em, ctx_len=CTX,
                    keep_logits=True, return_cache=True,
                    check_replicated=True, **job)
    return (jcfg, mesh, logits, toks, jcache), res, tree


def rel_err(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def check_logits(ref, res):
    _, _, logits, toks, _ = ref
    for r in res:
        lo, hi = r["rows"]
        assert r["unequal"] == [] and r["replicated"]["x"] > 0
        np.testing.assert_array_equal(r["tokens"], toks[:, lo:hi])
        if r["member"] != 0:
            continue
        assert len(r["logits"]) == STEPS + 1
        for got, want in zip(r["logits"], logits):
            assert rel_err(got, want[lo:hi]) < REL


def _coords(r, mesh):
    at = {"pod": r["pod"], "data": r["stage"], "model": r["member"]}
    return {a: at[a] for a in mesh}


def jax_specs(jcfg, mesh, tree, cache):
    """{path: spec tuple} of the JAX package's cache_shardings and
    param_shardings at ``jax.make_mesh`` of ``mesh``'s shape."""
    jm = jax.make_mesh(tuple(mesh.values()), tuple(mesh))

    def flat(shardings):
        leaves = jax.tree_util.tree_flatten_with_path(shardings)[0]
        return {jax.tree_util.keystr(p): tuple(s.spec) for p, s in leaves}
    return (flat(JS.cache_shardings(jcfg, jm, cache)),
            flat(JS.param_shardings(jcfg, jm, tree)))


def check_cache_and_bytes(ref, res, tree):
    jcfg, mesh, _, _, jcache = ref
    jtree = jax.tree.map(lambda t: np.zeros(t.shape, np.float32), tree)
    cspec, pspec = jax_specs(jcfg, mesh, jtree, jcache)
    want_tree = {p: torch.as_tensor(np.array(a)) for p, a in
                 ((jax.tree_util.keystr(k), v) for k, v in
                  jax.tree_util.tree_flatten_with_path(jcache)[0])}
    for r in res:
        c = _coords(r, mesh)
        assert set(r["cache"]) == set(want_tree)
        for path, got in r["cache"].items():
            want = S.local_shard(want_tree[path], cspec[path], mesh, c)
            want = want.float().numpy() if want.is_floating_point() \
                else want.numpy()
            assert got.shape == want.shape, path
            if path == "['len']":
                np.testing.assert_array_equal(got, want)
            elif np.abs(want).max() > 0:
                assert rel_err(got, want) < REL, path
            else:
                assert np.abs(got).max() == 0, path
        nbytes = sum(S.local_shard(t, pspec[p], mesh, c).numel()
                     * t.element_size()
                     for p, t in S.flatten_with_path(tree))
        assert r["nbytes"] == nbytes


CASES = [(a, B) for a in ("qwen2.5-14b", "mixtral-8x7b", "mamba2-780m",
                          "qwen2-vl-2b") for B in (1, 2, 8)]


@pytest.mark.parametrize("arch,B", CASES,
                         ids=[f"{a}-B{b}" for a, b in CASES])
def test_gspmd_prefill_and_decode_match_jax(world, arch, B):
    ref, res, tree = run_gspmd(world, arch, B)
    check_logits(ref, res)
    check_cache_and_bytes(ref, res, tree)
    # B = 1 and 2 are replicated over "data": every stage holds all rows
    rows = {r["rows"] for r in res}
    assert rows == ({(0, B)} if B < 4 else {(i * 2, i * 2 + 2)
                                           for i in range(4)})
