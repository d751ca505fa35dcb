"""The port's ring across ranks against the JAX package's
``build_ring_serve_step`` at the same mesh.

Eight rank processes (``launch.mesh.RankWorld``: spawned once for the
module, gloo on the CPU, torch on one thread a rank) run
``runtime.serve.rank_ring_job`` for each case: each rank reads its part
of a layer store written from the JAX package's weights (carried across
by ``bridge``) and of the cache the JAX package prefilled, then decodes
greedily. The JAX ring runs over ``jax.make_mesh`` of the same shape on
the same weights and cache. Every step's logits (rank (pod, 0, 0)'s,
gathered over its vocab shards) must be within 2e-4 of max|ref| and the
greedy tokens equal; the replicated activations (x after every layer,
the merged attention, the final hiddens) equal to the bit across each
stage's members; and each rank must hold exactly its own bytes: its part,
by the ring's specs, of every leaf of the ring-ordered model.

Cases of ``tests/test_ring_distributed.py``: dense at k 1 and 2, moe,
the rolling SWA buffer, MLA, layer padding and the multi-pod (2, 2, 2)
mesh here; ssm, the int8 cache, M-RoPE, the verify pass at T = 4 (dense
and MLA), q4 ring params and the negative control in
``test_torch_ring_ranks_more.py``, beside the driver's ranks and the
pieces (the merge, the masked write, the greedy argmax over shards).
"""
import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import init_cache, init_params, prefill
from repro.runtime import serve as JS
from repro_torch import bridge
from repro_torch.configs import get_config as t_get_config
from repro_torch.launch.mesh import RankWorld
from repro_torch.runtime import serve as RS
from repro_torch.runtime import sharding as S
from repro_torch.runtime.paramstore import save_param_store

KEY = jax.random.PRNGKey(0)
B, SP, CTX = 8, 5, 32
REL = 2e-4
JOB = "repro_torch.runtime.serve:rank_ring_job"


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


def _cfgs(arch, n_layers=8, **over):
    j = dataclasses.replace(get_config(arch).reduced(), n_layers=n_layers,
                            **over)
    t = dataclasses.replace(t_get_config(arch).reduced(), n_layers=n_layers,
                            **over)
    return j, t


def _to_torch(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


@functools.lru_cache(maxsize=None)
def _setup(jcfg, tp, q4):
    """The JAX weights (q4 ring params at ``tp`` with ``q4``), seed-made
    prompts prefilled on one device (over the dequantized reference of a
    q4 bank) and the first greedy tokens."""
    params = init_params(jcfg, KEY)
    if q4:
        params, skipped = JS.quantize_ring_params(dict(params), jcfg, tp=tp)
        assert not skipped
    ref = JS.dequant_ring_reference(params["blocks"]) if q4 \
        else params["blocks"]
    prompts = jax.random.randint(jax.random.PRNGKey(1), (B, SP), 0,
                                 jcfg.vocab)
    cache = init_cache(jcfg, B, CTX, dtype=jnp.float32)
    logits, cache = prefill(dict(params, blocks=ref), jcfg, prompts, cache)
    return params, cache, jnp.argmax(logits[:, -1], -1)[:, None].astype(
        jnp.int32)


def _mesh(shape, names):
    mesh = dict(zip(names, shape))
    return mesh, mesh.get("pod", 1), mesh["data"], mesh["model"]


def jax_ring(jcfg, params, cache, first, shape, names, k, steps, T):
    """``steps`` greedy passes of the JAX ring (T = 1), or one T-token
    verify pass; (logits (B, T, V) a pass, tokens, ring caches)."""
    mesh, _, M, tp = _mesh(shape, names)
    plan = JS.RingPlan.make(jcfg, M, k)
    pr = JS.pad_vocab(dict(params), jcfg, tp)
    pr["blocks"] = JS.pad_and_permute(params["blocks"], jcfg, M, k)
    jc = dict(cache)
    jc["layers"] = JS.pad_and_permute(cache["layers"], jcfg, M, k)
    step = JS.build_ring_serve_step(jcfg, jax.make_mesh(shape, names), plan,
                                    n_tokens=T)(pr, jc)
    tok = jnp.tile(first, (1, T))
    ln = jc["len"]
    logits, toks, caches = [], [], []
    for _ in range(steps):
        lg, jc = step(tok, ln, pr, jc)
        ln = ln + T
        lg = np.asarray(lg[..., :jcfg.vocab])
        logits.append(lg)
        toks.append(lg.argmax(-1))
        # a copy: the next step is given this cache donated
        caches.append({n: np.array(a, copy=True)
                       for n, a in jc["layers"].items()})
        tok = jnp.asarray(toks[-1][:, -1:], jnp.int32)
    return logits, toks, caches, pr


def port_ring(world, tcfg, params, cache, first, shape, names, k, steps, T,
              tmp, **job):
    """The same on the ranks: the weights to a layer store and the cache
    to a file under ``tmp``, then ``rank_ring_job`` on the world."""
    _, pods, M, tp = _mesh(shape, names)
    tree = bridge.tree_from_numpy(jax.tree.map(np.asarray, params),
                                  device="cpu")
    store = save_param_store(tree, tcfg, os.path.join(tmp, "store"))
    path = os.path.join(tmp, "cache.pt")
    torch.save({"len": _to_torch(cache["len"]),
                "layers": {n: _to_torch(a)
                           for n, a in cache["layers"].items()}}, path)
    kw = dict(cfg=tcfg, n_stages=M, tp=tp, pods=pods, k=k, store=store,
              cache=path, first=np.asarray(first), keep_logits=True,
              check_replicated=True)
    if T == 1:
        kw.update(steps=steps)
    else:
        kw.update(steps=0, verify_tokens=T)
    kw.update(job)
    return world.run(JOB, **kw)


def expected_bytes(tcfg, pr, shape, names, rank) -> int:
    """The bytes of rank ``rank``'s part of the ring-ordered model by the
    ring's specs."""
    mesh, pods, M, tp = _mesh(shape, names)
    tree = bridge.tree_from_numpy(jax.tree.map(np.asarray, pr),
                                  device="cpu")
    specs = RS.ring_param_specs(tcfg, mesh, tree)
    coords = {"pod": rank // (M * tp), "data": (rank // tp) % M,
              "model": rank % tp}
    return sum(S.local_shard(leaf, specs[path], mesh, coords).nbytes
               for path, leaf in S.flatten_with_path(tree))


def held(ranks, want, shape, names, *, T=1, upto=None) -> float:
    """Rank (pod, 0, 0)'s logits and tokens against the JAX ring's for
    each pod's rows; returns the worst max|d| / max|ref|."""
    _, pods, M, tp = _mesh(shape, names)
    logits, toks = want
    rows = B // pods
    worst = 0.0
    for p in range(pods):
        r = ranks[p * M * tp]
        got = r["logits"] if T == 1 else [r["verify_logits"]]
        got_tok = r["tokens"] if T == 1 else [g.argmax(-1) for g in got]
        n = len(logits) if upto is None else upto
        assert len(got) >= n
        for t in range(n):
            ref = logits[t][p * rows:(p + 1) * rows]
            rel = float(np.abs(got[t] - ref).max() / np.abs(ref).max())
            assert rel < REL, (p, t, rel)
            worst = max(worst, rel)
            np.testing.assert_array_equal(
                np.asarray(got_tok[t]).reshape(rows, -1),
                toks[t][p * rows:(p + 1) * rows])
    return worst


def replicated_and_bytes(ranks, tcfg, pr, shape, names):
    for r in ranks:
        assert r["unequal"] == [], (r["rank"], r["unequal"])
        assert r["replicated"].get("x", 0) > 0
        if tcfg.family != "ssm":
            assert r["replicated"]["attention"] == r["replicated"]["x"]
        assert r["nbytes"] == expected_bytes(tcfg, pr, shape, names,
                                             r["rank"]), r["rank"]


def run_case(world, tmp_path, arch, *, shape=(4, 2),
             names=("data", "model"), k=1, n_layers=8, steps=3, T=1,
             q4=False, **over):
    jcfg, tcfg = _cfgs(arch, n_layers, **over)
    _, _, _, tp = _mesh(shape, names)
    params, cache, first = _setup(jcfg, tp, q4)
    logits, toks, caches, pr = jax_ring(jcfg, params, cache, first, shape,
                                        names, k, steps if T == 1 else 1, T)
    ranks = port_ring(world, tcfg, params, cache, first, shape, names, k,
                      steps, T, str(tmp_path))
    worst = held(ranks, (logits, toks), shape, names, T=T)
    replicated_and_bytes(ranks, tcfg, pr, shape, names)
    return worst, ranks


@pytest.mark.parametrize("k", [1, 2])
def test_rank_ring_dense(world, tmp_path, k):
    _, ranks = run_case(world, tmp_path, "qwen2.5-14b", k=k)
    # every rank took the pod's tokens; the stages' rows are 8 / 4
    for r in ranks:
        np.testing.assert_array_equal(r["tokens"], ranks[0]["tokens"])
    assert {r["stage"] for r in ranks} == {0, 1, 2, 3}


def test_rank_ring_moe(world, tmp_path):
    run_case(world, tmp_path, "phi3.5-moe-42b-a6.6b", k=2)


def test_rank_ring_swa_rolling(world, tmp_path):
    """mixtral's window equals the cache (Smax 32): the rolling buffer,
    its lines split 16 and 16 over the members."""
    run_case(world, tmp_path, "mixtral-8x7b", k=2)


def test_rank_ring_mla_absorbed(world, tmp_path):
    run_case(world, tmp_path, "minicpm3-4b", k=2)


def test_rank_ring_layer_padding(world, tmp_path):
    """6 layers on 4 stages: 2 zero layers pad the ring to 8."""
    run_case(world, tmp_path, "minitron-8b", n_layers=6)


def test_rank_ring_multi_pod(world, tmp_path):
    """(pod 2, data 2, model 2) at k = 2: each pod runs its own ring over
    its half of the batch."""
    _, ranks = run_case(world, tmp_path, "qwen2.5-14b", k=2,
                        shape=(2, 2, 2), names=("pod", "data", "model"))
    assert {(r["pod"], r["stage"], r["member"]) for r in ranks} == {
        (p, m, i) for p in range(2) for m in range(2) for i in range(2)}
