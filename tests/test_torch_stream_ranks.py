"""The port's streamed ring across ranks (``runtime.serve.rank_stream_job``:
each of 4 x 2 rank processes streams only its stage's windows and only its
part of each leaf from the layer store, ``streaming.RankWindowPrefetcher``)
against its resident ring across the same ranks over the same store
(``rank_ring_job``) and against the JAX package's streamed ring
(``repro.runtime.streaming.StreamingRingDriver``) over the (4, 2) mesh
built from the device list, as the JAX ``ElasticRingServer`` builds it.

``tests/test_failover.py``'s setup: qwen2.5-14b reduced to 8 layers (7 for
the padding case), B 8, 4 stages, tp 2, f32, weights from the JAX
package's seed written once as a layer store (q4 with
``quantize_ring_params`` at tp 2) that both packages read; the batch
prefilled on one device by the JAX package. Streamed logits must equal
the resident rank ring's exactly (max|d| 0) and lie within 2e-4 of
max|ref| of the JAX streamed ring's, with equal tokens on every rank; each
rank reads exactly its own shards' bytes of its own stage's rows a pass
and stages at most its stage's rows, one window of them at depth 1;
transient read faults on one rank
are retried with equal tokens, a fatal one fails the world naming the
rank. Eight rank processes (``launch.mesh.RankWorld``, gloo on the CPU,
torch on one thread a rank) serve the whole module.
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
from repro.runtime.iopolicy import IOPolicy as JPolicy
from repro.runtime.paramstore import ParamStore as JParamStore
from repro.runtime.paramstore import save_param_store as j_save
from repro.runtime.streaming import StreamingRingDriver as JDriver
from repro_torch import bridge
from repro_torch.configs import get_config as t_get_config
from repro_torch.launch.mesh import RankFailure, RankWorld
from repro_torch.runtime import serve as RS
from repro_torch.runtime import sharding as S
from repro_torch.runtime.faults import FaultSpec
from repro_torch.runtime.iopolicy import IOPolicy

KEY = jax.random.PRNGKey(0)
B, SP, CTX, STEPS = 8, 5, 32, 3
M, TP = 4, 2
REL = 2e-4
RING = "repro_torch.runtime.serve:rank_ring_job"
STREAM = "repro_torch.runtime.serve:rank_stream_job"
FAST = IOPolicy(max_retries=3, backoff_base_s=0.002, backoff_max_s=0.01,
                op_deadline_s=10.0, get_timeout_s=30.0)


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
    w = RankWorld(M * TP, device="cpu", threads=1, timeout_s=180)
    yield w
    w.close()


def _to_torch(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


@functools.lru_cache(maxsize=None)
def _setup(n_layers, q4, tmp):
    """JAX weights (q4 ring params at tp 2), their layer store under
    ``tmp`` (the JAX writer; the port reads it), seed-made prompts
    prefilled on one device (over the dequantized reference of a q4
    bank), the cache as a file the ranks map, and the first tokens."""
    jcfg = dataclasses.replace(get_config("qwen2.5-14b").reduced(),
                               n_layers=n_layers)
    tcfg = dataclasses.replace(t_get_config("qwen2.5-14b").reduced(),
                               n_layers=n_layers)
    params = init_params(jcfg, KEY)
    if q4:
        params, skipped = JS.quantize_ring_params(dict(params), jcfg, tp=TP)
        assert not skipped
    ref = JS.dequant_ring_reference(params["blocks"]) if q4 \
        else params["blocks"]
    prompts = jax.random.randint(jax.random.PRNGKey(1), (B, SP), 0,
                                 jcfg.vocab)
    cache = init_cache(jcfg, B, CTX, dtype=jnp.float32)
    logits, cache = prefill(dict(params, blocks=ref), jcfg, prompts, cache)
    first = np.asarray(jnp.argmax(logits[:, -1], -1)[:, None], np.int32)
    d = os.path.join(tmp, f"L{n_layers}_{'q4' if q4 else 'f32'}")
    os.makedirs(d)
    j_save(params, jcfg, os.path.join(d, "store"))
    path = os.path.join(d, "cache.pt")
    torch.save({"len": _to_torch(cache["len"]),
                "layers": {n: _to_torch(a)
                           for n, a in cache["layers"].items()}}, path)
    return dict(jcfg=jcfg, tcfg=tcfg, params=params, cache=cache,
                first=first, store=os.path.join(d, "store"), path=path)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("stream_ranks"))
    return lambda n_layers=8, q4=False: _setup(n_layers, q4, tmp)


def jax_stream(env, k, T, steps):
    """The JAX streamed ring over the device-list (4, 2) mesh from the
    prefilled cache: ``steps`` greedy passes (T = 1) or one T-token
    verify pass over the first token repeated; the logits (B, T, V) of
    each pass."""
    jcfg, params = env["jcfg"], env["params"]
    plan = JS.RingPlan.make(jcfg, M, k)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:M * TP]).reshape(M, TP),
                             ("data", "model"))
    jc = dict(env["cache"])
    jc["layers"] = JS.pad_and_permute(jc["layers"], jcfg, M, k)
    head = {n: v for n, v in JS.pad_vocab(dict(params), jcfg, TP).items()
            if n != "blocks"}
    store = JParamStore(env["store"])
    drv = JDriver(jcfg, mesh, plan, store, head_params=head, cache_like=jc,
                  n_tokens=T, policy=JPolicy())
    tok = jnp.tile(jnp.asarray(env["first"]), (1, T))
    ln = jc["len"]
    out = []
    try:
        for _ in range(steps if T == 1 else 1):
            lg, jc = drv.step(tok, ln, jc)
            ln = ln + T
            lg = np.asarray(lg[..., :jcfg.vocab], np.float32)
            out.append(lg)
            tok = jnp.asarray(lg[:, -1:].argmax(-1), jnp.int32)
    finally:
        drv.close()
        store.close()
    return out


def port_runs(world, env, k, T, **stream):
    """The resident and the streamed rank ring from the same cache."""
    kw = dict(cfg=env["tcfg"], n_stages=M, tp=TP, k=k, store=env["store"],
              cache=env["path"], first=env["first"], keep_logits=True)
    kw.update(steps=STEPS) if T == 1 else kw.update(steps=0,
                                                   verify_tokens=T)
    resident = world.run(RING, **kw)
    streamed = world.run(STREAM, policy=FAST, **stream, **kw)
    return resident, streamed


def logits_of(rank, T):
    return rank["logits"] if T == 1 else [rank["verify_logits"]]


def own_bytes(env, k, rank) -> int:
    """The bytes of rank ``rank``'s part of its stage's rows that hold a
    model layer, by the ring's specs: what it must read a pass."""
    tcfg = env["tcfg"]
    plan = RS.RingPlan.make(tcfg, M, k)
    mesh = {"data": M, "model": TP}
    coords = {"data": (rank // TP) % M, "model": rank % TP}
    tree = bridge.tree_from_numpy(jax.tree.map(np.asarray,
                                               env["params"]["blocks"]),
                                  device="cpu")
    row = 0
    for path, leaf in S.flatten_with_path(tree, "['blocks']"):
        spec = RS.ring_leaf_spec(path, (plan.L_pad,) + tuple(leaf.shape[1:]),
                                 mesh)
        row += S.local_shard(leaf[0], spec[1:], mesh, coords).nbytes
    rows = RS._rank_rows(plan, coords["data"])
    return row * int((rows < tcfg.n_layers).sum())


@pytest.mark.parametrize("k,T,q4", [
    (1, 1, False), (2, 1, False), (1, 1, True), (2, 1, True),
    (1, 4, False), (2, 4, False), (1, 4, True), (2, 4, True)])
def test_streamed_rank_ring(world, setup, k, T, q4):
    env = setup(q4=q4)
    want = jax_stream(env, k, T, STEPS)
    resident, streamed = port_runs(world, env, k, T)
    plan = RS.RingPlan.make(env["tcfg"], M, k)
    for res, st in zip(resident, streamed):
        # the streamed rows are the resident rows' bytes: bit for bit
        for a, b in zip(logits_of(st, T), logits_of(res, T)):
            assert a is not None and float(np.abs(a - b).max()) == 0.0
        np.testing.assert_array_equal(st["tokens"], streamed[0]["tokens"])
        pf = st["prefetch"]
        assert pf["passes"] == (STEPS if T == 1 else 1)
        assert pf["bytes_a_pass"] == own_bytes(env, k, st["rank"])
        assert pf["peak_staged_bytes"] <= plan.k * plan.w * pf["row_nbytes"]
        assert st["nbytes"] == res["nbytes"]
    got = logits_of(streamed[0], T)
    assert len(got) == len(want)
    for t, (g, ref) in enumerate(zip(got, want)):
        rel = float(np.abs(g - ref).max() / np.abs(ref).max())
        assert rel < REL, (t, rel)
        np.testing.assert_array_equal(g.argmax(-1), ref.argmax(-1))
    if T > 1:
        for r in streamed:
            np.testing.assert_array_equal(r["verify_logits"].argmax(-1),
                                          got[0].argmax(-1))


def test_streamed_rank_ring_layer_padding(world, setup):
    """7 layers on 4 stages at k 1: stage 3's second row is a zero layer,
    read from nowhere."""
    env = setup(n_layers=7)
    want = jax_stream(env, 1, 1, STEPS)
    resident, streamed = port_runs(world, env, 1, 1)
    for res, st in zip(resident, streamed):
        for a, b in zip(st["logits"], res["logits"]):
            assert float(np.abs(a - b).max()) == 0.0
        np.testing.assert_array_equal(st["tokens"], streamed[0]["tokens"])
        pf = st["prefetch"]
        real = 1 if st["stage"] == M - 1 else 2
        assert pf["reads"] == real * STEPS
        assert pf["bytes_a_pass"] == own_bytes(env, 1, st["rank"])
    for g, ref in zip(streamed[0]["logits"], want):
        assert float(np.abs(g - ref).max() / np.abs(ref).max()) < REL
        np.testing.assert_array_equal(g.argmax(-1), ref.argmax(-1))


@pytest.mark.parametrize("n_layers", [8, 7])
def test_streamed_rank_ring_stages_one_window_at_depth_1(world, setup,
                                                         n_layers):
    """At depth 1 and k 2 a rank holds one window at a time (the
    one-process rule, current window plus ``depth - 1`` ahead, at a rank's
    share of a layer): its peak staged bytes are one window's, so window 0
    was released before window 1 was staged, every pass; with 7 layers
    stage 3's zero row is released with its window too. Logits equal the
    resident rank ring's and each rank reads its own shards once a pass."""
    env = setup(n_layers=n_layers)
    k = 2
    plan = RS.RingPlan.make(env["tcfg"], M, k)
    resident, streamed = port_runs(world, env, k, 1, depth=1)
    for res, st in zip(resident, streamed):
        for a, b in zip(st["logits"], res["logits"]):
            assert float(np.abs(a - b).max()) == 0.0
        np.testing.assert_array_equal(st["tokens"], streamed[0]["tokens"])
        pf = st["prefetch"]
        assert pf["peak_staged_bytes"] == plan.w * pf["row_nbytes"]
        assert pf["peak_staged_bytes"] < plan.k * plan.w * pf["row_nbytes"]
        assert pf["bytes_a_pass"] == own_bytes(env, k, st["rank"])


def test_streamed_rank_ring_retries_transient_faults(world, setup):
    """Two transient read faults on rank 5's reads are retried: the same
    tokens and logits as the clean run, the retries counted there only."""
    env = setup(q4=True)
    _, clean = port_runs(world, env, 2, 1)
    _, faulty = port_runs(world, env, 2, 1,
                          fault=(5, FaultSpec(op="layer_read", after=1,
                                              times=2)))
    for a, b in zip(faulty, clean):
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
        for x, y in zip(a["logits"], b["logits"]):
            assert float(np.abs(x - y).max()) == 0.0
        assert a["prefetch"]["retries"] == (2 if a["rank"] == 5 else 0)


def test_streamed_rank_ring_fatal_read_names_the_rank(world, setup):
    """A read that fails past its retries on rank 3 fails the world with a
    ``RankFailure`` naming rank 3 (stage 1) as the one that raised."""
    env = setup()
    with pytest.raises(RankFailure) as info:
        port_runs(world, env, 1, 1,
                  fault=(3, FaultSpec(op="layer_read", mode="error",
                                      error_type=ValueError, after=2)))
    err = info.value
    assert err.ranks("raised") == [3] and not err.ranks("died")
    assert "rank 3 raised" in str(err) and "layer_read" in str(err)
    assert "rank 3 (stage 1, member 1): window staging failed at " \
        "window 0" in str(err)
    # the world was ended; the next job starts a new one
    _, again = port_runs(world, env, 1, 1)
    assert len(again) == M * TP


def test_rank_window_prefetcher_cuts_before_copying(setup):
    """The prefetcher's leaf cuts are the ring specs' parts: a q4 leaf's
    packed rows and scale rows split together, and a split that would
    part them raises as ``rank_params``' cut raises."""
    from repro_torch.runtime.paramstore import ParamStore

    env = setup(q4=True)
    plan = RS.RingPlan.make(env["tcfg"], M, 1)

    @dataclasses.dataclass
    class Lay:
        mesh: dict
        coords: dict

    lay = Lay({"data": M, "model": TP}, {"data": 1, "model": 1})
    with ParamStore(env["store"]) as store:
        cuts = RS.rank_layer_cuts(store.layer_leaves, plan, lay)
        src = store.layer_bytes(2)
        buf = torch.zeros(sum(c.local.nbytes for c in cuts),
                          dtype=torch.uint8)
        for c in cuts:
            c.copy(src, buf, lay.mesh, lay.coords)
        from repro_torch.runtime.paramstore import _read_leaves
        got = _read_leaves([c.local for c in cuts], buf)
        want = RS._shard_tree(store.layer(2), "['blocks']", (plan.L_pad,),
                              lay.mesh, lay.coords, "cpu")
    flat_g = dict(S.flatten_with_path(got))
    flat_w = dict(S.flatten_with_path(want))
    assert flat_g.keys() == flat_w.keys()
    for p in flat_w:
        assert torch.equal(flat_g[p], flat_w[p]), p
    # a scale leaf whose rows cannot split while its packed rows do
    c = next(c for c in cuts if c.spec.part == "scale"
             and c.split[0] == "model")
    odd = dataclasses.replace(c.spec, shape=(3,) + tuple(c.spec.shape[1:]),
                              nbytes=c.spec.nbytes // c.spec.shape[0] * 3)
    with pytest.raises(ValueError, match="split differently"):
        RS.rank_layer_cuts([odd if s == c.spec else s
                            for s in store_leaves(env)], plan, lay)


def store_leaves(env):
    from repro_torch.runtime.paramstore import ParamStore

    with ParamStore(env["store"]) as store:
        return store.layer_leaves
