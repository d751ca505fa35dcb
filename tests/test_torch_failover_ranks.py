"""The port's elastic failover across rank processes against the JAX
package's ``ElasticRingServer`` over its (4, 2) device mesh.

``tests/test_failover.py``'s fixture: qwen2.5-14b reduced to 8 layers, B 8,
prompts of 4 tokens, 6 new tokens, 4 stages, tp 2, f32, one layer store
written by the JAX package that both read. The port's ring runs across
4 x 2 rank processes (``launch.mesh.RankWorld``, gloo on the CPU, one
torch thread a rank), each streaming its part (``serve.rank_stream_job``'s
path). Stage 1 dies at the pass of token 2: its first rank ``SIGKILL``ed
by the parent, or its first read of that pass raising ``StageFailure``.
The event must say stage 1, 4 -> 2 stages (batch 8 does not split over
3), S + 2 tokens replayed, none lost, and Halda's k over the paper
cluster's survivors, as the JAX event says; every token must equal the
JAX server's under the same fault, and the tokens after recovery a clean
port run on the survivor world fed the same history. An unattributed
rank error rebuilds on the same stages; an exhausted budget re-raises;
a death whose exit shows after the survivors' errors is still a death;
the driver's ``--chaos failover`` runs across ranks by default.
"""
import dataclasses
import functools
import os
import signal
import socket
import stat
import time

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core.profiles import paper_table2_cluster as j_cluster
from repro.models import init_params
from repro.runtime.failover import ElasticRingServer as JServer
from repro.runtime.faults import FaultInjector as JInjector
from repro.runtime.faults import FaultSpec as JSpec
from repro.runtime.faults import FaultyStore as JFaulty
from repro.runtime.iopolicy import IOPolicy as JPolicy
from repro.runtime.paramstore import ParamStore as JParamStore
from repro.runtime.paramstore import save_param_store as j_save
from repro_torch.configs import get_config as t_get_config
from repro_torch.core.profiles import paper_table2_cluster
from repro_torch.launch.mesh import RankFailure, RankWorld
from repro_torch.runtime.failover import ElasticRingServer, RankChaos
from repro_torch.runtime.iopolicy import IOPolicy

from test_elastic_cluster import model_70b
from test_torch_halda import t_model_70b

KEY = jax.random.PRNGKey(0)
B, S, MAX_NEW, N_STAGES, TP = 8, 4, 6, 4, 2
FAST = IOPolicy(max_retries=2, backoff_base_s=0.002, backoff_max_s=0.01,
                op_deadline_s=10.0, get_timeout_s=30.0)
J_FAST = JPolicy(max_retries=2, backoff_base_s=0.002, backoff_max_s=0.01,
                 op_deadline_s=10.0, get_timeout_s=30.0)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """This file's tests run torch on one thread (the suite's parallel
    workers would otherwise spin against each other)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Counting:
    """ParamStore proxy that counts the JAX server's layer reads (to put
    its fault at the pass of token 2, as ``tests/test_failover.py``
    does)."""

    def __init__(self, store):
        self.store = store
        self.reads = 0

    def layer(self, i):
        self.reads += 1
        return self.store.layer(i)

    def __getattr__(self, name):
        return getattr(self.store, name)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    jcfg = dataclasses.replace(get_config("qwen2.5-14b").reduced(),
                               n_layers=8)
    cfg = dataclasses.replace(t_get_config("qwen2.5-14b").reduced(),
                              n_layers=8)
    params = init_params(jcfg, KEY)
    d = str(tmp_path_factory.mktemp("failover_ranks"))
    j_save(params, jcfg, d)
    prompts = np.asarray(jax.random.randint(KEY, (B, S), 0, jcfg.vocab),
                         np.int32)
    counting = _Counting(JParamStore(d))
    srv = JServer(jcfg, counting, params, batch=B, ctx=32,
                  n_stages=N_STAGES, tp=TP, policy=J_FAST)
    try:
        srv.generate(prompts, 2)
    finally:
        srv.close()
        counting.close()
    return dict(jcfg=jcfg, cfg=cfg, params=params, dir=d, prompts=prompts,
                j_reads_2=counting.reads)


@functools.lru_cache(maxsize=None)
def _jax_failover(d, reads):
    jcfg = dataclasses.replace(get_config("qwen2.5-14b").reduced(),
                               n_layers=8)
    params = init_params(jcfg, KEY)
    prompts = np.asarray(jax.random.randint(KEY, (B, S), 0, jcfg.vocab),
                         np.int32)
    inj = JInjector([JSpec(op="layer_read", mode="stage_failure", stage=1,
                           after=reads, times=1)])
    store = JFaulty(JParamStore(d), inj)
    srv = JServer(jcfg, store, params, batch=B, ctx=32, n_stages=N_STAGES,
                  tp=TP, policy=J_FAST, device_profiles=j_cluster(),
                  model_profile=model_70b())
    try:
        return srv.generate(prompts, MAX_NEW), srv.events[0]
    finally:
        srv.close()
        store.close()


def _server(env, **kw):
    kw.setdefault("n_stages", N_STAGES)
    return ElasticRingServer(env["cfg"], env["dir"], batch=B, ctx=32, tp=TP,
                             policy=FAST, device="cpu", **kw)


def _generate(srv, prompts, n):
    try:
        return srv.generate(prompts, n)
    finally:
        srv.close()


def _reference(env, n_stages, k, history, n_new, world=None):
    """A clean port run on an ``n_stages`` x tp world (``world``: a
    running one, then closed) fed prompt + history as its prompt."""
    pr = np.concatenate([env["prompts"], history], axis=1)
    try:
        return _generate(_server(env, n_stages=n_stages, k=k, world=world),
                         pr, n_new)
    finally:
        if world is not None:
            world.close()


@pytest.mark.parametrize("mode", ["kill", "stage_failure"])
def test_rank_death_fails_over_as_jax_does(env, mode):
    srv = _server(env, chaos=RankChaos(stage=1, token=2,
                                       mode=mode),
                  device_profiles=paper_table2_cluster(),
                  model_profile=t_model_70b())
    assert srv.ranks                       # tp 2: across ranks by default
    try:
        toks = srv.generate(env["prompts"], MAX_NEW)
        survivors = srv.take_world()       # the clean run reuses them
    finally:
        srv.close()
    assert survivors.world == 2 * TP and survivors._procs
    assert toks.shape == (B, MAX_NEW)
    assert len(srv.events) == 1 and len(srv.failures) == 1
    cause = srv.failures[0]
    assert isinstance(cause, RankFailure)
    if mode == "kill":
        assert cause.ranks("died") == [2]          # stage 1, member 0
        assert cause.errors[0].signal == 9
        assert "rank 2 killed by signal 9" in str(cause)
    else:
        assert [e.rank for e in cause.errors
                if e.kind == "raised" and e.stage_failure] == [2]
    ev = srv.events[0]
    assert ev.failed_stage == 1
    assert ev.n_stages_before == N_STAGES and ev.n_stages_after == 2
    assert ev.token_index == 2 and ev.tokens_lost == 0
    assert ev.replayed_tokens == S + ev.token_index
    assert ev.halda is not None and ev.halda["k"] >= 1
    assert 0 < ev.detect_s < 5 and ev.rebuild_s > 0 and ev.replay_s > 0

    jtoks, jev = _jax_failover(env["dir"], env["j_reads_2"])
    np.testing.assert_array_equal(toks, jtoks)
    for f in ("token_index", "failed_stage", "n_stages_after", "plan",
              "halda", "replayed_tokens", "tokens_lost"):
        assert getattr(ev, f) == getattr(jev, f), f

    i = ev.token_index
    ref = _reference(env, ev.plan["n_stages"], ev.plan["k"], toks[:, :i],
                     MAX_NEW - i, world=survivors)
    np.testing.assert_array_equal(toks[:, i:], ref)


def test_unattributed_rank_error_rebuilds_same_stages(env):
    srv = _server(env, chaos=RankChaos(stage=1, token=2, mode="error"))
    toks = _generate(srv, env["prompts"], MAX_NEW)
    ev, = srv.events
    assert ev.failed_stage is None and ev.n_stages_after == N_STAGES
    assert ev.tokens_lost == 0 and ev.token_index == 2
    err = srv.failures[0]
    assert err.ranks("raised") == [2] and not err.errors[0].stage_failure
    jtoks, _ = _jax_failover(env["dir"], env["j_reads_2"])
    np.testing.assert_array_equal(toks[:, :2], jtoks[:, :2])
    ref = _reference(env, N_STAGES, ev.plan["k"], toks[:, :2], MAX_NEW - 2)
    np.testing.assert_array_equal(toks[:, 2:], ref)


def test_exhausted_budget_reraises(env):
    srv = _server(env, chaos=RankChaos(mode="kill", token=1),
                  max_failovers=0)
    with pytest.raises(RankFailure, match="killed by signal 9"):
        _generate(srv, env["prompts"], MAX_NEW)
    assert srv.ring is None and not srv.events


def _slow_death(ctx, *, victim: int, linger_s: float):
    """A rank job: rank ``victim`` shuts its connections at once (its
    peers' all-reduce fails with gloo's "Connection closed by peer"), but
    its exit shows only ``linger_s`` later, when it ``SIGKILL``s itself;
    the others all-reduce with it."""
    import torch.distributed as dist

    if ctx.rank == victim:
        for fd in os.listdir("/proc/self/fd"):
            try:
                if not stat.S_ISSOCK(os.fstat(int(fd)).st_mode):
                    continue
                s = socket.fromfd(int(fd), socket.AF_INET,
                                  socket.SOCK_STREAM)
            except OSError:
                continue
            # gloo's listening socket stays: shutting it aborts the rank
            if not s.getsockopt(socket.SOL_SOCKET, socket.SO_ACCEPTCONN):
                s.shutdown(socket.SHUT_RDWR)
            s.close()
        time.sleep(linger_s)
        os.kill(os.getpid(), signal.SIGKILL)
    dist.all_reduce(torch.ones(1))
    return ctx.rank


def test_a_death_seen_after_its_peers_errors_is_still_a_death():
    """A rank whose exit shows after its peers' errors, and later than
    ``GRACE_S`` after them, is named as died (the failover attributes it
    to its stage): while a survivor's error says a peer went away, the
    parent waits up to ``PEER_GRACE_S`` for that exit."""
    linger = 1.0
    assert RankWorld.GRACE_S < linger < RankWorld.PEER_GRACE_S
    with RankWorld(3, device="cpu", threads=1, timeout_s=60) as w:
        assert w.run(f"{__name__}:_slow_death", victim=9,
                     linger_s=0.0) == [0, 1, 2]
        t0 = time.monotonic()
        with pytest.raises(RankFailure) as info:
            w.run(f"{__name__}:_slow_death", victim=1, linger_s=linger)
        waited = time.monotonic() - t0
    err = info.value
    assert err.ranks("died") == [1] and err.errors[0].signal == 9
    assert err.ranks("raised") and set(err.ranks("raised")) <= {0, 2}
    assert all("Connection closed by peer" in e.traceback
               for e in err.errors if e.kind == "raised")
    assert linger <= waited < RankWorld.PEER_GRACE_S + 1.0


def test_driver_chaos_failover_across_ranks(capsys):
    """The driver at its default 4 x 2: the streamed ring across the decode
    section's ranks against the resident ring over a q4 store, then stage
    1's first rank killed at the third token, recovered on a 2 x 2 world
    with zero tokens lost and the tokens after recovery equal to a clean
    survivor-world run; the output names the rank that died."""
    from repro_torch.launch import serve as driver

    res = driver.main(["--smoke", "--device", "cpu", "--dtype", "f32",
                       "--stream-window", "2", "--store-quant", "q4",
                       "--chaos", "failover", "--new-tokens", "6"])
    out = capsys.readouterr().out
    ring = res["ring"]
    np.testing.assert_array_equal(ring["streamed_tokens"],
                                  ring["stored_tokens"])
    assert len(ring["stream_ranks"]) == 8 and ring["logits_max_d"] == 0.0
    fo = res["chaos"]
    ev = fo["event"]
    assert ev.failed_stage == 1 and ev.tokens_lost == 0
    assert ev.token_index == 2 and ev.n_stages_after == 2
    np.testing.assert_array_equal(fo["tokens"][:, 2:], fo["reference"])
    assert "chaos failover: stage 1 died at token 2 (rank 2 killed by " \
        "signal 9, seen " in out
    assert "ring across 4 x 2 ranks -> 2 x 2" in out
