"""The port's elastic ring failover against the JAX package's: an injected
stage failure mid-decode re-plans the ring on the survivors (Halda
re-solve included), rebuilds the streamed ring and resumes from the last
emitted token, with zero tokens lost and the tokens after recovery equal
to a clean survivor-ring run fed the same history — and to the JAX
``ElasticRingServer``'s on the same layer store (``tests/test_failover.py``'s
setup: 8-layer reduced qwen2.5-14b, B 8, M 4; the JAX ring at tp 1 on 4
of the 8 host devices). Everything runs on CPU tensors.
"""
import dataclasses
import shutil
import tempfile

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
from repro_torch.runtime import elastic
from repro_torch.runtime.failover import ElasticRingServer, FailoverEvent
from repro_torch.runtime.faults import FaultInjector, FaultSpec, FaultyStore
from repro_torch.runtime.iopolicy import IOPolicy
from repro_torch.runtime.paramstore import ParamStore
from repro_torch.runtime.telemetry import Tracer

from test_elastic_cluster import model_70b
from test_torch_halda import t_model_70b

KEY = jax.random.PRNGKey(0)
B, S, MAX_NEW, N_STAGES = 8, 4, 6, 4
FAST = IOPolicy(max_retries=2, backoff_base_s=0.002, backoff_max_s=0.01,
                op_deadline_s=10.0, get_timeout_s=30.0)
J_FAST = JPolicy(max_retries=2, backoff_base_s=0.002, backoff_max_s=0.01,
                 op_deadline_s=10.0, get_timeout_s=30.0)


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


def _cfgs():
    return (dataclasses.replace(get_config("qwen2.5-14b").reduced(),
                                n_layers=8),
            dataclasses.replace(t_get_config("qwen2.5-14b").reduced(),
                                n_layers=8))


class _Counting:
    """ParamStore proxy that counts layer reads (the port's prefetcher
    reads a layer through ``layer_bytes``, the JAX one through
    ``layer``)."""

    def __init__(self, store):
        self.store = store
        self.reads = 0

    def layer(self, i):
        self.reads += 1
        return self.store.layer(i)

    def layer_bytes(self, i):
        self.reads += 1
        return self.store.layer_bytes(i)

    def __getattr__(self, name):
        return getattr(self.store, name)


def _server(env, store, **kw):
    kw.setdefault("n_stages", N_STAGES)
    return ElasticRingServer(env["cfg"], store, batch=B, ctx=32,
                             policy=FAST, device="cpu", **kw)


@pytest.fixture(scope="module")
def ring_env():
    jcfg, cfg = _cfgs()
    params = init_params(jcfg, KEY)
    d = tempfile.mkdtemp(prefix="test_torch_failover_")
    j_save(params, jcfg, d)            # one store, read by both packages
    prompts = np.asarray(jax.random.randint(KEY, (B, S), 0, jcfg.vocab),
                         np.int32)
    env = dict(cfg=cfg, jcfg=jcfg, params=params, dir=d, prompts=prompts)
    counting = _Counting(ParamStore(d))
    srv = _server(env, counting)
    try:
        env["probe"] = srv.generate(prompts, 2)
    finally:
        srv.close()
        counting.close()
    env["reads_2"] = counting.reads
    # the JAX driver also reads layer 0 once a build (its bank's shapes)
    jcounting = _Counting(JParamStore(d))
    jsrv = JServer(jcfg, jcounting, params, batch=B, ctx=32,
                   n_stages=N_STAGES, tp=1, policy=J_FAST)
    try:
        jsrv.generate(prompts, 2)
    finally:
        jsrv.close()
        jcounting.close()
    env["j_reads_2"] = jcounting.reads
    yield env
    shutil.rmtree(d, ignore_errors=True)


def _reference(env, n_stages, k, history_tokens, n_new):
    """Clean run on an ``n_stages`` ring fed prompt+history as prompt."""
    store = ParamStore(env["dir"])
    ref = _server(env, store, n_stages=n_stages, k=k)
    try:
        pr = np.concatenate([env["prompts"], history_tokens], axis=1) \
            if history_tokens.shape[1] else env["prompts"]
        return ref.generate(pr, n_new)
    finally:
        ref.close()
        store.close()


def _jax_failover(env):
    inj = JInjector([JSpec(op="layer_read", mode="stage_failure", stage=1,
                           after=env["j_reads_2"], times=1)])
    store = JFaulty(JParamStore(env["dir"]), inj)
    srv = JServer(env["jcfg"], store, env["params"], batch=B, ctx=32,
                  n_stages=N_STAGES, tp=1, policy=J_FAST,
                  device_profiles=j_cluster(), model_profile=model_70b())
    try:
        return srv.generate(env["prompts"], MAX_NEW), srv.events
    finally:
        srv.close()
        store.close()


def test_stage_failure_triggers_elastic_failover(ring_env):
    env = ring_env
    assert env["reads_2"] == 5 * 8      # 4 prompt passes + 1, 8 layers
    inj = FaultInjector([FaultSpec(op="layer_read", mode="stage_failure",
                                   stage=1, after=env["reads_2"],
                                   times=1)])
    store = FaultyStore(ParamStore(env["dir"]), inj)
    tracer = Tracer()
    srv = _server(env, store, device_profiles=paper_table2_cluster(),
                  model_profile=t_model_70b(), tracer=tracer)
    try:
        toks = srv.generate(env["prompts"], MAX_NEW)
    finally:
        srv.close()
        store.close()

    assert toks.shape == (B, MAX_NEW)
    assert len(inj.fired) == 1
    assert len(srv.events) == 1
    ev = srv.events[0]
    assert isinstance(ev, FailoverEvent)
    assert ev.failed_stage == 1
    assert ev.n_stages_before == N_STAGES
    assert ev.n_stages_after == 2        # batch 8 % 3 != 0: one more goes
    assert ev.tokens_lost == 0
    assert ev.token_index == 2
    assert ev.replayed_tokens == S + ev.token_index
    assert ev.recovery_s > 0
    assert ev.halda is not None and ev.halda["k"] >= 1
    assert ev.plan["n_stages"] == 2
    spans = [e.name for e in tracer.events() if e.track == "failover"]
    assert [n for n in spans if n.startswith("failover/")] == [
        "failover/detect", "failover/resolve", "failover/rebuild",
        "failover/replay"]

    assert np.array_equal(toks[:, :ev.token_index],
                          env["probe"][:, :ev.token_index])
    ref = _reference(env, ev.plan["n_stages"], ev.plan["k"],
                     toks[:, :ev.token_index], MAX_NEW - ev.token_index)
    assert np.array_equal(toks[:, ev.token_index:], ref)

    # the JAX server on the same store and fault schedule
    jtoks, jevents = _jax_failover(env)
    assert np.array_equal(toks, jtoks)
    jev = jevents[0]
    for f in ("token_index", "failed_stage", "n_stages_after", "plan",
              "halda", "replayed_tokens", "tokens_lost"):
        assert getattr(ev, f) == getattr(jev, f), f


def test_unattributed_failure_rebuilds_same_stages(ring_env):
    env = ring_env
    inj = FaultInjector([FaultSpec(op="layer_read", mode="error",
                                   error_type=ValueError,
                                   after=env["reads_2"], times=1)])
    store = FaultyStore(ParamStore(env["dir"]), inj)
    srv = _server(env, store)
    try:
        toks = srv.generate(env["prompts"], MAX_NEW)
    finally:
        srv.close()
        store.close()

    assert len(srv.events) == 1
    ev = srv.events[0]
    assert ev.failed_stage is None
    assert ev.n_stages_after == N_STAGES
    assert ev.tokens_lost == 0
    ref = _reference(env, N_STAGES, ev.plan["k"],
                     toks[:, :ev.token_index], MAX_NEW - ev.token_index)
    assert np.array_equal(toks[:, ev.token_index:], ref)


def test_failover_budget_exhausted_reraises(ring_env):
    env = ring_env
    inj = FaultInjector([FaultSpec(op="layer_read", times=-1)])
    store = FaultyStore(ParamStore(env["dir"]), inj)
    srv = _server(env, store, max_failovers=1)
    try:
        with pytest.raises(Exception):
            srv.generate(env["prompts"], MAX_NEW)
    finally:
        srv.close()
        store.close()


def test_feasible_shrinks_survivors_to_batch_divisor():
    _, cfg = _cfgs()
    srv = ElasticRingServer(cfg, object(), batch=8, ctx=32, n_stages=4,
                            device="cpu")
    st = elastic.fail_stages(srv.state, cfg, [1])   # 3 survivors: 8 % 3
    st = srv._feasible(st)
    assert len(st.stages) == 2 and srv.batch % len(st.stages) == 0
    assert st.plan.n_stages == 2 and st.generation == 2


def test_feasible_raises_when_no_ring_fits():
    # the port's stages share one device, so only an empty survivor set
    # leaves no ring
    _, cfg = _cfgs()
    srv = ElasticRingServer(cfg, object(), batch=8, ctx=32, n_stages=4,
                            device="cpu")
    with pytest.raises(RuntimeError, match="no feasible ring"):
        srv._feasible(elastic.ElasticState(stages=[], plan=srv.state.plan))


def test_server_refuses_tp_and_ragged_batch():
    """tp 2 runs the ring across rank processes (``ranks`` by default at
    tp > 1; ``tests/test_torch_failover_ranks.py`` serves through it),
    which take a layer store's directory; a ragged batch is still
    refused; the one-process layout still refuses tp 2, naming the rank
    path; a ``RankChaos`` needs the ranks."""
    from repro_torch.runtime.failover import RankChaos

    _, cfg = _cfgs()
    srv = ElasticRingServer(cfg, "/a/store/dir", batch=8, ctx=32,
                            n_stages=4, tp=2, device="cpu")
    assert srv.ranks and srv.layout is None and srv.tp == 2
    with pytest.raises(TypeError, match="directory"):
        ElasticRingServer(cfg, object(), batch=8, ctx=32, n_stages=4,
                          tp=2, device="cpu")
    with pytest.raises(ValueError, match="RankWorld"):
        ElasticRingServer(cfg, object(), batch=8, ctx=32, n_stages=4,
                          tp=2, ranks=False, device="cpu")
    with pytest.raises(ValueError, match="ranks=True"):
        ElasticRingServer(cfg, object(), batch=8, ctx=32, n_stages=4,
                          chaos=RankChaos(), device="cpu")
    with pytest.raises(ValueError, match="ring unsupported"):
        ElasticRingServer(cfg, object(), batch=6, ctx=32, n_stages=4,
                          device="cpu")
    with pytest.raises(ValueError, match="ring unsupported"):
        ElasticRingServer(cfg, "/a/store/dir", batch=6, ctx=32, n_stages=4,
                          tp=2, device="cpu")


def test_recovery_s_property():
    ev = FailoverEvent(token_index=3, failed_stage=1, generation=1,
                       n_stages_before=4, n_stages_after=2,
                       plan={"n_stages": 2, "k": 2, "w": 2, "L_pad": 8},
                       halda=None, detect_s=0.1, resolve_s=0.2,
                       rebuild_s=0.3, replay_s=0.4, tokens_lost=0,
                       replayed_tokens=6)
    assert ev.recovery_s == pytest.approx(1.0)


def test_driver_chaos_failover(capsys):
    """``--chaos failover`` through the driver's entry point: the streamed
    ring against the resident ring over a q4 store, then a stage killed
    at the third token, recovered with zero tokens lost and the tokens
    after recovery equal to a clean survivor-ring run."""
    from repro_torch.launch import serve as driver

    res = driver.main(["--smoke", "--device", "cpu", "--dtype", "f32",
                       "--stages", "4", "--stream-window", "2",
                       "--store-quant", "q4", "--chaos", "failover",
                       "--new-tokens", "6"])
    out = capsys.readouterr().out
    ring = res["ring"]
    assert np.array_equal(ring["streamed_tokens"], ring["stored_tokens"])
    fo = res["chaos"]
    ev = fo["event"]
    assert ev.failed_stage == 1 and ev.tokens_lost == 0
    assert ev.token_index == 2 and ev.n_stages_after == 2
    assert np.array_equal(fo["tokens"][:, 2:], fo["reference"])
    assert "chaos failover: stage 1 died at token 2" in out
