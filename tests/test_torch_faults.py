"""The port's fault injection against the JAX package's, on the CPU.

``runtime/faults.py`` is a copy: the same schedules fire on the same calls
in both packages (windows, key scoping, seeded thinning, the stage-failure
mode). Transient layer-read faults in the port's streamed decode retry to
the clean run's tokens, counted in ``PrefetchStats.retries``; a permanent
fault fails fast and classified; the KV offloader retries its ``kv_h2d``
and ``kv_d2h`` copies; the tracer's ``ingest_*`` adapters give the JAX
tracer's events for the same records; and the serve driver's
``--chaos transient`` exits 0 with its parity line (its tier flags:
``tests/test_torch_cli_tiers.py`` and ``test_torch_cli_tiers_int8.py``).
"""
import dataclasses
import shutil
import tempfile
import time

import pytest
import torch

from repro.runtime import faults as JF
from repro.runtime import iopolicy as JIO
from repro.runtime import streaming as JS
from repro.runtime import telemetry as JT
from repro_torch.bridge import tree_from_params
from repro_torch.configs import get_config
from repro_torch.data import RequestGenerator
from repro_torch.launch import serve
from repro_torch.models import init_cache, init_params
from repro_torch.runtime import faults as TF
from repro_torch.runtime import iopolicy as TIO
from repro_torch.runtime import streaming as TS
from repro_torch.runtime import telemetry as TT
from repro_torch.runtime.kvcache import BlockOffloader
from repro_torch.runtime.paramstore import ParamStore, save_param_store

CPU = torch.device("cpu")
FAST = TIO.IOPolicy(max_retries=3, backoff_base_s=0.002, backoff_max_s=0.01,
                    op_deadline_s=5.0, get_timeout_s=10.0)


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


def _fire_pattern(mod, schedule, calls, seed=0):
    """Which of ``calls`` ((op, key) pairs) raise, and what, under a
    schedule of ``(op, kwargs)`` specs."""
    inj = mod.FaultInjector([mod.FaultSpec(op=op, **kw)
                             for op, kw in schedule], seed=seed)
    out = []
    for op, key in calls:
        try:
            inj.check(op, key=key)
            out.append(None)
        except BaseException as e:           # noqa: BLE001 - recorded
            out.append((type(e).__name__, getattr(e, "stage", None)))
    return out, inj.counts(), inj.exhausted(), \
        [(f.op, f.key, f.mode, f.call_index) for f in inj.fired]


CASES = {
    "window": ([("layer_read", {"after": 2, "times": 2})],
               [("layer_read", i) for i in range(6)]),
    "key_scope": ([("layer_read", {"key": 1, "times": -1})],
                  [("layer_read", 0), ("kv_h2d", 1), ("layer_read", 1),
                   ("layer_read", 1), ("layer_read", 2)]),
    "seeded_prob": ([("layer_read", {"prob": 0.5, "times": -1})],
                    [("layer_read", i) for i in range(64)]),
    "stage_failure": ([("layer_read", {"mode": "stage_failure",
                                       "stage": 2})],
                      [("layer_read", 5), ("layer_read", 6)]),
    "short_read_and_overlap": ([("kv_disk2h", {"mode": "short_read"}),
                                ("kv_disk2h", {"times": 2}),
                                ("kv_d2disk", {"after": 1})],
                               [("kv_disk2h", ("p",)), ("kv_disk2h", None),
                                ("kv_d2disk", 0), ("kv_d2disk", 1),
                                ("kv_disk2h", 3), ("kv_disk2h", 4)]),
}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("seed", [0, 7])
def test_injector_fires_as_jax(case, seed):
    schedule, calls = CASES[case]
    got = _fire_pattern(TF, schedule, calls, seed)
    want = _fire_pattern(JF, schedule, calls, seed)
    assert got == want
    if case == "window":
        assert [i for i, r in enumerate(got[0]) if r] == [2, 3]
        assert got[2]                                     # exhausted
    if case == "seeded_prob":
        n = sum(r is not None for r in got[0])
        assert 0 < n < 64
        assert _fire_pattern(TF, schedule, calls, seed + 1)[0] != got[0]
    if case == "stage_failure":
        assert got[0][0] == ("StageFailure", 2)


def test_fault_spec_and_classes_match_jax():
    for mod in (TF, JF):
        with pytest.raises(ValueError, match="unknown fault op"):
            mod.FaultSpec(op="nope")
        with pytest.raises(ValueError, match="unknown fault mode"):
            mod.FaultSpec(op="kv_h2d", mode="nope")
    assert TF.OP_KINDS == JF.OP_KINDS and TF.MODES == JF.MODES
    assert FAST.classify(TF.InjectedFault("x")) == "transient"
    assert FAST.classify(TIO.StageFailure("dead")) == "fatal"
    # a delay succeeds after sleeping; a stall sleeps then raises
    inj = TF.FaultInjector([TF.FaultSpec(op="kv_h2d", mode="delay",
                                         delay_s=0.01),
                            TF.FaultSpec(op="kv_d2h", mode="stall",
                                         delay_s=0.01)])
    t0 = time.perf_counter()
    inj.check("kv_h2d")
    with pytest.raises(TF.InjectedFault):
        inj.check("kv_d2h")
    assert time.perf_counter() - t0 >= 0.02


# --------------------------------------------------------------------------- #
#  the streamed decode under layer-read faults
# --------------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def store():
    cfg = dataclasses.replace(get_config("qwen2.5-14b").reduced(),
                              n_layers=3)
    params = init_params(cfg, torch.Generator().manual_seed(0), device=CPU)
    d = tempfile.mkdtemp(prefix="test_torch_faults_")
    save_param_store(tree_from_params(params), cfg, d)
    yield cfg, d
    shutil.rmtree(d, ignore_errors=True)


def _stream_serve(cfg, source):
    reqs = RequestGenerator(cfg.vocab, prompt_len=(4, 9), max_new=5,
                            seed=3).generate(3)
    eng = TS.make_streaming_engine(source, cfg, 2, 32, device=CPU)
    fin, _ = eng.run(init_cache(cfg, 2, 32, device=CPU), reqs)
    return {f.uid: f.tokens for f in fin}


def test_transient_layer_faults_recover_byte_identical(store):
    cfg, d = store
    with TS.StreamingParamSource(ParamStore(d), window=2, device=CPU,
                                 policy=FAST) as src:
        clean = _stream_serve(cfg, src)
    inj = TF.FaultInjector([TF.FaultSpec(op="layer_read", after=4,
                                         times=3)])
    with TS.StreamingParamSource(TF.FaultyStore(ParamStore(d), inj),
                                 window=2, device=CPU, policy=FAST) as src:
        chaos = _stream_serve(cfg, src)
        stats = src.stats()
    assert chaos == clean                    # byte-identical recovery
    assert len(inj.fired) == 3               # the faults really fired
    assert all(f.op == "layer_read" for f in inj.fired)
    assert stats.retries >= 3                # visible in PrefetchStats


def test_permanent_fault_fails_fast_classified(store):
    cfg, d = store
    inj = TF.FaultInjector([TF.FaultSpec(op="layer_read", times=-1)])
    fstore = TF.FaultyStore(ParamStore(d), inj)
    pf = TS.LayerPrefetcher(fstore, window=2, device=CPU, policy=FAST)
    try:
        t0 = time.monotonic()
        with pytest.raises(RuntimeError, match="prefetch of layer") as ei:
            pf.get(0)
        assert time.monotonic() - t0 < 5.0   # fail fast, no hang
        fatal = TIO.find_cause(ei.value, TIO.FatalIOError)
        assert fatal is not None and fatal.attempts == FAST.max_retries + 1
        assert TIO.find_cause(ei.value, TF.InjectedFault) is not None
    finally:
        pf.close()
        fstore.close()
    # the proxy delegates everything but the reads
    with TF.FaultyStore(ParamStore(d), TF.FaultInjector([])) as fs:
        assert fs.n_layers == cfg.n_layers
        fs.willneed(0)
        assert fs.layer_bytes(0).numel() == fs.layer_nbytes


# --------------------------------------------------------------------------- #
#  the KV offloader's copies under faults
# --------------------------------------------------------------------------- #

def _page():
    return {"k": torch.arange(8, dtype=torch.float32).reshape(2, 4),
            "v": torch.ones((2, 4))}


@pytest.mark.parametrize("op,times", [("kv_h2d", 2), ("kv_d2h", 1)])
def test_offloader_copies_retry(op, times):
    inj = TF.FaultInjector([TF.FaultSpec(op=op, times=times)])
    off = BlockOffloader(policy=FAST, injector=inj, device=CPU)
    try:
        off.offload(("h",), _page())         # retried under the policy
        assert off.holds(("h",))
        off.schedule(("h",))
        out = off.get(("h",))
        assert torch.equal(out["k"], _page()["k"])
        assert off.health.retries == times and len(inj.fired) == times
        assert off.fetched_bytes > 0 and off.stats().retries == times
    finally:
        assert off.close() is True
        assert off.close() is True           # idempotent


def test_offloader_permanent_fault_fails_fast():
    inj = TF.FaultInjector([TF.FaultSpec(op="kv_h2d", times=-1)])
    off = BlockOffloader(policy=FAST, injector=inj, device=CPU)
    try:
        off.offload(("h",), _page())
        off.schedule(("h",))
        t0 = time.monotonic()
        with pytest.raises(RuntimeError, match="offload fetch") as ei:
            off.get(("h",))
        assert time.monotonic() - t0 < 5.0
        assert TIO.find_cause(ei.value, TIO.FatalIOError) is not None
    finally:
        assert off.close() is True
    assert off.memory.used("host") == 0


# --------------------------------------------------------------------------- #
#  the tracer's ingest adapters
# --------------------------------------------------------------------------- #

def _events(tr):
    """The tracer's events; a counter's own timestamp is the clock at the
    call, so it is left out."""
    return [(type(e).__name__, dataclasses.astuple(e)[:2] + (e.value,)
             if type(e).__name__ == "CounterEvent"
             else dataclasses.astuple(e)) for e in tr.events()]


def test_ingest_adapters_give_jax_events():
    now = time.perf_counter()
    prefetch = [(3, now, now + 0.5, 100), (0, now + 1, now + 1.25, 7)]
    fired = [("kv_d2disk", ("p", 1), "error", 0, now + 2),
             ("layer_read", 4, "short_read", 5, now + 3)]
    out = {}
    for name, T, S, F, IO in (("port", TT, TS, TF, TIO),
                              ("jax", JT, JS, JF, JIO)):
        tr = T.Tracer()
        assert tr.ingest_prefetch_events(
            [S.PrefetchEvent(*p) for p in prefetch]) == 2
        assert tr.ingest_prefetch_events(
            [S.PrefetchEvent(*prefetch[0])], track="kv-offloader",
            cat="kv", name="kv_h2d") == 1
        assert tr.ingest_fired_faults([F.FiredFault(*f) for f in fired]) \
            == 2
        health = IO.WorkerHealth(name="BlockOffloader", failures=3,
                                 retries=2, last_error="OSError: eio",
                                 last_progress_t=now - 1000.0)
        tr.ingest_worker_health(health)
        tr.ingest_worker_health(IO.WorkerHealth(
            last_progress_t=now - 1000.0), track="w")
        out[name] = _events(tr)
    assert out["port"] == out["jax"]
    assert len(out["port"]) == 11


# --------------------------------------------------------------------------- #
#  the serve driver's fault and tier flags
# --------------------------------------------------------------------------- #

SMALL = ["--smoke", "--device", "cpu", "--dtype", "f32", "--batch", "4",
         "--requests", "6", "--new-tokens", "6"]


def test_serve_cli_chaos_transient(capsys):
    res = serve.main(SMALL + ["--chaos", "transient", "--stream-window", "2",
                              "--store-quant", "q4", "--io-retries", "4",
                              "--io-backoff-ms", "1", "--chaos-faults", "3"])
    out = capsys.readouterr().out
    assert "chaos transient: 3 injected disk faults absorbed" in out
    assert "tokens byte-identical to the clean run" in out
    assert len(res["chaos"]["fired"]) == 3
    assert res["chaos"]["stats"].retries >= 3


def test_serve_cli_rejects_misplaced_flags():
    with pytest.raises(SystemExit):
        serve.parse_args(["--check-resident"])              # no streaming
    with pytest.raises(SystemExit):
        serve.parse_args(["--stream-window", "2", "--park-idle-s", "0"])
    with pytest.raises(SystemExit):
        serve.parse_args(["--arch", "mamba2-780m", "--device-budget", "1"])
    assert serve.io_policy(serve.parse_args(
        ["--io-retries", "5", "--io-backoff-ms", "20",
         "--io-deadline-s", "3"])) == TIO.IOPolicy(
        max_retries=5, backoff_base_s=0.02, backoff_max_s=0.1,
        op_deadline_s=3.0, get_timeout_s=6.0)
