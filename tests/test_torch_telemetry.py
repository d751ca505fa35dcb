"""The port's span tracer and serving metrics against the JAX package's.

``repro_torch.runtime.telemetry`` and ``repro_torch.runtime.metrics`` are
copies of the JAX package's modules (which import no JAX): fed the same
scripted events on the same injected clock they must give equal Chrome
traces, stall records, histograms and snapshots. The port's engines
(paged, dense, streamed, on the CPU) must then emit what the JAX engines
emit on the same requests (the same span, counter and track names), in
traces and snapshots that the JAX package's own validators accept, and
``launch/serve.py --trace/--metrics-out`` must write files that both
packages' validators accept.
"""
import dataclasses
import itertools
import json
import shutil
import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.runtime.metrics as JMX
import repro.runtime.telemetry as JT
import repro_torch.runtime.metrics as TMX
import repro_torch.runtime.telemetry as TT
from repro.configs import get_config
from repro.models import model as JM
from repro.runtime import serve as j_serve
from repro.runtime import streaming as JS
from repro.runtime.engine import make_dense_engine as j_dense_engine
from repro.runtime.kvcache import make_paged_engine as j_paged_engine
from repro.runtime.paramstore import ParamStore as JParamStore
from repro.runtime.paramstore import save_param_store as j_save
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config as t_get_config
from repro_torch.models import model as TM
from repro_torch.runtime.engine import make_dense_engine
from repro_torch.runtime.kvcache import make_paged_engine
from repro_torch.runtime.paramstore import ParamStore
from repro_torch.runtime.streaming import (StreamingParamSource,
                                           make_streaming_engine)

CPU = torch.device("cpu")
B, CTX, PAGE, N_PAGES = 2, 64, 8, 32
#: the keys ``tests/test_metrics.py`` requires of an engine's snapshot
REQUIRED = ["request/ttft_s", "requests/finished"]


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


@pytest.fixture
def fake_clock(monkeypatch):
    """A scripted clock (0, 1, 2, ... ms) in each package, shared by its
    telemetry and metrics modules, so both see the same times."""
    for mods in ((JT, JMX), (TT, TMX)):
        ticks = itertools.count()

        def clock(ticks=ticks):
            return next(ticks) * 1e-3
        for mod in mods:
            monkeypatch.setattr(mod, "clock", clock)


def _script(tr, T):
    """The same events for either package's tracer (``T`` its module):
    nested phases inside token steps, spans, counters, instants, a phase
    under ``min_dur`` and one outside any step."""
    with tr.token_step(0, track="decode"):
        with tr.phase("compute", track="decode"):
            with tr.phase("disk_wait", track="decode", min_dur=2e-4,
                          label="disk_wait[3]"):
                pass
            tr.counter("spec/proposed", 4, track="decode")
        with tr.phase("h2d", cat="kv", track="decode"):
            pass
        with tr.phase("custom", track="decode"):        # -> "other"
            pass
    tr.span_event("layer_read[0]", T.clock(), T.clock(), cat="prefetch",
                  track="prefetcher", nbytes=128)
    with tr.span("admit[7]", cat="sched", track="decode", uid=7):
        tr.instant("reject[8]", cat="sched", track="decode", uid=8,
                   reason="pool too small")
    with tr.phase("compute"):                         # no open step
        pass
    with tr.token_step(1, track="decode", name="cycle[1]", uid=3):
        with tr.phase("staging_copy", min_dur=10.0):    # suppressed span
            pass
        tr.counter("store/released_bytes", 4096, track="prefetcher")


@pytest.mark.parametrize("capacity,sample", [(4096, 1.0), (5, 1.0),
                                             (4096, 0.5)])
def test_tracer_matches_jax(fake_clock, tmp_path, capacity, sample):
    """Equal Chrome traces (ring eviction and 1-in-N sampling included),
    equal stall records and summaries, and each package's validator
    accepts the other's export."""
    trs = []
    for T in (JT, TT):
        tr = T.Tracer(capacity=capacity, sample=sample)
        _script(tr, T)
        trs.append(tr)
    jt, tt = trs
    assert tt.chrome_trace() == jt.chrome_trace()
    assert [dataclasses.astuple(r) for r in tt.stalls()] == \
        [dataclasses.astuple(r) for r in jt.stalls()]
    assert tt.summary() == jt.summary()
    assert TT.format_summary(tt.summary()) == JT.format_summary(jt.summary())
    assert (tt.tracks(), tt.evicted) == (jt.tracks(), jt.evicted)
    for r in tt.stalls():
        assert r.accounted_s == pytest.approx(r.wall_s, abs=1e-12)
    path = tt.export_chrome_trace(str(tmp_path / "t.json"))
    want = JT.validate_chrome_trace(path, ("decode",))
    assert TT.validate_chrome_trace(path, ("decode",)) == want
    assert TT._main(["--validate", path, "--require", "decode"]) == 0


def test_trace_validator_rejects_like_jax(tmp_path):
    bad = {"missing.json": {"nope": []},
           "empty.json": {"traceEvents": []},
           "ph.json": {"traceEvents": [{"ph": "Q"}]},
           "dur.json": {"traceEvents": [{"ph": "X", "name": "a", "ts": 0,
                                         "pid": 1, "tid": 1, "dur": -1}]}}
    for name, doc in bad.items():
        p = tmp_path / name
        p.write_text(json.dumps(doc))
        for T in (JT, TT):
            with pytest.raises(ValueError):
                T.validate_chrome_trace(str(p))
    tr = TT.Tracer()
    tr.instant("x", track="decode")
    good = tr.export_chrome_trace(str(tmp_path / "good.json"))
    for T in (JT, TT):
        with pytest.raises(ValueError, match="required tracks missing"):
            T.validate_chrome_trace(good, ("prefetcher",))
    assert TT.NULL_TRACER.enabled is False
    with TT.NULL_TRACER.token_step(0) as step:
        assert step is None
    assert TT.resolve_tracer(None) is TT.NULL_TRACER


def _samples(seed):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.lognormal(-3.0, 1.5, 300), [0.0, 0.0, -1e-4],
                           rng.uniform(1.0, 5.0, 20)])


@pytest.mark.parametrize("growth", [1.1, 1.5])
def test_histograms_match_jax(growth):
    hs = [M.LogHistogram(growth) for M in (JMX, TMX)]
    others = [M.LogHistogram(growth) for M in (JMX, TMX)]
    for h, o in zip(hs, others):
        for v in _samples(1):
            h.observe(v)
        for v in _samples(2):
            o.observe(v)
        h.merge(o)
    qs = (0.0, 0.01, 0.25, 0.5, 0.9, 0.99, 0.999, 1.0)
    assert hs[1].quantiles(qs) == hs[0].quantiles(qs)
    assert hs[1].state() == hs[0].state()


def _drive_registry(M):
    """A registry and tracker through a scripted request lifecycle."""
    reg = M.MetricsRegistry(request_log_size=3)
    reg.add_source("engine", lambda: {"slots/active": 1.0,
                                      "kv/pages_free": 7.0})
    tr = M.RequestTracker(reg)
    for uid in range(5):
        tr.submit(uid, prompt_len=10 + uid)
    for uid in range(4):
        tr.admitted(uid, restored=uid == 3)
        tr.prefill_done(uid, 0.01 * (uid + 1))
        tr.prefill_chunks(uid, uid + 1)
        for _ in range(uid + 1):
            tr.token(uid)
        tr.step_done(0.002 * (uid + 1))
    tr.interleave_stall(0.125)
    for uid in range(3):
        tr.finished(uid)
    tr.rejected(4, "shed_capacity", "pool too small")
    tr.rejected(99, "deferred_ttl_expired")
    reg.inc("requests/rejected", reason="other")
    return reg


def test_registry_snapshot_matches_jax(fake_clock, tmp_path):
    """The same lifecycle gives equal snapshots, Prometheus text,
    percentiles and request logs; either validator takes either
    snapshot, and the port's CLI validates the export."""
    jreg, treg = _drive_registry(JMX), _drive_registry(TMX)
    js, ts = jreg.snapshot(), treg.snapshot()
    assert ts == js
    assert treg.prometheus_text() == jreg.prometheus_text()
    assert treg.percentile_summary() == jreg.percentile_summary()
    assert [dataclasses.astuple(t) for t in treg.request_log] == \
        [dataclasses.astuple(t) for t in jreg.request_log]
    assert treg.request_log_evicted == jreg.request_log_evicted == 2
    for validate in (JMX.validate_metrics_snapshot,
                     TMX.validate_metrics_snapshot):
        assert validate(ts, require=["request/ttft_s"]) == \
            JMX.validate_metrics_snapshot(js, require=["request/ttft_s"])
    path = treg.export_json(str(tmp_path / "m.json"))
    assert TMX.main(["--validate", path]) == 0
    assert TMX.main(["--validate", path, "--require", "no/such"]) == 1
    with pytest.raises(ValueError):
        TMX.Counter("c").inc(-1)


# --------------------------------------------------------------------------- #
#  the engines' instrumentation against the JAX engines'
# --------------------------------------------------------------------------- #

def _cfgs(n_layers=2):
    j = dataclasses.replace(get_config("qwen2.5-14b").reduced(),
                            n_layers=n_layers)
    t = dataclasses.replace(t_get_config("qwen2.5-14b").reduced(),
                            n_layers=n_layers)
    return j, t


class _Req:
    def __init__(self, uid, prompt, max_new, arrival_s=0.0):
        self.uid = uid
        self.prompt = prompt
        self.max_new_tokens = max_new
        self.arrival_s = arrival_s


def _requests(vocab, n=4):
    rng = np.random.default_rng(3)
    return [_Req(i, rng.integers(0, vocab, int(rng.integers(5, 20))), 4)
            for i in range(n)]


@pytest.fixture(scope="module")
def world():
    jcfg, tcfg = _cfgs()
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device=CPU)
    return jcfg, tcfg, jp, tp


def _names(tracer, tracks):
    """{(event kind, track, name without its [index])} on ``tracks``; a
    ``disk_wait`` span exists only where a wait outlasted 0.2 ms, so it
    is left out."""
    return {(type(ev).__name__, ev.track, ev.name.split("[")[0])
            for ev in tracer.events()
            if ev.track in tracks and not ev.name.startswith("disk_wait")}


def _check_instruments(ttr, treg, jtr, tracks, tmp_path):
    """The port's trace passes the JAX validator with ``tracks``, has the
    JAX engine's names on them, and every stall record partitions its
    step; the snapshot passes the JAX validator with the required keys
    and carries the JAX engine's counters and histograms."""
    path = ttr.export_chrome_trace(str(tmp_path / "trace.json"))
    JT.validate_chrome_trace(path, tracks)
    assert _names(ttr, tracks) == _names(jtr, tracks)
    stalls = ttr.stalls()
    assert stalls and all(r.accounted_s == pytest.approx(r.wall_s,
                                                         abs=1e-9)
                          for r in stalls)
    assert all(r.compute_s > 0 for r in stalls)
    snap = treg.snapshot()
    JMX.validate_metrics_snapshot(snap, require=REQUIRED)
    return snap


@pytest.mark.parametrize("chunk", [None, 8])
def test_paged_engine_trace_and_metrics_match_jax(world, tmp_path, chunk):
    """Both paged caches lease their pools on a tier manager and offload
    by default (the ``kv-memory`` track, the ``mem/`` and ``io/kv_retries``
    gauges): the names are equal, and the decode track is compared."""
    jcfg, tcfg, jp, tp = world
    reqs = _requests(jcfg.vocab)
    jtr, jreg = JT.Tracer(), JMX.MetricsRegistry()
    eng, kv = j_paged_engine(jp, jcfg, B, CTX, n_pages=N_PAGES,
                             page_tokens=PAGE, tracer=jtr, metrics=jreg,
                             prefill_chunk=chunk)
    try:
        fin_j, steps_j = eng.run(kv.init_cache(), reqs)
    finally:
        kv.close()
    ttr, treg = TT.Tracer(), TMX.MetricsRegistry()
    eng, kv = make_paged_engine(tp, tcfg, B, CTX, n_pages=N_PAGES,
                                page_tokens=PAGE, tracer=ttr, metrics=treg,
                                prefill_chunk=chunk, device=CPU)
    fin_t, steps_t = eng.run(kv.init_cache(), reqs)
    assert {f.uid: f.tokens for f in fin_t} == \
        {f.uid: f.tokens for f in fin_j}
    assert steps_t == steps_j
    snap = _check_instruments(ttr, treg, jtr, ("decode",), tmp_path)
    jsnap = jreg.snapshot()

    def counts(snap):               # seconds-valued counters are times
        return {k: v for k, v in snap["counters"].items()
                if not k.endswith("_s")}
    assert set(snap["counters"]) == set(jsnap["counters"])
    assert counts(snap) == counts(jsnap)
    assert {k: v["count"] for k, v in snap["histograms"].items()} == \
        {k: v["count"] for k, v in jsnap["histograms"].items()}
    assert set(snap["gauges"]) == set(jsnap["gauges"])
    assert {g for g in snap["gauges"] if g.startswith("mem/")} == {
        f"mem/{t}/{k}_bytes" for t in ("device", "host", "disk")
        for k in ("used", "peak")}
    assert len(ttr.stalls()) == len(jtr.stalls())


def test_dense_engine_trace_metrics_and_arrivals(world, tmp_path):
    """The dense engine's names equal the JAX engine's; an arrival-gated
    run gives the closed-loop streams, and TTFT counts from each
    request's arrival (request 1 arrives 50 ms after request 0, while
    request 0's admission still runs), in the engine's
    ``FinishedRequest`` and in the tracker's histogram alike."""
    jcfg, tcfg, jp, tp = world
    reqs = _requests(jcfg.vocab, n=3)
    jtr, jreg = JT.Tracer(), JMX.MetricsRegistry()
    fin_j, _ = j_dense_engine(jp, jcfg, B, CTX, tracer=jtr,
                              metrics=jreg).run(
        JM.init_cache(jcfg, B, CTX, dtype=jnp.float32), reqs)
    ttr, treg = TT.Tracer(), TMX.MetricsRegistry()
    eng = make_dense_engine(tp, tcfg, B, CTX, tracer=ttr, metrics=treg,
                            device=CPU)
    fin_t, steps = eng.run(TM.init_cache(tcfg, B, CTX, device=CPU), reqs)
    closed = {f.uid: f.tokens for f in fin_t}
    assert closed == {f.uid: f.tokens for f in fin_j}
    snap = _check_instruments(ttr, treg, jtr, ("decode",), tmp_path)
    assert snap["counters"] == jreg.snapshot()["counters"]
    assert snap["histograms"]["decode/step_s"]["count"] == steps

    late = [_Req(r.uid, r.prompt, r.max_new_tokens, 0.05 * r.uid)
            for r in reversed(reqs)]
    reg = TMX.MetricsRegistry()
    eng = make_dense_engine(tp, tcfg, B, CTX, metrics=reg, device=CPU)
    admit = eng.admit

    def slow_admit(*a, **k):      # the next request arrives meanwhile
        time.sleep(0.06)
        return admit(*a, **k)
    eng.admit = slow_admit
    fin_a, _ = eng.run(TM.init_cache(tcfg, B, CTX, device=CPU), late,
                       respect_arrivals=True)
    assert {f.uid: f.tokens for f in fin_a} == closed
    traces = {t.uid: t for t in reg.request_log}
    assert traces[1].submit_t - traces[0].submit_t >= 0.05 - 1e-3
    assert traces[2].submit_t - traces[0].submit_t >= 0.10 - 1e-3
    for f in fin_a:
        assert 0 <= f.ttft_s == pytest.approx(traces[f.uid].ttft_s,
                                              abs=5e-3)
    JMX.validate_metrics_snapshot(reg.snapshot(), require=REQUIRED)


@pytest.fixture(scope="module")
def q4_store():
    d = tempfile.mkdtemp(prefix="test_torch_telemetry_store_")
    jcfg, tcfg = _cfgs(3)
    params, _ = j_serve.quantize_ring_params(
        dict(JM.init_params(jcfg, jax.random.PRNGKey(2))), jcfg, tp=1)
    j_save(params, jcfg, d)
    yield jcfg, tcfg, d
    shutil.rmtree(d, ignore_errors=True)


def test_streamed_engine_trace_matches_jax(q4_store, tmp_path):
    """The streamed engine's decode and prefetcher tracks carry the JAX
    streamed engine's names. (The JAX engine is run without metrics: its
    gauge sample reads ``source.health.retries``, and its streamed
    source's ``health`` is a method.)"""
    jcfg, tcfg, d = q4_store
    reqs = _requests(jcfg.vocab, n=2)
    jtr = JT.Tracer()
    jsrc = JS.StreamingParamSource(JParamStore(d), window=1,
                                   device_put=False, tracer=jtr)
    try:
        fin_j, _ = JS.make_streaming_engine(
            jsrc, jcfg, B, CTX, tracer=jtr).run(
            JM.init_cache(jcfg, B, CTX, dtype=jnp.float32), reqs)
    finally:
        jsrc.close()
    ttr, treg = TT.Tracer(), TMX.MetricsRegistry()
    with StreamingParamSource(ParamStore(d), window=1, device="cpu",
                              tracer=ttr) as src:
        fin_t, _ = make_streaming_engine(
            src, tcfg, B, CTX, tracer=ttr, metrics=treg, device=CPU).run(
            TM.init_cache(tcfg, B, CTX, device=CPU), reqs)
    assert {f.uid: f.tokens for f in fin_t} == \
        {f.uid: f.tokens for f in fin_j}
    _check_instruments(ttr, treg, jtr, ("decode", "prefetcher"), tmp_path)
    assert ("SpanEvent", "prefetcher", "layer_read") in _names(
        ttr, ("prefetcher",))


@pytest.mark.parametrize("flags,tracks", [
    (["--paged-kv"], ("decode",)),
    (["--prefill-chunk", "8"], ("decode",)),
    (["--stream-window", "2", "--store-quant", "q4"],
     ("decode", "prefetcher")),
])
def test_serve_cli_trace_and_metrics(tmp_path, capsys, flags, tracks):
    """``python -m repro_torch.launch.serve --smoke --device cpu --trace
    t.json --metrics-out m.json --metrics-interval 2``: both packages'
    validators accept both files, and the rolling line is printed."""
    from repro_torch.launch import serve

    t, m = str(tmp_path / "t.json"), str(tmp_path / "m.json")
    res = serve.main(["--smoke", "--device", "cpu", "--dtype", "f32",
                      "--layers", "2", "--batch", "2", "--requests", "3",
                      "--new-tokens", "4", "--trace", t, "--metrics-out", m,
                      "--metrics-interval", "2", *flags])
    res = res["stream" if "--stream-window" in flags else "paged"]
    assert len(res["finished"]) == 3 and not res["rejected"]
    out = capsys.readouterr().out
    assert "stall attribution: tpot" in out and "[step 2]" in out
    for T in (JT, TT):
        T.validate_chrome_trace(t, tracks)
    for M in (JMX, TMX):
        M.validate_metrics_snapshot(m, require=REQUIRED)
