"""The port's streamed ring (``StreamingRingDriver`` over a layer store,
its banks staged by ``RingBankPrefetcher``) against its resident ring
(``RingServeStep``) on the same weights: logits within 1e-6 (f32, the
same products in the same order) and equal tokens, dense and padded, at
T = 1 and at the verify T, over bf16-free f32 and q4 stores, and the ssm
family; its residency, release, leases, trace tracks and retried faults.
It is also held against the JAX package's streamed ring
(``repro.runtime.streaming.StreamingRingDriver``, the driver
``tests/test_failover.py`` runs) on that file's setup: 8-layer reduced
qwen2.5-14b, B 8, M 4 (the JAX ring at tp 1 on 4 host devices), logits
within max|d|/max|ref| < 2e-4 and equal tokens. Also the driver's ring
path through ``serve.main`` (the resident ring beside the one-device
decode, the verify pass, the fallback where the batch does not split,
the one-process layout's tp refused). Everything runs on CPU tensors (the prefetcher stages
on the host).
"""
import dataclasses
import shutil
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import init_cache as j_init_cache
from repro.models import init_params as j_init_params
from repro.runtime import serve as JS
from repro.runtime.iopolicy import IOPolicy as JPolicy
from repro.runtime.paramstore import ParamStore as JParamStore
from repro.runtime.paramstore import save_param_store as j_save
from repro.runtime.streaming import StreamingRingDriver as JDriver
from repro_torch import bridge
from repro_torch.configs import get_config as t_get_config
from repro_torch.launch import serve as driver
from repro_torch.models import model as TM
from repro_torch.runtime import serve as RS
from repro_torch.runtime.faults import FaultInjector, FaultSpec, FaultyStore
from repro_torch.runtime.iopolicy import IOPolicy
from repro_torch.runtime.memory import TierManager
from repro_torch.runtime.paramstore import ParamStore, save_param_store
from repro_torch.runtime.streaming import StreamingRingDriver
from repro_torch.runtime.telemetry import Tracer

CPU = torch.device("cpu")
B, S, CTX, STEPS = 8, 4, 32, 6
FAST = IOPolicy(max_retries=3, backoff_base_s=0.002, backoff_max_s=0.01,
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


@pytest.fixture()
def tmp():
    dirs = []

    def make():
        dirs.append(tempfile.mkdtemp(prefix="test_torch_stream_ring_"))
        return dirs[-1]

    yield make
    for d in dirs:
        shutil.rmtree(d, ignore_errors=True)


def _model(arch, L, q4):
    cfg = dataclasses.replace(t_get_config(arch).reduced(), n_layers=L)
    params = TM.init_params(cfg, torch.Generator().manual_seed(0),
                            device=CPU)
    tree = bridge.tree_from_params(params)
    if q4:
        tree, skipped = RS.quantize_ring_params(tree, cfg, tp=1)
        assert not skipped
    return cfg, tree


def _greedy(step, cache, tok, n):
    toks, logits = [], []
    for _ in range(n):
        lg, cache = step(cache, tok)
        logits.append(lg)
        tok = lg.argmax(-1).to(torch.int32)
        toks.append(tok)
        tok = tok[:, -1:].expand(-1, lg.shape[1]).contiguous()
    return torch.stack(toks, 1), logits, cache


@pytest.mark.parametrize("arch,L,M,k,T,q4", [
    ("qwen2.5-14b", 8, 4, 2, 1, False),
    ("qwen2.5-14b", 8, 4, 2, 1, True),
    ("qwen2.5-14b", 7, 4, 1, 1, False),     # one zero layer pads to 8
    ("qwen2.5-14b", 8, 2, 2, 3, True),      # the verify pass
    ("mamba2-780m", 4, 2, 2, 1, True)])
def test_streamed_ring_equals_resident_ring(tmp, arch, L, M, k, T, q4):
    cfg, tree = _model(arch, L, q4)
    d = tmp()
    save_param_store(tree, cfg, d)
    plan = RS.RingPlan.make(cfg, M, k)
    step = RS.RingServeStep(cfg, plan, RS.ring_params(tree, cfg, plan),
                            n_tokens=T, graphs=False, device=CPU)
    tok = torch.randint(0, cfg.vocab, (B, T),
                        generator=torch.Generator().manual_seed(2),
                        dtype=torch.int32)
    want, want_lg, _ = _greedy(step, RS.init_ring_cache(cfg, plan, B, CTX,
                                                        device=CPU), tok,
                               STEPS)
    memory = TierManager(name="test")
    tracer = Tracer()
    store = ParamStore(d)
    drv = StreamingRingDriver(cfg, plan, store, n_tokens=T, device=CPU,
                              policy=FAST, tracer=tracer, memory=memory)
    try:
        got, got_lg, _ = _greedy(drv.step, RS.init_ring_cache(
            cfg, plan, B, CTX, device=CPU), tok, STEPS)
    finally:
        assert drv.close()
        store.close()
    assert torch.equal(got, want)
    for a, b in zip(got_lg, want_lg):
        assert float((a - b).abs().max()) <= 1e-6
    st = drv.stats()
    n = store.layer_nbytes
    assert len(st.events) == STEPS * cfg.n_layers     # each layer once a pass
    assert st.total_bytes_read == STEPS * cfg.n_layers * n
    assert st.peak_resident_bytes <= plan.L_pad * n
    assert st.releases == STEPS * cfg.n_layers
    assert all(s.used == 0 for s in memory.stats().values())   # balanced
    assert {"decode", "ring", "ring-prefetcher"} <= set(tracer.tracks())
    names = {e.name.split("[")[0] for e in tracer.events()
             if e.track == "ring"}
    assert {"embed", "microstep", "head"} <= names


def test_streamed_ring_peak_is_the_windows_ahead(tmp):
    """At M 4, k 2 (w 1) with banks 1 step ahead, the staged layers are
    those of the current bank and the next: at most 6 of the 8."""
    cfg, tree = _model("qwen2.5-14b", 8, True)
    d = tmp()
    save_param_store(tree, cfg, d)
    plan = RS.RingPlan.make(cfg, 4, 2)
    store = ParamStore(d)
    drv = StreamingRingDriver(cfg, plan, store, prefetch_depth=1,
                              device=CPU, policy=FAST)
    try:
        _greedy(drv.step, RS.init_ring_cache(cfg, plan, B, CTX, device=CPU),
                torch.zeros((B, 1), dtype=torch.int32), 2)
    finally:
        drv.close()
        store.close()
    peak = drv.stats().peak_resident_bytes
    assert 4 * store.layer_nbytes <= peak <= 6 * store.layer_nbytes


def test_streamed_ring_retries_transient_faults(tmp):
    cfg, tree = _model("qwen2.5-14b", 8, True)
    d = tmp()
    save_param_store(tree, cfg, d)
    plan = RS.RingPlan.make(cfg, 4, 1)
    tok = torch.zeros((B, 1), dtype=torch.int32)
    runs = []
    for faults in (0, 3):
        inj = FaultInjector([FaultSpec(op="layer_read", after=5,
                                       times=faults)])
        store = FaultyStore(ParamStore(d), inj)
        drv = StreamingRingDriver(cfg, plan, store, device=CPU, policy=FAST)
        try:
            runs.append(_greedy(drv.step, RS.init_ring_cache(
                cfg, plan, B, CTX, device=CPU), tok, 3)[0])
        finally:
            drv.close()
            store.close()
        assert len(inj.fired) == faults
        assert drv.stats().retries == faults
    assert torch.equal(runs[0], runs[1])


def test_streamed_ring_surfaces_a_fatal_read(tmp):
    cfg, tree = _model("qwen2.5-14b", 8, False)
    d = tmp()
    save_param_store(tree, cfg, d)
    plan = RS.RingPlan.make(cfg, 4, 1)
    inj = FaultInjector([FaultSpec(op="layer_read", mode="error",
                                   error_type=ValueError, after=3,
                                   times=1)])
    store = FaultyStore(ParamStore(d), inj)
    drv = StreamingRingDriver(cfg, plan, store, device=CPU, policy=FAST)
    try:
        with pytest.raises(RuntimeError, match="bank staging"):
            drv.step(RS.init_ring_cache(cfg, plan, B, CTX, device=CPU),
                     torch.zeros((B, 1), dtype=torch.int32))
    finally:
        assert drv.close()
        store.close()


@pytest.mark.parametrize("k", [1, 2])
def test_streamed_ring_matches_jax_driver(tmp, k):
    """``tests/test_failover.py``'s setup, both drivers over one store
    written by the JAX package: the prompt replayed a column a pass, then
    greedy steps."""
    jcfg = dataclasses.replace(get_config("qwen2.5-14b").reduced(),
                               n_layers=8)
    cfg = dataclasses.replace(t_get_config("qwen2.5-14b").reduced(),
                              n_layers=8)
    key = jax.random.PRNGKey(0)
    params = j_init_params(jcfg, key)
    d = tmp()
    j_save(params, jcfg, d)
    prompts = np.asarray(jax.random.randint(key, (B, S), 0, jcfg.vocab),
                         np.int32)
    M = 4
    jplan = JS.RingPlan.make(jcfg, M, k)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:M]).reshape(M, 1),
                             ("data", "model"))
    jcache = j_init_cache(jcfg, B, CTX, dtype=jnp.float32)
    jcache["layers"] = JS.pad_and_permute(jcache["layers"], jcfg, M, k)
    head = {n: v for n, v in JS.pad_vocab(dict(params), jcfg, 1).items()
            if n != "blocks"}
    jstore = JParamStore(d)
    jdrv = JDriver(jcfg, mesh, jplan, jstore, head_params=head,
                   cache_like=jcache, policy=JPolicy())
    plan = RS.RingPlan.make(cfg, M, k)
    store = ParamStore(d)
    drv = StreamingRingDriver(cfg, plan, store, device=CPU, policy=FAST)
    cache = RS.init_ring_cache(cfg, plan, B, CTX, device=CPU)
    ln = jcache["len"]
    cols = [prompts[:, t] for t in range(S)]
    try:
        for t in range(S + STEPS):
            col = cols[t]
            jl, jcache = jdrv.step(jnp.asarray(col).reshape(B, 1), ln,
                                   jcache)
            ln = ln + 1
            tl, cache = drv.step(cache, torch.tensor(col).reshape(B, 1))
            ref = np.asarray(jl[:, :, :jcfg.vocab], np.float32)
            rel = np.abs(tl.numpy() - ref).max() / np.abs(ref).max()
            assert rel < 2e-4, (t, rel)
            nxt = ref[:, 0].argmax(-1).astype(np.int32)
            assert np.array_equal(tl[:, 0].argmax(-1).numpy(), nxt)
            cols.append(nxt)
    finally:
        jdrv.close()
        drv.close()
        jstore.close()
        store.close()


# the driver's ring path through its entry point

@pytest.mark.parametrize("argv", [
    ["--stages", "4", "--ring-k", "2", "--verify-tokens", "4"],
    ["--arch", "mamba2-780m", "--stages", "2", "--ring-k", "2"],
    ["--stages", "3"]])
def test_driver_ring_path(argv, capsys):
    res = driver.main(["--smoke", "--device", "cpu", "--dtype", "f32",
                       "--new-tokens", "4", *argv])
    out = capsys.readouterr().out
    ring = res["ring"]
    if "3" in argv:      # 8 sequences do not split over 3 stages
        assert "ring unsupported" in out and ring is None
        return
    assert "ring decode (k=" in out and ring["tokens_equal"]
    if "--verify-tokens" in argv:
        assert "verify pass (T=4)" in out and ring["verify_ms"] > 0


def test_driver_refuses_tp():
    """The one-process ring refuses a tensor-parallel layout of a stage,
    naming the rank path that runs one (the driver's stream section runs
    its streamed ring there: ``tests/test_torch_stream_ranks.py``); a
    rank layout takes tp 2; the driver refuses a width under 1."""
    from repro_torch.launch.mesh import make_rank_layout, make_ring_layout

    with pytest.raises(ValueError, match="rank_stream_job"):
        make_ring_layout(4, 2, "cpu")
    assert make_ring_layout(4, 1, "cpu").tp == 1
    with pytest.raises(ValueError, match="pods, n_stages and tp >= 1"):
        make_rank_layout(4, 0, rank=0, device="cpu")
    with pytest.raises(SystemExit):
        driver.parse_args(["--tp", "0"])


def test_driver_ring_path_exits_on_a_token_mismatch(monkeypatch):
    """A one-device decode that disagrees with the ring makes the driver
    exit nonzero (f32 on the CPU: no split is allowed)."""
    one_device = driver.one_device_decode

    def skewed(weights, cfg, device):
        step = one_device(weights, cfg, device)

        def fn(cache, tokens):
            logits, cache = step(cache, tokens)
            logits = logits.clone()
            logits[..., 1] = logits.max() + 1.0     # always token 1
            return logits, cache
        return fn

    monkeypatch.setattr(driver, "one_device_decode", skewed)
    with pytest.raises(SystemExit, match="parity FAILED"):
        driver.main(["--smoke", "--device", "cpu", "--dtype", "f32",
                     "--new-tokens", "4", "--stages", "4"])


def test_ring_splits_finds_each_rows_first_difference():
    """``ring_splits``: per row, the first differing step, the reference's
    gap between the two tokens and the logit difference there, both over
    the reference's max|logit|."""
    def run(tokens, logits):
        return {"tokens": np.array(tokens, np.int32)[:, :, None],
                "logits": [torch.tensor(x)[:, None] for x in logits]}

    ref = run([[0, 1, 1], [2, 2, 2]],
              [[[4.0, 1.0, 0.0], [1.0, 0.0, 3.0]],
               [[0.0, 4.0, 3.9], [1.0, 0.0, 3.0]],
               [[0.0, 4.0, 1.0], [1.0, 0.0, 3.0]]])
    ring = run([[0, 2, 2], [2, 2, 2]],
               [[[4.0, 1.0, 0.0], [1.0, 0.0, 3.0]],
                [[0.0, 3.9, 4.0], [1.0, 0.0, 3.0]],
                [[0.0, 0.0, 9.0], [1.0, 0.0, 3.0]]])
    (row, step, gap, d), = driver.ring_splits(ring, ref)
    assert (row, step) == (0, 1)
    assert gap == pytest.approx(0.1 / 4) and d == pytest.approx(0.1 / 4)
