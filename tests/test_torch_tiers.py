"""The port's tiered KV memory against the JAX package's, on the CPU.

The same inputs (seeded numpy, the same weights through the bridge) go
through both packages: int8 page quantization, page files, the block
pool's eviction order, the host offloader under a host cap (spill to
disk and recall), paged engines small enough to evict (streams and
every tier counter equal), the pool sized from a device budget, random
park/restore schedules with and without injected disk faults, and the
engine's refusal to combine sessions with speculation. Runs as
``tests/test_memory.py`` runs the JAX package: reduced qwen2.5-14b at 2
layers, f32, 8-token pages.
"""
import dataclasses
import filecmp
import os
import threading

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import init_params as j_init_params
from repro.runtime import kvcache as JK
from repro.runtime.engine import ContinuousBatcher as JBatcher
from repro.runtime.faults import FaultInjector as JFaultInjector
from repro.runtime.faults import FaultSpec as JFaultSpec
from repro.runtime.iopolicy import FAST_TEST_POLICY as J_FAST
from repro.runtime.memory import MemoryBudget as JMemoryBudget
from repro.runtime.memory import TierManager as JTierManager
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config as t_get_config
from repro_torch.runtime import kvcache as TK
from repro_torch.runtime.engine import ContinuousBatcher
from repro_torch.runtime.faults import FaultInjector, FaultSpec
from repro_torch.runtime.iopolicy import (FAST_TEST_POLICY, BudgetExceeded,
                                          FatalIOError, find_cause)
from repro_torch.runtime.memory import MemoryBudget, TierManager

CPU = torch.device("cpu")
PT = 8          # page_tokens everywhere below
B, CTX = 2, 64


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
    j = dataclasses.replace(get_config("qwen2.5-14b").reduced(), n_layers=2)
    t = dataclasses.replace(t_get_config("qwen2.5-14b").reduced(),
                            n_layers=2)
    return j, t


class _Req:
    def __init__(self, uid, prompt, max_new, session=None):
        self.uid = uid
        self.prompt = prompt
        self.max_new_tokens = max_new
        self.session = session


@pytest.fixture(scope="module")
def world():
    jcfg, tcfg = _cfgs()
    jparams = j_init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                device=CPU)
    return {"jcfg": jcfg, "tcfg": tcfg, "jp": jparams, "tp": tparams}


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _as_torch(a: np.ndarray) -> torch.Tensor:
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _raw(t: torch.Tensor) -> bytes:
    return t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


def _page(rng, dtype, shape=(2, PT, 2, 16)):
    f = (rng.standard_normal(shape) * 3).astype(np.float32)
    f[0, 0, 0] = 0.0                      # an all-zero vector: scale 1
    return {"k": f.astype(dtype),
            "v": rng.integers(-5, 5, shape).astype(np.int8),
            "k_scale": rng.random(shape[:-1]).astype(dtype)}


# --------------------------------------------------------------------------- #
#  int8 pages and page files
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16])
def test_quantize_page_bytes_equal_jax(dtype):
    tree = _page(np.random.default_rng(0), dtype)
    want = JK.quantize_page(tree)
    got = TK.quantize_page({k: _as_torch(v) for k, v in tree.items()})
    assert sorted(got) == sorted(want) and TK.is_quantized_page(got)
    for name in want:
        assert got[name].dtype == (torch.int8 if "::" not in name
                                   else torch.float32)
        assert _raw(got[name]) == np.ascontiguousarray(want[name]).tobytes()
    tdt = torch.bfloat16 if dtype is ml_dtypes.bfloat16 else torch.float32
    back = TK.dequantize_page(got, tdt)
    jback = JK.dequantize_page(want, dtype)
    for name in jback:
        assert _raw(back[name]) == np.ascontiguousarray(jback[name]).tobytes()


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16])
def test_page_files_byte_identical_to_jax(dtype, tmp_path):
    tree = _page(np.random.default_rng(1), dtype)
    jstore = JK.PageFileStore(str(tmp_path / "jax"), policy=J_FAST)
    tstore = TK.PageFileStore(str(tmp_path / "port"),
                              policy=FAST_TEST_POLICY)
    ttree = {k: _as_torch(v) for k, v in tree.items()}
    assert tstore.put(("p", 0), ttree) == jstore.put(("p", 0), tree)
    assert filecmp.cmp(jstore._index[("p", 0)][0], tstore.path(("p", 0)),
                       shallow=False)
    back = tstore.get(("p", 0))                      # exact round trip
    for name, t in ttree.items():
        assert back[name].dtype == t.dtype and torch.equal(back[name], t)
    # a host page spills as its flat buffer: the same file again
    buf = torch.empty(TK.layout_nbytes(TK.page_layout(ttree)),
                      dtype=torch.uint8)
    specs = tstore.read_into(("p", 0), buf)
    tstore.put_flat(("p", 1), buf, specs)
    assert filecmp.cmp(tstore.path(("p", 0)), tstore.path(("p", 1)),
                       shallow=False)
    assert tstore.drop(("p", 0)) == jstore.drop(("p", 0))
    assert not tstore.holds(("p", 0)) and len(tstore) == 1
    tstore.close()
    jstore.close()
    assert len(tstore) == 0


def test_page_file_faults_retry_and_fatal(tmp_path):
    tree = {"k": torch.ones((1, PT, 4))}
    inj = FaultInjector([FaultSpec(op="kv_d2disk", times=2),
                         FaultSpec(op="kv_disk2h", times=2)])
    store = TK.PageFileStore(str(tmp_path), policy=FAST_TEST_POLICY,
                             injector=inj)
    store.put(("p",), tree)              # retries absorb the faults
    assert torch.equal(store.get(("p",))["k"], tree["k"])
    assert len(inj.fired) == 4 and store.health.retries == 4
    inj2 = FaultInjector([FaultSpec(op="kv_disk2h", times=-1)])
    store2 = TK.PageFileStore(str(tmp_path), policy=FAST_TEST_POLICY,
                              injector=inj2)
    store2.put(("q",), tree)
    with pytest.raises(FatalIOError):
        store2.get(("q",))
    # a truncated page file is a classified short read, not a shape crash
    with open(store.path(("p",)), "r+b") as f:
        f.truncate(8)
    with pytest.raises(FatalIOError, match="kv_disk2h"):
        store.get(("p",))


# --------------------------------------------------------------------------- #
#  the block pool's eviction order
# --------------------------------------------------------------------------- #

def _victims(mod, policy):
    """A scripted alloc/register/release/hit sequence; returns the pids
    evicted, in order."""
    costs = {}
    pool = mod.BlockPool(6, PT, evict_policy=policy,
                         recall_cost_fn=lambda h: costs[h])
    rng = np.random.default_rng(5)
    evicted = []
    pids = []
    for j in range(5):                     # fill the pool with keyed pages
        pid = pool.alloc()
        h = ("key", j)
        costs[h] = float(rng.choice([1e-4, 1e-3, 5e-3]))
        pool.register(h, pid)
        pids.append(pid)
    for pid in pids:
        pool.release(pid)                  # all cached, LRU by release
    for j in (3, 3, 1, 4):                 # reuse frequencies
        pool.lookup(("key", j))
    pool.note_hit(("key", 0))
    assert pool.available() == 5
    for _ in range(4):                     # each alloc evicts one
        pool.alloc(evict_cb=lambda p, h: evicted.append((p, h)))
    pool.check()
    return evicted, pool.evictions


@pytest.mark.parametrize("policy", ["lru", "cost"])
def test_victim_order_equals_jax(policy):
    got = _victims(TK, policy)
    assert got == _victims(JK, policy)
    assert got[1] == 4
    with pytest.raises(ValueError, match="evict_policy"):
        TK.BlockPool(4, PT, evict_policy="fifo")


# --------------------------------------------------------------------------- #
#  the host offloader under a host cap
# --------------------------------------------------------------------------- #

def _offload_run(mod, tmp_path, quant):
    """4 pages through a 2-page host cap with a disk tier: returns the
    recalled pages (numpy) and every counter."""
    rng = np.random.default_rng(3)
    trees = [{"k": rng.standard_normal((1, PT, 4)).astype(np.float32),
              "v": rng.standard_normal((1, PT, 4)).astype(np.float32)}
             for _ in range(4)]
    nb = sum(a.nbytes for a in
             (JK.quantize_page(trees[0]) if quant else trees[0]).values())
    if mod is TK:
        tm = TierManager(MemoryBudget(host=2 * nb))
        disk = TK.PageFileStore(str(tmp_path / "port"),
                                policy=FAST_TEST_POLICY)
        off = TK.BlockOffloader(policy=FAST_TEST_POLICY, memory=tm,
                                disk=disk, quant=quant, device=CPU)
        conv = lambda t: {k: torch.from_numpy(v) for k, v in t.items()}
    else:
        tm = JTierManager(JMemoryBudget(host=2 * nb))
        disk = JK.PageFileStore(str(tmp_path / "jax"), policy=J_FAST)
        off = JK.BlockOffloader(policy=J_FAST, memory=tm, disk=disk,
                                quant=quant)
        conv = lambda t: t
    try:
        for i, t in enumerate(trees):
            off.offload(i, conv(t))        # 2 spill through to disk
        used = (tm.used("host"), tm.used("disk"), len(disk))
        got = []
        for i in range(4):
            assert off.holds(i)
            off.schedule(i)
            got.append(_np(off.get(i, timeout=5.0)))
        st = off.stats()
        counts = (used, off.offloaded_bytes, off.fetched_bytes,
                  off.spilled_pages, off.fetched_disk_pages,
                  disk.written_bytes, disk.read_bytes,
                  tm.stats()["host"].peak, st.total_bytes_read,
                  st.layers_served, st.budget_refusals)
    finally:
        off.close()
    assert tm.used("host") == 0 and tm.used("disk") == 0
    tm.audit()
    return got, counts, trees


@pytest.mark.parametrize("quant", [False, True])
def test_offloader_spill_and_recall_equal_jax(quant, tmp_path):
    got, counts, trees = _offload_run(TK, tmp_path, quant)
    want, jcounts, _ = _offload_run(JK, tmp_path, quant)
    assert counts == jcounts
    assert counts[3] >= 2 and counts[4] >= 2          # spilled, recalled
    for g, w, t in zip(got, want, trees):
        for name in t:
            assert np.array_equal(g[name], w[name])
            if not quant:
                assert np.array_equal(g[name], t[name])


class _HoldH2D:
    """An injector that holds the worker inside its H2D copy (after it
    took the page's host buffer, before it read it) until ``go`` is set."""

    def __init__(self):
        self.entered = threading.Event()
        self.go = threading.Event()

    def check(self, op, key=None):
        if op == "kv_h2d":
            self.entered.set()
            assert self.go.wait(10.0)


def test_spill_of_a_page_mid_fetch_keeps_its_bytes(tmp_path):
    """The host tier holds one page, and the worker is copying it out when
    an eviction must spill: that page goes to disk, but its host buffer is
    not reused for the evicted page before the copy out of it ends, so
    both recalls hold their own bytes."""
    a = {"k": torch.full((1, PT, 4), 1.0)}
    b = {"k": torch.full((1, PT, 4), 2.0)}
    tm = TierManager(MemoryBudget(host=a["k"].numel() * 4))
    hold = _HoldH2D()
    off = TK.BlockOffloader(
        policy=FAST_TEST_POLICY, memory=tm, injector=hold, device=CPU,
        disk=TK.PageFileStore(str(tmp_path), policy=FAST_TEST_POLICY))
    try:
        off.offload("a", a)
        off.schedule("a")
        assert hold.entered.wait(10.0)   # the worker holds a's host buffer
        off.offload("b", b)              # host full, every page pending
        assert off.spilled_pages == 1 and tm.used("disk") > 0
        hold.go.set()
        assert torch.equal(off.get("a", timeout=5.0)["k"], a["k"])
        off.schedule("b")
        assert torch.equal(off.get("b", timeout=5.0)["k"], b["k"])
        assert off.fetched_disk_pages == 0   # a was staged from the host
    finally:
        hold.go.set()
        off.close()
    assert tm.used("host") == 0 and tm.used("disk") == 0
    assert len(off.disk) == 0
    tm.audit()


def test_offloader_host_cap_without_disk_raises_retryable():
    t = {"k": torch.ones((1, PT, 4))}
    nbytes = t["k"].numel() * 4
    tm = TierManager(MemoryBudget(host=2 * nbytes))
    off = TK.BlockOffloader(policy=FAST_TEST_POLICY, memory=tm, device=CPU)
    try:
        off.offload(0, t)
        off.offload(1, t)
        with pytest.raises(FatalIOError) as ei:
            off.offload(2, t)
        assert find_cause(ei.value, BudgetExceeded) is not None
        assert tm.stats()["host"].refusals >= 1
    finally:
        off.close()
    assert tm.used("host") == 0


# --------------------------------------------------------------------------- #
#  paged engines small enough to evict
# --------------------------------------------------------------------------- #

def _group_requests(vocab, n_groups=3, per=3, prefix=24, seed=0):
    """Round-robin over groups sharing a prompt prefix, so a group's
    prefix goes cold between its uses."""
    rng = np.random.default_rng(seed)
    prefs = [rng.integers(0, vocab, prefix) for _ in range(n_groups)]
    return [_Req(i, np.concatenate([prefs[i % n_groups],
                                    rng.integers(0, vocab,
                                                 int(rng.integers(3, 12)))]),
                 4) for i in range(n_groups * per)]


#: counters that do not depend on the offloader's worker thread's timing
COUNTERS = ("prefix_hits", "evictions", "offloaded_bytes", "fetched_bytes",
            "cow_copies", "n_pages", "active_pages_highwater")
#: counters of the disk tier: the JAX offloader may spill a page whose
#: fetch is pending, so there whether it is recalled from the host or the
#: disk depends on its worker's timing (the port keeps such a page on the
#: host); equal whenever no spill happens, and in the ``STAGED`` cases
DISK_COUNTERS = ("spilled_pages", "fetched_disk_pages", "disk_bytes_written",
                 "disk_bytes_read")

#: (n_pages, host budget in pages or None, engine keywords). With a disk
#: tier, cost eviction prices a page by the host tier's free bytes, which
#: the offloader's worker holds for a while during a disk recall: the
#: victims then depend on its timing, in both packages, so the spill
#: cases evict least recently used, but for ``STAGED``
ENGINES = {
    "offload": (10, None, {}),
    "offload_chunked": (10, None, {"prefill_chunk": 8}),
    "offload_quant": (10, None, {"offload_quant": True}),
    "offload_cost": (10, None, {"evict_policy": "cost"}),
    "host_spill_disk": (10, 3, {}),
    "host_spill_disk_chunked": (10, 3, {"prefill_chunk": 8}),
}
#: spill cases whose fetches are staged before the admit goes on (the
#: offloader's ``schedule`` returns once its worker has staged the page):
#: no copy is in flight at an eviction or a spill, nothing depends on the
#: worker's timing, and every counter, the disk tier's too, must equal
#: JAX's, under cost eviction as well
STAGED = {
    "host_spill_disk_staged": (8, 2, {}),
    "host_spill_disk_staged_cost_chunked": (8, 2, {"evict_policy": "cost",
                                                   "prefill_chunk": 8}),
}
ENGINES.update(STAGED)


def _stage_at_once(off):
    """Make ``off.schedule(h)`` return only once page ``h`` is staged (in
    either package: both keep staged pages in ``_staged`` under ``_cv``)."""
    schedule = off.schedule

    def staged(h):
        schedule(h)
        with off._cv:
            assert off._cv.wait_for(
                lambda: h in off._staged or off._error is not None, 10.0)
    off.schedule = staged


def _engine_run(world, pkg, name, tmp_path):
    n_pages, host_pages, kw = ENGINES[name]
    cfg = world["jcfg"] if pkg == "jax" else world["tcfg"]
    mod = JK if pkg == "jax" else TK
    page_bytes = 2 * PT * cfg.kv_heads * cfg.head_dim * 2 * 4
    kw = dict(kw)
    if host_pages is not None:
        Budget, Tiers = (JMemoryBudget, JTierManager) if pkg == "jax" \
            else (MemoryBudget, TierManager)
        kw["memory"] = Tiers(Budget(host=host_pages * page_bytes))
        kw["disk_dir"] = str(tmp_path / pkg)
    if pkg == "jax":
        eng, kv = mod.make_paged_engine(world["jp"], cfg, B, CTX,
                                        n_pages=n_pages, page_tokens=PT,
                                        **kw)
    else:
        eng, kv = mod.make_paged_engine(world["tp"], cfg, B, CTX,
                                        n_pages=n_pages, page_tokens=PT,
                                        device=CPU, **kw)
    assert kv.page_bytes == page_bytes
    if name in STAGED:
        _stage_at_once(kv.offloader)
    try:
        fin, _ = eng.run(kv.init_cache(), _group_requests(cfg.vocab))
        st = kv.stats()
        kv.pool.check()
        kv.memory.audit()
        if pkg == "port":
            # no page is both on the device and in a page file
            assert not set(kv.offloader._disk_keys) & set(kv.pool._pid_of)
    finally:
        kv.close()
    if pkg == "port":
        for tier in ("device", "host", "disk"):
            assert kv.memory.used(tier) == 0
    return {f.uid: f.tokens for f in fin}, \
        {k: getattr(st, k) for k in COUNTERS + DISK_COUNTERS}, st


@pytest.mark.parametrize("name", list(ENGINES))
def test_evicting_engine_equals_jax(world, name, tmp_path):
    """Under eviction the default engine recalls offloaded prefix pages,
    as the JAX engine does: equal streams and equal tier counters (with
    pages dropped instead, the prefix hits and bytes moved differ)."""
    want, jc, _ = _engine_run(world, "jax", name, tmp_path)
    got, tc, st = _engine_run(world, "port", name, tmp_path)
    assert got == want
    assert {k: tc[k] for k in COUNTERS} == {k: jc[k] for k in COUNTERS}
    assert tc["evictions"] > 0 and tc["fetched_bytes"] > 0
    if ENGINES[name][1] is None or name in STAGED:
        assert tc == jc
    if ENGINES[name][1] is None:
        assert tc["spilled_pages"] == 0
    else:
        assert tc["spilled_pages"] > 0 and tc["fetched_disk_pages"] > 0
        assert tc["disk_bytes_read"] == tc["fetched_disk_pages"] * \
            st.page_bytes
    assert len(st.fetch_events) > 0 and st.fetch_stall_s >= 0.0


def test_device_budget_sizes_pool_like_jax(world, tmp_path):
    jcfg, tcfg = world["jcfg"], world["tcfg"]
    rng = np.random.default_rng(11)
    reqs = [_Req(i, rng.integers(0, jcfg.vocab, int(rng.integers(4, 14))), 4)
            for i in range(6)]
    out = {}
    for pkg in ("jax", "port"):
        if pkg == "jax":
            _, kv0 = JK.make_paged_engine(world["jp"], jcfg, B, CTX,
                                          n_pages=4, page_tokens=PT)
        else:
            _, kv0 = TK.make_paged_engine(world["tp"], tcfg, B, CTX,
                                          n_pages=4, page_tokens=PT,
                                          device=CPU)
        pb = kv0.page_bytes
        kv0.close()
        # a budget that is not a whole number of pages: the pool rounds down
        budget = (10 * pb + pb // 2, 4 * pb)
        if pkg == "jax":
            tm = JTierManager(JMemoryBudget(device=budget[0],
                                            host=budget[1]))
            eng, kv = JK.make_paged_engine(
                world["jp"], jcfg, B, CTX, n_pages=None, page_tokens=PT,
                memory=tm, disk_dir=str(tmp_path / pkg))
        else:
            tm = TierManager(MemoryBudget(device=budget[0], host=budget[1]))
            eng, kv = TK.make_paged_engine(
                world["tp"], tcfg, B, CTX, n_pages=None, page_tokens=PT,
                memory=tm, disk_dir=str(tmp_path / pkg), device=CPU)
        try:
            fin, _ = eng.run(kv.init_cache(), reqs)
            tm.audit()
            stats = tm.stats()
            assert stats["device"].peak <= budget[0]
            assert stats["host"].peak <= budget[1]
            out[pkg] = (kv.pool.n_pages, stats["device"].peak,
                        {f.uid: f.tokens for f in fin})
        finally:
            kv.close()
        for tier in ("device", "host", "disk"):
            assert tm.used(tier) == 0
    assert out["port"] == out["jax"]
    assert out["port"][0] == 10
    with pytest.raises(ValueError, match="device budget"):
        TK.PagedKVCache(tcfg, batch=B, ctx=CTX, n_pages=None,
                        page_tokens=PT, device=CPU)


# --------------------------------------------------------------------------- #
#  random park/restore schedules (tests/test_memory.py:339 and :354)
# --------------------------------------------------------------------------- #

def _schedule(world, pkg, seed, tmp_path, chaos):
    """Random multi-turn sessions through a parking engine (turns
    interleaved in a seeded order, every session parked between its
    turns and demoted to disk at once, park_idle_s = 0); returns each
    session's concatenated stream, its uninterrupted stream, the kv
    stats and the tier manager."""
    cfg = world["jcfg"] if pkg == "jax" else world["tcfg"]
    rng = np.random.default_rng(seed)
    n_pages = B * (-(-CTX // PT)) + 2
    sessions = {}
    for s in range(3):
        total = int(rng.integers(4, 9))
        cut = int(rng.integers(2, total - 1))
        sessions[f"s{seed}-{s}"] = {
            "prompt": rng.integers(0, cfg.vocab, int(rng.integers(4, 18))),
            "turns": [cut, total - cut]}

    def build(**kw):
        if pkg == "jax":
            return JK.make_paged_engine(world["jp"], cfg, B, CTX,
                                        n_pages=n_pages, page_tokens=PT,
                                        **kw)
        return TK.make_paged_engine(world["tp"], cfg, B, CTX,
                                    n_pages=n_pages, page_tokens=PT,
                                    device=CPU, **kw)

    eng, kv = build()
    refs = {}
    for uid, (sid, spec) in enumerate(sessions.items()):
        fin, _ = eng.run(kv.init_cache(),
                         [_Req(uid, spec["prompt"], sum(spec["turns"]))])
        refs[sid] = [f for f in fin if f.uid == uid][0].tokens
    kv.close()
    FI, FS = (JFaultInjector, JFaultSpec) if pkg == "jax" \
        else (FaultInjector, FaultSpec)
    injector = FI([FS(op="kv_d2disk", times=2), FS(op="kv_disk2h", times=2)],
                  seed=seed) if chaos else None
    tm = JTierManager() if pkg == "jax" else TierManager()
    eng, kv = build(memory=tm, disk_dir=str(tmp_path / pkg),
                    park_idle_s=0.0,
                    io_policy=J_FAST if pkg == "jax" else FAST_TEST_POLICY,
                    injector=injector)
    cache = kv.init_cache()
    got = {sid: [] for sid in sessions}
    order = [(sid, t) for sid in sessions for t in range(2)]
    by_turn = {sid: 0 for sid in sessions}
    uid = 100
    while order:
        ready = [(sid, t) for sid, t in order if t == by_turn[sid]]
        sid, t = ready[int(rng.integers(len(ready)))]
        order.remove((sid, t))
        by_turn[sid] += 1
        spec = sessions[sid]
        fin, _ = eng.run(cache, [_Req(uid, spec["prompt"],
                                      spec["turns"][t], sid)])
        got[sid].extend([f for f in fin if f.uid == uid][0].tokens)
        uid += 1
    st = kv.stats()
    tm.audit()
    kv.close()
    return got, refs, st, tm, injector


@pytest.mark.parametrize("seed,chaos", [(0, False), (1, False), (2, False),
                                        (7, True)])
def test_random_park_restore_schedule_equals_jax(world, seed, chaos,
                                                 tmp_path):
    got, refs, st, tm, inj = _schedule(world, "port", seed, tmp_path, chaos)
    jgot, jrefs, jst, _, jinj = _schedule(world, "jax", seed, tmp_path,
                                          chaos)
    assert refs == jrefs
    for sid in refs:
        assert got[sid] == refs[sid], \
            f"session {sid}: split stream diverged from uninterrupted run"
    assert got == jgot
    assert st.parked_sessions >= 3 and st.restored_sessions >= 3
    assert st.disk_bytes_written > 0 and st.disk_bytes_read > 0
    assert (st.parked_sessions, st.restored_sessions, st.disk_bytes_written,
            st.disk_bytes_read) == (jst.parked_sessions,
                                    jst.restored_sessions,
                                    jst.disk_bytes_written,
                                    jst.disk_bytes_read)
    for tier in ("device", "host", "disk"):
        assert tm.used(tier) == 0, f"{tier} leaked {tm.used(tier)}B"
    if chaos:
        assert len(inj.fired) == len(jinj.fired) == 4


def test_sessions_and_speculation_refuse_each_other():
    eng = ContinuousBatcher(B, None, None, None, spec=object(), device=CPU)
    with pytest.raises(ValueError, match="speculative"):
        eng.admit(None, None, 0, np.arange(4), 2, session="s")
    with pytest.raises(ValueError, match="speculative"):     # as JAX's
        JBatcher(B, None, None, None, spec=object()).admit(
            None, None, 0, np.arange(4), 2, session="s")


def test_park_restore_bytes_and_refusal(world, tmp_path):
    """A parked session's pages come back bit-identical through both
    tiers, and a park that no tier can hold falls back to a plain finish
    (the next turn prefills from scratch)."""
    tcfg = world["tcfg"]
    rng = np.random.default_rng(4)
    prompt = rng.integers(0, tcfg.vocab, 20)
    eng, kv = TK.make_paged_engine(world["tp"], tcfg, B, CTX, n_pages=20,
                                   page_tokens=PT, device=CPU,
                                   disk_dir=str(tmp_path), park_idle_s=60.0)
    cache = kv.init_cache()
    eng.run(cache, [_Req(0, prompt, 3, "a")])
    ps = kv._parked["a"]
    assert ps.tier == "host" and kv.is_parked("a")
    parked = [_raw(t) for buf, specs in ps.pages
              for t in TK.page_tree(buf, specs).values()]
    kv.park_idle_s = 0.0
    assert kv.sweep_parked() == 1 and kv._parked["a"].tier == "disk"
    cache, meta, length = kv.restore_session(cache, 0, "a", max_new=2)
    assert length == 20 + 2 and "resume_token" in meta
    restored = [_raw(t) for pid in kv._slot_pages[0]
                for t in kv._page(cache, pid).values()]
    assert restored == parked
    kv.release_slot(0)
    kv.close()
    # no tier can hold it: a plain finish, nothing parked
    tm = TierManager(MemoryBudget(host=0))
    eng, kv = TK.make_paged_engine(world["tp"], tcfg, B, CTX, n_pages=20,
                                   page_tokens=PT, device=CPU, memory=tm,
                                   park_idle_s=0.0)
    fin, _ = eng.run(kv.init_cache(), [_Req(1, prompt, 3, "b")])
    assert len(fin[0].tokens) == 3 and not kv.is_parked("b")
    kv.close()
    tm.audit()
