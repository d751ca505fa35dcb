"""The port's compiled step (``runtime.engine.StepGraphs``): fixed-shape
decode and chunk steps replayed from CUDA graphs on the card.

On the CPU no graph exists, and the same step objects run the step on
their static buffers at every replay (the first run scrubbed, as a
capture). So these tests hold the buffer discipline a capture needs: a
graphed engine (``graphs=True``, the default) must give the JAX engine's
streams and the eager engine's (``graphs=False``) streams and page bytes;
the block table, lengths and token buffers must keep their addresses
through admissions, finishes, copy-on-write and speculative rollback; and
a replay must count the kernel launches its capture recorded once, the
capture's own not at all. ``chip_smoke.py`` replays the same steps from
real graphs on the card (phases 3, 5, 7, 9 and 12).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import model as JM
from repro.runtime.kvcache import make_paged_engine as j_paged_engine
from repro.runtime.speculative import SpeculativeDecoder as JSpec
from repro_torch.bridge import params_from_numpy, tree_from_params
from repro_torch.configs import get_config as t_get_config
from repro_torch.kernels import _build, ops
from repro_torch.models import model as TM
from repro_torch.runtime.engine import (GraphedDecode, StepGraphs,
                                        dense_decode, make_dense_engine,
                                        saved, write_dense_slot)
from repro_torch.runtime.kvcache import GraphedChunk, make_paged_engine
from repro_torch.runtime.paramstore import ResidentSource
from repro_torch.runtime.serve import quantize_ring_params
from repro_torch.runtime.speculative import SpeculativeDecoder
from repro_torch.runtime.streaming import make_streaming_engine

CPU = torch.device("cpu")
B, CTX, PAGE, N_PAGES, CHUNK, GAMMA = 2, 64, 8, 40, 8, 3


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


def _model(arch, seed, **kw):
    """(jcfg, tcfg, JAX params, the port's copy), reduced, 2 layers."""
    jcfg = dataclasses.replace(get_config(arch).reduced(), n_layers=2, **kw)
    tcfg = dataclasses.replace(t_get_config(arch).reduced(), n_layers=2,
                               **kw)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, tcfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp),
                                             device=CPU)


@pytest.fixture(scope="module")
def world():
    return {"target": _model("qwen2.5-14b", 0),
            "draft": _model("qwen1.5-0.5b", 7)}


class _Req:
    def __init__(self, uid, prompt, max_new):
        self.uid = uid
        self.prompt = prompt
        self.max_new_tokens = max_new


def _requests(vocab, shared=False):
    """Five requests, more than the slots, prompts 5-29 tokens (ragged
    last chunks); ``shared``: two of them on one 19-token prompt (prefix
    pages shared, copy-on-write at the divergence)."""
    rng = np.random.default_rng(3)
    reqs = [_Req(i, rng.integers(0, vocab, int(rng.integers(5, 30))),
                 int(rng.integers(4, 9))) for i in range(5)]
    if shared:
        p = np.random.default_rng(4).integers(0, vocab, 19)
        reqs[:2] = [_Req(0, p, 6), _Req(1, p.copy(), 6)]
    return reqs


_j_decode = jax.jit(JM.decode_step, static_argnums=1)


def _j_spec(draft):
    dcfg, _, dp, _ = draft

    def write_slot(cache, slot_cache, slot, length):
        def wr(dst, src):
            if dst.ndim >= 2 and dst.shape[1] == B and src.shape[1] == 1:
                return dst.at[:, slot].set(src[:, 0])
            return dst
        new = jax.tree.map(wr, cache, slot_cache)
        new["len"] = cache["len"].at[slot].set(slot_cache["len"][0])
        return new

    def prefill_one(prompt):
        c1 = JM.init_cache(dcfg, 1, CTX, dtype=jnp.float32)
        lg, c1 = JM.prefill(dp, dcfg, prompt, c1)
        return int(jnp.argmax(lg[0, -1])), c1

    return JSpec(lambda c, t: _j_decode(dp, dcfg, c, t), None, gamma=GAMMA,
                 draft_cache=JM.init_cache(dcfg, B, CTX, dtype=jnp.float32),
                 draft_prefill_one=prefill_one, draft_write_slot=write_slot)


def _t_spec(draft, graphs):
    """The port's decoder over the draft; its T = 1 step is graphed when
    the engine is (``dense_decode``, a step object of its own)."""
    _, dcfg, _, dp = draft

    def prefill_one(prompt):
        c1 = TM.init_cache(dcfg, 1, CTX, device=CPU)
        lg, c1 = TM.prefill(dp, dcfg, prompt, c1)
        return int(torch.argmax(lg[0, -1])), c1

    return SpeculativeDecoder(
        dense_decode(dp, dcfg, graphs=graphs, device=CPU), None,
        gamma=GAMMA, draft_cache=TM.init_cache(dcfg, B, CTX, device=CPU),
        draft_prefill_one=prefill_one, draft_write_slot=write_dense_slot)


def _streams(fin):
    return {f.uid: (list(f.tokens), f.proposed, f.accepted) for f in fin}


#: (id, kv dtype, chunk, shared prompts, spec)
CASES = [("chunked", "bfloat16", CHUNK, False, False),
         ("int8_chunked", "int8", CHUNK, False, False),
         ("prefix_cow", "bfloat16", None, True, False),
         ("prefix_cow_chunked_spec", "bfloat16", CHUNK, True, True)]


def _run_jax(world, kv_dtype, chunk, shared, spec):
    jcfg, _, jp, _ = world["target"]
    jcfg = dataclasses.replace(jcfg, kv_dtype=kv_dtype)
    js = _j_spec(world["draft"]) if spec else None
    eng, kv = j_paged_engine(jp, jcfg, B, CTX, n_pages=N_PAGES,
                             page_tokens=PAGE, offload=False, spec=js,
                             prefill_chunk=chunk)
    if js is not None:
        js.verify = eng.decode
    try:
        fin, _ = eng.run(kv.init_cache(), _requests(jcfg.vocab, shared))
        return _streams(fin), kv.stats()
    finally:
        kv.close()


def _run_port(world, kv_dtype, chunk, shared, spec, graphs, watch=False,
              cache_dtype=torch.float32):
    """A port paged engine's run; returns (streams, stats, final cache,
    engine). ``watch``: assert at every decode call that the cache holds
    the tensors it started with, and that each token buffer, once made,
    keeps its address."""
    _, tcfg, _, tp = world["target"]
    tcfg = dataclasses.replace(tcfg, kv_dtype=kv_dtype)
    ts = _t_spec(world["draft"], graphs) if spec else None
    eng, kv = make_paged_engine(tp, tcfg, B, CTX, n_pages=N_PAGES,
                                page_tokens=PAGE, spec=ts,
                                prefill_chunk=chunk, graphs=graphs,
                                cache_dtype=cache_dtype, device=CPU)
    if ts is not None:
        ts.verify = eng.decode
    cache = kv.init_cache()
    if watch:
        ptrs = {k: cache[k].data_ptr() for k in ("block_table", "len")}
        draft_len = ts.draft_cache["len"].data_ptr() if ts else None
        bufs = {}
        step, calls = eng.decode, []

        def decode(c, t):
            assert {k: c[k].data_ptr() for k in ptrs} == ptrs
            if ts is not None:
                assert ts.draft_cache["len"].data_ptr() == draft_len
            out = step(c, t)
            for T, buf in step.tokens.items():
                assert bufs.setdefault(T, buf.data_ptr()) == buf.data_ptr()
            assert out[1] is c
            calls.append(t.shape[1])
            return out
        eng.decode = decode
        if ts is not None:
            ts.verify = decode
    fin, _ = eng.run(cache, _requests(tcfg.vocab, shared))
    kv.pool.check()
    assert kv.pool.n_active == 0
    if watch:
        assert calls and {k: cache[k].data_ptr() for k in ptrs} == ptrs
        assert set(bufs) == ({GAMMA + 1} if spec else {1})
    return _streams(fin), kv.stats(), cache, eng


@pytest.mark.parametrize("kv_dtype,chunk,shared,spec",
                         [c[1:] for c in CASES], ids=[c[0] for c in CASES])
def test_graphed_paged_engine_matches_jax_and_eager(world, kv_dtype, chunk,
                                                    shared, spec):
    """Streams (and spec counts) equal the JAX engine's and the eager
    engine's; every page byte (the sink page's too: a capture restores
    it) equals the eager run's at the end; the addresses hold."""
    want, jst = _run_jax(world, kv_dtype, chunk, shared, spec)
    eager, est, ecache, _ = _run_port(world, kv_dtype, chunk, shared, spec,
                                      graphs=False)
    got, gst, gcache, eng = _run_port(world, kv_dtype, chunk, shared, spec,
                                      graphs=True, watch=True)
    assert got == eager == want
    for name, arr in gcache["pages"].items():
        assert torch.equal(arr, ecache["pages"][name]), name
    assert (gst.prefix_hits, gst.cow_copies) == (est.prefix_hits,
                                                 est.cow_copies) == \
        (jst.prefix_hits, jst.cow_copies)
    if shared:
        assert gst.prefix_hits >= 2 and gst.cow_copies >= 1
    sg = eng.graphs
    assert set(k[1] for k in sg.replays if k[0] == "decode") == \
        ({GAMMA + 1} if spec else {1})
    if chunk:
        chunks = eng.chunk_step
        assert chunks.graphed > 0 and chunks.eager > 0
        assert {k for k in sg.replays if k[0] == "chunk"} == \
            {("chunk", True)}
        assert sg.replays[("chunk", True)] == chunks.graphed


def test_graphed_bf16_pool_equals_eager(world):
    """A bf16 page pool (the card's serve dtype), chunked: equal streams
    and page bytes, graphed and eager."""
    args = ("bfloat16", CHUNK, True, False)
    eager, _, ecache, _ = _run_port(world, *args, graphs=False,
                                    cache_dtype=torch.bfloat16)
    got, _, gcache, _ = _run_port(world, *args, graphs=True, watch=True,
                                  cache_dtype=torch.bfloat16)
    assert got == eager
    for name, arr in gcache["pages"].items():
        assert arr.dtype == torch.bfloat16 and torch.equal(
            arr, ecache["pages"][name])


def _dense_run(params, cfg, reqs, graphs, spec=None):
    eng = make_dense_engine(params, cfg, B, CTX, spec=spec, graphs=graphs,
                            device=CPU)
    if spec is not None:
        spec.verify = eng.decode
    cache = TM.init_cache(cfg, B, CTX, device=CPU)
    lens = cache["len"].data_ptr()
    fin, _ = eng.run(cache, reqs)
    assert cache["len"].data_ptr() == lens
    return _streams(fin), cache


@pytest.mark.parametrize("with_spec", [False, True],
                         ids=["vanilla", "spec"])
def test_graphed_dense_engine_equals_eager(world, with_spec):
    """The dense-cache step at T = 1 and, with a spec decoder, the
    target's verify at T = gamma + 1 and the draft's T = 1 step, graphed
    and eager: equal streams and counts, equal cache bytes."""
    _, tcfg, _, tp = world["target"]
    reqs = _requests(tcfg.vocab)
    out = {}
    for graphs in (False, True):
        spec = _t_spec(world["draft"], graphs) if with_spec else None
        out[graphs] = _dense_run(tp, tcfg, reqs, graphs, spec)
        if spec is not None:
            out[graphs] += (spec.draft_cache,)
    assert out[True][0] == out[False][0]
    for a, b in zip(out[True][1:], out[False][1:]):
        for name, arr in a["layers"].items():
            assert torch.equal(arr, b["layers"][name]), name


def test_graphed_ssm_and_resident_layerwise_equal_eager():
    """The ssm family's decode (its conv and state written in place, the
    whole state saved and restored around a capture) and the layer-wise
    step over a resident q4 tree, graphed and eager."""
    cfg = dataclasses.replace(t_get_config("mamba2-780m").reduced(),
                              n_layers=2)
    params = TM.init_params(cfg, torch.Generator().manual_seed(5),
                            device=CPU)
    reqs = _requests(cfg.vocab)
    runs = [_dense_run(params, cfg, reqs, graphs) for graphs in (False,
                                                                True)]
    assert runs[0][0] == runs[1][0]
    for name, arr in runs[0][1]["layers"].items():
        assert torch.equal(arr, runs[1][1]["layers"][name]), name

    tcfg = dataclasses.replace(t_get_config("qwen2.5-14b").reduced(),
                               n_layers=2)
    tp = TM.init_params(tcfg, torch.Generator().manual_seed(2), device=CPU)
    tree, _ = quantize_ring_params(tree_from_params(tp), tcfg, tp=1)
    out = {}
    for graphs in (False, True):
        eng = make_streaming_engine(ResidentSource(tree), tcfg, B, CTX,
                                    graphs=graphs, device=CPU)
        assert (eng.graphs is not None) == graphs
        cache = TM.init_cache(tcfg, B, CTX, device=CPU)
        fin, _ = eng.run(cache, _requests(tcfg.vocab))
        out[graphs] = (_streams(fin), cache)
    assert out[True][0] == out[False][0]
    assert torch.equal(out[True][1]["layers"]["k"],
                       out[False][1]["layers"]["k"])


def test_replay_counts_launches_once_and_capture_none():
    """A stand-in step that bumps ``_build.LAUNCHES`` as a kernel wrapper
    does: each replay adds its capture's count once; the capture (and,
    on the card, its warm-up) adds nothing; a new T captures anew; a new
    cache drops the graphs. ``GraphedChunk`` runs ragged chunks eagerly,
    where the wrapper counts for itself."""
    ops.reset_launch_counts()
    scrubs = []

    def step(cache, tokens):
        _build.LAUNCHES["paged_verify"] += 2          # two kernels a step
        _build.LAUNCHES["q4_matmul"] += tokens.shape[1]
        return tokens.float() * 2, {**cache, "len": cache["len"] + 1}

    def scrub(cache, T):
        scrubs.append(T)
        return saved([cache["len"]], zero=[cache["len"]])

    sg = StepGraphs(CPU)
    g = GraphedDecode(step, sg, scrub)
    cache = {"len": torch.tensor([3, 5], dtype=torch.int32)}
    for n in range(1, 4):
        logits, c = g(cache, torch.tensor([[1], [2]]))
        assert c is cache and cache["len"].tolist() == [3 + n, 5 + n]
        assert ops.launch_counts()["paged_verify"] == 2 * n
        assert logits.tolist() == [[2.0], [4.0]]
    g(cache, torch.ones((2, 4), dtype=torch.int64))
    counts = ops.launch_counts()
    assert (counts["paged_verify"], counts["q4_matmul"]) == (8, 7)
    assert sg.captures == 2 and scrubs == [1, 4]
    assert sg.replays == {("decode", 1): 3, ("decode", 4): 1}
    g({"len": torch.zeros(2, dtype=torch.int32)}, torch.ones((2, 1)))
    assert sg.captures == 3 and scrubs == [1, 4, 1]
    assert ops.launch_counts()["paged_verify"] == 10

    ops.reset_launch_counts()

    def chunk(view, tokens, write):
        _build.LAUNCHES["paged_prefill"] += 1
        return tokens.float() + view["len"], view
    gc = GraphedChunk(chunk, sg, 4, max_pages=3, device=CPU)
    pages = {"k": torch.zeros((1, 2, 4))}
    for o, S in ((0, 4), (4, 4), (8, 2)):
        view = {"pages": pages, "len": torch.tensor([o]),
                "block_table": torch.tensor([[1, 0, 0]])}
        logits, _ = gc(view, torch.arange(S)[None], True)
        assert logits.tolist() == [[float(o + t) for t in range(S)]]
    assert (gc.graphed, gc.eager) == (2, 1)
    assert ops.launch_counts()["paged_prefill"] == 3
    assert sg.replays[("chunk", True)] == 2
    ops.reset_launch_counts()
