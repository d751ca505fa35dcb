"""The MLA family (minicpm3-4b, reduced) in the port against the JAX
package, on the same weights carried across by ``bridge``: the model
(expanded prefill, absorbed decode at T = 1 and 3, rollback), the
dense-cache and paged engines (latent pages, one-shot and chunked
admission, graphed steps), the T = 5 verify over pages, the KV tiers
recalling latent pages, int8 latent pages refused, the q4 store streamed
against its resident dequantized weights, the ring (at k 2, the verify
pass and a q4 bank) and the driver's ``--smoke``. Logits within
max|d|/max|ref| < 2e-4, f32 on both sides; greedy streams equal.
"""
import dataclasses
import functools
import shutil
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import model as JM
from repro.runtime.kvcache import make_paged_engine as j_paged_engine
from repro_torch import bridge
from repro_torch.configs import get_config as t_get_config
from repro_torch.data import RequestGenerator
from repro_torch.kernels import ops
from repro_torch.kernels import q4_matmul as q4
from repro_torch.models import model as TM
from repro_torch.runtime import kvcache as TK
from repro_torch.runtime import serve as RS
from repro_torch.runtime.engine import make_dense_engine
from repro_torch.runtime.kvcache import make_paged_engine
from repro_torch.runtime.paramstore import (ParamStore, save_param_store,
                                           stack_layers)
from repro_torch.runtime.streaming import StreamingParamSource

ARCH = "minicpm3-4b"
CPU = torch.device("cpu")
B, CTX, PAGE, N_PAGES = 2, 64, 8, 32
REL = 2e-4


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


def _cfgs(n_layers=2, **kw):
    return (dataclasses.replace(get_config(ARCH).reduced(),
                                n_layers=n_layers, **kw),
            dataclasses.replace(t_get_config(ARCH).reduced(),
                                n_layers=n_layers, **kw))


@functools.lru_cache(maxsize=None)
def _world(n_layers=2):
    jcfg, tcfg = _cfgs(n_layers)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), device=CPU)
    return jcfg, tcfg, jp, tp


def _close(t_logits, j_logits):
    a = t_logits.detach().float().numpy()
    b = np.asarray(j_logits, np.float32)
    assert a.shape == b.shape
    rel = np.abs(a - b).max() / np.abs(b).max()
    assert rel < REL, rel
    np.testing.assert_array_equal(a.argmax(-1), b.argmax(-1))


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(3, vocab, shape).astype(
        np.int32)


def _requests(vocab, n=5, seed=3):
    return RequestGenerator(vocab, prompt_len=(4, 40), max_new=6,
                            seed=seed).generate(n)


def _streams(finished):
    return {f.uid: f.tokens for f in finished}


# --------------------------------------------------------------------------- #
#  the model
# --------------------------------------------------------------------------- #

def test_bridge_carries_the_mla_tree_both_ways():
    jcfg, tcfg, jp, tp = _world()
    attn = tp.blocks[0].attn
    assert isinstance(attn, TM.MLA)
    back = bridge.tree_from_params(tp)
    flat = jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray,
                                                             jp))[0]
    for path, leaf in flat:
        t = back
        for k in path:
            t = t[k.key]
        np.testing.assert_array_equal(t.numpy(), leaf)


def test_prefill_and_absorbed_decode_match_jax():
    """The expanded prefill fills the latent cache as JAX's; the absorbed
    decode at T = 3 (causal among its tokens) gives JAX's logits; after a
    rollback to one accepted token a T = 1 step agrees again."""
    T = 3
    jcfg, tcfg, jp, tp = _world()
    prompts = _tokens(1, (B, 11), jcfg.vocab)
    toks = _tokens(2, (B, T), jcfg.vocab)
    cj = JM.init_cache(jcfg, B, 32, dtype=jnp.float32)
    lj, cj = JM.prefill(jp, jcfg, jnp.asarray(prompts), cj)
    ct = TM.init_cache(tcfg, B, 32, device=CPU)
    lt, ct = TM.prefill(tp, tcfg, torch.as_tensor(prompts), ct)
    _close(lt, lj)
    np.testing.assert_allclose(ct["layers"]["latent"].numpy(),
                               np.asarray(cj["layers"]["latent"]),
                               rtol=1e-4, atol=1e-5)
    lj, cj = JM.decode_step(jp, jcfg, cj, jnp.asarray(toks))
    lt, ct = TM.decode_step(tp, tcfg, ct, torch.as_tensor(toks))
    _close(lt, lj)
    keep = np.asarray(cj["len"]) - T + 1
    probe = _tokens(4, (B, 1), jcfg.vocab)
    lj, _ = JM.decode_step(jp, jcfg, JM.rollback_cache(cj, jnp.asarray(keep)),
                           jnp.asarray(probe))
    lt, _ = TM.decode_step(tp, tcfg, TM.rollback_cache(ct, keep),
                           torch.as_tensor(probe))
    _close(lt, lj)


def test_decode_matches_forward():
    """Greedy decode over the latent cache reproduces the full-sequence
    forward's logits at every position (both packages)."""
    jcfg, tcfg, jp, tp = _world()
    seq = _tokens(5, (B, 12), jcfg.vocab)
    full = TM.forward(tp, tcfg, torch.as_tensor(seq))
    _close(full, JM.forward(jp, jcfg, jnp.asarray(seq)))
    c = TM.init_cache(tcfg, B, 32, device=CPU)
    lt, c = TM.prefill(tp, tcfg, torch.as_tensor(seq[:, :6]), c)
    torch.testing.assert_close(lt[:, 0], full[:, 5], rtol=0, atol=1e-4)
    for t in range(6, 12):
        lt, c = TM.decode_step(tp, tcfg, c, torch.as_tensor(seq[:, t:t + 1]))
        torch.testing.assert_close(lt[:, 0], full[:, t], rtol=0, atol=1e-4)


# --------------------------------------------------------------------------- #
#  the engines
# --------------------------------------------------------------------------- #

def test_paged_engine_matches_jax_and_dense():
    """Latent pages with chunked admission (chunks through the absorbed
    path), the decode step and full chunks replayed through
    ``StepGraphs``: streams equal to the JAX paged engine's and to the
    port's dense-cache engine's (one-shot admission: the tier and driver
    cases below)."""
    jcfg, tcfg, jp, tp = _world()
    reqs = _requests(tcfg.vocab)
    eng, kv = j_paged_engine(jp, jcfg, B, CTX, n_pages=N_PAGES,
                             page_tokens=PAGE, offload=False,
                             prefill_chunk=PAGE)
    try:
        fin_j, _ = eng.run(kv.init_cache(), reqs)
    finally:
        kv.close()
    eng, kv = make_paged_engine(tp, tcfg, B, CTX, n_pages=N_PAGES,
                                page_tokens=PAGE, prefill_chunk=PAGE,
                                device=CPU)
    try:
        assert set(kv.init_cache()["pages"]) == {"latent"}
        fin_t, _ = eng.run(kv.init_cache(), reqs)
        kv.pool.check()
        assert kv.pool.n_active == 0
    finally:
        kv.close()
    assert _streams(fin_t) == _streams(fin_j)
    assert eng.graphs.replays[("decode", 1)] > 0 and eng.chunk_step.graphed
    fin_d, _ = make_dense_engine(tp, tcfg, B, CTX, device=CPU).run(
        TM.init_cache(tcfg, B, CTX, device=CPU), reqs)
    assert _streams(fin_d) == _streams(fin_t)


def test_paged_verify_pass_equals_single_steps():
    """A T = 5 verify pass over latent pages gives the logits of 5 single
    paged steps from the same pages, and JAX's T = 5 pass."""
    from repro.runtime.kvcache import PagedKVCache as JKV

    jcfg, tcfg, jp, tp = _world()
    prompt = _tokens(6, (1, 13), jcfg.vocab)[0]
    toks = _tokens(7, (1, 5), jcfg.vocab)

    def admitted(kv, pkg):
        cache = kv.init_cache()
        kv.plan_admit(cache, 0, [int(t) for t in prompt], 8)
        if pkg == "jax":
            c1 = JM.init_cache(jcfg, 1, 32, dtype=jnp.float32)
            _, c1 = JM.prefill(jp, jcfg, jnp.asarray(prompt[None]), c1)
        else:
            c1 = TM.init_cache(tcfg, 1, 32, device=CPU)
            _, c1 = TM.prefill(tp, tcfg, torch.as_tensor(prompt[None]), c1)
        cache = kv.install(cache, 0, c1["layers"], len(prompt))
        return kv.begin_step(cache, [0], 5)

    tkv = TK.PagedKVCache(tcfg, batch=1, ctx=32, n_pages=12, page_tokens=4,
                          device=CPU)
    cache = admitted(tkv, "port")
    ln0 = cache["len"].clone()
    lt, cache = TM.decode_step_paged(tp, tcfg, cache, torch.as_tensor(toks))
    singles = []
    for t in range(5):
        TM.rollback_cache(cache, ln0 + t)
        l1, _ = TM.decode_step_paged(tp, tcfg, cache,
                                     torch.as_tensor(toks[:, t:t + 1]))
        singles.append(l1[:, 0])
    torch.testing.assert_close(lt[0], torch.cat(singles), rtol=0, atol=1e-5)
    jkv = JKV(jcfg, batch=1, ctx=32, n_pages=12, page_tokens=4,
              offload=False)
    lj, _ = JM.decode_step_paged(jp, jcfg, admitted(jkv, "jax"),
                                 jnp.asarray(toks))
    _close(lt, lj)
    tkv.close()


def test_tiers_recall_latent_pages_as_jax():
    """A pool small enough to evict: prefix pages of latent lines offload
    to the host and come back on the next use of their prefix, with the
    streams and the tier counters of the JAX engine."""
    sys.path.insert(0, "tests")
    from test_torch_tiers import COUNTERS, _group_requests

    jcfg, tcfg, jp, tp = _world()
    reqs = _group_requests(tcfg.vocab)
    eng, kv = j_paged_engine(jp, jcfg, B, CTX, n_pages=10, page_tokens=8)
    try:
        fin_j, _ = eng.run(kv.init_cache(), reqs)
        jst = kv.stats()
    finally:
        kv.close()
    eng, kv = make_paged_engine(tp, tcfg, B, CTX, n_pages=10, page_tokens=8,
                                device=CPU)
    try:
        fin_t, _ = eng.run(kv.init_cache(), reqs)
        tst = kv.stats()
        kv.pool.check()
    finally:
        kv.close()
    assert kv.page_bytes == tcfg.n_layers * 8 * (
        tcfg.kv_lora_rank + tcfg.qk_rope_dim) * 4
    assert _streams(fin_t) == _streams(fin_j)
    assert {k: getattr(tst, k) for k in COUNTERS} == \
        {k: getattr(jst, k) for k in COUNTERS}
    assert tst.evictions > 0 and tst.fetched_bytes > 0


def test_int8_latent_pages_refused_as_in_jax():
    from repro.runtime.kvcache import paged_cache_spec as j_spec

    jcfg, tcfg = _cfgs(kv_dtype="int8")
    with pytest.raises(NotImplementedError, match="int8"):
        j_spec(jcfg)
    with pytest.raises(NotImplementedError, match="int8"):
        TK.paged_cache_spec(tcfg)
    assert TK.paged_cache_spec(_cfgs()[1]) == {
        "latent": (tcfg.kv_lora_rank + tcfg.qk_rope_dim,)}


# --------------------------------------------------------------------------- #
#  the q4 store, streamed
# --------------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def q4_store():
    """The world's weights quantized as the serve drivers do
    (``quantize_ring_params`` at tp = 2: every latent projection, ``wo``
    and the FFN), in a layer store."""
    _, tcfg, _, tp = _world()
    d = tempfile.mkdtemp(prefix="test_torch_mla_q4_")
    params, skipped = RS.quantize_ring_params(bridge.tree_from_params(tp),
                                              tcfg, tp=2)
    assert not skipped
    save_param_store(params, tcfg, d)
    yield d, params
    shutil.rmtree(d, ignore_errors=True)


def test_streamed_q4_matches_resident_dequantized(q4_store):
    """JAX's ``test_streamed_q4_mla_matches_resident_dequantized`` on the
    port: the store streamed through the layer-wise MLA path (packed
    ``wo`` and FFN through ``layers.qmm``, the latent projections
    dequantized when the layer is pulled) gives the tokens of its
    dequantized weights resident."""
    from repro_torch.quant.grouped import dequantize_tree

    sdir, _ = q4_store
    _, tcfg, _, _ = _world()
    S, steps = 6, 3
    toks = _tokens(8, (B, S + steps), tcfg.vocab)
    src = StreamingParamSource(ParamStore(sdir), window=2, device="cpu")
    try:
        with ParamStore(sdir) as store:
            tree = dict(store.head(), blocks=stack_layers(
                [store.layer(i) for i in range(tcfg.n_layers)]))
        tdp = bridge.params_from_numpy(dequantize_tree(tree, torch.float32),
                                       device=CPU)
        cr = TM.init_cache(tcfg, B, 32, device=CPU)
        lr, cr = TM.prefill(tdp, tcfg, torch.as_tensor(toks[:, :S]), cr)
        cs = TM.init_cache(tcfg, B, 32, device=CPU)
        ls, cs = TM.prefill_layerwise(src, tcfg, torch.as_tensor(
            toks[:, :S]), cs)
        for t in range(S, S + steps + 1):
            assert torch.equal(lr[:, -1].argmax(-1), ls[:, -1].argmax(-1))
            torch.testing.assert_close(ls, lr, rtol=0, atol=1e-5)
            if t == S + steps:
                break
            tok = torch.as_tensor(toks[:, t:t + 1])
            lr, cr = TM.decode_step(tdp, tcfg, cr, tok)
            ls, cs = TM.decode_step_layerwise(src, tcfg, cs, tok)
    finally:
        src.close()


def _b3_calls(monkeypatch):
    """Report the kernels active and stand B3's plain version in for it,
    recording each call's (M, K, N)."""
    calls = []

    def stand_in(x, packed, scale, *, group):
        calls.append((x.shape[0], x.shape[1], packed.shape[1]))
        return q4.q4_matmul_ref(x, packed, scale, group=group)

    monkeypatch.setattr(q4, "q4_matmul", stand_in)
    monkeypatch.setattr(ops, "kernels_active", lambda t: True)
    return calls


def test_card_route_of_the_q4_projections(q4_store, monkeypatch):
    """With kernels reported active (a CUDA tensor's route), a layer-wise
    decode step sends 4 packed projections a layer to B3 (``wo``,
    ``w_gate``, ``w_up``, ``w_down``: the latent ones are dequantized when
    the layer is pulled), and a ring step 7 (the ring's ``layers.qmm``
    also takes ``wq_a``, ``wq_b`` and ``wkv_a``, as the JAX ring does):
    the logits equal the plain route's."""
    sdir, _ = q4_store
    _, tcfg, _, _ = _world()
    d, H, f = tcfg.d_model, tcfg.n_heads, tcfg.d_ff
    r_q, r_kv, dr = tcfg.q_lora_rank, tcfg.kv_lora_rank, tcfg.qk_rope_dim
    dn, dv = tcfg.qk_nope_dim, tcfg.v_head_dim
    tok = torch.as_tensor(_tokens(9, (B, 1), tcfg.vocab))
    with ParamStore(sdir) as store:
        cache = TM.init_cache(tcfg, B, 16, device=CPU)
        want, _ = TM.decode_step_layerwise(store, tcfg, cache, tok)
        blocks = [store.layer(i) for i in range(tcfg.n_layers)]
        head = store.head()
    tree = dict(head, blocks=stack_layers(blocks))
    plan = RS.RingPlan.make(tcfg, 2, 1)
    step = RS.RingServeStep(tcfg, plan, RS.ring_params(tree, tcfg, plan),
                            graphs=False, device=CPU)
    ring_want, _ = step(RS.init_ring_cache(tcfg, plan, B, 16, device=CPU),
                        tok)
    calls = _b3_calls(monkeypatch)
    with ParamStore(sdir) as store:
        got, _ = TM.decode_step_layerwise(
            store, tcfg, TM.init_cache(tcfg, B, 16, device=CPU), tok)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    ffn = [(B, d, f), (B, d, f), (B, f, d)]
    assert calls == ([(B, H * dv, d)] + ffn) * tcfg.n_layers
    calls.clear()
    ring_got, _ = step(RS.init_ring_cache(tcfg, plan, B, 16, device=CPU),
                       tok)
    torch.testing.assert_close(ring_got, ring_want, rtol=0, atol=1e-5)
    mb = B // 2
    layer = [(mb, d, r_q), (mb, r_q, H * (dn + dr)), (mb, d, r_kv + dr),
             (mb, H * dv, d)] + [(mb, d, f), (mb, d, f), (mb, f, d)]
    assert calls == layer * tcfg.n_layers * 2


# --------------------------------------------------------------------------- #
#  the ring
# --------------------------------------------------------------------------- #

def test_ring_step_matches_jax():
    """The ring's MLA layers (``mla_block``'s absorbed decode over each
    stage's latent lines) against the JAX ring on a device-list mesh at
    k 2: every step's logits within 2e-4 of max|ref|, tokens equal."""
    from test_torch_ring import _run_both

    assert _run_both(ARCH, 2, 2, n_layers=4) == 6


def test_ring_tokens_equal_one_device_decode():
    """The MLA ring at k 2 against the port's one-device decode from the
    same prefill, eager and replayed through ``StepGraphs``; then a T = 4
    verify pass through the ring against the one-device T = 4 step."""
    _, tcfg = _cfgs(4)
    params = TM.init_params(tcfg, torch.Generator().manual_seed(0),
                            device=CPU)
    prompts = torch.randint(0, tcfg.vocab, (4, 5),
                            generator=torch.Generator().manual_seed(1))
    cache = TM.init_cache(tcfg, 4, 32, device=CPU)
    logits, cache = TM.prefill(params, tcfg, prompts, cache)
    plan = RS.RingPlan.make(tcfg, 2, 2)
    rparams = RS.ring_params(params, tcfg, plan)
    ring = [{"len": cache["len"].clone(),
             "layers": RS.pad_and_permute(cache["layers"], tcfg, 2, 2)}
            for _ in range(2)]
    steps = [RS.RingServeStep(tcfg, plan, rparams, graphs=g, device=CPU)
             for g in (False, True)]
    tok = logits[:, -1:].argmax(-1)
    for _ in range(4):
        want, cache = TM.decode_step(params, tcfg, cache, tok)
        for i in range(2):
            got, ring[i] = steps[i](ring[i], tok)
            assert torch.equal(got.argmax(-1), want.argmax(-1))
            assert float((got - want).abs().max()) <= 1e-5
        tok = want.argmax(-1)
    assert steps[1].graphs.replays[("decode", 1)] == 4
    block = torch.randint(0, tcfg.vocab, (4, 4),
                          generator=torch.Generator().manual_seed(2))
    want, _ = TM.decode_step(params, tcfg, cache, block)
    verify = RS.RingServeStep(tcfg, plan, rparams, n_tokens=4, graphs=False,
                              device=CPU)
    got, _ = verify(ring[0], block)
    assert torch.equal(got.argmax(-1), want.argmax(-1))
    assert float((got - want).abs().max()) <= 1e-5


# --------------------------------------------------------------------------- #
#  the driver
# --------------------------------------------------------------------------- #

def test_driver_smoke_equals_jax_decode():
    """``python -m repro_torch.launch.serve --arch minicpm3-4b --smoke
    --device cpu`` on the JAX package's weights: its ring decode equals
    its one-device decode and the JAX one-device decode of the same
    batch."""
    from repro.data import RequestGenerator as JRequestGenerator
    from repro_torch.launch import serve as TS

    args = TS.parse_args(["--arch", ARCH, "--smoke", "--new-tokens", "6",
                          "--device", "cpu"])
    jcfg = get_config(ARCH).reduced()
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    res = TS.run(args, params=bridge.params_from_numpy(
        jax.tree.map(np.asarray, jp), device=CPU))
    assert res["ring"] is not None and res["ring"]["tokens_equal"]
    prompts = np.stack([r.prompt for r in JRequestGenerator(
        jcfg.vocab, seed=1, prompt_len=(16, 17)).generate(8)])
    cache = JM.init_cache(jcfg, 8, 64, dtype=jnp.float32)
    logits, cache = JM.prefill(jp, jcfg, jnp.asarray(prompts), cache)
    tok = jnp.argmax(logits[:, -1], -1)[:, None]
    want = [np.asarray(tok)]
    for _ in range(6):
        logits, cache = JM.decode_step(jp, jcfg, cache, tok)
        tok = jnp.argmax(logits[:, -1], -1)[:, None]
        want.append(np.asarray(tok))
    np.testing.assert_array_equal(res["decode"]["tokens"],
                                  np.concatenate(want, 1))
