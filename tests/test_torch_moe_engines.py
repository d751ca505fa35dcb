"""The port's engines, store and ring for the moe family against the JAX
package's, on the same weights (reduced mixtral-8x7b and phi3.5-moe, 2
layers unless a case says otherwise).

Engines: the dense-cache engine (also at cf = 1.25, where its prefill
drops rows over capacity and the paged engine's never does, in both
packages), the paged engine (one-shot and chunked admission, f32 and int8
pages, prefix sharing and copy-on-write), greedy speculation, and the
layer-wise engine streamed from a q4 store: token streams equal to the
JAX engines'. The store: both writers' bytes equal for the 4-D expert
stacks and a quantized router. The ring: the resident ring step against
``build_ring_serve_step`` (logits within max|d|/max|ref| < 2e-4, tokens
equal), and on a q4 bank against its own dequantized reference. The
card route of the expert matmuls: 3 * E kernel-B3 calls a layer at
M = C.

This file runs the engine cases for mixtral-8x7b (its ``world``);
``test_torch_moe_engines_phi.py`` imports them beside a phi3.5-moe
``world``, and ``test_torch_moe_engines_ring.py`` holds the store, the
ring and the dense spec engine: three files, so the test runner's
workers share the family's minutes and each arch's weights are built
once.
"""
import dataclasses
import functools
import shutil
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.data import RequestGenerator as JRequestGenerator
from repro.models import model as JM
from repro.runtime import serve as JRS
from repro.runtime import streaming as JS
from repro.runtime.engine import make_dense_engine as j_dense_engine
from repro.runtime.kvcache import make_paged_engine as j_paged_engine
from repro.runtime.paramstore import ParamStore as JParamStore
from repro.runtime.paramstore import save_param_store as j_save
from repro_torch import bridge
from repro_torch.configs import get_config as t_get_config
from repro_torch.data import RequestGenerator
from repro_torch.models import model as TM
from repro_torch.runtime.engine import make_dense_engine
from repro_torch.runtime.kvcache import make_paged_engine
from repro_torch.runtime.paramstore import ParamStore
from repro_torch.runtime.streaming import (StreamingParamSource,
                                           make_streaming_engine)

CPU = torch.device("cpu")
B, CTX, PAGE, N_PAGES = 2, 64, 8, 32


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


def _cfgs(arch, n_layers=2, **kw):
    return (dataclasses.replace(get_config(arch).reduced(),
                                n_layers=n_layers, **kw),
            dataclasses.replace(t_get_config(arch).reduced(),
                                n_layers=n_layers, **kw))


def _requests(vocab, n=5, seed=3):
    reqs = RequestGenerator(vocab, prompt_len=(4, 40), max_new=6,
                            seed=seed).generate(n)
    jreqs = JRequestGenerator(vocab, prompt_len=(4, 40), max_new=6,
                              seed=seed).generate(n)
    for a, b in zip(reqs, jreqs):
        np.testing.assert_array_equal(a.prompt, b.prompt)
    return reqs


def _streams(finished):
    return {f.uid: f.tokens for f in finished}


@functools.lru_cache(maxsize=None)
def _world(arch):
    jcfg, tcfg = _cfgs(arch)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), device=CPU)
    return {"arch": arch, "jcfg": jcfg, "tcfg": tcfg, "jp": jp, "tp": tp}


@pytest.fixture(scope="module", params=["mixtral-8x7b"])
def world(request):
    return _world(request.param)


# --------------------------------------------------------------------------- #
#  the dense-cache and paged engines
# --------------------------------------------------------------------------- #

def _dense_pair(world, cfg_kw=None, reqs=None):
    jcfg = dataclasses.replace(world["jcfg"], **(cfg_kw or {}))
    tcfg = dataclasses.replace(world["tcfg"], **(cfg_kw or {}))
    reqs = reqs or _requests(tcfg.vocab)
    fin_j, _ = j_dense_engine(world["jp"], jcfg, B, CTX).run(
        JM.init_cache(jcfg, B, CTX, dtype=jnp.float32), reqs)
    fin_t, _ = make_dense_engine(world["tp"], tcfg, B, CTX,
                                 device=CPU).run(
        TM.init_cache(tcfg, B, CTX, device=CPU), reqs)
    return _streams(fin_j), _streams(fin_t)


def _paged_pair(world, kv_dtype="bfloat16", reqs=None, cfg_kw=None, **kw):
    cfg_kw = dict(cfg_kw or {}, kv_dtype=kv_dtype)
    jcfg = dataclasses.replace(world["jcfg"], **cfg_kw)
    tcfg = dataclasses.replace(world["tcfg"], **cfg_kw)
    reqs = reqs or _requests(tcfg.vocab)
    eng, kv = j_paged_engine(world["jp"], jcfg, B, CTX, n_pages=N_PAGES,
                             page_tokens=PAGE, offload=False, **kw)
    try:
        fin_j, _ = eng.run(kv.init_cache(), reqs)
        jst = kv.stats()
    finally:
        kv.close()
    eng, kv = make_paged_engine(world["tp"], tcfg, B, CTX, n_pages=N_PAGES,
                                page_tokens=PAGE, device=CPU, **kw)
    try:
        fin_t, _ = eng.run(kv.init_cache(), reqs)
        kv.pool.check()
        assert kv.pool.n_active == 0
    finally:
        kv.close()
    return _streams(fin_j), _streams(fin_t), jst, kv.stats()


def test_dense_engine_matches_jax_and_paged(world):
    want, got = _dense_pair(world)
    assert got == want
    assert _paged_pair(world)[1] == want     # lossless: paged equals dense


def test_dense_engine_drops_where_jax_does(world):
    """At cf = 1.25 the dense engine's prefill drops rows over capacity:
    streams equal to the JAX dense engine's; the paged engine stays
    lossless in both packages and equals the JAX paged engine."""
    kw = {"moe_capacity_factor": 1.25}
    want, got = _dense_pair(world, kw)
    assert got == want
    jp, tp, _, _ = _paged_pair(world, cfg_kw=kw)
    assert tp == jp


@pytest.mark.parametrize("kv_dtype,kw", [
    ("bfloat16", {"prefill_chunk": 8}),
    ("int8", {}),
    ("int8", {"prefill_chunk": 8}),
])
def test_paged_engine_streams_match_jax(world, kv_dtype, kw):
    want, got, _, _ = _paged_pair(world, kv_dtype, **kw)
    assert got == want


class _Req:
    def __init__(self, uid, prompt, max_new):
        self.uid = uid
        self.prompt = prompt
        self.max_new_tokens = max_new


@pytest.mark.parametrize("chunk", [None, 8])
def test_prefix_share_and_cow_match_jax(world, chunk):
    prompt = np.random.default_rng(4).integers(0, world["tcfg"].vocab, 19)
    reqs = [_Req(0, prompt, 5), _Req(1, prompt.copy(), 5)]
    want, got, jst, tst = _paged_pair(world, reqs=reqs, prefill_chunk=chunk)
    assert got == want and got[0] == got[1]
    assert (tst.prefix_hits, tst.cow_copies) == (jst.prefix_hits,
                                                 jst.cow_copies)
    assert tst.prefix_hits == 3 and tst.cow_copies >= 1


def _spec_setup(world):
    """(target, draft, requests) in ``test_torch_speculative``'s tuple form:
    the moe target and the reduced qwen1.5-0.5b draft (same vocab)."""
    from test_torch_speculative import _model

    target = (world["jcfg"], world["tcfg"], world["jp"], world["tp"])
    reqs = _requests(world["tcfg"].vocab, n=3, seed=6)
    return target, _model("qwen1.5-0.5b", 7), reqs


def test_paged_spec_engine_matches_jax(world):
    """Greedy speculation over pages: the draft proposes 3 tokens, the moe
    target verifies them at T = 4 through the paged engine (lossless, a
    sliding window masked by position): results (tokens, proposed,
    accepted) equal the JAX paged spec engine's."""
    import test_torch_speculative as TS

    target, draft, reqs = _spec_setup(world)
    want, got, _, _ = TS._paged_pair(target, draft, 3, reqs)
    assert got == want
    assert sum(r[1] for r in got.values()) > 0


# --------------------------------------------------------------------------- #
#  the store and the streamed engine
# --------------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def q4_store(world):
    """The world's weights quantized as the serve drivers do
    (``quantize_ring_params`` at the drivers' tp = 2), written by the JAX
    package."""
    d = tempfile.mkdtemp(prefix="test_torch_moe_q4_")
    params, skipped = JRS.quantize_ring_params(dict(world["jp"]),
                                               world["jcfg"], tp=2)
    assert not skipped
    j_save(params, world["jcfg"], d)
    yield d
    shutil.rmtree(d, ignore_errors=True)


def test_streamed_q4_engine_matches_jax(world, q4_store):
    jcfg, tcfg = world["jcfg"], world["tcfg"]
    reqs = _requests(tcfg.vocab, n=4)
    jsrc = JS.StreamingParamSource(JParamStore(q4_store), window=1,
                                   device_put=False)
    try:
        fin_j, _ = JS.make_streaming_engine(jsrc, jcfg, B, CTX).run(
            JM.init_cache(jcfg, B, CTX, dtype=jnp.float32), reqs)
    finally:
        jsrc.close()
    src = StreamingParamSource(ParamStore(q4_store), window=1, device="cpu")
    try:
        eng = make_streaming_engine(src, tcfg, B, CTX, device=CPU)
        fin_t, steps = eng.run(TM.init_cache(tcfg, B, CTX, device=CPU), reqs)
        st = eng.streaming_stats()
        assert st.peak_resident_bytes <= src.store.layer_nbytes
        assert st.layers_served == tcfg.n_layers * (len(reqs) + steps)
    finally:
        src.close()
    assert _streams(fin_t) == _streams(fin_j)


@pytest.mark.parametrize("cf,C", [(None, 6), (1.25, 3)])
def test_card_route_of_the_expert_matmuls(world, q4_store, monkeypatch, cf,
                                          C):
    """With kernels reported active (the route of a CUDA tensor), a
    layer-wise prefill of 6 tokens sends every q4 projection to kernel
    B3's wrapper (its plain version stands in): 4 attention projections
    and 3 * E expert products a layer, every expert at M = C (6 lossless,
    3 at cf = 1.25), and the logits equal the plain route's."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import q4_matmul as q4

    tcfg = dataclasses.replace(world["tcfg"], moe_capacity_factor=cf)
    calls = []

    def stand_in(x, packed, scale, *, group):
        calls.append((x.shape[0], x.shape[1], packed.shape[1]))
        return q4.q4_matmul_ref(x, packed, scale, group=group)

    prompt = torch.as_tensor(np.random.default_rng(11).integers(
        3, tcfg.vocab, (1, 6)).astype(np.int32))
    with ParamStore(q4_store) as store:
        want, _ = TM.prefill_layerwise(store, tcfg, prompt,
                                       TM.init_cache(tcfg, 1, 16, device=CPU))
        monkeypatch.setattr(q4, "q4_matmul", stand_in)
        monkeypatch.setattr(ops, "kernels_active", lambda t: True)
        got, _ = TM.prefill_layerwise(store, tcfg, prompt,
                                      TM.init_cache(tcfg, 1, 16, device=CPU))
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    d, H, hk, hd, f, E = (tcfg.d_model, tcfg.n_heads, tcfg.kv_heads,
                          tcfg.head_dim, tcfg.d_ff, tcfg.n_experts)
    layer = [(6, d, H * hd), (6, d, hk * hd), (6, d, hk * hd),
             (6, H * hd, d)] + [(C, d, f)] * (2 * E) + [(C, f, d)] * E
    assert calls == layer * tcfg.n_layers
