"""The port's speculative decoding against the JAX package's, on the same
weights and requests.

``repro.models.init_params`` draws the weights and the bridge carries them
into the port. The port's spec engines (dense, paged with and without
chunked admission and with prefix sharing, streamed q4) must give the JAX
engines' token streams and the same per-request ``proposed``/``accepted``
counts, with a distinct draft and with a self-draft (which accepts every
draft). Everything runs on CPU tensors, so attention takes the plain
versions of kernels B5 and B1 (``chip_smoke.py`` phase 8 runs the same
engines through the kernels on the card).
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
from repro.models import model as JM
from repro.runtime import serve as j_serve
from repro.runtime import streaming as JS
from repro.runtime.engine import make_dense_engine as j_dense_engine
from repro.runtime.kvcache import make_paged_engine as j_paged_engine
from repro.runtime.paramstore import ParamStore as JParamStore
from repro.runtime.paramstore import save_param_store as j_save
from repro.runtime.speculative import SpeculativeDecoder as JSpec
from repro.runtime.speculative import \
    expected_tokens_per_cycle as j_expected
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config as t_get_config
from repro_torch.models import model as TM
from repro_torch.runtime.engine import (ContinuousBatcher,
                                        make_dense_engine, write_dense_slot)
from repro_torch.runtime.kvcache import make_paged_engine
from repro_torch.runtime.paramstore import ParamStore
from repro_torch.runtime.speculative import (SpeculativeDecoder,
                                             expected_tokens_per_cycle)
from repro_torch.runtime.streaming import (StreamingParamSource,
                                           make_streaming_engine)

CPU = torch.device("cpu")
REL = 2e-4
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


def _cfgs(arch, n_layers=2, **kw):
    j = dataclasses.replace(get_config(arch).reduced(), n_layers=n_layers,
                            **kw)
    t = dataclasses.replace(t_get_config(arch).reduced(), n_layers=n_layers,
                            **kw)
    return j, t


def _model(arch, seed, n_layers=2, **kw):
    """(jcfg, tcfg, JAX params, the port's copy of them)."""
    jcfg, tcfg = _cfgs(arch, n_layers, **kw)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(seed))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device=CPU)
    return jcfg, tcfg, jp, tp


@pytest.fixture(scope="module")
def world():
    """Targets (qwen2.5-14b GQA, qwen1.5-32b MHA with an int8 dense cache)
    and the qwen1.5-0.5b draft (tied embeddings), all reduced, 2 layers;
    the draft's vocab is the targets' (as in the published configs)."""
    return {"qwen2.5-14b": _model("qwen2.5-14b", 0),
            "qwen1.5-32b": _model("qwen1.5-32b", 1),
            "draft": _model("qwen1.5-0.5b", 7)}


class _Req:
    def __init__(self, uid, prompt, max_new):
        self.uid = uid
        self.prompt = prompt
        self.max_new_tokens = max_new


def _requests(vocab, n=4, max_new=(3, 9), seed=6):
    rng = np.random.default_rng(seed)
    return [_Req(i, rng.integers(3, vocab, int(rng.integers(4, 12))),
                 int(rng.integers(*max_new))) for i in range(n)]


def _shared_prompt_requests(vocab):
    prompt = np.random.default_rng(4).integers(0, vocab, 19)
    return [_Req(0, prompt, 7), _Req(1, prompt.copy(), 7)]


def _result(finished):
    """{uid: (tokens, proposed, accepted)}."""
    return {f.uid: (list(f.tokens), f.proposed, f.accepted)
            for f in finished}


# --------------------------------------------------------------------------- #
#  spec decoders of both packages over one draft
# --------------------------------------------------------------------------- #

#: the JAX decode step compiled once per shape (op-by-op dispatch makes
#: the reference engines slow on the CPU); the same math
_j_decode = jax.jit(JM.decode_step, static_argnums=1)


def _j_write_slot(cache, slot_cache, slot, length):
    def wr(dst, src):
        if dst.ndim >= 2 and dst.shape[1] == B and src.shape[1] == 1:
            return dst.at[:, slot].set(src[:, 0])
        return dst
    new = jax.tree.map(wr, cache, slot_cache)
    new["len"] = cache["len"].at[slot].set(slot_cache["len"][0])
    return new


def _j_spec(draft, gamma, verify=None, vocab=None, pad=0):
    dcfg, _, dp, _ = draft

    def d_decode(c, t):
        lg, c = _j_decode(dp, dcfg, c, t)
        return jnp.pad(lg, ((0, 0), (0, 0), (0, pad))), c

    def d_prefill_one(prompt):
        c1 = JM.init_cache(dcfg, 1, CTX, dtype=jnp.float32)
        lg, c1 = JM.prefill(dp, dcfg, prompt, c1)
        return int(jnp.argmax(lg[0, -1])), c1

    return JSpec(d_decode, verify, gamma=gamma,
                 draft_cache=JM.init_cache(dcfg, B, CTX, dtype=jnp.float32),
                 draft_prefill_one=d_prefill_one,
                 draft_write_slot=_j_write_slot, vocab=vocab)


def _t_spec(draft, gamma, verify=None, vocab=None, pad=0):
    _, dcfg, _, dp = draft

    def d_decode(c, t):
        lg, c = TM.decode_step(dp, dcfg, c, t)
        return torch.nn.functional.pad(lg, (0, pad)), c

    def d_prefill_one(prompt):
        c1 = TM.init_cache(dcfg, 1, CTX, device=CPU)
        lg, c1 = TM.prefill(dp, dcfg, prompt, c1)
        return int(torch.argmax(lg[0, -1])), c1

    return SpeculativeDecoder(
        d_decode, verify, gamma=gamma,
        draft_cache=TM.init_cache(dcfg, B, CTX, device=CPU),
        draft_prefill_one=d_prefill_one, draft_write_slot=write_dense_slot,
        vocab=vocab)


def _vanilla(target, reqs):
    """The port's vanilla greedy dense engine on the same requests."""
    _, tcfg, _, tp = target
    fin, _ = make_dense_engine(tp, tcfg, B, CTX, device=CPU).run(
        TM.init_cache(tcfg, B, CTX, device=CPU), reqs)
    return {f.uid: list(f.tokens) for f in fin}


def _dense_pair(target, draft, gamma, reqs):
    """The dense spec engine of both packages; returns their results and
    the two decoders."""
    jcfg, tcfg, jp, tp = target
    js = _j_spec(draft, gamma, lambda c, t: _j_decode(jp, jcfg, c, t))
    fin_j, _ = j_dense_engine(jp, jcfg, B, CTX, spec=js).run(
        JM.init_cache(jcfg, B, CTX, dtype=jnp.float32), reqs)
    ts = _t_spec(draft, gamma, lambda c, t: TM.decode_step(tp, tcfg, c, t))
    fin_t, _ = make_dense_engine(tp, tcfg, B, CTX, spec=ts,
                                 device=CPU).run(
        TM.init_cache(tcfg, B, CTX, device=CPU), reqs)
    return _result(fin_j), _result(fin_t), js, ts


# --------------------------------------------------------------------------- #
#  multi-token decode and rollback on the port's in-place caches
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("arch", ["qwen2.5-14b", "qwen1.5-32b",
                                  "qwen1.5-0.5b"])
def test_multi_token_decode_matches_sequential(world, arch):
    """A T = 4 verify pass gives the logits of 4 single steps (and, for
    qwen1.5-32b, the same int8 dense cache), and equals the JAX
    package's verify pass."""
    jcfg, tcfg, jp, tp = world["draft" if arch == "qwen1.5-0.5b" else arch]
    rng = np.random.default_rng(1)
    prompt = rng.integers(3, tcfg.vocab, (2, 5)).astype(np.int32)
    toks = rng.integers(3, tcfg.vocab, (2, 4)).astype(np.int32)

    def prefilled():
        c = TM.init_cache(tcfg, 2, 32, device=CPU)
        return TM.prefill(tp, tcfg, torch.as_tensor(prompt), c)[1]

    c_seq, refs = prefilled(), []
    for t in range(4):
        lg, c_seq = TM.decode_step(tp, tcfg, c_seq,
                                   torch.as_tensor(toks[:, t:t + 1]))
        refs.append(lg[:, 0])
    ref = torch.stack(refs, 1)
    out, c_v = TM.decode_step(tp, tcfg, prefilled(), torch.as_tensor(toks))
    assert float((out - ref).abs().max() / ref.abs().max()) < 1e-5
    np.testing.assert_array_equal(c_v["len"].numpy(), c_seq["len"].numpy())
    # the caches hold the same lines (f32 products summed in another
    # order over T rows; an int8 line may round one step apart)
    for name, arr in c_v["layers"].items():
        if arr.dtype == torch.int8:
            assert int((arr.int() - c_seq["layers"][name].int()).abs()
                       .max()) <= 1
        else:
            torch.testing.assert_close(arr.float(),
                                       c_seq["layers"][name].float(),
                                       rtol=1e-5, atol=1e-5)
    assert (c_v["layers"]["k"].dtype == torch.int8) == \
        (tcfg.kv_dtype == "int8")

    cj = JM.init_cache(jcfg, 2, 32, dtype=jnp.float32)
    _, cj = JM.prefill(jp, jcfg, jnp.asarray(prompt), cj)
    lj, _ = JM.decode_step(jp, jcfg, cj, jnp.asarray(toks))
    lj = np.asarray(lj, np.float32)
    a = out.float().numpy()
    assert np.abs(a - lj).max() / np.abs(lj).max() < REL
    np.testing.assert_array_equal(a.argmax(-1), lj.argmax(-1))


@pytest.mark.parametrize("arch", ["qwen1.5-32b", "qwen1.5-0.5b"])
def test_configs_match_jax(arch):
    """The port's copies of the spec pair's configs, field for field."""
    assert dataclasses.asdict(t_get_config(arch)) == \
        dataclasses.asdict(get_config(arch))


@pytest.mark.parametrize("arch", ["qwen2.5-14b", "qwen1.5-32b"])
def test_card_route_of_dense_attention(world, arch, monkeypatch):
    """The route a CUDA tensor takes through ``_dense_attention``: with
    kernels reported active, every decode and verify pass of every layer
    calls B5's wrapper (replaced here by its plain version, the CPU has no
    kernel) with int32 lengths; an int8 cache goes to it as stored, with
    its scales (the kernel widens it, no dequantized copy is made); the
    logits still match the JAX package's."""
    from repro_torch.kernels import flash_decode, ops

    jcfg, tcfg, jp, tp = world[arch]
    calls = []

    def stand_in(q, k, v, kv_len, *, window=None, k_scale=None,
                 v_scale=None):
        calls.append((q.shape[1], k.dtype, kv_len.dtype,
                      k_scale is not None and v_scale is not None))
        return flash_decode.flash_verify_ref(q, k, v, kv_len, window=window,
                                             k_scale=k_scale,
                                             v_scale=v_scale)

    monkeypatch.setattr(flash_decode, "flash_verify", stand_in)
    monkeypatch.setattr(ops, "kernels_active", lambda t: True)
    rng = np.random.default_rng(12)
    prompt = rng.integers(3, tcfg.vocab, (2, 6)).astype(np.int32)
    cj = JM.init_cache(jcfg, 2, 32, dtype=jnp.float32)
    _, cj = JM.prefill(jp, jcfg, jnp.asarray(prompt), cj)
    ct = TM.init_cache(tcfg, 2, 32, device=CPU)
    _, ct = TM.prefill(tp, tcfg, torch.as_tensor(prompt), ct)
    assert calls == []                            # prefill: no B5
    for T in (1, 3):
        toks = rng.integers(3, tcfg.vocab, (2, T)).astype(np.int32)
        lj, cj = JM.decode_step(jp, jcfg, cj, jnp.asarray(toks))
        lt, ct = TM.decode_step(tp, tcfg, ct, torch.as_tensor(toks))
        a, b = lt.float().numpy(), np.asarray(lj, np.float32)
        assert np.abs(a - b).max() / np.abs(b).max() < REL
        np.testing.assert_array_equal(a.argmax(-1), b.argmax(-1))
    L = tcfg.n_layers
    int8 = tcfg.kv_dtype == "int8"
    assert calls == [(T, torch.int8 if int8 else torch.float32, torch.int32,
                      int8) for T in (1, 3) for _ in range(L)]


def test_rollback_then_decode_matches_prefix(world):
    """After rejected drafts roll back, decoding from the rolled-back
    in-place cache equals decoding from a cache that never saw them."""
    _, tcfg, _, tp = world["qwen2.5-14b"]
    rng = np.random.default_rng(2)
    prompt = torch.as_tensor(rng.integers(3, tcfg.vocab, (2, 5)))
    toks = torch.as_tensor(rng.integers(3, tcfg.vocab, (2, 4)))
    probe = torch.as_tensor(rng.integers(3, tcfg.vocab, (2, 1)))

    def prefilled():
        c = TM.init_cache(tcfg, 2, 32, device=CPU)
        return TM.prefill(tp, tcfg, prompt, c)[1]

    c0 = prefilled()
    len0 = c0["len"].clone()
    _, c_spec = TM.decode_step(tp, tcfg, c0, toks)         # writes 4
    c_rb = TM.rollback_cache(c_spec, len0 + 2)
    c_ref = prefilled()
    for t in range(2):
        _, c_ref = TM.decode_step(tp, tcfg, c_ref, toks[:, t:t + 1])
    lg_rb, _ = TM.decode_step(tp, tcfg, c_rb, probe)
    lg_ref, _ = TM.decode_step(tp, tcfg, c_ref, probe)
    assert float((lg_rb - lg_ref).abs().max()
                 / lg_ref.abs().max()) < 1e-5
    np.testing.assert_array_equal(c_rb["len"].numpy(), c_ref["len"].numpy())


# --------------------------------------------------------------------------- #
#  the dense spec engine
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("arch", ["qwen2.5-14b", "qwen1.5-32b"])
def test_dense_spec_engine_matches_jax_distinct_draft(world, arch):
    """A distinct draft (qwen1.5-0.5b): the JAX engine's streams and
    per-request counts, and the vanilla greedy streams."""
    target = world[arch]
    reqs = _requests(target[1].vocab)
    want, got, js, ts = _dense_pair(target, world["draft"], 3, reqs)
    assert got == want
    assert (ts.cycles, ts.proposed, ts.accepted) == \
        (js.cycles, js.proposed, js.accepted)
    assert {u: r[0] for u, r in got.items()} == _vanilla(target, reqs)
    assert all(len(got[r.uid][0]) == r.max_new_tokens for r in reqs)
    assert sum(r[1] for r in got.values()) > 0


@pytest.mark.parametrize("arch", ["qwen2.5-14b", "qwen1.5-32b"])
def test_dense_spec_engine_self_draft_accepts_everything(world, arch):
    """Draft == target: every draft is accepted and a cycle emits
    gamma + 1 tokens, as in the JAX package."""
    target = world[arch]
    reqs = [_Req(0, np.random.default_rng(3).integers(3, 256, 5), 9)]
    want, got, js, ts = _dense_pair(target, target, 3, reqs)
    assert got == want
    tokens, proposed, accepted = got[0]
    assert tokens == _vanilla(target, reqs)[0]
    assert accepted == proposed > 0
    assert ts.acceptance_rate == 1.0
    assert ts.cycles == js.cycles == 2        # 8 later tokens, 4 a cycle


def test_spec_budget_truncation(world):
    """A cycle that overshoots the budget is cut: exactly max_new tokens,
    the vanilla ones, and the slot frees."""
    target = world["qwen2.5-14b"]
    reqs = [_Req(0, np.random.default_rng(4).integers(3, 256, 5), 3)]
    want, got, _, _ = _dense_pair(target, target, 3, reqs)
    assert got == want
    assert got[0][0] == _vanilla(target, reqs)[0]
    assert len(got[0][0]) == 3


def test_spec_slot_reuse_and_eos(world):
    """2 slots, 4 requests of different budgets: a slot freed mid-stream
    (budget or EOS) takes the next request, its draft cache included;
    the streams match the JAX engine's with an EOS id that occurs."""
    target = world["qwen2.5-14b"]
    jcfg, tcfg, jp, tp = target
    reqs = [_Req(i, np.random.default_rng(10 + i).integers(3, 256, 4), n)
            for i, n in enumerate([3, 9, 6, 4])]
    plain = _vanilla(target, reqs)
    eos = plain[1][3]                         # a token request 1 emits
    js = _j_spec(world["draft"], 2, lambda c, t: _j_decode(jp, jcfg, c, t))
    fin_j, _ = j_dense_engine(jp, jcfg, B, CTX, spec=js, eos_id=eos).run(
        JM.init_cache(jcfg, B, CTX, dtype=jnp.float32), reqs)
    ts = _t_spec(world["draft"], 2,
                 lambda c, t: TM.decode_step(tp, tcfg, c, t))
    eng = make_dense_engine(tp, tcfg, B, CTX, spec=ts, eos_id=eos,
                            device=CPU)
    fin_t, _ = eng.run(TM.init_cache(tcfg, B, CTX, device=CPU), reqs)
    assert _result(fin_t) == _result(fin_j)
    got = _result(fin_t)
    assert len(got) == 4 and eng.free_slots() == [0, 1]
    assert got[1][0][-1] == eos and len(got[1][0]) <= 4
    for r in reqs:
        want = plain[r.uid]               # the prefill's token is kept
        if eos in want[1:]:
            want = want[:want.index(eos, 1) + 1]
        assert got[r.uid][0] == want


def test_spec_padded_vocab_logits(world):
    """Logits padded past the vocabulary (a zero pad column would win
    whenever every real logit is negative) are trimmed before each argmax:
    a self-draft still accepts everything and the stream is vanilla's."""
    target = world["qwen2.5-14b"]
    jcfg, tcfg, jp, tp = target
    pad = 32
    reqs = [_Req(0, np.random.default_rng(5).integers(3, 256, 5), 8)]

    def j_verify(c, t):
        lg, c = _j_decode(jp, jcfg, c, t)
        return jnp.pad(lg, ((0, 0), (0, 0), (0, pad))), c

    def t_verify(c, t):
        lg, c = TM.decode_step(tp, tcfg, c, t)
        return torch.nn.functional.pad(lg, (0, pad)), c

    js = _j_spec(target, 2, j_verify, vocab=jcfg.vocab, pad=pad)
    ts = _t_spec(target, 2, t_verify, vocab=tcfg.vocab, pad=pad)
    fin_j, _ = j_dense_engine(jp, jcfg, B, CTX, spec=js).run(
        JM.init_cache(jcfg, B, CTX, dtype=jnp.float32), reqs)
    fin_t, _ = make_dense_engine(tp, tcfg, B, CTX, spec=ts,
                                 device=CPU).run(
        TM.init_cache(tcfg, B, CTX, device=CPU), reqs)
    assert _result(fin_t) == _result(fin_j)
    assert fin_t[0].tokens == _vanilla(target, reqs)[0]
    assert fin_t[0].acceptance_rate == 1.0


@pytest.mark.parametrize("a,g", [(0.0, 4), (1.0, 4), (0.75, 4), (0.8, 4),
                                 (0.75, 6), (0.3, 1), (0.5, 9)])
def test_expected_tokens_per_cycle(a, g):
    assert expected_tokens_per_cycle(a, g) == j_expected(a, g)
    assert 1.0 <= expected_tokens_per_cycle(a, g) <= g + 1
    if a == 0.75 and g == 4:
        assert 3.0 < expected_tokens_per_cycle(a, g) < 3.1


def test_spec_decoder_rejects_gamma_zero_and_sessions(world):
    with pytest.raises(ValueError, match="gamma"):
        SpeculativeDecoder(None, None, gamma=0)
    spec = _t_spec(world["draft"], 2)
    eng = ContinuousBatcher(B, None, None, None, spec=spec, device=CPU)
    assert eng.spec is spec
    with pytest.raises(ValueError, match="speculative"):
        eng.admit(None, None, 0, np.arange(4), 2, session="s")


# --------------------------------------------------------------------------- #
#  the paged spec engine
# --------------------------------------------------------------------------- #

N_PAGES, PAGE = 48, 8


def _paged_pair(target, draft, gamma, reqs, **kw):
    jcfg, tcfg, jp, tp = target
    js = _j_spec(draft, gamma)
    eng, kv = j_paged_engine(jp, jcfg, B, CTX, n_pages=N_PAGES,
                             page_tokens=PAGE, offload=False, spec=js, **kw)
    js.verify = eng.decode
    try:
        fin_j, _ = eng.run(kv.init_cache(), reqs)
        jst = kv.stats()
    finally:
        kv.close()
    ts = _t_spec(draft, gamma)
    eng, kv = make_paged_engine(tp, tcfg, B, CTX, n_pages=N_PAGES,
                                page_tokens=PAGE, spec=ts, device=CPU, **kw)
    ts.verify = eng.decode
    fin_t, _ = eng.run(kv.init_cache(), reqs)
    kv.pool.check()
    assert kv.pool.n_active == 0              # every slot released
    return _result(fin_j), _result(fin_t), jst, kv.stats()


@pytest.mark.parametrize("chunk", [None, 8])
@pytest.mark.parametrize("draft", ["distinct", "self"])
def test_paged_spec_engine_matches_jax(world, draft, chunk):
    """Each cycle reserves gamma + 1 positions (CoW on a shared last page),
    trims the pages past the accepted length, and the streams and counts
    equal the JAX paged engine's and the vanilla dense streams."""
    target = world["qwen2.5-14b"]
    reqs = _requests(target[1].vocab, max_new=(5, 12))
    d = world["draft"] if draft == "distinct" else target
    want, got, jst, tst = _paged_pair(target, d, 3, reqs,
                                      prefill_chunk=chunk)
    assert got == want
    assert {u: r[0] for u, r in got.items()} == _vanilla(target, reqs)
    assert (tst.active_pages_highwater, tst.active_tokens_highwater) == \
        (jst.active_pages_highwater, jst.active_tokens_highwater)
    if draft == "self":
        assert all(r[1] == r[2] > 0 for r in got.values())


@pytest.mark.parametrize("chunk", [None, 8])
def test_paged_spec_prefix_share_and_cow_match_jax(world, chunk):
    """Identical prompts share prompt pages; the first verify pass of
    each copies the shared last page on write: the same streams, counts,
    prefix hits and CoW copies as the JAX cache."""
    target = world["qwen2.5-14b"]
    reqs = _shared_prompt_requests(target[1].vocab)
    want, got, jst, tst = _paged_pair(target, world["draft"], 3, reqs,
                                      prefill_chunk=chunk)
    assert got == want
    assert got[0] == got[1]
    assert (tst.prefix_hits, tst.cow_copies) == (jst.prefix_hits,
                                                 jst.cow_copies)
    assert tst.prefix_hits == 3 and tst.cow_copies >= 1


# --------------------------------------------------------------------------- #
#  the streamed q4 spec engine
# --------------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def q4_store():
    """qwen1.5-32b reduced, 3 layers, quantized as the serve drivers do
    (every matmul weight q4, ``quantize_ring_params`` at tp=1), written
    by the JAX package."""
    d = tempfile.mkdtemp(prefix="test_torch_spec_store_")
    jcfg, tcfg = _cfgs("qwen1.5-32b", 3)
    params, _ = j_serve.quantize_ring_params(
        dict(JM.init_params(jcfg, jax.random.PRNGKey(2))), jcfg, tp=1)
    j_save(params, jcfg, d)
    yield jcfg, tcfg, d
    shutil.rmtree(d, ignore_errors=True)


def test_streamed_q4_spec_engine_matches_jax(world, q4_store):
    """The verify pass is ``decode_step_layerwise`` at T = gamma + 1: each
    layer is read once for the whole block. Streams and counts equal the
    JAX streaming engine's, and the vanilla streamed streams."""
    jcfg, tcfg, d = q4_store
    reqs = _requests(tcfg.vocab, n=3, max_new=(4, 8))
    jsrc = JS.StreamingParamSource(JParamStore(d), window=1,
                                   device_put=False)
    try:
        js = _j_spec(world["draft"], 3, lambda c, t:
                     JM.decode_step_layerwise(jsrc, jcfg, c, t))
        fin_j, _ = JS.make_streaming_engine(jsrc, jcfg, B, CTX,
                                            spec=js).run(
            JM.init_cache(jcfg, B, CTX, dtype=jnp.float32), reqs)
    finally:
        jsrc.close()
    results = {}
    for spec in (True, False):
        src = StreamingParamSource(ParamStore(d), window=1, device="cpu")
        try:
            ts = _t_spec(world["draft"], 3, lambda c, t:
                         TM.decode_step_layerwise(src, tcfg, c, t)) \
                if spec else None
            eng = make_streaming_engine(src, tcfg, B, CTX, spec=ts,
                                        device=CPU)
            fin, steps = eng.run(TM.init_cache(tcfg, B, CTX, device=CPU),
                                 reqs)
            st = eng.streaming_stats()
            # a prefill pass per request and one pass per step
            assert st.layers_served == tcfg.n_layers * (len(reqs) + steps)
            assert st.peak_resident_bytes <= src.store.layer_nbytes
        finally:
            src.close()
        results[spec] = _result(fin)
        if spec:
            assert ts.cycles == steps
    assert results[True] == _result(fin_j)
    assert {u: r[0] for u, r in results[True].items()} == \
        {u: r[0] for u, r in results[False].items()}

