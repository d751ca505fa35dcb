"""The vlm family (qwen2-vl-2b, reduced: M-RoPE, QKV bias, tied
embeddings, 2 layers) in the port against the JAX package, on the same
weights carried across by ``bridge``: ``apply_mrope`` over three distinct
position streams, prefill with prepended patch embeddings, decode at T = 1
and 3, the paged engine (f32 and int8 pages), the layer-wise engine over
a q4 store and the route of its packed projections, the ring at k 2 and
the driver's ``--smoke``. Logits within max|d|/max|ref| < 2e-4, f32 on
both sides; greedy streams equal.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import layers as JL
from repro.models import model as JM
from repro.runtime.kvcache import make_paged_engine as j_paged_engine
from repro_torch import bridge
from repro_torch.configs import get_config as t_get_config
from repro_torch.data import RequestGenerator
from repro_torch.kernels import ops
from repro_torch.kernels import q4_matmul as q4
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.runtime import serve as RS
from repro_torch.runtime.engine import make_dense_engine
from repro_torch.runtime.kvcache import make_paged_engine
from repro_torch.runtime.paramstore import ResidentSource
from repro_torch.runtime.streaming import make_streaming_engine

ARCH = "qwen2-vl-2b"
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
def _world():
    jcfg, tcfg = _cfgs()
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


def _streams(finished):
    return {f.uid: f.tokens for f in finished}


def _requests(vocab, n=5, seed=3):
    return RequestGenerator(vocab, prompt_len=(4, 40), max_new=6,
                            seed=seed).generate(n)


@pytest.mark.parametrize("head_dim", [16, 128])
def test_apply_mrope_three_distinct_streams_equals_jax(head_dim):
    """Temporal, height and width streams that differ (a patch grid), so
    a frequency index driven by the wrong section would show; the
    sections of head dim 128 are (16, 24, 24)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 3, head_dim)).astype(np.float32)
    pos = np.stack([np.full((2, 7), 5), np.arange(14).reshape(2, 7) // 3,
                    np.arange(14).reshape(2, 7) % 3 + 40]).astype(np.int32)
    assert TL.mrope_sections(head_dim) == JL.mrope_sections(head_dim)
    want = JL.apply_mrope(jnp.asarray(x), jnp.asarray(pos), 1e6)
    got = TL.apply_mrope(torch.as_tensor(x), torch.as_tensor(pos), 1e6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    one = TL.apply_rope(torch.as_tensor(x), torch.as_tensor(pos[1]), 1e6)
    assert not torch.allclose(got, one, atol=1e-3)
    same = TL.apply_mrope(torch.as_tensor(x), torch.as_tensor(pos[1])[None]
                          .expand(3, 2, 7), 1e6)
    torch.testing.assert_close(same, one, rtol=0, atol=1e-6)


def test_prefill_with_patches_and_distinct_positions_matches_jax():
    """A prefill of 6 patch embeddings and 5 tokens at three distinct
    position streams, then decode steps (one stream broadcast to three,
    from ``len``): the cache and logits equal JAX's."""
    jcfg, tcfg, jp, tp = _world()
    rng = np.random.default_rng(1)
    embeds = rng.standard_normal((B, 6, jcfg.d_model)).astype(np.float32)
    toks = _tokens(2, (B, 5), jcfg.vocab)
    grid = np.arange(11)
    pos = np.stack([np.minimum(grid, 6), np.where(grid < 6, grid // 3, grid),
                    np.where(grid < 6, grid % 3, grid)])
    pos = np.broadcast_to(pos[:, None], (3, B, 11)).astype(np.int32)
    cj = JM.init_cache(jcfg, B, 32, dtype=jnp.float32)
    lj, cj = JM.prefill(jp, jcfg, jnp.asarray(toks), cj,
                        embeds=jnp.asarray(embeds), positions=jnp.asarray(pos))
    ct = TM.init_cache(tcfg, B, 32, device=CPU)
    lt, ct = TM.prefill(tp, tcfg, torch.as_tensor(toks), ct,
                        embeds=torch.as_tensor(embeds),
                        positions=torch.as_tensor(pos))
    _close(lt, lj)
    np.testing.assert_allclose(ct["layers"]["k"].numpy(),
                               np.asarray(cj["layers"]["k"]), rtol=1e-4,
                               atol=1e-4)
    for T in (1, 3):
        step = _tokens(3 + T, (B, T), jcfg.vocab)
        lj, cj = JM.decode_step(jp, jcfg, cj, jnp.asarray(step))
        lt, ct = TM.decode_step(tp, tcfg, ct, torch.as_tensor(step))
        _close(lt, lj)


def test_decode_matches_forward():
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


@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8"])
def test_paged_engine_matches_jax(kv_dtype):
    """M-RoPE positions through the paged steps, chunked admission,
    graphed: streams equal to the JAX paged engine's; f32 pages also to
    the port's dense engine."""
    jcfg, tcfg, jp, tp = _world()
    jcfg = dataclasses.replace(jcfg, kv_dtype=kv_dtype)
    tcfg = dataclasses.replace(tcfg, kv_dtype=kv_dtype)
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
        fin_t, _ = eng.run(kv.init_cache(), reqs)
        kv.pool.check()
    finally:
        kv.close()
    assert _streams(fin_t) == _streams(fin_j)
    if kv_dtype == "bfloat16":
        fin_d, _ = make_dense_engine(tp, tcfg, B, CTX, device=CPU).run(
            TM.init_cache(tcfg, B, CTX, device=CPU), reqs)
        assert _streams(fin_d) == _streams(fin_t)


def test_q4_layerwise_engine_and_card_route(monkeypatch):
    """The layer-wise engine over a q4 tree (``quantize_ring_params`` at
    tp 2) resident and graphed equals the plain dense engine over the
    dequantized weights; with kernels reported active a layer-wise
    prefill of 6 tokens sends the 7 projections a layer (their biases
    added after) to B3 at M = 6."""
    from repro_torch.quant.grouped import dequantize_tree

    _, tcfg, _, tp = _world()
    tree, skipped = RS.quantize_ring_params(bridge.tree_from_params(tp),
                                            tcfg, tp=2)
    assert not skipped
    reqs = _requests(tcfg.vocab, n=4)
    fin_q, _ = make_streaming_engine(ResidentSource(tree), tcfg, B, CTX,
                                     device=CPU).run(
        TM.init_cache(tcfg, B, CTX, device=CPU), reqs)
    dq = bridge.params_from_numpy(dequantize_tree(tree, torch.float32),
                                  device=CPU)
    fin_d, _ = make_dense_engine(dq, tcfg, B, CTX, device=CPU).run(
        TM.init_cache(tcfg, B, CTX, device=CPU), reqs)
    assert _streams(fin_q) == _streams(fin_d)
    tok = torch.as_tensor(_tokens(9, (1, 6), tcfg.vocab))
    src = ResidentSource(tree)
    want, _ = TM.prefill_layerwise(
        src, tcfg, tok, TM.init_cache(tcfg, 1, 16, device=CPU))
    calls = []

    def stand_in(x, packed, scale, *, group):
        calls.append((x.shape[0], x.shape[1], packed.shape[1]))
        return q4.q4_matmul_ref(x, packed, scale, group=group)

    monkeypatch.setattr(q4, "q4_matmul", stand_in)
    monkeypatch.setattr(ops, "kernels_active", lambda t: True)
    got, _ = TM.prefill_layerwise(
        src, tcfg, tok, TM.init_cache(tcfg, 1, 16, device=CPU))
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    d, H, hk, hd, f = (tcfg.d_model, tcfg.n_heads, tcfg.kv_heads,
                       tcfg.head_dim, tcfg.d_ff)
    layer = [(6, d, H * hd), (6, d, hk * hd), (6, d, hk * hd),
             (6, H * hd, d), (6, d, f), (6, d, f), (6, f, d)]
    assert calls == layer * tcfg.n_layers


def test_ring_step_matches_jax():
    """The ring's layers take M-RoPE positions (one stream broadcast to
    three) against the JAX ring on a device-list mesh at k 2."""
    from test_torch_ring import _run_both

    assert _run_both(ARCH, 2, 2, n_layers=4) == 6


def test_ring_tokens_equal_one_device_decode():
    _, tcfg = _cfgs(4)
    params = TM.init_params(tcfg, torch.Generator().manual_seed(0),
                            device=CPU)
    prompts = torch.randint(0, tcfg.vocab, (4, 5),
                            generator=torch.Generator().manual_seed(1))
    cache = TM.init_cache(tcfg, 4, 32, device=CPU)
    logits, cache = TM.prefill(params, tcfg, prompts, cache)
    plan = RS.RingPlan.make(tcfg, 2, 2)
    step = RS.RingServeStep(tcfg, plan, RS.ring_params(params, tcfg, plan),
                            graphs=True, device=CPU)
    ring = {"len": cache["len"].clone(),
            "layers": RS.pad_and_permute(cache["layers"], tcfg, 2, 2)}
    tok = logits[:, -1:].argmax(-1)
    for _ in range(4):
        want, cache = TM.decode_step(params, tcfg, cache, tok)
        got, ring = step(ring, tok)
        assert torch.equal(got.argmax(-1), want.argmax(-1))
        assert float((got - want).abs().max()) <= 1e-5
        tok = want.argmax(-1)


def test_driver_smoke_equals_jax_decode():
    """``python -m repro_torch.launch.serve --arch qwen2-vl-2b --smoke
    --device cpu`` on the JAX package's weights: the ring decode equals
    the JAX one-device decode of the same batch."""
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
