"""The port's model paths against the JAX package's, on the same weights.

``repro.models.init_params`` draws the weights; the bridge carries them
into the port. Logits must agree to max|Δ|/max|ref| < 2e-4 (the ring
tests' bound: both sides compute in f32 with another order of summation)
and the greedy tokens must be equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import model as JM
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config as t_get_config
from repro_torch.models import model as TM
from repro_torch.runtime.kvcache import PagedKVCache

ARCHS = ["qwen2.5-14b", "llama3-8b"]
CPU = torch.device("cpu")
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


def _cfgs(arch, kv_dtype="bfloat16"):
    jcfg = dataclasses.replace(get_config(arch).reduced(), kv_dtype=kv_dtype)
    tcfg = dataclasses.replace(t_get_config(arch).reduced(),
                               kv_dtype=kv_dtype)
    return jcfg, tcfg


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    jcfg, tcfg = _cfgs(request.param)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                device=CPU)
    return jcfg, tcfg, jparams, tparams


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


def _j_prefill(jcfg, jparams, prompts, ctx):
    c = JM.init_cache(jcfg, prompts.shape[0], ctx, dtype=jnp.float32)
    return JM.prefill(jparams, jcfg, jnp.asarray(prompts), c)


def _t_prefill(tcfg, tparams, prompts, ctx):
    c = TM.init_cache(tcfg, prompts.shape[0], ctx, device=CPU)
    return TM.prefill(tparams, tcfg, torch.as_tensor(prompts), c)


def test_prefill_matches(setup):
    jcfg, tcfg, jparams, tparams = setup
    prompts = _tokens(1, (2, 11), jcfg.vocab)
    lj, cj = _j_prefill(jcfg, jparams, prompts, 32)
    lt, ct = _t_prefill(tcfg, tparams, prompts, 32)
    _close(lt, lj)
    np.testing.assert_allclose(ct["layers"]["k"].numpy(),
                               np.asarray(cj["layers"]["k"]),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("T", [1, 3])
def test_decode_step_matches(setup, T):
    jcfg, tcfg, jparams, tparams = setup
    prompts = _tokens(2, (2, 9), jcfg.vocab)
    toks = _tokens(3, (2, T), jcfg.vocab)
    _, cj = _j_prefill(jcfg, jparams, prompts, 32)
    _, ct = _t_prefill(tcfg, tparams, prompts, 32)
    lj, cj = JM.decode_step(jparams, jcfg, cj, jnp.asarray(toks))
    lt, ct = TM.decode_step(tparams, tcfg, ct, torch.as_tensor(toks))
    _close(lt, lj)
    np.testing.assert_array_equal(ct["len"].numpy(), np.asarray(cj["len"]))
    # rollback to one accepted token, then decode one more: equal again
    keep = np.asarray(cj["len"]) - T + 1
    probe = _tokens(4, (2, 1), jcfg.vocab)
    lj, _ = JM.decode_step(jparams, jcfg,
                           JM.rollback_cache(cj, jnp.asarray(keep)),
                           jnp.asarray(probe))
    lt, _ = TM.decode_step(tparams, tcfg, TM.rollback_cache(ct, keep),
                           torch.as_tensor(probe))
    _close(lt, lj)


def _paged_jax_and_torch(jcfg, tcfg, batch=2, n_pages=24):
    """The JAX and the port's paged caches, 4-token pages, ctx 32."""
    from repro.runtime.kvcache import PagedKVCache as JKV

    jkv = JKV(jcfg, batch=batch, ctx=32, n_pages=n_pages, page_tokens=4,
              offload=False)
    tkv = PagedKVCache(tcfg, batch=batch, ctx=32, n_pages=n_pages,
                       page_tokens=4, device=CPU)
    return jkv, tkv


@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8"])
def test_paged_decode_and_chunked_prefill_match(setup, kv_dtype):
    """Chunked prefill into pages (two chunks, the last one short), a
    ``write=False`` replay of the last position, then paged decode with
    T = 1 and T = 2 — f32 pages, and int8 pages with f32 scales."""
    _chunked_prefill_then_decode(setup, kv_dtype)


@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8"])
def test_card_route_of_paged_attention(setup, kv_dtype, monkeypatch):
    """The route a CUDA tensor takes through ``_paged_attention``: with
    kernels reported active, each kernel wrapper is replaced by its plain
    version (the CPU has no kernel) and the same sequence must still match
    the JAX package. Float pages admit through B2 and decode through B1;
    int8 pages admit and decode through B4, as the reference does."""
    from repro_torch.kernels import ops, paged_decode, paged_prefill

    calls = []

    def stand_in(module, name, plain):
        def run(*a, **k):
            calls.append((name, a[0].shape[1]))
            return plain(*a, **k)
        monkeypatch.setattr(module, name, run)

    stand_in(paged_decode, "paged_verify", paged_decode.paged_verify_ref)
    stand_in(paged_prefill, "paged_prefill", paged_prefill.paged_prefill_ref)
    stand_in(paged_decode, "paged_verify_quant",
             paged_decode.paged_verify_quant_ref)
    monkeypatch.setattr(ops, "kernels_active", lambda t: True)
    _chunked_prefill_then_decode(setup, kv_dtype)
    L = setup[1].n_layers
    # chunks of 8 and 5 rows, the 1-row replay, then T = 1 and T = 2
    rows = [8, 5, 1, 1, 2]
    if kv_dtype == "int8":
        want = [("paged_verify_quant", r) for r in rows for _ in range(L)]
    else:
        want = [("paged_prefill", r) for r in rows[:3] for _ in range(L)] \
            + [("paged_verify", r) for r in rows[3:] for _ in range(L)]
    assert calls == want


def _chunked_prefill_then_decode(setup, kv_dtype):
    jcfg, tcfg, jparams, tparams = setup
    jcfg = dataclasses.replace(jcfg, kv_dtype=kv_dtype)
    tcfg = dataclasses.replace(tcfg, kv_dtype=kv_dtype)
    jkv, tkv = _paged_jax_and_torch(jcfg, tcfg)
    prompt = _tokens(5, (13,), jcfg.vocab)
    jc, tc = jkv.init_cache(), tkv.init_cache()
    for kv, c in ((jkv, jc), (tkv, tc)):
        kv.plan_admit(c, 0, [int(t) for t in prompt], 8, register=False)
    jc, _ = jkv.begin_chunked_admit(jc, 0, 13)
    tc, _ = tkv.begin_chunked_admit(tc, 0, 13)
    jtab, ttab = jnp.asarray(jkv.chunk_table(0)), torch.as_tensor(
        tkv.chunk_table(0))
    for lo, hi in ((0, 8), (8, 13)):
        jv = {"pages": jc["pages"], "block_table": jtab,
              "len": jnp.full((1,), lo, jnp.int32)}
        tv = {"pages": tc["pages"], "block_table": ttab,
              "len": torch.full((1,), lo, dtype=torch.int32)}
        lj, jv = JM.prefill_chunk_paged(jparams, jcfg, jv,
                                        jnp.asarray(prompt[None, lo:hi]))
        lt, _ = TM.prefill_chunk_paged(tparams, tcfg, tv,
                                       torch.as_tensor(prompt[None, lo:hi]))
        jc = {**jc, "pages": jv["pages"]}
        _close(lt, lj)
    for name in jc["pages"]:
        np.testing.assert_allclose(
            tc["pages"][name].float().numpy(),
            np.asarray(jc["pages"][name], np.float32), rtol=1e-4, atol=1e-4)
    # write=False replay of the final position reads the pages only
    jv = {"pages": jc["pages"], "block_table": jtab,
          "len": jnp.full((1,), 12, jnp.int32)}
    tv = {"pages": tc["pages"], "block_table": ttab,
          "len": torch.full((1,), 12, dtype=torch.int32)}
    lj, _ = JM.prefill_chunk_paged(jparams, jcfg, jv,
                                   jnp.asarray(prompt[None, 12:]),
                                   write=False)
    lt, _ = TM.prefill_chunk_paged(tparams, tcfg, tv,
                                   torch.as_tensor(prompt[None, 12:]),
                                   write=False)
    _close(lt, lj)
    jc = jkv.finish_chunked_admit(jc, 0, 13)
    tc = tkv.finish_chunked_admit(tc, 0, 13)
    for T, seed in ((1, 6), (2, 7)):
        toks = _tokens(seed, (2, T), jcfg.vocab)
        jc = jkv.begin_step(jc, [0], T)
        tc = tkv.begin_step(tc, [0], T)
        lj, jc = JM.decode_step_paged(jparams, jcfg, jc, jnp.asarray(toks))
        lt, tc = TM.decode_step_paged(tparams, tcfg, tc,
                                      torch.as_tensor(toks))
        jkv.advance(0, T)
        tkv.advance(0, T)
        _close(lt[:1], lj[:1])      # slot 1 is inactive (sink pages)
        np.testing.assert_array_equal(tc["len"].numpy(),
                                      np.asarray(jc["len"]))


def test_paged_rollback_then_decode_matches(setup):
    """A T = 3 verify pass over pages, rollback to one accepted token
    (``rollback_cache`` + ``trim_to`` returning the pages past it), then
    one more decode step: equal to the JAX package's same sequence."""
    jcfg, tcfg, jparams, tparams = setup
    prompt = _tokens(8, (1, 14), jcfg.vocab)
    jkv, tkv = _paged_jax_and_torch(jcfg, tcfg, batch=1, n_pages=16)
    _, cj = _j_prefill(jcfg, jparams, prompt, 32)
    _, ct = _t_prefill(tcfg, tparams, prompt, 32)
    jc, tc = jkv.init_cache(), tkv.init_cache()
    jkv.plan_admit(jc, 0, [int(t) for t in prompt[0]], 8)
    tkv.plan_admit(tc, 0, [int(t) for t in prompt[0]], 8)
    jc = jkv.install(jc, 0, cj["layers"], 14)
    tc = tkv.install(tc, 0, ct["layers"], 14)
    toks = _tokens(9, (1, 3), jcfg.vocab)
    jc = jkv.begin_step(jc, [0], 3)
    tc = tkv.begin_step(tc, [0], 3)
    _, jc = JM.decode_step_paged(jparams, jcfg, jc, jnp.asarray(toks))
    _, tc = TM.decode_step_paged(tparams, tcfg, tc, torch.as_tensor(toks))
    jc = JM.rollback_cache(jc, jnp.asarray([15]))
    tc = TM.rollback_cache(tc, [15])
    jkv.trim_to(0, 15)
    tkv.trim_to(0, 15)
    assert tkv.length(0) == jkv.length(0) == 15
    assert tkv.pool.n_active == jkv.pool.n_active == 4   # 17 -> 15 tokens
    probe = _tokens(10, (1, 1), jcfg.vocab)
    jc = jkv.begin_step(jc, [0], 1)
    tc = tkv.begin_step(tc, [0], 1)
    lj, _ = JM.decode_step_paged(jparams, jcfg, jc, jnp.asarray(probe))
    lt, _ = TM.decode_step_paged(tparams, tcfg, tc, torch.as_tensor(probe))
    _close(lt, lj)
    tkv.pool.check()
