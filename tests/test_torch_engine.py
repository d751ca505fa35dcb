"""The port's serving engines against the JAX package's, on the same
weights and the same seeded ``RequestGenerator`` requests (more requests
than slots). Token streams must be identical.

Mirrors ``tests/test_paged_model.py``'s engine tests. The JAX runs are
shared through a module-scoped fixture.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.data import RequestGenerator as JRequestGenerator
from repro.models import init_cache as j_init_cache
from repro.models import init_params as j_init_params
from repro.runtime.engine import make_dense_engine as j_dense_engine
from repro.runtime.kvcache import make_paged_engine as j_paged_engine
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config as t_get_config
from repro_torch.data import RequestGenerator
from repro_torch.models import init_cache
from repro_torch.runtime.engine import make_dense_engine
from repro_torch.runtime.kvcache import make_paged_engine

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


def _cfg(getter, kv_dtype="bfloat16"):
    return dataclasses.replace(getter("qwen2.5-14b").reduced(), n_layers=2,
                               kv_dtype=kv_dtype)


def _requests(vocab):
    reqs = RequestGenerator(vocab, prompt_len=(4, 30), max_new=6,
                            seed=3).generate(5)
    jreqs = JRequestGenerator(vocab, prompt_len=(4, 30), max_new=6,
                              seed=3).generate(5)
    for a, b in zip(reqs, jreqs):          # the copy draws the same stream
        np.testing.assert_array_equal(a.prompt, b.prompt)
        assert a.max_new_tokens == b.max_new_tokens
    return reqs


class _Req:
    def __init__(self, uid, prompt, max_new):
        self.uid = uid
        self.prompt = prompt
        self.max_new_tokens = max_new


def _shared_prompt_requests(vocab):
    prompt = np.random.default_rng(4).integers(0, vocab, 19)
    return [_Req(0, prompt, 5), _Req(1, prompt.copy(), 5)]


def _streams(finished):
    return {f.uid: f.tokens for f in finished}


@pytest.fixture(scope="module")
def world():
    """JAX weights, the port's copy of them, and a memo of JAX runs."""
    jcfg = _cfg(get_config)
    jparams = j_init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                device=CPU)
    return {"jparams": jparams, "tparams": tparams, "runs": {}}


def _jax_run(world, name, kv_dtype="bfloat16", reqs=None, **kw):
    runs = world["runs"]
    if name not in runs:
        jcfg = _cfg(get_config, kv_dtype)
        reqs = reqs or _requests(jcfg.vocab)
        if name == "dense":
            fin, _ = j_dense_engine(world["jparams"], jcfg, B, CTX).run(
                j_init_cache(jcfg, B, CTX, dtype=jnp.float32), reqs)
            runs[name] = (_streams(fin), None)
        else:
            eng, kv = j_paged_engine(world["jparams"], jcfg, B, CTX,
                                     n_pages=N_PAGES, page_tokens=PAGE,
                                     offload=False, **kw)
            try:
                fin, _ = eng.run(kv.init_cache(), reqs)
                runs[name] = (_streams(fin), kv.stats())
            finally:
                kv.close()
    return runs[name]


def _port_paged(world, kv_dtype="bfloat16", reqs=None, **kw):
    tcfg = _cfg(t_get_config, kv_dtype)
    reqs = reqs or _requests(tcfg.vocab)
    eng, kv = make_paged_engine(world["tparams"], tcfg, B, CTX,
                                n_pages=N_PAGES, page_tokens=PAGE,
                                device=CPU, **kw)
    fin, _ = eng.run(kv.init_cache(), reqs)
    kv.pool.check()
    assert kv.pool.n_active == 0          # every slot released
    assert all(len(f.tokens) == r.max_new_tokens
               for f, r in zip(sorted(fin, key=lambda f: f.uid),
                               sorted(reqs, key=lambda r: r.uid)))
    return _streams(fin), kv.stats()


@pytest.mark.parametrize("name,kv_dtype,kw", [
    ("paged", "bfloat16", {}),
    ("paged_chunked", "bfloat16", {"prefill_chunk": 8}),
    ("paged_int8_chunked", "int8", {"prefill_chunk": 8}),
    ("paged_int8", "int8", {}),
])
def test_paged_engine_streams_match_jax(world, name, kv_dtype, kw):
    want, _ = _jax_run(world, name, kv_dtype, **kw)
    got, _ = _port_paged(world, kv_dtype, **kw)
    assert got == want


def test_dense_engine_streams_match_jax_and_paged(world):
    want, _ = _jax_run(world, "dense")
    tcfg = _cfg(t_get_config)
    eng = make_dense_engine(world["tparams"], tcfg, B, CTX, device=CPU)
    fin, _ = eng.run(init_cache(tcfg, B, CTX, device=CPU),
                     _requests(tcfg.vocab))
    assert _streams(fin) == want
    # dense and paged agree too, as in the JAX package
    assert _port_paged(world)[0] == want


@pytest.mark.parametrize("chunk", [None, 8])
def test_prefix_share_and_cow_match_jax(world, chunk):
    """Identical prompts share prompt pages and diverge by copy-on-write:
    the same streams, prefix hits and CoW copies as the JAX cache."""
    reqs = _shared_prompt_requests(_cfg(t_get_config).vocab)
    want, jst = _jax_run(world, f"prefix_{chunk}", reqs=reqs,
                         prefill_chunk=chunk)
    got, tst = _port_paged(world, reqs=reqs, prefill_chunk=chunk)
    assert got == want
    assert got[0] == got[1]
    assert (tst.prefix_hits, tst.cow_copies) == (jst.prefix_hits,
                                                 jst.cow_copies)
    assert tst.prefix_hits == 3 and tst.cow_copies >= 1
    assert (tst.active_pages_highwater, tst.active_tokens_highwater) == \
        (jst.active_pages_highwater, jst.active_tokens_highwater)


def test_deferred_features_raise():
    """What later slices port raises instead of being ignored; what is
    ported is kept."""
    from repro_torch.runtime.engine import ContinuousBatcher
    from repro_torch.runtime.kvcache import PagedKVCache
    from repro_torch.runtime.metrics import MetricsRegistry
    from repro_torch.runtime.telemetry import NULL_TRACER, Tracer

    tcfg = _cfg(t_get_config)
    # the span tracer and serving metrics are ported: both are kept
    tracer, reg = Tracer(), MetricsRegistry()
    eng = ContinuousBatcher(2, None, None, None, device=CPU, tracer=tracer,
                            metrics=reg)
    assert eng.telemetry() is tracer and eng.metrics is reg
    assert ContinuousBatcher(2, None, None, None,
                             device=CPU).telemetry() is NULL_TRACER
    with pytest.raises(TypeError, match="Tracer"):
        ContinuousBatcher(2, None, None, None, device=CPU, tracer=object())
    # session parking is ported; beside speculation it is refused
    with pytest.raises(ValueError, match="speculative"):
        ContinuousBatcher(2, None, None, None, device=CPU,
                          spec=object()).admit(None, None, 0, np.arange(4),
                                               2, session="s")
    # speculative decoding is ported: the decoder is kept and drives step()
    spec = object()
    assert ContinuousBatcher(2, None, None, None, device=CPU,
                             spec=spec).spec is spec
    # weight streaming is ported: a source is kept for streaming_stats()
    src = type("Src", (), {"stats": lambda self: "stats"})()
    assert ContinuousBatcher(2, None, None, None, device=CPU,
                             source=src).streaming_stats() == "stats"
    # tiered memory is ported: offload is the default, as in JAX, and the
    # pool leases its bytes from the device tier until closed
    kv = PagedKVCache(tcfg, batch=2, ctx=64, n_pages=8, device=CPU)
    assert kv.offloader is not None
    assert kv.memory.used("device") == 8 * kv.page_bytes
    kv.close()
    assert kv.memory.used("device") == 0
