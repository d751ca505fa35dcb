"""The port's moe family against the JAX package's, on the same weights.

``moe_ffn`` (routing, capacity buckets, dropped rows, outputs), the
model paths of mixtral-8x7b and phi3.5-moe (reduced: 4 experts, top 2;
mixtral's sliding window of 32) and the copied configs. The weights are
drawn by ``repro.models.init_params`` and carried across by ``bridge``.
Bounds: ``moe_ffn`` outputs within 1e-5 absolute (f32 on both sides),
logits within max|d|/max|ref| < 2e-4 with the greedy tokens equal (the
ring tests' bound), bucket slots equal exactly.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch import bridge
from repro_torch.configs import get_config as t_get_config
from repro_torch.models import layers as TL
from repro_torch.models import model as TM

ARCHS = ["mixtral-8x7b", "phi3.5-moe-42b-a6.6b"]
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


def _cfgs(arch, **kw):
    return (dataclasses.replace(get_config(arch).reduced(), **kw),
            dataclasses.replace(t_get_config(arch).reduced(), **kw))


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


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "phi3.5-moe-42b-a6.6b",
                                  "minitron-8b"])
def test_configs_match_jax_field_for_field(arch):
    a, b = get_config(arch), t_get_config(arch)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert dataclasses.asdict(a.reduced()) == dataclasses.asdict(b.reduced())
    assert (a.total_params(), a.total_active_params()) == \
        (b.total_params(), b.total_active_params())


# --------------------------------------------------------------------------- #
#  moe_ffn
# --------------------------------------------------------------------------- #

def _j_slots(p, cfg, x, lossless):
    """The JAX dispatch's bucket slot of every routed row, recomputed with
    its own ops (``moe_ffn`` keeps them local)."""
    T = x.shape[0] * x.shape[1]
    E, K = cfg.n_experts, cfg.top_k
    xt = x.reshape(T, -1)
    logits = (xt @ p["router"]).astype(jnp.float32)
    _, idx = jax.lax.top_k(jax.nn.softmax(logits, -1), K)
    cf = cfg.moe_capacity_factor
    C = T if lossless or cf is None else min(max(int(K * T / E * cf), 1), T)
    flat_e = idx.reshape(-1)
    oh = jax.nn.one_hot(flat_e, E, dtype=jnp.int32)
    pos = (jnp.cumsum(oh, axis=0) * oh).sum(-1) - 1
    return np.asarray(jnp.where(pos < C, flat_e * C + pos, E * C)), C


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("cf,lossless", [(None, False), (1.25, True),
                                         (1.25, False)])
def test_moe_ffn_matches_jax(arch, cf, lossless):
    """Lossless, and at cf = 1.25 with 2 x 37 tokens leaning toward one
    expert, whose rows over capacity drop to the pad row: the same slots,
    the same outputs."""
    jcfg, tcfg = _cfgs(arch, moe_capacity_factor=cf)
    p = JL.init_moe(jcfg, jax.random.PRNGKey(3), jnp.float32)
    x = np.random.default_rng(0).standard_normal(
        (2, 37, jcfg.d_model)).astype(np.float32)
    # lean every token toward expert 0, so its bucket overflows at cf 1.25
    x += 4.0 * np.asarray(p["router"][:, 0]) * np.sqrt(jcfg.d_model)
    want = np.asarray(JL.moe_ffn(p, jcfg, jnp.asarray(x), lossless=lossless))
    tp = types.SimpleNamespace(**{k: torch.tensor(np.asarray(v))
                                  for k, v in p.items()})
    got = TL.moe_ffn(tp, tcfg, torch.tensor(x), lossless=lossless).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)

    jslot, jC = _j_slots(p, jcfg, jnp.asarray(x), lossless)
    gates, slot, C = TL.moe_route(tp.router, tcfg,
                                  torch.tensor(x).reshape(-1, x.shape[-1]),
                                  lossless=lossless)
    assert C == jC
    np.testing.assert_array_equal(slot.numpy(), jslot)
    dropped = int((slot == tcfg.n_experts * C).sum())
    if cf is not None and not lossless:
        assert C < 74 and dropped > 0       # the case exercises dropping
    else:
        assert C == 74 and dropped == 0
    np.testing.assert_allclose(gates.sum(-1).numpy(), 1.0, atol=1e-6)


def test_router_ties_go_to_the_lower_expert():
    """Equal router probabilities pick the lower expert index, as
    ``lax.top_k`` does."""
    _, tcfg = _cfgs("mixtral-8x7b")
    router = torch.zeros((tcfg.d_model, tcfg.n_experts))
    router[:, 2] = 1.0                      # expert 2 first, 0 1 3 tie
    x = torch.ones((3, tcfg.d_model))
    _, slot, C = TL.moe_route(router, tcfg, x, lossless=True)
    assert (slot // C).tolist() == [2, 0] * 3


def test_router_promotes_like_jax():
    """bf16 activations against a router dequantized to f32: f32 logits,
    as jnp's promotion gives (torch refuses a mixed product)."""
    _, tcfg = _cfgs("mixtral-8x7b")
    g = torch.Generator().manual_seed(0)
    router = torch.randn((tcfg.d_model, tcfg.n_experts), generator=g)
    x = torch.randn((5, tcfg.d_model), generator=g).to(torch.bfloat16)
    gates, slot, _ = TL.moe_route(router, tcfg, x, lossless=True)
    assert gates.dtype == torch.float32
    want = torch.topk(torch.softmax(x.float() @ router, -1), 2).indices
    assert torch.equal(slot.reshape(5, 2) // 5, want)


# --------------------------------------------------------------------------- #
#  the model paths
# --------------------------------------------------------------------------- #

@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    jcfg, tcfg = _cfgs(request.param)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                       device=CPU)
    return jcfg, tcfg, jparams, tparams


def test_forward_matches_jax(setup):
    jcfg, tcfg, jp, tp = setup
    toks = _tokens(1, (2, 40), jcfg.vocab)
    _close(TM.forward(tp, tcfg, torch.as_tensor(toks)),
           JM.forward(jp, jcfg, jnp.asarray(toks)))


@pytest.mark.parametrize("ctx,S", [(24, 9), (48, 40)])
def test_prefill_and_decode_match_jax(setup, ctx, S):
    """Prefill, then T = 1 steps, then (where the cache is longer than the
    window) a T = 3 verify pass and a rollback; ctx 48 > mixtral's
    window of 32 makes its cache the rolling buffer, where a verify pass
    raises in both packages."""
    jcfg, tcfg, jp, tp = setup
    prompts = _tokens(2, (2, S), jcfg.vocab)
    cj = JM.init_cache(jcfg, 2, ctx, dtype=jnp.float32)
    ct = TM.init_cache(tcfg, 2, ctx, device=CPU)
    lj, cj = JM.prefill(jp, jcfg, jnp.asarray(prompts), cj)
    lt, ct = TM.prefill(tp, tcfg, torch.as_tensor(prompts), ct)
    _close(lt, lj)
    np.testing.assert_allclose(ct["layers"]["k"].numpy(),
                               np.asarray(cj["layers"]["k"]), atol=1e-4)
    for s in range(3):
        t = _tokens(10 + s, (2, 1), jcfg.vocab)
        lj, cj = JM.decode_step(jp, jcfg, cj, jnp.asarray(t))
        lt, ct = TM.decode_step(tp, tcfg, ct, torch.as_tensor(t))
        _close(lt, lj)
    rolling = jcfg.attn_window is not None \
        and ct["layers"]["k"].shape[2] == jcfg.attn_window
    assert rolling == (jcfg.attn_window is not None and ctx > 32)
    t3 = _tokens(20, (2, 3), jcfg.vocab)
    if rolling:
        with pytest.raises(ValueError):
            TM.decode_step(tp, tcfg, ct, torch.as_tensor(t3))
        with pytest.raises(Exception):
            JM.decode_step(jp, jcfg, cj, jnp.asarray(t3))
        return
    lj, cj = JM.decode_step(jp, jcfg, cj, jnp.asarray(t3))
    lt, ct = TM.decode_step(tp, tcfg, ct, torch.as_tensor(t3))
    _close(lt, lj)
    keep = np.asarray(cj["len"]) - 2
    probe = _tokens(21, (2, 1), jcfg.vocab)
    lj, _ = JM.decode_step(jp, jcfg, JM.rollback_cache(cj, jnp.asarray(keep)),
                           jnp.asarray(probe))
    lt, _ = TM.decode_step(tp, tcfg, TM.rollback_cache(ct, keep),
                           torch.as_tensor(probe))
    _close(lt, lj)


@pytest.mark.parametrize("arch", ARCHS)
def test_dense_prefill_drops_where_jax_does(arch):
    """At cf = 1.25 (the published configs' factor) a dense prefill drops
    rows over capacity and decode does not, in both packages: the
    prefill's logits differ from the lossless model's and still match
    JAX's."""
    jcfg, tcfg = _cfgs(arch, moe_capacity_factor=1.25, n_layers=2)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(4))
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), device=CPU)
    prompts = _tokens(5, (1, 30), jcfg.vocab)
    cj = JM.init_cache(jcfg, 1, 64, dtype=jnp.float32)
    ct = TM.init_cache(tcfg, 1, 64, device=CPU)
    lj, cj = JM.prefill(jp, jcfg, jnp.asarray(prompts), cj)
    lt, ct = TM.prefill(tp, tcfg, torch.as_tensor(prompts), ct)
    _close(lt, lj)
    lossless = dataclasses.replace(tcfg, moe_capacity_factor=None)
    l0, _ = TM.prefill(tp, lossless, torch.as_tensor(prompts),
                       TM.init_cache(tcfg, 1, 64, device=CPU))
    assert (l0 - lt).abs().max() > 1e-3
    t = _tokens(6, (1, 1), jcfg.vocab)
    lj, _ = JM.decode_step(jp, jcfg, cj, jnp.asarray(t))
    lt, _ = TM.decode_step(tp, tcfg, ct, torch.as_tensor(t))
    _close(lt, lj)


@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8"])
def test_paged_paths_match_jax(setup, kv_dtype):
    """Chunked prefill into pages (two chunks, lossless as in JAX), a
    read-only replay, then paged decode at T = 1 and T = 2, against the
    JAX paged paths: f32 pages, and int8 pages with their scales
    (``test_torch_model``'s sequence)."""
    from test_torch_model import _chunked_prefill_then_decode

    _chunked_prefill_then_decode(setup, kv_dtype)
