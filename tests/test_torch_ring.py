"""The port's piped ring against the JAX package's: the layout
(``ring_permutation``, ``padded_layers``, ``RingPlan``, the bank rows,
``pad_and_permute``) equal to JAX's over a grid of (L, M, k), and the
resident ring step (``RingServeStep``) against ``build_ring_serve_step``
on a (M, 1) debug mesh of host devices: the same seed-made weights
carried across by ``bridge``, the same prefilled cache, then 6 greedy
steps each, every step's logits within max|d|/max|ref| < 2e-4 (f32 on
both sides, another order of summation) and the greedy tokens equal.
Cases: reduced qwen2.5-14b at M 2 and 4, k 1 and 2; a depth the stages
do not divide (padding); an int8 cache; the verify pass at T = 4;
reduced mamba2-780m; q4 ring params. The port's ring also against its
own one-device decode (tokens equal) and the step replayed through
``StepGraphs`` on the CPU. Everything runs on CPU tensors.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.launch.mesh import make_debug_mesh
from repro.models import model as JM
from repro.runtime import serve as JS
from repro_torch import bridge
from repro_torch.configs import get_config as t_get_config
from repro_torch.kernels import ops
from repro_torch.models import model as TM
from repro_torch.quant import QuantizedTensor
from repro_torch.runtime import serve as RS

KEY = jax.random.PRNGKey(0)
CPU = torch.device("cpu")
B, S, CTX, STEPS = 8, 5, 32, 6
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


def _cfgs(arch, n_layers=None, kv_dtype=None):
    j, t = get_config(arch).reduced(), t_get_config(arch).reduced()
    kw = {}
    if n_layers is not None:
        kw["n_layers"] = n_layers
    if kv_dtype is not None:
        kw["kv_dtype"] = kv_dtype
    return dataclasses.replace(j, **kw), dataclasses.replace(t, **kw)


def _to_torch(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _close(t_logits, j_logits):
    ref = np.asarray(j_logits, np.float32)
    got = t_logits.float().numpy()
    rel = np.abs(got - ref).max() / np.abs(ref).max()
    assert rel < REL, rel
    return rel


@pytest.mark.parametrize("L,M,k", [(8, 2, 1), (8, 2, 2), (8, 4, 2),
                                   (6, 4, 1), (7, 2, 2), (48, 4, 2),
                                   (64, 8, 4), (24, 3, 8), (4, 4, 2),
                                   (6, 4, 2)])
def test_layout_equals_jax(L, M, k):
    jcfg, cfg = _cfgs("qwen2.5-14b", n_layers=L)
    assert RS.padded_layers(L, M) == JS.padded_layers(L, M)
    if RS.padded_layers(L, M) // M % k:
        # the JAX plan refuses a k that does not divide a stage's layers;
        # the port's pads on with zero layers
        with pytest.raises(AssertionError):
            JS.RingPlan.make(jcfg, M, k)
        plan = RS.RingPlan.make(cfg, M, k)
        assert plan.L_pad == RS.padded_layers(L, M * k) > L
        assert plan.w * k * M == plan.L_pad
        return
    plan, jplan = RS.RingPlan.make(cfg, M, k), JS.RingPlan.make(jcfg, M, k)
    assert (plan.n_stages, plan.k, plan.w, plan.L_pad) == (
        jplan.n_stages, jplan.k, jplan.w, jplan.L_pad)
    assert plan.n_steps == k * M + M - 1
    assert np.array_equal(RS.ring_permutation(plan.L_pad, M, k),
                          JS.ring_permutation(jplan.L_pad, M, k))
    for t in range(plan.n_steps):
        assert np.array_equal(RS.ring_bank_layers(plan, t),
                              JS.ring_bank_layers(jplan, t))
        assert np.array_equal(RS.ring_bank_rounds(plan, t),
                              JS.ring_bank_rounds(jplan, t))
    stacked = np.arange(L * 3, dtype=np.float32).reshape(L, 3)
    got = RS.pad_and_permute({"x": torch.from_numpy(stacked)}, cfg, M, k)
    want = JS.pad_and_permute({"x": jnp.asarray(stacked)}, jcfg, M, k)
    assert np.array_equal(got["x"].numpy(), np.asarray(want["x"]))


def test_ring_supported_and_tp():
    _, cfg = _cfgs("qwen2.5-14b")
    assert RS.ring_supported(cfg, 8, 4) and not RS.ring_supported(cfg, 6, 4)
    _, ssm = _cfgs("mamba2-780m")
    assert RS.ring_supported(ssm, 4, 2)
    with pytest.raises(ValueError, match="ssm state is irreversible"):
        RS.RingServeStep(ssm, RS.RingPlan.make(ssm, 2), {"blocks": []},
                         n_tokens=2, graphs=False, device=CPU)


@functools.lru_cache(maxsize=None)
def _j_setup(jcfg, q4):
    """The JAX weights (q4 ring params with ``q4``), seed-made prompts
    prefilled on one device, and the first greedy tokens; shared by the
    cases of one config (the ring steps read the cache's copies)."""
    params = JM.init_params(jcfg, KEY)
    if q4:
        params, skipped = JS.quantize_ring_params(dict(params), jcfg, tp=1)
        assert not skipped
    prompts = jax.random.randint(jax.random.PRNGKey(1), (B, S), 0,
                                 jcfg.vocab)
    ref = JS.dequant_ring_reference(params["blocks"]) if q4 \
        else params["blocks"]
    cache = JM.init_cache(jcfg, B, CTX, dtype=jnp.float32)
    logits, cache = JM.prefill(dict(params, blocks=ref), jcfg, prompts,
                               cache)
    return params, cache, jnp.argmax(logits[:, -1], -1)


def _run_both(arch, M, k, *, n_layers=None, kv_dtype=None, T=1, q4=False):
    jcfg, cfg = _cfgs(arch, n_layers, kv_dtype)
    params, jcache, nxt = _j_setup(jcfg, q4)
    tree = bridge.tree_from_numpy(jax.tree.map(np.asarray, params),
                                  device=CPU)
    cache = {"len": _to_torch(jcache["len"]),
             "layers": {n: _to_torch(a)
                        for n, a in jcache["layers"].items()}}
    cache["layers"] = RS.pad_and_permute(cache["layers"], cfg, M, k)

    jplan = JS.RingPlan.make(jcfg, M, k)
    mesh = make_debug_mesh(M, 1)
    pr = JS.pad_vocab(dict(params), jcfg, 1)
    pr["blocks"] = JS.pad_and_permute(params["blocks"], jcfg, M, k)
    jcache = dict(jcache)
    jcache["layers"] = JS.pad_and_permute(jcache["layers"], jcfg, M, k)
    jstep = JS.build_ring_serve_step(jcfg, mesh, jplan, n_tokens=T)(
        pr, jcache)

    plan = RS.RingPlan.make(cfg, M, k)
    step = RS.RingServeStep(cfg, plan, RS.ring_params(tree, cfg, plan),
                            n_tokens=T, graphs=False, device=CPU)
    jtok = jnp.tile(nxt[:, None], (1, T)).astype(jnp.int32)
    ttok = _to_torch(jtok)
    ln = jcache["len"]
    held = 0
    for _ in range(STEPS):
        jl, jcache = jstep(jtok, ln, pr, jcache)
        ln = ln + T
        tl, cache = step(cache, ttok)
        jnext = np.asarray(jnp.argmax(jl[:, :, :jcfg.vocab], -1))
        assert np.array_equal(cache["len"].numpy(), np.asarray(ln))
        if kv_dtype == "int8" and _int8_flips(cache, jcache):
            # a line quantized on either side of a rounding boundary
            # (f32 sums in another order) moves its keys by 1/127: the
            # streams are held only before the first such flip, as
            # chip_smoke.py's phase 4 holds int8 pages
            break
        _close(tl, jl)
        assert np.array_equal(tl.argmax(-1).numpy(), jnext)
        held += 1
        jtok = jnp.tile(jnp.asarray(jnext[:, -1:], jnp.int32), (1, T))
        ttok = _to_torch(jtok)
    return held


def _int8_flips(cache, jcache) -> int:
    return sum(int((cache["layers"][n].numpy()
                    != np.asarray(jcache["layers"][n])).sum())
               for n in ("k", "v"))


@pytest.mark.parametrize("M,k", [(2, 1), (2, 2), (4, 1), (4, 2)])
def test_ring_step_matches_jax_dense(M, k):
    _run_both("qwen2.5-14b", M, k, n_layers=8)


def test_ring_step_matches_jax_padded_layers():
    """6 layers over 4 stages: 2 zero layers pad the ring to 8."""
    _run_both("qwen2.5-14b", 4, 1, n_layers=6)


def test_ring_step_matches_jax_int8_cache():
    """Held step by step until the two int8 caches first differ in a byte
    (the one-device decodes of the two packages split there too, at the
    third step of this seed)."""
    assert _run_both("qwen2.5-14b", 2, 2, n_layers=4, kv_dtype="int8") >= 2


def test_ring_verify_pass_matches_jax():
    _run_both("qwen2.5-14b", 2, 2, n_layers=4, T=4)


@pytest.mark.parametrize("k", [1, 2])
def test_ring_step_matches_jax_ssm(k):
    _run_both("mamba2-780m", 2, k)


def test_ring_step_matches_jax_q4_params():
    _run_both("qwen2.5-14b", 4, 2, n_layers=8, q4=True)


@pytest.mark.parametrize("arch,L,M,k", [("qwen2.5-14b", 6, 4, 1),
                                        ("qwen2.5-14b", 8, 2, 2),
                                        ("mamba2-780m", 4, 2, 2)])
def test_ring_tokens_equal_one_device_decode(arch, L, M, k):
    """The port's ring against its own one-device decode from the same
    prefill: equal greedy tokens (and, on the CPU, equal logits), eager
    and replayed through ``StepGraphs``."""
    _, cfg = _cfgs(arch, L)
    params = TM.init_params(cfg, torch.Generator().manual_seed(0),
                            device=CPU)
    prompts = torch.randint(0, cfg.vocab, (B, S),
                            generator=torch.Generator().manual_seed(1))
    cache = TM.init_cache(cfg, B, CTX, device=CPU)
    logits, cache = TM.prefill(params, cfg, prompts, cache)
    plan = RS.RingPlan.make(cfg, M, k)
    rparams = RS.ring_params(params, cfg, plan)
    ring = [{"len": cache["len"].clone(),
             "layers": RS.pad_and_permute(cache["layers"], cfg, M, k)}
            for _ in range(2)]
    steps = [RS.RingServeStep(cfg, plan, rparams, graphs=g, device=CPU)
             for g in (False, True)]
    tok = logits[:, -1:].argmax(-1)
    for _ in range(STEPS):
        want, cache = TM.decode_step(params, cfg, cache, tok)
        for i in range(2):
            got, ring[i] = steps[i](ring[i], tok)
            assert torch.equal(got.argmax(-1), want.argmax(-1))
            assert float((got - want).abs().max()) <= 1e-5
        tok = want.argmax(-1)
    assert steps[1].graphs.captures == 1
    assert steps[1].graphs.replays[("decode", 1)] == STEPS


def test_ring_step_launch_accounting_on_the_cpu():
    """On CPU tensors no kernel launches; the ring asks
    ``ops.kernels_active`` and takes the plain versions."""
    _, cfg = _cfgs("qwen2.5-14b", 6)
    params = TM.init_params(cfg, torch.Generator().manual_seed(0),
                            device=CPU)
    plan = RS.RingPlan.make(cfg, 4, 1)
    ops.reset_launch_counts()
    step = RS.RingServeStep(cfg, plan, RS.ring_params(params, cfg, plan),
                            graphs=False, device=CPU)
    cache = RS.init_ring_cache(cfg, plan, 4, CTX, device=CPU)
    logits, cache = step(cache, torch.zeros((4, 1), dtype=torch.int32))
    assert logits.shape == (4, 1, cfg.vocab)
    assert all(n == 0 for n in ops.launch_counts().values())
    with pytest.raises(ValueError, match="pad_and_permute"):
        step(TM.init_cache(cfg, 4, CTX, device=CPU),
             torch.zeros((4, 1), dtype=torch.int32))


def test_ring_params_share_the_model_weights():
    """``ring_params`` builds the ring over views: no second copy; a q4
    stacked tree keeps its leaves packed per layer (B3's input)."""
    _, cfg = _cfgs("qwen2.5-14b", 6)
    params = TM.init_params(cfg, torch.Generator().manual_seed(0),
                            device=CPU)
    plan = RS.RingPlan.make(cfg, 4, 1)
    rp = RS.ring_params(params, cfg, plan)
    perm = RS.ring_permutation(plan.L_pad, 4, 1)
    for blk, i in zip(rp["blocks"], perm):
        if i < cfg.n_layers:
            assert blk.attn.wq.data_ptr() == \
                params.blocks[i].attn.wq.data_ptr()
        else:
            assert not blk.attn.wq.any()
    tree, _ = RS.quantize_ring_params(bridge.tree_from_params(params), cfg,
                                      tp=1)
    rq = RS.ring_params(tree, cfg, plan)
    assert isinstance(rq["blocks"][0].attn.wq, QuantizedTensor)
    assert rq["blocks"][0].attn.wq.packed.dim() == 2


def test_q4_ring_equals_its_dequantized_reference():
    """``dequant_ring_reference``'s contract: on the plain route the ring
    over a q4 bank equals the ring over the bank dequantized with the
    window's numerics, to the bit."""
    _, cfg = _cfgs("qwen2.5-14b", 8)
    params = TM.init_params(cfg, torch.Generator().manual_seed(0),
                            device=CPU)
    tree, _ = RS.quantize_ring_params(bridge.tree_from_params(params), cfg,
                                      tp=1)
    ref = dict(tree, blocks=RS.dequant_ring_reference(tree["blocks"]))
    plan = RS.RingPlan.make(cfg, 4, 2)
    tok = torch.zeros((B, 1), dtype=torch.int32)
    out = []
    for t in (tree, ref):
        step = RS.RingServeStep(cfg, plan, RS.ring_params(t, cfg, plan),
                                graphs=False, device=CPU)
        cache = RS.init_ring_cache(cfg, plan, B, CTX, device=CPU)
        out.append([step(cache, tok)[0] for _ in range(3)])
    for a, b in zip(*out):
        assert torch.equal(a, b)
