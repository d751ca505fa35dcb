"""The moe family's store, ring and dense spec engine against the JAX
package's: see ``tests/test_torch_moe_engines.py``."""
import filecmp
import os
import shutil
import tempfile

import jax
import numpy as np
import pytest
import torch

from repro.models import model as JM
from repro.quant import quantize_tree as j_quantize_tree
from repro.runtime import serve as JRS
from repro.runtime.paramstore import save_param_store as j_save
from repro_torch import bridge
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.quant import QuantizedTensor
from repro_torch.runtime import serve as RS
from repro_torch.runtime.paramstore import ParamStore, save_param_store
from test_torch_moe_engines import CPU, _cfgs, _spec_setup, _world


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


def test_dense_spec_engine_matches_jax():
    """The dense-cache spec engine, phi3.5-moe (mixtral's dense cache at
    ctx 64 is its rolling window buffer, where a verify pass raises in
    both packages): results equal the JAX spec engine's."""
    import test_torch_speculative as TS

    target, draft, reqs = _spec_setup(_world("phi3.5-moe-42b-a6.6b"))
    want, got, _, _ = TS._dense_pair(target, draft, 3, reqs)
    assert got == want
    assert sum(r[1] for r in got.values()) > 0


# --------------------------------------------------------------------------- #
#  the store and the streamed engine
# --------------------------------------------------------------------------- #

@pytest.fixture()
def tmp():
    dirs = []

    def make():
        dirs.append(tempfile.mkdtemp(prefix="test_torch_moe_store_"))
        return dirs[-1]

    yield make
    for d in dirs:
        shutil.rmtree(d, ignore_errors=True)


@pytest.mark.parametrize("quant", ["tree", "ring_tp2"])
def test_store_bytes_equal_jax_writer(tmp, quant):
    """8 experts, so ``quantize_tree``'s weight rule takes the (L, d, E)
    router too (E >= 8, d % 64 == 0); the expert stacks are (L, E, d, f)
    leaves. Both writers' files are byte-identical, manifest included."""
    from test_torch_streaming import _port_tree

    jcfg, tcfg = _cfgs("mixtral-8x7b", n_experts=8)
    params = JM.init_params(jcfg, jax.random.PRNGKey(0))
    if quant == "tree":
        params = dict(params, blocks=j_quantize_tree(params["blocks"],
                                                     bits=4, stacked=True))
        tparams = _port_tree(params)
    else:
        params, _ = JRS.quantize_ring_params(dict(params), jcfg, tp=2)
        tparams, skipped = RS.quantize_ring_params(
            _port_tree(jax.tree.map(np.asarray, dict(
                JM.init_params(jcfg, jax.random.PRNGKey(0))))), tcfg, tp=2)
        assert not skipped
    moe = params["blocks"]["moe"]
    assert all(hasattr(moe[k], "packed") for k in ("router", "w_gate",
                                                   "w_up", "w_down"))
    assert moe["w_gate"].packed.ndim == 4
    dj = j_save(params, jcfg, tmp())
    dt = save_param_store(tparams, tcfg, tmp())
    names = sorted(os.listdir(dj))
    assert sorted(os.listdir(dt)) == names
    for name in names:
        assert filecmp.cmp(os.path.join(dj, name), os.path.join(dt, name),
                           shallow=False), name
    with ParamStore(dt) as store:
        lay = store.layer(1)["moe"]
        assert isinstance(lay["w_down"], QuantizedTensor)
        assert lay["w_down"].packed.shape == (8, tcfg.d_ff // 2,
                                              tcfg.d_model)


# --------------------------------------------------------------------------- #
#  the ring
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("arch,M,k,T", [("mixtral-8x7b", 4, 1, 1),
                                        ("mixtral-8x7b", 2, 2, 1),
                                        ("phi3.5-moe-42b-a6.6b", 2, 2, 4)])
def test_ring_step_matches_jax(arch, M, k, T):
    """The resident ring (lossless dispatch, as in JAX) against the JAX
    ring on a device-list mesh: mixtral over its rolling window buffer
    (ctx 32 = the window), phi3.5-moe also at the T = 4 verify pass."""
    from test_torch_ring import _run_both

    assert _run_both(arch, M, k, T=T) == 6


def test_q4_ring_equals_its_dequantized_reference():
    """A q4 moe bank keeps its expert stacks packed in the window (B3
    once an expert on the card; the JAX ring dequantizes them to bf16):
    on the plain route the ring equals the ring over the bank dequantized
    with the window's numerics, to the bit."""
    _, cfg = _cfgs("mixtral-8x7b", n_layers=4)
    params = TM.init_params(cfg, torch.Generator().manual_seed(0),
                            device=CPU)
    tree, skipped = RS.quantize_ring_params(bridge.tree_from_params(params),
                                            cfg, tp=2)
    assert not skipped and isinstance(tree["blocks"]["moe"]["router"],
                                      QuantizedTensor)
    ref = dict(tree, blocks=RS.dequant_ring_reference(tree["blocks"]))
    plan = RS.RingPlan.make(cfg, 2, 2)
    rp = RS.ring_params(tree, cfg, plan)
    assert rp["blocks"][0].moe.w_up.packed.dim() == 3
    assert not isinstance(rp["blocks"][0].moe.router, QuantizedTensor)
    tok = torch.zeros((4, 1), dtype=torch.int32)
    out = []
    for t in (tree, ref):
        step = RS.RingServeStep(cfg, plan, RS.ring_params(t, cfg, plan),
                                graphs=False, device=CPU)
        cache = RS.init_ring_cache(cfg, plan, 4, 32, device=CPU)
        out.append([step(cache, tok)[0] for _ in range(3)])
    for a, b in zip(*out):
        assert torch.equal(a, b)


def test_q4_ring_routes_as_the_one_device_decode():
    """Over a q4 bank the ring keeps the router in f32, as the layer-wise
    path dequantizes it, so the ring's logits equal the one-device
    layer-wise decode's from the same prefill (a router rounded to bf16
    would pick other experts at near ties)."""
    from repro_torch.runtime.paramstore import ResidentSource

    _, cfg = _cfgs("mixtral-8x7b", n_layers=4, n_experts=8)
    params = TM.init_params(cfg, torch.Generator().manual_seed(0),
                            device=CPU)
    tree, _ = RS.quantize_ring_params(bridge.tree_from_params(params), cfg,
                                      tp=2)
    src = ResidentSource(tree)
    prompts = torch.randint(0, cfg.vocab, (4, 5),
                            generator=torch.Generator().manual_seed(1))
    cache = TM.init_cache(cfg, 4, 16, device=CPU)
    logits, cache = TM.prefill_layerwise(src, cfg, prompts, cache)
    plan = RS.RingPlan.make(cfg, 2, 1)
    step = RS.RingServeStep(cfg, plan, RS.ring_params(tree, cfg, plan),
                            graphs=False, device=CPU)
    ring = {"len": cache["len"].clone(),
            "layers": RS.pad_and_permute(cache["layers"], cfg, 2, 1)}
    tok = logits[:, -1:].argmax(-1)
    for _ in range(3):
        want, cache = TM.decode_step_layerwise(src, cfg, cache, tok)
        got, ring = step(ring, tok)
        assert float((got - want).abs().max()) <= 1e-5
        tok = want.argmax(-1)


def test_ring_tokens_equal_one_device_decode_graphed():
    """The moe ring against the port's own one-device decode, eager and
    replayed through ``StepGraphs`` on the CPU (the dispatch reads nothing
    back to the host)."""
    _, cfg = _cfgs("phi3.5-moe-42b-a6.6b", n_layers=4)
    params = TM.init_params(cfg, torch.Generator().manual_seed(0),
                            device=CPU)
    prompts = torch.randint(0, cfg.vocab, (4, 5),
                            generator=torch.Generator().manual_seed(1))
    cache = TM.init_cache(cfg, 4, 32, device=CPU)
    logits, cache = TM.prefill(params, cfg, prompts, cache)
    plan = RS.RingPlan.make(cfg, 2, 1)
    rparams = RS.ring_params(params, cfg, plan)
    ring = [{"len": cache["len"].clone(),
             "layers": RS.pad_and_permute(cache["layers"], cfg, 2, 1)}
            for _ in range(2)]
    steps = [RS.RingServeStep(cfg, plan, rparams, graphs=g, device=CPU)
             for g in (False, True)]
    tok = logits[:, -1:].argmax(-1)
    for _ in range(4):
        want, cache = TM.decode_step(params, cfg, cache, tok)
        for i in range(2):
            got, ring[i] = steps[i](ring[i], tok)
            assert torch.equal(got.argmax(-1), want.argmax(-1))
            assert float((got - want).abs().max()) <= 1e-5
        tok = want.argmax(-1)
    assert steps[1].graphs.replays[("decode", 1)] == 4


def test_expert_mm_routes():
    """``expert_mm``: a plain stack is one batched product, a packed q4
    stack dequantizes at use off the card (qmm's fallback), both in
    x.dtype."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn((4, 3, 64), generator=g)
    w = torch.randn((4, 64, 32), generator=g)
    torch.testing.assert_close(TL.expert_mm(x, w), torch.bmm(x, w))
    from repro_torch.quant.grouped import dequantize_q4, quantize_q4

    qt = quantize_q4(w, 64)
    torch.testing.assert_close(TL.expert_mm(x, qt),
                               x @ dequantize_q4(qt, torch.float32))
    assert TL.expert_mm(x.to(torch.bfloat16), qt).dtype == torch.bfloat16
