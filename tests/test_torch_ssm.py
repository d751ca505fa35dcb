"""The port's ssm family (Mamba-2, ``mamba2-780m``) against the JAX
package's, at the reduced size on the CPU: the SSD scan (kernel B6's plain
version), the block, the model's prefill and decode, the dense and
streamed q4 engines, the layer store, and the refusals.

Tolerances, each with its reason:

* the SSD scans: atol = rtol = 2e-4, the bound ``tests/test_kernels.py``
  holds the Pallas kernel to (f32 on both sides, another order of
  summation over up to 128-position chunks);
* the block and the model: max|d|/max|ref| < 2e-4 with equal argmax, the
  port's logit bound (``tests/test_torch_model.py``);
* token streams and store bytes: equal.

Inputs are drawn from numpy seeds and handed to both packages. The CUDA
kernel itself needs the card: ``chip_smoke.py`` holds every launch
against the plain version there.
"""
import dataclasses
import filecmp
import os
import shutil
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.data import RequestGenerator as JRequestGenerator
from repro.kernels import ref as jref
from repro.kernels.ssd_scan import ssd_scan as j_ssd_scan
from repro.models import layers as JL
from repro.models import model as JM
from repro.runtime import serve as j_serve
from repro.runtime import streaming as JS
from repro.runtime.engine import make_dense_engine as j_dense_engine
from repro.runtime.kvcache import PagedKVCache as JPagedKVCache
from repro.runtime.paramstore import ParamStore as JParamStore
from repro.runtime.paramstore import save_param_store as j_save
from repro.runtime.speculative import SpeculativeDecoder as JSpec
from repro_torch import bridge
from repro_torch.configs import get_config as t_get_config
from repro_torch.data import RequestGenerator
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as tssd
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.runtime.engine import make_dense_engine
from repro_torch.runtime.kvcache import PagedKVCache
from repro_torch.runtime.paramstore import (ParamStore, ResidentSource,
                                            save_param_store)
from repro_torch.runtime.serve import quantize_ring_params
from repro_torch.runtime.speculative import SpeculativeDecoder
from repro_torch.runtime.streaming import (StreamingParamSource,
                                           make_streaming_engine)

ARCH = "mamba2-780m"
CPU = torch.device("cpu")
KEY = jax.random.PRNGKey(0)
SCAN_TOL = dict(rtol=2e-4, atol=2e-4)
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


def _cfgs(n_layers=None):
    j, t = get_config(ARCH).reduced(), t_get_config(ARCH).reduced()
    if n_layers:
        j = dataclasses.replace(j, n_layers=n_layers)
        t = dataclasses.replace(t, n_layers=n_layers)
    return j, t


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


def _scan_inputs(seed, Bsz, S, nh, P, N):
    """x, dt (softplus of a normal), A (< 0), B and C, as
    ``tests/test_kernels.py`` draws them."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((Bsz, S, nh, P)).astype(np.float32) * 0.5
    dt = np.log1p(np.exp(rng.standard_normal((Bsz, S, nh)))).astype(
        np.float32)
    A = -np.exp(rng.standard_normal(nh) * 0.3).astype(np.float32)
    Bm = rng.standard_normal((Bsz, S, N)).astype(np.float32) * 0.3
    Cm = rng.standard_normal((Bsz, S, N)).astype(np.float32) * 0.3
    return x, dt, A, Bm, Cm


def _close(got, want, tol=SCAN_TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **tol)


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


# --------------------------------------------------------------------------- #
#  B6's plain version against the Pallas kernel and the oracles
# --------------------------------------------------------------------------- #

#: (B, S, nh, P, N, chunk) with S % chunk == 0, as the Pallas kernel needs;
#: the last is the reduced config's head geometry
PALLAS_CASES = [(2, 32, 3, 8, 16, 16), (1, 64, 2, 16, 32, 32),
                (1, 32, 8, 16, 16, 16)]


@pytest.mark.parametrize("case", range(len(PALLAS_CASES)))
def test_ssd_scan_ref_matches_pallas(case):
    Bsz, S, nh, P, N, chunk = PALLAS_CASES[case]
    args = _scan_inputs(case, Bsz, S, nh, P, N)
    y_j, h_j = j_ssd_scan(*map(jnp.asarray, args), chunk=chunk,
                          interpret=True)
    y_t, h_t = tssd.ssd_scan_ref(*map(_t, args), chunk=chunk)
    _close(y_t, y_j)
    _close(h_t, h_j)


#: S < chunk, ragged S over two and three chunks, the model's chunk
RAGGED_CASES = [(2, 9, 4, 16, 16), (1, 200, 3, 8, 32), (2, 77, 8, 16, 16),
                (1, 300, 2, 16, 16)]


@pytest.mark.parametrize("case", range(len(RAGGED_CASES)))
def test_ssd_scan_ref_matches_oracles_at_any_length(case):
    """Any S at the model's chunk of 128: the JAX chunked oracle (which pads
    as the port does) and the O(S) recurrence of both packages."""
    args = _scan_inputs(10 + case, *RAGGED_CASES[case])
    jargs = tuple(map(jnp.asarray, args))
    y_t, h_t = tssd.ssd_scan_ref(*map(_t, args))
    y_c, h_c = jref.ssd_scan_ref(*jargs)
    y_s, h_s = jref.ssd_sequential_ref(*jargs)
    ys_t, hs_t = tssd.ssd_sequential_ref(*map(_t, args))
    for got, want in ((y_t, y_c), (h_t, h_c), (y_t, y_s), (h_t, h_s),
                      (ys_t, y_s), (hs_t, h_s)):
        _close(got, want)
    # ops routes a CPU tensor to the plain version, and counts nothing
    y_o, _ = ops.ssd_scan(*map(_t, args))
    np.testing.assert_array_equal(y_o.numpy(), y_t.numpy())
    assert ops.launch_counts()["ssd_scan"] == 0


def test_ssd_chunked_with_a_starting_state_matches_jax():
    """The plain path for a non-zero state (a prefill that continues a
    sequence), over three ragged chunks."""
    Bsz, S, nh, P, N = 2, 300, 3, 8, 16
    args = _scan_inputs(20, Bsz, S, nh, P, N)
    h0 = np.random.default_rng(21).standard_normal(
        (Bsz, nh, P, N)).astype(np.float32)
    y_j, h_j = JL.ssd_chunked(*map(jnp.asarray, args), h0=jnp.asarray(h0))
    y_t, h_t = TL.ssd_chunked(*map(_t, args), h0=_t(h0))
    _close(y_t, y_j)
    _close(h_t, h_j)


def test_ssd_scan_wrapper_checks_its_inputs():
    """The B6 wrapper takes CUDA tensors only and raises before anything is
    built or launched; ``use_kernels(False)`` forces the plain version."""
    x, dt, A, Bm, Cm = map(_t, _scan_inputs(30, 1, 9, 2, 8, 16))
    with pytest.raises(ValueError, match="CUDA"):
        tssd.ssd_scan(x, dt, A, Bm, Cm)
    ops.use_kernels(False)
    try:
        assert not ops.kernels_active(x)
        forced = ops.ssd_scan(x, dt, A, Bm, Cm)
    finally:
        ops.use_kernels(True)
    torch.testing.assert_close(forced, tssd.ssd_scan_ref(x, dt, A, Bm, Cm))
    assert ops.launch_counts()["ssd_scan"] == 0


# --------------------------------------------------------------------------- #
#  the block and the model
# --------------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def world():
    """JAX weights of the reduced mamba2-780m and the port's copy."""
    jcfg, tcfg = _cfgs()
    jparams = JM.init_params(jcfg, KEY)
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                       device=CPU)
    return {"jcfg": jcfg, "tcfg": tcfg, "jparams": jparams,
            "tparams": tparams, "runs": {}}


def test_bridge_round_trip_and_init_layout(world):
    """JAX weights carry over leaf for leaf, and the port's own
    ``init_params`` draws a tree of the JAX layout (names, shapes, dtypes)
    with the reference's constant leaves."""
    back = bridge.tree_from_params(world["tparams"])
    want = jax.tree.map(np.asarray, world["jparams"])
    assert jax.tree.structure(jax.tree.map(lambda t: 0, back)) == \
        jax.tree.structure(jax.tree.map(lambda a: 0, want))
    jax.tree.map(lambda t, a: np.testing.assert_array_equal(t.numpy(), a),
                 back, want)
    tcfg = world["tcfg"]
    gen = torch.Generator().manual_seed(0)
    own = bridge.tree_from_params(TM.init_params(tcfg, gen, device=CPU))
    jax.tree.map(lambda t, a: (t.shape == a.shape and t.numpy().dtype
                               == a.dtype) or pytest.fail("layout"),
                 own, want)
    ssd, jssd = own["blocks"]["ssd"], want["blocks"]["ssd"]
    for k in ("dt_bias", "a_log", "d_skip", "norm"):
        np.testing.assert_allclose(ssd[k].numpy(), jssd[k], rtol=1e-6)
    assert "unembed" not in own                    # tied embeddings


def test_ssd_block_prefill_continue_and_decode_match_jax(world):
    """One block with a cache: a zero-state prefill (``ops.ssd_scan``), a
    prefill that continues the state (``ssd_chunked`` with ``h0``), then a
    decode step; outputs and the written conv window and state."""
    jcfg, tcfg = world["jcfg"], world["tcfg"]
    jp = jax.tree.map(lambda a: a[0], world["jparams"]["blocks"]["ssd"])
    tp = world["tparams"].blocks[0].ssd
    rng = np.random.default_rng(40)
    jc = jax.tree.map(lambda a: a[0], JM.init_cache(jcfg, B, CTX,
                                                    dtype=jnp.float32)
                      ["layers"])
    tc = {k: v[0] for k, v in TM.init_cache(tcfg, B, CTX, device=CPU)
          ["layers"].items()}
    for S, decode, fresh in ((13, False, True), (150, False, False),
                             (1, True, False)):
        x = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
        out_j, jc = JL.ssd_block(jp, jcfg, jnp.asarray(x), cache=jc,
                                 decode=decode)
        out_t = TL.ssd_block(tp, tcfg, _t(x), cache=tc, decode=decode,
                             fresh=fresh)
        assert _rel(out_t, out_j) < REL, (S, decode)
        for k in ("conv", "state"):
            assert _rel(tc[k], jc[k]) < REL, (S, decode, k)
    # no cache: the zero-state scan, as forward runs it
    x = rng.standard_normal((B, 7, jcfg.d_model)).astype(np.float32)
    out_j, _ = JL.ssd_block(jp, jcfg, jnp.asarray(x))
    assert _rel(TL.ssd_block(tp, tcfg, _t(x)), out_j) < REL


@pytest.mark.parametrize("S", [9, 150])
def test_prefill_and_decode_match_jax(world, S):
    """``prefill`` plus 4 ``decode_step``s on bridged weights (a prompt
    shorter than a chunk and one over two ragged chunks), and ``forward``
    over the prompt."""
    jcfg, tcfg = world["jcfg"], world["tcfg"]
    rng = np.random.default_rng(S)
    prompt = rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32)
    full_j = JM.forward(world["jparams"], jcfg, jnp.asarray(prompt))
    full_t = TM.forward(world["tparams"], tcfg, _t(prompt))
    assert _rel(full_t, full_j) < REL
    jc = JM.init_cache(jcfg, B, CTX, dtype=jnp.float32)
    tc = TM.init_cache(tcfg, B, CTX, device=CPU)
    lj, jc = JM.prefill(world["jparams"], jcfg, jnp.asarray(prompt), jc)
    lt, tc = TM.prefill(world["tparams"], tcfg, _t(prompt), tc)
    for step in range(5):
        assert _rel(lt, lj) < REL, step
        np.testing.assert_array_equal(lt.argmax(-1).numpy(),
                                      np.asarray(lj).argmax(-1))
        nxt = np.asarray(lj).argmax(-1).astype(np.int32)      # (B, 1)
        lj, jc = JM.decode_step(world["jparams"], jcfg, jc,
                                jnp.asarray(nxt))
        lt, tc = TM.decode_step(world["tparams"], tcfg, tc, _t(nxt))
    np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))
    assert _rel(tc["layers"]["state"], jc["layers"]["state"]) < REL


def test_fresh_prefill_launches_the_scan_kernel_once_a_layer(world,
                                                             monkeypatch):
    """With the card's route taken (kernels reported active, the wrapper
    replaced by a spy over the plain version), a prefill into
    ``init_cache``'s cache and ``forward`` call B6 once a layer; decode and
    a prefill that continues a state never do."""
    tcfg, tparams = world["tcfg"], world["tparams"]
    calls = []

    def spy(*a, **k):
        calls.append(a[0].shape)
        return tssd.ssd_scan_ref(*a, **k)

    monkeypatch.setattr(ops, "kernels_active", lambda t: True)
    monkeypatch.setattr(tssd, "ssd_scan", spy)
    prompt = _t(np.arange(2 * 11, dtype=np.int32).reshape(2, 11) % 200)
    cache = TM.init_cache(tcfg, B, CTX, device=CPU)
    _, cache = TM.prefill(tparams, tcfg, prompt, cache)
    assert calls == [(B, 11, 8, 16)] * tcfg.n_layers
    TM.forward(tparams, tcfg, prompt)
    assert len(calls) == 2 * tcfg.n_layers
    _, cache = TM.decode_step(tparams, tcfg, cache, prompt[:, :1])
    _, cache = TM.prefill(tparams, tcfg, prompt, cache)        # continues
    assert len(calls) == 2 * tcfg.n_layers


# --------------------------------------------------------------------------- #
#  engines, the store and the serve CLI
# --------------------------------------------------------------------------- #

def _requests(vocab, n=5):
    reqs = RequestGenerator(vocab, prompt_len=(4, 30), max_new=6,
                            seed=3).generate(n)
    jreqs = JRequestGenerator(vocab, prompt_len=(4, 30), max_new=6,
                              seed=3).generate(n)
    for a, b in zip(reqs, jreqs):
        np.testing.assert_array_equal(a.prompt, b.prompt)
    return reqs


def _streams(finished):
    return {f.uid: f.tokens for f in finished}


def test_dense_engine_streams_match_jax(world):
    jcfg, tcfg = world["jcfg"], world["tcfg"]
    reqs = _requests(tcfg.vocab)
    fin_j, _ = j_dense_engine(world["jparams"], jcfg, B, CTX).run(
        JM.init_cache(jcfg, B, CTX, dtype=jnp.float32), reqs)
    eng = make_dense_engine(world["tparams"], tcfg, B, CTX, device=CPU)
    fin_t, _ = eng.run(TM.init_cache(tcfg, B, CTX, device=CPU), reqs)
    assert _streams(fin_t) == _streams(fin_j)
    assert all(len(f.tokens) == r.max_new_tokens for f, r in zip(
        sorted(fin_t, key=lambda f: f.uid), reqs))


@pytest.fixture(scope="module")
def q4_store():
    """A 3-layer ssm store quantized as the serve drivers do (every
    matmul weight, ``quantize_ring_params`` at tp=1), written by JAX."""
    d = tempfile.mkdtemp(prefix="test_torch_ssm_store_")
    jcfg, tcfg = _cfgs(3)
    params, skipped = j_serve.quantize_ring_params(
        dict(JM.init_params(jcfg, KEY)), jcfg, tp=1)
    assert not skipped
    j_save(params, jcfg, d)
    yield jcfg, tcfg, params, d
    shutil.rmtree(d, ignore_errors=True)


def test_streamed_q4_engine_matches_jax_and_resident(q4_store):
    """Window 1 over the q4 store: the JAX streaming engine's streams, the
    port's streamed engine's and its resident engine's, equal."""
    jcfg, tcfg, params, d = q4_store
    reqs = _requests(tcfg.vocab, n=4)
    jsrc = JS.StreamingParamSource(JParamStore(d), window=1,
                                   device_put=False)
    try:
        eng = JS.make_streaming_engine(jsrc, jcfg, B, CTX)
        fin_j, _ = eng.run(JM.init_cache(jcfg, B, CTX, dtype=jnp.float32),
                           reqs)
    finally:
        jsrc.close()
    src = StreamingParamSource(ParamStore(d), window=1, device="cpu")
    try:
        eng = make_streaming_engine(src, tcfg, B, CTX, device=CPU)
        fin_s, steps = eng.run(TM.init_cache(tcfg, B, CTX, device=CPU),
                               reqs)
        st = eng.streaming_stats()
        assert st.peak_resident_bytes <= src.store.layer_nbytes
        assert st.layers_served == tcfg.n_layers * (len(reqs) + steps)
        leaf = src.store.layer(0)["ssd"]
        assert all(hasattr(leaf[k], "packed") for k in ("in_proj",
                                                         "out_proj"))
        assert not hasattr(leaf["conv_w"], "packed")
    finally:
        src.close()
    assert _streams(fin_s) == _streams(fin_j)
    resident = ResidentSource(bridge.tree_from_numpy(
        jax.tree.map(np.asarray, params), device=CPU))
    eng = make_streaming_engine(resident, tcfg, B, CTX, device=CPU)
    fin_r, _ = eng.run(TM.init_cache(tcfg, B, CTX, device=CPU), reqs)
    assert _streams(fin_r) == _streams(fin_s)


@pytest.mark.parametrize("kind", ["f32", "bf16", "q4"])
def test_port_ssm_store_is_byte_identical(kind):
    """The port's store of the same weights equals the JAX writer's byte
    for byte (manifest included): v1 in f32 and bf16, v2 where each
    package quantizes for itself with ``quantize_ring_params`` at tp=1
    (``in_proj``/``out_proj`` to q4; ``conv_w``, whose axis -2 is the conv
    width, and the vectors stay as they are)."""
    jcfg, tcfg = _cfgs(2)
    dtype = jnp.bfloat16 if kind == "bf16" else jnp.float32
    jparams = JM.init_params(jcfg, KEY, dtype=dtype)
    tree = jax.tree.map(np.asarray, jparams)
    if kind == "bf16":
        ttree = jax.tree.map(lambda a: torch.tensor(a.view(np.int16)).view(
            torch.bfloat16), tree)
    else:
        ttree = jax.tree.map(torch.tensor, tree)
    if kind == "q4":
        jparams, _ = j_serve.quantize_ring_params(dict(jparams), jcfg, tp=1)
        ttree, skipped = quantize_ring_params(ttree, tcfg, tp=1)
        assert not skipped
        ssd = ttree["blocks"]["ssd"]
        assert {k for k, v in ssd.items() if hasattr(v, "packed")} == \
            {"in_proj", "out_proj"}
        assert tuple(ssd["conv_w"].shape) == (2, 4, 160)
    dirs = [tempfile.mkdtemp(prefix="test_torch_ssm_") for _ in range(2)]
    try:
        j_save(jparams, jcfg, dirs[0])
        save_param_store(ttree, tcfg, dirs[1])
        names = sorted(os.listdir(dirs[0]))
        assert sorted(os.listdir(dirs[1])) == names
        for name in names:
            assert filecmp.cmp(os.path.join(dirs[0], name),
                               os.path.join(dirs[1], name),
                               shallow=False), name
    finally:
        for d in dirs:
            shutil.rmtree(d, ignore_errors=True)


def test_multi_token_decode_and_paged_cache_refuse_ssm(world, q4_store):
    """Recurrent state has no per-token pages and cannot roll back: T > 1
    decode (resident and layer-wise) and the paged cache raise
    ``ValueError`` in both packages."""
    jcfg, tcfg = world["jcfg"], world["tcfg"]
    toks = np.zeros((B, 2), np.int32)
    with pytest.raises(ValueError, match="multi-token decode unsupported"):
        JM.decode_step(world["jparams"], jcfg,
                       JM.init_cache(jcfg, B, CTX), jnp.asarray(toks))
    with pytest.raises(ValueError, match="multi-token decode unsupported"):
        TM.decode_step(world["tparams"], tcfg,
                       TM.init_cache(tcfg, B, CTX, device=CPU), _t(toks))
    _, tcfg3, _, d = q4_store
    with ParamStore(d) as store:
        with pytest.raises(ValueError,
                           match="multi-token decode unsupported"):
            TM.decode_step_layerwise(store, tcfg3, TM.init_cache(
                tcfg3, B, CTX, device=CPU), _t(toks))
    with pytest.raises(ValueError, match="unsupported for family"):
        JPagedKVCache(jcfg, batch=B, ctx=CTX, n_pages=16, offload=False)
    with pytest.raises(ValueError, match="unsupported for family"):
        PagedKVCache(tcfg, batch=B, ctx=CTX, n_pages=16, device=CPU)


def test_speculative_decoding_over_an_ssm_target_fails_as_in_jax(world):
    """The verify pass is a T = gamma + 1 decode step, which the ssm
    family refuses: the spec engine fails on its first cycle in both
    packages."""
    jcfg, tcfg = world["jcfg"], world["tcfg"]
    reqs = _requests(tcfg.vocab, n=2)
    jspec = JSpec(lambda c, t: JM.decode_step(world["jparams"], jcfg, c, t),
                  lambda c, t: JM.decode_step(world["jparams"], jcfg, c, t),
                  gamma=2, draft_cache=JM.init_cache(jcfg, B, CTX,
                                                     dtype=jnp.float32))
    with pytest.raises(ValueError, match="multi-token decode unsupported"):
        j_dense_engine(world["jparams"], jcfg, B, CTX, spec=jspec).run(
            JM.init_cache(jcfg, B, CTX, dtype=jnp.float32), reqs)
    tp = world["tparams"]
    spec = SpeculativeDecoder(
        lambda c, t: TM.decode_step(tp, tcfg, c, t),
        lambda c, t: TM.decode_step(tp, tcfg, c, t), gamma=2,
        draft_cache=TM.init_cache(tcfg, B, CTX, device=CPU))
    with pytest.raises(ValueError, match="multi-token decode unsupported"):
        make_dense_engine(tp, tcfg, B, CTX, spec=spec, device=CPU).run(
            TM.init_cache(tcfg, B, CTX, device=CPU), reqs)


@pytest.mark.parametrize("extra", [["--paged-kv"], ["--stream-window", "2",
                                        "--store-quant", "q4",
                                        "--check-resident"]])
def test_serve_cli_serves_mamba2(extra):
    """``python -m repro_torch.launch.serve --arch mamba2-780m --smoke
    --device cpu``: the dense-cache engine, or (``--stream-window``) the
    layer-wise engine over a q4 store with the resident check; the
    paged-only flags are an argument error for the family."""
    from repro_torch.launch import serve

    res = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--dtype", "f32", "--layers", "2", "--batch", "2",
                      "--requests", "3", "--new-tokens", "4", *extra])
    res = res["stream" if "--stream-window" in extra else "paged"]
    assert len(res["finished"]) == 3 and not res["rejected"]
    assert all(len(f.tokens) == 4 for f in res["finished"])
    for flag in (["--check-dense"], ["--prefill-chunk", "8"],
                 ["--kv-quant-kernel"]):
        with pytest.raises(SystemExit):
            serve.parse_args(["--arch", ARCH, *flag])
