"""The port's weight streaming against the JAX package's: the layer store,
the prefetcher, the layer-wise model paths and the streamed engine.

Stores written by either package load in the other (manifest and files
byte-identical). The port's layer-wise logits over the same q4 store agree
with the JAX package's to max|d|/max|ref| < 2e-4 with equal argmax (the
ring tests' bound: f32 on both sides, another order of summation), and
the streamed engine's token streams equal the JAX streaming engine's.
Everything runs on CPU tensors: the prefetcher stages on the host
(``device="cpu"``) and the q4 projections take kernel B3's plain version.
"""
import dataclasses
import filecmp
import json
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
from repro.models import model as JM
from repro.quant import quantize_tree as j_quantize_tree
from repro.runtime import serve as j_serve
from repro.runtime import streaming as JS
from repro.runtime.paramstore import ParamStore as JParamStore
from repro.runtime.paramstore import load_resident as j_load_resident
from repro.runtime.paramstore import save_param_store as j_save
from repro_torch import bridge
from repro_torch.configs import get_config as t_get_config
from repro_torch.data import RequestGenerator
from repro_torch.models import model as TM
from repro_torch.quant import QuantizedTensor
from repro_torch.runtime.iopolicy import FAST_TEST_POLICY, ShortReadError
from repro_torch.runtime.memory import MemoryBudget, TierManager
from repro_torch.runtime.paramstore import (ParamStore, ResidentSource,
                                            load_resident, save_param_store)
from repro_torch.runtime.streaming import (LayerPrefetcher,
                                           StreamingParamSource,
                                           make_streaming_engine)

KEY = jax.random.PRNGKey(0)
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


def _cfgs(n_layers):
    j = dataclasses.replace(get_config("qwen2.5-14b").reduced(),
                            n_layers=n_layers)
    t = dataclasses.replace(t_get_config("qwen2.5-14b").reduced(),
                            n_layers=n_layers)
    return j, t


@pytest.fixture()
def tmp():
    dirs = []

    def make():
        dirs.append(tempfile.mkdtemp(prefix="test_torch_store_"))
        return dirs[-1]

    yield make
    for d in dirs:
        shutil.rmtree(d, ignore_errors=True)


def _np(x):
    """A leaf of either package as a numpy array of its bits (bf16 as
    uint16), or a (packed, scale bits, bits, group, (K, N)) tuple (a JAX
    slice of a stacked leaf keeps the stacked ``shape``, so only its
    trailing (K, N) is compared)."""
    if hasattr(x, "packed"):
        return (_np(x.packed), _np(x.scale), int(x.bits), int(x.group),
                tuple(int(d) for d in x.shape)[-2:])
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = _np(v)
    return out


def _assert_trees_equal(a, b):
    fa, fb = _flat(a), _flat(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        x, y = fa[k], fb[k]
        if isinstance(x, tuple):
            assert x[2:] == y[2:], k
            np.testing.assert_array_equal(x[0], y[0], err_msg=k)
            np.testing.assert_array_equal(x[1], y[1], err_msg=k)
        else:
            assert x.dtype == y.dtype and x.shape == y.shape, k
            np.testing.assert_array_equal(x, y, err_msg=k)


def _jax_tree(kind, n_layers=2):
    jcfg, tcfg = _cfgs(n_layers)
    if kind == "bf16":
        return jcfg, tcfg, JM.init_params(jcfg, KEY, dtype=jnp.bfloat16)
    params = JM.init_params(jcfg, KEY)
    if kind == "q4":
        params = dict(params)
        params["blocks"] = j_quantize_tree(params["blocks"], bits=4,
                                           stacked=True)
    return jcfg, tcfg, params


def _port_tree(jtree):
    """The JAX tree carried over bit for bit (bf16 stays bf16)."""
    def leaf(a):
        if hasattr(a, "packed"):
            return bridge.tree_from_numpy(a, device=CPU)
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.tensor(a.view(np.int16)).view(torch.bfloat16)
        return torch.tensor(a)

    def walk(t):
        return {k: walk(v) if isinstance(v, dict) else leaf(v)
                for k, v in t.items()}
    return walk(jax.tree.map(np.asarray, jtree))


# --------------------------------------------------------------------------- #
#  the store, both directions
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("kind,version", [("f32", 1), ("bf16", 1),
                                          ("q4", 2)])
def test_jax_store_reads_in_port(tmp, kind, version):
    jcfg, _, params = _jax_tree(kind)
    d = j_save(params, jcfg, tmp())
    with ParamStore(d) as store:
        assert store.version == version
        assert store.quant_format == ("q4" if kind == "q4" else None)
        assert store.n_layers == jcfg.n_layers
        for i in range(jcfg.n_layers):
            _assert_trees_equal(store.layer(i),
                                jax.tree.map(lambda a: a[i],
                                             params["blocks"]))
        _assert_trees_equal(load_resident(store), params)
        if kind == "q4":
            wq = store.layer(0)["attn"]["wq"]
            assert isinstance(wq, QuantizedTensor)
            assert wq.packed.dtype == torch.int8
            assert wq.scale.dtype == torch.bfloat16


@pytest.mark.parametrize("kind", ["f32", "bf16", "q4"])
def test_port_store_is_byte_identical_and_reads_in_jax(tmp, kind):
    jcfg, tcfg, params = _jax_tree(kind)
    dj = j_save(params, jcfg, tmp())
    dt = save_param_store(_port_tree(params), tcfg, tmp())
    names = sorted(os.listdir(dj))
    assert sorted(os.listdir(dt)) == names
    for name in names:                    # manifest.json included
        assert filecmp.cmp(os.path.join(dj, name), os.path.join(dt, name),
                           shallow=False), name
    store = JParamStore(dt)
    try:
        back = j_load_resident(store)
    finally:
        store.close()
    _assert_trees_equal(back, params)


def test_store_rejects_mismatched_layers_and_families(tmp):
    _, tcfg, params = _jax_tree("f32")
    tree = _port_tree(params)
    with pytest.raises(ValueError, match="leading axis"):
        save_param_store(tree, dataclasses.replace(tcfg, n_layers=3),
                         tmp())
    with pytest.raises(ValueError, match="unsupported for family"):
        save_param_store(tree, dataclasses.replace(tcfg, family="hybrid"),
                         tmp())


def test_truncated_layer_is_a_short_read_and_reopen_recovers(tmp):
    jcfg, _, params = _jax_tree("q4")
    d = j_save(params, jcfg, tmp())
    path = os.path.join(d, "layer_00001.bin")
    good = open(path, "rb").read()
    with ParamStore(d) as store:
        with open(path, "r+b") as f:
            f.truncate(len(good) // 2)
        with pytest.raises(ShortReadError, match="layer 1 short read"):
            store.layer(1)
        with open(path, "wb") as f:
            f.write(good)
        store.reopen(1)
        _assert_trees_equal(store.layer(1),
                            jax.tree.map(lambda a: a[1], params["blocks"]))
        with pytest.raises(IndexError):
            store.willneed(jcfg.n_layers)
        store.release(1)
        assert store.released_bytes in (0, store.layer_nbytes)
    open(path, "wb").close()                   # zero-length: cannot map
    with ParamStore(d) as store:
        with pytest.raises(ShortReadError, match="cannot map"):
            store.layer(1)


def test_corrupt_manifest_raises(tmp):
    jcfg, _, params = _jax_tree("f32")
    d = j_save(params, jcfg, tmp())
    mpath = os.path.join(d, "manifest.json")
    m = json.load(open(mpath))
    for bad, match in (({**m, "version": 9}, "version"),
                       ({k: v for k, v in m.items() if k != "leaves"},
                        "missing"), ([1], "expected an object")):
        with open(mpath, "w") as f:
            json.dump(bad, f)
        with pytest.raises(ValueError, match=match):
            ParamStore(d)


# --------------------------------------------------------------------------- #
#  prefetcher (counterparts of tests/test_streaming.py)
# --------------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def q4_store():
    """A 6-layer q4 store written by the JAX package, and its tree."""
    d = tempfile.mkdtemp(prefix="test_torch_q4store_")
    jcfg, tcfg, params = _jax_tree("q4", n_layers=6)
    j_save(params, jcfg, d)
    yield jcfg, tcfg, params, d
    shutil.rmtree(d, ignore_errors=True)


def test_prefetcher_residency_bounded_by_window(q4_store):
    jcfg, _, _, d = q4_store
    store = ParamStore(d)
    memory = TierManager(MemoryBudget(host=2 * store.layer_nbytes))
    pf = LayerPrefetcher(store, window=2, device="cpu", memory=memory)
    try:
        for _pass in range(2):                  # cyclic decode pattern
            for i in range(jcfg.n_layers):
                assert pf.get(i)["attn"]["wq"].packed.dtype == torch.int8
        st = pf.stats()
        assert st.peak_resident_bytes <= 2 * store.layer_nbytes
        assert st.layers_served == 2 * jcfg.n_layers
        assert 2 * jcfg.n_layers <= len(st.events) <= 2 * jcfg.n_layers + 2
        assert st.releases > 0
        assert st.bytes_per_layer == store.layer_nbytes
        assert memory.peak("host") <= 2 * store.layer_nbytes
    finally:
        assert pf.close()
        store.close()
    memory.audit()
    assert memory.used("host") == 0 and memory.used("device") == 0


def test_prefetcher_random_access_correct(q4_store):
    _, _, params, d = q4_store
    store = ParamStore(d)
    pf = LayerPrefetcher(store, window=2, device="cpu")
    try:
        for i in (3, 0, 2, 1, 3, 5, 4, 0):
            _assert_trees_equal(pf.get(i), jax.tree.map(
                lambda a: a[i], params["blocks"]))
    finally:
        pf.close()
        store.close()


def test_prefetcher_staging_failure_raises_not_hangs(q4_store):
    """A worker-thread failure surfaces in get() as an error, never a
    deadlock."""
    d = q4_store[3]
    store = ParamStore(d)
    store.layer_nbytes = 1 << 40          # poison: reads past EOF
    pf = LayerPrefetcher(store, window=2, device="cpu",
                         policy=FAST_TEST_POLICY)
    try:
        with pytest.raises(RuntimeError, match="prefetch of layer"):
            pf.get(0)
    finally:
        pf.close()
        store.close()


def test_tracer_is_not_ported_yet(q4_store):
    """The span tracer is ported: the prefetcher and the tier manager
    emit into a real ``Tracer`` on the JAX prefetcher's tracks and names,
    and refuse anything else."""
    from repro_torch.runtime.telemetry import Tracer

    store = ParamStore(q4_store[3])
    tracer = Tracer()
    try:
        with pytest.raises(TypeError, match="Tracer"):
            StreamingParamSource(store, window=1, device="cpu",
                                 tracer=object())
        with pytest.raises(TypeError, match="Tracer"):
            TierManager(tracer=object())
        with StreamingParamSource(store, window=2, device="cpu",
                                  tracer=tracer) as src:
            for i in (0, 1, 2, 0):
                src.layer(i)
        names = {(ev.track, ev.name.split("[")[0])
                 for ev in tracer.events()}
        assert ("prefetcher", "layer_read") in names
        assert ("prefetcher", "store/released_bytes") in names
        mem = TierManager(tracer=tracer, name="kv-memory")
        mem.lease("device", 64, "kv")
        assert ("kv-memory", "mem/device/used") in {
            (ev.track, ev.name) for ev in tracer.events()}
    finally:
        store.close()


# --------------------------------------------------------------------------- #
#  layer-wise model paths over the same q4 store
# --------------------------------------------------------------------------- #

def _close(t_logits, j_logits):
    a = t_logits.detach().float().numpy()
    b = np.asarray(j_logits, np.float32)
    assert a.shape == b.shape
    assert np.abs(a - b).max() / np.abs(b).max() < REL
    np.testing.assert_array_equal(a.argmax(-1), b.argmax(-1))


@pytest.fixture(scope="module")
def q4_ring_store():
    """A 3-layer store quantized as the serve drivers do (every matmul
    weight, ``quantize_ring_params`` at tp=1), written by the JAX
    package."""
    d = tempfile.mkdtemp(prefix="test_torch_ringstore_")
    jcfg, tcfg = _cfgs(3)
    params, _ = j_serve.quantize_ring_params(
        dict(JM.init_params(jcfg, KEY)), jcfg, tp=1)
    j_save(params, jcfg, d)
    yield jcfg, tcfg, params, d
    shutil.rmtree(d, ignore_errors=True)


@pytest.mark.parametrize("T", [1, 3])
def test_layerwise_prefill_and_decode_match_jax(q4_ring_store, T):
    jcfg, tcfg, _, d = q4_ring_store
    rng = np.random.default_rng(T)
    prompt = rng.integers(3, jcfg.vocab, (2, 9)).astype(np.int32)
    toks = rng.integers(3, jcfg.vocab, (2, T)).astype(np.int32)
    jsrc = JParamStore(d)
    tsrc = StreamingParamSource(ParamStore(d), window=2, device="cpu")
    try:
        cj = JM.init_cache(jcfg, 2, 32, dtype=jnp.float32)
        ct = TM.init_cache(tcfg, 2, 32, device=CPU)
        lj, cj = JM.prefill_layerwise(jsrc, jcfg, jnp.asarray(prompt), cj)
        lt, ct = TM.prefill_layerwise(tsrc, tcfg, torch.as_tensor(prompt),
                                      ct)
        _close(lt, lj)
        np.testing.assert_allclose(ct["layers"]["k"].numpy(),
                                   np.asarray(cj["layers"]["k"]),
                                   rtol=1e-4, atol=1e-4)
        lj, cj = JM.decode_step_layerwise(jsrc, jcfg, cj, jnp.asarray(toks))
        lt, ct = TM.decode_step_layerwise(tsrc, tcfg, ct,
                                          torch.as_tensor(toks))
        _close(lt, lj)
        np.testing.assert_array_equal(ct["len"].numpy(),
                                      np.asarray(cj["len"]))
        assert tsrc.stats().peak_resident_bytes <= \
            2 * tsrc.store.layer_nbytes
    finally:
        jsrc.close()
        tsrc.close()


def test_forward_layerwise_and_resident_forward_match_jax(q4_ring_store):
    jcfg, tcfg, params, d = q4_ring_store
    tokens = np.random.default_rng(5).integers(
        3, jcfg.vocab, (2, 7)).astype(np.int32)
    jsrc = JParamStore(d)
    try:
        lj = JM.forward_layerwise(jsrc, jcfg, jnp.asarray(tokens))
    finally:
        jsrc.close()
    with ParamStore(d) as store:
        _close(TM.forward_layerwise(store, tcfg, torch.as_tensor(tokens)),
               lj)
    # the resident model over the dequantized weights: JAX's forward
    dq = dict(params)
    dq["blocks"] = jax.tree.map(
        lambda a: a, JS_dequant(params["blocks"]))
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, dq),
                                       device=CPU)
    _close(TM.forward(tparams, tcfg, torch.as_tensor(tokens)),
           JM.forward(dq, jcfg, jnp.asarray(tokens)))


def JS_dequant(tree):
    from repro.quant import dequantize_tree
    return dequantize_tree(tree, jnp.float32)


def test_card_route_of_the_layerwise_path(q4_ring_store, monkeypatch):
    """The route a CUDA tensor takes: with kernels reported active every
    projection of every layer goes to kernel B3's wrapper (replaced here
    by its plain version), 7 launches a layer a pass, and the logits
    still match the JAX package's."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import q4_matmul as q4

    jcfg, tcfg, _, d = q4_ring_store
    calls = []

    def stand_in(x, packed, scale, *, group):
        calls.append((x.shape[0], x.shape[1], packed.shape[1]))
        return q4.q4_matmul_ref(x, packed, scale, group=group)

    monkeypatch.setattr(q4, "q4_matmul", stand_in)
    monkeypatch.setattr(ops, "kernels_active", lambda t: True)
    prompt = np.random.default_rng(11).integers(
        3, jcfg.vocab, (1, 6)).astype(np.int32)
    jsrc = JParamStore(d)
    try:
        lj, _ = JM.prefill_layerwise(jsrc, jcfg, jnp.asarray(prompt),
                                     JM.init_cache(jcfg, 1, 16,
                                                   dtype=jnp.float32))
    finally:
        jsrc.close()
    with ParamStore(d) as store:
        lt, _ = TM.prefill_layerwise(store, tcfg, torch.as_tensor(prompt),
                                     TM.init_cache(tcfg, 1, 16, device=CPU))
    _close(lt, lj)
    d_, H, hk, hd, f = (tcfg.d_model, tcfg.n_heads, tcfg.kv_heads,
                        tcfg.head_dim, tcfg.d_ff)
    layer = [(6, d_, H * hd), (6, d_, hk * hd), (6, d_, hk * hd),
             (6, H * hd, d_), (6, d_, f), (6, d_, f), (6, f, d_)]
    assert calls == layer * tcfg.n_layers


def test_layerwise_rejects_other_families(q4_ring_store):
    _, tcfg, _, d = q4_ring_store
    with ParamStore(d) as store:
        with pytest.raises(ValueError, match="unsupported for family"):
            TM.forward_layerwise(store, dataclasses.replace(
                tcfg, family="hybrid"), torch.zeros((1, 2), dtype=torch.int32))


# --------------------------------------------------------------------------- #
#  the streamed engine
# --------------------------------------------------------------------------- #

def _streams(finished):
    return {f.uid: f.tokens for f in finished}


def test_streaming_engine_matches_jax_and_resident(q4_ring_store):
    """Window 1 over the q4 store: the JAX streaming engine's streams, the
    port's resident engine's streams, one layer resident at a time."""
    jcfg, tcfg, params, d = q4_ring_store
    B, ctx = 2, 64
    reqs = RequestGenerator(tcfg.vocab, prompt_len=(4, 12), max_new=5,
                            seed=3).generate(4)
    jreqs = JRequestGenerator(jcfg.vocab, prompt_len=(4, 12), max_new=5,
                              seed=3).generate(4)
    jsrc = JS.StreamingParamSource(JParamStore(d), window=1,
                                   device_put=False)
    try:
        eng = JS.make_streaming_engine(jsrc, jcfg, B, ctx)
        fin_j, _ = eng.run(JM.init_cache(jcfg, B, ctx, dtype=jnp.float32),
                           jreqs)
    finally:
        jsrc.close()

    src = StreamingParamSource(ParamStore(d), window=1, device="cpu")
    try:
        eng = make_streaming_engine(src, tcfg, B, ctx, device=CPU)
        fin_s, steps = eng.run(TM.init_cache(tcfg, B, ctx, device=CPU),
                               reqs)
        st = eng.streaming_stats()
        assert st.peak_resident_bytes <= src.store.layer_nbytes
        assert st.layers_served == tcfg.n_layers * (len(reqs) + steps)
    finally:
        src.close()
    assert _streams(fin_s) == _streams(fin_j)
    assert all(len(f.tokens) == r.max_new_tokens for f, r in zip(
        sorted(fin_s, key=lambda f: f.uid), reqs))

    resident = ResidentSource(bridge.tree_from_numpy(
        jax.tree.map(np.asarray, params), device=CPU))
    eng = make_streaming_engine(resident, tcfg, B, ctx, device=CPU)
    fin_r, _ = eng.run(TM.init_cache(tcfg, B, ctx, device=CPU), reqs)
    assert _streams(fin_r) == _streams(fin_s)
    assert eng.streaming_stats() is None        # resident: no prefetcher


def test_serve_cli_streamed_q4_smoke():
    """``python -m repro_torch.launch.serve --stream-window 2
    --store-quant q4 --check-resident`` on the CPU: every request served
    from the q4 store, tokens equal to the resident run's."""
    from repro_torch.launch import serve

    res = serve.main(["--smoke", "--device", "cpu", "--dtype", "f32",
                      "--layers", "2", "--batch", "2", "--requests", "3",
                      "--new-tokens", "4", "--stream-window", "2",
                      "--store-quant", "q4", "--check-resident"])["stream"]
    assert len(res["finished"]) == 3 and not res["rejected"]
    assert res["stats"].peak_resident_bytes <= 2 * res["store_layer_nbytes"]
    with pytest.raises(SystemExit):
        serve.parse_args(["--stream-window", "2", "--check-dense"])
    with pytest.raises(SystemExit):
        serve.parse_args(["--store-quant", "q4"])
