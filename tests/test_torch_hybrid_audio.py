"""The hybrid (recurrentgemma-9b: RG-LRU and local attention) and audio
(whisper-tiny) families in the port against the JAX package, reduced, on
the same weights carried across by ``bridge``: the doubling scan against
``lax.associative_scan``, the hybrid model (prefill through the rolling
attention buffer, a prompt longer than the window, decode), its
dense-cache engine eager and replayed through ``StepGraphs`` over the
group/tail cache tree, the store's and the paged cache's refusals, whisper
with its frames (forward, prefill, decode to a full self-attention cache),
the driver's ``--smoke`` for recurrentgemma-9b and its refusal of whisper.
Logits within max|d|/max|ref| < 2e-4, f32 on both sides; greedy streams
equal. The scan sums in another order than JAX's tree: its outputs agree
to 1e-5 of max|ref| at S = 100 in f32.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import model as JM
from repro.runtime.engine import make_dense_engine as j_dense_engine
from repro_torch import bridge
from repro_torch.configs import get_config as t_get_config
from repro_torch.data import RequestGenerator
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.runtime import kvcache as TK
from repro_torch.runtime.engine import dense_decode, make_dense_engine
from repro_torch.runtime.paramstore import save_param_store

CPU = torch.device("cpu")
REL = 2e-4
HYBRID, AUDIO = "recurrentgemma-9b", "whisper-tiny"


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


@functools.lru_cache(maxsize=None)
def _world(arch, n_layers=None):
    kw = {} if n_layers is None else {"n_layers": n_layers}
    jcfg, tcfg = _cfgs(arch, **kw)
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


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, np.asarray(tree)


# --------------------------------------------------------------------------- #
#  the RG-LRU scan
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("S", [7, 100])
def test_doubling_scan_equals_associative_scan(S):
    rng = np.random.default_rng(S)
    a = rng.uniform(0.5, 1.0, (2, S, 8)).astype(np.float32)
    b = rng.standard_normal((2, S, 8)).astype(np.float32)

    def comb(l, r):
        return l[0] * r[0], l[1] * r[0] + r[1]
    ja, jb = jax.lax.associative_scan(comb, (jnp.asarray(a), jnp.asarray(b)),
                                      axis=1)
    ta, tb = TL.doubling_scan(torch.as_tensor(a), torch.as_tensor(b))
    for got, want in ((ta, ja), (tb, jb)):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    h, ref = np.zeros((2, 8), np.float32), []
    for t in range(S):                      # the recurrence itself
        h = a[:, t] * h + b[:, t]
        ref.append(h)
    np.testing.assert_allclose(tb.numpy(), np.stack(ref, 1), rtol=1e-4,
                               atol=1e-5)


# --------------------------------------------------------------------------- #
#  hybrid
# --------------------------------------------------------------------------- #

def test_hybrid_tree_and_cache_layout_match_jax():
    """7 reduced layers: 2 groups of (rglru, rglru, attn) and a tail of
    one RG-LRU layer. The bridge carries the groups and the tail both
    ways, and ``init_cache`` builds JAX's tree of groups and tail."""
    jcfg, tcfg, jp, tp = _world(HYBRID, 7)
    assert tp.groups == (2, 3)
    assert [type(b).__name__ for b in tp.blocks] == [
        "RGLRUBlock", "RGLRUBlock", "DenseBlock"] * 2 + ["RGLRUBlock"]
    back = bridge.tree_from_params(tp)
    want = dict(_leaves(jax.tree.map(np.asarray, jp)))
    got = dict(_leaves(jax.tree.map(lambda t: t.numpy(), back)))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    jc = JM.init_cache(jcfg, 2, 48, dtype=jnp.float32)
    tc = TM.init_cache(tcfg, 2, 48, device=CPU)
    assert {k: v.shape for k, v in _leaves(jc)} == {
        k: tuple(v.shape) for k, v in _leaves(jax.tree.map(
            lambda t: t.numpy(), tc))}


def test_hybrid_prefill_and_decode_match_jax():
    """The attention layers keep min(ctx, window) = 32 rolling lines at
    ctx 64, which a 40-token prompt wraps; the RG-LRU layers scan the
    prompt and step their state: logits and every cache leaf as JAX's,
    for 4 greedy steps (7 layers: a tail)."""
    S, ctx = 40, 64
    jcfg, tcfg, jp, tp = _world(HYBRID, 7)
    prompts = _tokens(1, (2, S), jcfg.vocab)
    cj = JM.init_cache(jcfg, 2, ctx, dtype=jnp.float32)
    lj, cj = JM.prefill(jp, jcfg, jnp.asarray(prompts), cj)
    ct = TM.init_cache(tcfg, 2, ctx, device=CPU)
    lt, ct = TM.prefill(tp, tcfg, torch.as_tensor(prompts), ct)
    for _ in range(4):
        _close(lt, lj)
        tok = np.asarray(jnp.argmax(lj[:, -1], -1))[:, None]
        lj, cj = JM.decode_step(jp, jcfg, cj, jnp.asarray(tok))
        lt, ct = TM.decode_step(tp, tcfg, ct, torch.as_tensor(tok))
    _close(lt, lj)
    want = dict(_leaves(jax.tree.map(np.asarray, cj)))
    for k, v in _leaves(jax.tree.map(lambda t: t.numpy(), ct)):
        np.testing.assert_allclose(v, want[k], rtol=1e-4, atol=1e-4,
                                   err_msg=k)


def test_hybrid_decode_matches_forward_and_refuses_verify():
    jcfg, tcfg, jp, tp = _world(HYBRID, 7)
    seq = _tokens(5, (2, 12), jcfg.vocab)
    full = TM.forward(tp, tcfg, torch.as_tensor(seq))
    _close(full, JM.forward(jp, jcfg, jnp.asarray(seq)))
    c = TM.init_cache(tcfg, 2, 64, device=CPU)
    lt, c = TM.prefill(tp, tcfg, torch.as_tensor(seq[:, :6]), c)
    for t in range(6, 12):
        lt, c = TM.decode_step(tp, tcfg, c, torch.as_tensor(seq[:, t:t + 1]))
        torch.testing.assert_close(lt[:, 0], full[:, t], rtol=0, atol=1e-4)
    with pytest.raises(ValueError, match="multi-token"):
        TM.decode_step(tp, tcfg, c, torch.as_tensor(seq[:, :2]))


def test_hybrid_dense_engine_matches_jax_graphed_and_eager():
    """The dense-cache engine over the group/tail tree: a slot's prefill
    copied into the batch cache leaf by leaf, the decode step replayed
    through ``StepGraphs`` (scrubbing the recurrent leaves whole) and
    eager: streams equal to the JAX engine's, prompts past the window."""
    jcfg, tcfg, jp, tp = _world(HYBRID, 7)
    reqs = RequestGenerator(tcfg.vocab, prompt_len=(4, 48), max_new=4,
                            seed=3).generate(3)
    assert max(len(r.prompt) for r in reqs) > tcfg.attn_window
    fin_j, _ = j_dense_engine(jp, jcfg, 2, 64).run(
        JM.init_cache(jcfg, 2, 64, dtype=jnp.float32), reqs)
    want = {f.uid: f.tokens for f in fin_j}
    for graphs in (True, False):
        eng = make_dense_engine(tp, tcfg, 2, 64, graphs=graphs, device=CPU)
        fin, _ = eng.run(TM.init_cache(tcfg, 2, 64, device=CPU), reqs)
        assert {f.uid: f.tokens for f in fin} == want
    assert eng.graphs is None


def test_store_and_paged_cache_refuse_hybrid_and_audio(tmp_path):
    from repro.runtime.kvcache import paged_cache_spec as j_spec
    from repro.runtime.paramstore import save_param_store as j_save

    for arch in (HYBRID, AUDIO):
        jcfg, tcfg, jp, tp = _world(arch, 7 if arch == HYBRID else None)
        for spec in (j_spec, TK.paged_cache_spec):
            with pytest.raises(ValueError, match="paged KV cache"):
                spec(tcfg)
        with pytest.raises(ValueError, match="param store unsupported"):
            j_save(jp, jcfg, str(tmp_path / "j"))
        with pytest.raises(ValueError, match="param store unsupported"):
            save_param_store(bridge.tree_from_params(tp), tcfg,
                             str(tmp_path / "t"))
        with pytest.raises(ValueError, match="paged decode unsupported"):
            TM.decode_step_paged(tp, tcfg, {"len": None}, torch.zeros(
                (1, 1), dtype=torch.int32))


# --------------------------------------------------------------------------- #
#  audio
# --------------------------------------------------------------------------- #

def _frames(cfg, B, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (B, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)


def test_whisper_matches_jax_to_a_full_cache():
    """Frames through the encoder, a 6-token prompt, then greedy decode
    until the self-attention cache (max_decode_len 64) is full: every
    step's logits as JAX's; the port's decode replayed through
    ``StepGraphs`` gives the eager tokens."""
    jcfg, tcfg, jp, tp = _world(AUDIO)
    B, S = 2, 6
    frames = _frames(jcfg, B)
    prompt = _tokens(2, (B, S), jcfg.vocab)
    _close(TM.forward(tp, tcfg, torch.as_tensor(prompt),
                      embeds=torch.as_tensor(frames)),
           JM.forward(jp, jcfg, jnp.asarray(prompt),
                      embeds=jnp.asarray(frames)))
    cj = JM.init_cache(jcfg, B, 128, dtype=jnp.float32)
    lj, cj = JM.prefill(jp, jcfg, jnp.asarray(prompt), cj,
                        embeds=jnp.asarray(frames))
    ct = TM.init_cache(tcfg, B, 128, device=CPU)
    assert ct["layers"]["k"].shape[2] == tcfg.max_decode_len
    lt, ct = TM.prefill(tp, tcfg, torch.as_tensor(prompt), ct,
                        embeds=torch.as_tensor(frames))
    np.testing.assert_allclose(ct["cross_k"].numpy(),
                               np.asarray(cj["cross_k"]), rtol=1e-4,
                               atol=1e-5)
    cg = {k: v.clone() if isinstance(v, torch.Tensor) else
          {n: a.clone() for n, a in v.items()} for k, v in ct.items()}
    graphed = dense_decode(tp, tcfg, graphs=True, device=CPU)
    lg = lt
    jdec = jax.jit(lambda c, t: JM.decode_step(jp, jcfg, c, t))
    for _ in range(tcfg.max_decode_len - S):
        _close(lt, lj)
        tok = np.asarray(jnp.argmax(lj[:, -1], -1))[:, None]
        assert torch.equal(lg[:, -1].argmax(-1), lt[:, -1].argmax(-1))
        lj, cj = jdec(cj, jnp.asarray(tok))
        lt, ct = TM.decode_step(tp, tcfg, ct, torch.as_tensor(tok))
        lg, cg = graphed(cg, torch.as_tensor(tok))
    _close(lt, lj)
    assert int(ct["len"][0]) == tcfg.max_decode_len == int(cg["len"][0])
    assert graphed.graphs.replays[("decode", 1)] == tcfg.max_decode_len - S


def test_whisper_needs_frames():
    _, tcfg, _, tp = _world(AUDIO)
    with pytest.raises(ValueError, match="frames"):
        TM.prefill(tp, tcfg, torch.zeros((1, 4), dtype=torch.int32),
                   TM.init_cache(tcfg, 1, 16, device=CPU))


# --------------------------------------------------------------------------- #
#  the driver
# --------------------------------------------------------------------------- #

def test_driver_smoke_hybrid_equals_jax_decode(capsys):
    """``--arch recurrentgemma-9b --smoke --paged-kv --chaos transient
    --device cpu``: the JAX driver's "ring unsupported" line, the batch
    decoded through the GSPMD layer across the 8 ranks with the tokens of
    the JAX one-device decode, and the paged and chaos sections skipped
    with the JAX driver's messages."""
    from repro.data import RequestGenerator as JRequestGenerator
    from repro_torch.launch import serve as TS

    args = TS.parse_args(["--arch", HYBRID, "--smoke", "--paged-kv",
                          "--chaos", "transient", "--new-tokens", "6",
                          "--device", "cpu"])
    jcfg = get_config(HYBRID).reduced()
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    res = TS.run(args, params=bridge.params_from_numpy(
        jax.tree.map(np.asarray, jp), device=CPU))
    out = capsys.readouterr().out
    assert "ring unsupported for B=8, M=4 (family=hybrid)" in out
    assert "paged-kv: unsupported family hybrid" in out
    assert "chaos: unsupported family hybrid" in out
    assert res["ring"] is None and "paged" not in res
    assert res["decode"]["gspmd"]["ranks"] == 8
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


def test_driver_refuses_whisper():
    from repro_torch.launch import serve as TS

    with pytest.raises(SystemExit):
        TS.parse_args(["--arch", AUDIO, "--smoke", "--device", "cpu"])
