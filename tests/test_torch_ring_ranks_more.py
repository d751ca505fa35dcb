"""More of the ring across ranks (``test_torch_ring_ranks.py`` has the
harness): ssm, an int8 cache, M-RoPE, the verify pass at T = 4 (dense and
MLA) and q4 ring params against the JAX ring at the (4, 2) mesh; the
negative control (members that merge without their shard's offset); the
serve driver's ranks and its failure path; and the pieces against the
JAX package's: the masked sequence-shard write, B5's stats' plain
version, the merges over a group, the greedy argmax over vocab shards.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro.runtime import serve as JS
from repro_torch.kernels import flash_decode as FD
from repro_torch.launch import serve as TD
from repro_torch.models import layers as TL
from repro_torch.runtime import collectives as C
from repro_torch.runtime import serve as RS
from repro_torch.runtime import sharding as S

from test_torch_ring_ranks import (_cfgs, _setup, held, jax_ring,
                                   port_ring, replicated_and_bytes,
                                   run_case, world)  # noqa: F401


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """This file's tests run torch on one thread (the suite's parallel
    workers would otherwise spin against each other)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_rank_ring_ssm(world, tmp_path):
    """mamba2: the state replicated inside each stage, no sequence
    split; the head still vocab-sharded."""
    run_case(world, tmp_path, "mamba2-780m", k=2)


def test_rank_ring_mrope(world, tmp_path):
    run_case(world, tmp_path, "qwen2-vl-2b", k=2)


def test_rank_ring_q4_params(world, tmp_path):
    """A q4 ring bank quantized at the real tp: each member's w_down
    slice keeps whole groups of packed rows and scale rows."""
    run_case(world, tmp_path, "qwen2.5-14b", k=2, q4=True)


@pytest.mark.parametrize("arch", ["qwen2.5-14b", "minicpm3-4b"])
def test_rank_ring_verify_pass(world, tmp_path, arch):
    """T = 4 tokens scored in one pass, causal among them, against the
    JAX ring's verify pass."""
    run_case(world, tmp_path, arch, T=4)


def test_rank_ring_int8_cache(world, tmp_path):
    """qwen1.5-32b's int8 cache, its lines and scales sequence-split.
    Each step's cache, put back together from the ranks' parts
    (``sharding.assemble``), is compared with the JAX ring's byte for
    byte; logits and tokens are held at every step before the first
    byte that differs (a line quantized on either side of a rounding
    boundary, as ``test_torch_ring.py`` holds int8), at least two."""
    shape, names = (4, 2), ("data", "model")
    jcfg, tcfg = _cfgs("qwen1.5-32b")
    assert jcfg.kv_dtype == "int8"
    params, cache, first = _setup(jcfg, 2, False)
    logits, toks, caches, pr = jax_ring(jcfg, params, cache, first, shape,
                                        names, 2, 4, 1)
    ranks = port_ring(world, tcfg, params, cache, first, shape, names, 2, 4,
                      1, str(tmp_path), return_cache=True)
    mesh = {"data": 4, "model": 2}
    same = 0
    for t in range(4):
        flips = 0
        for name, want in caches[t].items():
            spec = RS.ring_cache_spec(f"['layers']['{name}']", want.ndim,
                                      mesh)
            parts = {(r["stage"], r["member"]):
                     torch.from_numpy(r["caches"][t][name]) for r in ranks}
            got = S.assemble(parts, spec, mesh).numpy()
            assert got.shape == want.shape
            if name in ("k", "v"):
                flips += int((got != want).sum())
        if flips:
            break
        same += 1
    assert same >= 2
    held(ranks, (logits, toks), shape, names, upto=same)
    replicated_and_bytes(ranks, tcfg, pr, shape, names)


def test_negative_control_without_shard_offsets(world, tmp_path):
    """Members that mask their lines as if their shard began at line 0
    must miss the reference: the check is not blind."""
    shape, names = (4, 2), ("data", "model")
    jcfg, tcfg = _cfgs("qwen2.5-14b")
    params, cache, first = _setup(jcfg, 2, False)
    want = jax_ring(jcfg, params, cache, first, shape, names, 1, 2, 1)[:2]
    ranks = port_ring(world, tcfg, params, cache, first, shape, names, 1, 2,
                      1, str(tmp_path), offsets=False)
    with pytest.raises(AssertionError):
        held(ranks, want, shape, names)


def test_rank_launch_counts_on_the_cpu(world, tmp_path):
    """On CPU tensors no kernel launches: every rank takes the plain
    versions."""
    _, ranks = run_case(world, tmp_path, "qwen2.5-14b", steps=1)
    for r in ranks:
        assert all(n == 0 for n in r["launches"].values())
        assert r["load_s"] >= 0 and len(r["step_s"]) == 1


# --------------------------------------------------------------------------- #
#  the driver
# --------------------------------------------------------------------------- #

def test_driver_decodes_on_eight_ranks(capsys):
    """``python -m repro_torch.launch.serve --smoke --device cpu --stages
    4 --tp 2``: the decode section runs on 8 rank processes, its tokens
    equal the one-device decode's, and the verify pass is timed."""
    res = TD.main(["--smoke", "--device", "cpu", "--stages", "4", "--tp",
                   "2", "--new-tokens", "3", "--verify-tokens", "4"])
    ring = res["ring"]
    assert ring["ranks"] == 8 and ring["tokens_equal"]
    assert ring["verify_ms"] > 0
    out = capsys.readouterr().out
    assert "8 rank processes over gloo" in out
    assert "layout only" not in out
    assert ring["launches"]["flash_verify_stats"] == 0      # plain on the CPU
    assert "summed over the 8 ranks" in out


def test_driver_exits_nonzero_when_a_rank_fails():
    """``--chaos rank``: the last rank raises at its second step; the
    driver exits nonzero, naming it, instead of hanging."""
    with pytest.raises(SystemExit) as e:
        TD.main(["--smoke", "--device", "cpu", "--stages", "4", "--tp",
                 "2", "--new-tokens", "3", "--chaos", "rank"])
    assert "rank 7" in str(e.value.code) and "FAILED" in str(e.value.code)
    with pytest.raises(SystemExit):
        TD.parse_args(["--stages", "1", "--chaos", "rank"])


def test_one_process_layout_still_refuses_tp():
    from repro_torch.launch.mesh import make_ring_layout, rank_coords
    with pytest.raises(ValueError, match="across ranks"):
        make_ring_layout(4, tp=2, device="cpu")
    assert [rank_coords(r, 2, 2) for r in (0, 1, 2, 5, 7)] == [
        (0, 0, 0), (0, 0, 1), (0, 1, 0), (1, 0, 1), (1, 1, 1)]


# --------------------------------------------------------------------------- #
#  the pieces
# --------------------------------------------------------------------------- #

def test_masked_slot_update_equals_jax():
    rng = np.random.default_rng(0)
    arr = rng.standard_normal((4, 8, 2, 3)).astype(np.float32)
    new = rng.standard_normal((4, 1, 2, 3)).astype(np.float32)
    slot = np.array([3, 9, 12, 15], np.int32)
    for s_start in (0, 8):
        want = JS._masked_slot_update(jnp.asarray(arr), jnp.asarray(new),
                                      jnp.asarray(slot), s_start, 8)
        got = torch.from_numpy(arr.copy())
        RS.masked_slot_update(got, torch.from_numpy(new[:, 0]),
                              torch.from_numpy(slot), s_start, 8)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _shards(S_full, tp):
    n = S_full // tp
    return [(i * n, n) for i in range(tp)]


@pytest.mark.parametrize("T,window,lens", [
    (1, None, [0, 5, 17, 31]), (4, None, [4, 9, 20, 32]),
    (1, 6, [3, 12, 20, 31]), (1, None, [40, 1, 16, 0])])
def test_shard_stats_merge_to_full_attention(monkeypatch, T, window, lens):
    """Each shard's plain B5 stats (``flash_verify_stats_ref`` at
    ``kv_len - s_start``, which may be 0 or less or past the shard) equal
    the JAX package's ``verify_attention_stats`` at ``pos_offset``; merged
    over the shards (``merge_attention_lse``, from B5's stats and from
    the (acc, m, l) form through ``stats_to_lse``, as MLA's ring layer
    merges) they give the attention over the whole cache: JAX's
    ``verify_attention``. A row no shard sees returns 0."""
    rng = np.random.default_rng(1)
    Bq, H, hk, D, S_full, tp = 4, 4, 2, 16, 32, 4
    q = rng.standard_normal((Bq, T, H, D)).astype(np.float32)
    k = rng.standard_normal((Bq, S_full, hk, D)).astype(np.float32)
    v = rng.standard_normal((Bq, S_full, hk, D)).astype(np.float32)
    kv_len = np.asarray(lens, np.int32)
    os_, stats = [], []
    for s0, n in _shards(S_full, tp):
        o, lse = FD.flash_verify_stats_ref(
            torch.from_numpy(q), torch.from_numpy(k[:, s0:s0 + n]),
            torch.from_numpy(v[:, s0:s0 + n]),
            torch.from_numpy(kv_len - s0), window=window)
        acc, m, l = JL.verify_attention_stats(
            jnp.asarray(q), jnp.asarray(k[:, s0:s0 + n]),
            jnp.asarray(v[:, s0:s0 + n]), jnp.asarray(kv_len),
            window=window, pos_offset=s0)
        m = np.asarray(m)
        want_lse = np.where(np.isfinite(m), m + np.log(np.asarray(l)),
                            -np.inf)
        np.testing.assert_allclose(lse.numpy(), want_lse, atol=1e-5)
        want_o = np.asarray(acc) / np.maximum(np.asarray(l)[..., None], 1e-30)
        np.testing.assert_allclose(o.numpy(), want_o.transpose(0, 2, 1, 3),
                                   atol=1e-5)
        os_.append((o, lse))
        stats.append(TL.verify_attention_stats(
            torch.from_numpy(q), torch.from_numpy(k[:, s0:s0 + n]),
            torch.from_numpy(v[:, s0:s0 + n]), torch.from_numpy(kv_len),
            window=window, pos_offset=s0))
    full = np.asarray(JL.verify_attention(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v), jnp.asarray(kv_len),
                                          window=window))
    ax = C.Axis("model", None, tuple(range(tp)), 0)
    queue = []
    monkeypatch.setattr(C, "all_gather", lambda x, a: queue.pop(0))
    queue.append(torch.stack([torch.cat([o.float(), lse.transpose(1, 2)[
        ..., None]], -1) for o, lse in os_]))
    got = TL.merge_attention_lse(*os_[0], ax)
    np.testing.assert_allclose(got.numpy(), full, atol=2e-6)
    lses = [TL.stats_to_lse(*st, torch.float32) for st in stats]
    queue.append(torch.stack([torch.cat([o, lse.transpose(1, 2)[..., None]],
                                        -1) for o, lse in lses]))
    got = TL.merge_attention_lse(*lses[0], ax)
    np.testing.assert_allclose(got.numpy(), full, atol=2e-6)
    unseen = kv_len <= 0
    if unseen.any():
        assert not np.abs(full[unseen]).any()


def test_rank_greedy_ties_and_padding(monkeypatch):
    """The argmax over vocab shards equals ``torch.argmax`` of the full
    row, ties to the lowest index across shards, padded columns never
    chosen."""
    vocab, tp, v_loc = 10, 3, 4                      # padded to 12
    full = torch.tensor([[[0., 5., 1., 5., 2., 9., 9., 3., 1., 9., 0., 0.]],
                         [[1., 1., 1., 1., 1., 1., 1., 1., 1., 1., 50., 50.]],
                         [[-1., -2., -3., -4., -5., -6., -7., -8., -9., 7.,
                           8., 0.]]])
    want = full[..., :vocab].argmax(-1)
    outs = []
    for i in range(tp):
        shard = full[..., i * v_loc:(i + 1) * v_loc]
        ax = C.Axis("model", None, tuple(range(tp)), i)
        parts = []
        for j in range(tp):
            pj = full[..., j * v_loc:(j + 1) * v_loc]
            cols = torch.arange(j * v_loc, (j + 1) * v_loc)
            lg = torch.where(cols < vocab, pj, -math.inf)
            idx = lg.argmax(-1)
            parts.append(torch.stack([lg.gather(-1, idx[..., None])[
                ..., 0].double(), (idx + j * v_loc).double()]))
        monkeypatch.setattr(C, "all_gather", lambda x, a, p=parts:
                            torch.stack(p))
        outs.append(RS.rank_greedy(shard, ax, vocab))
    for o in outs:
        assert torch.equal(o.long(), want)
