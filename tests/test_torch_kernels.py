"""The port's paged-attention dispatch against the JAX Pallas kernels.

The same numpy inputs, drawn from a seed, go through the Pallas kernels
(``interpret=True``, as ``tests/test_kernels.py`` runs them on the CPU),
the JAX oracles in ``repro.kernels.ref`` and ``repro_torch.kernels.ops``
on CPU tensors (the plain torch versions). Tolerance atol = rtol = 1e-5:
every side computes in f32, with another order of summation.

The CUDA kernels themselves need the card: ``chip_smoke.py`` holds each
against its plain version there.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.flash_decode import flash_decode as j_flash_decode
from repro.kernels.flash_decode import flash_verify as j_flash_verify
from repro.kernels.paged_decode import paged_verify as j_paged_verify
from repro.kernels.paged_decode import \
    paged_verify_quant as j_paged_verify_quant
from repro.kernels.paged_prefill import paged_prefill as j_paged_prefill
from repro.kernels.q4_matmul import q4_matmul as j_q4_matmul
from repro.quant import grouped as JQ
from repro_torch.kernels import ops

TOL = dict(rtol=1e-5, atol=1e-5)


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


def _case(seed, *, B, T, H, h_kv, D, P, bs, nb, kv_len, sink_rows=()):
    """q, pages and a table whose entries past ceil(kv_len/bs) are stale
    page ids; rows in ``sink_rows`` get kv_len = T on an all-sink table
    (an inactive slot)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, H, D)).astype(np.float32)
    kp = rng.standard_normal((P, bs, h_kv, D)).astype(np.float32)
    vp = rng.standard_normal((P, bs, h_kv, D)).astype(np.float32)
    table = rng.permutation(np.arange(1, P))[:B * nb].reshape(B, nb)
    table = table.astype(np.int32)
    kv = np.asarray(kv_len, np.int32)
    for b in sink_rows:
        table[b] = 0
        kv[b] = T
    return q, kp, vp, table, kv


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


CASES = [
    # T, H, h_kv: GQA n_rep 1 and 5; kv_len leaves stale entries past it
    dict(B=3, T=1, H=4, h_kv=4, D=16, P=40, bs=8, nb=6,
         kv_len=[1, 20, 48]),
    dict(B=3, T=4, H=10, h_kv=2, D=16, P=40, bs=8, nb=6,
         kv_len=[4, 27, 41], sink_rows=(0,)),
    dict(B=2, T=1, H=10, h_kv=2, D=32, P=20, bs=4, nb=8,
         kv_len=[5, 30], sink_rows=(1,)),
    dict(B=2, T=4, H=4, h_kv=4, D=32, P=20, bs=4, nb=8,
         kv_len=[9, 32]),
    # a prompt chunk at B = 1: int8 admission runs B4 at this geometry
    dict(B=1, T=13, H=10, h_kv=2, D=16, P=40, bs=4, nb=16, kv_len=[37]),
]


@pytest.mark.parametrize("window", [None, 6])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_paged_verify_matches_pallas(case, window):
    q, kp, vp, table, kv = _case(case, **CASES[case])
    before = ops.launch_counts()
    out = ops.paged_verify(_t(q), _t(kp), _t(vp), _t(table), _t(kv),
                           window=window).numpy()
    assert ops.launch_counts() == before          # CPU: plain version
    jargs = tuple(jnp.asarray(a) for a in (q, kp, vp, table, kv))
    pallas = j_paged_verify(*jargs, window=window, interpret=True)
    oracle = ref.paged_verify_ref(*jargs, window=window)
    np.testing.assert_allclose(out, np.asarray(pallas), **TOL)
    np.testing.assert_allclose(out, np.asarray(oracle), **TOL)
    assert np.isfinite(out).all()
    if CASES[case]["T"] == 1:
        dec = ops.paged_decode(_t(q[:, 0]), _t(kp), _t(vp), _t(table),
                               _t(kv), window=window).numpy()
        np.testing.assert_array_equal(dec, out[:, 0])


PREFILL_CASES = [
    # one chunk of S rows at the end of kv_len; the table is sized for
    # the full context, so most of its pages are dead for the chunk
    dict(B=1, T=16, H=10, h_kv=2, D=16, P=40, bs=4, nb=16, kv_len=[40]),
    dict(B=1, T=5, H=4, h_kv=4, D=16, P=40, bs=8, nb=8, kv_len=[13]),
    dict(B=2, T=8, H=4, h_kv=2, D=32, P=40, bs=4, nb=10,
         kv_len=[8, 37]),
]


@pytest.mark.parametrize("window", [None, 8])
@pytest.mark.parametrize("case", range(len(PREFILL_CASES)))
def test_paged_prefill_matches_pallas(case, window):
    q, kp, vp, table, kv = _case(10 + case, **PREFILL_CASES[case])
    out = ops.paged_prefill(_t(q), _t(kp), _t(vp), _t(table), _t(kv),
                            window=window).numpy()
    jargs = tuple(jnp.asarray(a) for a in (q, kp, vp, table, kv))
    pallas = j_paged_prefill(*jargs, window=window, interpret=True)
    oracle = ref.paged_prefill_ref(*jargs, window=window)
    np.testing.assert_allclose(out, np.asarray(pallas), **TOL)
    np.testing.assert_allclose(out, np.asarray(oracle), **TOL)
    assert ops.launch_counts() == {k: 0 for k in ops.launch_counts()}


def _quantize(pages, rng):
    scale = (np.abs(pages).max(-1) / 127.0).astype(np.float32)
    scale *= rng.uniform(0.9, 1.1, scale.shape).astype(np.float32)
    qp = np.clip(np.rint(pages / scale[..., None]), -127, 127)
    return qp.astype(np.int8), scale


@pytest.mark.parametrize("scale_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_paged_verify_quant_matches_pallas(case, scale_dtype):
    q, kp, vp, table, kv = _case(20 + case, **CASES[case])
    rng = np.random.default_rng(case)
    kq, ks = _quantize(kp, rng)
    vq, vs = _quantize(vp, rng)
    # scales stored in the pool dtype; both sides read the same values
    ks_t = _t(ks).to(getattr(torch, scale_dtype))
    vs_t = _t(vs).to(getattr(torch, scale_dtype))
    out = ops.paged_verify_quant(_t(q), _t(kq), _t(vq), ks_t, vs_t,
                                 _t(table), _t(kv)).numpy()
    ks_j = jnp.asarray(ks).astype(scale_dtype)
    vs_j = jnp.asarray(vs).astype(scale_dtype)
    jargs = (jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq), ks_j, vs_j,
             jnp.asarray(table), jnp.asarray(kv))
    pallas = j_paged_verify_quant(*jargs, interpret=True)
    oracle = ref.paged_verify_quant_ref(*jargs)
    np.testing.assert_allclose(out, np.asarray(pallas), **TOL)
    np.testing.assert_allclose(out, np.asarray(oracle), **TOL)
    if CASES[case]["T"] == 1:
        dec = ops.paged_decode_quant(_t(q[:, 0]), _t(kq), _t(vq), ks_t,
                                     vs_t, _t(table), _t(kv)).numpy()
        np.testing.assert_array_equal(dec, out[:, 0])
    assert ops.launch_counts() == {k: 0 for k in ops.launch_counts()}


def test_use_kernels_false_and_cuda_tensor_without_card():
    """``use_kernels(False)`` forces the plain version; a kernel wrapper
    given a CPU tensor raises instead of computing anything."""
    from repro_torch.kernels import paged_decode as pd

    q, kp, vp, table, kv = _case(30, **CASES[0])
    args = (_t(q), _t(kp), _t(vp), _t(table), _t(kv))
    ops.use_kernels(False)
    try:
        assert not ops.kernels_active(args[0])
        forced = ops.paged_verify(*args).numpy()
    finally:
        ops.use_kernels(True)
    np.testing.assert_array_equal(forced, ops.paged_verify(*args).numpy())
    with pytest.raises(ValueError, match="CUDA"):
        pd.paged_verify(*args)


def test_build_is_keyed_by_source_and_needs_nvcc(monkeypatch):
    """One library per source under csrc/ lands in the git-ignored
    build/kernels/ under a name keyed by the sources' hash; without nvcc
    the build raises."""
    from pathlib import Path

    from repro_torch.kernels import _build

    root = Path(__file__).resolve().parents[1]
    assert set(_build.SOURCES) == {p.stem for p in (
        root / "src" / "repro_torch" / "kernels" / "csrc").glob("*.cu")}
    for name in _build.SOURCES:
        lib = _build.library_path(name)
        assert lib.parent == root / "build" / "kernels"
        assert lib.name.startswith(f"{name}_") and lib.suffix == ".so"
    assert "build/" in (root / ".gitignore").read_text().split()
    monkeypatch.setenv("NVCC", "/nonexistent/nvcc")
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setattr(_build.os.path, "isfile", lambda _: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


def test_build_key_covers_the_shared_header(monkeypatch, tmp_path):
    """The three sources include csrc/tc_common.cuh: an edit of the header
    alone renames every library, so a stale build is never loaded."""
    import shutil

    from repro_torch.kernels import _build

    csrc = tmp_path / "csrc"
    shutil.copytree(_build._CSRC, csrc)
    monkeypatch.setattr(_build, "_CSRC", csrc)
    monkeypatch.setattr(_build, "SOURCES", {
        name: csrc / path.name for name, path in _build.SOURCES.items()})
    before = {name: _build.library_path(name) for name in _build.SOURCES}
    header = csrc / "tc_common.cuh"
    header.write_text(header.read_text() + "\n")
    for name, path in before.items():
        assert _build.library_path(name) != path


# --------------------------------------------------------------------------- #
#  the tile kernels (B1, B2, B4, B5): precision, route plan, head dims
# --------------------------------------------------------------------------- #

def _within(out, want, dtype):
    """``chip_smoke.within``'s rule: f32 atol 2e-5; bf16 per element
    1e-5 + 2^-7 |want| under a 1e-2 ceiling; returns the worst ratio."""
    err = (out.float() - want.float()).abs()
    if dtype == torch.float32:
        return float(err.max()) / 2e-5
    ratio = float((err / (1e-5 + 2.0 ** -7 * want.float().abs())).max())
    return max(ratio, float(err.max()) / 1e-2)


def _pieces(x, n):
    """x as n bf16 pieces, largest first (each residual exact in f32)."""
    out = []
    for _ in range(n):
        out.append(x.to(torch.bfloat16).float())
        x = x - out[-1]
    return out


def _piece_products(a, b, eq):
    """Sum of the products of pieces whose orders sum below max(len)."""
    n = max(len(a), len(b))
    return sum(torch.einsum(eq, x, y) for i, x in enumerate(a)
               for j, y in enumerate(b) if i + j < n)


def _emulate_tiles(q, k, v, kv_len, *, k_scale=None, v_scale=None,
                   round_p=False, d_pad=None):
    """The rounding of ``csrc/paged_tiles.cu`` on the CPU, over gathered
    pages k/v (B, S, h_kv, D): q and f32 pages enter the products as three
    bf16 pieces, bf16 and int8 as one; S = Q.K^T summed over 16-wide steps
    of D in order (k_scale on the f32 score after the product, then the
    softmax scale); P (v_scale folded in) as hi + lo for a bf16 result or
    three pieces for an f32 one -- or, with ``round_p``, as one bf16
    rounding, the habit the design rejects -- times V, 16 output columns a
    group; the result rounded once to q's dtype. ``d_pad``: q, k and v
    staged zero-padded to that width, as the kernel stages a head, and
    the output cut back to D."""
    B, T, H, D = q.shape
    S, n_rep = k.shape[1], H // k.shape[2]
    if d_pad is not None:
        q, k, v = (torch.nn.functional.pad(t, (0, d_pad - D))
                   for t in (q, k, v))
    f32_q, f32_kv = q.dtype == torch.float32, k.dtype == torch.float32
    kx = k.float().repeat_interleave(n_rep, dim=2)
    vx = v.float().repeat_interleave(n_rep, dim=2)
    qp, kp = _pieces(q.float(), 3 if f32_q else 1), \
        _pieces(kx, 3 if f32_kv else 1)
    s = 0.0
    for c in range(0, q.shape[-1], 16):
        s = s + _piece_products([x[..., c:c + 16] for x in qp],
                                [x[..., c:c + 16] for x in kp],
                                "bthd,bshd->bhts")
    if k_scale is not None:
        s = s * k_scale.float().repeat_interleave(n_rep, 2).permute(
            0, 2, 1)[:, :, None]
    s = s * torch.tensor(1.0 / np.sqrt(D), dtype=torch.float32)
    qpos = kv_len.long()[:, None] - T + torch.arange(T)
    mask = (torch.arange(S)[None, None] <= qpos[..., None])[:, None]
    s = torch.where(mask, s, -torch.inf)
    m = s.amax(-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - torch.where(
        torch.isfinite(m), m, 0.0)), 0.0)
    l = p.sum(-1)
    if v_scale is not None:
        p = p * v_scale.float().repeat_interleave(n_rep, 2).permute(
            0, 2, 1)[:, :, None]
    P = [p.to(torch.bfloat16).float()] if round_p else \
        _pieces(p, 3 if f32_q else 2)
    vp = _pieces(vx, 3 if f32_kv else 1)
    acc = torch.cat([_piece_products(P, [x[..., c:c + 16] for x in vp],
                                     "bhts,bshd->bhtd")
                     for c in range(0, vx.shape[-1], 16)], -1)
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.transpose(1, 2)[..., :D].to(q.dtype)


#: a small GQA chunk (n_rep 5) at chip_smoke's data scale: q std 1, pages
#: std 0.5; int8 pools as the model quantizes them, scales in q's dtype
TILE_CHUNK = dict(B=2, T=24, H=10, h_kv=2, D=64, P=40, bs=8, nb=16,
                  kv_len=[24, 101])


def _tile_inputs(dtype, quant, seed=40):
    from repro_torch.models.layers import gather_pages, quantize_kv

    q, kp, vp, table, kv = _case(seed, **TILE_CHUNK)
    q, table, kv = _t(q).to(dtype), _t(table), _t(kv)
    kp, vp = _t(kp) * 0.5, _t(vp) * 0.5
    if quant:
        (kq, ks), (vq, vs) = quantize_kv(kp), quantize_kv(vp)
        ks, vs = ks.to(dtype), vs.to(dtype)
        want = ops.paged_verify_quant(q.float(), kq, vq, ks, vs, table, kv)
        gathered = [gather_pages(t, table) for t in (kq, vq, ks, vs)]
        return want, dict(q=q, k=gathered[0], v=gathered[1], kv_len=kv,
                          k_scale=gathered[2], v_scale=gathered[3])
    kp, vp = kp.to(dtype), vp.to(dtype)
    want = ops.paged_prefill(q.float(), kp.float(), vp.float(), table, kv)
    return want, dict(q=q, k=gather_pages(kp, table),
                      v=gather_pages(vp, table), kv_len=kv)


@pytest.mark.parametrize("quant", [False, True], ids=["pages", "int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_tile_precision_contract(dtype, quant):
    """The tile kernels' rounding (emulated) meets chip_smoke's phase-2
    rule against the plain version in f32: bf16 with P as hi + lo, f32
    with three pieces a side, int8 K exact with its scale after the
    product and v_scale folded into P. (The CUDA kernels themselves are
    held to the same rule on the card.)"""
    want, args = _tile_inputs(dtype, quant)
    out = _emulate_tiles(**args)
    assert out.dtype == dtype and out.shape == want.shape
    assert _within(out, want, dtype) <= 0.6


@pytest.mark.parametrize("quant", [False, True], ids=["pages", "int8"])
def test_tile_precision_bf16_rounded_p_fails(quant):
    """Why P enters as hi + lo: rounding P to bf16 once before P.V (the
    usual flash-attention habit) breaks the bf16 rule where outputs are
    near zero, with the same inputs that pass above."""
    want, args = _tile_inputs(torch.bfloat16, quant)
    assert _within(_emulate_tiles(**args, round_p=True), want,
                   torch.bfloat16) > 2.0


@pytest.mark.parametrize("T", [1, 5, 256])
def test_tile_plan_is_a_function_of_shapes(T):
    """qwen2.5-14b's heads (40 over 8, D 128), 16-token pages, a table of
    128: decode and verify rows (T * 5 <= 64) split the keys across CTAs
    (design 2: 8 splits of 16 pages). B1's key split is fixed by the pool
    (4 warps on 16-row tiles; 2 for f32 pages), so its key partition is
    the same at T = 1 and T = 5; B4 keeps the plan of its rows (the 4
    warps sharing a 16- or 32-row tile). Chunk rows take design 1; B2 is
    always design 1; B5 is always design 2, its cache's lines split 256 at
    a time. The plan reads no tensor, so kv_len cannot move it."""
    from repro_torch.kernels.paged_decode import TilePlan, tile_plan

    B, H, h_kv, D, bs, nb = 8, 40, 8, 128, 16, 128
    rows = T * 5
    for kernel, pool in (("paged_verify_quant", torch.int8),
                         ("paged_verify", torch.bfloat16),
                         ("paged_verify", torch.float32)):
        plan = tile_plan(B, T, H, h_kv, D, bs, nb, pool=pool, kernel=kernel)
        assert plan == tile_plan(B, T, H, h_kv, D, bs, nb, pool=pool,
                                 kernel=kernel)
        if T == 256:
            assert plan == TilePlan(1, 1, 1, nb, 128, None)
            continue
        if kernel == "paged_verify_quant":
            key_split = {1: 4, 5: 2}[T]
            assert 16 * 4 // key_split >= rows  # one row tile per split
        else:
            key_split = 2 if pool == torch.float32 else 4
            one = tile_plan(B, 1, H, h_kv, D, bs, nb, pool=pool,
                            kernel=kernel)
            five = tile_plan(B, 5, H, h_kv, D, bs, nb, pool=pool,
                             kernel=kernel)
            assert (one.design, one.key_split, one.n_split,
                    one.split_pages) == (five.design, five.key_split,
                                         five.n_split, five.split_pages)
        assert plan == TilePlan(2, key_split, 8, 16, 128,
                                ((B, h_kv, 8, rows, 128),
                                 (2, B, h_kv, 8, rows)))
    assert tile_plan(B, T, H, h_kv, D, bs, nb, pool=torch.bfloat16,
                     kernel="paged_prefill") == TilePlan(1, 1, 1, nb, 128,
                                                         None)
    # B5 over a contiguous cache of 1000 lines (bs 1, nb S), any T
    plan = tile_plan(2, T, 40, 40, 128, 1, 1000, pool=torch.int8,
                     kernel="flash_verify")
    assert (plan.design, plan.key_split, plan.n_split, plan.split_pages) \
        == (2, 4, 4, 256)
    # other head dims: staged zero-padded to the next tile width
    for d, d_pad in ((16, 64), (64, 64), (96, 128), (144, 256), (256, 256)):
        assert tile_plan(B, T, H, h_kv, d, bs, nb, pool=torch.bfloat16,
                         kernel="paged_verify").d_pad == d_pad


def test_tile_wrappers_check_alignment():
    """The tile kernels copy 16 bytes at a time: a pool at an odd offset
    or with a head stride of 130 bf16 elements is refused, not copied."""
    from repro_torch.kernels.paged_decode import _check_aligned

    pool = torch.zeros(4, 16, 2, 128, dtype=torch.bfloat16)
    _check_aligned("t", pool=pool)
    odd = torch.zeros(4 * 16 * 2 * 128 + 1, dtype=torch.bfloat16)[1:]
    with pytest.raises(ValueError, match="16-byte aligned"):
        _check_aligned("t", pool=odd.view(4, 16, 2, 128))
    wide = torch.zeros(4, 16, 2, 130, dtype=torch.bfloat16)[..., :128]
    with pytest.raises(ValueError, match="16-byte aligned"):
        _check_aligned("t", pool=wide)


@pytest.mark.parametrize("quant", [False, True], ids=["pages", "int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("D", [16, 96, 256])
def test_tile_zero_padding_is_exact(D, dtype, quant):
    """A head of width D runs on a tile D_pad wide (64, 128, 256) with its
    columns D..D_pad zero-filled in q, K and V: the emulated tile gives
    the unpadded emulation's result to the bit, and meets the precision
    contract at that D."""
    from repro_torch.kernels.paged_decode import check_head_dim
    from repro_torch.models.layers import gather_pages, quantize_kv

    q, kp, vp, table, kv = _case(41, **{**TILE_CHUNK, "D": D})
    q, table, kv = _t(q).to(dtype), _t(table), _t(kv)
    kp, vp = _t(kp) * 0.5, _t(vp) * 0.5
    if quant:
        (kq, ks), (vq, vs) = quantize_kv(kp), quantize_kv(vp)
        ks, vs = ks.to(dtype), vs.to(dtype)
        want = ops.paged_verify_quant(q.float(), kq, vq, ks, vs, table, kv)
        args = dict(q=q, k=gather_pages(kq, table),
                    v=gather_pages(vq, table), kv_len=kv,
                    k_scale=gather_pages(ks, table),
                    v_scale=gather_pages(vs, table))
    else:
        kp, vp = kp.to(dtype), vp.to(dtype)
        want = ops.paged_prefill(q.float(), kp.float(), vp.float(), table,
                                 kv)
        args = dict(q=q, k=gather_pages(kp, table),
                    v=gather_pages(vp, table), kv_len=kv)
    d_pad = check_head_dim("test", D)
    padded = _emulate_tiles(**args, d_pad=d_pad)
    plain = _emulate_tiles(**args)
    assert padded.shape == plain.shape == want.shape
    assert torch.equal(padded, plain)
    assert _within(padded, want, dtype) <= 0.6


@pytest.mark.parametrize("D", [8, 24, 272])
def test_tile_wrappers_reject_head_dims(D):
    """Every tile wrapper (B1, B2, B4, B5) refuses a head dim off the rule
    D % 16 == 0 and 16 <= D <= 256, naming the rule, before it looks at
    devices; so does the plan."""
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import paged_decode as pd
    from repro_torch.kernels import paged_prefill as pp

    q, kp, vp, table, kv = (_t(a) for a in _case(
        42, **{**CASES[1], "D": D}))
    kq = torch.zeros(kp.shape, dtype=torch.int8)
    sc = torch.ones(kp.shape[:3])
    cache = torch.zeros((q.shape[0], 12) + kp.shape[2:])
    calls = [lambda: pd.paged_verify(q, kp, vp, table, kv),
             lambda: pd.paged_decode(q[:, 0], kp, vp, table, kv),
             lambda: pp.paged_prefill(q, kp, vp, table, kv),
             lambda: pd.paged_verify_quant(q, kq, kq, sc, sc, table, kv),
             lambda: fd.flash_verify(q, cache, cache, kv),
             lambda: fd.flash_decode(q[:, 0], cache, cache, kv),
             lambda: pd.tile_plan(3, 4, 10, 2, D, 8, 6, pool=torch.float32,
                                  kernel="paged_verify")]
    for call in calls:
        with pytest.raises(ValueError, match=rf"head dim {D} .*"
                                             rf"D % 16 == 0 and 16 <= D"):
            call()


# --------------------------------------------------------------------------- #
#  B3: W4A16 grouped matmul
# --------------------------------------------------------------------------- #

def _q4_case(seed, M, K, N, group):
    """x and a JAX-quantized weight (packed int8, bf16 scales) from a
    seed; the port gets the same bytes (the scale as raw bf16 bits)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = rng.standard_normal((K, N)).astype(np.float32) / np.sqrt(K)
    qt = JQ.quantize_q4(jnp.asarray(w), group)
    packed = np.asarray(qt.packed)
    scale_bits = np.asarray(qt.scale).view(np.int16)
    tp = torch.tensor(packed)
    ts = torch.tensor(scale_bits).view(torch.bfloat16)
    return x, qt, tp, ts


#: shapes the Pallas kernel takes (M, N, K divide its 256/512/256 tiles)
Q4_PALLAS = [(8, 512, 1024, 64), (256, 256, 512, 64), (16, 512, 512, 128),
             (1, 256, 256, 32)]


@pytest.mark.parametrize("case", range(len(Q4_PALLAS)))
def test_q4_matmul_matches_pallas(case):
    """The port's dispatch on CPU tensors (the plain version) against the
    Pallas kernel in interpret mode and the JAX oracle, f32 x: atol 1e-5
    (every side sums f32 products in another order)."""
    M, K, N, group = Q4_PALLAS[case]
    x, qt, tp, ts = _q4_case(40 + case, M, K, N, group)
    before = ops.launch_counts()
    out = ops.q4_matmul(_t(x), tp, ts, group=group)
    assert ops.launch_counts() == before          # CPU: plain version
    assert out.dtype == torch.float32 and out.shape == (M, N)
    pallas = j_q4_matmul(jnp.asarray(x), qt.packed, qt.scale, group=group,
                         interpret=True)
    oracle = ref.q4_matmul_ref(jnp.asarray(x), qt.packed, qt.scale,
                               group=group)
    np.testing.assert_allclose(out.numpy(), np.asarray(pallas), **TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(oracle), **TOL)


#: ragged shapes the Hopper kernel takes and the Pallas kernel does not
Q4_RAGGED = [(1, 128, 24, 64), (3, 192, 40, 64), (37, 256, 33, 32),
             (17, 64, 1000, 16), (5, 96, 7, 48)]


@pytest.mark.parametrize("case", range(len(Q4_RAGGED)))
def test_q4_matmul_ragged_matches_oracle(case):
    M, K, N, group = Q4_RAGGED[case]
    x, qt, tp, ts = _q4_case(50 + case, M, K, N, group)
    out = ops.q4_matmul(_t(x), tp, ts, group=group)
    oracle = ref.q4_matmul_ref(jnp.asarray(x), qt.packed, qt.scale,
                               group=group)
    np.testing.assert_allclose(out.numpy(), np.asarray(oracle), **TOL)
    # bf16 x: the same product of the bf16-rounded x, in f32
    xb = _t(x).to(torch.bfloat16)
    outb = ops.q4_matmul(xb, tp, ts, group=group)
    oracle_b = ref.q4_matmul_ref(jnp.asarray(x, jnp.bfloat16), qt.packed,
                                 qt.scale, group=group)
    np.testing.assert_allclose(outb.numpy(), np.asarray(oracle_b), **TOL)


def test_q4_kernel_wrapper_checks_its_inputs():
    """The kernel wrapper takes CUDA tensors only and checks shapes and
    types before anything is built or launched."""
    from repro_torch.kernels import q4_matmul as q4

    x, qt, tp, ts = _q4_case(60, 4, 128, 16, 64)
    with pytest.raises(ValueError, match="CUDA"):
        q4.q4_matmul(_t(x), tp, ts, group=64)
    ops.use_kernels(False)
    try:
        forced = ops.q4_matmul(_t(x), tp, ts, group=64)
    finally:
        ops.use_kernels(True)
    torch.testing.assert_close(forced, q4.q4_matmul_ref(_t(x), tp, ts,
                                                        group=64))
    assert ops.launch_counts()["q4_matmul"] == 0


def test_qmm_routes_eligible_q4_to_the_kernel(monkeypatch):
    """``layers.qmm``: plain weights take ``@``; a 2-D q4 leaf with K even
    and a multiple of its group goes to ``ops.q4_matmul`` at any M and N
    (the card's rule, not the TPU's tile rule); q2 and 3-D stacks
    dequantize at use. The result comes back in x's dtype."""
    from repro_torch.kernels import ops as tops
    from repro_torch.models import layers as ll
    from repro_torch.quant import grouped as TQ

    calls = []
    real = tops.q4_matmul

    def spy(x, packed, scale, *, group):
        calls.append((tuple(x.shape), group))
        return real(x, packed, scale, group=group)

    monkeypatch.setattr(tops, "q4_matmul", spy)
    rng = np.random.default_rng(70)
    x = torch.as_tensor(rng.standard_normal((2, 3, 96)).astype(np.float32))
    w = torch.as_tensor(rng.standard_normal((96, 40)).astype(np.float32))
    q4, q2 = TQ.quantize_q4(w, 32), TQ.quantize_q2(w, 32)
    assert ll.q4_kernel_eligible(q4) and not ll.q4_kernel_eligible(q2)
    stacked = TQ.quantize_q4(w[None].expand(2, 96, 40), 32)
    assert not ll.q4_kernel_eligible(stacked)
    out = ll.qmm(x, q4)
    assert calls == [((6, 96), 32)] and out.shape == (2, 3, 40)
    want = x @ TQ.dequantize_q4(q4)
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(ll.qmm(x, q2), x @ TQ.dequantize_q2(q2))
    torch.testing.assert_close(ll.qmm(x, w), x @ w)
    assert ll.qmm(x.to(torch.bfloat16), q4).dtype == torch.bfloat16
    assert len(calls) == 2


# --------------------------------------------------------------------------- #
#  B5: decode/verify attention over a contiguous cache
# --------------------------------------------------------------------------- #

#: (B, T, H, h_kv, D, S, kv_len, window): T in {1, 3, 5}, n_rep in {1, 4},
#: D in {64, 128}, a window, kv_len past S (a verify pass near the end of
#: the cache clamps its writes), kv_len 0 at T = 1 (a fully masked row)
FLASH_CASES = [
    (2, 1, 4, 4, 64, 24, [7, 24], None),
    (2, 3, 8, 2, 64, 40, [3, 29], None),
    (2, 5, 4, 4, 128, 32, [5, 38], None),
    (3, 5, 8, 2, 128, 48, [9, 30, 48], 6),
    (2, 1, 8, 2, 128, 16, [0, 21], None),
    (2, 3, 4, 4, 64, 24, [11, 26], 4),
]


def _flash_case(seed, B, T, H, h_kv, D, S, kv_len):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, h_kv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, h_kv, D)).astype(np.float32)
    return q, k, v, np.asarray(kv_len, np.int32)


@pytest.mark.parametrize("case", range(len(FLASH_CASES)))
def test_flash_verify_matches_pallas(case):
    """The port's B5 dispatch on CPU tensors (the plain version) against
    the Pallas ``flash_verify`` in interpret mode (S <= 512, so one block
    holds the cache) and ``ref.flash_verify_ref``, atol 1e-5."""
    B, T, H, h_kv, D, S, kv_len, window = FLASH_CASES[case]
    q, k, v, kv = _flash_case(80 + case, B, T, H, h_kv, D, S, kv_len)
    before = ops.launch_counts()
    out = ops.flash_verify(_t(q), _t(k), _t(v), _t(kv),
                           window=window).numpy()
    assert ops.launch_counts() == before          # CPU: plain version
    jargs = tuple(jnp.asarray(a) for a in (q, k, v, kv))
    pallas = j_flash_verify(*jargs, window=window, interpret=True)
    oracle = ref.flash_verify_ref(*jargs, window=window)
    np.testing.assert_allclose(out, np.asarray(pallas), **TOL)
    np.testing.assert_allclose(out, np.asarray(oracle), **TOL)
    assert np.isfinite(out).all()
    if T == 1:
        dec = ops.flash_decode(_t(q[:, 0]), _t(k), _t(v), _t(kv),
                               window=window).numpy()
        np.testing.assert_allclose(dec, out[:, 0], **TOL)
        np.testing.assert_allclose(
            dec, np.asarray(j_flash_decode(jargs[0][:, 0], *jargs[1:],
                                           window=window, interpret=True)),
            **TOL)
        np.testing.assert_allclose(
            dec, np.asarray(ref.flash_decode_ref(jargs[0][:, 0],
                                                 *jargs[1:],
                                                 window=window)), **TOL)
    if 0 in kv_len:                               # fully masked row -> 0
        np.testing.assert_array_equal(out[kv_len.index(0)], 0.0)


def test_flash_verify_bf16_and_strided_cache():
    """bf16 q over an f32 cache view (a layer of the stacked cache, read
    through its strides) and bf16 q over a bf16 cache: the plain version
    computes in f32 from the values it is given, as the Pallas kernel."""
    q, k, v, kv = _flash_case(90, 2, 5, 8, 2, 64, 24, [9, 24])
    stacked = np.stack([k * 0, k, k * 2])          # (L, B, S, h_kv, D)
    kl = _t(stacked)[1]
    assert kl.storage_offset() > 0
    qb = _t(q).to(torch.bfloat16)
    out = ops.flash_verify(qb, kl, _t(v), _t(kv))
    assert out.dtype == torch.bfloat16
    want = ref.flash_verify_ref(jnp.asarray(qb.float().numpy()),
                                jnp.asarray(k), jnp.asarray(v),
                                jnp.asarray(kv))
    np.testing.assert_allclose(out.float().numpy(), np.asarray(want),
                               rtol=2 ** -7, atol=1e-5)
    kb, vb = _t(k).to(torch.bfloat16), _t(v).to(torch.bfloat16)
    pallas = j_flash_verify(jnp.asarray(q, jnp.bfloat16),
                            jnp.asarray(k, jnp.bfloat16),
                            jnp.asarray(v, jnp.bfloat16), jnp.asarray(kv),
                            interpret=True)
    np.testing.assert_allclose(
        ops.flash_verify(qb, kb, vb, _t(kv)).float().numpy(),
        np.asarray(pallas, np.float32), rtol=2 ** -7, atol=1e-5)


def test_flash_kernel_wrapper_checks_its_inputs():
    """The B5 wrapper takes CUDA tensors only and raises before anything
    is built or launched; ``use_kernels(False)`` forces the plain
    version; no launch is counted on the CPU."""
    from repro_torch.kernels import flash_decode as fd

    q, k, v, kv = _flash_case(91, 2, 3, 4, 4, 64, 16, [5, 16])
    args = (_t(q), _t(k), _t(v), _t(kv))
    with pytest.raises(ValueError, match="CUDA"):
        fd.flash_verify(*args)
    with pytest.raises(ValueError, match="CUDA"):
        fd.flash_decode(args[0][:, 0], *args[1:])
    ops.use_kernels(False)
    try:
        forced = ops.flash_verify(*args)
    finally:
        ops.use_kernels(True)
    torch.testing.assert_close(forced, fd.flash_verify_ref(*args))
    assert ops.launch_counts()["flash_verify"] == 0


def _emulate_split_walk(q, k, v, kv_len, *, window=None, k_scale=None,
                        v_scale=None):
    """Design 2 of ``csrc/paged_tiles.cu`` in its contiguous addressing
    mode, in f32 on the CPU: per (sequence, kv head, row tile), the splits
    ``tile_plan`` gives, each walked in blocks of N keys from a block
    boundary counted from the split's start over the tile's live range
    [k_lo, k_hi) (keys outside it zero-filled, never read), line j read
    at ``base + b*sb + j*ss + h*sh`` through k's own strides; each of the
    key_split warps keeps an online softmax over its part of every block,
    the warps merge in order, then the splits in split order."""
    from repro_torch.kernels.paged_decode import tile_plan

    B, T, H, D = q.shape
    S, h_kv = k.shape[1], k.shape[2]
    n_rep, rows = H // h_kv, T * (H // h_kv)
    plan = tile_plan(B, T, H, h_kv, D, 1, S, pool=k.dtype,
                     kernel="flash_verify")
    KS, N = plan.key_split, 32 if k.dtype == torch.float32 else 64
    TR, split_keys = 64 // KS, plan.split_pages
    scale = torch.tensor(1.0 / np.sqrt(D), dtype=torch.float32)
    out = torch.zeros(B, T, H, D)

    def lines(t, sc, b, h):
        x = torch.as_strided(t, (S, D), (t.stride(1), 1),
                             t.storage_offset() + b * t.stride(0)
                             + h * t.stride(2))
        if sc is not None:
            x = x.float() * torch.as_strided(
                sc, (S,), (sc.stride(1),),
                sc.storage_offset() + b * sc.stride(0)
                + h * sc.stride(2)).float()[:, None]
        return x.float()

    def merge(stats):
        """(m, l, acc) parts merged in order; a part with m = -inf adds
        nothing."""
        M = torch.stack([m for m, _, _ in stats]).amax(0)
        Ms = torch.where(torch.isfinite(M), M, 0.0)
        L, A = torch.zeros_like(M), 0.0
        for m, l, a in stats:
            f = torch.where(torch.isfinite(m), torch.exp(m - Ms), 0.0)
            L, A = L + l * f, A + a * f[:, None]
        return M, L, A

    for b in range(B):
        n = int(kv_len[b])
        for h in range(h_kv):
            kl, vl = lines(k, k_scale, b, h), lines(v, v_scale, b, h)
            for r0 in range(0, rows, TR):
                rr = torch.arange(r0, min(r0 + TR, rows))
                t, rep = rr // n_rep, rr % n_rep
                qr = q[b, t, h * n_rep + rep].float()
                qpos = n - T + t
                lo, hi = int(qpos[0]), int(qpos[-1])
                splits = []
                for sp in range(plan.n_split):
                    s0 = sp * split_keys
                    k_lo = max(0, lo - window + 1) if window else 0
                    k_lo = max(k_lo, s0)
                    k_hi = min(min(S, hi + 1) if hi >= 0 else 0,
                               s0 + split_keys)
                    kw = s0 + (k_lo - s0) // N * N
                    n_blocks = -(-(k_hi - kw) // N) if k_hi > k_lo else 0
                    parts = [(torch.full((len(rr),), -torch.inf),
                              torch.zeros(len(rr)), torch.zeros(len(rr), D))
                             for _ in range(KS)]
                    for j in range(n_blocks):
                        pos = kw + j * N + torch.arange(N)
                        live = (pos >= k_lo) & (pos < k_hi)
                        at = pos.clamp(0, S - 1)
                        kb = torch.where(live[:, None], kl[at], 0.0)
                        vb = torch.where(live[:, None], vl[at], 0.0)
                        for kg in range(KS):
                            sl = slice(kg * N // KS, (kg + 1) * N // KS)
                            see = live[sl] & (pos[sl] <= qpos[:, None])
                            if window:
                                see &= pos[sl] > qpos[:, None] - window
                            sc = torch.where(see, qr @ kb[sl].T * scale,
                                             -torch.inf)
                            m, l, a = parts[kg]
                            mn = torch.maximum(m, sc.amax(-1))
                            ms = torch.where(torch.isfinite(mn), mn, 0.0)
                            corr = torch.where(torch.isfinite(m),
                                               torch.exp(m - ms), 0.0)
                            p = torch.exp(sc - ms[:, None])
                            parts[kg] = (mn, l * corr + p.sum(-1),
                                         a * corr[:, None] + p @ vb[sl])
                    splits.append(merge(parts))
                _, L, A = merge(splits)
                out[b, t, h * n_rep + rep] = A / torch.clamp(
                    L, min=1e-30)[:, None]
    return out.to(q.dtype)


#: B5's walk: (B, T, H, h_kv, D, S, kv_len, window). Ragged S (40, 300,
#: 500: the last block and the last split are partial), kv_len past S,
#: two splits, a window, and fully masked rows: kv_len 2 < T puts rows
#: before position 0, and kv_len 200 with window 8 puts every row past the
#: window's reach of a 64-line cache
WALK_CASES = [
    (2, 5, 8, 2, 64, 300, [300, 310], None),
    (3, 3, 4, 4, 16, 40, [2, 40, 45], None),
    (2, 5, 8, 2, 96, 500, [260, 505], 64),
    (2, 4, 4, 2, 32, 64, [64, 200], 8),
    (1, 1, 16, 16, 128, 300, [299], None),
]


@pytest.mark.parametrize("pool", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("case", range(len(WALK_CASES)))
def test_contiguous_walk_matches_pallas(case, pool):
    """The contiguous addressing mode's walk (emulated), over a cache
    that is a strided layer of a stacked buffer whose lines past kv_len,
    past S and behind every row's window are NaN, against the Pallas
    ``flash_verify`` in interpret mode on the clean cache, atol 1e-5: the
    live range is right, nothing outside it is read, and fully masked
    rows come out 0."""
    from repro_torch.models.layers import quantize_kv

    B, T, H, h_kv, D, S, kv_len, window = WALK_CASES[case]
    q, k, v, kv = _flash_case(95 + case, B, T, H, h_kv, D, S, kv_len)
    scales = {}
    if pool == "int8":
        (kq, ks), (vq, vs) = quantize_kv(_t(k)), quantize_kv(_t(v))
        scales = dict(k_scale=ks.to(torch.bfloat16),
                      v_scale=vs.to(torch.bfloat16))
        k = (kq.float() * scales["k_scale"].float()[..., None]).numpy()
        v = (vq.float() * scales["v_scale"].float()[..., None]).numpy()
        tk, tv = kq, vq
    else:
        tk, tv = (_t(a).to(getattr(torch, pool)) for a in (k, v))
        k, v = tk.float().numpy(), tv.float().numpy()
    # a layer (index 1 of 3) of a buffer S + 8 lines long; NaN where the
    # walk must not read (int8 cannot hold NaN: its scales carry it)
    poisoned = []
    for t, sc in ((tk, scales.get("k_scale")), (tv, scales.get("v_scale"))):
        buf = torch.zeros((3, B, S + 8) + t.shape[2:], dtype=t.dtype)
        sbuf = torch.zeros((3, B, S + 8, h_kv), dtype=torch.bfloat16)
        buf[1, :, :S] = t
        if sc is not None:
            sbuf[1, :, :S] = sc
        for b, n in enumerate(kv_len):
            dead = torch.ones(S + 8, dtype=torch.bool)
            lo = max(0, n - T - window + 1) if window else 0
            dead[lo:min(n, S)] = False
            (sbuf if sc is not None else buf)[1, b, dead] = torch.nan
        poisoned.append((buf[1, :, :S], sbuf[1, :, :S] if sc is not None
                         else None))
    (pk, pks), (pv, pvs) = poisoned
    out = _emulate_split_walk(_t(q), pk, pv, _t(kv), window=window,
                              k_scale=pks, v_scale=pvs)
    pallas = j_flash_verify(*(jnp.asarray(a) for a in (q, k, v, kv)),
                            window=window, interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(pallas), **TOL)
    np.testing.assert_allclose(
        out.numpy(), ops.flash_verify(_t(q), tk, tv, _t(kv), window=window,
                                      **scales).numpy(), **TOL)
    for b, t in fully_masked_rows(kv_len, T, S, window):
        assert torch.equal(out[b, t], torch.zeros(H, D))


def fully_masked_rows(kv_len, T, S, window):
    """(sequence, row) pairs that see no cache line."""
    out = []
    for b, n in enumerate(kv_len):
        for t in range(T):
            qpos = n - T + t
            lo = max(qpos - window + 1, 0) if window else 0
            if min(qpos + 1, S) <= lo:
                out.append((b, t))
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_verify_int8_plain_matches_jax_dequantize(dtype):
    """The int8 plain version (the int8 cache and its bf16 scales inflated
    to f32, then ``verify_attention``) against the JAX package's own
    dequantize-then-attend on the same int8 cache: ``dequantize_kv`` to
    f32, then the Pallas ``flash_verify`` in interpret mode, q in f32
    (atol 1e-5) or bf16 (the bf16 tolerance, per element 1e-5 + 2^-7
    |ref|). The fused kernel reads the int8 values as they are, as B4
    does; the JAX model path's dequantize to a bf16 q's dtype rounds K and
    V first, and the plain model path on the CPU keeps that."""
    from repro.models.layers import dequantize_kv as j_dequantize_kv
    from repro_torch.models.layers import quantize_kv

    q, k, v, kv = _flash_case(99, 2, 5, 8, 2, 64, 96, [40, 96])
    (kq, ks), (vq, vs) = quantize_kv(_t(k)), quantize_kv(_t(v))
    ks, vs = ks.to(torch.bfloat16), vs.to(torch.bfloat16)
    qt = _t(q).to(getattr(torch, dtype))
    out = ops.flash_verify(qt, kq, vq, _t(kv), k_scale=ks, v_scale=vs)
    assert out.dtype == qt.dtype
    jks = jnp.asarray(ks.view(torch.int16).numpy()).view(jnp.bfloat16)
    jvs = jnp.asarray(vs.view(torch.int16).numpy()).view(jnp.bfloat16)
    jk = j_dequantize_kv(jnp.asarray(kq.numpy()), jks, jnp.float32)
    jv = j_dequantize_kv(jnp.asarray(vq.numpy()), jvs, jnp.float32)
    want = np.asarray(j_flash_verify(jnp.asarray(q, getattr(jnp, dtype)),
                                     jk, jv, jnp.asarray(kv),
                                     interpret=True), np.float32)
    got = out.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **TOL)
    else:
        assert (np.abs(got - want) <= 1e-5 + 2.0 ** -7 * np.abs(want)).all()
