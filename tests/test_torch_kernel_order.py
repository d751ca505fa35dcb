"""The arithmetic order of the port's B3 (``q4_matmul``) and B6
(``ssd_scan``) kernels, emulated in torch on the CPU, against the JAX
package's Pallas kernels (``interpret=True``) and oracles.

The CUDA kernels run only on the card (``chip_smoke.py`` phase 2 holds them
against their plain versions there). What these tests hold is the order
the kernels sum in, written out step by step as the kernels take it, and
the route each call takes, which is a function of shapes alone:

* B3: ``q4_plan`` picks the path and the K split; each 16-row block of x
  sums its groups' partials from zero (exact products, as the tensor cores
  take bf16 x times the int4 values), scales each in f32 in group order,
  and the splits are added in split order. f32 x enters as three bf16
  pieces that sum to it. Tolerance: ``Q4_TOL`` of ``chip_smoke.py``,
  1e-5 of max|ref| + 1e-5 |ref| (f32 sums in another order).
* B6: the chunks' cumsums in position order, C B^T once a chunk, the
  chunk states, the state hand-over in chunk order and the outputs, with
  the f32-formed operands as three bf16 pieces. Tolerances:
  atol = rtol = 2e-4 against the JAX oracles (``tests/test_torch_ssm.py``'s
  bound, f32 on both sides), and for bf16 inputs the chip's per-element
  1e-5 + 2^-7 |ref| (one rounding of the output).

Inputs come from numpy seeds.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.q4_matmul import q4_matmul as j_q4_matmul
from repro.kernels.ssd_scan import ssd_scan as j_ssd_scan
from repro.quant import grouped as JQ
from repro_torch.kernels import q4_matmul as tq4
from repro_torch.kernels import ssd_scan as tssd

Q4_TOL = 1e-5
SCAN_TOL = dict(rtol=2e-4, atol=2e-4)


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


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


# --------------------------------------------------------------------------- #
#  B3: the plan
# --------------------------------------------------------------------------- #

#: phase 2's B3 shapes (M, K, N): qwen2.5-14b's projections at decode,
#: a ragged tile and prefills; qwen1.5-32b's at its decode and verify;
#: mamba2-780m's in_proj and out_proj
PHASE2_Q4 = [(M, K, N)
             for K, N in ((5120, 5120), (5120, 1024), (5120, 13824),
                          (13824, 5120))
             for M in (1, 8, 37, 256, 512)] + \
    [(M, K, N) for K, N in ((5120, 5120), (5120, 27392), (27392, 5120))
     for M in (2, 10)] + \
    [(M, K, N) for K, N in ((1536, 6448), (3072, 1536)) for M in (1, 1024)]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", PHASE2_Q4, ids=str)
def test_q4_plan_fills_the_card(shape, dtype):
    """At every phase-2 shape the plan holds at least 2 waves of 132 SMs,
    splits K into whole groups, and sends bf16 x past 16 rows to the tile
    path (everything else to decode)."""
    M, K, N = shape
    dt = getattr(torch, dtype)
    plan = tq4.q4_plan(M, K, N, 64, x_dtype=dt)
    ctas = plan.grid[0] * plan.grid[1] * plan.grid[2]
    assert ctas >= 2 * tq4.SMS, (plan, ctas)
    assert 1 <= plan.n_split <= K // 64 and plan.grid[2] == plan.n_split
    assert plan.kernels == 1 + (plan.n_split > 1)
    want = "tile" if dt == torch.bfloat16 and M > tq4.DECODE_ROWS \
        else "decode"
    assert plan.path == want
    assert plan == tq4.q4_plan(M, K, N, 64, x_dtype=dt)   # shapes alone


@pytest.mark.parametrize("kn", [(5120, 5120), (5120, 1024), (27392, 5120),
                                (1536, 6448), (96, 40)], ids=str)
def test_q4_plan_gives_decode_rows_one_order(kn):
    """Every M <= 16 takes the decode path with the same K split and the
    same column tiles, so a row sums its groups in the same order whatever
    the rows beside it (a verify row equals a decode step's)."""
    K, N = kn
    plans = [tq4.q4_plan(M, K, N, 16 if K == 96 else 64) for M in range(1, 17)]
    assert {p.path for p in plans} == {"decode"}
    assert len({(p.n_split, p.grid[0], p.grid[1]) for p in plans}) == 1


# --------------------------------------------------------------------------- #
#  B3: the summation order, emulated
# --------------------------------------------------------------------------- #

def _pieces(x: torch.Tensor, n: int):
    """The n bf16 pieces that sum to x, largest first (each residual exact
    in f32), as the kernel splits f32 x."""
    out, r = [], x.float()
    for _ in range(n):
        p = r.to(torch.bfloat16).float()
        out.append(p)
        r = r - p
    return out


def _emulate_q4(x, packed, scale, group):
    """B3 as the kernel sums it: the plan's K splits, in each the groups in
    order, each group's partial of exact products (rounded once to f32),
    scaled in f32 and added to the split's accumulator; the splits added
    in split order. Every row is computed on its own."""
    from repro_torch.quant.grouped import unpack_q4

    M, K = x.shape
    N = packed.shape[1]
    plan = tq4.q4_plan(M, K, N, group, x_dtype=x.dtype)
    q = unpack_q4(packed).double()                       # (K, N), exact
    s = scale.float()
    if x.dtype == torch.float32:
        pcs = _pieces(x, 3)
        assert torch.equal(pcs[0] + pcs[1] + pcs[2], x)  # an exact split
        xd = sum(p.double() for p in pcs)
    else:
        xd = x.double()
    G = K // group
    out = None
    for sp in range(plan.n_split):
        acc = torch.zeros((M, N), dtype=torch.float32)
        for gi in range(sp * G // plan.n_split, (sp + 1) * G // plan.n_split):
            k = slice(gi * group, (gi + 1) * group)
            part = (xd[:, k, None] * q[None, k]).sum(1).float()
            acc = acc + s[gi][None] * part
        out = acc if out is None else out + acc
    return out


def _q4_case(seed, M, K, N, group):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = rng.standard_normal((K, N)).astype(np.float32) / np.sqrt(K)
    qt = JQ.quantize_q4(jnp.asarray(w), group)
    tp = torch.tensor(np.asarray(qt.packed))
    ts = torch.tensor(np.asarray(qt.scale).view(np.int16)).view(torch.bfloat16)
    return x, qt, tp, ts


def _within_q4(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    allowed = Q4_TOL * np.abs(want).max() + Q4_TOL * np.abs(want)
    return float((np.abs(got - want) / allowed).max())


#: shapes the Pallas kernel takes (M, N, K divide its 256/512/256 tiles)
Q4_PALLAS = [(8, 512, 1024, 64), (256, 256, 512, 64), (16, 512, 512, 128),
             (1, 256, 256, 32)]


@pytest.mark.parametrize("case", Q4_PALLAS, ids=str)
def test_q4_order_matches_pallas(case):
    M, K, N, group = case
    x, qt, tp, ts = _q4_case(70 + K, M, K, N, group)
    pallas = j_q4_matmul(jnp.asarray(x), qt.packed, qt.scale, group=group,
                         interpret=True)
    got = _emulate_q4(_t(x), tp, ts, group)
    assert _within_q4(got.numpy(), np.asarray(pallas)) <= 1.0


#: ragged shapes the Hopper kernel takes: M past one 16-row block, N not a
#: multiple of the 128-column tile, groups of 16, 32, 48 and 64
Q4_RAGGED = [(1, 128, 24, 64), (3, 192, 40, 64), (37, 256, 33, 32),
             (17, 64, 1000, 16), (5, 96, 7, 48), (100, 384, 136, 64)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", Q4_RAGGED, ids=str)
def test_q4_order_matches_the_plain_version(case, dtype):
    M, K, N, group = case
    x, qt, tp, ts = _q4_case(80 + M, M, K, N, group)
    xt = _t(x).to(getattr(torch, dtype))
    got = _emulate_q4(xt, tp, ts, group)
    want = tq4.q4_matmul_ref(xt, tp, ts, group=group)
    oracle = jref.q4_matmul_ref(jnp.asarray(x, getattr(jnp, dtype)),
                                qt.packed, qt.scale, group=group)
    assert _within_q4(got.numpy(), want.numpy()) <= 1.0
    assert _within_q4(got.numpy(), np.asarray(oracle)) <= 1.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_q4_decode_rows_equal_across_m(dtype):
    """A row's result does not depend on how many rows share the call, up
    to 16: every M <= 16 gives its rows to the bit."""
    x, qt, tp, ts = _q4_case(90, 16, 512, 200, 64)
    xt = _t(x).to(getattr(torch, dtype))
    full = _emulate_q4(xt, tp, ts, 64)
    for M in range(1, 17):
        assert torch.equal(_emulate_q4(xt[:M], tp, ts, 64), full[:M]), M


# --------------------------------------------------------------------------- #
#  B6: the decomposition, emulated
# --------------------------------------------------------------------------- #

def _three_pieces(v: torch.Tensor) -> torch.Tensor:
    """hi + mid + lo, the three bf16 pieces an f32-formed operand enters
    the bf16 products as."""
    hi, mid, lo = _pieces(v, 3)
    return hi + mid + lo


def _emulate_ssd(x, dt, A, Bm, Cm, *, chunk=128, pieces=False):
    """B6 as the kernels take it: per (b, chunk) the cumsum of dt A in
    position order and C B^T; per (b, chunk, head) the chunk state; the
    hand-over h_c = exp(total_c) h_{c-1} + s_c in chunk order; the outputs.
    Positions past S are padded with NaN and never used (selected away,
    never multiplied by zero); masked s > t exponents are clamped to 0 and
    never used. ``pieces``: the f32-formed operands (w x, the scores, the
    state) round to three bf16 pieces, as the tensor cores take them."""
    Bsz, S, nh, P = x.shape
    nc = -(-S // chunk)
    L = nc * chunk
    f = x.dtype
    pad = lambda a: torch.cat([a.float(), torch.full(
        (Bsz, L - S, *a.shape[2:]), float("nan"))], 1)
    xr = pad(x).reshape(Bsz, nc, chunk, nh, P)
    dtr = pad(dt).reshape(Bsz, nc, chunk, nh)
    Br = pad(Bm).reshape(Bsz, nc, chunk, -1)
    Cr = pad(Cm).reshape(Bsz, nc, chunk, -1)
    pos = torch.arange(L).reshape(nc, chunk)
    live = (pos < S)[None, :, :]                           # (1, nc, chunk)
    zero = torch.zeros(())
    piece = _three_pieces if pieces else (lambda v: v)
    xr = torch.where(live[..., None, None], xr, zero)
    dtr = torch.where(live[..., None], dtr, zero)
    Br = torch.where(live[..., None], Br, zero)
    Cr = torch.where(live[..., None], Cr, zero)
    a = A.float()
    cum = torch.zeros_like(dtr)                            # position order
    run = torch.zeros((Bsz, nc, nh))
    for i in range(chunk):
        run = run + dtr[:, :, i] * a
        cum[:, :, i] = run
    n = torch.clamp(S - torch.arange(nc) * chunk, max=chunk)   # rows a chunk
    total = cum[:, torch.arange(nc), n - 1]                # (B, nc, nh)
    cb = torch.einsum("bctn,bcsn->bcts", Cr, Br)           # once a chunk
    w = torch.where(live[..., None],
                    torch.exp(torch.clamp(total[:, :, None] - cum, max=0.0))
                    * dtr, zero)
    states = torch.einsum("bcshp,bcsn->bchpn", piece(w[..., None] * xr), Br)
    h = torch.zeros((Bsz, nh, P, Br.shape[-1]))
    h_prev = []
    for c in range(nc):
        h_prev.append(h)
        h = torch.exp(total[:, c])[..., None, None] * h + states[:, c]
    h_prev = torch.stack(h_prev, 1)                        # (B, nc, nh, P, N)
    t = torch.arange(chunk)
    causal = (t[:, None] >= t[None, :])[None, None, :, :, None]
    diff = torch.clamp(cum[:, :, :, None] - cum[:, :, None, :], max=0.0)
    scores = torch.where(causal & live[..., None, None],
                         cb[..., None] * torch.exp(diff)
                         * dtr[:, :, None, :, :], zero)    # (B,nc,t,s,nh)
    y = torch.einsum("bctsh,bcshp->bcthp", piece(scores), xr)
    y = y + torch.exp(cum)[..., None] * torch.einsum(
        "bctn,bchpn->bcthp", Cr, piece(h_prev))
    y = y.reshape(Bsz, L, nh, P)[:, :S]
    return y.to(f), h.to(f)


def _scan_inputs(seed, Bsz, S, nh, P, N, *, dt_shift=0.0):
    """x, dt (softplus of a normal), A (< 0), B and C, as
    ``tests/test_kernels.py`` draws them."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((Bsz, S, nh, P)).astype(np.float32) * 0.5
    dt = np.log1p(np.exp(rng.standard_normal((Bsz, S, nh)) + dt_shift)
                  ).astype(np.float32)
    A = -np.exp(rng.standard_normal(nh) * 0.3).astype(np.float32)
    Bm = rng.standard_normal((Bsz, S, N)).astype(np.float32) * 0.3
    Cm = rng.standard_normal((Bsz, S, N)).astype(np.float32) * 0.3
    return x, dt, A, Bm, Cm


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **SCAN_TOL)


#: (B, S, nh, P, N, chunk), S a multiple of the chunk (the Pallas kernel's
#: rule)
SSD_PALLAS = [(2, 32, 3, 8, 16, 16), (1, 64, 2, 16, 32, 32),
              (1, 256, 2, 16, 32, 128)]


@pytest.mark.parametrize("case", SSD_PALLAS, ids=str)
def test_ssd_decomposition_matches_pallas(case):
    Bsz, S, nh, P, N, chunk = case
    args = _scan_inputs(100 + S, Bsz, S, nh, P, N)
    y_j, h_j = j_ssd_scan(*map(jnp.asarray, args), chunk=chunk,
                          interpret=True)
    y_e, h_e = _emulate_ssd(*map(_t, args), chunk=chunk)
    _close(y_e, y_j)
    _close(h_e, h_j)


@pytest.mark.parametrize("S", [77, 1000])
def test_ssd_decomposition_matches_the_recurrence_at_ragged_s(S):
    args = _scan_inputs(110 + S, 1, S, 3, 8, 16)
    y_s, h_s = jref.ssd_sequential_ref(*map(jnp.asarray, args))
    y_e, h_e = _emulate_ssd(*map(_t, args))
    _close(y_e, y_s)
    _close(h_e, h_s)


def test_ssd_decomposition_stays_finite_on_a_poisoned_masked_future():
    """dt of ~40 makes every masked s > t difference overflow exp (and
    inf * 0 is NaN); positions past S are NaN. The decomposition never uses
    either: finite, and equal to the recurrence."""
    args = _scan_inputs(120, 1, 200, 2, 8, 16, dt_shift=40.0)
    y_e, h_e = _emulate_ssd(*map(_t, args))
    assert torch.isfinite(y_e).all() and torch.isfinite(h_e).all()
    y_s, h_s = tssd.ssd_sequential_ref(*map(_t, args))
    _close(y_e, y_s)
    _close(h_e, h_s)


def test_ssd_three_pieces_hold_the_bf16_bound():
    """bf16 inputs at mamba2-780m's head geometry (P 64, N 128) and phase
    2's scales: with the f32-formed operands as three bf16 pieces the outputs
    stay within one rounding of the f32 recurrence's (1e-5 + 2^-7 |ref| per
    element, the chip's bf16 bound)."""
    rng = np.random.default_rng(130)
    S, nh = 300, 2
    x = torch.tensor(rng.standard_normal((1, S, nh, 64), dtype=np.float32)
                     * 0.5).bfloat16()
    dt = torch.nn.functional.softplus(torch.tensor(
        rng.standard_normal((1, S, nh), dtype=np.float32) - 4.0))
    A = -torch.tensor(np.exp(rng.standard_normal(nh) * 0.5),
                      dtype=torch.float32)
    Bm = torch.tensor(rng.standard_normal((1, S, 128), dtype=np.float32)
                      * 0.3).bfloat16()
    Cm = torch.tensor(rng.standard_normal((1, S, 128), dtype=np.float32)
                      * 0.3).bfloat16()
    y_e, h_e = _emulate_ssd(x, dt, A, Bm, Cm, pieces=True)
    y_s, h_s = tssd.ssd_sequential_ref(x, dt, A, Bm, Cm)
    for got, want in ((y_e, y_s), (h_e, h_s)):
        err = (got.float() - want.float()).abs()
        allowed = 1e-5 + 2.0 ** -7 * want.float().abs()
        assert float((err / allowed).max()) <= 1.0


def test_ssd_plan_counts_the_chunks_and_workspaces():
    plan = tssd.ssd_plan(1, 1024, 48)
    assert plan.n_chunks == 8 and plan.grid == 384 and plan.kernels == 3
    # cumsums, C B^T once a chunk, the (P, N) f32 state of every head
    assert plan.workspace == (8 * 48 * 128, 8 * 128 * 128, 8 * 48 * 64 * 128)
    assert plan.workspace[2] * 4 == 12_582_912              # 12.6 MB
    assert tssd.ssd_plan(2, 77, 48).n_chunks == 1
