"""The trace reduction on a hand-made kernel list: names, a kernel's calls
with their split combines, busy time, the idle breakdown, and the
roofline readers over them."""
import pytest

from portbench import readers
from portbench.harness import Ctx
from portbench.trace import (DeviceTrace, calls, short_name, template_args,
                             union_s)

Q4D = "void (anonymous namespace)::q4_gemm<__nv_bfloat16, 1, true>(" \
      "__nv_bfloat16 const*, " \
      "unsigned char const*, __nv_bfloat16 const*, float*, int, int, int, " \
      "int, int)"
Q4T = "void q4_gemm<__nv_bfloat16, 8, true>(__nv_bfloat16 const*, ...)"
COMB = "(anonymous namespace)::q4_combine(float const*, float*, long long, " \
       "int)"
B1 = "void paged_tile_kernel<__nv_bfloat16, __nv_bfloat16, " \
     "__nv_bfloat16, 128, 4, true, false>(...)"
B2 = "void paged_tile_kernel<__nv_bfloat16, __nv_bfloat16, " \
     "__nv_bfloat16, 128, 2, false, false>(...)"
CS = "void combine_splits<__nv_bfloat16, 128>(float const*, ...)"


def test_names():
    assert short_name(Q4D) == "q4_gemm<__nv_bfloat16, 1, true>"
    assert template_args(Q4T) == ["__nv_bfloat16", "8", "true"]
    assert template_args(B1)[5:] == ["true", "false"]
    assert template_args(COMB) == []
    assert short_name(COMB) == "q4_combine"
    assert short_name("at::native::(anonymous namespace)::f(int)") == \
        "at::native::f"


def test_calls_take_their_combine():
    k = [(Q4D, 0.0, 1e-5), (COMB, 1e-5, 1e-6), (Q4T, 2e-5, 4e-5),
         ("elementwise", 6e-5, 1e-6), (Q4D, 7e-5, 1e-5)]
    dec = calls(k, "q4_gemm", "q4_combine",
                keep=lambda n: template_args(n)[1] != "8")
    assert [round(d, 9) for _, d in dec] == [1.1e-5, 1e-5]
    tile = calls(k, "q4_gemm", "q4_combine",
                 keep=lambda n: template_args(n)[1] == "8")
    assert [round(d, 9) for _, d in tile] == [4e-5]
    b = [(B1, 0.0, 2e-5), (CS, 2e-5, 5e-6), (B2, 3e-5, 8e-5)]
    assert len(calls(b, "paged_tile_kernel", "combine_splits",
                     keep=lambda n: template_args(n)[5] == "true")) == 1


def traced(kernels, t0=0.0, t1=1.0):
    tr = DeviceTrace(1.0)
    tr.t0, tr.t1, tr.kernels = t0, t1, kernels
    return tr


def test_busy_and_breakdown():
    assert union_s([(0, 2), (1, 3), (5, 6)])[0] == 4
    tr = traced([("a", 0.1, 0.2), ("b", 0.2, 0.2), ("a", 0.8, 0.5)])
    busy, _ = tr.busy()
    assert busy == pytest.approx(0.5)            # clipped at the close
    bd = tr.breakdown([("step", 0.0, 0.5), ("admit", 0.45, 0.7)])
    assert bd["device_ops"][0] == ["a", pytest.approx(0.7)]
    idle = {n.split(" (")[0]: s for n, s in bd["idle_gaps"]}
    assert idle == {"step": pytest.approx(0.1), "admit": pytest.approx(0.4)}


def ctx_of(kernels, decodes=(), prefills=(), engine="streaming_resident"):
    m = {"n_layers": 2, "d_model": 64, "n_heads": 4, "kv_heads": 2,
         "head_dim": 16, "d_ff": 128, "vocab": 256}
    return Ctx(trace=traced(kernels), model=m, engine={"kind": engine},
               weights={"projections": "q4", "group": 32}, slots=4,
               decodes=list(decodes), prefills=list(prefills), t0=0.0,
               t_close=1.0)


def test_roofline_readers():
    from portbench.counts import b3_decode
    k = [(Q4D, 0.01 + 1e-3 * i, 1e-4) for i in range(14)]
    ctx = ctx_of(k, decodes=[(0.005, 0.05, [10])])
    bound = 2 * sum(b3_decode.bound(1, K, N, 32)[0] for K, N in
                    [(64, 64), (64, 32), (64, 32), (64, 64), (64, 128),
                     (64, 128), (128, 64)])
    assert readers.b3_roofline(ctx, "decode") == pytest.approx(
        100 * bound / 14e-4)
    assert readers.b3_roofline(ctx, "tile") is None        # no calls
    assert readers.idle_share(ctx) == pytest.approx(100 * (1 - 14e-4))
    assert readers.mfu(ctx) > 0
    assert readers.b1_roofline(ctx) is None                # not paged
    assert readers.decode_step_ms(ctx) == pytest.approx(45.0)
    empty = ctx_of([])
    assert readers.idle_share(empty) is None and readers.mfu(empty) is None
