"""What the metric files of ``metrics/`` share: the traced window's steps,
kernel calls and their bounds. A reader returns None where it finds
nothing to read."""
from __future__ import annotations

from typing import List, Optional

from .counts import b1_decode, b3_decode, b3_tile, model_step
from .trace import calls, template_args
from .weights import proj_shapes


def traced(ctx, items) -> list:
    """The records (start, end, ...) that lie inside the traced window."""
    tr = ctx.trace
    if tr is None or tr.t1 is None:
        return []
    return [r for r in items if r[0] >= tr.t0 and r[1] <= tr.t1]


def idle_share(ctx) -> Optional[float]:
    tr = ctx.trace
    if tr is None or tr.t1 is None or not tr.kernels:
        return None
    busy, _ = tr.busy()
    return 100.0 * (1.0 - busy / tr.window_s)


def mfu(ctx) -> Optional[float]:
    """The traced window's least time for its model work (each step's
    larger of operations over the peak and bytes over the bandwidth),
    over the window, in %."""
    tr = ctx.trace
    steps = traced(ctx, ctx.decodes)
    chunks = traced(ctx, ctx.prefills)
    if tr is None or tr.t1 is None or not (steps or chunks):
        return None
    least = 0.0
    for _, _, lens in steps:
        least += model_step.least_s(*model_step.decode(ctx.model,
                                                       ctx.weights, lens))[0]
    for _, _, S, off, head_rows in chunks:
        least += model_step.least_s(*model_step.prefill(
            ctx.model, ctx.weights, S, off, head_rows))[0]
    return 100.0 * least / tr.window_s


def _share(bound_s: float, device_s: float) -> Optional[float]:
    if device_s <= 0.0 or bound_s <= 0.0:
        return None
    return 100.0 * bound_s / device_s


def b3_roofline(ctx, path: str) -> Optional[float]:
    """B3's calls on one path ("decode": M <= 16, "tile") in the traced
    window: the sum of their bounds over their device time."""
    if ctx.weights.get("projections") != "q4":
        return None
    L = ctx.model["n_layers"]
    shapes = list(proj_shapes(ctx.model).values())
    g = int(ctx.weights["group"])
    if path == "decode":
        rows = [len(lens) for _, _, lens in traced(ctx, ctx.decodes)]
        count = b3_decode
    else:
        rows = [S for _, _, S, _, _ in traced(ctx, ctx.prefills)]
        count = b3_tile
    bound = sum(L * count.bound(M, K, N, g)[0]
                for M in rows for K, N in shapes)

    def tile(name):          # q4_gemm<T, MT, aligned>: MT 8 is the tile
        a = template_args(name)
        return len(a) > 1 and a[1] == "8"
    keep = tile if path == "tile" else (lambda n: not tile(n))
    found = calls(ctx.trace.kernels, "q4_gemm", "q4_combine", keep=keep)
    ctx.note(f"b3 {path}: {len(found)} calls traced, "
             f"{L * len(shapes) * len(rows)} expected")
    return _share(bound, sum(d for _, d in found))


def b1_roofline(ctx) -> Optional[float]:
    """B1 (paged decode attention, design 2) over the traced decode
    steps: each layer's bound from the step's real lengths."""
    if ctx.engine.get("kind") != "paged":
        return None
    m = ctx.model
    steps = traced(ctx, ctx.decodes)
    bound = sum(m["n_layers"] * b1_decode.bound(
        lens, batch=ctx.slots, heads=m["n_heads"], kv_heads=m["kv_heads"],
        head_dim=m["head_dim"])[0] for _, _, lens in steps)

    def design2(name):       # paged_tile_kernel<.., kPartial, kContig>
        a = template_args(name)
        return len(a) == 7 and a[5] == "true" and a[6] == "false"
    found = calls(ctx.trace.kernels, "paged_tile_kernel", "combine_splits",
                  keep=design2)
    ctx.note(f"b1: {len(found)} calls traced, "
             f"{m['n_layers'] * len(steps)} expected")
    return _share(bound, sum(d for _, d in found))


def decode_step_ms(ctx) -> Optional[float]:
    """The window's decode calls outside the traced stretch (CUPTI's cost
    a kernel would count otherwise); all of them where the trace covered
    the whole window."""
    steps = [(a, b) for a, b, _ in ctx.decodes
             if ctx.t0 <= a <= ctx.t_close]
    tr = ctx.trace
    if tr is not None and tr.t1 is not None:
        steps = [ab for ab in steps
                 if not tr.t0 <= ab[0] <= tr.t1] or steps
    d: List[float] = [b - a for a, b in steps]
    return 1e3 * sum(d) / len(d) if d else None
