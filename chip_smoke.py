#!/usr/bin/env python3
"""The PyTorch / CUDA port on one H100, end to end: ``python3 chip_smoke.py``.

Phase 0  the card (name, power limit), TF32 off.
Phase 1  build the CUDA kernels from ``src/repro_torch/kernels/csrc`` with
         nvcc (sm_90a) and print the build time and ptxas summary.
Phase 2  hold each kernel (B1 paged_verify, B2 paged_prefill, B4
         paged_verify_quant) against its plain torch version at the main
         path's head shapes (H 40, h_kv 8, D 128, 16-token pages), B4 at
         decode and at int8 admission's chunk shapes, in f32 (atol 2e-5)
         and bf16 (per element 1e-5 + 2^-7 |ref|, under a 1e-2 ceiling),
         and show that the same check rejects a swapped page; time the
         kernel, the plain version and SDPA on pre-gathered pages
         (``library_ms``, a yardstick the port never calls), beside the
         least time the card could take.
Phase 3  serve 16 requests (prompts 256-1024, up to 32 new tokens) through
         the paged engine with chunked admission at qwen2.5-14b's full
         width, 48 layers, bf16, random weights from a seed — then the same
         with int8 pages — and show that every chunk and decode step of
         every layer launched its kernel.
Phase 4  a 4-layer full-width f32 copy: the paged engine (chunked, f32
         and int8 pages) with kernels against ``use_kernels(False)``:
         every launch agrees with its plain version on the same inputs;
         with f32 pages logits agree to 2e-4 of max|ref| and tokens are
         equal; the dense engine's tokens equal the paged engine's.

Prints the kernels' JSON line, then ``{"ok": true, "device": ...}`` as the
last line. Any failure raises and the script exits nonzero without it; it
also refuses to run without a CUDA device.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_S = 3.35e12                       # H100 SXM, data sheet
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}   # bf16 tensor / f32 SIMT
H, H_KV, D, BS = 40, 8, 128, 16             # qwen2.5-14b attention heads
SOURCE = "src/repro_torch/kernels/csrc/paged_attention.cu"
REPLACES = {"paged_verify": "src/repro/kernels/paged_decode.py:89",
            "paged_prefill": "src/repro/kernels/paged_prefill.py:99",
            "paged_verify_quant": "src/repro/kernels/paged_decode.py:214"}


def log(msg: str) -> None:
    print(msg, flush=True)


# --------------------------------------------------------------------------- #
#  phase 2 helpers
# --------------------------------------------------------------------------- #

class Timer:
    """Median device time of one call, each launch after an L2 flush (the
    main path meets each layer's pages cold: a layer pool outgrows L2)."""

    def __init__(self, torch, reps: int = 25):
        self.torch = torch
        self.reps = reps
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn) -> float:
        torch = self.torch
        for _ in range(3):
            fn()
        times = []
        for _ in range(self.reps):
            self.flush.zero_()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return float(np.median(times))


def make_pages(torch, rng, *, B, nb, kv_len, sink_rows=()):
    """A pool with each sequence's live pages at random ids; table entries
    past ceil(kv_len/bs) are stale ids of other pages; ``sink_rows`` run
    as inactive slots (all-sink table, kv_len = T set by the caller)."""
    P = B * nb + 1
    perm = rng.permutation(np.arange(1, P)).reshape(B, nb)
    table = perm.copy()
    for b in range(B):
        live = -(-int(kv_len[b]) // BS)
        table[b, live:] = rng.integers(1, P, nb - live)
    for b in sink_rows:
        table[b] = 0
    # data at std 0.5 keeps |out| < 4, where bf16's half-ulp is < 1e-2
    k = rng.standard_normal((P, BS, H_KV, D), dtype=np.float32) * 0.5
    v = rng.standard_normal((P, BS, H_KV, D), dtype=np.float32) * 0.5
    dev = "cuda"
    return (torch.from_numpy(k).to(dev), torch.from_numpy(v).to(dev),
            torch.from_numpy(table.astype(np.int32)).to(dev))


def visible(kv_len, T, window):
    """Per sequence: (positions any row sees, sum over rows of keys seen)."""
    pos, keys = [], []
    for n in kv_len:
        n = int(n)
        qpos = np.arange(n - T, n)
        lo = np.maximum(qpos - (window - 1), 0) if window else \
            np.zeros_like(qpos)
        pos.append(n - int(lo[0]))
        keys.append(int((qpos + 1 - lo).sum()))
    return pos, keys


def bound_ms(*, q_elems, elt, kv_pos, keys, quant, scale_elt, dtype):
    """Least time for the work: each input byte read once, each output
    byte written once (live K/V positions only), against the operations
    (QK and PV multiply-adds over the keys each row sees)."""
    kv_elt = 1 if quant else elt
    kv = sum(kv_pos) * H_KV * D * kv_elt * 2
    if quant:
        kv += sum(kv_pos) * H_KV * scale_elt * 2
    nbytes = 2 * q_elems * elt + kv
    flops = 4 * D * H * sum(keys)
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = flops / PEAK_OPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def sdpa_on_gathered(torch, q, k, v, table, kv_len, window):
    """The library yardstick: SDPA over pages gathered beforehand."""
    import torch.nn.functional as F

    B, T = q.shape[:2]
    kg = k[table.long()].flatten(1, 2).permute(0, 2, 1, 3)    # (B,hk,S,D)
    vg = v[table.long()].flatten(1, 2).permute(0, 2, 1, 3)
    S = kg.shape[2]
    pos = torch.arange(S, device=q.device)
    qpos = kv_len.long()[:, None] - T + torch.arange(T, device=q.device)
    mask = pos[None, None] <= qpos[..., None]
    if window:
        mask &= pos[None, None] > qpos[..., None] - window
    mask = mask[:, None]                                      # (B,1,T,S)
    n_rep = q.shape[2] // kg.shape[1]
    kg = kg.repeat_interleave(n_rep, dim=1)                   # (B,H,S,D)
    vg = vg.repeat_interleave(n_rep, dim=1)
    qt = q.permute(0, 2, 1, 3)

    def call():
        return F.scaled_dot_product_attention(qt, kg, vg, attn_mask=mask)
    return call


def within(out, want, dtype):
    """Worst ratio of |out - want| to what the dtype allows, per element.
    f32: atol 2e-5 (another order of summation). bf16: the kernel's one
    rounding of its f32 result, 1e-5 + 2^-7 |want| (one bf16 ulp at most;
    rounding costs half of one), under the 1e-2 ceiling; a per-element
    bound keeps the check sharp where outputs are small, as they are under
    a flat softmax."""
    err = (out.float() - want.float()).abs()
    if dtype == "float32":
        return float(err.max()) / 2e-5
    ratio = float((err / (1e-5 + 2.0 ** -7 * want.float().abs())).max())
    return max(ratio, float(err.max()) / 1e-2)


def check_kernels(torch, timer, rng):
    """Phase 2; returns the JSON rows (bf16 measurements) by kernel."""
    from repro_torch.kernels import paged_decode as pd
    from repro_torch.kernels import paged_prefill as pp
    from repro_torch.models.layers import quantize_kv

    B, nb = 8, 2048 // BS
    kv_len_np = rng.integers(64, 2049, B)
    cases = []
    for T in (1, 4):
        kvl = kv_len_np.copy()
        kvl[0] = T                               # inactive slot, sink table
        cases.append(("paged_verify", f"B1 T={T} B={B}", T, kvl, None, (0,)))
    for S, n, window in ((256, 1024, None), (256, 1024, 512),
                         (100, 868, None)):
        cases.append(("paged_prefill", f"B2 S={S} kv_len={n} "
                      f"window={window}", S, np.array([n]), window, ()))
    cases.append(("paged_verify_quant", f"B4 T=1 B={B}", 1, kv_len_np,
                  None, ()))
    # int8 chunked admission: a full chunk and a short last one at B = 1
    for S, n in ((256, 1024), (100, 868)):
        cases.append(("paged_verify_quant", f"B4 S={S} kv_len={n}", S,
                      np.array([n]), None, ()))
    rows = {}
    for name, label, T, kvl, window, sinks in cases:
        Bc = len(kvl)
        k32, v32, table = make_pages(torch, rng, B=Bc, nb=nb, kv_len=kvl,
                                     sink_rows=sinks)
        # negative control: one sequence's newest page swapped for another
        # page, which every row of it sees; the check must reject it
        b_bad = Bc - 1
        last = (int(kvl[b_bad]) - 1) // BS
        bad_table = table.clone()
        bad_table[b_bad, last] = table[b_bad, 0]
        kv_len = torch.from_numpy(kvl.astype(np.int32)).cuda()
        q32 = torch.from_numpy(rng.standard_normal(
            (Bc, T, H, D), dtype=np.float32)).cuda()
        for dtype in ("float32", "bfloat16"):
            dt = getattr(torch, dtype)
            q = q32.to(dt)
            if name == "paged_verify_quant":
                kq, ks = quantize_kv(k32)
                vq, vs = quantize_kv(v32)
                ks, vs = ks.to(dt), vs.to(dt)     # scales in the pool dtype
                args = (q, kq, vq, ks, vs, table, kv_len)
                kern = lambda: pd.paged_verify_quant(*args, window=window)
                plain32 = lambda tab=table: pd.paged_verify_quant_ref(
                    q.float(), kq, vq, ks, vs, tab, kv_len, window=window)
                plain = lambda: pd.paged_verify_quant_ref(*args,
                                                          window=window)
                kd = (ks.float()[..., None] * kq.float()).to(dt)
                vd = (vs.float()[..., None] * vq.float()).to(dt)
                lib = sdpa_on_gathered(torch, q, kd, vd, table, kv_len,
                                       window)
            else:
                k, v = k32.to(dt), v32.to(dt)
                args = (q, k, v, table, kv_len)
                wrap = pd.paged_verify if name == "paged_verify" \
                    else pp.paged_prefill
                ref = pd.paged_verify_ref if name == "paged_verify" \
                    else pp.paged_prefill_ref
                kern = lambda: wrap(*args, window=window)
                plain32 = lambda tab=table: ref(q.float(), k.float(),
                                                v.float(), tab, kv_len,
                                                window=window)
                plain = lambda: ref(*args, window=window)
                lib = sdpa_on_gathered(torch, q, k, v, table, kv_len,
                                       window)
            out = kern()
            torch.cuda.synchronize()
            want = plain32()
            if torch.isnan(out).any():
                raise AssertionError(f"{label} {dtype}: NaN in kernel out")
            err = float((out.float() - want.float()).abs().max())
            ratio = within(out, want, dtype)
            if ratio > 1.0:
                raise AssertionError(f"{label} {dtype}: max|err| {err}, "
                                     f"{ratio:.3g}x the tolerance")
            control = within(plain32(bad_table).to(dt), want, dtype)
            if control <= 1.0:
                raise AssertionError(f"{label} {dtype}: the check does not "
                                     f"see a swapped page ({control:.3g}x "
                                     f"the tolerance)")
            ms = timer(kern)
            plain_ms = timer(plain)
            lib_ms = timer(lib)
            kv_pos, keys = visible(kvl, T, window)
            bms, by = bound_ms(q_elems=q.numel(), elt=q.element_size(),
                               kv_pos=kv_pos, keys=keys,
                               quant=name == "paged_verify_quant",
                               scale_elt=q.element_size(), dtype=dtype)
            log(f"  {label} {dtype}: max|err| {err:.3g}, {ratio:.3g}x the "
                f"tolerance (a swapped page: {control:.3g}x); "
                f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA on "
                f"pre-gathered pages (library_ms) {lib_ms:.4f} ms, bound "
                f"{bms * 1e3:.2f} us ({by})")
            # the JSON row: each kernel at the shape it runs most often
            main_shape = label.startswith(("B1 T=1", "B4 T=1", "B2 S=256 "
                                           "kv_len=1024 window=None"))
            if dtype == "bfloat16" and main_shape:
                rows[name] = {"name": name, "route": "cuda",
                              "source": SOURCE, "replaces": REPLACES[name],
                              "launches": 0, "max_abs_err": err, "ms": ms,
                              "plain_ms": plain_ms, "bound_ms": bms,
                              "bound_by": by, "library_ms": lib_ms}
        del k32, v32, table
    return rows


# --------------------------------------------------------------------------- #
#  phases 3 and 4
# --------------------------------------------------------------------------- #

SERVE_ARGS = ["--arch", "qwen2.5-14b", "--batch", "8", "--ctx", "2048",
              "--page-tokens", "16", "--prefill-chunk", "256",
              "--prompt-len", "256", "--prompt-len-max", "1025",
              "--requests", "16", "--new-tokens", "32", "--seed", "0"]


def check_served(res) -> None:
    fin = res["finished"]
    if res["rejected"] or len(fin) != 16:
        raise AssertionError(f"{len(fin)} of 16 requests finished, "
                             f"{len(res['rejected'])} shed")
    want = {r.uid: r.max_new_tokens for r in res["requests"]}
    for f in fin:
        if len(f.tokens) != want[f.uid]:
            raise AssertionError(f"request {f.uid}: {len(f.tokens)} tokens"
                                 f", wanted {want[f.uid]}")


def serve_full(torch, ops, serve):
    """Phase 3: the main path at full width; returns launch counts.

    Every layer calls one kernel per prompt chunk and one per decode step.
    Float pages admit through B2 and decode through B1; int8 pages do both
    through B4. Each request runs to ``max_new`` (checked), so the schedule
    depends on lengths alone and the int8 run makes exactly the bf16 run's
    B1 + B2 launches, all of them B4."""
    ops.reset_launch_counts()
    deltas = {}
    for quant in (False, True):
        argv = SERVE_ARGS + ["--dtype", "bf16"]     # all 48 layers
        if quant:
            argv.append("--kv-quant-kernel")
        args = serve.parse_args(argv)
        t0 = time.perf_counter()
        cfg, params = serve.build_model(args)
        torch.cuda.synchronize()
        n = sum(p.numel() for p in params.parameters())
        log(f"  weights: {n / 1e9:.2f} B params in bf16 on the card, made "
            f"in {time.perf_counter() - t0:.1f} s")
        reqs = serve.make_requests(cfg, args)
        before = ops.launch_counts()
        res = serve.serve_paged(params, cfg, reqs, args)
        res["requests"] = reqs
        serve.report(res, args)
        check_served(res)
        after = ops.launch_counts()
        delta = {k: after[k] - before[k] for k in after}
        chunk = args.prefill_chunk
        chunks = cfg.n_layers * sum(-(-len(r.prompt) // chunk)
                                    for r in reqs)
        if quant:
            f = deltas[False]
            want = {"paged_verify": 0, "paged_prefill": 0,
                    "paged_verify_quant": f["paged_verify"]
                    + f["paged_prefill"]}
        else:
            want = {"paged_prefill": chunks, "paged_verify_quant": 0}
        for k, n in want.items():
            if delta[k] != n:
                raise AssertionError(
                    f"{'int8' if quant else 'bf16'} run: {k} launched "
                    f"{delta[k]} times, wanted {n} ({chunks} layer-chunks)")
        if not quant and delta["paged_verify"] < cfg.n_layers:
            raise AssertionError("bf16 run: paged_verify never launched")
        deltas[quant] = delta
        log(f"  launches in this run: {delta} ({chunks} layer-chunks)")
        del params, res
        gc.collect()
        torch.cuda.empty_cache()
    return ops.launch_counts()


LOGIT_REL = 2e-4      # the repo's logit bound (tests/test_torch_model.py)


def traced_paged_run(torch, params, cfg, reqs, args):
    """The paged engine as ``serve.serve_paged`` builds it, keeping the
    logits behind every greedy token by (uid, token index): the last
    chunk's last row for token 0, the decode step's row after that."""
    from repro_torch.runtime.kvcache import make_paged_engine

    B, bs = args.batch, args.page_tokens
    eng, kv = make_paged_engine(params, cfg, B, args.ctx,
                                n_pages=2 + B * (-(-args.ctx // bs)),
                                page_tokens=bs, cache_dtype=torch.float32,
                                prefill_chunk=args.prefill_chunk,
                                device=args.device)
    logits, admitting = {}, []
    admit, chunk_step, decode = eng.admit, eng.chunk_step, eng.decode

    def admit_(cache, tokens, uid, *a, **k):
        admitting.append(uid)
        return admit(cache, tokens, uid, *a, **k)

    def chunk_step_(*a, **k):
        out = chunk_step(*a, **k)
        logits[(admitting[-1], 0)] = out[0][0, -1].float().clone()
        return out

    def decode_(cache, tokens):
        out = decode(cache, tokens)
        for i in eng.active():
            st = eng.slots[i]
            key = (st.uid, len(st.generated))
            logits[key] = out[0][i, 0].float().clone()
        return out

    eng.admit, eng.chunk_step, eng.decode = admit_, chunk_step_, decode_
    fin, _ = eng.run(kv.init_cache(), reqs)
    check_served({"finished": fin, "rejected": eng.rejected,
                  "requests": reqs})
    return {f.uid: f.tokens for f in fin}, logits


def compare_runs(kern, plain):
    """Two traced runs, token by token. Up to each stream's first
    difference the contexts are equal, so the logits there measure the
    two paths' numerical agreement; a differing token ends the comparison
    of its stream. Returns (worst max|d|/max|ref|, streams equal,
    [(uid, token, top-2 gap / max|ref|, max|d|/max|ref| there)])."""
    (sk, lk), (sp, lp) = kern, plain
    worst, n_equal, splits = 0.0, 0, []
    for uid, toks in sp.items():
        n_equal += sk[uid] == toks
        for n, tok in enumerate(toks):
            a, b = lk[(uid, n)], lp[(uid, n)]
            top = float(b.abs().max())
            rel = float((a - b).abs().max()) / top
            worst = max(worst, rel)
            if sk[uid][n] != tok:
                splits.append((uid, n, float(b[tok] - b[sk[uid][n]]) / top,
                               rel))
                break
    return worst, n_equal, splits


@contextlib.contextmanager
def substituted(ops, mode, errs=None):
    """Phase-4 stand-ins for the kernel wrappers the model path calls.
    ``"shadow"``: each launch also runs the plain version on the same
    inputs, and ``errs`` keeps the largest max|d| by kernel. ``"plain"``:
    the model takes the card's route (kernels reported active) with each
    wrapper replaced by its plain version: one more plain run, summing in
    another order than ``use_kernels(False)``'s."""
    from repro_torch.kernels import paged_decode, paged_prefill

    saved = []
    for mod, name in ((paged_decode, "paged_verify"),
                      (paged_prefill, "paged_prefill"),
                      (paged_decode, "paged_verify_quant")):
        kern, ref = getattr(mod, name), getattr(mod, name + "_ref")

        def shadow(*a, kern=kern, ref=ref, name=name, **k):
            out = kern(*a, **k)
            d = float((out.float() - ref(*a, **k).float()).abs().max())
            errs[name] = max(errs.get(name, 0.0), d)
            return out

        saved.append((mod, name, kern))
        setattr(mod, name, shadow if mode == "shadow" else ref)
    active = ops.kernels_active
    if mode == "plain":
        ops.kernels_active = lambda t: True
    try:
        yield
    finally:
        ops.kernels_active = active
        for mod, name, kern in saved:
            setattr(mod, name, kern)


def parity(torch, ops, serve) -> None:
    """Phase 4, on a 4-layer full-width f32 copy: the paged engine
    (chunked, f32 and int8 pages) with kernels against
    ``use_kernels(False)``, and dense against paged.

    Every kernel launch of the kernel runs is held against its plain
    version on the same inputs (f32, atol 2e-5). With f32 pages the logits
    must then agree to LOGIT_REL and the streams be equal. With int8 pages
    the streams can split: a ~1e-7 difference moves a value across an int8
    rounding boundary when it is written to the pool, and the network
    carries that one-step change to the logits. Two plain versions that
    only sum in another order split the same way; that control is run and
    printed beside the kernel's numbers."""
    from repro_torch.models import init_cache
    from repro_torch.runtime.engine import make_dense_engine

    args = serve.parse_args(SERVE_ARGS + ["--dtype", "f32", "--layers",
                                          "4"])
    cfg, params = serve.build_model(args)
    reqs = serve.make_requests(cfg, args)
    streams = {}
    for quant in (False, True):
        c = dataclasses.replace(cfg, kv_dtype="int8") if quant else cfg
        label = f"{'int8' if quant else 'f32'} pages"
        errs = {}
        with substituted(ops, "shadow", errs):
            kern = traced_paged_run(torch, params, c, reqs, args)
        ops.use_kernels(False)
        try:
            plain = traced_paged_run(torch, params, c, reqs, args)
        finally:
            ops.use_kernels(True)
        streams[quant] = kern[0]
        want = ("paged_verify_quant",) if quant else ("paged_verify",
                                                      "paged_prefill")
        if sorted(errs) != sorted(want) or max(errs.values()) > 2e-5:
            raise AssertionError(f"{label}: kernel launches against their "
                                 f"plain versions on the same inputs: "
                                 f"max|d| {errs} (atol 2e-5, wanted "
                                 f"{want})")
        worst, n_equal, splits = compare_runs(kern, plain)
        log(f"  paged engine, {label}, chunked: every launch within "
            f"{max(errs.values()):.3g} of its plain version on the same "
            f"inputs {errs}; logits within {worst:.3g} of max|ref| of the "
            f"plain run up to each stream's first difference; streams "
            f"equal for {n_equal} of {len(reqs)} requests; splits (uid, "
            f"token, top-2 gap, logit difference there): {splits}")
        if not quant and (worst >= LOGIT_REL or n_equal != len(reqs)):
            raise AssertionError(f"{label}: kernel and plain-version runs "
                                 f"disagree (bound {LOGIT_REL}, streams "
                                 f"all equal)")
        if quant:
            with substituted(ops, "plain"):
                other = traced_paged_run(torch, params, c, reqs, args)
            worst, n_equal, splits = compare_runs(other, plain)
            log(f"  control, {label}: a second plain version against the "
                f"first: logits within {worst:.3g}; streams equal for "
                f"{n_equal} of {len(reqs)}; splits: {splits}")
        del kern, plain
    eng = make_dense_engine(params, cfg, args.batch, args.ctx,
                            cache_dtype=torch.float32, device=args.device)
    fin, _ = eng.run(init_cache(cfg, args.batch, args.ctx,
                                dtype=torch.float32, device=args.device),
                     reqs)
    dense = {f.uid: f.tokens for f in fin}
    if dense != streams[False]:
        bad = [u for u, t in dense.items() if streams[False].get(u) != t]
        raise AssertionError(f"dense engine tokens differ from the paged "
                             f"engine's for uids {bad}")
    log(f"  dense engine: tokens equal to the paged engine's for "
        f"{len(reqs)} requests")
    del params
    gc.collect()
    torch.cuda.empty_cache()


# --------------------------------------------------------------------------- #

def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's check needs the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import _build, ops
    from repro_torch.launch import serve

    t_start = time.perf_counter()
    log("== phase 0: device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    log(smi.splitlines()[0])
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    log("== phase 1: build")
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load()
    log(f"  {lib_path.name} ready in {time.perf_counter() - t0:.1f} s")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    log("== phase 2: kernels against their plain versions "
        f"(H {H}, h_kv {H_KV}, D {D}, pages of {BS})")
    rows = check_kernels(torch, Timer(torch), np.random.default_rng(0))
    log(f"  phase 2 done at {time.perf_counter() - t_start:.0f} s")

    log("== phase 3: serve qwen2.5-14b at full width, 48 layers, bf16")
    counts = serve_full(torch, ops, serve)
    log(f"  main-path launches: {counts}")
    log(f"  phase 3 done at {time.perf_counter() - t_start:.0f} s")

    log("== phase 4: token parity, 4 layers full width f32")
    parity(torch, ops, serve)
    log(f"  phase 4 done at {time.perf_counter() - t_start:.0f} s")

    for name, row in rows.items():
        row["launches"] = counts[name]
    print(json.dumps({"kernels": [rows[k] for k in REPLACES]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
