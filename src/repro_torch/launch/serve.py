"""Serving driver of the port: ``python -m repro_torch.launch.serve``.

Builds a dense GQA or ssm (``--arch mamba2-780m``) model with random
weights from ``--seed`` (``--smoke``: the reduced config) and serves
``RequestGenerator`` requests, printing TTFT, TPOT, tokens/s and the
kernel launch counts. Runs on the card unless ``--device cpu``.

Paged (the default for dense models): the paged continuous batcher
(``runtime.kvcache.make_paged_engine``), with the KV high-water mark;
``--check-dense`` also runs the dense-cache engine on the same requests and
exits nonzero on any token mismatch. An ssm model has no per-token pages:
it is served through the dense-cache engine
(``runtime.engine.make_dense_engine``), and the paged-only flags
(``--check-dense``, ``--prefill-chunk``, ``--kv-quant-kernel``) are an
argument error for it.

Streamed (``--stream-window W``, W > 0): the weights go to a layer store
in a temporary directory (packed q4 with ``--store-quant q4``, deleted at
exit) and the requests are served through the layer-wise engine
(``runtime.streaming.make_streaming_engine``) over a dense cache, with
``W`` layers staged ahead of the compute front; prints the store's
bytes per layer, the peak resident weight bytes, the prefetch stall and
the bytes read. ``--check-resident`` also serves the same requests with
the same (quantized) weights resident and exits nonzero on any token
mismatch.

Tiers (paged): ``--device-budget MB``, ``--host-budget MB`` and
``--park-idle-s S`` serve the same requests again, then their prompts once
more, through a paged engine whose every byte leases from one
``runtime.memory.TierManager`` (the pool sized from the device budget,
evicted prefix pages offloaded to host and spilled to page files in a
temporary directory, cost-model eviction; the repeats recall them) and
exit nonzero unless the tokens equal unbudgeted runs', the tier books
balance and every peak is within its budget; with ``--park-idle-s`` a
session's two turns, parked between them, must equal one uninterrupted
run. Faults, as in the JAX driver: ``--chaos transient`` (with
``--stream-window``) serves the streamed requests again from a store whose
layer reads fail ``--chaos-faults`` times and exits nonzero unless the
retried run's tokens equal the clean run's; ``--io-retries``,
``--io-backoff-ms`` and ``--io-deadline-s`` set the ``IOPolicy`` of every
store read and tier copy.

Observability, as in the JAX driver: ``--trace OUT.json`` attaches a
``runtime.telemetry.Tracer`` to the served engine (and the prefetcher)
and writes its Chrome trace (open it at https://ui.perfetto.dev) with the
per-step stall attribution; ``--metrics-out OUT.json`` collects serving
metrics in a ``runtime.metrics.MetricsRegistry`` and writes its snapshot
(check it with ``python -m repro_torch.runtime.metrics --validate
OUT.json``); ``--metrics-interval N`` prints a rolling line every N decode
steps. On the card every engine replays its fixed-shape decode steps from
CUDA graphs (see ``runtime.engine.StepGraphs``).
"""
from __future__ import annotations

import argparse
import dataclasses
import shutil
import sys
import tempfile
from typing import Dict, List, Optional

import numpy as np
import torch

from ..configs import get_config
from ..data import Request, RequestGenerator
from ..kernels import ops
from ..bridge import tree_from_params
from ..models import init_cache, init_params
from ..quant.grouped import tree_tensors
from ..runtime.engine import make_dense_engine
from ..runtime.faults import FaultInjector, FaultSpec, FaultyStore
from ..runtime.iopolicy import IOPolicy
from ..runtime.kvcache import make_paged_engine
from ..runtime.memory import MemoryBudget, TierManager
from ..runtime.metrics import MetricsRegistry, validate_metrics_snapshot
from ..runtime.paramstore import ParamStore, ResidentSource, save_param_store
from ..runtime.serve import quantize_ring_params
from ..runtime.streaming import StreamingParamSource, make_streaming_engine
from ..runtime.telemetry import Tracer, clock, format_summary

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2.5-14b")
    ap.add_argument("--smoke", action="store_true",
                    help="serve the reduced config (narrow widths)")
    ap.add_argument("--layers", type=int, default=0,
                    help="N>0: cut the depth to N layers (printed)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--requests", type=int, default=0,
                    help="requests to serve (default 2 x batch)")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--prompt-len-max", type=int, default=0,
                    help="prompt lengths are drawn from [prompt-len, "
                         "this) (default prompt-len + 8)")
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--ctx", type=int, default=64)
    ap.add_argument("--page-tokens", type=int, default=16)
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="N>0: chunked admission in N-token chunks")
    ap.add_argument("--kv-quant-kernel", action="store_true",
                    help="int8 KV pages (decode through the fused-dequant "
                         "kernel)")
    ap.add_argument("--dtype", choices=tuple(DTYPES), default="bf16")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--check-dense", action="store_true",
                    help="also run the dense-cache engine on the same "
                         "requests; exit nonzero on any token mismatch")
    ap.add_argument("--stream-window", type=int, default=0,
                    help="W>0: serve from a layer store in a temporary "
                         "directory through the layer-wise engine, W "
                         "layers staged ahead of the compute front")
    ap.add_argument("--store-quant", choices=("none", "q4"), default="none",
                    help="q4: the store holds the matmul weights as packed "
                         "int4 + bf16 group scales, run through kernel B3")
    ap.add_argument("--check-resident", action="store_true",
                    help="with --stream-window: also serve the same "
                         "requests with the same weights resident; exit "
                         "nonzero on any token mismatch")
    ap.add_argument("--chaos", choices=("none", "transient"),
                    default="none",
                    help="fault-injection smoke: 'transient' injects "
                         "retryable disk faults into the streamed "
                         "layer-wise decode and requires byte-identical "
                         "recovery (exits nonzero on a failed recovery); "
                         "needs --stream-window")
    ap.add_argument("--chaos-faults", type=int, default=3,
                    help="consecutive transient faults to inject "
                         "(capped at --io-retries: retries re-hit the "
                         "fault window)")
    ap.add_argument("--io-retries", type=int, default=3,
                    help="IOPolicy: max retries per I/O op before the "
                         "error is classified fatal")
    ap.add_argument("--io-backoff-ms", type=float, default=10.0,
                    help="IOPolicy: base exponential-backoff delay")
    ap.add_argument("--io-deadline-s", type=float, default=30.0,
                    help="IOPolicy: per-op deadline; a stalled read "
                         "surfaces as StallTimeout instead of hanging")
    ap.add_argument("--device-budget", type=float, default=0.0,
                    metavar="MB",
                    help="paged: cap device-tier KV bytes; the paged pool "
                         "sizes itself to the budget and the tier manager "
                         "audits that the high-water never exceeds it "
                         "(0 = unbounded)")
    ap.add_argument("--host-budget", type=float, default=0.0,
                    metavar="MB",
                    help="paged: cap host-tier bytes (offloaded + parked "
                         "pages); refusals spill the coldest pages to the "
                         "disk tier (0 = unbounded)")
    ap.add_argument("--park-idle-s", type=float, default=None,
                    metavar="S",
                    help="paged: enable session parking — finished "
                         "sessions keep their KV on host, demote to "
                         "per-session disk files after S idle seconds, "
                         "and restore byte-identically on the next admit; "
                         "runs a split-run parity check")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="capture a runtime trace (decode steps, admits, "
                         "prefill chunks, the prefetcher) and write "
                         "Chrome-trace JSON here; open it at "
                         "https://ui.perfetto.dev")
    ap.add_argument("--metrics-interval", type=int, default=0,
                    metavar="N",
                    help="print a rolling metrics line every N decode "
                         "steps: stall attribution (with --trace) and "
                         "request/step percentiles (with --metrics-out)")
    ap.add_argument("--metrics-out", default=None, metavar="OUT.json",
                    help="collect serving metrics (request lifecycle "
                         "percentiles, engine counters and gauges) and "
                         "write the JSON snapshot here; check it with "
                         "`python -m repro_torch.runtime.metrics "
                         "--validate OUT.json`")
    args = ap.parse_args(argv)
    if args.stream_window < 0:
        ap.error("--stream-window must be >= 0")
    if args.stream_window and (args.check_dense or args.prefill_chunk
                               or args.kv_quant_kernel):
        ap.error("--stream-window serves over a dense cache: it takes "
                 "neither --check-dense, --prefill-chunk nor "
                 "--kv-quant-kernel")
    if not args.stream_window and (args.check_resident
                                   or args.store_quant != "none"):
        ap.error("--check-resident and --store-quant need --stream-window")
    tiered = args.device_budget > 0 or args.host_budget > 0 \
        or args.park_idle_s is not None
    if get_config(args.arch).family == "ssm" and (
            args.check_dense or args.prefill_chunk or args.kv_quant_kernel
            or tiered):
        ap.error(f"{args.arch} keeps a recurrent state, not KV pages: it "
                 f"takes neither --check-dense, --prefill-chunk, "
                 f"--kv-quant-kernel nor the tier flags")
    if args.stream_window and tiered:
        ap.error("--device-budget, --host-budget and --park-idle-s tier a "
                 "paged cache: they do not take --stream-window")
    if args.chaos != "none" and not args.stream_window:
        ap.error("--chaos transient injects faults into the streamed "
                 "layer reads: it needs --stream-window")
    if args.device_budget < 0 or args.host_budget < 0:
        ap.error("budgets must be >= 0 MB")
    return args


def build_model(args: argparse.Namespace):
    """(cfg, params) for the flags: published widths (or reduced with
    ``--smoke``), the optional depth cut, random weights from the seed."""
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    if args.layers:
        print(f"depth cut: {args.layers} of {cfg.n_layers} layers")
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    if args.kv_quant_kernel:
        cfg = dataclasses.replace(cfg, kv_dtype="int8")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda but no CUDA device is available "
                         "(pass --device cpu to run the plain versions)")
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = init_params(cfg, gen, dtype=DTYPES[args.dtype], device=device)
    return cfg, params


def make_requests(cfg, args: argparse.Namespace) -> List:
    hi = args.prompt_len_max or args.prompt_len + 8
    gen = RequestGenerator(cfg.vocab, seed=7, prompt_len=(args.prompt_len,
                                                          hi),
                           max_new=args.new_tokens)
    return gen.generate(args.requests or 2 * args.batch)


def instruments(args: argparse.Namespace):
    """(tracer or None, registry or None) for ``--trace`` and
    ``--metrics-out``."""
    return (Tracer() if args.trace else None,
            MetricsRegistry() if args.metrics_out else None)


def _percentile_line(metrics) -> str:
    """One line of request/step percentiles for the console."""
    pcts = metrics.percentile_summary()
    parts = []
    for key, label in (("request/ttft_s", "ttft"),
                       ("request/tpot_s", "tpot"),
                       ("request/queue_wait_s", "queue"),
                       ("decode/step_s", "step")):
        if f"{key}/p50" in pcts:
            parts.append(f"{label} p50/p99 "
                         f"{pcts[f'{key}/p50'] * 1e3:.1f}/"
                         f"{pcts[f'{key}/p99'] * 1e3:.1f} ms")
    if "request/prefill_chunks/p50" in pcts:
        parts.append(f"prefill chunks p50/p99 "
                     f"{pcts['request/prefill_chunks/p50']:.0f}/"
                     f"{pcts['request/prefill_chunks/p99']:.0f}")
    stall = metrics.snapshot()["counters"].get("decode/interleave_stall_s")
    if stall:
        parts.append(f"interleave stall {stall * 1e3:.1f} ms")
    return "; ".join(parts)


def _ticking(eng, args: argparse.Namespace) -> None:
    """``--metrics-interval N``: after every N-th decode step of ``eng``,
    print the last N steps' stall attribution (with a tracer) and the
    request/step percentiles (with metrics)."""
    n = args.metrics_interval
    if n <= 0:
        return
    step, count = eng.step, [0]

    def step_(cache, tokens):
        out = step(cache, tokens)
        count[0] += 1
        if count[0] % n == 0:
            summ = eng.tracer.summary(last_n=n)
            if summ.get("n"):
                print(f"[step {count[0]}] {format_summary(summ)}")
            if eng.metrics is not None:
                line = _percentile_line(eng.metrics)
                if line:
                    print(f"[step {count[0]}] {line}")
        return out
    eng.step = step_


def export_instruments(tracer, metrics, args: argparse.Namespace) -> None:
    """Write ``--trace`` and ``--metrics-out`` and print their summaries."""
    if tracer is not None:
        tracer.export_chrome_trace(args.trace)
        summ = tracer.summary()
        if summ.get("n"):
            print("stall attribution:", format_summary(summ))
        print(f"trace: {len(tracer.events())} events on "
              f"{len(tracer.tracks())} tracks -> {args.trace} "
              f"(open at https://ui.perfetto.dev)")
    if metrics is not None:
        path = metrics.export_json(args.metrics_out)
        info = validate_metrics_snapshot(path)
        print(f"metrics: {info['counters']} counters, "
              f"{info['gauges']} gauges, {info['histograms']} "
              f"histograms -> {path}")
        print(_percentile_line(metrics) or "metrics: no samples yet")


def io_policy(args: argparse.Namespace) -> IOPolicy:
    """The ``IOPolicy`` of ``--io-retries``, ``--io-backoff-ms`` and
    ``--io-deadline-s`` (the JAX driver's ``_io_policy``)."""
    return IOPolicy(max_retries=args.io_retries,
                    backoff_base_s=args.io_backoff_ms / 1e3,
                    backoff_max_s=max(args.io_backoff_ms / 1e3, 0.1),
                    op_deadline_s=args.io_deadline_s,
                    get_timeout_s=2 * args.io_deadline_s)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve_paged(params, cfg, reqs, args: argparse.Namespace, *,
                tracer=None, metrics=None) -> Dict:
    """Serve ``reqs`` through the paged engine; returns the streams and
    what was measured (``engine``: the engine, for its graphs' counts)."""
    device = torch.device(args.device)
    B, ctx, bs = args.batch, args.ctx, args.page_tokens
    n_pages = 2 + B * (-(-ctx // bs))
    eng, kv = make_paged_engine(params, cfg, B, ctx, n_pages=n_pages,
                                page_tokens=bs,
                                cache_dtype=DTYPES[args.dtype],
                                prefill_chunk=args.prefill_chunk or None,
                                io_policy=io_policy(args), tracer=tracer,
                                metrics=metrics, device=device)
    _ticking(eng, args)
    cache = kv.init_cache()
    _sync(device)
    t0 = clock()
    try:
        fin, steps = eng.run(cache, reqs)
        _sync(device)
    finally:
        kv.close()
    wall = clock() - t0
    return {"finished": fin, "rejected": eng.rejected, "steps": steps,
            "wall_s": wall, "kv": kv.stats(), "engine": eng}


def serve_tiered(params, cfg, reqs, args: argparse.Namespace,
                 reference: Dict[int, List[int]]) -> Dict:
    """``--device-budget``/``--host-budget``/``--park-idle-s``: serve
    ``reqs`` again, then their prompts once more under new uids, with every
    byte leased from one ``TierManager`` (pool sized from the device
    budget, cost eviction, a disk tier in a temporary directory), and exit
    nonzero unless the tokens equal ``reference`` (the repeats: an
    unbudgeted run's of the same requests), the books balance and each
    tier's peak is within its budget. A device budget that cannot hold
    every prompt makes the repeats recall evicted pages from the host or
    the disk (the printed line counts them). With ``--park-idle-s``, a
    session's two turns parked between them must equal one uninterrupted
    run (the JAX driver's ``_tiered_smoke``). Returns the tier stats and
    the kv stats."""
    device = torch.device(args.device)
    B, ctx, bs = args.batch, args.ctx, args.page_tokens
    dtype = DTYPES[args.dtype]
    budget = MemoryBudget.from_mb(
        device=args.device_budget if args.device_budget > 0 else None,
        host=args.host_budget if args.host_budget > 0 else None)
    memory = TierManager(budget)
    full_pages = 2 + B * (-(-ctx // bs))
    ddir = tempfile.mkdtemp(prefix="kvdisk_")
    common = dict(page_tokens=bs, cache_dtype=dtype, io_policy=io_policy(args),
                  prefill_chunk=args.prefill_chunk or None, device=device)
    base = max(r.uid for r in reqs) + 1
    again = [Request(base + i, r.prompt, r.max_new_tokens, 0.0)
             for i, r in enumerate(reqs)]
    try:
        eng_r, kv_r = make_paged_engine(params, cfg, B, ctx,
                                        n_pages=full_pages, **common)
        try:
            fin_r, _ = eng_r.run(kv_r.init_cache(), list(reqs) + again)
        finally:
            kv_r.close()
        want = dict(reference)
        want.update((f.uid, f.tokens) for f in fin_r if f.uid >= base)
        eng, kv = make_paged_engine(
            params, cfg, B, ctx,
            n_pages=None if budget.device is not None else full_pages,
            memory=memory, evict_policy="cost", disk_dir=ddir,
            park_idle_s=args.park_idle_s, **common)
        try:
            fin, _ = eng.run(kv.init_cache(), list(reqs) + again)
            _sync(device)
        finally:
            kv.close()
        st = kv.stats()
        tiered = {f.uid: f.tokens for f in fin}
        bad = [u for u in tiered if want.get(u) != tiered[u]]
        if bad:
            raise SystemExit(f"tiered paged-kv parity FAILED for {bad}")
        stats = memory.stats()
        memory.audit()
        for tier in ("device", "host"):
            s = stats[tier]
            if s.capacity is not None and s.peak > s.capacity:
                raise SystemExit(f"tiered: {tier} high-water {s.peak} > "
                                 f"budget {s.capacity}")
        cap = "unbounded" if budget.device is None \
            else f"{budget.device / 1e6:.3f} MB"
        print(f"tiered paged decode: {len(tiered)} reqs byte-identical "
              f"({len(eng.rejected)} shed by budget); pool "
              f"{st.n_pages} pages; device peak "
              f"{stats['device'].peak / 1e6:.3f} MB / {cap}, host peak "
              f"{stats['host'].peak / 1e6:.3f} MB, disk peak "
              f"{stats['disk'].peak / 1e6:.3f} MB; refusals "
              f"{stats['host'].refusals}; evictions {st.evictions}, "
              f"offloaded {st.offloaded_bytes / 1e6:.3f} MB, spilled "
              f"{st.spilled_pages} pages, fetched "
              f"{st.fetched_bytes / 1e6:.3f} MB "
              f"({len(st.fetch_events) - st.fetched_disk_pages} pages from "
              f"host, {st.fetched_disk_pages} from disk)")
        out = {"tiers": stats, "kv": st}
        if args.park_idle_s is not None:
            sid, half = "smoke-session", args.new_tokens
            prompt = reqs[0].prompt
            eng_f, kv_f = make_paged_engine(params, cfg, B, ctx,
                                            n_pages=full_pages, **common)
            try:
                full, _ = eng_f.run(kv_f.init_cache(),
                                    [Request(900, prompt, 2 * half, 0.0)])
            finally:
                kv_f.close()
            eng_s, kv_s = make_paged_engine(
                params, cfg, B, ctx, n_pages=full_pages, disk_dir=ddir,
                park_idle_s=args.park_idle_s, **common)
            try:
                cache = kv_s.init_cache()
                f1, _ = eng_s.run(cache, [Request(901, prompt, half, 0.0,
                                                  sid)])
                if not kv_s.is_parked(sid):
                    raise SystemExit("session never parked at finish")
                f2, _ = eng_s.run(cache, [Request(902, prompt, half, 0.0,
                                                  sid)])
            finally:
                kv_s.close()
            got = f1[0].tokens + [f for f in f2 if f.uid == 902][0].tokens
            ref = full[0].tokens
            if got != ref:
                raise SystemExit(f"park/restore parity FAILED: {got} != "
                                 f"{ref}")
            ss = kv_s.stats()
            print(f"session parking: split run byte-identical to one "
                  f"uninterrupted run ({len(ref)} tokens); parked "
                  f"{ss.parked_sessions}, restored {ss.restored_sessions}, "
                  f"disk written {ss.disk_bytes_written / 1e6:.3f} MB")
            out["session"] = ss
    finally:
        shutil.rmtree(ddir, ignore_errors=True)
    return out


def serve_dense(params, cfg, reqs, args: argparse.Namespace, *,
                tracer=None, metrics=None) -> Dict:
    """Serve ``reqs`` through the dense-cache engine (the ssm family's
    resident path); returns the streams and what was measured."""
    device = torch.device(args.device)
    dtype = DTYPES[args.dtype]
    eng = make_dense_engine(params, cfg, args.batch, args.ctx,
                            cache_dtype=dtype, tracer=tracer,
                            metrics=metrics, device=device)
    _ticking(eng, args)
    cache = init_cache(cfg, args.batch, args.ctx, dtype=dtype, device=device)
    _sync(device)
    t0 = clock()
    fin, steps = eng.run(cache, reqs)
    _sync(device)
    wall = clock() - t0
    summ = _p50_summary(fin, wall)
    print(f"dense-cache serve on {args.device} ({args.dtype}): "
          f"{len(fin)} requests through {args.batch} slots, "
          f"{sum(len(f.tokens) for f in fin)} tokens in {wall:.3f} s "
          f"({steps} steps)")
    print(f"  TTFT p50 {summ['ttft_p50_s'] * 1e3:.2f} ms, TPOT p50 "
          f"{summ['tpot_p50_s'] * 1e3:.2f} ms, {summ['tokens_per_s']:.1f} "
          f"tokens/s")
    print(f"  kernel launches {ops.launch_counts()}")
    return {"finished": fin, "rejected": eng.rejected, "steps": steps,
            "wall_s": wall, "summary": summ}


def _p50_summary(fin, wall_s: float) -> Dict[str, float]:
    tpots = [f.tpot_s for f in fin if len(f.tokens) > 1]
    return {"requests": len(fin),
            "ttft_p50_s": float(np.median([f.ttft_s for f in fin])),
            "tpot_p50_s": float(np.median(tpots)) if tpots else 0.0,
            "tokens_per_s": sum(len(f.tokens) for f in fin) / wall_s}


def report(res: Dict, args: argparse.Namespace) -> Dict[str, float]:
    fin = res["finished"]
    n_tok = sum(len(f.tokens) for f in fin)
    st = res["kv"]
    out = dict(_p50_summary(fin, res["wall_s"]),
               kv_highwater_bytes=st.highwater_bytes)
    mode = ["int8 KV pages"] if args.kv_quant_kernel else []
    if args.prefill_chunk:
        mode.append(f"chunked prefill ({args.prefill_chunk} tokens)")
    print(f"paged serve on {args.device} ({args.dtype}"
          f"{', ' + ', '.join(mode) if mode else ''}): {len(fin)} requests "
          f"through {args.batch} slots, {n_tok} tokens in "
          f"{res['wall_s']:.3f} s ({res['steps']} steps)")
    print(f"  TTFT p50 {out['ttft_p50_s'] * 1e3:.2f} ms, TPOT p50 "
          f"{out['tpot_p50_s'] * 1e3:.2f} ms, {out['tokens_per_s']:.1f} "
          f"tokens/s")
    print(f"  KV high-water {st.highwater_bytes / 1e6:.2f} MB vs dense "
          f"envelope {st.dense_bytes(args.batch, args.ctx) / 1e6:.2f} MB; "
          f"prefix hits {st.prefix_hits}, CoW {st.cow_copies}")
    print(f"  kernel launches {ops.launch_counts()}")
    return out


def store_tree(params, cfg, args: argparse.Namespace):
    """(the model as a stacked tree for the store, its unquantized block
    bytes per layer): packed q4 (every matmul weight,
    ``quantize_ring_params`` at tp=1) with ``--store-quant q4``."""
    tree = tree_from_params(params)
    raw = sum(t.numel() * t.element_size()
              for t in tree_tensors(tree["blocks"])) // cfg.n_layers
    if args.store_quant == "q4":
        tree, skipped = quantize_ring_params(tree, cfg, tp=1)
        if skipped:
            print(f"store-quant q4: {len(skipped)} leaves left "
                  f"unquantized: {', '.join(skipped)}")
    return tree, raw


def serve_layerwise(source, cfg, reqs, args: argparse.Namespace, *,
                    tracer=None, metrics=None) -> Dict:
    """Serve ``reqs`` through the layer-wise engine over ``source`` on a
    dense cache; returns the streams and what was measured."""
    device = torch.device(args.device)
    dtype = DTYPES[args.dtype]
    eng = make_streaming_engine(source, cfg, args.batch, args.ctx,
                                cache_dtype=dtype, tracer=tracer,
                                metrics=metrics, device=device)
    _ticking(eng, args)
    cache = init_cache(cfg, args.batch, args.ctx, dtype=dtype, device=device)
    _sync(device)
    t0 = clock()
    fin, steps = eng.run(cache, reqs)
    _sync(device)
    wall = clock() - t0
    return {"finished": fin, "rejected": eng.rejected, "steps": steps,
            "wall_s": wall, "stats": eng.streaming_stats(),
            "summary": _p50_summary(fin, wall)}


def serve_streamed(params, cfg, reqs, args: argparse.Namespace, *,
                   tracer=None, metrics=None) -> Dict:
    """Write the store, serve from it with ``--stream-window`` layers
    staged ahead, and (``--check-resident``) serve again resident; the
    instruments see the streamed run."""
    W = args.stream_window
    tree, raw = store_tree(params, cfg, args)
    sdir = tempfile.mkdtemp(prefix="paramstore_")
    try:
        save_param_store(tree, cfg, sdir)
        store = ParamStore(sdir)
        total = store.layer_nbytes * cfg.n_layers
        print(f"store: {store.quant_format or 'unquantized'} manifest "
              f"v{store.version}, {store.layer_nbytes / 1e6:.3f} MB/layer "
              f"packed vs {raw / 1e6:.3f} MB/layer unquantized "
              f"({store.layer_nbytes / raw:.3f}x)")
        with StreamingParamSource(store, window=W, device=args.device,
                                  policy=io_policy(args),
                                  tracer=tracer) as src:
            res = serve_layerwise(src, cfg, reqs, args, tracer=tracer,
                                  metrics=metrics)
        st, summ = res["stats"], res["summary"]
        print(f"streamed serve on {args.device} ({args.dtype}, window "
              f"{W}/{cfg.n_layers} layers): {summ['requests']} requests "
              f"through {args.batch} slots in {res['wall_s']:.3f} s "
              f"({res['steps']} steps)")
        print(f"  TTFT p50 {summ['ttft_p50_s'] * 1e3:.2f} ms, TPOT p50 "
              f"{summ['tpot_p50_s'] * 1e3:.2f} ms, "
              f"{summ['tokens_per_s']:.1f} tokens/s")
        print(f"  peak resident weights {st.peak_resident_bytes / 1e6:.3f} "
              f"MB of {total / 1e6:.3f} MB in the store; prefetch stall "
              f"{st.stall_s * 1e3:.1f} ms; {st.total_bytes_read / 1e6:.3f} "
              f"MB read in {len(st.events)} layer reads")
        print(f"  kernel launches {ops.launch_counts()}")
        res["store_layer_nbytes"] = store.layer_nbytes
        if args.check_resident:
            fin_r = serve_layerwise(ResidentSource(tree), cfg, reqs,
                                    args)["finished"]
            resident = {f.uid: f.tokens for f in fin_r}
            streamed = {f.uid: f.tokens for f in res["finished"]}
            if resident != streamed:
                bad = [u for u in resident if resident[u] != streamed.get(u)]
                raise SystemExit(f"streamed vs resident parity FAILED for "
                                 f"uids {bad}")
            print(f"  resident weights: tokens identical for "
                  f"{len(resident)} requests")
        if args.chaos == "transient":
            res["chaos"] = serve_chaos(sdir, cfg, reqs, args, res)
    finally:
        shutil.rmtree(sdir, ignore_errors=True)
    return res


def serve_chaos(sdir: str, cfg, reqs, args: argparse.Namespace,
                clean: Dict) -> Dict:
    """``--chaos transient``: serve ``reqs`` again from the store at
    ``sdir`` with ``--chaos-faults`` (at most ``--io-retries``)
    consecutive layer-read faults injected after the 4th read, and exit
    nonzero unless the tokens equal the ``clean`` run's (the JAX driver's
    ``_chaos_smoke``). Returns the fired faults and the prefetch stats."""
    policy = io_policy(args)
    n = min(args.chaos_faults, policy.max_retries)
    inj = FaultInjector([FaultSpec(op="layer_read", after=4, times=n)])
    with StreamingParamSource(FaultyStore(ParamStore(sdir), inj),
                              window=args.stream_window, device=args.device,
                              policy=policy) as src:
        res = serve_layerwise(src, cfg, reqs, args)
    want = {f.uid: f.tokens for f in clean["finished"]}
    got = {f.uid: f.tokens for f in res["finished"]}
    if got != want:
        bad = [u for u in want if want[u] != got.get(u)]
        raise SystemExit(f"chaos transient: tokens DIVERGED after retry "
                         f"recovery for uids {bad}")
    st = res["stats"]
    print(f"chaos transient: {len(inj.fired)} injected disk faults "
          f"absorbed by retry/backoff ({st.retries} retries in "
          f"PrefetchStats); tokens byte-identical to the clean run")
    return {"fired": list(inj.fired), "stats": st}


def main(argv: Optional[List[str]] = None) -> Dict:
    args = parse_args(argv)
    cfg, params = build_model(args)
    reqs = make_requests(cfg, args)
    tracer, metrics = instruments(args)
    if args.stream_window:
        res = serve_streamed(params, cfg, reqs, args, tracer=tracer,
                             metrics=metrics)
    elif cfg.family == "ssm":
        res = serve_dense(params, cfg, reqs, args, tracer=tracer,
                          metrics=metrics)
    else:
        res = serve_paged(params, cfg, reqs, args, tracer=tracer,
                          metrics=metrics)
        res["summary"] = report(res, args)
    export_instruments(tracer, metrics, args)
    if res["rejected"]:
        raise SystemExit(f"{len(res['rejected'])} requests shed: "
                         f"{res['rejected'][0].reason}")
    if args.check_dense:
        device = torch.device(args.device)
        eng = make_dense_engine(params, cfg, args.batch, args.ctx,
                                cache_dtype=DTYPES[args.dtype],
                                device=device)
        fin_d, _ = eng.run(init_cache(cfg, args.batch, args.ctx,
                                      dtype=DTYPES[args.dtype],
                                      device=device), reqs)
        dense = {f.uid: f.tokens for f in fin_d}
        paged = {f.uid: f.tokens for f in res["finished"]}
        if dense != paged:
            bad = [u for u in dense if dense[u] != paged.get(u)]
            raise SystemExit(f"paged vs dense parity FAILED for uids {bad}")
        print(f"  dense engine: tokens identical for {len(dense)} "
              f"requests; kernel launches {ops.launch_counts()}")
    if args.device_budget > 0 or args.host_budget > 0 \
            or args.park_idle_s is not None:
        res["tiered"] = serve_tiered(
            params, cfg, reqs, args,
            {f.uid: f.tokens for f in res["finished"]})
    return res


if __name__ == "__main__":
    main(sys.argv[1:])
