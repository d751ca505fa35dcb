"""Serving driver of the port: ``python -m repro_torch.launch.serve``.

The JAX driver's structure and flags (``repro.launch.serve``), on the card
unless ``--device cpu``. A model of ``--arch`` (``--smoke``: the reduced
config, with f32 weights and cache unless ``--dtype``) with random weights
from ``--seed`` (``run`` also takes weights handed in), then in order:

decode: ``--batch`` prompts of ``--prompt-len`` tokens (``RequestGenerator``
  seed 1) prefill on the one-device path, then ``--new-tokens`` greedy steps
  decode through the piped ring of ``--stages`` stages (default 4;
  ``--ring-k`` rounds) across ``--stages x --tp`` rank processes (default 4
  x 2, the JAX driver's (4, 2) mesh: ``launch.mesh.RankWorld``, gloo, all on
  ``--device``), each holding its stage's rows, its tensor-parallel slice
  (sequence-split KV, split FFN, vocab-sharded head) and reading only its
  part of a layer store written to a temporary directory; beside it the
  one-device decode of the same cache (a token mismatch exits nonzero;
  bf16 on the card allows near-tie splits only; a rank that fails, dies or
  outlasts ``launch.mesh.RANK_TIMEOUT_S`` exits nonzero). ``--verify-tokens T`` also
  times a T-token verify pass on the ranks. Where ``ring_supported`` says
  no (the hybrid and audio families; a batch the stages do not split,
  batch 1 included) the steps decode through the GSPMD layer across the
  same ranks (``runtime.gspmd.rank_gspmd_job``: each rank holds its FSDP
  part of every weight and its part of the cache, as the JAX driver's
  ``gspmd_decode_step`` shards them), checked against the one-device
  decode as the ring is; only ``--stages 1`` decodes on one device.
  ``--mesh prod`` is the JAX driver's 16 stages x tp 16. ``--tp`` also
  picks the q4 groups of the store (``quantize_ring_params``) and pads the
  vocab.

stream (``--stream-window W``): the weights go to a layer store in a
  temporary directory (packed q4 with ``--store-quant q4``); the batch
  decodes layer by layer from it after a resident prefill, ``W`` layers
  staged ahead; on the ring, across the decode section's rank processes
  (the same world), the streamed ring (``runtime.serve.rank_stream_job``:
  each rank stages only its stage's windows and its part of each leaf
  from the store) decodes beside the resident ring over the same store
  (``rank_ring_job``; a token mismatch, or ranks that took different
  tokens, exit nonzero); then the
  requests below are served through the layer-wise engine
  (``runtime.streaming.make_streaming_engine``) over a dense cache, and
  ``--check-resident`` serves them again with the stored weights resident
  (a mismatch exits nonzero).

paged (``--paged-kv``; implied by ``--check-dense``, ``--prefill-chunk``,
  ``--kv-quant-kernel`` and the tier flags): ``--requests`` (default 2 x
  batch) ``RequestGenerator`` requests (seed 7, prompts of ``--prompt-len``
  to ``--prompt-len-max`` tokens) through the paged continuous batcher
  (``runtime.kvcache.make_paged_engine``; pages of ``--page-tokens``,
  chunked admission with ``--prefill-chunk``, int8 pages with
  ``--kv-quant-kernel``), then through the dense-cache engine, and exits
  nonzero on any token mismatch (int8 pages with chunked admission are not
  compared: they never match the dense engine, in either package). An ssm
  model has no per-token pages: it is served through the dense-cache engine
  (``runtime.engine.make_dense_engine``), and the paged-only flags are an
  argument error for it. Tiers: ``--device-budget MB``, ``--host-budget
  MB`` and ``--park-idle-s S`` serve the same requests again, then their
  prompts once more, through a paged engine whose every byte leases from
  one ``runtime.memory.TierManager`` (the pool sized from the device
  budget, evicted prefix pages offloaded to host and spilled to page files
  in a temporary directory, cost-model eviction; the repeats recall them)
  and exit nonzero unless the tokens equal unbudgeted runs', the tier books
  balance and every peak is within its budget; with ``--park-idle-s`` a
  session's two turns, parked between them, must equal one uninterrupted
  run.

chaos: ``--chaos transient`` decodes the batch again from the store (the
  stream section's, or one of its own at window 2) whose layer reads fail
  ``--chaos-faults`` times and exits nonzero unless the retried run's
  tokens equal the clean run's; ``--chaos failover`` serves the ring
  prompts through ``runtime.failover.ElasticRingServer`` across the
  decode section's ``--stages x --tp`` rank processes, SIGKILLs stage
  1's first rank as the third token's pass starts, and exits nonzero
  unless the death is attributed to stage 1 (the output names the rank),
  no token is lost and the tokens after recovery (the re-plan, the
  survivors re-spawned as a smaller world that replays the history) equal
  a clean run on that survivor world fed the same history; ``--chaos
  rank`` makes the last rank of the decode section (the ring's or the
  GSPMD layer's) raise at its second step, and the run exits
  nonzero. ``--io-retries``,
  ``--io-backoff-ms`` and ``--io-deadline-s`` set the ``IOPolicy`` of every
  store read and tier copy.

Families, as in the JAX driver: MLA (``minicpm3-4b``) and vlm
(``qwen2-vl-2b``) run every section (MLA refuses int8 pages:
``--kv-quant-kernel`` skips its paged section with the JAX driver's
message); the hybrid family (``recurrentgemma-9b``) decodes through the
GSPMD layer across ranks and skips the stream, paged and chaos sections
(no store and no pages for its recurrent state); ``--arch whisper-tiny``
is an argument error: its prefill needs audio frames, which neither
driver makes.

Observability, as in the JAX driver: ``--trace OUT.json`` attaches a
``runtime.telemetry.Tracer`` to the decode steps and the served engines
(and the prefetcher) and writes its Chrome trace (open it at
https://ui.perfetto.dev) with the per-step stall attribution;
``--metrics-out OUT.json`` collects serving metrics in a
``runtime.metrics.MetricsRegistry`` and writes its snapshot (check it with
``python -m repro_torch.runtime.metrics --validate OUT.json``);
``--metrics-interval N`` prints a rolling line every N decode steps. On the
card every engine replays its fixed-shape decode steps from CUDA graphs
(see ``runtime.engine.StepGraphs``). Prints the kernel launch counts.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import shutil
import sys
import tempfile
from typing import Callable, Dict, List, Optional, Tuple

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
from ..runtime.paramstore import (STACKED_FAMILIES, ParamStore, ResidentSource,
                                  save_param_store)
from ..runtime.serve import (RingPlan, pad_and_permute,
                             quantize_ring_params, ring_supported)
from ..runtime.streaming import StreamingParamSource, make_streaming_engine
from ..runtime.telemetry import Tracer, clock, format_summary, resolve_tracer

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
    ap.add_argument("--page-tokens", type=int, default=8)
    ap.add_argument("--paged-kv", action="store_true",
                    help="serve the requests through the paged engine and "
                         "then the dense-cache engine; exit nonzero on any "
                         "token mismatch")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="paged: chunked admission in N-token chunks")
    ap.add_argument("--kv-quant-kernel", action="store_true",
                    help="paged: int8 KV pages (decode through the "
                         "fused-dequant kernel)")
    ap.add_argument("--dtype", choices=tuple(DTYPES), default=None,
                    help="weights and caches (default f32 with --smoke, "
                         "as the JAX driver's, else bf16)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--check-dense", action="store_true",
                    help="the paged section with its dense-engine check "
                         "(what --paged-kv runs)")
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
    ap.add_argument("--stages", type=int, default=4,
                    help="M>1: decode through the piped ring of M stages, "
                         "one rank process a stage and tensor-parallel "
                         "member (1: on one device)")
    ap.add_argument("--ring-k", type=int, default=1,
                    help="with --stages: rounds per token (windows a "
                         "stage holds)")
    ap.add_argument("--verify-tokens", type=int, default=0,
                    help="with --stages, T>1: also time a T-token "
                         "speculative verify pass through the ring against "
                         "T single steps")
    ap.add_argument("--tp", type=int, default=2,
                    help="the ring's tensor-parallel width: the decode "
                         "section's stages each run as this many ranks "
                         "(sequence-split KV, split FFN, vocab-sharded "
                         "head); it also picks the store's q4 groups and "
                         "the vocab padding")
    ap.add_argument("--mesh", choices=("debug", "prod"), default="debug",
                    help="the JAX driver's mesh: debug is (--stages, --tp) "
                         "ranks; prod is 16 stages x tp 16, the production "
                         "mesh (256 rank processes)")
    ap.add_argument("--chaos", choices=("none", "transient", "failover",
                                        "rank"),
                    default="none",
                    help="fault-injection smoke: 'transient' injects "
                         "retryable disk faults into the streamed "
                         "layer-wise decode and requires byte-identical "
                         "recovery; 'failover' kills a ring stage "
                         "mid-decode and requires the elastic re-plan to "
                         "resume with zero tokens lost (both exit nonzero "
                         "on a failed recovery); 'rank' makes the last "
                         "rank of the decode section's ring across ranks "
                         "raise at its second step (the driver must exit "
                         "nonzero, not hang)")
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
    if args.dtype is None:
        args.dtype = "f32" if args.smoke else "bf16"
    if args.stream_window < 0:
        ap.error("--stream-window must be >= 0")
    if args.stream_window and (args.check_dense or args.prefill_chunk
                               or args.kv_quant_kernel):
        ap.error("--stream-window serves over a dense cache: it takes "
                 "neither --check-dense, --prefill-chunk nor "
                 "--kv-quant-kernel")
    if not args.stream_window and args.check_resident:
        ap.error("--check-resident needs --stream-window")
    if args.store_quant != "none" and not (
            args.stream_window or args.chaos in ("transient", "failover")):
        ap.error("--store-quant needs a store: --stream-window or --chaos")
    tiered = args.device_budget > 0 or args.host_budget > 0 \
        or args.park_idle_s is not None
    if get_config(args.arch).family == "audio":
        ap.error(f"{args.arch} is an encoder-decoder: its prefill needs "
                 f"audio frames, which this driver (as the JAX driver) "
                 f"does not make; drive it through models.prefill(..., "
                 f"embeds=frames) and models.decode_step")
    if get_config(args.arch).family == "ssm" and (
            args.check_dense or args.prefill_chunk or args.kv_quant_kernel
            or tiered):
        ap.error(f"{args.arch} keeps a recurrent state, not KV pages: it "
                 f"takes neither --check-dense, --prefill-chunk, "
                 f"--kv-quant-kernel nor the tier flags")
    if args.stream_window and tiered:
        ap.error("--device-budget, --host-budget and --park-idle-s tier a "
                 "paged cache: they do not take --stream-window")
    # the paged-only flags ask for the paged section, as --paged-kv does
    args.paged_kv = bool(args.paged_kv or args.check_dense
                         or args.prefill_chunk or args.kv_quant_kernel
                         or tiered)
    if args.mesh == "prod":
        args.stages, args.tp = 16, 16
    if args.stages < 1 or args.ring_k < 1 or args.tp < 1:
        ap.error("--stages, --ring-k and --tp must be >= 1")
    if args.chaos == "rank" and args.stages < 2:
        ap.error("--chaos rank fails a rank of the decode section across "
                 "ranks: it needs --stages > 1")
    if args.device_budget < 0 or args.host_budget < 0:
        ap.error("budgets must be >= 0 MB")
    return args


def build_model(args: argparse.Namespace, params=None):
    """(cfg, params) for the flags: published widths (or reduced with
    ``--smoke``), the optional depth cut, int8 KV with
    ``--kv-quant-kernel``, random weights from the seed (or ``params``, a
    ``DenseModel`` handed in, used as it is)."""
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
    if params is not None:
        return cfg, params
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
    bytes per layer): packed q4 (every matmul weight, expert stacks and a
    router included, ``quantize_ring_params`` at ``--tp``, as the JAX
    driver picks the groups) with ``--store-quant q4``."""
    tree = tree_from_params(params)
    raw = sum(t.numel() * t.element_size()
              for t in tree_tensors(tree["blocks"])) // cfg.n_layers
    if args.store_quant == "q4":
        tree, skipped = quantize_ring_params(tree, cfg, tp=args.tp)
        if skipped:
            print(f"store-quant q4: {len(skipped)} leaves left "
                  f"unquantized: {', '.join(skipped)}")
    return tree, raw


def write_store(params, cfg, args: argparse.Namespace):
    """Write ``store_tree``'s tree to a new temporary directory; returns
    (the directory, the tree, the store's bytes per layer)."""
    tree, raw = store_tree(params, cfg, args)
    sdir = tempfile.mkdtemp(prefix="paramstore_")
    save_param_store(tree, cfg, sdir)
    with ParamStore(sdir) as store:
        print(f"store: {store.quant_format or 'unquantized'} manifest "
              f"v{store.version}, {store.layer_nbytes / 1e6:.3f} MB/layer "
              f"packed vs {raw / 1e6:.3f} MB/layer unquantized "
              f"({store.layer_nbytes / raw:.3f}x)")
        return sdir, tree, store.layer_nbytes


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


def serve_streamed(sdir: str, tree, cfg, reqs, args: argparse.Namespace, *,
                   tracer=None, metrics=None) -> Dict:
    """Serve ``reqs`` from the store at ``sdir`` with ``--stream-window``
    layers staged ahead and (``--check-resident``) again with ``tree``, the
    stored weights, resident; the instruments see the streamed run."""
    W = args.stream_window
    with StreamingParamSource(ParamStore(sdir), window=W,
                              device=args.device, policy=io_policy(args),
                              tracer=tracer) as src:
        total = src.store.layer_nbytes * cfg.n_layers
        res = serve_layerwise(src, cfg, reqs, args, tracer=tracer,
                              metrics=metrics)
        res["store_layer_nbytes"] = src.store.layer_nbytes
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
    return res


def layerwise_decode(source, params, cfg, args: argparse.Namespace, *,
                     tracer=None) -> Dict:
    """The JAX driver's streamed decode of the batch: the prompts prefill
    with the resident weights ``params``, then ``--new-tokens`` greedy
    steps pull every layer from ``source``. Returns the tokens (B,
    new_tokens + 1), the first one from the prefill, and the step
    seconds."""
    from ..models import model as M

    device = torch.device(args.device)
    prompts = ring_prompts(cfg, args)
    cache = init_cache(cfg, args.batch, args.ctx, dtype=DTYPES[args.dtype],
                       device=device)
    logits, cache = M.prefill(params, cfg, prompts, cache)
    nxt = logits[:, -1:].argmax(-1).to(torch.int32)

    def step(c, t):
        return M.decode_step_layerwise(source, cfg, c, t)
    run = greedy_steps(step, cache, nxt, args.new_tokens, device,
                       tracer=tracer)
    return {"tokens": np.concatenate([nxt.cpu().numpy(),
                                      run["tokens"][:, :, 0]], 1),
            "step_s": run["step_s"]}


def serve_stream(params, cfg, args: argparse.Namespace, world, *,
                 tracer=None, metrics=None) -> Dict:
    """``--stream-window W``: write the store, decode the batch layer by
    layer from it (``layerwise_decode``, the JAX driver's
    ``_stream_smoke``), on the ring also ``stream_ring`` across
    ``world``'s ranks, then serve the requests through the layer-wise
    engine (``serve_streamed``)."""
    W = args.stream_window
    sdir, tree, layer_nbytes = write_store(params, cfg, args)
    try:
        with StreamingParamSource(ParamStore(sdir), window=W,
                                  device=args.device, policy=io_policy(args),
                                  tracer=tracer) as src:
            dec = layerwise_decode(src, params, cfg, args, tracer=tracer)
            st = src.stats()
        per_tok = float(np.median(dec["step_s"]))
        print(f"streamed decode (window={W}/{cfg.n_layers} layers, "
              f"store={args.store_quant}): {args.new_tokens} tokens x "
              f"{args.batch} seqs -> {per_tok * 1e3:.1f} ms/token/batch "
              f"(median step); peak resident "
              f"{st.peak_resident_bytes / 1e6:.3f} MB of "
              f"{layer_nbytes * cfg.n_layers / 1e6:.3f} MB weights; prefetch "
              f"stall {st.stall_s * 1e3:.1f} ms")
        out = {"tokens": dec["tokens"], "step_s": dec["step_s"],
               "decode_stats": st, "ring": None}
        if args.stages > 1 and ring_supported(cfg, args.batch, args.stages):
            out["ring"] = stream_ring(sdir, tree, cfg, args, world)
        out.update(serve_streamed(sdir, tree, cfg, make_requests(cfg, args),
                                  args, tracer=tracer, metrics=metrics))
    finally:
        shutil.rmtree(sdir, ignore_errors=True)
    return out


def serve_chaos(params, cfg, args: argparse.Namespace) -> Dict:
    """``--chaos transient``: decode the batch layer by layer
    (``layerwise_decode``) from a store of its own (``store_tree``) at
    window ``--stream-window`` (2 without it), then again from the same
    store with ``--chaos-faults`` (at most ``--io-retries``) consecutive
    layer-read faults injected after the 4th read, and exit nonzero unless
    the tokens are equal (the JAX driver's ``_chaos_smoke``). Returns the
    fired faults, the prefetch stats and the tokens."""
    window = args.stream_window or 2
    policy = io_policy(args)
    sdir, _, _ = write_store(params, cfg, args)
    try:
        def decode(store):
            with StreamingParamSource(store, window=window,
                                      device=args.device,
                                      policy=policy) as src:
                return (layerwise_decode(src, params, cfg, args)["tokens"],
                        src.stats())

        clean, _ = decode(ParamStore(sdir))
        n = min(args.chaos_faults, policy.max_retries)
        inj = FaultInjector([FaultSpec(op="layer_read", after=4, times=n)])
        chaos, st = decode(FaultyStore(ParamStore(sdir), inj))
    finally:
        shutil.rmtree(sdir, ignore_errors=True)
    if not np.array_equal(clean, chaos):
        raise SystemExit("chaos transient: tokens DIVERGED after retry "
                         "recovery")
    print(f"chaos transient: {len(inj.fired)} injected disk faults "
          f"absorbed by retry/backoff ({st.retries} retries in "
          f"PrefetchStats); tokens byte-identical to the clean run")
    return {"fired": list(inj.fired), "stats": st, "tokens": chaos}


# --------------------------------------------------------------------------- #
#  the piped ring (--stages)
# --------------------------------------------------------------------------- #

def ring_prompts(cfg, args: argparse.Namespace) -> torch.Tensor:
    """``--batch`` prompts of ``--prompt-len`` tokens, drawn as the JAX
    driver draws its batch (``RequestGenerator`` seed 1, one length)."""
    gen = RequestGenerator(cfg.vocab, seed=1,
                           prompt_len=(args.prompt_len, args.prompt_len + 1))
    return torch.tensor(np.stack([r.prompt for r in gen.generate(args.batch)]),
                        dtype=torch.int32, device=args.device)


def clone_cache(cache: Dict) -> Dict:
    return {"len": cache["len"].clone(),
            "layers": {n: a.clone() for n, a in cache["layers"].items()}}


def to_ring_cache(cache: Dict, cfg, plan) -> Dict:
    """A prefilled one-device cache, copied into ring order."""
    return {"len": cache["len"].clone(),
            "layers": pad_and_permute(cache["layers"], cfg, plan.n_stages,
                                      plan.k)}


def greedy_steps(step, cache: Dict, tok: torch.Tensor, n: int, device, *,
                 tracer=None, metrics=None, keep: bool = False) -> Dict:
    """``n`` greedy steps of ``step(cache, tokens) -> (logits, cache)`` from
    ``tok`` (B, T), each timed between device syncs (a ``token_step``
    whose ``compute`` phase holds the step and its sync, with a tracer).
    Returns the tokens (B, n, T) as numpy, the step seconds, the cache
    and, with ``keep``, every step's logits."""
    tracer = resolve_tracer(tracer)
    toks, secs, kept = [], [], []
    for t in range(n):
        _sync(device)
        t0 = clock()
        with tracer.token_step(t, track="decode"):
            with tracer.phase("compute"):
                logits, cache = step(cache, tok)
                tok = logits.argmax(-1).to(torch.int32)
                _sync(device)
        secs.append(clock() - t0)
        if metrics is not None:
            metrics.observe("decode/step_s", secs[-1])
            metrics.inc("tokens/generated", tok.numel())
        toks.append(tok.cpu().numpy())
        if keep:
            kept.append(logits.float().clone())
        tok = tok[:, -1:].expand(-1, tok.shape[1]).contiguous()
    return {"tokens": np.stack(toks, 1), "step_s": secs, "cache": cache,
            "logits": kept}


def one_device_decode(weights, cfg, device) -> Callable:
    """The one-device decode step over ``weights`` (a ``DenseModel``, or a
    stacked tree read layer-wise, q4 included), replayed from CUDA graphs
    on the card."""
    from ..models import model as M
    from ..runtime.engine import (GraphedDecode, StepGraphs, dense_decode,
                                  dense_scrub)

    graphs = device.type == "cuda"
    if not isinstance(weights, dict):
        return dense_decode(weights, cfg, graphs=graphs, device=device)
    src = ResidentSource(weights)

    def fn(cache, tokens):
        return M.decode_step_layerwise(src, cfg, cache, tokens)
    if not graphs:
        return fn
    return GraphedDecode(fn, StepGraphs(device), dense_scrub)


def ring_prefill(weights, cfg, args: argparse.Namespace):
    """Prefill the ring prompts on the one-device path over ``weights``;
    returns (prompts, the prefilled one-device cache, the first tokens
    (B, 1), the prefill's seconds)."""
    from ..models import model as M

    device = torch.device(args.device)
    prompts = ring_prompts(cfg, args)
    cache = init_cache(cfg, args.batch, args.ctx, dtype=DTYPES[args.dtype],
                       device=device)
    _sync(device)
    t0 = clock()
    if isinstance(weights, dict):
        logits, cache = M.prefill_layerwise(ResidentSource(weights), cfg,
                                            prompts, cache)
    else:
        logits, cache = M.prefill(weights, cfg, prompts, cache)
    nxt = logits[:, -1:].argmax(-1).to(torch.int32)
    _sync(device)
    return prompts, cache, nxt, clock() - t0


def ring_splits(ring: Dict, one: Dict) -> List[Tuple[int, int, float,
                                                      float]]:
    """Each batch row's first step where the ring's greedy token differs
    from the one-device decode's (``greedy_steps`` runs with ``keep``):
    (row, step, the one-device logits' gap between the two tokens there,
    the two runs' max logit difference there), both over the one-device
    logits' max|.|. The contexts are equal up to that step."""
    a, b = ring["tokens"][:, :, -1], one["tokens"][:, :, -1]
    splits = []
    for row in range(a.shape[0]):
        diff = np.flatnonzero(a[row] != b[row])
        if diff.size:
            n = int(diff[0])
            la, lb = ring["logits"][n][row, -1], one["logits"][n][row, -1]
            top = float(lb.abs().max())
            splits.append((row, n, float(lb[b[row, n]] - lb[a[row, n]]) / top,
                           float((la - lb).abs().max()) / top))
    return splits


def vocab_cut(step: Callable, cfg) -> Callable:
    """``step`` with its logits cut to the vocab: a ring's head pads the
    vocab to a multiple of ``--tp`` (``pad_vocab``), as the JAX driver
    slices ``logits[..., :cfg.vocab]``."""
    def fn(cache, tokens):
        logits, cache = step(cache, tokens)
        return logits[..., :cfg.vocab], cache
    return fn


def rank_tokens(rank: Dict) -> np.ndarray:
    """A rank's greedy tokens (steps, B, 1) as ``greedy_steps`` gives
    them: (B, steps, 1)."""
    return rank["tokens"].transpose(1, 0, 2)


def save_tree(tree: Dict, path: str) -> str:
    """A tree of tensors (a one-device cache of any family, a parameter
    tree) to a ``torch.save`` file the ranks map."""
    def host(t):
        if isinstance(t, dict):
            return {k: host(v) for k, v in t.items()}
        return t.detach().cpu()
    torch.save(host(tree), path)
    return path


def ring_ranks(weights, cfg, args: argparse.Namespace, cache: Dict,
               nxt: torch.Tensor, world, *, keep: bool) -> List[Dict]:
    """Run the decode section's ring across ranks: ``weights`` written to
    a layer store and the prefilled ``cache`` to a file, both in a
    temporary directory, then ``runtime.serve.rank_ring_job`` on
    ``world``'s ``--stages x --tp`` rank processes
    (``launch.mesh.RankWorld``, started here if it is not up; the
    kernels built first, so the ranks do not race their builds), each
    reading only its part. Returns every rank's result; a rank that
    fails, dies or times out exits nonzero."""
    from ..kernels import _build
    from ..launch.mesh import RankFailure

    card = args.device == "cuda"
    T = args.verify_tokens
    work = tempfile.mkdtemp(prefix="rank_ring_")
    try:
        tree = weights if isinstance(weights, dict) \
            else tree_from_params(weights)
        store = save_param_store(tree, cfg, os.path.join(work, "store"))
        path = save_tree(cache, os.path.join(work, "cache.pt"))
        if card:
            _build.build()
        t0 = clock()
        ranks = world.run(
            "repro_torch.runtime.serve:rank_ring_job", cfg=cfg,
            n_stages=args.stages, tp=args.tp, k=args.ring_k,
            store=store, cache=path, first=nxt.cpu().numpy(),
            steps=args.new_tokens,
            verify_tokens=T if T > 1 and cfg.family != "ssm" else 1,
            verify_reps=4, keep_logits=keep,
            fail_rank=args.stages * args.tp - 1
            if args.chaos == "rank" else None)
        print(f"ring across ranks: {len(ranks)} processes up in "
              f"{max(r['t_start'] for r in ranks) - t0:.2f} s, their groups"
              f" and parts loaded in {max(r['load_s'] for r in ranks):.2f}"
              f" s, all done in {clock() - t0:.2f} s")
        return ranks
    except RankFailure as e:
        raise SystemExit(f"ring across ranks FAILED: {e}")
    finally:
        shutil.rmtree(work, ignore_errors=True)


def serve_ring(weights, cfg, args: argparse.Namespace, world, *,
               tracer=None, metrics=None) -> Dict:
    """``--stages M``: prefill on the one-device path, decode
    ``--new-tokens`` steps through the ring across ``M x --tp`` rank
    processes (``ring_ranks`` on ``world``: one a stage and
    tensor-parallel member, over gloo) and through the one-device step from the same cache, and
    exit nonzero unless their tokens are equal (bf16 on the card: unless
    each row splits only where the top-2 gap is under twice the logit
    difference) and every rank took the same tokens; with
    ``--verify-tokens T`` time a T-token verify pass on the ranks against
    T single steps. ``weights``: the ``DenseModel``, or a stacked tree
    (the store's, q4 included). Returns what rank 0 measured."""
    device = torch.device(args.device)
    card = device.type == "cuda"
    B, Mst = args.batch, args.stages
    prompts, cache, nxt, ttft = ring_prefill(weights, cfg, args)
    print(f"prefill: {B}x{prompts.shape[1]} tokens in {ttft * 1e3:.0f} ms")
    if metrics is not None:
        metrics.observe("request/ttft_s", ttft)
    plan = RingPlan.make(cfg, Mst, k=args.ring_k)
    # bf16 on the card: the ring multiplies microbatches of B/M rows where
    # the one-device step multiplies B, and sums its shards' attention and
    # FFN halves apart, so the streams may split, but only at a near tie
    near_ties = card and args.dtype != "f32"
    ranks = ring_ranks(weights, cfg, args, cache, nxt, world, keep=near_ties)
    r0 = ranks[0]
    if any(not np.array_equal(r["tokens"], r0["tokens"]) for r in ranks):
        raise SystemExit("ring across ranks FAILED: the ranks took "
                         "different greedy tokens")
    ring = {"tokens": rank_tokens(r0),
            "step_s": r0["step_s"],
            "logits": [torch.from_numpy(lg).to(device)
                       for lg in r0["logits"]]}
    for s in ring["step_s"]:
        if metrics is not None:
            metrics.observe("decode/step_s", s)
            metrics.inc("tokens/generated", B)
    per_tok = float(np.median(ring["step_s"]))
    print(f"ring decode (k={plan.k}, w={plan.w}, M={Mst}, TP={args.tp}): "
          f"{args.new_tokens} tokens x {B} seqs in "
          f"{sum(ring['step_s']):.2f}s -> {per_tok * 1e3:.1f} ms/token/batch"
          f" (median step on rank 0 of {len(ranks)} rank processes over "
          f"gloo, eager)")
    one = greedy_steps(one_device_decode(weights, cfg, device), cache, nxt,
                       args.new_tokens, device, keep=near_ties)
    equal = bool(np.array_equal(ring["tokens"], one["tokens"]))
    print(f"  one-device decode: {float(np.median(one['step_s'])) * 1e3:.1f}"
          f" ms/token/batch; ring tokens equal to it: {equal}")
    if not equal:
        splits = ring_splits(ring, one) if near_ties else []
        if not splits or any(gap > 2 * d for _, _, gap, d in splits):
            raise SystemExit(f"ring vs one-device decode parity FAILED "
                             f"(splits (row, step, top-2 gap, logit "
                             f"difference): {splits or 'f32: none allowed'})")
        print(f"  near-tie splits (row, step, top-2 gap, logit difference,"
              f" over max|logit|): {splits}")
    summed = {k: sum(r["launches"][k] for r in ranks)
              for k in r0["launches"]}
    print(f"  rank launches over the decode steps (rank 0): "
          f"{r0['launches']}; summed over the {len(ranks)} ranks: {summed}")
    out = {"plan": plan, "first": nxt.cpu().numpy(),
           "tokens": ring["tokens"], "step_s": ring["step_s"],
           "one_device_tokens": one["tokens"], "tokens_equal": equal,
           "one_device_step_s": one["step_s"], "prefill_s": ttft,
           "verify_ms": None, "ranks": len(ranks),
           "launches": r0["launches"]}
    T = args.verify_tokens
    if T > 1 and cfg.family == "ssm":
        print("verify pass skipped: the ssm state cannot roll back")
    elif T > 1:
        dtv = float(np.median(r0["verify_s"][1:]))
        print(f"verify pass (T={T}): {dtv * 1e3:.1f} ms vs {T}x"
              f"{per_tok * 1e3:.1f} ms single steps -> amortization "
              f"{T * per_tok / dtv:.2f}x")
        out["verify_ms"] = dtv * 1e3
    return out


def stream_ring(sdir: str, tree, cfg, args: argparse.Namespace, world
                ) -> Dict:
    """The stream section's ring, across the decode section's ranks
    (``world``, the same ``--stages x --tp`` layout): from the batch
    prefilled over ``tree`` (the stored weights, q4 included),
    ``--new-tokens`` steps through the resident ring over the store at
    ``sdir`` (``rank_ring_job``) and through the streamed ring over it
    (``rank_stream_job``: each rank streams only its stage's windows and
    its part of each leaf, ``max(1, W // w)`` windows ahead), and exit
    nonzero unless their tokens are equal and every rank took the same
    tokens (a rank that fails exits nonzero too). The JAX driver streams
    its ring from a fresh cache; the port's starts where the resident
    ring starts, so the two can be compared token for token."""
    from ..launch.mesh import RankFailure

    W = args.stream_window
    plan = RingPlan.make(cfg, args.stages, k=args.ring_k)
    depth = max(1, W // plan.w)
    _, cache, nxt, _ = ring_prefill(tree, cfg, args)
    work = tempfile.mkdtemp(prefix="stream_ring_")
    try:
        kw = dict(cfg=cfg, n_stages=args.stages, tp=args.tp, k=args.ring_k,
                  store=sdir, first=nxt.cpu().numpy(),
                  cache=save_tree(cache, os.path.join(work, "cache.pt")),
                  steps=args.new_tokens, keep_logits=True)
        del cache
        ref = world.run("repro_torch.runtime.serve:rank_ring_job", **kw)
        run = world.run("repro_torch.runtime.serve:rank_stream_job",
                        depth=depth, policy=io_policy(args), **kw)
    except RankFailure as e:
        raise SystemExit(f"streamed ring across ranks FAILED: {e}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if any(not np.array_equal(r["tokens"], run[0]["tokens"])
           for r in ref + run):
        raise SystemExit("streamed ring vs resident ring parity FAILED "
                         "(across ranks)")
    d = max((float(np.abs(a - b).max()) for a, b in
             zip(run[0]["logits"], ref[0]["logits"])), default=0.0)
    pf = [r["prefetch"] for r in run]
    r0 = run[0]
    total = ParamStore(sdir)
    try:
        store_bytes = total.layer_nbytes * cfg.n_layers
    finally:
        total.close()
    print(f"streamed ring across {len(run)} ranks (k={plan.k}, w={plan.w},"
          f" M={args.stages}, TP={args.tp}, {depth} windows ahead): rank "
          f"0's step {float(np.median(r0['step_s'])) * 1e3:.1f} ms "
          f"against {float(np.median(ref[0]['step_s'])) * 1e3:.1f} ms "
          f"resident; a rank read {min(p['bytes_a_pass'] for p in pf) / 1e6:.3f}"
          f"-{max(p['bytes_a_pass'] for p in pf) / 1e6:.3f} MB a pass of the "
          f"store's {store_bytes / 1e6:.3f} MB, peak staged "
          f"{max(p['peak_staged_bytes'] for p in pf) / 1e6:.3f} MB, stall "
          f"{max(p['stall_s'] for p in pf) * 1e3:.1f} ms at most; tokens "
          f"equal to the resident ring's across the same ranks, on every "
          f"rank (logits max|d| {d:.3g})")
    return {"plan": plan, "stored_tokens": rank_tokens(ref[0]),
            "streamed_tokens": rank_tokens(r0), "streamed_step_s": r0["step_s"],
            "stream_ranks": run, "resident_ranks": ref, "logits_max_d": d,
            "store_bytes": store_bytes}


def serve_failover(sdir: str, cfg, args: argparse.Namespace, *,
                   stage: int = 1, tracer=None, device_profiles=None,
                   model_profile=None, ranks: bool = True,
                   world=None) -> Dict:
    """``--chaos failover``: serve the ring prompts through
    ``ElasticRingServer`` over the store at ``sdir`` while ring stage
    ``stage`` dies at the pass of the third token, and exit nonzero unless
    the death was attributed to that stage, no token was lost and the
    tokens after recovery equal a clean run on the survivor ring fed the
    same history (the JAX driver's ``_chaos_smoke``). ``ranks`` (the
    default): the ring runs across ``--stages x --tp`` rank processes and
    the parent ``SIGKILL``s the stage's member-0 rank as that pass starts
    (``RankChaos``); the survivors are re-planned and re-spawned as a
    world of their own. Else every stage runs in this process (``--tp``
    must be 1) and a fault kills the stage at the first layer read of the
    pass (every pass reads each layer once). ``world``: a running world of
    that layout to serve on first (the decode section's; the kill ends
    it); the clean run reuses the survivors' world. Returns the event,
    the streams, what the server caught and the fired faults.
    ``device_profiles``/``model_profile``: re-plan the survivors through
    Halda (``ElasticRingServer``'s)."""
    from ..runtime.failover import ElasticRingServer, RankChaos

    prompts = ring_prompts(cfg, args).cpu().numpy()
    S, n_new = prompts.shape[1], args.new_tokens
    if n_new < 3:
        raise SystemExit("--chaos failover kills a stage at the third "
                         "token: it needs --new-tokens >= 3")
    kw = dict(batch=args.batch, ctx=args.ctx, tp=args.tp, ranks=ranks,
              policy=io_policy(args), device=args.device,
              cache_dtype=DTYPES[args.dtype])
    inj = None
    if ranks:
        store = sdir
        chaos = RankChaos(stage=stage, token=2, mode="kill")
    else:
        inj = FaultInjector([FaultSpec(op="layer_read", mode="stage_failure",
                                       stage=stage,
                                       after=cfg.n_layers * (S + 1),
                                       times=1)], tracer=tracer)
        store, chaos = FaultyStore(ParamStore(sdir), inj), None
    srv = ElasticRingServer(cfg, store, n_stages=args.stages,
                            k=args.ring_k, tracer=tracer,
                            device_profiles=device_profiles,
                            model_profile=model_profile, chaos=chaos,
                            world=world, **kw)
    try:
        toks = srv.generate(prompts, n_new)
        survivors = srv.take_world()
    finally:
        srv.close()
        if not ranks:
            store.close()
    if not srv.events:
        raise SystemExit("chaos failover: the stage's death never "
                         "surfaced")
    ev = srv.events[0]
    if ev.failed_stage != stage:
        raise SystemExit(f"chaos failover: the death was attributed to "
                         f"stage {ev.failed_stage}, not {stage}: "
                         f"{srv.failures[0]}")
    if ev.tokens_lost or toks.shape[1] != n_new:
        raise SystemExit(f"chaos failover: lost {ev.tokens_lost} tokens")
    i = ev.token_index
    clean = sdir if ranks else ParamStore(sdir)
    ref_srv = ElasticRingServer(cfg, clean, n_stages=ev.plan["n_stages"],
                                k=ev.plan["k"], world=survivors, **kw)
    try:
        ref = ref_srv.generate(np.concatenate([prompts, toks[:, :i]], 1),
                               n_new - i)
    finally:
        ref_srv.close()
        if ranks:
            survivors.close()
        else:
            clean.close()
    if not np.array_equal(toks[:, i:], ref):
        raise SystemExit("chaos failover: tokens after recovery differ from "
                         "a clean survivor-ring run fed the same history")
    exc = srv.failures[0]
    died = [e for e in getattr(exc, "errors", []) if e.kind == "died"]
    cause = "; ".join(e.describe() for e in died) + (
        f", seen {(exc.t_seen - exc.t_first) * 1e3:.1f} ms after the kill"
        if died else str(exc).splitlines()[0])
    where = (f"across {args.stages} x {args.tp} ranks -> "
             f"{ev.n_stages_after} x {args.tp}" if ranks
             else f"in one process, {ev.n_stages_before} -> "
             f"{ev.n_stages_after} stages")
    print(f"chaos failover: stage {ev.failed_stage} died at token {i} "
          f"({cause}); ring {where} (k {ev.plan['k']}, w {ev.plan['w']}), "
          f"replayed {ev.replayed_tokens} tokens, recovered in "
          f"{ev.recovery_s:.3f}s (detect {ev.detect_s * 1e3:.1f} ms, "
          f"re-solve {ev.resolve_s * 1e3:.1f} ms, rebuild "
          f"{ev.rebuild_s:.3f}s, replay {ev.replay_s:.3f}s), 0 tokens lost; "
          f"tokens after recovery equal a clean survivor-ring run")
    return {"event": ev, "tokens": toks, "reference": ref,
            "failures": list(srv.failures),
            "fired": list(inj.fired) if inj is not None else []}


def serve_gspmd(weights, cfg, args: argparse.Namespace, world, *,
                metrics=None) -> Dict:
    """The decode section where the ring does not apply (the JAX driver's
    ``gspmd_decode_step`` branch): prefill on the one-device path, then
    ``--new-tokens`` greedy steps through the GSPMD layer across
    ``world``'s ``--stages x --tp`` ranks (``runtime.gspmd.
    rank_gspmd_job``: the weights and the prefilled cache written to
    files in a temporary directory, each rank cutting its FSDP part of
    every weight and its part of the cache; the kernels built first), and
    through the one-device step from the same cache; exit nonzero unless
    their tokens are equal (bf16 on the card: near-tie splits only), the
    ranks that share rows took the same tokens and no rank failed
    (``--chaos rank``: the last rank raises at its second step). Returns
    the tokens (B, new_tokens, 1), the first tokens and what rank 0
    measured."""
    from ..kernels import _build
    from ..launch.mesh import RankFailure

    device = torch.device(args.device)
    card = device.type == "cuda"
    B, Mst = args.batch, args.stages
    prompts, cache, nxt, ttft = ring_prefill(weights, cfg, args)
    print(f"prefill: {B}x{prompts.shape[1]} tokens in {ttft * 1e3:.0f} ms")
    if metrics is not None:
        metrics.observe("request/ttft_s", ttft)
    near_ties = card and args.dtype != "f32"
    work = tempfile.mkdtemp(prefix="rank_gspmd_")
    try:
        tree = weights if isinstance(weights, dict) \
            else tree_from_params(weights)
        ppath = save_tree(tree, os.path.join(work, "params.pt"))
        cpath = save_tree(cache, os.path.join(work, "cache.pt"))
        if card:
            _build.build()
        t0 = clock()
        ranks = world.run(
            "repro_torch.runtime.gspmd:rank_gspmd_job", cfg=cfg,
            n_stages=Mst, tp=args.tp, params=ppath, cache=cpath,
            first=nxt.cpu().numpy(), steps=args.new_tokens,
            dtype=str(DTYPES[args.dtype]).replace("torch.", ""),
            keep_logits=near_ties,
            fail_rank=Mst * args.tp - 1 if args.chaos == "rank" else None)
    except RankFailure as e:
        raise SystemExit(f"gspmd decode across ranks FAILED: {e}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    toks = np.full((B, args.new_tokens), -1, np.int64)
    logits: List = [None] * args.new_tokens
    for r in ranks:
        lo, hi = r["rows"]
        if (toks[lo:hi] < 0).all():
            toks[lo:hi] = r["tokens"].T
        elif not np.array_equal(r["tokens"].T, toks[lo:hi]):
            raise SystemExit("gspmd decode across ranks FAILED: ranks that "
                             "hold the same rows took different tokens")
        if near_ties and r["member"] == 0:
            for t, lg in enumerate(r["logits"]):
                if logits[t] is None:
                    logits[t] = np.zeros((B,) + lg.shape[1:], np.float32)
                logits[t][lo:hi] = lg
    r0 = ranks[0]
    dt = sum(r0["step_s"])
    print(f"gspmd decode: {args.new_tokens} x {B} in {dt:.2f}s "
          f"({float(np.median(r0['step_s'])) * 1e3:.1f} ms/token/batch, "
          f"median step on rank 0 of {len(ranks)} rank processes over "
          f"gloo, eager; ranks up and their parts loaded in "
          f"{max(r['load_s'] for r in ranks):.2f} s, all done in "
          f"{clock() - t0:.2f} s)")
    for s in r0["step_s"]:
        if metrics is not None:
            metrics.observe("decode/step_s", s)
            metrics.inc("tokens/generated", B)
    gs = {"tokens": toks[:, :, None],
          "logits": [torch.from_numpy(lg).to(device) for lg in logits
                     if lg is not None]}
    one = greedy_steps(one_device_decode(weights, cfg, device), cache, nxt,
                       args.new_tokens, device, keep=near_ties)
    equal = bool(np.array_equal(gs["tokens"], one["tokens"]))
    print(f"  one-device decode: {float(np.median(one['step_s'])) * 1e3:.1f}"
          f" ms/token/batch; gspmd tokens equal to it: {equal}")
    if not equal:
        splits = ring_splits(gs, one) if near_ties else []
        if not splits or any(gap > 2 * d for _, _, gap, d in splits):
            raise SystemExit(f"gspmd vs one-device decode parity FAILED "
                             f"(splits (row, step, top-2 gap, logit "
                             f"difference): {splits or 'f32: none allowed'})")
        print(f"  near-tie splits (row, step, top-2 gap, logit difference,"
              f" over max|logit|): {splits}")
    summed = {k: sum(r["launches"][k] for r in ranks)
              for k in r0["launches"]}
    print(f"  rank launches over the decode steps (rank 0): "
          f"{r0['launches']}; summed over the {len(ranks)} ranks: {summed}")
    return {"first": nxt.cpu().numpy(), "tokens": gs["tokens"],
            "step_s": r0["step_s"], "one_device_tokens": one["tokens"],
            "tokens_equal": equal, "prefill_s": ttft, "ranks": len(ranks),
            "launches": r0["launches"], "summed_launches": summed,
            "nbytes": [r["nbytes"] for r in ranks],
            "comm_share": r0["comm_share"]}


def serve_decode(params, cfg, args: argparse.Namespace, world, *,
                 tracer=None, metrics=None) -> Dict:
    """The decode section: prefill the batch, then decode it across
    ``world``'s ranks where ``--stages`` > 1: through the ring
    (``serve_ring``) where ``ring_supported`` holds, else through the
    GSPMD layer (``serve_gspmd``), as the JAX driver decodes with
    ``gspmd_decode_step`` on its mesh; with ``--stages 1`` on one device.
    Returns the tokens (B, new_tokens + 1), the first one from the
    prefill, and the ring's or the GSPMD layer's result (the other
    None)."""
    device = torch.device(args.device)
    B, Mst = args.batch, args.stages
    if Mst > 1 and ring_supported(cfg, B, Mst):
        ring = serve_ring(params, cfg, args, world, tracer=tracer,
                          metrics=metrics)
        return {"tokens": np.concatenate([ring["first"],
                                          ring["tokens"][:, :, 0]], 1),
                "ring": ring, "gspmd": None}
    if Mst > 1:
        print(f"{cfg.name}: ring unsupported for B={B}, M={Mst} "
              f"(family={cfg.family}) -- GSPMD decode path")
        gs = serve_gspmd(params, cfg, args, world, metrics=metrics)
        return {"tokens": np.concatenate([gs["first"],
                                          gs["tokens"][:, :, 0]], 1),
                "ring": None, "gspmd": gs}
    prompts, cache, nxt, ttft = ring_prefill(params, cfg, args)
    print(f"prefill: {B}x{prompts.shape[1]} tokens in {ttft * 1e3:.0f} ms")
    if metrics is not None:
        metrics.observe("request/ttft_s", ttft)
    run = greedy_steps(one_device_decode(params, cfg, device), cache, nxt,
                       args.new_tokens, device, tracer=tracer,
                       metrics=metrics)
    print(f"one-device decode: {args.new_tokens} tokens x {B} seqs -> "
          f"{float(np.median(run['step_s'])) * 1e3:.1f} ms/token/batch "
          f"(median step)")
    return {"tokens": np.concatenate([nxt.cpu().numpy(),
                                      run["tokens"][:, :, 0]], 1),
            "ring": None, "gspmd": None}


def serve_paged_section(params, cfg, args: argparse.Namespace, *,
                        tracer=None, metrics=None) -> Dict:
    """The paged section (the JAX driver's ``_paged_smoke``): the requests
    through the paged engine (an ssm model: the dense-cache engine), then
    through the dense-cache engine, exiting nonzero on any token mismatch
    (not for int8 pages with chunked admission, which never match the
    dense engine); then the tiers when a budget or parking is asked
    for."""
    device = torch.device(args.device)
    reqs = make_requests(cfg, args)
    if cfg.family == "ssm":
        print(f"paged-kv: {cfg.name} keeps a recurrent state, not KV pages:"
              f" served through the dense-cache engine")
        res = serve_dense(params, cfg, reqs, args, tracer=tracer,
                          metrics=metrics)
    else:
        res = serve_paged(params, cfg, reqs, args, tracer=tracer,
                          metrics=metrics)
        res["summary"] = report(res, args)
    if res["rejected"]:
        raise SystemExit(f"{len(res['rejected'])} requests shed: "
                         f"{res['rejected'][0].reason}")
    if cfg.family == "ssm":
        return res
    if cfg.kv_dtype == "int8" and args.prefill_chunk:
        print("  dense engine: not compared (int8 pages with chunked "
              "admission never match it, in either package)")
    else:
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


def run_sections(params, cfg, base, args: argparse.Namespace, world,
                 tracer, metrics) -> Dict:
    """``run``'s sections in order, the ring's on ``world``."""
    res: Dict = {"decode": serve_decode(params, base, args, world,
                                        tracer=tracer, metrics=metrics)}
    res["ring"] = res["decode"]["ring"]
    stacked = cfg.family in STACKED_FAMILIES
    if args.stream_window and stacked:
        res["stream"] = st = serve_stream(params, base, args, world,
                                          tracer=tracer, metrics=metrics)
        if st["ring"] is not None:
            res["ring"].update(st["ring"])
        if st["rejected"]:
            raise SystemExit(f"{len(st['rejected'])} requests shed: "
                             f"{st['rejected'][0].reason}")
    if args.chaos != "failover":
        world.close()              # the failover serves on it first
    if args.paged_kv and not stacked:
        print(f"paged-kv: unsupported family {cfg.family} -- skipped")
    elif args.paged_kv and cfg.mla and cfg.kv_dtype == "int8":
        print("paged-kv: int8 MLA latent pages unsupported -- skipped")
    elif args.paged_kv:
        res["paged"] = serve_paged_section(params, cfg, args, tracer=tracer,
                                           metrics=metrics)
    if args.chaos != "none" and not stacked:
        print(f"chaos: unsupported family {cfg.family} -- skipped")
    elif args.chaos == "transient":
        res["chaos"] = serve_chaos(params, base, args)
    elif args.chaos == "failover":
        if res["ring"] is None:
            print("chaos failover: ring path unavailable -- skipped")
            res["chaos"] = None
        else:
            sdir, _, _ = write_store(params, base, args)
            try:
                res["chaos"] = serve_failover(sdir, base, args,
                                              tracer=tracer, world=world)
            finally:
                shutil.rmtree(sdir, ignore_errors=True)
    return res


def run(args: argparse.Namespace, params=None) -> Dict:
    """Every section the flags ask for, in the JAX driver's order:
    decode, stream, paged, chaos. ``params``: a ``DenseModel`` to serve in
    place of the seed's random weights. Returns each section's result
    under its name (``decode``, ``stream``, ``paged``, ``chaos``) and the
    ring's under ``ring`` (with the stream section's streamed ring merged
    in)."""
    from .mesh import RankWorld

    if args.stages > 1:
        print(f"ring: the decode, stream and --chaos failover sections "
              f"run across one world of {args.stages} x {args.tp} rank "
              f"processes (stage x tensor-parallel member, over gloo); the "
              f"failover's survivors are a world of their own")
    cfg, params = build_model(args, params)
    # --kv-quant-kernel asks for int8 pages: the other sections keep the
    # config's own cache, as the JAX driver's do
    base = dataclasses.replace(cfg, kv_dtype=get_config(args.arch).kv_dtype)
    tracer, metrics = instruments(args)
    # one torch thread a rank: the card does the work, and a thread pool
    # a rank would have the ranks' host threads spin against each other
    # on the machine's cores; the ranks start at the world's first job
    world = RankWorld(args.stages * args.tp, device=args.device, threads=1)
    try:
        res = run_sections(params, cfg, base, args, world, tracer, metrics)
    finally:
        world.close()
    print("sample token ids:", res["decode"]["tokens"][:, -1][:8].tolist())
    print(f"kernel launches {ops.launch_counts()}")
    export_instruments(tracer, metrics, args)
    return res


def main(argv: Optional[List[str]] = None) -> Dict:
    return run(parse_args(argv))


if __name__ == "__main__":
    main(sys.argv[1:])
