"""Paged serving driver of the port: ``python -m repro_torch.launch.serve``.

Builds a dense model with random weights from ``--seed`` (``--smoke``: the
reduced config), serves ``RequestGenerator`` requests through the paged
continuous batcher (``runtime.kvcache.make_paged_engine``) and prints TTFT,
TPOT, tokens/s, the KV high-water mark and the kernel launch counts.
``--check-dense`` also runs the dense-cache engine on the same requests and
exits nonzero on any token mismatch. Runs on the card unless
``--device cpu``.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import Dict, List, Optional

import numpy as np
import torch

from ..configs import get_config
from ..data import RequestGenerator
from ..kernels import ops
from ..models import init_cache, init_params
from ..runtime.engine import make_dense_engine
from ..runtime.kvcache import make_paged_engine
from ..runtime.telemetry import clock

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
    return ap.parse_args(argv)


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


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve_paged(params, cfg, reqs, args: argparse.Namespace) -> Dict:
    """Serve ``reqs`` through the paged engine; returns the streams and
    what was measured."""
    device = torch.device(args.device)
    B, ctx, bs = args.batch, args.ctx, args.page_tokens
    n_pages = 2 + B * (-(-ctx // bs))
    eng, kv = make_paged_engine(params, cfg, B, ctx, n_pages=n_pages,
                                page_tokens=bs,
                                cache_dtype=DTYPES[args.dtype],
                                prefill_chunk=args.prefill_chunk or None,
                                device=device)
    cache = kv.init_cache()
    _sync(device)
    t0 = clock()
    fin, steps = eng.run(cache, reqs)
    _sync(device)
    wall = clock() - t0
    return {"finished": fin, "rejected": eng.rejected, "steps": steps,
            "wall_s": wall, "kv": kv.stats()}


def report(res: Dict, args: argparse.Namespace) -> Dict[str, float]:
    fin = res["finished"]
    n_tok = sum(len(f.tokens) for f in fin)
    tpots = [f.tpot_s for f in fin if len(f.tokens) > 1]
    st = res["kv"]
    out = {"requests": len(fin),
           "ttft_p50_s": float(np.median([f.ttft_s for f in fin])),
           "tpot_p50_s": float(np.median(tpots)) if tpots else 0.0,
           "tokens_per_s": n_tok / res["wall_s"],
           "kv_highwater_bytes": st.highwater_bytes}
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


def main(argv: Optional[List[str]] = None) -> Dict:
    args = parse_args(argv)
    cfg, params = build_model(args)
    reqs = make_requests(cfg, args)
    res = serve_paged(params, cfg, reqs, args)
    res["summary"] = report(res, args)
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
        print(f"  dense engine: tokens identical for {len(dense)} requests")
    return res


if __name__ == "__main__":
    main(sys.argv[1:])
