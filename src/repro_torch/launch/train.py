"""Training driver of the port: ``python -m repro_torch.launch.train --arch
<id> [--smoke]``.

The JAX driver's flags, defaults and loop (``repro.launch.train``), on the
card unless ``--device cpu``: config (``--smoke`` the reduced one,
``--d-model`` / ``--n-layers`` overrides) -> random f32 weights from
``--seed`` (``run`` also takes a model handed in) -> ``AdamW(lr,
warmup_steps=20)`` -> ``make_train_step`` (f32 gradients, no remat,
``--microbatch``) over the ``SyntheticCorpus`` stream -> a checkpoint of
``(params, AdamState)`` in the JAX package's layout every
``--ckpt-every`` steps (``CheckpointManager``, keep 2). ``--resume``
restores the latest checkpoint and fast-forwards the data stream to it,
so a run cut and resumed sees the batches an uninterrupted run sees.

Prints the JAX driver's lines (``arch=... params=...M``, ``step N loss L
gnorm G (t s)`` every 10 steps and at the first, ``checkpointed step N``,
``resumed from step N``, ``done``), then the step time between syncs,
tokens/s, the peak device bytes and whether TF32 was on.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import bridge
from ..configs import get_config
from ..data import SyntheticCorpus, batches
from ..models import init_params
from ..runtime.checkpoint import CheckpointManager
from ..runtime.optim import AdamState, AdamW
from ..runtime.train import make_train_step, make_trainable


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="qwen2.5-14b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatch", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--d-model", type=int, default=None,
                    help="override width (e.g. ~100M-param example)")
    ap.add_argument("--n-layers", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    return ap.parse_args(argv)


def build_config(args: argparse.Namespace):
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    over = {}
    if args.d_model:
        over["d_model"] = args.d_model
    if args.n_layers:
        over["n_layers"] = args.n_layers
    return dataclasses.replace(cfg, **over) if over else cfg


def _meta(t: torch.Tensor, dtype=None) -> torch.Tensor:
    return torch.empty(t.shape, dtype=dtype or t.dtype, device="meta")


def state_tree(params, opt: AdamState):
    """(params, AdamState) as the JAX package's checkpoint tree, where
    the leaves are (``checkpoint.save`` copies one leaf at a time to the
    host)."""
    return (bridge.tree_from_params(params),
            bridge.opt_state_tree(params, opt))


def state_like(params):
    """The checkpoint tree's shapes and dtypes as meta tensors: f32
    moments, an int32 step; nothing allocated."""
    moments = bridge.tree_from_params(
        params, leaf=lambda t: _meta(t, torch.float32))
    return (bridge.tree_from_params(params, leaf=_meta),
            AdamState(step=torch.empty((), dtype=torch.int32,
                                       device="meta"),
                      mu=moments, nu=moments))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(args: argparse.Namespace, params=None) -> Dict:
    """The training loop. ``params``: a model to train in place of the
    seed's random weights (trained in place). Returns {"losses" (one a
    step run), "grad_norms", "step_s" (each step's seconds between
    syncs), "start" (the step resumed from, 0 if none), "ckpt_s" (each
    save's seconds), "restore_s" (None without a restore),
    "tokens_per_s", "peak_bytes" (``max_memory_allocated``; None on the
    CPU), "tf32", "params", "opt"}."""
    cfg = build_config(args)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda but no CUDA device is available "
                         "(pass --device cpu to run the plain versions)")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    print(f"arch={cfg.name} params={cfg.total_params()/1e6:.1f}M "
          f"layers={cfg.n_layers} d={cfg.d_model}")

    if params is None:
        gen = torch.Generator(device=device).manual_seed(args.seed)
        params = init_params(cfg, gen, dtype=torch.float32, device=device)
    make_trainable(params)
    opt_def = AdamW(lr=args.lr, warmup_steps=20)
    step_fn = make_train_step(cfg, opt_def, grad_dtype=None, remat=False,
                              microbatch=args.microbatch)

    mgr = CheckpointManager(args.ckpt_dir, keep=2)
    start, opt, restore_s, ckpt_s = 0, None, None, []
    if args.resume:
        t = time.perf_counter()
        got, tree = mgr.restore_latest(state_like(params), device=device)
        if got is not None:
            bridge.load_params_tree(params, tree[0])
            opt = bridge.opt_state_from_tree(params, tree[1], AdamState)
            del tree
            start = got
            restore_s = time.perf_counter() - t
            print(f"resumed from step {start}")
    if opt is None:
        opt = opt_def.init(list(params.parameters()))

    corpus = SyntheticCorpus(vocab=cfg.vocab, seed=args.seed)
    it = batches(corpus, args.batch, args.seq, seed=args.seed)
    # fast-forward the stream on resume (determinism across restarts)
    for _ in range(start):
        next(it)

    losses: List[float] = []
    gnorms: List[float] = []
    step_s: List[float] = []
    t0 = time.time()
    for step in range(start, args.steps):
        batch = {k: torch.from_numpy(np.asarray(v)).to(device)
                 for k, v in next(it).items()}
        _sync(device)
        ts = time.perf_counter()
        params, opt, metrics = step_fn(params, opt, batch)
        loss = float(metrics["loss"])          # syncs the step
        step_s.append(time.perf_counter() - ts)
        losses.append(loss)
        gnorms.append(float(metrics["grad_norm"]))
        if (step + 1) % 10 == 0 or step == start:
            dt = time.time() - t0
            print(f"step {step + 1:5d} loss {loss:.4f} "
                  f"gnorm {gnorms[-1]:.3f} ({dt:.1f}s)", flush=True)
        if (step + 1) % args.ckpt_every == 0:
            t = time.perf_counter()
            mgr.save(step + 1, state_tree(params, opt))
            ckpt_s.append(time.perf_counter() - t)
            print(f"checkpointed step {step + 1}")
    res = {"losses": losses, "grad_norms": gnorms, "step_s": step_s,
           "start": start, "params": params, "opt": opt,
           "ckpt_s": ckpt_s, "restore_s": restore_s,
           "tf32": bool(torch.backends.cuda.matmul.allow_tf32),
           "peak_bytes": (torch.cuda.max_memory_allocated(device)
                          if device.type == "cuda" else None)}
    steady = step_s[1:] or step_s
    med = float(np.median(steady)) if steady else float("nan")
    res["tokens_per_s"] = args.batch * args.seq / med if steady else 0.0
    if step_s:
        peak = "n/a (cpu)" if res["peak_bytes"] is None \
            else f"{res['peak_bytes'] / 1e9:.2f} GB"
        print(f"step {med * 1e3:.1f} ms (median after the first, between "
              f"syncs), {res['tokens_per_s']:.0f} tokens/s, peak device "
              f"{peak}, tf32 {res['tf32']}")
    if ckpt_s or restore_s is not None:
        saves = ", ".join(f"{x:.1f} s" for x in ckpt_s) or "none"
        restored = "none" if restore_s is None else f"{restore_s:.1f} s"
        print(f"checkpoint saves: {saves}; restore: {restored}")
    print("done")
    return res


def main(argv: Optional[List[str]] = None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
