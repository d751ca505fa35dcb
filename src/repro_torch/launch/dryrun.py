"""The dry run over the production meshes: ``repro.launch.dryrun`` on
PyTorch's ``meta`` device.

For every (architecture x input shape) cell and both production meshes
(single pod 16 x 16, multi-pod 2 x 16 x 16; ``launch.mesh``), the JAX
package lowers and compiles the cell's step (``gspmd_prefill``,
``gspmd_decode_step``, ``build_ring_serve_step`` or
``jitted_train_step``) on ShapeDtypeStruct stand-ins and records its
memory and its collectives. Here the cell's step is the port's own rank
step, run once for rank 0 of the mesh on ``meta`` tensors
(``launch.specs``' stand-ins cut to the rank's part) over
``launch.mesh.dry_rank_layout``, whose axes have no process group: every
collective counts itself (``runtime.collectives.op_counts``) and returns
an uninitialised result of its shape, so the schedule is the step's own,
not a second formula, and no rank process starts. The steps:

  * train: ``runtime.train.RankTrainStep`` (``train_style`` fsdp, as the
    JAX dry run's default, or zero1), forward, backward and the AdamW
    update;
  * prefill: ``runtime.gspmd.GspmdPrefill``;
  * decode: ``decode_path``'s choice (the JAX function, over the port's
    ``{axis: size}`` mesh): the ring across ranks
    (``runtime.serve.RankRingStep`` over the rank's ``rank_params`` and
    ``rank_init_cache``) or ``runtime.gspmd.GspmdDecodeStep``.

Where a step reads a value from the device, the dry run supplies it: the
prefill's ``fresh`` (the cache holds no token yet; ``GspmdPrefill`` would
read ``len``). Nothing is compiled, so no record claims a compile time;
``plan_s`` is the step's wall time on meta tensors.

A record's shared keys are the JAX record's (``arch``, ``shape``,
``mesh``, ``kind``, ``path`` in the JAX path strings, ``mesh_kind``,
``ok``, ``model``); ``memory`` holds one device's bytes of parameters,
moments, cache and inputs and their sum as ``argument_bytes`` (the
JAX record's ``memory_analysis`` field of that name); ``collectives`` is
``{op: {"count", "bytes"}}`` a step (XLA's op names, result bytes) and
``collectives_by_axis`` the same by mesh axis.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mixtral-8x7b \\
      --shape decode_32k --mesh multi
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out d.json
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
from typing import Any, Dict, Optional

import torch

from ..configs import ASSIGNED_ARCHS, SHAPES, get_config
from ..configs.base import ModelConfig, ShapeSpec
from ..runtime import collectives as C
from ..runtime import gspmd as G
from ..runtime import serve
from ..runtime.optim import AdamW
from ..runtime.paramstore import ResidentSource
from ..runtime.train import RankTrainStep, rank_train_state
from . import specs as SP
from .mesh import dry_rank_layout, make_production_mesh

META = torch.device("meta")


def decode_path(cfg: ModelConfig, shape: ShapeSpec, mesh) -> str:
    """The JAX dry run's choice: the ring where the pod's batch splits
    over the stages and ``ring_supported`` holds, else GSPMD."""
    n_pods = mesh.get("pod", 1)
    n_stages = mesh["data"]
    b_pod = shape.global_batch // n_pods
    if shape.global_batch % n_pods:
        return "gspmd"
    if serve.ring_supported(cfg, b_pod, n_stages):
        return "ring"
    return "gspmd"


def _nbytes(tree) -> int:
    from ..runtime.sharding import flatten_with_path

    return sum(t.numel() * t.element_size()
               for _, t in flatten_with_path(tree))


def _histogram(counts: Dict[str, Dict[str, int]]) -> Dict[str, Dict]:
    out: Dict[str, Dict[str, int]] = {}
    for key, rec in counts.items():
        op = key.split("[")[0]
        acc = out.setdefault(op, {"count": 0, "bytes": 0})
        acc["count"] += rec["count"]
        acc["bytes"] += rec["bytes"]
    return out


def _rows(t: torch.Tensor, layout) -> torch.Tensor:
    return t[G.batch_rows(layout, t.shape[0])]


def plan_cell(arch: str, shape_name: str, mesh, *, ring_k: int = 1,
              microbatch: Optional[int] = None, train_style: str = "fsdp"
              ) -> Dict[str, Any]:
    """Run rank 0's step of one cell on meta tensors; the record without
    its mesh kind."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    lay = dry_rank_layout(mesh)
    meta: Dict[str, Any] = {"arch": arch, "shape": shape_name,
                            "mesh": dict(mesh), "kind": shape.kind}
    mem: Dict[str, int] = {"params_bytes": 0, "moments_bytes": 0,
                           "cache_bytes": 0, "input_bytes": 0}
    batch = SP.batch_shapes(cfg, shape)
    C.reset_op_counts()
    t0 = time.perf_counter()

    if shape.kind == "train":
        tree = SP.params_shapes(cfg)
        params, specs, mspecs = rank_train_state(tree, cfg, lay,
                                                 style=train_style)
        step = RankTrainStep(cfg, lay, params, specs, AdamW(),
                             style=train_style, moment_specs=mspecs,
                             microbatch=microbatch,
                             has_embeds="embeds" in batch)
        mem["params_bytes"] = G.tree_nbytes(params)
        st = step.init_state()
        mem["moments_bytes"] = sum(t.numel() * t.element_size()
                                   for t in st.mu + st.nu) \
            + st.step.element_size()
        mem["input_bytes"] = sum(_rows(t, lay).numel() * t.element_size()
                                 for t in batch.values())
        C.reset_op_counts()
        step(batch)
        meta["path"] = f"gspmd-train({train_style})"
    elif shape.kind == "prefill":
        tree = SP.params_shapes(cfg)
        params, specs = G.gspmd_params(tree, cfg, lay)
        ctx = SP.decode_context(cfg, shape)
        B = shape.global_batch
        cache = G.gspmd_init_cache(cfg, lay, B, ctx, dtype=torch.bfloat16)
        model = G.GspmdModel(cfg, lay, params, specs,
                             cache_specs=G.cache_specs(
                                 cfg, mesh, SP.cache_shapes(cfg, B, ctx)))
        tok = _rows(batch["tokens"], lay)
        em = batch.get("embeds")
        em = None if em is None else _rows(em, lay)
        mem["params_bytes"] = G.tree_nbytes(params)
        mem["cache_bytes"] = _nbytes(cache)
        mem["input_bytes"] = tok.numel() * tok.element_size() + (
            0 if em is None else em.numel() * em.element_size())
        # supplied: a fresh cache holds no token (the step would read len)
        G.GspmdPrefill(model, G.batch_rows(lay, B), B)(cache, tok, em,
                                                        fresh=True)
        meta["path"] = "gspmd-prefill"
    elif decode_path(cfg, shape, mesh) == "ring":
        n_pods, M = mesh.get("pod", 1), mesh["data"]
        plan = serve.RingPlan.make(cfg, M, k=ring_k)
        params = serve.rank_params(ResidentSource(SP.params_shapes(cfg)),
                                   cfg, plan, lay, device=META)
        ctx = SP.decode_context(cfg, shape)
        B = shape.global_batch // n_pods
        cache = serve.rank_init_cache(cfg, plan, lay,
                                      shape.global_batch, ctx,
                                      dtype=torch.bfloat16, device=META)
        tok = torch.empty((B, 1), dtype=torch.int32, device=META)
        mem["params_bytes"] = params["nbytes"]
        mem["cache_bytes"] = _nbytes(cache)
        # the tokens (B, 1); the lengths are the cache's ``len`` (the JAX
        # step takes them as an argument of their own, and jit drops the
        # cache's copy, which its step does not read)
        mem["input_bytes"] = tok.numel() * tok.element_size()
        step = serve.RankRingStep(cfg, plan, lay, params)
        with torch.no_grad():
            step(cache, tok)
        meta["path"] = f"ring(k={plan.k},w={plan.w},Lpad={plan.L_pad})"
        meta["ring"] = {"k": plan.k, "w": plan.w, "M": M,
                        "L_pad": plan.L_pad, "n_steps": plan.n_steps}
    else:
        tree = SP.params_shapes(cfg)
        params, specs = G.gspmd_params(tree, cfg, lay)
        ctx = SP.decode_context(cfg, shape)
        B = shape.global_batch
        one = SP.cache_shapes(cfg, B, ctx)
        cache = G.gspmd_cache(one, cfg, lay, device=META)
        model = G.GspmdModel(cfg, lay, params, specs,
                             cache_specs=G.cache_specs(cfg, mesh, one))
        tok = _rows(batch["tokens"], lay)
        mem["params_bytes"] = G.tree_nbytes(params)
        mem["cache_bytes"] = _nbytes(cache)
        mem["input_bytes"] = tok.numel() * tok.element_size()
        G.GspmdDecodeStep(model, G.batch_rows(lay, B), B)(cache, tok)
        meta["path"] = "gspmd-decode"
    meta["plan_s"] = round(time.perf_counter() - t0, 3)
    mem["argument_bytes"] = sum(mem.values())
    counts = C.op_counts()
    meta.update(memory=mem, collectives=_histogram(counts),
                collectives_by_axis=counts)
    meta["model"] = {"total_params": cfg.total_params(),
                     "active_params": cfg.total_active_params(),
                     "n_layers": cfg.n_layers}
    return meta


def run_cell(arch: str, shape_name: str, mesh_kind: str, **kw
             ) -> Dict[str, Any]:
    """One cell on the single (16 x 16) or multi (2 x 16 x 16) mesh: its
    record, ``ok`` True."""
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
    rec = plan_cell(arch, shape_name, mesh, **kw)
    rec.update(mesh_kind=mesh_kind, ok=True)
    return rec


def iter_cells():
    for arch in ASSIGNED_ARCHS:
        cfg = get_config(arch)
        for shape in cfg.shapes():
            yield arch, shape.name


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=("single", "multi", "both"),
                    default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--ring-k", type=int, default=1)
    ap.add_argument("--microbatch", type=int, default=None)
    ap.add_argument("--out", default="dryrun_results.json")
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("--all, or --arch and --shape")

    cells = list(iter_cells()) if args.all else [(args.arch, args.shape)]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    results, failures = [], 0
    for arch, shape in cells:
        for mk in meshes:
            tag = f"{arch} x {shape} x {mk}"
            try:
                rec = run_cell(arch, shape, mk, ring_k=args.ring_k,
                               microbatch=args.microbatch)
            except Exception as e:                   # noqa: BLE001
                rec = {"arch": arch, "shape": shape, "mesh_kind": mk,
                       "ok": False, "error": f"{type(e).__name__}: {e}",
                       "traceback": traceback.format_exc()[-2000:]}
            if rec["ok"]:
                gib = rec["memory"]["argument_bytes"] / 2 ** 30
                print(f"OK   {tag:58s} path={rec['path']} "
                      f"args={gib:.2f} GiB/device "
                      f"plan={rec['plan_s']}s", flush=True)
            else:
                failures += 1
                print(f"FAIL {tag:58s} {rec['error']}", flush=True)
            results.append(rec)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print(f"\n{len(results) - failures}/{len(results)} cells planned "
          f"-> {args.out}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
