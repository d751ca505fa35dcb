"""One run of one cell: everything is found by name from
``BENCHMARK.json`` -- the workload's configuration file
(``configs/<config>.json``), its traffic mix (``traffic/<traffic>.json``),
its correctness limit (``limits/<workload>.json``) and a reader per
metric (``metrics/<metric>.py``, a ``read(ctx)`` that returns a number or
None)."""
from __future__ import annotations

import gc
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

from . import check, driver, stats, weights
from .trace import DeviceTrace
from .traffic import Traffic

HERE = Path(__file__).resolve().parent
#: seconds of the window that a traced run records: its last (open loop)
#: or its first (closed loop, whose pool has no fixed end)
TRACE_SECONDS = 6.0
#: seconds an open-loop run may drain after its window before it stops
DRAIN_SECONDS = 120.0


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def spec(root: Path) -> dict:
    return load_json(root / "BENCHMARK.json")


def workload(sp: dict, name: str) -> dict:
    for w in sp["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_entry(sp: dict, name: str) -> dict:
    for c in sp["configs"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def metrics_of(sp: dict, cell: str, traced: bool) -> List[dict]:
    """The metrics a cell reports: its end-to-end ones untraced, its
    per-layer ones traced (a metric without ``workloads`` is every
    cell's)."""
    group = sp["per_layer"] if traced else sp["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def reader(name: str):
    path = HERE / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


class Ctx:
    """What a metric reader reads."""

    def __init__(self, **kw):
        self.notes: List[str] = []
        self.__dict__.update(kw)

    def note(self, text: str) -> None:
        self.notes.append(text)


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def run_cell(root: Path, name: str, seed: int, seconds: float, traced: bool,
             *, t_proc: float, device: str = "cuda", hooks=None,
             bench: Path = HERE, control: bool = False) -> dict:
    """Run one cell; returns the result line's object. ``hooks(eng)``, if
    given, runs on the built engine before the warm-up (tests break the
    timed path through it); ``bench`` holds the cell's ``configs/``,
    ``traffic/`` and ``limits/`` (tests give tiny ones). ``control``:
    also read the fp8 control's widest gap on the same sample and judge
    it by the same limit (``control.py``; the benchmark's own runs do
    not)."""
    import torch

    sp = spec(root)
    cell = workload(sp, name)
    conf_path = bench / "configs" / f"{cell['config']}.json"
    if (root / config_entry(sp, cell["config"])["file"]).resolve() \
            != conf_path.resolve():
        raise ValueError(f"{name}: BENCHMARK.json's file for "
                         f"{cell['config']} is not {conf_path}")
    conf = load_json(conf_path)
    mix = load_json(bench / "traffic" / f"{cell['traffic']}.json")
    limit = load_json(bench / "limits" / f"{name}.json")
    m, wfmt = conf["model"], conf["weights"]
    dev = torch.device(device)

    w = weights.make(m, wfmt, seed, dev)
    from . import program
    eng, cache, close, kv = program.build(conf, mix, w, dev)
    if hooks is not None:
        hooks(eng)
    traffic = Traffic(mix, seed, m["vocab"])
    eng.run(cache, traffic.warmup())
    eng.finished.clear()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    trace = None
    if traced:
        trace = DeviceTrace(min(seconds, TRACE_SECONDS))
        trace.warm()
    t_setup = time.perf_counter()
    setup_s = t_setup - t_proc
    log(f"{name}: seed {seed}, set-up {setup_s:.3f} s, weights "
        f"{weights.nbytes(w) / 1e9:.2f} GB")

    if mix["loop"] == "closed":
        rec = driver.Recorder(eng, traced=traced, trace=trace)
        t0, t_end, sent = driver.closed_loop(
            eng, cache, rec, traffic.closed_loop(seconds),
            min(seconds, TRACE_SECONDS))
        t_close = t_end
    else:
        reqs = traffic.open_loop(seconds)
        rec = driver.Recorder(eng, traced=traced, trace=trace,
                              deadline=time.perf_counter() + seconds
                              + DRAIN_SECONDS)
        t0, t_end, sent = driver.open_loop(eng, cache, rec, reqs, seconds)
        t_close = t0 + seconds
    log(f"window: {len(rec.recs)} requests, {t_end - t0:.3f} s from its "
        f"start to its last completion")
    done = rec.collect()
    for u in done:
        done[u] = (sent[u].prompt, done[u][1])
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    recs = list(rec.recs.values())

    ctx = Ctx(cell=name, loop=mix["loop"], model=m, weights=wfmt,
              engine=conf["engine"], slots=int(mix["slots"]),
              seconds=seconds, setup_s=setup_s, t0=t0, t_close=t_close,
              t_end=t_end, recs=recs, events=rec.events, trace=trace,
              decodes=rec.decodes, prefills=rec.prefills)
    metrics: Dict[str, dict] = {}
    for mt in metrics_of(sp, name, traced):
        v = reader(mt["name"])(ctx)
        if v is not None:
            metrics[mt["name"]] = {"value": float(v), "unit": mt["unit"]}
    for n in ctx.notes:
        log(n)
    out = {"attempted": len(recs), "failed": stats.failed(recs),
           "metrics": metrics}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev)
                   if dev.type == "cuda" else "cpu",
                   "count": int(cell["chips"]), "memory_peak_bytes": peak}
    if trace is not None and trace.t1 is not None:
        busy, _ = trace.busy()
        log(f"trace: {len(trace.kernels)} device events in "
            f"{trace.window_s:.2f} s; starting, stopping and reading took "
            f"{trace.cost_s:.1f} s")
        device_info["busy_s"] = busy
        device_info["window_s"] = trace.window_s
        out["breakdown"] = trace.breakdown(rec.spans)
        trace.kernels = []
    if kv is not None:
        # the page pool is reserved whole in set-up; what the traffic
        # filled of it (the warm-up's one request included)
        st = kv.stats()
        device_info["kv_pages_peak"] = st.active_pages_highwater
        device_info["kv_pages"] = st.n_pages
        device_info["kv_peak_bytes"] = st.active_pages_highwater \
            * st.page_bytes
        log(f"KV pages: at most {st.active_pages_highwater} of "
            f"{st.n_pages} in use "
            f"({device_info['kv_peak_bytes'] / 1e9:.2f} of "
            f"{st.n_pages * st.page_bytes / 1e9:.2f} GB)")
    if dev.type == "cuda":
        device_info["power_limit"] = power_limit()
    out["device"] = device_info

    # the program's state goes before the reference runs
    del eng, cache, rec, ctx, kv
    close()
    del close
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    uids = check.sample(done, seed, int(mix["check_tokens"]),
                        int(mix["check_ref_tokens"]))
    t_ref = time.perf_counter()
    gap, n_cmp, sep = check.widest_gap(w, m, done, uids, dev) if uids \
        else (None, 0, None)
    log(f"reference: {len(uids)} requests, {n_cmp} served tokens "
        f"compared, median top-2 separation {sep}, "
        f"{time.perf_counter() - t_ref:.1f} s")
    checks = {"logit_gap": {"value": gap, "limit": limit["logit_gap"]},
              "failed_requests": {"value": out["failed"], "limit": 0}}
    correct = gap is not None and gap <= limit["logit_gap"] \
        and out["failed"] == 0
    result = {"correct": bool(correct), **out}
    if control and uids:
        # the control in the program's place, held to the same limit
        cg = check.control_gap(w, m, done, uids, dev)
        result["control"] = {"logit_gap": cg,
                             "correct": cg <= limit["logit_gap"]}
    result["checks"] = checks
    return result
