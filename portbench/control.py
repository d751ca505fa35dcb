"""Readings that set a cell's correctness limit (not run by the
benchmark's own runs): for each seed, one run of the cell at its own load
with a short window, the program's widest logit gap and ``correct``, and
the fp8 control's gap on the same sample (``check.control_gap``) with
the ``correct`` that the same limit gives it, one JSON line a seed, all
in one process:

    python3 portbench/control.py --workload <cell> --seconds 20 \
        --seeds 11 12 13 [--program-only 14 15 ...]
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--program-only", type=int, nargs="*", default=[])
    args = ap.parse_args()

    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    torch.set_num_threads(4)
    for seed in [*args.seeds, *args.program_only]:
        t = time.perf_counter()
        r = harness.run_cell(ROOT, args.workload, seed, args.seconds, False,
                             t_proc=t, control=seed in args.seeds)
        print(json.dumps({
            "workload": args.workload, "seed": seed,
            "program_gap": r["checks"]["logit_gap"]["value"],
            "correct": r["correct"],
            "limit": r["checks"]["logit_gap"]["limit"],
            "control_gap": r.get("control", {}).get("logit_gap"),
            "control_correct": r.get("control", {}).get("correct"),
            "attempted": r["attempted"], "failed": r["failed"],
            "metrics": {k: v["value"] for k, v in r["metrics"].items()},
            "s": time.perf_counter() - t}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
