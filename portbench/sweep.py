"""The knee of an open-loop cell: its engine built once, then the mix
offered at each of a few fixed rates in turn (lowest first), each for a
window of ``--seconds``; a line a rate with the tokens per second
completed in the window, time to first token (p50, p90, and the mean of
the first and of the last quarter of arrivals: a backlog that grows shows
as the second far above the first) and the requests still waiting when
the window closed. The cell's rate is then set to about 4/5 of the
highest rate whose backlog does not grow.

    python3 portbench/sweep.py --workload <cell> --rates 1.5 2 2.5 3
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
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--drain", type=float, default=60.0)
    ap.add_argument("--seed", type=int, default=5)
    args = ap.parse_args()

    import torch

    from portbench import driver, harness, program, stats, weights
    from portbench.traffic import Traffic

    sp = harness.spec(ROOT)
    cell = harness.workload(sp, args.workload)
    conf = harness.load_json(harness.HERE / "configs"
                             / f"{cell['config']}.json")
    mix = harness.load_json(harness.HERE / "traffic"
                            / f"{cell['traffic']}.json")
    dev = torch.device("cuda")
    m = conf["model"]
    w = weights.make(m, conf["weights"], args.seed, dev)
    eng, cache, close, _ = program.build(conf, mix, w, dev)
    eng.run(cache, Traffic(mix, args.seed, m["vocab"]).warmup())
    base = {k: getattr(eng, k) for k in ("admit", "step")}
    for i, rate in enumerate(args.rates):
        for k, f in base.items():
            setattr(eng, k, f)
        eng.finished.clear()
        reqs = Traffic({**mix, "rate_per_s": rate}, args.seed + i,
                       m["vocab"]).open_loop(args.seconds)
        rec = driver.Recorder(eng, traced=False, deadline=time.perf_counter()
                              + args.seconds + args.drain)
        t0, t_end, _ = driver.open_loop(eng, cache, rec, reqs, args.seconds)
        rec.collect()
        recs = sorted(rec.recs.values(), key=lambda r: r.due)
        q = max(1, len(recs) // 4)

        def mean_ttft(rs):
            v = [(r.first if r.first is not None else t_end) - r.due
                 for r in rs]
            return sum(v) / len(v)
        waiting = sum(1 for r in recs if r.due <= t0 + args.seconds and
                      (r.admit is None or r.admit > t0 + args.seconds))
        print(json.dumps({
            "rate": rate, "requests": len(recs),
            "tokens_per_s": stats.tokens_per_s_open(rec.events, t0,
                                                    args.seconds),
            "ttft_p50_ms": stats.ttft_ms(recs, 50, t_end),
            "ttft_p90_ms": stats.ttft_ms(recs, 90, t_end),
            "tpot_ms": stats.tpot_ms(recs, t0 + args.seconds),
            "ttft_first_quarter_s": mean_ttft(recs[:q]),
            "ttft_last_quarter_s": mean_ttft(recs[-q:]),
            "waiting_at_close": waiting, "failed": stats.failed(recs),
            "drain_s": t_end - t0 - args.seconds}), flush=True)
        if stats.failed(recs):
            break                  # the drain overran: the engine is spent
    close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
