"""Halda: Heterogeneity-Aware Layer-to-Device Allocation (paper Alg. 1).

A copy of ``repro.core.halda`` (numpy, optional scipy): the port's
elastic ring failover re-plans through it.

Solves the LDA problem (Definition 1):

    min_{w,n}  L * (a.w + b.n + e.c) / (e.w) + kappa
    s.t.       1 <= w_m <= L,  0 <= n_m <= w_m,  L = k * sum(w),
               per-case RAM bounds, per-device VRAM bounds.

Strategy (Section 3.3):
  * enumerate k over the divisors of L  -> each k yields a standard ILP;
  * iterate the case assignment M1..M4 to a fixed point;
  * calibration: if a GPU is under-used while another device is overloaded,
    force the slowest-disk overloaded device into M4 and re-solve.

The ILP is solved with ``scipy.optimize.milp`` (HiGHS — the solver the paper
itself uses). A pure-python branch-and-bound fallback keeps the module
dependency-light; tests assert both agree on small instances.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .latency import (DISK_SPEED_THRESHOLD, ObjectiveData, build_objective,
                      classify_device, speculative_estimate, token_latency)
from .profiles import OS, Case, DeviceProfile, ModelProfile, divisors

try:  # HiGHS via scipy
    from scipy.optimize import Bounds, LinearConstraint, milp

    _HAVE_SCIPY = True
except Exception:  # pragma: no cover - exercised via force_fallback tests
    _HAVE_SCIPY = False


#: one ILP candidate: (w, n, k, analytic token latency)
Candidate = Tuple[Tuple[int, ...], Tuple[int, ...], int, float]


@dataclasses.dataclass
class HaldaSolution:
    w: List[int]
    n: List[int]
    k: int
    cases: List[Case]
    latency: float
    iterations: int
    relaxed: bool = False           # memory-consistency constraints dropped
    history: List[Tuple[int, float]] = dataclasses.field(default_factory=list)
    # every distinct (w, n, k) assignment the search evaluated — input to
    # the optional speculative post-pass
    candidates: List[Candidate] = dataclasses.field(default_factory=list)
    # filled by solve(..., spec=SpecPostPass(...))
    spec_report: Optional[List[dict]] = None

    @property
    def window_total(self) -> int:
        return sum(self.w)


@dataclasses.dataclass(frozen=True)
class SpecPostPass:
    """Inputs for the optional speculative post-pass on a Halda solve."""

    gamma: int = 4
    acceptance: float = 0.8
    draft_token_latency: float = 5e-3
    top: int = 8                     # candidates reported (by vanilla TPOT)


def speculative_post_pass(devices: Sequence[DeviceProfile],
                          model: ModelProfile, sol: "HaldaSolution",
                          spec: SpecPostPass) -> List[dict]:
    """Report each candidate assignment's TPOT with and without speculation.

    First step on the ROADMAP item of making Halda speculation-aware: the
    ILP still optimizes the vanilla decode objective, but the post-pass
    prices every candidate it visited under the acceptance-aware model
    (``latency.speculative_estimate``) so callers can see when the
    speculative ordering disagrees with the vanilla one — i.e. when a
    slightly slower vanilla assignment amortizes a gamma+1-token verify
    pass better (more streamed layers -> bigger once-per-pass win).
    """
    cands = list(sol.candidates)
    # the final assignment may differ from every ILP candidate (rebalance)
    cands.append((tuple(sol.w), tuple(sol.n), sol.k, sol.latency))
    # dedupe on the assignment, keep the best vanilla latency per key
    best: Dict[Tuple, Candidate] = {}
    for w, n, k, lat in cands:
        key = (w, n, k)
        if key not in best or lat < best[key][3]:
            best[key] = (w, n, k, lat)
    ordered = sorted(best.values(), key=lambda c: c[3])[:spec.top]
    rows = []
    for w, n, k, obj in ordered:
        # re-price vanilla under auto-classification so the two columns
        # are comparable (the solver's objective value is computed under
        # its assumed case assignment, which can differ)
        t_van = token_latency(devices, model, list(w), list(n))
        est = speculative_estimate(
            devices, model, list(w), list(n), gamma=spec.gamma,
            acceptance=spec.acceptance,
            draft_token_latency=spec.draft_token_latency)
        rows.append({
            "w": list(w), "n": list(n), "k": k,
            "objective": obj,
            "tpot_vanilla": t_van,
            "tpot_spec": est.tpot,
            "spec_speedup": est.speedup,
            "tokens_per_cycle": est.tokens_per_cycle,
            "chosen": list(w) == list(sol.w) and list(n) == list(sol.n)
                      and k == sol.k,
        })
    rows.sort(key=lambda r: r["tpot_vanilla"])
    return rows


# ---------------------------------------------------------------------------
# ILP for a fixed k  (eqs. 6-10)
# ---------------------------------------------------------------------------

def _case_rows(devices, model, obj: ObjectiveData, W: int, relax: bool):
    """Linear inequality rows for the per-case memory constraints.

    Returns (A, lb, ub) rows over x = [w_1..w_M, n_1..n_M].

    Besides the paper's overload-consistency bounds, overloaded devices get
    a *window-fit* upper bound: one round's streamed window must fit the
    reclaimable budget, or prefetch self-evicts ("prefetch-release", §3.1
    — "by setting the layer window size small, we ensure the model layers
    stay within memory limits"). The eq.(15) excess-reload cost model is
    only valid under this bound; without it the solver happily picks k=1
    windows that the real system would double-load.
    """
    M = len(devices)
    L = model.n_layers
    rows, lbs, ubs = [], [], []
    for i, (dev, case) in enumerate(zip(devices, obj.cases)):
        zi = obj.z_ram[i]
        cap = math.floor(zi * L + 1e-9)       # layers that fit the budget
        row_w = np.zeros(2 * M)
        row_w[i] = 1.0
        row_wn = np.zeros(2 * M)
        row_wn[i] = 1.0
        row_wn[M + i] = -1.0
        if case in (Case.M1, Case.M2):
            if relax:
                continue
            # overload consistency: w_m > W * z  ->  w_m >= floor(Wz)+1
            lo = math.floor(W * zi + 1e-9) + 1
            rows.append(row_w); lbs.append(lo); ubs.append(np.inf)
            # window fit (whole window streams on these platforms)
            rows.append(row_w.copy()); lbs.append(-np.inf)
            ubs.append(max(cap, 1))
        elif case == Case.M3:
            if relax:
                continue
            lo = math.floor(W * zi + 1e-9) + 1
            rows.append(row_wn); lbs.append(lo); ubs.append(np.inf)
            # window fit for the CPU-streamed part only
            rows.append(row_wn.copy()); lbs.append(-np.inf)
            ubs.append(max(cap, 1))
        else:  # M4: must NOT overload (hard even under relaxation)
            hi = math.floor(W * zi - 1e-9)
            if dev.os.value == "macos":
                rows.append(row_w)
            else:
                rows.append(row_wn)
            lbs.append(-np.inf); ubs.append(max(hi, 0 if dev.has_gpu else 1))
    return rows, lbs, ubs


def solve_ilp_fixed_k(devices: Sequence[DeviceProfile], model: ModelProfile,
                      obj: ObjectiveData, k: int, *, relax: bool = False,
                      force_fallback: bool = False
                      ) -> Optional[Tuple[List[int], List[int], float]]:
    """Solve the ILP (6-10) for one k. Returns (w, n, objective) or None."""
    L = model.n_layers
    if L % k:
        return None
    W = L // k
    M = len(devices)
    if W < M:  # every device needs >= 1 layer per round
        return None

    cost = np.concatenate([k * np.asarray(obj.a), k * np.asarray(obj.b)])

    lo = np.zeros(2 * M)
    hi = np.zeros(2 * M)
    lo[:M] = 1.0
    hi[:M] = W - (M - 1)
    for i, dev in enumerate(devices):
        cap = math.floor(W * obj.z_gpu[i] + 1e-9)
        hi[M + i] = min(cap, W) if dev.has_gpu else 0.0
    if np.any(lo > hi + 1e-9):
        return None

    rows = [np.concatenate([np.ones(M), np.zeros(M)])]   # sum w == W
    lbs, ubs = [W], [W]
    for i in range(M):                                   # n_m <= w_m
        r = np.zeros(2 * M)
        r[M + i] = 1.0
        r[i] = -1.0
        rows.append(r); lbs.append(-np.inf); ubs.append(0.0)
    cr, clb, cub = _case_rows(devices, model, obj, W, relax)
    rows += cr; lbs += clb; ubs += cub

    A = np.vstack(rows)
    if _HAVE_SCIPY and not force_fallback:
        res = milp(c=cost,
                   constraints=LinearConstraint(A, np.asarray(lbs),
                                                np.asarray(ubs)),
                   integrality=np.ones(2 * M),
                   bounds=Bounds(lo, hi))
        if not res.success or res.x is None:
            return None
        x = np.round(res.x).astype(int)
    else:
        x = _fallback_bnb(cost, A, np.asarray(lbs), np.asarray(ubs), lo, hi, M, W)
        if x is None:
            return None
    w = x[:M].tolist()
    n = x[M:].tolist()
    value = float(cost @ x)
    return w, n, value


def _fallback_bnb(cost, A, lbs, ubs, lo, hi, M, W):
    """Tiny exact solver: enumerate w compositions (bounded), greedy n.

    Only used when scipy is absent or in tests; fine for M <= 6 and the
    divisor-limited W values that occur in practice.
    """
    best = None
    best_val = np.inf
    w_ranges = [range(int(lo[i]), int(hi[i]) + 1) for i in range(M)]

    def feasible(x):
        v = A @ x
        return np.all(v >= lbs - 1e-9) and np.all(v <= ubs + 1e-9)

    for w in itertools.product(*w_ranges):
        if sum(w) != W:
            continue
        # choose n greedily per device: cost coef of n is cost[M+i]; n in
        # [0, min(w_i, hi[M+i])]; constraints couple w,n only per device.
        n = [0] * M
        for i in range(M):
            n_max = int(min(w[i], hi[M + i]))
            n[i] = n_max if cost[M + i] < 0 else 0
        x = np.array(list(w) + n, dtype=float)
        if not feasible(x):
            # try the flipped n choice per device (small search)
            ok = False
            for flips in itertools.product([0, 1], repeat=M):
                n2 = [int(min(w[i], hi[M + i])) if f else 0
                      for i, f in enumerate(flips)]
                x = np.array(list(w) + n2, dtype=float)
                if feasible(x):
                    ok = True
                    break
            if not ok:
                continue
        val = float(cost @ x)
        if val < best_val:
            best_val = val
            best = x.astype(int)
    return best


# ---------------------------------------------------------------------------
# Algorithm 1
# ---------------------------------------------------------------------------

def _initial_windows(devices: Sequence[DeviceProfile], L: int) -> List[int]:
    """Line 1: windows proportional to memory budgets, summing to L (k=1)."""
    budgets = np.array([d.memory_budget() for d in devices], dtype=float)
    if budgets.sum() <= 0:
        budgets = np.ones(len(devices))
    w = np.maximum(np.floor(budgets / budgets.sum() * L), 1).astype(int)
    # fix rounding so sum == L
    while w.sum() > L:
        w[np.argmax(w)] -= 1
    while w.sum() < L:
        w[np.argmax(budgets - w / max(L, 1))] += 1
    return w.tolist()


def _gpu_underused_and_overload(devices, model, obj, w, n, W) -> bool:
    """Calibration trigger (Alg. 1 line 13)."""
    gpu_free = False
    for i, dev in enumerate(devices):
        if dev.has_gpu:
            cap = math.floor(W * obj.z_gpu[i] + 1e-9)
            if n[i] < min(cap, w[i]):
                gpu_free = True
    overloaded = any(c in (Case.M1, Case.M2, Case.M3) for c in obj.cases)
    return gpu_free and overloaded


def overload_case(dev: DeviceProfile) -> Case:
    """The (single) overload case a device can be in, by OS (Section 3.2)."""
    if dev.os == OS.MACOS and dev.has_metal:
        return Case.M2
    if dev.os == OS.MACOS:
        return Case.M1
    return Case.M3  # Linux / Android / TPU stage


def solve_exact(devices: Sequence[DeviceProfile], model: ModelProfile, *,
                force_fallback: bool = False,
                max_enum_devices: int = 10) -> Optional[HaldaSolution]:
    """Exact LDA: enumerate consistent case assignments × divisors of L.

    Beyond-paper refinement (recorded in DESIGN.md): Algorithm 1's
    fixed-point iteration can stall in a local optimum when every GPU is
    full (the calibration trigger never fires), e.g. leaving a slow-disk
    macOS device overloaded in M2. Each device has only two possible cases
    — its OS-specific overload case or M4 — so for M <= ``max_enum_devices``
    we can enumerate all 2^M consistent assignments; the ILP's own
    consistency rows guarantee the assumed cases hold at the optimum, which
    makes the search exact for the LDA model under Assumption 1.
    """
    M = len(devices)
    if M > max_enum_devices:
        return None
    L = model.n_layers
    ks = [k for k in divisors(L) if L // k >= M]
    if not ks:
        ks = [1]
    choices = []
    for dev in devices:
        if dev.disk_speed() < DISK_SPEED_THRESHOLD:
            choices.append((Case.M4,))
        else:
            choices.append((overload_case(dev), Case.M4))
    best: Optional[HaldaSolution] = None
    history: List[Tuple[int, float]] = []
    cands: List[Candidate] = []
    for cases in itertools.product(*choices):
        obj = build_objective(devices, model, list(cases))
        for k in ks:
            out = solve_ilp_fixed_k(devices, model, obj, k,
                                    force_fallback=force_fallback)
            if out is None:
                continue
            wk, nk, _ = out
            lat = token_latency(devices, model, wk, nk, cases)
            history.append((k, lat))
            cands.append((tuple(wk), tuple(nk), k, lat))
            if best is None or lat < best.latency:
                best = HaldaSolution(w=wk, n=nk, k=k, cases=list(cases),
                                     latency=lat, iterations=0,
                                     history=history)
    if best is not None:
        best.candidates = cands
    return best


def solve(devices: Sequence[DeviceProfile], model: ModelProfile, *,
          max_iters: int = 32, force_fallback: bool = False,
          paper_faithful: bool = False,
          spec: Optional[SpecPostPass] = None) -> HaldaSolution:
    """Run Halda (Algorithm 1); unless ``paper_faithful``, refine with the
    exact case-enumeration search and return the better of the two.

    ``spec``: optional speculative post-pass — prices every candidate
    assignment with and without speculation (``sol.spec_report``)."""
    sol = _solve_inner(devices, model, max_iters=max_iters,
                       force_fallback=force_fallback,
                       paper_faithful=paper_faithful)
    if spec is not None:
        sol.spec_report = speculative_post_pass(devices, model, sol, spec)
    return sol


def _solve_inner(devices: Sequence[DeviceProfile], model: ModelProfile, *,
                 max_iters: int = 32, force_fallback: bool = False,
                 paper_faithful: bool = False) -> HaldaSolution:
    M = len(devices)
    L = model.n_layers
    if M == 1:
        dev = devices[0]
        w = [L]
        kvb = model.kv_bytes_layer
        per_layer = model.layer_bytes + kvb
        cap = int((dev.gpu_budget() - model.c_gpu) // per_layer) \
            if dev.has_gpu else 0
        n = [max(0, min(L, cap))]
        cases = [classify_device(dev, 0, model, w[0], n[0], 1)]
        lat = token_latency(devices, model, w, n)
        return HaldaSolution(w=w, n=n, k=1, cases=cases, latency=lat,
                             iterations=0,
                             candidates=[(tuple(w), tuple(n), 1, lat)])

    ks = [k for k in divisors(L) if L // k >= M]
    if not ks:
        ks = [1]

    w = _initial_windows(devices, L)
    n = [0] * M
    forced: set = set()
    prev_cases: Optional[List[Case]] = None
    best: Optional[HaldaSolution] = None
    relaxed_mode = False
    history: List[Tuple[int, float]] = []
    cands: List[Candidate] = []

    for it in range(max_iters):
        W = sum(w)
        k_now = max(1, round(L / max(W, 1)))
        cases = [classify_device(d, i, model, w[i], n[i], k_now,
                                 forced_m4=(i in forced))
                 for i, d in enumerate(devices)]
        if cases != prev_cases:
            prev_cases = cases
            continue

        obj = build_objective(devices, model, cases)
        round_best: Optional[Tuple[List[int], List[int], float, int]] = None
        for k in ks:
            out = solve_ilp_fixed_k(devices, model, obj, k,
                                    relax=relaxed_mode,
                                    force_fallback=force_fallback)
            if out is None:
                continue
            wk, nk, _ = out
            lat = token_latency(devices, model, wk, nk, cases)
            history.append((k, lat))
            cands.append((tuple(wk), tuple(nk), k, lat))
            if round_best is None or lat < round_best[2]:
                round_best = (wk, nk, lat, k)

        if round_best is None:
            if not relaxed_mode:
                relaxed_mode = True   # drop overload-consistency rows
                prev_cases = None
                continue
            break

        wk, nk, lat, kk = round_best
        Wk = sum(wk)
        obj_k = build_objective(devices, model, cases)
        if _gpu_underused_and_overload(devices, model, obj_k, wk, nk, Wk):
            candidates = [i for i, c in enumerate(cases)
                          if c in (Case.M1, Case.M2, Case.M3)
                          and i not in forced]
            if candidates:
                slowest = min(candidates,
                              key=lambda i: devices[i].disk_speed())
                forced.add(slowest)
                prev_cases = None
                continue

        if wk == w and nk == n:
            best = HaldaSolution(w=wk, n=nk, k=kk, cases=cases, latency=lat,
                                 iterations=it + 1, relaxed=relaxed_mode,
                                 history=history)
            break
        w, n = wk, nk
        best = HaldaSolution(w=wk, n=nk, k=kk, cases=cases, latency=lat,
                             iterations=it + 1, relaxed=relaxed_mode,
                             history=history)

    if best is None:
        # final fallback: memory-proportional with no GPU layers
        w = _initial_windows(devices, L)
        n = [0] * M
        cases = [classify_device(d, i, model, w[i], n[i], 1)
                 for i, d in enumerate(devices)]
        best = HaldaSolution(w=w, n=n, k=1, cases=cases,
                             latency=token_latency(devices, model, w, n),
                             iterations=max_iters, relaxed=True,
                             history=history)
    if not paper_faithful:
        exact = solve_exact(devices, model, force_fallback=force_fallback)
        if exact is not None:
            cands.extend(exact.candidates)
            if exact.latency < best.latency:
                exact = dataclasses.replace(exact,
                                            iterations=best.iterations)
                best = exact
        best = _rebalance(devices, model, best)
    best.candidates = cands
    return best


def _rebalance(devices: Sequence[DeviceProfile], model: ModelProfile,
               sol: HaldaSolution) -> HaldaSolution:
    """Latency-neutral tie-break: the paper's sum-form objective is
    indifferent to how a tie is split (e.g. [1,1,1,9] vs [3,3,3,3] on a
    homogeneous cluster), but a real pipeline prefers balanced windows
    (the max-form bubble argument). Greedily move layers from the largest
    window to the smallest while analytic latency does not increase."""
    w = list(sol.w)
    n = list(sol.n)
    best_lat = sol.latency
    L = model.n_layers
    for _ in range(L):
        hi = max(range(len(w)), key=lambda i: w[i])
        if w[hi] <= 1:
            break
        moved = False
        # try receivers from smallest window up (a straggler may refuse
        # extra layers — the next-smallest device can still take them)
        for lo in sorted(range(len(w)), key=lambda i: w[i]):
            if lo == hi or w[hi] - w[lo] <= 1:
                continue
            cand_w = list(w)
            cand_n = list(n)
            cand_w[hi] -= 1
            cand_w[lo] += 1
            if cand_n[hi] > cand_w[hi]:      # keep n <= w: move a GPU layer
                cand_n[hi] -= 1
                if devices[lo].has_gpu:
                    cand_n[lo] = min(cand_n[lo] + 1, cand_w[lo])
            lat = token_latency(devices, model, cand_w, cand_n)
            if lat <= best_lat + 1e-12:
                w, n = cand_w, cand_n
                best_lat = min(best_lat, lat)
                moved = True
                break
        if not moved:
            break
    if w == list(sol.w) and n == list(sol.n):
        return sol
    k = L // sum(w) if sum(w) and L % sum(w) == 0 else sol.k
    cases = [classify_device(d, i, model, w[i], n[i], max(k, 1))
             for i, d in enumerate(devices)]
    return dataclasses.replace(sol, w=w, n=n, k=k, cases=cases,
                               latency=best_lat)


def brute_force(devices: Sequence[DeviceProfile], model: ModelProfile,
                max_W: Optional[int] = None) -> HaldaSolution:
    """Exhaustive LDA search (tiny instances only; test oracle)."""
    M = len(devices)
    L = model.n_layers
    best: Optional[HaldaSolution] = None
    for k in divisors(L, exclude_self=False):
        W = L // k
        if W < M or (max_W and W > max_W):
            continue
        for w in itertools.product(range(1, W + 1), repeat=M):
            if sum(w) != W:
                continue
            n_ranges = []
            for i, dev in enumerate(devices):
                if dev.has_gpu:
                    n_ranges.append(range(0, w[i] + 1))
                else:
                    n_ranges.append(range(0, 1))
            for n in itertools.product(*n_ranges):
                cases = [classify_device(d, i, model, w[i], n[i], k)
                         for i, d in enumerate(devices)]
                # respect VRAM capacity
                obj = build_objective(devices, model, cases)
                ok = True
                for i, dev in enumerate(devices):
                    if n[i] > math.floor(W * obj.z_gpu[i] + 1e-9):
                        ok = False
                if not ok:
                    continue
                lat = token_latency(devices, model, list(w), list(n), cases)
                if best is None or lat < best.latency:
                    best = HaldaSolution(w=list(w), n=list(n), k=k,
                                         cases=cases, latency=lat,
                                         iterations=0)
    assert best is not None
    return best
