"""How ``correct`` is decided: once the window has closed and the
program's state is freed, the plain reference (``reference/dense.py``)
runs once over each sampled finished request's prompt and served tokens,
and the widest gap by which a served (greedy) token's logit lies below
the reference's best at its position is held to the cell's limit
(``limits/<workload>.json``). The sample is drawn from the seed among
the requests the run finished: the one with the most served tokens, then
others until ``check_tokens`` served tokens, within ``check_ref_tokens``
tokens of reference work."""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from .reference import dense


def sample(done: Dict[int, Tuple[np.ndarray, List[int]]], seed: int,
           check_tokens: int, ref_tokens: int) -> List[int]:
    """uids of the sampled requests (``done``: uid -> (prompt, served))."""
    if not done:
        return []
    uids = sorted(done)
    longest = max(uids, key=lambda u: (len(done[u][1]), len(done[u][0])))
    chosen = [longest]
    served = len(done[longest][1])
    work = len(done[longest][0]) + served
    rng = np.random.default_rng([seed % (1 << 63), 3])
    for u in rng.permutation(uids):
        u = int(u)
        if served >= check_tokens:
            break
        cost = len(done[u][0]) + len(done[u][1])
        if u == longest or work + cost > ref_tokens:
            continue
        chosen.append(u)
        served += len(done[u][1])
        work += cost
    return chosen


def sequences(done, uids, device) -> Tuple[list, list, list]:
    """(token sequences, logit rows, served tokens): the prompt and every
    served token but the last, whose logits at rows p-1 .. p+n-2 chose
    the n served tokens."""
    seqs, rows, served = [], [], []
    for u in uids:
        prompt, toks = done[u]
        p, n = len(prompt), len(toks)
        seq = np.concatenate([np.asarray(prompt, np.int64),
                              np.asarray(toks[:-1], np.int64)])
        seqs.append(torch.as_tensor(seq, device=device))
        rows.append((p - 1, p + n - 1))
        served.append(torch.as_tensor(np.asarray(toks, np.int64),
                                      device=device))
    return seqs, rows, served


def gaps(ref: Sequence[torch.Tensor], chosen: Sequence[torch.Tensor]
         ) -> List[float]:
    """Per sequence, the widest gap max(ref row) - ref row[chosen]."""
    out = []
    for r, c in zip(ref, chosen):
        g = r.max(-1).values - r.gather(-1, c[:, None])[:, 0]
        out.append(float(g.max()))
    return out


def separation(ref: Sequence[torch.Tensor]) -> float:
    """The median over rows of the reference's best logit less its
    second: how near the ties are that a gap can come from."""
    top = torch.cat([r.topk(2, dim=-1).values for r in ref])
    return float((top[:, 0] - top[:, 1]).median())


def widest_gap(w: dict, m: dict, done, uids, device
               ) -> Tuple[float, int, float]:
    """(widest gap of the served tokens under the reference, tokens
    compared, the reference's median top-2 separation)."""
    seqs, rows, served = sequences(done, uids, device)
    ref = dense.logits(w, m, seqs, rows)
    return (max(gaps(ref, served)), int(sum(len(s) for s in served)),
            separation(ref))


def control_gap(w: dict, m: dict, done, uids, device) -> float:
    """The fp8 control's widest gap: at each position of the same prompts
    and served tokens, the gap under the float32 reference of the token
    that the fp8 reference puts first."""
    seqs, rows, _ = sequences(done, uids, device)
    ref = dense.logits(w, m, seqs, rows)
    low = dense.logits(w, m, seqs, rows, precision="fp8")
    return max(gaps(ref, [x.argmax(-1) for x in low]))
