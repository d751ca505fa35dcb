"""The dense GQA decoder (Qwen2: RMSNorm, rotary positions on q and k,
q/k/v biases, grouped-query causal attention, a SiLU-gated feed-forward,
an untied head) in float32 plain PyTorch, with TF32 off, layer by layer
over a few sequences at once, from the benchmark's weights. A q4
projection is unpacked and scaled here from its packed bytes and group
scales.

``precision="fp8"`` is the control, the step below the configurations'
bf16: every matrix product takes its activations (and a bf16 weight, per
output column) rounded to float8 e4m3 with a scale a row, and attention
its q, k and v (a scale a position and head) and its probabilities (a
scale a row)."""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch

PROJ = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
#: rows of queries attended at once (bounds the score block's memory)
QUERY_BLOCK = 1024
FP8_MAX = 448.0


def tf32_off() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def unpack_q4(packed: torch.Tensor, scale: torch.Tensor, group: int
              ) -> torch.Tensor:
    """(K/2, N) int8 of two 4-bit values (row 2i low nibble, 2i + 1 high
    nibble, two's complement) and (K/group, N) scales -> (K, N) f32."""
    p = packed.to(torch.int32)
    lo = p & 0xF
    hi = (p >> 4) & 0xF
    lo = lo - 16 * (lo >= 8).to(torch.int32)
    hi = hi - 16 * (hi >= 8).to(torch.int32)
    Kh, N = packed.shape
    q = torch.stack([lo, hi], dim=1).reshape(2 * Kh, N).float()
    s = scale.float()
    return (q.reshape(2 * Kh // group, group, N) * s[:, None, :]).reshape(
        2 * Kh, N)


def layer_weight(w: dict, name: str, i: int) -> torch.Tensor:
    v = w[name]
    if isinstance(v, dict):
        return unpack_q4(v["packed"][i], v["scale"][i], int(v["group"]))
    return v[i].float()


def fp8_round(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale per slice along ``dim``."""
    s = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


def mm(x: torch.Tensor, wt: torch.Tensor, precision: str, q4: bool
       ) -> torch.Tensor:
    if precision == "fp8":
        x = fp8_round(x, -1)
        if not q4:
            wt = fp8_round(wt, 0)
    return x @ wt


def rms_norm(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * g.float()


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (S, h, D) at positions 0..S-1: each half-pair (i, i + D/2)
    turned by position * theta^(-2i/D)."""
    S, _, D = x.shape
    inv = 1.0 / theta ** (torch.arange(0, D, 2, dtype=torch.float64,
                                       device=x.device) / D)
    ang = torch.arange(S, dtype=torch.float64, device=x.device)[:, None] * inv
    cos = torch.cos(ang).float()[:, None, :]
    sin = torch.sin(ang).float()[:, None, :]
    a, b = x[..., :D // 2], x[..., D // 2:]
    return torch.cat([a * cos - b * sin, a * sin + b * cos], dim=-1)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     precision: str = "float32") -> torch.Tensor:
    """q (S, H, D), k and v (S, hk, D): query head h reads key head
    h // (H / hk)."""
    S, H, D = q.shape
    if precision == "fp8":
        q, k, v = (fp8_round(t, -1) for t in (q, k, v))
    rep = H // k.shape[1]
    k = k.repeat_interleave(rep, dim=1)
    v = v.repeat_interleave(rep, dim=1)
    out = torch.empty_like(q)
    for i0 in range(0, S, QUERY_BLOCK):
        i1 = min(S, i0 + QUERY_BLOCK)
        s = torch.einsum("qhd,khd->hqk", q[i0:i1], k[:i1]) / math.sqrt(D)
        rows = torch.arange(i0, i1, device=q.device)[:, None]
        cols = torch.arange(i1, device=q.device)[None, :]
        s = s.masked_fill(cols > rows, float("-inf"))
        p = torch.softmax(s, -1)
        if precision == "fp8":
            p = fp8_round(p, -1)
        out[i0:i1] = torch.einsum("hqk,khd->qhd", p, v[:i1])
    return out


def logits(w: dict, m: dict, seqs: Sequence[torch.Tensor],
           rows: Sequence[Tuple[int, int]], precision: str = "float32"
           ) -> List[torch.Tensor]:
    """The logits (hi - lo, V) f32 at rows [lo, hi) of each sequence
    (1-D token ids, positions from 0)."""
    tf32_off()
    L, H, hk, hd = m["n_layers"], m["n_heads"], m["kv_heads"], m["head_dim"]
    eps, theta = float(m["norm_eps"]), float(m["rope_theta"])
    q4 = isinstance(w["wq"], dict)
    xs = [w["embed"][s.long()].float() for s in seqs]
    with torch.no_grad():
        for i in range(L):
            W = {name: layer_weight(w, name, i) for name in PROJ}
            for j, x in enumerate(xs):
                S = x.shape[0]
                h = rms_norm(x, w["attn_norm"][i], eps)
                q = mm(h, W["wq"], precision, q4) + w["bq"][i].float()
                k = mm(h, W["wk"], precision, q4) + w["bk"][i].float()
                v = mm(h, W["wv"], precision, q4) + w["bv"][i].float()
                q = rope(q.reshape(S, H, hd), theta)
                k = rope(k.reshape(S, hk, hd), theta)
                a = causal_attention(q, k, v.reshape(S, hk, hd),
                                     precision)
                x = x + mm(a.reshape(S, H * hd), W["wo"], precision, q4)
                h = rms_norm(x, w["ffn_norm"][i], eps)
                g = mm(h, W["w_gate"], precision, q4)
                u = mm(h, W["w_up"], precision, q4)
                x = x + mm(torch.nn.functional.silu(g) * u, W["w_down"],
                           precision, q4)
                xs[j] = x
            del W
        head = w["unembed"].float()
        out = []
        for x, (lo, hi) in zip(xs, rows):
            h = rms_norm(x[lo:hi], w["final_norm"], eps)
            out.append(mm(h, head, precision, False))
    return out
