"""Seeded random weights, made on the device in a few large calls, in the
types they are served in, and held in the benchmark's own layout (which
both the program adapter and the reference read):

  embed (V, d), unembed (d, V), final_norm (d,)            bf16
  attn_norm, ffn_norm (L, d); bq (L, H hd), bk, bv (L, hk hd)  bf16
  wq, wk, wv, wo, w_gate, w_up, w_down:
      bf16 (L, K, N), or for q4 {"packed": int8 (L, K/2, N),
      "scale": bf16 (L, K/group, N), "group": g}: two 4-bit values a
      byte along K (row 2i in the low nibble, 2i + 1 in the high one,
      two's complement), one scale a group of g rows and a column.

Projections are normal with a standard deviation of 1/sqrt(K) (q4: the
values uniform over [-7, 7], the range a symmetric 4-bit quantizer
writes, with mean 0 as a trained weight's; the scales uniform in
[0.5, 1.5) times 1/(4.32 sqrt(K)), 4.32 being the values' standard
deviation); norms 1 + 0.05 normal, biases 0.1 normal, the embedding
0.02 normal, the head 1/sqrt(d) normal. (Values over all 16 nibbles,
-8 included, have mean -0.5: every projection then adds a common
component that grows over 64 layers until attention saturates and a
rounding flips whole tokens; a trained model has no such drift.)
"""
from __future__ import annotations

import math
from typing import Dict

import torch

PROJ = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
#: standard deviation of a value uniform over the 15 integers [-7, 7]
NIBBLE_STD = math.sqrt((15 ** 2 - 1) / 12.0)


def proj_shapes(m: dict) -> Dict[str, tuple]:
    d, H, hk, hd, f = (m["d_model"], m["n_heads"], m["kv_heads"],
                       m["head_dim"], m["d_ff"])
    return {"wq": (d, H * hd), "wk": (d, hk * hd), "wv": (d, hk * hd),
            "wo": (H * hd, d), "w_gate": (d, f), "w_up": (d, f),
            "w_down": (f, d)}


def make(m: dict, wfmt: dict, seed: int, device) -> dict:
    """The weights of model ``m`` in format ``wfmt`` from ``seed``."""
    g = torch.Generator(device=device)
    g.manual_seed(seed % (1 << 63))
    bf = torch.bfloat16
    L, d, V = m["n_layers"], m["d_model"], m["vocab"]
    H, hk, hd = m["n_heads"], m["kv_heads"], m["head_dim"]

    def normal(shape, std, mean=0.0):
        t = torch.randn(shape, generator=g, dtype=bf, device=device)
        t.mul_(std)
        if mean:
            t.add_(mean)
        return t

    w = {"embed": normal((V, d), 0.02),
         "unembed": normal((d, V), 1.0 / math.sqrt(d)),
         "final_norm": normal((d,), 0.05, 1.0),
         "attn_norm": normal((L, d), 0.05, 1.0),
         "ffn_norm": normal((L, d), 0.05, 1.0),
         "bq": normal((L, H * hd), 0.1),
         "bk": normal((L, hk * hd), 0.1),
         "bv": normal((L, hk * hd), 0.1)}
    q4 = wfmt.get("projections") == "q4"
    for name, (K, N) in proj_shapes(m).items():
        if not q4:
            w[name] = normal((L, K, N), 1.0 / math.sqrt(K))
            continue
        grp = int(wfmt["group"])
        shape = (L, K // 2, N)
        packed = torch.randint(0, 15, shape, generator=g, dtype=torch.int8,
                               device=device)
        packed.sub_(7).bitwise_and_(0xF)                 # rows 2i
        hi = torch.randint(0, 15, shape, generator=g, dtype=torch.int8,
                           device=device)
        packed.bitwise_or_(hi.sub_(7).bitwise_left_shift_(4))  # rows 2i+1
        del hi
        scale = torch.rand((L, K // grp, N), generator=g, dtype=bf,
                           device=device)
        scale.add_(0.5).mul_(1.0 / (NIBBLE_STD * math.sqrt(K)))
        w[name] = {"packed": packed, "scale": scale, "group": grp}
    return w


def nbytes(w: dict) -> int:
    n = 0
    for v in w.values():
        if isinstance(v, dict):
            n += v["packed"].nbytes + v["scale"].nbytes
        else:
            n += v.nbytes
    return n
