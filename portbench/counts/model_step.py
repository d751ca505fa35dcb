"""A model step's least time on the chip: the larger of its operations
over the bf16 peak and its bytes over the bandwidth. Bytes: every weight
read once a step (the packed bytes and scales of q4 projections, 2 B a
bf16 parameter), plus the KV lines read and written. Operations: 2 a
multiply-add of every projection and the head for every row, plus the
attention's 4 D H a key a row. A step is a prefill of ``S`` rows after
``offset`` cached positions (one sequence), or a decode step of one row
for each sequence, given its length after the step."""
from typing import Sequence

from .peaks import bound_s


def _proj_shapes(m: dict):
    d, H, hk, hd, f = (m["d_model"], m["n_heads"], m["kv_heads"],
                       m["head_dim"], m["d_ff"])
    return [(d, H * hd), (d, hk * hd), (d, hk * hd), (H * hd, d),
            (d, f), (d, f), (f, d)]


def proj_params(m: dict) -> int:
    """Projection parameters of one layer."""
    return sum(k * n for k, n in _proj_shapes(m))


def weight_bytes(m: dict, w: dict) -> int:
    """Bytes of every weight a step reads: the layers' projections
    (q4: packed nibbles and bf16 group scales), biases and norms, the
    final norm and the head; an embedding row a token is left out."""
    L, d, H, hk, hd = (m["n_layers"], m["d_model"], m["n_heads"],
                       m["kv_heads"], m["head_dim"])
    if w.get("projections") == "q4":
        g = w["group"]
        proj = sum(k // 2 * n + k // g * n * 2 for k, n in _proj_shapes(m))
    else:
        proj = 2 * proj_params(m)
    small = 2 * (2 * d + (H + 2 * hk) * hd)
    return L * (proj + small) + 2 * d + 2 * d * m["vocab"]


def kv_line_bytes(m: dict, kv_elt: int = 2) -> int:
    """Bytes of one position's K and V over every layer."""
    return m["n_layers"] * 2 * m["kv_heads"] * m["head_dim"] * kv_elt


def _attn_ops(m: dict, keys: int) -> int:
    return 4 * m["head_dim"] * m["n_heads"] * keys * m["n_layers"]


def _row_ops(m: dict) -> int:
    return 2 * (m["n_layers"] * proj_params(m) + m["d_model"] * m["vocab"])


def prefill(m: dict, w: dict, S: int, offset: int = 0,
            head_rows: int = 1):
    """(ops, bytes) of a prefill of S rows after ``offset`` positions,
    the head applied to ``head_rows`` of them (the last row of a whole
    prompt, every row of a chunk)."""
    keys = S * offset + S * (S + 1) // 2
    ops = S * _row_ops(m) + _attn_ops(m, keys) \
        + 2 * (head_rows - S) * m["d_model"] * m["vocab"]
    nbytes = weight_bytes(m, w) + kv_line_bytes(m) * (offset + S)
    return ops, nbytes


def decode(m: dict, w: dict, kv_lens: Sequence[int]):
    """(ops, bytes) of one decode step: a row a sequence; ``kv_lens`` are
    the sequences' lengths after the step's write."""
    ops = len(kv_lens) * _row_ops(m) + _attn_ops(m, sum(kv_lens))
    nbytes = weight_bytes(m, w) + kv_line_bytes(m) * (sum(kv_lens)
                                                      + len(kv_lens))
    return ops, nbytes


def least_s(ops: float, nbytes: float):
    return bound_s(nbytes, ops)
