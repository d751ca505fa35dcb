"""B1 (``kernels/paged_decode.py`` -> ``csrc/paged_tiles.cu`` design 2):
paged decode attention of one layer. q (B, T, H, D) read once and the
output written once in q's dtype; each sequence's live K and V lines
(kv_len of them, h_kv heads of D) read once; 4 D H operations a key a
row (QK and PV multiply-adds)."""
from typing import Sequence

from .peaks import bound_s


def nbytes(kv_lens: Sequence[int], *, batch: int, heads: int, kv_heads: int,
           head_dim: int, T: int = 1, elt: int = 2, kv_elt: int = 2) -> int:
    q = batch * T * heads * head_dim
    return 2 * q * elt + sum(kv_lens) * kv_heads * head_dim * kv_elt * 2


def ops(kv_lens: Sequence[int], *, heads: int, head_dim: int,
        T: int = 1) -> int:
    # row t of a sequence sees kv_len - (T - 1 - t) keys
    keys = sum(n - (T - 1 - t) for n in kv_lens for t in range(T))
    return 4 * head_dim * heads * keys


def bound(kv_lens: Sequence[int], *, batch: int, heads: int, kv_heads: int,
          head_dim: int, T: int = 1, elt: int = 2):
    return bound_s(nbytes(kv_lens, batch=batch, heads=heads,
                          kv_heads=kv_heads, head_dim=head_dim, T=T,
                          elt=elt),
                   ops(kv_lens, heads=heads, head_dim=head_dim, T=T))
