"""B3's tile path (bf16 x, M > 16: 64 x 128 output tiles on the tensor
cores). The same bytes and operations as the decode path; at prefill
sizes the operations bound it."""
from . import b3_decode


def nbytes(M: int, K: int, N: int, group: int = 64) -> int:
    return b3_decode.nbytes(M, K, N, group)


def ops(M: int, K: int, N: int) -> int:
    return b3_decode.ops(M, K, N)


def bound(M: int, K: int, N: int, group: int = 64):
    return b3_decode.bound(M, K, N, group)
