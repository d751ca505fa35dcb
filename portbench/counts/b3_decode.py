"""B3 (``kernels/q4_matmul.py`` -> ``csrc/q4_matmul.cu``), its decode
path (M <= 16): x (M, K) bf16 read once, the packed weight (K/2, N) and
its bf16 group scales (K/group, N) read once, the f32 output (M, N)
written once, against 2 M K N operations."""
from .peaks import bound_s


def nbytes(M: int, K: int, N: int, group: int = 64, x_elt: int = 2) -> int:
    return M * K * x_elt + K // 2 * N + K // group * N * 2 + M * N * 4


def ops(M: int, K: int, N: int) -> int:
    return 2 * M * K * N


def bound(M: int, K: int, N: int, group: int = 64, x_elt: int = 2):
    """(least seconds of one call, what bounds it)."""
    return bound_s(nbytes(M, K, N, group, x_elt), ops(M, K, N))
