"""W4A16 grouped matmul: the CUDA kernel B3 and its plain torch version.

Counterpart of ``repro/kernels/q4_matmul.py`` (Pallas). out (M, N) f32 =
x (M, K) @ dequant(packed (K/2, N) int8, scale (K/group, N) bf16), with
the nibbles unpacked and scaled inside the kernel
(``csrc/q4_matmul.cu``), so only the packed bytes cross device memory.
``q4_plan`` picks the route of a call from its shapes alone; the wrapper
checks what it is given, allocates the output and the split workspace and
launches on the current stream without synchronising (safe to capture in
a CUDA graph); it takes CUDA tensors only — ``kernels.ops`` routes CPU
tensors to ``q4_matmul_ref``.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import torch

from . import _build

_X_CODES = {torch.float32: 0, torch.bfloat16: 1}
_PATHS = {"decode": 0, "tile": 1}

#: streaming multiprocessors of an H100 SXM; a plan splits K until the grid
#: holds WAVES[path] CTAs an SM (more CTAs keep more bytes in flight at
#: decode; tiles hold more work each)
SMS = 132
WAVES = {"decode": 8, "tile": 4}
#: x rows of a decode CTA (8 when M <= 8); (rows, columns) of a tile CTA
DECODE_ROWS = 16
TILE = (64, 128)


class Q4Plan(NamedTuple):
    """The route of one B3 call. ``path``: "decode" (x in blocks of 16
    rows, a CTA per 128 columns, 16 rows and split) or "tile" (bf16 x,
    M > 16: a CTA per 64 x 128 output tile and split). ``n_split``: CTAs
    along K, each a contiguous run of whole groups, added afterwards in
    split order. ``grid``: the CTA grid (column tiles, row blocks, splits).
    ``kernels``: CUDA kernels the call issues (the split combine is the
    second)."""
    path: str
    n_split: int
    grid: Tuple[int, int, int]
    kernels: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=None)
def q4_plan(M: int, K: int, N: int, group: int, *,
            x_dtype: torch.dtype = torch.bfloat16) -> Q4Plan:
    """B3's route from shapes alone (never from data, so a CUDA graph may
    capture it). Decode takes every M <= 16 and f32 x at any M (in 16-row
    blocks); at M <= 16 its split count follows from K and N only, so a
    row sums its groups in the same order at every M <= 16 (a verify row
    equals a decode step's). Either path splits K until the grid holds
    WAVES[path] x SMS CTAs, or every group is a split of its own."""
    G = K // group
    rows = TILE[0] if x_dtype == torch.bfloat16 and M > DECODE_ROWS \
        else DECODE_ROWS
    path = "tile" if rows == TILE[0] else "decode"
    ctas = _cdiv(N, TILE[1]) * _cdiv(M, rows)
    n_split = min(G, max(1, _cdiv(WAVES[path] * SMS, ctas)))
    grid = (_cdiv(N, TILE[1]), _cdiv(M, rows), n_split)
    return Q4Plan(path, n_split, grid, 1 + (n_split > 1))


def q4_matmul(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
              *, group: int = 64) -> torch.Tensor:
    """B3. x: (M, K) f32/bf16 contiguous; packed: (K/2, N) int8; scale:
    (K/group, N) bf16 -> (M, N) f32. Any M >= 1 and N; group a multiple
    of 16 (every group the port's quantizers pick: 64, 32, 16) and K a
    multiple of it."""
    name = "q4_matmul"
    for t in (x, packed, scale):
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"{name}: all tensors must be on one CUDA "
                             f"device (got {t.device}, x on {x.device})")
    if x.dtype not in _X_CODES:
        raise TypeError(f"{name}: x dtype {x.dtype} not supported "
                        f"(expected float32 or bfloat16)")
    if packed.dtype != torch.int8 or scale.dtype != torch.bfloat16:
        raise TypeError(f"{name}: packed must be int8 and scale bfloat16 "
                        f"(got {packed.dtype}, {scale.dtype})")
    if x.dim() != 2 or packed.dim() != 2:
        raise ValueError(f"{name}: x must be (M, K) and packed (K/2, N)")
    M, K = x.shape
    N = packed.shape[1]
    if packed.shape[0] * 2 != K or M < 1 or N < 1:
        raise ValueError(f"{name}: x {tuple(x.shape)} does not match "
                         f"packed {tuple(packed.shape)}")
    if group < 16 or group % 16 or K % group \
            or scale.shape != (K // group, N):
        raise ValueError(f"{name}: scale {tuple(scale.shape)} is not "
                         f"(K/group, N) = ({K}/{group}, {N}) with group a "
                         f"multiple of 16")
    for t, what in ((x, "x"), (packed, "packed"), (scale, "scale")):
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")
    plan = q4_plan(M, K, N, group, x_dtype=x.dtype)
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    ws = torch.empty((plan.n_split, M, N), dtype=torch.float32,
                     device=x.device) if plan.n_split > 1 else None
    aligned = N % 16 == 0 and all(t.data_ptr() % 16 == 0
                                  for t in (x, packed, scale))
    lib = _build.load(name)
    code = lib.q4_matmul(x.data_ptr(), packed.data_ptr(), scale.data_ptr(),
                         out.data_ptr(), 0 if ws is None else ws.data_ptr(),
                         _X_CODES[x.dtype], M, N, K, group,
                         _PATHS[plan.path], plan.n_split, int(aligned),
                         torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(code, name, name)
    _build.LAUNCHES[name] += 1
    return out


def q4_matmul_ref(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
                  *, group: int = 64) -> torch.Tensor:
    """Plain B3: dequantize to f32, then an f32 matmul (as
    ``repro.kernels.ref.q4_matmul_ref``)."""
    from ..quant.grouped import QuantizedTensor, dequantize_q4

    K, N = packed.shape[0] * 2, packed.shape[1]
    w = dequantize_q4(QuantizedTensor(packed, scale, 4, group, (K, N)),
                      torch.float32)
    return x.float() @ w
