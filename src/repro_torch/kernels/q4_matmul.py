"""W4A16 grouped matmul: the CUDA kernel B3 and its plain torch version.

Counterpart of ``repro/kernels/q4_matmul.py`` (Pallas). out (M, N) f32 =
x (M, K) @ dequant(packed (K/2, N) int8, scale (K/group, N) bf16), with
the nibbles unpacked and scaled inside the kernel
(``csrc/q4_matmul.cu``), so only the packed bytes cross device memory.
The wrapper checks what it is given, allocates the output and launches on
the current stream without synchronising; it takes CUDA tensors only —
``kernels.ops`` routes CPU tensors to ``q4_matmul_ref``.
"""
from __future__ import annotations

import torch

from . import _build

_X_CODES = {torch.float32: 0, torch.bfloat16: 1}


def q4_matmul(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
              *, group: int = 64) -> torch.Tensor:
    """B3. x: (M, K) f32/bf16 contiguous; packed: (K/2, N) int8; scale:
    (K/group, N) bf16 -> (M, N) f32. Any M >= 1 and N; K even and a
    multiple of ``group``."""
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
    if group < 1 or K % group or scale.shape != (K // group, N):
        raise ValueError(f"{name}: scale {tuple(scale.shape)} is not "
                         f"(K/group, N) = ({K}/{group}, {N})")
    for t, what in ((x, "x"), (packed, "packed"), (scale, "scale")):
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    lib = _build.load(name)
    code = lib.q4_matmul(x.data_ptr(), packed.data_ptr(), scale.data_ptr(),
                         out.data_ptr(), _X_CODES[x.dtype], M, N, K, group,
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
