"""Mamba-2 SSD chunked scan from the zero state: the CUDA kernel B6 and its
plain torch versions.

Counterpart of ``repro/kernels/ssd_scan.py`` (Pallas). The kernels live in
``csrc/ssd_scan.cu`` (three a call: cumsums, chunk states and C B^T; the
state hand-over; outputs); the wrapper checks what it is given, allocates
the outputs and the f32 workspaces and launches on the current stream
without synchronising (safe to capture in a CUDA graph). It takes CUDA
tensors only — ``kernels.ops`` routes CPU tensors to the plain
version beside it. Unlike the Pallas wrapper it takes any S (the last
chunk is ragged) and reads x, B and C through their strides, in the
layout ``models.layers.ssd_block`` leaves them (views of one conv output).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from . import _build
from .paged_decode import _code

_FLOATS = (torch.float32, torch.bfloat16)
#: the kernels' head geometry (mamba2-780m's SSD heads) and largest chunk
HEAD_DIM, STATE_DIM, MAX_CHUNK = 64, 128, 128


class SSDPlan(NamedTuple):
    """The work of one B6 call, from shapes alone. ``n_chunks`` chunks;
    ``grid``: CTAs of the chunk-state and output kernels, (b, chunk,
    head); ``workspace``: f32 elements of the three workspaces (cumsums,
    C B^T, chunk states); ``kernels``: CUDA kernels a call issues."""
    n_chunks: int
    grid: int
    workspace: Tuple[int, int, int]
    kernels: int


def ssd_plan(B: int, S: int, nh: int, *, chunk: int = 128) -> SSDPlan:
    nc = -(-S // chunk)
    return SSDPlan(nc, B * nc * nh,
                   (B * nc * nh * MAX_CHUNK, B * nc * MAX_CHUNK * MAX_CHUNK,
                    B * nc * nh * HEAD_DIM * STATE_DIM), 3)


def _rows_aligned(t: torch.Tensor, lead: int) -> bool:
    """Every row of ``t`` (the leading ``lead`` strides) starts 16-byte
    aligned: the kernels then stage it with cp.async."""
    elt = t.element_size()
    return t.data_ptr() % 16 == 0 and all(
        st * elt % 16 == 0 for st in t.stride()[:lead])


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bmat: torch.Tensor, Cmat: torch.Tensor, *, chunk: int = 128
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """B6. x: (B, S, nh, 64) f32/bf16; dt: (B, S, nh) f32; A: (nh,) f32
    (<= 0); Bmat/Cmat: (B, S, 128) in x's dtype. Each may be a strided view
    with a contiguous last dim. Returns (y (B, S, nh, P), h_final
    (B, nh, P, N)), both contiguous in x.dtype: the scan from the zero
    state, chunks of ``chunk`` <= 128 positions in parallel, summed in f32
    in a fixed order."""
    name = "ssd_scan"
    for t in (x, dt, A, Bmat, Cmat):
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"{name}: all tensors must be on one CUDA "
                             f"device (got {t.device}, x on {x.device})")
    if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or Bmat.dim() != 3:
        raise ValueError(f"{name}: x must be (B, S, nh, P), dt (B, S, nh), "
                         f"A (nh,) and B/C (B, S, N)")
    Bsz, S, nh, P = x.shape
    N = Bmat.shape[-1]
    if dt.shape != (Bsz, S, nh) or A.shape != (nh,) \
            or Bmat.shape != (Bsz, S, N) or Cmat.shape != Bmat.shape:
        raise ValueError(f"{name}: dt {tuple(dt.shape)}, A "
                         f"{tuple(A.shape)}, B {tuple(Bmat.shape)}, C "
                         f"{tuple(Cmat.shape)} do not match x "
                         f"{tuple(x.shape)}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"{name}: dt and A must be float32")
    xc = _code(x, _FLOATS, f"{name} x")
    if Bmat.dtype != x.dtype or Cmat.dtype != x.dtype:
        raise TypeError(f"{name}: B and C must be in x's dtype {x.dtype}")
    if x.stride(-1) != 1 or Bmat.stride(-1) != 1 or Cmat.stride(-1) != 1 \
            or not A.is_contiguous():
        raise ValueError(f"{name}: x, B and C need a contiguous last dim, "
                         f"A contiguous")
    if Bsz == 0 or S == 0 or nh == 0:
        raise ValueError(f"{name}: empty batch, sequence or heads")
    if P != HEAD_DIM or N != STATE_DIM or not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"{name}: the kernel takes P = {HEAD_DIM}, N = "
                         f"{STATE_DIM} and 1 <= chunk <= {MAX_CHUNK} (got "
                         f"P = {P}, N = {N}, chunk = {chunk})")
    plan = ssd_plan(Bsz, S, nh, chunk=chunk)
    y = torch.empty((Bsz, S, nh, P), dtype=x.dtype, device=x.device)
    h = torch.empty((Bsz, nh, P, N), dtype=x.dtype, device=x.device)
    cum, cb, st = (torch.empty(n, dtype=torch.float32, device=x.device)
                   for n in plan.workspace)
    aligned = all(_rows_aligned(t, lead) for t, lead in
                  ((x, 3), (Bmat, 2), (Cmat, 2)))
    lib = _build.load(name)
    code = lib.ssd_scan(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bmat.data_ptr(),
        Cmat.data_ptr(), y.data_ptr(), h.data_ptr(), cum.data_ptr(),
        cb.data_ptr(), st.data_ptr(), xc, Bsz, S, nh, P, N, chunk,
        int(aligned), *x.stride()[:3], *dt.stride(), *Bmat.stride()[:2],
        *Cmat.stride()[:2], torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(code, name, name)
    _build.LAUNCHES[name] += 1
    return y, h


class SSDScan(torch.autograd.Function):
    """The scan under autograd: ``SSDScan.apply(scan, x, dt, A, Bmat,
    Cmat, chunk)`` returns ``scan``'s (y, h_final) (``ssd_scan``, kernel
    B6, on the card; a plain version in the tests) with a ``grad_fn``.

    The backward recomputes the scan from the saved inputs through the
    plain ``models.layers.ssd_chunked`` under ``enable_grad`` and returns
    its vector-Jacobian product: the gradient the JAX package trains
    with, XLA's autodiff of its plain chunked scan. The JAX package has
    no backward kernel to port, and none is written here; the recompute
    launches no kernel."""

    @staticmethod
    def forward(ctx, scan, x, dt, A, Bmat, Cmat, chunk):
        ctx.save_for_backward(x, dt, A, Bmat, Cmat)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return scan(x, dt, A, Bmat, Cmat, chunk=chunk)

    @staticmethod
    def backward(ctx, gy, gh):
        from ..models.layers import ssd_chunked
        saved = ctx.saved_tensors
        inputs = [t.detach().requires_grad_(need) for t, need in
                  zip(saved, ctx.needs_input_grad[1:6])]
        with torch.enable_grad():
            outs = ssd_chunked(*inputs, chunk=ctx.chunk)
        used, cot = zip(*[(o, g) for o, g in zip(outs, (gy, gh))
                          if g is not None])
        grads = iter(torch.autograd.grad(
            used, [t for t in inputs if t.requires_grad], cot,
            allow_unused=True))
        return (None, *(next(grads) if t.requires_grad else None
                        for t in inputs), None)


# --------------------------------------------------------------------------- #
#  plain versions
# --------------------------------------------------------------------------- #

def ssd_scan_ref(x, dt, A, Bmat, Cmat, *, chunk: int = 128
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain B6: the model layer's ``ssd_chunked`` from the zero state."""
    from ..models.layers import ssd_chunked
    return ssd_chunked(x, dt, A, Bmat, Cmat, chunk=chunk)


def ssd_sequential_ref(x, dt, A, Bmat, Cmat
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The O(S) recurrence h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T,
    y_t = C_t . h_t, in f32 from the zero state: ground truth for both
    SSD paths."""
    Bsz, S, nh, P = x.shape
    N = Bmat.shape[-1]
    A = A.float()
    h = torch.zeros((Bsz, nh, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        dtt = dt[:, t].float()
        h = h * torch.exp(dtt * A[None])[..., None, None] + torch.einsum(
            "bh,bhp,bn->bhpn", dtt, x[:, t].float(), Bmat[:, t].float())
        ys.append(torch.einsum("bn,bhpn->bhp", Cmat[:, t].float(), h))
    return torch.stack(ys, dim=1).to(x.dtype), h.to(x.dtype)
