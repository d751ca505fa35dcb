"""Named-axis collectives of the ring across ranks: what ``jax.lax`` gives
the JAX package's ring inside ``shard_map`` (``axis_index``, ``psum``,
``pmax``, ``all_gather``, ``ppermute``), over ``torch.distributed``
process groups.

An ``Axis`` is one of a rank's groups (``launch.mesh.RankLayout``): the
"model" group of its stage, or the ring of its member. The transport is
gloo (TCP between processes, the link prima.cpp's home devices talk
over). gloo moves host memory, so every op on a CUDA tensor waits for the
tensor's stream, copies it into a pinned host buffer, runs the gloo op on
the buffer's bytes and copies the result back to the card; a CPU tensor
goes as it is, and a CUDA op waits for its stream once. Nothing relies
on gloo's own CUDA support.

Replicated activations stay equal to the bit across a group: ``psum``
and ``pmax`` gather every member's tensor and reduce it locally in rank
order (``psum`` accumulates in f32), so every member computes the same
sum from the same bytes, whatever order a network all-reduce would take.

With a ``tracer`` every op is a ``comms`` phase on the ``comm`` track
(then the wait for the tensor's stream comes before it): the span holds
the host staging and the gloo op, so a step's ``comms`` share is the
time the collectives take.

Every op counts itself in ``op_counts()`` under the XLA name of what it
computes ("all-gather", "all-reduce", "reduce-scatter",
"collective-permute") and its axis, with its result's bytes (the JAX dry
run's histogram counts an op's result bytes too). An axis made with
``dry=True`` has no process group: its ops count themselves and return
uninitialised tensors of the result's shape on the input's device (the
dry run's ``meta`` tensors), so a rank's step runs with no peer.

``reduce_scatter`` sums in rank order like ``psum`` (gloo has no
reduce-scatter: each member sends every other its chunk, point to
point, and sums the parts of its own). The autograd
pairs of the GSPMD layer (``runtime.gspmd``) and the rank train step:

  * ``fsdp_gather``: all-gather forward, reduce-scatter backward (an FSDP
    weight gathered over "data": its gradient summed over the data ranks
    back to each rank's shard);
  * ``tp_enter`` / ``tp_sum``: Megatron's pair over "model", identity
    forward with a ``psum`` backward (a replicated tensor a member reads
    its own part of), and a ``psum`` forward with an identity backward
    (the partial products of a row-parallel weight);
  * ``tp_gather``: all-gather forward, the member's own chunk of the
    gradient backward (a column-parallel product gathered whole for
    computation every member repeats).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from .telemetry import resolve_tracer


@dataclasses.dataclass
class Axis:
    """A named axis: the process group, its members' global ranks in
    group order, and this rank's index in it (``group`` None: an axis of
    one member, which every op passes through)."""
    name: str
    group: object
    ranks: Tuple[int, ...]
    index: int
    tracer: object = None
    dry: bool = False

    @property
    def size(self) -> int:
        return len(self.ranks)


def dry_axis(name: str, size: int, index: int = 0) -> Axis:
    """An axis of ``size`` members with no process group (the dry run)."""
    return Axis(name, None, tuple(range(size)), index, dry=True)


#: (op, axis name) -> [count, result bytes], since ``reset_op_counts``
_COUNTS: Dict[Tuple[str, str], list] = {}


def reset_op_counts() -> None:
    _COUNTS.clear()


def op_counts() -> Dict[str, Dict[str, int]]:
    """{"<op>[<axis>]": {"count", "bytes"}} since ``reset_op_counts``."""
    return {f"{op}[{ax}]": {"count": c, "bytes": b}
            for (op, ax), (c, b) in sorted(_COUNTS.items())}


def _note(op: str, ax: Axis, shape, dtype) -> None:
    n = 1
    for d in shape:
        n *= int(d)
    rec = _COUNTS.setdefault((op, ax.name), [0, 0])
    rec[0] += 1
    rec[1] += n * dtype.itemsize


def _dry(like: torch.Tensor, shape) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=like.dtype, device=like.device)


def axis_index(ax: Axis) -> int:
    return ax.index


def axis_size(ax: Axis) -> int:
    return ax.size


#: a staging buffer above this many bytes is host memory of its own op,
#: freed after it (the GSPMD layer stages whole weight shards and their
#: gradients: kept pinned a shape each, eight ranks' buffers would fill
#: the host)
PIN_CACHE_BYTES = 64 << 20


class _Pinned:
    """Pinned host buffers by (use, shape, dtype), reused (see below);
    one above ``PIN_CACHE_BYTES`` is a new pageable buffer each time."""

    def __init__(self):
        self._bufs: Dict[Tuple, torch.Tensor] = {}

    def get(self, use: str, shape, dtype) -> torch.Tensor:
        n = dtype.itemsize
        for d in shape:
            n *= int(d)
        if n > PIN_CACHE_BYTES:
            return torch.empty(tuple(shape), dtype=dtype)
        key = (use, tuple(shape), dtype)
        buf = self._bufs.get(key)
        if buf is None:
            buf = torch.empty(shape, dtype=dtype, pin_memory=True)
            self._bufs[key] = buf
        return buf


_PINNED = _Pinned()


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """A contiguous host tensor's bytes, the form gloo moves."""
    return t.reshape(-1).view(torch.uint8)


# A CUDA op costs one wait for its stream: the copy into the pinned buffer
# is queued behind the work that made the tensor and waited for once; the
# copy back is queued without a wait. That is safe because every op waits
# for its stream before the host writes a pinned buffer again, and the
# stream runs the earlier copy back before anything queued after it.

def _wait(t: torch.Tensor) -> None:
    if t.device.type == "cuda":
        torch.cuda.current_stream(t.device).synchronize()


def _host(x: torch.Tensor, use: str) -> torch.Tensor:
    """``x`` on the host: a CUDA tensor copied into a pinned buffer (the
    copy waited for), a CPU tensor made contiguous."""
    if x.device.type != "cuda":
        return x.contiguous()
    buf = _PINNED.get(use, x.shape, x.dtype)
    buf.copy_(x, non_blocking=True)
    _wait(x)
    return buf


def _empty_host(like: torch.Tensor, shape, use: str) -> torch.Tensor:
    if like.device.type != "cuda":
        return torch.empty(shape, dtype=like.dtype)
    return _PINNED.get(use, shape, like.dtype)


def _back(h: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A host result on ``like``'s device: a new tensor (the pinned buffer
    is reused by a later op), copied on the stream without a wait."""
    if like.device.type != "cuda":
        return h
    out = torch.empty(h.shape, dtype=h.dtype, device=like.device)
    out.copy_(h, non_blocking=True)
    return out


def _span(ax: Axis, op: str, x: torch.Tensor):
    """The op's ``comms`` phase. With an enabled tracer the stream is
    waited for first, so the phase holds the staging and the gloo op and
    not the work queued before them (one more wait an op)."""
    tracer = resolve_tracer(ax.tracer)
    if tracer.enabled:
        _wait(x)
    return tracer.phase("comms", cat="comm", track="comm",
                        label=f"{op}[{ax.name}]",
                        nbytes=x.numel() * x.element_size())


def _gather(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    """Every member's ``x`` stacked in rank order (uncounted)."""
    import torch.distributed as dist

    with _span(ax, "all_gather", x):
        h = _host(x, "send")
        out = _empty_host(x, (ax.size,) + tuple(x.shape), "gather")
        dist.all_gather([_bytes(out[i]) for i in range(ax.size)], _bytes(h),
                        group=ax.group)
        return _back(out, x)


def all_gather(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    """Every member's ``x``, stacked in rank order: (size, *x.shape) on
    ``x``'s device."""
    if ax.size == 1:
        return x[None]
    shape = (ax.size,) + tuple(x.shape)
    _note("all-gather", ax, shape, x.dtype)
    return _dry(x, shape) if ax.dry else _gather(x, ax)


def _sum_parts(parts: torch.Tensor, dtype) -> torch.Tensor:
    """parts (n, ...) summed in rank order, f32 for a narrower float."""
    acc = parts[0].float() if parts.is_floating_point() else parts[0]
    for i in range(1, parts.shape[0]):
        acc = acc + parts[i]
    return acc.to(dtype)


def psum(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    """The sum of every member's ``x``, taken in rank order (f32
    accumulation for a narrower float), equal to the bit on every
    member."""
    if ax.size == 1:
        return x
    _note("all-reduce", ax, x.shape, x.dtype)
    if ax.dry:
        return _dry(x, x.shape)
    return _sum_parts(_gather(x, ax), x.dtype)


def pmax(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    """The elementwise max of every member's ``x``."""
    if ax.size == 1:
        return x
    _note("all-reduce", ax, x.shape, x.dtype)
    if ax.dry:
        return _dry(x, x.shape)
    return _gather(x, ax).amax(0)


def reduce_scatter(x: torch.Tensor, ax: Axis, dim: int = 0
                   ) -> torch.Tensor:
    """Member i's chunk i (along ``dim``, which the size must divide) of
    the sum of every member's ``x``, summed in rank order as ``psum``
    sums."""
    if ax.size == 1:
        return x
    dim = dim % x.dim()
    n = x.shape[dim] // ax.size
    if n * ax.size != x.shape[dim]:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"over {ax.name} ({ax.size})")
    shape = x.shape[:dim] + (n,) + x.shape[dim + 1:]
    _note("reduce-scatter", ax, shape, x.dtype)
    if ax.dry:
        return _dry(x, shape)
    # chunk j goes to member j and chunk i comes from every member (an
    # all-to-all of point-to-point sends, all posted before any wait);
    # member i sums its chunk's parts in rank order
    import torch.distributed as dist

    moved = x.movedim(dim, 0)
    chunks = moved.reshape((ax.size, n) + tuple(moved.shape[1:]))
    i, size = ax.index, ax.size
    with _span(ax, "reduce_scatter", x):
        h = _host(chunks.contiguous(), "rs_send")
        parts = _empty_host(x, tuple(chunks.shape), "rs_recv")
        parts[i].copy_(h[i])
        works = []
        for j in range(size):
            if j != i:
                works.append(dist.isend(_bytes(h[j]), ax.ranks[j],
                                        group=ax.group))
                works.append(dist.irecv(_bytes(parts[j]), ax.ranks[j],
                                        group=ax.group))
        for w in works:
            w.wait()
        # summed where the parts arrived, then the chunk alone copied back
        mine = _back(_sum_parts(parts, x.dtype), x)
    return mine.movedim(0, dim).contiguous()


def gather_cat(x: torch.Tensor, ax: Axis, dim: int) -> torch.Tensor:
    """Every member's ``x`` joined along ``dim`` in rank order."""
    if ax.size == 1:
        return x
    parts = all_gather(x.contiguous(), ax)
    return torch.cat(list(parts.unbind(0)), dim)


def ppermute(x: Optional[torch.Tensor], ax: Axis, *, like: torch.Tensor,
             send: bool = True, recv: bool = True, shift: int = 1
             ) -> Optional[torch.Tensor]:
    """The ring hop: send ``x`` to member ``index + shift`` and receive
    from member ``index - shift`` (a tensor of ``like``'s shape, dtype and
    device), both posted before either is waited for, so a ring of them
    cannot deadlock. ``send``/``recv`` False skip a side (the schedule
    knows when a stage's output has no reader). Returns what was
    received, or None."""
    if ax.size == 1:
        return x if (send and recv) else None
    if send:
        _note("collective-permute", ax, like.shape, like.dtype)
    if ax.dry:
        return _dry(like, like.shape) if recv else None
    import torch.distributed as dist

    n = ax.size
    with _span(ax, "ppermute", like):
        works, out = [], None
        if send:
            h = _host(x, "hop_send")
            works.append(dist.isend(_bytes(h), ax.ranks[(ax.index + shift)
                                                        % n],
                                    group=ax.group))
        elif recv:
            _wait(like)              # the last copy out of the buffer
        if recv:
            out = _empty_host(like, like.shape, "hop_recv")
            works.append(dist.irecv(_bytes(out), ax.ranks[(ax.index - shift)
                                                          % n],
                                    group=ax.group))
        for w in works:
            w.wait()
        return None if out is None else _back(out, like)


# --------------------------------------------------------------------------- #
#  autograd pairs (see the module docstring)
# --------------------------------------------------------------------------- #

class _FsdpGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, dim):
        ctx.ax, ctx.dim = ax, dim
        return gather_cat(x, ax, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g.contiguous(), ctx.ax, ctx.dim), None, None


class _TpGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, dim):
        ctx.ax, ctx.dim, ctx.n = ax, dim, x.shape[dim]
        return gather_cat(x, ax, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.ax.index * ctx.n, ctx.n), None, None


class _TpEnter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return psum(g.contiguous(), ctx.ax), None


class _TpSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        return psum(x.contiguous(), ax)

    @staticmethod
    def backward(ctx, g):
        return g, None


def fsdp_gather(x: torch.Tensor, ax: Optional[Axis], dim: int
                ) -> torch.Tensor:
    """``x`` (a rank's shard) joined with its peers' along ``dim``; the
    gradient is reduce-scattered back to the shard."""
    if ax is None or ax.size == 1:
        return x
    return _FsdpGather.apply(x, ax, dim % x.dim())


def tp_gather(x: torch.Tensor, ax: Optional[Axis], dim: int
              ) -> torch.Tensor:
    """``x`` joined with the other members' along ``dim``, for
    computation every member repeats; the gradient is the member's own
    chunk."""
    if ax is None or ax.size == 1:
        return x
    return _TpGather.apply(x, ax, dim % x.dim())


def tp_enter(x: torch.Tensor, ax: Optional[Axis]) -> torch.Tensor:
    """``x`` as it is; its gradient summed over ``ax`` (a replicated
    tensor of which each member reads its own part)."""
    if ax is None or ax.size == 1 or not torch.is_grad_enabled():
        return x
    return _TpEnter.apply(x, ax)


def tp_sum(x: torch.Tensor, ax: Optional[Axis]) -> torch.Tensor:
    """``psum`` of ``x`` over ``ax``; the gradient passes as it is."""
    if ax is None or ax.size == 1:
        return x
    if not torch.is_grad_enabled() or not x.requires_grad:
        return psum(x, ax)
    return _TpSum.apply(x, ax)
