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

    @property
    def size(self) -> int:
        return len(self.ranks)


def axis_index(ax: Axis) -> int:
    return ax.index


def axis_size(ax: Axis) -> int:
    return ax.size


class _Pinned:
    """Pinned host buffers by (use, shape, dtype), reused (see below)."""

    def __init__(self):
        self._bufs: Dict[Tuple, torch.Tensor] = {}

    def get(self, use: str, shape, dtype) -> torch.Tensor:
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


def all_gather(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    """Every member's ``x``, stacked in rank order: (size, *x.shape) on
    ``x``'s device."""
    if ax.size == 1:
        return x[None]
    import torch.distributed as dist

    with _span(ax, "all_gather", x):
        h = _host(x, "send")
        out = _empty_host(x, (ax.size,) + tuple(x.shape), "gather")
        dist.all_gather([_bytes(out[i]) for i in range(ax.size)], _bytes(h),
                        group=ax.group)
        return _back(out, x)


def psum(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    """The sum of every member's ``x``, taken in rank order (f32
    accumulation for a narrower float), equal to the bit on every
    member."""
    if ax.size == 1:
        return x
    parts = all_gather(x, ax)
    acc = parts[0].float() if x.is_floating_point() else parts[0]
    for i in range(1, ax.size):
        acc = acc + parts[i]
    return acc.to(x.dtype)


def pmax(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    """The elementwise max of every member's ``x``."""
    if ax.size == 1:
        return x
    return all_gather(x, ax).amax(0)


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
