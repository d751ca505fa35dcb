"""Checkpoint/restore in the JAX package's file layout
(``repro.runtime.checkpoint``), so a checkpoint written by either package
restores in the other.

A checkpoint is an npz: ``__meta__`` (JSON: ``n_leaves``, ``step``) and
one array a leaf, ``leaf_%05d`` in ``jax.tree_util``'s flatten order --
dict keys sorted, a tuple, list or NamedTuple in order, None no leaf --
a bf16 leaf as its ``uint16`` bits under ``leaf_%05d__bf16``. Leaves may
be torch tensors (any device), numpy arrays or Python scalars. Writes go
to a temporary file renamed over the target (``os.replace``), so a
partial write is never visible; restore checks the leaf count and every
shape and raises ``ValueError``. The port's trainer saves
``(params, AdamState)`` as the JAX package's tree through ``bridge``.
``CheckpointManager`` keeps the newest ``keep`` checkpoints and resumes
from the latest.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import tempfile
import zipfile
from typing import Any, List, Optional, Tuple

import numpy as np
import torch
from numpy.lib import format as npformat


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves of ``tree`` in ``jax.tree_util``'s flatten order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(like: Any, leaves) -> Any:
    """``like``'s structure with its leaves taken from the iterator
    ``leaves`` in flatten order."""
    if like is None:
        return None
    if isinstance(like, dict):
        out = {k: tree_unflatten(like[k], leaves) for k in sorted(like)}
        return {k: out[k] for k in like}
    if isinstance(like, (tuple, list)):
        vals = [tree_unflatten(v, leaves) for v in like]
        if hasattr(like, "_fields"):                 # a NamedTuple
            return type(like)(*vals)
        return type(like)(vals)
    return next(leaves)


def _to_numpy(leaf) -> Tuple[np.ndarray, bool]:
    """(the leaf as a host array, whether it is bf16 stored as bits)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), True
        return t.numpy(), False
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":
        return arr.view(np.uint16), True
    return arr, False


def _write(zf: zipfile.ZipFile, name: str, arr: np.ndarray) -> None:
    """One member, as ``np.savez`` writes it."""
    with zf.open(name + ".npy", "w", force_zip64=True) as fid:
        npformat.write_array(fid, arr, allow_pickle=False)


def save(path: str, tree: Any, *, step: Optional[int] = None) -> str:
    """Atomically write ``tree`` to ``path`` (.npz). The members are
    those ``np.savez`` writes, in its loop; each leaf is copied to the
    host only while it is written, so a tree on the device needs host
    memory for one leaf, not the whole tree."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    leaves = tree_leaves(tree)
    meta = {"n_leaves": len(leaves), "step": step}
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f, zipfile.ZipFile(
                f, mode="w", compression=zipfile.ZIP_STORED,
                allowZip64=True) as zf:
            _write(zf, "__meta__", np.asarray(json.dumps(meta)))
            for i, leaf in enumerate(leaves):
                arr, bf16 = _to_numpy(leaf)
                _write(zf, f"leaf_{i:05d}" + ("__bf16" if bf16 else ""),
                       arr)
                del arr
        os.replace(tmp, path)        # atomic on POSIX
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    return path


def _dtype(ref) -> torch.dtype:
    if isinstance(ref, torch.Tensor):
        return ref.dtype
    arr = np.asarray(ref)
    if arr.dtype.name == "bfloat16":
        return torch.bfloat16
    return torch.from_numpy(np.zeros((), arr.dtype)).dtype


def restore(path: str, like: Any, *, device=None) -> Any:
    """Restore into the structure of ``like`` (shapes and the leaf count
    validated). Each leaf comes back as a torch tensor of its ``like``
    leaf's dtype on ``device`` (default: the ``like`` leaf's device, the
    CPU for a meta tensor or a numpy leaf), read and moved one leaf at a
    time: a tree of meta tensors describes a checkpoint without
    allocating it."""
    flat = tree_leaves(like)
    leaves = []
    with np.load(path, allow_pickle=False) as data:
        n = len({k.split("__")[0] for k in data.files
                 if k.startswith("leaf_")})
        if n != len(flat):
            raise ValueError(f"checkpoint has {n} leaves, expected "
                             f"{len(flat)}")
        for i, ref in enumerate(flat):
            key = f"leaf_{i:05d}"
            if key in data.files:
                t = torch.from_numpy(data[key])
            else:
                t = torch.from_numpy(data[key + "__bf16"].view(
                    np.int16)).view(torch.bfloat16)
            if tuple(t.shape) != tuple(np.shape(ref)):
                raise ValueError(f"leaf {i}: shape {tuple(t.shape)} != "
                                 f"{tuple(np.shape(ref))}")
            dev = device
            if dev is None:
                dev = ref.device if isinstance(ref, torch.Tensor) \
                    and ref.device.type != "meta" else "cpu"
            leaves.append(t.to(device=dev, dtype=_dtype(ref)))
    return tree_unflatten(like, iter(leaves))


def read_step(path: str) -> Optional[int]:
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(str(data["__meta__"]))
    return meta.get("step")


@dataclasses.dataclass
class CheckpointManager:
    directory: str
    keep: int = 3
    prefix: str = "ckpt"

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"{self.prefix}_{step:08d}.npz")

    def all_steps(self) -> List[int]:
        if not os.path.isdir(self.directory):
            return []
        pat = re.compile(rf"{self.prefix}_(\d+)\.npz$")
        out = []
        for f in os.listdir(self.directory):
            m = pat.match(f)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, tree: Any) -> str:
        p = save(self._path(step), tree, step=step)
        for s in self.all_steps()[:-self.keep]:
            os.unlink(self._path(s))
        return p

    def restore_latest(self, like: Any, *, device=None
                       ) -> Tuple[Optional[int], Any]:
        step = self.latest()
        if step is None:
            return None, like
        return step, restore(self._path(step), like, device=device)
