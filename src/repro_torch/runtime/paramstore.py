"""Layer-sharded, mmap-backed parameter store of the port
(``repro.runtime.paramstore`` in PyTorch).

Each decoder layer's leaves are packed into one flat file
(``layer_00017.bin``) beside a JSON manifest, so a layer is one sequential
read, and releasing a layer behind the compute front is one ``madvise`` on
one mapping: prefetch (ahead of the front) and release (behind it) touch
disjoint files and never fight over the same pages (the paper's
prefetch-release conflict). The head (embedding, final norm, lm head) lives
in ``head.bin``.

Version-2 manifests persist ``QuantizedTensor`` leaves as two sub-leaves,
``part: "packed"`` and ``part: "scale"``, sharing a ``quant: {bits, group,
shape}`` record; version-1 manifests hold plain leaves only. Manifests and
files are byte-identical to the JAX package's writer, so a store written
by either package loads in the other. bf16 leaves are read and written as
raw 16-bit words (no ``ml_dtypes``); the manifest keeps numpy's dtype
names (``"bfloat16"``, ``"float32"``, ``"int8"``).

``ParamStore.layer(i)`` returns zero-copy CPU tensor views of the
mapping; ``layer_bytes(i)`` the whole layer as one flat uint8 tensor, which
the prefetcher (``runtime.streaming``) copies into its staging buffers
and ``leaves`` re-views there. ``ResidentSource`` adapts an in-memory tree
to the same ``ParamSource`` interface.
"""
from __future__ import annotations

import dataclasses
import json
import mmap
import os
import warnings
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..quant.grouped import QuantizedTensor, map_tree
from .iopolicy import ShortReadError

Params = Dict[str, Any]

MANIFEST = "manifest.json"
HEAD_FILE = "head.bin"
SUPPORTED_VERSIONS = (1, 2)

#: families whose per-layer stack lives under params["blocks"] with a
#: leading layer axis — the layout the store shards.
STACKED_FAMILIES = ("dense", "moe", "vlm", "ssm")

#: manifest dtype names (numpy's) <-> torch dtypes, for the leaves a
#: model tree holds
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "int8": torch.int8}
_NAMES = {v: k for k, v in _DTYPES.items()}


def _torch_dtype(name: str) -> torch.dtype:
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"param store: unsupported dtype {name!r}") from None


def _dtype_name(dt: torch.dtype) -> str:
    try:
        return _NAMES[dt]
    except KeyError:
        raise ValueError(f"param store: unsupported dtype {dt}") from None


@dataclasses.dataclass(frozen=True)
class LeafSpec:
    """One flat sub-leaf inside a layer (or head) file.

    Unquantized leaves are one spec (``part is None``). A quantized leaf
    is two specs sharing ``key``: ``part == "packed"`` and ``part ==
    "scale"``, each carrying the same ``quant = {bits, group, shape}``
    record (``shape``: the unpacked weight shape, layer axis stripped).
    """

    key: str                 # "/"-joined dict path, e.g. "attn/wq"
    shape: Tuple[int, ...]   # per-layer shape (layer axis stripped)
    dtype: str
    offset: int              # byte offset inside the file
    nbytes: int
    part: Optional[str] = None       # None | "packed" | "scale"
    quant: Optional[dict] = None     # {bits, group, shape} (v2 manifests)

    @classmethod
    def from_dict(cls, d: dict) -> "LeafSpec":
        return cls(key=d["key"], shape=tuple(d["shape"]), dtype=d["dtype"],
                   offset=d["offset"], nbytes=d["nbytes"],
                   part=d.get("part"), quant=d.get("quant"))

    def to_dict(self) -> dict:
        out = {"key": self.key, "shape": list(self.shape),
               "dtype": self.dtype, "offset": self.offset,
               "nbytes": self.nbytes}
        if self.part is not None:        # v1 manifests stay byte-identical
            out["part"] = self.part
            out["quant"] = self.quant
        return out


def _iter_leaves(tree: Params, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """Deterministic (sorted) walk of a nested-dict tree."""
    for k in sorted(tree):
        v = tree[k]
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            yield from _iter_leaves(v, path + "/")
        else:
            yield path, v


def _unflatten(leaves: Dict[str, Any]) -> Params:
    out: Params = {}
    for key, v in leaves.items():
        parts = key.split("/")
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def _layer_file(i: int) -> str:
    return f"layer_{i:05d}.bin"


def _flat_parts(tree: Params) -> List[Tuple[str, Optional[str],
                                            torch.Tensor, Optional[dict]]]:
    """Flatten a tree into (key, part, tensor, quant) write records; a
    ``QuantizedTensor`` becomes its packed and scale records."""
    out = []
    for key, leaf in _iter_leaves(tree):
        if isinstance(leaf, QuantizedTensor):
            q = {"bits": int(leaf.bits), "group": int(leaf.group),
                 "shape": [int(d) for d in leaf.shape]}
            out.append((key, "packed", leaf.packed, q))
            out.append((key, "scale", leaf.scale, q))
        else:
            out.append((key, None, torch.as_tensor(leaf), None))
    return out


def _write_raw(f, t: torch.Tensor) -> None:
    """Write a tensor's bytes in row-major order (numpy's ``tobytes``
    order) to ``f``, from its host copy without another."""
    t = t.detach().to("cpu").contiguous().reshape(-1)
    f.write(memoryview(t.view(torch.uint8).numpy()))


def _specs(flat, *, offset: int = 0) -> List[LeafSpec]:
    specs = []
    for key, part, t, q in flat:
        n = t.numel() * t.element_size()
        specs.append(LeafSpec(key=key, shape=tuple(int(d) for d in t.shape),
                              dtype=_dtype_name(t.dtype), offset=offset,
                              nbytes=n, part=part, quant=q))
        offset += n
    return specs


# --------------------------------------------------------------------------- #
#  save
# --------------------------------------------------------------------------- #

def save_param_store(params: Params, cfg, directory: str) -> str:
    """Persist ``params`` as a layer-sharded store; returns ``directory``.

    ``params["blocks"]`` leaves are layer-stacked (leading L axis), the
    layout the JAX package's ``init_params`` produces; leaves may be
    ``QuantizedTensor``s (then the manifest is version 2).
    """
    if cfg.family not in STACKED_FAMILIES:
        raise ValueError(f"param store unsupported for family {cfg.family}")
    L = cfg.n_layers
    blocks = params["blocks"]
    for key, part, t, _ in _flat_parts(blocks):
        if t.shape[0] != L:
            raise ValueError(f"{key}: leading axis {t.shape[0]} != L={L}")
    head = {k: v for k, v in params.items() if k != "blocks"}
    return write_param_store(lambda i: map_tree(lambda a: a[i], blocks),
                             head, cfg, directory)


def write_param_store(layer: Callable[[int], Params], head: Params, cfg,
                      directory: str) -> str:
    """Write a store one layer at a time: ``layer(i)`` returns layer
    ``i``'s tree (no layer axis) and is called once per layer, in order,
    so a caller can build each layer just in time and never hold the
    whole model. Every layer must have layer 0's leaves, shapes and
    dtypes. Returns ``directory``."""
    if cfg.family not in STACKED_FAMILIES:
        raise ValueError(f"param store unsupported for family {cfg.family}")
    os.makedirs(directory, exist_ok=True)
    L = cfg.n_layers
    layer_specs: List[LeafSpec] = []
    for i in range(L):
        flat = _flat_parts(layer(i))
        specs = _specs(flat)
        if i == 0:
            layer_specs = specs
        elif specs != layer_specs:
            raise ValueError(f"layer {i}: leaves differ from layer 0's")
        with open(os.path.join(directory, _layer_file(i)), "wb") as f:
            for _, _, t, _ in flat:
                _write_raw(f, t)
    layer_nbytes = sum(s.nbytes for s in layer_specs)

    head_flat = _flat_parts(head)
    head_specs = _specs(head_flat)
    with open(os.path.join(directory, HEAD_FILE), "wb") as f:
        for _, _, t, _ in head_flat:
            _write_raw(f, t)

    quantized = any(s.part for s in layer_specs + head_specs)
    manifest = {
        "version": 2 if quantized else 1,
        "model": cfg.name,
        "family": cfg.family,
        "n_layers": L,
        "layer_nbytes": layer_nbytes,
        "leaves": [s.to_dict() for s in layer_specs],
        "head_leaves": [s.to_dict() for s in head_specs],
    }
    with open(os.path.join(directory, MANIFEST), "w") as f:
        json.dump(manifest, f, indent=2)
        f.write("\n")
    return directory


# --------------------------------------------------------------------------- #
#  sources
# --------------------------------------------------------------------------- #

class ParamSource:
    """Layer-wise parameter access: what the layer-wise forward consumes.

    ``layer(i)`` returns the per-layer block tree (no leading layer axis);
    ``head()`` the non-block params (embed / final_norm / unembed).
    Implementations: ``ResidentSource`` (in-memory tree), ``ParamStore``
    (cold mmap reads), ``streaming.StreamingParamSource`` (prefetch
    window).
    """

    n_layers: int

    def layer(self, i: int) -> Params:
        raise NotImplementedError

    def head(self) -> Params:
        raise NotImplementedError

    def close(self) -> None:
        pass


class ResidentSource(ParamSource):
    """Adapt a fully resident stacked tree to the ParamSource interface
    (``layer(i)`` slices every leaf's layer axis, zero-copy)."""

    def __init__(self, params: Params):
        self._params = params
        first = next(t for _, _, t, _ in _flat_parts(params["blocks"]))
        self.n_layers = int(first.shape[0])

    def layer(self, i: int) -> Params:
        return map_tree(lambda a: a[i], self._params["blocks"])

    def head(self) -> Params:
        return {k: v for k, v in self._params.items() if k != "blocks"}


def _mmap_tensor(mm: mmap.mmap, n: int) -> torch.Tensor:
    """The first ``n`` bytes of a read-only mapping as a uint8 tensor,
    zero-copy (never written through). It goes through numpy, whose array
    holds a buffer export on the mapping: while any view of it lives,
    ``mm.close()`` raises ``BufferError`` instead of unmapping the memory
    under it (``torch.frombuffer`` holds no export)."""
    arr = np.frombuffer(mm, dtype=np.uint8, count=n)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="The given NumPy array "
                                "is not writable")
        return torch.from_numpy(arr)


def _read_leaves(specs: List[LeafSpec], buf: torch.Tensor, *,
                 copy: bool = False) -> Params:
    """Leaves at their manifest offsets in the flat uint8 ``buf`` (on any
    device), as views unless ``copy``; a leaf whose offset is not aligned
    to its element size is copied. Quantized sub-leaf pairs reassemble
    into ``QuantizedTensor``s."""
    leaves: Dict[str, Any] = {}
    pending: Dict[str, dict] = {}
    for spec in specs:
        raw = buf[spec.offset:spec.offset + spec.nbytes]
        dt = _torch_dtype(spec.dtype)
        if copy or raw.storage_offset() % dt.itemsize:
            raw = raw.clone()
        t = raw.view(dt).reshape(spec.shape)
        if spec.part is None:
            leaves[spec.key] = t
        else:
            pending.setdefault(spec.key, dict(spec.quant or {}))[spec.part] = t
    for key, ent in pending.items():
        if "packed" not in ent or "scale" not in ent:
            raise ValueError(
                f"quantized leaf {key}: manifest is missing its "
                f"{'scale' if 'packed' in ent else 'packed'} sub-leaf")
        if not {"bits", "group", "shape"} <= ent.keys():
            raise ValueError(
                f"quantized leaf {key}: manifest quant record is missing "
                f"{sorted({'bits', 'group', 'shape'} - ent.keys())}")
        leaves[key] = QuantizedTensor(
            packed=ent["packed"], scale=ent["scale"], bits=int(ent["bits"]),
            group=int(ent["group"]), shape=tuple(ent["shape"]))
    return _unflatten(leaves)


class ParamStore(ParamSource):
    """Read side of the layer-sharded store (one mmap per layer file).

    ``layer(i)`` returns tensor views of the mapping: pages fault in on
    first touch. ``release(i)`` advises the kernel to drop layer i's pages
    (``MADV_DONTNEED``), the release half of the prefetch-release fix.
    """

    def __init__(self, directory: str):
        self.directory = directory
        path = os.path.join(directory, MANIFEST)
        try:
            with open(path) as f:
                m = json.load(f)
        except json.JSONDecodeError as e:
            raise ValueError(f"corrupt param-store manifest {path}: {e}") \
                from e
        if not isinstance(m, dict):
            raise ValueError(f"corrupt param-store manifest {path}: "
                             f"expected an object, got {type(m).__name__}")
        self.version = int(m.get("version", 1))
        if self.version not in SUPPORTED_VERSIONS:
            raise ValueError(
                f"unsupported param-store manifest version {self.version} "
                f"(supported: {SUPPORTED_VERSIONS})")
        try:
            self.manifest = m
            self.n_layers = int(m["n_layers"])
            self.layer_nbytes = int(m["layer_nbytes"])
            self.family = m["family"]
            self._leaves = [LeafSpec.from_dict(d) for d in m["leaves"]]
            self._head_leaves = [LeafSpec.from_dict(d)
                                 for d in m["head_leaves"]]
        except KeyError as e:
            raise ValueError(
                f"corrupt param-store manifest {path}: missing {e}") from e
        self._maps: Dict[int, mmap.mmap] = {}
        self._files: Dict[int, Any] = {}
        self.released = 0          # release() calls that actually dropped
        self.released_bytes = 0    # bytes those drops returned to the OS

    @property
    def layer_leaves(self) -> List[LeafSpec]:
        """The manifest's specs of a layer file's leaves, in file order."""
        return list(self._leaves)

    @property
    def quant_format(self) -> Optional[str]:
        """"q4"/"q2" if any persisted leaf is quantized, else None."""
        bits = {s.quant["bits"] for s in self._leaves + self._head_leaves
                if s.quant is not None}
        return f"q{max(bits)}" if bits else None

    # -- mapping lifecycle ------------------------------------------------ #

    def _map(self, i: int) -> mmap.mmap:
        mm = self._maps.get(i)
        if mm is None:
            path = os.path.join(self.directory, _layer_file(i))
            f = open(path, "rb")
            try:
                mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
            except ValueError as e:      # zero-length file: truncated away
                f.close()
                raise ShortReadError(
                    f"layer {i}: cannot map {path} "
                    f"({os.path.getsize(path)} bytes, manifest requires "
                    f"{self.layer_nbytes}): {e}", layer=i, path=path,
                    expected=self.layer_nbytes,
                    got=os.path.getsize(path)) from e
            self._files[i] = f
            self._maps[i] = mm
        return mm

    def reopen(self, i: int) -> None:
        """Drop layer ``i``'s cached mapping so the next read re-opens and
        re-maps the file (``IOPolicy``'s retry hook)."""
        mm = self._maps.pop(i, None)
        f = self._files.pop(i, None)
        if mm is not None:
            try:
                mm.close()
            except BufferError:   # an old view pins the map; re-map fresh
                pass
        if f is not None:
            f.close()

    def layer_bytes(self, i: int) -> torch.Tensor:
        """Layer ``i``'s file as one flat uint8 CPU tensor over the
        mapping (zero-copy); a file shorter than the manifest says is a
        ``ShortReadError`` naming the layer and file."""
        if not 0 <= i < self.n_layers:
            raise IndexError(i)
        mm = self._map(i)
        if len(mm) < self.layer_nbytes:
            path = os.path.join(self.directory, _layer_file(i))
            raise ShortReadError(
                f"layer {i} short read: {path} maps {len(mm)} bytes but "
                f"the manifest requires {self.layer_nbytes} "
                f"(file truncated after manifest load?)",
                layer=i, path=path, expected=self.layer_nbytes,
                got=len(mm))
        return _mmap_tensor(mm, self.layer_nbytes)

    def leaves(self, buf: torch.Tensor) -> Params:
        """Layer leaves as views of a flat buffer holding one layer file's
        bytes (a staging copy, on the host or the card)."""
        return _read_leaves(self._leaves, buf)

    def layer(self, i: int) -> Params:
        return self.leaves(self.layer_bytes(i))

    def head(self) -> Params:
        path = os.path.join(self.directory, HEAD_FILE)
        with open(path, "rb") as f:
            raw = bytearray(f.read())
        buf = torch.frombuffer(raw, dtype=torch.uint8) if raw \
            else torch.empty(0, dtype=torch.uint8)
        return _read_leaves(self._head_leaves, buf, copy=True)

    def head_view(self) -> Params:
        """The head's leaves as views of a read-only mapping of its file:
        pages fault in as they are read, so a rank that copies out its
        vocab shard reads that and no more (``head()`` copies the file)."""
        mm = self._maps.get(-1)
        if mm is None:
            path = os.path.join(self.directory, HEAD_FILE)
            if os.path.getsize(path) == 0:
                return self.head()
            f = open(path, "rb")
            mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
            self._files[-1], self._maps[-1] = f, mm
        return _read_leaves(self._head_leaves, _mmap_tensor(mm, len(mm)))

    def release(self, i: int) -> None:
        """Drop layer i's page-cache mapping behind the compute front;
        every drop adds ``layer_nbytes`` to ``released_bytes``."""
        mm = self._maps.get(i)
        if mm is None:
            return
        try:
            if hasattr(mmap, "MADV_DONTNEED"):
                mm.madvise(mmap.MADV_DONTNEED)
                self.released += 1
                self.released_bytes += self.layer_nbytes
        except (OSError, ValueError):  # pragma: no cover - platform quirks
            pass

    def willneed(self, i: int) -> None:
        """Hint the kernel to start reading layer i (prefetch side);
        bounds-checked, and a missing layer file propagates."""
        if not 0 <= i < self.n_layers:
            raise IndexError(i)
        mm = self._map(i)
        if hasattr(mmap, "MADV_WILLNEED"):
            try:
                mm.madvise(mmap.MADV_WILLNEED)
            except (OSError, ValueError):  # pragma: no cover - hint only
                pass

    def close(self) -> None:
        for mm in self._maps.values():
            try:
                mm.close()
            except BufferError:     # a caller still holds a layer() view
                pass
        for f in self._files.values():
            f.close()
        self._maps.clear()
        self._files.clear()

    def __enter__(self) -> "ParamStore":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def stack_layers(trees: List[Any]) -> Any:
    """Per-layer trees stacked over a new leading layer axis (the layout
    ``save_param_store`` and ``ResidentSource`` take)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: stack_layers([t[k] for t in trees]) for k in first}
    if isinstance(first, QuantizedTensor):
        return QuantizedTensor(torch.stack([t.packed for t in trees]),
                               torch.stack([t.scale for t in trees]),
                               first.bits, first.group,
                               (len(trees),) + tuple(first.shape))
    return torch.stack(trees)


def load_resident(store: ParamStore) -> Params:
    """Materialize a full stacked tree from a store (the inverse of
    ``save_param_store`` up to copies)."""
    out = dict(store.head())
    out["blocks"] = stack_layers([store.layer(i)
                                  for i in range(store.n_layers)])
    return out
