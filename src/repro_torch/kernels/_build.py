"""Build and load the port's CUDA kernels.

``nvcc`` compiles each source under ``csrc/`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes``; a source
listed in ``PARTS`` compiles as several objects at once (one per value of
its macro, and one without it), linked into its library. The
libraries land in ``build/kernels/`` at the repository root (git-ignored),
each under a name keyed by a hash of all sources, the header they share
(``csrc/tc_common.cuh``) and the flags, so an edit rebuilds them. Nothing
is built at import: the first launch of any kernel builds every library,
one ``nvcc`` process per source or part, all started together. A missing ``nvcc``
or a failed build raises — there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

_CSRC = Path(__file__).resolve().parent / "csrc"
#: library name -> CUDA source
SOURCES = {"paged_tiles": _CSRC / "paged_tiles.cu",
           "q4_matmul": _CSRC / "q4_matmul.cu",
           "ssd_scan": _CSRC / "ssd_scan.cu"}
#: library name -> (macro, n): the source compiles once with ``-Dmacro=i``
#: for each i < n and once without the macro (paged_tiles: its eight
#: (q, pool, scale) dtype pairs' kernels, and its C interface)
PARTS = {"paged_tiles": ("PAGED_TILES_PAIR", 8)}
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: launches per kernel wrapper; each wrapper adds one where it launches
LAUNCHES: Dict[str, int] = {"paged_verify": 0, "paged_prefill": 0,
                            "paged_verify_quant": 0, "q4_matmul": 0,
                            "flash_verify": 0, "flash_verify_stats": 0,
                            "ssd_scan": 0}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: compiler output (ptxas register and shared-memory lines) of the builds
#: this process ran, by library; empty when the libraries already existed
build_log: Dict[str, str] = {}


def find_nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "nvcc not found (looked at $NVCC, PATH and /usr/local/cuda/bin): "
        "the port's CUDA kernels cannot be built on this machine")


def _key() -> str:
    h = hashlib.sha256()
    for path in sorted(_CSRC.glob("*.cu*")):     # the sources and headers
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(repr(sorted(PARTS.items())).encode())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"{name}_{_key()}.so"


def build() -> Dict[str, Path]:
    """Compile every source whose hashed library does not exist yet, all
    ``nvcc`` processes (a source's parts included) at once, then link the
    parts; returns the library path by name."""
    paths = {name: library_path(name) for name in SOURCES}
    todo = [name for name, p in paths.items() if not p.exists()]
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    procs, objs, temps = [], {}, []
    try:
        for name in todo:
            tmp = paths[name].with_suffix(f".{os.getpid()}.tmp")
            temps.append(tmp)
            macro, n = PARTS.get(name, (None, 0))
            if not n:
                cmds = [[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                         str(SOURCES[name])]]
            else:
                objs[name] = [tmp.with_suffix(f".{i}.o")
                              for i in range(n + 1)]
                temps += objs[name]
                cmds = [[nvcc, *NVCC_FLAGS, "-c",
                         *([f"-D{macro}={i}"] if i < n else []),
                         "-o", str(o), str(SOURCES[name])]
                        for i, o in enumerate(objs[name])]
            for cmd in cmds:
                procs.append((name, cmd, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)))
        failed, logs = [], {name: [] for name in todo}
        for name, cmd, proc in procs:
            out, _ = proc.communicate()
            logs[name].append(out)
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}):\n"
                              f"{' '.join(cmd)}\n{out}")
        for name in objs:
            if failed:
                break
            tmp = paths[name].with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, "-shared", "-o", str(tmp),
                   *(str(o) for o in objs[name])]
            link = subprocess.run(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
            if link.returncode != 0:
                failed.append(f"nvcc failed ({link.returncode}):\n"
                              f"{' '.join(cmd)}\n{link.stdout}")
        if failed:
            raise RuntimeError("\n".join(failed))
        for name in todo:
            os.replace(paths[name].with_suffix(f".{os.getpid()}.tmp"),
                       paths[name])
            build_log[name] = "".join(logs[name])
    finally:
        for *_, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for tmp in temps:
            tmp.unlink(missing_ok=True)
    return paths


def _declare(name: str, lib: ctypes.CDLL) -> None:
    P, I, F, L = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                  ctypes.c_longlong)
    err = getattr(lib, f"{name}_error_string")
    err.argtypes = [I]
    err.restype = ctypes.c_char_p
    if name == "q4_matmul":
        lib.q4_matmul.argtypes = [P] * 5 + [I] * 8 + [P]
        lib.q4_matmul.restype = I
        return
    if name == "ssd_scan":
        lib.ssd_scan.argtypes = [P] * 10 + [I] * 8 + [L] * 10 + [P]
        lib.ssd_scan.restype = I
        return
    lib.paged_tiles.argtypes = [P] * 11 + [I] * 12 + [F] + [I] * 3 + \
        [L] * 9 + [P]
    lib.paged_tiles.restype = I
    lib.paged_tiles_smem_bytes.argtypes = [I, I, I, I, I]
    lib.paged_tiles_smem_bytes.restype = L


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (every library is built on first use)."""
    with _lock:
        if not _libs:
            for lib_name, path in build().items():
                lib = ctypes.CDLL(str(path))
                _declare(lib_name, lib)
                _libs[lib_name] = lib
        return _libs[name]


def check(code: int, what: str, name: str) -> None:
    """Raise if a launch from library ``name`` returned a CUDA error."""
    if code != 0:
        msg = getattr(load(name), f"{name}_error_string")(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
