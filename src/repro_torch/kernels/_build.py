"""Build and load the port's CUDA kernels.

``nvcc`` compiles ``csrc/paged_attention.cu`` for ``sm_90a`` into a shared
library with a plain C interface, loaded with ``ctypes``. The library lands
in ``build/kernels/`` at the repository root (git-ignored), under a name
keyed by a hash of the source and flags, so an edit rebuilds it. Nothing is
built at import: the first launch builds. A missing ``nvcc`` or a failed
build raises — there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

_CSRC = Path(__file__).resolve().parent / "csrc"
SOURCE = _CSRC / "paged_attention.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: launches per kernel wrapper; each wrapper adds one where it launches
LAUNCHES: Dict[str, int] = {"paged_verify": 0, "paged_prefill": 0,
                            "paged_verify_quant": 0}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: compiler output of the build this process loaded (ptxas register and
#: shared-memory lines), or "" when the library was already built
build_log = ""


def find_nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "nvcc not found (looked at $NVCC, PATH and /usr/local/cuda/bin): "
        "the port's CUDA kernels cannot be built on this machine")


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"paged_attention_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the source unless the hashed library already exists."""
    global build_log
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                           f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
    os.replace(tmp, out)
    build_log = res.stdout + res.stderr
    return out


def _declare(lib: ctypes.CDLL) -> None:
    P, I, F, L = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                  ctypes.c_longlong)
    common = [I, I, I, I, I, I, I, I, I, I, F, L, L, L, L, L, L]
    lib.paged_verify.argtypes = [P] * 6 + common + [P]
    lib.paged_prefill.argtypes = [P] * 6 + common + [P]
    lib.paged_verify_quant.argtypes = [P] * 8 + common + [L, L, L, P]
    for fn in (lib.paged_verify, lib.paged_prefill, lib.paged_verify_quant):
        fn.restype = I
    lib.paged_attention_smem_bytes.argtypes = [I, I, I, I, I]
    lib.paged_attention_smem_bytes.restype = L
    lib.paged_attention_error_string.argtypes = [I]
    lib.paged_attention_error_string.restype = ctypes.c_char_p


def load() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            _declare(lib)
            _lib = lib
        return _lib


def check(code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if code != 0:
        msg = load().paged_attention_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
