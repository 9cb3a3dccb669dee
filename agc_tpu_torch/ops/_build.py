"""Build and load the port's CUDA kernels (``agc_tpu_torch/csrc``).

All ``*.cu`` sources are compiled by ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface, loaded with ctypes. The library
lives under ``build/agc_tpu_torch/`` beside the package, named by a hash
of the sources, and is built at first use: importing this module builds
nothing. ``nvcc``'s ``-Xptxas -v`` report (registers, shared memory,
spills per kernel) is kept in ``build.log`` next to it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "agc_tpu_torch"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_lock = threading.Lock()
_lib = None


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(ARCH_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build() -> Path:
    """Compile the kernels unless a library for these sources exists."""
    out = BUILD_DIR / f"libagc_kernels_{_digest()}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [
        _nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
        "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(tmp),
        *[str(p) for p in sorted(CSRC.glob("*.cu"))],
    ]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    (BUILD_DIR / "build.log").write_text(
        " ".join(cmd) + "\n" + res.stdout + res.stderr
    )
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({res.returncode}):\n{res.stderr[-4000:]}"
        )
    os.replace(tmp, out)
    return out


def _bind(lib) -> None:
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.agc_scan_fused.argtypes = [
        vp, i64, i64, i32, vp, i32, i32, vp, vp, vp,
    ]
    lib.agc_kmer_canon.argtypes = [vp, i64, i64, i32, vp, vp]
    lib.agc_greedy_walk.argtypes = [vp, vp, vp, i64, vp, i64, i64, i32, vp, vp]
    for fn in (lib.agc_scan_fused, lib.agc_kmer_canon, lib.agc_greedy_walk):
        fn.restype = ctypes.c_int
    lib.agc_cuda_error_string.argtypes = [ctypes.c_int]
    lib.agc_cuda_error_string.restype = ctypes.c_char_p


def lib():
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            _bind(handle)
            _lib = handle
        return _lib


def check(rc: int, name: str) -> None:
    """Raise when a kernel entry point returned a CUDA error."""
    if rc != 0:
        msg = lib().agc_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")
