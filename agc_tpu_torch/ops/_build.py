"""Build and load the port's CUDA kernels (``agc_tpu_torch/csrc``).

Each ``*.cu`` source is compiled by its own ``nvcc`` for ``sm_90a``, all
of them at once, and the objects are linked into one shared library with
a plain C interface, loaded with ctypes. The library lives under
``build/agc_tpu_torch/`` beside the package, named by a hash of the
sources, and is built at first use: importing this module builds
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


def _run_all(cmds: list[list[str]]) -> list[tuple[int, str]]:
    """Start every command at once; (returncode, output) of each."""
    procs = [
        subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for c in cmds
    ]
    outs = [p.communicate(timeout=900)[0] for p in procs]
    return [(p.returncode, o) for p, o in zip(procs, outs)]


def build() -> Path:
    """Compile the kernels unless a library for these sources exists."""
    out = BUILD_DIR / f"libagc_kernels_{_digest()}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{_digest()}.{os.getpid()}"
    nvcc = _nvcc()
    sources = sorted(CSRC.glob("*.cu"))
    objs = [BUILD_DIR / f"{p.stem}.{tag}.o" for p in sources]
    compile_cmds = [
        [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-c", "-Xcompiler", "-fPIC",
         "-Xptxas", "-v", "-o", str(o), str(p)]
        for p, o in zip(sources, objs)
    ]
    log = []
    failed = []
    for cmd, (rc, text) in zip(compile_cmds, _run_all(compile_cmds)):
        log.append(" ".join(cmd) + "\n" + text)
        if rc != 0:
            failed.append(text)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    if not failed:
        link = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
        rc, text = _run_all([link])[0]
        log.append(" ".join(link) + "\n" + text)
        if rc != 0:
            failed.append(text)
    (BUILD_DIR / "build.log").write_text("\n".join(log))
    for o in objs:
        o.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(t[-4000:] for t in failed))
    os.replace(tmp, out)
    return out


def _bind(lib) -> None:
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.agc_scan_fused.argtypes = [
        vp, i64, i64, i32, vp, i32, i32, vp, vp, vp,
    ]
    lib.agc_kmer_canon.argtypes = [vp, i64, i64, i32, vp, vp]
    u64t = ctypes.c_uint64
    lib.agc_kmer_dir_rc.argtypes = [vp, i64, i64, i32, vp, vp, vp, vp, vp, u64t, i32, vp, u64t,
                                    i32, vp, i64, vp]
    lib.agc_set_slice_build.argtypes = [vp, i64, vp, i64, u64t, i32, vp, vp, i64, vp, vp, vp]
    lib.agc_set_partition_count.argtypes = [vp, i64, vp, i64, i64, i64, u64t, i32, i32, i32, vp,
                                            vp]
    lib.agc_set_partition_scatter.argtypes = [vp, i64, vp, i64, i64, i64, u64t, i32, i32, i32,
                                              vp, vp, vp]
    lib.agc_set_build_constants.argtypes = [vp]
    lib.agc_walk_index_tile.argtypes = []
    lib.agc_walk_singles.argtypes = [vp, i64, vp, vp, vp, vp]
    lib.agc_walk_dir.argtypes = [vp, i64, i32, vp, vp]
    lib.agc_greedy_walk.argtypes = [vp, vp, vp, i64, vp, vp, i32, i64, i32, vp, vp]
    lib.agc_scan_fused_tile.argtypes = []
    lib.agc_member_mix.argtypes = [vp, i64, vp, i32, vp, vp, vp]
    lib.agc_mix_set_words.argtypes = [i64]
    lib.agc_mix_dir_bits.argtypes = [i64]
    lib.agc_mix_set_debug.argtypes = [vp, i32, vp, vp, vp, vp]
    lib.agc_dir_mix.argtypes = [vp, i64, i64, i32, vp, vp, vp, vp]
    lib.agc_match_estimate_tile.argtypes = []
    lib.agc_match_estimate.argtypes = [
        vp, vp, vp, vp, vp, vp, vp, vp, i64, i64, i64, i32, i32, i32, i32, vp, vp,
    ]
    lib.agc_rans_tables.argtypes = [vp, i64, vp, vp, i64, i64, vp, vp, vp, vp]
    lib.agc_rans_encode.argtypes = [vp, vp, vp, vp, vp, i64, vp, vp, vp]
    lib.agc_rans_layout.argtypes = [vp, vp, vp, i64, vp, vp, vp, vp, vp]
    lib.agc_rans_write.argtypes = [vp, i64, vp, vp, i64, vp, vp, vp, i64, vp, vp, vp, vp, vp,
                                   vp, i64, i64, vp, vp, vp]
    lib.agc_rans_decode.argtypes = [vp, i64, vp, vp, vp, vp, vp, vp, i64, vp, vp]
    for fn in (lib.agc_scan_fused, lib.agc_kmer_canon, lib.agc_kmer_dir_rc,
               lib.agc_set_slice_build, lib.agc_set_partition_count,
               lib.agc_set_partition_scatter, lib.agc_set_build_constants,
               lib.agc_walk_index_tile, lib.agc_walk_singles, lib.agc_walk_dir,
               lib.agc_greedy_walk,
               lib.agc_scan_fused_tile, lib.agc_member_mix, lib.agc_mix_set_words,
               lib.agc_mix_dir_bits, lib.agc_mix_set_debug, lib.agc_dir_mix,
               lib.agc_match_estimate_tile, lib.agc_match_estimate,
               lib.agc_rans_tables, lib.agc_rans_encode, lib.agc_rans_layout,
               lib.agc_rans_write, lib.agc_rans_decode):
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
