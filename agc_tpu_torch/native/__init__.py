"""Native (C++) fast paths of the host layers, loaded with ctypes.

The port's copy of agc_tpu's ``lz_native.cpp`` (LZ coder, FASTA
conversion, nibble packing, the host k-mer scan) is built on demand with
g++ into ``build/agc_tpu_torch/`` beside the package, named by a hash of
the source and flags, so nothing is written next to the source. When no
toolchain is available the pure-Python implementations in
``agc_tpu_torch.core.lz`` are used instead (same token grammar, slower).

The C API (``agc.h``, ``agc_capi.cpp``: the reference's ``libagc`` ABI,
decompression only) is linked with ``lz_native.cpp`` into
``build/agc_tpu_torch/capi_<hash>/libagcnative.so``, with ``agc.h`` copied
beside it, so that directory serves a C client as both ``-I`` and ``-L``
(``get_capi_path``). ``agc_capi.cpp`` declares the three zstd functions
it calls, and the library links ``-l:libzstd.so.1``, the runtime
library's own name, so it builds where neither ``zstd.h`` nor the
unversioned ``libzstd.so`` is installed.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "lz_native.cpp")
_CAPI_SRCS = [_SRC, os.path.join(_DIR, "agc_capi.cpp")]
_CAPI_HEADER = os.path.join(_DIR, "agc.h")
_CAPI_LINK = ["-l:libzstd.so.1"]
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build", "agc_tpu_torch")
_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib = None
_tried = False
_capi_lib = None
_capi_tried = False
_capi_error = None


def _lib_path() -> str:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"liblznative_{h.hexdigest()[:16]}.so")


def _build(out: str) -> bool:
    """Compile lz_native.cpp to ``out`` (first with -march=native, then
    without); concurrent builders each write a private temporary file."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    try:
        for extra in (["-march=native"], []):
            cmd = ["g++", *_FLAGS, *extra, _SRC, "-o", tmp]
            res = subprocess.run(cmd, capture_output=True, timeout=240)
            if res.returncode == 0:
                os.replace(tmp, out)
                return True
        return False
    except Exception:
        return False


def _capi_dir() -> str:
    h = hashlib.sha256(" ".join(_FLAGS + _CAPI_LINK).encode())
    for src in (*_CAPI_SRCS, _CAPI_HEADER):
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"capi_{h.hexdigest()[:16]}")


def _build_capi(out_dir: str) -> str | None:
    """Compile the C API into ``out_dir``/libagcnative.so and copy agc.h
    beside it; concurrent builds each write private temporary files.
    Returns None, or g++'s error output."""
    os.makedirs(out_dir, exist_ok=True)
    tag = f"{os.getpid()}.{threading.get_ident()}.tmp"
    header = os.path.join(out_dir, "agc.h")
    lib = os.path.join(out_dir, "libagcnative.so")
    cmd = ["g++", *_FLAGS, *_CAPI_SRCS, "-o", f"{lib}.{tag}", *_CAPI_LINK]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=240)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"{' '.join(cmd)}: {e}"
    if res.returncode != 0:
        return f"{' '.join(cmd)} exited {res.returncode}:\n{res.stderr}"
    shutil.copyfile(_CAPI_HEADER, f"{header}.{tag}")
    os.replace(f"{header}.{tag}", header)
    os.replace(f"{lib}.{tag}", lib)
    return None


def get_capi_path() -> str | None:
    """Build (at first use) and return the path of the C API's shared
    library (the reference's libagc equivalent: agc_open, agc_get_ctg_seq,
    ...); ``agc.h`` lies in the same directory. None when the build
    failed: ``capi_build_error()`` then gives g++'s output."""
    global _capi_tried, _capi_error
    lib = os.path.join(_capi_dir(), "libagcnative.so")
    with _lock:
        if not os.path.exists(lib):
            if _capi_tried:
                return None
            _capi_tried = True
            _capi_error = _build_capi(os.path.dirname(lib))
            if _capi_error is not None:
                return None
        return lib


def capi_build_error() -> str | None:
    """g++'s output of this process's failed C API build, or None."""
    return _capi_error


def get_capi():
    """ctypes handle to the C API library (or None)."""
    global _capi_lib
    path = get_capi_path()
    if path is None:
        return None
    with _lock:
        if _capi_lib is not None:
            return _capi_lib
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            return None
        lib.agc_open.restype = ctypes.c_void_p
        lib.agc_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
        lib.agc_close.argtypes = [ctypes.c_void_p]
        lib.agc_n_sample.argtypes = [ctypes.c_void_p]
        lib.agc_n_ctg.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.agc_get_ctg_len.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p,
        ]
        lib.agc_get_ctg_seq.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_char_p,
        ]
        lib.agc_reference_sample.restype = ctypes.c_void_p
        lib.agc_reference_sample.argtypes = [ctypes.c_void_p]
        lib.agc_list_sample.restype = ctypes.POINTER(ctypes.c_char_p)
        lib.agc_list_sample.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
        ]
        lib.agc_list_ctg.restype = ctypes.POINTER(ctypes.c_char_p)
        lib.agc_list_ctg.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
        ]
        lib.agc_list_destroy.argtypes = [ctypes.POINTER(ctypes.c_char_p)]
        lib.agc_string_destroy.argtypes = [ctypes.c_void_p]
        _capi_lib = lib
        return _capi_lib


def get_lib():
    """Return the loaded ctypes library or None."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = _lib_path()
        if not os.path.exists(path) and not _build(path):
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            return None
        u8p = ctypes.POINTER(ctypes.c_uint8)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        lib.lz_create.restype = ctypes.c_void_p
        lib.lz_create.argtypes = [ctypes.c_uint32]
        lib.lz_destroy.argtypes = [ctypes.c_void_p]
        lib.lz_prepare.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64]
        lib.lz_assure_index.argtypes = [ctypes.c_void_p]
        lib.lz_ref_ptr.restype = ctypes.c_void_p
        lib.lz_ref_ptr.argtypes = [ctypes.c_void_p]
        lib.lz_ref_len.restype = ctypes.c_uint64
        lib.lz_ref_len.argtypes = [ctypes.c_void_p]
        lib.lz_ctx_bytes.restype = ctypes.c_uint64
        lib.lz_ctx_bytes.argtypes = [ctypes.c_void_p]
        lib.lz_set_v1.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.lz_encode.restype = ctypes.c_int64
        lib.lz_encode.argtypes = [
            ctypes.c_void_p,
            ctypes.c_char_p,
            ctypes.c_uint64,
            u8p,
            ctypes.c_uint64,
        ]
        lib.lz_estimate.restype = ctypes.c_uint64
        lib.lz_estimate.argtypes = [
            ctypes.c_void_p,
            ctypes.c_char_p,
            ctypes.c_uint64,
            ctypes.c_uint64,
        ]
        lib.lz_cost_vector.argtypes = [
            ctypes.c_void_p,
            ctypes.c_char_p,
            ctypes.c_uint64,
            ctypes.c_int,
            u32p,
        ]
        lib.fasta_preprocess.restype = ctypes.c_uint64
        lib.fasta_preprocess.argtypes = [u8p, ctypes.c_uint64, u8p, u8p]
        lib.fasta_preprocess2.restype = ctypes.c_int64
        lib.fasta_preprocess2.argtypes = [
            u8p, ctypes.c_uint64, u8p, u8p,
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.ref_payload_tuples.restype = ctypes.c_int64
        lib.ref_payload_tuples.argtypes = [
            u8p, ctypes.c_uint64, u8p, ctypes.POINTER(ctypes.c_int32),
        ]
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.lz_anchor_diags.restype = ctypes.c_int64
        lib.lz_anchor_diags.argtypes = [
            ctypes.c_char_p, ctypes.c_uint64, ctypes.c_char_p,
            ctypes.c_uint64, ctypes.c_uint32, i32p,
        ]
        lib.lz_encode_anchored.restype = ctypes.c_int64
        lib.lz_encode_anchored.argtypes = [
            ctypes.c_char_p, ctypes.c_uint64, ctypes.c_char_p,
            ctypes.c_uint64, ctypes.c_uint32, i32p, ctypes.c_uint32,
            u8p, ctypes.c_uint64,
        ]
        lib.lz_encode_anchor_host.restype = ctypes.c_int64
        lib.lz_encode_anchor_host.argtypes = [
            ctypes.c_char_p, ctypes.c_uint64, ctypes.c_char_p,
            ctypes.c_uint64, ctypes.c_uint32, u8p, ctypes.c_uint64,
        ]
        lib.lz_encode_anchor_ctx.restype = ctypes.c_int64
        lib.lz_encode_anchor_ctx.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64,
            u8p, ctypes.c_uint64,
        ]
        lib.pack_nibbles.restype = None
        lib.pack_nibbles.argtypes = [u8p, ctypes.c_uint64, u8p]
        lib.tuples_to_bytes.restype = ctypes.c_uint64
        lib.tuples_to_bytes.argtypes = [ctypes.c_char_p, ctypes.c_uint64, u8p]
        lib.rc_numeric.restype = None
        lib.rc_numeric.argtypes = [u8p, ctypes.c_uint64, u8p]
        lib.lz_split_point.restype = ctypes.c_int64
        lib.lz_split_point.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_uint64,
        ]
        lib.numeric_to_fasta.restype = ctypes.c_uint64
        lib.numeric_to_fasta.argtypes = [
            u8p, ctypes.c_uint64, u8p, ctypes.c_uint32, u8p,
        ]
        u64p = ctypes.POINTER(ctypes.c_uint64)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.kmer_canon_all.restype = None
        lib.kmer_canon_all.argtypes = [
            u8p, ctypes.c_int64, ctypes.c_uint32, u64p, u8p,
        ]
        lib.kmer_canon_fill.restype = ctypes.c_int64
        lib.kmer_canon_fill.argtypes = [
            u8p, ctypes.c_int64, ctypes.c_uint32, u64p,
        ]
        lib.kmer_scan_members.restype = ctypes.c_int64
        lib.kmer_scan_members.argtypes = [
            u8p, ctypes.c_int64, ctypes.c_uint32,
            u64p, ctypes.c_int64,
            i64p, u64p, u64p, ctypes.c_int64,
        ]
        lib.kmer_discover_splitters.restype = ctypes.c_int64
        lib.kmer_discover_splitters.argtypes = [
            u8p, ctypes.c_int64, ctypes.c_uint32,
            u64p, ctypes.c_int64, ctypes.c_int64,
            i64p, u64p, ctypes.c_int64,
        ]
        lib.rans_compress.restype = ctypes.c_int64
        lib.rans_compress.argtypes = [u8p, ctypes.c_int64, u8p, ctypes.c_int64]
        lib.rans_decompress.restype = ctypes.c_int64
        lib.rans_decompress.argtypes = [
            u8p, ctypes.c_int64, u8p, ctypes.c_int64,
        ]
        for fn in (lib.lz_decode_v2, lib.lz_decode_v1):
            fn.restype = ctypes.c_int64
            fn.argtypes = [
                ctypes.c_char_p,
                ctypes.c_uint64,
                ctypes.c_char_p,
                ctypes.c_uint64,
                ctypes.c_uint32,
                u8p,
                ctypes.c_uint64,
            ]
        _lib = lib
        return _lib
