"""The port's C API (agc_tpu_torch/native: agc.h, agc_capi.cpp, the
reference's libagc ABI) on archives these tests build: against the port's
Decompressor and against agc_tpu's library (agc_tpu.native.get_capi_path)
on the same archives, written by the port and by agc_tpu in both
profiles (a tpu-rans archive from the port's device coder too) and by the
legacy 1.x / 2.x writers of test_legacy_archives.py; the header as C; the
committed example clients compiled unchanged against each library, their
outputs equal line for line; truncated and bit-flipped archives; four
threads sharing one handle.

Every library call runs in a subprocess (``_PROBE``, ctypes only), so a
crash fails a test instead of taking pytest down.
"""

import hashlib
import json
import os
import random
import subprocess
import sys

import numpy as np
import pytest

import agc_tpu.native as tpu_native
from agc_tpu.core.archive import ArchiveWriter
from agc_tpu.core.compressor import create_archive as tpu_create
from agc_tpu_torch import native
from agc_tpu_torch.core import Decompressor
from agc_tpu_torch.core.compressor import CompressorParams, create_archive

from test_legacy_archives import (
    _legacy_base,
    _legacy_v1_collection,
    _legacy_v2_collection,
    _params,
)
from test_torch_create import REPO, _tpu_params
from util import mutate, random_seq, write_fa

SEG = 2000  # segment size of the archives
TIMEOUT = 120  # seconds a probe or an example client may take

# One request a process: {"lib", "archive", "mode": "dump" | "threads",
# "ranges": {"sample\tcontig": [[start, end], ...]}}; prints one JSON
# object. "dump": for prefetching 1 and 0, every sample and contig listed,
# every length (with and without the sample), every contig whole and at
# the given ranges, and the error returns; "threads": four threads on one
# handle extracting every contig three times against one thread's bytes.
_PROBE = r'''
import ctypes, hashlib, json, random, sys, threading
req = json.loads(sys.argv[1])
lib = ctypes.CDLL(req["lib"])
P, S = ctypes.c_void_p, ctypes.c_char_p
lib.agc_open.restype = P
lib.agc_open.argtypes = [S, ctypes.c_int]
lib.agc_close.argtypes = [P]
lib.agc_n_sample.argtypes = [P]
lib.agc_n_ctg.argtypes = [P, S]
lib.agc_get_ctg_len.argtypes = [P, S, S]
lib.agc_get_ctg_seq.argtypes = [P, S, S, ctypes.c_int, ctypes.c_int, S]
lib.agc_reference_sample.restype = P
lib.agc_reference_sample.argtypes = [P]
lib.agc_list_sample.restype = ctypes.POINTER(S)
lib.agc_list_sample.argtypes = [P, ctypes.POINTER(ctypes.c_int)]
lib.agc_list_ctg.restype = ctypes.POINTER(S)
lib.agc_list_ctg.argtypes = [P, S, ctypes.POINTER(ctypes.c_int)]
lib.agc_list_destroy.argtypes = [ctypes.POINTER(S)]
lib.agc_string_destroy.argtypes = [P]


def listed(arr, n):
    if not arr:
        return None
    out = [arr[i].decode() for i in range(n.value)]
    assert arr[n.value] is None  # NULL-terminated
    lib.agc_list_destroy(arr)
    return out


def seq(h, s, c, a, b, cap):
    buf = ctypes.create_string_buffer(cap + 16)
    r = lib.agc_get_ctg_seq(h, s, c, a, b, buf)
    return [r, buf.value.decode() if r >= 0 else None]


def contigs(h):
    n = ctypes.c_int(0)
    out = []
    for s in listed(lib.agc_list_sample(h, ctypes.byref(n)), n) or []:
        m = ctypes.c_int(0)
        for c in listed(lib.agc_list_ctg(h, s.encode(), ctypes.byref(m)), m) or []:
            out.append((s, c, lib.agc_get_ctg_len(h, s.encode(), c.encode())))
    return out


def dump(prefetching):
    h = lib.agc_open(req["archive"].encode(), prefetching)
    if not h:
        return None
    out = {"n_sample": lib.agc_n_sample(h)}
    ref = lib.agc_reference_sample(h)
    out["reference"] = ctypes.string_at(ref).decode() if ref else None
    lib.agc_string_destroy(ref)
    n = ctypes.c_int(0)
    out["samples"] = listed(lib.agc_list_sample(h, ctypes.byref(n)), n)
    out["contigs"] = {}
    for s in out["samples"] or []:
        bs = s.encode()
        m = ctypes.c_int(0)
        names = listed(lib.agc_list_ctg(h, bs, ctypes.byref(m)), m)
        rows = []
        for c in names or []:
            bc = c.encode()
            ln = lib.agc_get_ctg_len(h, bs, bc)
            cap = max(ln, 0)
            whole = seq(h, bs, bc, -1, -1, cap)
            if whole[1] is not None:
                whole[1] = hashlib.sha256(whole[1].encode()).hexdigest()
            ranges = req["ranges"].get(f"{s}\t{c}", [[0, 0], [0, 99]])
            rows.append(dict(name=c, len=ln, len_no_sample=lib.agc_get_ctg_len(h, None, bc),
                             whole=whole, ranges=[[a, b] + seq(h, bs, bc, a, b, cap)
                                                  for a, b in ranges]))
        out["contigs"][s] = dict(n_ctg=lib.agc_n_ctg(h, bs), names=names, rows=rows)
    first = (out["samples"] or ["-"])[0].encode()
    out["errors"] = [
        lib.agc_n_ctg(h, b"no such sample"),
        lib.agc_get_ctg_len(h, b"no such sample", b"c1"),
        lib.agc_get_ctg_len(h, first, b"no such contig"),
        seq(h, b"no such sample", b"c1", -1, -1, 1)[0],
        seq(h, first, b"no such contig", 0, 0, 1)[0],
        bool(lib.agc_list_ctg(h, b"no such sample", ctypes.byref(n))),
        lib.agc_n_ctg(None, first), lib.agc_n_sample(None), lib.agc_close(None),
        lib.agc_list_destroy(None),
    ]
    out["close"] = lib.agc_close(h)
    return out


def threads(prefetching):
    h = lib.agc_open(req["archive"].encode(), prefetching)
    todo = [(s.encode(), c.encode(), ln) for s, c, ln in contigs(h)]
    want = [seq(h, s, c, -1, -1, ln) for s, c, ln in todo]
    got, errors = [], []

    def work(seed):
        try:
            order = list(range(len(todo))) * 3
            random.Random(seed).shuffle(order)
            got.append(all(seq(h, *todo[i][:2], -1, -1, todo[i][2]) == want[i] for i in order))
        except Exception as e:
            errors.append(repr(e))

    ts = [threading.Thread(target=work, args=(i,)) for i in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(60)
    alive = any(t.is_alive() for t in ts)
    lib.agc_close(h)
    return dict(contigs=len(todo), equal=got, errors=errors, alive=alive)


run = dump if req["mode"] == "dump" else threads
print(json.dumps({str(p): run(p) for p in (1, 0)}))
'''


def probe(lib: str, archive: str, mode: str = "dump", ranges=None) -> dict:
    req = dict(lib=lib, archive=archive, mode=mode, ranges=ranges or {})
    res = subprocess.run([sys.executable, "-c", _PROBE, json.dumps(req)],
                         capture_output=True, text=True, timeout=TIMEOUT)
    assert res.returncode == 0, (lib, archive, res.returncode, res.stderr[-2000:])
    return json.loads(res.stdout)


def _ranges(d: Decompressor) -> dict:
    """The ranges probed on each contig: both ends, one base, reversed,
    past the end, a negative start, and 15 bases across each of the first
    three segment boundaries (from the contig's segment lengths)."""
    out = {}
    for s in d.list_samples(sorted_=False):
        for c in d.list_contigs(s):
            ln = d.get_contig_length(s, c)
            ranges = [[0, 0], [0, 99], [ln - 100, ln - 1], [ln - 1, ln - 1], [5, 2], [0, ln],
                      [ln, ln + 3], [-1, 10]]
            at = 0
            for seg in d.collection.get_contig_desc(s, c)[1][:-1][:3]:
                at += seg.raw_length - d.kmer_length
                ranges.append([at - 7, at + 7])
            out[f"{s}\t{c}"] = ranges
    return out


@pytest.fixture(scope="module")
def libs():
    """(port, agc_tpu) library paths. agc_tpu builds its library at first
    use under one fixed file name, so its build can lose a race with
    another test process's once; the other's library is then in place."""
    port = native.get_capi_path()
    assert port is not None, native.capi_build_error()
    tpu = tpu_native.get_capi_path() or tpu_native.get_capi_path()
    assert tpu is not None, "agc_tpu's C API library failed to build"
    return port, tpu


@pytest.fixture(scope="module")
def collection(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("capi_inputs")
    rng = random.Random(77)
    ref = random_seq(rng, 40000)
    files = [str(tmp / "ref.fa")]
    write_fa(files[0], [("chr1 extra description", ref), ("chr2", random_seq(rng, 9000)),
                        ("short", random_seq(rng, 40))])
    for i in range(3):
        files.append(str(tmp / f"s{i}.fa"))
        write_fa(files[-1], [("chr1", mutate(rng, ref)), ("chr2", random_seq(rng, 7000))])
    return files


def _legacy(path: str, version: int) -> str:
    w = ArchiveWriter(path)
    _legacy_base(w, version)
    if version == 1:
        _legacy_v1_collection(w)
        _params(w, 17, 17, 50)
    else:
        _legacy_v2_collection(w)
        _params(w, 17, 17, 50, seg_size=1000)
    w.close()
    return path


ARCHIVES = ["port zstd", "port tpu-rans", "port tpu-rans device coder", "agc_tpu zstd",
            "agc_tpu tpu-rans", "legacy v1", "legacy v2"]


@pytest.fixture(scope="module")
def archives(collection, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("capi_archives")
    out = {name: str(tmp / (name.replace(" ", "_") + ".agc")) for name in ARCHIVES}
    mp = pytest.MonkeyPatch()
    try:
        mp.setenv("AGC_TPU_DEVICE_MATCH", "0")
        for profile in ("zstd", "tpu-rans"):
            params = CompressorParams(segment_size=SEG, profile=profile)
            create_archive(out[f"port {profile}"], collection, params, device="cpu")
            tpu_create(out[f"agc_tpu {profile}"], collection, _tpu_params(params))
        mp.setenv("AGC_TPU_RANS_DEVICE", "1")
        create_archive(out["port tpu-rans device coder"], collection,
                       CompressorParams(segment_size=SEG, profile="tpu-rans"), device="cpu")
    finally:
        mp.undo()
    _legacy(out["legacy v1"], 1)
    _legacy(out["legacy v2"], 2)
    return out


def _decompressor_view(d: Decompressor, ranges: dict) -> dict:
    """What the port's Decompressor says of the probe's questions."""
    view = dict(n_sample=d.get_no_samples(), reference=d.get_reference_sample(),
                samples=d.list_samples(sorted_=False), contigs={})
    for s in view["samples"]:
        rows = []
        for c in d.list_contigs(s):
            seq = d.get_contig_seq(s, c)
            ln = d.get_contig_length(s, c)
            assert ln == len(seq)
            rows.append(dict(name=c, len=ln, len_no_sample=d.get_contig_length("", c),
                             sha=hashlib.sha256(seq).hexdigest(),
                             ranges=[d.get_contig_seq(s, c, a, b).decode()
                                     for a, b in ranges[f"{s}\t{c}"]]))
        view["contigs"][s] = rows
    return view


@pytest.mark.parametrize("name", ARCHIVES)
def test_c_api_matches_decompressor_and_agc_tpu(libs, archives, name):
    """Both libraries, prefetching 1 and 0, say the same of every call;
    and what they extract is the Decompressor's."""
    port_lib, tpu_lib = libs
    d = Decompressor(archives[name])
    try:
        ranges = _ranges(d)
        view = _decompressor_view(d, ranges)
    finally:
        d.close()
    got = probe(port_lib, archives[name], ranges=ranges)
    assert got["1"] == got["0"]
    assert got == probe(tpu_lib, archives[name], ranges=ranges)
    dump = got["1"]
    assert dump["n_sample"] == view["n_sample"] == len(view["samples"])
    assert dump["reference"] == view["reference"]
    assert dump["samples"] == view["samples"]
    for s, rows in view["contigs"].items():
        lib_rows = dump["contigs"][s]
        assert lib_rows["n_ctg"] == len(rows)
        assert lib_rows["names"] == [r["name"] for r in rows]
        for want, have in zip(rows, lib_rows["rows"]):
            assert have["len"] == want["len"]
            assert have["whole"] == [want["len"], want["sha"]]
            assert [text for _a, _b, _r, text in have["ranges"]] == want["ranges"]
            assert [r for _a, _b, r, _text in have["ranges"]] == [len(t) for t in want["ranges"]]
            assert have["len_no_sample"] == want["len_no_sample"]
    assert dump["errors"][:5] == [-1] * 5
    assert dump["errors"][5] is False
    assert dump["close"] == 0
    if name.startswith("legacy"):
        assert dump["samples"] == ["s1"]
    else:
        assert dump["reference"] == "ref" and len(dump["samples"]) == 4
        # chr1 of every sample has segment boundaries to probe
        assert all(len(c["rows"][0]["ranges"]) == 11 for c in dump["contigs"].values())


def test_c_api_corrupted_archives_same_codes(libs, archives, tmp_path):
    """Truncated and bit-flipped copies of a port-written archive: both
    libraries return the same codes (and bytes) to every call."""
    port_lib, tpu_lib = libs
    with open(archives["port zstd"], "rb") as f:
        data = f.read()
    rng = np.random.default_rng(5)
    cases = {f"cut{n}": data[:n] for n in (0, 16, len(data) // 2, len(data) - 8,
                                            len(data) - 1)}
    for pos in [*rng.integers(0, len(data), 6), len(data) - 3, len(data) - 20]:
        flipped = bytearray(data)
        flipped[pos] ^= 1 << int(rng.integers(0, 8))
        cases[f"flip{pos}"] = bytes(flipped)
    d = Decompressor(archives["port zstd"])
    ranges = _ranges(d)
    d.close()
    opened = 0
    for label, blob in cases.items():
        path = str(tmp_path / f"{label}.agc")
        with open(path, "wb") as f:
            f.write(blob)
        got = probe(port_lib, path, ranges=ranges)
        assert got == probe(tpu_lib, path, ranges=ranges), label
        opened += got["1"] is not None
    assert probe(port_lib, str(tmp_path / "absent.agc")) == {"1": None, "0": None}
    assert opened  # some bit flips leave the archive readable


@pytest.mark.parametrize("name", ["port zstd", "port tpu-rans device coder"])
def test_c_api_four_threads_share_a_handle(libs, archives, name):
    got = probe(libs[0], archives[name], mode="threads")
    for run in got.values():
        assert run["contigs"] == 9 and not run["alive"] and not run["errors"]
        assert run["equal"] == [True] * 4


def _build_client(src: str, lib_path: str, out: str, compiler: str, *flags) -> str:
    lib_dir = os.path.dirname(lib_path)
    res = subprocess.run([compiler, *flags, src, "-I", lib_dir, "-L", lib_dir, "-lagcnative",
                          f"-Wl,-rpath,{lib_dir}", "-o", out],
                         capture_output=True, text=True, timeout=TIMEOUT)
    assert res.returncode == 0, res.stderr
    return out


def test_c_header_compiles_as_c(libs, archives, tmp_path):
    """agc.h is valid C: a C client compiles, links and reads an archive."""
    src = tmp_path / "client.c"
    src.write_text(
        '#include "agc.h"\n'
        "#include <stdio.h>\n"
        "int main(int argc, char** argv) {\n"
        "  agc_t* h = agc_open(argv[1], 0);\n"
        "  if (!h) return 1;\n"
        "  printf(\"%d %d\\n\", agc_n_sample(h), agc_get_ctg_len(h, \"s0\", \"chr2\"));\n"
        "  return agc_close(h);\n"
        "}\n"
    )
    exe = _build_client(str(src), libs[0], str(tmp_path / "client"), "gcc", "-std=c99",
                        "-Wall", "-Werror", "-pedantic")
    out = subprocess.run([exe, archives["port zstd"]], capture_output=True, text=True,
                         timeout=TIMEOUT)
    assert out.returncode == 0, out.stderr
    d = Decompressor(archives["port zstd"])
    assert out.stdout == f"4 {d.get_contig_length('s0', 'chr2')}\n"
    d.close()


@pytest.mark.parametrize("example,compiler,flags", [
    ("example_agc_lib_c.c", "gcc", ()),
    ("example_agc_lib_cpp.cpp", "g++", ("-std=c++17",)),
])
def test_examples_print_what_they_print_against_agc_tpu(libs, archives, tmp_path, example,
                                                        compiler, flags):
    """The committed example clients, compiled unchanged against each
    library and run on a port-written archive, print the same lines."""
    src = os.path.join(REPO, "examples", example)
    outs = []
    for which, lib_path in zip(("port", "agc_tpu"), libs):
        exe = _build_client(src, lib_path, str(tmp_path / f"{which}_client"), compiler, *flags)
        res = subprocess.run([exe, archives["port zstd"]], capture_output=True, text=True,
                             timeout=TIMEOUT)
        assert res.returncode == 0, res.stderr
        outs.append(res.stdout.splitlines())
    assert outs[0] == outs[1]
    assert "reference sample: ref" in outs[0]
