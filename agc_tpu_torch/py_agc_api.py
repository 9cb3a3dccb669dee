"""Drop-in compatibility module for the reference's ``py_agc_api``.

The reference exposes a pybind11 module with a ``CAGCFile`` class and an
opaque ``StringVector`` (reference: src/py_agc_api/py_agc_api.cpp:14-87).
Here both are plain Python: ``StringVector`` is a thin list wrapper kept
for call-site compatibility with scripts written against the reference
binding (they pass a StringVector to ListSample/ListCtg and iterate it).

Usage (same shape as the reference's py_agc_test.py):

    from agc_tpu_torch import py_agc_api
    agc = py_agc_api.CAGCFile()
    agc.Open("collection.agc", True)
    n = agc.NSample()
    samples = py_agc_api.StringVector()
    agc.ListSample(samples)
    seq = agc.GetCtgSeq("contig@sample", 0, 10)
"""

from __future__ import annotations

from .api import AGCFile as _AGCFile


class StringVector(list):
    """List stand-in for the reference binding's opaque vector<string>."""


class CAGCFile:
    def __init__(self):
        self._f = _AGCFile()

    def Open(self, path: str, prefetching: bool = True) -> bool:
        return self._f.Open(path, prefetching)

    def Close(self) -> bool:
        return self._f.Close()

    def IsOpened(self) -> bool:
        return self._f.IsOpened()

    # The reference binding accepts "ctg@sample" in the name argument;
    # its regex is greedy ('(.+)@(.+)', agc_decompressor_lib.h:128), so
    # the LAST '@' separates contig from sample.
    @staticmethod
    def _split(name: str) -> tuple[str, str]:
        if "@" in name:
            ctg, sample = name.rsplit("@", 1)
            return sample, ctg
        return "", name

    def GetCtgLen(self, sample_or_name: str, name: str | None = None) -> int:
        if name is None:
            sample, ctg = self._split(sample_or_name)
        else:
            sample, ctg = sample_or_name, name
        return self._f.GetCtgLen(sample, ctg)

    def GetCtgSeq(self, *args) -> str:
        # both reference overloads (py_agc_api.cpp:77,84):
        #   GetCtgSeq(sample, name, start, end)
        #   GetCtgSeq(name[, start[, end]])   (name may be "ctg@sample")
        if len(args) == 4:
            sample, ctg, start, end = args
        else:
            name = args[0]
            start = args[1] if len(args) > 1 else -1
            end = args[2] if len(args) > 2 else -1
            sample, ctg = self._split(name)
        return self._f.GetCtgSeq(sample, ctg, start, end)

    def NSample(self) -> int:
        return self._f.NSample()

    def NCtg(self, sample: str) -> int:
        return self._f.NCtg(sample)

    def ListSample(self, out: StringVector) -> bool:
        out.clear()
        out.extend(self._f.ListSample())
        return True

    def ListCtg(self, sample: str, out: StringVector) -> bool:
        out.clear()
        out.extend(self._f.ListCtg(sample))
        return True

    def GetReferenceSample(self) -> str:
        return self._f.GetReferenceSample()
