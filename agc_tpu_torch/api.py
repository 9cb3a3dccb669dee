"""Public decompression API, parity with the reference C++/Python API.

reference: src/lib-cxx/agc-api.h:23-102 (CAGCFile) and
src/py_agc_api/py_agc_api.cpp.
"""

from __future__ import annotations

from .core.decompressor import Decompressor


class AGCFile:
    """Random-access reader of an .agc archive.

    Mirrors ``CAGCFile``: Open/Close/IsOpened/GetCtgLen/GetCtgSeq/NSample/
    NCtg/ListSample/ListCtg/GetReferenceSample.
    """

    def __init__(self, path: str | None = None, prefetch: bool = True):
        self._d: Decompressor | None = None
        if path is not None:
            self.Open(path, prefetch)

    # -- reference-style API -------------------------------------------

    def Open(self, path: str, prefetching: bool = True) -> bool:
        if self._d is not None:
            return False
        try:
            self._d = Decompressor(path, prefetch=prefetching)
        except (OSError, ValueError, KeyError):
            # reference parity: CAGCFile::Open returns false on a missing
            # or unreadable archive (lib-cxx.cpp:35-43) — the canonical
            # caller pattern is `if not agc.Open(path): ...`
            return False
        return True

    def Close(self) -> bool:
        if self._d is None:
            return False
        self._d.close()
        self._d = None
        return True

    def IsOpened(self) -> bool:
        return self._d is not None

    def GetCtgLen(self, sample: str, name: str) -> int:
        if self._d is None:
            return -1
        return self._d.get_contig_length(sample, name)

    def GetCtgSeq(self, sample: str, name: str, start: int = -1, end: int = -1) -> str:
        if self._d is None:
            return ""
        seq = self._d.get_contig_seq(sample, name, start, end)
        return seq.decode("latin-1") if seq is not None else ""

    def NSample(self) -> int:
        return self._d.get_no_samples() if self._d else -1

    def NCtg(self, sample: str) -> int:
        return self._d.get_no_contigs(sample) if self._d else -1

    def ListSample(self) -> list[str]:
        return self._d.list_samples() if self._d else []

    def ListCtg(self, sample: str) -> list[str]:
        if self._d is None:
            return []
        return self._d.list_contigs(sample) or []

    def GetReferenceSample(self) -> str:
        return self._d.get_reference_sample() if self._d else ""

    # -- pythonic aliases ----------------------------------------------

    open = Open
    close = Close
    is_opened = IsOpened
    get_ctg_len = GetCtgLen
    get_ctg_seq = GetCtgSeq
    n_sample = NSample
    n_ctg = NCtg
    list_sample = ListSample
    list_ctg = ListCtg
    get_reference_sample = GetReferenceSample

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.Close()
