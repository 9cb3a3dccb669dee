"""LZ-diff codec: byte-level LZ of a segment against its group reference.

Token grammar is bit-compatible with the reference's CLZDiff_V2
(reference: src/common/lz_diff.{h,cpp}):

- literal          : b'A' + symbol_code          (codes 0..20)
- literal '!'      : symbol equals reference[pred_pos]   (V2 only)
- match            : ascii signed decimal (ref_pos - pred_pos)
                     [',' ascii decimal (len - min_match_len)] '.'
                     (the length is omitted when the match runs to the end of
                      both the segment and the reference -- lz_diff.cpp:781-784)
- N-run            : 0x1E ascii decimal (len - 4) 0x04
- empty encoding   : segment identical to the reference (IMPROVED_LZ_ENCODING)

The *encoder* here makes its own match choices (seed-and-extend over a
sampled hash index, mirroring the reference's defaults: key sampled every
hashing_step=4 positions, key_len = min_match_len - 3, <=64 probe tries),
but any grammar-valid token stream is accepted by the reference decoder, so
byte-identical encode decisions are not required for interoperability.

The hot inner loops have a pure-Python fallback and a C++ fast path
(agc_tpu_torch/native, built by g++ at first use). Segment-vs-candidate
*estimation* is also a batched device kernel (ops/match.py,
ops/cuda_match.py).
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

N_CODE = 4
N_RUN_STARTER = 0x1E
MIN_NRUN_LEN = 4
HASHING_STEP = 4
MAX_NO_TRIES = 64
MAX_LOAD_FACTOR = 0.7
INVALID_SYMBOL = 31

_U64 = np.uint64

# Per-THREAD native encode scratch, shared across every LZDiff instance:
# a per-context buffer (>=64 KB each) multiplied across thousands of
# group writers cost ~0.5 GB at 5 Gbase scale (round-4 memory anatomy).
# The buffer's content is copied out (tobytes) before the thread touches
# another context, so sharing is safe.
_ENC_TLS = threading.local()


def _enc_buffer(cap: int) -> np.ndarray:
    buf = getattr(_ENC_TLS, "buf", None)
    if buf is None or len(buf) < cap:
        buf = _ENC_TLS.buf = np.empty(max(cap, 1 << 16), np.uint8)
    return buf


def _murmur64_np(h):
    h = h.astype(np.uint64, copy=True)
    h ^= h >> _U64(33)
    h *= _U64(0xFF51AFD7ED558CCD)
    h ^= h >> _U64(33)
    h *= _U64(0xC4CEB9FE1A85EC53)
    h ^= h >> _U64(33)
    return h


# ---------------------------------------------------------------------------
# Decode (reference: lz_diff.cpp:801-836)
# ---------------------------------------------------------------------------


# Hard ceiling on a single decoded segment. Legitimate segments are
# bounded by contig length (largest known contigs are a few hundred Mb);
# a corrupt N-run token can claim petabytes, and before this ceiling the
# grow-and-retry loop would attempt the allocation (OOM instead of a
# clean error). Raise via env for exotic inputs.
_MAX_SEGMENT_BYTES = int(
    os.environ.get("AGC_TPU_MAX_SEGMENT_BYTES", str(4 << 30))
)
_MAX_TOKEN_VALUE = 1 << 50  # digit-parse overflow guard (mirrors native)


_U8P = ctypes.POINTER(ctypes.c_uint8)


def _native_decode(fn, reference: bytes, encoded: bytes, min_match_len: int) -> bytes:
    cap = max(2 * len(reference), 4 * len(encoded), 1 << 16)
    for _ in range(2):
        # np.empty: unlike a ctypes array the buffer is NOT zero-filled
        # (decode overwrites it), and the result is one slice-copy out
        buf = np.empty(cap, dtype=np.uint8)
        n = fn(
            reference,
            len(reference),
            encoded,
            len(encoded),
            min_match_len,
            buf.ctypes.data_as(_U8P),
            cap,
        )
        if n >= 0:
            return buf[:n].tobytes()
        if n == -(1 << 63):  # INT64_MIN: token stream walks off the ref
            raise ValueError("Corrupted archive! (invalid segment delta)")
        # -(needed): the stream decodes to exactly -n bytes — allocate
        # once, after the sanity ceiling
        if -n > _MAX_SEGMENT_BYTES:
            raise ValueError(
                f"Corrupted archive! (segment delta claims {-n} bytes)"
            )
        cap = -n
    raise ValueError("Corrupted archive! (invalid segment delta)")


def decode_v2(reference: bytes, encoded: bytes, min_match_len: int) -> bytes:
    """Replay a V2 token stream against ``reference``."""
    from ..native import get_lib

    lib = get_lib()
    if lib is not None:
        return _native_decode(lib.lz_decode_v2, reference, encoded, min_match_len)
    return _decode_v2_py(reference, encoded, min_match_len)


def _decode_v2_py(reference: bytes, encoded: bytes, min_match_len: int) -> bytes:
    if not encoded:
        # identical-to-reference shortcut never reaches here (no delta stored),
        # but an empty stream decodes to empty.
        return b""
    ref = reference
    out = bytearray()
    pred_pos = 0
    i = 0
    n = len(encoded)
    enc = encoded
    ord_A = 0x41
    ord_excl = 0x21
    while i < n:
        c = enc[i]
        if ord_A <= c <= ord_A + 20:  # literal
            out.append(c - ord_A)
            pred_pos += 1
            i += 1
        elif c == ord_excl:  # literal equal to reference
            if pred_pos >= len(ref):
                raise ValueError("Corrupted archive! (invalid segment delta)")
            out.append(ref[pred_pos])
            pred_pos += 1
            i += 1
        elif c == N_RUN_STARTER:  # N-run
            i += 1
            v = 0
            while i < n and enc[i] != N_CODE:
                if not (0x30 <= enc[i] <= 0x39) or v > _MAX_TOKEN_VALUE:
                    raise ValueError("Corrupted archive! (invalid segment delta)")
                v = v * 10 + (enc[i] - 0x30)
                i += 1
            i += 1  # skip stop marker
            if v + MIN_NRUN_LEN + len(out) > _MAX_SEGMENT_BYTES:
                raise ValueError("Corrupted archive! (invalid segment delta)")
            out.extend(bytes([N_CODE]) * (v + MIN_NRUN_LEN))
        else:  # match
            neg = False
            if c == 0x2D:  # '-'
                neg = True
                i += 1
            v = 0
            any_digit = False
            while i < n and 0x30 <= enc[i] <= 0x39:
                if v > _MAX_TOKEN_VALUE:
                    raise ValueError("Corrupted archive! (invalid segment delta)")
                v = v * 10 + (enc[i] - 0x30)
                i += 1
                any_digit = True
            if not any_digit:  # stray byte outside the grammar
                raise ValueError("Corrupted archive! (invalid segment delta)")
            dif_pos = -v if neg else v
            ref_pos = pred_pos + dif_pos
            if ref_pos < 0 or ref_pos > len(ref):
                raise ValueError("Corrupted archive! (invalid segment delta)")
            if i < n and enc[i] == 0x2C:  # ',' => explicit length
                i += 1
                v = 0
                while i < n and 0x30 <= enc[i] <= 0x39:
                    if v > _MAX_TOKEN_VALUE:
                        raise ValueError(
                            "Corrupted archive! (invalid segment delta)"
                        )
                    v = v * 10 + (enc[i] - 0x30)
                    i += 1
                length = v + min_match_len
            else:
                length = len(ref) - ref_pos  # match-to-end
            i += 1  # '.'
            if length > len(ref) - ref_pos:
                raise ValueError("Corrupted archive! (invalid segment delta)")
            out.extend(ref[ref_pos : ref_pos + length])
            pred_pos = ref_pos + length
    return bytes(out)


def decode_v1(reference: bytes, encoded: bytes, min_match_len: int) -> bytes:
    """Replay a V1 token stream (reference: lz_diff.cpp:597-625)."""
    from ..native import get_lib

    lib = get_lib()
    if lib is not None:
        return _native_decode(lib.lz_decode_v1, reference, encoded, min_match_len)
    return _decode_v1_py(reference, encoded, min_match_len)


def _decode_v1_py(reference: bytes, encoded: bytes, min_match_len: int) -> bytes:
    ref = reference
    out = bytearray()
    pred_pos = 0
    i = 0
    n = len(encoded)
    enc = encoded
    while i < n:
        c = enc[i]
        if 0x41 <= c <= 0x41 + 20 or c == 0x21:
            out.append((c - 0x41) & 0xFF)  # '!' wraps to 224, as native
            pred_pos += 1
            i += 1
        elif c == N_RUN_STARTER:
            i += 1
            v = 0
            while i < n and enc[i] != N_CODE:
                if not (0x30 <= enc[i] <= 0x39) or v > _MAX_TOKEN_VALUE:
                    raise ValueError("Corrupted archive! (invalid segment delta)")
                v = v * 10 + (enc[i] - 0x30)
                i += 1
            i += 1
            if v + MIN_NRUN_LEN + len(out) > _MAX_SEGMENT_BYTES:
                raise ValueError("Corrupted archive! (invalid segment delta)")
            out.extend(bytes([N_CODE]) * (v + MIN_NRUN_LEN))
        else:
            neg = False
            if c == 0x2D:
                neg = True
                i += 1
            v = 0
            any_digit = False
            while i < n and 0x30 <= enc[i] <= 0x39:
                if v > _MAX_TOKEN_VALUE:
                    raise ValueError("Corrupted archive! (invalid segment delta)")
                v = v * 10 + (enc[i] - 0x30)
                i += 1
                any_digit = True
            if not any_digit:  # stray byte outside the grammar
                raise ValueError("Corrupted archive! (invalid segment delta)")
            dif_pos = -v if neg else v
            ref_pos = pred_pos + dif_pos
            if ref_pos < 0 or ref_pos > len(ref):
                raise ValueError("Corrupted archive! (invalid segment delta)")
            i += 1  # ','
            if i < n and enc[i] == 0x2E:  # '.' => no length
                length = len(ref) - ref_pos
            else:
                v = 0
                while i < n and 0x30 <= enc[i] <= 0x39:
                    if v > _MAX_TOKEN_VALUE:
                        raise ValueError(
                            "Corrupted archive! (invalid segment delta)"
                        )
                    v = v * 10 + (enc[i] - 0x30)
                    i += 1
                length = v + min_match_len
            i += 1  # '.'
            if length > len(ref) - ref_pos:
                raise ValueError("Corrupted archive! (invalid segment delta)")
            out.extend(ref[ref_pos : ref_pos + length])
            pred_pos = ref_pos + length
    return bytes(out)


# ---------------------------------------------------------------------------
# Encoder: seed-and-extend with a sampled hash index over the reference.
# ---------------------------------------------------------------------------


def _append_int(out: bytearray, x: int) -> None:
    out.extend(str(x).encode("ascii"))


class LZDiff:
    """Group-reference LZ encoder/estimator (V2 grammar).

    Mirrors the reference's index parameters: key_len = min_match_len -
    hashing_step + 1 sampled every ``hashing_step`` positions
    (lz_diff.cpp:16-25), linear probing with <=64 tries.
    """

    def __init__(self, min_match_len: int = 20, v1_grammar: bool = False):
        self.min_match_len = min_match_len
        self.key_len = min_match_len - HASHING_STEP + 1
        # V1 token grammar (format-1.x archives): plain literals only and
        # matches always carry ",len-mml" (reference: CLZDiff_V1::Encode,
        # lz_diff.cpp:443-584)
        self.v1_grammar = v1_grammar
        self.reference: np.ndarray | None = None  # padded with invalid symbols
        self.ref_len = 0
        self.ht: np.ndarray | None = None
        self.ht_mask = 0
        self._index_ready = False
        # native fast path
        from ..native import get_lib

        self._lib = get_lib()
        self._ctx = None

    def __del__(self):
        if getattr(self, "_ctx", None) is not None and self._lib is not None:
            self._lib.lz_destroy(self._ctx)
            self._ctx = None

    def _ref_cptr(self):
        """(c_char_p, len) view of the prepared reference held by the
        native context (stable until the next prepare)."""
        ptr = self._lib.lz_ref_ptr(self._ctx)
        return (
            ctypes.cast(ctypes.c_void_p(ptr), ctypes.c_char_p),
            self.ref_len,
        )

    def ref_bytes(self) -> bytes | None:
        """Materialize the prepared reference (device match bank etc.);
        None when nothing is prepared."""
        if self._ctx is not None:
            if self.ref_len == 0:
                return b""
            ptr = self._lib.lz_ref_ptr(self._ctx)
            return ctypes.string_at(ptr, self.ref_len)
        if self.reference is not None:
            return self.reference[: self.ref_len].tobytes()
        return None

    def prepare(self, reference: bytes) -> None:
        if self._lib is not None:
            if self._ctx is None:
                self._ctx = self._lib.lz_create(self.min_match_len)
                if self.v1_grammar:
                    self._lib.lz_set_v1(self._ctx, 1)
            ref_b = bytes(reference)
            # the native context's copy is the ONLY resident copy: a
            # retained Python duplicate cost ~60 KB x thousands of
            # groups at multi-Gbase scale (round-4 memory anatomy)
            self._lib.lz_prepare(self._ctx, ref_b, len(ref_b))
            self.ref_len = len(ref_b)
            return
        ref = np.frombuffer(reference, dtype=np.uint8)
        padded = np.full(len(ref) + self.key_len, INVALID_SYMBOL, dtype=np.uint8)
        padded[: len(ref)] = ref
        self.reference = padded
        self.ref_len = len(ref)
        self._index_ready = False

    # -- index -----------------------------------------------------------

    def _codes_at(self, arr: np.ndarray, starts: np.ndarray) -> np.ndarray:
        """2-bit pack key_len symbols at each start; ~0 where any symbol > 3."""
        k = self.key_len
        codes = np.zeros(len(starts), dtype=np.uint64)
        valid = np.ones(len(starts), dtype=bool)
        for j in range(k):
            sym = arr[starts + j]
            valid &= sym <= 3
            codes = (codes << _U64(2)) | sym.astype(np.uint64)
        codes[~valid] = ~_U64(0)
        return codes

    def assure_index(self) -> None:
        if self._index_ready:
            return
        ref = self.reference
        k = self.key_len
        n_positions = 0
        starts = np.arange(0, max(0, len(ref) - k - 1) + 1, HASHING_STEP, dtype=np.int64)
        # only positions with i + key_len < len(ref) (reference: make_index loop bound)
        starts = starts[starts + k < len(ref)]
        codes = self._codes_at(ref, starts) if len(starts) else np.empty(0, np.uint64)
        valid_mask = codes != ~_U64(0)
        n_positions = int(valid_mask.sum())

        ht_size = int(n_positions / MAX_LOAD_FACTOR)
        # round down to power of two, then double (reference: lz_diff.cpp:117-125)
        while ht_size & (ht_size - 1):
            ht_size &= ht_size - 1
        ht_size <<= 1
        ht_size = max(ht_size, 8)
        self.ht_mask = ht_size - 1
        ht = np.full(ht_size, -1, dtype=np.int64)

        hashes = _murmur64_np(codes) & _U64(self.ht_mask)
        # sequential insertion with linear probing (order matters for parity
        # of probe sequences; insertion drops entries after 64 tries)
        s_list = starts[valid_mask]
        h_list = hashes[valid_mask].astype(np.int64)
        mask = self.ht_mask
        for s, h in zip(s_list.tolist(), h_list.tolist()):
            pos = h
            for _ in range(MAX_NO_TRIES):
                if ht[pos] < 0:
                    ht[pos] = s
                    break
                pos = (pos + 1) & mask
        self.ht = ht
        self._index_ready = True

    # -- matching --------------------------------------------------------

    def _find_best_match(
        self, text: np.ndarray, i: int, code: int, no_prev_literals: int
    ) -> tuple[int, int, int] | None:
        """Return (ref_pos, len_bck, len_fwd) of best match or None."""
        ht = self.ht
        mask = self.ht_mask
        ref = self.reference
        key_len = self.key_len
        max_len = len(text) - i
        pos = int(_murmur64_np(np.array([code], dtype=np.uint64))[0]) & mask
        best = None
        min_to_update = self.min_match_len
        for _ in range(MAX_NO_TRIES):
            h_pos = ht[pos]
            if h_pos < 0:
                break
            # forward extension
            lim = min(max_len, len(ref) - h_pos)
            f_len = _matching_length(text, i, ref, h_pos, lim)
            if f_len >= key_len:
                b_len = 0
                b_lim = min(no_prev_literals, h_pos)
                while (
                    b_len < b_lim
                    and text[i - b_len - 1] == ref[h_pos - b_len - 1]
                ):
                    b_len += 1
                if b_len + f_len > min_to_update:
                    best = (int(h_pos), b_len, int(f_len))
                    min_to_update = b_len + f_len
            pos = (pos + 1) & mask
        return best

    # -- encode ----------------------------------------------------------

    # -- anchor-mode encode (device-assisted path; see lz_native.cpp) ----

    _ANCHOR_POS_LIMIT = 1 << 24  # slot-table position field width

    def anchor_applies(self, n: int) -> bool:
        """Does the anchor-mode decision rule apply to a text of length
        ``n`` against the prepared reference? Pure function of (n, m) —
        the device prepass and the host twin must agree on this so
        device-on and device-off archives stay byte-identical."""
        if self._ctx is None or self.v1_grammar:
            return False
        m = self.ref_len
        return (
            0 < m < self._ANCHOR_POS_LIMIT
            and n < self._ANCHOR_POS_LIMIT
            and m >= self.key_len + 4
        )

    def encode_anchor(self, text_b: bytes, tables=None) -> bytes | None:
        """Anchor-mode encode: emit V2 tokens from the anchor diagonal
        set (``tables`` = int32 array of diagonals from the device
        kernel ops/match.py::anchor_diag_sets, INT32_MIN-padded, or
        None to compute it with the native host twin). Returns None
        when the rule does not apply (caller must use the classic
        encoder). Byte-identical regardless of where the set came
        from."""
        text = text_b if isinstance(text_b, bytes) else bytes(text_b)
        if not self.anchor_applies(len(text)):
            return None
        ref, ref_n = self._ref_cptr()
        u8p = ctypes.POINTER(ctypes.c_uint8)
        buf = _enc_buffer(max(len(text) + 64, 1 << 12))
        if tables is None:
            # ctx variant: the reference occurrence map is built once
            # per prepared reference and cached in the native context
            n = self._lib.lz_encode_anchor_ctx(
                self._ctx, text, len(text),
                buf.ctypes.data_as(u8p), len(buf),
            )
            if n == -(1 << 63):
                return None
            if n < 0:
                buf = _enc_buffer(-n + 64)
                n = self._lib.lz_encode_anchor_ctx(
                    self._ctx, text, len(text),
                    buf.ctypes.data_as(u8p), len(buf),
                )
        else:
            diags = np.ascontiguousarray(tables, dtype=np.int32)
            ndiag = int(np.sum(diags != np.int32(-(1 << 31))))
            i32p = ctypes.POINTER(ctypes.c_int32)
            n = self._lib.lz_encode_anchored(
                text, len(text), ref, ref_n, self.min_match_len,
                diags.ctypes.data_as(i32p), ndiag,
                buf.ctypes.data_as(u8p), len(buf),
            )
            if n < 0:
                buf = _enc_buffer(-n + 64)
                n = self._lib.lz_encode_anchored(
                    text, len(text), ref, ref_n, self.min_match_len,
                    diags.ctypes.data_as(i32p), ndiag,
                    buf.ctypes.data_as(u8p), len(buf),
                )
        return buf[:n].tobytes()

    def anchor_diags_host(self, text_b: bytes):
        """Host-twin anchor diagonal set for ``text_b`` (parity testing
        against the device kernel): -> int32[32], INT32_MIN-padded; None
        when the rule does not apply."""
        text = bytes(text_b)
        ref, ref_n = self._ref_cptr()
        diags = np.empty(32, dtype=np.int32)
        i32p = ctypes.POINTER(ctypes.c_int32)
        r = self._lib.lz_anchor_diags(
            text, len(text), ref, ref_n, self.min_match_len,
            diags.ctypes.data_as(i32p),
        )
        if r < 0:
            return None
        return diags

    def encode(self, text_b: bytes) -> bytes:
        """Encode ``text_b``; returns b"" when identical to the reference."""
        if self._ctx is not None:
            text = text_b if isinstance(text_b, bytes) else bytes(text_b)
            buf = _enc_buffer(max(len(text) + 64, 1 << 12))
            u8p = ctypes.POINTER(ctypes.c_uint8)
            n = self._lib.lz_encode(
                self._ctx, text, len(text), buf.ctypes.data_as(u8p), len(buf)
            )
            if n < 0:
                buf = _enc_buffer(-n + 64)
                n = self._lib.lz_encode(
                    self._ctx, text, len(text),
                    buf.ctypes.data_as(u8p), len(buf),
                )
            return buf[:n].tobytes()
        self.assure_index()
        text = np.frombuffer(text_b, dtype=np.uint8)
        n = len(text)
        ref = self.reference
        if n == self.ref_len and _arr_equal(text, ref[: self.ref_len]):
            return b""

        out = bytearray()
        key_len = self.key_len
        mml = self.min_match_len
        i = 0
        pred_pos = 0
        no_prev_literals = 0
        x_prev_valid = False
        x_prev = 0
        key_mask = (1 << (2 * key_len)) - 1

        while i + key_len < n:
            if x_prev_valid and no_prev_literals > 0:
                s = text[i + key_len - 1]
                if s > 3:
                    x = None
                else:
                    x = ((x_prev << 2) & key_mask) | int(s)
            else:
                x = _get_code(text, i, key_len)
            x_prev = x if x is not None else 0
            x_prev_valid = x is not None

            if x is None:
                nrun = _get_nrun_len(text, i, n)
                if nrun >= MIN_NRUN_LEN:
                    out.append(N_RUN_STARTER)
                    _append_int(out, nrun - MIN_NRUN_LEN)
                    out.append(N_CODE)
                    i += nrun
                    no_prev_literals = 0
                else:
                    out.append(0x41 + int(text[i]))
                    i += 1
                    pred_pos += 1
                    no_prev_literals += 1
                continue

            m = self._find_best_match(text, i, x, no_prev_literals)
            if m is None:
                out.append(0x41 + int(text[i]))
                i += 1
                pred_pos += 1
                no_prev_literals += 1
                continue

            match_pos, len_bck, len_fwd = m
            if len_bck:
                del out[-len_bck:]
                match_pos -= len_bck
                pred_pos -= len_bck
                i -= len_bck

            # rewrite recent literals equal to ref as '!' (lz_diff.cpp:769-779)
            if not self.v1_grammar and match_pos == pred_pos:
                e_size = len(out)
                for j in range(1, min(e_size, match_pos)):
                    c = out[e_size - j]
                    if c < 0x41 or c > 0x5A:
                        break
                    if c - 0x41 == ref[match_pos - j]:
                        out[e_size - j] = 0x21
            total_len = len_bck + len_fwd
            dif_pos = match_pos - pred_pos
            _append_signed(out, dif_pos)
            if self.v1_grammar or not (
                i + total_len == n and match_pos + total_len == self.ref_len
            ):
                out.append(0x2C)
                _append_int(out, total_len - mml)
            out.append(0x2E)
            pred_pos = match_pos + total_len
            i += total_len
            no_prev_literals = 0

        while i < n:
            out.append(0x41 + int(text[i]))
            i += 1
        return bytes(out)

    # -- estimate --------------------------------------------------------

    def estimate(self, text_b: bytes, bound: int = 1 << 62) -> int:
        """Token-stream size estimate with early-exit bound
        (reference: lz_diff.cpp:839-946)."""
        if self._ctx is not None:
            text = bytes(text_b)
            return int(self._lib.lz_estimate(self._ctx, text, len(text), bound))
        self.assure_index()
        text = np.frombuffer(text_b, dtype=np.uint8)
        n = len(text)
        ref = self.reference
        if n == self.ref_len and _arr_equal(text, ref[: self.ref_len]):
            return 0
        cost = 0
        key_len = self.key_len
        mml = self.min_match_len
        i = 0
        pred_pos = 0
        no_prev_literals = 0
        x_prev_valid = False
        x_prev = 0
        key_mask = (1 << (2 * key_len)) - 1
        while i + key_len < n:
            if cost > bound:
                return cost
            if x_prev_valid and no_prev_literals > 0:
                s = text[i + key_len - 1]
                x = None if s > 3 else (((x_prev << 2) & key_mask) | int(s))
            else:
                x = _get_code(text, i, key_len)
            x_prev = x if x is not None else 0
            x_prev_valid = x is not None
            if x is None:
                nrun = _get_nrun_len(text, i, n)
                if nrun >= MIN_NRUN_LEN:
                    cost += 2 + _uint_len(nrun - MIN_NRUN_LEN)
                    i += nrun
                    no_prev_literals = 0
                else:
                    cost += 1
                    i += 1
                    pred_pos += 1
                    no_prev_literals += 1
                continue
            m = self._find_best_match(text, i, x, no_prev_literals)
            if m is None:
                cost += 1
                i += 1
                pred_pos += 1
                no_prev_literals += 1
                continue
            match_pos, len_bck, len_fwd = m
            if len_bck:
                cost -= len_bck
                match_pos -= len_bck
                pred_pos -= len_bck
                i -= len_bck
            total_len = len_bck + len_fwd
            dif_pos = match_pos - pred_pos
            c = _uint_len(abs(dif_pos)) + (1 if dif_pos < 0 else 0)
            # V1 grammar always spells out ',len' (encode above), so the
            # match-to-end discount applies to V2 only
            if self.v1_grammar or not (
                i + total_len == n and match_pos + total_len == self.ref_len
            ):
                c += 1 + _uint_len(total_len - mml)
            cost += c + 1
            pred_pos = match_pos + total_len
            i += total_len
            no_prev_literals = 0
        cost += n - i
        return cost

    def get_coding_cost_vector(
        self, text_b: bytes, prefix_costs: bool
    ) -> np.ndarray:
        """Per-position coding costs for split-point search
        (reference: lz_diff.cpp:159-284)."""
        if self._ctx is not None:
            text = bytes(text_b)
            out = np.zeros(len(text), dtype=np.uint32)
            if len(text):
                self._lib.lz_cost_vector(
                    self._ctx,
                    text,
                    len(text),
                    1 if prefix_costs else 0,
                    out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
                )
            return out
        self.assure_index()
        text = np.frombuffer(text_b, dtype=np.uint8)
        n = len(text)
        costs: list[int] = []
        key_len = self.key_len
        mml = self.min_match_len
        i = 0
        pred_pos = 0
        no_prev_literals = 0
        x_prev_valid = False
        x_prev = 0
        key_mask = (1 << (2 * key_len)) - 1
        while i + key_len < n:
            if x_prev_valid and no_prev_literals > 0:
                s = text[i + key_len - 1]
                x = None if s > 3 else (((x_prev << 2) & key_mask) | int(s))
            else:
                x = _get_code(text, i, key_len)
            x_prev = x if x is not None else 0
            x_prev_valid = x is not None
            if x is None:
                nrun = _get_nrun_len(text, i, n)
                if nrun >= MIN_NRUN_LEN:
                    tc = 2 + _uint_len(nrun - MIN_NRUN_LEN)
                    if prefix_costs:
                        costs.append(tc)
                        costs.extend([0] * (nrun - 1))
                    else:
                        costs.extend([0] * (nrun - 1))
                        costs.append(tc)
                    i += nrun
                    no_prev_literals = 0
                else:
                    costs.append(1)
                    i += 1
                    pred_pos += 1
                    no_prev_literals += 1
                continue
            m = self._find_best_match(text, i, x, no_prev_literals)
            if m is None:
                costs.append(1)
                i += 1
                pred_pos += 1
                no_prev_literals += 1
                continue
            match_pos, len_bck, len_fwd = m
            if len_bck:
                del costs[-len_bck:]
                match_pos -= len_bck
                pred_pos -= len_bck
                i -= len_bck
            total_len = len_bck + len_fwd
            # note: the reference's cost vector uses the V1-style cost
            # (always includes the length field; lz_diff.h:159-172)
            dif_pos = match_pos - pred_pos
            tc = _uint_len(abs(dif_pos)) + (1 if dif_pos < 0 else 0)
            tc += _uint_len(total_len - mml) + 2
            if prefix_costs:
                costs.append(tc)
                costs.extend([0] * (total_len - 1))
            else:
                costs.extend([0] * (total_len - 1))
                costs.append(tc)
            pred_pos = match_pos + total_len
            i += total_len
            no_prev_literals = 0
        costs.extend([1] * (n - i))
        return np.asarray(costs, dtype=np.uint32)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _arr_equal(a: np.ndarray, b: np.ndarray) -> bool:
    return len(a) == len(b) and bool(np.array_equal(a, b))


def _get_code(text: np.ndarray, i: int, key_len: int) -> int | None:
    window = text[i : i + key_len]
    if np.any(window > 3):
        return None
    x = 0
    for s in window.tolist():
        x = (x << 2) | s
    return x


def _get_nrun_len(text: np.ndarray, i: int, n: int) -> int:
    if (
        i + 2 >= n
        or text[i] != N_CODE
        or text[i + 1] != N_CODE
        or text[i + 2] != N_CODE
    ):
        return 0
    j = i + 3
    # vectorized run scan
    rest = text[j:]
    nz = np.flatnonzero(rest != N_CODE)
    return (3 + int(nz[0])) if len(nz) else (n - i)


def _matching_length(
    text: np.ndarray, i: int, ref: np.ndarray, h_pos: int, max_len: int
) -> int:
    a = text[i : i + max_len]
    b = ref[h_pos : h_pos + max_len]
    lim = min(len(a), len(b))
    neq = np.flatnonzero(a[:lim] != b[:lim])
    return int(neq[0]) if len(neq) else lim


def _append_signed(out: bytearray, x: int) -> None:
    out.extend(str(x).encode("ascii"))


def _uint_len(x: int) -> int:
    if x < 10:
        return 1
    if x < 100:
        return 2
    if x < 1000:
        return 3
    if x < 10000:
        return 4
    if x < 100000:
        return 5
    if x < 1000000:
        return 6
    if x < 10000000:
        return 7
    return 8
