"""JPEG streams written by hand with numpy alone (no Pillow, no libjpeg):
lossless frames (SOF3, T.81 Annex H) for the codec's tests and for
``chip_smoke.py``, whose card machine has no JPEG encoder, and flat frames
of every other kind Pillow refuses (SOF11 and the hierarchical ones), each
coded as its marker says, for the refusal tests.

Every Huffman table here gives each symbol a five-bit code equal to it (the
lossless difference categories 0-16); the arithmetic coder is libjpeg's
jcarith.c (T.81 Annex D), with the Qe table of T.81 Table D.2.
"""

from __future__ import annotations

import struct

import numpy as np

SOI, EOI = b"\xff\xd8", b"\xff\xd9"
_VALS = bytes(range(17))


def segment(marker: int, body: bytes) -> bytes:
    return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body


def jfif() -> bytes:
    return segment(0xE0, b"JFIF\0\x01\x01\0\0\x01\0\x01\0\0")


def adobe(transform: int) -> bytes:
    return segment(0xEE, b"Adobe\0\x64\0\0\0\0" + bytes([transform]))


def dht(index: int = 0, ac: bool = False, symbols: int = 17) -> bytes:
    """Table ``index``: ``symbols`` five-bit codes, code i for symbol i (a
    DCT frame's DC table takes 16: its categories stop at 15)."""
    return segment(0xC4, bytes([(0x10 if ac else 0) | index, 0, 0, 0, 0, symbols] + [0] * 11) + _VALS[:symbols])


def sof(marker: int, h: int, w: int, comps: list[tuple[int, int, int]], precision: int = 8) -> bytes:
    """``comps``: (id, h sampling, v sampling) each, quantisation table 0."""
    body = struct.pack(">BHHB", precision, h, w, len(comps))
    body += b"".join(bytes([cid, (hs << 4) | vs, 0]) for cid, hs, vs in comps)
    return segment(marker, body)


def sos(ids: list[int], ss: int, se: int = 0, ah: int = 0, al: int = 0, tables: list[int] | None = None) -> bytes:
    tables = tables or [0] * len(ids)
    body = bytes([len(ids)]) + b"".join(bytes([cid, (t << 4) | t]) for cid, t in zip(ids, tables))
    return segment(0xDA, body + bytes([ss, se, (ah << 4) | al]))


def pack_bits(vals: np.ndarray, lens: np.ndarray) -> bytes:
    """Codes of ``lens`` bits (at most 25, MSB first) → bytes, the last
    padded with 1 bits, each 0xFF byte followed by a stuffed 0x00 (T.81
    F.1.2.3). Each code is placed in the 32-bit window of the byte it
    starts in; codes share no bit, so summing the windows' bytes is ORing
    them."""
    vals, lens = np.asarray(vals, np.int64), np.asarray(lens, np.int64)
    ends = np.cumsum(lens)
    total = int(ends[-1]) if len(ends) else 0
    acc = np.zeros((total + 7) // 8 + 4, np.int64)
    step = 1 << 22
    for s in range(0, len(vals), step):
        start = ends[s:s + step] - lens[s:s + step]
        byte = start >> 3
        window = vals[s:s + step] << (32 - (start & 7) - lens[s:s + step])
        runs = np.flatnonzero(np.diff(byte, prepend=-1))  # the codes starting in each byte, in runs
        for k in range(4):
            acc[byte[runs] + k] += np.add.reduceat((window >> (24 - 8 * k)) & 0xFF, runs)
    data = acc[:(total + 7) // 8].astype(np.uint8)
    if total % 8:
        data[-1] |= (1 << (8 - total % 8)) - 1
    return np.insert(data, np.flatnonzero(data == 0xFF) + 1, 0).tobytes()


def _predict(x: np.ndarray, predictor: int, first_rows: np.ndarray, initial: int) -> np.ndarray:
    """T.81 H.1.2.1 predictions of plane ``x`` (int64): a first row (of the
    scan or after a restart) from the left, its first sample ``initial``;
    the first column from above; the rest by ``predictor`` (1-7)."""
    ra = np.zeros_like(x)
    ra[:, 1:] = x[:, :-1]
    rb = np.zeros_like(x)
    rb[1:] = x[:-1]
    rc = np.zeros_like(x)
    rc[1:, 1:] = x[:-1, :-1]
    pred = {1: ra, 2: rb, 3: rc, 4: ra + rb - rc, 5: ra + ((rb - rc) >> 1), 6: rb + ((ra - rc) >> 1),
            7: (ra + rb) >> 1}[predictor].copy()
    pred[:, 0] = rb[:, 0]
    pred[first_rows] = ra[first_rows]
    pred[first_rows, 0] = initial
    return pred


_NBITS = np.array([0] + [int(v).bit_length() for v in range(1, 32769)], np.int64)


def _categories(diff: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Lossless differences (already mod 2^16, as -32767..32768) → (code
    value, length): the 5-bit category, then its extra bits (F.1.2.1;
    32768 is category 16, with none)."""
    s = _NBITS[np.abs(diff)]
    nextra = np.where(s == 16, 0, s)
    extra = np.where(diff < 0, diff - 1, diff) & ((1 << nextra) - 1)
    return (s << nextra) | extra, 5 + nextra


def lossless_jpeg(img: np.ndarray, predictor: int = 1, pt: int = 0, restart_rows: int = 0,
                  ids: tuple[int, ...] | None = None, sampling: list[tuple[int, int]] | None = None,
                  interleaved: bool = True, markers: bytes = b"", marker: int = 0xC3,
                  precision: int = 8, damage: int | None = None, eoi: bool = True) -> bytes:
    """An 8-bit lossless JPEG of ``img`` (u8 [H, W] or [H, W, C]).

    ``sampling`` gives each component's (h, v) factors; a component is
    decimated from ``img`` by max/own factor. ``restart_rows`` MCU rows
    make one restart interval; ``interleaved`` False writes one scan per
    component; ``markers`` go after SOI (JFIF, Adobe); ``damage`` replaces
    the code of the sample with that index in the first scan by 11111
    (no code of the table); ``marker`` and ``precision`` go in the frame
    header as given."""
    img = img[..., None] if img.ndim == 2 else img
    h, w, nc = img.shape
    sampling = sampling or [(1, 1)] * nc
    ids = ids or tuple(range(1, nc + 1))
    hmax, vmax = max(s[0] for s in sampling), max(s[1] for s in sampling)
    planes = [img[::vmax // sv, ::hmax // sh, c].astype(np.int32) >> pt for c, (sh, sv) in enumerate(sampling)]
    initial = 1 << (precision - pt - 1)
    out = [SOI, markers, dht(0), sof(marker, h, w, [(ids[c], *sampling[c]) for c in range(nc)], precision)]
    scans = [list(range(nc))] if interleaved else [[c] for c in range(nc)]
    for k, scan in enumerate(scans):
        multi = len(scan) > 1
        mcus_x = -(-w // hmax) if multi else planes[scan[0]].shape[1]
        mcus_y = -(-h // vmax) if multi else planes[scan[0]].shape[0]
        unit = [(sampling[c][0], sampling[c][1]) if multi else (1, 1) for c in scan]
        # differences over each component's MCU-padded grid (padding: 0)
        grids = []
        for c, (uh, uv) in zip(scan, unit):
            p = planes[c]
            rows_per_mcu = uv
            first = np.zeros(p.shape[0], bool)
            first[0] = True
            if restart_rows:
                first[np.arange(0, p.shape[0], restart_rows * rows_per_mcu)] = True
            diff = (p - _predict(p, predictor, first, initial)) & 0xFFFF
            diff = np.where(diff > 32768, diff - 65536, diff)
            g = np.zeros((mcus_y * uv, mcus_x * uh), np.int32)
            g[:p.shape[0], :p.shape[1]] = diff
            grids.append(g.reshape(mcus_y, uv, mcus_x, uh).transpose(0, 2, 1, 3).reshape(mcus_y, mcus_x, uv * uh))
        seq = np.concatenate(grids, axis=2)  # [MCU row, MCU, samples of the MCU in scan order]
        vals, lens = _categories(seq.reshape(mcus_y, -1))
        if damage is not None and k == 0:
            flat_v, flat_l = vals.reshape(-1), lens.reshape(-1)
            flat_v[damage], flat_l[damage] = 0x1F, 5
        ri = restart_rows * mcus_x
        out.append(segment(0xDD, struct.pack(">H", ri)) if restart_rows else b"")
        out.append(sos([ids[c] for c in scan], predictor, 0, 0, pt))
        step = restart_rows or mcus_y
        for j, r0 in enumerate(range(0, mcus_y, step)):
            if j:
                out.append(bytes([0xFF, 0xD0 + (j - 1) % 8]))
            out.append(pack_bits(vals[r0:r0 + step].reshape(-1), lens[r0:r0 + step].reshape(-1)))
    out.append(EOI if eoi else b"")
    return b"".join(out)


# ---------------------------------------------------------------------------
# Flat frames of the kinds Pillow refuses, coded as their markers say
# ---------------------------------------------------------------------------

_QE = [  # T.81 Table D.2: (Qe, Next_Index_LPS, Next_Index_MPS, Switch_MPS)
    (0x5A1D, 1, 1, 1), (0x2586, 14, 2, 0), (0x1114, 16, 3, 0), (0x080B, 18, 4, 0), (0x03D8, 20, 5, 0),
    (0x01DA, 23, 6, 0), (0x00E5, 25, 7, 0), (0x006F, 28, 8, 0), (0x0036, 30, 9, 0), (0x001A, 33, 10, 0),
    (0x000D, 35, 11, 0), (0x0006, 9, 12, 0), (0x0003, 10, 13, 0), (0x0001, 12, 13, 0), (0x5A7F, 15, 15, 1),
    (0x3F25, 36, 16, 0), (0x2CF2, 38, 17, 0), (0x207C, 39, 18, 0), (0x17B9, 40, 19, 0), (0x1182, 42, 20, 0),
    (0x0CEF, 43, 21, 0), (0x09A1, 45, 22, 0), (0x072F, 46, 23, 0), (0x055C, 48, 24, 0), (0x0406, 49, 25, 0),
    (0x0303, 51, 26, 0), (0x0240, 52, 27, 0), (0x01B1, 54, 28, 0), (0x0144, 56, 29, 0), (0x00F5, 57, 30, 0),
    (0x00B7, 59, 31, 0), (0x008A, 60, 32, 0), (0x0068, 62, 33, 0), (0x004E, 63, 34, 0), (0x003B, 32, 35, 0),
    (0x002C, 33, 9, 0), (0x5AE1, 37, 37, 1), (0x484C, 64, 38, 0), (0x3A0D, 65, 39, 0), (0x2EF1, 67, 40, 0),
]


class _QMEncoder:
    """jcarith.c's arith_encode and finish_pass, for decisions in a state
    table below index 40 (all a flat frame needs)."""

    def __init__(self):
        self.c, self.a, self.sc, self.zc, self.ct, self.buffer = 0, 0x10000, 0, 0, 11, -1
        self.out = bytearray()

    def _emit(self, b: int) -> None:
        self.out.append(b)

    def _flush_stacked(self, carry: bool) -> None:
        if carry:
            if self.buffer >= 0:
                self.out += b"\0" * self.zc
                self.zc = 0
                self._emit(self.buffer + 1)
                if self.buffer + 1 == 0xFF:
                    self._emit(0)
            self.zc += self.sc
            self.sc = 0
        else:
            if self.buffer == 0:
                self.zc += 1
            elif self.buffer >= 0:
                self.out += b"\0" * self.zc
                self.zc = 0
                self._emit(self.buffer)
            if self.sc:
                self.out += b"\0" * self.zc
                self.zc = 0
                self.out += b"\xff\0" * self.sc
                self.sc = 0

    def encode(self, st: list, val: int) -> None:
        sv = st[0]
        qe, nl, nm, switch = _QE[sv & 0x7F]
        self.a -= qe
        if val != (sv >> 7):
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            st[0] = (sv & 0x80) ^ (nl | (switch << 7))
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            st[0] = (sv & 0x80) ^ nm
        while True:
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                temp = self.c >> 19
                if temp > 0xFF:
                    self._flush_stacked(True)
                    self.buffer = temp & 0xFF
                elif temp == 0xFF:
                    self.sc += 1
                else:
                    self._flush_stacked(False)
                    self.buffer = temp & 0xFF
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                break

    def finish(self) -> bytes:
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        self._flush_stacked(bool(self.c & 0xF8000000))
        if self.c & 0x7FFF800:
            self.out += b"\0" * self.zc
            self.zc = 0
            self._emit((self.c >> 19) & 0xFF)
            if (self.c >> 19) & 0xFF == 0xFF:
                self._emit(0)
            if self.c & 0x7F800:
                self._emit((self.c >> 11) & 0xFF)
                if (self.c >> 11) & 0xFF == 0xFF:
                    self._emit(0)
        return bytes(self.out)


def flat_frame(marker: int, h: int = 16, w: int = 16, dhp: bool = True) -> bytes:
    """A one-component frame of mid-grey (128) under SOF ``marker``, its
    scan coded as the marker says: DCT Huffman (SOF0/1/2/5/6: every
    coefficient 0), lossless Huffman (SOF3/7: every difference 0), DCT
    arithmetic (SOF9/10/13/14) or lossless arithmetic (SOF11/15). A
    differential frame (SOF5-7, SOF13-15) follows a DHP marker unless
    ``dhp`` is False."""
    lossless = marker in (0xC3, 0xC7, 0xCB, 0xCF)
    arith = marker >= 0xC9
    dc_only = marker in (0xC2, 0xC6, 0xCA, 0xCE)  # a progressive frame's first scan: DC alone
    differential = marker in (0xC5, 0xC6, 0xC7, 0xCD, 0xCE, 0xCF)
    n = h * w if lossless else -(-h // 8) * -(-w // 8)
    head = [sof(marker, h, w, [(1, 1, 1)])]
    if not lossless:
        head.insert(0, segment(0xDB, b"\0" + b"\x01" * 64))
    if arith:
        enc, dc, ac = _QMEncoder(), [[0] for _ in range(64)], [[0] for _ in range(256)]
        for _ in range(n):
            enc.encode(dc[0], 0)  # DC (or lossless) difference 0 in its context
            if not (lossless or dc_only):
                enc.encode(ac[0], 1)  # end of block at k = 1
        data = enc.finish()
    else:
        head.insert(0, dht(0, symbols=17 if lossless else 16) + (b"" if lossless else dht(0, ac=True)))
        # category 0 is code 00000; end of block (0x00) is code 00000 too
        data = pack_bits(np.zeros(n, np.int64), np.full(n, 5 if lossless or dc_only else 10))
    scan = sos([1], 1 if lossless else 0, 0 if lossless or dc_only else 63)
    body = b"".join(head) + scan + data
    if differential and dhp:  # a hierarchical stream: DHP, then the frame
        return SOI + segment(0xDE, struct.pack(">BHHB", 8, h, w, 1) + b"\x01\x11\x00") + body + EOI
    return SOI + body + EOI
