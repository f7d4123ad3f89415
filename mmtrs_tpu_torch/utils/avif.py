"""AVIF as Pillow 12.1 opens it (libavif 1.3.0 with dav1d 1.5.1, libyuv
1909), with the port's own code: the ISOBMFF container that libavif reads,
the AV1 intra frames through ``csrc/host/av1.cpp``, and the YUV → RGB
conversion that Pillow's ``avifImageYUVToRGB`` call gives.

The container (libavif's ``avifParse``): ``ftyp`` with an ``avif`` or
``avis`` brand; ``meta`` with a ``pict`` handler, ``pitm``, ``iloc``
(versions 0-2, construction methods 0 and 1), ``iinf``/``infe`` (v2/v3),
``iprp`` (``ispe``, ``pixi``, ``av1C``, ``colr`` nclx and ICC, ``irot``,
``imir``, ``clap``, ``auxC``; each property's version and reserved bits
checked as libavif parses it, used or not; an item with an unknown
essential property skipped), ``iref`` (``dimg`` of a ``grid`` item,
``auxl`` of an alpha item, ``prem``), ``idat``; ``moov`` with its tracks
(``tkhd``, ``edts``/``elst``, ``tref`` auxl and prem, ``mdia`` with
``mdhd``, ``hdlr`` and ``minf``/``stbl``: ``stsd`` with an ``av01``
sample entry and its boxes, ``stco``/``co64``, ``stsc``, ``stsz``,
``stss``, ``stts``), each read up to the boxes the brands need, as
libavif stops. avifDecoderReset's automatic source: the major brand
``avis``, or another than ``avif`` with tracks, decodes the first sample
of the first AV1 colour track (and of its alpha track), its colour from
the sample entry's ``colr``; else the primary item (a coded image or a
grid). libavif's checks (``ispe`` required of every image item, a grid's
tiles alike and covering its output; Pillow turns libavif's strict checks
off) and size limits, and Pillow's bomb check on the image's size.
``irot``, ``imir`` and ``clap`` leave the pixels as they are: Pillow
reports the orientation in ``info["exif"]`` and never crops. A frame of
another size than its ``ispe`` (or ``tkhd``) is scaled to it as
avifImageScale scales it (libyuv's ScalePlane, kFilterBox). An alpha item
or track is decoded (Pillow opens such a file as RGBA and fails where it
cannot decode it) and dropped by ``convert("RGB")``, after the colour is
unpremultiplied where a ``prem`` reference says the colour was
premultiplied (libyuv's ARGBUnattenuate, as libavif has it run for
Pillow's RGBA).

The colour conversion (probed on every (Y, U, V) triple and on impulse
planes against libavif itself, ``tests/test_torch_codec_avif.py`` and
``tests/test_torch_codec_avif3.py``): libyuv's 6-bit fixed point
(``YuvPixel``) with its constants for BT.601 and BT.709 at full and limited
range and BT.2020 at both (and chroma-derived NCL of those primaries),
libyuv's bilinear chroma upsampling for 4:2:0 (``ScaleRowUp2_Bilinear``)
and linear for 4:2:2, the identity matrix as GBR, and 4:0:0 as gray;
libavif's own f32 path (its 9/16, 3/16, 1/16 chroma weights) for FCC,
SMPTE 240M, YCgCo, chroma-derived NCL of other primaries, matrix 15 and
the identity at limited range; all in torch ops on the device the planes go
to (the card's route converts on the card; the f32 path multiplies and adds
in separate ops, as the wheel's baseline x86-64 build does without FMA).
Matrices libavif refuses stay refused with its words.
"""

from __future__ import annotations

import ctypes
import struct
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from mmtrs_tpu_torch import _build
from mmtrs_tpu_torch.ops.color import fdiv

# libavif's default limits (avif.h)
IMAGE_SIZE_LIMIT = 16384 * 16384
IMAGE_DIMENSION_LIMIT = 32768

ALPHA_URNS = (b"urn:mpeg:mpegB:cicp:systems:auxiliary:alpha", b"urn:mpeg:hevc:2015:auxid:1")

# libyuv's YuvConstants (row_common.cc): (UB, VR, UG, VG, YG, YB) by
# (matrix coefficients, full range)
_LIBYUV = {
    (6, 1): (113, 90, 22, 46, 16320, 32),  # JPEG: BT.601 full range
    (6, 0): (128, 102, 25, 52, 18997, -1160),  # I601
    (1, 1): (119, 101, 12, 30, 16320, 32),  # F709
    (1, 0): (128, 115, 14, 34, 18997, -1160),  # H709
    (9, 1): (120, 94, 11, 37, 16320, 32),  # V2020
    (9, 0): (128, 107, 12, 42, 19003, -1160),  # 2020
}
# libavif's matrix for libyuv: BT.470BG and unspecified go as BT.601
_MATRIX_AS = {5: 6, 2: 6, 6: 6, 1: 1, 9: 9}
# libavif's matrix for libyuv of chroma-derived NCL, by colour primaries
_PRIMARIES_AS = {1: 1, 2: 1, 5: 6, 6: 6, 9: 9}
# 4:0:0 through libyuv's I400 rows: Y alone at full range; at limited
# range libyuv's Y scale and bias for it
_GRAY_LIMITED = (19003, -1160)


def _fail(msg: str) -> SyntaxError:
    return SyntaxError(f"AVIF: {msg} (libavif refuses it)")


# ---------------------------------------------------------------------------
# The container
# ---------------------------------------------------------------------------


def _box_at(d: bytes, at: int, end: int, top: bool = False) -> tuple[bytes, int, int]:
    """The box at ``at`` as avifROStreamReadBoxHeader reads it: (type, body
    start, box end). A box of size 0 runs to the end of the file at the top
    level (``top``) and fails inside another; at the top level an mdat box
    whose size runs past the end is cut there, as libavif reads the items'
    data wherever iloc says."""
    if end - at < 8:
        raise _fail("a box header cut short")
    n, t = struct.unpack_from(">I4s", d, at)
    hdr = 8
    if n == 1:
        if end - at < 16:
            raise _fail("a box header cut short")
        n = struct.unpack_from(">Q", d, at + 8)[0]
        hdr = 16
    elif n == 0:
        if not top:
            raise _fail(f"a {t!r} box of size 0 inside another")
        n = end - at
    if t == b"uuid":
        hdr += 16
    if top and t == b"mdat" and n >= hdr and at + n > end:
        n = end - at
    if n < hdr or at + n > end:
        raise _fail(f"a {t!r} box of a bad size")
    return t, at + hdr, at + n


def _boxes(d: bytes, at: int, end: int, top: bool = False) -> list[tuple[bytes, int, int]]:
    """(type, body start, box end) of each box in d[at:end]; at the file's
    ``top`` level up to the boxes the brands need, as avifParse stops."""
    out = []
    while at < end:
        if top and out and out[0][0] == b"ftyp":
            brands = _brands(d, out[0][1], out[0][2])
            seen = {t for t, _, _ in out}
            if (b"avif" not in brands or b"meta" in seen) and (b"avis" not in brands or b"moov" in seen):
                break
        out.append(_box_at(d, at, end, top))
        at = out[-1][2]
    return out


class _Reader:
    def __init__(self, d: bytes, at: int, end: int):
        self.d, self.at, self.end = d, at, end

    def take(self, n: int) -> bytes:
        if self.at + n > self.end:
            raise _fail("a box's fields run past its end")
        b = self.d[self.at:self.at + n]
        self.at += n
        return b

    def u(self, n: int) -> int:
        return int.from_bytes(self.take(n), "big") if n else 0


class _Item:
    def __init__(self, iid: int):
        self.id = iid
        self.type = b""
        self.extents: list[tuple[int, int]] = []
        self.construction = 0
        self.base = 0
        self.props: dict[bytes, tuple[int, int]] = {}
        self.colr: list[tuple[int, int]] = []
        self.unsupported = False  # an essential property libavif does not know: the item is skipped


def _handler(d: bytes, b0: int, b1: int) -> bytes:
    """avifParseHandlerBox: version 0, pre_defined 0, a terminated name; the
    handler type."""
    r = _Reader(d, b0, b1)
    if r.u(1) != 0:
        raise _fail("an hdlr box of another version than 0")
    r.take(3)
    if r.u(4) != 0:
        raise _fail("an hdlr box whose pre_defined is not 0")
    handler = r.take(4)
    r.take(12)
    if d.find(b"\0", r.at, b1) < 0:
        raise _fail("an hdlr box without its name")
    return handler


def _brands(d: bytes, body: int, end: int) -> list[bytes]:
    return [d[body:body + 4]] + [d[k:k + 4] for k in range(body + 8, end - 3, 4)]


def _ftyp_ok(d: bytes, body: int, end: int) -> bool:
    brands = _brands(d, body, end)
    return b"avif" in brands or b"avis" in brands


class Container:
    """The items and properties of an AVIF's ``meta`` box, checked as
    libavif's parser checks them."""

    def __init__(self, d: bytes):
        self.d = d
        top = _boxes(d, 0, len(d), top=True)
        if not top or top[0][0] != b"ftyp" or top[0][2] - top[0][1] < 8:
            raise _fail("no ftyp box first")
        if not _ftyp_ok(d, top[0][1], top[0][2]):
            raise _fail("an ftyp box without the avif or avis brand")
        self.major = d[top[0][1]:top[0][1] + 4]
        metas = [b for b in top if b[0] == b"meta"]
        moovs = [b for b in top if b[0] == b"moov"]
        if len(metas) > 1 or len(moovs) > 1:
            raise _fail(f"more than one {'meta' if len(metas) > 1 else 'moov'} box")
        self.items: dict[int, _Item] = {}
        self.props: list[tuple[bytes, int, int]] = []
        self.refs: list[tuple[bytes, int, list[int]]] = []
        self.idat = b""
        self.primary = None
        self.tracks: list[_Track] = [] if not moovs else _parse_moov(d, moovs[0][1], moovs[0][2])
        brands = _brands(d, top[0][1], top[0][2])
        if b"avis" in brands and not moovs:
            raise _fail("an avis brand without its moov box")
        if b"avif" in brands and not metas:
            raise _fail("an avif brand without its meta box")
        if metas:
            self._meta(*metas[0][1:])

    def _meta(self, body: int, end: int) -> None:
        d = self.d
        handler = None
        if end - body < 4 or d[body] != 0:
            raise _fail("a meta box of another version than 0")
        for t, b0, b1 in _boxes(d, body + 4, end):
            if t == b"hdlr":  # the meta box's handler is 'pict'
                handler = _handler(d, b0, b1)
            elif t == b"pitm":
                r = _Reader(d, b0, b1)
                ver = r.u(1)
                r.take(3)
                self.primary = r.u(2 if ver == 0 else 4)
            elif t == b"iloc":
                self._iloc(b0, b1)
            elif t == b"iinf":
                self._iinf(b0, b1)
            elif t == b"iprp":
                self._iprp(b0, b1)
            elif t == b"iref":
                self._iref(b0, b1)
            elif t == b"idat":
                self.idat = d[b0:b1]
        if handler != b"pict":
            raise _fail("a meta box without the pict handler")

    def _iloc(self, b0: int, b1: int) -> None:
        r = _Reader(self.d, b0, b1)
        ver = r.u(1)
        r.take(3)
        if ver > 2:
            raise _fail(f"an iloc box of version {ver}")
        a, b = r.u(1), r.u(1)
        osz, lsz, bsz, isz = a >> 4, a & 15, b >> 4, b & 15
        if any(s not in (0, 4, 8) for s in (osz, lsz, bsz)) or (ver and isz not in (0, 4, 8)):
            raise _fail("an iloc box of bad field sizes")
        count = r.u(2 if ver < 2 else 4)
        for _ in range(count):
            iid = r.u(2 if ver < 2 else 4)
            item = self.items.setdefault(iid, _Item(iid))
            if item.extents:
                raise _fail(f"item {iid} located twice")
            if ver in (1, 2):
                word = r.u(2)  # 12 reserved bits, then the construction method
                if word >> 4:
                    raise _fail("an iloc entry whose reserved bits are set")
                item.construction = word & 15
                if item.construction > 1:
                    raise _fail("an item built from another item (iloc construction method 2)")
            r.u(2)  # data_reference_index, which libavif does not read
            item.base = r.u(bsz)
            n = r.u(2)
            for _ in range(n):
                if ver in (1, 2) and isz:
                    r.u(isz)
                item.extents.append((r.u(osz), r.u(lsz)))

    def _iinf(self, b0: int, b1: int) -> None:
        r = _Reader(self.d, b0, b1)
        ver = r.u(1)
        r.take(3)
        if ver > 1:
            raise _fail(f"an iinf box of version {ver}")
        count = r.u(2 if ver == 0 else 4)
        kids = _boxes(self.d, r.at, b1)
        if count != len(kids):  # libavif reads entry_count boxes, and the box ends with them
            raise _fail("an iinf box whose entry count is not its boxes'")
        for t, c0, c1 in kids:
            if t != b"infe":
                raise _fail(f"an iinf box holding a {t!r} box")
            e = _Reader(self.d, c0, c1)
            ev = e.u(1)
            e.u(3)
            if ev not in (2, 3):  # avifParseItemInfoEntry needs item_type
                raise _fail(f"an infe box of version {ev}")
            iid = e.u(2 if ev == 2 else 4)
            e.u(2)  # item_protection_index, which libavif does not check
            item = self.items.setdefault(iid, _Item(iid))
            item.type = e.take(4)
            if self.d.find(b"\0", e.at, c1) < 0:  # item_name, a terminated string
                raise _fail("an infe box whose item name is not terminated")

    def _iprp(self, b0: int, b1: int) -> None:
        for t, c0, c1 in _boxes(self.d, b0, b1):
            if t == b"ipco":
                self.props = _boxes(self.d, c0, c1)
                for t2, p0, p1 in self.props:
                    _check_property(self.d, t2, p0, p1)
            elif t == b"ipma":
                r = _Reader(self.d, c0, c1)
                ver = r.u(1)
                flags = r.u(3)
                for _ in range(r.u(4)):
                    iid = r.u(2 if ver < 1 else 4)
                    item = self.items.setdefault(iid, _Item(iid))
                    for _ in range(r.u(1)):
                        v = r.u(2 if flags & 1 else 1)
                        idx = v & (0x7FFF if flags & 1 else 0x7F)
                        if idx == 0:
                            continue
                        if idx > len(self.props):
                            raise _fail("an item property index past the ipco box")
                        t2, p0, p1 = self.props[idx - 1]
                        if v >> (15 if flags & 1 else 7) and t2 not in _KNOWN_PROPERTIES:
                            item.unsupported = True
                        if t2 == b"colr":
                            item.colr.append((p0, p1))
                        elif t2 in item.props and item.props[t2] != (p0, p1):  # the same box twice is one
                            raise _fail(f"an item with two {t2!r} properties")
                        else:
                            item.props[t2] = (p0, p1)

    def _iref(self, b0: int, b1: int) -> None:
        r = _Reader(self.d, b0, b1)
        ver = r.u(1)
        r.take(3)
        w = 2 if ver == 0 else 4
        if ver > 1:  # avifParseItemReferenceBox skips the references of another version, after one box header
            if r.at < b1:
                _box_at(self.d, r.at, b1)
            return
        for t, c0, c1 in _boxes(self.d, r.at, b1):
            e = _Reader(self.d, c0, c1)
            src = e.u(w)
            self.refs.append((t, src, [e.u(w) for _ in range(e.u(2))]))

    def data(self, item: _Item) -> bytes:
        src = self.idat if item.construction == 1 else self.d
        out = bytearray()
        for off, n in item.extents:
            at = item.base + off
            if n == 0:  # to the end of the file
                n = len(src) - at
            if at + n > len(src) or n < 0:
                raise SyntaxError("AVIF: an item's data past the end of the file (libavif: truncated data)")
            out += src[at:at + n]
        return bytes(out)

    def prop(self, item: _Item, t: bytes) -> bytes | None:
        p = item.props.get(t)
        return None if p is None else self.d[p[0]:p[1]]

    def sample_item(self, track: "_Track") -> _Item:
        """A track's first sample as an item (its one extent in the file),
        with its sample entry's properties; every sample checked as libavif
        checks them."""
        samples = _samples(track, len(self.d))
        if any(size == 0 for _, size in samples):
            raise _fail("a sample of no data")
        fmt, props, colr = next(e for e in track.stbl["entries"] if e[0] == b"av01")
        item = _Item(track.id)
        item.type, item.extents, item.props, item.colr = b"av01", [samples[0]], props, colr
        return item


# the properties libavif parses (avifParseItemPropertyContainerBox); an
# essential one of another type makes libavif skip its item
_KNOWN_PROPERTIES = {b"ispe", b"auxC", b"colr", b"av1C", b"pasp", b"clap", b"irot", b"imir", b"pixi", b"a1op",
                     b"lsel", b"a1lx", b"clli"}


def _check_property(d: bytes, t: bytes, p0: int, p1: int) -> None:
    """libavif's checks of a property as it parses the ipco box, used or
    not: versions and reserved bits."""
    b = d[p0:p1]
    if t == b"av1C" and (len(b) < 4 or b[0] != 0x81):
        raise _fail("an av1C property whose marker or version is not 1")
    if t in (b"pixi", b"ispe") and (len(b) < 4 or b[0] != 0):
        raise _fail(f"a {t.decode()} property of another version than 0")
    if t == b"pixi" and (len(b) < 5 or len(b) < 5 + b[4]):
        raise _fail("a pixi property cut short")
    if (t == b"irot" and (not b or b[0] & 0xFC)) or (t == b"imir" and (not b or b[0] & 0xFE)):
        raise _fail(f"an {t.decode()} property with reserved bits set")
    if t == b"colr" and b[:4] == b"nclx" and (len(b) < 11 or b[10] & 0x7F):
        raise _fail("an nclx colour property with reserved bits set")
    if t == b"auxi" and (len(b) < 4 or b[0] != 0 or b.find(b"\0", 4) < 0):  # a track's aux_track_type
        raise _fail("an auxi box of another version than 0 or without its terminated type")


# ---------------------------------------------------------------------------
# The tracks of an image sequence (libavif's avifParseMovieBox and the
# boxes under it)
# ---------------------------------------------------------------------------

VISUAL_SAMPLE_ENTRY_SIZE = 78  # the VisualSampleEntry fields before an av01 entry's boxes
IMAGE_COUNT_LIMIT = 3600 * 720  # libavif's default imageCountLimit


class _Track:
    def __init__(self):
        self.id = self.width = self.height = 0
        self.aux_for = self.prem_by = 0  # tref's auxl and prem
        self.has_tkhd = False
        self.timescale = 0  # mdhd's; Pillow divides by it
        self.stbl: dict | None = None  # chunks, stsc, sizes, all_size, entries: [(format, props, colr)]


def _full(d: bytes, b0: int, b1: int, versions=(0,)) -> tuple[_Reader, int, int]:
    r = _Reader(d, b0, b1)
    ver, flags = r.u(1), r.u(3)
    if ver not in versions:
        raise _fail(f"a box of version {ver}")
    return r, ver, flags


def _parse_moov(d: bytes, b0: int, b1: int) -> list[_Track]:
    tracks = []
    for t, c0, c1 in _boxes(d, b0, b1):
        if t == b"trak":
            tracks.append(_parse_trak(d, c0, c1))
    if not tracks:
        raise _fail("a moov box without a trak box")
    return tracks


def _unique(seen: set, t: bytes) -> None:
    if t in seen:
        raise _fail(f"two {t.decode(errors='replace')} boxes in one parent")
    seen.add(t)


def _parse_trak(d: bytes, b0: int, b1: int) -> _Track:
    track, seen = _Track(), set()
    repeating, duration, segment = False, 0, 0
    for t, c0, c1 in _boxes(d, b0, b1):
        if t == b"tkhd":
            _unique(seen, t)
            r, ver, _ = _full(d, c0, c1, (0, 1))
            if ver == 1:
                r.u(16)
                track_id = r.u(4)
                r.u(4)
                duration = r.u(8)
            else:
                r.u(8)
                track_id = r.u(4)
                r.u(4)
                duration = r.u(4)
                duration = (1 << 64) - 1 if duration == 0xFFFFFFFF else duration
            r.take(52)
            track.width, track.height = r.u(4) >> 16, r.u(4) >> 16
            if track.width == 0 or track.height == 0 or track.width > IMAGE_DIMENSION_LIMIT or \
                    track.height > IMAGE_DIMENSION_LIMIT or track.width * track.height > IMAGE_SIZE_LIMIT:
                raise _fail(f"a track of {track.width}x{track.height}")
            track.id, track.has_tkhd = track_id, True
        elif t == b"mdia":
            _parse_mdia(d, c0, c1, track)
        elif t == b"tref":
            for k, e0, e1 in _boxes(d, c0, c1):
                if k in (b"auxl", b"prem"):
                    if e1 - e0 < 4:
                        raise _fail(f"a {k.decode()} reference cut short")
                    setattr(track, "aux_for" if k == b"auxl" else "prem_by", struct.unpack_from(">I", d, e0)[0])
        elif t == b"edts":
            _unique(seen, t)
            elst = [(e0, e1) for k, e0, e1 in _boxes(d, c0, c1) if k == b"elst"]
            if len(elst) != 1:
                raise _fail("an edts box without exactly one elst box")
            r = _Reader(d, *elst[0])
            ver, flags = r.u(1), r.u(3)
            if flags & 1:
                repeating = True
                if r.u(4) != 1:
                    raise _fail("an elst box of another entry count than 1")
                if ver > 1:
                    raise _fail(f"an elst box of version {ver}")
                segment = r.u(8 if ver == 1 else 4)
                if segment == 0:
                    raise _fail("an elst box of segment duration 0")
    if not track.has_tkhd:
        raise _fail("a trak box without its tkhd box")
    if repeating and duration == 0:
        raise _fail("a repeating track of duration 0")
    return track


def _parse_mdia(d: bytes, b0: int, b1: int, track: _Track) -> None:
    seen = set()
    for t, c0, c1 in _boxes(d, b0, b1):
        if t == b"mdhd":
            _unique(seen, t)
            r, ver, _ = _full(d, c0, c1, (0, 1))
            r.take(16 if ver == 1 else 8)
            track.timescale = r.u(4)
            r.take(8 if ver == 1 else 4)
        elif t == b"hdlr":  # checked as the meta box's, whatever its handler
            _unique(seen, t)
            _handler(d, c0, c1)
        elif t == b"minf":
            _unique(seen, t)
            stbls = [(e0, e1) for k, e0, e1 in _boxes(d, c0, c1) if k == b"stbl"]
            for e0, e1 in stbls:
                if track.stbl is not None:
                    raise _fail("a track with two sample tables")
                track.stbl = _parse_stbl(d, e0, e1)
            if not stbls:
                raise _fail("a minf box without its stbl box")


def _parse_stbl(d: bytes, b0: int, b1: int) -> dict:
    st = {"chunks": [], "stsc": [], "sizes": [], "all_size": 0, "entries": []}
    for t, c0, c1 in _boxes(d, b0, b1):
        if t in (b"stco", b"co64"):
            r, _, _ = _full(d, c0, c1)
            w = 8 if t == b"co64" else 4
            st["chunks"] += [r.u(w) for _ in range(r.u(4))]
        elif t == b"stsc":
            r, _, _ = _full(d, c0, c1)
            for i in range(r.u(4)):
                first, per, _ = r.u(4), r.u(4), r.u(4)
                if (i == 0 and first != 1) or (i and first <= st["stsc"][-1][0]):
                    raise _fail("an stsc box whose first chunks do not start at 1 and increase")
                st["stsc"].append((first, per))
        elif t == b"stsz":
            r, _, _ = _full(d, c0, c1)
            size, count = r.u(4), r.u(4)
            if size:
                st["all_size"] = size
            else:
                st["sizes"] += [r.u(4) for _ in range(count)]
        elif t in (b"stss", b"stts"):  # read as libavif reads them, unused here
            r, _, _ = _full(d, c0, c1)
            r.take(r.u(4) * (4 if t == b"stss" else 8))
        elif t == b"stsd":  # versions 0 and 1 (ISO 14496-12's sample descriptions)
            r, _, _ = _full(d, c0, c1, (0, 1))
            for _ in range(r.u(4)):
                fmt, e0, e1 = _box_at(d, r.at, r.end)
                props: dict[bytes, tuple[int, int]] = {}
                colr: list[tuple[int, int]] = []
                # libavif reads the av01 entry's boxes to the end of the stsd box
                if fmt == b"av01" and r.end - e0 > VISUAL_SAMPLE_ENTRY_SIZE:
                    for k, p0, p1 in _boxes(d, e0 + VISUAL_SAMPLE_ENTRY_SIZE, r.end):
                        _check_property(d, k, p0, p1)
                        if k == b"colr":
                            colr.append((p0, p1))
                        else:
                            props.setdefault(k, (p0, p1))
                st["entries"].append((fmt, props, colr))
                r.at = e1
    return st


def _samples(track: _Track, file_size: int) -> list[tuple[int, int]]:
    """avifCodecDecodeInputFillFromSampleTable: each sample's (offset, size)
    from the chunks, samples per chunk and sizes, within the file."""
    st = track.stbl
    counts = []
    for k in range(len(st["chunks"])):
        per = next((n for first, n in reversed(st["stsc"]) if first <= k + 1), 0)
        if per == 0:
            raise _fail("a sample table with a chunk of no samples")
        counts.append(per)
    if sum(counts) > IMAGE_COUNT_LIMIT:
        raise _fail("a track past the image count limit")
    out, at = [], 0
    for offset, per in zip(st["chunks"], counts):
        for _ in range(per):
            size = st["all_size"]
            if not size:
                if at >= len(st["sizes"]):
                    raise _fail("a sample table cut short")
                size = st["sizes"][at]
            if offset + size > file_size:
                raise _fail("a sample past the end of the file")
            out.append((offset, size))
            offset += size
            at += 1
    return out


def _ispe(c: Container, item: _Item) -> tuple[int, int]:
    p = c.prop(item, b"ispe")
    if p is None or len(p) < 12:
        raise _fail(f"item {item.id} without an ispe property")
    if p[0] != 0:
        raise _fail("an ispe property of another version than 0")
    return struct.unpack_from(">II", p, 4)


def _check_size(w: int, h: int) -> None:
    if w == 0 or h == 0 or w > IMAGE_DIMENSION_LIMIT or h > IMAGE_DIMENSION_LIMIT or w * h > IMAGE_SIZE_LIMIT:
        raise _fail(f"an image of {w}x{h}, past its size limits")


class Avif:
    """An AVIF's primary image as libavif sets it up: its item (a coded
    image or a grid of them), size, alpha and colour properties."""

    def __init__(self, d: bytes):
        c = self.c = Container(d)
        thumbs = {src for kind, src, _ in c.refs if kind == b"thmb"}
        for item in c.items.values():  # avifDecoderParse: every image item it does not skip has its ispe
            if item.type in (b"av01", b"grid") and item.extents and not item.unsupported and item.id not in thumbs:
                _check_size(*_ispe(c, item))
        # avifDecoderReset's AVIF_DECODER_SOURCE_AUTO: the major brand
        # decides, else the tracks where there are any
        if c.major == b"avis" or (c.major != b"avif" and c.tracks):
            self._from_tracks()
            return
        if c.primary is None or c.primary not in c.items:
            raise _fail("no primary item")
        prim = c.items[c.primary]
        if prim.type not in (b"av01", b"grid") or prim.unsupported:
            raise _fail(f"a primary item of type {prim.type!r}" + (" with an unknown essential property"
                                                                     if prim.unsupported else ""))
        self.width, self.height = _ispe(c, prim)
        _check_size(self.width, self.height)
        self.tiles, self.rows, self.cols, self.tile_w, self.tile_h = _layout(c, prim, self.width, self.height)
        for item in self.tiles + ([] if prim.type != b"grid" else [prim]):
            for off, n in item.extents:  # libavif's parse: each extent inside the file (or idat)
                src = len(c.idat) if item.construction == 1 else len(c.d)
                if item.base + off + n > src:
                    raise _fail(f"item {item.id}'s data past the end of the file")
        for item in self.tiles:
            _validate_av1(c, item)
        self.nclx = _nclx(c, prim)  # else the AV1 sequence header's
        alphas = [src for kind, src, dst in c.refs if kind == b"auxl" and prim.id in dst]
        self.alpha = None
        for a in alphas:
            item = c.items.get(a)
            if item is None or not item.extents or item.unsupported or item.type not in (b"av01", b"grid"):
                continue  # avifDecoderItemShouldBeSkipped
            aux = c.prop(item, b"auxC")
            if aux is not None and aux[4:].split(b"\0")[0] in ALPHA_URNS:
                self.alpha = item
                break
        self.alpha_layout = None
        if self.alpha is not None:
            aw, ah = _ispe(c, self.alpha)
            self.alpha_layout = (*_layout(c, self.alpha, aw, ah), aw, ah)
            for item in self.alpha_layout[0]:
                _validate_av1(c, item)
        # the last prem reference of the colour item names its alpha
        prem = [dst[-1] for kind, src, dst in c.refs if kind == b"prem" and src == prim.id and dst]
        self.premultiplied = self.alpha is not None and bool(prem) and prem[-1] == self.alpha.id

    def _from_tracks(self) -> None:
        """The first sample of the first AV1 track that is no auxiliary
        track, and of its alpha track (auxl), as avifDecoderReset takes an
        image sequence's tracks."""
        c = self.c

        def usable(t: _Track) -> bool:
            return t.stbl is not None and t.id != 0 and bool(t.stbl["chunks"]) and \
                any(e[0] == b"av01" for e in t.stbl["entries"])

        colour = next((t for t in c.tracks if usable(t) and t.aux_for == 0), None)
        if colour is None:
            raise _fail("no AV1 colour track")
        alpha = next((t for t in c.tracks if usable(t) and t.aux_for == colour.id), None)
        prim = c.sample_item(colour)
        self.alpha = None if alpha is None else c.sample_item(alpha)
        if c.prop(prim, b"av1C") is None:
            raise _fail("an av1 sample entry without its av1C box")
        if colour.timescale == 0:
            raise ValueError("AVIF: an image sequence of timescale 0 (Pillow divides by it)")
        for item in c.items.values():  # libavif's decode of a sequence fails on an item's pixi too (Not implemented)
            av1c = c.prop(item, b"av1C")
            if item.type == b"av01" and av1c and len(av1c) >= 4 and _pixi_differs(av1c, c.prop(item, b"pixi")):
                raise ValueError("AVIF: an item whose pixi depths are not its av1C depth (Pillow: Failed to "
                                 "decode image: Not implemented)")
        self.width, self.height = colour.width, colour.height
        self.tiles, self.rows, self.cols = [prim], 1, 1
        self.tile_w, self.tile_h = self.width, self.height
        self.nclx = _nclx(c, prim)
        self.premultiplied = self.alpha is not None and colour.prem_by == alpha.id
        self.alpha_layout = None if alpha is None else ([self.alpha], 1, 1, alpha.width, alpha.height, alpha.width,
                                                        alpha.height)


def _validate_av1(c: Container, item: _Item) -> None:
    """avifDecoderItemValidateProperties of a coded item: its av1C, and a
    pixi whose depths are the av1C's."""
    av1c = c.prop(item, b"av1C")
    if av1c is None or len(av1c) < 4:
        raise _fail(f"item {item.id} without an av1C property")
    if _pixi_differs(av1c, c.prop(item, b"pixi")):
        raise _fail(f"item {item.id} whose pixi depths are not its av1C depth")


def _pixi_differs(av1c: bytes, pixi: bytes | None) -> bool:
    """Whether a pixi names another depth than its item's av1C, libavif's
    check of both (``_check_property`` has held the pixi to its length)."""
    depth = 12 if av1c[2] & 0x20 else (10 if av1c[2] & 0x40 else 8)
    return pixi is not None and any(v != depth for v in pixi[5:5 + pixi[4]])


def _layout(c: Container, item: _Item, width: int, height: int) -> tuple[list[_Item], int, int, int, int]:
    """An image item's coded tiles: itself, or a grid's (tiles, rows,
    columns, tile width and height), checked as libavif checks a grid."""
    if item.type != b"grid":
        return [item], 1, 1, width, height
    refs = [t for kind, src, dst in c.refs if kind == b"dimg" and src == item.id for t in dst]
    g = c.data(item)
    if len(g) < 8 or g[0] != 0:
        raise _fail("a grid item of a bad size or version")
    big = g[1] & 1
    rows, cols = g[2] + 1, g[3] + 1
    fmt = ">II" if big else ">HH"
    if len(g) != 4 + struct.calcsize(fmt):
        raise _fail("a grid item of a bad size")
    out_w, out_h = struct.unpack_from(fmt, g, 4)
    if (out_w, out_h) != (width, height):
        raise _fail("a grid whose output size is not its ispe")
    if len(refs) != rows * cols:
        raise _fail("a grid with another number of tiles than its rows and columns")
    tiles = [c.items.get(t) for t in refs]
    if any(t is None or t.type != b"av01" or t.unsupported for t in tiles):
        raise _fail("a grid tile that is not an AV1 image item")
    sizes = {_ispe(c, t) for t in tiles}
    if len(sizes) != 1:
        raise _fail("grid tiles of different sizes")
    tile_w, tile_h = sizes.pop()
    if not (cols * tile_w >= out_w and (cols - 1) * tile_w < out_w and
            rows * tile_h >= out_h and (rows - 1) * tile_h < out_h):
        raise _fail("a grid whose tiles do not cover its output exactly")
    config = {c.prop(t, b"av1C") for t in tiles}
    if len(config) != 1 or None in config:
        raise _fail("grid tiles of different AV1 configurations")
    return tiles, rows, cols, tile_w, tile_h


def _nclx(c: Container, item: _Item) -> tuple[int, int, int, int] | None:
    """An item's (or sample entry's) nclx colour box: (primaries, transfer,
    matrix, full range), or None."""
    kinds = [c.d[p0:p0 + 4] for p0, _ in item.colr]
    if kinds.count(b"nclx") > 1 or kinds.count(b"rICC") + kinds.count(b"prof") > 1:
        raise _fail("two colour properties of one kind")
    for p0, p1 in item.colr:
        box = c.d[p0:p1]
        if box[:4] == b"nclx" and len(box) >= 11:
            cp, tc, mc = struct.unpack_from(">HHH", box, 4)
            return cp, tc, mc, box[10] >> 7
    return None


# ---------------------------------------------------------------------------
# The AV1 decode and the colour conversion
# ---------------------------------------------------------------------------


def _decode_item(data: bytes) -> tuple[list[np.ndarray], np.ndarray]:
    lib = _build.av1_library()
    out, dims = ctypes.c_void_p(), np.zeros(16, np.int32)
    msg = ctypes.create_string_buffer(256)
    status = lib.mmtrs_av1_decode(data, len(data), IMAGE_SIZE_LIMIT, ctypes.addressof(out), dims.ctypes.data,
                                  ctypes.addressof(msg))
    if status:
        text = msg.value.decode()
        if status == 6:
            raise ValueError(text)
        raise ValueError(f"AVIF: the AV1 image does not decode ({text}; Pillow: Failed to decode image)")
    w, h, sx, sy, n = (int(v) for v in dims[:5])
    cw, ch = (w + sx) >> sx, (h + sy) >> sy
    total = w * h + (2 * cw * ch if n == 3 else 0)
    buf = np.ctypeslib.as_array((ctypes.c_ubyte * max(total, 1)).from_address(out.value))[:total].copy()
    lib.mmtrs_av1_free(out)
    planes = [buf[:w * h].reshape(h, w)]
    if n == 3:
        planes.append(buf[w * h:w * h + cw * ch].reshape(ch, cw))
        planes.append(buf[w * h + cw * ch:].reshape(ch, cw))
    return planes, dims


def _obus(data: bytes) -> list[tuple[int, int, int]]:
    """(type, start, end) of each OBU of an item's data, as far as their
    headers and sizes parse."""
    out, at = [], 0
    while at < len(data):
        head = data[at]
        p = at + 1 + ((head >> 2) & 1)
        size = shift = 0
        if head & 2:  # obu_has_size_field: leb128
            while p < len(data) and shift < 56:
                size |= (data[p] & 127) << shift
                shift += 7
                p += 1
                if not data[p - 1] & 128:
                    break
        else:
            size = len(data) - p
        if p > len(data) or p + size > len(data):
            break
        out.append(((head >> 3) & 15, at, p + size))
        at = p + size
    return out


def _shared_sequence_headers(datas: list[bytes]) -> list[bytes]:
    """libavif decodes a grid's tiles in order on one dav1d decoder, so a
    tile whose data holds no sequence header before its frame decodes with
    the last one an earlier tile held: that one is put before it."""
    out, last = [], None
    for d in datas:
        obus = _obus(d)
        first_frame = next((k for k, (t, _, _) in enumerate(obus) if t in (3, 6)), len(obus))
        if last is not None and not any(t == 1 for t, _, _ in obus[:first_frame]):
            out.append(last + d)
        else:
            out.append(d)
        seqs = [d[s0:s1] for t, s0, s1 in obus if t == 1]
        last = seqs[-1] if seqs else last
    return out


def _scaled(planes: list[np.ndarray], dims: np.ndarray, w: int, h: int) -> tuple[list[np.ndarray], np.ndarray]:
    """A decoded frame at the size its item's ispe (or its track's tkhd)
    gives, as libavif's avifImageScale makes it: each plane through
    libyuv's ScalePlane with kFilterBox (``csrc/host/av1.cpp``)."""
    fw, fh, sx, sy = (int(v) for v in dims[:4])
    if (fw, fh) == (w, h):
        return planes, dims
    lib = _build.av1_library()
    out = []
    for p, plane in enumerate(planes):
        px, py = (sx, sy) if p else (0, 0)
        dw, dh = (w + px) >> px, (h + py) >> py
        src = np.zeros((plane.shape[0] + 1, plane.shape[1]), np.uint8)  # a row past the end for the filters' reads
        src[:-1] = plane
        dst = np.empty((dh, dw), np.uint8)
        if lib.mmtrs_avif_scale_plane(src.ctypes.data, plane.shape[1], plane.shape[0], dst.ctypes.data, dw, dh):
            raise ValueError("AVIF: a frame libavif cannot scale to its ispe, more than 16384 a side (Pillow: "
                             "Failed to decode image)")
        out.append(dst)
    dims = dims.copy()
    dims[0], dims[1] = w, h
    return out, dims


def _up_rows(sa: torch.Tensor, sb: torch.Tensor, w: int) -> tuple[torch.Tensor, torch.Tensor]:
    """libyuv's ScaleRowUp2_Bilinear_Any over chroma rows ``sa`` and ``sb``
    (int32 [..., cw]) → the two rows of width ``w`` between them (the first
    nearer ``sa``); their ends filtered vertically alone."""
    da = sa.new_empty(sa.shape[:-1] + (w,))
    db = sa.new_empty(sa.shape[:-1] + (w,))
    da[..., 0] = (3 * sa[..., 0] + sb[..., 0] + 2) >> 2
    db[..., 0] = (sa[..., 0] + 3 * sb[..., 0] + 2) >> 2
    k = (w - 1) // 2
    if k:
        s0, s1, t0, t1 = sa[..., :k], sa[..., 1:k + 1], sb[..., :k], sb[..., 1:k + 1]
        da[..., 1:2 * k:2] = (s0 * 9 + s1 * 3 + t0 * 3 + t1 + 8) >> 4
        da[..., 2:2 * k + 1:2] = (s0 * 3 + s1 * 9 + t0 + t1 * 3 + 8) >> 4
        db[..., 1:2 * k:2] = (s0 * 3 + s1 + t0 * 9 + t1 * 3 + 8) >> 4
        db[..., 2:2 * k + 1:2] = (s0 + s1 * 3 + t0 * 3 + t1 * 9 + 8) >> 4
    da[..., w - 1] = (3 * sa[..., k] + sb[..., k] + 2) >> 2
    db[..., w - 1] = (sa[..., k] + 3 * sb[..., k] + 2) >> 2
    return da, db


def upsample_420(c: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """A 4:2:0 chroma plane → int32 h × w as libyuv's I420...MatrixFilter
    (kFilterBilinear) rows give it: row 0 from chroma row 0 alone, then
    each pair of rows between two chroma rows, the last row (even heights)
    from the last chroma row alone."""
    c = c.to(torch.int32)
    out = c.new_empty((h, w))
    out[0] = _up_rows(c[0], c[0], w)[0]
    pairs = (h - 1) // 2
    if pairs:
        a, b = _up_rows(c[:pairs], c[1:pairs + 1], w)
        out[1:2 * pairs:2] = a
        out[2:2 * pairs + 1:2] = b
    if h % 2 == 0 and h > 1:
        out[h - 1] = _up_rows(c[pairs], c[pairs], w)[0]
    return out


def upsample_422(c: torch.Tensor, w: int) -> torch.Tensor:
    """A 4:2:2 chroma plane → int32 of width ``w``: libyuv's
    ScaleRowUp2_Linear_Any."""
    c = c.to(torch.int32)
    out = c.new_empty((c.shape[0], w))
    out[:, 0] = c[:, 0]
    k = (w - 1) // 2
    if k:
        out[:, 1:2 * k:2] = (c[:, :k] * 3 + c[:, 1:k + 1] + 2) >> 2
        out[:, 2:2 * k + 1:2] = (c[:, :k] + c[:, 1:k + 1] * 3 + 2) >> 2
    out[:, w - 1] = c[:, (w - 1) // 2]
    return out


# libavif's own conversion (reformat.c, avifImageYUVAnyToRGBAnySlow and its
# 4:4:4 fast path) for the matrices libyuv does not take: Kr and Kb
# (colr.c's table; BT.601's where the matrix has none there), and for
# chroma-derived NCL the primaries (x, y of R, G, B and white) they are
# computed from, BT.709's for primaries libavif does not know
_KR_KB = {1: (0.2126, 0.0722), 4: (0.30, 0.11), 5: (0.299, 0.114), 6: (0.299, 0.144), 7: (0.212, 0.087),
          9: (0.2627, 0.0593)}
_PRIMARIES = {
    1: (0.64, 0.33, 0.30, 0.60, 0.15, 0.06, 0.3127, 0.3290),
    4: (0.67, 0.33, 0.21, 0.71, 0.14, 0.08, 0.310, 0.316),
    5: (0.64, 0.33, 0.29, 0.60, 0.15, 0.06, 0.3127, 0.3290),
    6: (0.630, 0.340, 0.310, 0.595, 0.155, 0.070, 0.3127, 0.3290),
    7: (0.630, 0.340, 0.310, 0.595, 0.155, 0.070, 0.3127, 0.3290),
    8: (0.681, 0.319, 0.243, 0.692, 0.145, 0.049, 0.310, 0.316),
    9: (0.708, 0.292, 0.170, 0.797, 0.131, 0.046, 0.3127, 0.3290),
    10: (1.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.3333, 0.3333),
    11: (0.680, 0.320, 0.265, 0.690, 0.150, 0.060, 0.314, 0.351),
    12: (0.680, 0.320, 0.265, 0.690, 0.150, 0.060, 0.3127, 0.3290),
    22: (0.630, 0.340, 0.295, 0.605, 0.155, 0.077, 0.3127, 0.3290),
}
_F = np.float32


def _kr_kg_kb(matrix: int, primaries: int) -> tuple[np.float32, np.float32, np.float32]:
    """avifCalcYUVCoefficients in f32, each step in libavif's order."""
    if matrix == 12:  # H.273 equations 32-37
        rx, ry, gx, gy, bx, by, wx, wy = (_F(v) for v in _PRIMARIES.get(primaries, _PRIMARIES[1]))
        one = _F(1)
        rz, gz, bz, wz = one - (rx + ry), one - (gx + gy), one - (bx + by), one - (wx + wy)
        den = wy * (rx * (gy * bz - by * gz) + gx * (by * rz - ry * bz) + bx * (ry * gz - gy * rz))
        kr = (ry * (wx * (gy * bz - by * gz) + wy * (bx * gz - gx * bz) + wz * (gx * by - bx * gy))) / den
        kb = (by * (wx * (ry * gz - gy * rz) + wy * (gx * rz - rx * gz) + wz * (rx * gy - gx * ry))) / den
    else:
        kr, kb = (_F(v) for v in _KR_KB.get(matrix, (0.299, 0.114)))
    return kr, _F(1) - kr - kb, kb


def _up_nearest_bilinear(t: torch.Tensor, c: torch.Tensor, h: int, w: int, suby: int) -> torch.Tensor:
    """libavif's slow path upsampling of a subsampled plane, as f32 values
    (``t`` the plane's unorm table, ``c`` its samples): the nearest sample
    9/16, the adjacent column and row 3/16 each, the diagonal 1/16, summed
    in that order; at the first and an odd last column (and row), and for
    4:2:2's rows, the sample itself stands in for its neighbour."""
    dev = c.device
    i, j = torch.arange(w, device=dev), torch.arange(h, device=dev)
    ci, cj = i >> 1, j >> suby
    adj_c = torch.where((i == 0) | ((i == w - 1) & (i % 2 == 1)), 0, torch.where(i % 2 == 1, 1, -1))
    if suby:
        adj_r = torch.where((j == 0) | ((j == h - 1) & (j % 2 == 1)), 0, torch.where(j % 2 == 1, 1, -1))
    else:
        adj_r = torch.zeros_like(j)
    v = t[c.long()]
    rows0, rows1 = cj[:, None], (cj + adj_r)[:, None]
    cols0, cols1 = ci[None, :], (ci + adj_c)[None, :]
    out = v[rows0, cols0] * 0.5625
    out = out + v[rows0, cols1] * 0.1875
    out = out + v[rows1, cols0] * 0.1875
    return out + v[rows1, cols1] * 0.0625


def _libavif_float(planes: list[torch.Tensor], subx: int, suby: int, matrix: int, full: int,
                   primaries: int) -> torch.Tensor:
    """libavif's floating-point YUV → RGB of 8-bit planes: f32 unorm tables
    made on the host as libavif makes them, then separate multiplies and
    adds on the planes' device (no fused op: the wheel is a baseline x86-64
    build) and a true division (``fdiv``: the card divides by a Python
    scalar as a multiply by its reciprocal), each clamped to [0, 1] and
    truncated after + 0.5 as libavif stores a u8."""
    h, w = planes[0].shape
    dev = planes[0].device
    cp = np.arange(256, dtype=np.float32)
    bias_y, range_y = (_F(0), _F(255)) if full else (_F(16), _F(219))
    ty = (cp - bias_y) / range_y
    tuv = ty if matrix == 0 else (cp - _F(128)) / (_F(255) if full else _F(224))
    ty, tuv = torch.from_numpy(ty).to(dev), torch.from_numpy(tuv).to(dev)
    y = ty[planes[0].long()]
    if (subx, suby) == (0, 0):
        cb, cr = tuv[planes[1].long()], tuv[planes[2].long()]
    else:
        cb, cr = (_up_nearest_bilinear(tuv, p, h, w, suby) for p in planes[1:])
    if matrix == 0:  # identity: GBR
        r, g, b = cr, y, cb
    elif matrix == 8:  # YCgCo
        t = y - cb
        r, g, b = t + cr, y + cb, t - cr
    else:
        kr, kg, kb = _kr_kg_kb(matrix, primaries)
        two = _F(2)
        r = y + cr * float(two * (_F(1) - kr))
        b = y + cb * float(two * (_F(1) - kb))
        s = cr * float(kr * (_F(1) - kr))
        s = s + cb * float(kb * (_F(1) - kb))
        g = y - fdiv(s * 2.0, float(kg))  # a true division on the card too
    out = torch.stack([r, g, b], -1).clamp_(0.0, 1.0)
    return ((out * 255.0) + 0.5).to(torch.uint8)


def yuv_to_rgb(planes: list[torch.Tensor], subx: int, suby: int, matrix: int, full: int,
               primaries: int) -> torch.Tensor:
    """8-bit Y, U and V planes (u8 tensors on any device; 4:0:0: Y alone)
    → RGB u8 [H, W, 3] on their device, as Pillow's ``avifImageYUVToRGB``
    call gives them: libyuv's integer ops where libavif routes the matrix
    to libyuv, else libavif's own f32 steps, so the host and the card
    agree."""
    h, w = planes[0].shape
    if matrix in (3, 10, 11, 13, 14) or matrix >= 16 or (matrix == 8 and not full):
        # avifPrepareReformatState refuses these matrices, for gray too
        raise ValueError(f"AVIF of matrix coefficients {matrix} does not convert (nor in Pillow: libavif's "
                         "Reformat failed)")
    if len(planes) == 1:
        if full:
            return planes[0][..., None].expand(h, w, 3).contiguous()
        yg, yb = _GRAY_LIMITED
        g = ((((planes[0].to(torch.int32) * (0x0101 * yg)) >> 16) + yb) >> 6).clamp(0, 255).to(torch.uint8)
        return g[..., None].expand(h, w, 3).contiguous()
    if matrix == 0:
        if (subx, suby) != (0, 0):
            raise ValueError("AVIF with the identity matrix on subsampled chroma does not convert (nor in Pillow: "
                             "libavif's Reformat failed)")
        if full:
            return torch.stack([planes[2], planes[0], planes[1]], -1)
    # chroma-derived NCL goes to libyuv as the matrix of its primaries
    # where libyuv has that matrix
    key = (_MATRIX_AS.get(matrix if matrix != 12 else _PRIMARIES_AS.get(primaries, -1), -1), full)
    if key not in _LIBYUV:
        return _libavif_float(planes, subx, suby, matrix, full, primaries)
    ub, vr, ug, vg, yg, yb = _LIBYUV[key]
    if (subx, suby) == (1, 1):
        u, v = upsample_420(planes[1], h, w), upsample_420(planes[2], h, w)
    elif (subx, suby) == (1, 0):
        u, v = upsample_422(planes[1], w), upsample_422(planes[2], w)
    else:
        u, v = planes[1].to(torch.int32), planes[2].to(torch.int32)
    # int32 is wide enough: (y · 0x0101) · yg < 2^31 for 8-bit y
    y1 = (planes[0].to(torch.int32) * (0x0101 * yg)) >> 16
    r = (y1 + v * vr - (vr * 128 - yb)) >> 6
    g = (y1 + (ug * 128 + vg * 128 + yb) - (u * ug + v * vg)) >> 6
    b = (y1 + u * ub - (ub * 128 - yb)) >> 6
    return torch.stack([r, g, b], -1).clamp_(0, 255).to(torch.uint8)


def _decode_planes(av: Avif) -> tuple[list[np.ndarray], np.ndarray]:
    """The primary image's Y, U and V planes at its output size."""
    return _decode_layout(av.c, (av.tiles, av.rows, av.cols, av.tile_w, av.tile_h, av.width, av.height))


def _decode_layout(c: Container, layout: tuple) -> tuple[list[np.ndarray], np.ndarray]:
    """An image's planes at its output size: one coded item, or a grid's
    tiles (decoded on a few threads) pasted and cropped as libavif pastes
    them; ``layout``: (tiles, rows, columns, tile width and height, width,
    height)."""
    tiles, rows, cols, tile_w, tile_h, width, height = layout
    datas = _shared_sequence_headers([c.data(t) for t in tiles])
    if len(datas) == 1:
        results = [_decode_item(datas[0])]
    else:
        with ThreadPoolExecutor(max_workers=min(8, len(datas))) as pool:
            results = list(pool.map(_decode_item, datas))
    results = [_scaled(planes, dims, tile_w, tile_h) for planes, dims in results]
    dims0 = results[0][1]
    for planes, dims in results:
        if tuple(dims[2:6]) != tuple(dims0[2:6]):
            raise ValueError("AVIF: grid tiles of different pixel formats (Pillow: Failed to decode image)")
    if len(results) == 1:
        return results[0]
    sx, sy, n = int(dims0[2]), int(dims0[3]), int(dims0[4])
    # avifAreGridDimensionsValid (MIAF 7.3.11.4.2): tiles of 64 or more a
    # side, and even widths (4:2:0 and 4:2:2) and heights (4:2:0)
    sub = n == 3 and sx
    if tile_w < 64 or tile_h < 64 or (sub and (width % 2 or tile_w % 2)) or \
            (sub and sy and (height % 2 or tile_h % 2)):
        raise ValueError("AVIF: an invalid image grid (tiles under 64 a side, or odd sizes of subsampled ones; "
                         "Pillow: Invalid image grid)")
    out = []
    for p in range(n):
        px, py = (sx, sy) if p else (0, 0)
        full = np.zeros(((height + py) >> py, (width + px) >> px), np.uint8)
        tw, th = (tile_w + px) >> px, (tile_h + py) >> py
        for k, (planes, _) in enumerate(results):
            r, col = divmod(k, cols)
            y0, x0 = r * th, col * tw
            ph, pw = full[y0:y0 + th, x0:x0 + tw].shape
            full[y0:y0 + ph, x0:x0 + pw] = planes[p][:ph, :pw]
        out.append(full)
    return out, dims0


# libyuv's ARGBUnattenuate as its x86 SIMD rows compute it (pmulhuw of the
# sample times 0x0101 by fixed_invtbl8's 16-bit reciprocal, then packuswb:
# a product of 0x8000 or more saturates to 0), probed on every (value,
# alpha) pair against libavif (tests/test_torch_codec_avif3.py)
_UNATTENUATE = torch.tensor([0, 0xFFFF] + [0x10000 // a for a in range(2, 255)] + [0x100], dtype=torch.int64)


def unpremultiply(rgb: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """RGB u8 [H, W, 3] of premultiplied colour and its alpha u8 [H, W] (on
    one device) → the colour libavif's avifRGBImageUnpremultiplyAlpha gives
    Pillow's RGBA (libyuv's ARGBUnattenuate): integer ops alone."""
    ia = _UNATTENUATE.to(rgb.device)[alpha.long()][..., None]
    x = (rgb.long() * 0x0101 * ia) >> 16
    return torch.where(x >= 0x8000, 0, x.clamp(max=255)).to(torch.uint8)


def decode_avif(av: Avif, device: torch.device | str = "cpu") -> torch.Tensor:
    """The primary image → RGB u8 [H, W, 3] on ``device``, as Pillow's
    ``Image.open(...).convert("RGB")`` gives it: decoded on the host, its
    planes converted where they land."""
    planes, dims = _decode_planes(av)
    if int(dims[5]) != 8:
        raise ValueError(f"AVIF of {int(dims[5])}-bit samples is not decoded by the port's codec")
    alpha = None
    if av.alpha is not None:  # Pillow decodes the alpha plane too, and fails with it
        aplanes, _ = _decode_layout(av.c, av.alpha_layout)
        alpha = aplanes[0]
        if alpha.shape != (av.height, av.width) and (av.rows * av.cols == 1 or av.premultiplied):
            raise ValueError("AVIF: an alpha plane of another size than the image (Pillow: Failed to decode image)")
    if av.nclx is not None:
        primaries, _, matrix, full = av.nclx
    else:
        primaries, matrix, full = int(dims[6]), int(dims[8]), int(dims[9])
    on = [torch.from_numpy(p).to(device) for p in planes]
    rgb = yuv_to_rgb(on, int(dims[2]), int(dims[3]), matrix, full, primaries)
    if av.premultiplied:  # Pillow's RGBA is unpremultiplied; convert("RGB") then drops the alpha
        rgb = unpremultiply(rgb, torch.from_numpy(alpha).to(device))
    return rgb


def planes_of(data: bytes) -> tuple[list[np.ndarray], np.ndarray]:
    """An AVIF's primary image as the port decodes it: its Y, U and V planes
    and the decoder's dims (size, sampling, depth, CICP, range, the tools
    mask's low and high words: ``tools_of``)."""
    return _decode_planes(Avif(data))


def tools_of(dims: np.ndarray) -> int:
    """The 64-bit mask of the AV1 tools a decode used (``csrc/host/av1.cpp``'s
    TOOL_* bits), from its dims[10] (low word) and dims[11] (high word)."""
    return (int(dims[10]) & 0xFFFFFFFF) | (int(dims[11]) & 0xFFFFFFFF) << 32
