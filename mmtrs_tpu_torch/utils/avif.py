"""AVIF still pictures as Pillow 12.1 opens them (libavif 1.3.0 with dav1d
1.5.1, libyuv 1909), with the port's own code: the ISOBMFF container that
libavif reads for a still image, the AV1 intra frames through
``csrc/host/av1.cpp``, and the YUV → RGB conversion that Pillow's
``avifImageYUVToRGB`` call gives, as libavif routes it through libyuv.

The container (libavif's ``avifParse``): ``ftyp`` with an ``avif`` or
``avis`` brand; ``meta`` with a ``pict`` handler, ``pitm``, ``iloc``
(versions 0-2, construction methods 0 and 1), ``iinf``/``infe`` (v2/v3),
``iprp`` (``ispe``, ``pixi``, ``av1C``, ``colr`` nclx and ICC, ``irot``,
``imir``, ``clap``, ``auxC``; each property's version and reserved bits
checked as libavif parses it, used or not; an item with an unknown
essential property skipped), ``iref`` (``dimg`` of a ``grid`` item,
``auxl`` of an alpha item, ``prem``), ``idat``, read up to the boxes the
brands need (``meta``; ``moov`` for ``avis``), as libavif stops; its checks
(``ispe`` required of every image item, a grid's tiles alike and covering its output; Pillow
turns libavif's strict checks off) and size limits, and Pillow's bomb check on the primary item's
size. ``irot``, ``imir`` and ``clap`` leave the pixels as they are: Pillow
reports the orientation in ``info["exif"]`` and never crops. An alpha item
is decoded (Pillow opens such a file as RGBA and fails where it cannot
decode it) and dropped by ``convert("RGB")``; a premultiplied one would
change the colour and is refused by name.

The colour conversion (probed on every (Y, U, V) triple and on impulse
planes against libavif itself, ``tests/test_torch_codec_avif.py``):
libyuv's 6-bit fixed point (``YuvPixel``) with its constants for BT.601 and
BT.709 at full and limited range and BT.2020 at full range, libyuv's
bilinear chroma upsampling for 4:2:0 (``ScaleRowUp2_Bilinear``) and linear
for 4:2:2, the identity matrix as GBR, and 4:0:0 as gray, in torch integer
ops on the device the planes go to (the card's route converts on the
card). libavif's own (floating-point) paths for the other matrices are
refused by name.
"""

from __future__ import annotations

import ctypes
import struct
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from mmtrs_tpu_torch import _build

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
    (9, 1): (120, 94, 11, 37, 16320, 32),  # U2020
}
# libavif's matrix for libyuv: BT.470BG and unspecified go as BT.601
_MATRIX_AS = {5: 6, 2: 6, 6: 6, 1: 1, 9: 9}
# 4:0:0 through libyuv's I400 rows: Y alone at full range; at limited
# range libyuv's Y scale and bias for it
_GRAY_LIMITED = (19003, -1160)


def _fail(msg: str) -> SyntaxError:
    return SyntaxError(f"AVIF: {msg} (libavif refuses it)")


# ---------------------------------------------------------------------------
# The container
# ---------------------------------------------------------------------------


def _boxes(d: bytes, at: int, end: int, lenient: bool = False) -> list[tuple[bytes, int, int]]:
    """(type, body start, box end) of each box in d[at:end]; ``lenient``
    (the file's top level): an mdat box whose size runs past the end is
    cut there, as libavif reads the items' data wherever iloc says."""
    out = []
    while at < end:
        if lenient and out and out[0][0] == b"ftyp":  # avifParse stops once it has every box the brands need
            brands = _brands(d, out[0][1], out[0][2])
            seen = {t for t, _, _ in out}
            if (b"avif" not in brands or b"meta" in seen) and (b"avis" not in brands or b"moov" in seen):
                break
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
            n = end - at
        if t == b"uuid":
            hdr += 16
        if lenient and t == b"mdat" and n >= hdr and at + n > end:
            n = end - at
        if n < hdr or at + n > end:
            raise _fail(f"a {t!r} box of a bad size")
        out.append((t, at + hdr, at + n))
        at += n
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
        top = _boxes(d, 0, len(d), lenient=True)
        if not top or top[0][0] != b"ftyp" or top[0][2] - top[0][1] < 8:
            raise _fail("no ftyp box first")
        if not _ftyp_ok(d, top[0][1], top[0][2]):
            raise _fail("an ftyp box without the avif or avis brand")
        metas = [b for b in top if b[0] == b"meta"]
        if len(metas) != 1:
            raise _fail("no meta box" if not metas else "more than one meta box")
        self.items: dict[int, _Item] = {}
        self.props: list[tuple[bytes, int, int]] = []
        self.refs: list[tuple[bytes, int, list[int]]] = []
        self.idat = b""
        self.primary = None
        handler = None
        _, body, end = metas[0]
        if end - body < 4 or d[body] != 0:
            raise _fail("a meta box of another version than 0")
        for t, b0, b1 in _boxes(d, body + 4, end):
            if t == b"hdlr":  # avifParseHandlerBox: version 0, pre_defined 0, 'pict', a terminated name
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
        if b"avis" in _brands(d, top[0][1], top[0][2]) and not any(t == b"moov" for t, _, _ in top):
            raise _fail("an avis brand without its moov box")
        if self.primary is None and any(t == b"moov" for t, _, _ in top):
            raise ValueError("AVIF image sequence (an avis track) without a primary item is not decoded by the "
                             "port's codec (AVIF's third slice)")
        if self.primary is None or self.primary not in self.items:
            raise _fail("no primary item")

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
            if ev < 2:
                continue
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
    if (t == b"irot" and (not b or b[0] & 0xFC)) or (t == b"imir" and (not b or b[0] & 0xFE)):
        raise _fail(f"an {t.decode()} property with reserved bits set")
    if t == b"colr" and b[:4] == b"nclx" and (len(b) < 11 or b[10] & 0x7F):
        raise _fail("an nclx colour property with reserved bits set")


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
        prim = c.items[c.primary]
        if prim.type not in (b"av01", b"grid") or prim.unsupported:
            raise _fail(f"a primary item of type {prim.type!r}" + (" with an unknown essential property"
                                                                     if prim.unsupported else ""))
        thumbs = {src for kind, src, _ in c.refs if kind == b"thmb"}
        for item in c.items.values():  # every image item libavif does not skip has its ispe
            if item.type in (b"av01", b"grid") and item.extents and not item.unsupported and item.id not in thumbs:
                _ispe(c, item)
        self.width, self.height = _ispe(c, prim)
        _check_size(self.width, self.height)
        if prim.type == b"grid":
            tiles = [t for kind, src, dst in c.refs if kind == b"dimg" and src == prim.id for t in dst]
            g = c.data(prim)
            if len(g) < 8 or g[0] != 0:
                raise _fail("a grid item of a bad size or version")
            big = g[1] & 1
            self.rows, self.cols = g[2] + 1, g[3] + 1
            fmt = ">II" if big else ">HH"
            if len(g) != 4 + struct.calcsize(fmt):
                raise _fail("a grid item of a bad size")
            out_w, out_h = struct.unpack_from(fmt, g, 4)
            if (out_w, out_h) != (self.width, self.height):
                raise _fail("a grid whose output size is not its ispe")
            if len(tiles) != self.rows * self.cols:
                raise _fail("a grid with another number of tiles than its rows and columns")
            self.tiles = [c.items.get(t) for t in tiles]
            if any(t is None or t.type != b"av01" or t.unsupported for t in self.tiles):
                raise _fail("a grid tile that is not an AV1 image item")
            sizes = {_ispe(c, t) for t in self.tiles}
            if len(sizes) != 1:
                raise _fail("grid tiles of different sizes")
            self.tile_w, self.tile_h = sizes.pop()
            if not (self.cols * self.tile_w >= out_w and (self.cols - 1) * self.tile_w < out_w and
                    self.rows * self.tile_h >= out_h and (self.rows - 1) * self.tile_h < out_h):
                raise _fail("a grid whose tiles do not cover its output exactly")
            config = {c.prop(t, b"av1C") for t in self.tiles}
            if len(config) != 1 or None in config:
                raise _fail("grid tiles of different AV1 configurations")
        else:
            self.tiles = [prim]
            self.rows = self.cols = 1
            self.tile_w, self.tile_h = self.width, self.height
        for item in self.tiles + ([] if prim.type != b"grid" else [prim]):
            for off, n in item.extents:  # libavif's parse: each extent inside the file (or idat)
                src = len(c.idat) if item.construction == 1 else len(c.d)
                if item.base + off + n > src:
                    raise _fail(f"item {item.id}'s data past the end of the file")
        for item in self.tiles:
            av1c = c.prop(item, b"av1C")
            if av1c is None or len(av1c) < 4:
                raise _fail(f"item {item.id} without an av1C property")
            depth = 12 if av1c[2] & 0x20 else (10 if av1c[2] & 0x40 else 8)
            pixi = c.prop(item, b"pixi")
            if pixi is not None:  # avifDecoderItemValidateProperties: its depths are the av1C's
                if len(pixi) < 5 or len(pixi) < 5 + pixi[4] or any(v != depth for v in pixi[5:5 + pixi[4]]):
                    raise _fail(f"item {item.id} whose pixi depths are not its av1C depth")
        self.nclx = None  # the primary item's nclx colour box, else the AV1 sequence header's
        for p0, p1 in prim.colr:
            box = c.d[p0:p1]
            if box[:4] == b"nclx" and len(box) >= 11:
                cp, tc, mc = struct.unpack_from(">HHH", box, 4)
                self.nclx = (cp, tc, mc, box[10] >> 7)
                break
        alphas = [src for kind, src, dst in c.refs if kind == b"auxl" and prim.id in dst]
        self.alpha = None
        for a in alphas:
            item = c.items.get(a)
            if item is None or not item.extents or item.unsupported:  # avifDecoderItemShouldBeSkipped
                continue
            aux = c.prop(item, b"auxC")
            if aux is not None and aux[4:].split(b"\0")[0] in ALPHA_URNS:
                self.alpha = item
                break
        if self.alpha is not None:
            if c.prop(self.alpha, b"av1C") is None:
                raise _fail(f"item {self.alpha.id} without an av1C property")
            if any(kind == b"prem" and src == prim.id for kind, src, _ in c.refs):
                raise ValueError("AVIF with premultiplied alpha is not decoded by the port's codec (it changes the "
                                 "colour Pillow gives; AVIF's third slice)")


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


def yuv_to_rgb(planes: list[torch.Tensor], subx: int, suby: int, matrix: int, full: int) -> torch.Tensor:
    """8-bit Y, U and V planes (u8 tensors on any device; 4:0:0: Y alone)
    → RGB u8 [H, W, 3] on their device, as Pillow's ``avifImageYUVToRGB``
    call gives them: integer ops alone, so the host and the card agree."""
    h, w = planes[0].shape
    if len(planes) == 1:
        # avifPrepareReformatState refuses these matrices for gray too
        if matrix in (3, 10, 11, 13, 14) or matrix >= 16 or (matrix == 8 and not full):
            raise ValueError(f"AVIF of matrix coefficients {matrix} does not convert (nor in Pillow: libavif's "
                             "Reformat failed)")
        if full:
            return planes[0][..., None].expand(h, w, 3).contiguous()
        yg, yb = _GRAY_LIMITED
        g = ((((planes[0].to(torch.int32) * (0x0101 * yg)) >> 16) + yb) >> 6).clamp(0, 255).to(torch.uint8)
        return g[..., None].expand(h, w, 3).contiguous()
    if matrix == 0:
        if (subx, suby) != (0, 0):
            raise ValueError("AVIF with the identity matrix on subsampled chroma does not convert (nor in Pillow: "
                             "libavif's Reformat failed)")
        if not full:
            raise ValueError("AVIF with the identity matrix at limited range goes through libavif's own conversion, "
                             "which the port's codec does not reproduce (AVIF's third slice)")
        return torch.stack([planes[2], planes[0], planes[1]], -1)
    key = (_MATRIX_AS.get(matrix, -1), full)
    if key not in _LIBYUV:
        if matrix in (3, 10, 13, 14) or (matrix == 8 and not full):
            raise ValueError(f"AVIF of matrix coefficients {matrix} does not convert (nor in Pillow: libavif's "
                             "Reformat failed)")
        raise ValueError(f"AVIF of matrix coefficients {matrix} at {'full' if full else 'limited'} range goes "
                         "through libavif's own conversion, which the port's codec does not reproduce (AVIF's "
                         "third slice)")
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
    """The primary image's Y, U and V planes at its output size: one item,
    or a grid's tiles (decoded on a few threads) pasted and cropped as
    libavif pastes them."""
    datas = [av.c.data(t) for t in av.tiles]
    if len(datas) == 1:
        results = [_decode_item(datas[0])]
    else:
        with ThreadPoolExecutor(max_workers=min(8, len(datas))) as pool:
            results = list(pool.map(_decode_item, datas))
    dims0 = results[0][1]
    for planes, dims in results:
        if (int(dims[0]), int(dims[1])) != (av.tile_w, av.tile_h):
            raise ValueError("AVIF whose AV1 image has another size than its ispe property is not decoded by the "
                             "port's codec (libavif scales the image to the ispe; AVIF's third slice)")
        if tuple(dims[2:6]) != tuple(dims0[2:6]):
            raise ValueError("AVIF: grid tiles of different pixel formats (Pillow: Failed to decode image)")
    if len(results) == 1:
        return results[0]
    sx, sy, n = int(dims0[2]), int(dims0[3]), int(dims0[4])
    # avifAreGridDimensionsValid (MIAF 7.3.11.4.2): tiles of 64 or more a
    # side, and even widths (4:2:0 and 4:2:2) and heights (4:2:0)
    sub = n == 3 and sx
    if av.tile_w < 64 or av.tile_h < 64 or (sub and (av.width % 2 or av.tile_w % 2)) or \
            (sub and sy and (av.height % 2 or av.tile_h % 2)):
        raise ValueError("AVIF: an invalid image grid (tiles under 64 a side, or odd sizes of subsampled ones; "
                         "Pillow: Invalid image grid)")
    out = []
    for p in range(n):
        px, py = (sx, sy) if p else (0, 0)
        full = np.zeros(((av.height + py) >> py, (av.width + px) >> px), np.uint8)
        tw, th = (av.tile_w + px) >> px, (av.tile_h + py) >> py
        for k, (planes, _) in enumerate(results):
            r, col = divmod(k, av.cols)
            y0, x0 = r * th, col * tw
            ph, pw = full[y0:y0 + th, x0:x0 + tw].shape
            full[y0:y0 + ph, x0:x0 + pw] = planes[p][:ph, :pw]
        out.append(full)
    return out, dims0


def decode_avif(av: Avif, device: torch.device | str = "cpu") -> torch.Tensor:
    """The primary image → RGB u8 [H, W, 3] on ``device``, as Pillow's
    ``Image.open(...).convert("RGB")`` gives it: decoded on the host, its
    planes converted where they land."""
    planes, dims = _decode_planes(av)
    if int(dims[5]) != 8:
        raise ValueError(f"AVIF of {int(dims[5])}-bit samples is not decoded by the port's codec (AVIF's third slice)")
    if av.alpha is not None:  # Pillow decodes the alpha plane too, and fails with it
        _, adims = _decode_item(av.c.data(av.alpha))
        if (int(adims[0]), int(adims[1])) != (av.width, av.height) and av.rows * av.cols == 1:
            raise ValueError("AVIF: an alpha plane of another size than the image (Pillow: Failed to decode image)")
    if av.nclx is not None:
        _, _, matrix, full = av.nclx
    else:
        matrix, full = int(dims[8]), int(dims[9])
    on = [torch.from_numpy(p).to(device) for p in planes]
    return yuv_to_rgb(on, int(dims[2]), int(dims[3]), matrix, full)


def planes_of(data: bytes) -> tuple[list[np.ndarray], np.ndarray]:
    """An AVIF's primary image as the port decodes it: its Y, U and V planes
    and the decoder's dims (size, sampling, depth, CICP, range, the tools
    mask's low and high words: ``tools_of``)."""
    return _decode_planes(Avif(data))


def tools_of(dims: np.ndarray) -> int:
    """The 64-bit mask of the AV1 tools a decode used (``csrc/host/av1.cpp``'s
    TOOL_* bits), from its dims[10] (low word) and dims[11] (high word)."""
    return (int(dims[10]) & 0xFFFFFFFF) | (int(dims[11]) & 0xFFFFFFFF) << 32
