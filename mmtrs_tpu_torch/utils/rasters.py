"""The raster formats that Pillow 12.1 opens besides JPEG, PNG, BMP, GIF,
TIFF and WebP, identified and decoded as Pillow identifies and decodes
them, without Pillow.

Identification (:func:`identify`) runs Pillow's openers in the order
``Image.open`` tries them (the preinit plugins BMP, DIB, GIF, JPEG, PPM and
PNG first, then the rest in ``Image.ID``'s order): an opener whose
``_accept`` test takes the first 16 bytes (or that has none) parses the
header, and an opener that fails the way Pillow's does with a
``SyntaxError``, ``IndexError``, ``TypeError``, ``KeyError``, ``EOFError``
or ``struct.error`` (ImageFile turns the last four into SyntaxError), or
that finds no mode or a size of 0, gives way to the next one. Any other
error refuses the file, as Pillow's ``open`` raises it; data that no
opener takes is not identified, where Pillow raises
``UnidentifiedImageError``. Each opener is written over a file object as
Pillow's is, so that its reads fail where Pillow's fail.

An opener returns a loader; the loader gives the image's samples in a
Pillow mode, which ``codec.convert_rgb`` turns into RGB as Pillow's
``convert("RGB")`` does. The byte loops (TGA, PCX and SGI run lengths, QOI,
BC1-BC7, CCITT fax) run in C (``csrc/host/rasters.cpp``). Decoded here:

- PNM: P1-P6 (plain and raw, any maxval, 16-bit), PFM (``Pf``) and
  Pillow's own ``P0CMYK``/``PyP``/``PyRGBA``/``PyCMYK``;
- QOI; ICO (the entry Pillow picks: the largest, the lowest colour depth
  among equals; PNG or DIB inside, the AND mask or alpha bytes checked as
  Pillow reads them) and CUR; DIB (a BMP without its file header);
- TGA: types 1, 2, 3, 9, 10 and 11 at 1, 8, 15/16, 24 and 32 bits,
  colour-mapped, either origin, mirrored;
- PCX (1-bit, 2/4-plane EGA, 8-bit gray or palette, 24-bit) and DCX's
  first page; SGI (verbatim and RLE, 8 and 16 bits, 1, 3 and 4 channels);
- PSD's merged image (raw or RLE) in Pillow's modes 1, L, P, RGB, RGBA and
  CMYK; DDS: uncompressed (masks, luminance, palette, DX10 RGBA) and BC1-BC7
  (BC5 and BC6H signed and unsigned);
- SUN (raw and RLE), XBM, XPM, MSP, IM, FITS (raw and gzip), SPIDER, GBR,
  PIXAR, MCIDAS, IMT, XVThumb, FTEX, IPTC (one layer, or one of three or
  four bands as Pillow merges it), BLP (palette, JPEG, and BLP2's DXT in
  Pillow's own Python arithmetic), ICNS (PNG and RGB entries), FLI/FLC (a
  first frame of BLACK, BRUN, COPY and the LC and SS2 delta chunks) and
  PCD (PhotoCD's 768 × 512 base image, PhotoYCC, turned as it says);
- PSD's Lab mode and TIFF's CIELab through ``codec.convert_rgb``'s copy of
  Pillow's LittleCMS transform;
- JPEG 2000 (.jp2 and raw codestreams, and ICNS's JPEG 2000 entries): the
  codestream through the port's own decoder (``csrc/host/jp2.cpp``, as
  Pillow's OpenJPEG 2.5.4 decodes it, in strict mode), the JP2 boxes read
  as Pillow's plugin and OpenJPEG read them, each tile unpacked as
  Pillow's ``Jpeg2KDecode.c`` unpacks it (precision shifts, the signed
  offset, its sYCC guess, palettes), then converted;
- AVIF (``utils.avif``): libavif's container and checks, an image
  sequence from its track, the AV1 intra frame through the port's own
  decoder (``csrc/host/av1.cpp``: palette, intraBC, CDEF, loop restoration,
  quantiser matrices, film grain), frames scaled to their ``ispe``,
  premultiplied alpha, and libyuv's or libavif's own YUV → RGB as Pillow's
  libavif routes it; superres and 10/12 bits refused by name.

Refused, with an error that names them: the
formats Pillow identifies but cannot load without
software it lacks (EPS without Ghostscript; WMF/EMF, BUFR, GRIB, HDF5 and
MPEG, whose plugins are stubs with no handler).
"""

from __future__ import annotations

import io
import math
import struct
from typing import Callable

import numpy as np

from mmtrs_tpu_torch import _build

# Pillow's DecompressionBombError limit: twice Image.MAX_IMAGE_PIXELS
MAX_PIXELS = 2 * 89_478_485
# what an opener raises, or Python raises in it, for Pillow to try the next opener
NOT_THIS = (SyntaxError, IndexError, TypeError, KeyError, EOFError, struct.error)
_WHITESPACE = b"\x20\x09\x0a\x0b\x0c\x0d"

Loaded = tuple  # (samples, mode, palette rows [n, 3] or None)
Loader = Callable[[], Loaded]


def check_pixels(fmt: str, w: int, h: int, what: str = "image") -> None:
    """Refuse a header that asks for more than MAX_PIXELS pixels."""
    if w * h > MAX_PIXELS:
        raise ValueError(f"{fmt} {what} of {w}x{h} = {w * h} pixels exceeds the limit of {MAX_PIXELS} pixels")


def _sized(fmt: str, w: int, h: int) -> None:
    """ImageFile's check after an opener (a size of 0 gives way to the next
    opener), then ``Image.open``'s bomb check."""
    if w <= 0 or h <= 0:
        raise SyntaxError("not identified by this opener")
    check_pixels(fmt, w, h)


def i16(b: bytes, o: int = 0) -> int:
    return struct.unpack_from("<H", b, o)[0]


def i32(b: bytes, o: int = 0) -> int:
    return struct.unpack_from("<I", b, o)[0]


def i16be(b: bytes, o: int = 0) -> int:
    return struct.unpack_from(">H", b, o)[0]


def i32be(b: bytes, o: int = 0) -> int:
    return struct.unpack_from(">I", b, o)[0]


def _truncated(fmt: str) -> ValueError:
    return ValueError(f"truncated {fmt}: the image data ends early")


def _raw(data: bytes, offset: int, count: int, fmt: str) -> np.ndarray:
    """``count`` bytes from ``offset``, which the file must hold (Pillow's raw
    decoder refuses a truncated tile)."""
    if offset < 0 or len(data) < offset + count:
        raise _truncated(fmt)
    return np.frombuffer(data, np.uint8, count=count, offset=offset)


def unpack_bits(rows: np.ndarray, width: int, depth: int) -> np.ndarray:
    """Rows of packed samples, high bits first → [rows, width] u8 values."""
    if depth == 8:
        return rows[:, :width]
    bits = np.unpackbits(rows, axis=1)[:, : width * depth].reshape(rows.shape[0], width, depth)
    return (bits * (1 << np.arange(depth - 1, -1, -1, dtype=np.uint8))).sum(axis=2, dtype=np.uint8)


def _scaled(v: np.ndarray, bits: int) -> np.ndarray:
    """A ``bits``-bit field scaled to 8 bits as Pillow's unpackers scale it."""
    return (v.astype(np.int64) * 255 // ((1 << bits) - 1)).astype(np.uint8)


def _c(status: int, fmt: str) -> None:
    if status:
        raise _truncated(fmt)


# ---------------------------------------------------------------------------
# PNM (PpmImagePlugin)
# ---------------------------------------------------------------------------

_PPM_MODES = {b"P1": "1", b"P2": "L", b"P3": "RGB", b"P4": "1", b"P5": "L", b"P6": "RGB", b"P0CMYK": "CMYK",
              b"Pf": "F", b"PyP": "P", b"PyRGBA": "RGBA", b"PyCMYK": "CMYK"}
_BANDS = {"1": 1, "L": 1, "I": 1, "F": 1, "P": 1, "RGB": 3, "RGBA": 4, "CMYK": 4}


def _ppm_token(fp: io.BytesIO) -> bytes:
    token = b""
    while len(token) <= 10:
        c = fp.read(1)
        if not c:
            break
        if c in _WHITESPACE:
            if not token:
                continue
            break
        if c == b"#":
            while fp.read(1) not in b"\r\n":
                pass
            continue
        token += c
    if not token:
        raise ValueError("corrupt PNM: the header ends early")
    if len(token) > 10:
        raise ValueError(f"corrupt PNM: a header token of more than 10 bytes ({token[:11]!r})")
    return token


def _ppm_plain_tokens(body: bytes) -> list[bytes]:
    """The plain formats' data with ``#`` comments (to the end of their
    line) removed, split at whitespace."""
    out, pos = [], 0
    while True:
        c = body.find(b"#", pos)
        if c < 0:
            out.append(body[pos:])
            break
        out.append(body[pos:c])
        ends = [e for e in (body.find(b"\n", c), body.find(b"\r", c)) if e >= 0]
        if not ends:
            break
        pos = min(ends) + 1
    return b" ".join(out).split()


def open_ppm(data: bytes) -> Loader:
    fp = io.BytesIO(data)
    magic = b""
    for _ in range(6):
        c = fp.read(1)
        if not c or c in _WHITESPACE:
            break
        magic += c
    mode = _PPM_MODES[magic]  # KeyError: not a PPM file
    try:
        w, h = int(_ppm_token(fp)), int(_ppm_token(fp))
    except ValueError as e:
        raise ValueError(f"corrupt PNM header: {e}") from None
    plain = magic in (b"P1", b"P2", b"P3")
    maxval, scale = 255, 0.0
    if mode == "F":
        scale = float(_ppm_token(fp))
        if scale == 0.0 or not math.isfinite(scale):
            raise ValueError("corrupt PFM: the scale must be finite and non-zero")
    elif mode != "1":
        maxval = int(_ppm_token(fp))
        if not 0 < maxval < 65536:
            raise ValueError("corrupt PNM: maxval must be greater than 0 and less than 65536")
        if maxval > 255 and mode == "L":
            mode = "I"
    _sized("PPM", w, h)
    start = fp.tell()
    bands = _BANDS[mode]

    def load() -> Loaded:
        n = w * h * bands
        if plain:
            tokens = _ppm_plain_tokens(data[start:])
            if mode == "1":
                digits = b"".join(tokens)
                bad = digits.translate(None, b"01")
                if bad:
                    raise ValueError(f"corrupt PBM: a token {bad[:1]!r} that is neither 0 nor 1")
                if len(digits) < n:
                    raise _truncated("PBM")
                v = np.frombuffer(digits[:n], np.uint8)
                return np.where(v == 48, 255, 0).astype(np.uint8).reshape(h, w), "1", None
            if len(tokens) < n:
                raise _truncated("PNM")
            if any(len(t) > 10 for t in tokens[:n]):
                raise ValueError("corrupt PNM: a data token of more than 10 bytes")
            v = np.array([int(t) for t in tokens[:n]], np.int64)
            if (v < 0).any() or (v > maxval).any():
                raise ValueError(f"corrupt PNM: a value outside 0..{maxval}")
            out_max = 65535 if mode == "I" else 255
            v = np.round(v / maxval * out_max).astype(np.int64)
            return v.reshape((h, w, bands) if bands > 1 else (h, w)), mode, None
        if mode == "1":
            stride = (w + 7) // 8
            rows = _raw(data, start, stride * h, "PBM").reshape(h, stride)
            return np.where(unpack_bits(rows, w, 1) > 0, 0, 255).astype(np.uint8), "1", None
        if mode == "F":
            v = _raw(data, start, 4 * n, "PFM").view("<f4" if scale < 0 else ">f4").reshape(h, w)
            return v[::-1].astype(np.float32), "F", None
        shape = (h, w, bands) if bands > 1 else (h, w)
        if maxval == 255:
            return _raw(data, start, n, "PNM").reshape(shape), mode, None
        if maxval == 65535 and mode == "I":
            return _raw(data, start, 2 * n, "PNM").view(">u2").astype(np.int64).reshape(shape), "I", None
        # Pillow's PpmDecoder: whole pixels while the file holds them, each
        # sample round(v / maxval * out_max) (half to even), capped
        size = 2 if maxval > 255 else 1
        out_max = 65535 if mode == "I" else 255
        k = min(n, (len(data) - start) // (size * bands) * bands)
        v = np.frombuffer(data, ">u2" if size == 2 else np.uint8, count=k, offset=start).astype(np.float64)
        vals = np.minimum(out_max, np.round(v / maxval * out_max)).astype(np.int64)
        if k < n:
            raise _truncated("PNM")
        return vals.reshape(shape), mode, None

    return load


# ---------------------------------------------------------------------------
# QOI
# ---------------------------------------------------------------------------


def open_qoi(data: bytes) -> Loader:
    fp = io.BytesIO(data)
    if fp.read(4) != b"qoif":
        raise SyntaxError("not a QOI file")
    w, h = i32be(fp.read(4)), i32be(fp.read(4))
    channels = fp.read(1)[0]
    mode = "RGB" if channels == 3 else "RGBA"
    _sized("QOI", w, h)

    def load() -> Loaded:
        ch = 3 if mode == "RGB" else 4
        out = np.empty((h, w, ch), np.uint8)
        body = data[14:]
        _c(_build.raster_library().mmtrs_qoi_decode(body, len(body), w, h, ch, out.ctypes.data), "QOI")
        return out, mode, None

    return load


# ---------------------------------------------------------------------------
# DIB, ICO and CUR (a BMP's bitmap without its file header)
# ---------------------------------------------------------------------------


def _dib_pixel_offset(data: bytes, at: int) -> int:
    """The pixel data's offset from ``at`` (a DIB's header), as Pillow's
    _bitmap reads past the header, BI_BITFIELDS masks and palette."""
    size = i32(data, at)
    hdr = data[at + 4:at + size]
    if len(hdr) < size - 4:
        raise ValueError("corrupt or truncated DIB: short header")
    if size == 12:
        bits, colors, pad, masks = i16(hdr, 6), 0, 3, 0
    elif size in (40, 52, 56, 64, 108, 124):
        bits, comp, colors, pad = i16(hdr, 10), i32(hdr, 12), i32(hdr, 28), 4
        masks = 12 if comp == 3 and len(hdr) < 48 else 0
    else:
        raise ValueError(f"BMP with a {size}-byte header is not supported by the port's codec")
    colors = colors or (1 << bits if bits < 32 else 0)
    return size + masks + (pad * colors if bits <= 8 else 0)


def _dib_as_bmp(data: bytes, at: int, half: bool) -> bytes:
    """The DIB at ``at`` with a BMP file header whose offset points at its
    pixels; ``half``: the height halved, as an icon's XOR bitmap."""
    off = _dib_pixel_offset(data, at)
    body = bytearray(data[at:])
    if half:
        if i32(body) == 12:
            struct.pack_into("<H", body, 6, i16(body, 6) // 2)
        else:
            h = struct.unpack_from("<i", body, 8)[0]
            struct.pack_into("<i", body, 8, -(abs(h) // 2) if h < 0 else int(h / 2))
    return b"BM" + struct.pack("<IHHI", 14 + len(body), 0, 0, 14 + off) + bytes(body)


def _dib_size(data: bytes, at: int) -> tuple[int, int, int]:
    """(width, height, bits) of the DIB header at ``at``."""
    size = i32(data, at)
    if size == 12:
        return i16(data, at + 4), i16(data, at + 6), i16(data, at + 10)
    w, h = struct.unpack_from("<iI", data, at + 4)
    if data[at + 11] == 0xFF:
        h = 2 ** 32 - h
    return w, h, i16(data, at + 14)


def open_dib(data: bytes) -> Loader:
    i32(data)
    w, h, _ = _dib_size(data, 0)
    _sized("DIB", w, h)
    return lambda: (_decode_bmp(_dib_as_bmp(data, 0, False)), "RGB", None)


def _decode_bmp(data: bytes) -> np.ndarray:
    from mmtrs_tpu_torch.utils.codec import decode_bmp

    return decode_bmp(data)


def _decode_png(data: bytes) -> np.ndarray:
    from mmtrs_tpu_torch.utils.codec import decode_png

    return decode_png(data)


def open_ico(data: bytes) -> Loader:
    fp = io.BytesIO(data)
    s = fp.read(6)
    if s[:4] != b"\x00\x00\x01\x00":
        raise SyntaxError("not an ICO file")
    entries = []
    for _ in range(i16(s, 4)):
        e = fp.read(16)
        width, height, nb_color = e[0] or 256, e[1] or 256, e[2]
        bpp = i16(e, 6)
        depth = bpp or (nb_color != 0 and math.ceil(math.log(nb_color, 2))) or 256
        entries.append({"dim": (width, height), "square": width * height, "depth": depth, "bpp": bpp,
                        "size": i32(e, 8), "offset": i32(e, 12)})
    entries = sorted(entries, key=lambda x: x["depth"])
    entries = sorted(entries, key=lambda x: x["square"], reverse=True)
    e = entries[0]  # IndexError with no entries
    _sized("ICO", *e["dim"])

    def decode() -> Loaded:
        at = e["offset"]
        if data[at:at + 8] == b"\x89PNG\r\n\x1a\n":
            return _decode_png(data[at:]), "RGB", None
        w, h, _ = _dib_size(data, at)
        check_pixels("ICO", w, h)
        h = int(h / 2)
        bmp = _dib_as_bmp(data, at, True)
        pixels = at + _dib_pixel_offset(data, at)
        if e["bpp"] == 32:  # the alpha bytes must all be there
            if len(data[pixels:pixels + w * h * 4]) // 4 < w * h:
                raise ValueError("truncated ICO: the alpha bytes end early")
        else:  # the AND mask: rows padded to 32 bits, the last bytes of the entry (its last row's padding
            # may be missing, as Pillow's raw reader allows)
            wp = w + (32 - w % 32) % 32
            total = int(wp * h / 8)
            start = at + e["size"] - total
            need = (wp // 8) * (h - 1) + (w + 7) // 8 if h else 0
            if start < 0 or len(data[start:start + total]) < need:
                raise ValueError("truncated ICO: the AND mask ends early")
        return _decode_bmp(bmp), "RGB", None

    loaded = decode()  # Pillow's IcoImageFile loads the entry while it opens
    return lambda: loaded


def open_cur(data: bytes) -> Loader:
    fp = io.BytesIO(data)
    s = fp.read(6)
    if s[:4] != b"\x00\x00\x02\x00":
        raise SyntaxError("not a CUR file")
    m = b""
    for _ in range(i16(s, 4)):
        e = fp.read(16)
        if not m:
            m = e
        elif e[0] > m[0] and e[1] > m[1]:
            m = e
    if not m:
        raise TypeError("No cursors were found")
    at = i32(m, 12)
    w, h, _ = _dib_size(data, at)
    _sized("CUR", w, h // 2)
    return lambda: (_decode_bmp(_dib_as_bmp(data, at, True)), "RGB", None)


# ---------------------------------------------------------------------------
# TGA
# ---------------------------------------------------------------------------

_TGA_RAW = {(1, 8): "P", (3, 1): "1", (3, 8): "L", (3, 16): "LA", (2, 16): "BGRA;15Z", (2, 24): "BGR",
            (2, 32): "BGRA"}


def _bgr15(words: np.ndarray) -> np.ndarray:
    """16-bit BGRA;15 words → RGB u8."""
    return np.stack([_scaled((words >> 10) & 31, 5), _scaled((words >> 5) & 31, 5), _scaled(words & 31, 5)], -1)


def open_tga(data: bytes) -> Loader:
    s = data[:18]
    id_len, cmap_type, kind, depth, flags = s[0], s[1], s[2], s[16], s[17]
    w, h = i16(s, 12), i16(s, 14)
    if cmap_type not in (0, 1) or w <= 0 or h <= 0 or depth not in (1, 8, 16, 24, 32):
        raise SyntaxError("not a TGA file")
    if kind in (3, 11):
        mode = "1" if depth == 1 else "LA" if depth == 16 else "L"
    elif kind in (1, 9):
        mode = "P" if cmap_type else "L"
    elif kind in (2, 10):
        mode = "RGB" if depth == 24 else "RGBA"
    else:
        raise SyntaxError("unknown TGA mode")
    orient = flags & 0x30
    mirror = orient in (0x10, 0x30)
    bottom_up = orient in (0, 0x10)
    pos = 18 + id_len
    palette = None
    if cmap_type:
        start, size, map_depth = i16(s, 3), i16(s, 5), s[7]
        if map_depth not in (16, 24, 32):
            raise SyntaxError("unknown TGA map depth")
        entry = map_depth // 8
        raw = bytes(entry * start) + data[pos:pos + entry * size]
        pos += entry * size
        n = len(raw) // entry
        rows = np.frombuffer(raw, np.uint8, count=n * entry).reshape(n, entry)
        if map_depth == 16:
            palette = _bgr15(rows.view("<u2")[:, 0].astype(np.int64))
        else:
            palette = rows[:, 2::-1]
    _sized("TGA", w, h)
    rawmode = _TGA_RAW.get((kind & 7, depth))

    def load() -> Loaded:
        if rawmode is None:
            raise ValueError(f"TGA image type {kind} at {depth} bits is not read (Pillow sets no decoder for it "
                             "either)")
        if cmap_type and s[7] == 32:
            raise ValueError("TGA colour maps of 32 bits are not read (Pillow's palette refuses BGRA too)")
        if kind in (1, 9) and not cmap_type:
            raise ValueError("TGA colour-mapped images without a colour map are not read (nor by Pillow)")
        bits = depth
        if kind & 8 and bits == 1:  # Pillow's RLE decoder reads no 1-bit image to its end
            raise ValueError("truncated TGA: run-length coded 1-bit images are not read (nor by Pillow)")
        if kind & 8:
            pb = (bits + 7) // 8
            cap = w * h * pb
            flat = np.zeros(cap, np.uint8)
            used = np.zeros(1, np.int64)
            body = data[pos:]
            st = _build.raster_library().mmtrs_tga_rle(body, len(body), pb, w * pb, flat.ctypes.data, cap,
                                                       used.ctypes.data)
            if st == 2:
                raise ValueError("corrupt TGA: a run past the end of its row (Pillow overruns too)")
            _c(st, "TGA")
            px = flat.reshape(h, w, pb)
        else:
            if bits == 1:
                stride = (w + 7) // 8
                px = unpack_bits(_raw(data, pos, stride * h, "TGA").reshape(h, stride), w, 1) * np.uint8(255)
            else:
                pb = bits // 8
                px = _raw(data, pos, w * h * pb, "TGA").reshape(h, w, pb)
        if bottom_up:
            px = px[::-1]
        if mirror:
            px = px[:, ::-1]
        if rawmode == "BGRA;15Z":
            return _bgr15(px.copy().view("<u2")[..., 0].astype(np.int64)), "RGB", None
        if rawmode in ("BGR", "BGRA"):
            return px[..., 2::-1], "RGB", None
        if rawmode == "LA":
            return px[..., 0], "L", None
        if rawmode == "1":
            return px, "1", None
        return px[..., 0], mode, palette

    return load


# ---------------------------------------------------------------------------
# PCX and DCX
# ---------------------------------------------------------------------------


def _open_pcx_at(data: bytes, at: int) -> Loader:
    s = data[at:at + 68]
    if not (len(s) >= 2 and s[0] == 10 and s[1] in (0, 2, 3, 5)):
        raise SyntaxError("not a PCX file")
    x0, y0, x1, y1 = i16(s, 4), i16(s, 6), i16(s, 8) + 1, i16(s, 10) + 1
    if x1 <= x0 or y1 <= y0:
        raise SyntaxError("bad PCX image size")
    version, bits, planes, provided = s[1], s[3], s[65], i16(s, 66)
    palette = None
    if bits == 1 and planes == 1:
        mode = "1"
    elif bits == 1 and planes in (2, 4):
        mode = "P"
        palette = np.frombuffer(s[16:64], np.uint8).reshape(16, 3)
    elif version == 5 and bits == 8 and planes == 1:
        mode = "L"
        tail = data[-769:] if len(data) >= 769 else data
        if len(tail) == 769 and tail[0] == 12:
            pal = np.frombuffer(tail[1:], np.uint8).reshape(256, 3)
            if not (pal == np.arange(256, dtype=np.uint8)[:, None]).all():
                mode, palette = "P", pal
    elif version == 5 and bits == 8 and planes == 3:
        mode = "RGB"
    else:
        raise ValueError(f"PCX at {bits} bits and {planes} planes (version {version}) is not supported by the "
                         "port's codec (nor by Pillow)")
    w, h = x1 - x0, y1 - y0
    stride = (w * bits + 7) // 8
    if provided != stride:
        stride += stride % 2
    _sized("PCX", w, h)

    def load() -> Loaded:
        row_bytes = planes * stride
        out = np.zeros((h, row_bytes), np.uint8)
        used = np.zeros(1, np.int64)
        body = data[at + 128:]
        st = _build.raster_library().mmtrs_pcx_rle(body, len(body), row_bytes, h, out.ctypes.data, used.ctypes.data)
        if st == 2:
            raise ValueError("corrupt PCX: a run past the end of its row (Pillow overruns too)")
        _c(st, "PCX")
        if mode == "1":
            return unpack_bits(out, w, 1) * np.uint8(255), "1", None
        if bits == 1:  # P;2L / P;4L: plane p gives bit p of the index
            idx = np.zeros((h, w), np.uint8)
            for p in range(planes):
                idx |= unpack_bits(out[:, p * stride:(p + 1) * stride], w, 1) << np.uint8(p)
            return idx, "P", palette
        if mode == "RGB":
            return np.stack([out[:, p * stride:p * stride + w] for p in range(3)], -1), "RGB", None
        return out[:, :w], mode, palette

    return load


def open_pcx(data: bytes) -> Loader:
    return _open_pcx_at(data, 0)


def open_dcx(data: bytes) -> Loader:
    if len(data) < 4 or i32(data) != 987654321:
        raise SyntaxError("not a DCX file")
    offsets = []
    for i in range(1024):
        off = i32(data, 4 + 4 * i)
        if not off:
            break
        offsets.append(off)
    return _open_pcx_at(data, offsets[0])


# ---------------------------------------------------------------------------
# SGI
# ---------------------------------------------------------------------------

_SGI_MODES = {(1, 1, 1): "L", (1, 2, 1): "L", (2, 1, 1): "L", (2, 2, 1): "L", (1, 3, 3): "RGB", (2, 3, 3): "RGB",
              (1, 3, 4): "RGBA", (2, 3, 4): "RGBA"}


def open_sgi(data: bytes) -> Loader:
    s = data[:512]
    if len(s) < 2 or i16be(s) != 474:
        raise ValueError("not an SGI image file")
    comp, bpc = s[2], s[3]
    dim, w, h, z = i16be(s, 4), i16be(s, 6), i16be(s, 8), i16be(s, 10)
    key = (bpc, dim, z)
    if key not in _SGI_MODES:
        raise ValueError(f"SGI images at {bpc} bytes, dimension {dim} and {z} channels are not supported by the "
                         "port's codec (nor by Pillow)")
    mode = _SGI_MODES[key]
    _sized("SGI", w, h)
    bands = len(mode)

    def load() -> Loaded:
        if comp == 0:
            page = w * h * bpc
            planes = []
            for c in range(bands):
                raw = _raw(data, 512 + c * page, page, "SGI")
                v = raw.reshape(h, w * bpc)[:, ::bpc] if bpc == 2 else raw.reshape(h, w)
                planes.append(v)
            px = np.stack(planes, -1)[::-1]
        elif comp == 1:
            out = np.zeros((h, w * bands * bpc), np.uint8)
            body = data[512:]
            st = _build.raster_library().mmtrs_sgi_rle(body, len(body), w, h, bands, bpc, out.ctypes.data)
            if st:
                raise ValueError("corrupt SGI: an RLE row outside the file or past the row")
            px = out.reshape(h, w, bands, bpc)[..., 0][::-1]
        else:
            raise ValueError(f"SGI compression {comp} is not read (Pillow sets no decoder for it either)")
        return (px[..., 0] if bands == 1 else px), mode, None

    return load


# ---------------------------------------------------------------------------
# PSD (the merged image)
# ---------------------------------------------------------------------------

_PSD_MODES = {(0, 1): ("1", 1), (0, 8): ("L", 1), (1, 8): ("L", 1), (2, 8): ("P", 1), (3, 8): ("RGB", 3),
              (4, 8): ("CMYK", 4), (7, 8): ("L", 1), (8, 8): ("L", 1), (9, 8): ("LAB", 3)}


def open_psd(data: bytes) -> Loader:
    fp = io.BytesIO(data)
    s = fp.read(26)
    if s[:4] != b"8BPS" or i16be(s, 4) != 1:
        raise SyntaxError("not a PSD file")
    bits, channels_in, psd_mode = i16be(s, 22), i16be(s, 12), i16be(s, 24)
    mode, channels = _PSD_MODES[(psd_mode, bits)]
    if channels > channels_in:
        raise ValueError("corrupt PSD: not enough channels")
    if mode == "RGB" and channels_in == 4:
        mode, channels = "RGBA", 4
    w, h = i32be(s, 18), i32be(s, 14)
    palette = None
    size = i32be(fp.read(4))
    if size:
        pal = fp.read(size)
        if mode == "P" and size == 768:
            palette = np.frombuffer(pal, np.uint8).reshape(3, 256).T
    size = i32be(fp.read(4))
    if size:  # image resources: each read as Pillow reads it
        end = fp.tell() + size
        while fp.tell() < end:
            fp.read(4)
            i16be(fp.read(2))
            name = fp.read(fp.read(1)[0])
            if not len(name) & 1:
                fp.read(1)
            res = fp.read(i32be(fp.read(4)))
            if len(res) & 1:
                fp.read(1)
    size = i32be(fp.read(4))
    if size:  # layers and masks: skipped
        end = fp.tell() + size
        i32be(fp.read(4))
        fp.seek(end)
    compression = i16be(fp.read(2))
    start = fp.tell()
    _sized("PSD", w, h)

    def load() -> Loaded:
        stride = (w + 7) // 8 if mode == "1" else w
        planes = []
        if compression == 0:
            for c in range(channels):
                planes.append(_raw(data, start + c * w * h, stride * h, "PSD").reshape(h, stride))
        elif compression == 1:
            counts = data[start:start + 2 * channels * h]
            off = start + 2 * channels * h
            for c in range(channels):
                plane = np.zeros((h, stride), np.uint8)
                used = np.zeros(1, np.int64)
                body = data[off:]
                _c(_build.raster_library().mmtrs_packbits_rows(body, len(body), stride, h, plane.ctypes.data,
                                                               used.ctypes.data), "PSD")
                planes.append(plane)
                off += sum(i16be(counts, 2 * (c * h + y)) for y in range(h))
        else:
            raise ValueError(f"PSD compression {compression} is not read (Pillow sets no decoder for it either)")
        if mode == "1":
            return unpack_bits(planes[0], w, 1) * np.uint8(255), "1", None
        px = planes[0] if channels == 1 else np.stack(planes, -1)
        if mode == "CMYK":
            px = 255 - px
        return px, mode, palette

    return load


# ---------------------------------------------------------------------------
# DDS
# ---------------------------------------------------------------------------

_DDPF_ALPHAPIXELS, _DDPF_FOURCC, _DDPF_PALETTEINDEXED8, _DDPF_RGB, _DDPF_LUMINANCE = 0x1, 0x4, 0x20, 0x40, 0x20000
_FOURCC = {b"DXT1": (1, False, "RGBA"), b"DXT3": (2, False, "RGBA"), b"DXT5": (3, False, "RGBA"),
           b"BC4U": (4, False, "L"), b"ATI1": (4, False, "L"), b"BC5S": (5, True, "RGB"),
           b"BC5U": (5, False, "RGB"), b"ATI2": (5, False, "RGB")}
# DXGI formats Pillow decodes → (BCn, signed, mode); 0 for raw RGBA
_DXGI = {70: (1, False, "RGBA"), 71: (1, False, "RGBA"), 73: (2, False, "RGBA"), 74: (2, False, "RGBA"),
         76: (3, False, "RGBA"), 77: (3, False, "RGBA"), 79: (4, False, "L"), 80: (4, False, "L"),
         82: (5, False, "RGB"), 83: (5, False, "RGB"), 84: (5, True, "RGB"), 95: (6, False, "RGB"),
         96: (6, True, "RGB"), 97: (7, False, "RGBA"), 98: (7, False, "RGBA"), 99: (7, False, "RGBA"),
         27: (0, False, "RGBA"), 28: (0, False, "RGBA"), 29: (0, False, "RGBA")}


def open_dds(data: bytes) -> Loader:
    fp = io.BytesIO(data)
    if fp.read(4) != b"DDS ":
        raise SyntaxError("not a DDS file")
    (header_size,) = struct.unpack("<I", fp.read(4))
    if header_size != 124:
        raise ValueError(f"corrupt DDS: a header size of {header_size}")
    header = fp.read(120)
    if len(header) != 120:
        raise ValueError(f"corrupt DDS: an incomplete header of {len(header)} bytes")
    _, h, w = struct.unpack("<3I", header[:12])
    pfflags, fourcc, bitcount = struct.unpack("<I4sI", header[72:84])
    palette = None
    if pfflags & _DDPF_RGB:
        n_masks = 4 if pfflags & _DDPF_ALPHAPIXELS else 3
        masks = struct.unpack(f"<{n_masks}I", header[84:84 + 4 * n_masks])
        kind = ("rgb", masks)
    elif pfflags & _DDPF_LUMINANCE:
        if bitcount == 8:
            kind = ("raw", "L")
        elif bitcount == 16 and pfflags & _DDPF_ALPHAPIXELS:
            kind = ("raw", "LA")
        else:
            raise ValueError(f"DDS luminance at {bitcount} bits is not supported by the port's codec (nor by Pillow)")
    elif pfflags & _DDPF_PALETTEINDEXED8:
        pal = fp.read(1024)
        palette = np.frombuffer(pal[: len(pal) // 4 * 4], np.uint8).reshape(-1, 4)[:, :3]
        kind = ("raw", "P")
    elif pfflags & _DDPF_FOURCC:
        if fourcc == b"DX10":
            (dxgi,) = struct.unpack("<I", fp.read(4))
            fp.read(16)
            if dxgi not in _DXGI:
                raise ValueError(f"DDS with DXGI format {dxgi} is not supported by the port's codec (nor by Pillow)")
            n, sign, mode = _DXGI[dxgi]
            kind = ("bcn", n, sign, mode) if n else ("raw", "RGBA")
        elif fourcc in _FOURCC:
            kind = ("bcn", *_FOURCC[fourcc])
        else:
            raise ValueError(f"DDS pixel format {fourcc!r} is not supported by the port's codec (nor by Pillow)")
    else:
        raise ValueError(f"DDS pixel format flags {pfflags:#x} are not supported by the port's codec (nor by Pillow)")
    start = fp.tell()
    _sized("DDS", w, h)

    def load() -> Loaded:
        if kind[0] == "bcn":
            _, n, sign, mode = kind
            ch = 1 if n == 4 else 3 if n in (5, 6) else 4
            out = np.empty((h, w, ch), np.uint8)
            body = data[start:]
            _c(_build.raster_library().mmtrs_bcn_decode(body, len(body), w, h, n, int(sign), out.ctypes.data), "DDS")
            return (out[..., 0] if ch == 1 else out), mode, None
        if kind[0] == "rgb":  # Pillow's DdsRgbDecoder: int(v / max * 255) per mask; zeros past the file's end
            masks = kind[1]
            nbytes = bitcount // 8
            raw = np.zeros(w * h * nbytes, np.uint8)
            avail = data[start:start + raw.size]
            raw[: len(avail)] = np.frombuffer(avail, np.uint8)
            words = np.zeros(w * h, np.int64)
            for b in range(nbytes):
                words |= raw[b::nbytes].astype(np.int64) << (8 * b)
            chans = []
            for m in masks[:3]:
                shift = (m & -m).bit_length() - 1 if m else 0
                total = m >> shift if m else 0
                v = (words & m) >> shift
                chans.append((v / total * 255).astype(np.uint8) if total else np.zeros(w * h, np.uint8))
            return np.stack(chans, -1).reshape(h, w, 3), "RGB", None
        mode = kind[1]
        bands = {"L": 1, "LA": 2, "P": 1, "RGBA": 4}[mode]
        px = _raw(data, start, w * h * bands, "DDS").reshape(h, w, bands)
        if mode in ("L", "LA", "P"):
            return px[..., 0], "P" if mode == "P" else "L", palette
        return px, "RGBA", None

    return load


# ---------------------------------------------------------------------------
# SUN, XBM, XPM, MSP, FITS, SPIDER, GBR, PIXAR, MCIDAS, IMT, XVThumb, FTEX,
# IM and IPTC
# ---------------------------------------------------------------------------


def open_sun(data: bytes) -> Loader:
    s = data[:32]
    if len(s) < 4 or i32be(s) != 0x59A66A95:
        raise SyntaxError("not an SUN raster file")
    w, h, depth = i32be(s, 4), i32be(s, 8), i32be(s, 12)
    file_type, pal_type, pal_len = i32be(s, 20), i32be(s, 24), i32be(s, 28)
    raws = {1: ("1", "1;I"), 4: ("L", "L;4"), 8: ("L", "L")}
    if depth in raws:
        mode, raw = raws[depth]
    elif depth in (24, 32):
        mode, raw = "RGB", ("RGB" if file_type == 3 else "BGR") + ("X" if depth == 32 else "")
    else:
        raise SyntaxError("Unsupported Mode/Bit Depth")
    offset, palette = 32, None
    if pal_len:
        if pal_len > 1024:
            raise SyntaxError("Unsupported Color Palette Length")
        if pal_type != 1:
            raise SyntaxError("Unsupported Palette Type")
        pal = data[32:32 + pal_len]
        n = len(pal) // 3
        palette = np.frombuffer(pal, np.uint8, count=3 * n).reshape(3, n).T
        offset += pal_len
        if mode == "L":
            mode = "P"
    if file_type not in (0, 1, 2, 3, 4, 5):
        raise SyntaxError("Unsupported Sun Raster file type")
    _sized("SUN", w, h)

    def load() -> Loaded:
        if file_type == 2:  # Pillow's SunRleDecode: runs fill unpadded rows continuously
            stride = (w * depth + 7) // 8
            flat = np.zeros(stride * h, np.uint8)
            used = np.zeros(1, np.int64)
            body = data[offset:]
            _c(_build.raster_library().mmtrs_sun_rle(body, len(body), flat.ctypes.data, flat.size, used.ctypes.data),
               "SUN")
            rows = flat.reshape(h, stride)
        else:  # rows padded to 16 bits; the last row's padding may be missing, as Pillow's raw reader allows
            stride = ((w * depth + 15) // 16) * 2
            body = np.zeros(stride * h, np.uint8)
            need = stride * (h - 1) + (w * depth + 7) // 8
            body[:need] = _raw(data, offset, need, "SUN")
            rows = body.reshape(h, stride)
        if depth < 8:
            v = unpack_bits(rows, w, depth)
            if depth == 1:
                return np.where(v > 0, 0, 255).astype(np.uint8), "1", None
            return (v if mode == "P" else v * np.uint8(17)), mode, palette
        if depth == 8:
            return rows[:, :w], mode, palette
        px = rows[:, : w * depth // 8].reshape(h, w, depth // 8)[..., :3]
        return (px if raw.startswith("RGB") else px[..., ::-1]), "RGB", None

    return load


_XBM_HEAD = __import__("re").compile(
    rb"\s*#define[ \t]+.*_width[ \t]+(?P<width>[0-9]+)[\r\n]+"
    rb"#define[ \t]+.*_height[ \t]+(?P<height>[0-9]+)[\r\n]+"
    rb"(?P<hotspot>"
    rb"#define[ \t]+[^_]*_x_hot[ \t]+(?P<xhot>[0-9]+)[\r\n]+"
    rb"#define[ \t]+[^_]*_y_hot[ \t]+(?P<yhot>[0-9]+)[\r\n]+"
    rb")?"
    rb"[\000-\377]*_bits\[]"
)
_HEX = np.zeros(256, np.uint8)
for _i, _ch in enumerate(b"0123456789abcdef"):
    _HEX[_ch] = _i
    _HEX[bytes([_ch]).upper()[0]] = _i


def open_xbm(data: bytes) -> Loader:
    m = _XBM_HEAD.match(data[:512])
    if not m:
        raise SyntaxError("not a XBM file")
    w, h = int(m.group("width")), int(m.group("height"))
    start = m.end()
    _sized("XBM", w, h)

    def load() -> Loaded:
        # Pillow's XbmDecode: after each 'x', the next two characters as hex
        # digits (any other character counts 0), then on to the next 'x'
        stride = (w + 7) // 8
        need = stride * h
        out = np.zeros(need, np.uint8)
        pos, k, body = start, 0, data
        while k < need:
            x = body.find(b"x", pos)
            if x < 0 or x + 3 > len(body):
                raise _truncated("XBM")
            out[k] = (_HEX[body[x + 1]] << 4) + _HEX[body[x + 2]]
            k += 1
            pos = x + 3
        bits = np.unpackbits(out.reshape(h, stride), axis=1, bitorder="little")[:, :w]
        return bits * np.uint8(255), "1", None

    return load


_XPM_HEAD = __import__("re").compile(b'"([0-9]*) ([0-9]*) ([0-9]*) ([0-9]*)')


def open_xpm(data: bytes) -> Loader:
    fp = io.BytesIO(data)
    if fp.read(9) != b"/* XPM */":
        raise SyntaxError("not an XPM file")
    while True:
        line = fp.readline()
        if not line:
            raise SyntaxError("broken XPM file")
        m = _XPM_HEAD.match(line)
        if m:
            break
    w, h = int(m.group(1)), int(m.group(2))
    n_colors, bpp = int(m.group(3)), int(m.group(4))
    palette: dict[bytes, tuple[int, int, int]] = {}
    for _ in range(n_colors):
        line = fp.readline().rstrip()
        c = line[1:bpp + 1]
        s = line[bpp + 1:-2].split()
        for i in range(0, len(s), 2):
            if s[i] == b"c":
                rgb = s[i + 1]
                if rgb == b"None":
                    pass
                elif rgb.startswith(b"#"):
                    v = int(rgb[1:], 16)
                    palette[c] = ((v >> 16) & 255, (v >> 8) & 255, v & 255)
                else:
                    raise ValueError("XPM colours other than #rrggbb and None are not read (nor by Pillow)")
                break
        else:
            raise ValueError("XPM colours other than #rrggbb and None are not read (nor by Pillow)")
    start = fp.tell()
    _sized("XPM", w, h)

    def load() -> Loaded:
        keys = list(palette)
        table = np.array(list(palette.values()), np.uint8).reshape(-1, 3)
        idx: list[int] = []
        pixel_header = False
        body = io.BytesIO(data[start:])
        while len(idx) < w * h:
            line = body.readline()
            if not line:
                break
            if line.rstrip() == b"/* pixels */" and not pixel_header:
                pixel_header = True
                continue
            line = b'"'.join(line.split(b'"')[1:-1])
            for i in range(0, len(line), bpp):
                key = line[i:i + bpp]
                if key not in palette:
                    raise ValueError(f"corrupt XPM: a pixel {key!r} not in the palette")
                idx.append(keys.index(key))
        if len(idx) < w * h:
            raise _truncated("XPM")
        v = np.array(idx[: w * h], np.int64).reshape(h, w)
        if n_colors > 256:
            return table[v], "RGB", None
        return v.astype(np.uint8), "P", table

    return load


def open_msp(data: bytes) -> Loader:
    s = data[:32]
    if s[:4] not in (b"DanM", b"LinS"):
        raise SyntaxError("not an MSP file")
    checksum = 0
    for i in range(0, 32, 2):
        checksum ^= i16(s, i)
    if checksum:
        raise SyntaxError("bad MSP checksum")
    w, h = i16(s, 4), i16(s, 6)
    _sized("MSP", w, h)
    stride = (w + 7) // 8

    def load() -> Loaded:
        if s[:4] == b"DanM":
            rows = _raw(data, 32, stride * h, "MSP").reshape(h, stride)
        else:  # Pillow's MspDecoder: a row map, then each row's runs
            if len(data) < 32 + 2 * h:
                raise ValueError("truncated MSP: the row map ends early")
            rowmap = struct.unpack_from(f"<{h}H", data, 32)
            pos, out = 32 + 2 * h, bytearray()
            for y, n in enumerate(rowmap):
                if n == 0:
                    out += b"\xff" * stride
                    continue
                row = data[pos:pos + n]
                pos += n
                if len(row) != n:
                    raise ValueError(f"truncated MSP: row {y} ends early")
                i = 0
                while i < n:
                    kind = row[i]
                    i += 1
                    if kind == 0:
                        if i + 2 > n:
                            raise ValueError(f"corrupt MSP: row {y}")
                        out += row[i + 1:i + 2] * row[i]
                        i += 2
                    else:
                        out += row[i:i + kind]
                        i += kind
            if len(out) < stride * h:
                raise _truncated("MSP")
            rows = np.frombuffer(bytes(out[: stride * h]), np.uint8).reshape(h, stride)
        return unpack_bits(rows, w, 1) * np.uint8(255), "1", None

    return load


def open_fits(data: bytes) -> Loader:
    fp = io.BytesIO(data)
    headers: dict[bytes, bytes] = {}
    in_header, found = False, None
    while True:
        card = fp.read(80)
        if not card:
            raise ValueError("truncated FITS file")
        key = card[:8].strip()
        if key in (b"SIMPLE", b"XTENSION"):
            in_header = True
        elif headers and not in_header:
            break
        elif key == b"END":
            fp.seek(math.ceil(fp.tell() / 2880) * 2880)
            if not found:
                found = _fits_layout(headers)
            in_header = False
            continue
        if found:
            continue
        value = card[8:].split(b"/")[0].strip()
        if value.startswith(b"="):
            value = value[1:].strip()
        if not headers and (not key.startswith(b"SIMPLE") or value != b"T"):
            raise SyntaxError("Not a FITS file")
        headers[key] = value
    if not found or not found[0]:
        raise ValueError("FITS with no image data")
    decoder, offset, (w, h), mode, bits = found
    if mode is None:
        raise SyntaxError("not identified by this opener")
    offset += fp.tell() - 80
    _sized("FITS", w, h)

    def load() -> Loaded:
        size = {"L": 1, "I;16": 2, "I": 4, "F": 4}[mode]
        if decoder == "raw":
            body = _raw(data, offset, w * h * size, "FITS")
        else:  # Pillow's FitsGzipDecoder: the low bytes of each 4-byte sample, rows reversed
            import gzip

            try:
                value = gzip.decompress(data[offset:])
            except (OSError, EOFError) as e:
                raise ValueError(f"corrupt FITS: {e}") from None
            nb = min(bits // 8, 4)
            four = np.zeros(w * h * 4, np.uint8)
            four[: min(four.size, len(value))] = np.frombuffer(value[: four.size], np.uint8)
            body = four.reshape(h, w, 4)[::-1, :, 4 - nb:].reshape(-1)
            if body.size < w * h * size:
                raise _truncated("FITS")
            body = body[: w * h * size]
        v = body.view({"L": np.uint8, "I;16": "<u2", "I": "<i4", "F": "<f4"}[mode]).reshape(h, w)
        if decoder == "raw":
            v = v[::-1]
        return v, mode, None

    return load


def _fits_layout(headers: dict[bytes, bytes]):
    """FitsImageFile._parse_headers → (decoder, offset, size, mode, bits)."""
    prefix, decoder, offset = b"", "raw", 0
    if headers.get(b"XTENSION") == b"'BINTABLE'" and headers.get(b"ZIMAGE") == b"T" \
            and headers[b"ZCMPTYPE"] == b"'GZIP_1  '":
        size0 = _fits_size(headers, prefix) or (0, 0)
        offset = size0[0] * size0[1] * (int(headers[b"BITPIX"]) // 8)
        prefix, decoder = b"Z", "fits_gzip"
    size = _fits_size(headers, prefix)
    if not size:
        return ("", 0, (0, 0), None, 0)
    bits = int(headers[prefix + b"BITPIX"])
    mode = {8: "L", 16: "I;16", 32: "I", -32: "F", -64: "F"}.get(bits)
    return (decoder, offset, size, mode, bits)


def _fits_size(headers: dict[bytes, bytes], prefix: bytes):
    naxis = int(headers[prefix + b"NAXIS"])
    if naxis == 0:
        return None
    if naxis == 1:
        return 1, int(headers[prefix + b"NAXIS1"])
    return int(headers[prefix + b"NAXIS1"]), int(headers[prefix + b"NAXIS2"])


def _spider_int(f: float) -> bool:
    try:
        return f - int(f) == 0
    except (ValueError, OverflowError):
        return False


def _spider_header(t: tuple) -> int:
    h = (99, *t)
    if not all(_spider_int(h[i]) for i in (1, 2, 5, 12, 13, 22, 23)):
        return 0
    if int(h[5]) not in (1, 3, -11, -12, -21, -22):
        return 0
    labrec, labbyt, lenbyt = int(h[13]), int(h[22]), int(h[23])
    return labbyt if labbyt == labrec * lenbyt else 0


def open_spider(data: bytes) -> Loader:
    f = data[:108]
    try:
        big, t = True, struct.unpack(">27f", f)
        hdrlen = _spider_header(t)
        if not hdrlen:
            big, t = False, struct.unpack("<27f", f)
            hdrlen = _spider_header(t)
        if not hdrlen:
            raise SyntaxError("not a valid Spider file")
    except struct.error:
        raise SyntaxError("not a valid Spider file") from None
    h = (99, *t)
    if int(h[5]) != 1:
        raise SyntaxError("not a Spider 2D image")
    w, ht = int(h[12]), int(h[2])
    istack, imgnumber = int(h[24]), int(h[27])
    if istack == 0 and imgnumber == 0:
        offset = hdrlen
    elif istack > 0 and imgnumber == 0:
        offset = hdrlen * 2
    elif istack == 0 and imgnumber > 0:
        raise ValueError("SPIDER stack images with an image number are not read (Pillow fails on them too)")
    else:
        raise SyntaxError("inconsistent stack header values")
    _sized("SPIDER", w, ht)

    def load() -> Loaded:
        v = _raw(data, offset, 4 * w * ht, "SPIDER").view(">f4" if big else "<f4").reshape(ht, w)
        return v, "F", None

    return load


def open_gbr(data: bytes) -> Loader:
    fp = io.BytesIO(data)
    header_size = i32be(fp.read(4))
    if header_size < 20:
        raise SyntaxError("not a GIMP brush")
    version = i32be(fp.read(4))
    if version not in (1, 2):
        raise SyntaxError(f"Unsupported GIMP brush version: {version}")
    w, h, depth = i32be(fp.read(4)), i32be(fp.read(4)), i32be(fp.read(4))
    if w == 0 or h == 0:
        raise SyntaxError("not a GIMP brush")
    if depth not in (1, 4):
        raise SyntaxError(f"Unsupported GIMP brush color depth: {depth}")
    if version == 1:
        comment = header_size - 20
    else:
        comment = header_size - 28
        if fp.read(4) != b"GIMP":
            raise SyntaxError("not a GIMP brush, bad magic number")
        i32be(fp.read(4))
    fp.read(comment)
    start = fp.tell()
    check_pixels("GBR", w, h)
    _sized("GBR", w, h)

    def load() -> Loaded:
        v = _raw(data, start, w * h * depth, "GBR").reshape(h, w, depth)
        return (v[..., 0], "L", None) if depth == 1 else (v, "RGBA", None)

    return load


def open_pixar(data: bytes) -> Loader:
    s = data[:512]
    if s[:4] != b"\x80\xe8\x00\x00":
        raise SyntaxError("not a PIXAR file")
    w, h = i16(s, 418), i16(s, 416)
    if (i16(s, 424), i16(s, 426)) != (14, 2):
        raise SyntaxError("not identified by this opener")
    _sized("PIXAR", w, h)
    return lambda: (_raw(data, 1024, w * h * 3, "PIXAR").reshape(h, w, 3), "RGB", None)


def open_mcidas(data: bytes) -> Loader:
    s = data[:256]
    if s[:8] != b"\x00\x00\x00\x00\x00\x00\x00\x04" or len(s) != 256:
        raise SyntaxError("not an McIdas area file")
    d = (0, *struct.unpack("!64i", s))
    if d[11] not in (1, 2, 4):
        raise SyntaxError("unsupported McIdas format")
    nb = d[11]
    w, h = d[10], d[9]
    offset, stride = d[34] + d[15], d[15] + d[10] * d[11] * d[14]
    _sized("MCIDAS", w, h)

    def load() -> Loaded:
        rows = []
        for y in range(h):
            rows.append(_raw(data, offset + y * stride, w * nb, "MCIDAS"))
        v = np.stack(rows).view({1: np.uint8, 2: ">u2", 4: ">i4"}[nb])
        return v.astype(np.int64) if nb > 1 else v, {1: "L", 2: "I;16", 4: "I"}[nb], None

    return load


_IMT_FIELD = __import__("re").compile(rb"([a-z]*) ([^ \r\n]*)")


def open_imt(data: bytes) -> Loader:
    fp = io.BytesIO(data)
    buffer = fp.read(100)
    if b"\n" not in buffer:
        raise SyntaxError("not an IM file")
    w = h = 0
    mode, start = None, None
    while True:
        if buffer:
            c, buffer = buffer[:1], buffer[1:]
        else:
            c = fp.read(1)
        if not c:
            break
        if c == b"\x0c":
            start = fp.tell() - len(buffer)
            break
        if b"\n" not in buffer:
            buffer += fp.read(100)
        lines = buffer.split(b"\n")
        c += lines.pop(0)
        buffer = b"\n".join(lines)
        if len(c) == 1 or len(c) > 100:
            break
        if c[0] == ord(b"*"):
            continue
        m = _IMT_FIELD.match(c)
        if not m:
            break
        k, v = m.group(1, 2)
        if k == b"width":
            w = int(v)
        elif k == b"height":
            h = int(v)
        elif k == b"pixel" and v == b"n8":
            mode = "L"
    if mode is None:
        raise SyntaxError("not identified by this opener")
    _sized("IMT", w, h)

    def load() -> Loaded:
        if start is None:
            raise ValueError("IMT without its image data is not read (nor by Pillow)")
        return _raw(data, start, w * h, "IMT").reshape(h, w), "L", None

    return load


def open_xvthumb(data: bytes) -> Loader:
    fp = io.BytesIO(data)
    if fp.read(6) != b"P7 332":
        raise SyntaxError("not an XV thumbnail file")
    fp.readline()
    while True:
        s = fp.readline()
        if not s:
            raise SyntaxError("Unexpected EOF reading XV thumbnail file")
        if s[0] != 35:
            break
    w, h = (int(v) for v in s.strip().split(maxsplit=2)[:2])
    start = fp.tell()
    _sized("XVThumb", w, h)
    r, g, b = np.meshgrid(np.arange(8), np.arange(8), np.arange(4), indexing="ij")
    palette = np.stack([r * 255 // 7, g * 255 // 7, b * 255 // 3], -1).reshape(256, 3).astype(np.uint8)
    return lambda: (_raw(data, start, w * h, "XVThumb").reshape(h, w), "P", palette)


def open_ftex(data: bytes) -> Loader:
    fp = io.BytesIO(data)
    if fp.read(4) != b"FTEX":
        raise SyntaxError("not an FTEX file")
    struct.unpack("<i", fp.read(4))
    w, h = struct.unpack("<2i", fp.read(8))
    _, n_formats = struct.unpack("<2i", fp.read(8))
    if n_formats != 1:
        raise ValueError("FTEX with more than one format is not read (nor by Pillow)")
    fmt, where = struct.unpack("<2i", fp.read(8))
    fp.seek(where)
    (size,) = struct.unpack("<i", fp.read(4))
    body = fp.read(size) if size >= 0 else fp.read()
    if fmt not in (0, 1):
        raise ValueError(f"FTEX texture format {fmt} is not read (nor by Pillow)")
    _sized("FTEX", w, h)

    def load() -> Loaded:
        if fmt == 1:
            return _raw(body, 0, w * h * 3, "FTEX").reshape(h, w, 3), "RGB", None
        out = np.empty((h, w, 4), np.uint8)
        _c(_build.raster_library().mmtrs_bcn_decode(body, len(body), w, h, 1, 0, out.ctypes.data), "FTEX")
        return out, "RGBA", None

    return load


_IM_OPEN = {"0 1 image": ("1", "1"), "L 1 image": ("1", "1"), "Greyscale image": ("L", "L"),
            "Grayscale image": ("L", "L"), "RGB image": ("RGB", "RGB;L"), "RLB image": ("RGB", "RLB"),
            "RYB image": ("RGB", "RLB"), "B1 image": ("1", "1"), "B2 image": ("P", "P;2"), "B4 image": ("P", "P;4"),
            "X 24 image": ("RGB", "RGB"), "L 32 S image": ("I", "I;32"), "L 32 F image": ("F", "F;32"),
            "RGB3 image": ("RGB", "RGB;T"), "RYB3 image": ("RGB", "RYB;T"), "LA image": ("LA", "LA;L"),
            "PA image": ("LA", "PA;L"), "RGBA image": ("RGBA", "RGBA;L"), "RGBX image": ("RGB", "RGBX;L"),
            "CMYK image": ("CMYK", "CMYK;L"), "YCC image": ("YCbCr", "YCbCr;L")}
for _b in ("8", "8S", "16", "16S", "32", "32F"):
    _IM_OPEN[f"L {_b} image"] = _IM_OPEN[f"L*{_b} image"] = ("F", f"F;{_b}")
for _b in ("16", "16L", "16B"):
    _IM_OPEN[f"L {_b} image"] = _IM_OPEN[f"L*{_b} image"] = (f"I;{_b}", f"I;{_b}")
_IM_OPEN["L 32S image"] = _IM_OPEN["L*32S image"] = ("I", "I;32S")
for _b in range(2, 33):
    _IM_OPEN[f"L*{_b} image"] = ("F", f"F;{_b}")
_IM_SPLIT = __import__("re").compile(rb"^([A-Za-z][^:]*):[ \t]*(.*)[ \t]*$")
_IM_TAGS = ("Comment", "Date", "Digitalization equipment", "File size (no of images)", "Lut", "Name", "Scale (x,y)",
            "Image size (x*y)", "Image type")
# the raw modes read here: bands stored line by line ("L" suffix: each row
# holds every band's line in turn), or interleaved
_IM_RAW = {"1": ("1", 1), "L": ("L", 1), "P;2": None, "P;4": None, "RGB;L": ("RGB", 3), "RGB": ("RGB", 3),
           "RGBA;L": ("RGBA", 4), "RGBX;L": ("RGB", 4), "CMYK;L": ("CMYK", 4), "LA;L": ("L", 2),
           "YCbCr;L": ("YCbCr", 3)}


def _im_number(v: str):
    try:
        return int(v)
    except ValueError:
        return float(v)


def open_im(data: bytes) -> Loader:
    fp = io.BytesIO(data)
    if b"\n" not in fp.read(100):
        raise SyntaxError("not an IM file")
    fp.seek(0)
    info: dict = {"Image type": "L", "Image size (x*y)": (512, 512)}
    rawmode, n = "L", 0
    while True:
        s = fp.read(1)
        if s == b"\r":
            continue
        if not s or s == b"\0" or s == b"\x1a":
            break
        s = s + fp.readline()
        if len(s) > 100:
            raise SyntaxError("not an IM file")
        if s.endswith(b"\r\n"):
            s = s[:-2]
        elif s.endswith(b"\n"):
            s = s[:-1]
        m = _IM_SPLIT.match(s)
        if not m:
            raise SyntaxError("Syntax error in IM header")
        k, v = (g.decode("latin-1", "replace") for g in m.group(1, 2))
        if k in ("File size (no of images)", "Scale (x,y)", "Image size (x*y)"):
            v = tuple(map(_im_number, v.replace("*", ",").split(",")))
            if len(v) == 1:
                v = v[0]
        elif k == "Image type" and v in _IM_OPEN:
            v, rawmode = _IM_OPEN[v]
        info[k] = v
        if k in _IM_TAGS:
            n += 1
    if not n:
        raise SyntaxError("Not an IM file")
    size, mode = info["Image size (x*y)"], info["Image type"]
    while s and not s.startswith(b"\x1a"):
        s = fp.read(1)
    if not s:
        raise SyntaxError("File truncated")
    palette = None
    if "Lut" in info:
        lut = fp.read(768)
        gray = all(lut[i] == lut[i + 256] == lut[i + 512] for i in range(256))
        if mode in ("L", "LA", "P", "PA") and not gray:
            if mode in ("L", "P"):
                mode = rawmode = "P"
            else:
                mode, rawmode = "PA", "PA;L"
            palette = np.frombuffer(lut, np.uint8).reshape(3, 256).T
    offset = fp.tell()
    w, h = size if isinstance(size, tuple) and len(size) == 2 else (0, 0)
    if not isinstance(w, int) or not isinstance(h, int) or not isinstance(mode, str) or not mode:
        raise SyntaxError("not identified by this opener")
    _sized("IM", w, h)
    if rawmode not in _IM_RAW and rawmode not in ("P", "PA;L"):
        raise ValueError(f"IM images of raw mode {rawmode} are not supported by the port's codec")

    def load() -> Loaded:
        if rawmode == "1":
            stride = (w + 7) // 8
            rows = _raw(data, offset, stride * h, "IM").reshape(h, stride)[::-1]
            return unpack_bits(rows, w, 1) * np.uint8(255), "1", None
        if rawmode in ("P", "L"):
            return _raw(data, offset, w * h, "IM").reshape(h, w)[::-1], mode, palette
        if rawmode in ("P;2", "P;4"):
            d = int(rawmode[-1])
            stride = (w * d + 7) // 8
            return unpack_bits(_raw(data, offset, stride * h, "IM").reshape(h, stride), w, d)[::-1], "P", palette
        if rawmode == "PA;L":
            return _raw(data, offset, 2 * w * h, "IM").reshape(h, 2, w)[::-1, 0], "P", palette
        out_mode, bands = _IM_RAW[rawmode]
        raw = _raw(data, offset, bands * w * h, "IM")
        px = raw.reshape(h, bands, w).transpose(0, 2, 1) if rawmode.endswith(";L") else raw.reshape(h, w, bands)
        return px[::-1], out_mode, None

    return load


def open_iptc(data: bytes) -> Loader:
    fp = io.BytesIO(data)
    info: dict = {}

    def field():
        s = fp.read(5)
        if not s.strip(b"\x00"):
            return None, 0
        tag = s[1], s[2]
        if s[0] != 0x1C or tag[0] not in (1, 2, 3, 4, 5, 6, 7, 8, 9, 240):
            raise SyntaxError("invalid IPTC/NAA file")
        size = s[3]
        if size > 132:
            raise ValueError("corrupt IPTC/NAA: an illegal field length")
        if size == 128:
            size = 0
        elif size > 128:
            size = i32be((b"\0\0\0\0" + fp.read(size - 128))[-4:])
        else:
            size = i16be(s, 3)
        return tag, size

    while True:
        offset = fp.tell()
        tag, size = field()
        if not tag or tag == (8, 10):
            break
        value = fp.read(size) if size else None
        if tag in info:  # a repeated field: Pillow keeps its values in a list
            info[tag] = (info[tag] if isinstance(info[tag], list) else [info[tag]]) + [value]
        else:
            info[tag] = value
    layers, component = info[(3, 60)][0], info[(3, 60)][1]
    as_int = lambda key: i32be((b"\0\0\0\0" + info[key])[-4:])
    w, h = as_int((3, 20)), as_int((3, 30))
    compression = {1: "raw", 5: "jpeg"}.get(as_int((3, 120)))
    if compression is None:
        raise ValueError("IPTC images of an unknown compression are not read (nor by Pillow)")
    mode = "L" if layers == 1 and not component else "RGB" if layers == 3 and component else \
        "CMYK" if layers == 4 and component else None
    if mode is None:
        raise SyntaxError("not identified by this opener")
    # the one layer the data holds, as Pillow's band: component 1 is band 0
    band = None if mode == "L" else info[(3, 65)][0] - 1 if (3, 65) in info else 0
    _sized("IPTC", w, h)

    def body() -> bytes:
        """The 8:10 fields' data joined (a PGM header before raw samples)."""
        if tag != (8, 10):
            raise ValueError("corrupt IPTC/NAA: no image data")
        fp.seek(offset)
        out = bytearray(b"P5\n%d %d\n255\n" % (w, h) if compression == "raw" else b"")
        while True:
            kind, size = field()
            if kind != (8, 10):
                break
            out += fp.read(size)
        return bytes(out)

    def load() -> Loaded:
        from mmtrs_tpu_torch.utils.codec import decode_image

        data = body()
        if band is None:
            return decode_image(data, "cpu").numpy(), "RGB", None
        sub_kind, sub_load = identify(data)
        if sub_load is None or (sub := sub_load())[1] != "L":
            raise ValueError(f"IPTC/NAA: a {mode} layer whose data is not one gray band (Pillow cannot merge it)")
        return iptc_merge(sub[0], mode, band), mode, None

    load.iptc = (body, mode, band, compression)  # codec.decode_image decodes a JPEG body on the caller's device
    return load


def iptc_merge(layer, mode: str, band: int):
    """IptcImagePlugin's merge: the decoded layer (numpy or torch, [H, W])
    as band ``band`` of ``mode`` (RGB or CMYK), the other bands black."""
    if isinstance(layer, np.ndarray):
        px = np.zeros((*layer.shape[:2], len(mode)), np.uint8)
    else:
        import torch

        px = torch.zeros((*layer.shape[:2], len(mode)), dtype=torch.uint8, device=layer.device)
    px[..., band] = layer
    return px


def _blp_dxt(block_rows: list[bytes], kind: int, alpha: bool) -> bytes:
    """BlpImagePlugin's decode_dxt1/3/5 (Python, not the BCn decoder): each
    block row gives its four pixel rows in turn; 565 colours widened by a
    shift alone; the byte stream as Pillow builds it."""
    out = []
    for row in block_rows:
        size = 8 if kind == 1 else 16
        b = np.frombuffer(row[: len(row) // size * size], np.uint8).reshape(-1, size).astype(np.int64)
        cb = b[:, -8:]
        c0, c1 = cb[:, 0] | (cb[:, 1] << 8), cb[:, 2] | (cb[:, 3] << 8)
        code = cb[:, 4] | (cb[:, 5] << 8) | (cb[:, 6] << 16) | (cb[:, 7] << 24)
        rgb0 = np.stack([((c0 >> 11) & 31) << 3, ((c0 >> 5) & 63) << 2, (c0 & 31) << 3], -1)
        rgb1 = np.stack([((c1 >> 11) & 31) << 3, ((c1 >> 5) & 63) << 2, (c1 & 31) << 3], -1)
        gt = (c0 > c1)[:, None] if kind == 1 else np.ones((len(b), 1), bool)
        pal = np.stack([rgb0, rgb1, np.where(gt, (2 * rgb0 + rgb1) // 3, (rgb0 + rgb1) // 2),
                        np.where(gt, (2 * rgb1 + rgb0) // 3, 0)], 1)  # [n, 4, 3]
        n = np.arange(16)
        sel = (code[:, None] >> (2 * n)) & 3  # [n, 16]
        rgb = np.take_along_axis(pal, sel[..., None].repeat(3, -1), 1)  # [n, 16, 3]
        if kind == 1:
            a = np.where((sel == 3) & ~gt, 0, 255)
        elif kind == 2:
            nib = (b[:, n // 2] >> (4 * (n % 2))) & 15
            a = nib * 17
        else:
            a0, a1 = b[:, 0:1], b[:, 1:2]
            code2 = b[:, 2] | (b[:, 3] << 8)
            code1 = b[:, 4] | (b[:, 5] << 8) | (b[:, 6] << 16) | (b[:, 7] << 24)
            idx = 3 * n
            ac = np.where(idx <= 12, (code2[:, None] >> np.minimum(idx, 12)) & 7,
                          np.where(idx == 15, (code2[:, None] >> 15) | ((code1[:, None] << 1) & 6),
                                   (code1[:, None] >> np.maximum(idx - 16, 0)) & 7))
            a = np.where(ac == 0, a0, np.where(ac == 1, a1, np.where(
                a0 > a1, ((8 - ac) * a0 + (ac - 1) * a1) // 7,
                np.where(ac == 6, 0, np.where(ac == 7, 255, ((6 - ac) * a0 + (ac - 1) * a1) // 5)))))
        px = np.concatenate([rgb, a[..., None]], -1) if (alpha or kind != 1) else rgb
        px = px.reshape(len(b), 4, 4, -1).transpose(1, 0, 2, 3)  # [4 rows, blocks, 4, ch]
        out.append(px.astype(np.uint8).tobytes())
    return b"".join(out)


# the frame headers JpegImagePlugin reads with its SOF handler (DHP too)
_JPEG_SOF = frozenset((0xC0, 0xC1, 0xC2, 0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB, 0xCD, 0xCE, 0xCF, 0xDE))


def open_jpeg(data: bytes) -> None:
    """JpegImagePlugin's walk of the markers before the first scan, for the
    refusals of its frame handler: a precision other than 8 bits or a
    component count other than 1, 3 or 4 raise SyntaxError, so no opener
    takes the data. The codec's JPEG decoders read everything else."""
    pos, n = 2, len(data)
    while pos + 4 <= n:
        if data[pos] != 0xFF:
            pos += 1
            continue
        marker = data[pos + 1]
        if marker in (0x00, 0xFF):
            pos += 1 if marker == 0xFF else 2
            continue
        if marker == 0xDA:
            break
        if 0xD0 <= marker <= 0xD9:
            pos += 2
            continue
        length = i16be(data, pos + 2)
        seg = data[pos + 4:pos + 2 + length]
        if marker in _JPEG_SOF and len(seg) >= 6:
            if seg[0] != 8:
                raise SyntaxError(f"cannot handle {seg[0]}-bit layers")
            if seg[5] not in (1, 3, 4):
                raise SyntaxError(f"cannot handle {seg[5]}-layer images")
        pos += 2 + length
    return None


def blp1_jpeg(data: bytes) -> tuple[bytes, int, int, bool] | None:
    """(JPEG stream, w, h, alpha) of a BLP1 file whose image is a JPEG: its
    shared header and first mipmap joined, as BlpImagePlugin joins them.
    None for any other BLP, or where the opener refuses the header or the
    data are short (its loader then raises)."""
    try:
        magic, compression, alpha = data[:4], *struct.unpack("<iI", data[4:12])
        w, h = struct.unpack("<II", data[12:20])
        if magic != b"BLP1" or compression != 0:
            return None
        _sized("BLP", w, h)
        offsets = struct.unpack("<16I", data[28:92])
        lengths = struct.unpack("<16I", data[92:156])
        (size,) = struct.unpack("<I", data[156:160])
    except (struct.error, SyntaxError, ValueError):
        return None
    start = 160 + size
    if len(data) < start or offsets[0] < start or len(data) < offsets[0] + lengths[0]:
        return None
    return data[160:start] + data[offsets[0]:offsets[0] + lengths[0]], w, h, alpha != 0


def open_blp(data: bytes) -> Loader:
    fp = io.BytesIO(data)
    magic = fp.read(4)
    if magic not in (b"BLP1", b"BLP2"):
        raise ValueError(f"corrupt BLP: the magic {magic!r}")
    (compression,) = struct.unpack("<i", fp.read(4))
    if magic == b"BLP1":
        alpha = struct.unpack("<I", fp.read(4))[0] != 0
    else:
        encoding, alpha_b, alpha_encoding = struct.unpack("<bbb", fp.read(3))
        alpha = alpha_b != 0
        fp.read(1)
    w, h = struct.unpack("<II", fp.read(8))
    if magic == b"BLP1":
        (encoding,) = struct.unpack("<i", fp.read(4))
        fp.read(4)
        offset = 28
    else:
        offset = 20
    mode = "RGBA" if alpha else "RGB"
    _sized("BLP", w, h)
    bands = len(mode)

    def raw(stream: bytes) -> Loaded:
        if len(stream) < w * h * bands:
            raise ValueError("truncated BLP: not enough image data")
        return np.frombuffer(stream, np.uint8, count=w * h * bands).reshape(h, w, bands), mode, None

    def load() -> Loaded:
        body = io.BytesIO(data)
        body.seek(offset)

        def read(n: int) -> bytes:
            got = body.read(n)
            if len(got) < n:
                raise ValueError("truncated BLP file")
            return got

        offsets = struct.unpack("<16I", read(64))
        lengths = struct.unpack("<16I", read(64))

        def palette() -> np.ndarray:
            pal = body.read(1024)
            return np.frombuffer(pal[: len(pal) // 4 * 4], np.uint8).reshape(-1, 4)

        def bgra(pal: np.ndarray) -> bytes:
            idx = np.frombuffer(read(lengths[0]), np.uint8)
            if idx.size and idx.max() >= len(pal):
                raise ValueError("corrupt BLP: a palette index past the palette")
            px = pal[idx][:, [2, 1, 0, 3] if alpha else [2, 1, 0]]
            return px.tobytes()

        if magic == b"BLP1":
            if compression == 0:  # on the host here; decode_image decodes it on its device
                import torch

                from mmtrs_tpu_torch.utils.codec import decode_blp_jpeg

                (size,) = struct.unpack("<I", read(4))
                header = read(size)
                read(offsets[0] - body.tell())
                stream = header + read(lengths[0])
                return decode_blp_jpeg(stream, w, h, alpha, torch.device("cpu")).numpy(), mode, None
            if compression == 1 and encoding in (4, 5):
                return raw(bgra(palette()))
            raise ValueError(f"BLP1 compression {compression}, encoding {encoding} is not read (nor by Pillow)")
        pal = palette()
        body.seek(offsets[0])
        if compression != 1:
            raise ValueError(f"BLP2 compression {compression} is not read (nor by Pillow)")
        if encoding == 1:
            return raw(bgra(pal))
        if encoding != 2 or alpha_encoding not in (0, 1, 7):
            raise ValueError(f"BLP2 encoding {encoding}, alpha {alpha_encoding} is not read (nor by Pillow)")
        kind = {0: 1, 1: 2, 7: 3}[alpha_encoding]
        line = (w + 3) // 4 * (8 if kind == 1 else 16)
        rows = [read(line) for _ in range((h + 3) // 4)]
        return raw(_blp_dxt(rows, kind, alpha))

    return load


_ICNS_SIZES = {  # (w, h, scale) → its resources, in Pillow's order
    (512, 512, 2): (b"ic10",), (512, 512, 1): (b"ic09",), (256, 256, 2): (b"ic14",), (256, 256, 1): (b"ic08",),
    (128, 128, 2): (b"ic13",), (128, 128, 1): (b"ic07", b"it32", b"t8mk"), (64, 64, 1): (b"icp6",),
    (32, 32, 2): (b"ic12",), (48, 48, 1): (b"ih32", b"h8mk"), (32, 32, 1): (b"icp5", b"il32", b"l8mk"),
    (16, 16, 2): (b"ic11",), (16, 16, 1): (b"icp4", b"is32", b"s8mk"),
}


def open_icns(data: bytes) -> Loader:
    fp = io.BytesIO(data)
    sig, filesize = struct.unpack(">4sI", fp.read(8))
    if sig != b"icns":
        raise SyntaxError("not an icns file")
    dct, i = {}, 8
    while i < filesize:
        sig, block = struct.unpack(">4sI", fp.read(8))
        if block <= 0:
            raise SyntaxError("invalid block header")
        i += 8
        block -= 8
        dct[sig] = (i, block)
        fp.seek(block, io.SEEK_CUR)
        i += block
    sizes = [size for size, codes in _ICNS_SIZES.items() if any(c in dct for c in codes)]
    if not sizes:
        raise SyntaxError("No 32bit icon resources found")
    best = max(sizes)
    _sized("ICNS", best[0] * best[2], best[1] * best[2])

    def load() -> Loaded:
        px = None
        for code in _ICNS_SIZES[best]:
            if code not in dct or code.endswith(b"mk"):
                continue
            start, length = dct[code]
            if code in (b"it32", b"ih32", b"il32", b"is32"):
                if code == b"it32":
                    if data[start:start + 4] != b"\0\0\0\0":
                        raise ValueError("corrupt ICNS: an it32 resource without its zero signature")
                    start, length = start + 4, length - 4
                px = _icns_rgb(data, start, length, best[0] * best[2], best[1] * best[2])
                continue
            sig = data[start:start + 12]
            if sig.startswith(b"\x89PNG\r\n\x1a\n"):
                return _decode_png(data[start:]), "RGB", None  # an RGBA image wins over the RGB channels
            if sig.startswith((b"\xff\x4f\xff\x51", b"\x0d\x0a\x87\x0a")) or sig == b"\0\0\0\x0cjP  \r\n\x87\n":
                # IcnsImagePlugin: the entry opened as a JPEG 2000 file and converted to RGBA
                loaded = open_jpeg2000(data[start:start + length])()
                if loaded[1] == "I;16":
                    raise ValueError("ICNS entries in 16-bit JPEG 2000 are not decoded (nor by Pillow, which cannot "
                                     "convert I;16 to RGBA)")
                return loaded
            raise ValueError("corrupt ICNS: an unsupported icon subimage format (nor read by Pillow)")
        if px is None:
            raise ValueError("corrupt ICNS: no RGB resource at the best size")
        return px, "RGB", None

    return load


def _icns_rgb(data: bytes, start: int, length: int, w: int, h: int) -> np.ndarray:
    """IcnsImagePlugin.read_32: raw RGB, or per band a PackBits-like code
    (a byte ≥ 0x80: byte − 125 copies of the next; else byte + 1 literals)."""
    n = w * h
    if length == n * 3:
        raw = data[start:start + length]
        if len(raw) < length:
            raise _truncated("ICNS")
        return np.frombuffer(raw, np.uint8).reshape(h, w, 3)
    pos, planes = start, []
    for _ in range(3):
        out, left = bytearray(), n
        while left > 0:
            if pos >= len(data):
                break
            b = data[pos]
            pos += 1
            if b & 0x80:
                k = b - 125
                out += data[pos:pos + 1] * k
                pos += 1
            else:
                k = b + 1
                out += data[pos:pos + k]
                pos += k
            left -= k
        if left != 0:
            raise ValueError(f"corrupt ICNS: a channel with {left} bytes left")
        if len(out) < n:
            raise _truncated("ICNS")
        planes.append(np.frombuffer(bytes(out[:n]), np.uint8).reshape(h, w))
    return np.stack(planes, -1)


def open_fli(data: bytes) -> Loader:
    s = data[:128]
    if not (len(s) >= 16 and i16(s, 4) in (0xAF11, 0xAF12) and i16(s, 14) in (0, 3)
            and s[20:22] == b"\0\0" and s[42:80] == bytes(38) and s[88:] == bytes(40)):
        raise SyntaxError("not an FLI/FLC file")
    w, h = i16(s, 8), i16(s, 10)
    palette = np.repeat(np.arange(256, dtype=np.int64)[:, None], 3, 1)
    fp = io.BytesIO(data)
    fp.seek(128)
    c = fp.read(16)
    at = 128
    if i16(c, 4) == 0xF100:  # a prefix chunk: the frames follow it
        at = 128 + i32(c)
        fp.seek(at)
        c = fp.read(16)
    if i16(c, 4) == 0xF1FA:
        size = None
        for _ in range(i16(c, 6)):
            if size is not None:
                fp.seek(size - 6, io.SEEK_CUR)
            head = fp.read(6)
            kind = i16(head, 4)
            if kind in (4, 11):
                shift, k = (2 if kind == 11 else 0), 0
                for _ in range(i16(fp.read(2))):
                    e = fp.read(2)
                    k += e[0]
                    count = e[1] or 256
                    rgb = fp.read(count * 3)
                    for j in range(0, len(rgb), 3):
                        # Pillow's o8 keeps the low byte of a 6-bit entry shifted past 255
                        palette[k] = [(rgb[j] << shift) & 255, (rgb[j + 1] << shift) & 255, (rgb[j + 2] << shift) & 255]
                        k += 1
                break
            size = i32(head)
            if not size:
                break
    _sized("FLI", w, h)
    pal = palette.astype(np.uint8)

    def load() -> Loaded:
        return _fli_frame(data, w, h), "P", pal

    return load


_FLI_STATUS = {1: "a packet or row past the data or the image", 2: "not a frame chunk, or an unknown chunk",
               3: "a chunk of size 0"}


def _fli_frame(data: bytes, w: int, h: int) -> np.ndarray:
    """The first frame as Pillow reads it: its tile starts at byte 128
    whatever a prefix chunk says (so a file with one fails, as in Pillow),
    its reader holds one frame size of bytes (a byte short of an even size
    will do, as FliDecode allows a pad byte), and FliDecode's chunks (BLACK,
    BRUN, COPY and the deltas LC and SS2) apply to a black buffer, in
    ``csrc/host/rasters.cpp``."""
    from mmtrs_tpu_torch import _build

    if len(data) < 128 + 4:
        raise _truncated("FLI")
    size = i32(data, 128)
    size = size - (1 << 32) if size >= 1 << 31 else size
    buf = data[128:] if size < 0 else data[128:128 + size]
    if not buf or len(buf) + len(buf) % 2 < size or len(buf) < 4:
        raise _truncated("FLI")
    img = np.zeros((h, w), np.uint8)
    status = _build.raster_library().mmtrs_fli_frame(buf, len(buf), w, h, img.ctypes.data)
    if status == 4:
        raise _truncated("FLI")
    if status:
        raise ValueError(f"corrupt FLI: {_FLI_STATUS[status]}")
    return img


def open_pcd(data: bytes) -> Loader:
    """PhotoCD as Pillow's PcdImagePlugin reads it: the 768 × 512 base image
    at 96 sectors, PhotoYCC → RGB in ``csrc/host/rasters.cpp``, then turned
    by the orientation bits at byte 1538 of the second sector (1: 90°
    counter-clockwise, 3: 270°), as Pillow's ``load_end`` rotates it."""
    if not data[2048:2048 + 1539].startswith(b"PCD_"):
        raise SyntaxError("not a PCD file")
    orientation = data[2048 + 1538] & 3  # IndexError on a short file, as Pillow's s[1538]

    def load() -> Loaded:
        from mmtrs_tpu_torch import _build

        src = data[96 * 2048:]
        rgb = np.empty((512, 768, 3), np.uint8)
        if _build.raster_library().mmtrs_pcd_decode(src, len(src), rgb.ctypes.data):
            raise _truncated("PCD")
        turns = {1: 1, 3: 3}.get(orientation, 0)
        return (np.rot90(rgb, turns) if turns else rgb), "RGB", None

    return load


# ---------------------------------------------------------------------------
# JPEG 2000 (Jpeg2KImagePlugin, Jpeg2KDecode.c over OpenJPEG 2.5.4)
# ---------------------------------------------------------------------------

_J2K_MAGIC = b"\xff\x4f\xff\x51"
_JP2_MAGIC = b"\x00\x00\x00\x0cjP  \r\n\x87\n"
# OpenJPEG's colour spaces, as opj_jp2_read_header sets them from colr's EnumCS
_CS_UNSPECIFIED, _CS_SRGB, _CS_GRAY, _CS_SYCC, _CS_EYCC, _CS_CMYK, _CS_UNKNOWN = 0, 1, 2, 3, 4, 5, -1
_ENUMCS = {16: _CS_SRGB, 17: _CS_GRAY, 18: _CS_SYCC, 24: _CS_EYCC, 12: _CS_CMYK}
# Jpeg2KDecode.c's j2k_unpackers: (mode, colour space, components) → unpacker
_J2K_UNPACKERS = {
    ("L", _CS_GRAY, 1): "gray", ("P", _CS_SRGB, 1): "gray", ("PA", _CS_SRGB, 2): "graya",
    ("I;16", _CS_GRAY, 1): "gray_i", ("LA", _CS_GRAY, 2): "graya", ("RGB", _CS_GRAY, 1): "gray",
    ("RGB", _CS_GRAY, 2): "gray", ("RGB", _CS_SRGB, 3): "srgb", ("RGB", _CS_SYCC, 3): "sycc",
    ("RGB", _CS_SRGB, 4): "srgb", ("RGB", _CS_SYCC, 4): "sycc", ("RGBA", _CS_GRAY, 1): "gray",
    ("RGBA", _CS_GRAY, 2): "graya", ("RGBA", _CS_SRGB, 3): "srgb", ("RGBA", _CS_SYCC, 3): "sycc",
    ("RGBA", _CS_SRGB, 4): "srgb", ("RGBA", _CS_SYCC, 4): "sycc", ("CMYK", _CS_CMYK, 4): "srgb",
}


class _BoxReader:
    """Jpeg2KImagePlugin.BoxReader: fields and sub-boxes of the JP2 header."""

    def __init__(self, fp: io.BytesIO, length: int = -1):
        self.fp, self.has_length, self.length, self.remaining = fp, length >= 0, length, -1

    def _can_read(self, n: int) -> bool:
        if self.has_length and self.fp.tell() + n > self.length:
            return False
        return n <= self.remaining if self.remaining >= 0 else True

    def _read(self, n: int) -> bytes:
        if not self._can_read(n):
            raise SyntaxError("Not enough data in header")
        data = self.fp.read(n)
        if len(data) < n:
            raise ValueError(f"corrupt JPEG 2000: a header box ends early (Pillow: expected to read {n} bytes but "
                             f"only got {len(data)})")
        if self.remaining > 0:
            self.remaining -= n
        return data

    def fields(self, fmt: str) -> tuple:
        return struct.unpack(fmt, self._read(struct.calcsize(fmt)))

    def boxes(self) -> "_BoxReader":
        n = self.remaining
        return _BoxReader(io.BytesIO(self._read(n)), n)

    def has_next(self) -> bool:
        return self.fp.tell() + self.remaining < self.length if self.has_length else True

    def next_type(self) -> bytes:
        if self.remaining > 0:
            self.fp.seek(self.remaining, io.SEEK_CUR)
        self.remaining = -1
        lbox, tbox = self.fields(">I4s")
        hlen = 8
        if lbox == 1:
            lbox, hlen = self.fields(">Q")[0], 16
        if lbox < hlen or not self._can_read(lbox - hlen):
            raise SyntaxError("Invalid header length")
        self.remaining = lbox - hlen
        return tbox


def _j2k_size_mode(fp: io.BytesIO) -> tuple[tuple[int, int], str]:
    """Jpeg2KImagePlugin._parse_codestream (after SOC and the SIZ marker)."""
    hdr = fp.read(2)
    lsiz = struct.unpack(">H", hdr)[0]
    siz = hdr + fp.read(lsiz - 2)
    _, _, xsiz, ysiz, xosiz, yosiz, _, _, _, _, csiz = struct.unpack_from(">HHIIIIIIIIH", siz)
    size = (xsiz - xosiz, ysiz - yosiz)
    if csiz == 1:
        mode = "I;16" if (struct.unpack_from(">B", siz, 38)[0] & 0x7F) + 1 > 8 else "L"
    elif csiz in (2, 3, 4):
        mode = {2: "LA", 3: "RGB", 4: "RGBA"}[csiz]
    else:
        raise SyntaxError("unable to determine J2K image mode")
    return size, mode


def _jp2_header(fp: io.BytesIO) -> tuple[tuple[int, int], str, np.ndarray | None]:
    """Jpeg2KImagePlugin._parse_jp2_header: size, mode and palette (P and PA
    from a pclr box, its colours added as ImagePalette.getcolor adds them)."""
    reader, header = _BoxReader(fp), None
    while reader.has_next():
        if reader.next_type() == b"jp2h":
            header = reader.boxes()
            break
    if header is None:
        raise ValueError("corrupt JPEG 2000: no jp2h box (Pillow's assertion fails)")
    size = mode = nc = None
    palette = None
    while header.has_next():
        tbox = header.next_type()
        if tbox == b"ihdr":
            height, width, nc, bpc = header.fields(">IIHB")
            size = (width, height)
            if nc == 1 and (bpc & 0x7F) > 8:
                mode = "I;16"
            else:
                mode = {1: "L", 2: "LA", 3: "RGB", 4: "RGBA"}.get(nc, mode)
        elif tbox == b"colr" and nc == 4:
            meth, _, _, enumcs = header.fields(">BBBI")
            if meth == 1 and enumcs == 12:
                mode = "CMYK"
        elif tbox == b"pclr" and mode in ("L", "LA"):
            ne, npc = header.fields(">HB")
            if max(header.fields(">" + "B" * npc)) <= 8:
                colors: dict = {}
                for _ in range(ne):
                    color = header.fields(">" + "B" * npc)
                    if color not in colors:
                        if len(colors) >= 256:
                            raise ValueError("corrupt JPEG 2000: a palette of more than 256 colours (Pillow "
                                             "cannot allocate them)")
                        colors[color] = len(colors)
                if npc != 3:
                    raise ValueError(f"JPEG 2000 palettes of {npc} columns are not supported by the port's codec")
                palette = np.array(list(colors), np.uint8).reshape(-1, 3)
                mode = "P" if mode == "L" else "PA"
        elif tbox == b"res ":
            res = header.boxes()
            while res.has_next():
                if res.next_type() == b"resc":
                    res.fields(">HHHHBB")
                    break
    if size is None or mode is None:
        raise SyntaxError("Malformed JP2 header")
    return size, mode, palette


def _skip_comment(fp: io.BytesIO) -> None:
    """Jpeg2KImageFile._parse_comment: its reads, which can fail as Pillow's fail."""
    while True:
        marker = fp.read(2)
        if not marker:
            break
        typ = marker[1]
        if typ in (0x90, 0xD9):
            break
        length = struct.unpack(">H", fp.read(2))[0]
        if typ == 0x64:
            fp.read(length - 2)
            break
        fp.seek(length - 2, io.SEEK_CUR)


def _jp2_refuse(why: str) -> ValueError:
    return ValueError(f"corrupt JPEG 2000: {why} (OpenJPEG refuses it)")


def _jp2_image_box(kind: bytes, body: bytes, st: dict) -> None:
    """OpenJPEG's handlers of the boxes inside jp2h (opj_jp2_read_ihdr, _colr,
    _bpcc, _pclr, _cmap, _cdef): their checks, and the colour they set."""
    n = len(body)
    if kind == b"ihdr":
        if "nc" in st:
            return  # a second ihdr is ignored
        if n != 14:
            raise _jp2_refuse("an ihdr box of the wrong size")
        st["nc"] = struct.unpack(">H", body[8:10])[0]
        if not 1 <= st["nc"] <= 16384:
            raise _jp2_refuse("an ihdr box with a bad component count")
        st["bpc"] = body[10]
    elif kind == b"colr":
        if "enumcs" in st:
            return  # boxes after the first are ignored
        if n < 3:
            raise _jp2_refuse("a colr box of the wrong size")
        if body[0] == 1:
            if n < 7:
                raise _jp2_refuse("a colr box of the wrong size")
            st["enumcs"] = struct.unpack(">I", body[3:7])[0]
        elif body[0] == 2:
            st["enumcs"] = 0  # an ICC profile: the colour space is read as unspecified
    elif kind == b"bpcc":
        if n != st.get("nc", -1):
            raise _jp2_refuse("a bpcc box of the wrong size")
    elif kind == b"pclr":
        if "pclr" in st or n < 3:
            raise _jp2_refuse("a second or short pclr box")
        entries, cols = struct.unpack(">HB", body[:3])
        if not 1 <= entries <= 1024 or cols == 0 or n < 3 + cols:
            raise _jp2_refuse("a bad pclr box")
        need = 3 + cols + entries * sum(((b & 0x7F) + 8) >> 3 for b in body[3:3 + cols])
        if n < need:
            raise _jp2_refuse("a pclr box shorter than its entries")
        st["pclr"] = cols
    elif kind == b"cmap":
        if "pclr" not in st:
            raise _jp2_refuse("a cmap box before the pclr box")
        if "cmap" in st or n < st["pclr"] * 4:
            raise _jp2_refuse("a second or short cmap box")
        st["cmap"] = True
    elif kind == b"cdef":
        if "cdef" in st:
            raise _jp2_refuse("a second cdef box")
        count = struct.unpack(">H", body[:2])[0] if n >= 2 else 0
        if n < 2 or count == 0 or n < 2 + 6 * count:
            raise _jp2_refuse("a cdef box of the wrong size")
        st["cdef"] = True


_JP2_IMAGE_BOXES = (b"ihdr", b"colr", b"bpcc", b"pclr", b"cmap", b"cdef")


def _jp2_box_header(data: bytes, pos: int, end: int) -> tuple[int, bytes, int] | None:
    """(length, type, header size) of the box at ``pos`` (length 0: to the
    end; 1: the 64-bit length after), or None where fewer than 8 bytes are left."""
    if pos + 8 > end:
        return None
    length, kind = struct.unpack(">I4s", data[pos:pos + 8])
    head = 8
    if length == 0:
        length = end - pos
    elif length == 1:
        if pos + 16 > end:
            return None
        hi, length = struct.unpack(">II", data[pos + 8:pos + 16])
        if hi:
            raise _jp2_refuse("a box over 2^32 bytes")
        head = 16
    return length, kind, head


def _jp2_codestream(data: bytes) -> tuple[bytes, int]:
    """The codestream and colour space OpenJPEG's JP2 reader takes from a
    .jp2 file (opj_jp2_read_header_procedure): the signature box first, then
    ftyp, jp2h (its image boxes checked as OpenJPEG checks them), boxes it
    does not know skipped, up to the jp2c box, whose body is the codestream."""
    pos, st, state = 0, {}, []
    while True:
        box = _jp2_box_header(data, pos, len(data))
        if box is None:
            break
        length, kind, head = box
        if kind == b"jp2c":
            if "jp2h" not in state:
                raise _jp2_refuse("a codestream box before jp2h")
            enumcs = st.get("enumcs")
            return data[pos + head:], _ENUMCS.get(enumcs, _CS_UNKNOWN) if enumcs else _CS_UNKNOWN
        if length < head:
            raise _jp2_refuse("a box shorter than its header")
        body = data[pos + head:pos + length]
        known = kind in (b"jP  ", b"ftyp", b"jp2h")
        if known or kind in _JP2_IMAGE_BOXES:
            if len(body) < length - head:
                raise _jp2_refuse(f"a {kind!r} box past the end of the file")
            if kind == b"jP  ":
                if state or len(body) != 4 or body != b"\r\n\x87\n":
                    raise _jp2_refuse("a bad signature box")
            elif kind == b"ftyp":
                if state != ["jP  "] or len(body) < 8 or (len(body) - 8) % 4:
                    raise _jp2_refuse("a bad ftyp box")
            elif kind == b"jp2h":
                if "ftyp" not in state:
                    raise _jp2_refuse("a jp2h box before ftyp")
                at = 0
                while at < len(body):
                    sub = _jp2_box_header(body, at, len(body))
                    if sub is None or sub[0] < sub[2] or sub[0] > len(body) - at:
                        raise _jp2_refuse("a box inside jp2h of a bad length")
                    if sub[1] in _JP2_IMAGE_BOXES:
                        _jp2_image_box(sub[1], body[at + sub[2]:at + sub[0]], st)
                    at += sub[0]
                if "nc" not in st:
                    raise _jp2_refuse("no ihdr box in jp2h")
            elif "jp2h" in state:  # an image box outside jp2h, read once jp2h is
                _jp2_image_box(kind, body, st)
            state.append(kind.decode("latin-1"))
        else:
            if not state:
                raise _jp2_refuse("no signature box first")
            if state == ["jP  "]:
                raise _jp2_refuse("no ftyp box second")
            if len(body) < length - head:
                raise _jp2_refuse(f"a {kind!r} box past the end of the file")
        pos += length
    if "jp2h" not in state:
        raise _jp2_refuse("no jp2h box")
    raise _jp2_refuse("no jp2c codestream box")


def jpeg2000_tiles(stream: bytes) -> tuple[list, list, list]:
    """A codestream through the port's own decoder (``csrc/host/jp2.cpp``)
    → (the image's x0, y0, x1, y1; per component (dx, dy, prec, sgnd); per
    decoded tile (x0, y0, x1, y1, [[h, w] int32 per component]))."""
    import ctypes

    lib = _build.jp2_library()
    out, words, msg = ctypes.c_void_p(), ctypes.c_longlong(), ctypes.create_string_buffer(256)
    status = lib.mmtrs_jp2_decode(stream, len(stream), MAX_PIXELS, ctypes.addressof(out), ctypes.addressof(words),
                                  ctypes.addressof(msg))
    if status:
        why = msg.value.decode()
        if status == 5:
            raise ValueError(f"JPEG 2000 image exceeds the limit of {MAX_PIXELS} pixels")
        raise ValueError(why if status == 6 or why.startswith(("corrupt", "truncated")) else
                         f"corrupt JPEG 2000: {why}")
    try:
        w = np.ctypeslib.as_array((ctypes.c_int32 * words.value).from_address(out.value)).copy()
    finally:
        lib.mmtrs_jp2_free(out)
    box, nc = list(w[:4]), int(w[4])
    comps = [tuple(int(v) for v in w[5 + 4 * c:9 + 4 * c]) for c in range(nc)]
    pos = 5 + 4 * nc
    tiles = []
    pos += 1
    for _ in range(int(w[pos - 1])):
        tx0, ty0, tx1, ty1 = (int(v) for v in w[pos + 1:pos + 5])
        pos += 5
        planes = []
        for _ in range(nc):
            cw, ch = int(w[pos]), int(w[pos + 1])
            planes.append(w[pos + 2:pos + 2 + cw * ch].reshape(ch, cw))
            pos += 2 + cw * ch
        tiles.append((tx0, ty0, tx1, ty1, planes))
    return box, comps, tiles


def _j2k_csiz(prec: int) -> int:
    size = (prec + 7) >> 3
    return 4 if size == 3 else size


def decode_jpeg2000(stream: bytes, color_space: int, mode: str, size: tuple[int, int],
                    palette: np.ndarray | None) -> Loaded:
    """A codestream decoded and unpacked as Pillow's JPEG 2000 decoder does:
    OpenJPEG's colour space (unspecified or unknown: gray for 1-2
    components, sRGB for 3-4, sYCC where the second or third is the first
    subsampled), the unpacker of Pillow's mode, each tile
    checked against Pillow's size and placed at its offset. A tile's samples
    go through the byte buffer OpenJPEG fills and Pillow reads (each
    sample's low 1, 2 or 4 bytes; the buffer kept from tile to tile, zeroed
    when it grows), and Pillow's unpackers index it with its own strides
    (``w / dx`` for a subsampled component, the tile's width otherwise)."""
    box, comps, tiles = jpeg2000_tiles(stream)
    nc = len(comps)
    if not 1 <= nc <= 4:
        raise ValueError(f"JPEG 2000 of {nc} components is not decoded (nor by Pillow)")
    if (box[2] - box[0], box[3] - box[1]) != tuple(size):
        raise ValueError("corrupt JPEG 2000: a codestream of another size than the JP2 header's (Pillow refuses it)")
    if color_space in (_CS_UNSPECIFIED, _CS_UNKNOWN):  # no colr box, an ICC profile or an unknown EnumCS
        color_space = _CS_GRAY if nc <= 2 else _CS_SRGB
        # Pillow's guess: a subsampled second or third component (the first
        # not) is chroma
        first = next((c for c, (dx, dy, _, _) in enumerate(comps) if (dx, dy) != (1, 1)), None)
        if nc >= 3 and first in (1, 2):
            color_space = _CS_SYCC
    unpack = _J2K_UNPACKERS.get((mode, color_space, nc))
    if unpack is None or (unpack in ("gray", "gray_i", "graya") and comps[0][:2] != (1, 1)):
        raise ValueError(f"JPEG 2000 of {nc} components in OpenJPEG colour space {color_space} as mode {mode} is not "
                         "decoded (nor by Pillow: no unpacker)")
    w, h = size
    channels = {"gray": 1, "gray_i": 1, "graya": 2}.get(unpack, min(nc, 4))
    bits = 16 if unpack == "gray_i" else 8
    img = np.zeros((h, w, channels), np.uint16 if bits == 16 else np.uint8)
    csiz = [_j2k_csiz(prec) for _, _, prec, _ in comps]
    buf = np.zeros(0, np.uint8)
    for tx0, ty0, tx1, ty1, planes in tiles:
        x0, y0 = tx0 - box[0], ty0 - box[1]
        if tx0 < box[0] or ty0 < box[1] or tx1 - box[0] > w or ty1 - box[1] > h or tx0 > tx1 or ty0 > ty1:
            raise ValueError("corrupt JPEG 2000: a tile outside the image Pillow sized (Pillow refuses it)")
        th, tw = ty1 - ty0, tx1 - tx0
        # OpenJPEG's tile buffer: each component's samples, its csiz low bytes each
        data = b"".join(planes[c].astype("<i4").view(np.uint8).reshape(-1, 4)[:, :csiz[c]].tobytes()
                        for c in range(nc))
        need = max(len(data), tw * th * sum(csiz))
        if len(buf) < need:
            buf = np.zeros(need, np.uint8)
        buf[:len(data)] = np.frombuffer(data, np.uint8)
        # Pillow's strides: the gray unpackers step through the tile's width;
        # the colour ones through w / dx of each component
        base = 0
        yy, xx = np.mgrid[0:th, 0:tw]
        for c in range(channels):
            dx, dy, prec, sgnd = comps[c]
            if unpack in ("gray", "gray_i", "graya"):
                dx = dy = 1
            stride = tw // dx
            at = base + csiz[c] * ((yy // dy) * stride + xx // dx)
            word = np.zeros((th, tw), np.int64)
            for k in range(csiz[c]):
                word |= buf[np.minimum(at + k, len(buf) - 1)].astype(np.int64) << (8 * k)
            shift = bits - prec
            offset = (1 << (prec - 1)) if sgnd else 0
            if shift < 0:
                offset += 1 << (-shift - 1)
            x = (word + offset) & 0xFFFFFFFF
            v = ((x >> -shift) if shift < 0 else (x << shift)) & 0xFFFF
            img[y0:y0 + th, x0:x0 + tw, c] = v & (0xFFFF if bits == 16 else 0xFF)
            base += csiz[c] * (tw // dx) * (th // dy)
    if unpack == "sycc":
        mode = "YCbCr"
    elif mode in ("RGB", "RGBA") and unpack in ("gray", "graya"):
        mode = "L"
    return img, mode, palette


def open_jpeg2000(data: bytes) -> Loader:
    """Jpeg2KImageFile._open: the codestream's SIZ or the JP2 header."""
    fp = io.BytesIO(data)
    sig = fp.read(4)
    if sig == _J2K_MAGIC:
        size, mode = _j2k_size_mode(fp)
        _skip_comment(fp)
        palette = None
    else:
        if sig + fp.read(8) != _JP2_MAGIC:
            raise SyntaxError("not a JPEG 2000 file")
        size, mode, palette = _jp2_header(fp)
        if fp.read(12).endswith(b"jp2c\xff\x4f\xff\x51"):
            fp.seek(struct.unpack(">H", fp.read(2))[0] - 2, io.SEEK_CUR)
            _skip_comment(fp)
    _sized("JPEG2000", *size)

    def load() -> Loaded:
        if sig == _J2K_MAGIC:
            stream, space = data, _CS_UNSPECIFIED
        else:
            stream, space = _jp2_codestream(data)
        return decode_jpeg2000(stream, space, mode, size, palette)

    return load


def open_avif(data: bytes) -> Loader:
    """AvifImagePlugin._open: libavif's parse of the container (a failure is
    a SyntaxError, as Pillow's is) and the primary image's size; the load
    decodes it with the port's own AV1 decoder (``utils.avif``)."""
    from mmtrs_tpu_torch.utils import avif

    av = avif.Avif(data)
    _sized("AVIF", av.width, av.height)

    def load() -> Loaded:
        return avif.decode_avif(av).numpy(), "RGB", None

    load.avif = av  # codec.decode_image converts its planes on the caller's device
    return load


def _raiser(e: Exception) -> Loader:
    def load() -> Loaded:
        raise ValueError(str(e)) from e

    return load


def _refuse(name: str, why: str) -> Callable[[bytes], Loader]:
    def opener(data: bytes) -> Loader:
        raise ValueError(f"{name} images are not supported by the port's codec ({why})")

    return opener


_AVIF_BRANDS = (b"avif", b"avis", b"mif1", b"msf1")


def _accept_avif(p: bytes) -> bool:
    return p[4:8] == b"ftyp" and p[8:12] in _AVIF_BRANDS


# (name, accept test on the first 16 bytes or None, opener or None for the
# codec's own decoders), in the order Pillow 12.1's Image.open tries them
def openers() -> list[tuple[str, Callable[[bytes], bool] | None, Callable[[bytes], Loader] | None]]:
    """(name, accept test on the first 16 bytes or None, opener or None for
    the codec's own decoders), in the order Pillow 12.1's Image.open tries
    them."""
    stub = "Pillow's plugin is a stub with no handler"
    return [
        ("BMP", lambda p: p[:2] == b"BM", None),
        ("DIB", lambda p: len(p) >= 4 and i32(p) in (12, 40, 52, 56, 64, 108, 124), open_dib),
        ("GIF", lambda p: p[:6] in (b"GIF87a", b"GIF89a"), None),
        ("JPEG", lambda p: p[:3] == b"\xff\xd8\xff", open_jpeg),
        ("PPM", lambda p: len(p) >= 2 and p[:1] == b"P" and p[1] in b"0123456fy", open_ppm),
        ("PNG", lambda p: p[:8] == b"\x89PNG\r\n\x1a\n", None),
        ("AVIF", _accept_avif, open_avif),
        ("BLP", lambda p: p[:4] in (b"BLP1", b"BLP2"), open_blp),
        ("BUFR", lambda p: p[:4] in (b"BUFR", b"ZCZC"), _refuse("BUFR", stub)),
        ("CUR", lambda p: p[:4] == b"\x00\x00\x02\x00", open_cur),
        ("PCX", lambda p: len(p) >= 2 and p[0] == 10 and p[1] in (0, 2, 3, 5), open_pcx),
        ("DCX", lambda p: len(p) >= 4 and i32(p) == 987654321, open_dcx),
        ("DDS", lambda p: p[:4] == b"DDS ", open_dds),
        ("EPS", lambda p: p[:4] == b"%!PS" or (len(p) >= 4 and i32(p) == 0xC6D3D0C5),
         _refuse("EPS", "PostScript needs Ghostscript, which Pillow here lacks too")),
        ("FITS", lambda p: p[:6] == b"SIMPLE", open_fits),
        ("FLI", lambda p: len(p) >= 16 and i16(p, 4) in (0xAF11, 0xAF12) and i16(p, 14) in (0, 3), open_fli),
        ("FTEX", lambda p: p[:4] == b"FTEX", open_ftex),
        ("GBR", lambda p: len(p) >= 8 and i32be(p) >= 20 and i32be(p, 4) in (1, 2), open_gbr),
        ("GRIB", lambda p: len(p) >= 8 and p[:4] == b"GRIB" and p[7] == 1, _refuse("GRIB", stub)),
        ("HDF5", lambda p: p[:8] == b"\x89HDF\r\n\x1a\n", _refuse("HDF5", stub)),
        ("JPEG2000", lambda p: p[:4] == _J2K_MAGIC or p[:12] == _JP2_MAGIC, open_jpeg2000),
        ("ICNS", lambda p: p[:4] == b"icns", open_icns),
        ("ICO", lambda p: p[:4] == b"\x00\x00\x01\x00", open_ico),
        ("IM", None, open_im),
        ("IMT", None, open_imt),
        ("IPTC", None, open_iptc),
        ("MCIDAS", lambda p: p[:8] == b"\x00\x00\x00\x00\x00\x00\x00\x04", open_mcidas),
        ("MPEG", lambda p: p[:4] == b"\x00\x00\x01\xb3", _refuse("MPEG", "Pillow's plugin cannot read it either")),
        ("TIFF", lambda p: p[:4] in (b"MM\x00\x2a", b"II\x2a\x00", b"MM\x2a\x00", b"II\x00\x2a", b"MM\x00\x2b",
                                     b"II\x2b\x00"), None),
        ("MSP", lambda p: p[:4] in (b"DanM", b"LinS"), open_msp),
        ("PCD", None, open_pcd),
        ("PIXAR", lambda p: p[:4] == b"\x80\xe8\x00\x00", open_pixar),
        ("PSD", lambda p: p[:4] == b"8BPS", open_psd),
        ("QOI", lambda p: p[:4] == b"qoif", open_qoi),
        ("SGI", lambda p: len(p) >= 2 and i16be(p) == 474, open_sgi),
        ("SPIDER", None, open_spider),
        ("SUN", lambda p: len(p) >= 4 and i32be(p) == 0x59A66A95, open_sun),
        ("TGA", None, open_tga),
        ("WEBP", lambda p: p[:4] == b"RIFF" and p[8:12] == b"WEBP" and p[12:16] in (b"VP8 ", b"VP8X", b"VP8L"), None),
        ("WMF", lambda p: p[:6] == b"\xd7\xcd\xc6\x9a\x00\x00" or p[:4] == b"\x01\x00\x00\x00",
         _refuse("WMF", "Pillow's plugin loads it only on Windows")),
        ("XBM", lambda p: p.lstrip().startswith(b"#define"), open_xbm),
        ("XPM", lambda p: p[:9] == b"/* XPM */", open_xpm),
        ("XVThumb", lambda p: p[:6] == b"P7 332", open_xvthumb),
    ]


def identify(data: bytes) -> tuple[str, Loader | None]:
    """(Pillow's format name, a loader, or None for the codec's own
    decoders) of ``data``. Where the opener of the format that takes the
    data refuses it (Pillow's open raises), the loader raises that error;
    data that no opener takes raises ValueError here."""
    prefix = data[:16]
    why = ""  # what the opener of a format whose magic matched refused
    for name, accept, opener in openers():
        if accept is not None and not accept(prefix):
            continue
        if opener is None:
            return name, None
        try:
            return name, opener(data)
        except NOT_THIS as e:
            if accept is not None and isinstance(e, SyntaxError) and not why:
                why = f" ({name}: {e})"
            continue
        except (ValueError, OverflowError, MemoryError) as e:
            return name, _raiser(e)
    if prefix[:4] == b"RIFF" and prefix[8:12] == b"WEBP":  # Pillow's WebP opener wants a VP8 chunk first
        raise ValueError(f"cannot identify the image data: a corrupt WebP whose first chunk is {prefix[12:16]!r}")
    raise ValueError("cannot identify the image data: no format the port's codec knows (those Pillow 12.1 opens) "
                     f"takes it{why}")
