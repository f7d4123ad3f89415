"""The port's image codec, without Pillow: JPEG and PNG decode and encode,
and the decode of every other format Pillow 12.1 opens (BMP, GIF, TIFF and
WebP here; the rest in ``rasters.py``), identified as Pillow identifies
them (``sniff``) and converted as its ``convert("RGB")`` converts them
(``convert_rgb``, the one place each mode's conversion is written).

A JPEG is dispatched by the kind of its frame, the same on both devices.
Lossless (SOF3) and arithmetic-coded (SOF9, SOF10) frames, and Huffman
progressive (SOF2) ones whose scan headers leave the progression incomplete
(the files libjpeg's block smoothing estimates among them), go to the port's
own decoder (``csrc/host/jpeg.cpp``, C++ with no library), which decodes
on the host as Pillow 12.1's bundled libjpeg-turbo 3.1.3 does, bit for
bit; its components move to the device and are converted there with
libjpeg's fixed-point tables. It also names the frames Pillow refuses
(SOF11, the hierarchical SOF5-7 and SOF13-15, precision other than 8
bits, a lossless frame asking for colour conversion). Pillow itself reads
a file in 64 KiB blocks, and libjpeg's arithmetic decoder cannot wait for
the next one: Pillow raises "broken data stream" for an arithmetic-coded
JPEG whose scan data crosses a block boundary. The port decodes such a
file as Pillow does when handed the whole file in one block. Every other
JPEG (Huffman-coded DCT, SOF0-SOF2) runs on the device's backend, chosen
when the library is built and never switched at run time:

- on the CPU, the system libjpeg (``csrc/host/codec.cpp``), which decodes
  as Pillow's ``Image.open(...).convert("RGB")`` does (both are
  libjpeg-turbo with its default IDCT and upsampling) and encodes as
  Pillow's ``save(..., quality=q)`` does (baseline, 4:2:0);
- on the card, the CUDA toolkit's nvJPEG (``csrc/host/nvjpeg.cpp``): a
  decode lands in a CUDA tensor and an encode reads one. Its IDCT and
  chroma upsampling are its own, so its pixels are near Pillow's, not equal.

Four-component (CMYK and YCCK) JPEGs decode as Pillow decodes them: libjpeg
gives CMYK (converting YCCK itself), Pillow inverts every sample (it assumes
Adobe's inverted CMYK, with or without the APP14 marker) and converts with
its ``cmyk2rgb``. On the card nvJPEG decodes the four planes as they are
stored; libjpeg's fixed-point YCC → RGB turns a YCCK's first three into
CMY, and the same inversion and conversion follow in torch on the card.

A missing compiler, header or library raises with its name; nothing moves to
another backend. PNG, BMP, GIF, TIFF and WebP are host work on either device:
the files are parsed here, deflated streams inflated with ``zlib``, and the
sequential loops (PNG's row unfilter, LZW, PackBits, BMP's RLE) run in C
(``csrc/host/png.cpp``), WebP's bitstreams in ``csrc/host/webp.cpp``; the
image then moves to the device. The PNG encoder
is ``zlib`` and ``struct`` alone. Each decoder gives what Pillow's
``convert("RGB")`` gives:

- PNG at every colour type and depth, interlaced (Adam7) or not: gray
  repeated, alpha dropped (not composited), the palette looked up (tRNS
  ignored), 16-bit RGB and alpha samples cut to their high byte, 16-bit gray
  clipped at 255;
- BMP with Windows (40–124-byte) and OS/2 v1 (12-byte) headers at 1, 4, 8,
  16 (5-5-5), 24 and 32 bits, ``BI_BITFIELDS`` at 16 and 32 bits,
  ``BI_RLE8`` and ``BI_RLE4`` as Pillow reads them, rows bottom-up or
  top-down;
- GIF's first frame: LZW, global and local colour tables, interlaced rows,
  a frame smaller than the screen at its offset on a canvas of the
  transparency index (else index 0), transparency otherwise ignored;
- TIFF (the first image) in every mode of Pillow's table: either byte
  order, strips or tiles, ``PlanarConfiguration`` 1 and 2, fill order 2,
  an IFD damaged past the file's end read as Pillow reads it for the mode
  and size and as libtiff reads it for the decode;
  no compression, LZW, Adobe deflate (8 and 32946), PackBits, CCITT RLE,
  Group 3 (1-D and 2-D) and Group 4 (``csrc/host/rasters.cpp``), and JPEG
  (``JPEGTables`` spliced into each strip or tile: libjpeg on the CPU,
  nvJPEG on the card, as libtiff's codec decodes them: YCbCr converted,
  RGB, gray and CMYK samples as stored), and old-style JPEG (compression 6,
  both of libtiff's layouts: the stream ``tif_ojpeg.c`` writes, through
  the port's own decoder's raw planes on either device, converted as
  TIFFRGBAImage converts YCbCr); the horizontal-difference
  predictor; 1-16-bit gray, 32-bit integer and float samples, 8- and
  16-bit RGB(A) (alpha unassociated or premultiplied), CMYK, palette, and
  YCbCr through libtiff's conversion and subsampling (uncompressed YCbCr as
  Pillow's raw reader reads it, without);
- WebP as Pillow 12.1 reads it through libwebp 1.6's WebPAnimDecoder, bit
  for bit: the RIFF container is walked here as libwebp's demuxer walks it
  (simple lossy ``VP8 ``, simple lossless ``VP8L``, extended ``VP8X``), and
  the first frame's bitstream is decoded in C. Lossy: RFC 6386 up to the
  YUV planes (intra prediction, dequantisation, the WHT and IDCT, both loop
  filters), then libwebp's fancy chroma upsampler and 14-bit fixed-point
  YUV → RGB. Lossless: RFC 9649 (the four transforms, colour cache, meta
  prefix codes, LZ77 with the 120-code distance map). An ``ALPH`` chunk is
  checked as libwebp checks it and dropped (Pillow's RGBA is not
  premultiplied, so alpha never changes RGB); ``ICCP``, ``EXIF`` and
  ``XMP `` are skipped; an animation's first frame sits at its offset on a
  black canvas.

What Pillow opens and this codec refuses raises a ValueError that names
the format and the feature (AVIF; ``rasters.py`` lists the rest; JPEG 2000
is decoded there, by the port's ``csrc/host/jp2.cpp``). Data no opener takes is not identified. A
header that asks for more than ``MAX_PIXELS`` pixels is refused before
anything is allocated, as Pillow refuses it (DecompressionBombError); a
corrupt or truncated file raises a ValueError that names its format.
"""

from __future__ import annotations

import ctypes
import os
import struct
import weakref
import zlib
from pathlib import Path

import numpy as np
import torch

from mmtrs_tpu_torch import _build
from mmtrs_tpu_torch.device import resolve_device
from mmtrs_tpu_torch.utils import rasters

PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
# PNG colour type -> channels (PNG specification, table 11.1)
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
MAX_PIXELS = rasters.MAX_PIXELS
_check_pixels = rasters.check_pixels


def sniff(data: bytes) -> str:
    """The format of an encoded image as Pillow 12.1's ``Image.open(...).format``
    names it ("JPEG", "PNG", "BMP", "TIFF", "WEBP", "TGA", ...), found as
    :func:`rasters.identify` finds it, or "unknown" where Pillow identifies
    no format."""
    try:
        return rasters.identify(data)[0]
    except ValueError:
        return "unknown"


def is_jpeg(prefix: bytes) -> bool:
    """True when the bytes start as a JPEG does (Pillow's JPEG opener takes
    them before any opener after it)."""
    return prefix[:3] == b"\xff\xd8\xff"


def decode_image(src: bytes | str | Path, device: str | torch.device | None = None) -> torch.Tensor:
    """Encoded bytes, or a file's path → RGB u8 [H, W, 3] on ``device``
    (None: the card), as ``np.asarray(Image.open(src).convert("RGB"))``
    gives it. Raises ValueError for a corrupt file or a format the codec
    does not read, naming it."""
    dev = resolve_device(device)
    data = bytes(src) if isinstance(src, (bytes, bytearray, memoryview)) else Path(src).read_bytes()
    kind, load = rasters.identify(data)
    if kind == "JPEG":
        if jpeg_goes_own(data):
            planes, space = jpeg_own_planes(data)
            return jpeg_planes_to_rgb(planes.to(dev), space)
        return _nvjpeg_decode(data, dev) if dev.type == "cuda" else _decode_jpeg_cpu(data)
    if kind == "BLP" and (blp := rasters.blp1_jpeg(data)) is not None:
        return decode_blp_jpeg(*blp, dev)
    if kind == "TIFF":
        try:
            return decode_tiff_to(data, dev)
        except rasters.NOT_THIS as e:  # a tag missing or short: Pillow's open or libtiff refuses it too
            raise ValueError(f"corrupt TIFF: {e!r}") from None
    if load is None:
        return torch.from_numpy(_HOST_DECODERS[kind](data)).to(dev)
    if kind == "IPTC" and load.iptc[3] == "jpeg":
        return _decode_iptc_jpeg(load.iptc, dev)
    if kind == "AVIF" and hasattr(load, "avif"):  # decoded on the host, converted on ``dev``
        from mmtrs_tpu_torch.utils.avif import decode_avif

        try:
            return decode_avif(load.avif, dev)
        except rasters.NOT_THIS as e:  # an item's data past the file's end: Pillow's decode fails too
            raise ValueError(f"corrupt or truncated AVIF image: {e}") from None
    try:
        loaded = load()
    except rasters.NOT_THIS as e:  # a short read past the header: Pillow's decoders raise there too
        raise ValueError(f"corrupt or truncated {kind} image: {e}") from None
    rgb = convert_rgb(*loaded)
    rgb = rgb if rgb.flags.writeable and rgb.flags.c_contiguous else np.ascontiguousarray(rgb).copy()
    return torch.from_numpy(rgb).to(dev)


# ---------------------------------------------------------------------------
# Pillow's convert("RGB"), for every mode the decoders give
# ---------------------------------------------------------------------------


def _ycbcr_tables() -> tuple[np.ndarray, ...]:
    """Pillow's YCbCr → RGB tables (ConvertYCbCr.c): each coefficient times
    (c − 128), scaled by 2^6 and truncated after adding a half."""
    x = np.arange(256, dtype=np.float64) - 128
    fix = lambda c: np.trunc(c * 64 * x + 0.5).astype(np.int64)
    return fix(1.40200), fix(-0.34414), fix(-0.71414), fix(1.77200)


def convert_rgb(px: np.ndarray, mode: str, palette: np.ndarray | None = None) -> np.ndarray:
    """Samples in a Pillow mode → RGB u8 [H, W, 3], as Pillow's
    ``convert("RGB")`` gives it. ``px``: [H, W] for 1, L, P, I;16, I and F
    ([H, W, C] with the first channel used for LA and PA), [H, W, C] for
    RGB, RGBA, RGBX, CMYK, YCbCr and LAB (L, a + 128, b + 128, as Pillow
    holds it; converted as its LittleCMS transform converts it, equal on all
    2^24 inputs). "1" holds 0 and 255; P and PA look
    their index up in ``palette`` rows [n, 3] (an index past them, or no
    palette, is black); I;16 (any byte order, as values) is capped at 255,
    I clipped to 0..255; F is truncated toward 0 and clipped, NaN → 0."""
    if px.ndim == 3 and mode in ("1", "L", "LA", "P", "PA", "I", "I;16", "F"):
        px = px[..., 0]
    if mode in ("1", "L", "LA"):
        g = px.astype(np.uint8)
    elif mode in ("P", "PA"):
        lut = np.zeros((256, 3), np.uint8)
        if palette is not None:
            lut[: min(len(palette), 256)] = palette[:256]
        return lut[px.astype(np.uint8)]
    elif mode == "I;16":
        g = np.minimum(px, 255).astype(np.uint8)
    elif mode == "I":
        g = np.clip(px, 0, 255).astype(np.uint8)
    elif mode == "F":
        v = px.astype(np.float32)
        with np.errstate(invalid="ignore"):
            g = np.where(v >= 255, 255, np.where(v > 0, np.trunc(np.where(v > 0, v, 0)), 0)).astype(np.uint8)
    elif mode in ("RGB", "RGBA", "RGBX"):
        return np.ascontiguousarray(px[..., :3], dtype=np.uint8)
    elif mode == "CMYK":
        return cmyk2rgb(torch.from_numpy(np.ascontiguousarray(px))).numpy()
    elif mode == "LAB":  # Pillow's LittleCMS transform to sRGB, in csrc/host/rasters.cpp
        lab = np.ascontiguousarray(px[..., :3], dtype=np.uint8)
        rgb = np.empty_like(lab)
        _build.raster_library().mmtrs_lab_to_rgb(lab.ctypes.data, lab.size // 3, rgb.ctypes.data)
        return rgb
    elif mode == "YCbCr":
        r_cr, g_cb, g_cr, b_cb = _ycbcr_tables()
        x = px.astype(np.int64)
        y64, cb, cr = x[..., 0] * 64, x[..., 1], x[..., 2]
        rgb = np.stack([y64 + r_cr[cr], y64 + g_cb[cb] + g_cr[cr], y64 + b_cb[cb]], -1)
        return np.where(rgb <= 0, 0, np.where(rgb >= 16384, 255, rgb >> 6)).astype(np.uint8)
    else:
        raise ValueError(f"images in Pillow mode {mode} are not supported by the port's codec")
    return np.repeat(g[..., None], 3, axis=2)


def _jpeg_error(status: int, backend: str) -> Exception:
    if status == 2:
        return ValueError(f"corrupt or truncated JPEG ({backend})")
    if status >= 200:
        return RuntimeError(f"{backend}: CUDA error {status - 200}")
    if status >= 100:
        return RuntimeError(f"{backend}: nvjpegStatus_t {status - 100}")
    return RuntimeError(f"{backend}: status {status}")


def _decode_jpeg_cpu(data: bytes) -> torch.Tensor:
    lib = _build.jpeg_library()
    dims = np.zeros(3, np.int32)
    status = lib.mmtrs_jpeg_info(data, len(data), dims.ctypes.data)
    if status:
        raise _jpeg_error(status, "libjpeg")
    h, w = int(dims[0]), int(dims[1])
    out = torch.empty((h, w, 3), dtype=torch.uint8)
    status = lib.mmtrs_jpeg_decode(data, len(data), out.data_ptr(), h, w)
    if status:
        raise _jpeg_error(status, "libjpeg")
    return out


def jpeg_has_end(data: bytes) -> bool:
    """True when an EOI marker follows the JPEG stream's last start-of-scan
    marker. Entropy-coded data stuffs every 0xFF byte, so neither marker
    occurs inside a scan: a stream cut inside its last scan has no EOI after
    it. nvJPEG decodes such a stream without an error, where libjpeg warns
    and Pillow refuses it, so the card's decode refuses it too."""
    sos = data.rfind(b"\xff\xda")
    return sos >= 0 and data.find(b"\xff\xd9", sos + 2) >= 0


def adobe_transform(data: bytes) -> int | None:
    """The colour transform of a JPEG's Adobe APP14 marker (0 none, 1
    YCbCr, 2 YCCK), or None without one: the markers before the first scan
    are walked as libjpeg reads them."""
    pos = 2
    while pos + 4 <= len(data) and data[pos] == 0xFF:
        marker = data[pos + 1]
        if marker == 0xDA:
            break
        if marker == 0xFF:
            pos += 1
            continue
        n = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        seg = data[pos + 4:pos + 2 + n]
        if marker == 0xEE and seg.startswith(b"Adobe") and len(seg) >= 12:
            return seg[11]
        pos += 2 + n
    return None


def _ycc_tables(dev: torch.device) -> tuple[torch.Tensor, ...]:
    """libjpeg's fixed-point YCbCr → RGB tables (jdcolor.c,
    build_ycc_rgb_table): Cr → R, Cb → B, and the two G terms in 16.16."""
    one_half, fix = 1 << 15, lambda v: int(v * (1 << 16) + 0.5)
    x = torch.arange(256, dtype=torch.int64, device=dev) - 128
    cr_r = (fix(1.40200) * x + one_half) >> 16
    cb_b = (fix(1.77200) * x + one_half) >> 16
    cr_g = -fix(0.71414) * x
    cb_g = -fix(0.34414) * x + one_half
    return cr_r, cb_b, cr_g, cb_g


def cmyk2rgb(cmyk: torch.Tensor) -> torch.Tensor:
    """Pillow's cmyk2rgb on u8 [..., 4] (either device): nk = 255 − k, each
    channel nk − MULDIV255(c, nk), in int32 (the result lies in 0..nk)."""
    x = cmyk.to(torch.int32)
    nk = 255 - x[..., 3:]
    t = x[..., :3] * nk + 128
    return (nk - (((t >> 8) + t) >> 8)).to(torch.uint8)


def ycc_to_rgb(ycc: torch.Tensor) -> torch.Tensor:
    """u8 [..., 3] YCbCr → RGB u8 (either device) as libjpeg's
    ycc_rgb_convert gives it: ``_ycc_tables``, the sum clipped to 0..255."""
    cr_r, cb_b, cr_g, cb_g = _ycc_tables(ycc.device)
    x = ycc.long()
    y, cb, cr = x[..., 0], x[..., 1], x[..., 2]
    rgb = torch.stack([y + cr_r[cr], y + ((cb_g[cb] + cr_g[cr]) >> 16), y + cb_b[cb]], dim=-1)
    return rgb.clamp_(0, 255).to(torch.uint8)


def cmyk_to_rgb(cmyk: torch.Tensor, ycck: bool) -> torch.Tensor:
    """u8 [H, W, 4] as stored in a four-component JPEG → RGB u8 as Pillow
    gives it: a YCCK's Y, Cb, Cr become C, M, Y = 255 − their RGB (libjpeg's
    ycck_cmyk_convert, K kept), then Pillow inverts every sample ("CMYK;I")
    and applies its cmyk2rgb: nk = 255 − k, r = nk − MULDIV255(c, nk)."""
    x = torch.cat([255 - ycc_to_rgb(cmyk[..., :3]), cmyk[..., 3:]], dim=-1) if ycck else cmyk
    return cmyk2rgb(255 - x.to(torch.int32))


def _nvjpeg_cmyk_planes(data: bytes, dims: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A four-component JPEG on the card: nvJPEG's planes as stored, each
    brought to full size by repetition, [H, W, 4]."""
    lib = _build.nvjpeg_library()
    h, w = int(dims[0]), int(dims[1])
    with torch.cuda.device(dev):
        planes = [torch.empty((int(dims[3 + 2 * c]), int(dims[4 + 2 * c])), dtype=torch.uint8, device=dev)
                  for c in range(4)]
        ptrs = (ctypes.c_void_p * 4)(*[p.data_ptr() for p in planes])
        status = lib.mmtrs_nvjpeg_decode_planes(data, len(data), ctypes.addressof(ptrs), _build.stream_handle())
        if status:
            raise _jpeg_error(status, "nvJPEG")
        full = [p.repeat_interleave(-(-h // p.shape[0]), 0)[:h].repeat_interleave(-(-w // p.shape[1]), 1)[:, :w]
                for p in planes]
        return torch.stack(full, dim=-1)


def _is_ycck(data: bytes) -> bool:
    """libjpeg's rule for four components: an Adobe marker whose transform
    is not 0 means YCCK."""
    return adobe_transform(data) not in (None, 0)


def jpeg_components(data: bytes) -> int:
    """The component count of a JPEG's frame header (0 without one), the
    markers before its first scan walked as libjpeg reads them."""
    pos = 2
    while pos + 4 <= len(data) and data[pos] == 0xFF:
        marker = data[pos + 1]
        if marker == 0xFF:
            pos += 1
            continue
        if marker == 0xDA:
            break
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC) and pos + 10 <= len(data):
            return data[pos + 9]
        pos += 2 + struct.unpack(">H", data[pos + 2:pos + 4])[0]
    return 0


# the frame markers that go to the port's own decoder: lossless, arithmetic,
# hierarchical (SOF3, SOF5-7, SOF9-11, SOF13-15, DHP); it decodes SOF3, SOF9
# and SOF10 and names the rest, which Pillow refuses
OWN_FRAMES = frozenset((0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB, 0xCD, 0xCE, 0xCF, 0xDE))
# libjpeg's J_COLOR_SPACE numbers, as jpeg.cpp reports the stored components
JCS_GRAYSCALE, JCS_RGB, JCS_YCBCR, JCS_CMYK, JCS_YCCK = 1, 2, 3, 4, 5
JCS_UNKNOWN = 6  # the own decoder's code for libjpeg's JCS_UNKNOWN: no colour conversion


def jpeg_goes_own(data: bytes) -> bool:
    """True when a JPEG goes to the port's own decoder, on either device:
    its frame is one of ``OWN_FRAMES``, or it is Huffman progressive (SOF2)
    and its scan headers leave the progression incomplete (a coefficient
    never coded or not refined to its last bit). Those are the files
    libjpeg's block smoothing estimates (``smoothing_ok``), which the system
    libjpeg-turbo 2.1.5 does otherwise than Pillow's 3.1.3, and those
    nvJPEG refuses or reads otherwise. Decided from the headers alone,
    before any decode."""
    marker = jpeg_frame_marker(data)
    return marker in OWN_FRAMES or (marker == 0xC2 and _own_takes_sof2(data))


def _own_takes_sof2(data: bytes) -> bool:
    return bool(_build.jpeg_own_library().mmtrs_jpeg_own_takes_sof2(data, len(data)))


def jpeg_frame_marker(data: bytes) -> int:
    """The first frame marker of a JPEG (SOF0-SOF15 or DHP) before its first
    scan, the markers found as libjpeg's next_marker finds them (bytes
    between segments skipped); 0 without one."""
    return _jpeg_frame(data)[0]


def jpeg_frame_header(data: bytes) -> tuple[int, int, int, int, list[tuple[int, int, int]]] | None:
    """The first frame header: (marker, precision, height, width, [(id, h, v)
    of each component]), or None without a whole one."""
    marker, pos = _jpeg_frame(data)
    if not marker or pos + 8 > len(data):
        return None
    precision, height, width, n = struct.unpack(">BHHB", data[pos + 2:pos + 8])
    if pos + 8 + 3 * n > len(data):
        return None
    comps = [(data[pos + 8 + 3 * k], data[pos + 9 + 3 * k] >> 4, data[pos + 9 + 3 * k] & 15) for k in range(n)]
    return marker, precision, height, width, comps


def _jpeg_frame(data: bytes) -> tuple[int, int]:
    """(the first frame marker or 0, the offset of its segment's length)."""
    pos, n = 2, len(data)
    while True:
        while pos < n and data[pos] != 0xFF:
            pos += 1
        while pos < n and data[pos] == 0xFF:
            pos += 1
        if pos >= n:
            return 0, pos
        marker = data[pos]
        pos += 1
        if marker in (0xDA, 0xD9):
            return 0, pos
        if (0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC)) or marker == 0xDE:
            return marker, pos
        if marker == 0 or 0xD0 <= marker <= 0xD8 or marker == 0x01:
            continue
        if pos + 2 > n:
            return 0, pos
        pos += struct.unpack(">H", data[pos:pos + 2])[0]


def _own_error(status: int, msg: str, dims: np.ndarray) -> Exception:
    if status == 5:
        try:
            _check_pixels("JPEG", int(dims[1]), int(dims[0]))
        except ValueError as e:
            return e
    if status == 6:
        return ValueError(msg)
    if status == 3:
        return ValueError(f"corrupt or truncated JPEG (image file is truncated): {msg}")
    return ValueError(f"corrupt JPEG (broken data stream): {msg}")


def _own_tensor(lib, ptr: int, h: int, w: int, c: int) -> torch.Tensor:
    """The decoder's malloc'd h x w x c buffer as a tensor that frees it."""
    buf = (ctypes.c_ubyte * (h * w * c)).from_address(ptr)
    weakref.finalize(buf, lib.mmtrs_jpeg_own_free, ptr)
    return torch.from_numpy(np.ctypeslib.as_array(buf).reshape(h, w, c))


def jpeg_own_planes(data: bytes, space: int = 0, libtiff: bool = False) -> tuple[torch.Tensor, int]:
    """A lossless or arithmetic-coded JPEG through the port's own decoder,
    on the host → (its components as stored, at full size: u8 [H, W, C] on
    the CPU; their colour space, a ``JCS_*`` number). ``space``: the colour
    space libtiff sets for a JPEG-in-TIFF chunk (``JCS_YCBCR``, or
    ``JCS_UNKNOWN``: no conversion) in place of libjpeg's guess; ``libtiff``:
    read through libtiff's data source, which feeds a fake EOI past the
    chunk's end (a cut chunk decodes on, as past a marker). Raises
    ValueError naming the reason where Pillow refuses the file, and for a
    frame over ``MAX_PIXELS`` before anything is allocated."""
    lib = _build.jpeg_own_library()
    out, dims = ctypes.c_void_p(), np.zeros(4, np.int32)
    msg = ctypes.create_string_buffer(256)
    status = lib.mmtrs_jpeg_own_decode_as(data, len(data), MAX_PIXELS, space | (0x100 if libtiff else 0),
                                          ctypes.addressof(out), dims.ctypes.data, ctypes.addressof(msg))
    if status:
        raise _own_error(status, msg.value.decode(), dims)
    h, w, c, space = (int(v) for v in dims)
    return _own_tensor(lib, out.value, h, w, c), space


def jpeg_planes_to_rgb(planes: torch.Tensor, space: int) -> torch.Tensor:
    """A JPEG's components as stored (either device) → RGB u8 as Pillow's
    ``convert("RGB")`` gives it: gray repeated, YCbCr through libjpeg's
    tables, RGB as is, CMYK and YCCK through ``cmyk_to_rgb``."""
    if space == JCS_GRAYSCALE:
        return planes.expand(*planes.shape[:2], 3).contiguous()
    if space == JCS_YCBCR:
        return ycc_to_rgb(planes)
    if space == JCS_RGB:
        return planes
    return cmyk_to_rgb(planes, ycck=space == JCS_YCCK)


def jpeg_stored_planes4(data: bytes, dev: torch.device) -> torch.Tensor:
    """A four-component JPEG's samples as stored, at full size, u8
    [H, W, 4] on ``dev`` (a YCCK left unconverted): the own decoder for its
    frames, else libjpeg on the CPU and nvJPEG on the card."""
    if jpeg_goes_own(data):
        return jpeg_own_planes(data)[0].to(dev)
    if dev.type == "cuda":
        if not jpeg_has_end(data):
            raise _jpeg_error(2, "nvJPEG")
        dims = np.zeros(11, np.int32)
        status = _build.nvjpeg_library().mmtrs_nvjpeg_info(data, len(data), dims.ctypes.data)
        if status:
            raise _jpeg_error(status, "nvJPEG")
        return _nvjpeg_cmyk_planes(data, dims, dev)
    lib = _build.jpeg_library()
    dims = np.zeros(3, np.int32)
    status = lib.mmtrs_jpeg_info(data, len(data), dims.ctypes.data)
    if status:
        raise _jpeg_error(status, "libjpeg")
    h, w = int(dims[0]), int(dims[1])
    out = torch.empty((h, w, 4), dtype=torch.uint8)
    if lib.mmtrs_jpeg_decode_tiff(data, len(data), out.data_ptr(), h, w, 4, 0):
        raise _jpeg_error(2, "libjpeg")
    return out


def decode_blp_jpeg(stream: bytes, w: int, h: int, alpha: bool, dev: torch.device) -> torch.Tensor:
    """A BLP1 file's JPEG (its shared header and first mipmap) as Pillow's
    BlpImagePlugin reads it, on ``dev``. For a four-component JPEG the
    plugin sets the tile's JPEG mode to "CMYK", so libjpeg converts no YCCK
    and the stored samples are inverted ("CMYK;I") and converted by
    cmyk2rgb; any other JPEG decodes as ``decode_image`` decodes it. The RGB
    bytes are then read back as BGR into the BLP header's w x h."""
    if jpeg_components(stream) == 4:
        rgb = cmyk_to_rgb(jpeg_stored_planes4(stream, dev), ycck=False)
    else:
        rgb = decode_image(stream, dev)
    _check_pixels("BLP", int(rgb.shape[1]), int(rgb.shape[0]))
    if alpha:
        raise ValueError("BLP1 JPEG with alpha is not supported by the port's codec (nor by Pillow)")
    flat = rgb.flip(-1).reshape(-1)
    if flat.numel() < w * h * 3:
        raise ValueError("truncated BLP: not enough image data")
    return flat[: w * h * 3].reshape(h, w, 3)


def _decode_iptc_jpeg(iptc: tuple, dev: torch.device) -> torch.Tensor:
    """An IPTC image whose data is a JPEG, decoded on ``dev`` as
    ``decode_image`` decodes a JPEG: whole, or (three- and four-layer
    modes) its one gray band merged into the mode as IptcImagePlugin merges
    it, then converted."""
    body, mode, band, _ = iptc
    try:
        stream = body()
    except rasters.NOT_THIS as e:
        raise ValueError(f"corrupt or truncated IPTC image: {e}") from None
    if band is None:
        return decode_image(stream, dev)
    if rasters.identify(stream)[0] != "JPEG" or jpeg_components(stream) != 1:
        raise ValueError(f"IPTC/NAA: a {mode} layer whose data is not one gray band (Pillow cannot merge it)")
    try:
        px = rasters.iptc_merge(decode_image(stream, dev)[..., 0], mode, band)
    except IndexError as e:
        raise ValueError(f"corrupt or truncated IPTC image: {e}") from None
    return px if mode == "RGB" else cmyk2rgb(px)


def jpeg_is_arithmetic(data: bytes) -> bool:
    """True when the JPEG's frame header is an arithmetic-coded one
    (SOF9-SOF11, SOF13-SOF15)."""
    return jpeg_frame_marker(data) in (0xC9, 0xCA, 0xCB, 0xCD, 0xCE, 0xCF)


def _nvjpeg_decode(data: bytes, dev: torch.device) -> torch.Tensor:
    if not jpeg_has_end(data):
        raise _jpeg_error(2, "nvJPEG")
    lib = _build.nvjpeg_library()
    dims = np.zeros(11, np.int32)
    status = lib.mmtrs_nvjpeg_info(data, len(data), dims.ctypes.data)
    if status:
        raise _jpeg_error(status, "nvJPEG")
    if int(dims[2]) == 4:
        return cmyk_to_rgb(_nvjpeg_cmyk_planes(data, dims, dev), ycck=_is_ycck(data))
    h, w, gray = int(dims[0]), int(dims[1]), int(dims[2]) == 1
    with torch.cuda.device(dev):
        out = torch.empty((h, w) if gray else (h, w, 3), dtype=torch.uint8, device=dev)
        status = lib.mmtrs_nvjpeg_decode(data, len(data), out.data_ptr(), h, w, int(gray), _build.stream_handle())
    if status:
        raise _jpeg_error(status, "nvJPEG")
    # a one-component JPEG decodes to its Y plane; RGB repeats it, as
    # libjpeg's gray -> RGB conversion does
    return out[..., None].expand(h, w, 3).contiguous() if gray else out


def decode_paths(paths: list, min_edge: int = 0, threads: int = 0) -> tuple[list, np.ndarray]:
    """Decode JPEG files on a pool of ``threads`` host threads (0: up to 8),
    without resizing → (a u8 [H, W, 3] CPU tensor per decoded file, else
    None; int32 status per file: 0 ok, 1 min edge below ``min_edge``, 2
    decode error). A lossless or arithmetic-coded file is decoded on the
    pool by the port's own decoder and converted here, every other by the
    CPU backend's libjpeg into the buffer its tensor owns."""
    lib, own = _build.jpeg_library(), _build.jpeg_own_library()
    n = len(paths)
    if n == 0:
        return [], np.zeros(0, np.int32)
    c_paths = (ctypes.c_char_p * n)(*[os.fsencode(str(p)) for p in paths])
    pixels = (ctypes.c_void_p * n)()
    dims = np.zeros(2 * n, np.int32)
    status = np.zeros(n, np.int32)
    spaces = np.zeros(n, np.int32)
    nt = threads or min(8, os.cpu_count() or 1)
    lib.mmtrs_jpeg_decode_paths(ctypes.cast(c_paths, ctypes.c_void_p), n, min_edge, nt,
                                ctypes.cast(pixels, ctypes.c_void_p), dims.ctypes.data, status.ctypes.data,
                                ctypes.cast(own.mmtrs_jpeg_own_decode, ctypes.c_void_p), MAX_PIXELS,
                                spaces.ctypes.data)
    out = []
    for i in range(n):
        if status[i] != 0:
            out.append(None)
            continue
        h, w, space = int(dims[2 * i]), int(dims[2 * i + 1]), int(spaces[i])
        if space:
            c = {JCS_GRAYSCALE: 1, JCS_RGB: 3, JCS_YCBCR: 3}.get(space, 4)
            out.append(jpeg_planes_to_rgb(_own_tensor(own, pixels[i], h, w, c), space))
            continue
        buf = (ctypes.c_ubyte * (h * w * 3)).from_address(pixels[i])
        weakref.finalize(buf, lib.mmtrs_codec_free, pixels[i])
        out.append(torch.from_numpy(np.ctypeslib.as_array(buf).reshape(h, w, 3)))
    return out, status


def _rgb_u8(img) -> torch.Tensor:
    t = img if isinstance(img, torch.Tensor) else torch.from_numpy(np.array(img))  # a copy: any strides
    if t.dtype != torch.uint8 or t.dim() != 3 or t.shape[2] != 3:
        raise ValueError(f"needs an RGB u8 [H, W, 3] image, got {t.dtype} {tuple(t.shape)}")
    return t.contiguous()


def encode_jpeg(img, quality: int = 95) -> bytes:
    """RGB u8 [H, W, 3] (a numpy array or a tensor) → JPEG bytes at
    ``quality``, on the tensor's device: libjpeg for a CPU tensor or array
    (Pillow's ``save(..., quality=quality)``: baseline, 4:2:0), nvJPEG for
    a CUDA tensor (4:2:0)."""
    t = _rgb_u8(img)
    h, w = int(t.shape[0]), int(t.shape[1])
    out, n = ctypes.c_void_p(), np.zeros(1, np.int64)
    if t.device.type == "cuda":
        lib, free = _build.nvjpeg_library(), "mmtrs_nvjpeg_free"
        with torch.cuda.device(t.device):
            status = lib.mmtrs_nvjpeg_encode(t.data_ptr(), h, w, quality, ctypes.addressof(out), n.ctypes.data,
                                             _build.stream_handle())
        backend = "nvJPEG"
    elif t.device.type == "cpu":
        lib, free, backend = _build.jpeg_library(), "mmtrs_codec_free", "libjpeg"
        status = lib.mmtrs_jpeg_encode(t.data_ptr(), h, w, quality, ctypes.addressof(out), n.ctypes.data)
    else:
        raise ValueError(f"encode_jpeg: no JPEG encoder for a {t.device.type} tensor")
    if status:
        raise _jpeg_error(status, backend)
    try:
        return ctypes.string_at(out.value, int(n[0]))
    finally:
        getattr(lib, free)(out.value)


def _png_chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def encode_png(img) -> bytes:
    """RGB u8 [H, W, 3] → PNG bytes (8-bit RGB, every row Sub-filtered,
    zlib level 6 as Pillow's default). A CUDA tensor is copied to the host
    first."""
    a = _rgb_u8(img).cpu().numpy()
    h, w, _ = a.shape
    rows = a.reshape(h, w * 3)
    filtered = np.empty((h, w * 3 + 1), np.uint8)
    filtered[:, 0] = 1  # Sub: each byte minus the byte one pixel to its left, mod 256
    filtered[:, 1:4] = rows[:, :3]
    filtered[:, 4:] = rows[:, 3:] - rows[:, :-3]
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (PNG_MAGIC + _png_chunk(b"IHDR", ihdr) + _png_chunk(b"IDAT", zlib.compress(filtered.tobytes(), 6))
            + _png_chunk(b"IEND", b""))




# ---------------------------------------------------------------------------
# Host formats: the C loops
# ---------------------------------------------------------------------------


def _lzw(data: bytes, min_bits: int, tiff: bool, size: int) -> np.ndarray:
    """LZW-decoded bytes, at most ``size`` (fewer when the stream ends
    early); GIF's variant or TIFF's (``tiff``)."""
    out = np.zeros(max(size, 1), np.uint8)
    n = np.zeros(1, np.int64)
    status = _build.png_library().mmtrs_lzw_decode(data, len(data), min_bits, int(tiff), out.ctypes.data, size,
                                                   n.ctypes.data)
    if status:
        raise ValueError(f"corrupt {'TIFF' if tiff else 'GIF'}: an LZW code outside the table")
    return out[: int(n[0])]


def _packbits(data: bytes, size: int) -> np.ndarray:
    out = np.zeros(max(size, 1), np.uint8)
    n = np.zeros(1, np.int64)
    _build.png_library().mmtrs_packbits(data, len(data), out.ctypes.data, size, n.ctypes.data)
    return out[: int(n[0])]


# ---------------------------------------------------------------------------
# BMP
# ---------------------------------------------------------------------------


_BMP_COMPRESSION = {1: "BI_RLE8", 2: "BI_RLE4", 3: "BI_BITFIELDS", 4: "BI_JPEG", 5: "BI_PNG",
                    6: "BI_ALPHABITFIELDS", 11: "BI_CMYK", 12: "BI_CMYKRLE8", 13: "BI_CMYKRLE4"}


def _bmp_masked(px: np.ndarray, masks: tuple[int, int, int]) -> np.ndarray:
    """Little-endian pixel words → RGB by bit masks, each field scaled to 8
    bits as Pillow's unpackers do (v · 255 / (2^bits − 1))."""
    out = []
    for m in masks:
        shift = (m & -m).bit_length() - 1 if m else 0
        bits = bin(m).count("1")
        v = (px & m) >> shift if m else np.zeros_like(px)
        out.append(v if bits == 8 else (v * 255 // max((1 << bits) - 1, 1)))
    return np.stack(out, axis=-1).astype(np.uint8)


def decode_bmp(data: bytes) -> np.ndarray:
    """BMP bytes → RGB u8 [H, W, 3] numpy, as Pillow's ``convert("RGB")``
    (see the module docstring). Raises ValueError for a corrupt file and,
    naming it, for another header, compression or bit depth."""
    if data[:2] != b"BM" or len(data) < 30:
        raise ValueError("corrupt or truncated BMP: no file header")
    offset = struct.unpack("<I", data[10:14])[0]
    dib = struct.unpack("<I", data[14:18])[0]
    if dib == 12:  # OS/2 v1: 16-bit sizes, 3-byte palette entries, no compression
        w, h, _, bpp = struct.unpack("<HHHH", data[18:26])
        comp, n_colors, entry, top_down = 0, 0, 3, False
    elif dib in (40, 52, 56, 64, 108, 124):
        if len(data) < 14 + dib:
            raise ValueError("corrupt or truncated BMP: short info header")
        w, h, _, bpp, comp, _, _, _, n_colors, _ = struct.unpack("<iiHHIIiiII", data[18:54])
        entry, top_down = 4, data[25] == 0xFF
        if top_down:
            h = 2 ** 32 - (h & 0xFFFFFFFF)
    else:
        raise ValueError(f"BMP with a {dib}-byte header is not supported by the port's codec")
    if comp not in (0, 1, 2, 3):
        name = _BMP_COMPRESSION.get(comp, f"type {comp}")
        raise ValueError(f"BMP compression {comp} ({name}) is not supported by the port's codec")
    if bpp not in (1, 4, 8, 16, 24, 32):
        raise ValueError(f"{bpp}-bit BMP images are not supported by the port's codec")
    if (comp == 3 and bpp not in (16, 32)) or (comp in (1, 2) and bpp != (8 if comp == 1 else 4)):
        raise ValueError(f"BMP compression {comp} ({_BMP_COMPRESSION[comp]}) at {bpp} bits is not supported by the "
                         "port's codec")
    if w <= 0 or h <= 0:
        raise ValueError(f"corrupt BMP: size {w}x{h}")
    _check_pixels("BMP", w, h)
    pal_at = 14 + dib
    masks = None
    if comp == 3:
        if dib >= 52:
            masks = struct.unpack("<III", data[54:66])
        else:
            masks, pal_at = struct.unpack("<III", data[54:66]), pal_at + 12
    n_colors = n_colors or (1 << bpp if bpp <= 8 else 0)
    if offset == 14 + dib and bpp <= 8:  # Pillow: a palette the offset left out follows the header
        offset += 4 * n_colors

    if comp in (1, 2):
        flat = np.empty(w * h, np.uint8)
        body = data[offset:]
        _build.png_library().mmtrs_bmp_rle(body, len(body), int(comp == 2), offset % 2, w, h, flat.ctypes.data)
        index = flat.reshape(h, w)
    else:
        stride = (w * bpp + 31) // 32 * 4
        if len(data) < offset + stride * (h - 1) + (w * bpp + 7) // 8:
            raise ValueError("corrupt or truncated BMP: the pixel data ends early")
        buf = np.frombuffer(data, np.uint8, count=min(stride * h, len(data) - offset), offset=offset)
        rows = np.zeros((h, stride), np.uint8)
        rows.reshape(-1)[: buf.size] = buf
        if bpp > 8:
            if bpp == 24:
                px = rows[:, : w * 3].reshape(h, w, 3)[..., ::-1]
            else:
                words = rows[:, : w * bpp // 8].view("<u2" if bpp == 16 else "<u4").astype(np.int64)
                if masks is None or masks == (0, 0, 0):  # BI_RGB: 5-5-5, BGRX
                    masks = (0x7C00, 0x3E0, 0x1F) if bpp == 16 else (0xFF0000, 0xFF00, 0xFF)
                px = _bmp_masked(words, masks)
            out = px if top_down else px[::-1]
            return np.ascontiguousarray(out)
        index = rasters.unpack_bits(rows, w, bpp)
    if not top_down:
        index = index[::-1]
    if pal_at + entry * n_colors > max(offset, pal_at) or n_colors > 65536:
        raise ValueError("corrupt BMP: the palette overlaps the pixel data")
    pal = np.frombuffer(data, np.uint8, count=entry * n_colors, offset=pal_at).reshape(n_colors, entry)
    grays = (0, 255) if n_colors == 2 else range(n_colors)
    if all(tuple(pal[i, :3]) == (g, g, g) for i, g in enumerate(grays)):
        # Pillow drops a gray palette: mode "1" (2 colours) or "L", whose
        # values are the indices themselves
        g = np.where(index > 0, 255, 0).astype(np.uint8) if n_colors == 2 else index
        return convert_rgb(g, "L")
    return convert_rgb(index, "P", pal[:, 2::-1])


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------


# (x0, y0, dx, dy) of the seven Adam7 passes (PNG specification, 8.2)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _png_pass(raw: bytes, pos: int, w: int, h: int, channels: int, depth: int) -> tuple[np.ndarray, int]:
    """One (sub-)image's filtered rows from ``raw[pos:]`` → ([h, w,
    channels] samples, u8 or big-endian u16 as u16; the next position)."""
    stride = (w * channels * depth + 7) // 8
    need = h * (stride + 1)
    if len(raw) < pos + need:
        raise ValueError("truncated PNG: the image data ends early")
    rows = np.empty((h, stride), np.uint8)
    bad = _build.png_library().mmtrs_png_unfilter(raw[pos:pos + need], h, stride,
                                                  max(1, channels * depth // 8), rows.ctypes.data)
    if bad:
        raise ValueError(f"corrupt PNG: row {bad - 1} has an unknown filter type")
    if depth == 16:
        px = rows.view(">u2").reshape(h, w, channels)
    else:
        px = rasters.unpack_bits(rows, w * channels, depth).reshape(h, w, channels) if depth < 8 \
            else rows.reshape(h, w, channels)
    return px, pos + need


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes → RGB u8 [H, W, 3] numpy, as Pillow's ``convert("RGB")``
    (see the module docstring). Raises ValueError for a corrupt file."""
    if data[:8] != PNG_MAGIC:
        raise ValueError("not a PNG file")
    pos, header, palette, idat = 8, None, None, []
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            if idat and kind != b"IDAT":  # Pillow stops at a chunk cut after the image data
                break
            raise ValueError("truncated PNG")
        # Pillow checks the CRCs of the chunks before the image data only
        if not idat and kind != b"IDAT" and zlib.crc32(kind + body) != struct.unpack(">I", crc)[0]:
            raise ValueError(f"corrupt PNG: chunk {kind!r} fails its CRC")
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None or not idat:
        raise ValueError("corrupt PNG: no IHDR or IDAT chunk")
    w, h, depth, ctype, _, _, interlace = header
    _check_pixels("PNG", w, h)
    if ctype not in _PNG_CHANNELS or depth not in (1, 2, 4, 8, 16) \
            or (depth < 8 and ctype not in (0, 3)) or (depth == 16 and ctype == 3) or interlace > 1:
        raise ValueError(f"corrupt PNG: colour type {ctype} at {depth} bits, interlace {interlace}")
    if ctype == 3 and palette is None:
        raise ValueError("corrupt PNG: a palette image without PLTE")
    channels = _PNG_CHANNELS[ctype]
    passes = [((w - x0 + dx - 1) // dx, (h - y0 + dy - 1) // dy) for x0, y0, dx, dy in _ADAM7] if interlace \
        else [(w, h)]
    need = sum(ph * ((pw * channels * depth + 7) // 8 + 1) for pw, ph in passes if pw > 0 and ph > 0)
    try:  # as Pillow's ZIP decoder: inflate until the image is full (the checksum after it is not reached)
        raw = zlib.decompressobj().decompress(b"".join(idat), need)
    except zlib.error as e:
        raise ValueError(f"corrupt PNG: {e}") from None
    if interlace:
        px = np.zeros((h, w, channels), np.uint16 if depth == 16 else np.uint8)
        pos = 0
        for x0, y0, dx, dy in _ADAM7:
            pw, ph = (w - x0 + dx - 1) // dx, (h - y0 + dy - 1) // dy
            if pw > 0 and ph > 0:
                px[y0::dy, x0::dx], pos = _png_pass(raw, pos, pw, ph, channels, depth)
    else:
        px, _ = _png_pass(raw, 0, w, h, channels, depth)
    if ctype == 3:
        return convert_rgb(px, "P", palette)
    if depth == 16 and ctype == 0:  # Pillow's "I;16"
        return convert_rgb(px, "I;16")
    if depth == 16:  # the others' high bytes
        px = (px >> 8).astype(np.uint8)
    elif depth < 8:
        px = px * np.uint8(255 // ((1 << depth) - 1))
    return convert_rgb(px, "L" if ctype in (0, 4) else "RGB")


# ---------------------------------------------------------------------------
# GIF (the first frame)
# ---------------------------------------------------------------------------


def _gif_blocks(data: bytes, pos: int) -> tuple[bytes, int]:
    """The data sub-blocks from ``pos`` joined, and the position after
    their terminator."""
    out = []
    while pos < len(data):
        n = data[pos]
        pos += 1
        if n == 0:
            break
        out.append(data[pos:pos + n])
        pos += n
    return b"".join(out), pos


def decode_gif(data: bytes) -> np.ndarray:
    """GIF bytes → RGB u8 [H, W, 3] of the first frame, as Pillow's
    ``convert("RGB")`` (see the module docstring)."""
    if data[:6] not in (b"GIF87a", b"GIF89a") or len(data) < 13:
        raise ValueError("not a GIF file")
    sw, sh, flags = struct.unpack("<HHB", data[6:11])
    pos, palette, transparency = 13, None, None
    if flags & 0x80:
        n = 3 << ((flags & 7) + 1)
        palette, pos = np.frombuffer(data, np.uint8, count=min(n, len(data) - pos), offset=pos), pos + n
    while True:
        if pos >= len(data) or data[pos] == 0x3B:
            raise ValueError("corrupt GIF: no image")
        kind = data[pos]
        if kind == 0x21:  # extension: the graphic control's transparency index
            label = data[pos + 1]
            first = data[pos + 2:pos + 3 + data[pos + 2]] if pos + 2 < len(data) else b""
            if label == 0xF9 and len(first) >= 5 and first[1] & 1:
                transparency = first[4]
            _, pos = _gif_blocks(data, pos + 2)
        elif kind == 0x2C:
            break
        else:
            raise ValueError(f"corrupt GIF: block type {kind:#x}")
    if pos + 10 > len(data):
        raise ValueError("truncated GIF")
    x0, y0, fw, fh, fflags = struct.unpack("<HHHHB", data[pos + 1:pos + 10])
    pos += 10
    if fflags & 0x80:
        n = 3 << ((fflags & 7) + 1)
        palette, pos = np.frombuffer(data, np.uint8, count=min(n, len(data) - pos), offset=pos), pos + n
    if pos >= len(data):
        raise ValueError("truncated GIF")
    min_bits = data[pos]
    if not 1 <= min_bits <= 11:
        raise ValueError(f"corrupt GIF: LZW code size {min_bits}")
    H, W = max(sh, y0 + fh), max(sw, x0 + fw)
    _check_pixels("GIF", W, H, "canvas")  # covers the frame, which lies inside it
    stream, _ = _gif_blocks(data, pos + 1)
    pixels = _lzw(stream, min_bits, False, fw * fh)
    frame = np.zeros(fw * fh, np.uint8)
    frame[: pixels.size] = pixels
    frame = frame.reshape(fh, fw)
    if fflags & 0x40:  # interlaced: rows stored by passes 0::8, 4::8, 2::4, 1::2
        order = np.concatenate([np.arange(s, fh, d) for s, d in ((0, 8), (4, 8), (2, 4), (1, 2))])
        rows = np.empty_like(frame)
        rows[order] = frame
        frame = rows
    index = np.full((H, W), transparency or 0, np.uint8)
    index[y0:y0 + fh, x0:x0 + fw] = frame
    if palette is None or all(palette[i] == i // 3 for i in range(len(palette))):
        return convert_rgb(index, "L")  # Pillow's "L": the index is the gray level
    return convert_rgb(index, "P", palette[: len(palette) // 3 * 3].reshape(-1, 3))


# ---------------------------------------------------------------------------
# TIFF (the first image)
# ---------------------------------------------------------------------------


# the types Pillow's IFD reader loads (it drops the others, SLONG8 and IFD8
# among them)
_TIFF_TYPES = {1: "B", 2: "B", 3: "H", 4: "I", 5: "II", 6: "b", 7: "B", 8: "h", 9: "i", 10: "ii", 11: "f", 12: "d",
               13: "I", 16: "Q"}
_TIFF_COMPRESSION = {1: "none", 2: "CCITT RLE", 3: "CCITT Group 3", 4: "CCITT Group 4", 5: "LZW",
                     6: "old-style JPEG", 7: "JPEG", 8: "Adobe deflate", 32773: "PackBits",
                     32946: "deflate"}
_TIFF_PHOTOMETRIC = {0: "WhiteIsZero", 1: "BlackIsZero", 2: "RGB", 3: "palette", 4: "transparency mask",
                     5: "CMYK", 6: "YCbCr", 8: "CIELab"}
_BIT_REVERSE = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)


def _tiff_tags(data: bytes) -> tuple[str, dict[int, tuple]]:
    """The byte order and the first IFD's tags (tag → tuple of values; -1
    → the tags dropped: those of a type Pillow does not load, and those
    from the first whose values lie past the file's end, where Pillow stops
    reading the IFD, to the last; -4 → the raw entries (type, count, value
    field) of the tags libtiff reads apart, ``_TIFF_LIBTIFF_READS``; -5 →
    the tags past that first entry as libtiff reads them, which reads on
    and skips each entry whose values lie past the file's end; -6 → the
    tags libtiff cannot read: those past the file's end and those of a type
    it does not read as a number; -7 → the type of each tag Pillow loads). A
    BigTIFF (``II+``: 8-byte offsets and counts, 20-byte entries) is read
    as Pillow reads it; Pillow takes ``MM`` files for classic ones, whose
    first IFD then lies where bytes 4-7 say."""
    bo = "<" if data[:2] == b"II" else ">"
    big = data[2] == 43
    word, cnt = ("Q", "Q") if big else ("I", "H")
    wsize, esize = (8, 20) if big else (4, 12)
    ifd = struct.unpack(bo + word, data[8:16] if big else data[4:8])[0]
    if ifd + struct.calcsize(cnt) > len(data):
        raise ValueError("corrupt TIFF: the IFD lies beyond the file")
    n = struct.unpack(bo + cnt, data[ifd:ifd + struct.calcsize(cnt)])[0]
    first = ifd + struct.calcsize(cnt)
    tags, raw, libtiff, unread, types = {}, {}, {}, [], {}
    for i in range(n):
        e = first + esize * i
        if e + esize > len(data):
            raise ValueError("corrupt TIFF: the IFD runs past the end of the file")
        tag, typ, count = struct.unpack(bo + "HH" + word, data[e:e + 4 + wsize])
        if tag in _TIFF_LIBTIFF_READS:
            raw[tag] = (typ, count, data[e + 4 + wsize:e + esize])
        fmt = _TIFF_TYPES.get(typ)
        if fmt is None:  # a type Pillow does not load: it drops the tag
            tags[-1] = tags.get(-1, ()) + (tag,)
            if typ not in (17, 18) or not big:  # libtiff reads SLONG8 and IFD8 as integers, in BigTIFF
                unread.append(tag)
            continue
        vals = _ifd_values(data, bo, word, e + 4 + wsize, typ, fmt, count)
        if vals is None:  # Pillow's IFD reader stops at a tag whose values lie past the file's end
            tags[-1] = tags.get(-1, ()) + tuple(
                struct.unpack(bo + "H", data[first + esize * j:first + esize * j + 2])[0]
                for j in range(i, n) if first + esize * j + 2 <= len(data))
            unread.append(tag)
            for j in range(i + 1, n):
                e = first + esize * j
                if e + esize > len(data):
                    break
                tag, typ, count = struct.unpack(bo + "HH" + word, data[e:e + 4 + wsize])
                if tag in _TIFF_LIBTIFF_READS:
                    raw[tag] = (typ, count, data[e + 4 + wsize:e + esize])
                fmt = _TIFF_TYPES.get(typ)
                vals = None if fmt is None else _ifd_values(data, bo, word, e + 4 + wsize, typ, fmt, count)
                if vals is None:
                    unread.append(tag)
                else:
                    libtiff.setdefault(tag, vals)
            break
        tags[tag] = vals
        types[tag] = typ
        if typ in _TIFF_NOT_INTEGERS or (typ == 16 and not big):  # libtiff's integer readers refuse them
            unread.append(tag)
    tags[-4], tags[-5], tags[-6], tags[-7] = raw, libtiff, tuple(unread), types
    return bo, tags


def _ifd_values(data: bytes, bo: str, word: str, field: int, typ: int, fmt: str, count: int) -> tuple | None:
    """An IFD entry's values (rationals as floats), inline in its value
    field at ``field`` or at the offset it holds; None where they lie past
    the file's end."""
    size = struct.calcsize(bo + fmt) * count
    wsize = struct.calcsize(word)
    at = field if size <= wsize else struct.unpack(bo + word, data[field:field + wsize])[0]
    if at + size > len(data):
        return None
    vals = struct.unpack(f"{bo}{count * len(fmt)}{fmt[0]}", data[at:at + size])
    if typ in (5, 10):  # rationals: numerator over denominator
        vals = tuple(a / b if b else 0.0 for a, b in zip(vals[::2], vals[1::2]))
    return vals


# the tags without which libtiff's TIFFReadDirectory fails where it cannot
# read them: samples per pixel, compression, the sizes, planar
# configuration, rows per strip, extra samples, and the per-sample shorts
_TIFF_LIBTIFF_NEEDS = frozenset((277, 259, 256, 257, 32997, 322, 323, 32998, 284, 278, 338, 258, 280, 281, 32996,
                                 339))
# the types libtiff's TIFFReadDirEntryShort/Long do not take: ASCII,
# rationals, UNDEFINED, floats and IFD offsets
_TIFF_NOT_INTEGERS = frozenset((2, 5, 7, 10, 11, 12, 13))
# the tags Pillow's TiffImageFile._setup reads as numbers
_TIFF_NUMBERS = (256, 257, 258, 259, 262, 277, 339)
# the tags whose entries libtiff reads apart from Pillow for a compressed
# image: strip and tile offsets and counts, and YCbCrSubsampling
_TIFF_LIBTIFF_READS = (273, 279, 324, 325, 530)


def _libtiff_values(data: bytes, bo: str, big: bool, entry: tuple, n: int) -> tuple:
    """The first ``n`` values of an IFD entry (type, count, value field) as
    libtiff's TIFFReadDirEntryArrayWithLimit reads them: inline only when
    the whole array would fit the field, else from the offset the field
    holds (so an entry whose count was damaged reads its values from
    elsewhere, as libtiff does)."""
    typ, count, field = entry
    fmt = {1: "B", 6: "b", 3: "H", 8: "h", 4: "I", 9: "i", 16: "Q", 17: "q"}.get(typ)
    if fmt is None or count < n:
        raise ValueError("corrupt TIFF: strip or tile offsets or counts that libtiff cannot read")
    size, wsize = struct.calcsize(fmt), (8 if big else 4)
    if count * size <= wsize:
        raw = field[:n * size]
    else:
        at = struct.unpack(bo + ("Q" if big else "I"), field[:wsize])[0]
        raw = data[at:at + n * size]
        if len(raw) < n * size:
            raise ValueError("corrupt TIFF: strip or tile offsets or counts past the end of the file")
    vals = struct.unpack(f"{bo}{n}{fmt}", raw)
    if min(vals, default=0) < 0:  # a signed type's negative value: out of libtiff's range
        raise ValueError("corrupt TIFF: strip or tile offsets or counts that libtiff cannot read")
    return vals


def _libtiff_pair(t: dict, tag: int, default: tuple) -> tuple:
    """A two-value tag (YCbCrSubsampling) as libtiff's short array reader
    takes it: of an integer type, else the default stands."""
    vals = t.get(tag)
    if not vals or len(vals) < 2 or t[-7].get(tag, 3) not in (1, 3, 4, 6, 8, 9, 16, 17):
        return default
    return tuple(vals[:2])


def _libtiff_long(t: dict, tag: int) -> int:
    """A one-value offset or length tag as libtiff reads it: of an integer
    type and not negative, else 0 (libtiff drops it)."""
    vals = t.get(tag)
    if not vals or t[-7].get(tag, 4) not in (1, 3, 4, 6, 8, 9, 16, 17) or vals[0] < 0:
        return 0
    return vals[0]


def _libtiff_short(t: dict, tag: int, default: int) -> int:
    """A one-value tag as libtiff's TIFFReadDirEntryShort reads it: of an
    integer type and within 0-65535, else libtiff drops it (a warning) and
    the default stands."""
    vals = t.get(tag)
    typ = t[-7].get(tag, 3)
    if not vals or typ not in (1, 3, 4, 6, 8, 9, 16, 17) or not 0 <= vals[0] <= 65535:
        return default
    return vals[0]


# Pillow's TiffImagePlugin.OPEN_INFO (fill order 1): (photometric, sample
# formats, bits per sample, extra samples) → (mode, raw mode); the keys
# big-endian files lack, and those fill order 2 has too
_TIFF_MODES = {
    (0, (1,), (1,), ()): ("1", "1;I"), (1, (1,), (1,), ()): ("1", "1"), (0, (1,), (2,), ()): ("L", "L;2I"),
    (1, (1,), (2,), ()): ("L", "L;2"), (0, (1,), (4,), ()): ("L", "L;4I"), (1, (1,), (4,), ()): ("L", "L;4"),
    (0, (1,), (8,), ()): ("L", "L;I"), (1, (1,), (8,), ()): ("L", "L"), (1, (2,), (8,), ()): ("L", "L"),
    (1, (1,), (12,), ()): ("I;16", "I;12"), (0, (1,), (16,), ()): ("I;16", "I;16"),
    (1, (1,), (16,), ()): ("I;16", "I;16"), (1, (2,), (16,), ()): ("I", "I;16S"),
    (0, (3,), (32,), ()): ("F", "F;32F"), (1, (1,), (32,), ()): ("I", "I;32N"),
    (1, (2,), (32,), ()): ("I", "I;32S"), (1, (3,), (32,), ()): ("F", "F;32F"),
    (1, (1,), (8, 8), (2,)): ("LA", "LA"), (2, (1,), (8, 8, 8), ()): ("RGB", "RGB"),
    (2, (1,), (8, 8, 8, 8), ()): ("RGBA", "RGBA"), (2, (1,), (8, 8, 8, 8), (0,)): ("RGB", "RGBX"),
    (2, (1,), (8, 8, 8, 8, 8), (0, 0)): ("RGB", "RGBXX"), (2, (1,), (8, 8, 8, 8, 8, 8), (0, 0, 0)): ("RGB", "RGBXXX"),
    (2, (1,), (8, 8, 8, 8), (1,)): ("RGBA", "RGBa"), (2, (1,), (8, 8, 8, 8, 8), (1, 0)): ("RGBA", "RGBaX"),
    (2, (1,), (8, 8, 8, 8, 8, 8), (1, 0, 0)): ("RGBA", "RGBaXX"), (2, (1,), (8, 8, 8, 8), (2,)): ("RGBA", "RGBA"),
    (2, (1,), (8, 8, 8, 8, 8), (2, 0)): ("RGBA", "RGBAX"), (2, (1,), (8, 8, 8, 8, 8, 8), (2, 0, 0)): ("RGBA", "RGBAXX"),
    (2, (1,), (8, 8, 8, 8), (999,)): ("RGBA", "RGBA"), (2, (1,), (16, 16, 16), ()): ("RGB", "RGB;16L"),
    (2, (1,), (16, 16, 16, 16), ()): ("RGBA", "RGBA;16L"), (2, (1,), (16, 16, 16, 16), (0,)): ("RGB", "RGBX;16L"),
    (2, (1,), (16, 16, 16, 16), (1,)): ("RGBA", "RGBa;16L"), (2, (1,), (16, 16, 16, 16), (2,)): ("RGBA", "RGBA;16L"),
    (3, (1,), (1,), ()): ("P", "P;1"), (3, (1,), (2,), ()): ("P", "P;2"), (3, (1,), (4,), ()): ("P", "P;4"),
    (3, (1,), (8,), ()): ("P", "P"), (3, (1,), (8, 8), (0,)): ("P", "PX"), (3, (1,), (8, 8), (2,)): ("PA", "PA"),
    (5, (1,), (8, 8, 8, 8), ()): ("CMYK", "CMYK"), (5, (1,), (8, 8, 8, 8, 8), (0,)): ("CMYK", "CMYKX"),
    (5, (1,), (8, 8, 8, 8, 8, 8), (0, 0)): ("CMYK", "CMYKXX"), (5, (1,), (16, 16, 16, 16), ()): ("CMYK", "CMYK;16L"),
    (6, (1,), (8,), ()): ("L", "L"), (6, (1,), (8, 8, 8), ()): ("RGB", "RGBX"), (8, (1,), (8, 8, 8), ()): ("LAB", "LAB"),
}
_TIFF_NOT_BIG_ENDIAN = {(1, (1,), (32,), ()), (1, (1,), (12,), ()), (0, (1,), (16,), ())}
_TIFF_FILL_ORDER_2 = {(0, (1,), (1,), ()), (1, (1,), (1,), ()), (0, (1,), (2,), ()), (1, (1,), (2,), ()),
                      (0, (1,), (4,), ()), (1, (1,), (4,), ()), (0, (1,), (8,), ()), (1, (1,), (8,), ()),
                      (1, (1,), (16,), ()), (2, (1,), (8, 8, 8), ()), (3, (1,), (1,), ()), (3, (1,), (2,), ()),
                      (3, (1,), (4,), ()), (3, (1,), (8,), ())}
_TIFF_CCITT = (2, 3, 4)


def _tiff_bytes(data: bytes, offset: int, count: int, comp: int, size: int, reverse: bool, need: int) -> np.ndarray:
    """One strip or tile's bytes, decompressed to ``size`` (zero-padded),
    of which the file must give ``need``: Pillow's raw reader takes them
    from the offset whatever the byte count says; libtiff refuses a chunk
    past the file's end or one that decompresses to fewer bytes.
    ``reverse``: fill order 2, whose bits libtiff reverses before it
    decompresses (Pillow's raw reader after)."""
    if comp == 1:
        raw = data[offset:offset + need]
        if len(raw) < need:
            raise ValueError("truncated TIFF: the image data ends early")
    else:
        if offset + count > len(data):
            raise ValueError("corrupt TIFF: a strip or tile runs past the end of the file")
        raw = data[offset:offset + count]
    if reverse:
        raw = _BIT_REVERSE[np.frombuffer(raw, np.uint8)].tobytes()
    if comp == 1:
        out = np.frombuffer(raw, np.uint8)
    elif comp == 5:
        out = _lzw(raw, 8, True, size)
    elif comp in (8, 32946):
        try:
            # as libtiff's ZIPDecode: inflate until the chunk is full (the
            # checksum after it is not reached), an error before then fails
            out = np.frombuffer(zlib.decompressobj().decompress(raw, need), np.uint8)
        except zlib.error as e:
            raise ValueError(f"corrupt TIFF: {e}") from None
    else:
        out = _packbits(raw, size)
    if out.size < need:
        raise ValueError("corrupt TIFF: a strip or tile decompresses to fewer bytes than its rows need")
    full = np.zeros(size, np.uint8)
    full[: min(size, out.size)] = out[:size]
    return full


def _tiff_samples(buf: np.ndarray, rows: int, cols: int, n: int, depth: int, kind: str) -> np.ndarray:
    """A chunk's bytes → [rows, cols, n] samples: u8 for 1-8 bits, 12-bit
    packed as Pillow's I;12 unpacks it, 16- and 32-bit in the file's byte
    order (``kind``: a numpy dtype code without its order, e.g. ">u" or
    "<f")."""
    if depth <= 8:
        stride = (cols * n * depth + 7) // 8
        return rasters.unpack_bits(buf[: rows * stride].reshape(rows, stride), cols * n, depth).reshape(rows, cols, n)
    if depth == 12:
        stride = (cols * n * 12 + 7) // 8
        b = buf[: rows * stride].reshape(rows, stride).astype(np.uint16)
        pairs = -(-cols * n // 2)
        b = np.pad(b, ((0, 0), (0, 3 * pairs - stride)))
        trip = b.reshape(rows, pairs, 3)
        v = np.stack([(trip[..., 0] << 4) | (trip[..., 1] >> 4), ((trip[..., 1] & 15) << 8) | trip[..., 2]], -1)
        return v.reshape(rows, 2 * pairs)[:, : cols * n].reshape(rows, cols, n)
    dt = np.dtype(f"{kind}{depth // 8}")
    return buf[: rows * cols * n * dt.itemsize].view(dt).reshape(rows, cols, n)


def _fp_acc(buf: np.ndarray, rows: int, line: int, stride: int, nbytes: int) -> np.ndarray:
    """The floating-point predictor undone as libtiff's ``fpAcc`` undoes it,
    row by row: the bytes summed mod 256 along the row ``stride`` (samples
    a pixel) apart, then the row's byte planes (most significant first, each
    a byte of every sample) put back together in little-endian order, which
    libtiff leaves whatever the file's byte order (Pillow then reads them in
    the file's)."""
    b = buf[: rows * line].reshape(rows, line // stride, stride)
    b = np.cumsum(b, axis=1, dtype=np.uint8).reshape(rows, nbytes, line // nbytes)
    out = buf.copy()
    out[: rows * line] = b[:, ::-1].transpose(0, 2, 1).reshape(-1)
    return out


def _tiff_ycbcr_rgb(t: dict, ycc: np.ndarray) -> np.ndarray:
    """u8 [..., 3] YCbCr → RGB as libtiff's TIFFYCbCrToRGB (its fixed-point
    tables from the file's ReferenceBlackWhite and YCbCrCoefficients, in
    single precision), which Pillow reaches through TIFFRGBAImage."""
    f32 = np.float32
    luma = [f32(v) for v in t.get(529, (0.299, 0.587, 0.114))]
    rbw = [f32(v) for v in t.get(532, (0.0, 255.0, 128.0, 255.0, 128.0, 255.0))]
    fix = lambda v: int(np.floor(np.float64(v) * 65536 + 0.5))
    clamp2 = lambda v: min(max(v, f32(0)), f32(2))
    f1 = f32(2) - f32(2) * luma[0]
    f2 = luma[0] * f1 / luma[1]
    f3 = f32(2) - f32(2) * luma[2]
    f4 = luma[2] * f3 / luma[1]
    d1, d2, d3, d4 = fix(clamp2(f1)), -fix(clamp2(f2)), fix(clamp2(f3)), -fix(clamp2(f4))

    def code2v(c, rb, rw, cr):
        den = rw - rb if rw - rb != 0 else f32(1)
        return (f32(c) - f32(rb)) * f32(cr) / den

    clampw = lambda v, lo, hi: min(max(v, lo), hi)
    x = np.arange(256) - 128
    cr = np.array([int(clampw(code2v(v, rbw[4] - f32(128), rbw[5] - f32(128), 127), f32(-4096), f32(4096))) for v in x])
    cb = np.array([int(clampw(code2v(v, rbw[2] - f32(128), rbw[3] - f32(128), 127), f32(-4096), f32(4096))) for v in x])
    y_tab = np.array([int(clampw(code2v(v + 128, rbw[0], rbw[1], 255), f32(-4096), f32(4096))) for v in x])
    cr_r = (d1 * cr + 32768) >> 16
    cb_b = (d3 * cb + 32768) >> 16
    cr_g, cb_g = d2 * cr, d4 * cb + 32768
    y, b_, r_ = y_tab[ycc[..., 0]], ycc[..., 1].astype(np.int64), ycc[..., 2].astype(np.int64)
    rgb = np.stack([y + cr_r[r_], y + ((cb_g[b_] + cr_g[r_]) >> 16), y + cb_b[b_]], -1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def _tiff_ycbcr_blocks(buf: np.ndarray, rows: int, cols: int, hs: int, vs: int) -> np.ndarray:
    """A YCbCr chunk stored in subsampling blocks (hs × vs luma samples,
    then Cb and Cr) → [rows, cols, 3] samples, each block's chroma on each
    of its pixels, as libtiff's putcontig8bitYCbCr routines place it."""
    bw, bh = -(-cols // hs), -(-rows // vs)
    per = hs * vs + 2
    blocks = np.zeros(bh * bw * per, np.uint8)
    blocks[: min(blocks.size, buf.size)] = buf[: blocks.size]
    blocks = blocks.reshape(bh, bw, per)
    y = blocks[..., : hs * vs].reshape(bh, bw, vs, hs).transpose(0, 2, 1, 3).reshape(bh * vs, bw * hs)
    cb = np.repeat(np.repeat(blocks[..., hs * vs], vs, 0), hs, 1)
    cr = np.repeat(np.repeat(blocks[..., hs * vs + 1], vs, 0), hs, 1)
    return np.stack([y, cb, cr], -1)[:rows, :cols]


class _Tiff:
    """The first image's layout, read and checked as Pillow's
    TiffImageFile._setup reads it."""

    def __init__(self, data: bytes):
        self.bo, t = _tiff_tags(data)
        self.tags = t
        one = lambda tag, default=None: t.get(tag, (default,))[0]
        self.one = one
        # Pillow loads a BYTE or UNDEFINED entry as bytes and an ASCII one as
        # a str: its _setup takes neither as a size, a sample layout, a
        # compression or a photometric (which old-style JPEG does not read)
        # (nor, where it reads the strips itself, as the rows per strip)
        typed = [tag for tag in (*_TIFF_NUMBERS, 278) if t[-7].get(tag) in (1, 2, 7)
                 and not (tag == 262 and one(259) == 6 and t[-7].get(259) not in (1, 2, 7))
                 and not (tag == 278 and one(259, 1) != 1)]
        if typed:
            raise ValueError(f"corrupt TIFF: tag {typed[0]} of type {t[-7][typed[0]]}, which Pillow reads as other than a "
                             "number (Pillow refuses the file)")
        w, h = one(256), one(257)
        if not w or not h:
            raise ValueError("corrupt TIFF: no ImageWidth or ImageLength")
        _check_pixels("TIFF", w, h)
        self.w, self.h = w, h
        comp, planar = one(259, 1), 2 if one(284, 1) == 2 else 1  # Pillow tests for 2 alone
        photo = 6 if comp == 6 else one(262, 0)
        fill = one(266, 1)
        sf = t.get(339, (1,))
        if len(sf) > 1 and max(sf) == min(sf) == 1:
            sf = (1,)
        bps = t.get(258, (1,))
        extra = t.get(338, ())
        spp = one(277, 3 if comp == 6 and photo in (2, 6) else 1)
        if spp > 6:  # Pillow's MAX_SAMPLESPERPIXEL
            raise ValueError(f"corrupt TIFF: {spp} samples per pixel (Pillow: Invalid value for samples per pixel)")
        if spp < len(bps):
            bps = bps[:spp]
        elif spp > len(bps) and len(bps) == 1:
            bps = bps * spp
        key = (photo, tuple(sf), tuple(bps), tuple(extra))
        if len(bps) != spp or key not in _TIFF_MODES or (self.bo == ">" and key in _TIFF_NOT_BIG_ENDIAN) \
                or (fill == 2 and key not in _TIFF_FILL_ORDER_2):
            name = _TIFF_PHOTOMETRIC.get(photo, f"photometric {photo}")
            raise ValueError(f"TIFF {name} images at {'/'.join(map(str, bps))} bits (sample format "
                             f"{'/'.join(map(str, sf))}, extra samples {list(extra)}) are not supported by the port's "
                             "codec (nor by Pillow)")
        self.mode, self.rawmode = _TIFF_MODES[key]
        self.sample_format = t.get(339, (1,))[0]  # Pillow's, which its raw mode unpacks
        self.pillow_tags = t
        if comp not in (1, 2, 3, 4, 5, 6, 7, 8, 32773, 32946):
            name = _TIFF_COMPRESSION.get(comp, f"type {comp}")
            raise ValueError(f"TIFF compression ({name}, compression {comp}) is not supported by the port's codec")
        if comp != 1:
            # Pillow hands the file to libtiff, which reads the IFD on past
            # an entry where Pillow's reader stopped: Pillow's view gave the
            # mode and size, libtiff's gives the decode's layout. Where the
            # two views disagree on the size of a pixel or on YCbCr, Pillow's
            # unpacker would read libtiff's rows as another layout.
            for tag, ours in ((258, bps), (262, (photo,)), (277, (spp,))):
                theirs = t[-5].get(tag)
                if tag == 262 and 6 not in (*(theirs or ()), photo):
                    continue
                if tag == 277 and t.get(284, t[-5].get(284, (1,)))[:1] == (2,):
                    continue  # separate planes: Pillow reads the first ones, each laid out alike
                if theirs is not None and tag in t[-1] and tuple(theirs) != tuple(ours):
                    raise ValueError(f"corrupt TIFF: a damaged IFD that Pillow reads without tag {tag} and libtiff "
                                     f"reads with it ({list(theirs)}): the two would lay the samples out apart")
            bad = [tag for tag in t[-6] if tag in _TIFF_LIBTIFF_NEEDS]
            if bad:
                raise ValueError(f"corrupt TIFF: tag {bad[0]} cannot be read (its values lie past the file's end, or "
                                 "of another type): libtiff refuses the IFD")
            t = {**t[-5], **t}
            self.tags = t
            planar, fill = _libtiff_short(t, 284, 1), one(266, 1)
            # libtiff drops a one-value tag that holds several, and then fails the decode
            for tag in (256, 257, 259, 262, 266, 277, 278, 284, 317, 322, 323):
                if len(t.get(tag, (0,))) != 1:
                    raise ValueError(f"corrupt TIFF: tag {tag} holds other than the one value libtiff takes")
        if comp in _TIFF_CCITT and bps != (1,):
            raise ValueError(f"corrupt TIFF: CCITT compression of {bps}-bit samples")
        self.comp, self.photo, self.planar, self.fill, self.spp, self.bps = comp, photo, planar, fill, spp, bps
        self.predictor = one(317, 1) if comp == 1 else _libtiff_short(t, 317, 1)
        if self.predictor not in (1, 2, 3):
            raise ValueError(f"TIFF predictor {self.predictor} is not supported by the port's codec (nor by Pillow)")
        if self.predictor == 3 and comp in (5, 8, 32946) and t.get(339, (1,))[:1] != (3,):
            raise ValueError("corrupt TIFF: the floating-point predictor (3) on integer samples, which libtiff refuses")
        self.big = data[2] == 43
        if comp == 1 and any(t[-7].get(tag) in (2, 7) for tag in (273, 279, 324, 325)):
            # Pillow's raw reader takes the offsets and counts as integers: a str or bytes fails it
            raise ValueError("corrupt TIFF: strip or tile offsets or counts of a text or undefined type (Pillow "
                             "refuses them)")
        # the photometric libtiff's JPEG codec sees: one of an IFD type it
        # drops (Pillow reads it as a number), and then leaves the
        # components as stored
        self.jpeg_ycc = photo == 6 and planar == 1
        if comp == 7 and t[-7].get(262) in (13, 18) and photo == 6:
            self.jpeg_ycc = False
        elif comp == 7 and t[-7].get(262) in _TIFF_NOT_INTEGERS and photo == 6:
            raise ValueError("corrupt TIFF: a photometric tag libtiff cannot read, which its JPEG decode needs")
        if comp != 1:  # libtiff reads the offsets and counts: of SLONG8 too, not of IFD or IFD8
            if self.big and struct.unpack(self.bo + "HH", data[4:8]) != (8, 0):
                raise ValueError("corrupt TIFF: a BigTIFF header whose offset size is not 8 (libtiff refuses it)")
            for tag in (273, 279, 324, 325):
                typ = t[-4][tag][0] if tag in t[-4] else None
                if typ in (13, 18):
                    raise ValueError(f"corrupt TIFF: strip or tile offsets or counts of type {typ}, which libtiff "
                                     "refuses")
        if 322 in t:
            self.cw, self.ch = one(322), one(323)
            self.offsets = t[324] if comp == 1 else t.get(324, ())
            self.counts = t.get(325, (len(data),) * len(self.offsets))
        else:
            self.cw, self.ch = w, min(one(278, h), h)
            self.offsets = t[273] if comp == 1 else t.get(273, ())
            self.counts = t.get(279, (len(data),) * len(self.offsets))
        if not self.cw or not self.ch:
            raise ValueError("corrupt TIFF: a tile or strip of size 0")
        self.across, self.down = -(-w // self.cw), -(-h // self.ch)
        _check_pixels("TIFF", self.across * self.cw, self.down * self.ch, "grid of strips or tiles")
        self.planes = spp if planar == 2 else 1
        n_chunks = self.across * self.down * self.planes
        if comp != 1:  # libtiff's own reading of the offsets and counts
            off_tag, cnt_tag = (324, 325) if 322 in t else (273, 279)
            # libtiff's old-style JPEG hack: one strip may lack its offset or
            # count, the codec's read of it then failing
            self.strips_read = True
            if comp == 6 and (off_tag not in t[-4] or cnt_tag not in t[-4]) and n_chunks == 1 and 322 not in t:
                self.offsets, self.counts, self.strips_read = (0,), (0,), False
            elif off_tag not in t[-4]:
                raise ValueError("corrupt TIFF: no strip or tile offsets")
            else:
                self.offsets = _libtiff_values(data, self.bo, self.big, t[-4][off_tag], n_chunks)
                if cnt_tag in t[-4]:
                    self.counts = _libtiff_values(data, self.bo, self.big, t[-4][cnt_tag], n_chunks)
                    if n_chunks == 1 and 322 not in t and self.offsets[0] and not self.counts[0]:
                        # ByteCountLooksBad: one strip of no bytes, which
                        # EstimateStripByteCounts runs to the file's end
                        self.counts = (max(len(data) - self.offsets[0], 0),)
                else:  # libtiff's estimate, for the one strip it allows without counts: to the file's end
                    self.counts = tuple(max(len(data) - o, 0) for o in self.offsets)
        if len(self.offsets) < n_chunks:
            raise ValueError("corrupt TIFF: fewer strips or tiles than the image needs")
        # libtiff's YCbCrSubsampling, or (JPEGFixupTags) the first JPEG frame's
        self.ycc_sampling = None
        if 530 in t[-4] and t[-4][530][:2] in ((3, 2), (4, 2)):
            try:
                self.ycc_sampling = _libtiff_values(data, self.bo, self.big, t[-4][530], 2)
            except ValueError:  # its values past the file's end: libtiff drops the tag
                pass
        elif comp == 7 and 530 in t[-4] and t[-4][530][0] in (1, 6) and t[-4][530][1] >= 2:
            pair = _libtiff_values(data, self.bo, self.big, t[-4][530], 2)  # BYTE/SBYTE: libtiff reads them too
            if any(v not in (1, 2, 4) for v in pair):
                raise ValueError(f"corrupt TIFF: YCbCrSubsampling {list(pair)}, which libtiff refuses")
            self.ycc_sampling = pair

    def chunks(self):
        """(plane, row, column, offset, count) of each strip or tile: those
        the image needs (libtiff), or for an uncompressed image every
        offset as Pillow's raw reader places it, wrapping back to the top
        (a later strip then overwrites an earlier one), or the last alone
        where one strip covers a chunky image."""
        n = self.across * self.down
        if self.comp != 1:
            for i in range(n * self.planes):
                p, (r, c) = i // n, divmod(i % n, self.across)
                yield p, r, c, self.offsets[i], self.counts[i]
            return
        offsets = self.offsets
        if (self.cw, self.ch) == (self.w, self.h) and self.planar != 2:
            offsets = offsets[-1:]
        elif self.planar == 2 and len(offsets) > n * self.planes:
            raise ValueError("corrupt TIFF: more strips or tiles than the planes hold (Pillow cannot open it)")
        for i, off in enumerate(offsets):
            p, (r, c) = (i // n) % self.planes, divmod(i % n, self.across)
            yield p, r, c, off, self.counts[min(i, len(self.counts) - 1)]

    def jpeg_stream(self, data: bytes, offset: int, count: int) -> bytes:
        """A JPEG-in-TIFF chunk with the file's JPEGTables spliced in (libtiff
        refuses a chunk that runs past the file's end)."""
        if offset + count > len(data):
            raise ValueError("corrupt TIFF: a strip or tile runs past the end of the file")
        strip = data[offset:offset + count]
        tables = bytes(self.tags[347]) if 347 in self.tags else b""
        if len(tables) >= 4 and strip[:2] == b"\xff\xd8":
            return tables[:-2] + strip[2:]
        return strip


def decode_tiff(data: bytes) -> np.ndarray:
    """TIFF bytes → RGB u8 [H, W, 3] of the first image, as Pillow's
    ``convert("RGB")`` gives it (see the module docstring)."""
    return convert_rgb(*_tiff_samples_of(_Tiff(data), data))


def _tiff_samples_of(f: _Tiff, data: bytes) -> tuple[np.ndarray, str, np.ndarray | None]:
    """The image's samples in its Pillow mode, and its palette."""
    w, h, cw, ch = f.w, f.h, f.cw, f.ch
    per_chunk = 1 if f.planar == 2 else f.spp
    depth = f.bps[0]
    kind = f.bo + ("f" if f.sample_format == 3 else "i" if f.sample_format == 2 else "u")
    if f.comp == 6:
        img = _tiff_ojpeg(f, data)
    elif f.comp == 7:
        img = _tiff_jpeg_cpu(f, data)
    elif f.comp == 1 and f.photo == 6 and f.rawmode == "RGBX":
        img = _tiff_ycbcr_raw(f, data)
    else:
        dtype = np.uint8 if depth <= 8 else np.uint16 if depth <= 16 else np.dtype(kind.replace(">", "<") + "4")
        img = np.zeros((f.planes, f.down * ch, f.across * cw, per_chunk), dtype)
        ycc = f.photo == 6 and f.spp == 3
        hs, vs = f.tags.get(530, (2, 2))[:2] if ycc else (1, 1)
        for p, r, c, off, count in f.chunks():
            rows = min(ch, h - r * ch) if 322 not in f.tags or f.comp == 1 else ch
            if f.comp in _TIFF_CCITT:
                px = _ccitt(f, data, off, count, rows)
            elif ycc:
                size = -(-cw // hs) * -(-ch // vs) * (hs * vs + 2)
                need = -(-cw // hs) * -(-rows // vs) * (hs * vs + 2)
                buf = _tiff_bytes(data, off, count, f.comp, size, f.fill == 2, need)
                px = _tiff_ycbcr_rgb(f.tags, _tiff_ycbcr_blocks(buf, ch, cw, hs, vs))
            else:
                line = (cw * per_chunk * depth + 7) // 8
                size = ch * line
                if f.comp == 1:  # Pillow's raw tile: its last row as wide as the image shows
                    need = (rows - 1) * line + (min(cw, w - c * cw) * per_chunk * depth + 7) // 8
                else:
                    need = rows * line
                buf = _tiff_bytes(data, off, count, f.comp, size, f.fill == 2 and f.comp != 1, need)
                if f.fill == 2 and f.comp == 1:  # Pillow's raw modes ending in R
                    buf = _BIT_REVERSE[buf]
                if f.predictor == 3 and f.comp in (5, 8, 32946):
                    buf = _fp_acc(buf, ch, line, per_chunk, depth // 8)
                px = _tiff_samples(buf, ch, cw, per_chunk, depth, kind)
                if f.predictor == 2 and f.comp in (5, 8, 32946):  # libtiff's codecs with a predictor
                    px = np.cumsum(px, axis=1, dtype=px.dtype)
                if f.comp != 1 and f.bo == ">" and depth == 32 and f.predictor != 3:
                    # libtiff hands 32-bit samples over in native (little-endian)
                    # order; Pillow's raw mode reads them big-endian (it
                    # corrects 16-bit modes alone)
                    px = px.byteswap()
            img[p, r * ch:(r + 1) * ch, c * cw:(c + 1) * cw] = px.astype(img.dtype, copy=False)
        img = img[0] if f.planes == 1 else np.concatenate(list(img), axis=-1)
    px = img[:h, :w]
    return _tiff_mode_samples(f, px)


def _tiff_mode_samples(f: _Tiff, px: np.ndarray) -> tuple[np.ndarray, str, np.ndarray | None]:
    """Samples as decoded → samples in the Pillow mode, as Pillow's raw
    mode unpacks them."""
    raw, depth = f.rawmode, f.bps[0]
    if f.comp in (6, 7) or (f.photo == 6 and f.mode == "RGB"):
        return px, "RGB", None
    if f.mode == "P" or f.mode == "PA":
        cmap = np.asarray(f.pillow_tags[320], np.int64).reshape(3, -1).T // 256  # Pillow keeps the high byte
        return px[..., 0], "P", cmap.astype(np.uint8)
    if depth < 8 and f.mode in ("1", "L"):  # 1-, 2- and 4-bit gray, scaled, inverted for WhiteIsZero
        g = px[..., 0] * np.uint8(255 // ((1 << depth) - 1))
        return (255 - g if raw.endswith("I") or ";I" in raw else g), f.mode, None
    if f.mode in ("1", "L", "LA"):
        g = px[..., 0]
        return (255 - g if raw == "L;I" else g), "L", None
    if f.mode in ("I;16", "I", "F"):
        v = px[..., 0]
        if raw == "I;32N":  # unsigned 32-bit samples read as Pillow's signed I
            v = v.astype(np.uint32).view(np.int32)
        return v.astype(np.float32 if f.mode == "F" else np.int64), f.mode, None
    if f.mode == "LAB":  # Pillow's LAB raw mode stores a* and b* (signed) offset by 128; its
        # per-band raw modes of separate planes (L, A, B) copy the bytes
        return (px ^ np.array([0, 128, 128], np.uint8) if f.planar == 1 else px), "LAB", None
    if depth == 16:  # RGB;16L, RGBA;16L, CMYK;16L and kin: the high byte
        px = (px >> 8).astype(np.uint8)
    if "a" in raw:  # premultiplied alpha: Pillow's RGBa unpacker divides it out
        rgb, a = px[..., :3].astype(np.int64), px[..., 3:4].astype(np.int64)
        un = np.minimum(rgb * 255 // np.maximum(a, 1), 255)
        return np.where(a == 0, 0, np.where(a == 255, rgb, un)).astype(np.uint8), "RGB", None
    return px, f.mode, None


def _ccitt(f: _Tiff, data: bytes, offset: int, count: int, rows: int) -> np.ndarray:
    """A CCITT strip or tile of ``rows`` rows → [ch, cw, 1] u8 bits, 1 where
    the fax is black (libtiff's raster, which the photometric then reads)."""
    if offset + count > len(data):
        raise ValueError("corrupt TIFF: a strip or tile runs past the end of the file")
    raw = np.frombuffer(data[offset:offset + count], np.uint8)
    if f.fill == 2:
        raw = _BIT_REVERSE[raw]
    raw = raw.tobytes()
    out = np.zeros((f.ch, f.cw), np.uint8)
    done = np.zeros(1, np.int32)
    options = f.one(292, 0) if f.comp == 3 else 0
    status = _build.raster_library().mmtrs_ccitt_decode(raw, len(raw), f.cw, rows, f.comp, options,
                                                        out.ctypes.data, done.ctypes.data)
    if status:
        why = "a code outside T.4 or a run past the row" if status == 1 else "the data ends early"
        raise ValueError(f"corrupt TIFF: a {_TIFF_COMPRESSION[f.comp]} strip or tile ({why})")
    return out[..., None]


def _tiff_ycbcr_raw(f: _Tiff, data: bytes) -> np.ndarray:
    """Uncompressed YCbCr as Pillow reads it (raw mode RGBX, no colour
    conversion): four bytes a pixel from each strip's offset."""
    img = np.zeros((f.down * f.ch, f.w, 3), np.uint8)
    offsets = f.offsets[-1:] if (f.cw, f.ch) == (f.w, f.h) else f.offsets
    for i, off in enumerate(offsets):
        rows = min(f.ch, f.h - i * f.ch)
        px = np.frombuffer(data[off:off + 4 * f.cw * rows], np.uint8)
        if px.size < 4 * f.cw * rows:
            raise ValueError("truncated TIFF: the image data ends early")
        img[i * f.ch:i * f.ch + rows] = px.reshape(rows, f.cw, 4)[..., :3]
    return img


def _tiff_jpeg_check(f: _Tiff, stream: bytes) -> bool:
    """libtiff's checks of a JPEG-in-TIFF chunk's frame before it decodes
    (``JPEGPreDecode``): its component count (the samples of a pixel, or 1
    for separate planes), precision (the bits of a sample) and sampling
    (the first component's what ``YCbCrSubsampling`` says for YCbCr, 1 × 1
    otherwise; every other component's 1 × 1), each refused by name where
    Pillow refuses it. True when the frame is one for the own decoder,
    which takes it on either device."""
    head = jpeg_frame_header(stream)
    if head is None:
        return False  # the decoders name what is wrong
    marker, precision, _, _, comps = head
    ycc = f.jpeg_ycc
    if f.ycc_sampling is None:  # JPEGFixupTags: from the first chunk's frame, where libtiff's parser reads it
        f.ycc_sampling = tuple(comps[0][1:]) if marker in (0xC0, 0xC1, 0xC2, 0xC9, 0xCA) else (2, 2)
    hs, vs = f.ycc_sampling if ycc else (1, 1)
    if len(comps) != (1 if f.planar == 2 else f.spp):
        raise ValueError("corrupt TIFF: a JPEG strip or tile of another component count (libtiff refuses it)")
    if precision != f.bps[0]:
        raise ValueError(f"corrupt TIFF: a JPEG strip or tile of {precision}-bit precision in a TIFF of "
                         f"{f.bps[0]}-bit samples (libtiff refuses it)")
    if comps[0][1:] != (hs, vs) or any((h, v) != (1, 1) for _, h, v in comps[1:]):
        raise ValueError("corrupt TIFF: a JPEG strip or tile whose sampling factors the TIFF's do not allow "
                         "(libtiff refuses it)")
    if marker in OWN_FRAMES and marker in (0xC3, 0xC7, 0xCB, 0xCF) and ycc:
        raise ValueError("lossless JPEG-in-TIFF in YCbCr is not decoded (nor by Pillow: libjpeg converts no "
                         "colour in lossless mode)")
    return marker in OWN_FRAMES or (marker == 0xC2 and _own_takes_sof2(stream))


def _tiff_jpeg_own(f: _Tiff, stream: bytes) -> torch.Tensor:
    """A chunk through the port's own decoder as libtiff has libjpeg decode
    it: YCbCr photometric (chunky) converted, every other photometric's
    components as stored; u8 [h, w, C] on the CPU."""
    ycc = f.jpeg_ycc
    planes, _ = jpeg_own_planes(stream, JCS_YCBCR if ycc else JCS_UNKNOWN, libtiff=True)
    return ycc_to_rgb(planes) if ycc else planes


def _tiff_jpeg_cpu(f: _Tiff, data: bytes) -> np.ndarray:
    """JPEG-in-TIFF chunk by chunk, as libtiff decodes it: through libjpeg,
    or the port's own decoder for the frames it takes (lossless and
    arithmetic-coded); YCbCr converted to RGB, every other photometric's
    components as stored."""
    ycc = f.jpeg_ycc
    comps = 3 if ycc else (1 if f.planar == 2 else f.spp)
    img = np.zeros((f.planes, f.down * f.ch, f.across * f.cw, comps), np.uint8)
    dims = np.zeros(3, np.int32)
    for p, r, c, off, count in f.chunks():
        stream = f.jpeg_stream(data, off, count)
        if _tiff_jpeg_check(f, stream):
            out = _tiff_jpeg_own(f, stream).numpy()
            hh, ww = out.shape[:2]
            if ww != f.cw or hh > f.ch:
                raise ValueError("corrupt TIFF: a JPEG strip or tile of another size")
            img[p, r * f.ch:r * f.ch + hh, c * f.cw:(c + 1) * f.cw] = out
            continue
        lib = _build.jpeg_library()  # built only for a chunk libjpeg decodes
        status = lib.mmtrs_jpeg_info(stream, len(stream), dims.ctypes.data)
        hh, ww = int(dims[0]), int(dims[1])
        if status or ww != f.cw or hh > f.ch:
            raise ValueError("corrupt TIFF: a JPEG strip or tile that libjpeg cannot read, or of another size")
        out = np.empty((hh, ww, comps), np.uint8)
        if lib.mmtrs_jpeg_decode_tiff(stream, len(stream), out.ctypes.data, hh, ww, comps, int(ycc)):
            raise ValueError("corrupt TIFF: a JPEG strip or tile that libjpeg cannot decode")
        img[p, r * f.ch:r * f.ch + hh, c * f.cw:(c + 1) * f.cw] = out
    px = img[0] if f.planes == 1 else np.concatenate(list(img), axis=-1)
    return _tiff_jpeg_mode(f, px[:f.h, :f.w])


def _ojpeg_stream(f: _Tiff, data: bytes) -> bytes:
    """The JPEG stream libtiff's old-style JPEG codec (``tif_ojpeg.c``)
    hands to libjpeg. libtiff reads one
    byte stream: the ``JPEGInterchangeFormat`` bytes (cut at the file's
    end), then each strip's (a strip past the file's end skipped, one that
    runs past it cut there). It parses the markers at its start as
    ``OJPEGReadHeaderInfoSec`` does (SOI, APPn and COM skipped; DQT, DHT,
    DRI, SOF0/1/3 and SOS kept), or, where the stream holds no frame, takes
    the table tags (``JPEGQTables``, ``JPEGDCTables``, ``JPEGACTables``,
    ``JPEGRestartInterval``, the sampling of ``YCbCrSubsampling``), and
    writes its own header: SOI, the tables, DRI, SOF, SOS. The rest of the
    stream follows as the scan's data, an RSTn marker where one strip ends
    and another follows, then EOI."""
    t, size = f.tags, len(data)
    parts, striles = [], []  # striles: each strip's (start, end) in the stream
    jif = _libtiff_long(t, 513)
    if 0 < jif < size:
        n = _libtiff_long(t, 514)
        parts.append(data[jif:size if n == 0 or jif + n > size else jif + n])
    for _, _, _, off, count in f.chunks() if f.strips_read else ():
        start = sum(map(len, parts))
        if 0 < off < size:
            parts.append(data[off:size if count == 0 or off + count > size else off + count])
        striles.append((start, sum(map(len, parts))))
    buf = b"".join(parts)
    ends = [sum(map(len, parts[:k + 1])) for k in range(len(parts))]
    spp = f.spp

    def skip(k):  # OJPEGReadSkip: never past the end of the interchange stream or strip it is in
        nonlocal pos
        pos = min(pos + k, min((e for e in ends if e >= pos), default=pos))

    def bad(why):
        return ValueError(f"corrupt TIFF: an old-style JPEG {why} (libtiff refuses it)")

    pos = 0

    def take(k):
        nonlocal pos
        if pos + k > len(buf):
            raise bad("stream that ends inside its header")
        pos += k
        return buf[pos - k:pos]

    word = lambda: struct.unpack(">H", take(2))[0]
    qtab, dctab, actab = [None] * 4, [None] * 4, [None] * 4
    # OJPEGReadHeaderInfo: over several strips the restart interval is a
    # strip's MCUs, whatever JPEGRestartInterval says (a DRI marker in the
    # stream overrides it); one strip keeps the tag's
    restart = _libtiff_short(t, 515, 0)
    ycc = spp == 3 and _libtiff_short(t, 262, 6) == 6 and f.planar == 1
    hs, vs = _libtiff_pair(t, 530, (2, 2)) if ycc else (1, 1)
    rps = t.get(278, (f.h,))[0]
    if isinstance(rps, int) and 0 < rps < f.h and isinstance(hs, int) and isinstance(vs, int) and hs > 0 and vs > 0:
        restart = -(-f.w // (8 * hs)) * (rps // (8 * vs))
    sof = None  # (marker, height, width, [(id, hv, tq)])
    sos = None  # [(id, tda)]
    m = 0
    while m != 0xDA:
        if pos >= len(buf):  # the first peek finds no data: the header is never read
            raise bad("stream without data")
        if buf[pos] != 0xFF:
            break
        pos += 1
        m = take(1)[0]
        while m == 0xFF:
            m = take(1)[0]
        if m == 0xD8:
            continue
        if m == 0xFE or 0xE0 <= m <= 0xEF:
            n = word()
            if n < 2:
                raise bad("marker segment shorter than its length")
            skip(n - 2)
        elif m == 0xDD:
            if word() != 4:
                raise bad("DRI marker")
            restart = word()
        elif m == 0xDB:
            n = word()
            if n <= 2:
                raise bad("DQT marker")
            n -= 2
            while n > 0:
                if n < 65:
                    raise bad("DQT marker")
                body = take(65)
                if body[0] & 15 > 3:
                    raise bad("DQT marker")
                qtab[body[0] & 15] = b"\xff\xdb\x00\x43" + body
                n -= 65
        elif m == 0xC4:
            n = word()
            if n <= 2:
                raise bad("DHT marker")
            body = take(n - 2)
            o = body[0]
            if o >> 4 not in (0, 1) or o & 15 > 3:
                raise bad("DHT marker")
            (actab if o >> 4 else dctab)[o & 15] = b"\xff\xc4" + struct.pack(">H", n) + body
        elif m in (0xC0, 0xC1, 0xC3):
            if sof is not None:
                raise bad("stream with a second frame header")
            n = word()
            if n < 11 or (n - 8) % 3:
                raise bad("SOF marker")
            nc = (n - 8) // 3
            if nc != spp:
                raise bad("frame of another number of samples")
            if take(1)[0] != 8:
                raise bad("frame of other than 8 bits a sample")
            height, width = word(), word()
            if height < f.h or width != f.w:
                raise bad("frame of another size")
            if take(1)[0] != nc:
                raise bad("SOF marker")
            sof = (m, height, width, [tuple(take(3)) for _ in range(nc)])
        elif m == 0xDA:
            if word() != 6 + 2 * spp or take(1)[0] != spp:
                raise bad("SOS marker")
            sos = [tuple(take(2)) for _ in range(spp)]
            skip(3)
        else:
            raise bad(f"stream with an unknown marker 0x{m:02x}")
    if sof is None:  # the table tags
        ycc = spp == 3 and _libtiff_short(t, 262, 6) == 6 and f.planar == 1
        hs, vs = _libtiff_pair(t, 530, (2, 2)) if ycc else (1, 1)
        # OJPEGReadHeaderInfo over several strips: the subsampling (with no
        # frame header in the stream, the tag's or its (2, 2) default) must
        # divide a strip's rows
        if isinstance(rps, int) and 0 < rps < f.h and (hs not in (1, 2, 4) or vs not in (1, 2, 4) or rps % (8 * vs)):
            raise bad("strips whose length the subsampling does not divide")
        sof = (0xC0, f.h, f.w, [(k, (hs << 4 | vs) if k == 0 else 0x11, 0) for k in range(spp)])
        tq, tda = [0] * spp, [0] * spp
        for tag, kind in ((519, "q"), (520, 0x00), (521, 0x10)):
            offs = t.get(tag, (0,) * spp) if t[-7].get(tag, 4) not in _TIFF_NOT_INTEGERS else (0,) * spp
            if min(offs, default=0) < 0:  # a signed type's negative value: libtiff drops the tag
                offs = (0,) * spp
            if len(offs) != spp or offs[0] == 0:  # libtiff sets no table tag of another count
                raise bad(f"without its tag {tag} (JPEG tables)")
            for k in range(spp):
                if offs[k] == 0 or (k and offs[k] == offs[k - 1]):
                    if kind == "q":
                        tq[k] = tq[k - 1]
                    else:
                        tda[k] = tda[k] | (tda[k - 1] & (0xF0 if kind == 0 else 0x0F))
                    continue
                if offs[k] in offs[:max(k - 1, 0)]:
                    raise bad(f"tag {tag} naming one table for two components")
                if kind == "q":
                    body = data[offs[k]:offs[k] + 64]
                    if len(body) < 64:
                        raise bad("quantisation table past the end of the file")
                    qtab[k], tq[k] = b"\xff\xdb\x00\x43" + bytes([k]) + body, k
                    continue
                counts = data[offs[k]:offs[k] + 16]
                values = data[offs[k] + 16:offs[k] + 16 + sum(counts)]
                if len(counts) < 16 or len(values) < sum(counts):
                    raise bad("Huffman table past the end of the file")
                (actab if kind else dctab)[k] = (b"\xff\xc4" + struct.pack(">H", 19 + len(values)) + bytes([kind | k])
                                                  + counts + values)
                tda[k] |= k << 4 if kind == 0 else k
        sof = (sof[0], sof[1], sof[2], [(c, hv, tq[k]) for k, (c, hv, _) in enumerate(sof[3])])
        sos = [(k, tda[k]) for k in range(spp)]
    elif sos is None:
        raise bad("stream without a scan header")
    marker, height, width, comps = sof
    out = bytearray(b"\xff\xd8")
    for table in (*qtab, *dctab, *actab):
        out += table or b""
    if restart:
        out += b"\xff\xdd\x00\x04" + struct.pack(">H", restart)
    out += bytes([0xFF, marker]) + struct.pack(">HBHHB", 8 + 3 * spp, 8, height, width, spp)
    for c in comps:
        out += bytes(c)
    out += b"\xff\xda" + struct.pack(">HB", 6 + 2 * spp, spp)
    for c in sos:
        out += bytes(c)
    out += b"\x00\x3f\x00"
    at, rst = pos, 0
    for k, (start, end) in enumerate(striles):
        if end > at:
            out += buf[at:end]
            at = end
        if end > start and end > pos and k + 1 < len(striles):  # a strip's data ends and another strip follows
            out += bytes([0xFF, 0xD0 + rst])
            rst = (rst + 1) & 7
    out += buf[at:]
    # EOI follows the last strip's data; where the last strip holds none
    # (or none could be read) libtiff's source fails when libjpeg asks for more
    ends_well = bool(striles) and striles[-1][1] > striles[-1][0]
    return bytes(out) + (b"\xff\xd9" if ends_well else b"")


def _tiff_ojpeg(f: _Tiff, data: bytes) -> np.ndarray:
    """Old-style JPEG-in-TIFF (compression 6) as libtiff decodes it and
    Pillow reads it: the stream of ``_ojpeg_stream`` through the port's
    own decoder on the host, as libjpeg decodes it for libtiff. Chunky
    YCbCr comes out as raw, subsampled planes, each chroma sample then
    standing for its block (the luma's sampling factors, libtiff's
    corrected YCbCrSubsampling) and converted by libtiff's TIFFYCbCrToRGB,
    as TIFFRGBAImage does for Pillow; a sampling TIFF cannot hold (chroma
    other than 1 × 1, luma other than 1, 2 or 4) is upsampled by libjpeg
    first; one component is read as stored (mode L). → [H, W, 3] RGB."""
    if f.planar == 2 or 322 in f.tags:
        raise ValueError("TIFF old-style JPEG in separate planes or tiles is not supported by the port's codec")
    photo = _libtiff_short(f.tags, 262, 6)  # libtiff takes YCbCr where it cannot read the tag
    if f.spp == 1 and photo == 6:
        raise ValueError("corrupt TIFF: an old-style JPEG of one sample taken for YCbCr (its photometric tag "
                         "unreadable), which libtiff cannot decode")
    if f.spp == 3 and photo != 6:
        raise ValueError(f"TIFF old-style JPEG of 3 samples in photometric {photo} (not YCbCr) is not supported by "
                         "the port's codec")
    if f.spp not in (1, 3):
        raise ValueError(f"TIFF old-style JPEG of {f.spp} samples is not supported by the port's codec")
    stream = _ojpeg_stream(f, data)
    lib = _build.jpeg_own_library()
    out, dims = ctypes.c_void_p(), np.zeros(20, np.int32)
    msg = ctypes.create_string_buffer(256)
    status = lib.mmtrs_jpeg_own_decode_raw(stream, len(stream), MAX_PIXELS, ctypes.addressof(out), dims.ctypes.data,
                                           ctypes.addressof(msg))
    if status:
        raise _own_error(status, msg.value.decode(), dims)
    h, w, n, delivered = (int(v) for v in dims[:4])
    comps = [tuple(int(v) for v in dims[4 + 4 * k:8 + 4 * k]) for k in range(n)]
    total = sum(dh * dw for dh, dw, _, _ in comps)
    buf = (ctypes.c_ubyte * max(total, 1)).from_address(out.value)
    flat = np.ctypeslib.as_array(buf)[:total].copy()
    lib.mmtrs_jpeg_own_free(out)
    planes, at = [], 0
    for dh, dw, _, _ in comps:
        planes.append(flat[at:at + dh * dw].reshape(dh, dw))
        at += dh * dw
    if n != f.spp or w != f.w or h < f.h:
        raise ValueError("corrupt TIFF: an old-style JPEG stream of another size or component count")
    h = f.h  # libtiff reads the image's rows of a taller frame
    if delivered != -1:
        # libtiff's source ran dry (or its resync failed) in the strip that
        # needed iMCU row ``delivered``. Pillow reads mode L strip by strip
        # and raises; in YCbCr it calls TIFFRGBAImageGet a strip at a time,
        # which keeps a failed strip's buffer (zeroed, then the rows decoded)
        # but fails outright on the next strip, whose OJPEGPreDecode must
        # skip the failed rows first and fails again: only a failure in the
        # last strip lets the image through
        delivered = delivered if delivered >= 0 else -2 - delivered
        rps = f.tags.get(278, (h,))[0] or h
        strip = delivered * 8 * comps[0][3] // rps
        if n == 1 or strip < -(-h // rps) - 1:
            raise ValueError("corrupt TIFF: an old-style JPEG strip that libtiff cannot read")
    if n == 1:  # Pillow's mode L, repeated into RGB
        return np.repeat(planes[0][:h, :, None], 3, -1)
    (_, _, hs, vs), rest = comps[0], comps[1:]
    if any((ch, cv) != (1, 1) for _, _, ch, cv in rest) or hs not in (1, 2, 4) or vs not in (1, 2, 4):
        raise ValueError("TIFF old-style JPEG with a sampling TIFF cannot hold is not supported by the port's codec")
    rows, cols = np.arange(h) // vs, np.arange(w) // hs
    ycc = np.stack([planes[0][:h], planes[1][rows][:, cols], planes[2][rows][:, cols]], -1)
    if delivered >= 0:  # TIFFRGBAImage goes on past libtiff's error: the rows not decoded stay zero
        ycc[delivered * 8 * vs:] = 0
    return _tiff_ycbcr_rgb(f.tags, ycc)


def _tiff_jpeg_mode(f: _Tiff, px):
    """JPEG-in-TIFF samples (numpy or torch) → RGB as Pillow converts the
    mode libtiff's JPEG codec gives."""
    if f.photo == 6:
        return px
    if f.mode == "CMYK":
        return cmyk2rgb(torch.from_numpy(px)).numpy() if isinstance(px, np.ndarray) else cmyk2rgb(px)
    if f.mode in ("L", "1"):
        g = px[..., :1]
        g = 255 - g if f.photo == 0 else g
        return np.repeat(g, 3, axis=2) if isinstance(px, np.ndarray) else g.expand(*g.shape[:2], 3).contiguous()
    return px[..., :3]


def decode_tiff_to(data: bytes, dev: torch.device) -> torch.Tensor:
    """A TIFF onto ``dev``: JPEG-in-TIFF on the card through nvJPEG, chunk by
    chunk into a CUDA tensor (no host route); everything else on the host."""
    if dev.type != "cuda":
        return torch.from_numpy(decode_tiff(data))
    f = _Tiff(data)
    if f.comp != 7:
        return torch.from_numpy(decode_tiff(data)).to(dev)
    return _tiff_jpeg_cuda(f, data, dev)


def _tiff_jpeg_cuda(f: _Tiff, data: bytes, dev: torch.device) -> torch.Tensor:
    lib = _build.nvjpeg_library()
    ycc = f.jpeg_ycc
    comps = 3 if ycc else (1 if f.planar == 2 else f.spp)
    dims = np.zeros(11, np.int32)
    with torch.cuda.device(dev):
        img = torch.zeros((f.planes, f.down * f.ch, f.across * f.cw, comps), dtype=torch.uint8, device=dev)
        for p, r, c, off, count in f.chunks():
            stream = f.jpeg_stream(data, off, count)
            if _tiff_jpeg_check(f, stream):  # the own decoder's frames: on the host, converted on the card
                planes = _tiff_jpeg_own(f, stream) if not f.jpeg_ycc else None
                if planes is None:
                    stored, _ = jpeg_own_planes(stream, JCS_YCBCR, libtiff=True)
                    planes = ycc_to_rgb(stored.to(dev))
                hh, ww = planes.shape[:2]
                if ww != f.cw or hh > f.ch:
                    raise ValueError("corrupt TIFF: a JPEG strip or tile of another size")
                img[p, r * f.ch:r * f.ch + hh, c * f.cw:(c + 1) * f.cw] = planes.to(dev)
                continue
            if not jpeg_has_end(stream):
                raise _jpeg_error(2, "nvJPEG")
            status = lib.mmtrs_nvjpeg_info(stream, len(stream), dims.ctypes.data)
            if status:
                raise _jpeg_error(status, "nvJPEG")
            hh, ww, n = int(dims[0]), int(dims[1]), int(dims[2])
            if ww != f.cw or hh > f.ch or n != comps:
                raise ValueError("corrupt TIFF: a JPEG strip or tile of another size or component count")
            dst = img[p, r * f.ch:r * f.ch + hh, c * f.cw:(c + 1) * f.cw]
            if n == 1:
                out = torch.empty((hh, ww), dtype=torch.uint8, device=dev)
                status = lib.mmtrs_nvjpeg_decode(stream, len(stream), out.data_ptr(), hh, ww, 1, _build.stream_handle())
                dst[..., 0] = out
            elif ycc:
                out = torch.empty((hh, ww, 3), dtype=torch.uint8, device=dev)
                status = lib.mmtrs_nvjpeg_decode(stream, len(stream), out.data_ptr(), hh, ww, 0, _build.stream_handle())
                dst.copy_(out)
            else:  # RGB or CMYK samples as stored: nvJPEG's planes, unconverted
                planes = [torch.empty((int(dims[3 + 2 * k]), int(dims[4 + 2 * k])), dtype=torch.uint8, device=dev)
                          for k in range(n)]
                ptrs = (ctypes.c_void_p * n)(*[q.data_ptr() for q in planes])
                status = lib.mmtrs_nvjpeg_decode_planes(stream, len(stream), ctypes.addressof(ptrs),
                                                        _build.stream_handle())
                for k, q in enumerate(planes):
                    dst[..., k] = q.repeat_interleave(-(-hh // q.shape[0]), 0)[:hh].repeat_interleave(
                        -(-ww // q.shape[1]), 1)[:, :ww]
            if status:
                raise _jpeg_error(status, "nvJPEG")
        px = img[0] if f.planes == 1 else torch.cat(list(img), dim=-1)
        return _tiff_jpeg_mode(f, px[:f.h, :f.w]).contiguous()


# ---------------------------------------------------------------------------
# WebP (the first frame)
# ---------------------------------------------------------------------------


_WEBP_MAX_CHUNK = 2 ** 32 - 10  # libwebp's MAX_CHUNK_PAYLOAD
_WEBP_MAX_AREA = 2 ** 32  # libwebp's MAX_IMAGE_AREA: a larger canvas or frame is corrupt
_WEBP_VP8X_FLAGS = 0x3E  # ICC profile, alpha, EXIF, XMP, animation
_WEBP_ALPHA_FLAG, _WEBP_ANIMATION_FLAG = 0x10, 0x02
_WEBP_STATUS = {1: "truncated WebP: the {} bitstream ends early", 2: "corrupt WebP: a bad {} bitstream",
                3: "corrupt WebP: the VP8 bitstream is an inter frame (a WebP holds key frames only)"}


def _le(data: bytes, pos: int, n: int) -> int:
    return int.from_bytes(data[pos:pos + n], "little")


def _webp_chunk(data: bytes, pos: int, end: int) -> tuple[bytes, int, int, int]:
    """The chunk at ``pos`` → (fourcc, payload offset, payload size, offset
    after its padding); raises when it runs past the RIFF chunk's ``end``."""
    if end - pos < 8:
        raise ValueError("truncated WebP: a chunk header runs past the RIFF chunk")
    fourcc, size = data[pos:pos + 4], _le(data, pos + 4, 4)
    padded = size + (size & 1)
    if size > _WEBP_MAX_CHUNK or padded > end - pos - 8:
        raise ValueError(f"corrupt WebP: the {fourcc!r} chunk of {size} bytes runs past the RIFF chunk")
    return fourcc, pos + 8, size, pos + 8 + padded


def _webp_image_size(fourcc: bytes, payload: bytes, size: int) -> tuple[int, int]:
    """The width and height in a VP8 or VP8L bitstream's header, checked as
    libwebp's VP8GetInfo and VP8LGetInfo check it."""
    if fourcc == b"VP8 ":
        if len(payload) < 10:
            raise ValueError("truncated WebP: a VP8 frame header of fewer than 10 bytes")
        bits = _le(payload, 0, 3)
        if payload[3:6] != b"\x9d\x01\x2a":
            raise ValueError(_WEBP_STATUS[3] if bits & 1 else "corrupt WebP: no VP8 start code")
        if bits & 1:
            raise ValueError(_WEBP_STATUS[3])
        if (bits >> 1) & 7 > 3 or not (bits >> 4) & 1 or bits >> 5 >= size:
            raise ValueError("corrupt WebP: a bad VP8 frame header (profile, show flag or first partition)")
        w, h = _le(payload, 6, 2) & 0x3FFF, _le(payload, 8, 2) & 0x3FFF
    else:
        if len(payload) < 5 or payload[0] != 0x2F or payload[4] >> 5:
            raise ValueError("corrupt WebP: a bad VP8L header (signature or version)")
        bits = _le(payload, 1, 4)
        w, h = (bits & 0x3FFF) + 1, ((bits >> 14) & 0x3FFF) + 1
    if not w or not h:
        raise ValueError(f"corrupt WebP: a {w}x{h} image")
    return w, h


def _webp_frame(data: bytes, pos: int, end: int) -> tuple[dict, int]:
    """One frame's chunks from ``pos`` as libwebp's demuxer stores them
    (StoreFrame): an ALPH chunk, then a VP8 or VP8L one; parsing stops at
    any other chunk. → (frame, position after it)."""
    frame: dict = {"alpha": None, "image": None, "w": 0, "h": 0, "x": 0, "y": 0}
    while pos != end:
        fourcc, start, size, nxt = _webp_chunk(data, pos, end)
        if fourcc == b"ALPH" and frame["alpha"] is None:
            frame["alpha"] = (pos, data[start:start + size])
        elif fourcc in (b"VP8 ", b"VP8L") and frame["image"] is None:
            if fourcc == b"VP8L" and frame["alpha"] is not None:
                raise ValueError("corrupt WebP: an ALPH chunk before a VP8L image, which carries its own alpha")
            frame["w"], frame["h"] = _webp_image_size(fourcc, data[start:nxt], size)
            frame["image"] = (pos, fourcc, data[start:nxt])  # the padding byte too, as libwebp hands it on
        else:
            break
        pos = nxt
        if end - pos < 8 and pos != end:
            raise ValueError("truncated WebP: a chunk header runs past the RIFF chunk")
    return frame, pos


def _webp_parse(data: bytes) -> tuple[int, int, dict]:
    """The RIFF container as libwebp's demuxer parses it for Pillow's
    WebPAnimDecoder → (canvas width, canvas height, first frame). Refuses
    what the demuxer refuses and a canvas or frame over MAX_PIXELS."""
    if len(data) < 20:
        raise ValueError("truncated WebP: no RIFF header")
    riff_size = _le(data, 4, 4)
    if riff_size < 8 or riff_size > _WEBP_MAX_CHUNK:
        raise ValueError(f"corrupt WebP: a RIFF size of {riff_size}")
    end = riff_size + 8
    if len(data) < end:
        raise ValueError(f"truncated WebP: the RIFF chunk says {riff_size} bytes, the file holds {len(data) - 8}")
    first = data[12:16]
    if first in (b"VP8 ", b"VP8L"):  # simple: one frame, the canvas its size
        frame, _ = _webp_frame(data, 12, end)
        if frame["image"] is None:
            raise ValueError("corrupt WebP: no image chunk")
        frame["alpha"] = None  # an ALPH chunk after the image: dropped, as without VP8X's alpha flag
        _check_pixels("WebP", frame["w"], frame["h"])
        return frame["w"], frame["h"], frame
    if first != b"VP8X":
        raise ValueError(f"corrupt WebP: the first chunk is {first!r}")
    _, start, size, pos = _webp_chunk(data, 12, end)
    if size < 10:
        raise ValueError("corrupt WebP: a VP8X chunk of fewer than 10 bytes")
    flags = data[start]
    cw, ch = 1 + _le(data, start + 4, 3), 1 + _le(data, start + 7, 3)
    if cw * ch >= _WEBP_MAX_AREA or flags & ~_WEBP_VP8X_FLAGS & 0xFF:
        raise ValueError(f"corrupt WebP: a VP8X canvas of {cw}x{ch} with flags {flags:#x}")
    _check_pixels("WebP", cw, ch, "canvas")
    animated = bool(flags & _WEBP_ANIMATION_FLAG)
    frames, anim = [], False
    if end - pos < 8:
        raise ValueError("truncated WebP: nothing after the VP8X chunk")
    while True:
        fourcc, start, size, nxt = _webp_chunk(data, pos, end)
        if fourcc == b"VP8X":
            raise ValueError("corrupt WebP: a second VP8X chunk")
        if fourcc in (b"ALPH", b"VP8 ", b"VP8L"):
            if anim or animated or frames:
                raise ValueError(f"corrupt WebP: a {fourcc!r} chunk outside a frame of the animation")
            frame, nxt = _webp_frame(data, pos, end)
            if not flags & _WEBP_ALPHA_FLAG:
                frame["alpha"] = None  # the demuxer drops ALPH when the canvas has no alpha
            frames.append(frame)
        elif fourcc == b"ANIM":
            if size + (size & 1) < 6:
                raise ValueError("corrupt WebP: an ANIM chunk of fewer than 6 bytes")
            anim = True
        elif fourcc == b"ANMF":
            if not anim or size + (size & 1) < 16:
                raise ValueError("corrupt WebP: an ANMF chunk before ANIM, or of fewer than 16 bytes")
            x, y = 2 * _le(data, start, 3), 2 * _le(data, start + 3, 3)
            fw, fh = 1 + _le(data, start + 6, 3), 1 + _le(data, start + 9, 3)
            if fw * fh >= _WEBP_MAX_AREA:
                raise ValueError(f"corrupt WebP: a {fw}x{fh} frame")
            payload = size + (size & 1) - 16
            if end - (start + 16) < max(payload, 8):
                raise ValueError("truncated WebP: an ANMF frame runs past the RIFF chunk")
            frame, nxt = _webp_frame(data, start + 16, end)
            if nxt - (start + 16) > payload:
                raise ValueError("corrupt WebP: an ANMF frame's chunks run past it")
            if animated and (frame["image"] or frame["alpha"]):
                if frames and frames[-1]["image"] is None:
                    raise ValueError("corrupt WebP: a frame without an image chunk")
                frame["x"], frame["y"] = x, y
                frames.append(frame)
        if nxt == end:
            break
        if end - nxt < 8:
            raise ValueError("truncated WebP: a chunk header runs past the RIFF chunk")
        pos = nxt
    if not frames:
        raise ValueError("corrupt WebP: no frame")
    for f in frames:
        if f["image"] is None:
            raise ValueError("corrupt WebP: a frame without an image chunk")
        if f["alpha"] is not None and f["alpha"][0] > f["image"][0]:
            raise ValueError("corrupt WebP: an ALPH chunk after its image")
        _check_pixels("WebP", f["w"], f["h"], "frame")
        inside = (f["x"] + f["w"] <= cw and f["y"] + f["h"] <= ch) if animated else \
            (f["x"], f["y"], f["w"], f["h"]) == (0, 0, cw, ch)
        if not inside:
            raise ValueError(f"corrupt WebP: a {f['w']}x{f['h']} frame at ({f['x']}, {f['y']}) on a {cw}x{ch} canvas")
    return cw, ch, frames[0]


def _webp_check(status: int, what: str) -> None:
    if status == 4:
        raise MemoryError(f"decoding a WebP {what} bitstream ran out of memory")
    if status:
        raise ValueError(_WEBP_STATUS.get(status, "corrupt WebP: a bad {} bitstream").format(what))


def _webp_check_alpha(alpha: bytes, w: int, h: int) -> None:
    """An ALPH chunk's header and plane checked as libwebp checks them
    before it writes alpha; the plane itself never changes RGB."""
    if not alpha:
        raise ValueError("corrupt WebP: an empty ALPH chunk")
    method, pre, reserved = alpha[0] & 3, (alpha[0] >> 4) & 3, alpha[0] >> 6
    if method > 1 or pre > 1 or reserved:
        raise ValueError(f"corrupt WebP: ALPH header byte {alpha[0]:#x}")
    if method == 0:
        if len(alpha) - 1 < w * h:
            raise ValueError("truncated WebP: the ALPH plane is shorter than the image")
        return
    _webp_check(_build.webp_library().mmtrs_webp_alpha_check(alpha[1:], len(alpha) - 1, w, h), "ALPH")


def decode_webp(data: bytes) -> np.ndarray:
    """WebP bytes → RGB u8 [H, W, 3] numpy of the first frame, as Pillow's
    ``convert("RGB")`` gives it (see the module docstring)."""
    if data[:4] != b"RIFF" or data[8:12] != b"WEBP":
        raise ValueError("not a WebP file")
    cw, ch, frame = _webp_parse(data)
    _, fourcc, payload = frame["image"]
    w, h = frame["w"], frame["h"]
    lib = _build.webp_library()
    if frame["alpha"] is not None:
        _webp_check_alpha(frame["alpha"][1], w, h)
    rgb = np.empty((h, w, 3), np.uint8)
    if fourcc == b"VP8 ":
        _webp_check(lib.mmtrs_webp_vp8_decode(payload, len(payload), w, h, rgb.ctypes.data), "VP8")
    else:
        _webp_check(lib.mmtrs_webp_vp8l_decode(payload, len(payload), w, h, rgb.ctypes.data), "VP8L")
    if (cw, ch) == (w, h):
        return rgb
    canvas = np.zeros((ch, cw, 3), np.uint8)  # WebPAnimDecoder's canvas: transparent black
    canvas[frame["y"]:frame["y"] + h, frame["x"]:frame["x"] + w] = rgb
    return canvas


_HOST_DECODERS = {"PNG": decode_png, "BMP": decode_bmp, "GIF": decode_gif, "WEBP": decode_webp}
