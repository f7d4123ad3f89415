"""The port's image codec, without Pillow: JPEG and PNG, decode and encode.

JPEG runs on the device's backend, chosen when the library is built and
never switched at run time:

- on the CPU, the system libjpeg (``csrc/host/codec.cpp``), which decodes
  as Pillow's ``Image.open(...).convert("RGB")`` does (both are
  libjpeg-turbo with its default IDCT and upsampling) and encodes as
  Pillow's ``save(..., quality=q)`` does (baseline, 4:2:0);
- on the card, the CUDA toolkit's nvJPEG (``csrc/host/nvjpeg.cpp``): a
  decode lands in a CUDA tensor and an encode reads one. Its IDCT and
  chroma upsampling are its own, so its pixels are near Pillow's, not equal.

A missing compiler, header or library raises with its name; nothing moves to
another backend. PNG is host work on either device: the chunks are parsed
and inflated here with ``zlib``, the rows unfiltered in C
(``csrc/host/png.cpp``), and the image moved to the device; the encoder is
``zlib`` and ``struct`` alone.

BMP is host work too (``decode_bmp``): uncompressed (``BI_RGB``) files at
24 and 32 bits a pixel and 8-bit palette files, rows bottom-up or top-down.

What Pillow opens and this codec refuses, with an error that names the
format: CMYK and YCCK JPEGs, interlaced or 16-bit PNGs, BMPs compressed
(RLE, bit fields) or at 1, 4 or 16 bits a pixel, and WebP, GIF and TIFF
files.
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

PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
_OTHER_FORMATS = (  # (magic, name) of formats Pillow reads and this codec does not
    (b"BM", "BMP"),
    (b"GIF8", "GIF"),
    (b"II*\x00", "TIFF"),
    (b"MM\x00*", "TIFF"),
)
# PNG colour type -> channels (PNG specification, table 11.1)
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def sniff(data: bytes) -> str:
    """The format of an encoded image by its magic bytes: "jpeg", "png", or
    the name of a format the codec does not read ("BMP", "WebP", ...;
    "unknown" when nothing matches)."""
    if data[:3] == b"\xff\xd8\xff":
        return "jpeg"
    if data[:8] == PNG_MAGIC:
        return "png"
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        return "WebP"
    for magic, name in _OTHER_FORMATS:
        if data.startswith(magic):
            return name
    return "unknown"


def decode_image(src: bytes | str | Path, device: str | torch.device | None = None) -> torch.Tensor:
    """Encoded bytes, or a file's path → RGB u8 [H, W, 3] on ``device``
    (None: the card), as ``np.asarray(Image.open(src).convert("RGB"))``
    gives it. Raises ValueError for a corrupt file or a format the codec
    does not read, naming it."""
    dev = resolve_device(device)
    data = bytes(src) if isinstance(src, (bytes, bytearray, memoryview)) else Path(src).read_bytes()
    kind = sniff(data)
    if kind == "jpeg":
        return _decode_jpeg_cuda(data, dev) if dev.type == "cuda" else _decode_jpeg_cpu(data)
    if kind == "png":
        return torch.from_numpy(decode_png(data)).to(dev)
    if kind == "BMP":
        return torch.from_numpy(decode_bmp(data)).to(dev)
    if kind == "unknown":
        raise ValueError("cannot identify the image data: the port's codec reads JPEG, PNG and BMP")
    raise ValueError(f"{kind} images are not supported by the port's codec (JPEG, PNG and BMP only)")


def _jpeg_error(status: int, backend: str) -> Exception:
    if status == 2:
        return ValueError(f"corrupt or truncated JPEG ({backend})")
    if status == 3:
        return ValueError("CMYK/YCCK JPEG images are not supported by the port's codec")
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


def _decode_jpeg_cuda(data: bytes, dev: torch.device) -> torch.Tensor:
    if not jpeg_has_end(data):
        raise _jpeg_error(2, "nvJPEG")
    lib = _build.nvjpeg_library()
    dims = np.zeros(3, np.int32)
    status = lib.mmtrs_nvjpeg_info(data, len(data), dims.ctypes.data)
    if status:
        raise _jpeg_error(status, "nvJPEG")
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
    """Decode JPEG files on a pool of ``threads`` host threads (0: up to 8)
    with the CPU backend, without resizing → (a u8 [H, W, 3] CPU tensor per
    decoded file, else None; int32 status per file: 0 ok, 1 min edge below
    ``min_edge``, 2 decode error). Each tensor owns the buffer libjpeg
    decoded into."""
    lib = _build.jpeg_library()
    n = len(paths)
    if n == 0:
        return [], np.zeros(0, np.int32)
    c_paths = (ctypes.c_char_p * n)(*[os.fsencode(str(p)) for p in paths])
    pixels = (ctypes.c_void_p * n)()
    dims = np.zeros(2 * n, np.int32)
    status = np.zeros(n, np.int32)
    nt = threads or min(8, os.cpu_count() or 1)
    lib.mmtrs_jpeg_decode_paths(ctypes.cast(c_paths, ctypes.c_void_p), n, min_edge, nt,
                                ctypes.cast(pixels, ctypes.c_void_p), dims.ctypes.data, status.ctypes.data)
    out = []
    for i in range(n):
        if status[i] != 0:
            out.append(None)
            continue
        h, w = int(dims[2 * i]), int(dims[2 * i + 1])
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


_BMP_COMPRESSION = {1: "BI_RLE8", 2: "BI_RLE4", 3: "BI_BITFIELDS", 4: "BI_JPEG", 5: "BI_PNG",
                    6: "BI_ALPHABITFIELDS", 11: "BI_CMYK", 12: "BI_CMYKRLE8", 13: "BI_CMYKRLE4"}


def decode_bmp(data: bytes) -> np.ndarray:
    """BMP bytes → RGB u8 [H, W, 3] numpy, as Pillow's ``convert("RGB")``:
    uncompressed (``BI_RGB``) at 24 bits (BGR) or 32 bits (BGRX, the fourth
    byte dropped) a pixel, or 8-bit indices into a BGRX palette; rows
    padded to 4 bytes, bottom-up (positive height) or top-down (negative).
    Raises ValueError for a corrupt file and, naming it, for any other
    compression or bit depth."""
    if data[:2] != b"BM" or len(data) < 30:
        raise ValueError("corrupt or truncated BMP: no file header")
    offset = struct.unpack("<I", data[10:14])[0]
    dib = struct.unpack("<I", data[14:18])[0]
    if dib < 40:
        raise ValueError(f"BMP with a {dib}-byte (OS/2) header is not supported by the port's codec")
    if len(data) < 14 + 40:
        raise ValueError("corrupt or truncated BMP: short info header")
    w, h, _, bpp, comp, _, _, _, n_colors, _ = struct.unpack("<iiHHIIiiII", data[18:54])
    if comp != 0:
        name = _BMP_COMPRESSION.get(comp, f"type {comp}")
        raise ValueError(f"BMP compression {comp} ({name}) is not supported by the port's codec (BI_RGB only)")
    if bpp not in (8, 24, 32):
        raise ValueError(f"{bpp}-bit BMP images are not supported by the port's codec (8, 24 and 32 bits)")
    top_down, h = h < 0, abs(h)
    if w <= 0 or h == 0:
        raise ValueError(f"corrupt BMP: size {w}x{h}")
    stride = (w * bpp + 31) // 32 * 4
    if len(data) < offset + stride * (h - 1) + (w * bpp + 7) // 8:
        raise ValueError("corrupt or truncated BMP: the pixel data ends early")
    buf = np.frombuffer(data, np.uint8, count=min(stride * h, len(data) - offset), offset=offset)
    rows = np.zeros((h, stride), np.uint8)
    rows.reshape(-1)[: buf.size] = buf
    if not top_down:
        rows = rows[::-1]
    if bpp == 8:
        n = n_colors or 256
        pal = np.frombuffer(data, np.uint8, count=4 * n, offset=14 + dib) if 14 + dib + 4 * n <= offset \
            else None
        if pal is None:
            raise ValueError("corrupt BMP: the palette overlaps the pixel data")
        lut = np.zeros((256, 3), np.uint8)
        lut[: min(n, 256)] = pal.reshape(n, 4)[:256, 2::-1]
        return lut[rows[:, :w]]
    px = rows[:, : w * (bpp // 8)].reshape(h, w, bpp // 8)
    return np.ascontiguousarray(px[..., 2::-1])


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes → RGB u8 [H, W, 3] numpy, as Pillow's ``convert("RGB")``:
    gray repeated, alpha dropped (not composited), palette looked up.
    Raises ValueError for a corrupt file, an interlaced one or 16 bits a
    sample."""
    if data[:8] != PNG_MAGIC:
        raise ValueError("not a PNG file")
    pos, header, palette, idat = 8, None, None, []
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError("truncated PNG")
        if zlib.crc32(kind + body) != struct.unpack(">I", crc)[0]:
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
    if interlace:
        raise ValueError("interlaced (Adam7) PNG images are not supported by the port's codec")
    if depth == 16:
        raise ValueError("16-bit PNG images are not supported by the port's codec")
    if ctype not in _PNG_CHANNELS or (depth != 8 and ctype not in (0, 3)) or depth not in (1, 2, 4, 8):
        raise ValueError(f"corrupt PNG: colour type {ctype} at {depth} bits")
    if ctype == 3 and palette is None:
        raise ValueError("corrupt PNG: a palette image without PLTE")
    channels = _PNG_CHANNELS[ctype]
    stride = (w * channels * depth + 7) // 8
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"corrupt PNG: {e}") from None
    if len(raw) < h * (stride + 1):
        raise ValueError("truncated PNG: the image data ends early")
    rows = np.empty((h, stride), np.uint8)
    bad = _build.png_library().mmtrs_png_unfilter(raw, h, stride, max(1, channels * depth // 8), rows.ctypes.data)
    if bad:
        raise ValueError(f"corrupt PNG: row {bad - 1} has an unknown filter type")
    if depth < 8:  # one sample a pixel, packed from the high bits down
        bits = np.unpackbits(rows, axis=1).reshape(h, -1, depth)[:, :w]
        vals = (bits * (1 << np.arange(depth - 1, -1, -1, dtype=np.uint8))).sum(axis=2, dtype=np.uint8)
        px = vals if ctype == 3 else vals * np.uint8(255 // ((1 << depth) - 1))
        px = px[..., None]
    else:
        px = rows.reshape(h, w, channels)
    if ctype == 3:
        lut = np.zeros((256, 3), np.uint8)
        lut[:len(palette)] = palette[:256]
        return lut[px[..., 0]]
    if ctype in (0, 4):
        return np.repeat(px[..., :1], 3, axis=2)
    return np.ascontiguousarray(px[..., :3])
