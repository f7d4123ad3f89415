"""The port's codec against Pillow 12.1 on every format Pillow's
``Image.open`` reads besides those of test_torch_codec*.py: identification
(``sniff`` names what ``Image.open(...).format`` names, and refuses where
it raises), decoding (equal to ``convert("RGB")``, bit for bit), Pillow's
``convert("RGB")`` for every mode the decoders give, the bomb limit, and
the formats that stay refused.

The goldens (``mmtrs_tpu_torch/testdata/pillow_goldens.npz``, each file
and Pillow's decode of it, read on the card's machine by chip_smoke.py)
are regenerated with ``python -m tests.test_torch_codec_pillow``. Pillow
cannot write every variant; PSD, SUN, PIXAR, MCIDAS, IMT, CUR, DCX, 16-bit
SGI and TIFF, subsampled YCbCr, fill-order-2 fax, BC6H and signed BC5 blocks
and odd TGA/PCX headers are written by hand below.
"""

from __future__ import annotations

import io
import struct
import subprocess
import zlib
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from tests.test_torch_codec_formats import tiff_bytes

ROOT = Path(__file__).resolve().parents[1]
GOLDENS = ROOT / "mmtrs_tpu_torch" / "testdata" / "pillow_goldens.npz"
H, W = 19, 23  # odd sizes: partial blocks, padded rows


def _rgb(seed: int, h: int = H, w: int = W) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), np.uint8)


def _save(img: Image.Image, fmt: str, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, fmt, **kw)
    return buf.getvalue()


def _pillow(data: bytes) -> tuple[str, np.ndarray]:
    im = Image.open(io.BytesIO(data))
    return im.format, np.asarray(im.convert("RGB"))


# ---------------------------------------------------------------------------
# Hand-written files
# ---------------------------------------------------------------------------


def psd_bytes(mode: int, bits: int, planes: list[np.ndarray], rle: bool, palette: bytes = b"") -> bytes:
    """A PSD whose merged image holds ``planes`` (each [h, stride] bytes)."""
    h, stride = planes[0].shape
    w = stride * 8 if bits == 1 else stride
    head = b"8BPS" + struct.pack(">H6xHIIHH", 1, len(planes), h, w, bits, mode)
    body = struct.pack(">I", len(palette)) + palette + struct.pack(">I", 0) + struct.pack(">I", 0)
    if not rle:
        return head + body + struct.pack(">H", 0) + b"".join(p.tobytes() for p in planes)
    rows, counts = [], []
    for p in planes:
        for row in p:
            enc = _packbits(row.tobytes())
            rows.append(enc)
            counts.append(len(enc))
    return head + body + struct.pack(">H", 1) + struct.pack(f">{len(counts)}H", *counts) + b"".join(rows)


def _packbits(row: bytes) -> bytes:
    """PackBits: runs of 3 or more as a run packet, the rest as literals."""
    out, i = bytearray(), 0
    while i < len(row):
        j = i
        while j < len(row) and j - i < 128 and row[j] == row[i]:
            j += 1
        if j - i >= 3:
            out += bytes([257 - (j - i), row[i]])
            i = j
            continue
        k = i
        while k < len(row) and k - i < 128 and not (k + 2 < len(row) and row[k] == row[k + 1] == row[k + 2]):
            k += 1
        out += bytes([k - i - 1]) + row[i:k]
        i = k
    return bytes(out)


def tga_bytes(kind: int, depth: int, px: bytes, w: int, h: int, flags: int = 0x20, cmap: tuple | None = None,
              ident: bytes = b"") -> bytes:
    cm_type, cm_start, cm_len, cm_depth, cm_data = (0, 0, 0, 0, b"") if cmap is None else (1, *cmap)
    head = struct.pack("<BBBHHBHHHHBB", len(ident), cm_type, kind, cm_start, cm_len, cm_depth, 0, 0, w, h, depth,
                       flags)
    return head + ident + cm_data + px


def tga_rle(px: bytes, pb: int, w: int = W) -> bytes:
    """TGA RLE of whole pixels: runs of equal pixels within a row (Pillow
    refuses a run across rows), raw packets otherwise (across rows)."""
    pixels = [px[i:i + pb] for i in range(0, len(px), pb)]
    out, i = bytearray(), 0
    while i < len(pixels):
        j = i
        while j < len(pixels) and j - i < 128 and pixels[j] == pixels[i] and (j == i or j % w):
            j += 1
        if j - i > 1:
            out += bytes([0x80 | (j - i - 1)]) + pixels[i]
            i = j
        else:
            k = i
            while k < len(pixels) and k - i < 128 and (k + 1 >= len(pixels) or pixels[k + 1] != pixels[k]):
                k += 1
            k = max(k, i + 1)
            out += bytes([k - i - 1]) + b"".join(pixels[i:k])
            i = k
    return bytes(out)


def pcx_bytes(w: int, h: int, bits: int, planes: int, rows: bytes, stride: int, palette16: bytes = bytes(48),
              tail: bytes = b"", version: int = 5) -> bytes:
    head = struct.pack("<BBBBHHHHHH", 10, version, 1, bits, 0, 0, w - 1, h - 1, 72, 72) + palette16 + b"\0"
    head += struct.pack("<BH", planes, stride) + bytes(60)
    body = bytearray()
    for b in rows:  # every byte as a run of one, so values >= 0xC0 survive
        body += bytes([0xC1, b]) if b >= 0xC0 else bytes([b])
    return head + bytes(body) + tail


def sgi_bytes(bpc: int, planes: np.ndarray, rle: bool) -> bytes:
    """planes [z, h, w] (u8 or big-endian u16 values), rows bottom first."""
    z, h, w = planes.shape
    head = struct.pack(">HBBHHHH", 474, int(rle), bpc, 3 if z > 1 else 2, w, h, z).ljust(512, b"\0")
    if not rle:
        return head + planes.astype(">u2" if bpc == 2 else np.uint8).tobytes()
    starts, lengths, rows = [], [], bytearray()
    at = 512 + 8 * z * h
    for c in range(z):
        for y in range(h):
            row = planes[c, y]
            enc = bytearray()
            for x0 in range(0, w, 100):  # literal runs of at most 100, then the terminator
                chunk = row[x0:x0 + 100]
                if bpc == 1:
                    enc += bytes([0x80 | len(chunk)]) + chunk.astype(np.uint8).tobytes()
                else:
                    enc += struct.pack(">H", 0x80 | len(chunk)) + chunk.astype(">u2").tobytes()
            enc += bytes(bpc)
            starts.append(at + len(rows))
            lengths.append(len(enc))
            rows += enc
    return head + struct.pack(f">{z * h}I", *starts) + struct.pack(f">{z * h}I", *lengths) + bytes(rows)


_DX10 = {"bc1": 71, "bc4": 80, "bc5": 83, "bc5s": 84, "bc6h": 95, "bc6hs": 96, "bc7": 98, "rgba": 28}


def dds_bytes(w: int, h: int, kind: str, payload: bytes) -> bytes:
    hdr = bytearray(124)
    struct.pack_into("<IIII", hdr, 0, 124, 0x1007, h, w)
    struct.pack_into("<II4s", hdr, 72, 32, 4, b"DX10")
    return b"DDS " + bytes(hdr) + struct.pack("<5I", _DX10[kind], 3, 0, 1, 0) + payload


def dds_fourcc(w: int, h: int, fourcc: bytes, payload: bytes) -> bytes:
    hdr = bytearray(124)
    struct.pack_into("<IIII", hdr, 0, 124, 0x1007, h, w)
    struct.pack_into("<II4s", hdr, 72, 32, 4, fourcc)
    return b"DDS " + bytes(hdr) + payload


def dds_masks(w: int, h: int, bits: int, masks: tuple, payload: bytes) -> bytes:
    hdr = bytearray(124)
    struct.pack_into("<IIII", hdr, 0, 124, 0x1007, h, w)
    struct.pack_into("<III", hdr, 72, 32, 0x40 | (1 if len(masks) == 4 else 0), 0)
    struct.pack_into(f"<I{len(masks)}I", hdr, 84, bits, *masks)
    return b"DDS " + bytes(hdr) + payload


def _blocks(seed: int, n: int, size: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, (n, size), np.uint8).tobytes()


def sun_bytes(depth: int, rows: bytes, w: int, h: int, ftype: int = 1, palette: bytes = b"") -> bytes:
    head = struct.pack(">8I", 0x59A66A95, w, h, depth, len(rows), ftype, 1 if palette else 0, len(palette))
    return head + palette + rows


def sun_rle(data: bytes) -> bytes:
    out, i = bytearray(), 0
    while i < len(data):
        j = i
        while j < len(data) and j - i < 256 and data[j] == data[i]:
            j += 1
        if j - i >= 3:
            out += bytes([0x80, j - i - 1, data[i]])
            i = j
        else:
            out += b"\x80\x00" if data[i] == 0x80 else data[i:i + 1]
            i += 1
    return bytes(out)


def _rows(px: np.ndarray, stride: int) -> bytes:
    """Packed 1-bit rows (u8 0/1 [h, w]) padded to ``stride`` bytes."""
    packed = np.packbits(px, axis=1)
    return np.pad(packed, ((0, 0), (0, stride - packed.shape[1]))).tobytes()


def _tiff_g4_fill2() -> bytes:
    """Pillow's Group 4 strip with its bits reversed and FillOrder 2."""
    a = (_rgb(40)[..., 0] > 128)
    t = Image.open(io.BytesIO(_save(Image.fromarray(a), "TIFF", compression="group4")))
    strip = t.fp.getvalue()[t.tag_v2[273][0]:t.tag_v2[273][0] + t.tag_v2[279][0]]
    rev = bytes(int(f"{b:08b}"[::-1], 2) for b in strip)
    return tiff_bytes(W, H, {258: (3, [1]), 259: (3, [4]), 262: (3, [0]), 266: (3, [2]), 277: (3, [1]),
                             278: (4, [H])}, [rev])


def _tiff_ycbcr_sub(hs: int, vs: int) -> bytes:
    """YCbCr with (hs, vs) subsampling, LZW-free: Adobe deflate blocks."""
    rng = np.random.default_rng(41)
    bw, bh = -(-W // hs), -(-H // vs)
    blocks = rng.integers(0, 256, (bh, bw, hs * vs + 2), np.uint8)
    return tiff_bytes(W, H, {258: (3, [8, 8, 8]), 259: (3, [8]), 262: (3, [6]), 277: (3, [3]), 278: (4, [H]),
                             530: (3, [hs, vs])}, [zlib.compress(blocks.tobytes())])


def _tiff_16(spp: int, photo: int, bo: str, extra=None) -> bytes:
    rng = np.random.default_rng(42 + spp)
    v = rng.integers(0, 65536, (H, W, spp)).astype(f"{bo}u2")
    tags = {258: (3, [16] * spp), 259: (3, [1]), 262: (3, [photo]), 277: (3, [spp]), 278: (4, [H])}
    if extra is not None:
        tags[338] = (3, [extra])
    return tiff_bytes(W, H, tags, [v.tobytes()], bo=bo)


def _tiff_32(sf: int, bo: str) -> bytes:
    rng = np.random.default_rng(43 + sf)
    if sf == 3:
        v = rng.normal(100, 200, (H, W)).astype(f"{bo}f4")
        v.reshape(-1)[:4] = [np.nan, np.inf, -np.inf, 254.9]
    else:
        v = rng.integers(-(2 ** 31), 2 ** 31, (H, W)).astype(f"{bo}{'i' if sf == 2 else 'u'}4")
        v.reshape(-1)[:4] = [0, 1, 255, 256]
    return tiff_bytes(W, H, {258: (3, [32]), 259: (3, [1]), 262: (3, [1]), 277: (3, [1]), 278: (4, [H]),
                             339: (3, [sf])}, [v.tobytes()], bo=bo)


def _ico_entries(sizes, fmt: str) -> bytes:
    img = Image.fromarray(_rgb(44, 32, 32))
    return _save(img, "ICO", sizes=sizes, bitmap_format=fmt)


def _cur() -> bytes:
    ico = _save(Image.fromarray(_rgb(45, 16, 16)), "ICO", sizes=[(16, 16)], bitmap_format="bmp")
    return ico[:2] + b"\x02\x00" + ico[4:]


def _dcx() -> bytes:
    pcx = _save(Image.fromarray(_rgb(46)), "PCX")
    return struct.pack("<III", 987654321, 12, 0) + pcx


def _pnm() -> dict[str, bytes]:
    a = _rgb(47)
    g = a[..., 0]
    return {
        "ppm_p6.ppm": _save(Image.fromarray(a), "PPM"),
        "ppm_p5.pgm": _save(Image.fromarray(g), "PPM"),
        "ppm_p4.pbm": _save(Image.fromarray(g > 128), "PPM"),
        "ppm_p3_comments.ppm": b"P3\n# a comment\n3 2 # more\n7\n0 1 2 3 4 5\n6 7 0 1 2 3\n4 5 6 7 0 1\n",
        "ppm_p2_maxval1000.pgm": b"P2 3 2 1000 0 499 500 999 1000 250",
        "ppm_p1.pbm": b"P1\n5 2\n10101\n0 1 1 0 1\n",
        "ppm_p5_maxval100.pgm": b"P5 4 2 100\n" + bytes([0, 1, 50, 99, 100, 25, 75, 49]),
        "ppm_p6_16bit.ppm": b"P6 2 2 65535\n" + np.array([0, 255, 256, 65535, 40000, 1000] * 2, ">u2").tobytes(),
        "ppm_p5_16bit.pgm": b"P5 3 1 65535\n" + np.array([0, 255, 65535], ">u2").tobytes(),
        "ppm_p6_maxval4095.ppm": b"P6 2 1 4095\n" + np.array([0, 4095, 2048, 1, 4000, 100], ">u2").tobytes(),
        "ppm_pfm_le.pfm": b"Pf\n3 2\n-1.0\n" + np.array([0.5, -3, 300, 254.7, np.nan, 1.5], "<f4").tobytes(),
        "ppm_pfm_be.pfm": b"Pf 2 2 1.0 " + np.array([1.0, 200.5, 255.9, -0.0], ">f4").tobytes(),
    }


def _tga() -> dict[str, bytes]:
    a = _rgb(48)
    img = Image.fromarray(a)
    out = {}
    for mode in ("RGB", "RGBA", "L", "P", "LA"):
        out[f"tga_{mode}.tga"] = _save(img.convert(mode), "TGA")
        out[f"tga_{mode}_rle.tga"] = _save(img.convert(mode), "TGA", compression="tga_rle")
    out["tga_RGB_bottom_up.tga"] = _save(img, "TGA", orientation=-1)
    words = ((a[..., 0].astype(np.uint16) >> 3) << 10) | ((a[..., 1].astype(np.uint16) >> 3) << 5) | (a[..., 2] >> 3)
    words |= (a[..., 0].astype(np.uint16) & 1) << 15
    px16 = words.astype("<u2").tobytes()
    out["tga_16bit.tga"] = tga_bytes(2, 16, px16, W, H, flags=0x20)
    out["tga_16bit_rle_mirrored.tga"] = tga_bytes(10, 16, tga_rle(px16, 2), W, H, flags=0x30)
    bgr = a[..., ::-1].tobytes()
    out["tga_24bit_mirrored_bottom_up.tga"] = tga_bytes(2, 24, bgr, W, H, flags=0x10, ident=b"an id")
    idx = (a[..., 0] % 40).tobytes()
    pal16 = np.random.default_rng(49).integers(0, 65536, 30).astype("<u2").tobytes()
    out["tga_cmap16_start5.tga"] = tga_bytes(1, 8, idx, W, H, cmap=(5, 30, 16, pal16))
    pal24 = np.random.default_rng(50).integers(0, 256, (40, 3), np.uint8).tobytes()
    out["tga_cmap24_rle.tga"] = tga_bytes(9, 8, tga_rle(idx, 1), W, H, cmap=(0, 40, 24, pal24))
    out["tga_gray_rle_bottom_up.tga"] = tga_bytes(11, 8, tga_rle(a[..., 1].tobytes(), 1), W, H, flags=0)
    return out


def _pcx() -> dict[str, bytes]:
    a = _rgb(51)
    img = Image.fromarray(a)
    out = {f"pcx_{m}.pcx": _save(img.convert(m), "PCX") for m in ("RGB", "L", "P", "1")}
    rng = np.random.default_rng(52)
    planes = rng.integers(0, 2, (4, H, W), np.uint8)
    stride = (W + 7) // 8 + 1  # an even stride, padded
    rows = b"".join(b"".join(_rows(planes[p][y:y + 1], stride) for p in range(4)) for y in range(H))
    out["pcx_ega_4plane.pcx"] = pcx_bytes(W, H, 1, 4, rows, stride, palette16=rng.integers(0, 256, 48, np.uint8).tobytes(),
                                          version=2)
    rows2 = b"".join(b"".join(_rows(planes[p][y:y + 1], stride) for p in range(2)) for y in range(H))
    out["pcx_2plane.pcx"] = pcx_bytes(W, H, 1, 2, rows2, stride, palette16=rng.integers(0, 256, 48, np.uint8).tobytes())
    out["pcx_odd_stride_rgb.pcx"] = pcx_bytes(W, H, 8, 3, b"".join(
        b"".join(a[y, :, c].tobytes() + b"\x07" for c in range(3)) for y in range(H)), W + 1)
    out["dcx_first_page.dcx"] = _dcx()
    return out


def _sgi() -> dict[str, bytes]:
    img = Image.fromarray(_rgb(53))
    out = {}
    for mode in ("RGB", "RGBA", "L"):
        out[f"sgi_{mode}.sgi"] = _save(img.convert(mode), "SGI")
        out[f"sgi_{mode}_rle.sgi"] = _save(img.convert(mode), "SGI", rle=True)
    v16 = np.random.default_rng(54).integers(0, 65536, (3, H, W))
    out["sgi_16bit.sgi"] = sgi_bytes(2, v16, False)
    out["sgi_16bit_rle.sgi"] = sgi_bytes(2, v16, True)
    out["sgi_8bit_rle_hand.sgi"] = sgi_bytes(1, np.random.default_rng(55).integers(0, 256, (1, H, W)), True)
    return out


def _psd() -> dict[str, bytes]:
    rng = np.random.default_rng(56)
    p = [rng.integers(0, 256, (H, W), np.uint8) for _ in range(4)]
    p[0][:, :8] = 7  # runs for PackBits
    out = {}
    for rle in (False, True):
        tag = "rle" if rle else "raw"
        out[f"psd_rgb_{tag}.psd"] = psd_bytes(3, 8, p[:3], rle)
        out[f"psd_rgba_{tag}.psd"] = psd_bytes(3, 8, p, rle)
        out[f"psd_gray_{tag}.psd"] = psd_bytes(1, 8, p[:1], rle)
        out[f"psd_cmyk_{tag}.psd"] = psd_bytes(4, 8, p, rle)
        out[f"psd_indexed_{tag}.psd"] = psd_bytes(2, 8, p[:1], rle, palette=rng.integers(0, 256, 768, np.uint8).tobytes())
        bits = rng.integers(0, 256, (H, 3), np.uint8)
        out[f"psd_bitmap_{tag}.psd"] = psd_bytes(0, 1, [bits], rle)
    return out


def _dds() -> dict[str, bytes]:
    img = Image.fromarray(_rgb(57))
    out = {}
    for mode, fmts in (("RGB", ("DXT1", "BC5")), ("RGBA", ("DXT1", "DXT3", "DXT5", "BC2", "BC3")),
                       ("L", ("DXT5",))):
        for pf in fmts:
            out[f"dds_{pf.lower()}_{mode.lower()}.dds"] = _save(img.convert(mode), "DDS", pixel_format=pf)
    for mode in ("RGB", "RGBA", "L", "LA"):
        out[f"dds_uncompressed_{mode.lower()}.dds"] = _save(img.convert(mode), "DDS")
    nb = -(-W // 4) * -(-H // 4)
    for i, kind in enumerate(("bc6h", "bc6hs", "bc7", "bc5s", "bc1", "bc4")):
        size = 8 if kind in ("bc1", "bc4") else 16
        out[f"dds_random_{kind}.dds"] = dds_bytes(W, H, kind, _blocks(60 + i, nb, size))
    out["dds_ati2.dds"] = dds_fourcc(W, H, b"ATI2", _blocks(70, nb, 16))
    out["dds_ati1.dds"] = dds_fourcc(W, H, b"ATI1", _blocks(71, nb, 8))
    out["dds_dx10_rgba.dds"] = dds_bytes(W, H, "rgba", _rgb(72, H, W * 4 // 3 + 1).tobytes()[: W * H * 4])
    out["dds_rgb565.dds"] = dds_masks(W, H, 16, (0xF800, 0x7E0, 0x1F), _blocks(73, W * H, 2))
    return out


def _tiff() -> dict[str, bytes]:
    img = Image.fromarray(_rgb(58))
    out = {}
    for comp in (None, "tiff_lzw", "tiff_adobe_deflate", "packbits"):
        kw = {"compression": comp} if comp else {}
        tag = comp or "raw"
        for mode in ("CMYK", "I;16", "I", "F"):
            out[f"tiff_{mode.replace(';', '')}_{tag}.tif"] = _save(img.convert(mode), "TIFF", **kw)
    out["tiff_ycbcr_lzw.tif"] = _save(img.convert("YCbCr"), "TIFF", compression="tiff_lzw")
    for mode in ("RGB", "L", "CMYK", "YCbCr"):
        out[f"tiff_jpeg_{mode.lower()}.tif"] = _save(img.convert(mode), "TIFF", compression="jpeg")
    big = Image.fromarray(_rgb(59, 70, 90))
    out["tiff_jpeg_strips.tif"] = _save(big, "TIFF", compression="jpeg", tiffinfo={278: 16})
    one = img.convert("1")
    out["tiff_g3_1d.tif"] = _save(one, "TIFF", compression="group3")
    out["tiff_g3_2d.tif"] = _save(one, "TIFF", compression="group3", tiffinfo={292: 1})
    out["tiff_g4.tif"] = _save(one, "TIFF", compression="group4")
    out["tiff_ccitt_rle.tif"] = _save(one, "TIFF", compression="tiff_ccitt")
    out["tiff_g4_strips.tif"] = _save(Image.fromarray(_rgb(60, 70, 90)[..., 0] > 100), "TIFF", compression="group4",
                                      tiffinfo={278: 16})
    out["tiff_g4_fill_order_2.tif"] = _tiff_g4_fill2()
    out["tiff_ycbcr_2x2.tif"] = _tiff_ycbcr_sub(2, 2)
    out["tiff_ycbcr_2x1.tif"] = _tiff_ycbcr_sub(2, 1)
    out["tiff_rgb16_le.tif"] = _tiff_16(3, 2, "<")
    out["tiff_rgb16_be.tif"] = _tiff_16(3, 2, ">")
    out["tiff_rgba16_premultiplied.tif"] = _tiff_16(4, 2, "<", extra=1)
    out["tiff_cmyk16.tif"] = _tiff_16(4, 5, "<")
    out["tiff_gray16_be.tif"] = _tiff_16(1, 1, ">")
    out["tiff_float32_be.tif"] = _tiff_32(3, ">")
    out["tiff_int32_signed.tif"] = _tiff_32(2, "<")
    out["tiff_uint32.tif"] = _tiff_32(1, "<")
    return out


def _others() -> dict[str, bytes]:
    a = _rgb(61)
    img = Image.fromarray(a)
    out = {
        "qoi_rgb.qoi": _save(img, "QOI"),
        "qoi_rgba.qoi": _save(img.convert("RGBA"), "QOI"),
        "ico_png_sizes.ico": _ico_entries([(16, 16), (32, 32)], "png"),
        "ico_bmp_sizes.ico": _ico_entries([(16, 16), (32, 32)], "bmp"),
        "ico_bmp_palette.ico": _save(Image.fromarray(_rgb(62, 16, 16)).convert("P"), "ICO", sizes=[(16, 16)],
                                     bitmap_format="bmp"),
        "ico_bmp_1bit.ico": _save(Image.fromarray(_rgb(63, 16, 16)).convert("1"), "ICO", sizes=[(16, 16)],
                                  bitmap_format="bmp"),
        "cur.cur": _cur(),
        "dib.dib": _save(img, "DIB"),
        "xbm.xbm": _save(img.convert("1"), "XBM"),
        "xpm.xpm": b'/* XPM */\nstatic char *x[] = {\n"4 3 3 1",\n"a c #ff0000",\n"b c #00ff00",\n". c #123456",\n'
                   b'"/* pixels */\n"ab.a",\n"b.ab",\n"..ab"\n};\n',
        "msp_danm.msp": _save(img.convert("1"), "MSP"),
        "spider.spi": _save(img.convert("F"), "SPIDER"),
        "xvthumb.xv": b"P7 332\n#XVVERSION:Version 2.28\n#END_OF_COMMENTS\n%d %d 255\n" % (W, H) + a[..., 0].tobytes(),
        "ftex_rgb.ftc": b"FTEX" + struct.pack("<i2i2i2i", 0, W, H, 1, 1, 1, 32) + struct.pack("<i", W * H * 3)
                        + a.tobytes(),
        "ftex_dxt1.ftc": b"FTEX" + struct.pack("<i2i2i2i", 0, W, H, 1, 1, 0, 32) + struct.pack("<i", 8 * 36)
                         + _blocks(64, 36, 8),
        "gbr_gray.gbr": struct.pack(">5I", 32, 2, W, H, 1) + b"GIMP" + struct.pack(">I", 10) + b"abc\0"
                        + a[..., 0].tobytes(),
        "gbr_rgba_v1.gbr": struct.pack(">5I", 24, 1, W, H, 4) + b"bru\0" + _rgb(65, H, W * 4 // 3 + 1).tobytes()[
            : W * H * 4],
        "pixar.pxr": (b"\x80\xe8\x00\x00".ljust(416, b"\0") + struct.pack("<HH", H, W).ljust(8, b"\0")
                      + struct.pack("<HH", 14, 2)).ljust(1024, b"\0") + a.tobytes(),
        "sun_rgb.ras": sun_bytes(24, np.pad(a[..., ::-1].reshape(H, -1), ((0, 0), (0, 1))).tobytes(), W, H),
        "sun_rgb_type3.ras": sun_bytes(24, np.pad(a.reshape(H, -1), ((0, 0), (0, 1))).tobytes(), W, H, ftype=3),
        "sun_gray_rle.ras": sun_bytes(8, sun_rle(np.repeat(a[..., 1], 1, 0).tobytes()), W, H, ftype=2),
        "sun_palette.ras": sun_bytes(8, np.pad(a[..., 2], ((0, 0), (0, 1))).tobytes(), W, H,
                                     palette=_blocks(66, 1, 768)),
        "sun_1bit.ras": sun_bytes(1, _rows(a[..., 0] > 128, 4), W, H),
        "fits_8bit.fits": b"".join(c.ljust(80).encode() for c in (
            "SIMPLE  =                    T", "BITPIX  =                    8", "NAXIS   =                    2",
            f"NAXIS1  = {W:20d}", f"NAXIS2  = {H:20d}", "END")).ljust(2880, b" ") + a[..., 0].tobytes(),
        "mcidas.area": _mcidas(a[..., 0]),
        "imt.imt": b"width %d\nheight %d\npixel n8\n\x0c" % (W, H) + a[..., 1].tobytes(),
        "iptc_raw.iptc": _iptc(a[..., 2]),
    }
    for mode in ("L", "RGB", "P", "1", "RGBA", "CMYK", "YCbCr", "LA"):
        out[f"im_{mode.lower()}.im"] = _save(img.convert(mode), "IM")
    out["blp2_palette.blp"] = _save(img.convert("P"), "BLP")
    out["blp1_palette.blp"] = _save(img.convert("P"), "BLP", blp_version="BLP1")
    for alpha, enc in ((0, 0), (1, 0), (1, 1), (1, 7), (0, 7)):
        out[f"blp2_dxt_a{alpha}_e{enc}.blp"] = blp2_dxt(W, H, alpha, enc, 90 + enc + alpha)
    png = _save(Image.fromarray(_rgb(67, 32, 32)).convert("RGBA"), "PNG")
    res = b"icp5" + struct.pack(">I", 8 + len(png)) + png + icns_rle(16, 66)[8:]
    out["icns_png.icns"] = b"icns" + struct.pack(">I", 8 + len(res)) + res
    out["icns_is32_rle.icns"] = icns_rle(16, 68)
    out["icns_il32_rle.icns"] = icns_rle(32, 69)
    for kind in ("brun", "brun6", "copy"):
        out[f"fli_{kind}.flc"] = fli_bytes(W, H, 70 + len(kind), kind)
    return out


def blp2_dxt(w: int, h: int, alpha: int, alpha_encoding: int, seed: int) -> bytes:
    """A BLP2 of random DXT blocks (Pillow decodes these in Python)."""
    size = 8 if alpha_encoding == 0 else 16
    body = _blocks(seed, -(-w // 4) * -(-h // 4), size)
    head = b"BLP2" + struct.pack("<iBBBB", 1, 2, alpha, alpha_encoding, 0) + struct.pack("<II", w, h)
    offsets = [20 + 128 + 1024] + [0] * 15
    return head + struct.pack("<16I", *offsets) + struct.pack("<16I", len(body), *[0] * 15) + bytes(1024) + body


def icns_rle(w: int, seed: int) -> bytes:
    """An ICNS with one 32-bit RLE resource (is32 at 16, il32 at 32)."""
    rng = np.random.default_rng(seed)
    code = {16: b"is32", 32: b"il32", 48: b"ih32"}[w]
    body = bytearray()
    for _ in range(3):
        left = w * w
        while left:
            if rng.random() < 0.5:
                k = int(min(left, rng.integers(3, 131)))
                if k < 3:
                    body += bytes([k - 1]) + rng.integers(0, 256, k, np.uint8).tobytes()
                else:
                    body += bytes([k + 125, int(rng.integers(0, 256))])
            else:
                k = int(min(left, rng.integers(1, 129)))
                body += bytes([k - 1]) + rng.integers(0, 256, k, np.uint8).tobytes()
            left -= k
    res = code + struct.pack(">I", 8 + len(body)) + bytes(body)
    return b"icns" + struct.pack(">I", 8 + len(res)) + res


def fli_bytes(w: int, h: int, seed: int, kind: str) -> bytes:
    """An FLC whose first frame holds a colour chunk (type 4 at 8 bits or
    11 at 6) and a BRUN or COPY chunk."""
    rng = np.random.default_rng(seed)
    px = rng.integers(0, 256, (h, w), np.uint8)
    if kind == "copy":
        image = struct.pack("<IH", 6 + w * h, 16) + px.tobytes()
    else:
        rows = bytearray()
        for y in range(h):
            rows += b"\0"
            x = 0
            while x < w:
                n = min(w - x, int(rng.integers(1, 9)))
                if rng.random() < 0.5:
                    rows += bytes([n, int(px[y, x])])
                    px[y, x:x + n] = px[y, x]
                else:
                    rows += bytes([256 - n]) + px[y, x:x + n].tobytes()
                x += n
        image = struct.pack("<IH", 6 + len(rows), 15) + bytes(rows)
    ctype = 11 if kind == "brun6" else 4
    pal = rng.integers(0, 64 if ctype == 11 else 256, 3 * 256, np.uint8).tobytes()
    color = struct.pack("<H", 1) + bytes([0, 0]) + pal
    color = struct.pack("<IH", 6 + len(color), ctype) + color
    frame_body = color + image
    frame = struct.pack("<IHH8x", 16 + len(frame_body), 0xF1FA, 2) + frame_body
    head = struct.pack("<IHHHHHHI", 128 + len(frame), 0xAF12, 1, w, h, 8, 0, 70).ljust(128, b"\0")
    return head + frame


def _mcidas(g: np.ndarray) -> bytes:
    w = [0] * 65
    w[2], w[9], w[10], w[11], w[14], w[15], w[34] = 4, H, W, 1, 1, 4, 256
    prefix = 4
    rows = b"".join(b"\xaa" * prefix + g[y].tobytes() for y in range(H))
    return struct.pack("!64i", *w[1:]) + rows


def _iptc(g: np.ndarray) -> bytes:
    def field(rec, tag, body):
        return bytes([0x1C, rec, tag]) + struct.pack(">H", len(body)) + body

    return (field(3, 60, bytes([1, 0])) + field(3, 20, struct.pack(">H", W)) + field(3, 30, struct.pack(">H", H))
            + field(3, 120, bytes([1])) + field(8, 10, g.tobytes()))


_ARITH_TOOL = r"""
// arith_tool <rgb file> <h> <w> <out.jpg> <progressive 0|1>: RGB bytes as an
// arithmetic-coded JPEG (YCbCr 4:2:0, quality 90)
#include <cstdio>
#include <cstdlib>
#include <vector>
#include <jpeglib.h>
int main(int argc, char** argv) {
    int h = std::atoi(argv[2]), w = std::atoi(argv[3]);
    std::vector<unsigned char> rgb(h * w * 3);
    FILE* f = std::fopen(argv[1], "rb"); std::fread(rgb.data(), 1, rgb.size(), f); std::fclose(f);
    jpeg_compress_struct ci; jpeg_error_mgr err; ci.err = jpeg_std_error(&err); jpeg_create_compress(&ci);
    FILE* o = std::fopen(argv[4], "wb"); jpeg_stdio_dest(&ci, o);
    ci.image_width = w; ci.image_height = h; ci.input_components = 3; ci.in_color_space = JCS_RGB;
    jpeg_set_defaults(&ci); jpeg_set_quality(&ci, 90, TRUE);
    ci.arith_code = TRUE;
    if (std::atoi(argv[5])) jpeg_simple_progression(&ci);
    jpeg_start_compress(&ci, TRUE);
    while (ci.next_scanline < ci.image_height) { JSAMPROW r = &rgb[ci.next_scanline * w * 3]; jpeg_write_scanlines(&ci, &r, 1); }
    jpeg_finish_compress(&ci); jpeg_destroy_compress(&ci); std::fclose(o);
    return 0;
}
"""


def arithmetic_jpegs(workdir: Path) -> dict[str, bytes]:
    """Arithmetic-coded JPEGs (baseline sequential and progressive) written
    by the system libjpeg, which has C_ARITH_CODING_SUPPORTED."""
    src, exe = workdir / "arith_tool.cpp", workdir / "arith_tool"
    src.write_text(_ARITH_TOOL)
    subprocess.run(["g++", "-O2", str(src), "-o", str(exe), "-ljpeg"], check=True, capture_output=True)
    from mmtrs_tpu_torch.synth import synth_teeth

    teeth = synth_teeth(1, (61, 83), seed=78)[0]
    (workdir / "in.rgb").write_bytes(np.ascontiguousarray(teeth).tobytes())
    out = {}
    for prog in (0, 1):
        dst = workdir / f"arith_{prog}.jpg"
        subprocess.run([str(exe), str(workdir / "in.rgb"), "61", "83", str(dst), str(prog)], check=True)
        out[f"jpeg_arithmetic{'_progressive' if prog else ''}.jpg"] = dst.read_bytes()
    return out


def golden_files(workdir: Path) -> dict[str, bytes]:
    """Every golden file, by name (its extension as a user's file would have)."""
    out = {}
    for part in (_pnm(), _tga(), _pcx(), _sgi(), _psd(), _dds(), _tiff(), _others(), arithmetic_jpegs(workdir)):
        out.update(part)
    return out


def write_goldens(path: Path = GOLDENS) -> int:
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        files = golden_files(Path(d))
    arrays = {}
    for name, data in sorted(files.items()):
        fmt, rgb = _pillow(data)
        arrays[name] = np.frombuffer(data, np.uint8)
        arrays[f"{name}.pil"] = rgb
        arrays[f"{name}.format"] = np.frombuffer(fmt.encode(), np.uint8)
    np.savez_compressed(path, **arrays)
    return len(files)


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------


def _golden_names() -> list[str]:
    if not GOLDENS.exists():  # before the first ``python -m tests.test_torch_codec_pillow``
        return []
    with np.load(GOLDENS) as z:
        return sorted(f for f in z.files if not f.endswith((".pil", ".format")))


@pytest.fixture(scope="module")
def goldens():
    with np.load(GOLDENS) as z:
        return {f: z[f] for f in z.files}


def test_goldens_are_small_and_regenerate_bit_for_bit(tmp_path):
    """The committed file is under 1 MB and is what the writers above and
    Pillow 12.1 give now: the same files and Pillow's decode of each."""
    assert GOLDENS.stat().st_size < 1 << 20
    fresh = golden_files(tmp_path)
    with np.load(GOLDENS) as z:
        assert sorted(fresh) == _golden_names()
        for name, data in fresh.items():
            # the arithmetic JPEGs depend on the system libjpeg's encoder;
            # every other file is the writers' and Pillow's
            if not name.startswith("jpeg_arithmetic"):
                assert z[name].tobytes() == data, name
            fmt, rgb = _pillow(z[name].tobytes())
            np.testing.assert_array_equal(rgb, z[f"{name}.pil"], err_msg=name)
            assert fmt == z[f"{name}.format"].tobytes().decode(), name


@pytest.mark.parametrize("name", _golden_names())
def test_golden_decodes_and_sniffs_as_pillow(goldens, name):
    """Every golden: the port's decode equals Pillow's, bit for bit, and
    sniff names Pillow's format."""
    from mmtrs_tpu_torch.utils.codec import decode_image, sniff

    data = goldens[name].tobytes()
    assert sniff(data) == goldens[f"{name}.format"].tobytes().decode()
    got = decode_image(data, "cpu")
    assert got.dtype.is_floating_point is False and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), goldens[f"{name}.pil"])


def _mutations(data: bytes, seed: int) -> list[bytes]:
    """Cuts at 8 places, 24 files with 1-3 bytes changed anywhere, and 8
    with a byte changed in the first 32."""
    rng = np.random.default_rng(seed)
    out = [data[:int(c)] for c in np.linspace(1, len(data) - 1, 8)]
    for k in range(32):
        m = bytearray(data)
        span = 32 if k >= 24 else len(m)
        for i in rng.integers(0, min(span, len(m)), rng.integers(1, 4)):
            m[int(i)] = int(rng.integers(0, 256))
        out.append(bytes(m))
    return out


def _pillow_or_none(data: bytes):
    try:
        im = Image.open(io.BytesIO(data))
        if im.size[0] * im.size[1] > 1 << 22:
            return "big"
        return im.format, np.asarray(im.convert("RGB"))
    except Exception:  # noqa: BLE001  (whatever Pillow raises for a bad file)
        return None


FAMILIES = ["ppm", "tga", "pcx", "sgi", "psd", "dds", "tiff", "qoi", "ico", "xbm", "sun", "im", "fits", "msp", "blp",
            "icns", "fli"]


@pytest.mark.parametrize("family", FAMILIES)
def test_sniff_and_decode_agree_with_pillow_on_mutated_files(goldens, family):
    """Cut and mutated goldens of each family, and garbage: where Pillow
    opens and decodes, sniff names its format and the decode is equal;
    where Pillow raises, the port raises a ValueError."""
    from mmtrs_tpu_torch.utils.codec import decode_image, sniff

    names = [n for n in _golden_names() if n.startswith(family)]
    rng = np.random.default_rng(len(family))
    corpus = [rng.integers(0, 256, int(rng.integers(1, 300)), np.uint8).tobytes() for _ in range(4)]
    for i, n in enumerate(names[:6]):
        corpus += _mutations(goldens[n].tobytes(), i)
    bad = []
    for data in corpus:
        want = _pillow_or_none(data)
        if want == "big":
            continue
        try:
            got = decode_image(data, "cpu").numpy()
        except ValueError:
            got = None
        if want is None:
            if got is not None:
                bad.append(("port decodes, Pillow raises", data[:40]))
            continue
        if got is None or sniff(data) != want[0] or got.shape != want[1].shape or not np.array_equal(got, want[1]):
            bad.append((f"Pillow {want[0]}, port {sniff(data)}", data[:40]))
    assert bad == [], bad[:3]


def test_every_pillow_opener_is_known_in_pillows_order():
    """The port's openers are Pillow 12.1's 43, in Image.open's order."""
    from mmtrs_tpu_torch.utils.rasters import openers

    Image.preinit()
    first = list(Image.ID)
    Image.init()
    order = first + [f for f in Image.ID if f not in first]
    assert [name.upper() for name, _, _ in openers()] == order


@pytest.mark.parametrize("mode", ["1", "L", "LA", "P", "PA", "RGBA", "RGBX", "CMYK", "YCbCr", "I;16", "I", "F"])
def test_convert_rgb_equals_pillow(mode):
    """codec.convert_rgb against Pillow's convert("RGB"): every 8-bit value
    (every (c, k) pair of CMYK on each channel, YCbCr's (cb, cr) plane at
    six luma values and 2^20 random triples), all 65,536 16-bit values, and
    an int and float sweep with negatives, values above 255, NaN and ±inf."""
    from mmtrs_tpu_torch.utils.codec import convert_rgb

    rng = np.random.default_rng(0)
    v = np.arange(256, dtype=np.uint8)
    palette = None
    if mode in ("1",):
        px = np.array([[0, 255]], np.uint8)
    elif mode in ("L", "P"):
        px = v.reshape(16, 16)
        palette = rng.integers(0, 256, (200, 3), np.uint8) if mode == "P" else None
    elif mode in ("LA", "PA"):
        px = np.stack([v, v[::-1]], -1).reshape(16, 16, 2)
        palette = rng.integers(0, 256, (256, 3), np.uint8) if mode == "PA" else None
    elif mode in ("RGBA", "RGBX"):
        px = rng.integers(0, 256, (64, 64, 4), np.uint8)
    elif mode == "CMYK":
        c, k = np.meshgrid(v, v, indexing="ij")
        z = np.zeros_like(c)
        px = np.concatenate([np.stack([c, z, z, k], -1), np.stack([z, c, z, k], -1), np.stack([z, z, c, k], -1),
                             rng.integers(0, 256, (256, 256, 4), np.uint8)], 0)
    elif mode == "YCbCr":
        cb, cr = np.meshgrid(v, v, indexing="ij")
        planes = [np.stack([np.full_like(cb, y), cb, cr], -1) for y in (0, 1, 127, 128, 254, 255)]
        px = np.concatenate(planes + [rng.integers(0, 256, (4096, 256, 3), np.uint8)], 0)
    elif mode == "I;16":
        px = np.arange(65536, dtype=np.uint16).reshape(256, 256)
    elif mode == "I":
        px = np.concatenate([np.arange(-300, 600), [2 ** 31 - 1, -2 ** 31, 70000, -70000]]).astype(np.int32)[None]
    else:
        f = np.concatenate([np.linspace(-300, 600, 9001), [np.nan, np.inf, -np.inf, 254.999, 255.0, 0.999, -0.0,
                                                           3.4e38, -3.4e38, 1e-30]]).astype(np.float32)
        px = f[None]
    raw = np.packbits(px > 0, axis=1) if mode == "1" else px  # Pillow's "1" takes packed bits
    im = Image.frombytes(mode, (px.shape[1], px.shape[0]), np.ascontiguousarray(raw).tobytes())
    if palette is not None:
        im.putpalette(palette.tobytes())
    want = np.asarray(im.convert("RGB"))
    np.testing.assert_array_equal(convert_rgb(px, mode, palette), want)


def _bomb_files() -> dict[str, bytes]:
    big = 60_000
    return {
        "tga": tga_bytes(2, 24, bytes(64), big, big),
        "psd": psd_bytes(3, 8, [np.zeros((1, 1), np.uint8)] * 3, False)[:14] + struct.pack(">II", big, big)
               + psd_bytes(3, 8, [np.zeros((1, 1), np.uint8)] * 3, False)[22:],
        "dds": dds_bytes(big, big, "bc7", bytes(64)),
        "qoi": b"qoif" + struct.pack(">II", big, big) + bytes([3, 0]) + bytes(16),
        "sgi": struct.pack(">HBBHHHH", 474, 0, 1, 3, big, big, 3).ljust(600, b"\0"),
        "pcx": pcx_bytes(big, big, 8, 3, b"", big),
        "ppm": b"P6 60000 60000 255\n" + bytes(64),
        "ico": struct.pack("<HHH", 0, 1, 1) + struct.pack("<BBBBHHII", 0, 0, 0, 0, 1, 32, 40, 22)
               + struct.pack("<IiiHHIIiiII", 40, big, 2 * big, 1, 32, 0, 0, 0, 0, 0, 0),
    }


@pytest.mark.parametrize("fmt", ["tga", "psd", "dds", "qoi", "sgi", "pcx", "ppm", "ico"])
def test_bomb_limit_holds_for_the_new_formats(fmt):
    """A header over Pillow's limit raises a ValueError naming the size
    before anything large is allocated, where Pillow raises
    DecompressionBombError."""
    import tracemalloc

    from mmtrs_tpu_torch.utils.codec import MAX_PIXELS, decode_image

    data = _bomb_files()[fmt]
    with pytest.raises(Image.DecompressionBombError):
        Image.open(io.BytesIO(data)).load()
    tracemalloc.start()
    try:
        with pytest.raises(ValueError, match=rf"exceeds the limit of {MAX_PIXELS} pixels"):
            decode_image(data, "cpu")
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    assert peak < 16 << 20, peak


def refused_files() -> dict[str, tuple[bytes, str]]:
    """Files of the formats the port refuses, and the name its error holds:
    Pillow 12.1 here opens none of them to the end either; None for a
    format once refused that the port now decodes (AVIF, Lab PSD, PCD,
    JPEG 2000)."""
    img = Image.fromarray(_rgb(80))
    return {
        "eps": (b"%!PS-Adobe-3.0 EPSF-3.0\n%%BoundingBox: 0 0 16 16\n%%EndComments\nshowpage\n", "EPS"),
        "wmf": (bytes.fromhex("d7cdc69a0000") + bytes(16) + bytes(64), "WMF"),
        "emf": (struct.pack("<II", 1, 88) + bytes(80), "WMF"),
        "bufr": (b"BUFR" + bytes(60), "BUFR"),
        "grib": (b"GRIB\0\0\0\x01" + bytes(60), "GRIB"),
        "hdf5": (b"\x89HDF\r\n\x1a\n" + bytes(60), "HDF5"),
        "mpeg": (b"\x00\x00\x01\xb3" + struct.pack(">HH", 0x0100, 0x1000) + bytes(60), "MPEG"),
        "avif": (_save(img, "AVIF"), None),
        "jpeg2000": (_save(img, "JPEG2000"), None),
        "psd_lab": (psd_bytes(9, 8, [np.zeros((H, W), np.uint8)] * 3, False), None),
        "tga_cmap32": (tga_bytes(1, 8, bytes(W * H), W, H, cmap=(0, 4, 32, bytes(16))), "TGA colour maps of 32"),
        "tga_type1_no_map": (tga_bytes(1, 8, bytes(W * H), W, H), "TGA colour-mapped"),
        "tga_rle_1bit": (tga_bytes(11, 1, b"\x82\xff" * 40, W, H), "TGA"),
        "tga_run_across_rows": (tga_bytes(10, 24, b"\xff\x01\x02\x03" * 4, W, H), "TGA.*run past"),
        "pcd": ((bytes(2048) + b"PCD_IPI").ljust(96 * 2048 + 768 * 512 * 3 // 2, b"\x80"), None),
    }


@pytest.mark.parametrize("case", list(refused_files()))
def test_refused_formats_name_themselves(case):
    from mmtrs_tpu_torch.utils.codec import decode_image

    data, name = refused_files()[case]
    if name is None:  # refused once, now decoded as Pillow decodes it (AVIF, Lab PSD, PCD, JPEG 2000)
        np.testing.assert_array_equal(decode_image(data, "cpu").numpy(), _pillow(data)[1])
        return
    with pytest.raises(Exception):  # noqa: B017  (Pillow's own error types)
        Image.open(io.BytesIO(data)).convert("RGB")
    with pytest.raises(ValueError, match=name):
        decode_image(data, "cpu")


def test_arithmetic_jpegs_are_named(goldens):
    """The arithmetic-coded goldens are found as such (they go to the
    port's own decoder on either device); the Huffman ones are not."""
    from mmtrs_tpu_torch.utils.codec import jpeg_components, jpeg_is_arithmetic

    arith = [n for n in goldens if n.startswith("jpeg_arithmetic") and not n.endswith((".pil", ".format"))]
    assert len(arith) == 2 and all(jpeg_is_arithmetic(goldens[n].tobytes()) for n in arith)
    assert all(jpeg_components(goldens[n].tobytes()) == 3 for n in arith)
    with np.load(ROOT / "mmtrs_tpu_torch" / "testdata" / "codec_goldens.npz") as z:
        assert not any(jpeg_is_arithmetic(z[f].tobytes()) for f in z.files if f.endswith(".jpg"))


def test_jpeg_in_tiff_on_a_cuda_tensor_takes_nvjpeg_or_raises(goldens, monkeypatch):
    """JPEG-in-TIFF for the card goes to nvJPEG: without a card its library
    raises by name; nothing falls back to libjpeg on the host."""
    import torch

    from mmtrs_tpu_torch import _build
    from mmtrs_tpu_torch.utils import codec

    monkeypatch.setattr(_build, "jpeg_library", lambda: (_ for _ in ()).throw(AssertionError("host route")))
    if torch.cuda.is_available():
        pytest.skip("a card is visible: chip_smoke.py phase 9 holds the nvJPEG route")
    _build.nvjpeg_library.cache_clear()
    with pytest.raises(RuntimeError, match="nvJPEG|CUDA"):
        codec.decode_tiff_to(goldens["tiff_jpeg_rgb.tif"].tobytes(), torch.device("cuda"))


if __name__ == "__main__":
    print(f"wrote {write_goldens()} goldens to {GOLDENS}")
