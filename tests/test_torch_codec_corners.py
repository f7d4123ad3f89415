"""The corners of the formats Pillow 12.1 decodes that the port once refused,
held against Pillow live on the CPU route: TIFF's floating-point predictor
(3) and BigTIFF, CIELab in TIFF and PSD (Pillow converts it through
LittleCMS), IPTC with more than one layer, FLI/FLC first frames made of
delta chunks, damaged CCITT strips, JPEG-in-TIFF whose frames the port's
own decoder takes (lossless, arithmetic-coded), progressive arithmetic
frames whose scans leave coefficients unrefined (libjpeg's block
smoothing) and Kodak PhotoCD. Each file is written by hand here: Pillow
cannot write most of them.

The goldens (``mmtrs_tpu_torch/testdata/corners_goldens.npz``: each file
and Pillow's decode of it, which chip_smoke.py holds the card route to)
are regenerated with ``python -m tests.test_torch_codec_corners``.
"""

from __future__ import annotations

import io
import re
import struct
import zlib
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from tests.test_torch_codec_formats import tiff_bytes

ROOT = Path(__file__).resolve().parents[1]
GOLDENS = ROOT / "mmtrs_tpu_torch" / "testdata" / "corners_goldens.npz"
H, W = 19, 23  # odd sizes: partial strips, tiles and blocks


def _pillow(data: bytes) -> tuple[str, np.ndarray]:
    im = Image.open(io.BytesIO(data))
    return im.format, np.asarray(im.convert("RGB"))


def _pillow_or_none(data: bytes):
    try:
        return _pillow(data)
    except Exception:  # noqa: BLE001  (whatever Pillow raises for a bad file)
        return None


def _port(data: bytes) -> np.ndarray:
    from mmtrs_tpu_torch.utils.codec import decode_image

    return decode_image(data, "cpu").numpy()


# ---------------------------------------------------------------------------
# TIFF: the floating-point predictor and BigTIFF
# ---------------------------------------------------------------------------


def tiff_lzw(raw: bytes) -> bytes:
    """TIFF LZW (MSB first, early change) with literals only: a Clear code
    every 200 codes keeps the decoder's table, and the code width, at 9 bits."""
    codes = []
    for i in range(0, len(raw), 200):
        codes += [256, *raw[i:i + 200]]
    codes.append(257)
    bits = "".join(f"{c:09b}" for c in codes)
    bits += "0" * (-len(bits) % 8)
    return int(bits, 2).to_bytes(len(bits) // 8, "big")


def _fp_encode(px: np.ndarray) -> np.ndarray:
    """libtiff's floating-point predictor on rows of [rows, cols, spp] f32:
    each row's big-endian bytes split into byte planes (most significant
    first), then differenced mod 256 ``spp`` bytes apart."""
    rows, cols, spp = px.shape
    planes = px.astype(">f4").view(np.uint8).reshape(rows, cols * spp, 4).transpose(0, 2, 1).reshape(rows, -1)
    d = planes.astype(np.int64)
    d[:, spp:] -= planes[:, :-spp]
    return (d % 256).astype(np.uint8)


def _float_px(seed: int, h: int = H, w: int = W) -> np.ndarray:
    rng = np.random.default_rng(seed)
    f = (rng.standard_normal((h, w)) * 90 + 120).astype(np.float32)
    f.flat[::7] = rng.uniform(-5, 300, f.size)[::7].astype(np.float32)  # both clips
    return f


def float_p3_tiff(bo: str = "<", comp: int = 8, tiled=None, rows_per_strip: int = 5, big: bool = False,
                  seed: int = 0) -> bytes:
    """A 32-bit float gray TIFF with predictor 3, deflate or LZW, strips or
    tiles (the predictor runs over each tile's whole rows)."""
    f = _float_px(seed)
    if tiled:
        tw, th = tiled
        ph, pw = -(-H // th) * th, -(-W // tw) * tw
        full = np.zeros((ph, pw), np.float32)
        full[:H, :W] = f
        parts = [full[r:r + th, c:c + tw] for r in range(0, ph, th) for c in range(0, pw, tw)]
    else:
        parts = [f[r:r + rows_per_strip] for r in range(0, H, rows_per_strip)]
    enc = lambda raw: zlib.compress(raw) if comp == 8 else tiff_lzw(raw)
    chunks = [enc(_fp_encode(p[..., None]).tobytes()) for p in parts]
    tags = {258: (3, [32]), 259: (3, [comp]), 262: (3, [1]), 277: (3, [1]), 317: (3, [3]), 339: (3, [3])}
    if not tiled:
        tags[278] = (3, [rows_per_strip])
    return tiff_bytes(W, H, tags, chunks, bo, tiled, big=big)


def _save(img: Image.Image, fmt: str, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, fmt, **kw)
    return buf.getvalue()


def rgb_tiff(bo: str = "<", comp: int = 1, tiled=None, planar: int = 1, big: bool = False, offset_type: int = 4,
             seed: int = 1, h: int = H, w: int = W, rows_per_strip: int = 4) -> bytes:
    """An 8-bit RGB TIFF: none, LZW or deflate; strips or tiles; chunky or
    planar."""
    px = np.random.default_rng(seed).integers(0, 256, (h, w, 3), np.uint8)
    planes = [px[..., i:i + 1] for i in range(3)] if planar == 2 else [px]
    enc = {1: bytes, 5: tiff_lzw, 8: zlib.compress}[comp]
    chunks = []
    for p in planes:
        if tiled:
            tw, th = tiled
            ph, pw = -(-h // th) * th, -(-w // tw) * tw
            full = np.zeros((ph, pw, p.shape[2]), np.uint8)
            full[:h, :w] = p
            parts = [full[r:r + th, c:c + tw] for r in range(0, ph, th) for c in range(0, pw, tw)]
        else:
            parts = [p[r:r + rows_per_strip] for r in range(0, h, rows_per_strip)]
        chunks += [enc(q.tobytes()) for q in parts]
    tags = {258: (3, [8] * 3), 259: (3, [comp]), 262: (3, [2]), 277: (3, [3]), 284: (3, [planar])}
    if not tiled:
        tags[278] = (3, [rows_per_strip])
    return tiff_bytes(w, h, tags, chunks, bo, tiled, big=big, offset_type=offset_type)


def _tiff_corners() -> dict[str, bytes]:
    f = Image.fromarray(_float_px(3), "F")
    return {
        "tiff_p3_pillow_deflate.tif": _save(f, "TIFF", compression="tiff_adobe_deflate", tiffinfo={317: 3}),
        "tiff_p3_pillow_lzw.tif": _save(f, "TIFF", compression="tiff_lzw", tiffinfo={317: 3}),
        "tiff_p3_lzw.tif": float_p3_tiff(comp=5),
        "tiff_p3_deflate_be.tif": float_p3_tiff(">", seed=1),
        "tiff_p3_tiled.tif": float_p3_tiff(tiled=(16, 16), seed=2),
        "tiff_p3_big.tif": float_p3_tiff(comp=5, big=True, seed=4),
        "bigtiff_raw.tif": rgb_tiff(big=True),
        "bigtiff_long8_lzw.tif": rgb_tiff(comp=5, big=True, offset_type=16, seed=2),
        "bigtiff_slong8_deflate.tif": rgb_tiff(comp=8, big=True, offset_type=17, seed=3),
        "bigtiff_tiled_planar.tif": rgb_tiff(comp=8, big=True, tiled=(16, 16), planar=2, seed=4),
        "bigtiff_tiled_raw.tif": rgb_tiff(big=True, tiled=(16, 16), offset_type=16, seed=5),
        "tiff_ifd_offsets_raw.tif": rgb_tiff(offset_type=13, seed=6),
    }


def _tiff_refused() -> dict[str, tuple[bytes, str]]:
    half = np.float16(_float_px(5)).view(np.uint16)
    f16 = tiff_bytes(W, H, {258: (3, [16]), 259: (3, [1]), 262: (3, [1]), 277: (3, [1]), 278: (3, [H]),
                            339: (3, [3])}, [half.tobytes()])
    p3_int = tiff_bytes(W, H, {258: (3, [8]), 259: (3, [8]), 262: (3, [1]), 277: (3, [1]), 278: (3, [H]),
                               317: (3, [3])}, [zlib.compress(bytes(W * H))])
    return {
        "tiff_float16": (f16, "16 bits"),
        "tiff_p3_on_integers": (p3_int, "floating-point predictor"),
        "bigtiff_big_endian": (rgb_tiff(">", big=True), "TIFF"),
        "bigtiff_ifd8_lzw": (rgb_tiff(comp=5, big=True, offset_type=18), "type 18"),
        "tiff_slong8_raw": (rgb_tiff(offset_type=17), "TIFF"),
    }


# ---------------------------------------------------------------------------
# CIELab: TIFF (photometric 8) and PSD (mode 9)
# ---------------------------------------------------------------------------


def _lab_px(seed: int, h: int = H, w: int = W) -> np.ndarray:
    """L, a, b bytes over their whole range (a and b as the file stores
    them: signed in TIFF, offset by 128 in PSD, the same bytes)."""
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), np.uint8)


def lab_tiff(bo: str = "<", comp: int = 1, planar: int = 1, seed: int = 30, rows_per_strip: int = 5) -> bytes:
    px = _lab_px(seed)
    planes = [px[..., i:i + 1] for i in range(3)] if planar == 2 else [px]
    enc = {1: bytes, 5: tiff_lzw, 8: zlib.compress}[comp]
    chunks = [enc(p[r:r + rows_per_strip].tobytes()) for p in planes for r in range(0, H, rows_per_strip)]
    tags = {258: (3, [8] * 3), 259: (3, [comp]), 262: (3, [8]), 277: (3, [3]), 278: (3, [rows_per_strip]),
            284: (3, [planar])}
    return tiff_bytes(W, H, tags, chunks, bo)


def _lab_corners() -> dict[str, bytes]:
    from tests.test_torch_codec_pillow import psd_bytes

    px = _lab_px(33)
    planes = [px[..., i] for i in range(3)]
    return {
        "tiff_lab_raw.tif": lab_tiff(),
        "tiff_lab_lzw.tif": lab_tiff(comp=5, seed=31),
        "tiff_lab_deflate_planar_be.tif": lab_tiff(">", comp=8, planar=2, seed=32),
        "tiff_lab_raw_planar.tif": lab_tiff(planar=2, seed=35),
        "psd_lab_raw.psd": psd_bytes(9, 8, planes, False),
        "psd_lab_rle.psd": psd_bytes(9, 8, [np.repeat(p[:, ::3], 3, 1)[:, :W] for p in planes], True),
        "psd_lab_alpha.psd": psd_bytes(9, 8, planes + [_lab_px(34)[..., 0]], True),
    }


def _lab_refused() -> dict[str, tuple[bytes, str]]:
    from tests.test_torch_codec_pillow import psd_bytes

    px16 = [np.zeros((H, 2 * W), np.uint8)] * 3
    return {"psd_lab_16bit": (psd_bytes(9, 16, px16, False), "cannot identify")}


# ---------------------------------------------------------------------------
# IPTC with more than one layer
# ---------------------------------------------------------------------------


def _field(rec: int, tag: int, body: bytes) -> bytes:
    return bytes([0x1C, rec, tag]) + struct.pack(">H", len(body)) + body


def iptc_bytes(layers: int, component: int, data: bytes, band: int | None = None, compression: int = 1,
               w: int = W, h: int = H) -> bytes:
    """An IPTC/NAA image record: layers and component (3:60), the band the
    data fills (3:65, 1-based), size, compression (1 raw, 5 JPEG) and the
    data in 8:10 fields of at most 1000 bytes."""
    out = _field(3, 60, bytes([layers, component])) + _field(3, 20, struct.pack(">H", w))
    out += _field(3, 30, struct.pack(">H", h)) + _field(3, 120, bytes([compression]))
    if band is not None:
        out += _field(3, 65, bytes([band]))
    return out + b"".join(_field(8, 10, data[i:i + 1000]) for i in range(0, len(data), 1000))


def _gray(seed: int, h: int = H, w: int = W) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (h, w), np.uint8)


def _iptc_corners() -> dict[str, bytes]:
    g = _gray(20).tobytes()
    jpeg_gray = _save(Image.fromarray(_gray(21)), "JPEG", quality=90)
    return {
        "iptc_rgb_band1.iptc": iptc_bytes(3, 1, g),
        "iptc_rgb_band2.iptc": iptc_bytes(3, 1, g, band=2),
        "iptc_rgb_band3.iptc": iptc_bytes(3, 1, g, band=3),
        "iptc_rgb_band0.iptc": iptc_bytes(3, 1, g, band=0),
        "iptc_cmyk_band2.iptc": iptc_bytes(4, 1, g, band=2),
        "iptc_cmyk_band4.iptc": iptc_bytes(4, 1, g, band=4),
        "iptc_rgb_jpeg_gray.iptc": iptc_bytes(3, 1, jpeg_gray, band=3, compression=5),
    }


def _iptc_refused() -> dict[str, tuple[bytes, str]]:
    g = _gray(22).tobytes()
    jpeg_rgb = _save(Image.fromarray(np.dstack([_gray(23)] * 3)), "JPEG", quality=90)
    return {
        "iptc_rgb_band_past_the_last": (iptc_bytes(3, 1, g, band=5), "IPTC"),
        "iptc_rgb_jpeg_of_three_components": (iptc_bytes(3, 1, jpeg_rgb, band=1, compression=5), "IPTC"),
        "iptc_rgb_short_data": (iptc_bytes(3, 1, g[:100], band=1), "IPTC|PPM|truncated"),
    }


# ---------------------------------------------------------------------------
# FLI/FLC first frames made of delta chunks
# ---------------------------------------------------------------------------


def _chunk(kind: int, body: bytes) -> bytes:
    body += b"\0" * (len(body) & 1)
    return struct.pack("<IH", 6 + len(body), kind) + body


def fli_file(w: int, h: int, chunks: list[bytes], seed: int, magic: int = 0xAF12, prefix: bytes = b"") -> bytes:
    """An FLC (or FLI: 0xAF11) of one frame: a colour chunk (type 4), then
    ``chunks``; ``prefix``: a prefix chunk (0xF100) before the frame."""
    pal = np.random.default_rng(seed).integers(0, 256, 3 * 256, np.uint8).tobytes()
    color = _chunk(4, struct.pack("<H", 1) + bytes([0, 0]) + pal)
    body = color + b"".join(chunks)
    frame = struct.pack("<IHH8x", 16 + len(body), 0xF1FA, 1 + len(chunks)) + body
    if prefix:
        prefix = struct.pack("<IH", 6 + len(prefix), 0xF100) + prefix
    head = struct.pack("<IHHHHHHI", 128 + len(prefix) + len(frame), magic, 1, w, h, 8, 0, 70).ljust(128, b"\0")
    return head + prefix + frame


def lc_chunk(rows: dict[int, list[tuple[int, bytes | tuple[int, int]]]], y0: int, n: int) -> bytes:
    """LC (12): lines y0..y0+n; each line's packets (skip, literal bytes or
    (run length, value))."""
    body = bytearray(struct.pack("<HH", y0, n))
    for y in range(y0, y0 + n):
        packets = rows.get(y, [])
        body.append(len(packets))
        for skip, p in packets:
            if isinstance(p, tuple):
                body += bytes([skip, 256 - p[0], p[1]])
            else:
                body += bytes([skip, len(p)]) + p
    return _chunk(12, bytes(body))


def ss2_chunk(lines: list[tuple[int, int | None, list[tuple[int, bytes | tuple[int, bytes]]]]]) -> bytes:
    """SS2 (7): per coded line (lines to skip before it, the last byte of an
    odd width or None, packets (skip, literal words or (run length, word)))."""
    body = bytearray(struct.pack("<H", len(lines)))
    for skip, last, packets in lines:
        if skip:
            body += struct.pack("<H", 65536 - skip)
        if last is not None:
            body += struct.pack("<H", 0x8000 | last)
        body += struct.pack("<H", len(packets))
        for pskip, p in packets:
            if isinstance(p, tuple):
                body += bytes([pskip, 256 - p[0]]) + p[1]
            else:
                body += bytes([pskip, len(p) // 2]) + p
    return _chunk(7, bytes(body))


def _lc_rows(seed: int, w: int, y0: int, n: int) -> dict:
    rng = np.random.default_rng(seed)
    rows = {}
    for y in range(y0, y0 + n):
        x, packets = 0, []
        while len(packets) < 6:
            skip = int(rng.integers(0, 4))
            k = int(rng.integers(1, 6))
            if x + skip + k > w:
                break
            val = (k, int(rng.integers(0, 256))) if rng.random() < 0.5 else rng.integers(0, 256, k, np.uint8).tobytes()
            packets.append((skip, val))
            x += skip + k
        rows[y] = packets
    return rows


def _ss2_lines(seed: int, w: int, h: int) -> list:
    rng = np.random.default_rng(seed)
    lines, y = [], 0
    while y < h:
        skip = int(rng.integers(0, 3))
        if y + skip >= h:
            break
        y += skip
        x, packets = 0, []
        while len(packets) < 4:
            pskip = 2 * int(rng.integers(0, 2))
            k = int(rng.integers(1, 4))
            if x + pskip + 2 * k > w:
                break
            if rng.random() < 0.5:
                packets.append((pskip, (k, rng.integers(0, 256, 2, np.uint8).tobytes())))
            else:
                packets.append((pskip, rng.integers(0, 256, 2 * k, np.uint8).tobytes()))
            x += pskip + 2 * k
        last = int(rng.integers(0, 256)) if w % 2 and rng.random() < 0.5 else None
        lines.append((skip, last, packets))
        y += 1
    return lines


def _brun_chunk(px: np.ndarray) -> bytes:
    rows = bytearray()
    for row in px:
        rows += b"\0" + bytes([256 - len(row)]) + row.tobytes()
    return _chunk(15, bytes(rows))


def _fli_corners() -> dict[str, bytes]:
    base = np.random.default_rng(40).integers(0, 256, (H, W), np.uint8)
    return {
        "fli_lc.flc": fli_file(W, H, [lc_chunk(_lc_rows(41, W, 2, 12), 2, 12)], 41),
        "fli_lc_whole.fli": fli_file(W, H, [lc_chunk(_lc_rows(42, W, 0, H), 0, H)], 42, magic=0xAF11),
        "fli_ss2.flc": fli_file(W, H, [ss2_chunk(_ss2_lines(43, W, H))], 43),
        "fli_ss2_even.flc": fli_file(W - 1, H, [ss2_chunk(_ss2_lines(44, W - 1, H))], 44),
        "fli_brun_then_lc.flc": fli_file(W, H, [_brun_chunk(base), lc_chunk(_lc_rows(45, W, 5, 9), 5, 9)], 45),
        "fli_black_ss2_lc.flc": fli_file(W, H, [_chunk(13, b""), ss2_chunk(_ss2_lines(46, W, H)),
                                                lc_chunk(_lc_rows(47, W, 0, 4), 0, 4)], 46),
    }


def _fli_refused() -> dict[str, tuple[bytes, str]]:
    over = {3: [(20, (5, 7))]}  # a run past the width: FliDecode stops, an overrun
    return {
        "fli_lc_run_past_the_width": (fli_file(W, H, [lc_chunk(over, 3, 1)], 48), "FLI"),
        "fli_lc_lines_past_the_height": (fli_file(W, H, [lc_chunk(_lc_rows(49, W, 10, 9), 10, 12)], 49), "FLI"),
        "fli_ss2_skip_past_the_height": (fli_file(W, H, [ss2_chunk([(H + 2, None, [])])], 50), "FLI"),
        "fli_lc_with_a_prefix_chunk": (fli_file(W, H, [lc_chunk(_lc_rows(51, W, 0, 3), 0, 3)], 51,
                                                prefix=b"\0" * 10), "FLI"),
    }


# ---------------------------------------------------------------------------
# JPEG-in-TIFF whose frames the own decoder takes
# ---------------------------------------------------------------------------


def _jpeg_golden(name: str) -> bytes:
    with np.load(ROOT / "mmtrs_tpu_torch" / "testdata" / "jpeg_goldens.npz") as z:
        return z[name].tobytes()


def jpeg_tiff(streams: list[bytes], photometric: int, subsampling=None, rows: int | None = None) -> bytes:
    """A JPEG-in-TIFF (compression 7) whose strips are ``streams`` (each a
    whole JPEG of the strip's rows; the same width)."""
    from mmtrs_tpu_torch.utils.codec import jpeg_frame_header

    heads = [jpeg_frame_header(st) for st in streams]
    _, _, h, w, comps = heads[0]
    n = len(comps)
    rows = rows or h
    tags = {258: (3, [8] * n), 259: (3, [7]), 262: (3, [photometric]), 277: (3, [n]), 278: (3, [rows])}
    if photometric == 6:
        tags[530] = (3, list(subsampling or comps[0][1:]))
    return tiff_bytes(w, rows * (len(streams) - 1) + heads[-1][2], tags, streams)


def _jpeg_tiff_corners() -> dict[str, bytes]:
    g = _jpeg_golden
    return {
        "jit_arith_420_ycbcr.tif": jpeg_tiff([g("arith_420_19x23.jpg")], 6),
        "jit_arith_prog_411_ycbcr.tif": jpeg_tiff([g("arith_411_prog_19x23.jpg")], 6),
        "jit_arith_prog_422_restart_ycbcr.tif": jpeg_tiff([g("arith_422_prog_restart2.jpg")], 6),
        "jit_arith_444_rgb.tif": jpeg_tiff([g("arith_444.jpg")], 2),
        "jit_arith_rgb_ids_ycbcr.tif": jpeg_tiff([g("arith_rgb.jpg")], 6),
        "jit_arith_cmyk.tif": jpeg_tiff([g("arith_cmyk.jpg")], 5),
        "jit_arith_two_strips.tif": jpeg_tiff([g("arith_420_19x23.jpg")] * 2, 6),
        "jit_arith_prog_two_strips.tif": jpeg_tiff([g("arith_411_prog_19x23.jpg")] * 2, 6),
        "jit_lossless_rgb.tif": jpeg_tiff([g("lossless_p1.jpg")], 2),
        "jit_lossless_p7_restart_rgb.tif": jpeg_tiff([g("lossless_p7_restart2.jpg")], 2),
        "jit_lossless_gray.tif": jpeg_tiff([g("lossless_gray_p2.jpg")], 1),
        "jit_lossless_cmyk.tif": jpeg_tiff([g("lossless_cmyk_p3.jpg")], 5),
    }


def _jpeg_tiff_refused() -> dict[str, tuple[bytes, str]]:
    g = _jpeg_golden
    return {
        "jit_lossless_ycbcr": (jpeg_tiff([g("lossless_p1.jpg")], 6), "lossless JPEG-in-TIFF in YCbCr"),
        "jit_lossless_420_rgb": (jpeg_tiff([g("lossless_420.jpg")], 2), "sampling factors"),
        "jit_arith_420_rgb": (jpeg_tiff([g("arith_420_19x23.jpg")], 2), "sampling factors"),
        "jit_arith_gray_sampled": (jpeg_tiff([g("arith_gray.jpg")], 1), "sampling factors"),
        "jit_arith_420_under_a_smaller_tag": (jpeg_tiff([g("arith_420_19x23.jpg")], 6, (2, 1)), "sampling factors"),
        "jit_precision_12": (jpeg_tiff([g("refused_precision_12.jpg")], 2), "precision"),
        "jit_arith_mixed_sampling_strips": (jpeg_tiff([g("arith_420_19x23.jpg"), g("arith_411_prog_19x23.jpg")], 6,
                                                      (4, 2)), "sampling factors"),
        "jit_arith_444_under_a_larger_tag": (jpeg_tiff([g("arith_444.jpg")], 6, (2, 2)), "sampling factors"),
    }


# ---------------------------------------------------------------------------
# Progressive frames whose scans leave coefficients unrefined
# ---------------------------------------------------------------------------


def jpeg_scans(data: bytes) -> tuple[bytes, list[bytes], bytes]:
    """A progressive JPEG split into (the markers before its first scan,
    each scan with the table segments before it, EOI): a scan is its SOS
    segment and entropy-coded data up to the next marker that is not a
    stuffed byte or a restart."""
    first = data.find(b"\xff\xda")
    head, scans, pos = data[:first], [], first
    seg_start = first
    while pos < len(data):
        if data[pos:pos + 2] == b"\xff\xd9":
            scans.append(data[seg_start:pos])
            return head, scans, data[pos:]
        if data[pos:pos + 2] == b"\xff\xda":
            pos += 2 + struct.unpack(">H", data[pos + 2:pos + 4])[0]
            while not (data[pos] == 0xFF and data[pos + 1] not in (0, *range(0xD0, 0xD8))):
                pos += 1
            if data[pos + 1] != 0xD9:
                scans.append(data[seg_start:pos])
                seg_start = pos
            continue
        pos += 2 + struct.unpack(">H", data[pos + 2:pos + 4])[0]  # DHT, DAC, DQT, DRI between scans
    raise ValueError("no EOI")


def drop_scans(data: bytes, keep) -> bytes:
    """The file with only the scans whose index ``keep`` holds (the table
    segments before a dropped scan kept)."""
    head, scans, tail = jpeg_scans(data)
    out = head
    for i, sc in enumerate(scans):
        at = sc.find(b"\xff\xda")
        out += sc if i in keep else sc[:at]
    return out + tail


# (source golden, scans kept): the prefixes of libjpeg's simple progression
# (YCbCr: DC Al 1; Y 1-5; Cr, Cb 1-63; Y 6-63; Y refine; DC refine; Cr, Cb,
# Y refine), the DC refinement or a band left out, with and without restarts
SMOOTHED = {
    "prog420_dc_only": ("arith_420_prog.jpg", range(1)),
    "prog420_first2": ("arith_420_prog.jpg", range(2)),
    "prog420_first4": ("arith_420_prog.jpg", range(4)),
    "prog420_first6": ("arith_420_prog.jpg", range(6)),
    "prog420_no_dc_refine": ("arith_420_prog.jpg", {0, 1, 2, 3, 4, 5, 7, 8, 9}),
    "prog420_no_y_high_band": ("arith_420_prog.jpg", {0, 1, 2, 3, 6}),
    "prog422_restart_dc_only": ("arith_422_prog_restart2.jpg", range(1)),
    "prog422_restart_first2": ("arith_422_prog_restart2.jpg", range(2)),
    "prog422_restart_no_dc_refine": ("arith_422_prog_restart2.jpg", {0, 1, 2, 3, 4, 5, 7, 8, 9}),
    "prog411_first3": ("arith_411_prog_19x23.jpg", range(3)),
    "gray_prog_first2": ("arith_gray_prog.jpg", range(2)),
    "gray_prog_no_dc_refine": ("arith_gray_prog.jpg", {0, 1, 2, 3, 5}),
    "ycck_prog_first3": ("arith_ycck_prog.jpg", range(3)),
    "prog444_dc_only": ("arith_444_prog.jpg", range(1)),
}


def _with_height(data: bytes, h: int) -> bytes:
    """The frame header's height set to ``h`` (its scans' data past the rows
    left is ignored, as libjpeg ignores it)."""
    from mmtrs_tpu_torch.utils.codec import _jpeg_frame

    at = _jpeg_frame(data)[1] + 3
    return data[:at] + struct.pack(">H", h) + data[at + 2:]


def _sof2_progressive() -> bytes:
    """A Huffman progressive JPEG (SOF2) from Pillow, 61 × 83, 4:2:0."""
    yy, xx = np.mgrid[0:61, 0:83]
    img = np.stack([(xx * 3 + yy) % 256, (yy * 4) % 256, (xx * 2 + yy * 2) % 256], -1)
    img = (img + np.random.default_rng(5).integers(-10, 10, img.shape)).clip(0, 255).astype(np.uint8)
    return _save(Image.fromarray(img), "JPEG", quality=90, progressive=True)


# The same progressions in Huffman coding (SOF2): their scan headers leave
# coefficients that libjpeg smooths, so the port's own decoder takes them on
# both devices (their ids, ``record_sof2_*``, are those they had when the
# system libjpeg's decode was only recorded)
SOF2_RECORDED = {"dc_only": range(1), "first2": range(2), "first4": range(4), "first6": range(6),
                 "no_dc_refine": {0, 1, 2, 3, 4, 5, 7, 8, 9}}


def _sof2_recorded() -> dict[str, bytes]:
    src = _sof2_progressive()
    return {f"record_sof2_{name}.jpg": drop_scans(src, set(keep)) for name, keep in SOF2_RECORDED.items()}


def _smoothed_corners() -> dict[str, bytes]:
    out = {f"smooth_{name}.jpg": drop_scans(_jpeg_golden(src), set(keep)) for name, (src, keep) in SMOOTHED.items()}
    # 37 rows: the luma's last iMCU row holds one block row of its two
    for name, keep in (("first4", range(4)), ("dc_only", range(1)), ("no_dc_refine", {0, 1, 2, 3, 4, 5, 7, 8, 9})):
        out[f"smooth_prog420_h37_{name}.jpg"] = drop_scans(_with_height(_jpeg_golden("arith_420_prog.jpg"), 37),
                                                           set(keep))
    return out


# ---------------------------------------------------------------------------
# Old-style JPEG-in-TIFF (compression 6)
# ---------------------------------------------------------------------------


def jpeg_parts(j: bytes) -> tuple[dict, list, int, bytes]:
    """A baseline JPEG's tables ({("q" | "dc" | "ac", id): DQT body or DHT
    counts and values}), its components [(id, hv, tq, td, ta)], restart
    interval and entropy-coded data (without EOI)."""
    pos, tables, restart, sof = 2, {}, 0, []
    while True:
        m, size = j[pos + 1], struct.unpack(">H", j[pos + 2:pos + 4])[0]
        seg = j[pos + 4:pos + 2 + size]
        if m == 0xDB:
            for k in range(0, len(seg), 65):
                tables[("q", seg[k] & 15)] = seg[k + 1:k + 65]
        elif m == 0xC4:
            k = 0
            while k < len(seg):
                n = sum(seg[k + 1:k + 17])
                tables[("ac" if seg[k] >> 4 else "dc", seg[k] & 15)] = seg[k + 1:k + 17 + n]
                k += 17 + n
        elif m == 0xDD:
            restart = struct.unpack(">H", seg[:2])[0]
        elif m == 0xC0:
            sof = [(seg[6 + 3 * i], seg[7 + 3 * i], seg[8 + 3 * i]) for i in range(seg[5])]
        elif m == 0xDA:
            sel = {seg[1 + 2 * i]: seg[2 + 2 * i] for i in range(seg[0])}
            comps = [(cid, hv, tq, sel[cid] >> 4, sel[cid] & 15) for cid, hv, tq in sof]
            return tables, comps, restart, j[pos + 2 + size:-2]
        pos += 2 + size


def ojpeg_tiff(img: np.ndarray, layout: str, subsampling: str = "4:2:0", strip_rows: int | None = None,
               bo: str = "<", proc: int | None = None) -> bytes:
    """An old-style JPEG-in-TIFF of ``img`` (gray or RGB) from a Pillow
    JPEG, in one of libtiff's layouts: "whole" (JPEGInterchangeFormat and
    the one strip both at the whole JPEG), "head" (JPEGInterchangeFormat
    at the JPEG's header up to its scan, the entropy-coded data in the
    strips) or "tables" (JPEGProc ``proc``, JPEGQTables, JPEGDCTables,
    JPEGACTables, JPEGRestartInterval and YCbCrSubsampling, the data in
    the strips). ``strip_rows``: strips of that many rows, each a restart
    interval whose RST marker libtiff puts back."""
    gray = img.ndim == 2
    kw = {"quality": 85} if gray else {"quality": 85, "subsampling": subsampling}
    h, w = img.shape[:2]
    if strip_rows:
        kw["restart_marker_rows"] = strip_rows // (8 if gray or subsampling != "4:2:0" else 16)
    j = _save(Image.fromarray(img), "JPEG", **kw)
    n = 1 if gray else 3
    tags = {259: (3, [6]), 262: (3, [1 if gray else 6]), 277: (3, [n]), 258: (3, [8] * n)}
    if strip_rows:
        tags[278] = (4, [strip_rows])
    tables, comps, restart, body = jpeg_parts(j)
    strips = re.split(rb"\xff[\xd0-\xd7]", body) if strip_rows else [body]
    if layout == "whole":
        tags[513], tags[514] = (4, [0]), (4, [len(j)])
        tags[513] = (4, [tiff_bytes(w, h, tags, [j], bo).find(j)])
        return tiff_bytes(w, h, tags, [j], bo)
    if layout == "head":
        head = j[:len(j) - len(body) - 2]
        tags[513], tags[514] = (4, [0]), (4, [len(head)])
        tags[513] = (4, [len(tiff_bytes(w, h, tags, strips, bo))])
        return tiff_bytes(w, h, tags, strips, bo) + head
    tags[512] = (3, [proc or 1])
    if restart:
        tags[515] = (3, [restart])
    if not gray:
        tags[530] = (3, [comps[0][1] >> 4, comps[0][1] & 15])
    blob, at = b"", {}
    for key in sorted(tables, key=str):
        at[key] = len(blob)
        blob += tables[key] + b"\0" * (len(tables[key]) & 1)
    for tag in (519, 520, 521):
        tags[tag] = (4, [0] * n)
    base = len(tiff_bytes(w, h, tags, strips, bo))
    for tag, kind, k in ((519, "q", 2), (520, "dc", 3), (521, "ac", 4)):
        tags[tag] = (4, [base + at[(kind, c[k])] for c in comps])
    return tiff_bytes(w, h, tags, strips, bo) + blob


def _ojpeg_image(h: int, w: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    ramp = np.stack([xx * 5 + yy, yy * 4 + 40, (xx + yy) * 3], -1)
    return (ramp + rng.integers(-12, 12, (h, w, 3))).clip(0, 255).astype(np.uint8)


def _ojpeg_corners() -> dict[str, bytes]:
    """Both of libtiff's layouts (the interchange stream, whole or its
    header alone, and the table tags) at gray, 4:4:4, 4:2:2 and 4:2:0, a
    restart interval over several strips, big-endian."""
    img, tall = _ojpeg_image(37, 45, 70), _ojpeg_image(64, 48, 71)
    out = {}
    for layout in ("whole", "head", "tables"):
        out[f"ojpeg_{layout}_gray.tif"] = ojpeg_tiff(img[..., 1], layout)
        for sub in ("4:4:4", "4:2:2", "4:2:0"):
            out[f"ojpeg_{layout}_{sub.replace(':', '')}.tif"] = ojpeg_tiff(img, layout, sub)
    for layout in ("head", "tables"):
        out[f"ojpeg_{layout}_420_restart_4_strips.tif"] = ojpeg_tiff(tall, layout, "4:2:0", strip_rows=16)
        out[f"ojpeg_{layout}_444_restart_8_strips.tif"] = ojpeg_tiff(tall, layout, "4:4:4", strip_rows=8)
    out["ojpeg_tables_422_big_endian.tif"] = ojpeg_tiff(img, "tables", "4:2:2", bo=">")
    out["ojpeg_tables_proc14.tif"] = ojpeg_tiff(img, "tables", proc=14)  # libtiff writes a baseline frame anyway
    return out


def _with_strip_words(data: bytes, tag: int, values: dict[int, int]) -> bytes:
    """A little-endian TIFF with entries of its strip offset (273) or
    count (279) array replaced: {strip: value}."""
    ifd = struct.unpack("<I", data[4:8])[0]
    m = bytearray(data)
    for k in range(struct.unpack("<H", data[ifd:ifd + 2])[0]):
        t, _, n, at = struct.unpack("<HHII", data[ifd + 2 + 12 * k:ifd + 14 + 12 * k])
        if t == tag:
            for i, v in values.items():
                struct.pack_into("<I", m, at + 4 * i if n > 1 else ifd + 10 + 12 * k, v)
    return bytes(m)


# old-style JPEG-in-TIFF whose strips libtiff reads short or long: a count of
# 0 or past the file reads to the file's end (here through the other strips
# and, in the "head" layout, the interchange header put after them); offsets
# of 0 or past the file skip a strip
OJPEG_STRIPS = [
    ("head_420_restart_4_strips", 279, {0: 0}), ("head_420_restart_4_strips", 279, {1: 1 << 20}),
    ("head_420_restart_4_strips", 279, {2: 0xFFFFFFFF}), ("head_444_restart_8_strips", 279, {6: 0}),
    ("tables_420_restart_4_strips", 273, {1: 0, 3: 0}), ("tables_444_restart_8_strips", 273, {2: 0, 5: 1 << 30}),
]


@pytest.mark.parametrize("name,tag,values", OJPEG_STRIPS)
def test_ojpeg_strips_libtiff_reads_short_or_long_agree_with_pillow(goldens, name, tag, values):
    """tif_ojpeg.c's source fails libjpeg's resync (a restart marker out of
    place) and fails when its strips run dry; TIFFRGBAImageGet, which
    Pillow calls a strip at a time, keeps the failed strip's rows but the
    next strip's read then fails too: Pillow decodes only where the failure
    falls in the last strip, with that strip's undecoded rows zero."""
    data = _with_strip_words(goldens[f"ojpeg_{name}.tif"].tobytes(), tag, values)
    want = _pillow_or_none(data)
    if want is None:
        with pytest.raises(ValueError, match="old-style JPEG strip"):
            _port(data)
    else:
        np.testing.assert_array_equal(_port(data), want[1])


def _with_entry_type(data: bytes, tag: int, typ: int) -> bytes:
    """A classic TIFF with the type of its first IFD's entry ``tag``
    replaced."""
    bo = "<" if data[:2] == b"II" else ">"
    ifd = struct.unpack(bo + "I", data[4:8])[0]
    m = bytearray(data)
    for k in range(struct.unpack(bo + "H", data[ifd:ifd + 2])[0]):
        if struct.unpack(bo + "H", data[ifd + 2 + 12 * k:ifd + 4 + 12 * k])[0] == tag:
            struct.pack_into(bo + "H", m, ifd + 4 + 12 * k, typ)
    return bytes(m)


# damaged entry types: Pillow loads BYTE and UNDEFINED as bytes and ASCII as
# a str, which its _setup cannot take as a size, sample layout, compression,
# photometric or (reading the strips itself) rows per strip or strip
# offsets; libtiff's integer readers refuse ASCII, rationals, UNDEFINED,
# floats and IFD offsets (and in a classic TIFF the 8-byte types), dropping
# an optional tag (predictor, planar, photometric, restart interval, the
# old-style JPEG's offsets and tables) and failing on a required one
ENTRY_TYPES = [("tiff_p3_lzw.tif", 256, 1), ("tiff_p3_lzw.tif", 259, 2), ("tiff_p3_lzw.tif", 277, 13),
               ("tiff_lab_raw.tif", 262, 7), ("tiff_lab_raw.tif", 278, 1), ("tiff_lab_raw.tif", 339, 2),
               ("jit_arith_420_ycbcr.tif", 278, 13), ("ojpeg_tables_420_restart_4_strips.tif", 262, 2),
               ("tiff_p3_lzw.tif", 273, 9), ("tiff_p3_lzw.tif", 317, 11), ("tiff_p3_deflate_be.tif", 317, 4),
               ("tiff_lab_raw.tif", 284, 5), ("tiff_lab_raw.tif", 273, 2), ("jit_arith_420_ycbcr.tif", 530, 1),
               ("ojpeg_tables_420_restart_4_strips.tif", 515, 5), ("ojpeg_tables_420_restart_4_strips.tif", 530, 2),
               ("ojpeg_tables_420_restart_4_strips.tif", 519, 13), ("ojpeg_tables_gray.tif", 262, 11),
               ("ojpeg_head_420.tif", 514, 11), ("tiff_p3_lzw.tif", 277, 17)]


@pytest.mark.parametrize("name,tag,typ", ENTRY_TYPES)
def test_damaged_entry_types_agree_with_pillow(goldens, name, tag, typ):
    """An IFD entry whose type is damaged: the port decodes equal to
    Pillow, or both refuse."""
    data = _with_entry_type(goldens[name].tobytes(), tag, typ)
    want = _pillow_or_none(data)
    if want is None:
        with pytest.raises(ValueError):
            _port(data)
    else:
        np.testing.assert_array_equal(_port(data), want[1])


# the entry-type damage a sweep of every tag × type over the JPEG-in-TIFF
# goldens found the port reading otherwise than libtiff: a dropped
# YCbCrSubsampling whose (2, 2) default does not divide the strips of a
# 4:4:4 old-style file (OJPEGReadHeaderInfo fails), a StripByteCounts of
# BYTE/SBYTE that reads 0 (ByteCountLooksBad: EstimateStripByteCounts runs
# the one strip to the file's end), JPEGQTables of SBYTE that read negative
# (libtiff drops the tag), a LONG8 SamplesPerPixel in a classic TIFF
# (Pillow's MAX_SAMPLESPERPIXEL)
TIFF_RESIDUALS = [("ojpeg_tables_444_restart_8_strips.tif", 530, 2), ("ojpeg_tables_444_restart_8_strips.tif", 530, 4),
                  ("ojpeg_tables_444_restart_8_strips.tif", 530, 11), ("jit_arith_444_rgb.tif", 279, 1),
                  ("jit_arith_444_rgb.tif", 279, 6), ("ojpeg_tables_420.tif", 519, 6),
                  ("ojpeg_tables_proc14.tif", 519, 6), ("ojpeg_tables_gray.tif", 277, 16)]


@pytest.mark.parametrize("name,tag,typ", TIFF_RESIDUALS)
def test_queue3_tiff_entry_types_agree_with_pillow(goldens, name, tag, typ):
    """Damaged entry types libtiff reads apart from Pillow: the port decodes
    equal to Pillow, or both refuse (a ValueError, not a MemoryError)."""
    data = _with_entry_type(goldens[name].tobytes(), tag, typ)
    want = _pillow_or_none(data)
    if want is None:
        with pytest.raises(ValueError):
            _port(data)
    else:
        np.testing.assert_array_equal(_port(data), want[1])


# Queue 3's cut JPEG-in-TIFF faults: a StripByteCounts of BYTE reads a
# short count, and libtiff's JPEG source feeds libjpeg a fake EOI past the
# cut (libjpeg decodes on with zero bits, or zero data in an arithmetic
# scan); a PhotometricInterpretation of type IFD, which libtiff drops (its
# JPEG codec then leaves the components as stored) where Pillow reads 6
CUT_JPEG_IN_TIFF = [("jit_arith_cmyk.tif", 279, 1), ("jit_arith_prog_411_ycbcr.tif", 279, 1),
                    ("jit_arith_prog_422_restart_ycbcr.tif", 279, 1), ("jit_arith_rgb_ids_ycbcr.tif", 279, 1),
                    ("jit_lossless_cmyk.tif", 279, 1), ("jit_lossless_p7_restart_rgb.tif", 279, 1),
                    ("jit_arith_rgb_ids_ycbcr.tif", 262, 13)]


@pytest.mark.parametrize("name,tag,typ", CUT_JPEG_IN_TIFF)
def test_cut_jpeg_in_tiff_strips_decode_as_pillow(goldens, name, tag, typ):
    """Each decodes in Pillow, with every row, and the port's decode is
    equal."""
    data = _with_entry_type(goldens[name].tobytes(), tag, typ)
    want = _pillow(data)[1]
    assert want.shape == goldens[f"{name}.pil"].shape
    np.testing.assert_array_equal(_port(data), want)


@pytest.mark.parametrize("sample_format,comp,predictor", [(3, 8, 1), (3, 32773, 1), (2, 5, 2), (2, 8, 1)])
def test_big_endian_32bit_compressed_samples_as_pillow_reads_them(sample_format, comp, predictor):
    """A big-endian TIFF of 32-bit samples that libtiff decompresses: libtiff
    hands them over in native order and Pillow's raw mode (F;32BF, I;32BS)
    reads them big-endian, so Pillow shows them byte-swapped; the port
    equals it (and a damaged predictor entry that libtiff drops lands
    here too)."""
    rng = np.random.default_rng(sample_format + comp)
    px = _float_px(4) if sample_format == 3 else rng.integers(-2 ** 31, 2 ** 31, (H, W)).astype(np.int32)
    if predictor == 2:
        px = np.diff(px.astype(np.int64), axis=1, prepend=0).astype(px.dtype)
    raw = px.astype(">" + px.dtype.str[1:]).tobytes()
    body = zlib.compress(raw) if comp == 8 else tiff_lzw(raw) if comp == 5 else b"".join(
        bytes([len(raw[k:k + 128]) - 1]) + raw[k:k + 128] for k in range(0, len(raw), 128))
    tags = {258: (3, [32]), 259: (3, [comp]), 262: (3, [1]), 277: (3, [1]), 339: (3, [sample_format]),
            278: (3, [H]), 317: (3, [predictor])}
    data = tiff_bytes(W, H, tags, [body], ">")
    np.testing.assert_array_equal(_port(data), _pillow(data)[1])


def _ojpeg_refused() -> dict[str, tuple[bytes, str]]:
    img = _ojpeg_image(37, 45, 72)
    tables = ojpeg_tiff(img, "tables")
    no_qtables = tables.replace(struct.pack("<HHI", 519, 4, 3), struct.pack("<HHI", 65000, 4, 3))
    head = ojpeg_tiff(img, "head")
    return {
        "ojpeg_interchange_cut": (head[:-200], "old-style JPEG"),
        "ojpeg_strips_cut": (ojpeg_tiff(img, "tables")[:700], "TIFF"),
        "ojpeg_without_qtables": (no_qtables, "tag 519"),
    }


# ---------------------------------------------------------------------------
# Kodak PhotoCD
# ---------------------------------------------------------------------------


def pcd_bytes(orientation: int, seed: int, rows: int = 256) -> bytes:
    """A PhotoCD file: the ``PCD_IPI`` sector with its orientation byte, and
    the 768 × 512 base image at sector 96 in ``rows`` row pairs (two luma
    rows, then the two half-width chroma rows) of synthetic YCC whose ramps
    take every value of each plane, both clips of the PhotoYCC → RGB sums
    reached."""
    yy, xx = np.mgrid[0:512, 0:768]
    cy, cx = yy[::2, ::2], xx[::2, ::2]
    luma = ((xx // 3 + yy // 2 + seed) & 255).astype(np.uint8)
    c1 = ((cy // 2 + seed) & 255).astype(np.uint8)
    c2 = ((cx // 3 * 2 + cy // 2) & 255).astype(np.uint8)
    pairs = np.concatenate([luma.reshape(256, 2 * 768), c1, c2], axis=1)[:rows]
    sector = bytearray(2048)
    sector[:7] = b"PCD_IPI"
    sector[1538] = orientation | 0x10  # the orientation's bits beside others
    return bytes(2048) + bytes(sector) + bytes(94 * 2048) + pairs.tobytes()


def _pcd_corners() -> dict[str, bytes]:
    return {f"pcd_orientation{k}.pcd": pcd_bytes(k, 60 + k) for k in range(4)}


def _pcd_refused() -> dict[str, tuple[bytes, str]]:
    return {"pcd_truncated": (pcd_bytes(1, 64, rows=255), "PCD")}


# ---------------------------------------------------------------------------
# The goldens
# ---------------------------------------------------------------------------


def golden_files() -> dict[str, bytes]:
    """Every golden file, by name."""
    out = {}
    for part in (_tiff_corners(), _lab_corners(), _iptc_corners(), _fli_corners(), _jpeg_tiff_corners(), _smoothed_corners(),
                 _sof2_recorded(), _pcd_corners(), _ojpeg_corners()):
        out.update(part)
    return out


def refused_files() -> dict[str, tuple[bytes, str]]:
    """Variants Pillow refuses too, and the words the port's error holds."""
    out = {}
    for part in (_tiff_refused(), _lab_refused(), _iptc_refused(), _fli_refused(), _jpeg_tiff_refused(), _pcd_refused(),
                 _ojpeg_refused()):
        out.update(part)
    return out


def write_goldens(path: Path = GOLDENS) -> int:
    """Each golden file with Pillow's decode and format, and each refused
    file (``refused_<case>``) with the words of the port's error
    (``.refused``), which chip_smoke.py reads where Pillow is absent."""
    files = golden_files()
    arrays = {}
    for name, data in sorted(files.items()):
        fmt, rgb = _pillow(data)
        arrays[name] = np.frombuffer(data, np.uint8)
        arrays[f"{name}.pil"] = rgb
        arrays[f"{name}.format"] = np.frombuffer(fmt.encode(), np.uint8)
    for case, (data, words) in sorted(refused_files().items()):
        arrays[f"refused_{case}"] = np.frombuffer(data, np.uint8)
        arrays[f"refused_{case}.refused"] = np.frombuffer(words.encode(), np.uint8)
    np.savez_compressed(path, **arrays)
    return len(files)


def _golden_names(recorded: bool = False) -> list[str]:
    """The goldens held equal to Pillow, or (``recorded``) those whose
    difference is recorded."""
    if not GOLDENS.exists():  # before the first ``python -m tests.test_torch_codec_corners``
        return []
    with np.load(GOLDENS) as z:
        return sorted(f for f in z.files if not f.endswith((".pil", ".format", ".refused"))
                      and not f.startswith("refused_") and f.startswith("record_") == recorded)


@pytest.fixture(scope="module")
def goldens():
    with np.load(GOLDENS) as z:
        return {f: z[f] for f in z.files}


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------


def test_goldens_are_small_and_regenerate_bit_for_bit():
    """The committed file is under 1.5 MB and holds what the writers above
    and Pillow 12.1 give now."""
    assert GOLDENS.stat().st_size < 1536 << 10
    fresh = golden_files()
    with np.load(GOLDENS) as z:
        assert sorted(fresh) == sorted(_golden_names() + _golden_names(recorded=True))
        for name, data in fresh.items():
            assert z[name].tobytes() == data, name
            fmt, rgb = _pillow(data)
            np.testing.assert_array_equal(rgb, z[f"{name}.pil"], err_msg=name)
            assert fmt == z[f"{name}.format"].tobytes().decode(), name
        for case, (data, words) in refused_files().items():
            assert z[f"refused_{case}"].tobytes() == data and z[f"refused_{case}.refused"].tobytes() == words.encode()


@pytest.mark.parametrize("name", _golden_names())
def test_golden_decodes_and_sniffs_as_pillow(goldens, name):
    """Every golden: the port's decode on the CPU route equals Pillow's, bit
    for bit, and sniff names Pillow's format."""
    from mmtrs_tpu_torch.utils.codec import sniff

    data = goldens[name].tobytes()
    assert sniff(data) == goldens[f"{name}.format"].tobytes().decode()
    np.testing.assert_array_equal(_port(data), goldens[f"{name}.pil"])


@pytest.mark.parametrize("name", _golden_names(recorded=True))
def test_sof2_progressions_on_the_cpu_route_equal_pillow(goldens, name):
    """Huffman progressive frames with the smoothed progressions: routed to
    the port's own decoder from their scan headers, and equal to Pillow's
    libjpeg-turbo 3.1.3 bit for bit."""
    from mmtrs_tpu_torch.utils.codec import jpeg_goes_own

    data = goldens[name].tobytes()
    assert jpeg_goes_own(data)
    np.testing.assert_array_equal(_port(data), goldens[f"{name}.pil"])


def test_sof2_route_is_read_from_the_scan_headers():
    """A whole progression (every coefficient refined to its last bit) and
    baseline frames stay with libjpeg and nvJPEG; a progression cut short,
    a smoothed one with restarts, a gray one and one whose AC bands stop at
    coefficient 5 go to the own decoder and equal Pillow."""
    from mmtrs_tpu_torch.utils.codec import jpeg_goes_own

    src = _sof2_progressive()
    assert not jpeg_goes_own(src)
    assert not jpeg_goes_own(_save(Image.fromarray(np.zeros((16, 16, 3), np.uint8)), "JPEG"))
    img = np.asarray(Image.open(io.BytesIO(src)))
    cases = [drop_scans(src, {0, 1, 2, 3, 4, 5, 6, 7, 8}),
             drop_scans(_save(Image.fromarray(img), "JPEG", progressive=True, restart_marker_blocks=2), {0, 1, 2}),
             drop_scans(_save(Image.fromarray(img[..., 0]), "JPEG", progressive=True), {0, 1})]
    for data in cases:
        assert jpeg_goes_own(data)
        np.testing.assert_array_equal(_port(data), _pillow(data)[1])


@pytest.mark.parametrize("case", sorted(refused_files()))
def test_pillow_refuses_and_the_port_names_the_variant(case):
    data, words = refused_files()[case]
    assert _pillow_or_none(data) is None
    with pytest.raises(ValueError, match=words):
        _port(data)


def test_lab_to_rgb_equals_pillow_on_every_triple():
    """``convert_rgb`` of mode LAB on all 2^24 (L, a, b) triples equals
    Pillow's ``convert("RGB")`` (its LittleCMS transform), bit for bit."""
    from mmtrs_tpu_torch.utils.codec import convert_rgb

    v = np.arange(1 << 24, dtype=np.uint32)
    lab = np.stack([v >> 16, (v >> 8) & 255, v & 255], -1).astype(np.uint8).reshape(4096, 4096, 3)
    want = np.asarray(Image.frombytes("LAB", (4096, 4096), (lab ^ np.array([0, 128, 128], np.uint8)).tobytes())
                      .convert("RGB"))
    np.testing.assert_array_equal(convert_rgb(lab, "LAB"), want)


def _mutations(data: bytes, seed: int, n: int = 24) -> list[bytes]:
    """Cuts at 6 places and ``n`` files with 1-3 bytes changed anywhere."""
    rng = np.random.default_rng(seed)
    out = [data[:int(c)] for c in np.linspace(1, len(data) - 1, 6)]
    for _ in range(n):
        m = bytearray(data)
        for i in rng.integers(0, len(m), rng.integers(1, 4)):
            m[int(i)] = int(rng.integers(0, 256))
        out.append(bytes(m))
    return out


MUTATED = ["tiff_p3", "bigtiff", "tiff_lab", "psd_lab", "iptc_", "fli_", "jit_", "smooth_", "record_sof2", "ojpeg_"]


@pytest.mark.parametrize("family", MUTATED)
def test_mutated_files_agree_with_pillow(goldens, family):
    """Cut and mutated goldens of each family: where Pillow decodes, the
    port's decode is equal; where Pillow raises, the port raises a
    ValueError. A TIFF whose damaged IFD Pillow and libtiff read apart is
    held to Pillow too."""
    names = [n for n in _golden_names() + _golden_names(recorded=True) if n.startswith(family)]
    bad = []
    for i, n in enumerate(names[:4]):
        for data in _mutations(goldens[n].tobytes(), i):
            want = _pillow_or_none(data)
            try:
                got = _port(data)
            except ValueError:
                got = None
            if want is None and got is not None:
                bad.append(("port decodes, Pillow raises", n, data))
            elif want is not None and (got is None or got.shape != want[1].shape or not np.array_equal(got, want[1])):
                bad.append(("differs" if got is not None else "port raises, Pillow decodes", n, data))
    assert bad == [], [b[:2] for b in bad[:3]]


if __name__ == "__main__":
    print(f"wrote {write_goldens()} goldens to {GOLDENS}")
