"""The codec's host formats and four-component JPEGs held against Pillow on
the CPU: every variant decodes to ``np.asarray(Image.open(f).convert("RGB"))``
exactly, on files Pillow writes or that are built here byte by byte
(interlaced and 16-bit PNG, OS/2, bit-field and RLE BMP, GIF frames with
local tables, offsets and interlaced rows, tiled, planar, predicted and
big-endian TIFF, YCCK JPEG through a small libjpeg program); every refused
variant raises a ValueError that names it.

``host_goldens()`` gives the small files that ``python -m
tests.test_torch_codec`` commits beside the JPEG goldens, which
``chip_smoke.py`` decodes on the card.
"""

import io
import struct
import subprocess
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image


def _pil(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def _img(h, w, c=3, seed=0, hi=256) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, hi, (h, w, c) if c else (h, w)).astype(np.uint8)


def _save(a, fmt, mode=None, **kw) -> bytes:
    b = io.BytesIO()
    im = Image.fromarray(a)
    (im.convert(mode) if mode else im).save(b, fmt, **kw)
    return b.getvalue()


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _filtered(rows: np.ndarray, bpp: int) -> bytes:
    """Rows of packed bytes, each filtered with type y % 5 (every type, the
    first row of each pass with Up/Average/Paeth's missing row above)."""
    out = []
    prev = np.zeros(rows.shape[1], np.int64)
    for y, r in enumerate(rows.astype(np.int64)):
        t = y % 5
        left = np.concatenate([np.zeros(bpp, np.int64), r[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        pred = [0, left, prev, (left + prev) // 2, _paeth(left, prev, upleft)][t]
        out.append(bytes([t]) + ((r - pred) % 256).astype(np.uint8).tobytes())
        prev = r
    return b"".join(out)


def _pack(samples: np.ndarray, depth: int) -> np.ndarray:
    """[h, w·c] samples → packed rows (big-endian for 16 bits)."""
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(samples.shape[0], -1)
    if depth == 8:
        return samples.astype(np.uint8)
    bits = ((samples[..., None] >> np.arange(depth - 1, -1, -1)) & 1).astype(np.uint8)
    return np.packbits(bits.reshape(samples.shape[0], -1), axis=1)


_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def png_bytes(px: np.ndarray, ctype: int, depth: int, interlace: bool, palette=None, trns=None) -> bytes:
    """px [h, w, channels] samples → a PNG, every filter type used."""
    h, w, c = px.shape
    bpp = max(1, c * depth // 8)
    if interlace:
        raw = b"".join(_filtered(_pack(px[y0::dy, x0::dx].reshape(-(-(h - y0) // dy), -1), depth), bpp)
                       for x0, y0, dx, dy in _ADAM7 if x0 < w and y0 < h)
    else:
        raw = _filtered(_pack(px.reshape(h, -1), depth), bpp)
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, int(interlace)))
    if palette is not None:
        out += _chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    return out + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b"")


PNG_TYPES = [(0, d) for d in (1, 2, 4, 8, 16)] + [(3, d) for d in (1, 2, 4, 8)] + \
    [(2, 8), (2, 16), (4, 8), (4, 16), (6, 8), (6, 16)]


def _png_case(ctype, depth, interlace, shape=(13, 17)):
    h, w = shape
    c = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    seed = ctype * 100 + depth + 7 * interlace
    px = np.random.default_rng(seed).integers(0, 1 << depth, (h, w, c))
    if ctype == 0 and depth == 16:
        px[::3] %= 512  # 16-bit gray: values on both sides of Pillow's clip at 255
    palette = np.random.default_rng(seed + 1).integers(0, 256, (1 << depth, 3)) if ctype == 3 else None
    trns = bytes(range(0, 256, 37)) if ctype == 3 else (struct.pack(">H", int(px.flat[0])) if ctype == 0 else None)
    return png_bytes(px, ctype, depth, interlace, palette, trns)


@pytest.mark.parametrize("interlace", [False, True], ids=["plain", "adam7"])
@pytest.mark.parametrize("ctype,depth", PNG_TYPES, ids=[f"type{c}_{d}bit" for c, d in PNG_TYPES])
def test_png_every_type_depth_and_interlace(ctype, depth, interlace):
    from mmtrs_tpu_torch.utils.codec import decode_image

    data = _png_case(ctype, depth, interlace)
    np.testing.assert_array_equal(decode_image(data, "cpu").numpy(), _pil(data))


@pytest.mark.parametrize("shape", [(1, 1), (2, 3), (5, 1), (9, 9), (8, 16)])
def test_png_adam7_small_sizes_with_empty_passes(shape):
    from mmtrs_tpu_torch.utils.codec import decode_image

    for ctype, depth in ((2, 8), (0, 1), (6, 16)):
        data = _png_case(ctype, depth, True, shape)
        np.testing.assert_array_equal(decode_image(data, "cpu").numpy(), _pil(data), err_msg=f"{ctype}/{depth}")


# ---------------------------------------------------------------------------
# BMP
# ---------------------------------------------------------------------------


def bmp_bytes(w, h, bpp, pixels: bytes, palette: bytes = b"", comp=0, masks=None, os2=False, top_down=False,
              colors=0) -> bytes:
    if os2:
        info = struct.pack("<IHHHH", 12, w, h, 1, bpp)
    else:
        info = struct.pack("<IiiHHIIiiII", 40, w, -h if top_down else h, 1, bpp, comp, len(pixels), 2835, 2835,
                           colors, 0)
    extra = struct.pack("<III", *masks) if masks else b""
    offset = 14 + len(info) + len(extra) + len(palette)
    return b"BM" + struct.pack("<IHHI", offset + len(pixels), 0, 0, offset) + info + extra + palette + pixels


def _rows(packed: np.ndarray) -> bytes:
    """Rows → bottom-up, padded to 4 bytes."""
    stride = (packed.shape[1] + 3) // 4 * 4
    out = np.zeros((packed.shape[0], stride), np.uint8)
    out[:, : packed.shape[1]] = packed
    return out[::-1].tobytes()


def _bmp_indexed(bpp, os2=False, gray=False, colors=0):
    h, w = 11, 21
    n = colors or (1 << bpp)
    idx = np.random.default_rng(bpp).integers(0, n, (h, w))
    pal = np.repeat(np.arange(n)[:, None], 3, 1) if gray else np.random.default_rng(bpp + 9).integers(0, 256, (n, 3))
    if gray and n == 2:
        pal = np.array([[0, 0, 0], [255, 255, 255]])
    entry = 3 if os2 else 4
    palette = np.concatenate([pal, np.zeros((n, 1), int)], 1)[:, :entry] if not os2 else pal
    palette = palette[:, [2, 1, 0] + ([3] if entry == 4 else [])].astype(np.uint8).tobytes()
    return bmp_bytes(w, h, bpp, _rows(_pack(idx, bpp)), palette, os2=os2, colors=colors)


def _bmp_16(masks=None):
    h, w = 9, 13
    words = np.random.default_rng(16).integers(0, 1 << 16, (h, w)).astype("<u2")
    return bmp_bytes(w, h, 16, _rows(words.view(np.uint8)), comp=3 if masks else 0, masks=masks)


def _bmp_32(masks):
    h, w = 7, 10
    words = np.random.default_rng(32).integers(0, 1 << 32, (h, w), dtype=np.uint64).astype("<u4")
    return bmp_bytes(w, h, 32, _rows(words.view(np.uint8)), comp=3, masks=masks)


def _rle(rle4: bool) -> bytes:
    """Encoded runs, absolute runs (odd and even, word-aligned), ends of
    line, a delta and the end of the bitmap (Pillow refuses a bitmap that
    ends before its last row is full)."""
    n = 16 if rle4 else 256
    pal = np.random.default_rng(44).integers(0, 256, (n, 4)).astype(np.uint8)
    pal[:, 3] = 0
    w, h = 20, 6
    s = bytearray()
    s += bytes([5, 0x12 if rle4 else 7, 0, 4]) + (bytes([0x34, 0x56]) if rle4 else bytes([1, 2, 3, 4]))
    s += bytes([0, 0])  # end of line
    s += bytes([0, 3]) + (bytes([0x78, 0x9A]) if rle4 else bytes([9, 8, 7, 0]))  # odd absolute run, padded
    s += bytes([30, 0x21 if rle4 else 5])  # a run longer than the row
    s += bytes([0, 0, 0, 2, 3, 1, 2, 1])  # end of line, delta (+ the bytes Pillow reads after it)
    s += bytes([4, 0x4F if rle4 else 11, 0, 0, 2, 0xAB if rle4 else 200, 0, 0, 20, 0x5D if rle4 else 99, 0, 1])
    return bmp_bytes(w, h, 4 if rle4 else 8, bytes(s), pal.tobytes(), comp=2 if rle4 else 1)


BMP_CASES = {
    "os2_1bit": lambda: _bmp_indexed(1, os2=True),
    "os2_4bit": lambda: _bmp_indexed(4, os2=True),
    "os2_8bit": lambda: _bmp_indexed(8, os2=True),
    "os2_24bit": lambda: bmp_bytes(9, 5, 24, _rows(_img(5, 9).reshape(5, -1)), os2=True),
    "1bit": lambda: _bmp_indexed(1),
    "1bit_black_white": lambda: _bmp_indexed(1, gray=True),
    "4bit": lambda: _bmp_indexed(4),
    "8bit_gray": lambda: _bmp_indexed(8, gray=True),
    "4bit_9_colors": lambda: _bmp_indexed(4, colors=9),
    "16bit_555": lambda: _bmp_16(),
    "bitfields16_565": lambda: _bmp_16((0xF800, 0x7E0, 0x1F)),
    "bitfields16_555": lambda: _bmp_16((0x7C00, 0x3E0, 0x1F)),
    "bitfields32_bgrx": lambda: _bmp_32((0xFF0000, 0xFF00, 0xFF)),
    "bitfields32_xbgr": lambda: _bmp_32((0xFF000000, 0xFF0000, 0xFF00)),
    "bitfields32_bgxr": lambda: _bmp_32((0xFF000000, 0xFF00, 0xFF)),
    "rle8": lambda: _rle(False),
    "rle4": lambda: _rle(True),
    "pillow_1bit": lambda: _save(_img(10, 30), "BMP", "1"),
}


@pytest.mark.parametrize("case", sorted(BMP_CASES))
def test_bmp_variants_decode_as_pillow(case):
    from mmtrs_tpu_torch.utils.codec import decode_image

    data = BMP_CASES[case]()
    np.testing.assert_array_equal(decode_image(data, "cpu").numpy(), _pil(data))


def test_bmp_rle_delta_follows_pillow():
    """Pillow 12 reads a delta escape's (right, up) two bytes after the
    escape's own two: the port reads it so too (pinned here), where the
    BMP specification puts them right after the escape."""
    from mmtrs_tpu_torch.utils.codec import decode_image

    pal = bytes([0, 0, 0, 0, 255, 255, 255, 0]) + bytes(4 * 254)
    # two white, a delta (0, 2) whose (right 1, up 0) the specification
    # reads; Pillow skips those and takes (right 2, up 0) from the next pair
    body = bytes([2, 1, 0, 2, 1, 0, 2, 0, 2, 1])
    data = bmp_bytes(6, 1, 8, body, pal, comp=1)
    got = decode_image(data, "cpu").numpy()
    np.testing.assert_array_equal(got, _pil(data))
    assert got[0, :, 0].tolist() == [255, 255, 0, 0, 255, 255]


# ---------------------------------------------------------------------------
# GIF
# ---------------------------------------------------------------------------


def lzw_gif(indices: np.ndarray, min_bits: int) -> bytes:
    """GIF LZW: a clear code, the codes growing with the table, the end code,
    in 255-byte sub-blocks."""
    clear, end = 1 << min_bits, (1 << min_bits) + 1
    table = {bytes([i]): i for i in range(clear)}
    width, nxt, codes, cur = min_bits + 1, end + 1, [(clear, min_bits + 1)], b""
    for v in indices.reshape(-1).tolist():
        s = cur + bytes([v])
        if s in table:
            cur = s
            continue
        codes.append((table[cur], width))
        if nxt < 4096:
            table[s] = nxt
            nxt += 1
            if nxt > (1 << width) and width < 12:
                width += 1
        else:
            codes.append((clear, width))
            table = {bytes([i]): i for i in range(clear)}
            width, nxt = min_bits + 1, end + 1
        cur = bytes([v])
    codes += [(table[cur], width), (end, width)]
    acc = nbits = 0
    out = bytearray()
    for code, wd in codes:
        acc |= code << nbits
        nbits += wd
        while nbits >= 8:
            out.append(acc & 255)
            acc >>= 8
            nbits -= 8
    if nbits:
        out.append(acc)
    blocks = b"".join(bytes([len(out[i:i + 255])]) + bytes(out[i:i + 255]) for i in range(0, len(out), 255))
    return bytes([min_bits]) + blocks + b"\x00"


def gif_bytes(screen, box, idx, global_pal=None, local_pal=None, interlace=False, transparency=None) -> bytes:
    sw, sh = screen
    x0, y0, fw, fh = box
    bits = lambda pal: int(np.log2(len(pal))) - 1
    out = b"GIF89a" + struct.pack("<HHBBB", sw, sh, (0x80 | bits(global_pal)) if global_pal is not None else 0, 0, 0)
    if global_pal is not None:
        out += global_pal.astype(np.uint8).tobytes()
    if transparency is not None:
        out += b"\x21\xf9\x04" + struct.pack("<BHB", 1, 0, transparency) + b"\x00"
    flags = (0x80 | bits(local_pal)) if local_pal is not None else 0
    out += b"," + struct.pack("<HHHHB", x0, y0, fw, fh, flags | (0x40 if interlace else 0))
    if local_pal is not None:
        out += local_pal.astype(np.uint8).tobytes()
    rows = idx
    if interlace:
        rows = idx[np.concatenate([np.arange(s, fh, d) for s, d in ((0, 8), (4, 8), (2, 4), (1, 2))])]
    min_bits = max(2, int(np.ceil(np.log2(max(int(idx.max()) + 1, 2)))))
    return out + lzw_gif(rows, min_bits) + b";"


def _pal(n, seed):
    return np.random.default_rng(seed).integers(0, 256, (n, 3))


GIF_CASES = {
    "pillow_p": lambda: _save(_img(37, 53), "GIF", "P"),
    "pillow_p_table_full": lambda: _save(_img(150, 170, seed=3), "GIF", "P"),  # clear codes mid-stream
    "pillow_l": lambda: _save(_img(20, 31), "GIF", "L"),
    "pillow_transparency": lambda: _save(_img(20, 31), "GIF", "P", transparency=3),
    "global_table_growth": lambda: gif_bytes((64, 48), (0, 0, 64, 48), np.random.default_rng(1).integers(0, 256, (48, 64)),
                                             _pal(256, 2)),
    "local_table": lambda: gif_bytes((30, 20), (0, 0, 30, 20), np.random.default_rng(3).integers(0, 16, (20, 30)),
                                     _pal(4, 4), _pal(16, 5)),
    "interlaced": lambda: gif_bytes((19, 23), (0, 0, 19, 23), np.random.default_rng(6).integers(0, 8, (23, 19)),
                                    _pal(8, 7), interlace=True),
    "offset_frame": lambda: gif_bytes((40, 30), (7, 5, 20, 13), np.random.default_rng(8).integers(0, 32, (13, 20)),
                                      _pal(32, 9)),
    "offset_frame_transparent": lambda: gif_bytes((40, 30), (3, 9, 25, 11),
                                                  np.random.default_rng(10).integers(0, 32, (11, 25)), _pal(32, 11),
                                                  transparency=5),
    "no_table": lambda: gif_bytes((12, 10), (0, 0, 12, 10), np.random.default_rng(12).integers(0, 200, (10, 12))),
}


@pytest.mark.parametrize("case", sorted(GIF_CASES))
def test_gif_first_frame_decodes_as_pillow(case):
    from mmtrs_tpu_torch.utils.codec import decode_image, sniff

    data = GIF_CASES[case]()
    assert sniff(data) == "GIF"
    np.testing.assert_array_equal(decode_image(data, "cpu").numpy(), _pil(data))


# ---------------------------------------------------------------------------
# TIFF
# ---------------------------------------------------------------------------


def tiff_bytes(w, h, tags: dict, chunks: list[bytes], bo="<", tiled=None, big=False, offset_type=4) -> bytes:
    """A one-IFD TIFF: ``tags`` (tag → (type, values)), the strips or tiles
    after the IFD; their offset and count tags are filled in, of type
    ``offset_type``. ``big``: a BigTIFF (8-byte offsets, 20-byte entries)."""
    tags = dict(tags)
    tags[256], tags[257] = (4, [w]), (4, [h])
    off_tag, cnt_tag = (324, 325) if tiled else (273, 279)
    if tiled:
        tags[322], tags[323] = (3, [tiled[0]]), (3, [tiled[1]])
    tags[off_tag], tags[cnt_tag] = (offset_type, [0] * len(chunks)), (offset_type, [len(c) for c in chunks])
    fmt = {1: "B", 2: "B", 3: "H", 4: "I", 7: "B", 11: "f", 12: "d", 13: "I", 16: "Q", 17: "q", 18: "Q"}
    word, entry = (8, 20) if big else (4, 12)
    n = len(tags)
    head_len = 16 if big else 8
    ifd_end = head_len + (8 if big else 2) + entry * n + word
    extra, entries = b"", []
    at = ifd_end
    for tag in sorted(tags):
        typ, vals = tags[tag]
        b = struct.pack(f"{bo}{len(vals)}{fmt[typ]}", *vals)
        if len(b) > word:
            at += len(b) + (len(b) & 1)
    data_at = at
    offs = []
    for c in chunks:
        offs.append(data_at)
        data_at += len(c)
    tags[off_tag] = (offset_type, offs)
    at = ifd_end
    for tag in sorted(tags):
        typ, vals = tags[tag]
        b = struct.pack(f"{bo}{len(vals)}{fmt[typ]}", *vals)
        if len(b) <= word:
            entries.append(struct.pack(f"{bo}HH" + ("Q" if big else "I"), tag, typ, len(vals)) + b.ljust(word, b"\0"))
        else:
            entries.append(struct.pack(f"{bo}HH" + ("QQ" if big else "II"), tag, typ, len(vals), at))
            extra += b + b"\0" * (len(b) & 1)
            at += len(b) + (len(b) & 1)
    if big:
        head = (b"II+\0" if bo == "<" else b"MM\0+") + struct.pack(f"{bo}HHQ", 8, 0, 16)
        ifd = struct.pack(f"{bo}Q", n) + b"".join(entries) + struct.pack(f"{bo}Q", 0)
    else:
        head = (b"II*\0" if bo == "<" else b"MM\0*") + struct.pack(f"{bo}I", 8)
        ifd = struct.pack(f"{bo}H", n) + b"".join(entries) + struct.pack(f"{bo}I", 0)
    return head + ifd + extra + b"".join(chunks)


def _diff(px: np.ndarray) -> np.ndarray:
    """Horizontal differencing along W, per sample (predictor 2)."""
    out = px.astype(np.int64)
    out[:, 1:] -= px[:, :-1].astype(np.int64)
    return (out % 256).astype(np.uint8)


def _tiff_rgb(bo="<", tiled=None, planar=1, predictor=1, comp=1, extra=None, rows_per_strip=4, spp=3):
    h, w = 19, 23
    px = _img(h, w, spp, seed=spp * 10 + planar)
    if extra == 1:  # premultiplied alpha: colour at most alpha
        px[..., :3] = (px[..., :3].astype(int) * px[..., 3:4] // 255).astype(np.uint8)
    planes = [px[..., i:i + 1] for i in range(spp)] if planar == 2 else [px]
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
        for part in parts:
            raw = (_diff(part) if predictor == 2 else part).tobytes()
            chunks.append(zlib.compress(raw) if comp == 8 else raw)
    tags = {258: (3, [8] * spp), 259: (3, [comp]), 262: (3, [2]), 277: (3, [spp]), 284: (3, [planar]),
            317: (3, [predictor])}
    if not tiled:
        tags[278] = (3, [rows_per_strip])
    if extra is not None:
        tags[338] = (3, [extra])
    return tiff_bytes(w, h, tags, chunks, bo, tiled)


def _tiff_gray(depth, photometric, palette=False, bo="<"):
    h, w = 9, 14
    v = np.random.default_rng(depth * 3 + photometric).integers(0, 1 << depth, (h, w))
    tags = {258: (3, [depth]), 259: (3, [1]), 262: (3, [3 if palette else photometric]), 277: (3, [1]),
            278: (3, [h])}
    if palette:
        cmap = np.random.default_rng(5).integers(0, 65536, 3 << depth)
        tags[320] = (3, cmap.tolist())
    return tiff_bytes(w, h, tags, [_pack(v, depth).tobytes()], bo)


TIFF_CASES = {
    **{f"pillow_{m}_{c}": (lambda m=m, c=c: _save(_img(21, 26), "TIFF", m, compression=c, tiffinfo={278: 5}))
       for m in ("RGB", "RGBA", "L", "P", "1") for c in ("raw", "tiff_lzw", "tiff_adobe_deflate", "packbits")},
    "pillow_lzw_predictor": lambda: _save(_img(21, 26), "TIFF", "RGB", compression="tiff_lzw", tiffinfo={317: 2}),
    "pillow_lzw_table_full": lambda: _save(_img(90, 110, seed=4), "TIFF", "RGB", compression="tiff_lzw"),
    "pillow_deflate_predictor_gray": lambda: _save(_img(21, 26), "TIFF", "L", compression="tiff_adobe_deflate",
                                                   tiffinfo={317: 2}),
    "big_endian_strips": lambda: _tiff_rgb(">"),
    "big_endian_deflate_predictor": lambda: _tiff_rgb(">", predictor=2, comp=8),
    "tiled": lambda: _tiff_rgb(tiled=(16, 16)),
    "tiled_deflate_predictor": lambda: _tiff_rgb(tiled=(16, 16), predictor=2, comp=8),
    "planar2_strips": lambda: _tiff_rgb(planar=2),
    "planar2_tiled_deflate": lambda: _tiff_rgb(tiled=(16, 16), planar=2, comp=8),
    "rgba_unassociated": lambda: _tiff_rgb(extra=2, spp=4),
    "rgba_premultiplied": lambda: _tiff_rgb(extra=1, spp=4),
    "rgb_extra_sample": lambda: _tiff_rgb(extra=0, spp=4),
    "gray_white_is_zero_8bit": lambda: _tiff_gray(8, 0),
    "bilevel_white_is_zero": lambda: _tiff_gray(1, 0),
    "bilevel_black_is_zero_be": lambda: _tiff_gray(1, 1, bo=">"),
    "gray_4bit": lambda: _tiff_gray(4, 1),
    "palette_4bit": lambda: _tiff_gray(4, 1, palette=True),
    "palette_8bit_be": lambda: _tiff_gray(8, 1, palette=True, bo=">"),
}


@pytest.mark.parametrize("case", sorted(TIFF_CASES))
def test_tiff_decodes_as_pillow(case):
    from mmtrs_tpu_torch.utils.codec import decode_image, sniff

    data = TIFF_CASES[case]()
    assert sniff(data) == "TIFF"
    np.testing.assert_array_equal(decode_image(data, "cpu").numpy(), _pil(data))


# ---------------------------------------------------------------------------
# CMYK and YCCK JPEG
# ---------------------------------------------------------------------------


_JPEG_TOOL = r"""
// ycck_tool enc <rgb file> <h> <w> <out.jpg> <space: cmyk|ycck>: RGB bytes
// → C, M, Y = 255 − R, G, B and K = min, written as a CMYK or YCCK JPEG
// (libjpeg converts CMYK → YCCK itself); ycck_tool raw <in.jpg> <out>
// <space>: the decoded samples in libjpeg's CMYK or YCCK output.
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>
#include <jpeglib.h>
int main(int argc, char** argv) {
    if (!std::strcmp(argv[1], "enc")) {
        int h = std::atoi(argv[3]), w = std::atoi(argv[4]);
        std::vector<unsigned char> rgb(h * w * 3), cmyk(h * w * 4);
        FILE* f = std::fopen(argv[2], "rb"); std::fread(rgb.data(), 1, rgb.size(), f); std::fclose(f);
        for (int i = 0; i < h * w; ++i) {
            int c = 255 - rgb[3 * i], m = 255 - rgb[3 * i + 1], y = 255 - rgb[3 * i + 2];
            int k = c < m ? (c < y ? c : y) : (m < y ? m : y);
            cmyk[4 * i] = c - k / 2; cmyk[4 * i + 1] = m - k / 2; cmyk[4 * i + 2] = y - k / 2; cmyk[4 * i + 3] = k;
        }
        jpeg_compress_struct ci; jpeg_error_mgr err; ci.err = jpeg_std_error(&err); jpeg_create_compress(&ci);
        FILE* o = std::fopen(argv[5], "wb"); jpeg_stdio_dest(&ci, o);
        ci.image_width = w; ci.image_height = h; ci.input_components = 4; ci.in_color_space = JCS_CMYK;
        jpeg_set_defaults(&ci);
        jpeg_set_colorspace(&ci, std::strcmp(argv[6], "ycck") ? JCS_CMYK : JCS_YCCK);
        jpeg_set_quality(&ci, 90, TRUE); jpeg_start_compress(&ci, TRUE);
        while (ci.next_scanline < ci.image_height) { JSAMPROW r = &cmyk[ci.next_scanline * w * 4]; jpeg_write_scanlines(&ci, &r, 1); }
        jpeg_finish_compress(&ci); jpeg_destroy_compress(&ci); std::fclose(o);
        return 0;
    }
    jpeg_decompress_struct di; jpeg_error_mgr err; di.err = jpeg_std_error(&err); jpeg_create_decompress(&di);
    FILE* f = std::fopen(argv[2], "rb"); jpeg_stdio_src(&di, f); jpeg_read_header(&di, TRUE);
    di.out_color_space = std::strcmp(argv[4], "ycck") ? JCS_CMYK : JCS_YCCK;
    jpeg_start_decompress(&di);
    std::vector<unsigned char> out(di.output_height * di.output_width * 4);
    while (di.output_scanline < di.output_height) { JSAMPROW r = &out[di.output_scanline * di.output_width * 4]; jpeg_read_scanlines(&di, &r, 1); }
    jpeg_finish_decompress(&di); jpeg_destroy_decompress(&di); std::fclose(f);
    FILE* o = std::fopen(argv[3], "wb"); std::fwrite(out.data(), 1, out.size(), o); std::fclose(o);
    return 0;
}
"""


def jpeg_tool(workdir: Path) -> Path:
    """The small libjpeg program above, built with g++ in ``workdir``."""
    src, exe = workdir / "ycck_tool.cpp", workdir / "ycck_tool"
    if not exe.exists():
        src.write_text(_JPEG_TOOL)
        subprocess.run(["g++", "-O2", str(src), "-o", str(exe), "-ljpeg"], check=True, capture_output=True)
    return exe


def four_component_jpeg(workdir: Path, rgb: np.ndarray, space: str) -> bytes:
    h, w, _ = rgb.shape
    (workdir / "in.rgb").write_bytes(np.ascontiguousarray(rgb).tobytes())
    out = workdir / f"out_{space}.jpg"
    subprocess.run([str(jpeg_tool(workdir)), "enc", str(workdir / "in.rgb"), str(h), str(w), str(out), space],
                   check=True)
    return out.read_bytes()


def _strip_app14(data: bytes) -> bytes:
    i = data.find(b"\xff\xee")
    n = struct.unpack(">H", data[i + 2:i + 4])[0]
    return data[:i] + data[i + 2 + n:]


@pytest.fixture(scope="module")
def four_component(tmp_path_factory):
    from mmtrs_tpu_torch.synth import synth_teeth

    d = tmp_path_factory.mktemp("jpeg4")
    teeth = synth_teeth(1, (61, 83), seed=77)[0]
    cmyk_pil = _save(teeth, "JPEG", "CMYK", quality=90)
    return d, {
        "pillow_cmyk": cmyk_pil,
        "pillow_cmyk_no_adobe": _strip_app14(cmyk_pil),
        "cmyk": four_component_jpeg(d, teeth, "cmyk"),
        "ycck": four_component_jpeg(d, teeth, "ycck"),
    }


@pytest.mark.parametrize("case", ["pillow_cmyk", "pillow_cmyk_no_adobe", "cmyk", "ycck"])
def test_four_component_jpeg_decodes_as_pillow(four_component, case):
    """libjpeg's CMYK (YCCK converted by libjpeg), Pillow's inversion and
    cmyk2rgb, and decode_paths' threads the same."""
    from mmtrs_tpu_torch.utils.codec import adobe_transform, decode_image, decode_paths

    d, files = four_component
    data = files[case]
    assert adobe_transform(data) == {"pillow_cmyk": 0, "pillow_cmyk_no_adobe": None, "cmyk": 0, "ycck": 2}[case]
    want = _pil(data)
    np.testing.assert_array_equal(decode_image(data, "cpu").numpy(), want)
    (d / f"{case}.jpg").write_bytes(data)
    got, status = decode_paths([d / f"{case}.jpg"])
    assert status.tolist() == [0]
    np.testing.assert_array_equal(got[0].numpy(), want)


@pytest.mark.parametrize("case", ["cmyk", "ycck"])
def test_card_cmyk_arithmetic_equals_pillow_on_libjpeg_planes(four_component, case):
    """The card's route after nvJPEG, on the CPU: libjpeg's raw CMYK or
    YCCK samples (the planes as stored, upsampled by libjpeg) through
    cmyk_to_rgb give Pillow's decode exactly."""
    from mmtrs_tpu_torch.utils.codec import cmyk_to_rgb

    d, files = four_component
    src, out = d / f"raw_{case}.jpg", d / f"raw_{case}.bin"
    src.write_bytes(files[case])
    subprocess.run([str(jpeg_tool(d)), "raw", str(src), str(out), case], check=True)
    want = _pil(files[case])
    planes = torch.from_numpy(np.fromfile(out, np.uint8).reshape(*want.shape[:2], 4))
    np.testing.assert_array_equal(cmyk_to_rgb(planes, ycck=case == "ycck").numpy(), want)


# ---------------------------------------------------------------------------
# Refusals
# ---------------------------------------------------------------------------


def _refused() -> dict[str, tuple[bytes, str | None]]:
    """Each variant the codec once refused and the words its error must
    hold, or None for the variants it now decodes (Pillow opens all but
    BI_JPEG and the corrupt WebPs, which it refuses too)."""
    from tests.test_torch_codec_webp import _corrupt

    a = _img(16, 16)
    webp = _corrupt()
    return {
        "tiff_jpeg": (_save(a, "TIFF", compression="jpeg"), None),
        "tiff_ccitt_g4": (_save(a, "TIFF", "1", compression="group4"), None),
        "tiff_16bit": (_save(np.arange(256, dtype=np.uint16).reshape(16, 16) * 200, "TIFF"), None),
        "tiff_float": (_save(np.linspace(0, 1, 256, dtype=np.float32).reshape(16, 16), "TIFF"), None),
        "tiff_cmyk": (_save(a, "TIFF", "CMYK"), None),
        "bmp_jpeg": (bmp_bytes(2, 2, 24, bytes(16), comp=4), "BI_JPEG"),
        "tiff_ccitt_g3": (_save(a, "TIFF", "1", compression="group3"), None),
        "webp": (webp["inter_frame"], "WebP.*inter frame"),
        "webp_bad_riff_size": (webp["bad_riff_size"], "truncated WebP"),
        "avif": (_save(a, "AVIF"), None),
        "jpeg2000": (_save(a, "JPEG2000"), None),
        "ppm": (_save(a, "PPM"), None),
        "ico": (_save(a, "ICO"), None),
    }


@pytest.mark.parametrize("case", ["tiff_jpeg", "tiff_ccitt_g4", "tiff_16bit", "tiff_float", "tiff_cmyk", "bmp_jpeg",
                                  "tiff_ccitt_g3", "webp", "webp_bad_riff_size", "avif", "jpeg2000", "ppm", "ico"])
def test_refused_variants_name_themselves(case):
    """A variant or format Pillow reads and the codec does not raises with
    its name; a corrupt WebP (an inter frame, a RIFF size past the file's
    end), which Pillow refuses too, raises naming WebP. The variants the
    codec has learned to read since (JPEG-in-TIFF, CCITT, 16-bit, float and
    CMYK TIFF, PPM, ICO, JPEG 2000, AVIF) decode as Pillow decodes them."""
    from mmtrs_tpu_torch.utils.codec import decode_image

    data, msg = _refused()[case]
    if case == "bmp_jpeg" or case.startswith("webp"):
        with pytest.raises(Exception):  # noqa: B017  (Pillow's own error types)
            _pil(data)
    else:
        want = _pil(data)  # Pillow reads it
    if msg is None:
        np.testing.assert_array_equal(decode_image(data, "cpu").numpy(), want)
        return
    with pytest.raises(ValueError, match=msg):
        decode_image(data, "cpu")


def _bombs() -> dict[str, tuple[bytes, bool]]:
    """Files of a few hundred bytes whose headers ask for more pixels than
    Pillow's DecompressionBombError limit, and whether Pillow's open refuses
    them too (a TIFF's tile grid is not its image size)."""
    big = 60_000  # 3.6e9 pixels
    pal = np.random.default_rng(0).integers(0, 256, (256, 4)).astype(np.uint8).tobytes()
    return {
        "gif_canvas": (gif_bytes((big, big), (0, 0, 2, 2), np.zeros((2, 2), int), _pal(4, 1)), True),
        "gif_frame": (gif_bytes((16, 16), (100, 100, big, big), np.zeros((2, 2), int), _pal(4, 1)), True),
        "tiff_image": (tiff_bytes(big, big, {258: (3, [8]), 259: (3, [1]), 262: (3, [1]), 277: (3, [1]),
                                             278: (4, [big])}, [bytes(64)]), True),
        "tiff_tile_grid": (tiff_bytes(16, 16, {258: (3, [8]), 259: (3, [1]), 262: (3, [1]), 277: (3, [1])},
                                      [bytes(64)], tiled=(65520, 65520)), False),
        "bmp_rle8": (bmp_bytes(big, big, 8, bytes([0, 1]), pal, comp=1), True),
        "bmp_rle4": (bmp_bytes(big, big, 4, bytes([0, 1]), pal[:64], comp=2), True),
        "png": (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", big, big, 8, 2, 0, 0, 1))
                + _chunk(b"IDAT", zlib.compress(bytes(16))) + _chunk(b"IEND", b""), True),
    }


@pytest.mark.parametrize("case", ["gif_canvas", "gif_frame", "tiff_image", "tiff_tile_grid", "bmp_rle8", "bmp_rle4",
                                  "png"])
def test_oversized_headers_are_refused_before_allocating(case):
    """A header over Pillow's limit raises a ValueError naming the size,
    with no large allocation first (numpy's allocations are traced)."""
    import tracemalloc

    from mmtrs_tpu_torch.utils.codec import MAX_PIXELS, decode_image

    data, pillow_refuses = _bombs()[case]
    assert len(data) < 2048
    assert MAX_PIXELS == 2 * Image.MAX_IMAGE_PIXELS
    if pillow_refuses:
        with pytest.raises(Image.DecompressionBombError):
            Image.open(io.BytesIO(data))
    tracemalloc.start()
    try:
        with pytest.raises(ValueError, match=rf"exceeds the limit of {MAX_PIXELS} pixels"):
            decode_image(data, "cpu")
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    assert peak < 16 << 20, peak


# ---------------------------------------------------------------------------
# Goldens for the card (written by python -m tests.test_torch_codec)
# ---------------------------------------------------------------------------


def host_goldens(workdir: Path) -> dict[str, bytes]:
    """One small file of each host variant the codec gained, for the card's
    phase 9 (the four-component JPEGs are JPEG goldens,
    tests/test_torch_codec.py's ``teeth_cmyk`` and ``teeth_ycck``)."""
    return {
        "png_adam7_rgb8.png": _png_case(2, 8, True),
        "png_rgba16.png": _png_case(6, 16, False),
        "png_adam7_gray16.png": _png_case(0, 16, True),
        "bmp_os2_4bit.bmp": BMP_CASES["os2_4bit"](),
        "bmp_bitfields16.bmp": BMP_CASES["bitfields16_565"](),
        "bmp_rle4.bmp": BMP_CASES["rle4"](),
        "bmp_rle8.bmp": BMP_CASES["rle8"](),
        "gif_offset_interlaced.gif": gif_bytes((40, 30), (6, 4, 21, 17),
                                               np.random.default_rng(14).integers(0, 64, (17, 21)), _pal(64, 15),
                                               interlace=True, transparency=9),
        "gif_pillow.gif": GIF_CASES["pillow_p"](),
        "tiff_tiled_deflate_predictor.tif": TIFF_CASES["tiled_deflate_predictor"](),
        "tiff_planar2_be.tif": _tiff_rgb(">", planar=2),
        "tiff_lzw.tif": TIFF_CASES["pillow_RGB_tiff_lzw"](),
        "tiff_packbits_bilevel.tif": TIFF_CASES["pillow_1_packbits"](),
    }


def test_host_goldens_are_committed_and_equal_pillow(tmp_path):
    """The committed host goldens are Pillow's decode of their bytes and of
    a fresh build of the same files; the codec decodes them equal."""
    from mmtrs_tpu_torch.utils.codec import decode_image

    fresh = host_goldens(tmp_path)
    with np.load(Path(__file__).resolve().parents[1] / "mmtrs_tpu_torch" / "testdata" / "codec_goldens.npz") as z:
        for name, data in fresh.items():
            committed = z[f"host/{name}"].tobytes()
            want = z[f"host/{name}.pil"]
            np.testing.assert_array_equal(_pil(committed), want, err_msg=name)
            assert committed == data, name
            np.testing.assert_array_equal(decode_image(committed, "cpu").numpy(), want, err_msg=name)
