"""AVIF through the port's own AV1 decoder (``csrc/host/av1.cpp``) and its
copy of libavif's colour conversion (``utils/avif.py``), against Pillow 12.1
(libavif 1.3.0, dav1d 1.5.1, libyuv 1909):

- every golden decodes to Pillow's ``convert("RGB")`` bit for bit, and its
  Y, U and V planes equal libavif's (``tests/avif_oracle.py``);
- the goldens' tool masks cover every tool of AVIF's first slice;
- the conversion equals libavif's on every (Y, U, V) triple and on random
  4:2:0 and 4:2:2 planes of odd sizes, for each (matrix, range) it takes;
- each tool no slice decodes (superres, 10 bits, inter frames) is refused
  by name on a file that uses it (CDEF, loop restoration, palette, film
  grain, quantiser matrices and premultiplied alpha, once refused here, now
  decode equal to Pillow; ``tests/test_torch_codec_avif2.py`` and
  ``tests/test_torch_codec_avif3.py`` hold them);
- damaged image sequences (Queue 3's ``avis`` fault) decode from their
  track as Pillow's do, or both refuse;
- cut and mutated files agree with Pillow (both decode equal, or both
  refuse);
- ``scripts/make_av1_tables.py`` rewrites the committed table header.

The goldens (``mmtrs_tpu_torch/testdata/avif_goldens.npz``) are written by
``python -m tests.test_torch_codec_avif``: Pillow's ``save`` at its
defaults and with ``advanced=`` libaom options to reach each tool, and
grid, ``irot``, ``imir`` and ``clap`` files built around Pillow-written
items (``chip_smoke._avif_grid`` and ``_avif_file``, which the card's
machine uses without Pillow). Each golden holds Pillow's decode, which the
card's machine reads back.
"""

from __future__ import annotations

import functools
import io
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image, ImageDraw

import chip_smoke as cs
from tests import avif_oracle as ao

ROOT = Path(__file__).resolve().parents[1]
GOLDENS = ROOT / "mmtrs_tpu_torch" / "testdata" / "avif_goldens.npz"

# the tools mask of csrc/host/av1.cpp
TOOLS = {"dc": 0, "v_h": 1, "directional": 2, "smooth": 3, "paeth": 4, "cfl": 5, "filter_intra": 6,
         "angle_delta": 7, "edge_upsample": 8, "tx4": 9, "tx8": 10, "tx16": 11, "tx32": 12, "tx64": 13,
         "tx_rect": 14, "dct": 15, "adst": 16, "idtx": 17, "tx_1d": 18, "lossless": 19, "tiles": 20,
         "segmentation": 21, "delta_q": 22, "delta_lf": 23, "sb128": 24, "deblock": 25, "420": 26, "422": 27, "444": 28, "400": 29,
         "edge_filter": 30}


def photo(h: int, w: int, seed: int) -> np.ndarray:
    """A smooth photograph-like RGB image with sensor noise."""
    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(float)
    base = 128 + 60 * np.sin(xx / 17.0 + seed) * np.cos(yy / 23.0) + 30 * np.sin((xx + yy) / 7.0)
    img = np.stack([base, base * 0.8 + 30 * np.cos(xx / 11.0), 255 - base * 0.9], -1) + r.normal(0, 8, (h, w, 3))
    return img.clip(0, 255).astype(np.uint8)


def screen(h: int, w: int, seed: int) -> Image.Image:
    """Dark text on a flat background: libaom takes it for screen content."""
    im = Image.new("RGB", (w, h), (250, 250, 250))
    d = ImageDraw.Draw(im)
    r = np.random.default_rng(seed)
    for i in range(12):
        d.text((int(r.integers(0, w - 30)), int(r.integers(0, h - 10))), f"AVIF {i}",
               fill=tuple(int(v) for v in r.integers(0, 200, 3)))
    d.rectangle((5, 5, 40, 30), fill=(200, 30, 30))
    return im


def rgba(img: np.ndarray) -> Image.Image:
    """``img`` with an alpha ramp (an opaque image is written without its
    alpha item)."""
    h, w, _ = img.shape
    alpha = (np.add.outer(np.arange(h), np.arange(w)) * 255 // (h + w)).astype(np.uint8)
    return Image.fromarray(np.dstack([img, alpha]), "RGBA")


def _save(img, **kw) -> bytes:
    buf = io.BytesIO()
    (img if isinstance(img, Image.Image) else Image.fromarray(img)).save(buf, "AVIF", **kw)
    return buf.getvalue()


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


def _with_props(avif: bytes, extra: list[bytes]) -> bytes:
    data, props = cs._avif_item(avif)
    return cs._avif_file([{"id": 1, "type": b"av01", "data": data, "props": props + extra}], 1)


def _clap(wn, hn, hon, hod):
    return cs._box(b"clap", struct.pack(">IIIIiIiI", wn, 1, hn, 1, hon, hod, 0, 1))


NO_LR = ("enable-restoration", "0")


def golden_files() -> dict[str, bytes]:
    """Every golden file, by name: Pillow's defaults (4:2:0, speed 6,
    quality 75) and each subsampling, speeds 5-10 and qualities 10-100;
    libaom options for tiles, 128² superblocks, lossless, delta q and lf,
    the reduced tx set, filter intra (speed 2, no loop restoration), 64-point
    transforms (speed 4), screen content; segmentation from libavif's
    encoder in its good-quality usage (``avif_oracle.encode``: Pillow's
    all-intra encoder ignores ``aq-mode``); grids, irot, imir and clap
    built in Python."""
    out = {}
    odd = photo(45, 67, 1)
    mid = photo(97, 130, 2)
    out["default_420_67x45.avif"] = _save(odd)
    out["default_420_130x97.avif"] = _save(mid)
    for sub in ("4:4:4", "4:2:2"):
        out[f"s{sub.replace(':', '')}_130x97.avif"] = _save(mid, subsampling=sub)
        out[f"s{sub.replace(':', '')}_q95_67x45.avif"] = _save(odd, subsampling=sub, quality=95)
    out["s400_67x45.avif"] = _save(odd, subsampling="4:0:0")
    yy, xx = np.mgrid[0:128, 0:128]
    flat = np.stack([xx + 60, yy + 70, (xx + yy) // 2 + 50], -1).astype(np.uint8)
    out["tx64_speed4_128x128.avif"] = _save(flat, quality=50, speed=4, advanced=[("enable-tx64", "1"), NO_LR])
    for sp in (5, 8, 10):
        out[f"speed{sp}_q50_130x97.avif"] = _save(mid, speed=sp, quality=50)
    out["q10_130x97.avif"] = _save(mid, quality=10)
    out["q100_67x45.avif"] = _save(odd, quality=100)
    out["limited_range_67x45.avif"] = _save(odd, range="limited")
    out["rgba_67x45.avif"] = _save(rgba(odd))
    big = photo(128, 160, 3)
    out["tiles_2x2_160x128.avif"] = _save(big, tile_cols=2, tile_rows=2, autotiling=False)
    out["sb128_160x128.avif"] = _save(big, advanced=[("sb-size", "128")])
    out["lossless_67x45.avif"] = _save(odd, quality=100, advanced=[("lossless", "1")])
    out["delta_q_lf_160x128.avif"] = _save(big, advanced=[("deltaq-mode", "2"), ("delta-lf-mode", "1")])
    out["reduced_tx_set_130x97.avif"] = _save(mid, advanced=[("reduced-tx-type-set", "1")])
    out["segmentation_aq1_160x128.avif"] = ao.encode(photo(128, 160, 7), [("aq-mode", "1"), ("enable-cdef", "0"),
                                                                          ("enable-restoration", "0")])
    out["filter_intra_speed2_130x97.avif"] = _save(mid, speed=2, advanced=[("enable-filter-intra", "1"), NO_LR])
    out["screen_no_palette_128x96.avif"] = _save(screen(96, 128, 2), quality=100,
                                                 advanced=[("enable-palette", "0")])
    tiles = [_save(photo(64, 64, 10 + k)) for k in range(4)]
    out["grid_2x2_128x128.avif"] = cs._avif_grid(tiles, 2, 2)
    out["grid_2x2_crop_120x100.avif"] = cs._avif_grid(tiles, 2, 2, (120, 100))
    out["grid_3x1_copies_192x64.avif"] = cs._avif_grid(tiles[:1], 3, 1)
    out["irot1_imir0_67x45.avif"] = _with_props(out["default_420_67x45.avif"],
                                                [cs._box(b"irot", bytes([1])), cs._box(b"imir", bytes([0]))])
    out["clap_67x45.avif"] = _with_props(out["default_420_67x45.avif"], [_clap(40, 30, 0, 1)])
    return out


def _prem(rgba: bytes) -> bytes:
    """An RGBA AVIF with a prem reference: its colour premultiplied."""
    from mmtrs_tpu_torch.utils.avif import Container

    c = Container(rgba)
    alpha = next(src for kind, src, dst in c.refs if kind == b"auxl")
    items = []
    for iid, item in sorted(c.items.items()):
        props = [rgba[p0 - 8:p1] for _, (p0, p1) in item.props.items()] + [rgba[p0 - 8:p1] for p0, p1 in item.colr]
        items.append({"id": iid, "type": item.type, "data": c.data(item), "props": props})
    return cs._avif_file(items, c.primary, [(b"auxl", alpha, [c.primary]), (b"prem", c.primary, [alpha])])


def _rewrite_headers(avif: bytes, seq_bits, frame_bits) -> bytes:
    """A one-item AVIF with the bits of its AV1 sequence header and frame
    OBU rewritten in place (each OBU keeps its size): ``seq_bits`` and
    ``frame_bits`` map the OBU's bit string to the new one."""
    data, props = cs._avif_item(avif)
    b = bytearray(data)
    at = 0
    while at < len(b):
        kind, p = (b[at] >> 3) & 15, at + 1 + ((b[at] >> 2) & 1)
        size = shift = 0
        while True:
            size |= (b[p] & 127) << shift
            shift += 7
            p += 1
            if not b[p - 1] & 128:
                break
        if kind in (1, 6):
            bits = "".join(f"{v:08b}" for v in b[p:p + size])
            bits = seq_bits(bits) if kind == 1 else frame_bits(bits)
            b[p:p + size] = int(bits, 2).to_bytes(size, "big")
        at = p + size
    return cs._avif_file([{"id": 1, "type": b"av01", "data": bytes(b), "props": props}], 1)


def _reduced_flags_at(bits: str) -> int:
    """In a reduced still-picture sequence header: the bit of
    enable_superres (after the sizes and three intra flags)."""
    wb, hb = int(bits[10:14], 2) + 1, int(bits[14:18], 2) + 1
    return 18 + wb + hb + 3


def _superres(avif: bytes) -> bytes:
    """enable_superres set in the sequence header, and use_superres (with
    denominator 9) in the frame header after disable_cdf_update and
    allow_screen_content_tools (and force_integer_mv): the bits after it
    keep their places, so only the header's start is a valid one."""
    def seq(bits):
        k = _reduced_flags_at(bits)
        return bits[:k] + "1" + bits[k + 1:]

    def frame(bits):
        k = 2 + (bits[1] == "1")
        return bits[:k] + "1000" + bits[k + 4:]

    return _rewrite_headers(avif, seq, frame)


def _ten_bit(avif: bytes) -> bytes:
    """high_bitdepth set in the sequence header's colour config: a 10-bit
    stream's header (the encoder of the wheel's libaom writes 8 bits
    alone)."""
    def seq(bits):
        k = _reduced_flags_at(bits) + 3
        return bits[:k] + "1" + bits[k + 1:]

    return _rewrite_headers(avif, seq, lambda bits: bits)


def _inter_frame(anim: bytes) -> bytes:
    """A one-item AVIF whose data is an animation's sequence header and its
    second frame (an inter frame), taken from the OBUs that follow the
    primary item in the mdat box."""
    from mmtrs_tpu_torch.utils.avif import Container

    c = Container(anim)
    item = c.items[c.primary]
    start = item.base + item.extents[0][0]
    obus, at, frames, seq = anim, start, [], b""
    while at < len(obus) and len(frames) < 2:
        kind, p = (obus[at] >> 3) & 15, at + 1 + ((obus[at] >> 2) & 1)
        size = shift = 0
        while True:
            size |= (obus[p] & 127) << shift
            shift += 7
            p += 1
            if not obus[p - 1] & 128:
                break
        if kind == 1 and not seq:
            seq = obus[at:p + size]
        if kind == 6:
            frames.append(obus[at:p + size])
        at = p + size
    _, props = cs._avif_item(anim)
    return cs._avif_file([{"id": 1, "type": b"av01", "data": seq + frames[1], "props": props}], 1)


@functools.cache
def refused_files() -> dict[str, tuple[bytes, str]]:
    """A file using each tool once refused, and the words the port's error
    holds (CDEF, loop restoration and palette decode since the second
    slice). Pillow decodes them all but the crafted superres,
    10-bit, inter-frame and sequence files (the wheel's libaom writes neither
    superres nor more than 8 bits)."""
    mid = photo(97, 130, 4)
    frames = [Image.fromarray(photo(64, 64, s)) for s in range(2)]
    anim = io.BytesIO()
    frames[0].save(anim, "AVIF", save_all=True, append_images=frames[1:])
    anim = anim.getvalue()
    data, props = cs._avif_item(anim)
    no_pitm = cs._avif_file([{"id": 1, "type": b"av01", "data": data, "props": props}], None, brand=b"avis")
    no_pitm += cs._box(b"moov", b"")  # a track's place, without the track
    return {
        "cdef": (_save(mid, advanced=[("enable-cdef", "1")]), "CDEF"),
        "loop_restoration": (_save(mid, speed=2), "loop restoration"),
        "film_grain": (_save(mid, advanced=[("film-grain-test", "1")]), "film grain"),
        "quantiser_matrices": (_save(mid, advanced=[("tune", "iq")]), "quantiser matrices"),
        "palette": (_save(screen(96, 128, 1)), "palette"),
        "ten_bit": (_ten_bit(_save(mid)), "10-bit"),
        "superres": (_superres(_save(mid)), "superres"),
        "inter_frame": (_inter_frame(anim), "inter"),
        "premultiplied_alpha": (_prem(_save(rgba(photo(45, 67, 5)))), "premultiplied"),
        "avis_without_primary_item": (no_pitm, "image sequence"),
    }


def _phone() -> np.ndarray:
    """The 1024 × 768 phone photo the card's machine uploads (the WebP
    golden, which the port decodes equal to Pillow)."""
    with np.load(ROOT / "mmtrs_tpu_torch" / "testdata" / "webp_goldens.npz") as z:
        return np.asarray(Image.open(io.BytesIO(z["phone_1024x768_q90.webp"].tobytes())).convert("RGB"))


def upload_files() -> dict[str, bytes]:
    """The card's uploads of the phone photo (no Pillow there to write
    them), in ``chip_smoke.AVIF_UPLOADS``: at Pillow's defaults, 4:4:4,
    4:0:0 and in two tile columns, and a 512 × 384 crop whose 2 × 2 grid of
    copies is a 1024 × 768 upload too."""
    phone = _phone()
    return {cs.AVIF_UPLOAD_FILES["avif_420"]: _save(phone),
            cs.AVIF_UPLOAD_FILES["avif_444"]: _save(phone, subsampling="4:4:4"),
            cs.AVIF_UPLOAD_FILES["avif_400"]: _save(phone, subsampling="4:0:0"),
            cs.AVIF_UPLOAD_FILES["avif_two_tiles"]: _save(phone, tile_cols=1, tile_rows=0, autotiling=False),
            cs.AVIF_GRID_TILE: _save(phone[192:576, 256:768])}


def write_goldens(path: Path = GOLDENS) -> int:
    files = golden_files()
    arrays = {}
    for name, data in sorted(files.items()):
        fmt, rgb = _pillow(data)
        arrays[name] = np.frombuffer(data, np.uint8)
        arrays[f"{name}.pil"] = rgb
    np.savez_compressed(path, **arrays)
    np.savez_compressed(cs.AVIF_UPLOADS, **{k: np.frombuffer(v, np.uint8) for k, v in upload_files().items()})
    return len(files)


def _golden_names() -> list[str]:
    if not GOLDENS.exists():  # before the first ``python -m tests.test_torch_codec_avif``
        return []
    with np.load(GOLDENS) as z:
        return sorted(f for f in z.files if not f.endswith(".pil"))


@pytest.fixture(scope="module")
def goldens():
    with np.load(GOLDENS) as z:
        return {f: z[f] for f in z.files}


def test_goldens_are_small_and_regenerate_bit_for_bit():
    """The committed file is under 1 MB, each golden at most 256² pixels,
    and holds what the writers above and Pillow 12.1 give now."""
    assert GOLDENS.stat().st_size < 1 << 20
    fresh = golden_files()
    with np.load(GOLDENS) as z:
        assert sorted(fresh) == _golden_names()
        for name, data in fresh.items():
            assert z[name].tobytes() == data, name
            rgb = z[f"{name}.pil"]
            assert rgb.shape[0] * rgb.shape[1] <= 256 * 256, name
            np.testing.assert_array_equal(_pillow(data)[1], rgb, err_msg=name)


@pytest.mark.parametrize("name", _golden_names())
def test_golden_decodes_as_pillow_with_libavifs_planes(goldens, name):
    """The port's RGB equals Pillow's, its Y, U and V planes libavif's
    (dav1d's), and the file sniffs as AVIF."""
    from mmtrs_tpu_torch.utils import avif, codec

    data = goldens[name].tobytes()
    assert codec.sniff(data) == "AVIF"
    np.testing.assert_array_equal(_port(data), goldens[f"{name}.pil"])
    planes, _ = avif.planes_of(data)
    want = ao.decode(data)["planes"]
    assert len(planes) == len(want)
    for got, ref in zip(planes, want):
        np.testing.assert_array_equal(got, ref)


def test_goldens_cover_every_tool_of_the_first_slice(goldens):
    """The union of the goldens' tool masks holds each intra mode class,
    filter intra, CfL, angle deltas, the edge filter and upsampling, each
    transform size and type class, lossless, tiles, segmentation, delta q
    and lf, 128² superblocks, the deblocking filter and each subsampling
    (delta lf multi is decoded, but neither of the wheel's encoders writes
    it)."""
    from mmtrs_tpu_torch.utils import avif

    mask = 0
    for name in _golden_names():
        mask |= int(avif.planes_of(goldens[name].tobytes())[1][10]) & 0xFFFFFFFF
    missing = [tool for tool, bit in TOOLS.items() if not mask >> bit & 1]
    assert missing == []


REFUSED = ["cdef", "loop_restoration", "film_grain", "quantiser_matrices", "palette", "ten_bit", "superres",
           "inter_frame", "premultiplied_alpha", "avis_without_primary_item"]


def test_refused_cases_are_listed():
    assert sorted(refused_files()) == sorted(REFUSED)


# the tools AVIF's second and third slices decode
# (tests/test_torch_codec_avif2.py, tests/test_torch_codec_avif3.py)
DECODED = ("cdef", "loop_restoration", "palette", "film_grain", "quantiser_matrices", "premultiplied_alpha")


@pytest.mark.parametrize("case", REFUSED)
def test_second_slice_tools_are_refused_by_name(case):
    """Each tool no slice decodes (superres, 10 bits, inter frames) raises
    with its name; Pillow decodes the files that Pillow's and libavif's
    encoders wrote. CDEF, loop restoration, palette, film grain, quantiser
    matrices and premultiplied alpha now decode, equal to Pillow. A
    sequence decodes from its track since the third slice: this one's moov
    box holds no track, which libavif and the port refuse alike."""
    data, words = refused_files()[case]
    if case not in ("superres", "ten_bit", "inter_frame", "avis_without_primary_item"):
        assert _pillow_or_none(data) is not None
    if case in DECODED:
        np.testing.assert_array_equal(_port(data), _pillow(data)[1])
        return
    if case == "avis_without_primary_item":
        assert _pillow_or_none(data) is None
        with pytest.raises(ValueError):
            _port(data)
        return
    with pytest.raises(ValueError, match=words):
        _port(data)


# (matrix coefficients, full range): BT.601 and BT.709 at both ranges and
# the identity, swept over every triple; BT.2020 at full range on random
# planes below
CONVERSIONS = [(6, 1), (6, 0), (1, 1), (1, 0), (0, 1)]


@pytest.mark.parametrize("matrix,full", CONVERSIONS)
def test_conversion_equals_libavif_on_every_triple(matrix, full):
    """libavif's ``avifImageYUVToRGB`` of a 4096² 4:4:4 image holding every
    (Y, U, V) triple once equals the port's conversion."""
    from mmtrs_tpu_torch.utils.avif import yuv_to_rgb

    v = np.arange(1 << 24, dtype=np.uint32)
    planes = [(v >> s & 255).astype(np.uint8).reshape(4096, 4096) for s in (16, 8, 0)]
    got = yuv_to_rgb([torch.from_numpy(p) for p in planes], 0, 0, matrix, full, 1).numpy()
    np.testing.assert_array_equal(got, ao.yuv_to_rgb(planes, ao.YUV444, matrix, full))


@pytest.mark.parametrize("fmt", [ao.YUV420, ao.YUV422, ao.YUV400])
def test_upsampling_equals_libavif_at_odd_sizes(fmt):
    """Random planes of odd and even sizes, down to 1 × 1, in 4:2:0, 4:2:2
    and 4:0:0, at full and limited range: libyuv's chroma upsampling."""
    from mmtrs_tpu_torch.utils.avif import yuv_to_rgb

    rng = np.random.default_rng(fmt)
    sx, sy = {ao.YUV420: (1, 1), ao.YUV422: (1, 0), ao.YUV400: (1, 1)}[fmt]
    for h, w in ((1, 1), (2, 3), (7, 9), (45, 67), (64, 2), (1, 33)):
        y = rng.integers(0, 256, (h, w)).astype(np.uint8)
        uv = [rng.integers(0, 256, ((h + sy) >> sy, (w + sx) >> sx)).astype(np.uint8) for _ in range(2)]
        planes = [y] if fmt == ao.YUV400 else [y, *uv]
        for matrix, full in ((6, 1), (6, 0), (1, 0), (9, 1)):
            got = yuv_to_rgb([torch.from_numpy(p) for p in planes], sx, sy, matrix, full, 1).numpy()
            np.testing.assert_array_equal(got, ao.yuv_to_rgb(planes, fmt, matrix, full),
                                          err_msg=f"{h}x{w} {matrix} {full}")


def test_conversions_libavif_routes_elsewhere_are_named():
    """Matrices libavif converts in floating point (FCC, SMPTE 240M; once
    refused by name, converted since AVIF's third slice) and BT.2020 at
    limited range (libyuv's) equal libavif's conversion; those libavif
    cannot convert (the identity on subsampled chroma) fail in both, by
    name."""
    from mmtrs_tpu_torch.utils.avif import yuv_to_rgb

    y = np.full((4, 4), 100, np.uint8)
    uv = [np.full((2, 2), 120, np.uint8)] * 2
    on = [torch.from_numpy(p) for p in (y, *uv)]
    for matrix, full in ((4, 1), (7, 0), (9, 0)):
        np.testing.assert_array_equal(yuv_to_rgb(on, 1, 1, matrix, full, 1).numpy(),
                                      ao.yuv_to_rgb([y, *uv], ao.YUV420, matrix, full))
    with pytest.raises(ValueError, match="identity matrix"):
        yuv_to_rgb(on, 1, 1, 0, 1, 1)
    with pytest.raises(ValueError):
        ao.yuv_to_rgb([y, *uv], ao.YUV420, 0, 1)


def _mutations(data: bytes, seed: int, n: int = 30) -> list[bytes]:
    """Cuts at 8 places and ``n`` files with 1-3 bytes changed anywhere."""
    rng = np.random.default_rng(seed)
    out = [data[:int(c)] for c in np.linspace(1, len(data) - 1, 8)]
    for _ in range(n):
        m = bytearray(data)
        for i in rng.integers(0, len(m), rng.integers(1, 4)):
            m[int(i)] = int(rng.integers(0, 256))
        out.append(bytes(m))
    return out


MUTATED = ["default_420_130x97.avif", "s444_130x97.avif", "tiles_2x2_160x128.avif"]


@pytest.mark.parametrize("name", MUTATED)
def test_mutated_files_agree_with_pillow(goldens, name):
    """Cut and mutated goldens: where Pillow decodes, the port's decode is
    equal (dav1d decodes a damaged tile on, and refuses one whose symbols
    run more than 14 bits past its data); where Pillow raises, the port
    raises a ValueError."""
    bad = []
    for k, data in enumerate(_mutations(goldens[name].tobytes(), MUTATED.index(name))):
        want = _pillow_or_none(data)
        try:
            got = _port(data)
        except ValueError:
            got = None
        if want is None and got is not None:
            bad.append((k, "port decodes, Pillow raises"))
        elif want is not None and (got is None or got.shape != want[1].shape or not np.array_equal(got, want[1])):
            bad.append((k, "differs" if got is not None else "port raises, Pillow decodes"))
    assert bad == [], bad[:3]


# one byte of a golden changed, each a rule of libavif 1.3.0's parser (or
# conversion, or dav1d's header parse) that a fuzz of the goldens found the
# port without: (golden, offset, new byte)
CONTAINER_RESIDUALS = {
    "ipma_names_an_unknown_item": ("rgba_67x45.avif", 415, 152),  # the alpha item then lacks its ispe
    "iloc_names_an_unknown_item": ("rgba_67x45.avif", 122, 55),  # the alpha item has no data: skipped
    "iloc_reserved_bits": ("clap_67x45.avif", 105, 225),
    "iloc_reserved_bits_of_a_tile": ("grid_3x1_copies_192x64.avif", 137, 155),
    "av1c_marker": ("filter_intra_speed2_130x97.avif", 221, 93),
    "nclx_reserved_bits": ("s444_130x97.avif", 243, 167),
    "irot_reserved_bits": ("irot1_imir0_67x45.avif", 245, 36),
    "imir_reserved_bits": ("irot1_imir0_67x45.avif", 254, 44),
    "unknown_essential_property": ("irot1_imir0_67x45.avif", 244, 253),
    "pixi_version": ("q10_130x97.avif", 205, 243),
    "meta_version": ("tx64_speed4_128x128.avif", 40, 72),
    "iinf_holding_another_box": ("rgba_67x45.avif", 180, 102),
    "mdat_size_past_what_libavif_reads": ("limited_range_67x45.avif", 270, 72),
    "one_property_associated_twice": ("q10_130x97.avif", 266, 131),
    "avis_brand_without_moov": ("s444_130x97.avif", 11, 115),
    "gray_of_a_matrix_libavif_refuses": ("s400_67x45.avif", 236, 234),
    # dav1d's sequence-header check: an operating point names both layers
    "operating_point_without_layers": ("segmentation_aq1_160x128.avif", 281, 84),
    # dav1d takes a segment id past the last active segment as 0, where the
    # specification clips it to the last
    "segment_id_past_the_last_active": ("segmentation_aq1_160x128.avif", 303, 190),
    # the alpha's extent run on into the colour item: dav1d reads its OBUs
    # past the frame, and one runs past the data
    "obu_past_the_frame_running_past_the_data": ("rgba_67x45.avif", 134, 157),
}


# Queue 3's avis-track fault: cuts and mutations of the animated goldens
# (tests/test_torch_codec_avif2.py) that the port once decoded otherwise than
# Pillow, reading the primary item where Pillow's libavif reads the track's
# first sample (284 of 1,428 such files; none since AVIF's third slice):
# (golden, the seed of _mutations(golden, seed, 196), the file's index), one
# of each kind of damage: a cut, the sample table's sizes, chunks, offsets
# and description, the media header, the edit list, the sample entry's
# av1C, the handler, the item list, and the AV1 data of a frame the track's
# header scales
AVIS_FUZZ = [("animated_q30_speed4_128x96.avif", 1000, 6), ("animated_q30_speed6_128x96.avif", 1001, 119),
             ("animated_q30_speed6_128x96.avif", 1001, 33), ("animated_q30_speed6_422_128x96.avif", 1002, 42),
             ("animated_q30_speed4_128x96.avif", 1000, 23), ("animated_q30_speed4_128x96.avif", 1000, 179),
             ("animated_q30_speed4_128x96.avif", 1000, 118), ("animated_q30_speed6_128x96.avif", 1001, 36),
             ("animated_q30_speed6_422_128x96.avif", 1002, 98), ("animated_q30_speed4_128x96.avif", 1000, 74),
             ("animated_q30_speed4_128x96.avif", 1000, 97), ("animated_q30_speed4_128x96.avif", 1000, 49)]


@pytest.mark.parametrize("name,seed,k", AVIS_FUZZ)
def test_avis_mutations_decode_from_the_track_as_pillow(name, seed, k):
    """A damaged image sequence: the port decodes equal to Pillow (from the
    track's first sample), or both refuse."""
    with np.load(cs.AVIF2_GOLDENS) as z:
        data = _mutations(z[name].tobytes(), seed, 196)[k]
    want = _pillow_or_none(data)
    if want is None:
        with pytest.raises(ValueError):
            _port(data)
    else:
        np.testing.assert_array_equal(_port(data), want[1])


def _changed(goldens, name: str, at: int, value: int) -> bytes:
    data = bytearray(goldens[name].tobytes())
    data[at] = value
    return bytes(data)


@pytest.mark.parametrize("case", sorted(CONTAINER_RESIDUALS))
def test_container_residuals_agree_with_pillow(goldens, case):
    """Queue 3's container faults: the port decodes equal to Pillow, or
    both refuse."""
    data = _changed(goldens, *CONTAINER_RESIDUALS[case])
    want = _pillow_or_none(data)
    if want is None:
        with pytest.raises(ValueError):
            _port(data)
    else:
        np.testing.assert_array_equal(_port(data), want[1])


def test_every_image_item_needs_its_ispe(goldens):
    """libavif refuses an AV1 item without ispe even where nothing refers to
    it; one with ispe but no av1C is skipped unless it is the alpha."""
    data, props = cs._avif_item(goldens["default_420_67x45.avif"].tobytes())
    ispe = [p for p in props if p[4:8] == b"ispe"]
    av1c = [p for p in props if p[4:8] == b"av1C"]
    main = {"id": 1, "type": b"av01", "data": data, "props": props}
    for extra, ok in ((av1c, False), (ispe, True)):
        f = cs._avif_file([main, {"id": 2, "type": b"av01", "data": data, "props": extra}], 1)
        assert (_pillow_or_none(f) is not None) == ok
        if ok:
            np.testing.assert_array_equal(_port(f), _pillow(f)[1])
        else:
            with pytest.raises(ValueError):
                _port(f)


# a damaged file whose planes differ from dav1d's at these many samples
# (Y, U, V), counted against dav1d's AVX2 transforms: the path dav1d takes
# on an x86 CPU without AVX-512 VBMI, as where these tests run (on one
# with it, dav1d takes its AVX-512 ICL transforms and the counts may
# differ)
DAV1D_SIMD_DIFFERENCES = {
    # coefficients past int16 in a damaged tile: dav1d's AVX2 inverse
    # transforms saturate in their 16-bit lanes, the port clamps only where
    # dav1d's C transforms do (Y 255 against 0)
    "int16_overflow": (("delta_q_lf_160x128.avif", 2976, 124), (55, 19, 289)),
}


@pytest.mark.parametrize("case", sorted(DAV1D_SIMD_DIFFERENCES))
def test_damaged_files_left_differing_from_dav1d_are_pinned(goldens, case):
    """A documented difference (ROADMAP Queue 3, by design): both decode,
    and the port's planes differ from dav1d's at the pinned number of
    samples."""
    (name, at, value), counts = DAV1D_SIMD_DIFFERENCES[case]
    from mmtrs_tpu_torch.utils.avif import planes_of

    data = _changed(goldens, name, at, value)
    assert _pillow_or_none(data) is not None
    got = planes_of(data)[0]
    want = ao.decode(data)["planes"]
    assert tuple(int((g != w).sum()) for g, w in zip(got, want)) == counts


def test_card_uploads_regenerate_and_decode_as_pillow():
    """The card's uploads are what Pillow writes now and decode equal to
    Pillow's decode, the grid of the tile's copies too (the two-tile file
    has two tile columns)."""
    from mmtrs_tpu_torch.utils import avif

    fresh = upload_files()
    with np.load(cs.AVIF_UPLOADS) as z:
        assert sorted(z.files) == sorted(fresh)
        for name, data in fresh.items():
            assert z[name].tobytes() == data, name
    files = dict(fresh)
    files["grid"] = cs._avif_grid([fresh[cs.AVIF_GRID_TILE]], 2, 2)
    for name, data in files.items():
        got = _port(data)
        assert got.shape == (768, 1024, 3) or name == cs.AVIF_GRID_TILE, name
        np.testing.assert_array_equal(got, _pillow(data)[1], err_msg=name)
    assert int(avif.planes_of(fresh[cs.AVIF_UPLOAD_FILES["avif_two_tiles"]])[1][10]) >> TOOLS["tiles"] & 1


def test_segment_id_read_before_skip_is_predicted_as_unskipped(goldens):
    """The segmentation golden with a segment enabling the reference-frame
    feature (one byte of its frame header changed): segment ids are then
    read before skip, and predicted as for a block not skipped (the
    previous block's skip flag must not leak in); equal to Pillow and
    dav1d's planes."""
    from mmtrs_tpu_torch.utils.avif import planes_of

    data = bytearray(goldens["segmentation_aq1_160x128.avif"].tobytes())
    data[310] = 221
    data = bytes(data)
    np.testing.assert_array_equal(_port(data), _pillow(data)[1])
    for got, want in zip(planes_of(data)[0], ao.decode(data)["planes"]):
        np.testing.assert_array_equal(got, want)


def test_grid_of_copies_holds_the_tiles_planes_in_each_cell():
    """chip_smoke.py's 12 MP grid is copies of one tile: on a 2 × 2 grid,
    each cell's planes are the tile's, and the RGB is Pillow's (the
    conversion's chroma upsampling runs across the cells, as libavif's
    does on the pasted planes)."""
    from mmtrs_tpu_torch.utils.avif import planes_of

    upload = _save(photo(128, 192, 20))
    grid = cs._avif_grid([upload], 2, 2)
    np.testing.assert_array_equal(_port(grid), _pillow(grid)[1])
    for g, t in zip(planes_of(grid)[0], planes_of(upload)[0]):
        np.testing.assert_array_equal(g.reshape(2, t.shape[0], 2, t.shape[1]).transpose(0, 2, 1, 3),
                                      np.broadcast_to(t, (2, 2) + t.shape))


def test_decoder_refuses_a_bomb_before_allocating():
    """An ispe of Pillow's bomb size raises as Pillow's check does, and one
    past libavif's limits as libavif refuses it, before any decode."""
    base = _save(photo(16, 16, 9))
    data, props = cs._avif_item(base)
    for w, h in ((20000, 10000), (40000, 8)):
        props2 = [p if p[4:8] != b"ispe" else cs._fullbox(b"ispe", 0, 0, struct.pack(">II", w, h)) for p in props]
        f = cs._avif_file([{"id": 1, "type": b"av01", "data": data, "props": props2}], 1)
        assert _pillow_or_none(f) is None
        with pytest.raises(ValueError):
            _port(f)


def test_av1_tables_header_matches_the_script():
    """The committed av1_tables.h is what scripts/make_av1_tables.py reads
    from the wheel's libavif now (its own shape and agreement checks
    included)."""
    res = subprocess.run([sys.executable, str(ROOT / "scripts" / "make_av1_tables.py"), "--check"],
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


if __name__ == "__main__":
    print(f"wrote {write_goldens()} goldens to {GOLDENS}")
