"""AVIF's third slice through the port's own decoder (``csrc/host/av1.cpp``,
``utils/avif.py``), held to Pillow 12.1 (libavif 1.3.0, dav1d 1.5.1, libyuv
1909) and, where the planes change, to dav1d's planes
(``tests/avif_oracle.py``):

- premultiplied alpha (Pillow's ``alpha_premultiplied``): the colour
  unpremultiplied as libavif has libyuv's ARGBUnattenuate do it for
  Pillow's RGBA, swept over every (value, alpha) pair; 4:2:0, 4:4:4, a grid
  (with its alpha grid) and an animated save;
- quantiser matrices (``enable-qm`` at qm-min/qm-max levels over 0-15, and
  ``tune=iq``, which turns them on) in 4:2:0, 4:4:4 and 4:0:0;
- film grain: libaom's ``film-grain-test`` vectors 1-16 (Pillow writes all
  16 through ``advanced=``; they set the AR lag, the luma and chroma
  points, chroma scaling from luma, overlap and the clip to restricted
  range each otherwise) and ``denoise-noise-level`` on a noisy photograph;
  dav1d here applies the grain with its x86 SIMD rows (AVX-512 Ice Lake on
  a CPU with AVX-512 VBMI2 and GFNI, as where these tests run, AVX2
  elsewhere), which dav1d's own checkasm holds equal to its C;
- libavif's own floating-point YUV → RGB for the matrices libyuv does not
  take (FCC, SMPTE 240M, YCgCo, chroma-derived NCL of primaries libyuv has
  no matrix for, the identity at limited range, matrix 15), on nclx boxes
  rewritten in Pillow saves, swept over every (Y, U, V) triple;
- a frame of another size than its ``ispe`` (or its track's ``tkhd``):
  scaled as libavif scales it (libyuv's ScalePlane, kFilterBox), a grid's
  tiles too;
- an image sequence decoded from its track as libavif's
  AVIF_DECODER_SOURCE_AUTO picks it, the sample entry's ``colr`` before the
  AV1 sequence header's.

The goldens (``mmtrs_tpu_torch/testdata/avif3_goldens.npz``, each with
Pillow's decode) and the card's files (``avif3_uploads.npz``) are written
by ``python -m tests.test_torch_codec_avif3``.
"""

from __future__ import annotations

import struct

import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke as cs
from tests import avif_oracle as ao
from tests.test_torch_codec_avif import _phone, _pillow, _pillow_or_none, _port, _save, photo, rgba
from tests.test_torch_codec_avif2 import _animated

GOLDENS = cs.AVIF3_GOLDENS

# the tools mask's high word (csrc/host/av1.cpp, TOOL_QM, TOOL_FILM_GRAIN)
QM_BIT, GRAIN_BIT = 41, 42


def noisy(h: int, w: int, seed: int, sigma: float = 14.0) -> np.ndarray:
    """Smooth ramps under strong sensor noise: libaom's noise model needs
    flat blocks, and 128 × 96 of them (at 80 × 64 it finds too few and
    writes no grain)."""
    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(float)
    base = np.stack([90 + xx, 120 + yy * 0.5, 160 - xx * 0.5], -1)
    return np.clip(base + r.normal(0, sigma, (h, w, 3)), 0, 255).astype(np.uint8)


def with_nclx(avif: bytes, primaries: int, matrix: int, full: int) -> bytes:
    """A one-item AVIF with its nclx colour box rewritten (the AV1 sequence
    header keeps its own, which the box overrides)."""
    data, props = cs._avif_item(avif)
    nclx = cs._box(b"colr", b"nclx" + struct.pack(">HHHB", primaries, 13, matrix, full << 7))
    return cs._avif_file([{"id": 1, "type": b"av01", "data": data,
                           "props": [p for p in props if p[4:8] != b"colr"] + [nclx]}], 1)


def with_ispe(avif: bytes, w: int, h: int) -> bytes:
    """A one-item AVIF whose ispe says another size than its AV1 frame's."""
    data, props = cs._avif_item(avif)
    props = [p if p[4:8] != b"ispe" else cs._fullbox(b"ispe", 0, 0, struct.pack(">II", w, h)) for p in props]
    return cs._avif_file([{"id": 1, "type": b"av01", "data": data, "props": props}], 1)


def _box_at(data: bytes, kind: bytes, start: int = 0) -> int:
    """The offset of the first ``kind`` box's header from ``start``."""
    return data.index(kind, start) - 4


def with_tkhd_size(anim: bytes, w: int, h: int) -> bytes:
    """A sequence whose track header says another size than its frames'."""
    m = bytearray(anim)
    at = _box_at(anim, b"tkhd")
    end = at + struct.unpack_from(">I", anim, at)[0]
    struct.pack_into(">II", m, end - 8, w << 16, h << 16)
    return bytes(m)


def with_track_colr(anim: bytes, matrix: int, full: int) -> bytes:
    """A sequence whose sample entry's nclx box holds another matrix and
    range than its AV1 sequence header."""
    m = bytearray(anim)
    at = _box_at(anim, b"colr", _box_at(anim, b"stsd"))
    struct.pack_into(">H", m, at + 16, matrix)
    m[at + 18] = full << 7
    return bytes(m)


def retype(data: bytes, kind: bytes, new: bytes, start: int = 0) -> bytes:
    """``data`` with the first ``kind`` box from ``start`` renamed ``new``
    (``free``: the box is gone for a parser)."""
    at = data.index(kind, start)
    return data[:at] + new + data[at + 4:]


def with_brands(data: bytes, major: bytes, compatible: list[bytes]) -> bytes:
    """``data`` with its ftyp's major brand and compatible brands (the box
    keeps its size: the list is padded with the last brand)."""
    n = (struct.unpack_from(">I", data, 0)[0] - 16) // 4
    brands = (compatible + [compatible[-1]] * n)[:n]
    return data[:8] + major + data[12:16] + b"".join(brands) + data[16 + 4 * n:]


def mixed_sequence(anim: bytes, still: bytes) -> bytes:
    """A sequence whose primary item is another picture than its track's
    first sample: ``still``'s AV1 data appended to the mdat box (the last
    box) and the primary item's one extent pointed at it."""
    data, _ = cs._avif_item(still)
    m = bytearray(anim + data)
    at = _box_at(anim, b"mdat")
    struct.pack_into(">I", m, at, struct.unpack_from(">I", anim, at)[0] + len(data))
    iloc = _box_at(anim, b"iloc")  # version 0, 4-byte offsets and lengths, no base offset, one item
    assert anim[iloc + 12:iloc + 16] == b"\x44\x00\x00\x01"
    struct.pack_into(">II", m, iloc + 22, len(anim), len(data))
    return bytes(m)


def with_restricted_grain(avif: bytes) -> bytes:
    """A one-item AVIF with film grain whose clip_to_restricted_range (the
    frame header's last bit) is flipped: none of libaom's test vectors sets
    it, and the bits after it keep their places."""
    from mmtrs_tpu_torch.utils import avif as av

    bits = int(av.planes_of(avif)[1][13])
    data, props = cs._avif_item(avif)
    b = bytearray(data)
    at = 0
    while at < len(b):  # the OBUs: the frame's payload
        kind, p = (b[at] >> 3) & 15, at + 1 + ((b[at] >> 2) & 1)
        size = shift = 0
        while True:
            size |= (b[p] & 127) << shift
            shift += 7
            p += 1
            if not b[p - 1] & 128:
                break
        if kind == 6:
            b[p + (bits - 1) // 8] ^= 0x80 >> ((bits - 1) % 8)
        at = p + size
    return cs._avif_file([{"id": 1, "type": b"av01", "data": bytes(b), "props": props}], 1)


def golden_files() -> dict[str, bytes]:
    """Every golden, by name (each at most 130 × 128)."""
    out = {}
    odd, mid, small = photo(45, 67, 5), photo(97, 130, 4), photo(64, 80, 4)
    # premultiplied alpha
    out["prem_420_67x45.avif"] = _save(rgba(odd), alpha_premultiplied=True)
    out["prem_444_67x45.avif"] = _save(rgba(odd), subsampling="4:4:4", alpha_premultiplied=True)
    out["prem_q40_80x64.avif"] = _save(rgba(small), quality=40, alpha_premultiplied=True)
    out["prem_grid_2x2_128x128.avif"] = cs._avif_rgba_grid(_save(rgba(photo(64, 64, 6)), alpha_premultiplied=True),
                                                           2, 2, True)
    out["rgba_grid_2x2_128x128.avif"] = cs._avif_rgba_grid(_save(rgba(photo(64, 64, 6))), 2, 2, False)
    frames = [rgba(photo(48, 64, s)) for s in range(3)]
    out["prem_animated_64x48.avif"] = _animated(frames, alpha_premultiplied=True, quality=50)
    # quantiser matrices
    for lo, hi in ((0, 3), (4, 7), (8, 11), (12, 15)):
        out[f"qm_{lo}_{hi}_80x64.avif"] = _save(small, advanced=[("enable-qm", "1"), ("qm-min", str(lo)),
                                                                 ("qm-max", str(hi))])
    out["qm_0_15_130x97.avif"] = _save(mid, advanced=[("enable-qm", "1"), ("qm-min", "0"), ("qm-max", "15")])
    out["qm_q30_444_67x45.avif"] = _save(odd, quality=30, subsampling="4:4:4", advanced=[("enable-qm", "1")])
    out["tune_iq_420_130x97.avif"] = _save(mid, advanced=[("tune", "iq")])
    for sub in ("4:4:4", "4:0:0"):
        out[f"tune_iq_{sub.replace(':', '')}_80x64.avif"] = _save(small, subsampling=sub, advanced=[("tune", "iq")])
    # film grain
    for v in range(1, 17):
        out[f"grain_test{v}_64x48.avif"] = _save(photo(48, 64, 7), advanced=[("film-grain-test", str(v))])
    for sub, v in (("4:4:4", 3), ("4:2:2", 10), ("4:0:0", 16)):
        out[f"grain_test{v}_{sub.replace(':', '')}_67x45.avif"] = _save(odd, subsampling=sub,
                                                                         advanced=[("film-grain-test", str(v))])
    out["grain_denoise10_128x96.avif"] = _save(noisy(96, 128, 8), advanced=[("denoise-noise-level", "10")])
    out["grain_denoise25_444_128x96.avif"] = _save(noisy(96, 128, 9), subsampling="4:4:4",
                                                   advanced=[("denoise-noise-level", "25")])
    out["grain_test1_restricted_64x48.avif"] = with_restricted_grain(out["grain_test1_64x48.avif"])
    out["grain_test16_restricted_444_67x45.avif"] = with_restricted_grain(_save(odd, subsampling="4:4:4",
                                                                                advanced=[("film-grain-test", "16")]))
    out["grain_qm_80x64.avif"] = _save(small, advanced=[("film-grain-test", "7"), ("enable-qm", "1")])
    # libavif's own conversion: nclx boxes rewritten
    tiny = photo(37, 49, 5)
    s420, s444 = _save(tiny), _save(tiny, subsampling="4:4:4")
    for name, (cp, mc, full) in {"fcc": (1, 4, 1), "fcc_limited": (1, 4, 0), "smpte240": (1, 7, 1),
                                 "smpte240_limited": (1, 7, 0), "ycgco": (1, 8, 1), "matrix15": (1, 15, 0),
                                 "cdnc_p3": (12, 12, 1), "cdnc_ebu_limited": (22, 12, 0),
                                 "bt2020_limited": (9, 9, 0), "cdnc_bt709": (1, 12, 1)}.items():
        out[f"nclx_{name}_420_49x37.avif"] = with_nclx(s420, cp, mc, full)
        out[f"nclx_{name}_444_49x37.avif"] = with_nclx(s444, cp, mc, full)
    out["nclx_identity_limited_444_49x37.avif"] = with_nclx(s444, 1, 0, 0)
    out["nclx_fcc_422_49x37.avif"] = with_nclx(_save(tiny, subsampling="4:2:2"), 1, 4, 1)
    # frames of another size than their ispe (or tkhd)
    base, base444 = _save(photo(48, 64, 3)), _save(photo(48, 64, 3), subsampling="4:4:4")
    for w, h in ((48, 36), (32, 24), (24, 18), (16, 12), (40, 30), (128, 96), (100, 70), (65, 47), (64, 20)):
        out[f"ispe_{w}x{h}_of_64x48.avif"] = with_ispe(base, w, h)
    out["ispe_444_80x60_of_64x48.avif"] = with_ispe(base444, 80, 60)
    tile = with_ispe(_save(photo(96, 128, 4)), 64, 64)
    out["ispe_grid_2x2_of_64x64_tiles_128x128.avif"] = cs._avif_grid([tile], 2, 2)
    anim = _animated([Image.fromarray(photo(48, 64, s)) for s in range(3)], quality=50)
    out["tkhd_48x36_of_64x48.avif"] = with_tkhd_size(anim, 48, 36)
    # sequences from their track
    out["track_colr_bt709_limited_64x48.avif"] = with_track_colr(anim, 1, 0)
    out["track_without_pitm_64x48.avif"] = retype(anim, b"pitm", b"free")
    mixed = mixed_sequence(anim, _save(photo(48, 64, 9)))
    out["track_over_its_item_64x48.avif"] = mixed
    out["item_under_major_avif_64x48.avif"] = with_brands(mixed, b"avif", [b"avif", b"avis", b"mif1", b"miaf"])
    out["track_under_major_mif1_64x48.avif"] = with_brands(mixed, b"mif1", [b"avif", b"avis", b"mif1", b"miaf"])
    out["track_without_meta_64x48.avif"] = with_brands(retype(mixed, b"meta", b"free"), b"avis",
                                                       [b"avis", b"msf1", b"iso8", b"miaf"])
    return out


def upload_files() -> dict[str, bytes]:
    """The card's files (no Pillow there to write them): the 1024 × 768
    phone photo with film-grain-test vector 10 (its 4 × 4 grid of copies is
    the 12 MP grain file), with tune=iq, and as premultiplied RGBA (its
    4 × 4 RGBA grid is the 12 MP premultiplied file)."""
    phone = _phone()
    return {cs.AVIF3_UPLOAD_FILES["avif_film_grain"]: _save(phone, advanced=[("film-grain-test", "10")]),
            cs.AVIF3_UPLOAD_FILES["avif_qm"]: _save(phone, advanced=[("tune", "iq")]),
            cs.AVIF3_UPLOAD_FILES["avif_premultiplied"]: _save(rgba(phone), alpha_premultiplied=True)}


def write_goldens(path=GOLDENS) -> int:
    files = golden_files()
    arrays = {}
    for name, data in sorted(files.items()):
        arrays[name] = np.frombuffer(data, np.uint8)
        arrays[f"{name}.pil"] = _pillow(data)[1]
    np.savez_compressed(path, **arrays)
    np.savez_compressed(cs.AVIF3_UPLOADS, **{k: np.frombuffer(v, np.uint8) for k, v in upload_files().items()})
    return len(files)


def _golden_names() -> list[str]:
    if not GOLDENS.exists():  # before the first ``python -m tests.test_torch_codec_avif3``
        return []
    with np.load(GOLDENS) as z:
        return sorted(f for f in z.files if not f.endswith(".pil"))


@pytest.fixture(scope="module")
def goldens():
    with np.load(GOLDENS) as z:
        return {f: z[f] for f in z.files}


def test_goldens_are_small_and_regenerate_bit_for_bit():
    """The committed file is under 1 MiB, each golden at most 130 × 128
    pixels, and holds what the writers above and Pillow 12.1 give now."""
    assert GOLDENS.stat().st_size < 1 << 20
    fresh = golden_files()
    with np.load(GOLDENS) as z:
        assert sorted(fresh) == _golden_names()
        for name, data in fresh.items():
            assert z[name].tobytes() == data, name
            rgb = z[f"{name}.pil"]
            assert rgb.shape[0] * rgb.shape[1] <= 130 * 128, name
            np.testing.assert_array_equal(_pillow(data)[1], rgb, err_msg=name)


@pytest.mark.parametrize("name", _golden_names())
def test_golden_decodes_as_pillow_with_dav1ds_planes(goldens, name):
    """The port's RGB equals Pillow's; its Y, U and V planes equal libavif's
    (dav1d's, film grain applied, scaled to the ispe)."""
    from mmtrs_tpu_torch.utils import avif

    data = goldens[name].tobytes()
    np.testing.assert_array_equal(_port(data), goldens[f"{name}.pil"])
    planes, _ = avif.planes_of(data)
    want = ao.decode(data)["planes"]
    assert len(planes) == len(want)
    for got, ref in zip(planes, want):
        np.testing.assert_array_equal(got, ref)


def test_goldens_use_the_tools_they_stand_for(goldens):
    """Each quantiser-matrix golden decodes with a matrix, each grain golden
    adds grain; the others use neither."""
    from mmtrs_tpu_torch.utils import avif

    for name in _golden_names():
        tools = avif.tools_of(avif.planes_of(goldens[name].tobytes())[1])
        qm, grain = bool(tools >> QM_BIT & 1), bool(tools >> GRAIN_BIT & 1)
        assert qm == name.startswith(("qm_", "tune_iq", "grain_qm")), name
        assert grain == name.startswith("grain_"), name


# the film grain parameters' kinds in dims[12] (csrc/host/av1.cpp)
GRAIN_KINDS = {"luma points": 1, "chroma points": 2, "chroma scaling from luma": 3, "overlap": 4,
               "restricted range": 5, "grain scale shift": 8}


def test_grain_goldens_cover_the_grain_parameters(goldens):
    """libaom's 16 test vectors and the denoised photographs set, between
    them, luma and chroma points, chroma scaling from luma, the overlap
    blend, a grain scale shift and AR lags 2 and 3; the clip to restricted
    range, which none of them sets, comes from two files with that bit
    flipped. (No writer here uses lags 0 and 1: the AR loops take the lag
    as a number.)"""
    from mmtrs_tpu_torch.utils import avif

    kinds, lags = 0, set()
    for name in _golden_names():
        if name.startswith("grain_"):
            g = int(avif.planes_of(goldens[name].tobytes())[1][12])
            assert g & 1, name
            kinds |= g
            lags.add(g >> 6 & 3)
    assert [k for k, bit in GRAIN_KINDS.items() if not kinds >> bit & 1] == [] and lags == {2, 3}


def test_unpremultiply_equals_libavif_on_every_value_and_alpha():
    """libavif's unpremultiply of Pillow's RGBA (libyuv's ARGBUnattenuate on
    this x86 CPU) on every (value, alpha) pair equals the port's, through
    the identity matrix at 4:4:4 (R = V, G = Y, B = U)."""
    from mmtrs_tpu_torch.utils.avif import unpremultiply

    v, a = (x.astype(np.uint8) for x in np.meshgrid(np.arange(256), np.arange(256), indexing="ij"))
    want = ao.yuv_to_rgb([v, v, v], ao.YUV444, 0, 1, alpha=a, premultiplied=True)
    got = unpremultiply(torch.from_numpy(np.stack([v, v, v], -1)), torch.from_numpy(a)).numpy()
    np.testing.assert_array_equal(got, want)
    plain = ao.yuv_to_rgb([v, v, v], ao.YUV444, 0, 1, alpha=a, premultiplied=False)
    np.testing.assert_array_equal(plain[..., 0], v)  # not premultiplied: the colour as it is


# (matrix, full range, colour primaries) swept over every triple: libavif's
# f32 path for FCC, YCgCo and chroma-derived NCL of P3 primaries
FLOAT_SWEEPS = [(4, 1, 2), (8, 1, 2), (12, 1, 12)]


@pytest.mark.parametrize("matrix,full,primaries", FLOAT_SWEEPS)
def test_libavif_float_conversion_equals_libavif_on_every_triple(matrix, full, primaries):
    """libavif's avifImageYUVToRGB of a 4096² 4:4:4 image holding every
    (Y, U, V) triple once equals the port's conversion."""
    from mmtrs_tpu_torch.utils.avif import yuv_to_rgb

    v = np.arange(1 << 24, dtype=np.uint32)
    planes = [(v >> s & 255).astype(np.uint8).reshape(4096, 4096) for s in (16, 8, 0)]
    got = yuv_to_rgb([torch.from_numpy(p) for p in planes], 0, 0, matrix, full, primaries).numpy()
    np.testing.assert_array_equal(got, ao.yuv_to_rgb(planes, ao.YUV444, matrix, full, primaries=primaries))


# the rest of the matrices libavif converts, on random triples: its f32
# path, and libyuv's for BT.2020 at limited range and for chroma-derived
# NCL of primaries libyuv has a matrix for (BT.709, unspecified as BT.709,
# BT.601, BT.2020)
MATRICES = [(4, 0, 2), (7, 1, 2), (7, 0, 2), (15, 1, 2), (15, 0, 2), (12, 0, 22), (12, 1, 30), (0, 0, 2), (9, 0, 2),
            (12, 1, 1), (12, 0, 2), (12, 1, 6), (12, 0, 5), (12, 1, 9)]


def test_conversions_of_every_other_matrix_equal_libavif():
    """Random 4:4:4, 4:2:0 and 4:2:2 planes at odd sizes, impulse planes
    among them: the port's conversion equals libavif's for every matrix and
    range it converts, by the route libavif takes."""
    from mmtrs_tpu_torch.utils.avif import yuv_to_rgb

    rng = np.random.default_rng(3)
    for fmt, (sx, sy) in ((ao.YUV444, (0, 0)), (ao.YUV420, (1, 1)), (ao.YUV422, (1, 0))):
        for h, w in ((1, 1), (2, 3), (7, 9), (45, 67), (256, 256)):
            y = rng.integers(0, 256, (h, w)).astype(np.uint8)
            uv = [rng.integers(0, 256, ((h + sy) >> sy, (w + sx) >> sx)).astype(np.uint8) for _ in range(2)]
            if h == 7:  # impulses: one sample of each plane at its extreme
                y[:] = 16
                for p in uv:
                    p[:] = 128
                y[3, 4], uv[0][1, 2], uv[1][-1, -1] = 235, 255, 0
            for matrix, full, cp in MATRICES + FLOAT_SWEEPS:
                if matrix == 0 and sx:
                    continue
                got = yuv_to_rgb([torch.from_numpy(p) for p in (y, *uv)], sx, sy, matrix, full, cp).numpy()
                want = ao.yuv_to_rgb([y, *uv], fmt, matrix, full, primaries=cp)
                np.testing.assert_array_equal(got, want, err_msg=f"{fmt} {h}x{w} {matrix} {full} {cp}")


def test_matrices_libavif_refuses_stay_refused_with_pillows_words():
    """Matrices 3, 10, 11, 13, 14 and 16 and up, YCgCo at limited range and
    the identity on subsampled chroma: libavif's Reformat fails, and the
    port refuses them naming it."""
    from mmtrs_tpu_torch.utils.avif import yuv_to_rgb

    y = np.full((4, 4), 100, np.uint8)
    uv = [np.full((2, 2), 120, np.uint8)] * 2
    for matrix, full in ((3, 1), (10, 1), (11, 0), (13, 1), (14, 1), (16, 1), (17, 0), (8, 0), (0, 1)):
        with pytest.raises(ValueError):
            ao.yuv_to_rgb([y, *uv], ao.YUV420, matrix, full)
        with pytest.raises(ValueError, match="Reformat failed"):
            yuv_to_rgb([torch.from_numpy(p) for p in (y, *uv)], 1, 1, matrix, full, 1)


def test_scaled_frames_equal_libavifs_planes():
    """A 4:2:0 frame of 64 × 48 under ispe sizes of every libyuv scale path
    (copy, vertical, 3/4, 1/2, 3/8, 1/4, box, 2x bilinear, bilinear up and
    down, point sampling at a side of 1): the port's planes equal libavif's
    scaled ones."""
    from mmtrs_tpu_torch.utils import avif

    base = _save(photo(48, 64, 3))
    for w, h in ((64, 96), (64, 24), (48, 36), (32, 24), (24, 18), (16, 12), (12, 9), (128, 96), (127, 95),
                 (200, 30), (70, 47), (21, 16), (1, 1), (64, 1), (1, 48), (192, 144)):
        data = with_ispe(base, w, h)
        got = avif.planes_of(data)[0]
        for g, r in zip(got, ao.decode(data)["planes"]):
            np.testing.assert_array_equal(g, r, err_msg=f"{w}x{h}")


def test_sequence_source_follows_libavifs_automatic_choice(goldens):
    """The primary item and the track's first sample hold different
    pictures: major brand avis, or another brand with tracks, decodes the
    track; major brand avif the item; without pitm or meta the track."""
    track = goldens["track_over_its_item_64x48.avif.pil"]
    item = goldens["item_under_major_avif_64x48.avif.pil"]
    assert not np.array_equal(track, item)
    for name in ("track_under_major_mif1_64x48.avif", "track_without_meta_64x48.avif",
                 "track_without_pitm_64x48.avif"):
        np.testing.assert_array_equal(goldens[f"{name}.pil"], track)
    np.testing.assert_array_equal(_port(goldens["item_under_major_avif_64x48.avif"].tobytes()), item)


# cuts and mutations of these goldens (the seed of _mutations(golden, seed,
# 40), the file's index) that the slice's first decoder read otherwise than
# Pillow: an iref of another version (libavif skips its references), an
# alpha item retyped (skipped) or of another av1C depth than its pixi, a
# track's sample description of version 1 and its auxi box of version 1, a
# sequence header without its trailing bit (dav1d refuses it), a grid tile
# whose sequence header is damaged (libavif's one dav1d decoder keeps the
# previous tile's)
MUTATED = [("prem_420_67x45.avif", 2058, 41), ("prem_q40_80x64.avif", 2062, 31), ("prem_q40_80x64.avif", 2062, 47),
           ("prem_420_67x45.avif", 4058, 22), ("track_colr_bt709_limited_64x48.avif", 2071, 18),
           ("prem_animated_64x48.avif", 4060, 30), ("nclx_smpte240_limited_420_49x37.avif", 2054, 46),
           ("prem_grid_2x2_128x128.avif", 4061, 10)]


@pytest.mark.parametrize("name,seed,k", MUTATED)
def test_mutated_goldens_agree_with_pillow(goldens, name, seed, k):
    """The port decodes equal to Pillow, or both refuse."""
    from tests.test_torch_codec_avif import _mutations

    data = _mutations(goldens[name].tobytes(), seed, 40)[k]
    want = _pillow_or_none(data)
    if want is None:
        with pytest.raises(ValueError):
            _port(data)
    else:
        np.testing.assert_array_equal(_port(data), want[1])


def test_grid_tile_without_its_sequence_header_takes_the_previous_tiles():
    """libavif decodes a grid's tiles in order on one dav1d decoder: a tile
    whose data holds no sequence header decodes with the previous tile's,
    as Pillow's does; the first tile without one fails in both."""
    from mmtrs_tpu_torch.utils.avif import _obus

    parts = [cs._avif_item(_save(photo(64, 64, 10 + k))) for k in range(4)]
    grid = bytes([0, 1, 1, 1]) + struct.pack(">II", 128, 128)
    head = [{"id": 1, "type": b"grid", "data": grid, "idat": True,
             "props": [cs._fullbox(b"ispe", 0, 0, struct.pack(">II", 128, 128))]
             + [p for p in parts[0][1] if p[4:8] in (b"pixi", b"colr")]}]
    for which in (0, 2):
        items = head + [{"id": k + 2, "type": b"av01", "hidden": True, "props": props,
                         "data": d if k != which else b"".join(d[s:e] for t, s, e in _obus(d) if t != 1)}
                        for k, (d, props) in enumerate(parts)]
        data = cs._avif_file(items, 1, [(b"dimg", 1, [2, 3, 4, 5])])
        if which == 0:
            assert _pillow_or_none(data) is None
            with pytest.raises(ValueError):
                _port(data)
        else:
            np.testing.assert_array_equal(_port(data), _pillow(data)[1])


def test_card_uploads_regenerate_and_decode_as_pillow():
    """The card's files are what Pillow writes now and decode equal to
    Pillow with the tools they stand for; the 4 × 4 RGBA grid of the
    premultiplied upload and the grain upload's 4 × 4 grid are 12 MP files
    the port decodes (their 2 × 2 grids equal Pillow's decode)."""
    from mmtrs_tpu_torch.utils import avif

    fresh = upload_files()
    with np.load(cs.AVIF3_UPLOADS) as z:
        assert sorted(z.files) == sorted(fresh)
        for name, data in fresh.items():
            assert z[name].tobytes() == data, name
    bits = {"avif_film_grain": GRAIN_BIT, "avif_qm": QM_BIT, "avif_premultiplied": None}
    for fam, name in cs.AVIF3_UPLOAD_FILES.items():
        data = fresh[name]
        np.testing.assert_array_equal(_port(data), _pillow(data)[1], err_msg=name)
        assert bits[fam] is None or avif.tools_of(avif.planes_of(data)[1]) >> bits[fam] & 1, name
    grain = cs._avif_grid([fresh[cs.AVIF3_UPLOAD_FILES["avif_film_grain"]]], 2, 2)
    prem = cs._avif_rgba_grid(fresh[cs.AVIF3_UPLOAD_FILES["avif_premultiplied"]], 2, 2, True)
    for data in (grain, prem):
        got = _port(data)
        assert got.shape == (1536, 2048, 3)
        np.testing.assert_array_equal(got, _pillow(data)[1])


if __name__ == "__main__":
    print(f"wrote {write_goldens()} goldens to {GOLDENS}")
