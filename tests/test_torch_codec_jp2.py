"""JPEG 2000 through the port's own decoder (``csrc/host/jp2.cpp``) against
Pillow 12.1 (OpenJPEG 2.5.4): every golden decodes to Pillow's
``convert("RGB")`` bit for bit on the CPU route and sniffs as "JPEG2000";
files Pillow refuses are refused by name; cut and mutated codestreams and
.jp2 files agree with Pillow (both decode equal, or both refuse); an ICNS
with a JPEG 2000 entry.

The goldens (``mmtrs_tpu_torch/testdata/jp2_goldens.npz``) are written by
``python -m tests.test_torch_codec_jp2``: Pillow's ``save`` for what it
writes (modes L, LA, RGB, RGBA and I;16 in .jp2 and raw codestreams, the
5/3 and 9/7 wavelets, quality layers, every progression order, tiles,
precincts, code-block sizes, offsets, no component transform, signed
samples, PLT and COM markers), OpenJPEG's encoder through
``tests/jp2_streams.py`` for what it hides (every code-block style, POC,
SOP and EPH, tile-parts, 12- and 16-bit and signed samples, CMYK and sYCC
colour boxes), and codestream rewrites for PPM and PPT. Each golden holds
Pillow's decode, which the card's machine (no Pillow) reads back.
"""

from __future__ import annotations

import io
import struct
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from tests import jp2_streams as js

ROOT = Path(__file__).resolve().parents[1]
GOLDENS = ROOT / "mmtrs_tpu_torch" / "testdata" / "jp2_goldens.npz"


def _image(h: int, w: int, c: int, seed: int) -> np.ndarray:
    """Ramps with noise: every band and bit-plane carries data."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    ramps = [xx * 5 + yy, yy * 4 + 40, (xx + yy) * 3, 255 - xx * 2]
    px = np.stack([ramps[k % 4] for k in range(c)], -1) + rng.integers(-20, 20, (h, w, c))
    return px.clip(0, 255).astype(np.uint8)


def _save(img: Image.Image, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, "JPEG2000", **kw)
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


def _with_colr(jp2: bytes, enumcs: int) -> bytes:
    """A .jp2 with its colr box's EnumCS replaced."""
    at = jp2.index(b"colr") + 4
    return jp2[:at + 3] + struct.pack(">I", enumcs) + jp2[at + 7:]


def _pclr(jp2: bytes, palette: list[tuple[int, int, int]]) -> bytes:
    """A one-component .jp2 with a pclr box (8-bit RGB entries) added to its
    jp2h, which makes Pillow open it as mode P."""
    body = struct.pack(">HB", len(palette), 3) + bytes([7, 7, 7]) + b"".join(bytes(c) for c in palette)
    box = struct.pack(">I4s", 8 + len(body), b"pclr") + body
    at = jp2.index(b"jp2h") - 4
    n = struct.unpack(">I", jp2[at:at + 4])[0]
    return jp2[:at] + struct.pack(">I", n + len(box)) + jp2[at + 4:at + n] + box + jp2[at + n:]


def golden_files() -> dict[str, bytes]:
    """Every golden file, by name."""
    rgb, rgba, gray = _image(45, 61, 3, 80), _image(37, 53, 4, 81), _image(41, 39, 1, 82)[..., 0]
    la = _image(29, 33, 2, 83)
    out = {}
    for ext, no_jp2 in (("jp2", False), ("j2k", True)):
        out[f"pil_l_53.{ext}"] = _save(Image.fromarray(gray), no_jp2=no_jp2)
        out[f"pil_la_53.{ext}"] = _save(Image.fromarray(la, "LA"), no_jp2=no_jp2)
        out[f"pil_rgb_53.{ext}"] = _save(Image.fromarray(rgb), no_jp2=no_jp2)
        out[f"pil_rgba_53.{ext}"] = _save(Image.fromarray(rgba), no_jp2=no_jp2)
        out[f"pil_i16_53.{ext}"] = _save(Image.fromarray(gray.astype(np.uint16) * 257, "I;16"), no_jp2=no_jp2)
        out[f"pil_rgb_97_layers.{ext}"] = _save(Image.fromarray(rgb), no_jp2=no_jp2, irreversible=True,
                                                quality_layers=[40, 12, 4])
    out["pil_l_97.j2k"] = _save(Image.fromarray(gray), no_jp2=True, irreversible=True, quality_layers=[10])
    out["pil_la_97.jp2"] = _save(Image.fromarray(la, "LA"), irreversible=True, quality_layers=[8])
    out["pil_rgba_97.jp2"] = _save(Image.fromarray(rgba), irreversible=True, quality_layers=[16, 4])
    for order in js.PROGRESSIONS:
        out[f"pil_rgb_{order.lower()}_tiles.j2k"] = _save(
            Image.fromarray(rgb), no_jp2=True, progression=order, tile_size=(32, 24), codeblock_size=(16, 16),
            precinct_size=(32, 32), quality_layers=[30, 10, 1], irreversible=order in ("RPCL", "CPRL"))
    out["pil_rgb_mct0.j2k"] = _save(Image.fromarray(rgb), no_jp2=True, mct=0)
    out["pil_rgb_signed.j2k"] = _save(Image.fromarray(rgb), no_jp2=True, signed=True)
    out["pil_rgb_offsets.j2k"] = _save(Image.fromarray(rgb), no_jp2=True, offset=(7, 3), tile_offset=(2, 1),
                                       tile_size=(20, 17))
    out["pil_rgb_plt_comment.jp2"] = _save(Image.fromarray(rgb), plt=True, comment=b"a comment", num_resolutions=3)
    out["pil_l_one_resolution.j2k"] = _save(Image.fromarray(gray), no_jp2=True, num_resolutions=1)
    # OpenJPEG's encoder, for the settings Pillow hides
    for name, mode in (("bypass", js.BYPASS), ("reset", js.RESET), ("termall", js.TERMALL), ("vsc", js.VSC),
                       ("pterm", js.PTERM), ("segsym", js.SEGSYM), ("all_styles", 63)):
        out[f"opj_rgb_{name}.j2k"] = js.openjpeg_encode(rgb, mode=mode, rates=(20, 6, 1), cblk=(16, 16))
    out["opj_rgb_97_all_styles.j2k"] = js.openjpeg_encode(rgb, mode=63, rates=(20, 5), irreversible=True)
    out["opj_rgb_poc.j2k"] = js.openjpeg_encode(rgb, rates=(20, 6, 1), pocs=((0, 0, 2, 3, 3, "RPCL"),
                                                                              (0, 0, 3, 6, 3, "CPRL")))
    out["opj_rgb_sop_eph.j2k"] = js.openjpeg_encode(rgb, csty=js.SOP | js.EPH, rates=(10, 1))
    for flag in "RLC":
        out[f"opj_rgb_tile_parts_{flag}.j2k"] = js.openjpeg_encode(rgb, tile=(32, 32), tile_parts=flag,
                                                                   rates=(20, 6, 1))
    sop_eph = js.openjpeg_encode(rgb, csty=js.SOP | js.EPH, tile=(32, 32), rates=(12, 1))
    out["opj_rgb_ppt.j2k"] = js.to_ppt(sop_eph)
    out["opj_rgb_ppm.j2k"] = js.to_ppm(sop_eph)
    wide = gray.astype(np.int32)
    out["opj_l_12bit.j2k"] = js.openjpeg_encode(wide * 16 + 7, prec=12)
    out["opj_l_16bit.jp2"] = js.openjpeg_encode(wide * 257, prec=16, jp2=True)
    out["opj_l_12bit_signed.j2k"] = js.openjpeg_encode(wide * 16 - 2048, prec=12, signed=True)
    out["opj_rgb_12bit_97.j2k"] = js.openjpeg_encode(rgb.astype(np.int32) * 16, prec=12, irreversible=True,
                                                     rates=(8,))
    out["opj_rgb_4bit.j2k"] = js.openjpeg_encode(rgb >> 4, prec=4)
    out["opj_rgb_signed_97.j2k"] = js.openjpeg_encode(rgb.astype(np.int32) - 128, signed=True, irreversible=True,
                                                      rates=(6,))
    out["opj_cmyk.jp2"] = _with_colr(js.openjpeg_encode(rgba, jp2=True, mct=0), 12)
    out["opj_sycc.jp2"] = _with_colr(js.openjpeg_encode(rgb, jp2=True, mct=0), 18)
    out["opj_rgb_unknown_enumcs.jp2"] = _with_colr(js.openjpeg_encode(rgb, jp2=True), 99)  # read as unspecified
    # Pillow reads a palette image only in an sRGB colour box; an index past the palette is black
    out["pil_p_palette.jp2"] = _pclr(_with_colr(_save(Image.fromarray(gray >> 3)), 16),
                                     [(i * 8, 255 - i * 5, (i * 37) % 256) for i in range(28)] + [(8, 255, 37)] * 2)
    return out


def refused_files() -> dict[str, tuple[bytes, str]]:
    """Files Pillow refuses too, and the words the port's error holds."""
    rgb = _image(45, 61, 3, 84)
    jp2 = _save(Image.fromarray(rgb))
    j2k = _save(Image.fromarray(rgb), no_jp2=True)
    at = jp2.index(b"ihdr") + 8
    wider = jp2[:at] + struct.pack(">I", 62) + jp2[at + 4:]
    return {
        "jp2_cut": (jp2[:len(jp2) // 2], "JPEG 2000"),
        "j2k_cut_in_header": (j2k[:60], "JPEG 2000"),
        "j2k_cut": (j2k[:len(j2k) - 300], "JPEG 2000"),
        "jp2_ihdr_wider": (wider, "another size"),
        "jp2_eycc": (_with_colr(jp2, 24), "JPEG 2000"),
        "jp2_la_of_rgb": (jp2.replace(b"ihdr" + jp2[at - 4:at + 4] + b"\x00\x03",
                                      b"ihdr" + jp2[at - 4:at + 4] + b"\x00\x02"), "JPEG 2000"),
    }


def _phone() -> np.ndarray:
    """The 1024 × 768 phone photo the card's machine uploads (the WebP
    golden, which the port decodes equal to Pillow)."""
    with np.load(ROOT / "mmtrs_tpu_torch" / "testdata" / "webp_goldens.npz") as z:
        return np.asarray(Image.open(io.BytesIO(z["phone_1024x768_q90.webp"].tobytes())).convert("RGB"))


def upload_files() -> dict[str, bytes]:
    """The card's 1024 × 768 uploads (no Pillow there to write them): .jp2
    5/3 and 9/7 at 20:1, one 1024 × 768 tile and 2 decomposition levels (4
    × 4 copies of its tile-part make a 12 MP codestream whose code-blocks
    fall as the upload's), a Huffman progressive JPEG without its last two
    scans (its luma left unrefined: libjpeg smooths it), and a lossless 5/3
    tile of 256 × 256 (16 × 12 copies: a 12 MP lossless codestream)."""
    from tests.test_torch_codec_corners import drop_scans

    phone = Image.fromarray(_phone())
    kw = {"tile_size": (1024, 768), "num_resolutions": 3, "quality_layers": [20]}
    buf = io.BytesIO()
    phone.save(buf, "JPEG", quality=75, progressive=True)
    jpeg = buf.getvalue()
    lossless = phone.crop((384, 256, 640, 512))  # one 256 x 256 tile: 16 x 12 of them make 12 MP
    return {"upload_53_1024x768.jp2": _save(phone, **kw), "upload_97_1024x768.jp2": _save(phone, irreversible=True, **kw),
            "upload_sof2_1024x768.jpg": drop_scans(jpeg, set(range(jpeg.count(b"\xff\xda") - 2))),
            "upload_53_lossless_tile_256.jp2": _save(lossless, tile_size=(256, 256), num_resolutions=3)}


def write_goldens(path: Path = GOLDENS) -> int:
    files = golden_files()
    arrays = {name: np.frombuffer(data, np.uint8) for name, data in upload_files().items()}
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


def _golden_names() -> list[str]:
    if not GOLDENS.exists():  # before the first ``python -m tests.test_torch_codec_jp2``
        return []
    with np.load(GOLDENS) as z:
        return sorted(f for f in z.files if not f.endswith((".pil", ".format", ".refused"))
                      and not f.startswith(("refused_", "upload_")))


@pytest.fixture(scope="module")
def goldens():
    with np.load(GOLDENS) as z:
        return {f: z[f] for f in z.files}


def test_goldens_are_small_and_regenerate_bit_for_bit():
    """The committed file is under 1.5 MB and holds what the writers above,
    OpenJPEG's encoder and Pillow 12.1 give now."""
    assert GOLDENS.stat().st_size < 1536 << 10
    fresh = golden_files()
    with np.load(GOLDENS) as z:
        assert sorted(fresh) == _golden_names()
        for name, data in fresh.items():
            assert z[name].tobytes() == data, name
            fmt, rgb = _pillow(data)
            np.testing.assert_array_equal(rgb, z[f"{name}.pil"], err_msg=name)
            assert fmt == z[f"{name}.format"].tobytes().decode(), name
        for case, (data, words) in refused_files().items():
            assert z[f"refused_{case}"].tobytes() == data and z[f"refused_{case}.refused"].tobytes() == words.encode()
        for name, data in upload_files().items():
            assert z[name].tobytes() == data, name


@pytest.mark.parametrize("name", sorted(["upload_53_1024x768.jp2", "upload_97_1024x768.jp2",
                                         "upload_sof2_1024x768.jpg", "upload_53_lossless_tile_256.jp2"]))
def test_card_uploads_decode_as_pillow(goldens, name):
    """The card's uploads decode equal to Pillow here (the smoothed SOF2 one
    through the own decoder, chosen from its scan headers)."""
    from mmtrs_tpu_torch.utils.codec import jpeg_goes_own

    data = goldens[name].tobytes()
    if name.endswith(".jpg"):
        assert jpeg_goes_own(data)
    np.testing.assert_array_equal(_port(data), _pillow(data)[1])


def test_a_grid_of_the_upload_tile_is_a_12mp_codestream(goldens):
    """chip_smoke.py's 12 MP codestream (4 × 4 copies of the upload's tile)
    decodes, each tile as the upload decodes, as Pillow decodes the grid
    (shown here on 2 × 2 to stay quick)."""
    import chip_smoke

    upload = goldens["upload_97_1024x768.jp2"].tobytes()
    big = chip_smoke._tiled_codestream(upload, 2, 2)
    got = _port(big)
    np.testing.assert_array_equal(got, _pillow(big)[1])
    np.testing.assert_array_equal(got[768:, 1024:], _port(upload))


@pytest.mark.parametrize("name", _golden_names())
def test_golden_decodes_and_sniffs_as_pillow(goldens, name):
    """Every golden: the port's decode on the CPU route equals Pillow's, bit
    for bit, and sniff names Pillow's format."""
    from mmtrs_tpu_torch.utils.codec import sniff

    data = goldens[name].tobytes()
    assert sniff(data) == goldens[f"{name}.format"].tobytes().decode() == "JPEG2000"
    np.testing.assert_array_equal(_port(data), goldens[f"{name}.pil"])


@pytest.mark.parametrize("case", sorted(refused_files()))
def test_pillow_refuses_and_the_port_names_the_variant(case):
    data, words = refused_files()[case]
    assert _pillow_or_none(data) is None
    with pytest.raises(ValueError, match=words):
        _port(data)


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


def _with_poc_order(data: bytes, entry: int, order: int) -> bytes:
    """``data`` with the progression order byte of its POC's ``entry`` set
    to ``order`` (one byte per component index: three components)."""
    at = data.find(b"\xff\x5f") + 4 + 7 * entry + 6
    return data[:at] + bytes([order]) + data[at + 1:]


@pytest.mark.parametrize("entry,order", [(0, 5), (1, 5), (1, 255), (1, 2)])
def test_poc_with_an_unknown_progression_order_decodes_as_openjpeg(goldens, entry, order):
    """A POC entry whose progression order byte is not 0-4 gives no packets
    (OpenJPEG's pi_next), so the tile's highest resolution read can fall
    short of its last: OpenJPEG reconstructs the tile at that resolution
    (``resno_decoded``) and hands the smaller image out at the top-left
    of Pillow's buffer (packed, read with Pillow's strides), the rest left
    zero. An unknown first entry makes
    both refuse. (1, 2): the second entry in RPCL, as a known order."""
    data = _with_poc_order(goldens["opj_rgb_poc.j2k"].tobytes(), entry, order)
    want = _pillow_or_none(data)
    if want is None:
        with pytest.raises(ValueError):
            _port(data)
        return
    got = _port(data)
    np.testing.assert_array_equal(got, want[1])
    if order > 4:
        assert (got == 0).mean() > 0.9  # a fraction of the samples: the lower resolutions' alone


MUTATED = ["pil_rgb_53.jp2", "pil_rgb_97_layers.j2k", "pil_rgb_rpcl_tiles.j2k", "opj_rgb_all_styles.j2k",
           "opj_rgb_ppm.j2k", "opj_rgb_sop_eph.j2k"]


@pytest.mark.parametrize("name", MUTATED)
def test_mutated_files_agree_with_pillow(goldens, name):
    """Cut and mutated goldens: where Pillow decodes, the port's decode is
    equal; where Pillow raises, the port raises a ValueError."""
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


def test_icns_with_a_jpeg2000_entry_decodes_as_pillow():
    """An ICNS whose 64 × 64 resource (icp6) is a .jp2 and whose 32 × 32
    one is a raw codestream: Pillow opens the largest, as JPEG 2000,
    converted to RGBA."""
    jp2 = _save(Image.fromarray(_image(64, 64, 4, 85)))
    j2k = _save(Image.fromarray(_image(32, 32, 3, 86)), no_jp2=True)
    res = b"icp6" + struct.pack(">I", 8 + len(jp2)) + jp2 + b"icp5" + struct.pack(">I", 8 + len(j2k)) + j2k
    icns = b"icns" + struct.pack(">I", 8 + len(res)) + res
    fmt, want = _pillow(icns)
    assert fmt == "ICNS"
    np.testing.assert_array_equal(_port(icns), want)
    small = b"icns" + struct.pack(">I", 16 + len(j2k)) + b"icp5" + struct.pack(">I", 8 + len(j2k)) + j2k
    np.testing.assert_array_equal(_port(small), _pillow(small)[1])


def test_decoder_refuses_a_bomb_before_allocating():
    """A SIZ that asks for more than MAX_PIXELS is refused as Pillow refuses
    it (DecompressionBombError), from the header alone."""
    from mmtrs_tpu_torch.utils.codec import MAX_PIXELS

    j2k = bytearray(_save(Image.fromarray(_image(16, 16, 1, 87)[..., 0]), no_jp2=True))
    side = int(MAX_PIXELS ** 0.5) + 2
    j2k[8:16] = struct.pack(">II", side, side)
    with pytest.raises(ValueError, match="exceeds the limit"):
        _port(bytes(j2k))


if __name__ == "__main__":
    print(f"wrote {write_goldens()} goldens to {GOLDENS}")
