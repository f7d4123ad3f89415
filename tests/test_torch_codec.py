"""The port's image codec (``utils/codec.py``) held against Pillow on the CPU.

JPEG decodes on the system libjpeg and must equal
``np.asarray(Image.open(...).convert("RGB"))`` bit for bit on every kind in
the committed goldens (``mmtrs_tpu_torch/testdata/codec_goldens.npz``,
which ``chip_smoke.py`` also holds the card's nvJPEG decode against); its
q95 encode must decode, in Pillow, to the pixels of Pillow's own q95
encode. PNG must be exact both ways, on every mode and filter type Pillow
writes.

Regenerate the goldens (JPEG bytes from Pillow, and Pillow's decode of
them) with ``python -m tests.test_torch_codec``.
"""

import io
import struct
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from mmtrs_tpu_torch.synth import synth_teeth
from tests.test_torch_codec_webp import _corrupt as _corrupt_webp

ROOT = Path(__file__).resolve().parents[1]
GOLDENS = ROOT / "mmtrs_tpu_torch" / "testdata" / "codec_goldens.npz"
GOLDEN_KINDS = ("teeth_q75_420", "teeth_q95_420", "teeth_q95_444", "teeth_q90_422", "teeth_progressive",
                "teeth_gray", "smooth_q95_420", "smooth_progressive_444", "phone_strip_q95_420", "teeth_cmyk",
                "teeth_ycck")


def _pil_jpeg(a: np.ndarray, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(a).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _pil_cmyk_jpeg(a: np.ndarray) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(a).convert("CMYK").save(buf, "JPEG", quality=90)
    return buf.getvalue()


def _pil_decode(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def _smooth(h: int, w: int) -> np.ndarray:
    """A smooth colour ramp with a hard-edged disc, no noise."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([255 * x / w, 255 * y / h, 128 + 100 * np.sin(x / 9.0) * np.cos(y / 7.0)], axis=-1)
    img[(y - h / 2) ** 2 + (x - w / 3) ** 2 < (min(h, w) / 4) ** 2] = (230, 40, 60)
    return np.clip(img, 0, 255).astype(np.uint8)


def make_goldens() -> dict[str, bytes]:
    """JPEG bytes of every golden kind, from Pillow: odd sizes (97×101,
    121×163, 45×61), q75 / q90 / q95, 4:2:0, 4:2:2, 4:4:4, progressive,
    grayscale, a 48-row strip of a 3024×4032 synthetic tooth, and CMYK
    (Pillow's) and YCCK (libjpeg's, through the small program of
    tests/test_torch_codec_formats.py) four-component files."""
    import tempfile

    from tests.test_torch_codec_formats import four_component_jpeg

    teeth = synth_teeth(1, (97, 101), seed=31, angles_deg=[20.0])[0]
    with tempfile.TemporaryDirectory() as d:
        ycck = four_component_jpeg(Path(d), teeth, "ycck")
    smooth = _smooth(121, 163)
    phone = synth_teeth(1, (3024, 4032), seed=32, angles_deg=[0.0])[0][1488:1536]
    return {
        "teeth_q75_420": _pil_jpeg(teeth, quality=75),
        "teeth_q95_420": _pil_jpeg(teeth, quality=95),
        "teeth_q95_444": _pil_jpeg(teeth, quality=95, subsampling=0),
        "teeth_q90_422": _pil_jpeg(teeth, quality=90, subsampling=1),
        "teeth_progressive": _pil_jpeg(teeth, quality=90, progressive=True),
        "teeth_gray": _pil_jpeg(np.ascontiguousarray(teeth[..., 1]), quality=90),
        "smooth_q95_420": _pil_jpeg(smooth, quality=95),
        "smooth_progressive_444": _pil_jpeg(_smooth(45, 61), quality=85, subsampling=0, progressive=True),
        "phone_strip_q95_420": _pil_jpeg(np.ascontiguousarray(phone), quality=95),
        "teeth_cmyk": _pil_cmyk_jpeg(teeth),
        "teeth_ycck": ycck,
    }


def load_goldens() -> dict[str, tuple[bytes, np.ndarray]]:
    with np.load(GOLDENS) as z:
        return {k: (z[f"{k}.jpg"].tobytes(), z[f"{k}.pil"]) for k in GOLDEN_KINDS}


def test_goldens_are_pillows_decode_of_their_bytes():
    goldens = load_goldens()
    assert sorted(goldens) == sorted(GOLDEN_KINDS)
    for name, (data, want) in goldens.items():
        np.testing.assert_array_equal(_pil_decode(data), want, err_msg=name)
    with Image.open(io.BytesIO(goldens["teeth_progressive"][0])) as im:
        assert im.info.get("progressive") and im.mode == "RGB"
    with Image.open(io.BytesIO(goldens["teeth_gray"][0])) as im:
        assert im.mode == "L"


@pytest.mark.parametrize("kind", GOLDEN_KINDS)
@pytest.mark.parametrize("source", ["bytes", "path"])
def test_jpeg_decode_equals_pillow(kind, source, tmp_path):
    from mmtrs_tpu_torch.utils.codec import decode_image

    data, want = load_goldens()[kind]
    if source == "path":
        p = tmp_path / f"{kind}.jpg"
        p.write_bytes(data)
        got = decode_image(p, "cpu")
    else:
        got = decode_image(data, "cpu")
    assert got.dtype == torch.uint8 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)


def test_decode_paths_equals_pillow_with_statuses(tmp_path):
    """The thread-pool decode: each JPEG equal to Pillow's, a missing file
    and a corrupt one status 2, a decoded image below ``min_edge`` status 1."""
    from mmtrs_tpu_torch.utils.codec import decode_paths

    goldens = load_goldens()
    paths = []
    for k in GOLDEN_KINDS:
        paths.append(tmp_path / f"{k}.jpg")
        paths[-1].write_bytes(goldens[k][0])
    (tmp_path / "bad.jpg").write_bytes(b"\xff\xd8\xff" + b"\x00" * 64)
    paths += [tmp_path / "bad.jpg", tmp_path / "missing.jpg"]
    imgs, status = decode_paths(paths, threads=3)
    assert list(status) == [0] * len(GOLDEN_KINDS) + [2, 2]
    for k, img in zip(GOLDEN_KINDS, imgs):
        np.testing.assert_array_equal(img.numpy(), goldens[k][1], err_msg=k)
    assert imgs[-1] is None and imgs[-2] is None
    _, status = decode_paths(paths[:2], min_edge=98)
    assert list(status) == [1, 1]  # 97×101: the shorter edge is 97
    assert decode_paths([])[0] == []


@pytest.mark.parametrize("size", [(97, 101), (512, 512), (16, 24)])
def test_jpeg_encode_q95_decodes_as_pillows(size):
    """The port's q95 JPEG, decoded by Pillow, equals Pillow's q95 JPEG of
    the same image decoded by Pillow (the bytes may differ)."""
    from mmtrs_tpu_torch.utils.codec import encode_jpeg

    img = synth_teeth(1, size, seed=41)[0]
    ours = encode_jpeg(img, 95)
    np.testing.assert_array_equal(_pil_decode(ours), _pil_decode(_pil_jpeg(img, quality=95)))
    np.testing.assert_array_equal(_pil_decode(encode_jpeg(torch.from_numpy(img), 95)), _pil_decode(ours))
    np.testing.assert_array_equal(_pil_decode(encode_jpeg(img, 75)), _pil_decode(_pil_jpeg(img, quality=75)))


def _png_filter_types(data: bytes) -> set[int]:
    """The filter type of every row of a non-interlaced PNG."""
    pos, idat, header = 8, [], None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        pos += 12 + n
    w, h, depth, ctype = header[:4]
    ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    stride = (w * ch * depth + 7) // 8
    raw = zlib.decompress(b"".join(idat))
    return {raw[y * (stride + 1)] for y in range(h)}


def _pillow_pngs() -> list[tuple[str, bytes]]:
    img = Image.fromarray(synth_teeth(1, (97, 101), seed=51, angles_deg=[10.0])[0])
    rgba = np.dstack([np.asarray(img), np.arange(97 * 101, dtype=np.uint8).reshape(97, 101)])
    ims = {
        "RGB": img,
        "RGBA": Image.fromarray(rgba),
        "L": img.convert("L"),
        "LA": Image.fromarray(rgba).convert("LA"),
        "P": img.quantize(200),
        "P16": img.quantize(12),  # 4 bits a pixel
        "P2": img.quantize(2),  # 1 bit a pixel
        "1": img.convert("1"),
    }
    out = []
    for mode, im in ims.items():
        for optimize in (False, True):
            buf = io.BytesIO()
            im.save(buf, "PNG", optimize=optimize)
            out.append((f"{mode}-{optimize}", buf.getvalue()))
    return out


def test_png_decode_equals_pillow_on_every_mode_and_filter():
    """RGB, RGBA, L, LA and P (8, 4 and 1 bits) and 1-bit gray, with
    ``optimize`` off and on: equal to Pillow's ``convert("RGB")``; Pillow's
    files use all five filter types between them."""
    from mmtrs_tpu_torch.utils.codec import decode_image

    filters = set()
    for name, data in _pillow_pngs():
        got = decode_image(data, "cpu")
        np.testing.assert_array_equal(got.numpy(), _pil_decode(data), err_msg=name)
        filters |= _png_filter_types(data)
    assert filters == {0, 1, 2, 3, 4}


@pytest.mark.parametrize("size", [(97, 101), (1, 1), (512, 688)])
def test_png_encode_round_trips_exactly(size):
    from mmtrs_tpu_torch.utils.codec import decode_image, encode_png

    img = synth_teeth(1, size, seed=61)[0] if min(size) > 1 else np.array([[[7, 200, 255]]], np.uint8)
    data = encode_png(img)
    np.testing.assert_array_equal(_pil_decode(data), img)
    np.testing.assert_array_equal(decode_image(data, "cpu").numpy(), img)
    with Image.open(io.BytesIO(data)) as im:
        assert im.mode == "RGB" and im.size == (size[1], size[0])
    np.testing.assert_array_equal(_pil_decode(encode_png(img[::-1, ::-1])), img[::-1, ::-1])


def _bad_inputs() -> dict[str, tuple[bytes, str]]:
    teeth = synth_teeth(1, (97, 101), seed=71)[0]
    jpg = _pil_jpeg(teeth, quality=90)
    png = io.BytesIO()
    Image.fromarray(teeth).save(png, "PNG")
    png = png.getvalue()
    cmyk, deep, bmp = (io.BytesIO() for _ in range(3))
    Image.fromarray(teeth).convert("CMYK").save(cmyk, "JPEG")  # cut in half below
    # a non-interlaced stream under IHDR's interlace flag: Adam7's passes
    # need more rows than it holds
    ihdr = png[16:29][:12] + b"\x01"
    interlaced = png[:16] + ihdr + struct.pack(">I", zlib.crc32(b"IHDR" + ihdr)) + png[33:]
    Image.fromarray((teeth[..., 0].astype(np.uint16) * 257)).save(deep, "PNG")
    # 16 bits a sample under colour type 3 (palette), which PNG forbids
    ihdr16 = deep.getvalue()[16:29][:9] + b"\x03" + deep.getvalue()[16:29][10:]
    deep = deep.getvalue()[:16] + ihdr16 + struct.pack(">I", zlib.crc32(b"IHDR" + ihdr16)) + deep.getvalue()[33:]
    Image.fromarray(teeth[..., 0]).save(bmp, "BMP")  # 8-bit; its compression field set to BI_JPEG below
    webp = _corrupt_webp()
    return {
        "garbage": (b"not an image at all", "cannot identify"),
        "empty": (b"", "cannot identify"),
        "jpeg_truncated": (jpg[: len(jpg) // 2], "corrupt or truncated JPEG"),
        "jpeg_header_only": (jpg[:20], "corrupt or truncated JPEG"),
        "png_truncated": (png[: len(png) // 2], "PNG"),
        "png_bad_crc": (png[:40] + bytes([png[40] ^ 1]) + png[41:], "CRC"),
        "jpeg_cmyk": (cmyk.getvalue()[: len(cmyk.getvalue()) // 2], "corrupt or truncated JPEG"),
        "png_interlaced": (interlaced, "truncated PNG|unknown filter type"),
        "png_16bit": (deep, "colour type 3 at 16 bits"),
        "bmp": (bmp.getvalue()[:30] + struct.pack("<I", 4) + bmp.getvalue()[34:], "BMP compression 4"),
        "webp": (webp["truncated_vp8"], "truncated WebP"),
        "webp_truncated_vp8l": (webp["truncated_vp8l"], "truncated WebP"),
    }


@pytest.mark.parametrize("case", ["garbage", "empty", "jpeg_truncated", "jpeg_header_only", "png_truncated",
                                  "png_bad_crc", "jpeg_cmyk", "png_interlaced", "png_16bit", "bmp", "webp",
                                  "webp_truncated_vp8l"])
def test_corrupt_and_unsupported_inputs_raise(case):
    """Corrupt bytes raise (a cut CMYK JPEG, an interlace flag on a
    non-interlaced stream, 16-bit palette samples, lossy and lossless WebP
    bitstreams that end early); a compression Pillow reads and the codec
    does not raises with its name."""
    from mmtrs_tpu_torch.utils.codec import decode_image

    data, msg = _bad_inputs()[case]
    with pytest.raises(ValueError, match=msg):
        decode_image(data, "cpu")


def test_jpeg_has_end_finds_streams_cut_in_their_last_scan():
    """The card's decode refuses a JPEG with no EOI after its last scan
    (nvJPEG decodes one without an error): every golden has its end, and
    each cut of a baseline and a progressive one inside or after its scans,
    which libjpeg refuses, has none."""
    from mmtrs_tpu_torch.utils.codec import decode_image, jpeg_has_end

    goldens = load_goldens()
    assert all(jpeg_has_end(data) for data, _ in goldens.values())
    for kind in ("teeth_q95_420", "teeth_progressive"):
        data = goldens[kind][0]
        first_scan = data.find(b"\xff\xda")
        for cut in (first_scan + 40, (first_scan + len(data)) // 2, len(data) - 2):
            assert not jpeg_has_end(data[:cut]), (kind, cut)
            with pytest.raises(ValueError, match="corrupt or truncated"):
                decode_image(data[:cut], "cpu")
    assert not jpeg_has_end(b"\xff\xd8\xff\xd9")


def test_decode_wants_the_card_by_default():
    from mmtrs_tpu_torch.utils.codec import decode_image

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        decode_image(load_goldens()["teeth_q95_420"][0])


if __name__ == "__main__":
    import tempfile

    from tests.test_torch_codec_formats import host_goldens

    goldens = make_goldens()
    arrays = {}
    for k in GOLDEN_KINDS:
        arrays[f"{k}.jpg"] = np.frombuffer(goldens[k], np.uint8)
        arrays[f"{k}.pil"] = _pil_decode(goldens[k])
    with tempfile.TemporaryDirectory() as d:  # the host formats, under host/
        for name, data in host_goldens(Path(d)).items():
            arrays[f"host/{name}"] = np.frombuffer(data, np.uint8)
            arrays[f"host/{name}.pil"] = _pil_decode(data)
    GOLDENS.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(GOLDENS, **arrays)
    print(f"wrote {GOLDENS} ({GOLDENS.stat().st_size} bytes)")
