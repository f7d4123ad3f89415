"""AVIF's second slice through the port's own AV1 decoder
(``csrc/host/av1.cpp``): the tools Pillow 12.1's encoder (libaom 3.12) writes
through its plain ``quality``, ``speed``, ``subsampling`` and ``save_all``
options, held to Pillow (libavif 1.3.0, dav1d 1.5.1) and to dav1d's planes
(``tests/avif_oracle.py``):

- palette (its colour cache, the delta-coded colours, the colour map in
  wavefront order) on screen-like images at Pillow's defaults;
- intraBC (the DV stack, read_mv, dav1d's clip into the decoded region, the
  BILINEAR copy, the var-tx tree and the inter tx sets with their flipped
  transforms) on a tiled text image, which libaom copies from above;
- CDEF on animated saves at low quality and on ``enable-cdef`` stills;
- loop restoration (Wiener, self-guided, switchable; stripes with the
  deblocked rows at their edges) on photographs at speeds 0, 2 and 4.

The goldens (``mmtrs_tpu_torch/testdata/avif2_goldens.npz``, each with
Pillow's decode) and the card's files (``avif2_uploads.npz``: a screenshot-
like upload, an animated first frame, the speed-2 photograph whose grid of
16 copies is ``chip_smoke.py``'s 12 MP restoration file) are written by
``python -m tests.test_torch_codec_avif2``.
"""

from __future__ import annotations

import io
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

import chip_smoke as cs
from tests import avif_oracle as ao
from tests.test_torch_codec_avif import _mutations, _phone, _pillow, _pillow_or_none, _port, _save, photo, rgba, screen

ROOT = Path(__file__).resolve().parents[1]
GOLDENS = cs.AVIF2_GOLDENS

# the tools mask's high word (csrc/host/av1.cpp, TOOL_PALETTE_Y ...)
NEW_TOOLS = {"palette_y": 32, "palette_uv": 33, "palette_cache": 34, "intrabc": 35, "cdef_y": 36, "cdef_uv": 37,
             "wiener": 38, "sgrproj": 39, "switchable_lr": 40}


def tiled_text(h: int, w: int, seed: int) -> Image.Image:
    """A 48 × 32 patch of text repeated: libaom's hash search finds each
    copy above and codes it with intraBC."""
    patch = np.asarray(screen(32, 48, seed))
    return Image.fromarray(np.tile(patch, (h // 32 + 1, w // 48 + 1, 1))[:h, :w])


def _animated(frames: list[Image.Image], **kw) -> bytes:
    """Pillow's ``save_all`` of ``frames``, with the creation and
    modification times of its movie, track and media headers set to 0 (so
    the file regenerates bit for bit; no decoder reads them)."""
    buf = io.BytesIO()
    frames[0].save(buf, "AVIF", save_all=True, append_images=frames[1:], **kw)
    data = bytearray(buf.getvalue())
    for kind in (b"mvhd", b"tkhd", b"mdhd"):
        at = data.find(kind)
        while at >= 0:
            size = 16 if data[at + 4] == 1 else 8  # version 1: 64-bit times
            data[at + 8:at + 8 + size] = bytes(size)
            at = data.find(kind, at + 4)
    return bytes(data)


def golden_files() -> dict[str, bytes]:
    """Every golden, by name: text-like images at Pillow's defaults (speed
    6, quality 75) in 4:2:0, 4:4:4, 4:0:0 and RGBA, at q100 at speeds 6 and
    8, and at speed 0; tiled text (intraBC); an animated save's first
    frame at q30 and q50 at speeds 4, 6 and 8 and in 4:2:2; ``enable-cdef``
    stills at an odd size; photographs at speeds 0, 2 and 4 in 4:2:0, 4:4:4
    and 4:0:0, one at an odd size and one in two tiles."""
    out = {}
    text = screen(96, 128, 3)
    out["text_420_128x96.avif"] = _save(text)
    out["text_444_128x96.avif"] = _save(text, subsampling="4:4:4")
    out["text_400_128x96.avif"] = _save(text, subsampling="4:0:0")
    out["text_rgba_128x96.avif"] = _save(rgba(np.asarray(text)))
    out["text_q100_speed6_128x96.avif"] = _save(text, quality=100, speed=6)
    out["text_q100_speed8_128x96.avif"] = _save(text, quality=100, speed=8)
    out["text_speed0_128x96.avif"] = _save(text, speed=0)
    out["intrabc_tiled_text_256x256.avif"] = _save(tiled_text(256, 256, 5))
    out["intrabc_tiled_text_444_192x160.avif"] = _save(tiled_text(160, 192, 8), subsampling="4:4:4")
    frames = [Image.fromarray(photo(96, 128, s)) for s in range(3)]
    for q in (30, 50):
        for sp in (4, 6, 8):
            out[f"animated_q{q}_speed{sp}_128x96.avif"] = _animated(frames, quality=q, speed=sp)
    out["animated_q30_speed6_422_128x96.avif"] = _animated(frames, quality=30, speed=6, subsampling="4:2:2")
    odd = photo(45, 67, 1)
    for sub in ("4:2:0", "4:4:4", "4:0:0"):
        out[f"cdef_{sub.replace(':', '')}_67x45.avif"] = _save(odd, subsampling=sub, advanced=[("enable-cdef", "1")])
    mid, small = photo(97, 130, 2), photo(64, 80, 2)
    for sub in ("4:2:0", "4:4:4", "4:0:0"):
        tag = sub.replace(":", "")
        out[f"photo_speed0_{tag}_80x64.avif"] = _save(small, speed=0, subsampling=sub)
        for sp in (2, 4):
            out[f"photo_speed{sp}_{tag}_130x97.avif"] = _save(mid, speed=sp, subsampling=sub)
    out["photo_speed0_odd_67x45.avif"] = _save(odd, speed=0)
    out["photo_speed2_two_tiles_200x160.avif"] = _save(photo(160, 200, 3), speed=2, tile_cols=1, tile_rows=0,
                                                       autotiling=False)
    return out


def upload_files() -> dict[str, bytes]:
    """The card's files (no Pillow there to write them): a 1024 × 768
    screenshot-like upload (tiled text: palette and intraBC), the first
    frame of a q30 animated save of the phone photo (CDEF), and the phone
    photo at speed 2 with ``enable-cdef`` (loop restoration and CDEF)."""
    phone = _phone()
    frames = [Image.fromarray(np.roll(phone, 8 * k, 1)) for k in range(3)]
    return {cs.AVIF2_UPLOAD_FILES["avif_screenshot"]: _save(tiled_text(768, 1024, 11)),
            cs.AVIF2_UPLOAD_FILES["avif_animated"]: _animated(frames, quality=30),
            cs.AVIF2_GRID_TILE: _save(phone, speed=2, advanced=[("enable-cdef", "1")])}


def write_goldens(path: Path = GOLDENS) -> int:
    files = golden_files()
    arrays = {}
    for name, data in sorted(files.items()):
        arrays[name] = np.frombuffer(data, np.uint8)
        arrays[f"{name}.pil"] = _pillow(data)[1]
    np.savez_compressed(path, **arrays)
    np.savez_compressed(cs.AVIF2_UPLOADS, **{k: np.frombuffer(v, np.uint8) for k, v in upload_files().items()})
    return len(files)


def _golden_names() -> list[str]:
    if not GOLDENS.exists():  # before the first ``python -m tests.test_torch_codec_avif2``
        return []
    with np.load(GOLDENS) as z:
        return sorted(f for f in z.files if not f.endswith(".pil"))


@pytest.fixture(scope="module")
def goldens():
    with np.load(GOLDENS) as z:
        return {f: z[f] for f in z.files}


def _tools(data: bytes) -> int:
    from mmtrs_tpu_torch.utils import avif

    return avif.tools_of(avif.planes_of(data)[1])


def test_goldens_are_small_and_regenerate_bit_for_bit():
    """The committed file is under 1 MiB, each golden at most 256² pixels,
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
def test_golden_decodes_as_pillow_with_dav1ds_planes(goldens, name):
    """The port's RGB equals Pillow's, its Y, U and V planes dav1d's."""
    from mmtrs_tpu_torch.utils import avif

    data = goldens[name].tobytes()
    np.testing.assert_array_equal(_port(data), goldens[f"{name}.pil"])
    planes, _ = avif.planes_of(data)
    want = ao.decode(data)["planes"]
    assert len(planes) == len(want)
    for got, ref in zip(planes, want):
        np.testing.assert_array_equal(got, ref)


def test_goldens_cover_every_tool_of_the_second_slice(goldens):
    """The union of the goldens' tool masks holds palette (Y, UV, cache
    hits), intraBC, CDEF (luma and chroma), Wiener, self-guided and
    switchable restoration; each family sets its own tools."""
    mask = 0
    for name in _golden_names():
        tools = _tools(goldens[name].tobytes())
        mask |= tools
        family = name.split("_")[0]
        want = {"text": "palette_y", "intrabc": "intrabc", "animated": "cdef_y", "cdef": None,
                "photo": None}[family]
        assert want is None or tools >> NEW_TOOLS[want] & 1, name
        if family == "photo":
            assert tools >> NEW_TOOLS["wiener"] & 1 or tools >> NEW_TOOLS["sgrproj"] & 1, name
    assert [tool for tool, bit in NEW_TOOLS.items() if not mask >> bit & 1] == []


MUTATED = ["text_444_128x96.avif", "intrabc_tiled_text_256x256.avif", "photo_speed2_420_130x97.avif"]


@pytest.mark.parametrize("name", MUTATED)
def test_mutated_files_agree_with_pillow(goldens, name):
    """Cut and mutated goldens of each new family (palette, intraBC with
    CDEF-free frames, restoration): where Pillow decodes, the port's decode
    is equal; where Pillow raises, the port raises a ValueError."""
    bad = []
    for k, data in enumerate(_mutations(goldens[name].tobytes(), 100 + MUTATED.index(name))):
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


def test_card_uploads_regenerate_and_decode_as_pillow():
    """The card's files are what Pillow writes now and decode equal to
    Pillow, with the tools they stand for: the screenshot palette and
    intraBC, the animated frame CDEF, the speed-2 photograph Wiener,
    self-guided and switchable restoration and CDEF."""
    fresh = upload_files()
    with np.load(cs.AVIF2_UPLOADS) as z:
        assert sorted(z.files) == sorted(fresh)
        for name, data in fresh.items():
            assert z[name].tobytes() == data, name
    want = {cs.AVIF2_UPLOAD_FILES["avif_screenshot"]: ("palette_y", "intrabc"),
            cs.AVIF2_UPLOAD_FILES["avif_animated"]: ("cdef_y",),
            cs.AVIF2_GRID_TILE: ("cdef_y", "cdef_uv", "wiener", "sgrproj", "switchable_lr")}
    for name, data in fresh.items():
        got = _port(data)
        assert got.shape == (768, 1024, 3), name
        np.testing.assert_array_equal(got, _pillow(data)[1], err_msg=name)
        tools = _tools(data)
        assert all(tools >> NEW_TOOLS[t] & 1 for t in want[name]), (name, hex(tools >> 32))


if __name__ == "__main__":
    print(f"wrote {write_goldens()} goldens to {GOLDENS}")
