"""Write ``mmtrs_tpu_torch/csrc/host/lab_tables.h``: the colour lookup table
through which Pillow converts CIELab images to RGB.

Pillow's ``Image.convert("RGB")`` of a ``LAB`` image builds a LittleCMS
transform (``ImageCms``: a Lab v2 profile on D50, ``cmsCreateLab2Profile``,
into ``cmsCreate_sRGBProfile``, perceptual intent, no flags, 8-bit Lab with
a pad byte in, 8-bit RGBA out). LittleCMS optimises that transform into a
single 33 x 33 x 33 grid of 16-bit RGB samples (``OptimizeByResampling``)
that it evaluates by tetrahedral interpolation. This script builds the same
transform through the LittleCMS that Pillow's wheel ships
(``pillow.libs/liblcms2-*.so*``), checks that the optimised pipeline is that
one grid, and writes its samples. ``csrc/host/rasters.cpp`` then evaluates
it as LittleCMS does (each 8-bit input times 257, ``TetrahedralInterp16``,
16 to 8 bits by ``(v * 65281 + 2^23) >> 24``), all in integers:
tests/test_torch_codec_corners.py holds the result equal to Pillow on all
2^24 inputs.

The header is committed with LittleCMS's notice from Pillow's ``LICENSE``,
so no machine that builds the codec runs this script or needs Pillow::

    python scripts/make_lab_tables.py            # write the header
    python scripts/make_lab_tables.py --check    # exit 1 if it differs
"""

from __future__ import annotations

import argparse
import ctypes
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
HEADER = ROOT / "mmtrs_tpu_torch" / "csrc" / "host" / "lab_tables.h"
GRID = 33
# lcms2.h's pixel-type packing: colour space << 16 | extra << 7 | channels << 3 | bytes
PT_RGB, PT_LABV2 = 4, 30
LAB_8_PAD = (PT_LABV2 << 16) | (1 << 7) | (3 << 3) | 1  # Pillow's "LAB" (findLCMStype)
RGBA_8 = (PT_RGB << 16) | (1 << 7) | (3 << 3) | 1  # Pillow's "RGB"
# _cmsTRANSFORM: two formats, xform, four formatters, a 1-pixel cache of two
# 16-entry u16 arrays, then the optimised pipeline
LUT_OFFSET = 8 + 8 + 4 * 8 + 2 * 16 * 2
CLUT = int.from_bytes(b"clut", "big")


def _pillow_site() -> Path:
    import PIL

    return Path(PIL.__file__).resolve().parent


def _lcms() -> ctypes.CDLL:
    found = sorted((_pillow_site().parent / "pillow.libs").glob("liblcms2-*.so*"))
    if not found:
        raise FileNotFoundError("Pillow's LittleCMS (pillow.libs/liblcms2-*.so) not found")
    lib = ctypes.CDLL(str(found[0]))
    p, u = ctypes.c_void_p, ctypes.c_uint32
    for name, res, args in (("cmsCreateLab2Profile", p, [p]), ("cmsCreate_sRGBProfile", p, []),
                            ("cmsCreateTransform", p, [p, u, p, u, u, u]), ("cmsPipelineStageCount", u, [p]),
                            ("cmsPipelineGetPtrToFirstStage", p, [p]), ("cmsStageType", u, [p]),
                            ("cmsStageData", p, [p]), ("cmsStageInputChannels", u, [p]),
                            ("cmsStageOutputChannels", u, [p])):
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args
    return lib


def extract() -> np.ndarray:
    """The optimised transform's grid, [33^3, 3] u16, L outermost, then a,
    then b (LittleCMS's opta 3267, 99, 3)."""
    lib = _lcms()
    xf = lib.cmsCreateTransform(lib.cmsCreateLab2Profile(None), LAB_8_PAD, lib.cmsCreate_sRGBProfile(), RGBA_8, 0, 0)
    if not xf:
        raise RuntimeError("LittleCMS refused Pillow's Lab -> sRGB transform")
    fmts = (ctypes.c_uint32 * 2).from_address(xf)
    if (fmts[0], fmts[1]) != (LAB_8_PAD, RGBA_8):
        raise ValueError("the transform's layout is not the one this script reads")
    lut = ctypes.c_void_p.from_address(xf + LUT_OFFSET).value
    stage = lib.cmsPipelineGetPtrToFirstStage(lut)
    if lib.cmsPipelineStageCount(lut) != 1 or lib.cmsStageType(stage) != CLUT \
            or (lib.cmsStageInputChannels(stage), lib.cmsStageOutputChannels(stage)) != (3, 3):
        raise ValueError("LittleCMS did not optimise the transform into one 3 -> 3 grid")
    data = lib.cmsStageData(stage)
    table, params = ctypes.c_void_p.from_address(data).value, ctypes.c_void_p.from_address(data + 8).value
    n_entries, has_float = ctypes.c_uint32.from_address(data + 16).value, ctypes.c_int.from_address(data + 20).value
    fields = np.ctypeslib.as_array((ctypes.c_uint32 * 48).from_address(params + 8))
    n_samples, domain, opta = fields[3:6], fields[18:21], fields[33:36]
    if n_entries != GRID ** 3 * 3 or has_float or list(n_samples) != [GRID] * 3 or list(domain) != [GRID - 1] * 3 \
            or list(opta) != [3, 3 * GRID, 3 * GRID * GRID]:
        raise ValueError("the grid is not 33 x 33 x 33 16-bit samples of 3 outputs")
    return np.ctypeslib.as_array((ctypes.c_uint16 * n_entries).from_address(table)).copy().reshape(-1, 3)


def lcms_notice() -> str:
    lic = next(iter(sorted(_pillow_site().parent.glob("pillow-*.dist-info/licenses/LICENSE"))))
    text = lic.read_text()
    start = text.find("\nLCMS2\n")
    if start < 0:
        raise FileNotFoundError("LittleCMS's notice is not in Pillow's LICENSE")
    end = text.find("\n----", start)
    return text[start + 1:end].strip()


def render() -> str:
    grid = extract()
    notice = "\n".join(f" * {line}".rstrip() for line in lcms_notice().splitlines())
    rows = ",\n".join("  " + ", ".join(str(int(v)) for v in row) for row in grid.reshape(-1, 9))
    return ("/* Pillow's CIELab -> RGB conversion (LittleCMS's optimised transform from\n"
            " * a Lab v2 D50 profile to sRGB, perceptual intent), written by\n"
            " * scripts/make_lab_tables.py: kLabGrid, 33 x 33 x 33 RGB samples (16-bit),\n"
            " * L outermost, then a, then b, evaluated by tetrahedral interpolation in\n"
            " * csrc/host/rasters.cpp.\n"
            " *\n"
            f"{notice}\n"
            " */\n\n"
            "#pragma once\n\n"
            "#include <cstdint>\n\n"
            f"static const uint16_t kLabGrid[{grid.size}] = {{\n{rows}\n}};\n")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--check", action="store_true", help="exit 1 if the committed header differs")
    args = ap.parse_args(argv)
    text = render()
    if args.check:
        same = HEADER.exists() and HEADER.read_text() == text
        print(f"{HEADER}: {'equal to' if same else 'differs from'} the grid of the installed LittleCMS")
        return 0 if same else 1
    HEADER.write_text(text)
    print(f"wrote {HEADER}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
