"""Write ``mmtrs_tpu_torch/csrc/host/raster_tables.h``: the constant tables
of the codec's CCITT and BCn decoders, read from installed libraries.

``csrc/host/rasters.cpp`` needs the CCITT T.4 run-length codes (white and
black, terminating and make-up) and the BC6H/BC7 block tables (BC6H's
fourteen mode descriptions and their endpoint bit layouts; BC7's eight mode
descriptions, partition tables, anchor indices and interpolation weights)
and PhotoYCC's conversion tables.
The standards define them by value. Rather than copy them by hand, this
script finds each one in read-only data: the CCITT codes in the libtiff that
Pillow's wheel ships (``pillow.libs/libtiff-*.so*``), the block tables in
Pillow's own ``_imaging`` extension. Each table is found by its first row,
and checked against the tables beside it and against what the standards
say of it (the T.4 codes' count and sentinel, the BC7 partitions' subset
counts). PhotoYCC's five conversion tables (PCD) are Pillow's own
``UnpackYCC.c`` arrays, found by the first entries of their luma table and
checked against the scale factors its comment names. The header is written
with libtiff's and Pillow's notices, copied from Pillow's ``LICENSE``.

The header is committed, so no machine that builds the codec runs this
script or needs Pillow::

    python scripts/make_raster_tables.py            # write the header
    python scripts/make_raster_tables.py --check    # exit 1 if it differs
"""

from __future__ import annotations

import argparse
import struct
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
HEADER = ROOT / "mmtrs_tpu_torch" / "csrc" / "host" / "raster_tables.h"

# the first three entries (bits, code, run) of libtiff's TIFFFaxWhiteCodes
# and TIFFFaxBlackCodes: T.4's terminating codes for runs 0, 1 and 2
WHITE_FIRST = (8, 0x35, 0, 6, 0x7, 1, 4, 0x7, 2)
BLACK_FIRST = (10, 0x37, 0, 3, 0x2, 1, 2, 0x3, 2)
N_CODES = 104  # 64 terminating + 40 make-up (27 own, 13 shared to 2560) codes
# BC6H mode 0's endpoint layout begins gy[4], by[4], bz[4], rw[9:0], gw[9:0]
BC6_FIRST = bytes([116, 132, 180, *range(10), *range(16, 26)])
BC7_MODES = bytes([3, 4, 0, 0, 4, 0, 1, 0, 3, 0, 2, 6, 0, 0, 6, 0, 0, 1, 3, 0])
WEIGHTS = bytes([0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51, 55, 60, 64, 0, 9, 18, 27, 37, 46, 55, 64,
                 0, 21, 43, 64])


def _pillow_site() -> Path:
    import PIL

    return Path(PIL.__file__).resolve().parent


def find_libs() -> tuple[Path, Path]:
    site = _pillow_site()
    tiff = sorted((site.parent / "pillow.libs").glob("libtiff-*.so*"))
    imaging = sorted(site.glob("_imaging.*.so"))
    if not tiff or not imaging:
        raise FileNotFoundError("Pillow's libtiff (pillow.libs/libtiff-*.so) or _imaging extension not found")
    return tiff[0], imaging[0]


def find_notices() -> tuple[str, str]:
    """Pillow's own notice and libtiff's, as Pillow's wheel carries them."""
    lic = next(iter(sorted(_pillow_site().parent.glob("pillow-*.dist-info/licenses/LICENSE"))))
    text = lic.read_text()
    pillow = text[:text.find("\n----")].strip()
    start = text.find("\nLIBTIFF\n")
    if start < 0:
        raise FileNotFoundError("libtiff's notice is not in Pillow's LICENSE")
    end = text.find("\n----", start)
    return pillow, text[start + 1:end if end > 0 else None].strip()


def _fax_codes(blob: bytes, first: tuple[int, ...], color: str) -> np.ndarray:
    at = blob.find(struct.pack("<9H", *first))
    if at < 0:
        raise ValueError(f"the {color} T.4 codes are not in libtiff")
    rows = np.frombuffer(blob, "<i2", count=3 * (N_CODES + 1), offset=at).reshape(-1, 3).astype(np.int32)
    codes, eol = rows[:N_CODES], rows[N_CODES]
    runs = codes[:, 2]
    if tuple(eol) != (12, 1, -1) or list(runs[:64]) != list(range(64)) \
            or list(runs[64:]) != list(range(64, 2561, 64)):
        raise ValueError(f"the {color} T.4 codes: not 64 terminating and 40 make-up codes before EOL")
    # a prefix code: no code is the prefix of another
    bits = sorted((f"{c:0{n}b}" for n, c, _ in codes), key=len)
    for i, a in enumerate(bits):
        if any(b.startswith(a) for b in bits[i + 1:]):
            raise ValueError(f"the {color} T.4 codes are not a prefix code")
    return codes


# PhotoYCC → RGB (UnpackYCC.c): L = 1.3584 Y, CB = 2.2179 (C1 − 156),
# CR = 1.8215 (C2 − 137), GB = −0.194 CB, GR = −0.509 CR, each rounded
YCC_L_FIRST = (0, 1, 3, 4, 5, 7, 8, 10, 11, 12, 14, 15)


def _ycc_tables(imaging: bytes) -> dict[str, np.ndarray]:
    """The five 256-entry int16 tables: L found by its first entries, the
    four chroma tables that lie before it told apart by their direction and
    range, each within two of the scale its comment gives (the arrays are
    rounded from other digits)."""
    at = imaging.find(struct.pack(f"<{len(YCC_L_FIRST)}h", *YCC_L_FIRST))
    if at < 0:
        raise ValueError("PhotoYCC's luma table is not in Pillow's _imaging")
    table = lambda k: np.frombuffer(imaging, "<i2", count=256, offset=at + 512 * k).astype(np.int16)
    i = np.arange(256, dtype=np.float64)
    cb, cr = 2.2179 * (i - 156), 1.8215 * (i - 137)
    want = {"kYccL": 1.3584 * i, "kYccCb": cb, "kYccCr": cr, "kYccGb": -0.194 * cb, "kYccGr": -0.509 * cr}
    out = {"kYccL": table(0)}
    for k in range(-4, 0):
        t = table(k).astype(np.float64)
        name = min((n for n in want if n not in out), key=lambda n: np.abs(t - want[n]).max())
        out[name] = table(k)
    for name, ref in want.items():
        if name not in out or np.abs(out[name] - ref).max() > 2.0:
            raise ValueError(f"PhotoYCC's table {name} is not beside its luma table, or not what UnpackYCC.c says")
    return {n: out[n] for n in want}


def extract(tiff: bytes, imaging: bytes) -> dict[str, np.ndarray]:
    out = {"kFaxWhite": _fax_codes(tiff, WHITE_FIRST, "white"), "kFaxBlack": _fax_codes(tiff, BLACK_FIRST, "black")}
    at = imaging.find(BC6_FIRST)
    if at < 0:
        raise ValueError("BC6H's bit layouts are not in Pillow's _imaging")
    out["kBc6Packings"] = np.frombuffer(imaging, np.uint8, count=14 * 75, offset=at).reshape(14, 75)
    modes = imaging.find(bytes([2, 1, 5, 10, 5, 5, 5, 2, 1, 5, 7, 6, 6, 6]), at + 14 * 75)
    if modes < 0 or modes - (at + 14 * 75) > 16:
        raise ValueError("BC6H's mode table does not follow its bit layouts")
    out["kBc6Modes"] = np.frombuffer(imaging, np.uint8, count=14 * 7, offset=modes).reshape(14, 7)
    w = imaging.find(WEIGHTS, modes)
    if w < 0:
        raise ValueError("the BC6H/BC7 interpolation weights do not follow BC6H's mode table")
    out["kWeights4"] = np.frombuffer(WEIGHTS[:16], np.uint8)
    out["kWeights3"] = np.frombuffer(WEIGHTS[16:24], np.uint8)
    out["kWeights2"] = np.frombuffer(WEIGHTS[24:], np.uint8)
    # then BC7's anchors (A3b, A3a, A2), the 3- and 2-subset partitions and its modes, each 64 entries
    a3b = w + 48
    out["kBc7Anchor3b"] = np.frombuffer(imaging, np.uint8, count=64, offset=a3b)
    out["kBc7Anchor3a"] = np.frombuffer(imaging, np.uint8, count=64, offset=a3b + 64)
    out["kBc7Anchor2"] = np.frombuffer(imaging, np.uint8, count=64, offset=a3b + 128)
    out["kBc7Subsets3"] = np.frombuffer(imaging, "<u4", count=64, offset=a3b + 192).astype(np.uint32)
    out["kBc7Subsets2"] = np.frombuffer(imaging, "<u2", count=64, offset=a3b + 448).astype(np.uint16)
    m7 = a3b + 576
    if imaging[m7:m7 + len(BC7_MODES)] != BC7_MODES:
        raise ValueError("BC7's mode table does not follow its partitions")
    out["kBc7Modes"] = np.frombuffer(imaging, np.uint8, count=80, offset=m7).reshape(8, 10)
    # every anchor lies in 1..15, every partition of a 2- or 3-subset table
    # uses each of its subsets, and pixel 0 is always in subset 0
    anchors = np.concatenate([out["kBc7Anchor3b"], out["kBc7Anchor3a"], out["kBc7Anchor2"]])
    s2 = (out["kBc7Subsets2"][:, None].astype(np.int64) >> np.arange(16)) & 1
    s3 = (out["kBc7Subsets3"][:, None].astype(np.int64) >> (2 * np.arange(16))) & 3
    if anchors.min() < 1 or anchors.max() > 15 or (s2[:, 0] != 0).any() or (s3[:, 0] != 0).any() \
            or (s2.max(1) != 1).any() or (s3.max(1) != 2).any() \
            or (s2[np.arange(64), out["kBc7Anchor2"]] != 1).any():
        raise ValueError("BC7's anchors or partitions are not what the BC7 format defines")
    out.update(_ycc_tables(imaging))
    return out


_CTYPES = {np.dtype(np.uint8): "uint8_t", np.dtype(np.uint16): "uint16_t", np.dtype(np.uint32): "uint32_t",
           np.dtype(np.int32): "int32_t", np.dtype(np.int16): "int16_t"}


def _c_array(name: str, values: np.ndarray) -> str:
    ctype = _CTYPES[values.dtype]
    dims = "".join(f"[{d}]" for d in values.shape)
    flat = values.reshape(-1, values.shape[-1]) if values.ndim > 1 else values.reshape(-1, min(values.size, 16))
    rows = ",\n".join("  " + ", ".join(str(int(v)) for v in row) for row in flat)
    return f"static const {ctype} {name}{dims} = {{\n{rows}\n}};\n"


def render() -> str:
    tiff, imaging = find_libs()
    tables = extract(tiff.read_bytes(), imaging.read_bytes())
    pillow, libtiff = (("\n".join(f" * {line}".rstrip() for line in n.splitlines())) for n in find_notices())
    parts = [
        "/* The constant tables of the codec's CCITT and BCn decoders\n"
        " * (csrc/host/rasters.cpp), written by scripts/make_raster_tables.py.\n"
        " * kFaxWhite/kFaxBlack: ITU-T T.4's run-length codes as {bits, code, run},\n"
        " * 64 terminating codes then the make-up codes, from libtiff's read-only\n"
        " * data. The BC6H and BC7 tables: the block formats' mode descriptions,\n"
        " * BC6H's endpoint bit layouts (each entry endpoint << 4 | bit), BC7's\n"
        " * partitions (a subset index per pixel, pixel 0 in the low bits), anchor\n"
        " * indices and interpolation weights, from Pillow's _imaging extension.\n"
        " * kYcc*: PhotoYCC → RGB (PCD), Pillow's UnpackYCC.c tables.\n"
        " *\n"
        f"{libtiff}\n"
        " *\n"
        f"{pillow}\n"
        " */\n",
        "#pragma once\n",
        "#include <cstdint>\n",
    ]
    for name, values in tables.items():
        parts.append(_c_array(name, values))
    return "\n".join(parts)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--check", action="store_true", help="exit 1 if the committed header differs")
    args = ap.parse_args(argv)
    text = render()
    if args.check:
        same = HEADER.exists() and HEADER.read_text() == text
        print(f"{HEADER}: {'equal to' if same else 'differs from'} the tables in the installed libraries")
        return 0 if same else 1
    HEADER.write_text(text)
    print(f"wrote {HEADER}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
