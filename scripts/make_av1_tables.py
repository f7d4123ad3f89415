"""Write ``mmtrs_tpu_torch/csrc/host/av1_tables.h``: the AV1 decoder's
constant tables, read from the libavif that Pillow's wheel ships.

The AV1 intra decoder of the PyTorch port's codec (``csrc/host/av1.cpp``)
needs the tables the AV1 specification defines by value: the default CDFs
of every syntax element an intra frame reads, the 8-bit quantiser lookups,
the directional-prediction derivatives, the smooth weights and the
filter-intra taps. Pillow's ``pillow.libs/libavif-*.so*`` embeds both
libaom 3.12 (its encoder) and dav1d 1.5 (its decoder), and their read-only
data hold these tables. This script finds each one by its first values,
takes the first occurrence, checks its shape (each CDF strictly
decreasing, in the layout of the library it is read from), and checks that
a table both libraries hold agrees between them. The scan orders the
decoder builds itself; the script checks them against libaom's tables.

Layouts: libaom keeps a CDF of N symbols as N - 1 inverse probabilities
(32768 - cdf), then 0 and a counter (``AOM_CDFn``), a table's CDFs padded
to its widest; dav1d keeps N - 1 inverse probabilities and a counter. The
header keeps libaom's form for every CDF: N - 1 values, 0, 0.

The header is committed, so no machine that builds the codec runs this
script or needs libavif::

    python scripts/make_av1_tables.py            # write the header
    python scripts/make_av1_tables.py --check    # exit 1 if it differs
"""

from __future__ import annotations

import argparse
import struct
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
HEADER = ROOT / "mmtrs_tpu_torch" / "csrc" / "host" / "av1_tables.h"


def icdf(*cdf: int) -> list[int]:
    return [32768 - v for v in cdf]


# (name, dims without the CDF axis, symbols, stride in the library,
# signature: the first values as the library stores them). libaom's copies.
AOM_CDFS = (
    ("kPartitionCdf", (20,), 10, 11, icdf(19132, 25510, 30392) + [0, 0]),
    ("kKfYModeCdf", (5, 5), 13, 14, icdf(15588, 17027, 19338, 20218, 20682, 21110)),
    ("kUvModeCdf", (2, 13), 14, 15, icdf(22631, 24152, 25378, 25661, 25986, 26520)),
    ("kAngleDeltaCdf", (8,), 7, 8, icdf(2180, 5032, 7567, 22776, 26989, 30217) + [0, 0]),
    ("kIntraTxSet1Cdf", (4, 13), 7, 17, icdf(1535, 8035, 9461, 12751, 23467, 27825) + [0, 0]),
    ("kIntraTxSet2Cdf", (4, 13), 5, 17, icdf(6554, 13107, 19661, 26214) + [0] * 13 + [26214]),
    ("kTxSizeCdf", (4, 3), 3, 4, [12800, 0, 0, 0, 12800, 0, 0, 0, 8448]),
    ("kCflAlphaCdf", (6,), 16, 17, [25131, 12049, 1367, 287, 111, 80, 76, 72, 68, 64, 60, 56, 52, 48, 44, 0, 0]),
    ("kFilterIntraCdf", (22,), 2, 3, icdf(4621) + [0, 0] + icdf(6743) + [0, 0] + icdf(5893) + [0, 0]),
    ("kDeltaLfMultiCdf", (4,), 4, 5, icdf(28160, 32120, 32677) + [0, 0] + icdf(28160, 32120, 32677)),
    ("kTxbSkipCdf", (4, 5, 13), 2, 3, [919, 0, 0, 26876, 0, 0, 20656, 0, 0, 10833, 0, 0]),
    ("kEobExtraCdf", (4, 5, 2, 9), 2, 3, [15807, 0, 0, 15545, 0, 0, 25147, 0, 0, 16384, 0, 0]),
    ("kDcSignCdf", (4, 2, 3), 2, 3, [16768, 0, 0, 19712, 0, 0, 13952, 0, 0, 17536, 0, 0]),
    ("kEobPt16Cdf", (4, 2, 2), 5, 6, [31928, 31729, 30788, 27873, 0, 0, 32398, 32097, 30885, 28297]),
    ("kEobPt32Cdf", (4, 2, 2), 6, 7, [32368, 32248, 31791, 30666, 26226, 0, 0, 32558, 32363]),
    ("kEobPt64Cdf", (4, 2, 2), 7, 8, [32439, 32270, 31667, 30984, 29503, 25010, 0, 0, 32433]),
    ("kEobPt128Cdf", (4, 2, 2), 8, 9, [32549, 32286, 31628, 30677, 29088, 26740, 20182, 0, 0, 32397]),
    ("kEobPt256Cdf", (4, 2, 2), 9, 10, [32458, 32184, 30881, 29179, 26600, 24157, 21416, 17116, 0, 0, 31770]),
    ("kEobPt512Cdf", (4, 2, 2), 10, 11, [32127, 31785, 29061, 27338, 22534, 17810, 13980, 9356, 6707, 0, 0]),
    ("kEobPt1024Cdf", (4, 2, 2), 11, 12, [32375, 32347, 32017, 31145, 29608, 26416, 19423, 14721, 10197, 6938, 0]),
    ("kCoeffBaseEobCdf", (4, 5, 2, 4), 3, 4, [14931, 3713, 0, 0, 3168, 1322, 0, 0, 1924, 890, 0, 0]),
    ("kCoeffBaseCdf", (4, 5, 2, 42), 4, 5, icdf(4034, 8930, 12727) + [0, 0] + icdf(18082, 29741, 31877)),
    ("kCoeffBrCdf", (4, 5, 2, 21), 4, 5, icdf(14298, 20718, 24174) + [0, 0] + icdf(12536, 19601, 23789)),
)
# dav1d's copies, for the tables libaom keeps in another form; the
# signature as dav1d stores it, and the bytes from its start to the table
DAV1D_CDFS = (
    ("kSkipCdf", (3,), 2, 2, icdf(31671) + [0] + icdf(16515) + [0] + icdf(4576) + [0], 0),
    ("kPaletteYModeCdf", (7, 3), 2, 2, icdf(31676) + [0] + icdf(3419) + [0] + icdf(1261) + [0], 0),
    ("kPaletteUvModeCdf", (2,), 2, 2, icdf(32461) + [0] + icdf(21488) + [0] + icdf(30531) + [0], 0),
    ("kIntrabcCdf", (), 2, 2, icdf(32461) + [0] + icdf(21488) + [0] + icdf(30531) + [0], 8),
    ("kCflSignCdf", (), 8, 8, icdf(1418, 2123, 13340, 18405, 26972, 28343, 32294) + [0], 0),
    ("kFilterIntraModeCdf", (), 5, 8, icdf(8949, 12776, 17211, 29558) + [0] * 4 + icdf(5622), 0),
    ("kSegmentIdCdf", (3,), 8, 8, icdf(5622, 7893, 16093, 18233, 27809, 28373, 32533) + [0], 0),
    ("kDeltaQCdf", (), 4, 4, icdf(28160, 32120, 32677) + [0] + icdf(28160, 32120, 32677) + [0], 0),
    ("kDeltaLfCdf", (), 4, 4, icdf(28160, 32120, 32677) + [0] + icdf(28160, 32120, 32677) + [0], 8),
)
# (name, C type, count, signature: the first values)
PLAIN = (
    ("kDcQLookup", "int16_t", 256, (4, 8, 8, 9, 10, 11, 12, 12, 13, 14, 15, 16, 17, 18, 19, 19, 20)),
    ("kAcQLookup", "int16_t", 256, (4, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23)),
    ("kDrIntraDerivative", "uint16_t", 90, (0, 0, 0, 1023, 0, 0, 547, 0, 0, 372, 0, 0, 0, 0, 273)),
    ("kSmoothWeights", "uint8_t", 126, (255, 128, 255, 149, 85, 64, 255, 197, 146, 105, 73, 50, 37, 32)),
    ("kFilterIntraTaps", "int8_t", 5 * 8 * 8, (-6, 10, 0, 0, 0, 12, 0, 0, -5, 2, 10, 0, 0, 9, 0, 0)),
    # the transforms' 12-bit cosines (libaom's av1_cospi_arr_data at cos_bit 12) and sines
    ("kCosPi", "int32_t", 64, (4096, 4095, 4091, 4085, 4076, 4065, 4052, 4036, 4017, 3996, 3973, 3948)),
    ("kSinPi", "int32_t", 5, (0, 1321, 2482, 3344, 3803)),
)
_FMT = {"int32_t": "i", "int16_t": "h", "uint16_t": "H", "uint8_t": "B", "int8_t": "b"}
# libaom keeps the default and rectangular scans in its own orientation
# (transposed: row and column swapped); the decoder builds the
# specification's and the script finds libaom's transpose of each
SCAN_SIZES = ((4, 4), (8, 8), (16, 16), (32, 32), (4, 8), (8, 4), (8, 16), (16, 8), (16, 32), (32, 16), (4, 16),
              (16, 4), (8, 32), (32, 8))


def find_libavif() -> Path:
    import PIL

    libs = Path(PIL.__file__).resolve().parent.parent / "pillow.libs"
    found = sorted(libs.glob("libavif-*.so*"))
    if not found:
        sys.exit("no libavif in Pillow's wheel (pillow.libs)")
    return found[0]


def rodata(blob: bytes) -> tuple[int, int]:
    """The file range of the ELF's .rodata section."""
    shoff, = struct.unpack_from("<Q", blob, 0x28)
    shentsize, shnum, shstrndx = struct.unpack_from("<HHH", blob, 0x3A)
    sec = [struct.unpack_from("<IIQQQQIIQQ", blob, shoff + i * shentsize) for i in range(shnum)]
    names = sec[shstrndx][4]
    for name, _, _, _, off, size, *_ in sec:
        if blob[names + name:blob.index(b"\0", names + name)] == b".rodata":
            return off, off + size
    sys.exit("no .rodata section")


def find(blob: bytes, lo: int, hi: int, pattern: bytes, what: str) -> int:
    at = blob.find(pattern, lo, hi)
    if at < 0:
        sys.exit(f"{what}: not found in the library's read-only data")
    return at


def aom_table(blob, lo, hi, name, dims, n, stride, sig) -> np.ndarray:
    at = find(blob, lo, hi, np.array(sig, "<u2").tobytes(), name)
    count = int(np.prod(dims))
    raw = np.frombuffer(blob[at:at + 2 * count * stride], "<u2").reshape(count, stride).astype(np.int64)
    out = np.zeros((count, n + 1), np.int64)
    for k, row in enumerate(raw):
        # a row of fewer symbols (partition at 8×8 and 128×128, the 2-symbol
        # tx depth of 8×8) ends earlier: its 0 terminator, then zeros
        m = next(i for i, v in enumerate(row) if v == 0)
        vals = row[:m]
        if m > n - 1 or (np.diff(vals) >= 0).any() or (row[m:] != 0).any():
            sys.exit(f"{name}: CDF {k} is not libaom's form: {row.tolist()}")
        out[k, :m] = vals
    return out.reshape(*dims, n + 1)


def dav1d_table(blob, lo, hi, name, dims, n, stride, sig, skip) -> np.ndarray:
    at = find(blob, lo, hi, np.array(sig, "<u2").tobytes(), name) + skip
    count = int(np.prod(dims)) if dims else 1
    raw = np.frombuffer(blob[at:at + 2 * count * stride], "<u2").reshape(count, stride).astype(np.int64)
    out = np.zeros((count, n + 1), np.int64)
    for k, row in enumerate(raw):
        vals = row[:n - 1]
        if (vals == 0).any() or (np.diff(vals) >= 0).any() or row[n - 1] != 0:
            sys.exit(f"{name}: CDF {k} is not dav1d's form: {row.tolist()}")
        out[k, :n - 1] = vals
    return out.reshape(*dims, n + 1) if dims else out[0]


def agree(blob: bytes, lo: int, hi: int, name: str, table: np.ndarray, own: int) -> int:
    """How many of ``table``'s CDFs the other library holds too, found
    anywhere in the read-only data but at the copy read (``own``)."""
    found = 0
    flat = table.reshape(-1, table.shape[-1])
    for row in flat:
        vals = row[:next(i for i, v in enumerate(row) if v == 0)]
        pattern = np.array(vals, "<u2").tobytes()
        at = blob.find(pattern, lo, hi)
        while at >= 0 and own <= at < own + 2 * flat.size * 4:
            at = blob.find(pattern, at + 1, hi)
        found += at >= 0
    return found


def scans_checked(blob: bytes, lo: int, hi: int) -> int:
    for w, h in SCAN_SIZES:
        order = []
        for d in range(w + h - 1):
            rows = list(range(max(0, d - (w - 1)), min(d, h - 1) + 1))
            if (w == h and d % 2 == 0) or w > h:
                rows = rows[::-1]
            order += [r * w + d - r for r in rows]
        transposed = [(p % w) * h + p // w for p in order]
        find(blob, lo, hi, np.array(transposed, "<i2").tobytes(), f"libaom's default scan {w}x{h}")
    return len(SCAN_SIZES)


def c_array(name: str, ctype: str, arr: np.ndarray) -> str:
    def body(a, indent):
        if a.ndim == 1:
            return "{" + ", ".join(str(int(v)) for v in a) + "}"
        inner = [body(x, indent + 1) for x in a]
        sep = ",\n" + "    " * (indent + 1)
        return "{\n" + "    " * (indent + 1) + sep.join(inner) + "\n" + "    " * indent + "}"

    dims = "".join(f"[{d}]" for d in arr.shape)
    return f"static const {ctype} {name}{dims} = {body(arr, 0)};\n"


def build() -> str:
    path = find_libavif()
    blob = path.read_bytes()
    lo, hi = rodata(blob)
    out = ["// Generated by scripts/make_av1_tables.py from the libavif of Pillow's wheel",
           f"// ({path.name}: libaom 3.12's and dav1d 1.5's read-only data). Do not edit.",
           "// The tables are those the AV1 specification defines by value; libaom",
           "// and dav1d are BSD-2-Clause (AOMedia and VideoLAN).",
           "// A CDF of N symbols: N - 1 inverse probabilities (32768 - cdf), 0, and",
           "// the adaptation counter (0).",
           "#pragma once", "#include <cstdint>", ""]
    checks = []
    for name, dims, n, stride, sig in AOM_CDFS:
        table = aom_table(blob, lo, hi, name, dims, n, stride, sig)
        own = blob.find(np.array(sig, "<u2").tobytes(), lo, hi)
        checks.append((name, agree(blob, lo, hi, name, table, own), table.size // (n + 1)))
        out.append(c_array(name, "uint16_t", table))
    for name, dims, n, stride, sig, skip in DAV1D_CDFS:
        out.append(c_array(name, "uint16_t", dav1d_table(blob, lo, hi, name, dims, n, stride, sig, skip)))
    for name, ctype, count, sig in PLAIN:
        fmt = "<" + _FMT[ctype]
        at = find(blob, lo, hi, struct.pack(f"<{len(sig)}{_FMT[ctype]}", *sig), name)
        size = struct.calcsize(fmt)
        vals = np.array(struct.unpack(f"<{count}{_FMT[ctype]}", blob[at:at + size * count]))
        out.append(c_array(name, ctype, vals))
    # the two libraries' copies agree wherever dav1d keeps the CDFs as
    # libaom does (dav1d lays its coefficient CDFs out otherwise): the mode
    # tables' every CDF is found outside the copy read
    for name, got, total in checks:
        if name in ("kPartitionCdf", "kKfYModeCdf", "kAngleDeltaCdf", "kCflAlphaCdf", "kFilterIntraCdf") \
                and got != total:
            sys.exit(f"{name}: dav1d's copy differs from libaom's ({got} of {total} CDFs found)")
    scans_checked(blob, lo, hi)
    return "\n".join(out)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--check", action="store_true", help="compare with the committed header instead of writing")
    args = ap.parse_args()
    text = build()
    if args.check:
        same = HEADER.exists() and HEADER.read_text() == text
        print("av1_tables.h is up to date" if same else "av1_tables.h differs from the script's output")
        return 0 if same else 1
    HEADER.write_text(text)
    print(f"wrote {HEADER}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
