"""Write ``mmtrs_tpu_torch/csrc/host/av1_tables.h``: the AV1 decoder's
constant tables, read from the libavif that Pillow's wheel ships.

The AV1 intra decoder of the PyTorch port's codec (``csrc/host/av1.cpp``)
needs the tables the AV1 specification defines by value: the default CDFs
of every syntax element an intra frame reads (palette, intraBC's MV, the
var-tx split, the inter tx sets and loop restoration among them), the
8-bit quantiser lookups, the directional-prediction derivatives, the
smooth weights, the filter-intra taps, CDEF's directions and divisors, the
self-guided filter's parameter sets, the quantiser matrices and film
grain's Gaussian sequence. Pillow's ``pillow.libs/libavif-*.so*`` embeds both
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
# AVIF's second slice (palette, intraBC, CDEF, loop restoration): libaom's
# palette CDFs, a CDF of each palette size in a row of 9 (sizes 2-8, each
# under 5 colour contexts), the var-tx split, the inter tx-set CDFs
# (libaom's [set][square size][17], set 0 empty; set 1 serves the square
# sizes 4 and 8, set 2 16, set 3 all four), its MV context (joints,
# then two components alike); dav1d's restoration CDFs
SLICE2_AOM = (
    ("kPaletteYSizeCdf", (7,), 7, 8, icdf(7952, 13000, 18149, 21478, 25527, 29241)),
    ("kPaletteUvSizeCdf", (7,), 7, 8, icdf(8713, 19979, 27128, 29609, 31331, 32272)),
    ("kPaletteYColorCdf", (7, 5), 8, 9, icdf(28710) + [0] * 8 + icdf(16384) + [0] * 8 + icdf(10553)),
    ("kPaletteUvColorCdf", (7, 5), 8, 9, icdf(29089) + [0] * 8 + icdf(16384) + [0] * 8 + icdf(8713)),
    ("kTxfmSplitCdf", (21,), 2, 3, icdf(28581) + [0, 0] + icdf(23846) + [0, 0] + icdf(20847)),
)
INTER_TX_SIG = icdf(4458, 5560, 7695, 9709, 13330, 14789, 17537, 20266)
INTER_INV1_SIG = (9, 10, 11, 12, 13, 14, 15, 0, 1, 2, 4, 5, 3, 6, 7, 8)
INTER_INV2_SIG = (9, 10, 11, 0, 1, 2, 4, 5, 3, 6, 7, 8)
MV_SIG = icdf(4096, 11264, 19328) + [0, 0] + icdf(28672, 30976, 31858, 32320, 32551, 32656, 32740, 32757)
# (name, symbols, CDFs) of an nmv component in libaom's nmv_context, in order
MV_FIELDS = (("kMvClassCdf", 11, 1), ("kMvClass0FrCdf", 4, 2), ("kMvFrCdf", 4, 1), ("kMvSignCdf", 2, 1),
             ("kMvClass0HpCdf", 2, 1), ("kMvHpCdf", 2, 1), ("kMvClass0BitCdf", 2, 1), ("kMvBitCdf", 2, 10))
SLICE2_DAV1D = (
    ("kRestoreSwitchableCdf", (), 3, 4, icdf(9413, 22581) + [0, 0] + icdf(11570) + [0], 0),
    ("kRestoreWienerCdf", (), 2, 2, icdf(11570) + [0] + icdf(16855) + [0], 0),
    ("kRestoreSgrprojCdf", (), 2, 2, icdf(11570) + [0] + icdf(16855) + [0], 4),
)
# libaom's self-guided parameter sets (r0, r1, s0, s1) and dav1d's s pairs
SGR_AOM_SIG = (2, 1, 140, 3236, 2, 1, 112, 2158)
SGR_DAV1D_SIG = (140, 3236, 112, 2158, 93, 1618)
# libaom's CDEF tables: the directions as offsets in its 144-wide buffer
# (cdef_directions_padded + 2), the 4:2:2 and 4:4:0 direction maps, the
# direction search's divisors
CDEF_BSTRIDE = 144
CDEF_DIRS_SIG = (-143, -286, 1, -142, 1, 2, 1, 146)
CDEF_CONV440_SIG = (1, 2, 2, 2, 3, 4, 6, 0)
CDEF_CONV422_SIG = (7, 0, 2, 4, 5, 6, 6, 6)
CDEF_DIV_SIG = (0, 840, 420, 280, 210, 168, 140, 120, 105)
# the Wiener taps' middle values, found in libaom; the ranges and subexp
# parameters libaom keeps as immediates (the specification's values)
WIENER_MID_SIG = (3, -7, 15)
SPEC_CONSTANTS = (
    ("kWienerTapsMin", "int8_t", (-5, -23, -17)),
    ("kWienerTapsMax", "int8_t", (10, 8, 46)),
    ("kWienerTapsK", "int8_t", (1, 2, 3)),
    ("kSgrprojXqdMin", "int8_t", (-96, -32)),
    ("kSgrprojXqdMax", "int8_t", (31, 95)),
    ("kSgrprojXqdMid", "int8_t", (-32, 31)),
)
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


def ints(blob: bytes, lo: int, hi: int, sig, fmt: str, count: int, what: str) -> np.ndarray:
    at = find(blob, lo, hi, np.array(sig, fmt).tobytes(), what)
    return np.frombuffer(blob[at:at + np.dtype(fmt).itemsize * count], fmt).astype(np.int64)


def aom_rows(blob: bytes, at: int, n: int, stride: int, count: int, what: str) -> np.ndarray:
    """``count`` libaom CDFs of ``n`` symbols at ``at``, in the header's form."""
    raw = np.frombuffer(blob[at:at + 2 * count * stride], "<u2").reshape(count, stride).astype(np.int64)
    out = np.zeros((count, n + 1), np.int64)
    for k, row in enumerate(raw):
        vals = row[:n - 1]
        if (vals == 0).any() or (np.diff(vals) >= 0).any() or (row[n - 1:] != 0).any():
            sys.exit(f"{what}: CDF {k} is not libaom's form: {row.tolist()}")
        out[k, :n - 1] = vals
    return out


def slice2(blob: bytes, lo: int, hi: int) -> list[str]:
    out = []
    for name, dims, n, stride, sig in SLICE2_AOM:
        table = aom_table(blob, lo, hi, name, dims, n, stride, sig)
        own = blob.find(np.array(sig, "<u2").tobytes(), lo, hi)
        got = agree(blob, lo, hi, name, table, own)
        if got != table.size // (n + 1):  # dav1d holds each of these CDFs too
            sys.exit(f"{name}: dav1d's copy differs from libaom's ({got} of {table.size // (n + 1)} CDFs found)")
        if "Color" in name:  # size s (2-8) holds s symbols
            for s in range(2, 9):
                for row in table[s - 2]:
                    if next(i for i, v in enumerate(row) if v == 0) != s - 1:
                        sys.exit(f"{name}: palette size {s} holds a CDF of another size")
        out.append(c_array(name, "uint16_t", table))
    at = find(blob, lo, hi, np.array(INTER_TX_SIG, "<u2").tobytes(), "the inter tx-set CDFs") - 4 * 17 * 2
    if np.frombuffer(blob[at:at + 4 * 17 * 2], "<u2").any():
        sys.exit("the inter tx-set CDFs: set 0 is not empty")
    set1 = aom_rows(blob, at + 4 * 17 * 2, 16, 17, 4, "kInterTxSet1Cdf")
    set2 = aom_rows(blob, at + 8 * 17 * 2, 12, 17, 4, "kInterTxSet2Cdf")
    set3 = aom_rows(blob, at + 12 * 17 * 2, 2, 17, 4, "kInterTxSet3Cdf")
    # the specification keeps set 2's CDF of 16×16 alone (the one size it serves)
    out += [c_array("kInterTxSet1Cdf", "uint16_t", set1[:2]), c_array("kInterTxSet2Cdf", "uint16_t", set2[2]),
            c_array("kInterTxSet3Cdf", "uint16_t", set3)]
    # the symbol → type maps of sets 1 and 2 (libaom's av1_ext_tx_inv, ALL16
    # and DTT9_IDTX_1DDCT); set 3 is IDTX, DCT_DCT
    for name, sig, n in (("kTxTypeInterInvSet1", INTER_INV1_SIG, 16), ("kTxTypeInterInvSet2", INTER_INV2_SIG, 12)):
        out.append(c_array(name, "uint8_t", ints(blob, lo, hi, sig, "<i4", n, f"libaom's {name}")))
    at = find(blob, lo, hi, np.array(MV_SIG, "<u2").tobytes(), "the MV context")
    out.append(c_array("kMvJointCdf", "uint16_t", aom_rows(blob, at, 4, 5, 1, "kMvJointCdf")[0]))
    comps = []
    for c in range(2):
        p, comp = at + 10 + c * 2 * sum((n + 1) * k for _, n, k in MV_FIELDS), {}
        for name, n, k in MV_FIELDS:
            rows = aom_rows(blob, p, n, n + 1, k, name)
            comp[name] = rows if k > 1 else rows[0]
            p += 2 * (n + 1) * k
        comps.append(comp)
    for name, _, _ in MV_FIELDS:
        if (comps[0][name] != comps[1][name]).any():
            sys.exit(f"{name}: the MV context's two components differ")
        out.append(c_array(name, "uint16_t", comps[0][name]))
    for name, dims, n, stride, sig, skip in SLICE2_DAV1D:
        out.append(c_array(name, "uint16_t", dav1d_table(blob, lo, hi, name, dims, n, stride, sig, skip)))
    sgr = ints(blob, lo, hi, SGR_AOM_SIG, "<i4", 64, "libaom's av1_sgr_params").reshape(16, 4)
    dav1d_s = ints(blob, lo, hi, SGR_DAV1D_SIG, "<u2", 32, "dav1d's sgr params").reshape(16, 2)
    # the specification's layout (r0, s0, r1, s1), s 0 where r is (libaom: -1)
    sgr = np.stack([sgr[:, 0], np.where(sgr[:, 0] > 0, sgr[:, 2], 0), sgr[:, 1], np.where(sgr[:, 1] > 0, sgr[:, 3], 0)], 1)
    if (sgr[:, 1::2] != dav1d_s).any():
        sys.exit("the self-guided parameters: libaom's and dav1d's differ")
    out.append(c_array("kSgrParams", "int32_t", sgr))
    offs = ints(blob, lo, hi, CDEF_DIRS_SIG, "<i4", 16, "libaom's cdef_directions").reshape(8, 2)
    dy = np.round(offs / CDEF_BSTRIDE).astype(np.int64)
    dirs = np.stack([dy, offs - dy * CDEF_BSTRIDE], -1)
    if (np.abs(dirs[..., 1]) > 2).any():
        sys.exit("libaom's cdef_directions: an offset of more than 2 columns")
    out.append(c_array("kCdefDirections", "int8_t", dirs))
    ident = np.arange(8)
    c440 = ints(blob, lo, hi, CDEF_CONV440_SIG, "<i4", 8, "libaom's CDEF 4:4:0 directions")
    c422 = ints(blob, lo, hi, CDEF_CONV422_SIG, "<i4", 8, "libaom's CDEF 4:2:2 directions")
    out.append(c_array("kCdefUvDir", "uint8_t", np.array([[ident, c440], [c422, ident]])))  # [subx][suby][dir]
    out.append(c_array("kCdefDivTable", "int32_t", ints(blob, lo, hi, CDEF_DIV_SIG, "<i4", 9, "libaom's div_table")))
    out.append(c_array("kWienerTapsMid", "int8_t", ints(blob, lo, hi, WIENER_MID_SIG, "<i4", 3, "the Wiener taps")))
    for name, ctype, vals in SPEC_CONSTANTS:
        out.append(c_array(name, ctype, np.array(vals)))
    return out


# AVIF's third slice (quantiser matrices, film grain): libaom's
# iwt_matrix_ref (the specification's Quantizer_Matrix, 15 levels x luma and
# chroma x 3,344 weights: the sizes 4x4 ... 32x8 one after another, each in
# libaom's coefficient order, column by column), found by the first 4x4's
# weights and checked against dav1d's 32x32 tables (their lower triangles,
# row by row); dav1d's Gaussian_Sequence (2,048 int16)
QM_SIG = (32, 43, 73, 97, 43, 67, 94, 110, 73, 94, 137, 150, 97, 110, 150, 200)
QM_TOTAL = 3344
QM_32_AT = 336  # the 32x32 weights' offset (after 4x4, 8x8 and 16x16)
GAUSS_SIG = (56, 568, -180, 172, 124, -84, 172, -64, -900, 24, 820, 224)


def slice3(blob: bytes, lo: int, hi: int) -> list[str]:
    qm = ints(blob, lo, hi, QM_SIG, "u1", 15 * 2 * QM_TOTAL, "libaom's iwt_matrix_ref").reshape(15, 2, QM_TOTAL)
    tri = np.tril_indices(32)
    for level in range(15):
        for c in range(2):
            m32 = qm[level, c, QM_32_AT:QM_32_AT + 1024].reshape(32, 32)
            if (m32 != m32.T).any():
                sys.exit(f"libaom's quantiser matrix {level}/{c}: its 32x32 is not symmetric")
    first = qm[0, 0, QM_32_AT:QM_32_AT + 1024].reshape(32, 32)[tri]
    at = find(blob, lo, hi, first.astype("u1").tobytes(), "dav1d's 32x32 quantiser matrices")
    dav1d = np.frombuffer(blob[at:at + 15 * 2 * 528], "u1").reshape(15, 2, 528)
    if any((qm[level, c, QM_32_AT:QM_32_AT + 1024].reshape(32, 32)[tri] != dav1d[level, c]).any()
           for level in range(15) for c in range(2)):
        sys.exit("the quantiser matrices: libaom's and dav1d's 32x32 weights differ")
    if qm.min() < 1 or (qm[14] > 32).any():
        sys.exit("libaom's quantiser matrices: a weight out of their range")
    gauss = ints(blob, lo, hi, GAUSS_SIG, "<i2", 2048, "dav1d's Gaussian_Sequence")
    if gauss.min() < -2048 or gauss.max() > 2047:
        sys.exit("dav1d's Gaussian_Sequence: a value past 12 bits")
    return [c_array("kQuantizerMatrix", "uint8_t", qm), c_array("kGaussianSequence", "int16_t", gauss)]


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
    out += slice2(blob, lo, hi)
    out += slice3(blob, lo, hi)
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
