"""Write ``mmtrs_tpu_torch/csrc/host/webp_tables.h``: the WebP decoder's
constant tables, read from an installed libwebp.

The WebP decoder of the PyTorch port's codec (``csrc/host/webp.cpp``) needs
six tables that RFC 6386 (VP8) and RFC 9649 (VP8L) define by value: the
dequantisation tables, the coefficient probabilities and their update
probabilities, the 4×4 intra-mode probabilities and the lossless format's
distance map. Rather than copy them by hand, this script finds each one in
the read-only data of the libwebp shared library that Pillow's wheel ships
(``pillow.libs/libwebp-*.so*``; else the system's ``libwebp.so``): it
searches for the table's first row, takes the first occurrence, and checks
the table's size, its shape and the tables beside it. The header is written
with libwebp's licence notice, copied from Pillow's ``LICENSE``.

The header is committed, so no machine that builds the codec runs this
script or needs libwebp::

    python scripts/make_webp_tables.py            # write the header
    python scripts/make_webp_tables.py --check    # exit 1 if it differs
"""

from __future__ import annotations

import argparse
import ctypes.util
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
HEADER = ROOT / "mmtrs_tpu_torch" / "csrc" / "host" / "webp_tables.h"

# (name, C type, dims, signature: the first values, as the specifications list them)
TABLES = (
    ("kAcTable", "uint16_t", (128,), list(range(4, 20))),
    ("kDcTable", "uint8_t", (128,), [4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17]),
    ("CoeffsUpdateProba", "uint8_t", (4, 8, 3, 11), [255] * 33 + [176, 246, 255]),
    ("kBModesProba", "uint8_t", (10, 10, 9), [231, 120, 48, 89, 115, 113, 120, 152, 112]),
    ("CoeffsProba0", "uint8_t", (4, 8, 3, 11), [128] * 33 + [253, 136, 254, 255, 228, 219]),
    ("kCodeToPlane", "uint8_t", (120,), [0x18, 0x07, 0x17, 0x19, 0x28, 0x06, 0x27, 0x29, 0x16, 0x1a]),
)
# the VP8 zig-zag scan, which libwebp keeps right after CoeffsProba0, and
# VP8L's code-length code order, kept after the distance map
ZIGZAG = bytes([0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15])
CODE_LENGTH_ORDER = bytes([17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15])


def find_libwebp() -> Path:
    """Pillow's bundled libwebp, else the system's."""
    try:
        import PIL

        libs = Path(PIL.__file__).resolve().parent.parent / "pillow.libs"
        found = sorted(p for p in libs.glob("libwebp-*.so*"))
        if found:
            return found[0]
    except ImportError:
        pass
    name = ctypes.util.find_library("webp")
    for d in ("/usr/lib/x86_64-linux-gnu", "/usr/lib64", "/usr/lib", "/usr/local/lib"):
        if name and (Path(d) / name).exists():
            return Path(d) / name
    raise FileNotFoundError("no libwebp found (neither Pillow's pillow.libs/libwebp-*.so nor a system libwebp)")


def find_licence() -> str:
    """libwebp's licence notice as Pillow's wheel carries it."""
    import PIL

    site = Path(PIL.__file__).resolve().parent.parent
    for lic in sorted(site.glob("pillow-*.dist-info/licenses/LICENSE")):
        text = lic.read_text()
        start = text.find("\nLIBWEBP\n")
        if start >= 0:
            end = text.find("\n----", start)
            return text[start + 1:end if end > 0 else None].strip()
    raise FileNotFoundError("Pillow's LICENSE with libwebp's notice not found")


def _values(blob: bytes, offset: int, ctype: str, dims: tuple[int, ...]) -> np.ndarray:
    dtype = np.dtype("<u2") if ctype == "uint16_t" else np.dtype(np.uint8)
    n = int(np.prod(dims))
    return np.frombuffer(blob, dtype, count=n, offset=offset).reshape(dims)


def extract(blob: bytes) -> dict[str, tuple[int, np.ndarray]]:
    """Each table's offset in ``blob`` and its values, checked."""
    out = {}
    for name, ctype, dims, first in TABLES:
        sig = np.array(first, "<u2" if ctype == "uint16_t" else np.uint8).tobytes()
        at = blob.find(sig)
        if at < 0:
            raise ValueError(f"{name}: its first row is not in the library")
        out[name] = (at, _values(blob, at, ctype, dims))
    ac, dc = out["kAcTable"][1], out["kDcTable"][1]
    if not (np.all(np.diff(ac.astype(int)) > 0) and ac[-1] == 284):
        raise ValueError("kAcTable: not the 128 rising steps from 4 to 284")
    if not (np.all(np.diff(dc.astype(int)) >= 0) and dc[-1] == 157):
        raise ValueError("kDcTable: not the 128 steps from 4 to 157")
    # the five VP8 tables lie in one block, each after the one before it
    # (CoeffsProba0 after up to 63 bytes of alignment), the zig-zag scan after them
    order = ["kAcTable", "kDcTable", "CoeffsUpdateProba", "kBModesProba", "CoeffsProba0"]
    sizes = {"kAcTable": 256, "kDcTable": 128, "CoeffsUpdateProba": 1056, "kBModesProba": 900, "CoeffsProba0": 1056}
    for a, b in zip(order, order[1:]):
        gap = out[b][0] - (out[a][0] + sizes[a])
        if not 0 <= gap < 64 or any(blob[out[a][0] + sizes[a]:out[b][0]]):
            raise ValueError(f"{b} does not follow {a} ({gap} bytes between them)")
    after = out["CoeffsProba0"][0] + 1056
    if blob.find(ZIGZAG, after, after + 64) < 0:
        raise ValueError("CoeffsProba0 is not followed by the zig-zag scan")
    plane_at, plane = out["kCodeToPlane"]
    if len(set(plane.tolist())) != 120 or blob.find(CODE_LENGTH_ORDER, plane_at + 120, plane_at + 192) < 0:
        raise ValueError("kCodeToPlane: not 120 distinct codes followed by the code-length order")
    return out


def _c_array(name: str, ctype: str, values: np.ndarray) -> str:
    dims = "".join(f"[{d}]" for d in values.shape)
    flat = values.reshape(-1, values.shape[-1]) if values.ndim > 1 else values.reshape(-1, 16 if values.size % 16 == 0 else 8)
    rows = ",\n".join("  " + ", ".join(str(int(v)) for v in row) for row in flat)
    return f"static const {ctype} {name}{dims} = {{\n{rows}\n}};\n"


def render(lib: Path | None = None) -> str:
    """The header's text, from ``lib`` (default: find_libwebp())."""
    lib = lib or find_libwebp()
    tables = extract(lib.read_bytes())
    licence = "\n".join(f" * {line}".rstrip() for line in find_licence().splitlines())
    parts = [
        "/* The WebP decoder's constant tables (csrc/host/webp.cpp), written by\n"
        " * scripts/make_webp_tables.py from libwebp's read-only data. Their values\n"
        " * are those RFC 6386 (VP8) and RFC 9649 (VP8L) define; the indices follow\n"
        " * libwebp's layout (kBModesProba by libwebp's 4x4 mode order: DC, TM, VE,\n"
        " * HE, RD, VR, LD, VL, HD, HU).\n"
        " *\n"
        f"{licence}\n"
        " */\n",
        "#pragma once\n",
        "#include <cstdint>\n",
    ]
    for name, ctype, _, _ in TABLES:
        parts.append(_c_array(name, ctype, tables[name][1]))
    return "\n".join(parts)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--check", action="store_true", help="exit 1 if the committed header differs")
    ap.add_argument("--lib", type=Path, default=None, help="the libwebp shared library to read")
    args = ap.parse_args(argv)
    text = render(args.lib)
    if args.check:
        same = HEADER.exists() and HEADER.read_text() == text
        print(f"{HEADER}: {'equal to' if same else 'differs from'} the tables in {args.lib or find_libwebp()}")
        return 0 if same else 1
    HEADER.write_text(text)
    print(f"wrote {HEADER} from {args.lib or find_libwebp()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
