"""Sweeps of the codec's AVIF and JPEG-in-TIFF decoders against Pillow 12.1
(and dav1d's planes, through ``tests/avif_oracle.py``), too long for the
test suite. Each prints how many files it tried, how many agree and the
ones that differ (the port decodes otherwise, or one of the two refuses).

    python scripts/fuzz_codec_avif.py avis          # cuts and 1-3-byte mutations of the animated goldens
    python scripts/fuzz_codec_avif.py goldens N     # of the goldens of AVIF slice N (1, 2 or 3)
    python scripts/fuzz_codec_avif.py saves SEED K  # K random Pillow saves with QMs, film grain, premultiplied alpha
    python scripts/fuzz_codec_avif.py jit-types     # every tag of the JPEG-in-TIFF goldens retyped to types 1-18

Run from the repository root; it needs Pillow 12.1's wheel (the oracle's
libavif), so it runs where the tests run, not on the card.
"""

from __future__ import annotations

import argparse
import struct
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from tests import avif_oracle as ao  # noqa: E402
from tests.test_torch_codec_avif import _mutations, _pillow_or_none, _port, _save, photo, rgba  # noqa: E402

GOLDENS = {1: "AVIF_GOLDENS", 2: "AVIF2_GOLDENS", 3: "AVIF3_GOLDENS"}  # chip_smoke's names


def _agree(data: bytes) -> str | None:
    """None where the port's decode equals Pillow's or both refuse, else
    what differs."""
    want = _pillow_or_none(data)
    try:
        got = _port(data)
    except (ValueError, MemoryError):
        got = None
    if want is None and got is None:
        return None
    if want is None or got is None:
        return "Pillow refuses" if want is None else "the port refuses"
    return None if got.shape == want[1].shape and np.array_equal(got, want[1]) else "differs"


def mutated(files: dict[str, bytes], seed0: int, n: int) -> list[tuple]:
    bad, total = [], 0
    for gi, (name, data) in enumerate(sorted(files.items())):
        for k, m in enumerate(_mutations(data, seed0 + gi, n)):
            total += 1
            what = _agree(m)
            if what:
                bad.append((name, seed0 + gi, k, what))
    print(f"{total} files, {total - len(bad)} agree, {len(bad)} differ")
    return bad


def saves(seed: int, count: int) -> list[tuple]:
    """Random saves: sizes 8-159, every subsampling, qualities 10-99,
    speeds 3-9, each with quantiser matrices, tune=iq, a film-grain test
    vector (alone or with QMs) or a denoise level in turn, every 7th as
    premultiplied RGBA; each held to dav1d's planes and Pillow's RGB."""
    from mmtrs_tpu_torch.utils import avif

    rng = np.random.default_rng(seed)
    bad, refused = [], 0
    for i in range(count):
        h, w = int(rng.integers(8, 160)), int(rng.integers(8, 160))
        img = photo(h, w, int(rng.integers(0, 1000)))
        sub = str(rng.choice(["4:2:0", "4:4:4", "4:2:2", "4:0:0"]))
        q, sp = int(rng.integers(10, 100)), int(rng.integers(3, 10))
        lo = int(rng.integers(0, 16))
        hi = int(rng.integers(lo, 16))
        opts = [[("enable-qm", "1"), ("qm-min", str(lo)), ("qm-max", str(hi))], [("tune", "iq")],
                [("film-grain-test", str(int(rng.integers(1, 17))))],
                [("film-grain-test", str(int(rng.integers(1, 17)))), ("enable-qm", "1")],
                [("denoise-noise-level", str(int(rng.integers(5, 60))))]][i % 5]
        kw = dict(subsampling=sub, quality=q, speed=sp, advanced=opts)
        if i % 7 == 0:
            img, kw = rgba(img), {**kw, "alpha_premultiplied": True}
        data = _save(img, **kw)
        what = _agree(data)
        if what is None and _pillow_or_none(data) is None:
            refused += 1
            continue
        if what is None:
            planes = avif.planes_of(data)[0]
            if not all(np.array_equal(g, r) for g, r in zip(planes, ao.decode(data)["planes"])):
                what = "planes differ from dav1d's"
        if what:
            bad.append((i, h, w, kw, what))
    print(f"{count} saves, {count - len(bad) - refused} equal, {refused} refused by both, {len(bad)} differ")
    return bad


def jit_types() -> list[tuple]:
    from tests.test_torch_codec_corners import _with_entry_type

    bad, total = [], 0
    with np.load(ROOT / "mmtrs_tpu_torch" / "testdata" / "corners_goldens.npz") as z:
        files = {f: z[f].tobytes() for f in z.files if f.startswith("jit_") and f.endswith(".tif")}
    for name, data in sorted(files.items()):
        bo = "<" if data[:2] == b"II" else ">"
        ifd = struct.unpack(bo + "I", data[4:8])[0]
        tags = [struct.unpack(bo + "H", data[ifd + 2 + 12 * k:ifd + 4 + 12 * k])[0]
                for k in range(struct.unpack(bo + "H", data[ifd:ifd + 2])[0])]
        for tag in tags:
            for typ in range(1, 19):
                total += 1
                what = _agree(_with_entry_type(data, tag, typ))
                if what:
                    bad.append((name, tag, typ, what))
    print(f"{total} files, {total - len(bad)} agree, {len(bad)} differ")
    return bad


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("sweep", choices=["avis", "goldens", "saves", "jit-types"])
    ap.add_argument("args", nargs="*", type=int)
    a = ap.parse_args()
    if a.sweep == "avis":
        with np.load(cs.AVIF2_GOLDENS) as z:
            files = {f: z[f].tobytes() for f in z.files if f.startswith("animated") and not f.endswith(".pil")}
        bad = mutated(files, 1000, 196)
    elif a.sweep == "goldens":
        n = a.args[0]
        with np.load(getattr(cs, GOLDENS[n])) as z:
            files = {f: z[f].tobytes() for f in z.files if not f.endswith(".pil")}
        bad = mutated(files, 1000 * (n + 1), 40)
    elif a.sweep == "saves":
        bad = saves(*a.args[:2])
    else:
        bad = jit_types()
    for b in bad:
        print(b)
    return 0


if __name__ == "__main__":
    sys.exit(main())
