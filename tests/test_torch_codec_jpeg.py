"""The port's own JPEG decoder (``mmtrs_tpu_torch/csrc/host/jpeg.cpp``) held
to Pillow 12.1 on the CPU, bit for bit: lossless (SOF3) and arithmetic-coded
(SOF9, SOF10) frames, through ``decode_image``, ``decode_paths`` and the
CLI twin's chunk decoder, and the frames Pillow refuses, each refused naming
itself.

The goldens (``mmtrs_tpu_torch/testdata/jpeg_goldens.npz``, written by
``python -m tests.test_torch_codec_jpeg``) hold each file and Pillow's
``convert("RGB")`` of it, or the fact that Pillow refuses it:

- lossless streams from ``tests/jpeg_streams.py``'s writer: predictors 1-7,
  point transforms 0 and 2, restarts, 1, 3 and 4 components, ids 1,2,3 and
  'R','G','B', interleaved and not, subsampled, odd sizes, a damaged code;
- arithmetic-coded streams from the system libjpeg (``_ARITH_TOOL``, built
  with g++): 4:4:4, 4:2:2, 4:2:0, 4:4:0, 4:1:1, gray, CMYK, YCCK and RGB,
  sequential and progressive, restarts, non-default DAC conditioning, one
  byte flipped mid-scan;
- BLP1 files around RGB, CMYK, YCCK and lossless JPEGs (a BLP1 header
  written by hand);
- the refusals: a lossless frame asking for colour conversion (JFIF, Adobe
  transform 1 and 2, YCCK), 6- and 12-bit precision, cut streams (and a
  lossless one without EOI), SOF11,
  the hierarchical SOF5-7 and SOF13-15 (with and without DHP), each coded as
  its marker says (``jpeg_streams.flat_frame``);
- two 1024x768 arithmetic 4:2:0 uploads (sequential, progressive) of the
  phone photo of webp_goldens.npz and a 12 MP one (held by SHA-256 and
  shape), for chip_smoke.py's phase 9.

Pillow reads a file in 64 KiB blocks and libjpeg's arithmetic decoder
cannot wait for the next one, so stock Pillow 12.1 raises "broken data
stream" on an arithmetic-coded file whose scan data crosses a block
boundary: the goldens hold Pillow's decode with the whole file in one block
(``decodermaxblock`` raised), which the port gives, and mark the files that
stock Pillow refuses.
"""

from __future__ import annotations

import hashlib
import io
import re
import struct
import subprocess
from functools import cache
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from mmtrs_tpu_torch.synth import synth_teeth
from tests.jpeg_streams import adobe, flat_frame, jfif, lossless_jpeg

ROOT = Path(__file__).resolve().parent.parent
GOLDENS = ROOT / "mmtrs_tpu_torch" / "testdata" / "jpeg_goldens.npz"
WEBP_GOLDENS = ROOT / "mmtrs_tpu_torch" / "testdata" / "webp_goldens.npz"
ARCHIVE_SHAPE = (3024, 4032)  # a 12 MP phone photo
ARCHIVE = "arith_420_3024x4032_q80.jpg"
UPLOADS = ("upload_arith_420_1024x768.jpg", "upload_arith_420_prog_1024x768.jpg")

_ARITH_TOOL = r"""
// jpeg_tool <raw> <h> <w> <comps> <out.jpg> <progressive> <quality> <hs> <vs> <restart>
//           <dc L> <dc U> <ac K> <space: - | rgb | cmyk | ycck> <arithmetic 0|1>
// writes the raw samples (gray, RGB or CMYK) as a JPEG: the first
// component sampled hs x vs (YCCK's K too), the others 1x1
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>
#include <jpeglib.h>
int main(int argc, char** argv) {
    int h = atoi(argv[2]), w = atoi(argv[3]), nc = atoi(argv[4]);
    std::vector<unsigned char> px((size_t)h * w * nc);
    FILE* f = fopen(argv[1], "rb"); fread(px.data(), 1, px.size(), f); fclose(f);
    jpeg_compress_struct ci; jpeg_error_mgr err; ci.err = jpeg_std_error(&err); jpeg_create_compress(&ci);
    FILE* o = fopen(argv[5], "wb"); jpeg_stdio_dest(&ci, o);
    ci.image_width = w; ci.image_height = h; ci.input_components = nc;
    ci.in_color_space = nc == 1 ? JCS_GRAYSCALE : nc == 3 ? JCS_RGB : JCS_CMYK;
    jpeg_set_defaults(&ci); jpeg_set_quality(&ci, atoi(argv[7]), TRUE);
    if (!strcmp(argv[14], "ycck")) jpeg_set_colorspace(&ci, JCS_YCCK);
    if (!strcmp(argv[14], "rgb")) jpeg_set_colorspace(&ci, JCS_RGB);
    ci.arith_code = atoi(argv[15]);
    ci.comp_info[0].h_samp_factor = atoi(argv[8]); ci.comp_info[0].v_samp_factor = atoi(argv[9]);
    for (int c = 1; c < ci.num_components; ++c) { ci.comp_info[c].h_samp_factor = 1; ci.comp_info[c].v_samp_factor = 1; }
    if (!strcmp(argv[14], "ycck")) { ci.comp_info[3].h_samp_factor = atoi(argv[8]); ci.comp_info[3].v_samp_factor = atoi(argv[9]); }
    ci.restart_interval = atoi(argv[10]);
    for (int t = 0; t < 16; ++t) { ci.arith_dc_L[t] = atoi(argv[11]); ci.arith_dc_U[t] = atoi(argv[12]); ci.arith_ac_K[t] = atoi(argv[13]); }
    if (atoi(argv[6])) jpeg_simple_progression(&ci);
    jpeg_start_compress(&ci, TRUE);
    while (ci.next_scanline < ci.image_height) { JSAMPROW r = &px[(size_t)ci.next_scanline * w * nc]; jpeg_write_scanlines(&ci, &r, 1); }
    jpeg_finish_compress(&ci); jpeg_destroy_compress(&ci); fclose(o);
    return 0;
}
"""


class JpegTool:
    """The system libjpeg's encoder as a small program built with g++ (it
    has C_ARITH_CODING_SUPPORTED), writing under ``workdir``."""

    def __init__(self, workdir: Path):
        self.dir = workdir
        src, self.exe = workdir / "jpeg_tool.cpp", workdir / "jpeg_tool"
        src.write_text(_ARITH_TOOL)
        subprocess.run(["g++", "-O2", str(src), "-o", str(self.exe), "-ljpeg"], check=True, capture_output=True)

    def __call__(self, px: np.ndarray, progressive: bool = False, quality: int = 90, sampling: tuple = (2, 2),
                 restart: int = 0, dac: tuple = (0, 1, 5), space: str = "-", arithmetic: bool = True) -> bytes:
        h, w = px.shape[:2]
        nc = 1 if px.ndim == 2 else px.shape[2]
        raw, out = self.dir / "in.raw", self.dir / "out.jpg"
        raw.write_bytes(np.ascontiguousarray(px).tobytes())
        args = [h, w, nc, out, int(progressive), quality, *sampling, restart, *dac, space, int(arithmetic)]
        subprocess.run([str(self.exe), str(raw), *map(str, args)], check=True)
        return out.read_bytes()


def blp1(jpeg: bytes, w: int, h: int, split: int) -> bytes:
    """A BLP1 file (compression 0, JPEG) written by hand: the JPEG's first
    ``split`` bytes as the shared header, the rest as the first mipmap after
    4 bytes of padding."""
    offsets = [160 + split + 4] + [0] * 15
    lengths = [len(jpeg) - split] + [0] * 15
    return (b"BLP1" + struct.pack("<iIIIiI", 0, 0, w, h, 5, 0) + struct.pack("<16I", *offsets)
            + struct.pack("<16I", *lengths) + struct.pack("<I", split) + jpeg[:split] + b"\0" * 4 + jpeg[split:])


def _tooth(h: int, w: int, seed: int) -> np.ndarray:
    """A synthetic tooth with noise, so the entropy coders see every kind of
    value."""
    t = synth_teeth(1, (max(h, 32), max(w, 32)), seed=seed)[0][:h, :w].astype(np.int64)
    noise = np.random.default_rng(seed).integers(-24, 25, t.shape)
    return np.clip(t + noise, 0, 255).astype(np.uint8)


def _flip(data: bytes, frac: float) -> bytes:
    """One byte of the first scan's data, at ``frac`` of it, XOR 0x5A."""
    sos = data.find(b"\xff\xda")
    i = sos + 20 + int((len(data) - sos - 22) * frac)
    return data[:i] + bytes([data[i] ^ 0x5A]) + data[i + 1:]


def _phone() -> np.ndarray:
    """The 1024x768 phone photo of webp_goldens.npz (Pillow's decode of its
    WebP, by SHA-256), as chip_smoke.py's uploads use it."""
    with np.load(WEBP_GOLDENS) as z:
        return np.asarray(Image.open(io.BytesIO(z["phone_1024x768_q90.webp"].tobytes())).convert("RGB"))


def lossless_files() -> dict[str, bytes]:
    rgb, odd = _tooth(21, 29, 3), _tooth(19, 23, 4)
    cmyk = np.concatenate([rgb, _tooth(21, 29, 5)[..., :1]], -1)
    out = {f"lossless_p{p}.jpg": lossless_jpeg(odd, p) for p in range(1, 8)}
    out.update({
        "lossless_p6_pt2.jpg": lossless_jpeg(rgb, 6, pt=2),
        "lossless_p7_restart2.jpg": lossless_jpeg(rgb, 7, restart_rows=2),
        "lossless_p4_restart1_separate.jpg": lossless_jpeg(rgb, 4, restart_rows=1, interleaved=False),
        "lossless_p5_separate.jpg": lossless_jpeg(odd, 5, interleaved=False),
        "lossless_gray_p2.jpg": lossless_jpeg(rgb[..., 1], 2),
        "lossless_cmyk_p3.jpg": lossless_jpeg(cmyk, 3),
        "lossless_ids_rgb.jpg": lossless_jpeg(rgb, 1, ids=(82, 71, 66)),
        "lossless_adobe0.jpg": lossless_jpeg(rgb, 1, markers=adobe(0)),
        "lossless_ids_567.jpg": lossless_jpeg(rgb, 1, ids=(5, 6, 7)),
        "lossless_420.jpg": lossless_jpeg(odd, 1, sampling=[(2, 2), (1, 1), (1, 1)]),
        "lossless_422_separate_restart.jpg": lossless_jpeg(rgb, 6, restart_rows=1, interleaved=False,
                                                           sampling=[(2, 1), (1, 1), (1, 1)]),
        "lossless_440_restart.jpg": lossless_jpeg(rgb, 4, restart_rows=1, sampling=[(1, 2), (1, 1), (1, 1)]),
        "lossless_1x1.jpg": lossless_jpeg(rgb[:1, :1], 1),
        "lossless_damaged_code.jpg": lossless_jpeg(odd, 1, damage=40),
    })
    cut = lossless_jpeg(rgb, 1)
    out.update({
        "refused_lossless_jfif.jpg": lossless_jpeg(rgb, 1, markers=jfif()),
        "refused_lossless_adobe1.jpg": lossless_jpeg(rgb, 1, markers=adobe(1)),
        "refused_lossless_adobe2.jpg": lossless_jpeg(rgb, 1, markers=adobe(2)),
        "refused_lossless_ycck.jpg": lossless_jpeg(cmyk, 1, markers=adobe(2)),
        "refused_precision_6.jpg": lossless_jpeg(rgb, 1, precision=6),
        "refused_precision_12.jpg": lossless_jpeg(rgb, 1, precision=12),
        "refused_lossless_cut.jpg": cut[: len(cut) // 2],
        # libjpeg's bit reader looks up to 7 bytes ahead: without EOI it runs
        # into the end of the file, so Pillow finds it truncated
        "refused_lossless_no_eoi.jpg": lossless_jpeg(odd, 1, eoi=False),
    })
    for marker in (0xC5, 0xC6, 0xC7, 0xCB, 0xCD, 0xCE, 0xCF):
        out[f"refused_sof{marker - 0xC0}.jpg"] = flat_frame(marker, dhp=False)
        if marker != 0xCB:
            out[f"refused_sof{marker - 0xC0}_dhp.jpg"] = flat_frame(marker)
    return out


def arithmetic_files(tool: JpegTool) -> dict[str, bytes]:
    t, small = _tooth(61, 83, 7), _tooth(19, 23, 8)
    cmyk = np.concatenate([t, _tooth(61, 83, 9)[..., :1]], -1)
    sampling = {"444": (1, 1), "422": (2, 1), "420": (2, 2), "440": (1, 2), "411": (4, 1)}
    out = {}
    for name, s in sampling.items():
        out[f"arith_{name}.jpg"] = tool(t, sampling=s)
        out[f"arith_{name}_prog.jpg"] = tool(t, True, sampling=s)
    out.update({
        "arith_420_19x23.jpg": tool(small),
        "arith_411_prog_19x23.jpg": tool(small, True, sampling=(4, 1)),
        "arith_gray.jpg": tool(t[..., 0]),
        "arith_gray_prog.jpg": tool(t[..., 0], True),
        "arith_cmyk.jpg": tool(cmyk, sampling=(1, 1), space="cmyk"),
        "arith_ycck_prog.jpg": tool(cmyk, True, space="ycck"),
        "arith_rgb.jpg": tool(t, sampling=(1, 1), space="rgb"),
        "arith_420_restart3.jpg": tool(t, restart=3),
        "arith_422_prog_restart2.jpg": tool(t, True, sampling=(2, 1), restart=2),
        "arith_dac.jpg": tool(t, quality=75, dac=(2, 5, 20)),
        "arith_dac_prog.jpg": tool(t, True, dac=(1, 3, 2)),
    })
    out["arith_flipped.jpg"] = _flip(out["arith_420.jpg"], 0.4)
    out["arith_flipped_prog.jpg"] = _flip(out["arith_420_prog.jpg"], 0.5)
    seq = out["arith_420.jpg"]
    out["refused_arith_cut.jpg"] = seq[: len(seq) * 2 // 3]
    return out


def blp_files(tool: JpegTool) -> dict[str, bytes]:
    # noise-free teeth: on the card a baseline JPEG inside stays on nvJPEG,
    # held to chip_smoke.py's JPEG bars, which were set on such images
    t = synth_teeth(1, (61, 83), seed=10)[0]
    cmyk = np.concatenate([t, synth_teeth(1, (61, 83), seed=11)[0][..., :1]], -1)
    buf = io.BytesIO()
    Image.fromarray(t).save(buf, "JPEG", quality=90)
    rgb_jpeg = buf.getvalue()
    buf = io.BytesIO()
    Image.fromarray(t).convert("CMYK").save(buf, "JPEG", quality=90)
    return {
        "blp1_jpeg_rgb.blp": blp1(rgb_jpeg, 83, 61, 300),
        "blp1_jpeg_cmyk.blp": blp1(buf.getvalue(), 83, 61, 300),
        "blp1_jpeg_ycck.blp": blp1(tool(cmyk, space="ycck", arithmetic=False), 83, 61, 250),
        "blp1_arith_ycck.blp": blp1(tool(cmyk, True, space="ycck"), 83, 61, 250),
        "blp1_lossless.blp": blp1(lossless_jpeg(t, 1), 83, 61, 120),
    }


def large_files(tool: JpegTool) -> dict[str, bytes]:
    phone = _phone()
    archive = synth_teeth(1, ARCHIVE_SHAPE, seed=25, angles_deg=[30.0])[0]
    return {UPLOADS[0]: tool(phone, quality=85), UPLOADS[1]: tool(phone, True, quality=85),
            ARCHIVE: tool(archive, quality=80)}


def golden_files(workdir: Path, large: bool = True) -> dict[str, bytes]:
    tool = JpegTool(workdir)
    out = {**lossless_files(), **arithmetic_files(tool), **blp_files(tool)}
    if large:
        out.update(large_files(tool))
    return out


def pillow_decode(data: bytes, whole: bool = True) -> np.ndarray | str:
    """Pillow's ``convert("RGB")`` (with the whole file in one read block
    unless ``whole`` is False), or its error."""
    try:
        im = Image.open(io.BytesIO(data))
        if whole:
            im.decodermaxblock = len(data) + 1
        return np.asarray(im.convert("RGB"))
    except Exception as e:  # noqa: BLE001 (Pillow's own error types)
        return f"{type(e).__name__}: {re.sub(r' at 0x[0-9a-f]+', '', str(e))}"


def write_goldens(path: Path = GOLDENS) -> int:
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        files = golden_files(Path(d))
    arrays = {}
    for name, data in sorted(files.items()):
        arrays[name] = np.frombuffer(data, np.uint8)
        want = pillow_decode(data)
        if isinstance(want, str):
            arrays[f"{name}.refused"] = np.frombuffer(want.encode(), np.uint8)
        elif name in (ARCHIVE, *UPLOADS):
            arrays[f"{name}.sha256"] = np.frombuffer(hashlib.sha256(want.tobytes()).digest(), np.uint8)
            arrays[f"{name}.shape"] = np.array(want.shape, np.int64)
        else:
            arrays[f"{name}.pil"] = want
        if not isinstance(want, str) and isinstance(pillow_decode(data, whole=False), str):
            arrays[f"{name}.stock_refused"] = np.ones(1, np.uint8)
    np.savez_compressed(path, **arrays)
    return len(files)


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------

# what each refusal's error names
REASONS = {
    "refused_lossless_jfif.jpg": "colour conversion", "refused_lossless_adobe1.jpg": "colour conversion",
    "refused_lossless_adobe2.jpg": "colour conversion", "refused_lossless_ycck.jpg": "colour conversion",
    "refused_precision_6.jpg": "cannot handle 6-bit", "refused_precision_12.jpg": "cannot handle 12-bit",
    "refused_lossless_cut.jpg": "truncated", "refused_lossless_no_eoi.jpg": "truncated",
    "refused_arith_cut.jpg": "arithmetic-coded data ends early",
    "refused_sof11.jpg": "lossless arithmetic-coded JPEG \\(SOF11\\)",
    **{f"refused_sof{k}.jpg": f"hierarchical JPEG \\(SOF{k}\\)" for k in (5, 6, 7, 13, 14, 15)},
    **{f"refused_sof{k}_dhp.jpg": "hierarchical JPEG \\(a DHP marker\\)" for k in (5, 6, 7, 13, 14, 15)},
}


@cache
def _goldens() -> dict[str, np.ndarray]:
    if not GOLDENS.exists():  # before the first ``python -m tests.test_torch_codec_jpeg``
        return {}
    with np.load(GOLDENS) as z:
        return {f: z[f] for f in z.files}


def _names(kind: str = "") -> list[str]:
    return sorted(f for f in _goldens() if "." in f and f.rsplit(".", 1)[1] in ("jpg", "blp")
                  and f.startswith(kind))


def _decoded() -> list[str]:
    return [n for n in _names() if f"{n}.refused" not in _goldens()]


def _same(name: str, got: np.ndarray) -> bool:
    g = _goldens()
    if f"{name}.pil" in g:
        return got.shape == g[f"{name}.pil"].shape and np.array_equal(got, g[f"{name}.pil"])
    return (hashlib.sha256(np.ascontiguousarray(got).tobytes()).digest() == g[f"{name}.sha256"].tobytes()
            and got.shape == tuple(g[f"{name}.shape"]))


def test_goldens_are_small_and_regenerate_bit_for_bit(tmp_path):
    """The committed file is under 1 MB beside its 12 MP JPEG and is what
    the writers, the system libjpeg and Pillow 12.1 give now: the
    hand-written files byte for byte, Pillow's answer on every file."""
    g = _goldens()
    assert GOLDENS.stat().st_size - g[ARCHIVE].size < 1 << 20
    fresh = golden_files(tmp_path)
    assert sorted(fresh) == _names()
    for name, data in fresh.items():
        if name.startswith(("lossless", "refused_lossless", "refused_precision", "refused_sof")):
            assert g[name].tobytes() == data, name
        want = pillow_decode(g[name].tobytes())
        if isinstance(want, str):
            assert want == g[f"{name}.refused"].tobytes().decode(), name
        else:
            assert _same(name, want), name
        stock = pillow_decode(g[name].tobytes(), whole=False)
        assert (f"{name}.stock_refused" in g) == (isinstance(stock, str) and not isinstance(want, str)), name
    assert set(REASONS) == {n for n in _names() if f"{n}.refused" in g}


@pytest.mark.parametrize("name", _decoded())
def test_golden_decodes_equal_to_pillow(name):
    """Every file Pillow decodes: ``decode_image`` on the CPU gives Pillow's
    pixels, bit for bit; ``sniff`` names Pillow's format."""
    from mmtrs_tpu_torch.utils.codec import decode_image, sniff

    data = _goldens()[name].tobytes()
    assert _same(name, decode_image(data, "cpu").numpy())
    assert sniff(data) == ("BLP" if name.endswith(".blp") else "JPEG")


@pytest.mark.parametrize("name", sorted(REASONS))
def test_refusal_names_itself(name):
    """Every file stock Pillow refuses, the port refuses with a ValueError
    that names the reason."""
    from mmtrs_tpu_torch.utils.codec import decode_image, sniff

    data = _goldens()[name].tobytes()
    assert isinstance(pillow_decode(data, whole=False), str)
    with pytest.raises(ValueError, match=REASONS[name]):
        decode_image(data, "cpu")
    assert sniff(data) == ("unknown" if "precision" in name else "JPEG")


def test_stock_pillow_refuses_the_large_arithmetic_files():
    """The 12 MP and 1024x768 arithmetic files cross Pillow's 64 KiB read
    block: stock Pillow raises "broken data stream"; the port decodes them
    as Pillow does with the whole file in one block."""
    g = _goldens()
    for name in (ARCHIVE, *UPLOADS):
        assert f"{name}.stock_refused" in g
        assert "broken data stream" in pillow_decode(g[name].tobytes(), whole=False)
    small = [n for n in _decoded() if n not in (ARCHIVE, *UPLOADS)]
    assert not any(f"{n}.stock_refused" in g for n in small)


def test_decode_paths_and_the_cli_chunk_agree(tmp_path):
    """A folder of every small golden JPEG and a baseline one:
    ``decode_paths`` gives each decoded file Pillow's pixels (status 0) and
    each refused one status 2, on three threads; the CLI twin's chunk
    decoder, which rejected lossless files as ``decode_error`` before the
    own decoder, rejects only the refused files."""
    import torch

    from mmtrs_tpu_torch.utils.codec import decode_paths
    from mmtrs_tpu_torch.utils.images import _decode_chunk

    g = _goldens()
    names = [n for n in _names() if n.endswith(".jpg") and n not in (ARCHIVE, *UPLOADS)]
    paths = []
    for n in names:
        (tmp_path / n).write_bytes(g[n].tobytes())
        paths.append(tmp_path / n)
    buf = io.BytesIO()
    Image.fromarray(_tooth(40, 50, 1)).save(buf, "JPEG", quality=90)
    (tmp_path / "baseline.jpg").write_bytes(buf.getvalue())
    imgs, status = decode_paths([*paths, tmp_path / "baseline.jpg"], threads=3)
    for n, img, st in zip(names, imgs, status):
        assert st == (2 if n in REASONS else 0), n
        assert img is None if n in REASONS else _same(n, img.numpy()), n
    assert status[-1] == 0 and np.array_equal(imgs[-1].numpy(), pillow_decode(buf.getvalue()))
    _, ok, rejected = _decode_chunk([*paths, tmp_path / "baseline.jpg"], 0, torch.device("cpu"))
    assert [p.name for p, why in rejected] == [n for n in names if n in REASONS]
    assert all(why == "decode_error" for _, why in rejected) and ok[-1].name == "baseline.jpg"


def test_own_frames_never_reach_libjpeg_or_nvjpeg(monkeypatch):
    """Lossless and arithmetic frames (the goldens here and the two of
    pillow_goldens.npz) decode with libjpeg's and nvJPEG's builds made to
    fail, and a damaged one raises the own decoder's ValueError: no route
    falls back to another backend."""
    import torch

    from mmtrs_tpu_torch import _build
    from mmtrs_tpu_torch.utils.codec import decode_image

    def boom():
        raise AssertionError("another backend was asked")

    monkeypatch.setattr(_build, "jpeg_library", boom)
    monkeypatch.setattr(_build, "nvjpeg_library", boom)
    for name in ("lossless_p3.jpg", "arith_420_prog.jpg", "arith_flipped.jpg", "blp1_arith_ycck.blp"):
        assert _same(name, decode_image(_goldens()[name].tobytes(), "cpu").numpy()), name
    with np.load(ROOT / "mmtrs_tpu_torch" / "testdata" / "pillow_goldens.npz") as z:
        for name in ("jpeg_arithmetic.jpg", "jpeg_arithmetic_progressive.jpg"):
            assert torch.equal(decode_image(z[name].tobytes(), "cpu"), torch.from_numpy(z[f"{name}.pil"]))
    with pytest.raises(ValueError, match="truncated"):
        decode_image(_goldens()["refused_lossless_cut.jpg"].tobytes(), "cpu")


def test_frame_walk_agrees_with_the_decoder():
    """``jpeg_goes_own``, which routes a JPEG (its frame marker, and for a
    Huffman progressive frame its scan headers), sends a file to the own
    decoder exactly when the decoder's own parse does not leave it to
    libjpeg (status 1)."""
    import ctypes

    from mmtrs_tpu_torch import _build
    from mmtrs_tpu_torch.utils.codec import jpeg_goes_own

    lib = _build.jpeg_own_library()
    buf = io.BytesIO()
    Image.fromarray(_tooth(20, 20, 2)).save(buf, "JPEG", progressive=True)
    files = {n: _goldens()[n].tobytes() for n in _names() if n.endswith(".jpg")}
    files.update({"baseline": buf.getvalue(), **{f"flat_{m:x}": flat_frame(m) for m in (0xC0, 0xC1, 0xC2, 0xC9)}})
    for name, data in files.items():
        out, dims, msg = ctypes.c_void_p(), np.zeros(4, np.int32), ctypes.create_string_buffer(256)
        status = lib.mmtrs_jpeg_own_decode(data, len(data), 0, ctypes.addressof(out), dims.ctypes.data,
                                           ctypes.addressof(msg))
        lib.mmtrs_jpeg_own_free(out)
        assert jpeg_goes_own(data) == (status != 1), (name, status, msg.value)


CUT_AND_MUTATED = ["lossless_p7_restart2.jpg", "lossless_420.jpg", "arith_420_restart3.jpg", "arith_422_prog.jpg",
                   "arith_ycck_prog.jpg"]


@pytest.mark.parametrize("name", CUT_AND_MUTATED)
def test_cut_and_mutated_files_agree_with_pillow(name):
    """60 variants of a golden (a byte flipped, set to 0xFF, or the file
    cut) decode equal to Pillow's decode, or both refuse."""
    from mmtrs_tpu_torch.utils.codec import decode_image

    data = _goldens()[name].tobytes()
    rng = np.random.default_rng(sum(data[:64]))
    sos = data.find(b"\xff\xda")
    for k in range(60):
        b = bytearray(data)
        if k % 3 == 0:
            i = int(rng.integers(sos, len(b)))
            b[i] ^= int(rng.integers(1, 256))
        elif k % 3 == 1:
            i = int(rng.integers(sos + 4, len(b) - 2))
            b[i] = 0xFF
        else:
            b = b[: int(rng.integers(2, len(b)))]
        want = pillow_decode(bytes(b), whole=False)
        try:
            got = decode_image(bytes(b), "cpu").numpy()
        except ValueError as e:
            assert isinstance(want, str), (name, k, str(e))
            continue
        assert not isinstance(want, str) and np.array_equal(got, want), (name, k, want if isinstance(want, str) else "")


def test_block_smoothing_is_refused_by_name():
    """A progressive arithmetic frame with only its DC scan: Pillow smooths
    the blocks (libjpeg's ``decompress_smooth_data``) and decodes it; so
    does the port, once refused by name, now equal to Pillow
    (tests/test_torch_codec_corners.py holds more progressions)."""
    from mmtrs_tpu_torch.utils.codec import decode_image

    data = flat_frame(0xCA)
    want = pillow_decode(data, whole=False)
    assert not isinstance(want, str)
    np.testing.assert_array_equal(decode_image(data, "cpu").numpy(), want)


def test_a_bomb_is_refused_before_decoding():
    """A lossless header of 20000x20000 pixels is refused with the pixel
    limit's error before its (missing) scan data is read."""
    from mmtrs_tpu_torch.utils.codec import decode_image
    from tests.jpeg_streams import SOI, dht, sof, sos

    data = SOI + dht(0) + sof(0xC3, 20000, 20000, [(1, 1, 1)]) + sos([1], 1) + b"\0" * 16
    with pytest.raises(ValueError, match="exceeds the limit"):
        decode_image(data, "cpu")


def test_blp1_jpeg_decodes_on_the_callers_device(monkeypatch):
    """BLP1's JPEG decodes on the device the caller names: with a card
    reported visible, ``decode_image(..., "cpu")`` builds no nvJPEG and
    gives Pillow's pixels (CMYK and YCCK as BlpImagePlugin reads them)."""
    import torch

    from mmtrs_tpu_torch import _build
    from mmtrs_tpu_torch.utils.codec import decode_image

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(_build, "nvjpeg_library", lambda: (_ for _ in ()).throw(AssertionError("nvJPEG")))
    for name in _names("blp1"):
        got = decode_image(_goldens()[name].tobytes(), "cpu")
        assert got.device.type == "cpu" and _same(name, got.numpy()), name


if __name__ == "__main__":
    print(f"wrote {write_goldens()} goldens to {GOLDENS}")
