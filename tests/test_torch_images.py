"""The port's image IO (``utils/images.py``) held against the JAX package's
on the CPU: ``iter_batches`` against JAX's Pillow route
(``use_native=False``) — the same ok and rejected lists and bit-equal
batches — and ``load_image``, ``save_jpeg`` and ``list_images`` against
theirs. JAX's native route (``target_hw`` with every file a JPEG,
native/loader.cpp) resizes with half-pixel centres instead of Pillow's
BILINEAR; the port follows the Pillow route, and one test pins the
difference.
"""

import io
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from mmtrs_tpu_torch.synth import synth_teeth

ROOT = Path(__file__).resolve().parents[1]


def _write(path: Path, img: np.ndarray, fmt: str = "JPEG") -> Path:
    Image.fromarray(img).save(path, fmt, **({"quality": 90} if fmt == "JPEG" else {}))
    return path


@pytest.fixture(scope="module")
def mixed_dir(tmp_path_factory):
    """JPEGs and PNGs of mixed sizes, one below 400 px, a corrupt file and
    a grayscale PNG."""
    d = tmp_path_factory.mktemp("mixed")
    sizes = [(420, 500), (512, 512), (404, 612), (610, 410), (401, 403), (450, 450)]
    for i, s in enumerate(sizes):
        _write(d / f"a{i}.jpg", synth_teeth(1, s, seed=100 + i)[0])
    _write(d / "b_small.jpg", synth_teeth(1, (300, 500), seed=120)[0])
    _write(d / "c_png.png", synth_teeth(1, (433, 517), seed=121)[0], "PNG")
    Image.fromarray(synth_teeth(1, (408, 408), seed=122)[0][..., 0]).save(d / "d_gray.png")
    (d / "e_corrupt.jpg").write_bytes(b"\xff\xd8\xff\xe0" + b"\x17" * 300)
    return d


def _port_batches(paths, **kw):
    from mmtrs_tpu_torch.utils.images import iter_batches

    return [(ok, b.numpy(), rej) for ok, b, rej in iter_batches(paths, device="cpu", **kw)]


def _jax_batches(paths, **kw):
    from mmtrs_tpu.utils.images import iter_batches

    return list(iter_batches(paths, **kw))


def _assert_same(got, want):
    assert len(got) == len(want)
    for (ok, b, rej), (jok, jb, jrej) in zip(got, want):
        assert ok == jok and rej == jrej
        assert b.dtype == jb.dtype == np.uint8 and b.shape == jb.shape
        np.testing.assert_array_equal(b, jb)


def test_list_images_equals_jax(mixed_dir):
    from mmtrs_tpu.utils.images import IMG_EXTS as JEXTS
    from mmtrs_tpu.utils.images import list_images as jlist
    from mmtrs_tpu_torch.utils.images import IMG_EXTS, list_images

    assert IMG_EXTS == JEXTS
    assert list_images(mixed_dir) == jlist(mixed_dir)


@pytest.mark.parametrize("batch_size", [3, 16])
def test_iter_batches_mixed_sizes_equal_jax_pillow_route(mixed_dir, batch_size):
    """Batches resized to their maximum rounded up to /8 (Pillow BILINEAR),
    with a JPEG named .bmp and a real 24-bit BMP among them, and the rejects
    in order (min edge, corrupt): all equal."""
    from mmtrs_tpu_torch.utils.images import list_images

    shutil.copy(mixed_dir / "a0.jpg", mixed_dir / "f_as.bmp")  # a JPEG with a BMP suffix decodes in both
    _write(mixed_dir / "g_real.bmp", synth_teeth(1, (420, 420), seed=123)[0], "BMP")
    try:
        paths = list_images(mixed_dir)
        got = _port_batches(paths, batch_size=batch_size, min_edge=400)
        _assert_same(got, _jax_batches(paths, batch_size=batch_size, min_edge=400, use_native=False))
        assert any(mixed_dir / "g_real.bmp" in ok for ok, _, _ in got)
        rejects = {p.name: r for _, _, rej in got for p, r in rej}
        assert rejects == {"b_small.jpg": "min_edge", "e_corrupt.jpg": "decode_error"}
    finally:
        (mixed_dir / "f_as.bmp").unlink()
        (mixed_dir / "g_real.bmp").unlink()


def test_iter_batches_target_hw_equals_jax_pillow_route(mixed_dir):
    from mmtrs_tpu_torch.utils.images import list_images

    paths = list_images(mixed_dir)
    _assert_same(_port_batches(paths, batch_size=4, target_hw=(256, 320), min_edge=400),
                 _jax_batches(paths, batch_size=4, target_hw=(256, 320), min_edge=400, use_native=False))


def test_iter_batches_all_rejected_chunk(tmp_path):
    """A chunk with nothing left yields an empty batch beside its rejects,
    as JAX's does; an empty chunk list yields nothing."""
    _write(tmp_path / "s.jpg", synth_teeth(1, (100, 120), seed=130)[0])
    (tmp_path / "x.png").write_bytes(b"\x89PNG\r\n\x1a\n" + b"\x00" * 20)
    paths = sorted(tmp_path.iterdir())
    got = _port_batches(paths, batch_size=2, min_edge=400)
    want = _jax_batches(paths, batch_size=2, min_edge=400, use_native=False)
    assert [(ok, b.shape, rej) for ok, b, rej in got] == [(ok, b.shape, rej) for ok, b, rej in want]
    assert got[0][1].shape == (0, 1, 1, 3)
    assert _port_batches([], batch_size=2) == []


def test_jax_native_route_resizes_differently(tmp_path, monkeypatch):
    """With ``target_hw`` and every file a JPEG, JAX takes its native
    loader, whose half-pixel bilinear resize is not Pillow's: the port,
    which follows the Pillow route, equals ``use_native=False`` and differs
    from the native batch. The loader is built from a copy of native/ so
    that no other test's build is touched."""
    from mmtrs_tpu.utils import native_loader

    native = tmp_path / "native"
    native.mkdir()
    for f in ("loader.cpp", "Makefile"):
        shutil.copy(ROOT / "native" / f, native / f)
    monkeypatch.setattr(native_loader, "_NATIVE_DIR", native)
    monkeypatch.setattr(native_loader, "_SO", native / "build" / "libmmtrs_loader.so")
    monkeypatch.setattr(native_loader, "_lib", None)
    assert native_loader.available()
    for i in range(3):
        _write(tmp_path / f"{i}.jpg", synth_teeth(1, (240 + 16 * i, 320), seed=140 + i)[0])
    paths = sorted(tmp_path.glob("*.jpg"))
    (port,) = _port_batches(paths, batch_size=4, target_hw=(200, 264))
    (pillow,) = _jax_batches(paths, batch_size=4, target_hw=(200, 264), use_native=False)
    (nat,) = _jax_batches(paths, batch_size=4, target_hw=(200, 264), use_native=True)
    assert port[0] == pillow[0] == nat[0]
    np.testing.assert_array_equal(port[1], pillow[1])
    d = np.abs(port[1].astype(int) - nat[1].astype(int))
    assert d.max() > 0 and (d > 0).mean() > 0.05, ((d > 0).mean(), d.max())


def test_load_and_save_jpeg_equal_jax(tmp_path):
    """``load_image`` equals JAX's (Pillow's) decode; ``save_jpeg`` of a
    float image (clipped, then truncated to u8) writes a file that Pillow
    decodes to the pixels of JAX's ``save_jpeg`` of the same image."""
    from mmtrs_tpu.utils.images import load_image as jload
    from mmtrs_tpu.utils.images import save_jpeg as jsave
    from mmtrs_tpu_torch.utils.images import load_image, save_jpeg

    img = synth_teeth(1, (97, 131), seed=150)[0]
    src = _write(tmp_path / "src.jpg", img)
    np.testing.assert_array_equal(load_image(src, "cpu").numpy(), jload(src))
    f = img.astype(np.float32) * 1.3 - 20.5
    ours, theirs = save_jpeg(tmp_path / "sub" / "ours.jpg", f), jsave(tmp_path / "theirs.jpg", f)
    assert ours == tmp_path / "sub" / "ours.jpg"
    np.testing.assert_array_equal(np.asarray(Image.open(ours)), np.asarray(Image.open(theirs)))
    np.testing.assert_array_equal(np.asarray(Image.open(save_jpeg(tmp_path / "t.jpg", torch.from_numpy(f), 80))),
                                  np.asarray(Image.open(jsave(tmp_path / "j.jpg", f, 80))))
    flipped = img[::-1, ::-1]  # a numpy view with negative strides, which Pillow takes
    np.testing.assert_array_equal(np.asarray(Image.open(save_jpeg(tmp_path / "f.jpg", flipped))),
                                  np.asarray(Image.open(jsave(tmp_path / "jf.jpg", flipped))))
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "PNG")
    (tmp_path / "p.png").write_bytes(buf.getvalue())
    np.testing.assert_array_equal(load_image(tmp_path / "p.png", "cpu").numpy(), img)
