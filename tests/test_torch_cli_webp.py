"""The port's preprocessing CLI beside the JAX package's ``run_pipeline.py``
on a folder that mixes WebP files in among JPEGs: 512² teeth as JPEG, lossy
WebP and lossless WebP, a 480×640 (4:3) lossy WebP photo, a WebP below the
minimum edge and a WebP whose bitstream ends early.

The port decodes each WebP with its own C and the JAX package with Pillow,
to the same pixels, so the two CLIs list the same files and log the same
statuses: no WebP that Pillow reads is a ``rejected_decode_error``. The
outputs are held as tests/test_torch_cli.py holds the JPEG run's: equal to
the port's own ``preprocess_stream`` on the batches, and within its bar of
the JAX CLI on its TPU route (the Pallas kernels in interpret mode).
"""

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from tests.synth import synth_images
from tests.test_torch_cli import _jax_tpu_route, _log, _run


def _webp(path, img, **kw):
    Image.fromarray(img).save(path, "WEBP", **kw)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import run_pipeline
    from mmtrs_tpu.utils import images as jimages
    from mmtrs_tpu_torch.cli import run_pipeline as port_cli
    from tests.test_torch_codec_webp import _corrupt

    root = tmp_path_factory.mktemp("cli_webp")
    in_dir = root / "in"
    in_dir.mkdir()
    imgs = synth_images(3, 512, seed=22)
    jimages.save_jpeg(in_dir / "0.jpg", imgs[0])
    _webp(in_dir / "1.webp", imgs[1], quality=90)
    _webp(in_dir / "2.webp", imgs[2], lossless=True)
    wide = np.asarray(Image.fromarray(synth_images(1, 640, seed=24)[0]).crop((0, 80, 640, 560)))
    _webp(in_dir / "wide.webp", wide, quality=80)
    _webp(in_dir / "small.webp", synth_images(1, 64, seed=23)[0])
    (in_dir / "corrupt.webp").write_bytes(_corrupt()["truncated_vp8"])

    mp = pytest.MonkeyPatch()
    try:
        out = {}
        for name, main, mod, extra in (("jax_tpu", run_pipeline.main, jimages, []),
                                       ("port", port_cli.main, port_cli, ["--device", "cpu"])):
            argv = ["--input_dir", str(in_dir), "--output_dir", str(root / name / "out"),
                    "--log_dir", str(root / name / "logs"), "--batch_size", "4", *extra]
            with mp.context() as m:
                if name == "jax_tpu":
                    _jax_tpu_route(m)
                rc, seen = _run(main, mod, argv, mp)
            out[name] = {"rc": rc, "seen": seen, "log": _log(root / name / "logs"),
                         "outs": sorted(p.name for p in (root / name / "out").iterdir())}
    finally:
        mp.undo()
        jax.clear_caches()
    out["in_dir"] = in_dir
    return out


def test_same_files_and_statuses(runs):
    jax, port = runs["jax_tpu"], runs["port"]
    assert jax["rc"] == port["rc"] == 0
    assert port["outs"] == jax["outs"] == ["0.jpg", "1.jpg", "2.jpg", "wide.jpg"]
    assert port["log"]["processed"] == jax["log"]["processed"] == 4
    assert port["log"]["total"] == jax["log"]["total"] == 6
    status = lambda log: {e["file"]: e["status"] for e in log["entries"]}
    assert status(port["log"]) == status(jax["log"]) == {
        "0.jpg": "ok", "1.webp": "ok", "2.webp": "ok", "wide.webp": "ok", "small.webp": "rejected_min_edge",
        "corrupt.webp": "rejected_decode_error"}
    keys = lambda log: sorted((e["file"], tuple(sorted(e))) for e in log["entries"])
    assert keys(port["log"]) == keys(jax["log"])


def test_decoded_batches_equal_jax(runs):
    """The port's batches (its WebP decode, then Pillow's bilinear resize to
    the batch size) equal the JAX package's, on Pillow, value for value."""
    from mmtrs_tpu.utils import images as jimages
    from mmtrs_tpu_torch.utils.images import iter_batches, list_images

    paths = list_images(runs["in_dir"])
    assert paths == jimages.list_images(runs["in_dir"])
    got = list(iter_batches(paths, 4, min_edge=400, device="cpu"))
    want = list(jimages.iter_batches(paths, 4, min_edge=400))
    assert len(got) == len(want) == 2
    for (ok, batch, rej), (jok, jbatch, jrej) in zip(got, want):
        assert ok == jok and rej == jrej
        np.testing.assert_array_equal(batch.numpy(), jbatch)


def test_outputs_equal_the_ports_preprocess_stream(runs):
    from mmtrs_tpu_torch.config import PreprocessConfig
    from mmtrs_tpu_torch.preprocess import preprocess_stream
    from mmtrs_tpu_torch.utils.images import iter_batches, list_images

    def feed():
        for ok, batch, _ in iter_batches(list_images(runs["in_dir"]), 4, min_edge=400, device="cpu"):
            if len(batch):
                n = len(batch)
                yield (ok, n), torch.cat([batch, batch[-1:].expand(4 - n, -1, -1, -1)])

    n = 0
    for (ok, real), out, _ in preprocess_stream(feed(), PreprocessConfig(), device="cpu"):
        for i, p in enumerate(ok[:real]):
            np.testing.assert_array_equal(runs["port"]["seen"][p.stem], out[i], err_msg=p.name)
            n += 1
    assert n == 4


def test_outputs_within_the_bar_of_jax_tpu_route(runs):
    seen, jseen = runs["port"]["seen"], runs["jax_tpu"]["seen"]
    assert sorted(seen) == sorted(jseen) == ["0", "1", "2", "wide"]
    for stem in seen:
        assert seen[stem].shape == jseen[stem].shape == (512, 512, 3)
        d = np.abs(seen[stem].astype(int) - jseen[stem].astype(int))
        assert (d <= 2).mean() >= 0.999 and d.max() <= 32, (stem, (d <= 2).mean(), d.max())
