"""The port's preprocessing CLI (``python -m mmtrs_tpu_torch.cli.run_pipeline``)
beside the JAX package's ``run_pipeline.py``, both run on the CPU over one
input directory: the JAX test's three 512² teeth and one small image
(tests/test_preprocess.py), plus a corrupt file and a 480×640 (4:3) photo.

Each CLI's outputs are kept before encoding (its ``save_jpeg`` wrapped).
The port's must equal its own ``preprocess_stream`` on the same padded
batches. The JAX CLI runs twice: on its CPU route (float chroma, deskew's
shears in f32), and on its TPU route with the Pallas kernels in interpret
mode, the route the port follows. Against the TPU route the port is held to
the bar pinned in tests/test_torch_serve.py: within 2 levels on ≥ 99.9 % of
values, max ≤ 32. On these inputs JAX's two routes disagree with each other
on the two deskewed teeth (the angle by 0.1°, and then a segmenter box),
so there the port is as far from the CPU route as the TPU route is; a test
pins which outputs those are.
"""

import json

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from tests.synth import synth_images


def _run(module_main, save_module, argv, monkeypatch):
    """Run a CLI with its ``save_jpeg`` wrapped: (rc, {stem: the u8 array
    it was given}, the log)."""
    seen = {}
    orig = save_module.save_jpeg

    def keep(path, img, quality=95):
        a = img.cpu().numpy() if isinstance(img, torch.Tensor) else np.asarray(img)
        seen[path.stem] = np.clip(a, 0, 255).astype(np.uint8)
        return orig(path, img, quality)

    with monkeypatch.context() as m:
        m.setattr(save_module, "save_jpeg", keep)
        rc = module_main(argv)
    return rc, seen


def _log(log_dir):
    (p,) = list(log_dir.glob("preprocess_*.json"))
    return json.loads(p.read_text())


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both CLIs over one input directory, each with its outputs before
    encoding."""
    import run_pipeline
    from mmtrs_tpu.utils import images as jimages
    from mmtrs_tpu_torch.cli import run_pipeline as port_cli

    root = tmp_path_factory.mktemp("cli")
    in_dir = root / "in"
    in_dir.mkdir()
    imgs = synth_images(3, 512, seed=12)
    for i in range(3):
        jimages.save_jpeg(in_dir / f"{i}.jpg", imgs[i])
    jimages.save_jpeg(in_dir / "small.jpg", synth_images(1, 64, seed=13)[0])
    (in_dir / "corrupt.jpg").write_bytes(b"\xff\xd8\xff\xe0 not a jpeg")
    wide = np.asarray(Image.fromarray(synth_images(1, 640, seed=14)[0]).crop((0, 80, 640, 560)))
    jimages.save_jpeg(in_dir / "wide.jpg", wide)

    mp = pytest.MonkeyPatch()
    try:
        out = {}
        for name, main, mod, extra in (("jax", run_pipeline.main, jimages, []),
                                       ("jax_tpu", run_pipeline.main, jimages, []),
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


def _jax_tpu_route(m):
    """The JAX package's TPU main path on the CPU: the fused CLAHE-LAB
    kernels and deskew's u8 shears through the Pallas row shift, both in
    interpret mode (as tests/test_torch_augment.py's ``jax_tpu_route``).
    Traces made before or under the patch are dropped."""
    import functools

    import mmtrs_tpu.ops.pallas.shift_kernel as sk
    import mmtrs_tpu.preprocess as jp
    from mmtrs_tpu.ops import warp as jw
    from mmtrs_tpu.ops.pallas.lab_kernels import clahe_lab_fused

    orig = sk.shift_rows_pallas
    m.setattr(sk, "shift_rows_pallas", lambda *a, **k: orig(*a, **{**k, "interpret": True}))
    m.setattr(jw, "_pallas_shift_available", lambda: True)
    m.setattr(jp, "_use_pallas", lambda: True)
    m.setattr(jp, "_lab_fused", functools.partial(clahe_lab_fused, interpret=True))
    jax.clear_caches()


def _within_bar(a, b) -> bool:
    d = np.abs(a.astype(int) - b.astype(int))
    return (d <= 2).mean() >= 0.999 and d.max() <= 32


def test_same_files_statuses_and_log_keys(runs):
    jax, port = runs["jax"], runs["port"]
    assert jax["rc"] == port["rc"] == 0
    assert port["outs"] == jax["outs"] == ["0.jpg", "1.jpg", "2.jpg", "wide.jpg"]
    assert port["log"]["processed"] == jax["log"]["processed"] == 4
    assert port["log"]["total"] == jax["log"]["total"] == 6
    assert set(port["log"]) == set(jax["log"])
    assert port["log"]["config"] == jax["log"]["config"]
    status = lambda log: {e["file"]: e["status"] for e in log["entries"]}
    assert status(port["log"]) == status(jax["log"])
    assert status(port["log"])["small.jpg"] == "rejected_min_edge"
    assert status(port["log"])["corrupt.jpg"] == "rejected_decode_error"
    keys = lambda log: sorted((e["file"], tuple(sorted(e))) for e in log["entries"])
    assert keys(port["log"]) == keys(jax["log"])
    for e in port["log"]["entries"]:
        if e["status"] == "ok":
            assert e["output"].endswith(f"/port/out/{e['file'].rsplit('.', 1)[0]}.jpg")


def test_outputs_equal_the_ports_preprocess_stream(runs):
    """Every output before encoding equals ``preprocess_stream`` on the
    same batches, padded as the CLI pads them."""
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
    status = lambda run: [(e["file"], e["status"]) for e in runs[run]["log"]["entries"]]
    assert status("jax_tpu") == status("jax") == status("port")
    for stem in seen:
        assert seen[stem].shape == jseen[stem].shape == (512, 512, 3)
        d = np.abs(seen[stem].astype(int) - jseen[stem].astype(int))
        assert (d <= 2).mean() >= 0.999 and d.max() <= 32, (stem, (d <= 2).mean(), d.max())


def test_jax_routes_disagree_on_the_deskewed_teeth(runs):
    """Against JAX's CPU route the port keeps the bar on the teeth that
    deskew leaves alone and misses it on the two it rotates, exactly where
    JAX's TPU route misses it too."""
    seen, cpu, tpu = runs["port"]["seen"], runs["jax"]["seen"], runs["jax_tpu"]["seen"]
    port_off = {k for k in seen if not _within_bar(seen[k], cpu[k])}
    tpu_off = {k for k in seen if not _within_bar(tpu[k], cpu[k])}
    assert port_off == tpu_off == {"1", "2"}
    angle = lambda run: {e["file"]: e["deskew_angle"] for e in runs[run]["log"]["entries"] if e["status"] == "ok"}
    assert {k for k, a in angle("jax").items() if a != 0.0} == {"1.jpg", "2.jpg"}
    for f, a in angle("port").items():
        assert abs(a - angle("jax_tpu")[f]) <= 1e-3, (f, a, angle("jax_tpu")[f])


def test_fallback_layers_match_jax(tmp_path, monkeypatch):
    """Nothing processed (every file too small or corrupt): both CLIs write
    contrast-stretched copies, log the same statuses, and their copies
    decode to the same pixels."""
    import run_pipeline
    from mmtrs_tpu.utils import images as jimages
    from mmtrs_tpu_torch.cli import run_pipeline as port_cli

    in_dir = tmp_path / "in"
    in_dir.mkdir()
    jimages.save_jpeg(in_dir / "small.jpg", synth_images(1, 96, seed=15)[0])
    (in_dir / "zz.png").write_bytes(b"\x89PNG\r\n\x1a\n broken")
    logs = {}
    for name, main, extra in (("jax", run_pipeline.main, []), ("port", port_cli.main, ["--device", "cpu"])):
        rc = main(["--input_dir", str(in_dir), "--output_dir", str(tmp_path / name),
                   "--log_dir", str(tmp_path / f"{name}_logs"), *extra])
        assert rc == 0
        logs[name] = _log(tmp_path / f"{name}_logs")
    assert logs["port"]["entries"] == logs["jax"]["entries"]
    assert [e["status"] for e in logs["port"]["entries"]] == [
        "rejected_min_edge", "rejected_decode_error", "fallback_enhanced", "failed"]
    assert logs["port"]["processed"] == logs["jax"]["processed"] == 1
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "port" / "small.jpg")),
                                  np.asarray(Image.open(tmp_path / "jax" / "small.jpg")))


def test_empty_input_dir_and_default_device(tmp_path):
    from mmtrs_tpu_torch.cli import run_pipeline as port_cli

    (tmp_path / "in").mkdir()
    argv = ["--input_dir", str(tmp_path / "in"), "--output_dir", str(tmp_path / "out")]
    assert port_cli.main([*argv, "--device", "cpu"]) == 1
    assert port_cli.build_parser().parse_args(argv).device is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_cli.main(argv)
