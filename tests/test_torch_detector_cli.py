"""The port's preprocessing CLI with ``--model_path`` beside the JAX
package's ``run_pipeline.py --model_path``, on the CPU, over one folder:
three 512² synthetic teeth and a gray photo. The checkpoint is a full-width
ResNet-50-FPN (the recipe's img_size 128, 91 classes) from the port's
``fake_state_dict`` with biases planted so that detections pass the gates,
saved as JAX's CLI reads it (Orbax + recipe, through JAX's
``convert_state_dict``) with the npz the port reads beside it
(scripts/export_npz_checkpoints.py).

Both CLIs crop with the learned segmenter: the same ``seg_valid`` per file
and outputs within the CLI tests' bar (tests/test_torch_cli.py: within 2
levels on ≥ 99.9 % of values, max ≤ 32) of JAX's TPU route, with
``--no_rotate`` so that deskew's route gap (pinned there) stays out. A
checkpoint that fails to load takes the saliency segmenter in both, with
JAX's warning. The segmenter-equivalence twin gives the JAX script's
report on a cut of its scenes.
"""

import importlib.util
import json
from pathlib import Path

import jax
import numpy as np
import pytest

from tests.synth import synth_images
from tests.test_torch_cli import _jax_tpu_route, _log, _run, _within_bar


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """The Orbax checkpoint and its npz, biases planted."""
    from mmtrs_tpu.models.detection import convert_state_dict
    from mmtrs_tpu.utils.checkpoint import save_checkpoint
    from mmtrs_tpu_torch.models.detection import DetectorConfig, fake_state_dict
    from scripts.export_npz_checkpoints import export_folder

    root = tmp_path_factory.mktemp("detector")
    sd = fake_state_dict(DetectorConfig(), seed=0)
    sd["roi_heads.box_predictor.cls_score.bias"][1] += 6.0
    sd["roi_heads.mask_predictor.mask_fcn_logits.bias"][1] += 4.0
    base = root / "weights" / "mask_rcnn_molar"
    save_checkpoint(base, convert_state_dict(sd), recipe={"kind": "maskrcnn_resnet50_fpn", "img_size": 128,
                                                         "num_classes": 91})
    assert export_folder(root / "weights") == [base.with_name(base.name + ".npz")]
    return base


@pytest.fixture(scope="module")
def runs(checkpoint, tmp_path_factory):
    import run_pipeline
    from mmtrs_tpu.utils import images as jimages
    from mmtrs_tpu_torch.cli import run_pipeline as port_cli

    root = tmp_path_factory.mktemp("detector_cli")
    in_dir = root / "in"
    in_dir.mkdir()
    imgs = synth_images(3, 512, seed=21)
    for i in range(3):
        jimages.save_jpeg(in_dir / f"{i}.jpg", imgs[i])
    gray = np.repeat(synth_images(1, 512, seed=22)[0][..., 1:2], 3, axis=2)
    jimages.save_jpeg(in_dir / "gray.jpg", gray)
    mp = pytest.MonkeyPatch()
    out = {}
    try:
        for name, main, mod, extra in (("jax", run_pipeline.main, jimages, []),
                                       ("port", port_cli.main, port_cli, ["--device", "cpu"])):
            argv = ["--input_dir", str(in_dir), "--output_dir", str(root / name / "out"), "--log_dir",
                    str(root / name / "logs"), "--batch_size", "4", "--no_rotate", "--model_path", str(checkpoint),
                    *extra]
            with mp.context() as m:
                if name == "jax":
                    _jax_tpu_route(m)
                rc, seen = _run(main, mod, argv, mp)
            out[name] = {"rc": rc, "seen": seen, "log": _log(root / name / "logs")}
    finally:
        mp.undo()
        jax.clear_caches()
    return out


def test_both_clis_crop_with_the_detector_alike(runs):
    jax_run, port = runs["jax"], runs["port"]
    assert jax_run["rc"] == port["rc"] == 0
    valid = {e["file"]: e["seg_valid"] for e in jax_run["log"]["entries"]}
    assert {e["file"]: e["seg_valid"] for e in port["log"]["entries"]} == valid
    assert valid == {"0.jpg": True, "1.jpg": True, "2.jpg": True, "gray.jpg": False}
    assert sorted(port["seen"]) == sorted(jax_run["seen"]) == ["0", "1", "2", "gray"]
    for stem in jax_run["seen"]:
        assert _within_bar(port["seen"][stem], jax_run["seen"][stem]), stem


@pytest.mark.parametrize("n_images", [1, 0], ids=["one_image", "empty_input"])
@pytest.mark.parametrize("which", ["jax", "port"])
def test_a_checkpoint_that_fails_to_load_takes_the_saliency_segmenter(which, n_images, tmp_path, capsys,
                                                                      monkeypatch):
    """An empty directory as --model_path: JAX's warning, then the
    saliency segmenter (preprocess_stream is handed none); with no image in
    the input folder the warning still comes first, then exit 1."""
    import run_pipeline
    from mmtrs_tpu_torch.cli import run_pipeline as port_cli

    from mmtrs_tpu.utils import images as jimages

    (tmp_path / "in").mkdir()
    (tmp_path / "bad").mkdir()
    for i, img in enumerate(synth_images(n_images, 512, seed=23)):
        jimages.save_jpeg(tmp_path / "in" / f"{i}.jpg", img)
    handed = []

    def stream(batches, cfg, segmenter=None, **kw):
        handed.append(segmenter)
        list(batches)
        return iter(())

    if which == "jax":
        import mmtrs_tpu.preprocess as jp

        monkeypatch.setattr(jp, "preprocess_stream", stream)
        main, extra = run_pipeline.main, []
    else:
        monkeypatch.setattr(port_cli, "preprocess_stream", stream)
        main, extra = port_cli.main, ["--device", "cpu"]
    rc = main(["--input_dir", str(tmp_path / "in"), "--output_dir", str(tmp_path / "out"), "--log_dir",
               str(tmp_path / "logs"), "--model_path", str(tmp_path / "bad"), *extra])
    printed = capsys.readouterr().out
    assert (rc, handed) == ((0, [None]) if n_images else (1, []))
    assert "[warn] could not load detector (" in printed and "); using saliency segmenter" in printed


def test_segmenter_equivalence_twin_equals_the_jax_script(tmp_path, monkeypatch):
    """The twin's report equals the JAX script's on the same seeded scenes
    (cut to 30 at 128², 6 metal), key for key."""
    from mmtrs_tpu_torch.cli import segmenter_equivalence as twin

    spec = importlib.util.spec_from_file_location(
        "jax_seg_eq", Path(__file__).resolve().parents[1] / "scripts" / "segmenter_equivalence.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    monkeypatch.setattr(script, "REPO", tmp_path)
    monkeypatch.setattr(script, "SIZE", 128)
    monkeypatch.setattr(script, "N_SCENES", 30)
    monkeypatch.setattr(script, "N_METAL", 6)
    monkeypatch.setattr(script.crop_window, "__defaults__", (128, 128, 15.0))  # bound to SIZE at import
    assert script.main() == 0
    want = json.loads((tmp_path / "reports" / "segmenter_equivalence.json").read_text())
    got = twin.report(30, 6, 128, device="cpu")
    for key in ("n_scenes", "img_px", "saliency_valid_rate", "box_iou", "crop_window_iou", "tooth_coverage_by_crop"):
        assert got[key] == want[key], key
    assert got["metal_gate"]["rejected_by_saliency_path"] == want["metal_gate"]["rejected_by_saliency_path"]
    out = tmp_path / "twin.json"
    monkeypatch.setattr(twin, "N_SCENES", 5)
    monkeypatch.setattr(twin, "N_METAL", 2)
    assert twin.main(["--out", str(out), "--device", "cpu"]) == 0
    assert json.loads(out.read_text())["n_scenes"] == 5
