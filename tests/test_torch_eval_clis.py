"""The port's evaluation CLIs held against the JAX package's scripts on the
CPU: ``cli.eval_vision`` (scripts/eval_vision.py) on a tiny JAX-trained
hard checkpoint saved with Orbax and exported by
scripts/export_npz_checkpoints.py, and ``cli.evaluate_models``
(scripts/evaluate_models.py) on forests the JAX package trains and saves.

Bars: eval_vision's prediction CSV with the same rows and labels and
probabilities within 1e-5 (f32 test_cnn on both sides; read ≤ 1e-7), its
metrics within 1e-5 and the tuned threshold equal; evaluate_models' JSON
files equal (metrics rounded to 4 digits, the blend's α and threshold)."""

import json

import numpy as np
import pandas as pd
import pytest
from PIL import Image

from tests.synth import synth_images, synth_standardized


@pytest.fixture(scope="module")
def vision_case(tmp_path_factory):
    """test_cnn at 32², f32, one epoch, trained by the JAX VisionTrainer and
    saved as Orbax ``vision_hard_best`` + recipe, exported to npz; 36 rows
    (train/val/test) of JPEGs, 4 of the val and test rows at 40² so both
    CLIs resize them; one row's file missing."""
    from mmtrs_tpu.config import VisionTrainConfig
    from mmtrs_tpu.train.vision import VisionData, VisionTrainer
    from mmtrs_tpu.utils.checkpoint import save_checkpoint
    from scripts.export_npz_checkpoints import export_folder

    root = tmp_path_factory.mktemp("eval_vision")
    rng = np.random.default_rng(11)
    y = (rng.random(36) < 0.45).astype(int)
    imgs = synth_images(36, 32, seed=12, labels=y)
    vt = VisionTrainer(VisionTrainConfig(model_name="test_cnn", img_size=32, epochs=1, batch_size=8, bf16=False,
                                         drop_rate=0.0))
    state, _ = vt.fit(VisionData(images=imgs[:20], y=y[:20]), VisionData(images=imgs[20:28], y=y[20:28]),
                      log=lambda *a: None)
    save_checkpoint(root / "weights" / "vision_hard_best", {"params": state.params, "batch_stats": state.batch_stats},
                    recipe={"model_name": "test_cnn", "img_size": 32, "task": "hard", "thr": 0.45})
    assert [p.name for p in export_folder(root / "weights")] == ["vision_hard_best.npz"]
    img_dir = root / "images"
    img_dir.mkdir()
    big = synth_images(4, 40, seed=13, labels=y[24:28])
    for i in range(36):
        if i == 30:
            continue  # its file is missing: both CLIs drop the row
        im = big[i - 24] if 24 <= i < 28 else imgs[i]
        Image.fromarray(im).save(img_dir / f"{i}.jpg", quality=95)
    split = ["train"] * 20 + ["Val"] * 8 + ["test"] * 8
    pd.DataFrame({"image_name": [f"{i}.jpg" for i in range(36)], "y_majority": y, "split": split}).to_csv(
        root / "data.csv", index=False)
    return root


@pytest.mark.parametrize("flags", [[], ["--tune_on", "val"], ["--no_tta", "--split", "val"]],
                         ids=["recipe_thr", "tune_on_val", "no_tta"])
def test_eval_vision_matches_jax(vision_case, flags):
    from mmtrs_tpu_torch.cli import eval_vision as port
    from scripts import eval_vision as jax_cli

    root = vision_case
    base = ["--ckpt", str(root / "weights" / "vision_hard_best"), "--data", str(root / "data.csv"),
            "--image_dir", str(root / "images")] + flags
    assert jax_cli.main(base + ["--outdir", str(root / "jax")]) == 0
    assert port.main(base + ["--outdir", str(root / "port"), "--device", "cpu"]) == 0
    split = flags[flags.index("--split") + 1] if "--split" in flags else "test"
    name = f"vision_hard_{split}_predictions.csv"
    a, b = pd.read_csv(root / "jax" / name), pd.read_csv(root / "port" / name)
    assert list(b.columns) == ["image_name", "y", "prob"] and len(b) == (7 if split == "test" else 8)
    assert b["image_name"].tolist() == a["image_name"].tolist() and b["y"].tolist() == a["y"].tolist()
    np.testing.assert_allclose(b["prob"], a["prob"], rtol=0, atol=1e-5)
    mj = json.loads((root / "jax" / "metrics_vision_hard.json").read_text())
    mp = json.loads((root / "port" / "metrics_vision_hard.json").read_text())
    assert set(mp) == set(mj) == {"auc", "acc", "prec", "rec", "f1", "brier"}
    for k in mj:
        assert abs(mp[k] - mj[k]) <= 1e-5, k


def test_eval_vision_without_recipe_fails(tmp_path):
    from mmtrs_tpu_torch.cli import eval_vision

    np.savez(tmp_path / "ck.npz", **{"params/x": np.zeros(1)})
    assert eval_vision.main(["--ckpt", str(tmp_path / "ck"), "--data", "x.csv", "--image_dir", str(tmp_path),
                             "--device", "cpu"]) == 1


@pytest.fixture(scope="module")
def forests(tmp_path_factory):
    """An xgb-like and an lgbm-like forest trained and saved by the JAX
    package on a 160-row cohort's train split."""
    from mmtrs_tpu.config import GBDTConfig
    from mmtrs_tpu.data.features import build_features
    from mmtrs_tpu.models.gbdt import train_gbdt

    root = tmp_path_factory.mktemp("forests")
    df = synth_standardized(160, seed=31)
    df.loc[df.index[::5], "split"] = "VAL"
    df.to_csv(root / "data.csv", index=False)
    tr = df[df["split"] == "train"]
    X = build_features(tr).to_numpy(np.float32)
    y = tr["y_majority"].astype(int).to_numpy()
    train_gbdt(X, y, GBDTConfig(n_estimators=30, max_depth=3, early_stopping_rounds=0)).save(root / "xgb_forest")
    lg = GBDTConfig.lgbm_like()
    train_gbdt(X, y, GBDTConfig(**{**lg.__dict__, "n_estimators": 30, "early_stopping_rounds": 0})).save(
        root / "lgbm_forest")
    return root


@pytest.mark.parametrize("which", ["xgb", "lgbm", "both", "blend"])
def test_evaluate_models_matches_jax(forests, which):
    from mmtrs_tpu_torch.cli import evaluate_models as port
    from scripts import evaluate_models as jax_cli

    root = forests
    base = ["--data", str(root / "data.csv"), "--xgb", str(root / "xgb_forest"), "--lgbm", str(root / "lgbm_forest"),
            "--which", which]
    (root / which / "jax").mkdir(parents=True)
    (root / which / "port").mkdir(parents=True)
    assert jax_cli.main(base + ["--outdir", str(root / which / "jax")]) == 0
    assert port.main(base + ["--outdir", str(root / which / "port"), "--device", "cpu"]) == 0
    names = sorted(p.name for p in (root / which / "jax").iterdir())
    assert names == sorted(p.name for p in (root / which / "port").iterdir())
    assert names == (["blend_params.json", "evaluation.json", "metrics_blend.json"] if which == "blend"
                     else ["evaluation.json"])
    for n in names:
        assert json.loads((root / which / "port" / n).read_text()) == json.loads((root / which / "jax" / n).read_text())


def test_eval_clis_need_the_card_by_default(vision_case, forests):
    import torch

    from mmtrs_tpu_torch.cli import eval_vision, evaluate_models

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        eval_vision.main(["--ckpt", str(vision_case / "weights" / "vision_hard_best"), "--data",
                          str(vision_case / "data.csv"), "--image_dir", str(vision_case / "images")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evaluate_models.main(["--data", str(forests / "data.csv"), "--xgb", str(forests / "xgb_forest")])
