"""The port's whole service built from a weights folder, held against the
JAX package's on the CPU: tiny test_cnn MM and MIL folds trained on
synthetic data and a tab k-fold, as the JAX serving fixture makes them
(tests/test_serve_integration.py), exported to npz by
scripts/export_npz_checkpoints.py, then served by both packages'
``build_service_from_weights``. The served upload's parity with JAX
(~250 s of worker time, the suite's second longest test) is held in
tests/test_torch_built_service.py.

Both build the image streams in bf16, and the port takes the TPU
preprocessing route where JAX's CPU route keeps float chroma (a level or two
on some pixels, tests/test_torch_serve.py), so each image stream's p is held
to BF16_BAR; Tab and the Stacker are f32 and held as in
tests/test_torch_tab.py and tests/test_torch_stacker.py.
"""

import importlib.util
import json

import numpy as np
import pytest
import torch

from mmtrs_tpu.config import GBDTConfig, MILConfig, MMJointConfig
from tests.synth import synth_images, synth_standardized
from tests.test_torch_mm import ROOT

# the image streams' |Δp| bar at bf16: the largest difference measured on
# 520² uploads synth_images(seed=77..80), with and without fields, was
# 2.32e-4 (MIL, seed 78); MM's was 1.09e-4. Tab's bar is f32's.
BF16_BAR = 1e-3
TAB_BAR = 1e-6


def _exporter():
    spec = importlib.util.spec_from_file_location(
        "export_npz_checkpoints", ROOT / "scripts" / "export_npz_checkpoints.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def weights_dir(tmp_path_factory):
    """Minimal MM + MIL fold models and a tab ensemble, saved with recipes
    in the reference weights layout, then exported to npz."""
    from mmtrs_tpu.train.mil import run_mil_kfold
    from mmtrs_tpu.train.mm import run_mm_kfold
    from mmtrs_tpu.train.tabular import train_tab_kfold

    root = tmp_path_factory.mktemp("weights")
    n = 60
    df = synth_standardized(n, seed=41)
    df["split"] = ["test" if i >= 48 else "train" for i in range(n)]
    y = df["y_majority"].astype(int).to_numpy()
    imgs = synth_images(n, 32, seed=42, labels=y)
    run_mm_kfold(imgs, df, MMJointConfig(model_name="test_cnn", img_size=32, batch_size=12,
                                         lr=1e-3, n_folds=2, epochs=2),
                 outdir=root / "mm_dualtask_v1", epochs=2, save_ckpts=True, log=lambda *a: None)
    run_mil_kfold(imgs, df, MILConfig(model_name="test_cnn", bag_size=2, img_size=32, attn_dim=8,
                                      epochs=2, batch_size=12, lr=1e-3, n_folds=2),
                  outdir=root / "mil_v1", epochs=2, save_ckpts=True, log=lambda *a: None)
    train_tab_kfold(df, outdir=root / "tab_v1", n_folds=2,
                    cfg=GBDTConfig(**{**GBDTConfig.stack_tab_like().__dict__, "n_estimators": 80}))
    written = _exporter().export_folder(root)
    assert len(written) == 4, written
    return root


def test_exporter_writes_params_and_batch_stats_only(weights_dir):
    """Each npz holds exactly the Orbax checkpoint's params and batch_stats
    leaves, bit for bit, under /-joined keys; forests are left alone."""
    import jax

    from mmtrs_tpu.utils.checkpoint import load_checkpoint

    for base in ("mm_dualtask_v1/mm_dualtask_fold0", "mil_v1/mil_v1_fold1"):
        state, _ = load_checkpoint(weights_dir / base)
        want = {}
        for coll in ("params", "batch_stats"):
            for path, leaf in jax.tree_util.tree_flatten_with_path(state[coll])[0]:
                want["/".join([coll] + [p.key for p in path])] = np.asarray(leaf)
        with np.load(weights_dir / f"{base}.npz") as z:
            assert sorted(z.files) == sorted(want)
            for k in z.files:
                assert z[k].dtype == want[k].dtype and np.array_equal(z[k], want[k]), k
    assert sorted(p.name for p in (weights_dir / "tab_v1").iterdir()) == [
        "tab_fold0.json", "tab_fold0.npz", "tab_fold1.json", "tab_fold1.npz"]


def test_empty_weights_folder_has_no_streams(tmp_path):
    from mmtrs_tpu_torch.serve.ensembles import build_service_from_weights

    svc = build_service_from_weights(tmp_path, device="cpu")
    assert svc.mm_predict is svc.mil_predict is svc.tab_predict is svc.stacker is None
    out = svc.predict_one(synth_images(1, 520, seed=9)[0])
    assert out == {"error": "no model streams available"}


def test_recipe_without_npz_raises(weights_dir, tmp_path):
    """A fold whose recipe is there but whose npz is not (not exported) is
    an error, not a missing stream."""
    from mmtrs_tpu_torch.serve.ensembles import MMEnsemble

    recipe = json.loads((weights_dir / "mm_dualtask_v1" / "mm_dualtask_fold0.recipe.json").read_text())
    (tmp_path / "mm_dualtask_fold0.recipe.json").write_text(json.dumps(recipe))
    with pytest.raises(FileNotFoundError, match="export_npz_checkpoints"):
        MMEnsemble.from_folder(tmp_path, device="cpu")


@pytest.mark.parametrize("entry", ["MILEnsemble", "MMEnsemble", "TabEnsemble.from_folder",
                                   "TabEnsemble", "build_service_from_weights"])
def test_entry_points_raise_without_card(entry, weights_dir):
    """With no device argument each serving entry point wants the card; on
    a machine without one it raises instead of serving on the CPU."""
    from mmtrs_tpu_torch.models.mil import MILNet
    from mmtrs_tpu_torch.models.mm_joint import MMJointDualHead
    from mmtrs_tpu_torch.serve import ensembles
    from mmtrs_tpu_torch.train.tabular import load_tab_ensemble

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    calls = {
        "MILEnsemble": lambda: ensembles.MILEnsemble([], MILNet("test_cnn", 8)),
        "MMEnsemble": lambda: ensembles.MMEnsemble([], MMJointDualHead("test_cnn")),
        "TabEnsemble.from_folder": lambda: ensembles.TabEnsemble.from_folder(weights_dir / "tab_v1"),
        "TabEnsemble": lambda: ensembles.TabEnsemble(load_tab_ensemble(weights_dir / "tab_v1", "cpu")),
        "build_service_from_weights": lambda: ensembles.build_service_from_weights(weights_dir),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()
