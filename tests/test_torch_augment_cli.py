"""The port's record-keeping augmentation CLI
(``python -m mmtrs_tpu_torch.cli.run_augment_records``) held against the
JAX package's run_augment_records.py on the CPU: the same table and JPEGs
in, preset ``none``; the lineage tables byte for byte, the written JPEGs
byte for byte (libjpeg here and Pillow there encode alike) and so the
images."""

import importlib.util
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
from PIL import Image

from tests.synth import synth_standardized

ROOT = Path(__file__).resolve().parents[1]


def _jax_cli():
    spec = importlib.util.spec_from_file_location("jax_run_augment_records", ROOT / "run_augment_records.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("sizes", [(512, 512, 512), (512, 600, 512)], ids=["512", "one_off_size"])
def test_augment_records_cli_matches_jax(tmp_path, sizes):
    """Three teeth (JPEG q95 written by Pillow, one of them 600² in the
    second case, which both CLIs resize to 512² with Pillow's BILINEAR
    arithmetic), a fourth row whose file is missing: both CLIs drop that row
    and write the same data_dl_augmented.csv and the same images."""
    from mmtrs_tpu_torch.cli.run_augment_records import main
    from mmtrs_tpu_torch.synth import synth_teeth

    src = tmp_path / "in"
    src.mkdir()
    df = synth_standardized(4, seed=21).drop(columns=["origin_id", "split"])
    for i, s in enumerate(sizes):
        Image.fromarray(synth_teeth(1, s, seed=22 + i)[0]).save(src / f"{i + 1}.jpg", quality=95)
    df.to_csv(tmp_path / "table.csv", index=False)
    args = ["--table", str(tmp_path / "table.csv"), "--image_dir", str(src), "--n_aug", "2",
            "--preset", "none", "--seed", "3", "--test_frac", "0.34", "--batch_size", "4"]
    assert _jax_cli().main(args + ["--out_dir", str(tmp_path / "jax")]) == 0
    assert main(args + ["--out_dir", str(tmp_path / "port"), "--device", "cpu"]) == 0

    jcsv, pcsv = tmp_path / "jax" / "data_dl_augmented.csv", tmp_path / "port" / "data_dl_augmented.csv"
    assert pcsv.read_bytes() == jcsv.read_bytes()
    names = pd.read_csv(pcsv)["image_name"].tolist()
    assert len(names) == 9 and not (tmp_path / "port" / "data_dl_augmented.xlsx").exists()
    assert sorted(p.name for p in (tmp_path / "port" / "images").iterdir()) == sorted(names)
    for n in names:
        a, b = tmp_path / "jax" / "images" / n, tmp_path / "port" / "images" / n
        assert b.read_bytes() == a.read_bytes(), n
        np.testing.assert_array_equal(np.asarray(Image.open(b)), np.asarray(Image.open(a)))
