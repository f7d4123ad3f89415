"""The rehearsal twin (``python -m mmtrs_tpu_torch.cli.rehearsal``) and its
replay (``...cli.stack_from_streams``) on the CPU: the cohort byte for byte
against scripts/rehearsal.py's ``hard_cohort``, a tiny run (test_cnn for
MM and MIL, 24 cases at 64², 2 folds, 1 epoch) that writes every key of the
JAX script's summary, and the replay's stack equal to the run's."""

import json
import shutil
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

from mmtrs_tpu_torch.utils.table import to_csv

ROOT = Path(__file__).resolve().parents[1]

TINY = ["--n", "24", "--raw_size", "64", "--n_aug", "2", "--folds", "2", "--mm_epochs", "1", "--mil_epochs", "1",
        "--mm_model", "test_cnn", "--mm_img", "64", "--mm_batch", "8", "--mil_img", "32", "--device", "cpu"]


STACK_TREES = 60  # stack_tab_like's 700 cut for the tiny runs: a wiring test, not the recipe


@pytest.fixture(scope="module", autouse=True)
def small_cpu_stack():
    """One torch thread (the forests' small ops only contend with the other
    test workers' threads) and ``stack_tab_like`` at STACK_TREES trees for
    every run of this file, the run and its replay alike; the MIL stream's
    B0 (the script's constant) becomes test_cnn."""
    import torch

    import mmtrs_tpu_torch.config as config
    from mmtrs_tpu_torch.config import GBDTConfig, MILConfig

    threads, orig = torch.get_num_threads(), GBDTConfig.stack_tab_like
    torch.set_num_threads(1)
    mp = pytest.MonkeyPatch()
    mp.setattr(GBDTConfig, "stack_tab_like",
               staticmethod(lambda: GBDTConfig(**{**orig().__dict__, "n_estimators": STACK_TREES})))
    mp.setattr(config, "MILConfig", lambda **kw: MILConfig(**{**kw, "model_name": "test_cnn"}))
    yield
    mp.undo()
    torch.set_num_threads(threads)


def _keys(d, prefix=""):
    out = set()
    for k, v in d.items():
        out.add(prefix + k)
        if isinstance(v, dict) and k not in ("streams", "stack"):
            out |= _keys(v, prefix + k + ".")
    return out


@pytest.mark.parametrize("n,size,seed", [(12, 64, 2026), (7, 33, 5)])
def test_hard_cohort_matches_jax_byte_for_byte(tmp_path, n, size, seed):
    """The table's CSV (pandas' against the port's writer) and the u8 images
    equal, column dtypes alike."""
    from mmtrs_tpu_torch.cli.rehearsal import hard_cohort
    from scripts.rehearsal import hard_cohort as jax_cohort

    want_df, want_imgs = jax_cohort(n, size, seed)
    got, imgs = hard_cohort(n, size, seed)
    assert got.columns == list(want_df.columns)
    for c in got.columns:
        assert got[c].dtype.kind == want_df[c].dtype.kind, c
    want_df.to_csv(tmp_path / "jax.csv", index=False)
    to_csv(got, tmp_path / "port.csv")
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()
    assert imgs.dtype == np.uint8 and np.array_equal(imgs, want_imgs)


def test_hard_cohort_table_does_not_depend_on_size(tmp_path):
    from mmtrs_tpu_torch.cli.rehearsal import hard_cohort

    a, _ = hard_cohort(30, 8, 2026)
    b, _ = hard_cohort(30, 48, 2026)
    to_csv(a, tmp_path / "a.csv")
    to_csv(b, tmp_path / "b.csv")
    assert (tmp_path / "a.csv").read_bytes() == (tmp_path / "b.csv").read_bytes()


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    from mmtrs_tpu_torch.cli import rehearsal

    out = tmp_path_factory.mktemp("rehearsal") / "run"
    assert rehearsal.main(TINY + ["--out", str(out), "--save_ckpts"], log=lambda m: None) == 0
    return out


def test_tiny_rehearsal_writes_every_key(tiny_run):
    """summary.json has every key of the TPU record's (results/rehearsal_r5)
    and the recorded epoch cut; the timings are finite; the streams and the
    stack wrote their files (with the folds' npz + recipe); 24 cases × 3
    rows."""
    rec = json.loads((tiny_run / "summary.json").read_text())
    tpu = json.loads((ROOT / "results" / "rehearsal_r5" / "summary.json").read_text())
    assert _keys(rec) == _keys(tpu) | {"config.cut", "config.cut.mm_epochs", "config.cut.mil_epochs",
                                        "config.cut.mm_epochs.from", "config.cut.mm_epochs.to",
                                        "config.cut.mil_epochs.from", "config.cut.mil_epochs.to"}
    assert rec["platform"] == "cpu" and rec["n_cases"] == 24 and rec["n_rows_augmented"] == 72
    assert rec["config"]["cut"] == {"mm_epochs": {"from": 8, "to": 1}, "mil_epochs": {"from": 6, "to": 1}}
    assert all(np.isfinite(v) for v in rec["timings"].values())
    assert set(rec["streams"]) == {"mm", "mil"} and set(rec["stack"]) == {"oof", "test", "thr"}
    assert isinstance(rec["stack_beats_streams"], bool)
    for sub in ("mm", "mil"):
        for f in ("oof_val.csv", "pred_test.csv", "summary.json"):
            assert (tiny_run / sub / f).exists(), (sub, f)
    assert sorted(p.name for p in (tiny_run / "mm").glob("*.npz")) == ["mm_dualtask_fold0.npz", "mm_dualtask_fold1.npz"]
    assert sorted(p.name for p in (tiny_run / "mil").glob("*.npz")) == ["mil_v1_fold0.npz", "mil_v1_fold1.npz"]
    for f in ("stack_oof.csv", "stack_test.csv", "summary.json"):
        assert (tiny_run / "stack" / f).exists()
    oof = pd.read_csv(tiny_run / "mm" / "oof_val.csv")
    assert len(oof) + len(pd.read_csv(tiny_run / "mm" / "pred_test.csv")) == 72


def test_stack_from_streams_replays_the_run(tiny_run, tmp_path):
    """On a copy of the run's folder the replay rebuilds the table, passes
    the length gate and writes the same stack: stack/ byte for byte, the
    summary's stack block, best stream AUC and verdict equal."""
    from mmtrs_tpu_torch.cli import stack_from_streams

    copy = tmp_path / "copy"
    shutil.copytree(tiny_run, copy)
    args = ["--dir", str(copy)] + TINY[: TINY.index("--mm_epochs")] + ["--device", "cpu"]
    assert stack_from_streams.main(args, log=lambda m: None) == 0
    for f in ("stack_oof.csv", "stack_test.csv", "summary.json"):
        assert (copy / "stack" / f).read_bytes() == (tiny_run / "stack" / f).read_bytes(), f
    run, replay = (json.loads((d / "summary.json").read_text()) for d in (tiny_run, copy))
    assert replay["salvaged"] is True and replay["stack"] == run["stack"]
    for k in ("best_stream_test_auc", "stack_beats_streams", "n_rows_augmented", "streams"):
        assert replay[k] == run[k] or (k == "best_stream_test_auc" and np.isnan(replay[k]) and np.isnan(run[k])), k


def test_stack_from_streams_refuses_streams_of_another_table(tiny_run, tmp_path):
    from mmtrs_tpu_torch.cli import stack_from_streams

    copy = tmp_path / "copy"
    shutil.copytree(tiny_run, copy)
    args = ["--dir", str(copy), "--n", "30", "--raw_size", "64", "--n_aug", "2", "--folds", "2", "--device", "cpu"]
    with pytest.raises(ValueError, match="train\\+val rows"):
        stack_from_streams.main(args, log=lambda m: None)


def test_rehearsal_needs_the_card_by_default(tmp_path):
    import torch

    from mmtrs_tpu_torch.cli import rehearsal

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rehearsal.main(["--n", "4", "--out", str(tmp_path / "o")], log=lambda m: None)
