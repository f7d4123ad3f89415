"""The stack golden: the final stack of the TPU rehearsal
(results/rehearsal_r5) rebuilt on the CPU from its stream CSVs.

The rehearsal's lineage table is rebuilt without its images: the table of
``hard_cohort(422, ·, 2026)`` is drawn before any pixel, and the lineage
(children, names, the grouped test split) depends on the ids and seeds
alone, so ``build_augmented_table`` with preset ``none`` on 8² stand-ins
gives the rehearsal's 4,642 rows; its train+val rows are exactly the rows
the TPU streams scored (results/rehearsal_r5/{mm,mil}/oof_val.csv, in
order). Both packages' ``run_final_stack`` then run on those CSVs, the
port's forests on JAX's own subsampling masks (``jax_draws_for``), both at
150 trees as tests/test_torch_stack_fit.py patches them (the recipe's 700
run on the card: ``cli.stack_from_streams``, PERF.md).

Bars (tests/test_torch_stack_fit.py's): meta_coef and the intercept within
1e-3 of the largest coefficient, the threshold within one step of the
stack grid (0.0049). Reading against the TPU record (700 trees): see
PERF.md."""

import json
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

ROOT = Path(__file__).resolve().parents[1]
R5 = ROOT / "results" / "rehearsal_r5"
TREES = 150


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's CPU forests on one torch thread: their small ops only
    contend with the other test workers' threads."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tables():
    """(the port's rebuilt table, JAX's rebuilt DataFrame)."""
    from mmtrs_tpu.data.records import build_augmented_table as jbuild
    from mmtrs_tpu_torch.cli.rehearsal import AUGMENT_SEED, COHORT_SEED, TEST_FRAC, hard_cohort
    from mmtrs_tpu_torch.data.records import build_augmented_table
    from scripts.rehearsal import hard_cohort as jax_cohort

    df, imgs = hard_cohort(422, 8, COHORT_SEED)
    table, _ = build_augmented_table(df, imgs, n_aug=10, preset="none", seed=AUGMENT_SEED, test_frac=TEST_FRAC,
                                     device="cpu")
    jdf, jimgs = jax_cohort(422, 8, COHORT_SEED)
    jtable, _ = jbuild(jdf, jimgs, n_aug=10, preset="none", seed=AUGMENT_SEED, test_frac=TEST_FRAC)
    return table, jtable


def test_rebuilt_table_is_the_rehearsals(tables):
    """4,642 rows; the train+val rows in order are the TPU streams' OOF
    rows and the test rows their test rows, with the same labels, in both
    packages."""
    table, jtable = tables
    assert len(table) == len(jtable) == 4642
    assert table["image_name"].tolist() == jtable["image_name"].tolist()
    for stream in ("mm", "mil"):
        oof = pd.read_csv(R5 / stream / "oof_val.csv")
        test = pd.read_csv(R5 / stream / "pred_test.csv")
        tv = table["split"] != "test"
        assert table["image_name"][tv].tolist() == oof["image_name"].tolist()
        assert table["image_name"][~tv].tolist() == test["image_name"].tolist()
        assert np.array_equal(table["y_majority"][tv].astype(float), oof["y"].to_numpy())


def test_stack_golden_matches_jax_on_the_tpu_streams(tables, tmp_path):
    from mmtrs_tpu.config import FusionConfig as JF
    from mmtrs_tpu.config import GBDTConfig as J
    from mmtrs_tpu.fusion import run_final_stack as jrun
    from mmtrs_tpu_torch.config import FusionConfig as PF
    from mmtrs_tpu_torch.config import GBDTConfig as P
    from mmtrs_tpu_torch.fusion.stack import run_final_stack
    from mmtrs_tpu_torch.utils.io import read_table
    from tests.test_torch_gbdt_train import jax_draws_for

    table, jtable = tables
    jcfg = J(**{**J.stack_tab_like().__dict__, "n_estimators": TREES})
    pcfg = P(**{**P.stack_tab_like().__dict__, "n_estimators": TREES})
    files = [R5 / s / f for s in ("mm", "mil") for f in ("oof_val.csv", "pred_test.csv")]
    want = jrun(jtable, *[pd.read_csv(f) for f in files], outdir=tmp_path / "jax",
                cfg=JF(n_folds=5, thr_mode="max_acc"), tab_cfg=jcfg)
    got = run_final_stack(table, *[read_table(f) for f in files], outdir=tmp_path / "port",
                          cfg=PF(n_folds=5, thr_mode="max_acc"), tab_cfg=pcfg, device="cpu",
                          draws_for=jax_draws_for(jcfg))
    scale = np.abs(want["meta_coef"]).max()
    assert np.abs(np.subtract(got["meta_coef"], want["meta_coef"])).max() <= 1e-3 * scale
    assert abs(got["meta_intercept"] - want["meta_intercept"]) <= 1e-3 * scale
    assert abs(got["thr"] - want["thr"]) <= 0.0049 + 1e-9
    assert got["features"] == want["features"] == ["prob_tab", "prob_mm", "prob_mil"]
    tpu = json.loads((R5 / "stack" / "summary.json").read_text())
    print(f"stack golden at {TREES} trees: port meta_coef {got['meta_coef']} intercept {got['meta_intercept']} thr "
          f"{got['thr']} test auc {got['test']['auc']}; JAX {want['meta_coef']} {want['meta_intercept']} "
          f"{want['thr']} {want['test']['auc']}; TPU record (700 trees) {tpu['meta_coef']} {tpu['meta_intercept']} "
          f"{tpu['thr']} {tpu['test']['auc']}")
