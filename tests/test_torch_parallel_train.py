"""The port's trainers data-parallel over 2 gloo ranks against one process,
the counterpart of tests/test_parallel.py (JAX's 8-device mesh against one
device): MM, MIL, KFold (MixUp on, pos_weight ≠ 1, through ``fit_fold``),
Vision soft (sample weights, EfficientNet-B0 for its drop-path) and the
progressive trainer, at tests/parallel_worker.py's shapes (``test_cnn``,
32², batch 16 / 8, ragged evals of 17 / 9 / 17 rows), dropout on. The
bars are JAX's own: 3-step losses rtol 1e-3 / atol 5e-5, eval within 2e-3.

The data exposes local statistics: rank 0's rows of a batch are bright,
rank 1's dark, the positives and the large sample weights sit in rank 0's
rows and its tabular features are shifted. A rank that took its shard's
BatchNorm moments and weight sums as the global ones (a straight DDP wrap,
``LocalStats``) misses the bars; the tests assert that too.

The ranks are ``python -m tests.test_torch_parallel_train <out>`` processes
that ``parallel.dryrun.launch`` starts (one torch thread each, a FileStore
in the test's tmp_path); one launch runs every family, and the one-process
runs happen in the test's own process on one thread.
"""

from __future__ import annotations

import contextlib
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

LOSS_RTOL, LOSS_ATOL, EVAL_BAR = 1e-3, 5e-5, 2e-3  # tests/test_parallel.py:63-66
STEPS = 3


def _skewed(n: int, batch: int, seed: int):
    """n rows at 32²: of the first ``batch`` rows (the global batch), the
    first half (rank 0's shard) bright with the positives, shifted tabular
    features and sample weight 3, the second half dark with weight 0.25;
    the rows after the batch alike to the second half."""
    rng = np.random.default_rng(seed)
    h = batch // 2
    imgs = np.concatenate([rng.uniform(150, 255, (h, 32, 32, 3)), rng.uniform(0, 100, (n - h, 32, 32, 3))])
    tab = rng.normal(size=(n, 9)) + np.where(np.arange(n) < h, 2.0, 0.0)[:, None]
    y = (np.arange(n) < h - 1).astype(np.float32)
    y[batch - 1] = 1.0
    p = np.clip(y * 0.8 + rng.uniform(0, 0.2, n), 0, 1)
    w = np.where(np.arange(n) < h, 3.0, 0.25)
    return imgs.astype(np.float32), tab.astype(np.float32), y, p.astype(np.float32), w.astype(np.float32)


def _mm(group):
    from mmtrs_tpu_torch.config import MMJointConfig
    from mmtrs_tpu_torch.parallel.mesh import shard_batch
    from mmtrs_tpu_torch.train.mm import MMTrainer

    cfg = MMJointConfig(model_name="test_cnn", img_size=32, batch_size=16, tab_hidden=8, train_aug="none")
    imgs, tab, y, p, _ = _skewed(17, 16, 7)
    tr = MMTrainer(cfg, device="cpu", dtype=torch.float32, group=group)
    tr.init_state(STEPS)
    batch = [tr._prep(torch.from_numpy(imgs[:16])), *(torch.from_numpy(a[:16]) for a in (tab, y, p))]
    if group is not None:
        batch = shard_batch(group, batch)
    losses = [float(tr.train_step(*batch)) for _ in range(STEPS)]
    out = {"losses": losses, "eval": tr.logits(torch.from_numpy(imgs), tab, tta=True).tolist()}
    if group is not None:
        out["grad_syncs"] = group.grad_syncs
    return out


def _mil(group):
    from mmtrs_tpu_torch.config import MILConfig
    from mmtrs_tpu_torch.train.mil import MILTrainer

    cfg = MILConfig(model_name="test_cnn", bag_size=2, img_size=32, batch_size=8)
    imgs, _, y, _, _ = _skewed(9, 8, 8)
    imgs = torch.from_numpy(imgs.astype(np.uint8))
    oid = np.arange(9)
    tr = MILTrainer(cfg, device="cpu", dtype=torch.float32, group=group)
    tr.init_state(STEPS)
    rows = slice(0, 8) if group is None else group.rows(8)
    bags = tr.train_bags(imgs[rows], 1, oid[rows])
    losses = [float(tr.train_step(bags, torch.from_numpy(y[rows]))) for _ in range(STEPS)]
    return {"losses": losses, "eval": tr.predict_proba(None, imgs, oid).tolist()}


def _kfold(group, grad_accum: int = 1):
    from mmtrs_tpu_torch.train.kfold import KFoldConfig, KFoldHardTrainer

    batch = 16 // grad_accum
    cfg = KFoldConfig(model_name="test_cnn", img_size=32, batch_size=batch, grad_accum=grad_accum, use_mixup=True)
    imgs, _, _, _, _ = _skewed(33, 16, 9)
    y = np.zeros(33, int)
    y[[0, 2, 5, 11, 20, 25, 30]] = 1  # 4 of the 16 train rows: pos_weight 3
    tr = KFoldHardTrainer(cfg, device="cpu", group=group)
    epochs = STEPS if grad_accum == 1 else 2
    best = tr.fit_fold(torch.from_numpy(imgs.astype(np.uint8)), y, np.arange(16), np.arange(16, 33),
                       epochs=epochs, log=lambda *a: None)
    out = {key: [h[key] for h in best["history"]] for key in ("loss", "grad_norm", "logit_std")}
    out.update(losses=out.pop("loss"), eval=tr.predict_proba(best["state"], torch.from_numpy(imgs[16:].astype(np.uint8))).tolist(),
               pos_weight=tr.pos_weight, mixed=[bool(tr._mix_draws(s, batch).gate) for s in range(tr.step)],
               opt_count=tr.opt.count)
    if group is not None:
        out["grad_syncs"] = group.grad_syncs
    return out


def _vision_soft(group):
    from mmtrs_tpu_torch.config import VisionTrainConfig
    from mmtrs_tpu_torch.parallel.mesh import shard_batch
    from mmtrs_tpu_torch.train.vision import VisionData, VisionTrainer

    cfg = VisionTrainConfig(model_name="efficientnet_b0", img_size=32, batch_size=16, task="soft", bf16=False)
    imgs, _, y, p, w = _skewed(17, 16, 10)
    u8 = imgs.astype(np.uint8)
    tr = VisionTrainer(cfg, device="cpu", group=group)
    tr.init_state(STEPS)
    x = tr._prep_images(torch.from_numpy(u8[:16]), False, 0)
    batch = [x, torch.from_numpy(y[:16]).long(), torch.from_numpy(p[:16]), torch.from_numpy(w[:16])]
    if group is not None:
        batch = shard_batch(group, batch)
    losses = [float(tr.train_step(*batch)) for _ in range(STEPS)]
    return {"losses": losses, "eval": tr.predict_proba(None, VisionData(images=u8, y=y)).tolist()}


def _progressive(group):
    from mmtrs_tpu_torch.config import ProgressiveConfig, ProgressiveStage
    from mmtrs_tpu_torch.train.progressive import progressive_ensemble_probs, train_progressive
    from mmtrs_tpu_torch.train.vision import VisionData

    imgs, _, y, _, _ = _skewed(24, 16, 11)
    imgs, y = imgs.astype(np.uint8), y.astype(np.int64)
    cfg = ProgressiveConfig(model_name="test_cnn", seeds=(0,),
                            stages=(ProgressiveStage(32, 1, 8, 1e-3), ProgressiveStage(32, 1, 8, 5e-4)))
    states = train_progressive(cfg, VisionData(imgs[:16], y[:16]), VisionData(imgs[16:], y[16:]), device="cpu",
                               log=lambda *a: None, group=group)
    probs = progressive_ensemble_probs(states, VisionData(imgs[16:], y[16:])).tolist()
    return {"losses": probs, "eval": probs}


FAMILIES = {"mm": _mm, "mil": _mil, "kfold": _kfold, "vision_soft": _vision_soft, "progressive": _progressive}


def _local_stats_group(group):
    """The same ranks with each shard's BatchNorm moments and weight sums
    taken as the global ones: what a straight DDP wrap computes."""
    from mmtrs_tpu_torch.parallel.mesh import DataGroup

    class LocalStats(DataGroup):
        def all_sum(self, t):
            return t * self.size

    return LocalStats(group.pg, group.rank, group.size, group.backend)


def _rank_main(out: Path) -> None:
    from mmtrs_tpu_torch.parallel.mesh import group_from_env

    torch.set_num_threads(1)
    group, _ = group_from_env()
    res = {}
    try:
        for name, fam in FAMILIES.items():
            group.grad_syncs = 0
            res[name] = fam(group)
            res[f"{name}_local"] = fam(_local_stats_group(group))
        group.grad_syncs = 0
        res["kfold_accum"] = _kfold(group, grad_accum=2)
    finally:
        group.close()
    (out / f"rank{group.rank}.json").write_text(json.dumps(res))


@contextlib.contextmanager
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from mmtrs_tpu_torch.parallel.dryrun import launch

    out = tmp_path_factory.mktemp("ranks")
    launch(2, "tests.test_torch_parallel_train", [out], device="cpu", backend="gloo", timeout=600, workdir=out)
    ranks = [json.loads((out / f"rank{r}.json").read_text()) for r in range(2)]
    with _one_thread():
        one = {name: fam(None) for name, fam in FAMILIES.items()}
        one["kfold_accum"] = _kfold(None, grad_accum=2)
    return ranks, one


def _misses(got: dict, want: dict) -> bool:
    l, w = np.array(got["losses"]), np.array(want["losses"])
    loss_ok = np.all(np.abs(l - w) <= LOSS_ATOL + LOSS_RTOL * np.abs(w))
    return not loss_ok or float(np.max(np.abs(np.array(got["eval"]) - np.array(want["eval"])))) >= EVAL_BAR


@pytest.mark.parametrize("name", list(FAMILIES))
def test_two_ranks_match_one_process(runs, name):
    """Both ranks' losses (each the global batch's) and gathered eval
    outputs equal one process's within JAX's mesh bars."""
    ranks, one = runs
    for r in ranks:
        np.testing.assert_allclose(r[name]["losses"], one[name]["losses"], rtol=LOSS_RTOL, atol=LOSS_ATOL)
        diff = float(np.max(np.abs(np.array(r[name]["eval"]) - np.array(one[name]["eval"]))))
        assert diff < EVAL_BAR, diff
    assert len(one[name]["eval"]) in (8, 9, 17)
    assert ranks[0][name]["eval"] == ranks[1][name]["eval"]


@pytest.mark.parametrize("name", ["mm", "mil", "kfold", "vision_soft"])
def test_local_statistics_would_miss(runs, name):
    """The data is not one under which local and global agree: with each
    shard's moments and weight sums the same ranks miss the bars."""
    ranks, one = runs
    assert _misses(ranks[0][f"{name}_local"], one[name])


def test_kfold_statistics_are_global(runs):
    """KFold's grad norm (of the averaged gradient) and logit std are the
    global batch's, with pos_weight 3 and MixUp firing."""
    ranks, one = runs
    got, want = ranks[0]["kfold"], one["kfold"]
    assert want["pos_weight"] == 3.0 and any(want["mixed"])
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=LOSS_RTOL, atol=LOSS_ATOL)
    np.testing.assert_allclose(got["logit_std"], want["logit_std"], rtol=LOSS_RTOL, atol=LOSS_ATOL)


def test_gradient_all_reduce_per_optimiser_step(runs):
    """The counterpart of test_mesh_step_contains_all_reduce: one gradient
    all-reduce per MM optimiser step (3), and with KFold's grad_accum 2
    exactly one per window (4 micro steps, 2 windows), whose losses still
    equal one process's; the micro steps' grad norms are NaN there (no micro
    step's global gradient is formed)."""
    ranks, one = runs
    assert ranks[0]["mm"]["grad_syncs"] == STEPS
    assert ranks[0]["kfold"]["grad_syncs"] == STEPS
    got, want = ranks[0]["kfold_accum"], one["kfold_accum"]
    assert got["opt_count"] == want["opt_count"] == 2 and got["grad_syncs"] == 2
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=LOSS_RTOL, atol=LOSS_ATOL)
    assert np.isnan(got["grad_norm"]).all() and not np.isnan(want["grad_norm"]).any()
    assert float(np.max(np.abs(np.array(got["eval"]) - np.array(want["eval"])))) < EVAL_BAR


if __name__ == "__main__":
    _rank_main(Path(sys.argv[1]))
