"""The whole system at reference scale on the card (the twin of
scripts/rehearsal.py).

Usage:
  python -m mmtrs_tpu_torch.cli.rehearsal [--n 422] [--mm_model efficientnet_b4]
      [--mm_img 380] [--mm_epochs 8] [--mil_epochs 6] [--folds 5]
      [--out results/rehearsal_h100] [--save_ckpts] [--device cuda]

Stages, each timed on the host clock: a seeded synthetic-but-hard cohort
(``hard_cohort``: a subtle visual cue, noisy expert votes, partly
informative tabular fields), ``preprocess_batch`` in chunks of 32 (the last
one padded, u8 cast on the device), the 10× ``legacy`` lineage table
(``build_augmented_table``), the MM dual-task stream (``run_mm_kfold``), the
MIL stream (``run_mil_kfold``) and the final stack (``run_final_stack`` with
``stack_tab_like`` forests, ``max_acc`` threshold). It writes each stage's
artifacts under ``--out`` and ``summary.json`` with the JAX script's keys;
``platform`` holds the device's name. If the time budget forces a cut,
cut ``--mm_epochs`` first, then ``--mil_epochs``, never the widths: the
summary's ``config`` records the cut.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from mmtrs_tpu_torch.device import resolve_device
from mmtrs_tpu_torch.utils.table import Table

COHORT_SEED = 2026
AUGMENT_SEED = 42
TEST_FRAC = 0.19
PREPROCESS_BATCH = 32
DEFAULTS = {"mm_epochs": 8, "mil_epochs": 6}


def hard_cohort(n: int, size: int, seed: int) -> tuple[Table, np.ndarray]:
    """Synthetic-but-hard dataset: subtle visual cue + noisy votes +
    partially-informative tabular features → (Table, u8 [n, size, size, 3]).
    The numpy draws are the JAX script's, in its order: every table column
    is drawn before any image, so the table does not depend on ``size``."""
    rng = np.random.default_rng(seed)
    z = rng.normal(0, 1, n)  # latent severity drives everything
    p_ind = 1 / (1 + np.exp(-1.4 * z))
    votes = rng.binomial(7, p_ind)
    p_indirect = votes / 7.0
    y = (p_indirect >= 0.5).astype(int)

    def noisy_bin(strength, thresh=0.0):
        return ((z + rng.normal(0, strength, n)) > thresh).astype(int)

    table = Table(
        {
            "image_id": np.arange(1, n + 1),
            "image_name": [f"case_{i:04d}.jpg" for i in range(1, n + 1)],
            "depth": noisy_bin(1.2),
            "width": noisy_bin(1.5, 0.3),
            "enamel_cracks": noisy_bin(2.0, 0.5),
            "occlusal_load": rng.integers(0, 2, n),
            "carious_lesion": np.clip(np.round(z + rng.normal(0, 1.5, n)), -1, 1).astype(int),
            "opposing_type": rng.integers(0, 4, n),
            "adjacent_teeth": rng.integers(0, 2, n),
            "age_range": noisy_bin(2.5),
            "cervical_lesion": noisy_bin(1.8, -0.2),
            "p_indirect": p_indirect,
            "y_majority": y,
            "weight": np.abs(2 * p_indirect - 1),
        }
    )
    table["origin_id"] = table["image_id"]

    # raw images: a tooth ellipse; severity darkens a sub-region slightly;
    # negatives get distractor spots too
    ys_, xs_ = np.mgrid[0:size, 0:size].astype(np.float32)
    imgs = np.empty((n, size, size, 3), np.uint8)
    for i in range(n):
        cx, cy = size / 2 + rng.normal(0, size * 0.06, 2)
        a = size * rng.uniform(0.20, 0.33)
        b = size * rng.uniform(0.14, 0.26)
        th = rng.uniform(-0.5, 0.5)
        dx, dy = xs_ - cx, ys_ - cy
        u = dx * np.cos(th) + dy * np.sin(th)
        v = -dx * np.sin(th) + dy * np.cos(th)
        tooth = (u / a) ** 2 + (v / b) ** 2 <= 1.0
        img = np.empty((size, size, 3), np.float32)
        img[..., 0] = 62 + rng.normal(0, 7, (size, size))
        img[..., 1] = 36 + rng.normal(0, 7, (size, size))
        img[..., 2] = 41 + rng.normal(0, 7, (size, size))
        shade = np.array([226.0, 206.0, 158.0]) + rng.normal(0, 10, 3)
        img[tooth] = shade + rng.normal(0, 9, (int(tooth.sum()), 3))
        sev = 1 / (1 + np.exp(-(z[i] + rng.normal(0, 0.8))))
        spot = ((xs_ - cx) ** 2 + (ys_ - cy) ** 2) <= (size * rng.uniform(0.05, 0.10)) ** 2
        img[spot & tooth] *= 1.0 - 0.35 * sev
        if rng.random() < 0.4:
            sx, sy = cx + rng.normal(0, a / 2), cy + rng.normal(0, b / 2)
            st = ((xs_ - sx) ** 2 + (ys_ - sy) ** 2) <= (size * 0.03) ** 2
            img[st & tooth] *= 0.75
        imgs[i] = np.clip(img, 0, 255)
    return table, imgs


def preprocess_cohort(raw: np.ndarray, out_size: int, device: torch.device) -> torch.Tensor:
    """``preprocess_batch`` over ``raw`` in chunks of 32, the last chunk
    padded with its last image, each result cast to u8 (round half to even,
    as ``jnp.round``) on the device → u8 [n, out_size, out_size, 3] there."""
    from mmtrs_tpu_torch.data.records import quantize_round_half_even
    from mmtrs_tpu_torch.preprocess import preprocess_batch

    bs = PREPROCESS_BATCH
    proc = torch.empty((len(raw), out_size, out_size, 3), dtype=torch.uint8, device=device)
    for s in range(0, len(raw), bs):
        chunk = raw[s : s + bs]
        pad = bs - len(chunk)
        if pad:
            chunk = np.concatenate([chunk, np.repeat(chunk[-1:], pad, 0)])
        o, _ = preprocess_batch(torch.from_numpy(chunk).to(device), out_size=out_size)
        proc[s : s + bs] = quantize_round_half_even(o)[: bs - pad]
    return proc


def rehearsal_table(n: int, raw_size: int, n_aug: int, device: torch.device) -> tuple[Table, torch.Tensor]:
    """The cohort, preprocessed and augmented with the rehearsal's seeds
    (cohort 2026, augmentation 42, test fraction 0.19) → the lineage table
    and its u8 images on ``device``."""
    from mmtrs_tpu_torch.data.records import build_augmented_table

    df, raw = hard_cohort(n, raw_size, seed=COHORT_SEED)
    proc = preprocess_cohort(raw, raw_size, device)
    return build_augmented_table(df, proc, n_aug=n_aug, preset="legacy", seed=AUGMENT_SEED, test_frac=TEST_FRAC,
                                 device=device)


def platform_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else device.type


def run_stack(table: Table, mm: dict, mil: dict, outdir: Path, folds: int, device: torch.device) -> dict:
    """Stage 6: the final stack (FusionConfig(folds, max_acc),
    stack_tab_like forests) on the streams' OOF and test tables."""
    from mmtrs_tpu_torch.config import FusionConfig, GBDTConfig
    from mmtrs_tpu_torch.fusion.stack import run_final_stack

    return run_final_stack(
        table,
        oof_mm=mm["oof"], pred_mm=mm["test"],
        oof_mil=mil["oof"], pred_mil=mil["test"],
        outdir=outdir,
        cfg=FusionConfig(n_folds=folds, thr_mode="max_acc"),
        tab_cfg=GBDTConfig.stack_tab_like(),
        device=device,
    )


def best_stream_auc(mm: dict, mil: dict) -> float:
    """The better test AUC of the two image streams."""
    from mmtrs_tpu_torch.metrics.binary import roc_auc

    return float(max(roc_auc(mm["test"]["y"], mm["test"]["prob"]), roc_auc(mil["test"]["y"], mil["test"]["prob"])))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="The whole system at reference scale on the card")
    ap.add_argument("--n", type=int, default=422)
    ap.add_argument("--raw_size", type=int, default=512)
    ap.add_argument("--n_aug", type=int, default=10)
    ap.add_argument("--folds", type=int, default=5)
    ap.add_argument("--mm_epochs", type=int, default=DEFAULTS["mm_epochs"])
    ap.add_argument("--mil_epochs", type=int, default=DEFAULTS["mil_epochs"])
    ap.add_argument("--mm_model", default="efficientnet_b4")
    ap.add_argument("--mm_img", type=int, default=380)
    ap.add_argument("--mm_batch", type=int, default=16)
    ap.add_argument("--mil_img", type=int, default=320)
    ap.add_argument("--bag", type=int, default=12)
    ap.add_argument("--out", default="results/rehearsal_h100")
    ap.add_argument("--save_ckpts", action="store_true",
                    help="write each fold's MM/MIL checkpoint (npz + recipe) beside its stream's CSVs")
    ap.add_argument("--device", default=None, help="compute device (default: the card)")
    return ap


def main(argv=None, log=None) -> int:
    """Run the rehearsal; ``log`` (default: print with the seconds since
    the start) takes every progress line."""
    args = build_parser().parse_args(argv)
    t_start = time.perf_counter()
    log = log or (lambda msg: print(f"[{time.perf_counter() - t_start:9.2f} s] {msg}", flush=True))
    from mmtrs_tpu_torch.config import MILConfig, MMJointConfig
    from mmtrs_tpu_torch.train.mil import run_mil_kfold
    from mmtrs_tpu_torch.train.mm import run_mm_kfold
    from mmtrs_tpu_torch.utils.io import save_json

    dev = resolve_device(args.device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    platform = platform_name(dev)
    log(f"[rehearsal] platform={platform} n={args.n}")
    timings: dict[str, float] = {}
    t_total = time.perf_counter()

    t0 = time.perf_counter()
    df, raw = hard_cohort(args.n, args.raw_size, seed=COHORT_SEED)
    timings["cohort_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    proc = preprocess_cohort(raw, args.raw_size, dev)
    sync()
    timings["preprocess_s"] = time.perf_counter() - t0
    timings["preprocess_imgs_per_s"] = len(raw) / timings["preprocess_s"]
    log(f"[rehearsal] preprocess {timings['preprocess_imgs_per_s']:.1f} imgs/s")

    from mmtrs_tpu_torch.data.records import build_augmented_table

    t0 = time.perf_counter()
    table, aug_imgs = build_augmented_table(df, proc, n_aug=args.n_aug, preset="legacy", seed=AUGMENT_SEED,
                                            test_frac=TEST_FRAC, device=dev)
    del proc
    sync()
    timings["augment_s"] = time.perf_counter() - t0
    timings["augment_imgs_per_s"] = len(table) / timings["augment_s"]
    log(f"[rehearsal] {len(table)} rows after augmentation ({timings['augment_imgs_per_s']:.1f} imgs/s)")

    t0 = time.perf_counter()
    mm_cfg = MMJointConfig(model_name=args.mm_model, img_size=args.mm_img, batch_size=args.mm_batch, lr=3e-4,
                           n_folds=args.folds, epochs=args.mm_epochs)
    mm = run_mm_kfold(aug_imgs, table, mm_cfg, outdir=out / "mm", epochs=args.mm_epochs,
                      save_ckpts=args.save_ckpts, log=log, device=dev)
    sync()
    timings["mm_s"] = time.perf_counter() - t0
    mm.pop("folds")
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    mil_cfg = MILConfig(model_name="efficientnet_b0", bag_size=args.bag, img_size=args.mil_img, attn_dim=128,
                        epochs=args.mil_epochs, batch_size=16, lr=3e-4, n_folds=args.folds)
    mil = run_mil_kfold(aug_imgs, table, mil_cfg, outdir=out / "mil", epochs=args.mil_epochs,
                        save_ckpts=args.save_ckpts, log=log, device=dev)
    sync()
    timings["mil_s"] = time.perf_counter() - t0
    mil.pop("states")
    del aug_imgs
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # the stack reads the streams back from the CSVs they wrote, as
    # stack_from_streams does, so a replay from the folder is exact (the
    # CSV parser, pandas' own, may miss a float's last bit)
    from mmtrs_tpu_torch.utils.io import read_table

    for name, stream in (("mm", mm), ("mil", mil)):
        stream["oof"], stream["test"] = (read_table(out / name / f) for f in ("oof_val.csv", "pred_test.csv"))

    t0 = time.perf_counter()
    summary = run_stack(table, mm, mil, out / "stack", args.folds, dev)
    timings["stack_s"] = time.perf_counter() - t0
    timings["total_s"] = time.perf_counter() - t_total

    config = {
        "folds": args.folds, "n_aug": args.n_aug,
        "mm": {"model": mm_cfg.model_name, "img": mm_cfg.img_size, "epochs": args.mm_epochs,
               "train_aug": mm_cfg.train_aug},
        "mil": {"model": mil_cfg.model_name, "img": mil_cfg.img_size, "bag": mil_cfg.bag_size,
                "epochs": args.mil_epochs},
    }
    cut = {k: {"from": v, "to": getattr(args, k)} for k, v in DEFAULTS.items() if getattr(args, k) != v}
    if cut:
        config["cut"] = cut
    rec = {
        "platform": platform,
        "n_cases": args.n,
        "n_rows_augmented": int(len(table)),
        "config": config,
        "timings": {k: round(v, 2) for k, v in timings.items()},
        "streams": {"mm": mm["summary"], "mil": mil["summary"]},
        "stack": {"oof": summary["oof"], "test": summary["test"], "thr": summary["thr"]},
    }
    # strict: the stack must match or beat every stream on the record
    best_stream = best_stream_auc(mm, mil)
    rec["best_stream_test_auc"] = best_stream
    rec["stack_beats_streams"] = bool(summary["test"]["auc"] >= best_stream)
    save_json(rec, out / "summary.json")
    log(json.dumps(rec["stack"], indent=2, default=float))
    log(f"[rehearsal] total {timings['total_s']:.0f}s → {out}/summary.json")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
