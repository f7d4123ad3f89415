#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (mmtrs_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root, on a CUDA machine

Phases (each raises on failure, so the script exits non-zero):
  0. device: a CUDA card is required (there is no CPU path); prints the
     card's name and power limit, and the torch / CUDA versions;
  1. build: compiles mmtrs_tpu_torch/csrc/*.cu with nvcc into build/
     (phase 9 builds the codec's csrc/host libraries);
  2. kernels vs their plain PyTorch versions on the card, at u8 / f32
     [16, 512, 512, 3]: K1 and K2 torch.equal to plain on every input their
     per-pixel halves can see (K1 on an image of every colour,
     [1, 4096, 4096, 3]; K2 on planes of every (L', da, db) triple with
     identity LUTs) and, at [16, 512, 512, 3] and a served upload's
     [1, 512, 512, 3], on teeth, a flat, a two-colour and a saturated random
     image, K1, K2 and the K1+K2 chain (K2's first call on the card fills
     its sRGB encode table and waits for it, once, before any timing); K3
     f32 within 1e-3 and its u8 store equal to
     round-half-up of the f32 result; K5 torch.equal to plain on rows of
     identity, brightness/contrast, HSV, noise σ = √5 and √15, dropout and
     all at once, on the every-colour image under HSV rows that wrap the
     hue both ways and clip S and V (two after brightness/contrast ±0.15),
     on noise over seeds with 0, ±1 and the int32 extremes, on holes
     touching each edge, at [32, 512, 512, 3], [12, 380, 380, 3],
     [2, 752, 1000, 3] and [3, 97, 101, 3] (heads and tails off the 8-byte
     grid), on a view of the last that starts off it and on 40 images with
     the kinds shuffled; K4 and
     K6 on both axes at [16, 512, 512, 3] and the MM trainer's randaug
     batch [12, 380, 380, 3] (rows of 1140 bytes, not 16-byte aligned): K4
     with the chains' warps (legacy / randaug, ten, crop∘augment, half
     flipped), random ±20 per line, and ±100 per line with |α| 3 (whose
     vertical-pass tiles span far more source rows than the kernel stages,
     so they take its global-read branch), K6 with window 11 and
     uniform ±11, ±14 (beyond the window) and, at [4, 512, 512, 3],
     elastic's own fields: u8 bit-equal to plain, f32 within 1e-3; K7 at
     u8 and f32 [32, 512, 512, 3] with a random
     7-row subset: written rows bit-equal to plain, untouched rows
     byte-identical; K8 and K9 at every shape the L-plane route gives them
     (a served request [1, 512, 688], serving's buckets [16, 512, 688],
     [16, 688, 512] and [16, 512, 912], the archive's [4, 3024, 4032] and
     [2, 3024, 4032], and the padded [2, 752, 1000], tw = 125), on the L
     planes of teeth, one value a tile, a two-value checkerboard and
     uniform random values, K9 also on 256 planes where every position
     sees every value (random LUTs) at serving's buckets, and both at
     [1, 40, 50] with 5 × 10 tiles: K8's LUTs, K9's u8 store and its f32
     blend torch.equal to plain; K3 also at [16, 512, 512, 3] and one
     archive image [1, 3024, 4032, 3] on both axes, and at phase 7's
     [2, 752, 1000, 3] (rows of 3000 bytes, not 16-byte aligned), with
     deskew's shear offsets (±45°) and random ±40: u8 bit-equal, f32 within
     1e-3. Times of
     each kernel: one call between CUDA events (median of 50, in turns with
     the library call where there is one), back to back
     (per launch of 60 between two events, the inputs rotated over copies
     whose sum exceeds the 50 MB L2) and the wrapper's host µs (median of
     10 chunks of 100 calls); its plain version's one call; the library call's one-call
     and back-to-back times where one PyTorch call computes the function
     (K7 index_copy_; K3 and K6 grid_sample at f32, beside their own f32
     times; K3, K4 and K6 per shape, axis and offsets); and each kernel's
     bound: the larger of its bytes over 3.35 TB/s and its f32 operations
     over 67 TFLOP/s (the H100 SXM's published peaks);
  3. preprocess_batch at [16, 512, 512, 3] with deskew firing on 2 images:
     K1-K3 launched, and the result against the same port run on the CPU
     (seg_valid equal, angles within 1e-3°, boxes within 1 px, u8 within
     2 levels on ≥ 99.9 % of values), the caller's batch byte-identical
     after the in-place deskew; imgs/s;
  4. serving: PredictService with a 2-fold bf16 MILEnsemble of
     MILNet("efficientnet_b0", attn_dim=128) (random weights from seeded
     generators) answers uploads at 512², 512×768, 640×512 and 512×1024
     (the fused route: the K1-K3 counters rise per request, K8/K9's do not)
     and phone-shaped uploads at 768×1024, 1024×768 and 576×1024, which
     bucket to 512×688, 688×512 and 512×912 (the L-plane route: K8, K9 and
     K3 rise, K1/K2 do not; the bucket resize on the card equals the same
     function on the CPU), and refuses a 480×640 one; p50 latency per route;
     an f32 copy of each fold's logit on the card agrees with the CPU within
     1e-3 relative;
  5. augmentation: preprocess_augment_batch with the legacy preset at u8
     [32, 512, 512, 3], draws from draw_legacy for origin ids chosen so that
     every gated member fires among the first 8 images, deskew on 2 of
     them: K1-K6 each launched, u8 out, the first 8 against the same port on
     the CPU with the same draws (bars of phase 3), the caller's batch
     byte-identical after the in-place write-backs; imgs/s of the chain and
     of augment_batch(·, "legacy") alone;
  6. the other presets: ``ten`` and ``simple`` through the records device
     loop (augment_children) on u8 [32, 512, 512, 3] synthetic teeth, 10
     children per origin (10 batches of 32, every variant), and
     ``randaug`` at u8 [12, 512, 512, 3] (the MM trainer's batch) on
     lineages chosen so that all 14 ops and the erasing fire among the
     first 8: K4 and K7 (and K6 for ``ten``) launched, values in 0..255,
     the caller's batch byte-identical afterwards,
     the first 10 children (8 randaug images) against the same port on the
     CPU with the same draws (u8 within 2 levels on ≥ 99.9 % of values);
     imgs/s of augment_batch per preset and host ms of its draws;
  7. the archive pass: preprocess_stream over in-memory u8 batches of
     [4, 3024, 4032, 3] synthetic 12 MP teeth (3 batches after a warm-up):
     the L-plane route (K8, K9, K3 launched, K1/K2 not), metas in order,
     the host batches byte-identical, imgs/s; and a [2, 752, 1000, 3]
     batch (a 750×1000 archive padded to /8) against the same port on the
     CPU with phase 3's bars;
  8. the full service from a weights folder: the phase writes one into a
     temporary directory under build/ through the port's own code, with
     no JAX: 5 folds of MMJointDualHead("efficientnet_b4") and 5 of
     MILNet("efficientnet_b0", 128), each a seeded Flax-default init with
     BatchNorm statistics from synthetic teeth as served (MM: its
     residual branches scaled by MM_RESIDUAL_SCALE, then at 380² through
     the three views; its tabular MLP's BatchNorms from seeded rows of
     encode_fields), written as npz (mm_joint_to_flax /
     milnet_to_flax + save_npz_checkpoint) beside the repo's recipes
     (results/rehearsal_r5/{mm,mil}/*.recipe.json) and OOF CSVs, and 5
     seeded forests shaped like GBDTConfig.stack_tab_like() (700 trees,
     depth 5, 16 features). build_service_from_weights on its default
     device, the card, then answers phase 4's seven uploads, without and
     with all 9 fields (a warm-up, then 3 repetitions): the route's
     kernels rise and the other route's do not, the streams are
     {prob_mm, prob_mil} or {prob_mm, prob_mil, prob_tab}, p_indirect lies
     in [0, 1]; the Stacker's thresholds equal a CPU fit's on the same
     CSVs (youden within 1e-6); the served MM folds equal the written
     ones, fold 0 in f32 on the card agrees with the CPU within 1e-3
     relative on both logits, and the Tab stream within 1e-6; the served
     bf16 MM and MIL streams (every fold, the three views, the division
     by T) agree, on one processed upload with and without fields, with
     ensembles read from the same folder onto the CPU within
     SERVE_BF16_BAR in p, and the MM ensemble in f32 from the service's
     folds with the CPU's within SERVE_F32_BAR; prints serve p50 per
     route with and without fields, and one request's stages
     (preprocess, MM, MIL, Tab, fuse) on the host clock, a synchronise
     after each, beside the card's name and power limit;
  9. the entry points on phase 8's service, before its folder is removed:
     the codec (nvJPEG on the card, which has no libjpeg: its decode of the
     committed Pillow goldens within the NVJPEG_* bar, a q95 round trip
     stable over two runs, PNG exact, the libjpeg backend's build refused
     by name; decode ms of a 12 MP JPEG, encode ms of a 512² one); the CLI
     twin (``cli.run_pipeline.main`` on its default device, batch 4) over 9
     synthetic 12 MP teeth written as JPEGs under build/, one image below
     400 px and one garbage file: 9 outputs, the two rejects logged, each
     output before encoding torch.equal to ``preprocess_numpy`` on its
     decoded, padded batch, K8, K9, K3 and K7 launched and K1/K2 not; its
     images/s beside phase 7's; the app (``serve.app.make_server`` on an
     ephemeral port in a thread, stopped after): GET / and /ui, POST
     /predict with phase 8's seven uploads as JPEG and as PNG, without and
     with all 9 fields, each answer equal to ``predict_one`` on the decoded
     upload and each preview PNG to its ``processed_image``, the 300×300
     and partial-fields refusals with the JAX service's words; HTTP p50
     beside ``predict_one``'s;
 10. training the MM stream (the rehearsal's stages 2-4 at
     MMJointConfig's widths: B4 at 380, batch 12, bf16, randaug; depth cut
     to 24 cases, 2 folds, 1 epoch): 24 raw 512² synthetic teeth with 9
     seeded fields and labels through preprocess_batch (K1-K3),
     build_augmented_table(n_aug=2, legacy) (K4, K5, K7, and K1/K2, K6 as
     drawn), run_mm_kfold with save_ckpts into a temporary folder (randaug:
     K4, K7): every step loss finite, every fold's parameters and running
     statistics moved, the npz folds, recipes, CSVs, summary.json and
     metrics.jsonl written; build_service_from_weights on that folder
     answers phase 4's seven uploads without and with fields, each p within
     SERVE_BF16_BAR and SERVE_SAME_DEVICE_BAR of trainer.predict_proba on
     the same processed image;
     6 bf16 steps timed one by one (prep and step ms, imgs/s) and the run's
     peak memory; one f32 step of B4 at 380 (batch 4, no augmentation or
     dropout) on the card against the CPU within the F32_* bars; its
     seconds per stage and kernel launches per stage on earlier lines.
 11. the rest of the rehearsal (steps 5-6) on phase 10's table and folder:
     make_bags card vs CPU; run_mil_kfold at MILConfig's widths (B0, bag
     12 at 320, batch 16, bf16; 2 folds, 1 epoch, save_ckpts), 6 bf16 steps
     timed (bags/s, peak memory) and one f32 B0 MIL step card vs CPU
     within the F32_* bars; train_gbdt at stack_tab_like on a seeded
     3,762 × 9 table twice (equal forests) and on the CPU (GBDT_* bars),
     with its seconds, device events a tree and host syncs;
     run_final_stack card vs CPU (STACK_* bars); train_tab_kfold;
     cli.run_fusion train and infer-batch card vs CPU (FUSION_BAR); then
     build_service_from_weights on the folders phases 10-11 trained,
     each served stream within SERVE_ALL_BAR of its trained model.
 12. the vision trainers on phase 10's table and images at the recipes'
     widths (depth cut to 24 cases x 3 rows, 1-2 epochs, 2 folds, 1 seed):
     (a) the rows written as JPEGs (nvJPEG) and a CSV, then
     cli.run_train_images --task hard (efficientnet_b3, 512, b16, legacy)
     and --task soft (convnext_tiny, 512, b16, ten), 1 epoch each, their
     augmentation kernels launched; each checkpoint served through
     fusion.streams._predict_vision_ckpt (f32) on the card and the CPU
     within VISION_CKPT_BAR; (b) collect_base_preds on those and on
     xgb_like / lgbm_like forests (STREAM_TREES trees): four streams; (c)
     train_progressive(efficientnet_b4, 384 b16 -> 512 b8, 1 epoch each,
     legacy) and progressive_ensemble_probs; (d) run_hard_kfold
     (convnextv2_base 512 b8 f32, 2 folds x 2 epochs, freeze 1, MixUp, EMA
     .99, accumulation 2): every backbone parameter bit-equal through the
     frozen epoch, then run_threshold_sweep on the folds' logits; (e)
     finalize_mm_from_ckpts on phase 10's folds within FINALIZE_BAR of its
     run; (f) one f32 step of convnext_tiny and convnextv2_base (b2, 224²,
     LayerScale and GRN randomised) card vs CPU within the F32_* bars; (g)
     6 bf16 steps each of B3 hard b16, ConvNeXt-tiny soft b16 and
     ConvNeXtV2-base k-fold b8 at 512², timed with the prep apart, and the
     peak memory of each.
 13. the pipeline's last entry points: (a) cli.rehearsal at its widths
     (MM efficientnet_b4 380 b16 randaug, MIL B0 bag 12 at 320,
     stack_tab_like), depth cut to 26 cases x 3 rows, 2 folds, 1 epoch:
     every summary.json key present and finite, then cli.stack_from_streams
     on a copy of its folder writing the same stack byte for byte; (b)
     cli.run_augment --strength strong and medium and cli.run_augment_simple
     on 8 teeth written as JPEG, PNG and BMP (one 768x1024, one 600x520);
     (c) cli.make_balanced_splits and cli.make_group_splits on phase 10's
     table, no group across splits; (d) cli.eval_vision on phase 12's
     vision_hard_best within EVAL_VISION_BAR of _predict_vision_ckpt on the
     same decoded images; (e) cli.evaluate_models --which blend on phase
     12's forests (xgb_like Platt-calibrated).

The counters are reset just before each driven path (phases 3, 4, 5, each
preset of 6, 7, 8, 9's CLI and app runs, each stage of 10 and 11, 12's CLI
and progressive runs, and 13's rehearsal and augmentation CLIs); the JSON line of kernels
reports K1-K3's and K8-K9's launches from the serving run (phase 4),
K4-K6's from the augmentation run (phase 5) and K7's from the preset runs
(phase 6).
The last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import functools
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SHAPE = (16, 512, 512, 3)
AUG_SHAPE = (32, 512, 512, 3)  # build_augmented_table's default batch (data/records.py:63)
SERVE_SHAPE = (1, 512, 512, 3)  # one served 512² upload on the fused route
SEED = 20261016
# the kernels each driven path runs: serving on the fused route (phases 3,
# 4), serving and the archive on the L-plane route (phases 4, 7) and the
# augmentation chain (phase 5)
FUSED_KERNELS = ("clahe_lab_fwd_lut", "clahe_apply_lab_bwd")
L_KERNELS = ("clahe_hist_lut", "clahe_apply")
SERVE_KERNELS = FUSED_KERNELS + ("shift_rows",)
L_ROUTE_KERNELS = L_KERNELS + ("shift_rows",)
AUG_KERNELS = SERVE_KERNELS + ("resample_rows", "photometric", "shift_rows_windowed")
# gated members of the legacy preset that must fire among the first 8 images
AUG_MEMBERS = ("hflip", "vflip", "ssr", "persp", "clahe", "bc", "hsv", "noise", "dropout", "blur", "elastic")
PRESET_SHAPE = AUG_SHAPE
RANDAUG_SHAPE = (12, 512, 512, 3)  # the MM trainer's batch_size (config.py:276)
L_SHAPE = (16, 512, 688)  # serving's L plane: a 4:3 phone photo's bucket
# every shape the L-plane route gives K8 and K9: a served request, serving's
# buckets at b16, the archive's batch (and the b2 that PR 5-8 timed), and a
# 750x1000 archive padded to /8; the timed ones
L_CHECK_SHAPES = ((1, 512, 688), L_SHAPE, (16, 688, 512), (16, 512, 912), (4, 3024, 4032), (2, 3024, 4032),
                  (2, 752, 1000))
L_TIMED_SHAPES = (L_SHAPE, (1, 512, 688), (4, 3024, 4032), (2, 3024, 4032))
# serving's uploads: shapes the fused route takes, and phone photos' shapes,
# which bucket to 512x688, 688x512 and 512x912 and take the L-plane route
FUSED_UPLOADS = [(512, 512), (512, 768), (640, 512), (512, 1024)]
PHONE_UPLOADS = [(768, 1024), (1024, 768), (576, 1024)]
ARCHIVE_SHAPE = (4, 3024, 4032, 3)  # a batch of 12 MP phone photos
ARCHIVE_BATCHES = 3
SMALL_ARCHIVE_SHAPE = (2, 752, 1000, 3)  # a 750x1000 archive padded to /8
# the kernels each preset of phase 6 runs
PRESET_KERNELS = {
    "ten": ("resample_rows", "shift_rows_windowed", "scatter_rows"),
    "simple": ("resample_rows", "scatter_rows"),
    "randaug": ("resample_rows", "scatter_rows"),
}


T_START = time.perf_counter()
# the H100 SXM's published peaks (NVIDIA's data sheet): device memory and
# f32 outside the tensor cores; and its L2, which back-to-back timing rotates
# its inputs past
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
L2_BYTES = 50e6
B2B_LAUNCHES = 60  # back-to-back launches between two events
ONE_CALL_REPS = 50  # single calls whose median is a kernel's one-call time
HOST_CALLS = 1000  # wrapper calls whose host time is taken (median of 10 chunks of 100)
# K3 at deskew's shapes: a 512^2 batch, one archive image, and phase 7's
# small archive batch, whose rows (W·C = 3000 bytes) are not 16-byte aligned
K3_SHAPES = ((16, 512, 512, 3), (1, 3024, 4032, 3), SMALL_ARCHIVE_SHAPE)
# K4 and K6 also at the MM trainer's randaug batch: 12 images at 380²
# (mmtrs_tpu/config.py:268,276), whose rows (W·C = 1140 bytes) are not
# 16-byte aligned
MM_SHAPE = (12, 380, 380, 3)
# K5 also at images of 29,391 bytes (97 x 101 x 3), so that their heads and
# tails fall off the 8-byte grid, and a view of them that starts off it
K5_ODD_SHAPE = (3, 97, 101, 3)
# f32 operations per output element of each kernel's formula, each exp, log
# and division counted as one (so the least the card must issue): the LAB
# conversions, pows and blends of csrc/*.cu counted line by line. The card
# issues 8-20 instructions for one exp, log or IEEE division, so the bound
# is what a perfect kernel could approach, not what holds one of these back
# (K1 and K2 issue about 200 instructions a pixel, `chip_profile.py --sass`)
OPS_PER_ELEMENT = {
    "clahe_lab_fwd_lut": 90,    # per pixel: 3 gamma pows, XYZ, 3 cube roots, L a b, quantise, count
    "clahe_apply_lab_bwd": 110,  # per pixel: blend, L' store, inverse f, RGB, 3 gamma pows
    "shift_rows": 8,             # per value: two taps, weight, blend, store
    "resample_rows": 12,         # per value: affine source, two hat taps, blend, store
    "photometric": 110,          # per pixel: brightness/contrast, HSV there and back, noise, dropout
    "shift_rows_windowed": 10,   # per value: clipped source, two taps, blend, store
    "scatter_rows": 0,           # a copy
    "clahe_hist_lut": 1,         # per pixel: one count; the 256-bin scan is per tile
    "clahe_apply": 30,           # per pixel: tile coordinates, 4 gathers, blend, store
}


def _fail(msg: str) -> int:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    return 1


def _time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of one call, from CUDA events around each call
    (the card idle before it, so it includes the call's host dispatch)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def _time_pair_ms(fn_a, fn_b, reps: int = ONE_CALL_REPS, warmup: int = 3) -> tuple[float, float]:
    """:func:`_time_ms` of two calls taken in turns (a, b, b, a, ...), so
    that both meet the same card and host: medians of ``reps`` each."""
    for _ in range(warmup):
        fn_a()
        fn_b()
    ta, tb = [], []
    for i in range(reps):
        for fn, times in ((fn_a, ta), (fn_b, tb))[:: 1 if i % 2 == 0 else -1]:
            times.append(_time_ms(fn, reps=1, warmup=0))
    return float(np.median(ta)), float(np.median(tb))


def _rotations(args) -> list:
    """``args`` and copies of it (each tensor cloned), enough sets that their
    tensors together exceed the card's 50 MB L2: a launch that takes the
    next set finds its inputs in device memory, not in the cache."""
    import torch

    nbytes = sum(a.numel() * a.element_size() for a in args if isinstance(a, torch.Tensor))
    n = max(2, int(L2_BYTES // max(nbytes, 1)) + 1)
    return [tuple(args)] + [tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args)
                            for _ in range(n - 1)]


def _b2b_ms(fn, argsets, launches: int = B2B_LAUNCHES) -> float:
    """Device ms per launch of ``launches`` back-to-back calls of ``fn``
    between two CUDA events, taking the argument sets in turn."""
    import torch

    fn(*argsets[0])
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for i in range(launches):
        fn(*argsets[i % len(argsets)])
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / launches


def _host_us(fn, args, calls: int = HOST_CALLS, chunk: int = 100) -> float:
    """Host µs per call of ``fn``: time.perf_counter_ns over ``calls`` calls
    in chunks, with a synchronise between them outside the clock, so the
    launch queue never fills and the clock reads the host's own work; the
    median of the chunks' means, so that a chunk the shared host interrupts
    does not carry the figure."""
    import torch

    fn(*args)
    means = []
    for _ in range(calls // chunk):
        torch.cuda.synchronize()
        t0 = time.perf_counter_ns()
        for _ in range(chunk):
            fn(*args)
        means.append((time.perf_counter_ns() - t0) / chunk / 1e3)
    torch.cuda.synchronize()
    return float(np.median(means))


def _bound_ms(nbytes: int, ops: int) -> tuple[float, str]:
    """The least time the card could take: the larger of the bytes moved
    (each input read once, each output written once) over the memory rate
    and the operations over the f32 rate; and which of the two it is."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, ops / PEAK_F32_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)
    print(f"  ok: {what}")


def phase_kernels(torch, dev):
    from mmtrs_tpu_torch.ops.clahe import quantize_u8
    from mmtrs_tpu_torch.ops.kernels.shift import shift_rows, shift_rows_ref
    from mmtrs_tpu_torch.synth import synth_teeth

    print("phase 2: kernels vs plain on the card at", SHAPE)
    x = torch.from_numpy(synth_teeth(SHAPE[0], SHAPE[1], seed=SEED)).to(dev)

    gen = torch.Generator().manual_seed(SEED)
    xf = (torch.rand(SHAPE, generator=gen) * 255.0).to(dev).contiguous()
    k3_err = 0.0
    for axis, n in ((2, SHAPE[1]), (1, SHAPE[2])):
        off = ((torch.rand((SHAPE[0], n), generator=gen) * 80.0) - 40.0).to(dev)
        e = (shift_rows(xf, off, axis) - shift_rows_ref(xf, off, axis)).abs().max().item()
        k3_err = max(k3_err, e)
        _check(e <= 1e-3, f"K3 f32 axis {axis} max err {e:.3g} <= 1e-3")
        u8 = shift_rows(x, off, axis)
        f32 = shift_rows(x.float(), off, axis)
        _check(torch.equal(u8, quantize_u8(f32)), f"K3 u8 axis {axis} == round-half-up of f32")
        _check(torch.equal(u8, shift_rows_ref(x, off, axis)), f"K3 u8 axis {axis} == plain")
    k3_stat, k3_detail, e = _check_shift_rows(torch, dev, x, gen)
    k3_err = max(k3_err, e)

    stats, errs = {"shift_rows": k3_stat}, {"shift_rows": k3_err}
    for name, err, st in _check_clahe_lab(torch, dev, x, gen):
        errs[name], stats[name] = err, st
    for check in (_check_resample, _check_photometric, _check_windowed, _check_scatter, _check_clahe_l):
        for name, err, st in check(torch, dev, x, xf, gen):
            errs[name], stats[name] = err, st
    print(f"  times (ms): one call between events (median of {ONE_CALL_REPS}), back to back (per launch of "
          f"{B2B_LAUNCHES}, inputs rotated past the L2); host us per wrapper call (median of {HOST_CALLS // 100} chunks of 100)")
    f = lambda v, d=4: "-" if v is None else f"{v:.{d}f}"
    for k, st in stats.items():
        print(f"  {k}: kernel {f(st['ms'])} / b2b {f(st['ms_b2b'])} ms, host {f(st['host_us'], 2)} us; "
              f"plain {f(st['plain_ms'])} ms; library {f(st['library_ms'])} / b2b {f(st['library_ms_b2b'])} ms; "
              f"bound {st['bound_ms'] * 1e3:.2f} us by {st['bound_by']} ({st['nbytes']} B, {st['ops']} ops)")
    stats["shift_rows"]["detail"] = k3_detail
    return stats, errs


def every_byte_triple() -> np.ndarray:
    """u8 [4096, 4096, 3] that holds each of the 2^24 byte triples once. As
    RGB it is every colour, and K1's per-pixel outputs are a function of one
    colour; as planes (L', da, db) it is every input of K2's per-pixel
    backward conversion (identity LUTs make the blend return L')."""
    i = np.arange(1 << 24, dtype=np.uint32)
    return np.stack([i >> 16, (i >> 8) & 255, i & 255], axis=-1).astype(np.uint8).reshape(4096, 4096, 3)


def _adversarial_images(torch, dev, shape, gen):
    """(what, u8 RGB) at ``shape``: one colour (a tile's counts in one bin,
    so the redistribution carries the largest excess), two colours in a
    checkerboard (two bins, half of a warp's lanes on each), and saturated
    random pixels (uniform, a quarter of the channels at 0 or 255)."""
    B, H, W, _ = shape
    flat = torch.empty(shape, dtype=torch.uint8)
    flat[...] = torch.tensor([228, 208, 160], dtype=torch.uint8)
    two = flat.clone()
    two[:, (torch.arange(H)[:, None] + torch.arange(W)[None, :]) % 2 == 1] = torch.tensor([60, 35, 40], dtype=torch.uint8)
    rnd = torch.randint(0, 256, shape, generator=gen, dtype=torch.uint8)
    sat = torch.rand(shape, generator=gen)
    rnd[sat < 0.125] = 0
    rnd[sat >= 0.875] = 255
    return [("flat", flat.to(dev)), ("two-colour", two.to(dev)), ("saturated random", rnd.to(dev))]


def _max_err(got, want) -> float:
    return float(max((g.int() - w.int()).abs().max().item() for g, w in zip(got, want)))


def _check_clahe_lab(torch, dev, x, gen):
    """K1 and K2 held ``torch.equal`` to their plain versions on every input
    their per-pixel halves can see: K1 on the every-colour image
    [1, 4096, 4096, 3] (planes and LUTs), K2 on the every-triple planes with
    identity LUTs; both at [1, 40, 50, 3] with 5 x 10 tiles and at
    [4, 512, 512, 3] (the paths the main shapes do not take); and at
    [16, 512, 512, 3] and a served upload's
    [1, 512, 512, 3] on teeth, a flat, a two-colour and a saturated random
    image: K1, K2 on K1's planes, and the chain against the plain chain.
    Times at both shapes on teeth; the JSON line takes [16, 512, 512, 3]'s,
    the other stands in its ``detail``."""
    from mmtrs_tpu_torch.ops.kernels import clahe_lab as K

    clip, tiles = 3.0, (8, 8)
    every = torch.from_numpy(every_byte_triple()).to(dev)[None]
    got, want = K.clahe_lab_fwd_lut(every, clip, tiles), K.clahe_lab_fwd_lut_ref(every, clip, tiles)
    for name, g, w in zip(("L", "da", "db", "LUTs"), got, want):
        _check(torch.equal(g, w), f"K1 every colour {tuple(every.shape)}: {name} equal to plain")
    lq, da, db = (every[..., c].contiguous() for c in range(3))
    da, db = da.view(torch.int8), db.view(torch.int8)
    ident = torch.arange(256, dtype=torch.uint8, device=dev).expand(1, tiles[0] * tiles[1], 256).contiguous()
    out = K.clahe_apply_lab_bwd(lq, da, db, ident, tiles)
    _check(torch.equal(out, K.clahe_apply_lab_bwd_ref(lq, da, db, ident, tiles)),
           "K2 every (L', da, db) triple, identity LUTs: equal to plain")
    del every, got, want, lq, da, db, out
    # the paths the main shapes do not take: rows of a tile not a multiple of
    # 4 pixels (byte by byte), LUT rows read from global memory (10 tiles
    # across), and a tile split over a cluster of 2 blocks (b4)
    for shape, tl in (((1, 40, 50, 3), (5, 10)), ((4, 512, 512, 3), tiles)):
        img = _teeth_at(torch, dev, x, shape)
        got, want = K.clahe_lab_fwd_lut(img, clip, tl), K.clahe_lab_fwd_lut_ref(img, clip, tl)
        _check(all(torch.equal(g, w) for g, w in zip(got, want)), f"K1 {shape} tiles {tl}: equal to plain")
        _check(torch.equal(K.clahe_apply_lab_bwd(*got, tl), K.clahe_apply_lab_bwd_ref(*got, tl)),
               f"K2 {shape} tiles {tl}: equal to plain")
    res = {}
    for shape in (SHAPE, SERVE_SHAPE):
        teeth = x[: shape[0]]
        for what, img in [("teeth", teeth)] + _adversarial_images(torch, dev, shape, gen):
            got, want = K.clahe_lab_fwd_lut(img, clip, tiles), K.clahe_lab_fwd_lut_ref(img, clip, tiles)
            _check(all(torch.equal(g, w) for g, w in zip(got, want)), f"K1 {shape} {what}: L, da, db, LUTs equal to plain")
            out = K.clahe_apply_lab_bwd(*got, tiles)
            _check(torch.equal(out, K.clahe_apply_lab_bwd_ref(*got, tiles)), f"K2 {shape} {what}: equal to plain")
            _check(torch.equal(out, K.clahe_lab_fused_ref(img, clip, tiles)), f"K1 + K2 chain {shape} {what}: equal to plain")
        got = K.clahe_lab_fwd_lut(teeth, clip, tiles)
        want = K.clahe_lab_fwd_lut_ref(teeth, clip, tiles)
        out = K.clahe_apply_lab_bwd(*got, tiles)
        px = teeth.numel() // 3
        res[shape] = [
            ("clahe_lab_fwd_lut", _max_err(got, want), _stat(
                "clahe_lab_fwd_lut", K.clahe_lab_fwd_lut, (teeth, clip, tiles),
                lambda: K.clahe_lab_fwd_lut_ref(teeth, clip, tiles), _nbytes(teeth, *got), px)),
            ("clahe_apply_lab_bwd", _max_err([out], [K.clahe_apply_lab_bwd_ref(*got, tiles)]), _stat(
                "clahe_apply_lab_bwd", K.clahe_apply_lab_bwd, (*got, tiles),
                lambda: K.clahe_apply_lab_bwd_ref(*got, tiles), _nbytes(*got, out), px)),
        ]
    keys = ("ms", "ms_b2b", "host_us", "plain_ms", "bound_ms")
    for (name, _, st), (_, _, one) in zip(res[SHAPE], res[SERVE_SHAPE]):
        st["detail"] = [{"shape": list(SERVE_SHAPE), **{k: one[k] for k in keys}}]
        print(f"  {name} at {SERVE_SHAPE}: kernel {one['ms']:.4f} / b2b {one['ms_b2b']:.4f} ms, "
              f"host {one['host_us']:.2f} us; plain {one['plain_ms']:.4f} ms; bound {one['bound_ms'] * 1e3:.2f} us")
    return res[SHAPE]


def _deskew_offsets(torch, gen, B, n_lines, axis):
    """Offsets like deskew's shears (ops/warp.py rotate_shear3) for B images
    rotated by angles uniform in ±45°: ``alpha·(y − cy)`` with alpha =
    −tan(θ/2) for the x-shear (axis 2), ``sin θ·(x − cx)`` for the y-shear
    (axis 1)."""
    theta = (torch.rand(B, generator=gen) * 90.0 - 45.0) * (np.pi / 180.0)
    slope = -torch.tan(theta / 2.0) if axis == 2 else torch.sin(theta)
    return slope[:, None] * (torch.arange(n_lines, dtype=torch.float32)[None, :] - n_lines / 2.0)


def _grid_sample_shift(torch, img_nchw, off, axis):
    """(fn, args) of one ``grid_sample`` call that computes K3's shift (or
    K6's with per-pixel ``off``) at f32 on an NCHW batch: bilinear, border
    padding, align_corners, so p + off is the source position; the grid is
    built here, outside the timed call."""
    B, _, H, W = img_nchw.shape
    dev = img_nchw.device
    ys = torch.arange(H, dtype=torch.float32, device=dev)[None, :, None].expand(B, H, W)
    xs = torch.arange(W, dtype=torch.float32, device=dev)[None, None, :].expand(B, H, W)
    if off.dim() == 2:
        off = off[:, :, None] if axis == 2 else off[:, None, :]
    if axis == 2:
        xs = xs + off
    else:
        ys = ys + off
    grid = torch.stack([2.0 * xs / (W - 1) - 1.0, 2.0 * ys / (H - 1) - 1.0], dim=-1).contiguous()
    fn = lambda im, g: torch.nn.functional.grid_sample(
        im, g, mode="bilinear", padding_mode="border", align_corners=True)
    return fn, (img_nchw, grid)


def _teeth_at(torch, dev, x, shape):
    """u8 teeth at a checked shape: phase 2's batch (or its first images),
    archive images, or synthetic teeth at another size."""
    from mmtrs_tpu_torch.synth import synth_teeth

    B, H, W, _ = shape
    if shape[1:] == SHAPE[1:] and B <= SHAPE[0]:
        return x[:B]
    if (H, W) == ARCHIVE_SHAPE[1:3]:
        return torch.from_numpy(_archive_batch()[:B]).to(dev)
    return torch.from_numpy(synth_teeth(B, (H, W), seed=SEED + 7)).to(dev)


def _check_shift_rows(torch, dev, x, gen):
    """K3 on both axes at each of K3_SHAPES, with deskew's shear offsets and
    with random ±40:
    u8 bit-equal to plain, f32 within 1e-3; back-to-back times of each at
    u8 and f32, and ``grid_sample``'s at f32 with deskew's offsets at
    [16, 512, 512, 3]. The JSON line's numbers are deskew's x-shear at u8
    [16, 512, 512, 3] (what the main path runs)."""
    from mmtrs_tpu_torch.ops.kernels.shift import shift_rows, shift_rows_ref

    detail, err, stat = [], 0.0, None
    for shape in K3_SHAPES:
        B, H, W, C = shape
        u8 = _teeth_at(torch, dev, x, shape)
        f32 = u8.float()
        for axis in (2, 1):
            lines = H if axis == 2 else W
            for kind in ("deskew", "random ±40"):
                off = (_deskew_offsets(torch, gen, B, lines, axis) if kind == "deskew"
                       else torch.rand((B, lines), generator=gen) * 80.0 - 40.0).to(dev)
                got = shift_rows(u8, off, axis)
                _check(torch.equal(got, shift_rows_ref(u8, off, axis)),
                       f"K3 u8 {shape} axis {axis} {kind}: bit-equal to plain")
                e = (shift_rows(f32, off, axis) - shift_rows_ref(f32, off, axis)).abs().max().item()
                _check(e <= 1e-3, f"K3 f32 {shape} axis {axis} {kind}: max err {e:.3g} <= 1e-3")
                err = max(err, e)
                row = {"shape": list(shape), "axis": axis, "offsets": kind,
                       "bound_ms": _bound_ms(_nbytes(u8, off, u8), OPS_PER_ELEMENT["shift_rows"] * u8.numel())[0],
                       "u8_ms_b2b": _b2b_ms(shift_rows, _rotations((u8, off, axis))),
                       "f32_ms_b2b": _b2b_ms(shift_rows, _rotations((f32, off, axis)))}
                if shape == SHAPE and kind == "deskew":
                    lib_fn, lib_args = _grid_sample_shift(torch, f32.permute(0, 3, 1, 2).contiguous(), off, axis)
                    d = (lib_fn(*lib_args).permute(0, 2, 3, 1) - shift_rows(f32, off, axis)).abs().max().item()
                    row.update(grid_sample_ms=_time_ms(lambda: lib_fn(*lib_args)),
                               grid_sample_ms_b2b=_b2b_ms(lib_fn, _rotations(lib_args)),
                               grid_sample_max_diff=d, f32_ms=_time_ms(lambda: shift_rows(f32, off, axis)))
                    if axis == 2:
                        stat = _stat("shift_rows", shift_rows, (u8, off, axis), lambda: shift_rows_ref(u8, off, axis),
                                     _nbytes(u8, off, u8), u8.numel(), library=(lib_fn, lib_args))
                        stat.update(f32_ms=row["f32_ms"], f32_ms_b2b=row["f32_ms_b2b"])
                detail.append(row)
                gs = ("" if "grid_sample_ms" not in row else
                      f"; f32 one call {row['f32_ms']:.4f}; grid_sample f32 {row['grid_sample_ms']:.4f} / b2b "
                      f"{row['grid_sample_ms_b2b']:.4f} ms (max diff from K3 {row['grid_sample_max_diff']:.3g})")
                print(f"  K3 {shape} axis {axis} {kind}: b2b u8 {row['u8_ms_b2b']:.4f}, f32 {row['f32_ms_b2b']:.4f} ms, "
                      f"bound (u8) {row['bound_ms'] * 1e3:.2f} us{gs}")
    return stat, detail, err


def _stat(name, fn, args, plain, nbytes, elements, library=None):
    """Times of a kernel's wrapper ``fn(*args)``: one call between events
    (``ms``, median of ONE_CALL_REPS), back to back over inputs rotated past
    the L2 (``ms_b2b``) and its host cost (``host_us``); its plain version's
    one call; and, where one PyTorch call computes the same function
    (``library``: (fn, args)), that call's one-call time, taken in turns
    with the kernel's, and its back-to-back time. Besides, the bound of the
    work on these inputs."""
    ops = OPS_PER_ELEMENT[name] * elements
    bound, by = _bound_ms(nbytes, ops)
    st = {"plain_ms": _time_ms(plain), "ms_b2b": _b2b_ms(fn, _rotations(args)), "host_us": _host_us(fn, args),
          "library_ms": None, "library_ms_b2b": None,
          "nbytes": nbytes, "ops": ops, "bound_ms": bound, "bound_by": by}
    if library is None:
        st["ms"] = _time_ms(lambda: fn(*args), reps=ONE_CALL_REPS)
    else:
        lib_fn, lib_args = library
        st["ms"], st["library_ms"] = _time_pair_ms(lambda: fn(*args), lambda: lib_fn(*lib_args))
        st["library_ms_b2b"] = _b2b_ms(lib_fn, _rotations(lib_args))
    return st


def _warp_mats(torch, B, S, first: str):
    """Forward maps [B, 3, 3] of the warps the chains draw at S²: a third
    from ``first`` (the ``legacy`` or ``randaug`` preset's draws), a third
    from ``ten``'s, a third ``first``'s composed with a tooth's crop as
    ``crop_warp_fused`` composes them; every second map flipped in x and y,
    so that both passes meet α < 0."""
    from mmtrs_tpu_torch.ops.augment import draw_batch, draw_legacy, draw_randaug
    from mmtrs_tpu_torch.ops.resize import _crop_warp_matrix
    from mmtrs_tpu_torch.ops.warp import hflip3, mat3, vflip3

    ids = list(range(B))
    own = (draw_legacy(SEED, ids, 0, S, S, img_size=S) if first == "legacy"
           else draw_randaug(SEED, ids, 0, S, S)).mats
    variants = [i % 9 for i in ids]  # ten's variants with a warp (9 is elastic)
    ten = draw_batch("ten", SEED, ids, [v + 1 for v in variants], S, S, aug_idx=variants).mats
    gen = torch.Generator().manual_seed(SEED + 8)
    centre = S / 2.0 + (torch.rand((B, 2), generator=gen) - 0.5) * (S / 5.0)
    half = (0.3 + 0.15 * torch.rand((B, 2), generator=gen)) * S
    boxes = torch.cat([centre - half, centre + half], dim=1).clamp(0.0, S - 1.0)  # (y0, x0, y1, x1)
    crop = _crop_warp_matrix(boxes, own, S, S, S, 15.0)[0]
    third = torch.arange(B) * 3 // B
    mats = torch.where((third == 0)[:, None, None], own, torch.where((third == 1)[:, None, None], ten, crop))
    flip = mat3(hflip3(float(S)), vflip3(float(S)))
    return torch.where((torch.arange(B) % 2 == 1)[:, None, None], mat3(mats, flip), mats)


def _check_resample(torch, dev, x, xf, gen):
    """K4 on both axes at phase 2's [16, 512, 512, 3] and at the MM
    trainer's randaug batch [12, 380, 380, 3] (rows of 1140 bytes, not
    16-byte aligned), with the offsets of the chains' warps (``_warp_mats``),
    with random ±20 per line (half the images flipped, α −1.05 or 0.9), and
    with random ±100 per line at α 3 or −3: a 32-column tile of the
    vertical pass then needs source rows spread over about 200 (the
    offsets' floors alone), far past the rows a tile stages for the chains'
    warps, so every tile takes the kernel's global-read branch. u8 (u8
    store) bit-equal to plain, f32 within 1e-3; back-to-back times at u8
    and f32.
    The JSON line's numbers are the horizontal pass at u8 [16, 512, 512, 3]
    with random ±20, as the kernel table has always been taken."""
    from mmtrs_tpu_torch.ops.kernels.resample import resample_rows, resample_rows_ref
    from mmtrs_tpu_torch.ops.warp import warp_passes

    detail, err, stat = [], 0.0, None
    for shape, first in ((SHAPE, "legacy"), (MM_SHAPE, "randaug")):
        B, H, W, C = shape
        u8 = _teeth_at(torch, dev, x, shape)
        f32 = (u8.float() + torch.rand(shape, generator=gen).to(dev) * 0.99).contiguous()
        _, warp_h, warp_v = warp_passes(_warp_mats(torch, B, W, first).to(dev), H, W)
        for kind in ("warps", "random ±20", "steep ±100"):
            for axis, lines, n in ((2, H, W), (1, W, H)):
                if kind == "warps":
                    a = warp_h if axis == 2 else warp_v
                else:
                    amp, alphas = (20.0, (0.9, -1.05)) if kind == "random ±20" else (100.0, (3.0, -3.0))
                    a = tuple(t.to(dev).contiguous() for t in _random_passes(torch, gen, B, lines, n, amp, alphas))
                got = resample_rows(u8, *a, axis=axis)
                _check(torch.equal(got, resample_rows_ref(u8, *a, axis=axis)),
                       f"K4 u8 {shape} axis {axis} {kind}: bit-equal to plain")
                e = (resample_rows(f32, *a, axis=axis) - resample_rows_ref(f32, *a, axis=axis)).abs().max().item()
                _check(e <= 1e-3, f"K4 f32 {shape} axis {axis} {kind}: max err {e:.3g} <= 1e-3")
                err = max(err, e)
                row = {"shape": list(shape), "axis": axis, "offsets": kind,
                       "alpha_abs_max": a[1].abs().max().item(),
                       "bound_ms": _bound_ms(_nbytes(u8, *a, u8), OPS_PER_ELEMENT["resample_rows"] * u8.numel())[0],
                       "u8_ms_b2b": _b2b_ms(lambda im, *t: resample_rows(im, *t, axis=axis), _rotations((u8, *a))),
                       "f32_ms_b2b": _b2b_ms(lambda im, *t: resample_rows(im, *t, axis=axis), _rotations((f32, *a)))}
                if shape == SHAPE and axis == 2 and kind == "random ±20":
                    stat = _stat("resample_rows", lambda im, *t: resample_rows(im, *t, axis=2), (u8, *a),
                                 lambda: resample_rows_ref(u8, *a, axis=2), _nbytes(u8, *a, u8), u8.numel())
                    stat.update(f32_ms_b2b=row["f32_ms_b2b"])
                detail.append(row)
                print(f"  K4 {shape} axis {axis} {kind} (|alpha| <= {row['alpha_abs_max']:.3f}): b2b u8 "
                      f"{row['u8_ms_b2b']:.4f}, f32 {row['f32_ms_b2b']:.4f} ms, bound (u8) {row['bound_ms'] * 1e3:.2f} us")
    stat["detail"] = detail
    return [("resample_rows", err, stat)]


def _k5_kinds(hole5, hole6) -> np.ndarray:
    """K5's seven kinds of rows: identity, brightness/contrast, HSV, noise at
    σ = √5 and √15, dropout with its hole at ``hole5``, and all members at
    once with its hole at ``hole6`` ((y0, x0) each)."""
    kinds = np.zeros((7, 10), np.float32)
    kinds[1, :2] = (0.12, -0.09)
    kinds[2, 2:6] = (4.0, -6.0, 8.0, 1.0)
    kinds[3, 6] = np.sqrt(5.0)
    kinds[4, 6] = np.sqrt(15.0)
    kinds[5, 7:10] = (1.0, *hole5)
    kinds[6] = (-0.07, 0.11, -3.0, 9.0, -5.0, 1.0, np.sqrt(15.0), 1.0, *hole6)
    return kinds


def _photometric_rows(torch, dev, gen):
    """K5's arguments at SHAPE: the seven kinds repeated over B, holes at
    (200, 301) and (40, 90); a seed per image; the dropout hole."""
    B = SHAPE[0]
    params = torch.from_numpy(_k5_kinds((200.0, 301.0), (40.0, 90.0))[np.arange(B) % 7]).to(dev)
    seeds = torch.randint(-(2**31), 2**31 - 1, (B,), generator=gen, dtype=torch.int32).to(dev)
    return params, seeds, SHAPE[1] // 24


# K5's mixes, each at u8 [B, 512, 512, 3] synthetic teeth: (a) phase 2's
# rows; (b) the ``legacy`` chain's own draws for lineages 0..31, the table
# builder's batch and gate mix; (c) brightness/contrast on every image (the
# byte floor); (d) every member on every image (the worst case)
K5_MIXES = ("a", "b", "c", "d")


def _photometric_mix(torch, dev, x, mix, gen):
    """(imgs, params, seeds, hole) of K5's mix ``mix`` (see K5_MIXES); ``x``
    is phase 2's batch."""
    from mmtrs_tpu_torch.ops.augment import draw_legacy

    if mix == "a":
        return (x, *_photometric_rows(torch, dev, gen))
    B, S = AUG_SHAPE[0], AUG_SHAPE[1]
    hole = S // 24
    imgs = _teeth_at(torch, dev, x, AUG_SHAPE)
    if mix == "b":
        d = draw_legacy(SEED, range(B), 0, S, S, img_size=S)
        return imgs, d.params.to(dev), d.seeds.to(dev), hole
    u = torch.rand((B, 10), generator=gen)
    p = torch.zeros((B, 10))
    p[:, 0:2] = u[:, 0:2] * 0.3 - 0.15
    if mix == "d":
        p[:, 2] = u[:, 2] * 10.0 - 5.0
        p[:, 3] = u[:, 3] * 24.0 - 12.0
        p[:, 4] = u[:, 4] * 16.0 - 8.0
        p[:, 5] = 1.0
        p[:, 6] = torch.sqrt(5.0 + 10.0 * u[:, 6])
        p[:, 7] = 1.0
        p[:, 8:10] = torch.floor(u[:, 8:10] * (S - hole))
    seeds = torch.randint(-(2**31), 2**31 - 1, (B,), generator=gen, dtype=torch.int32)
    return imgs, p.to(dev), seeds.to(dev), hole


def _k5_rows(torch, B, H, W, hole, gen):
    """(params, seeds) at any shape: the seven kinds cycled, with the holes
    at the bottom-right corner (dropout) and the top-right one (all)."""
    kinds = _k5_kinds((H - hole, W - hole), (0.0, W - hole))
    seeds = torch.randint(-(2**31), 2**31 - 1, (B,), generator=gen, dtype=torch.int32)
    return torch.from_numpy(kinds[np.arange(B) % 7]), seeds


def _k5_cases(torch, dev, x, gen):
    """(what, imgs, params, seeds, hole) of K5's checks besides phase 2's
    rows: the every-colour image [1, 4096, 4096, 3] under HSV rows that
    wrap the hue both ways (dh ±5) and clip S (ds ±12) and V (dv ±8), two
    of them after brightness/contrast ±0.15, one image a row; noise at σ √5
    and √15 over seeds that include 0, ±1 and the int32 extremes; holes
    touching each edge; phase 2's kinds (:func:`_k5_rows`) at [32, 512, 512,
    3], [12, 380, 380, 3], [2, 752, 1000, 3] and [3, 97, 101, 3] (images of
    29,391 bytes: heads and tails off the 8-byte grid); the view
    ``imgs[1:]`` of the last, whose input starts at an odd byte, off the
    grid its output is on; and 40 images of [64, 64] with the kinds shuffled (the
    kernel ranks the images by their stages, 32 a ballot, and takes the
    heaviest first). A generator, so that one case is on the card at a time."""
    B, H, W, _ = SHAPE
    hole = H // 24
    every = torch.from_numpy(every_byte_triple()).to(dev)[None]
    rows = [(dh, ds, dv, 0.0, 0.0) for dh in (-5.0, 5.0) for ds in (-12.0, 12.0) for dv in (-8.0, 8.0)]
    rows += [(5.0, 12.0, 8.0, 0.15, 0.15), (-5.0, -12.0, -8.0, -0.15, -0.15)]
    for dh, ds, dv, br, ct in rows:
        p = torch.tensor([[br, ct, dh, ds, dv, 1.0, 0.0, 0.0, 0.0, 0.0]], device=dev)
        yield (f"every colour {tuple(every.shape)} HSV ({dh}, {ds}, {dv}), bc ({br}, {ct})",
               every, p, torch.zeros(1, dtype=torch.int32, device=dev), hole)
    del every
    seeds = torch.tensor([0, 1, -1, 2**31 - 1, -(2**31), 12345, -7, 99], dtype=torch.int32)
    seeds = torch.cat([seeds, torch.randint(-(2**31), 2**31 - 1, (B,), generator=gen, dtype=torch.int32)])[:B]
    p = torch.zeros((B, 10))
    p[:, 6] = torch.where(torch.arange(B) % 2 == 0, 5.0, 15.0).sqrt()
    p[B // 2:, 0:2] = torch.tensor([0.1, -0.12])
    yield "noise σ √5 / √15, seeds 0, ±1, int32 extremes", x, p.to(dev), seeds.to(dev), hole
    corners = [(0, 0), (0, W - hole), (H - hole, 0), (H - hole, W - hole),
               (0, 200), (H - hole, 300), (100, 0), (50, W - hole)]
    p = torch.zeros((B, 10))
    p[:, 7] = 1.0
    p[:, 8:10] = torch.tensor([corners[i % len(corners)] for i in range(B)], dtype=torch.float32)
    p[1::2, 6] = 15.0**0.5
    yield "holes touching each edge", x, p.to(dev), seeds.to(dev), hole
    for shape in (AUG_SHAPE, MM_SHAPE, SMALL_ARCHIVE_SHAPE, K5_ODD_SHAPE):
        b, h, w, _ = shape
        imgs, ph = _teeth_at(torch, dev, x, shape), max(1, h // 24)
        p, s = _k5_rows(torch, b, h, w, ph, gen)
        yield f"{shape} phase 2's kinds", imgs, p.to(dev), s.to(dev), ph
    view = imgs[1:]
    _check(view.data_ptr() % 8 != 0 and view.is_contiguous(), f"the view starts at byte {view.data_ptr() % 8} of 8")
    yield f"view imgs[1:] of {K5_ODD_SHAPE}", view, p[1:].to(dev), s[1:].to(dev), ph
    shape = (40, 64, 64, 3)  # more images than a warp ranks in one ballot
    p, s = _k5_rows(torch, 40, 64, 64, 2, gen)
    p = p[torch.randperm(40, generator=gen)]
    yield f"{shape} phase 2's kinds shuffled", _teeth_at(torch, dev, x, shape), p.to(dev), s.to(dev), 2


def _check_photometric(torch, dev, x, xf, gen):
    """K5 ``torch.equal`` to its plain version on phase 2's rows and on
    :func:`_k5_cases`; its times on phase 2's rows."""
    from mmtrs_tpu_torch.ops.kernels.photometric import photometric, photometric_ref

    params, seeds, hole = _photometric_rows(torch, dev, gen)
    _equal_u8("K5 phase 2's rows", photometric(x, params, seeds, hole), photometric_ref(x, params, seeds, hole))
    for what, imgs, p, s, h in _k5_cases(torch, dev, x, gen):
        _equal_u8(f"K5 {what}", photometric(imgs, p, s, h), photometric_ref(imgs, p, s, h))
    st = _stat("photometric", photometric, (x, params, seeds, hole),
               lambda: photometric_ref(x, params, seeds, hole), _nbytes(x, params, seeds, x), x.numel() // 3)
    return [("photometric", 0.0, st)]


def _equal_u8(what, got, want):
    """``torch.equal``, with the count of values that differ and the largest
    difference in the message."""
    d = (got.int() - want.int()).abs()
    _check(got.equal(want), f"{what}: equal to plain ({int((d != 0).sum())} values differ, max {int(d.max())})")


def _random_passes(torch, gen, B, lines, n, amp=20.0, alphas=(0.9, -1.05)):
    """K4's (off, alpha, r) with random ±amp per line on the host: α
    alphas[0], or alphas[1] with r near n − 1 on every second image (a
    flip)."""
    flip = torch.arange(B) % 2 == 1
    alpha = torch.where(flip, alphas[1], alphas[0]).float()
    beta = torch.rand((B, lines), generator=gen) * 2.0 * amp - amp + torch.where(flip, n - 1.0, 0.0)[:, None]
    r = beta.mean(dim=1)
    return beta - r[:, None], alpha, r


def _check_windowed(torch, dev, x, xf, gen):
    """K6 on both axes, u8 and f32, window m = 11 (the elastic pass's), at
    [16, 512, 512, 3] and the MM trainer's randaug batch [12, 380, 380, 3]
    with uniform ±11 offsets and ±14 (beyond the window: the TPU kernel's
    windowed sum), and at an elastic sub-batch [4, 512, 512, 3] with
    ``elastic``'s own smoothed fields (α 10, σ 5): u8 bit-equal to plain,
    f32 within 1e-3; back-to-back times at u8 and f32, and ``grid_sample``'s
    f32 one call and back to back on the same offsets (it computes the
    bilinear shift, which K6's result is within the window). The JSON line's
    numbers are the vertical pass (elastic's first) at u8 [16, 512, 512, 3]
    with ±11."""
    from mmtrs_tpu_torch.ops.augment import elastic_offsets
    from mmtrs_tpu_torch.ops.kernels.shift import shift_rows_windowed, shift_rows_windowed_ref

    m = 11
    cases = [(SHAPE, "uniform ±11"), (SHAPE, "uniform ±14"), ((4, *SHAPE[1:]), "elastic"),
             (MM_SHAPE, "uniform ±11"), (MM_SHAPE, "uniform ±14")]
    detail, err, stat = [], 0.0, None
    for shape, kind in cases:
        B, H, W, C = shape
        u8 = _teeth_at(torch, dev, x, shape)
        f32 = (u8.float() + torch.rand(shape, generator=gen).to(dev) * 0.99).contiguous()
        if kind == "elastic":
            dx, dy, win = elastic_offsets((torch.rand((B, 2, H, W), generator=gen) * 2.0 - 1.0).to(dev), 10.0, 5.0)
            _check(win == m and max(dx.abs().max().item(), dy.abs().max().item()) <= m,
                   f"elastic's offsets within its window {win}")
        else:
            amp = float(kind.split("±")[1])
            dx, dy = ((torch.rand((B, H, W), generator=gen) * 2.0 * amp - amp).to(dev) for _ in range(2))
        for axis, off in ((1, dy.contiguous()), (2, dx.contiguous())):
            got = shift_rows_windowed(u8, off, m, axis)
            _check(torch.equal(got, shift_rows_windowed_ref(u8, off, m, axis)),
                   f"K6 u8 {shape} axis {axis} {kind}: bit-equal to plain")
            e = (shift_rows_windowed(f32, off, m, axis) - shift_rows_windowed_ref(f32, off, m, axis)).abs().max().item()
            _check(e <= 1e-3, f"K6 f32 {shape} axis {axis} {kind}: max err {e:.3g} <= 1e-3")
            err = max(err, e)
            lib_fn, lib_args = _grid_sample_shift(torch, f32.permute(0, 3, 1, 2).contiguous(), off, axis)
            row = {"shape": list(shape), "axis": axis, "offsets": kind,
                   "bound_ms": _bound_ms(_nbytes(u8, off, u8), OPS_PER_ELEMENT["shift_rows_windowed"] * u8.numel())[0],
                   "u8_ms_b2b": _b2b_ms(lambda im, o: shift_rows_windowed(im, o, m, axis), _rotations((u8, off))),
                   "f32_ms_b2b": _b2b_ms(lambda im, o: shift_rows_windowed(im, o, m, axis), _rotations((f32, off))),
                   "grid_sample_ms": _time_ms(lambda: lib_fn(*lib_args)),
                   "grid_sample_ms_b2b": _b2b_ms(lib_fn, _rotations(lib_args))}
            if kind != "uniform ±14":
                row["grid_sample_max_diff"] = (lib_fn(*lib_args).permute(0, 2, 3, 1)
                                               - shift_rows_windowed(f32, off, m, axis)).abs().max().item()
            if shape == SHAPE and axis == 1 and kind == "uniform ±11":
                stat = _stat("shift_rows_windowed", shift_rows_windowed, (u8, off, m, 1),
                             lambda: shift_rows_windowed_ref(u8, off, m, 1), _nbytes(u8, off, u8), u8.numel(),
                             library=(lib_fn, lib_args))
                stat.update(f32_ms=_time_ms(lambda: shift_rows_windowed(f32, off, m, 1)),
                            f32_ms_b2b=row["f32_ms_b2b"])
            detail.append(row)
            diff = ("" if "grid_sample_max_diff" not in row
                    else f" (max diff from K6 f32 {row['grid_sample_max_diff']:.3g})")
            print(f"  K6 {shape} axis {axis} {kind}: b2b u8 {row['u8_ms_b2b']:.4f}, f32 {row['f32_ms_b2b']:.4f} ms, "
                  f"bound (u8) {row['bound_ms'] * 1e3:.2f} us; grid_sample f32 {row['grid_sample_ms']:.4f} / b2b "
                  f"{row['grid_sample_ms_b2b']:.4f} ms{diff}")
    stat["detail"] = detail
    return [("shift_rows_windowed", err, stat)]


def _check_scatter(torch, dev, x, xf, gen):
    """K7 at u8 and f32 [32, 512, 512, 3], a random 7-row subset: written
    rows bit-equal to plain, untouched rows byte-identical (a kernel that
    writes rows beyond the subset fails here)."""
    from mmtrs_tpu_torch.ops.kernels.scatter import scatter_rows_, scatter_rows_ref

    B = PRESET_SHAPE[0]
    idx = torch.randperm(B, generator=gen)[:7].to(dev)
    keep = torch.ones(B, dtype=torch.bool)
    keep[idx.cpu()] = False
    keep = keep.to(dev)
    bufs, err = {}, 0.0
    for dtype in (torch.uint8, torch.float32):
        dst = (torch.rand(PRESET_SHAPE, generator=gen) * 255.0).to(dtype).to(dev)
        sub = (torch.rand((7, *PRESET_SHAPE[1:]), generator=gen) * 255.0).to(dtype).to(dev)
        got = scatter_rows_(dst.clone(), sub, idx)
        torch.cuda.synchronize()
        want = scatter_rows_ref(dst.clone(), sub, idx)
        err = max(err, (got.float() - want.float()).abs().max().item())
        _check(torch.equal(got, want), f"K7 {dtype} bit-equal to plain")
        _check(torch.equal(got[idx], sub), f"K7 {dtype} written rows equal the sub-batch")
        _check(torch.equal(got[keep], dst[keep]), f"K7 {dtype} the {int(keep.sum())} other rows untouched")
        bufs[dtype] = (dst, sub)
    # f32: what subset_apply writes back in the ten / simple / randaug chains
    # bytes: the sub-batch read and its rows written, and the ids
    dst, sub = bufs[torch.float32]
    st = _stat("scatter_rows", scatter_rows_, (dst, sub, idx), lambda: scatter_rows_ref(dst, sub, idx),
               _nbytes(sub, sub, idx), sub.numel(),
               library=(lambda d, s, i: d.index_copy_(0, i, s), (dst, sub, idx)))
    return [("scatter_rows", err, st)]


def _l_planes(torch, dev, rgb):
    """The u8 L plane of u8 RGB on the card, as the L-plane route makes it."""
    from mmtrs_tpu_torch.ops.color import rgb_to_lab
    from mmtrs_tpu_torch.ops.kernels.clahe import quantize_l

    return quantize_l(rgb_to_lab(rgb.to(dev).float())[..., 0]).contiguous()


@functools.cache
def _serving_teeth():
    """u8 [16, 512, 688, 3]: serving's batch of synthetic teeth (host)."""
    from mmtrs_tpu_torch.synth import synth_teeth

    return synth_teeth(L_SHAPE[0], L_SHAPE[1:], seed=SEED + 5)


def _l_teeth(torch, dev, x, shape):
    """The u8 L planes of synthetic teeth at ``shape`` [B, H, W]: serving's
    batch or its first image, the archive's images, or other teeth
    (``_teeth_at``)."""
    B, H, W = shape
    if (H, W) == L_SHAPE[1:] and B <= L_SHAPE[0]:
        return _l_planes(torch, dev, torch.from_numpy(_serving_teeth()[:B]))
    return _l_planes(torch, dev, _teeth_at(torch, dev, x, (B, H, W, 3)))


def _l_adversarial(torch, dev, shape, gen, tiles):
    """(what, u8 L) at ``shape``: one value a tile, (37 · tile) mod 256, so
    that a batch of 256 tiles or more holds all 256 values (all of a tile's
    counts in one bin: the most contention, and the largest excess to
    redistribute); two values in a checkerboard (half of a word's bytes on
    each); and uniform random values."""
    B, H, W = shape
    ty, tx = tiles
    ys, xs = torch.arange(H, device=dev)[:, None], torch.arange(W, device=dev)[None, :]
    tile = torch.arange(B, device=dev)[:, None, None] * (ty * tx) + ((ys // (H // ty)) * tx + xs // (W // tx))[None]
    flat = (tile * 37 % 256).to(torch.uint8)
    two = torch.where((ys + xs) % 2 == 1, 200, 60).to(torch.uint8).expand(B, H, W).contiguous()
    rnd = torch.randint(0, 256, shape, generator=gen, dtype=torch.uint8).to(dev)
    return [("flat", flat), ("two-colour", two), ("uniform random", rnd)]


def _every_value_planes(torch, dev, H, W, k0, n):
    """u8 [n, H, W], plane k0 + i = (k0 + i + x + y) mod 256: over 256 planes
    every position sees every L value."""
    k = torch.arange(k0, k0 + n, device=dev)[:, None, None]
    ys, xs = torch.arange(H, device=dev)[None, :, None], torch.arange(W, device=dev)[None, None, :]
    return ((k + ys + xs) % 256).to(torch.uint8).contiguous()


def _check_l_pair(torch, C, what, l, tiles, clip=3.0):
    """K8's LUTs of ``l`` and K9's u8 and f32 blends of them, each
    ``torch.equal`` to its plain version."""
    lut = C.clahe_hist_lut(l, clip, tiles)
    _check(torch.equal(lut, C.clahe_hist_lut_ref(l, clip, tiles)), f"K8 {what}: LUTs equal to plain")
    for dt in (torch.uint8, torch.float32):
        got, want = C.clahe_apply(l, lut, tiles, dt), C.clahe_apply_ref(l, lut, tiles, dt)
        _check(torch.equal(got, want), f"K9 {what} {str(dt)[6:]}: equal to plain "
                                        f"({int((got != want).sum())} values differ)")


def _check_clahe_l(torch, dev, x, xf, gen):
    """K8 and K9 at every shape the L-plane route gives them: a served
    request [1, 512, 688], serving's buckets at b16 ([16, 512, 688],
    [16, 688, 512], [16, 512, 912]), the archive's [4, 3024, 4032] and
    [2, 3024, 4032], and the padded [2, 752, 1000] (rows not 16-byte
    aligned, tw = 125); on the L planes of teeth, one value a tile, two in
    a checkerboard and uniform random ones: K8's LUTs, K9's u8 store and
    its f32 blend ``torch.equal`` to plain. At serving's three buckets K9
    also on 256 planes where every position sees every value, with random
    LUTs; and both at [1, 40, 50] with 5 x 10 tiles (rows of a width not a
    multiple of 8, so byte loads; more than 8 tiles across, so K9's LUTs
    from global memory). Times on teeth: the JSON line takes
    [16, 512, 688]'s (K9 with its u8 store, what the preprocessing stage
    runs); its ``detail`` the other timed shapes and K9's f32 store."""
    from mmtrs_tpu_torch.ops.kernels import clahe as C

    clip, tiles = 3.0, (8, 8)
    small = torch.randint(0, 256, (1, 40, 50), generator=gen, dtype=torch.uint8).to(dev)
    _check_l_pair(torch, C, "[1, 40, 50] tiles (5, 10)", small, (5, 10))
    res, detail = {}, []
    for shape in L_CHECK_SHAPES:
        teeth = _l_teeth(torch, dev, x, shape)
        for what, l in [("teeth", teeth)] + _l_adversarial(torch, dev, shape, gen, tiles):
            _check_l_pair(torch, C, f"{list(shape)} {what}", l, tiles, clip)
        if shape[0] == 16:
            _, H, W = shape
            for k0 in range(0, 256, 64):
                planes = _every_value_planes(torch, dev, H, W, k0, 64)
                lut = torch.randint(0, 256, (64, 64, 256), generator=gen, dtype=torch.uint8).to(dev)
                for dt in (torch.uint8, torch.float32):
                    got, want = C.clahe_apply(planes, lut, tiles, dt), C.clahe_apply_ref(planes, lut, tiles, dt)
                    _check(torch.equal(got, want), f"K9 {[H, W]} planes {k0}..{k0 + 63} (every value), random LUTs, "
                                                    f"{str(dt)[6:]}: equal to plain ({int((got != want).sum())} differ)")
            del planes, lut, got, want
        if shape not in L_TIMED_SHAPES:
            continue
        lut = C.clahe_hist_lut(teeth, clip, tiles)
        u8, px = C.clahe_apply(teeth, lut, tiles, torch.uint8), teeth.numel()
        stats = {
            "clahe_hist_lut": _stat("clahe_hist_lut", C.clahe_hist_lut, (teeth, clip, tiles),
                                    lambda: C.clahe_hist_lut_ref(teeth, clip, tiles), _nbytes(teeth, lut), px),
            "clahe_apply": _stat("clahe_apply", C.clahe_apply, (teeth, lut, tiles, torch.uint8),
                                 lambda: C.clahe_apply_ref(teeth, lut, tiles, torch.uint8),
                                 _nbytes(teeth, lut, u8), px),
        }
        if shape == L_SHAPE:
            f32 = C.clahe_apply(teeth, lut, tiles)
            stats["clahe_apply f32"] = _stat("clahe_apply", C.clahe_apply, (teeth, lut, tiles, torch.float32),
                                             lambda: C.clahe_apply_ref(teeth, lut, tiles), _nbytes(teeth, lut, f32), px)
            res = stats
        keys = ("ms", "ms_b2b", "host_us", "plain_ms", "bound_ms")
        for name, st in stats.items():
            if shape != L_SHAPE or name.endswith("f32"):
                detail.append({"name": name, "shape": list(shape), **{k: st[k] for k in keys}})
            print(f"  {name} at {list(shape)}: kernel {st['ms']:.4f} / b2b {st['ms_b2b']:.4f} ms, host "
                  f"{st['host_us']:.2f} us; plain {st['plain_ms']:.4f} ms; bound {st['bound_ms'] * 1e3:.2f} us")
        del teeth, lut, u8
    for name in L_KERNELS:
        res[name]["detail"] = [d for d in detail if d["name"].split()[0] == name]
    return [(name, 0.0, res[name]) for name in L_KERNELS]


@functools.cache
def _archive_batch():
    """u8 [4, 3024, 4032, 3]: synthetic 12 MP teeth, the first two rotated
    so deskew fires (built once, on the host)."""
    from mmtrs_tpu_torch.synth import synth_teeth

    B, H, W, _ = ARCHIVE_SHAPE
    return synth_teeth(B, (H, W), seed=SEED + 6, angles_deg=[30.0, -25.0] + [0.0] * (B - 2))


def phase_preprocess(torch, dev):
    from mmtrs_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from mmtrs_tpu_torch.preprocess import preprocess_batch
    from mmtrs_tpu_torch.ops.clahe import quantize_u8
    from mmtrs_tpu_torch.synth import synth_teeth

    print("phase 3: preprocess_batch on the card at", SHAPE)
    angles = [30.0, -25.0] + [0.0] * (SHAPE[0] - 2)
    host = torch.from_numpy(synth_teeth(SHAPE[0], SHAPE[1], seed=SEED + 1, angles_deg=angles))
    x = host.to(dev)
    reset_launches()
    out, info = preprocess_batch(x)
    torch.cuda.synchronize()
    counts = dict(LAUNCHES)
    _check(all(counts[k] > 0 for k in SERVE_KERNELS), f"every kernel of the path launched: {counts}")
    _check(torch.equal(x.cpu(), host), "the caller's batch byte-identical after the in-place deskew")
    _check(out.shape == (SHAPE[0], 512, 512, 3) and out.dtype == torch.float32, f"out {tuple(out.shape)} {out.dtype}")
    _check(bool(torch.isfinite(out).all()), "out finite")
    fired = int((info["deskew_angle"] != 0).sum())
    _check(fired >= 2, f"deskew fired on {fired} images")

    ref, ref_info = preprocess_batch(host)  # the same port on the CPU: plain versions
    _check(torch.equal(info["seg_valid"].cpu(), ref_info["seg_valid"]), "seg_valid equal to CPU")
    da = (info["deskew_angle"].cpu() - ref_info["deskew_angle"]).abs().max().item()
    _check(da <= 1e-3, f"angles within 1e-3 deg of CPU (max {da:.3g})")
    db = (info["boxes"].cpu() - ref_info["boxes"]).abs().max().item()
    _check(db <= 1.0, f"boxes within 1 px of CPU (max {db})")
    d = (quantize_u8(out).cpu().int() - quantize_u8(ref).int()).abs()
    within = (d <= 2).float().mean().item()
    _check(within >= 0.999, f"u8 within 2 levels of CPU on {within:.6f} of values (max {d.max().item()})")

    reps = 5
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        preprocess_batch(x)
    torch.cuda.synchronize()
    ips = reps * SHAPE[0] / (time.perf_counter() - t0)
    print(f"  preprocess_batch: {ips:.1f} imgs/s at b{SHAPE[0]} 512^2 (host clock, {reps} reps)")
    return ips


def phase_serve(torch, dev):
    from mmtrs_tpu_torch.models.backbones.efficientnet import calibrate_batchnorm_, lecun_init_
    from mmtrs_tpu_torch.models.mil import MILNet, make_eval_bag
    from mmtrs_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from mmtrs_tpu_torch.ops.resize import resize_bilinear_u8
    from mmtrs_tpu_torch.serve.ensembles import MILEnsemble
    from mmtrs_tpu_torch.serve.service import PredictService, serve_bucket_shape
    from mmtrs_tpu_torch.synth import synth_teeth
    from mmtrs_tpu_torch.train.common import normalize_imagenet

    print("phase 4: PredictService + 2-fold MILEnsemble(efficientnet_b0, attn 128, bf16)")

    # random weights, one seeded generator per fold: Flax's default init,
    # then BatchNorm statistics taken on a bag of synthetic teeth as served,
    # so the random net's features keep a trained net's scale instead of
    # fading to zero (identity BatchNorms) or saturating the sigmoid
    folds = []
    for f in range(2):
        gen = torch.Generator().manual_seed(SEED + f)
        net = lecun_init_(MILNet("efficientnet_b0", attn_dim=128, dtype=torch.float32), gen)
        teeth = torch.from_numpy(synth_teeth(4, 512, seed=SEED + 20 + f, angles_deg=[0.0] * 4))
        calibrate_batchnorm_(net.encoder, normalize_imagenet(make_eval_bag(teeth)))
        folds.append(net.state_dict())

    ens = MILEnsemble(folds, MILNet("efficientnet_b0", 128).to(dev))
    svc = PredictService(mil_predict=ens.predict, device=dev)
    uploads = [
        synth_teeth(1, s, seed=SEED + 10 + i, angles_deg=[25.0 + 5 * i])[0]
        for i, s in enumerate(FUSED_UPLOADS + PHONE_UPLOADS)
    ]
    # the phone uploads' bucket resize on the card equals the same function on the CPU
    for img in uploads[len(FUSED_UPLOADS):]:
        bucket = serve_bucket_shape(*img.shape[:2])
        host = torch.from_numpy(img)
        on_card = resize_bilinear_u8(host.to(dev), bucket).cpu()
        _check(torch.equal(on_card, resize_bilinear_u8(host, bucket)),
               f"upload {img.shape[:2]} -> bucket {bucket}: resize on the card == on the CPU")
    svc.predict_one(uploads[0])  # warm-up: cuDNN plans, allocator
    svc.predict_one(uploads[-1])
    torch.cuda.synchronize()

    reset_launches()
    lat, results = {"fused": [], "L-plane": []}, []
    for rep in range(3):
        for img in uploads:
            route, rise, stay = (("fused", SERVE_KERNELS, L_KERNELS) if img.shape[:2] in FUSED_UPLOADS
                                 else ("L-plane", L_ROUTE_KERNELS, FUSED_KERNELS))
            before = dict(LAUNCHES)
            t0 = time.perf_counter()
            r = svc.predict_one(img)
            torch.cuda.synchronize()
            lat[route].append(time.perf_counter() - t0)
            if not (all(LAUNCHES[k] > before[k] for k in rise) and all(LAUNCHES[k] == before[k] for k in stay)):
                raise AssertionError(f"{route} route not taken for {img.shape}: {before} -> {LAUNCHES}")
            if "error" in r:
                raise AssertionError(f"request {img.shape} failed: {r['error']}")
            p = r["p_indirect"]
            if not (np.isfinite(p) and 0.0 <= p <= 1.0 and r["label"] in ("Direct", "Indirect")):
                raise AssertionError(f"bad answer {r}")
            if r["processed_image"].shape != (512, 512, 3) or r["processed_image"].dtype != np.uint8:
                raise AssertionError("processed image is not u8 512x512x3")
            if rep == 0:
                results.append((img.shape, route, r["label"], p))
    launches = dict(LAUNCHES)
    for shape, route, label, p in results:
        print(f"  upload {shape} ({route} route): {label} p_indirect={p:.6f}")
    n = len(lat["fused"]) + len(lat["L-plane"])
    _check(True, f"{n} requests answered; K1-K3 rose on every fused-route request and K8, K9, K3 on every "
                 f"L-plane one, the other route's counters unchanged: {launches}")
    low = svc.predict_one(synth_teeth(1, (480, 640), seed=SEED)[0])
    _check("resolution" in low.get("error", ""), f"480x640 refused: {low.get('error')}")
    p50 = float(np.median(lat["fused"] + lat["L-plane"])) * 1e3
    p50s = {k: float(np.median(v)) * 1e3 for k, v in lat.items()}
    print(f"  p50 latency {p50:.2f} ms per request (host clock, {n} requests); fused route "
          f"{p50s['fused']:.2f} ms, L-plane route {p50s['L-plane']:.2f} ms")

    # each fold in f32 on the card against the CPU: logits of one bag of
    # the four processed uploads (TF32 is off; the bound covers cuDNN's
    # other summation order through 16 blocks)
    procs = torch.from_numpy(np.stack([svc.preprocess(u) for u in uploads[:4]]))
    bag = normalize_imagenet(make_eval_bag(procs))[None]
    for f, sd in enumerate(folds):
        net = MILNet("efficientnet_b0", 128, dtype=torch.float32).eval()
        net.load_state_dict(sd)
        with torch.no_grad():
            cpu = net(bag)[0].item()
            gpu = net.to(dev)(bag.to(dev))[0].item()
        _check(abs(gpu - cpu) <= 1e-3 * max(1.0, abs(cpu)),
               f"fold {f} f32 logit on card {gpu:.6f} vs CPU {cpu:.6f}")
    return launches, p50


def _covering_origin_ids(n: int, gates, members, first: int = 8) -> list[int]:
    """n origin ids (seed SEED, aug_idx 0) such that among the first ``first``
    every one of ``members`` fires at least once; chosen greedily from the
    host draws' gates (``gates(ids)`` → {member: [len(ids)] bool})."""
    cand = list(range(4000))
    g = gates(cand)
    fired = np.stack([g[k].numpy() for k in members], axis=1)  # [cand, members]
    chosen, todo = [], np.ones(len(members), bool)
    while todo.any() and len(chosen) < first:
        score = (fired & todo).sum(axis=1)
        score[chosen] = -1
        best = int(np.argmax(score))
        chosen.append(best)
        todo &= ~fired[best]
    if todo.any():
        raise AssertionError(f"no {first} lineages fire {np.array(members)[todo]}")
    rest = [i for i in cand if i not in chosen]
    return chosen + rest[: n - len(chosen)]


def _legacy_gates(ids):
    from mmtrs_tpu_torch.ops.augment import draw_uniforms, legacy_gates
    from mmtrs_tpu_torch.utils.rng import generators_for_batch

    return legacy_gates(draw_uniforms(generators_for_batch(SEED, ids, 0)))


def _randaug_gates(ids):
    from mmtrs_tpu_torch.ops.augment import RANDAUG_SLOTS, draw_uniforms, randaug_gates
    from mmtrs_tpu_torch.utils.rng import generators_for_batch

    return randaug_gates(draw_uniforms(generators_for_batch(SEED, ids, 0), len(RANDAUG_SLOTS)))


def _rate(torch, fn, batch: int, reps: int = 5) -> float:
    """imgs/s of ``fn`` on a batch: host clock over ``reps`` calls after one
    warm-up, ending in a synchronise."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return reps * batch / (time.perf_counter() - t0)


def phase_augment(torch, dev):
    from mmtrs_tpu_torch.ops.augment import augment_batch, draw_legacy
    from mmtrs_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from mmtrs_tpu_torch.preprocess import preprocess_augment_batch
    from mmtrs_tpu_torch.synth import synth_teeth

    B, S = AUG_SHAPE[0], AUG_SHAPE[1]
    print("phase 5: preprocess_augment_batch (legacy preset) on the card at", AUG_SHAPE)
    ids = _covering_origin_ids(B, _legacy_gates, AUG_MEMBERS)
    t0 = time.perf_counter()
    draws = draw_legacy(SEED, ids, 0, S, S, img_size=S)
    draw_s = time.perf_counter() - t0
    print(f"  origin ids {ids[:8]} + {B - 8} more; draws on the host in {draw_s * 1e3:.1f} ms, "
          f"elastic on {int(draws.elastic_on.sum())}, CLAHE on {int(draws.use_clahe.sum())}, "
          f"blur on {int(draws.blur_on.sum())}")
    angles = [30.0, -25.0] + [0.0] * (B - 2)
    host = torch.from_numpy(synth_teeth(B, S, seed=SEED + 2, angles_deg=angles))
    x = host.to(dev)

    reset_launches()
    out, info = preprocess_augment_batch(x, draws, out_size=S)
    torch.cuda.synchronize()
    counts = dict(LAUNCHES)
    _check(all(counts[k] > 0 for k in AUG_KERNELS), f"K1-K6 each launched: {counts}")
    _check(torch.equal(x.cpu(), host), "subset_apply_ left the caller's batch byte-identical")
    _check(out.shape == AUG_SHAPE and out.dtype == torch.uint8, f"out {tuple(out.shape)} {out.dtype}")
    fired = int((info["deskew_angle"][:8] != 0).sum())
    _check(fired >= 2, f"deskew fired on {fired} of the first 8 images")

    n = 8  # the same port on the CPU (plain versions) with the same draws
    ref, ref_info = preprocess_augment_batch(host[:n], draws.take(range(n)), out_size=S)
    _check(torch.equal(info["seg_valid"][:n].cpu(), ref_info["seg_valid"]), "seg_valid equal to CPU")
    da = (info["deskew_angle"][:n].cpu() - ref_info["deskew_angle"]).abs().max().item()
    _check(da <= 1e-3, f"angles within 1e-3 deg of CPU (max {da:.3g})")
    db = (info["boxes"][:n].cpu() - ref_info["boxes"]).abs().max().item()
    _check(db <= 1.0, f"boxes within 1 px of CPU (max {db})")
    d = (out[:n].cpu().int() - ref.int()).abs()
    within = (d <= 2).float().mean().item()
    _check(within >= 0.999, f"u8 within 2 levels of CPU on {within:.6f} of values (max {d.max().item()})")

    ips = _rate(torch, lambda: preprocess_augment_batch(x, draws, out_size=S), B)
    aug_ips = _rate(torch, lambda: augment_batch(x, draws, "legacy", img_size=S), B)
    _check(torch.equal(x.cpu(), host), "the caller's batch still byte-identical after the timed runs")
    print(f"  preprocess_augment_batch: {ips:.1f} imgs/s at b{B} 512^2 (host clock, 5 reps; "
          f"draws made beforehand, {draw_s * 1e3:.1f} ms per batch on the host)")
    print(f"  augment_batch(legacy): {aug_ips:.1f} imgs/s at b{B} 512^2 (host clock, 5 reps)")
    return counts, ips, aug_ips


def _u8_within(what, got, want):
    """u8 results of the card and the CPU: within 2 levels on ≥ 99.9 %."""
    d = (got.cpu().int() - want.int()).abs()
    within = (d <= 2).float().mean().item()
    _check(within >= 0.999, f"{what}: u8 within 2 levels of CPU on {within:.6f} of values (max {d.max().item()})")


def _preset_run(torch, preset, counts, drive):
    """Drive one preset with the counters reset just before; check that its
    kernels launched, and return the drive's result."""
    from mmtrs_tpu_torch.ops.kernels import LAUNCHES, reset_launches

    reset_launches()
    out = drive()
    torch.cuda.synchronize()
    counts[preset] = dict(LAUNCHES)
    want = PRESET_KERNELS[preset]
    _check(all(counts[preset][k] > 0 for k in want), f"{preset}: {', '.join(want)} launched: {counts[preset]}")
    return out


def phase_presets(torch, dev):
    from mmtrs_tpu_torch.data.records import augment_children, child_plan, quantize_round_half_even
    from mmtrs_tpu_torch.ops.augment import augment_batch, draw_batch, draw_randaug
    from mmtrs_tpu_torch.synth import synth_teeth

    B, S = PRESET_SHAPE[0], PRESET_SHAPE[1]
    print("phase 6: the ten / simple presets through the records device loop at", PRESET_SHAPE,
          "and randaug at", RANDAUG_SHAPE)
    host = torch.from_numpy(synth_teeth(B, S, seed=SEED + 3))
    x = host.to(dev)
    plan = child_plan(range(B), 10)
    counts, rates = {}, {}
    for preset in ("ten", "simple"):
        kids = _preset_run(torch, preset, counts, lambda: augment_children(x, plan, preset, seed=SEED, batch_size=B))
        _check(kids.shape == (len(plan), *PRESET_SHAPE[1:]) and kids.dtype == torch.uint8,
               f"{preset}: {len(plan)} u8 children in batches of {B}")
        _check(torch.equal(x.cpu(), host), f"{preset}: subset_apply_ left the caller's batch byte-identical")
        n = 10  # every variant of origin 0, on the CPU with the same lineages
        ref = augment_children(host, plan[:n], preset, seed=SEED, batch_size=n)
        _u8_within(f"{preset} children 0-9", kids[:n], ref)

        src, origins, aug_idxs = zip(*plan[:B])
        variants = [a - 1 for a in aug_idxs]
        chunk = x.index_select(0, torch.tensor(src, device=dev))
        t0 = time.perf_counter()
        draws = draw_batch(preset, SEED, origins, aug_idxs, S, S, aug_idx=variants)
        draw_ms = (time.perf_counter() - t0) * 1e3
        before = chunk.clone()
        rates[preset] = (_rate(torch, lambda: augment_batch(chunk, draws, preset, aug_idx=variants), B), draw_ms)
        _check(torch.equal(chunk, before), f"{preset}: augment_batch left its input byte-identical")

    Br = RANDAUG_SHAPE[0]
    members = [f"op{k}" for k in range(14)] + ["erase"]
    ids = _covering_origin_ids(Br, _randaug_gates, members)
    t0 = time.perf_counter()
    draws = draw_randaug(SEED, ids, 0, S, S)
    draw_ms = (time.perf_counter() - t0) * 1e3
    xr = x[:Br]
    out = _preset_run(torch, "randaug", counts, lambda: augment_batch(xr, draws, "randaug"))
    _check(out.shape == RANDAUG_SHAPE and out.dtype == torch.float32, f"randaug: out {tuple(out.shape)} {out.dtype}")
    _check(bool(((out >= 0) & (out <= 255)).all()), "randaug: values in 0..255")
    _check(torch.equal(xr.cpu(), host[:Br]), "randaug: subset_apply_ left the caller's batch byte-identical")
    n = 8
    ref = augment_batch(host[:n], draws.take(range(n)), "randaug")
    _u8_within("randaug images 0-7", quantize_round_half_even(out[:n]), quantize_round_half_even(ref))
    rates["randaug"] = (_rate(torch, lambda: augment_batch(xr, draws, "randaug"), Br), draw_ms)
    print(f"  randaug origin ids {ids[:8]} + {Br - 8} more; erasing on {int(draws.erase_on.sum())}")
    for preset, (ips, ms) in rates.items():
        b = Br if preset == "randaug" else B
        print(f"  augment_batch({preset}): {ips:.1f} imgs/s at b{b} 512^2 (host clock, 5 reps; "
              f"draws made beforehand, {ms:.1f} ms per batch on the host)")
    return counts, rates


def phase_archive(torch, dev):
    from mmtrs_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from mmtrs_tpu_torch.preprocess import preprocess_stream
    from mmtrs_tpu_torch.synth import synth_teeth

    B = ARCHIVE_SHAPE[0]
    print(f"phase 7: preprocess_stream (the archive pass) on the card, {ARCHIVE_BATCHES} batches of", ARCHIVE_SHAPE)
    host = _archive_batch()
    kept = host.copy()
    list(preprocess_stream(iter([("warm-up", host)]), device=dev))
    torch.cuda.synchronize()

    reset_launches()
    t0 = time.perf_counter()
    outs = list(preprocess_stream(((i, host) for i in range(ARCHIVE_BATCHES)), device=dev))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(LAUNCHES)
    _check(all(counts[k] > 0 for k in L_ROUTE_KERNELS) and all(counts[k] == 0 for k in FUSED_KERNELS),
           f"the L-plane route: K8, K9, K3 launched, K1/K2 not: {counts}")
    _check([m for m, _, _ in outs] == list(range(ARCHIVE_BATCHES)), "batches came back in input order")
    _check(np.array_equal(host, kept), "the caller's host batches byte-identical")
    for _, out, info in outs:
        _check(out.shape == (B, 512, 512, 3) and out.dtype == np.uint8, f"out {out.shape} {out.dtype}")
        fired = int((info["deskew_angle"] != 0).sum())
        _check(fired >= 2, f"deskew fired on {fired} images")
    ips = ARCHIVE_BATCHES * B / dt
    print(f"  preprocess_stream: {ips:.2f} imgs/s at b{B} {ARCHIVE_SHAPE[1]}x{ARCHIVE_SHAPE[2]} "
          f"(host clock, {ARCHIVE_BATCHES} batches from host numpy to host numpy)")

    n, H, W, _ = SMALL_ARCHIVE_SHAPE
    small = synth_teeth(n, (H, W), seed=SEED + 7, angles_deg=[30.0] + [0.0] * (n - 1))
    (_, got, info), = preprocess_stream(iter([(0, small)]), device=dev)
    (_, ref, ref_info), = preprocess_stream(iter([(0, small)]), device="cpu")
    _check(np.array_equal(info["seg_valid"], ref_info["seg_valid"]), f"{SMALL_ARCHIVE_SHAPE}: seg_valid equal to CPU")
    da = np.abs(info["deskew_angle"] - ref_info["deskew_angle"]).max()
    _check(da <= 1e-3, f"angles within 1e-3 deg of CPU (max {da:.3g})")
    db = np.abs(info["boxes"] - ref_info["boxes"]).max()
    _check(db <= 1.0, f"boxes within 1 px of CPU (max {db})")
    d = np.abs(got.astype(int) - ref.astype(int))
    within = (d <= 2).mean()
    _check(within >= 0.999, f"u8 within 2 levels of CPU on {within:.6f} of values (max {d.max()})")
    return counts, ips


# phase 8: the full service from a weights folder, at the repo's recipes
REHEARSAL = ROOT / "results" / "rehearsal_r5"
N_FOLDS = 5
# GBDTConfig.stack_tab_like(): 700 trees, 31 leaves → depth 5 (31 split
# slots, 32 leaves a tree), on the 16 engineered features
TAB_TREES, TAB_DEPTH, TAB_FEATURES = 700, 5, 16
# the scale of each residual MBConv's last BatchNorm in the random MM folds
# (Flax's init: 1). At 1 the 32 residual branches of a random B4 add up to
# a net that amplifies small changes of its input: logits in the hundreds,
# p of 0 or 1 in most folds whatever their T, and bf16 rounding moves p by
# tenths. Trained residual branches are small; at 0.2 the folds give
# logits of order 1
MM_RESIDUAL_SCALE = 0.2
# |Δp| of an image stream on the card against the same folds on the CPU.
# In bf16 the two devices round differently through B4's 32 blocks and
# B0's 16: over phase 4's seven uploads they differ by up to 8.1e-3
# (`chip_profile.py --bf16-spread` on an H100), where
# tests/test_torch_service_weights.py's three-layer nets keep the port
# within 1e-3 of JAX. In f32 (TF32 off) they differ by under 1e-6
SERVE_BF16_BAR = 2e-2
SERVE_F32_BAR = 1e-5
# phase 10: the served p of the folds it trained against the trainer's own
# predict_proba, the same bf16 model on the same card (read 4.26e-8 on an
# NVIDIA H100 80GB HBM3 at 700 W; PERF.md)
SERVE_SAME_DEVICE_BAR = 1e-5


def _field_rows(n: int, seed: int) -> list[dict]:
    """n seeded sets of all 9 UI fields."""
    from mmtrs_tpu_torch.serve.choices import CHOICES_MAP

    rng = np.random.default_rng(seed)
    return [{k: list(v)[rng.integers(len(v))] for k, v in CHOICES_MAP.items()} for _ in range(n)]


def _recipe(stream: str, name: str) -> dict:
    return json.loads((REHEARSAL / stream / f"{name}.recipe.json").read_text())


def _random_forest(torch, rng):
    """A forest shaped like stack_tab_like's: seeded splits over seeded edges
    (midpoints of the encodings' values), leaves with the learning rate
    folded in, a third of the features' edges few and one in eight none."""
    from mmtrs_tpu_torch.models.gbdt import Forest

    cuts = np.array([-0.5, 0.5, 1.5, 2.5], np.float32)
    edges = tuple(
        np.empty(0, np.float32) if rng.random() < 0.125
        else np.unique(rng.choice(cuts, rng.integers(1, 5))).astype(np.float32)
        for _ in range(TAB_FEATURES)
    )
    n_nodes = 2**TAB_DEPTH - 1
    sf = rng.integers(0, TAB_FEATURES, (TAB_TREES, n_nodes))
    n_edges = np.array([len(e) for e in edges])[sf]
    sb = rng.integers(0, np.maximum(n_edges, 1))
    return Forest(
        split_feat=torch.from_numpy(sf), split_bin=torch.from_numpy(sb),
        leaf_value=torch.from_numpy(rng.normal(0, 0.03, (TAB_TREES, 2**TAB_DEPTH)).astype(np.float32)),
        depth=TAB_DEPTH, base_score=float(rng.normal(-0.6, 0.1)), n_trees_used=TAB_TREES,
        objective="binary_logistic", bin_edges=edges,
    )


def _write_weights(torch, dev, root: Path):
    """The weights folder, through the port's own code: 5 MM folds of
    MMJointDualHead(efficientnet_b4) and 5 MIL folds of MILNet(efficientnet_b0,
    128), each a seeded Flax init with BatchNorm statistics from synthetic
    teeth as served (the MM folds' residual branches scaled down first,
    MM_RESIDUAL_SCALE), written as npz + the repo's recipes; the repo's
    OOF CSVs; 5 seeded forests. Returns the MM folds' state dicts."""
    import shutil

    from mmtrs_tpu_torch.models.backbones.efficientnet import MBConv, calibrate_batchnorm_, lecun_init_
    from mmtrs_tpu_torch.models.convert import milnet_to_flax, mm_joint_to_flax
    from mmtrs_tpu_torch.models.mil import MILNet, make_eval_bag
    from mmtrs_tpu_torch.models.mm_joint import MMJointDualHead
    from mmtrs_tpu_torch.ops.resize import resize_bilinear
    from mmtrs_tpu_torch.serve.choices import encode_fields
    from mmtrs_tpu_torch.synth import synth_teeth
    from mmtrs_tpu_torch.train.common import normalize_imagenet
    from mmtrs_tpu_torch.utils.checkpoint import save_npz_checkpoint

    teeth = torch.from_numpy(synth_teeth(4, 512, seed=SEED + 40, angles_deg=[0.0] * 4)).to(dev)
    rows = np.array([encode_fields(f) for f in _field_rows(256, SEED + 41)], np.float32)
    mm_states = []
    for f in range(N_FOLDS):
        recipe = _recipe("mm", f"mm_dualtask_fold{f}")
        s = recipe["img_size"]
        x = normalize_imagenet(resize_bilinear(teeth.float(), (s, s)))
        gen = torch.Generator().manual_seed(SEED + 100 + f)
        net = lecun_init_(MMJointDualHead(recipe["model_name"], dtype=torch.float32), gen).to(dev)
        with torch.no_grad():
            for blk in net.backbone.modules():
                if isinstance(blk, MBConv) and blk.residual:
                    blk.bn2.weight.fill_(MM_RESIDUAL_SCALE)
        calibrate_batchnorm_(net.backbone, torch.cat([x, x.flip(2), x.flip(1)]))
        t = (rows - np.float32(recipe["scaler_mean"])) / np.float32(recipe["scaler_scale"])
        calibrate_batchnorm_(net.tab_mlp, torch.from_numpy(t).to(dev))
        sd = {k: v.cpu() for k, v in net.state_dict().items()}
        save_npz_checkpoint(root / "mm_dualtask_v1" / f"mm_dualtask_fold{f}", mm_joint_to_flax(sd), recipe)
        mm_states.append(sd)
    bag = normalize_imagenet(make_eval_bag(teeth))
    for f in range(N_FOLDS):
        recipe = _recipe("mil", f"mil_v1_fold{f}")
        gen = torch.Generator().manual_seed(SEED + 200 + f)
        net = lecun_init_(MILNet(recipe["model_name"], recipe["attn_dim"], dtype=torch.float32), gen).to(dev)
        calibrate_batchnorm_(net.encoder, bag)
        sd = {k: v.cpu() for k, v in net.state_dict().items()}
        save_npz_checkpoint(root / "mil_v1" / f"mil_v1_fold{f}", milnet_to_flax(sd), recipe)
    for stream, folder in (("mm", "mm_dualtask_v1"), ("mil", "mil_v1")):
        shutil.copy(REHEARSAL / stream / "oof_val.csv", root / folder / "oof_val.csv")
    rng = np.random.default_rng(SEED + 300)
    for f in range(N_FOLDS):
        _random_forest(torch, rng).save(root / "tab_v1" / f"tab_fold{f}")
    return mm_states


def phase_serve_weights(torch, dev, smi: str, then):
    """Phase 8; ``then(svc, uploads, fields, results)``, phase 9, runs on
    its service before the weights folder is removed, and its result is
    returned third."""
    import tempfile

    from mmtrs_tpu_torch.models.mm_joint import MMJointDualHead
    from mmtrs_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from mmtrs_tpu_torch.ops.resize import resize_bilinear
    from mmtrs_tpu_torch.serve.choices import encode_fields
    from mmtrs_tpu_torch.serve.ensembles import MILEnsemble, MMEnsemble, TabEnsemble, build_service_from_weights
    from mmtrs_tpu_torch.serve.service import Stacker, read_oof_csv
    from mmtrs_tpu_torch.synth import synth_teeth
    from mmtrs_tpu_torch.train.common import normalize_imagenet

    t_phase = time.perf_counter()
    mm_r, mil_r = _recipe("mm", "mm_dualtask_fold0"), _recipe("mil", "mil_v1_fold0")
    print(f"phase 8: build_service_from_weights: {N_FOLDS} MM folds ({mm_r['model_name']} at "
          f"{mm_r['img_size']}, bf16, 3 views), {N_FOLDS} MIL folds ({mil_r['model_name']}, bf16), "
          f"{N_FOLDS} forests ({TAB_TREES} trees, depth {TAB_DEPTH}) and the Stacker")
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        mm_states = _write_weights(torch, dev, root)
        torch.cuda.synchronize()
        mb = sum(p.stat().st_size for p in root.rglob("*")) / 1e6
        print(f"  weights folder written in {time.perf_counter() - t0:.2f} s ({mb:.1f} MB)")
        t0 = time.perf_counter()
        svc = build_service_from_weights(root)
        torch.cuda.synchronize()
        print(f"  service built in {time.perf_counter() - t0:.2f} s (npz reads, 10 nets and 5 forests "
              f"to the card, the Stacker's Newton on the card)")
        mm, mil, tab = (getattr(svc, k).__self__ for k in ("mm_predict", "mil_predict", "tab_predict"))
        _check(svc.device.type == mm.device.type == mil.device.type == tab.device.type == dev.type
               and len(mm.nets) == len(mil.nets) == len(tab.forests) == N_FOLDS and svc.stacker is not None,
               f"{N_FOLDS} MM, {N_FOLDS} MIL folds and {N_FOLDS} forests on the card, the Stacker fitted")

        # the Stacker against a CPU fit on the same CSVs: grid thresholds
        # equal; youden is one of the scores, within the golden test's 1e-6
        t0 = time.perf_counter()
        cpu_st = Stacker.fit(*(read_oof_csv(root / d / "oof_val.csv") for d in ("mm_dualtask_v1", "mil_v1")),
                             device="cpu")
        cpu_s = time.perf_counter() - t0
        th, cth = svc.stacker.thresholds, cpu_st.thresholds
        _check(th["max_f1"] == cth["max_f1"] and th["max_acc"] == cth["max_acc"]
               and abs(th["youden"] - cth["youden"]) <= 1e-6,
               f"Stacker thresholds {th} == CPU fit's {cth} (youden within 1e-6); meta2 coef "
               f"{svc.stacker.meta2.coef_.tolist()} intercept {svc.stacker.meta2.intercept_:.6f} "
               f"({svc.stacker.meta2.n_iter_} Newton steps; the CPU fit took {cpu_s:.3f} s)")
        t0 = time.perf_counter()
        Stacker.fit(*(read_oof_csv(root / d / "oof_val.csv") for d in ("mm_dualtask_v1", "mil_v1")), device=dev)
        print(f"  the Stacker's fit on the card: {time.perf_counter() - t0:.3f} s "
              f"({svc.stacker.meta2.n_iter_} steps, one sync each)")

        # every upload of phase 4, on its route, without and with all 9 fields
        uploads = [
            synth_teeth(1, s, seed=SEED + 10 + i, angles_deg=[25.0 + 5 * i])[0]
            for i, s in enumerate(FUSED_UPLOADS + PHONE_UPLOADS)
        ]
        fields = _field_rows(1, SEED + 50)[0]
        for call in ({}, {"fields": fields}):  # warm-up: cuDNN plans, allocator
            svc.predict_one(uploads[0], **call)
            svc.predict_one(uploads[-1], **call)
        torch.cuda.synchronize()

        reset_launches()
        lat, results = {}, []
        for rep in range(3):
            for img in uploads:
                route, rise, stay = (("fused", SERVE_KERNELS, L_KERNELS) if img.shape[:2] in FUSED_UPLOADS
                                     else ("L-plane", L_ROUTE_KERNELS, FUSED_KERNELS))
                for tabular, call in ((False, {}), (True, {"fields": fields})):
                    before = dict(LAUNCHES)
                    t0 = time.perf_counter()
                    r = svc.predict_one(img, **call)
                    torch.cuda.synchronize()
                    lat.setdefault((route, tabular), []).append(time.perf_counter() - t0)
                    if not (all(LAUNCHES[k] > before[k] for k in rise) and all(LAUNCHES[k] == before[k] for k in stay)):
                        raise AssertionError(f"{route} route not taken for {img.shape}: {before} -> {LAUNCHES}")
                    if "error" in r:
                        raise AssertionError(f"request {img.shape} failed: {r['error']}")
                    want = {"prob_mm", "prob_mil"} | ({"prob_tab"} if tabular else set())
                    if set(r["streams"]) != want or r["used_tabular"] != tabular:
                        raise AssertionError(f"streams {sorted(r['streams'])}, wanted {sorted(want)}")
                    p = r["p_indirect"]
                    if not (np.isfinite(p) and 0.0 <= p <= 1.0 and r["label"] in ("Direct", "Indirect")
                            and all(0.0 <= v <= 1.0 for v in r["streams"].values())):
                        raise AssertionError(f"bad answer {r}")
                    if r["processed_image"].shape != (512, 512, 3) or r["processed_image"].dtype != np.uint8:
                        raise AssertionError("processed image is not u8 512x512x3")
                    if rep == 0:
                        results.append((img.shape, route, tabular, r))
        launches = dict(LAUNCHES)
        for shape, route, tabular, r in results:
            streams = " ".join(f"{k}={v:.6f}" for k, v in r["streams"].items())
            print(f"  upload {shape} ({route}, {'fields' if tabular else 'no fields'}): {r['label']} "
                  f"p_indirect={r['p_indirect']:.6f} thr={r['threshold']:.6f} {streams}")
        n = sum(len(v) for v in lat.values())
        _check(True, f"{n} requests answered with the right streams; K1-K3 rose on every fused-route "
                     f"request and K8, K9, K3 on every L-plane one, the other route's counters unchanged: "
                     f"{launches}")
        p50s = {k: float(np.median(v)) * 1e3 for k, v in lat.items()}
        for (route, tabular), ms in sorted(p50s.items()):
            print(f"  serve p50 {route} route, {'all 9 fields' if tabular else 'no fields'}: {ms:.2f} ms "
                  f"(host clock, {len(lat[(route, tabular)])} requests; {smi})")

        # one request's stages, each ended by a synchronise (3 repetitions,
        # the median of each stage), per route, with all 9 fields
        tab_vec = encode_fields(fields)
        stages = {}
        for route, img in (("fused", uploads[0]), ("L-plane", uploads[-1])):
            times = []
            for _ in range(3):
                t = [time.perf_counter()]
                proc = svc.preprocess(img)
                t.append(time.perf_counter())
                p_mm = svc.mm_predict(proc, tab_vec)
                t.append(time.perf_counter())
                p_mil = svc.mil_predict(proc)
                t.append(time.perf_counter())
                p_tab = svc.tab_predict(tab_vec)
                torch.cuda.synchronize()
                t.append(time.perf_counter())
                svc.stacker.fuse(p_mm, p_mil, p_tab)
                t.append(time.perf_counter())
                times.append(np.diff(t) * 1e3)
            med = np.median(times, axis=0)
            stages[route] = dict(zip(("preprocess", "mm", "mil", "tab", "fuse"), med.tolist()))
            print(f"  stages of one {route} request with fields (host clock, median of 3): "
                  + ", ".join(f"{k} {v:.2f} ms" for k, v in stages[route].items())
                  + f"; sum {med.sum():.2f} ms; {smi}")

        # the service's MM folds are the written ones, bit for bit; fold 0 in
        # f32 on the card against the CPU (TF32 off), both logits of the
        # three views of one processed upload
        _check(all(torch.equal(net.state_dict()[k].cpu(), v)
                   for net, sd in zip(mm.nets, mm_states) for k, v in sd.items()),
               f"MM folds 0-{N_FOLDS - 1} served == the folds written, through npz and the Flax tree")
        f0 = mm.folds[0]
        net = MMJointDualHead(mm_r["model_name"], dtype=torch.float32).eval()
        net.load_state_dict(mm_states[0])
        x = torch.from_numpy(svc.preprocess(uploads[1])).float()[None]
        v = normalize_imagenet(resize_bilinear(x, (f0["img_size"],) * 2))
        v = torch.cat([v, v.flip(2), v.flip(1)])
        t = torch.from_numpy(np.tile((np.float32(tab_vec) - f0["mean"]) / f0["scale"], (3, 1)))
        with torch.no_grad():
            cpu = net(v, t)
            gpu = net.to(dev)(v.to(dev), t.to(dev))
        for name, c, g in zip(("logit_cls", "logit_reg"), cpu, gpu):
            c, g = c.numpy(), g.cpu().numpy()
            rel = float(np.max(np.abs(g - c) / np.maximum(1.0, np.abs(c))))
            _check(rel <= 1e-3, f"MM fold 0 f32 {name} on the card {g.round(6).tolist()} vs CPU "
                                f"{c.round(6).tolist()}: {rel:.3g} relative")

        # the Tab stream on the card against the CPU on seeded field rows
        cpu_tab = TabEnsemble.from_folder(root / "tab_v1", device="cpu")
        d = max(abs(tab.predict_one(encode_fields(f)) - cpu_tab.predict_one(encode_fields(f)))
                for f in _field_rows(32, SEED + 51))
        _check(d <= 1e-6, f"TabEnsemble on the card vs CPU on 32 field rows: max |dp| {d:.3g}")

        # the image streams against the same folds read from the folder onto
        # the CPU, on one processed upload: as served (bf16, every fold, the
        # three views, the [F, 3] copy and the division by T) within
        # SERVE_BF16_BAR; and the MM ensemble in f32 from the folds as the
        # service read them, on the card, against the CPU's within
        # SERVE_F32_BAR
        t0 = time.perf_counter()
        cpu_mm = MMEnsemble.from_folder(root / "mm_dualtask_v1", device="cpu")
        cpu_mil = MILEnsemble.from_folder(root / "mil_v1", device="cpu")
        f32 = MMJointDualHead(mm_r["model_name"], dtype=torch.float32)
        f32_card, f32_cpu = MMEnsemble(mm.folds, f32, device=dev), MMEnsemble(cpu_mm.folds, f32, device="cpu")
        proc = svc.preprocess(uploads[0])
        for what, ens, ref, args, bar in (
            ("MM bf16, fields", mm, cpu_mm, (proc, tab_vec), SERVE_BF16_BAR),
            ("MM bf16, no fields", mm, cpu_mm, (proc, None), SERVE_BF16_BAR),
            ("MIL bf16", mil, cpu_mil, (proc,), SERVE_BF16_BAR),
            ("MM f32, fields", f32_card, f32_cpu, (proc, tab_vec), SERVE_F32_BAR),
            ("MM f32, no fields", f32_card, f32_cpu, (proc, None), SERVE_F32_BAR),
        ):
            got, want = ens.predict(*args), ref.predict(*args)
            _check(abs(got - want) <= bar,
                   f"{what} ({N_FOLDS} folds) p {got:.6f} on the card vs {want:.6f} on the CPU: "
                   f"|dp| {abs(got - want):.3g}, bar {bar}")
        print(f"  the CPU ensembles' reads and predictions took {time.perf_counter() - t0:.1f} s")
        print(f"  phase 8 took {time.perf_counter() - t_phase:.1f} s")
        after = then(svc, uploads, fields, results)
    _check(not root.exists(), "the weights folder removed")
    return launches, p50s, after


# phase 9: the codec, the CLI twin and the app on the card. The card's
# machine has no libjpeg, so its JPEG codec is nvJPEG, whose IDCT and
# chroma upsampling are not libjpeg's. The bar for its decode of the
# committed goldens against Pillow's, set from a first measurement on the
# card (PERF.md §6): on every golden a mean |d| of at most NVJPEG_MEAN_BAR
# levels, at least NVJPEG_EQUAL of the values equal and NVJPEG_WITHIN8
# within 8 levels; where no chroma is upsampled (4:4:4, grayscale) |d| at
# most NVJPEG_444_MAX
GOLDENS = ROOT / "mmtrs_tpu_torch" / "testdata" / "codec_goldens.npz"
NVJPEG_MEAN_BAR = 2.5
NVJPEG_EQUAL = 0.25
NVJPEG_WITHIN8 = 0.97
NVJPEG_444_MAX = 4
CLI_TEETH = 9  # 12 MP JPEGs through the CLI, beside one small image and one garbage file
CLI_BATCH = 4
# PredictService's refusals, as the JAX package's service words them
# (mmtrs_tpu/serve/service.py)
LOW_RES_ERROR = "image resolution too low (min edge 300 < 512)"
PARTIAL_ERROR = "provide all tabular fields or none; missing: "


def _codec_checks(torch, dev, smi: str) -> dict:
    """The goldens against Pillow's decode within the nvJPEG bar, a q95
    round trip stable over two runs, PNG exact both ways, the CPU backend's
    build refused by name; decode ms of a 12 MP JPEG, encode ms of a 512²."""
    from mmtrs_tpu_torch import _build
    from mmtrs_tpu_torch.utils.codec import decode_image, encode_jpeg, encode_png

    t0 = time.perf_counter()
    _build.nvjpeg_library()
    _build.png_library()
    print(f"  codec libraries built in {time.perf_counter() - t0:.2f} s (nvJPEG by nvcc, PNG by g++)")
    try:
        _build.jpeg_library()
        raise AssertionError("the libjpeg backend built on the card's machine, which has no libjpeg")
    except RuntimeError as e:
        _check("libjpeg" in str(e), f"the CPU backend's build raises by name here: {e}")
    with np.load(GOLDENS) as z:
        names = sorted({f.rsplit(".", 1)[0] for f in z.files})
        for name in names:
            got = decode_image(z[f"{name}.jpg"].tobytes(), dev)
            want = z[f"{name}.pil"]
            _check(got.device.type == "cuda" and got.dtype == torch.uint8 and tuple(got.shape) == want.shape,
                   f"golden {name}: decoded on the card, u8 {tuple(got.shape)}")
            d = np.abs(got.cpu().numpy().astype(int) - want.astype(int))
            no_chroma = "444" in name or "gray" in name
            _check(d.mean() <= NVJPEG_MEAN_BAR and (d == 0).mean() >= NVJPEG_EQUAL
                   and (d <= 8).mean() >= NVJPEG_WITHIN8 and (d.max() <= NVJPEG_444_MAX or not no_chroma),
                   f"golden {name} vs Pillow: max |d| {d.max()}, equal {(d == 0).mean():.4f}, within 8 "
                   f"{(d <= 8).mean():.5f}, mean {d.mean():.4f} (bar: mean <= {NVJPEG_MEAN_BAR}, equal >= "
                   f"{NVJPEG_EQUAL}, within 8 >= {NVJPEG_WITHIN8}" + (f", max <= {NVJPEG_444_MAX})" if no_chroma else ")"))
    teeth = _archive_batch()
    x = torch.from_numpy(teeth[0, :512, 1500:2012]).to(dev).contiguous()
    a, b = encode_jpeg(x, 95), encode_jpeg(x, 95)
    da, db = decode_image(a, dev), decode_image(b, dev)
    _check(a == b and torch.equal(da, db), f"encode_jpeg(x, 95) twice: the same {len(a)} bytes, the same decode")
    png = encode_png(x)
    _check(torch.equal(decode_image(png, dev), x), "PNG round trip exact")
    big = encode_jpeg(torch.from_numpy(teeth[0]).to(dev), 95)
    timed = {"decode_12mp_ms": (lambda: decode_image(big, dev)), "encode_512_ms": (lambda: encode_jpeg(x, 95)),
             "png_encode_512_ms": (lambda: encode_png(x)), "png_decode_512_ms": (lambda: decode_image(png, dev))}
    out = {}
    for key, fn in timed.items():
        fn()
        ts = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        out[key] = float(np.median(ts))
    print(f"  nvJPEG decode of a 12 MP JPEG ({len(big)} bytes, q95 4:2:0) {out['decode_12mp_ms']:.2f} ms, "
          f"encode of a 512² u8 image {out['encode_512_ms']:.2f} ms; PNG encode {out['png_encode_512_ms']:.2f} ms, "
          f"decode {out['png_decode_512_ms']:.2f} ms at 512² (host clock, median of 5; {smi})")
    return out


def _cli_check(torch, dev, tmp: Path, archive_ips: float) -> dict:
    """``cli.run_pipeline.main`` on 9 synthetic 12 MP teeth, one small image
    and one garbage file, batch 4, on its default device."""
    from mmtrs_tpu_torch.cli import run_pipeline
    from mmtrs_tpu_torch.config import PreprocessConfig
    from mmtrs_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from mmtrs_tpu_torch.preprocess import preprocess_numpy
    from mmtrs_tpu_torch.synth import synth_teeth
    from mmtrs_tpu_torch.utils.codec import encode_jpeg
    from mmtrs_tpu_torch.utils.images import iter_batches, list_images

    in_dir = tmp / "in"
    in_dir.mkdir()
    teeth = torch.from_numpy(_archive_batch()).to(dev)
    variants = [teeth, teeth.flip(2), teeth[:1].flip(1)]  # as taken, mirrored, upside down
    for i, img in enumerate(torch.cat(variants)[:CLI_TEETH]):
        (in_dir / f"tooth_{i}.jpg").write_bytes(encode_jpeg(img.contiguous(), 95))
    small = torch.from_numpy(synth_teeth(1, (300, 400), seed=SEED + 60)[0]).to(dev)
    (in_dir / "small.jpg").write_bytes(encode_jpeg(small, 95))
    (in_dir / "garbage.jpg").write_bytes(np.random.default_rng(SEED).integers(0, 256, 5000, np.uint8).tobytes())

    kept = {}
    save = run_pipeline.save_jpeg

    def keep(path, img, quality=95):  # the outputs before encoding
        kept[Path(path).stem] = img.clone()
        return save(path, img, quality)

    run_pipeline.save_jpeg = keep
    try:
        reset_launches()
        t0 = time.perf_counter()
        rc = run_pipeline.main(["--input_dir", str(in_dir), "--output_dir", str(tmp / "out"),
                                "--log_dir", str(tmp / "logs"), "--batch_size", str(CLI_BATCH)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(LAUNCHES)
    finally:
        run_pipeline.save_jpeg = save
    (log_path,) = list((tmp / "logs").glob("preprocess_*.json"))
    log = json.loads(log_path.read_text())
    status = {e["file"]: e["status"] for e in log["entries"]}
    outs = sorted(p.name for p in (tmp / "out").iterdir())
    _check(rc == 0 and outs == [f"tooth_{i}.jpg" for i in range(CLI_TEETH)] and log["processed"] == CLI_TEETH,
           f"the CLI wrote {len(outs)} outputs and logged processed {log['processed']} of {log['total']}")
    _check(status == {"garbage.jpg": "rejected_decode_error", "small.jpg": "rejected_min_edge",
                      **{f"tooth_{i}.jpg": "ok" for i in range(CLI_TEETH)}}, f"log statuses {status}")
    _check(all(counts[k] > 0 for k in L_ROUTE_KERNELS + ("scatter_rows",)) and all(counts[k] == 0 for k in FUSED_KERNELS),
           f"the CLI's run took the L-plane route with deskew's write-back: K8, K9, K3, K7 launched, K1/K2 not: "
           f"{counts}")
    _check(all(v.device == torch.device(dev) for v in kept.values()), f"the outputs reached the encoder on {dev}")

    cfg, n = PreprocessConfig(), 0
    for ok, batch, _ in iter_batches(list_images(in_dir), CLI_BATCH, min_edge=cfg.min_edge_px, device=dev):
        if not len(batch):
            continue
        real = len(batch)
        batch = torch.cat([batch, batch[-1:].expand(CLI_BATCH - real, -1, -1, -1)])
        want, _ = preprocess_numpy(batch.cpu().numpy(), cfg, device=dev)
        for i, path in enumerate(ok[:real]):
            got = kept[path.stem]
            _check(torch.equal(got.cpu(), torch.from_numpy(want[i])),
                   f"{path.name}: the CLI's u8 output == preprocess_numpy on its decoded, padded batch")
            n += 1
    _check(n == CLI_TEETH, f"{n} outputs held against preprocess_numpy")
    print(f"  the CLI: {log['imgs_per_sec']:.2f} imgs/s over its loop (nvJPEG decode, the Pillow-route feed, "
          f"preprocess_stream, nvJPEG encode, file writes), {CLI_TEETH / wall:.2f} imgs/s for the whole main() "
          f"({wall:.2f} s); preprocess_stream alone (phase 7) {archive_ips:.2f} imgs/s")
    return {"imgs_per_sec": log["imgs_per_sec"], "main_imgs_per_sec": CLI_TEETH / wall, "launches": counts}


def _app_check(torch, dev, svc, uploads, fields, results, smi: str) -> dict:
    """``serve_http`` on an ephemeral port over phase 8's service: GET / and
    /ui; POST /predict with phase 8's seven uploads as JPEG and as PNG,
    without and with all 9 fields, each answer against ``predict_one`` on
    the decoded upload (a PNG decodes to the upload itself, so phase 8's
    answers are the reference) and its preview against
    ``processed_image``; the two refusals."""
    import base64
    import threading
    import urllib.error
    import urllib.request

    from mmtrs_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from mmtrs_tpu_torch.serve import app
    from mmtrs_tpu_torch.utils.codec import decode_image, decode_png, encode_jpeg, encode_png

    httpd = app.make_server(svc, "127.0.0.1", 0)
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()

    def post(body: dict) -> tuple[int, dict, float]:
        req = urllib.request.Request(f"{url}/predict", data=json.dumps(body).encode(), method="POST")
        t0 = time.perf_counter()
        try:
            with urllib.request.urlopen(req) as r:
                code, out = r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            code, out = e.code, json.loads(e.read())
        return code, out, time.perf_counter() - t0

    try:
        with urllib.request.urlopen(f"{url}/") as r:
            schema = json.loads(r.read())
        _check(set(schema) == {"fields", "threshold_modes", "metrics"} and len(schema["fields"]) == 9,
               f"GET / answers the schema ({len(schema['fields'])} fields, {schema['threshold_modes']})")
        with urllib.request.urlopen(f"{url}/ui") as r:
            page = r.read().decode()
        _check("<title>Tooth Restoration Selection (H100)</title>" in page and 'id="proc"' in page,
               f"GET /ui answers the page ({len(page)} bytes)")

        ref = {(shape, tabular): r for shape, _, tabular, r in results}
        http_ms, one_ms = {}, []
        reset_launches()
        for img in uploads:
            x = torch.from_numpy(img).to(dev)
            for fmt, raw in (("jpeg", encode_jpeg(x, 95)), ("png", encode_png(img))):
                b64 = base64.b64encode(raw).decode()
                decoded = decode_image(raw, dev)
                if fmt == "png":
                    _check(torch.equal(decoded, x), f"{img.shape} as PNG decodes to the upload itself")
                for tabular, call in ((False, {}), (True, {"fields": fields})):
                    code, got, dt = post({"image_b64": b64, "include_processed": True, **call})
                    http_ms.setdefault(fmt, []).append(dt * 1e3)
                    if fmt == "png":
                        want = ref[(img.shape, tabular)]
                    else:
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        want = svc.predict_one(decoded, **call)
                        torch.cuda.synchronize()
                        one_ms.append((time.perf_counter() - t0) * 1e3)
                    same = code == 200 and all(got[k] == want[k] for k in ("p_indirect", "threshold", "label", "streams"))
                    if not same:
                        raise AssertionError(f"{img.shape} {fmt} {'fields' if tabular else 'no fields'}: HTTP {code} "
                                             f"{ {k: v for k, v in got.items() if k != 'processed_image_b64'} } "
                                             f"!= predict_one {want['p_indirect']} {want['streams']}")
                    preview = decode_png(base64.b64decode(got["processed_image_b64"]))
                    if not np.array_equal(preview, want["processed_image"]):
                        raise AssertionError(f"{img.shape} {fmt}: the preview PNG is not processed_image")
        counts = dict(LAUNCHES)
        n = sum(len(v) for v in http_ms.values())
        _check(True, f"{n} POST /predict answers == predict_one on the decoded upload (p_indirect, threshold, "
                     f"label, streams) and {n} previews == processed_image")
        _check(all(counts[k] > 0 for k in SERVE_KERNELS + L_KERNELS + ("scatter_rows",)),
               f"the app's requests ran K1-K3 (fused route), K8/K9 (L-plane route), K7: {counts}")

        code, low, _ = post({"image_b64": base64.b64encode(encode_png(uploads[0][:300, :300])).decode()})
        _check(code == 400 and low == {"error": LOW_RES_ERROR}, f"a 300x300 upload: {code} {low}")
        partial = {k: fields[k] for k in list(fields)[:2]}
        code, part, _ = post({"image_b64": base64.b64encode(encode_png(uploads[0])).decode(), "fields": partial})
        missing = [k for k in fields if k not in partial]
        _check(code == 400 and part == {"error": PARTIAL_ERROR + str(missing)}, f"two of 9 fields: {code} {part}")
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=10)
    _check(not thread.is_alive(), "the server thread stopped")
    p50 = {fmt: float(np.median(v)) for fmt, v in http_ms.items()}
    p50["predict_one"] = float(np.median(one_ms))
    print(f"  HTTP p50: JPEG uploads {p50['jpeg']:.2f} ms, PNG uploads {p50['png']:.2f} ms (base64, decode on the "
          f"card, predict_one, PNG preview, JSON); predict_one alone on the decoded JPEG uploads "
          f"{p50['predict_one']:.2f} ms (host clock, {len(http_ms['jpeg'])} requests each; {smi})")
    return {"http_p50_ms": p50, "launches": counts}


def phase_entry_points(torch, dev, smi: str, archive_ips: float):
    """Phase 9, run by phase 8 on its service (``then``)."""
    import tempfile

    def run(svc, uploads, fields, results):
        t_phase = time.perf_counter()
        print("phase 9: the codec (nvJPEG on the card, PNG on the host), the CLI twin and the app on the card")
        codec = _codec_checks(torch, dev, smi)
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
            cli = _cli_check(torch, dev, Path(tmp), archive_ips)
        served = _app_check(torch, dev, svc, uploads, fields, results, smi)
        seconds = time.perf_counter() - t_phase
        print(f"  phase 9 took {seconds:.1f} s")
        return {"codec": codec, "cli": cli, "app": served, "seconds": seconds}

    return run


# phase 10: train the MM stream on the card, the rehearsal's stages 2-4
# (scripts/rehearsal.py:172-216) at the MMJointConfig defaults' widths (B4 at
# 380, batch 12, bf16 activations, f32 parameters and AdamW state, randaug),
# depth cut to TRAIN_CASES cases, TRAIN_FOLDS folds and 1 epoch
TRAIN_CASES = 24
TRAIN_AUG = 2
TRAIN_FOLDS = 2
TRAIN_TIMED_STEPS = 6  # bf16 steps timed one by one after the k-fold run
# one f32 step of B4 at 380 (batch 4, no augmentation, every dropout and
# drop-path rate 0) on the card (TF32 off) against the same step on the CPU:
# the loss within F32_LOSS_BAR relative; every gradient leaf within
# F32_GRAD_BAR of its max |g|, except the biases whose gradient is 0 in
# exact arithmetic (_zero_grad_leaves: each device gives rounding noise
# that the other cannot match, so they are held apart and each device's
# under F32_ZERO_GRAD_BAR of the largest gradient); the running statistics
# within F32_STATS_BAR relative; after the AdamW step, every parameter
# element whose gradient exceeds 1e-3 of its leaf's max on both devices
# within F32_PARAM_BAR (elsewhere AdamW's first step, lr·g / (|g| + eps), is
# ~lr·sign(g) on each device, and a sign of noise tells nothing). Each bar
# stands 2-8 times over the largest of 8 batches' readings by
# `chip_profile.py --f32-step`, and a TF32-on control fails every one
# (NVIDIA H100 80GB HBM3, 700 W; PERF.md). Not batch 2: over 2 rows
# TabMLP's train-mode BatchNorm gives ±1 and its backward a difference of
# nearly equal terms, so its leaves' gradients disagreed between the
# devices by up to 1.98e-2 of their max.
F32_STEP_BATCH = 4
F32_LOSS_BAR = 5e-6  # read <= 7.45e-7; TF32 on 1.60e-4
F32_GRAD_BAR = 1e-3  # read <= 2.48e-4; TF32 on 0.245
F32_STATS_BAR = 5e-4  # read <= 1.11e-4; TF32 on 8.21e-2
F32_PARAM_BAR = 1e-5  # read <= 4.27e-6; TF32 on 6.00e-4
F32_ZERO_GRAD_BAR = 5e-6  # read <= 6.11e-7; TF32 on 1.43e-5; a real gradient read 1.24e-3
TRAIN_KERNELS = ("resample_rows", "scatter_rows")  # randaug: K4 warp, K7 erasing write-back
# the legacy table's chain on every batch: K4 warp, K5 photometric, K7
# gated write-backs (K1/K2's CLAHE member and K6's elastic fire by draw)
LEGACY_TABLE_KERNELS = ("resample_rows", "photometric", "scatter_rows")


def _zero_grad_leaves(model) -> set[str]:
    """The parameters of MMJointDualHead whose gradient is 0 in exact
    arithmetic in train mode: TabMLP's Dense biases (each before a
    BatchNorm), and each MBConv's last BatchNorm bias whose output reaches
    only 1×1 convolutions (the blocks that read it up to the next block
    without a residual all expand first, or it is the last block, before
    conv_head) and then a BatchNorm, which subtracts it again. A block
    without expansion convolves it depthwise with zero padding first (B4's
    stage0_block1 reads stage0_block0's), which does not cancel it."""
    out = {"tab_mlp.fc0.bias", "tab_mlp.fc1.bias"}
    blocks = list(getattr(model.backbone, "blocks", {}).items())
    for i, (name, _) in enumerate(blocks):
        readers = []
        for _, nxt in blocks[i + 1:]:
            readers.append(nxt)
            if not nxt.residual:
                break
        if all(hasattr(r, "pw_expand") for r in readers):
            out.add(f"backbone.blocks.{name}.bn2.bias")
    return out


def _train_cohort(n: int):
    """n raw 512² synthetic teeth (a third rotated past deskew's gate), 9
    seeded fields each (encode_fields), seeded labels and soft targets: the
    port's Table of one row per case."""
    from mmtrs_tpu_torch.data.features import BASE_FEATURES
    from mmtrs_tpu_torch.serve.choices import encode_fields
    from mmtrs_tpu_torch.synth import synth_teeth
    from mmtrs_tpu_torch.utils.table import Table

    rng = np.random.default_rng(SEED + 60)
    angles = [25.0 if i % 3 == 0 else 0.0 for i in range(n)]
    raw = synth_teeth(n, 512, seed=SEED + 61, angles_deg=angles)
    tab = np.array([encode_fields(f) for f in _field_rows(n, SEED + 62)], np.float64)
    y = (rng.random(n) < 0.5).astype(np.int64)
    p = np.clip(y * 0.6 + rng.random(n) * 0.4, 0.0, 1.0)
    cols = {"image_name": [f"{i + 1}.jpg" for i in range(n)]}
    cols.update({c: tab[:, j] for j, c in enumerate(BASE_FEATURES)})
    cols.update({"y_majority": y, "p_indirect": p})
    return Table(cols), raw


def _f32_step_check(torch, dev, aug_table, aug_imgs, sel):
    """One f32 train step of the same seed-built B4 (MMJointConfig's
    widths, batch ``sel`` of the lineage table, no augmentation, no dropout
    or drop-path) on the card and on the CPU; returns the losses and the
    measured gaps (``_f32_step_ok`` holds them to the F32_* bars)."""
    from mmtrs_tpu_torch.config import MMJointConfig
    from mmtrs_tpu_torch.data.features import BASE_FEATURES
    from mmtrs_tpu_torch.models.backbones.efficientnet import MBConv
    from mmtrs_tpu_torch.train.mm import MMTrainer

    cfg = MMJointConfig(train_aug="none", tab_dropout=0.0, head_dropout=0.0)
    imgs = aug_imgs[torch.from_numpy(sel).to(aug_imgs.device)].cpu()
    cols = (np.stack([aug_table[c][sel] for c in BASE_FEATURES], 1), aug_table["y_majority"][sel],
            aug_table["p_indirect"][sel])
    out = {}
    for where in ("cpu", dev):
        tr = MMTrainer(cfg, device=where, dtype=torch.float32)
        for m in tr.model.modules():
            if isinstance(m, MBConv):
                m.drop_path = 0.0
        tr.init_state(10)
        x = tr._prep_train(imgs.to(where), sel, 0)
        loss = tr.train_step(x, *(torch.from_numpy(c.astype(np.float32)).to(where) for c in cols))
        grads = {k: v.grad.detach().cpu().clone() for k, v in tr.model.named_parameters()}
        state = {k: v.detach().cpu().clone() for k, v in tr.model.state_dict().items()}
        out[str(where)] = (float(loss), grads, state)
    # the grads the trainer leaves are clipped in place: the same factor on
    # both devices up to the norm's rounding, which the bars absorb
    return out["cpu"][0], out[str(dev)][0], _step_gaps(torch, out, dev, _zero_grad_leaves(tr.model))


def _step_gaps(torch, out: dict, dev, zero=frozenset()) -> dict:
    """The gaps of one f32 train step, card vs CPU, from out[device] =
    (loss, gradients, state dict after the step): the loss relative; each
    gradient leaf's gap over its max |g| ("grad_by_leaf", with its max over
    the largest, and its worst "grad"), but the leaves ``zero`` whose
    gradient is 0 in exact arithmetic, held apart as each device's largest
    over the largest |g|; the running statistics relative (0 where there
    are none); after AdamW, every parameter element whose gradient exceeds
    1e-3 of its leaf's max on both devices."""
    (lc, gc, sc), (lg, gg, sg) = out["cpu"], out[str(dev)]
    gaps = {"loss": abs(lg - lc) / abs(lc)}
    gmax = max(float(g.abs().max()) for g in gc.values())
    # each leaf: (its gap over its max |g|, its max |g| over the largest)
    gaps["grad_by_leaf"] = {k: (float((gg[k] - g).abs().max() / g.abs().max().clamp_min(1e-30)),
                                float(g.abs().max()) / gmax) for k, g in gc.items() if k not in zero}
    gaps["grad"] = max(v[0] for v in gaps["grad_by_leaf"].values())
    for name, gs in (("card", gg), ("cpu", gc)):
        gaps[f"zero_grad_{name}"] = max((float(gs[k].abs().max()) for k in zero), default=0.0) / gmax
    stats = [k for k in sc if k.endswith(("running_mean", "running_var"))]
    gaps["stats"] = max((float(((sg[k] - sc[k]).abs() / sc[k].abs().clamp_min(1e-3)).max()) for k in stats),
                        default=0.0)
    gaps["params_firm"] = 0.0
    for k, g in gc.items():
        firm = torch.minimum(g.abs(), gg[k].abs()) > 1e-3 * g.abs().max()
        if k not in zero and firm.any():
            gaps["params_firm"] = max(gaps["params_firm"], float((sg[k] - sc[k]).abs()[firm].max()))
    return gaps


def _f32_step_ok(gaps: dict) -> bool:
    return (gaps["loss"] <= F32_LOSS_BAR and gaps["grad"] <= F32_GRAD_BAR and gaps["stats"] <= F32_STATS_BAR
            and gaps["params_firm"] <= F32_PARAM_BAR
            and max(gaps["zero_grad_card"], gaps["zero_grad_cpu"]) <= F32_ZERO_GRAD_BAR)


def phase_train(torch, dev, smi: str, work: Path):
    """Phase 10: preprocess raw teeth, build the legacy lineage table, train
    the MM stream k-fold (run_mm_kfold at B4 380, randaug, save_ckpts) into
    ``work``/mm_dualtask_v1, serve the folds it wrote
    (build_service_from_weights) on phase 4's uploads, and hold one f32
    train step on the card against the CPU. Phase 11 goes on from the table
    and the folder."""
    from mmtrs_tpu_torch.config import MMJointConfig
    from mmtrs_tpu_torch.data.features import BASE_FEATURES
    from mmtrs_tpu_torch.data.records import build_augmented_table, quantize_round_half_even
    from mmtrs_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from mmtrs_tpu_torch.preprocess import preprocess_batch
    from mmtrs_tpu_torch.serve.choices import encode_fields
    from mmtrs_tpu_torch.serve.ensembles import build_service_from_weights
    from mmtrs_tpu_torch.synth import synth_teeth
    from mmtrs_tpu_torch.train.common import Throughput
    from mmtrs_tpu_torch.train.mm import MMTrainer, run_mm_kfold

    t_phase = time.perf_counter()
    cfg = MMJointConfig(n_folds=TRAIN_FOLDS, epochs=1)
    print(f"phase 10: train the MM stream: {TRAIN_CASES} raw teeth -> preprocess_batch -> "
          f"build_augmented_table(n_aug={TRAIN_AUG}, legacy) -> run_mm_kfold({cfg.model_name} at "
          f"{cfg.img_size}, batch {cfg.batch_size}, {cfg.n_folds} folds, 1 epoch, train_aug={cfg.train_aug}, "
          f"bf16) -> build_service_from_weights")
    table, raw = _train_cohort(TRAIN_CASES)
    launches, seconds = {}, {}

    reset_launches()
    t0 = time.perf_counter()
    proc, _ = preprocess_batch(torch.from_numpy(raw).to(dev))
    proc = quantize_round_half_even(proc)
    torch.cuda.synchronize()
    seconds["preprocess"] = time.perf_counter() - t0
    launches["preprocess"] = dict(LAUNCHES)
    _check(all(launches["preprocess"][k] > 0 for k in SERVE_KERNELS),
           f"preprocess_batch launched {SERVE_KERNELS}: {launches['preprocess']}")

    reset_launches()
    t0 = time.perf_counter()
    aug_table, aug_imgs = build_augmented_table(table, proc, n_aug=TRAIN_AUG, preset="legacy", seed=42,
                                                test_frac=0.19)
    torch.cuda.synchronize()
    seconds["table"] = time.perf_counter() - t0
    launches["table"] = dict(LAUNCHES)
    n_rows = TRAIN_CASES * (1 + TRAIN_AUG)
    _check(len(aug_table) == n_rows and aug_imgs.shape == (n_rows, 512, 512, 3) and aug_imgs.device.type == dev.type,
           f"lineage table of {len(aug_table)} rows ({sorted(set(aug_table['split']))}), images on the card; "
           f"legacy launches {launches['table']}")
    _check(all(launches["table"][k] > 0 for k in LEGACY_TABLE_KERNELS),
           f"the legacy build launched {LEGACY_TABLE_KERNELS}")

    out_dir = work / "mm_dualtask_v1"
    stamps = []
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = run_mm_kfold(aug_imgs, aug_table, cfg, outdir=out_dir, epochs=1, save_ckpts=True,
                       log=lambda msg: stamps.append((time.perf_counter(), msg)))
    torch.cuda.synchronize()
    seconds["run_mm_kfold"] = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches["train"] = dict(LAUNCHES)
    for _, msg in stamps:
        print(f"  {msg}")
    start = t0
    for fold in range(TRAIN_FOLDS):
        fit_end = [t for t, m in stamps if m.startswith("[mm ep")][fold]
        fold_end = [t for t, m in stamps if m.startswith("[mm fold")][fold]
        seconds[f"fold{fold}_fit"], seconds[f"fold{fold}_eval"] = fit_end - start, fold_end - fit_end
        start = fold_end
    _check(all(launches["train"][k] > 0 for k in TRAIN_KERNELS),
           f"randaug in the trainer launched {TRAIN_KERNELS}: {launches['train']}")
    losses = np.concatenate([h["losses"] for f in res["folds"] for h in f["history"]])
    _check(len(losses) > 0 and bool(np.isfinite(losses).all()),
           f"{len(losses)} step losses, all finite: {np.round(losses, 4).tolist()}")
    ref = MMTrainer(cfg, device="cpu")  # the fold's start, built from cfg.seed as the run's was
    params = [n for n, _ in ref.model.named_parameters()]
    stats = [n for n in ref._init if n.endswith(("running_mean", "running_var"))]
    for k, f in enumerate(res["folds"]):
        sd = f["state"]["model"]
        moved_p = sum(not torch.equal(sd[n].cpu(), ref._init[n]) for n in params)
        moved_s = sum(not torch.equal(sd[n].cpu(), ref._init[n]) for n in stats)
        n_s = len(stats)
        _check(moved_p > 0 and moved_s == n_s,
               f"fold {k}: {moved_p} parameter tensors and {moved_s}/{n_s} running statistics changed")
    names = sorted(p.name for p in out_dir.iterdir())
    want = {f"mm_dualtask_fold{k}{e}" for k in range(TRAIN_FOLDS) for e in (".npz", ".recipe.json")}
    want |= {"oof_val.csv", "pred_test.csv", "summary.json", "metrics.jsonl"}
    _check(set(names) == want, f"outputs {names}")
    print(f"  summary: {json.dumps(res['summary'])}")

    # the service from the folds it wrote, on phase 4's uploads
    reset_launches()
    t0 = time.perf_counter()
    svc = build_service_from_weights(work)
    torch.cuda.synchronize()
    seconds["service_build"] = time.perf_counter() - t0
    uploads = [synth_teeth(1, s, seed=SEED + 10 + i, angles_deg=[25.0 + 5 * i])[0]
               for i, s in enumerate(FUSED_UPLOADS + PHONE_UPLOADS)]
    fields = _field_rows(1, SEED + 50)[0]
    trainer = MMTrainer(cfg)
    worst = 0.0
    t0 = time.perf_counter()
    for img in uploads:
        for call in ({}, {"fields": fields}):
            r = svc.predict_one(img, **call)
            if "error" in r or set(r["streams"]) != {"prob_mm"}:
                raise AssertionError(f"request {img.shape}: {r.get('error', r.get('streams'))}")
            x = torch.from_numpy(r["processed_image"]).to(dev)[None]
            ps = []
            for f in res["folds"]:
                raw9 = np.float32(encode_fields(fields))[None] if call else f["scaler"].mean[None]
                ps.append(trainer.predict_proba(f, x, raw9)[0])
            worst = max(worst, abs(r["p_indirect"] - float(np.mean(ps))))
    seconds["serve"] = time.perf_counter() - t0
    launches["serve"] = dict(LAUNCHES)
    _check(worst <= min(SERVE_BF16_BAR, SERVE_SAME_DEVICE_BAR),
           f"served p (MM only, {TRAIN_FOLDS} folds read from npz) on {len(uploads)} uploads without and with "
           f"fields vs trainer.predict_proba on the same processed image: max |dp| {worst:.3g}, bars "
           f"{SERVE_BF16_BAR} (phase 8's bf16) and {SERVE_SAME_DEVICE_BAR} (the same bf16 model on the same "
           f"card: the npz round trip of the parameters, T, thr and the scaler); launches {launches['serve']}")

    # the bf16 step, timed one by one on the same device dataset
    tv = np.nonzero(aug_table["split"] != "test")[0]
    tab = np.stack([aug_table[c] for c in BASE_FEATURES], 1).astype(np.float32)
    tab_d = torch.from_numpy(tab).to(dev)
    y_d = torch.from_numpy(aug_table["y_majority"].astype(np.float32)).to(dev)
    p_d = torch.from_numpy(aug_table["p_indirect"].astype(np.float32)).to(dev)
    trainer.init_state(TRAIN_TIMED_STEPS)
    thr = Throughput()
    prep_ms, step_ms = [], []
    rng = np.random.default_rng(SEED + 63)
    for i in range(TRAIN_TIMED_STEPS):
        sel = rng.choice(tv, cfg.batch_size, replace=False)
        sel_d = torch.from_numpy(sel).to(dev)
        torch.cuda.synchronize()
        thr.start()
        t0 = time.perf_counter()
        x = trainer._prep_train(aug_imgs.index_select(0, sel_d), sel, 0)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        trainer.train_step(x, tab_d[sel_d], y_d[sel_d], p_d[sel_d])
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        thr.stop(cfg.batch_size)
        prep_ms.append((t1 - t0) * 1e3)
        step_ms.append((t2 - t1) * 1e3)
    step = {"prep_ms": float(np.median(prep_ms[1:])), "step_ms": float(np.median(step_ms[1:])),
            "first_step_ms": step_ms[0], "imgs_per_sec": thr.imgs_per_sec, "peak_gb": peak / 1e9}
    print(f"  bf16 train step at b{cfg.batch_size} {cfg.img_size}^2 (median of {TRAIN_TIMED_STEPS - 1} after the "
          f"first, host clock, each ending in a synchronise): randaug + resize + normalise "
          f"{step['prep_ms']:.2f} ms, forward + backward + AdamW {step['step_ms']:.2f} ms (first "
          f"{step_ms[0]:.2f} ms); Throughput {thr.imgs_per_sec:.2f} imgs/s over all {TRAIN_TIMED_STEPS}; peak "
          f"memory of run_mm_kfold {peak / 1e9:.2f} GB (torch.cuda.max_memory_allocated); {smi}")

    # one f32 step on the card against the CPU
    t0 = time.perf_counter()
    lc, lg, gaps = _f32_step_check(torch, dev, aug_table, aug_imgs, tv[:F32_STEP_BATCH])
    seconds["f32_step_check"] = time.perf_counter() - t0
    _check(_f32_step_ok(gaps),
           f"f32 B4 train step at b{F32_STEP_BATCH} {cfg.img_size}^2, card vs CPU: loss {lg:.7f} vs {lc:.7f} "
           f"({gaps['loss']:.3g} relative, bar {F32_LOSS_BAR}); gradients {gaps['grad']:.3g} of their leaf's max "
           f"(bar {F32_GRAD_BAR}), the zero-gradient biases {gaps['zero_grad_card']:.3g} (card) and "
           f"{gaps['zero_grad_cpu']:.3g} (CPU) of the largest (bar {F32_ZERO_GRAD_BAR}); running statistics "
           f"{gaps['stats']:.3g} relative (bar {F32_STATS_BAR}); parameters after AdamW {gaps['params_firm']:.3g} "
           f"where the gradient is firm (bar {F32_PARAM_BAR})")
    seconds["phase"] = time.perf_counter() - t_phase
    print("  phase 10 seconds: " + ", ".join(f"{k} {v:.2f}" for k, v in seconds.items()) + f"; {smi}")
    print("  phase 10 kernel launches: " + json.dumps(launches))
    return {"launches": launches, "seconds": seconds, "step": step, "summary": res["summary"], "mm": res,
            "table": aug_table, "imgs": aug_imgs, "trainer": trainer, "cfg": cfg, "uploads": uploads,
            "fields": fields}


# phase 11: the rest of the rehearsal on the card (scripts/rehearsal.py:218-243:
# step 5 run_mil_kfold, step 6 run_final_stack with the stack_tab_like tab
# stream), then train_tab_kfold, the fusion CLI twin, and a service built from
# the folders phases 10-11 trained. MIL at MILConfig's widths as the rehearsal
# runs them (B0, bag 12, 320², attn 128, batch 16, bf16), depth cut to phase
# 10's table, TRAIN_FOLDS folds and 1 epoch; the GBDT at stack_tab_like's 700
# trees, 31 leaves (depth 5), 64 bins, subsample and colsample 0.85.
MIL_BATCH = 16  # scripts/rehearsal.py:220 (MILConfig's default is 8)

MIL_TIMED_STEPS = 6
# one f32 MIL step (B0 at 320, 2 bags of 12, every dropout and drop-path
# rate 0) on the card against the CPU, held as phase 10's B4 step is
# (_f32_step_ok's bars, whose readings are B4's; PERF.md has B0's)
MIL_F32_BAGS = 2
GBDT_ROWS = 3762  # the rehearsal's train+val rows (results/rehearsal_r5/mm/oof_val.csv)
# the card's forest against the CPU's from the same GBDTDraws, held by
# their probabilities on the table's rows and their share of trees split
# alike: at reg_lambda 0 a last-bit difference of the two devices' sigmoid
# can pick between splits whose gains agree to the last bits
# (tests/test_torch_gbdt_train.py). On this table every tree split alike
# and the probabilities read 1.79e-7 apart (NVIDIA H100 80GB HBM3, 700 W;
# PERF.md), so the bars stand at 1 % of the trees and 56x the reading
GBDT_PROBA_BAR = 1e-5
GBDT_ALIKE_BAR = 0.99
# the stack on the card against the same call on the CPU: over phase 10's
# ~29 rows a fold its forests did not split alike, the meta_coef read 1.34e-2
# of the largest apart, the CSVs' probabilities 1.08e-2, the threshold 0 steps
STACK_COEF_BAR = 5e-2  # relative to the largest meta coefficient
STACK_THR_STEPS = 1  # steps of the stack grid (0.0049)
STACK_PROB_BAR = 5e-2
FUSION_BAR = 1e-6  # the CLI on one CSV, card vs CPU: read 0 (weights and p)
SERVE_ALL_BAR = 1e-5  # each served stream against the same model, same card


def _mil_zero_grad_leaves(model) -> set[str]:
    """MILNet's parameters whose gradient is 0 in exact arithmetic in train
    mode: the encoder's MBConv last BatchNorm biases that reach only 1×1
    convolutions and then a BatchNorm (``_zero_grad_leaves``' rule)."""
    class _View:
        backbone = model.encoder

    return {k.replace("backbone.", "encoder.", 1) for k in _zero_grad_leaves(_View)
            if k.startswith("backbone.")}


def _mil_f32_step_check(torch, dev, imgs, origin, y):
    """One f32 MIL step of the same seed-built B0 at MILConfig's widths on
    the card and on the CPU, the same bags (made on each device from one
    BagDraws); returns the gaps ``_f32_step_ok`` reads."""
    from mmtrs_tpu_torch.config import MILConfig
    from mmtrs_tpu_torch.models.mil import BagDraws, make_bags
    from mmtrs_tpu_torch.train.common import normalize_imagenet
    from mmtrs_tpu_torch.train.mil import MILTrainer

    cfg = MILConfig(batch_size=MIL_F32_BAGS)
    draws = BagDraws.draw(cfg.seed, origin, cfg.bag_size, cfg.crop_scale)
    out = {}
    for where in ("cpu", dev):
        tr = MILTrainer(cfg, device=where, dtype=torch.float32, drop_rate=0.0, drop_path=0.0)
        tr.init_state(10)
        bags = normalize_imagenet(make_bags(imgs.to(where), draws, cfg.img_size))
        loss = tr.train_step(bags, torch.from_numpy(y.astype(np.float32)).to(where))
        grads = {k: v.grad.detach().cpu().clone() for k, v in tr.model.named_parameters()}
        state = {k: v.detach().cpu().clone() for k, v in tr.model.state_dict().items()}
        out[str(where)] = (float(loss), grads, state)
    return out["cpu"][0], out[str(dev)][0], _step_gaps(torch, out, dev, _mil_zero_grad_leaves(tr.model))


def _gbdt_table(n: int):
    """n seeded cases of the 9 encoded fields and a label from a logistic
    model of them (the rehearsal's train+val size)."""
    from mmtrs_tpu_torch.serve.choices import encode_fields

    rng = np.random.default_rng(SEED + 80)
    X = np.array([encode_fields(f) for f in _field_rows(n, SEED + 81)], np.float32)
    z = X @ rng.normal(0, 0.8, X.shape[1]).astype(np.float32) + rng.normal(0, 1, n)
    y = (z > np.median(z)).astype(np.float32)
    return X, y


def _forest_gap(a, b, X) -> dict:
    from mmtrs_tpu_torch.models.gbdt import predict_proba

    alike = ((a.split_feat.cpu() == b.split_feat.cpu()) & (a.split_bin.cpu() == b.split_bin.cpu())).all(1)
    pa, pb = (predict_proba(f.to("cpu"), X).double().numpy() for f in (a, b))
    return {"max_dp": float(np.abs(pa - pb).max()), "trees_alike": float(alike.double().mean())}


def _forests_equal(torch, a, b) -> bool:
    return (torch.equal(a.split_feat, b.split_feat) and torch.equal(a.split_bin, b.split_bin)
            and torch.equal(a.leaf_value.nan_to_num(7.0), b.leaf_value.nan_to_num(7.0))
            and np.array_equal(a.val_history, b.val_history) and a.n_trees_used == b.n_trees_used)


def _gbdt_checks(torch, dev, smi: str) -> dict:
    """train_gbdt at stack_tab_like on a seeded GBDT_ROWS × 9 table (80/20
    train/val), twice on the card and once on the CPU from the same draws;
    the seconds a forest, the host syncs of a fit (the same at 700 trees as
    at 20: none inside the tree loop), and the device events of a 20-tree
    fit under torch.profiler."""
    import warnings

    from torch.profiler import ProfilerActivity, profile

    from mmtrs_tpu_torch.config import GBDTConfig
    from mmtrs_tpu_torch.models.gbdt import GBDTDraws, train_gbdt

    cfg = GBDTConfig.stack_tab_like()
    X, y = _gbdt_table(GBDT_ROWS)
    n_tr = int(GBDT_ROWS * 0.8)
    fit = lambda device, c=cfg, d=None: train_gbdt(X[:n_tr], y[:n_tr], c, X_val=X[n_tr:], y_val=y[n_tr:],
                                                    draws=d, device=device)
    draws = GBDTDraws.draw(cfg, n_tr, X.shape[1])
    fit(dev, GBDTConfig(**{**cfg.__dict__, "n_estimators": 5}),
        GBDTDraws(draws.col_keep[:5], draws.row_keep[:5]))  # warm-up
    def syncs(fn):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                result = fn()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return result, sum("synchroniz" in str(w.message) for w in caught)

    out = {"seconds": []}
    forests = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        forest, out["host_syncs"] = syncs(lambda: fit(dev, d=draws))
        forests.append(forest)
        torch.cuda.synchronize()
        out["seconds"].append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    cpu = fit("cpu", d=draws)
    out["cpu_seconds"] = time.perf_counter() - t0
    small = GBDTConfig(**{**cfg.__dict__, "n_estimators": 20})
    d20 = GBDTDraws(draws.col_keep[:20], draws.row_keep[:20])
    out["host_syncs_20_trees"] = syncs(lambda: fit(dev, small, d20))[1]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fit(dev, small, d20)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    out["device_events_per_tree"] = sum(e.count for e in events) / 20
    out["device_ms_per_tree"] = sum(e.self_device_time_total for e in events) / 1e3 / 20
    out["repeat_equal"] = _forests_equal(torch, forests[0], forests[1])
    out["vs_cpu"] = _forest_gap(forests[0], cpu, X)
    _check(out["repeat_equal"], "two stack_tab_like forests grown on the card from the same draws are equal "
           "(splits, leaves, val history, n_trees_used)")
    _check(out["vs_cpu"]["max_dp"] <= GBDT_PROBA_BAR and out["vs_cpu"]["trees_alike"] >= GBDT_ALIKE_BAR,
           f"the card's forest vs the CPU's from the same draws: max |dp| {out['vs_cpu']['max_dp']:.3g} on the "
           f"{GBDT_ROWS} rows (bar {GBDT_PROBA_BAR}), {out['vs_cpu']['trees_alike']:.3f} of the trees split "
           f"alike (bar {GBDT_ALIKE_BAR})")
    _check(out["host_syncs"] == out["host_syncs_20_trees"],
           f"no host sync inside the tree loop: {out['host_syncs']} syncs a 700-tree fit, "
           f"{out['host_syncs_20_trees']} a 20-tree fit (set-up uploads and the val history's one read)")
    print(f"  train_gbdt stack_tab_like ({cfg.n_estimators} trees, depth 5, {cfg.max_bins} bins) on "
          f"{n_tr}+{GBDT_ROWS - n_tr} rows x 9: {out['seconds'][0]:.2f} s and {out['seconds'][1]:.2f} s a forest "
          f"on the card, {out['cpu_seconds']:.2f} s on the CPU; {out['device_events_per_tree']:.0f} device events "
          f"and {out['device_ms_per_tree']:.3f} device ms a tree (20-tree fit under torch.profiler); "
          f"{out['host_syncs']} host syncs a fit; {smi}")
    return out


def _stack_gap(a: dict, b: dict) -> dict:
    coef = np.abs(np.subtract(a["meta_coef"], b["meta_coef"])).max() / np.abs(b["meta_coef"]).max()
    return {"coef": float(coef), "thr_steps": abs(a["thr"] - b["thr"]) / 0.0049}


def _csv_gap(a: Path, b: Path, col: str) -> float:
    from mmtrs_tpu_torch.utils.table import from_csv

    ta, tb = from_csv(a), from_csv(b)
    if ta.columns != tb.columns or len(ta) != len(tb) or list(ta["image_name"]) != list(tb["image_name"]):
        return float("inf")
    return float(np.abs(ta[col] - tb[col]).max()) if len(ta) else 0.0


def phase_rest(torch, dev, smi: str, work: Path, train: dict):
    """Phase 11: on phase 10's table and MM folds, train the MIL stream
    (run_mil_kfold, save_ckpts) into ``work``/mil_v1, grow stack_tab_like
    forests (_gbdt_checks), fit the final stack on the MM and MIL frames
    just trained (card and CPU), train_tab_kfold into ``work``/tab_v1, run
    the fusion CLI twin, and serve a service built from ``work``."""
    from mmtrs_tpu_torch.cli import run_fusion
    from mmtrs_tpu_torch.config import FusionConfig, GBDTConfig, MILConfig
    from mmtrs_tpu_torch.fusion.stack import fit_tab_oof, merge_inner, run_final_stack
    from mmtrs_tpu_torch.models.mil import BagDraws, MILNet, make_bags, make_eval_bag
    from mmtrs_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from mmtrs_tpu_torch.serve.choices import encode_fields
    from mmtrs_tpu_torch.serve.ensembles import build_service_from_weights
    from mmtrs_tpu_torch.train.common import Throughput, normalize_imagenet
    from mmtrs_tpu_torch.train.mil import MILTrainer, run_mil_kfold
    from mmtrs_tpu_torch.train.tabular import predict_tab_ensemble, train_tab_kfold
    from mmtrs_tpu_torch.utils.table import Table, to_csv

    t_phase = time.perf_counter()
    table, imgs = train["table"], train["imgs"]
    cfg = MILConfig(batch_size=MIL_BATCH, n_folds=TRAIN_FOLDS, epochs=1)
    print(f"phase 11: the rest of the rehearsal: run_mil_kfold({cfg.model_name}, bag {cfg.bag_size} at "
          f"{cfg.img_size}, attn {cfg.attn_dim}, batch {cfg.batch_size}, {cfg.n_folds} folds, 1 epoch, bf16) on "
          f"phase 10's {len(table)}-row table -> train_gbdt(stack_tab_like) x3 -> run_final_stack (MM + MIL + "
          f"tab) -> train_tab_kfold -> cli.run_fusion train / infer-batch -> build_service_from_weights")
    seconds, launches = {}, {}

    # make_bags on the card against the CPU, at the trainer's widths
    tv = np.nonzero(table["split"] != "test")[0]
    sel = tv[:MIL_BATCH]
    draws = BagDraws.draw(cfg.seed, table["origin_id"][sel], cfg.bag_size, cfg.crop_scale)
    batch = imgs.index_select(0, torch.from_numpy(sel).to(dev))
    got = make_bags(batch, draws, cfg.img_size)
    want = make_bags(batch.cpu(), draws, cfg.img_size)
    bag_err = float((got.cpu() - want).abs().max())
    _check(got.shape == (MIL_BATCH, cfg.bag_size, cfg.img_size, cfg.img_size, 3) and bag_err <= 1e-4,
           f"make_bags at b{MIL_BATCH} x {cfg.bag_size} x {cfg.img_size}^2 from 512^2, card vs CPU: max |d| "
           f"{bag_err:.3g} (bar 1e-4)")
    del got, want

    mil_dir = work / "mil_v1"
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    stamps = []
    t0 = time.perf_counter()
    mil = run_mil_kfold(imgs, table, cfg, outdir=mil_dir, epochs=1, save_ckpts=True,
                        log=lambda msg: stamps.append(msg))
    torch.cuda.synchronize()
    seconds["run_mil_kfold"] = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches["mil"] = dict(LAUNCHES)
    for msg in stamps:
        print(f"  {msg}")
    names = sorted(p.name for p in mil_dir.iterdir())
    want_names = {f"mil_v1_fold{k}{e}" for k in range(TRAIN_FOLDS) for e in (".npz", ".recipe.json")}
    want_names |= {"oof_val.csv", "pred_test.csv", "summary.json"}
    _check(set(names) == want_names, f"MIL outputs {names}")
    probs = np.concatenate([mil["oof"]["prob"], mil["test"]["prob"]])
    _check(bool(np.isfinite(probs).all()) and probs.min() >= 0 and probs.max() <= 1,
           f"MIL OOF and test probabilities finite in [0, 1]: {len(probs)} rows; summary "
           f"{json.dumps(mil['summary'])}")
    ref = MILTrainer(cfg, device="cpu")
    for k, st in enumerate(mil["states"]):
        moved = sum(not torch.equal(st["model"][n].cpu(), ref._init[n]) for n, _ in ref.model.named_parameters())
        _check(moved > 0, f"MIL fold {k}: {moved} parameter tensors changed")

    # the bf16 MIL step, timed one by one
    trainer = MILTrainer(cfg)
    trainer.init_state(MIL_TIMED_STEPS)
    y_d = torch.from_numpy(table["y_majority"].astype(np.float32)).to(dev)
    rng = np.random.default_rng(SEED + 90)
    thr = Throughput()
    bag_ms, step_ms = [], []
    for i in range(MIL_TIMED_STEPS):
        s = rng.choice(tv, cfg.batch_size, replace=False)
        s_d = torch.from_numpy(s).to(dev)
        torch.cuda.synchronize()
        thr.start()
        t0 = time.perf_counter()
        bags = trainer.train_bags(imgs.index_select(0, s_d), cfg.seed, table["origin_id"][s])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        trainer.train_step(bags, y_d[s_d])
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        thr.stop(cfg.batch_size)
        bag_ms.append((t1 - t0) * 1e3)
        step_ms.append((t2 - t1) * 1e3)
    mil_step = {"bags_ms": float(np.median(bag_ms[1:])), "step_ms": float(np.median(step_ms[1:])),
                "first_step_ms": step_ms[0], "bags_per_sec": thr.imgs_per_sec, "peak_gb": peak / 1e9}
    print(f"  bf16 MIL step at b{cfg.batch_size} x {cfg.bag_size} x {cfg.img_size}^2 (median of "
          f"{MIL_TIMED_STEPS - 1} after the first, host clock, each ending in a synchronise): make_bags + "
          f"normalise {mil_step['bags_ms']:.2f} ms, forward + backward + AdamW {mil_step['step_ms']:.2f} ms "
          f"(first {step_ms[0]:.2f} ms); {thr.imgs_per_sec:.2f} bags/s over all {MIL_TIMED_STEPS}; peak memory "
          f"of run_mil_kfold {peak / 1e9:.2f} GB; {smi}")
    del trainer

    # one f32 MIL step on the card against the CPU
    t0 = time.perf_counter()
    s = tv[:MIL_F32_BAGS]
    lc, lg, gaps = _mil_f32_step_check(torch, dev, imgs.index_select(0, torch.from_numpy(s).to(dev)).cpu(),
                                       table["origin_id"][s], table["y_majority"][s])
    seconds["mil_f32_step_check"] = time.perf_counter() - t0
    _check(_f32_step_ok(gaps),
           f"f32 B0 MIL step at {MIL_F32_BAGS} bags of {cfg.bag_size} at {cfg.img_size}^2, card vs CPU: loss "
           f"{lg:.7f} vs {lc:.7f} ({gaps['loss']:.3g} relative, bar {F32_LOSS_BAR}); gradients {gaps['grad']:.3g} "
           f"of their leaf's max (bar {F32_GRAD_BAR}), the zero-gradient biases {gaps['zero_grad_card']:.3g} "
           f"(card) and {gaps['zero_grad_cpu']:.3g} (CPU) of the largest (bar {F32_ZERO_GRAD_BAR}); running "
           f"statistics {gaps['stats']:.3g} relative (bar {F32_STATS_BAR}); parameters after AdamW "
           f"{gaps['params_firm']:.3g} where the gradient is firm (bar {F32_PARAM_BAR})")

    # the GBDT at the recipe's widths
    t0 = time.perf_counter()
    gbdt = _gbdt_checks(torch, dev, smi)
    seconds["gbdt"] = time.perf_counter() - t0

    # the final stack on the frames phases 10-11 trained, card and CPU
    mm_oof, mm_test = train["mm"]["oof"], train["mm"]["test"]
    mil_oof, mil_test = mil["oof"], mil["test"]
    fcfg = FusionConfig(n_folds=TRAIN_FOLDS, thr_mode="max_acc")  # scripts/rehearsal.py:233
    stack = {}
    for where in (None, "cpu"):
        t0 = time.perf_counter()
        out = work / ("stack" if where is None else "stack_cpu")
        stack[where or "card"] = run_final_stack(table, mm_oof, mm_test, mil_oof, mil_test, outdir=out, cfg=fcfg,
                                                 tab_cfg=GBDTConfig.stack_tab_like(), device=where)
        seconds[f"run_final_stack_{where or 'card'}"] = time.perf_counter() - t0
    sg = _stack_gap(stack["card"], stack["cpu"])
    csv_gap = max(_csv_gap(work / "stack" / n, work / "stack_cpu" / n, "prob") for n in ("stack_oof.csv", "stack_test.csv"))
    _check(sg["coef"] <= STACK_COEF_BAR and sg["thr_steps"] <= STACK_THR_STEPS + 1e-6 and csv_gap <= STACK_PROB_BAR,
           f"run_final_stack card vs CPU: meta_coef {stack['card']['meta_coef']} vs {stack['cpu']['meta_coef']} "
           f"({sg['coef']:.3g} of the largest, bar {STACK_COEF_BAR}), thr {stack['card']['thr']} vs "
           f"{stack['cpu']['thr']} ({sg['thr_steps']:.2f} grid steps, bar {STACK_THR_STEPS}); the written CSVs' "
           f"probabilities {csv_gap:.3g} apart (bar {STACK_PROB_BAR}); summary {json.dumps(stack['card'])}")

    # train_tab_kfold into tab_v1, as the service reads it
    t0 = time.perf_counter()
    tab = train_tab_kfold(table, work / "tab_v1", n_folds=N_FOLDS)
    torch.cuda.synchronize()
    seconds["train_tab_kfold"] = time.perf_counter() - t0
    _check(len(tab["forests"]) == N_FOLDS and len(list((work / "tab_v1").glob("tab_fold*.npz"))) == N_FOLDS,
           f"train_tab_kfold wrote {N_FOLDS} forests")

    # the fusion CLI twin on a CSV of the three streams, card and CPU
    tab_oof, tab_test = fit_tab_oof(table, folds=TRAIN_FOLDS)
    rows = []
    for part, (t, m, l) in (("train", (tab_oof, mm_oof, mil_oof)), ("test", (tab_test, mm_test, mil_test))):
        ren = lambda x, name: Table({("prob_" + name if c == "prob" else c): x[c] for c in x.columns})
        j = merge_inner(merge_inner(ren(t, "tab"), ren(m, "mm")), ren(l, "mil"))
        rows.append(Table({"image_name": j["image_name"], "y_majority": j["y"].astype(np.int64),
                           "split": [part] * len(j), "prob_tab": j["prob_tab"], "prob_mm": j["prob_mm"],
                           "prob_mil": j["prob_mil"]}))
    csv = work / "streams.csv"
    to_csv(Table.concat(rows), csv)
    t0 = time.perf_counter()
    for where, d in (("cuda", "fusion"), ("cpu", "fusion_cpu")):
        code = run_fusion.main(["train", "--data", str(csv), "--out_dir", str(work / d), "--device", where])
        code |= run_fusion.main(["infer-batch", "--fusion_dir", str(work / d), "--data", str(csv),
                                 "--out_dir", str(work / d)])
        _check(code == 0, f"cli.run_fusion train + infer-batch on {where}")
    seconds["fusion_cli"] = time.perf_counter() - t0
    fa, fb = (json.loads((work / d / "fusion_summary.json").read_text()) for d in ("fusion", "fusion_cpu"))
    wgap = max(float(np.abs(np.subtract(fa[p]["weights"], fb[p]["weights"])).max()) for p in ("stack", "blend"))
    hyb = _csv_gap(work / "fusion" / "hybrid_test_predictions.csv", work / "fusion_cpu" / "hybrid_test_predictions.csv",
                   "p_indirect")
    _check(fa["choice"] == fb["choice"] and fa["threshold"] == fb["threshold"] and wgap <= FUSION_BAR
           and hyb <= FUSION_BAR,
           f"fusion CLI card vs CPU on {len(Table.concat(rows))} rows of 3 streams: choice {fa['choice']} / "
           f"{fb['choice']}, threshold {fa['threshold']} / {fb['threshold']}, weights {wgap:.3g} apart, "
           f"hybrid_test_predictions.csv p {hyb:.3g} apart (bar {FUSION_BAR})")

    # serve what phases 10-11 trained: MM, MIL, Tab and the Stacker from work
    reset_launches()
    t0 = time.perf_counter()
    svc = build_service_from_weights(work)
    torch.cuda.synchronize()
    seconds["service_build"] = time.perf_counter() - t0
    nets = []
    for st in mil["states"]:
        net = MILNet(cfg.model_name, cfg.attn_dim).to(dev)
        net.load_state_dict(st["model"])
        nets.append(net.eval())
    fields = train["fields"]
    tab_p = float(predict_tab_ensemble(tab["forests"], Table(
        {c: [v] for c, v in zip(("depth", "width", "enamel_cracks", "occlusal_load", "carious_lesion",
                                  "opposing_type", "adjacent_teeth", "age_range", "cervical_lesion"),
                                 encode_fields(fields))}))[0])
    worst = {"prob_mm": 0.0, "prob_mil": 0.0, "prob_tab": 0.0}
    mm_trainer, mm_folds = train["trainer"], train["mm"]["folds"]
    t0 = time.perf_counter()
    for img in train["uploads"]:
        r = svc.predict_one(img, fields=fields)
        if "error" in r or set(r["streams"]) != set(worst):
            raise AssertionError(f"request {img.shape}: {r.get('error', r.get('streams'))}")
        x = torch.from_numpy(r["processed_image"]).to(dev)[None]
        raw9 = np.float32(encode_fields(fields))[None]
        p_mm = float(np.mean([mm_trainer.predict_proba(f, x, raw9)[0] for f in mm_folds]))
        with torch.no_grad():
            bag = normalize_imagenet(make_eval_bag(x))[None]
            logit = torch.stack([n(bag)[0][0] for n in nets]).double().mean().item()
        p_mil = 1.0 / (1.0 + np.exp(-logit))
        for k, v in (("prob_mm", p_mm), ("prob_mil", p_mil), ("prob_tab", tab_p)):
            worst[k] = max(worst[k], abs(r["streams"][k] - v))
        _check(0.0 <= r["p_indirect"] <= 1.0, f"served p {r['p_indirect']}")
    seconds["serve"] = time.perf_counter() - t0
    launches["serve"] = dict(LAUNCHES)
    _check(max(worst.values()) <= SERVE_ALL_BAR,
           f"a service built from the folders the port trained (MM x{TRAIN_FOLDS}, MIL x{TRAIN_FOLDS}, Tab x{N_FOLDS}, "
           f"the Stacker on both OOF CSVs) on {len(train['uploads'])} uploads with fields: each stream against "
           f"its trained model on the same processed image, max |dp| {json.dumps(worst)} (bar {SERVE_ALL_BAR}); "
           f"launches {launches['serve']}")
    seconds["phase"] = time.perf_counter() - t_phase
    print("  phase 11 seconds: " + ", ".join(f"{k} {v:.2f}" for k, v in seconds.items()) + f"; {smi}")
    print("  phase 11 kernel launches: " + json.dumps(launches))
    return {"launches": launches, "seconds": seconds, "mil_step": mil_step, "gbdt": gbdt,
            "stack": stack["card"], "mil_summary": mil["summary"]}


# phase 12: the vision trainers on the card at the recipes' widths
# (run_train_images.py:79 and its hard default; train/kfold.py:110;
# ProgressiveConfig's B4 stages), depth cut to phase 10's 24 cases x 3 rows,
# 1-2 epochs, 2 folds, 1 seed
VISION_HARD = ("efficientnet_b3", 512, 16, "legacy")  # run_train_images.py's hard default, --aug legacy
VISION_SOFT = ("convnext_tiny", 512, 16, "ten")  # its soft default (run_train_images.py:79), --aug ten
PROG_MODEL = "efficientnet_b4"  # ProgressiveConfig's
PROG_STAGES = ((384, 1, 16, 3e-4), (512, 1, 8, 1e-4))  # its stages, 1 epoch each
KFOLD_MODEL = ("convnextv2_base", 512, 8)  # KFoldConfig's
STREAM_TREES = 200  # the xgb_like / lgbm_like forests of (b), cut from 1200 / their recipe's
VISION_CHECK_ROWS = 8  # images a checkpoint predicts on the card and on the CPU
VISION_CKPT_BAR = 1e-5  # max |dp| of a served checkpoint (f32), card vs CPU
FINALIZE_BAR = 1e-6  # finalize_mm_from_ckpts vs phase 10's run_mm_kfold, same card
F32_CONVNEXT = ("convnext_tiny", "convnextv2_base")
F32_CONVNEXT_SIZE = 224  # a spatial cut only: the CPU pays for the widths
F32_CONVNEXT_BATCH = 2
VISION_TIMED_STEPS = 6
VISION_TRAIN_KERNELS = {"legacy": LEGACY_TABLE_KERNELS, "ten": ("resample_rows",)}


def _randomize_convnext_(torch, net, seed: int):
    """LayerScale gammas and GRN gamma/beta to seeded values of order 0.3,
    so each block is far from the identity it starts as."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in net.named_parameters():
            if name.endswith((".gamma", ".beta")):
                p.copy_(torch.randn(p.shape, generator=gen) * 0.3)
    return net


def _convnext_f32_step_check(torch, dev, name: str, imgs):
    """One f32 hard train step (CE, no dropout or drop-path) of ``name`` at
    F32_CONVNEXT_SIZE, batch F32_CONVNEXT_BATCH, from the same seeded init
    (LayerScale and GRN randomised) on the card and on the CPU → the loss
    pair and the gaps ``_f32_step_ok`` reads (no BatchNorm, so no running
    statistics and no zero-gradient leaves)."""
    from mmtrs_tpu_torch.config import VisionTrainConfig
    from mmtrs_tpu_torch.models.backbones.efficientnet import lecun_init_
    from mmtrs_tpu_torch.models.backbones.factory import create_model
    from mmtrs_tpu_torch.train.vision import VisionTrainer

    cfg = VisionTrainConfig(model_name=name, img_size=F32_CONVNEXT_SIZE, task="hard", batch_size=F32_CONVNEXT_BATCH,
                            drop_rate=0.0, drop_path=0.0, bf16=False)
    net = lecun_init_(create_model(name, num_classes=2, dtype=torch.float32), torch.Generator().manual_seed(SEED + 100))
    init = _randomize_convnext_(torch, net, SEED + 101).state_dict()
    y = torch.arange(F32_CONVNEXT_BATCH) % 2
    out = {}
    for where in ("cpu", dev):
        tr = VisionTrainer(cfg, device=where, init=init)
        tr.init_state(10)
        x = tr._prep_images(imgs.to(where), False, 0)
        loss = tr.train_step(x, y.to(where))
        grads = {k: v.grad.detach().cpu().clone() for k, v in tr.model.named_parameters()}
        state = {k: v.detach().cpu().clone() for k, v in tr.model.state_dict().items()}
        out[str(where)] = (float(loss), grads, state)
        del tr
    return out["cpu"][0], out[str(dev)][0], _step_gaps(torch, out, dev)


def _timed_steps(torch, prep, step, batch: int, n: int = VISION_TIMED_STEPS) -> dict:
    """``n`` steps timed one by one on the host clock, a synchronise after
    the prep and after the step; medians after the first."""
    from mmtrs_tpu_torch.train.common import Throughput

    thr = Throughput()
    prep_ms, step_ms = [], []
    torch.cuda.reset_peak_memory_stats()
    for i in range(n):
        torch.cuda.synchronize()
        thr.start()
        t0 = time.perf_counter()
        args = prep(i)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        step(*args)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        thr.stop(batch)
        prep_ms.append((t1 - t0) * 1e3)
        step_ms.append((t2 - t1) * 1e3)
    return {"prep_ms": float(np.median(prep_ms[1:])), "step_ms": float(np.median(step_ms[1:])),
            "first_step_ms": step_ms[0], "imgs_per_sec": thr.imgs_per_sec,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def phase_vision(torch, dev, smi: str, work: Path, train: dict):
    """Phase 12: on phase 10's table and images, (a) the CLI twin
    cli.run_train_images (hard and soft) from JPEGs it writes, its
    checkpoints served card vs CPU; (b) collect_base_preds on them and on
    two forests; (c) train_progressive; (d) run_hard_kfold with the freeze,
    MixUp, EMA and accumulation, then run_threshold_sweep; (e)
    finalize_mm_from_ckpts on phase 10's folds; (f) an f32 ConvNeXt step card
    vs CPU; (g) bf16 steps timed."""
    from mmtrs_tpu_torch.cli import run_train_images
    from mmtrs_tpu_torch.config import GBDTConfig, ProgressiveConfig, ProgressiveStage, VisionTrainConfig
    from mmtrs_tpu_torch.data.splits import grouped_train_test_split, stratified_group_kfold
    from mmtrs_tpu_torch.eval.threshold_sweep import run_threshold_sweep
    from mmtrs_tpu_torch.fusion.streams import _predict_vision_ckpt, collect_base_preds
    from mmtrs_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from mmtrs_tpu_torch.train.kfold import KFoldConfig, KFoldHardTrainer, apply_mixup_cutmix, run_hard_kfold
    from mmtrs_tpu_torch.train.mm import finalize_mm_from_ckpts
    from mmtrs_tpu_torch.train.progressive import progressive_ensemble_probs, train_progressive
    from mmtrs_tpu_torch.train.tabular import train_lgbm_like, train_xgb_like
    from mmtrs_tpu_torch.train.vision import VisionData, VisionTrainer
    from mmtrs_tpu_torch.utils.images import save_jpeg
    from mmtrs_tpu_torch.utils.table import to_csv

    t_phase = time.perf_counter()
    table, imgs = train["table"].copy(), train["imgs"]
    rng = np.random.default_rng(SEED + 110)
    table["weight"] = rng.uniform(0.5, 1.0, len(table))  # consensus weights of the soft task and the forests
    print(f"phase 12: the vision trainers on phase 10's {len(table)}-row table: cli.run_train_images "
          f"({VISION_HARD[0]} hard {VISION_HARD[3]}, {VISION_SOFT[0]} soft {VISION_SOFT[3]}, {VISION_HARD[1]}^2 "
          f"b{VISION_HARD[2]}, 1 epoch) -> collect_base_preds -> train_progressive({PROG_MODEL}, {PROG_STAGES}) -> run_hard_kfold("
          f"{KFOLD_MODEL[0]} {KFOLD_MODEL[1]}^2 b{KFOLD_MODEL[2]}, 2 folds x 2 epochs, freeze 1, MixUp, EMA .99, "
          f"accum 2) -> run_threshold_sweep -> finalize_mm_from_ckpts -> f32 steps -> timed bf16 steps")
    seconds, launches, peaks = {}, {}, {}
    tv = np.nonzero(table["split"] != "test")[0]
    te = np.nonzero(table["split"] == "test")[0]
    take = lambda idx: imgs.index_select(0, torch.from_numpy(np.asarray(idx)).to(dev))

    # (a) the CLI twin from JPEGs and a CSV written by the port's codec
    t0 = time.perf_counter()
    img_dir, csv = work / "vision_images", work / "vision_meta.csv"
    for i, name in enumerate(table["image_name"]):
        save_jpeg(img_dir / str(name), imgs[i])
    to_csv(table.select(["image_name", "y_majority", "p_indirect", "weight", "origin_id", "aug_idx", "split"]), csv)
    seconds["jpegs"] = time.perf_counter() - t0
    check = torch.from_numpy(np.stack([imgs[int(i)].cpu().numpy() for i in te[:VISION_CHECK_ROWS]]))
    ckpt_gap = {}
    for task, (model, size, bs, aug) in (("hard", VISION_HARD), ("soft", VISION_SOFT)):
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        code = run_train_images.main(["--task", task, "--model", model, "--img_size", str(size), "--data", str(csv),
                                      "--image_dir", str(img_dir), "--epochs", "1", "--batch_size", str(bs),
                                      "--aug", aug, "--out", str(work / "vision" / task)])
        torch.cuda.synchronize()
        seconds[f"cli_{task}"] = time.perf_counter() - t0
        launches[f"cli_{task}"] = dict(LAUNCHES)
        peaks[f"cli_{task}"] = torch.cuda.max_memory_allocated() / 1e9
        want = VISION_TRAIN_KERNELS[aug]
        _check(code == 0 and all(launches[f"cli_{task}"][k] > 0 for k in want),
               f"cli.run_train_images --task {task} --model {model} --aug {aug}: exit {code}, launches "
               f"{launches[f'cli_{task}']} (each of {want} > 0)")
        base = work / "vision" / task / f"vision_{task}_best"
        t0 = time.perf_counter()
        p_card = _predict_vision_ckpt(base, check.to(dev))
        p_cpu = _predict_vision_ckpt(base, check, device="cpu")
        seconds[f"ckpt_{task}_card_cpu"] = time.perf_counter() - t0
        ckpt_gap[task] = float(np.abs(p_card - p_cpu).max())
        _check(ckpt_gap[task] <= VISION_CKPT_BAR and np.isfinite(p_card).all(),
               f"vision_{task}_best ({model}, npz + recipe) served through _predict_vision_ckpt (f32, hflip TTA) on "
               f"{len(check)} images, card vs CPU: max |dp| {ckpt_gap[task]:.3g} (bar {VISION_CKPT_BAR})")
    summaries = {t: json.loads((work / "vision" / t / f"{t}_summary.json").read_text()) for t in ("hard", "soft")}
    print(f"  CLI summaries: " + json.dumps({t: {"thr": v["thr"], "history": v["history"]} for t, v in summaries.items()}))

    # (b) the four streams from what (a) wrote and two forests
    t0 = time.perf_counter()
    trees = lambda c: GBDTConfig(**{**c.__dict__, "n_estimators": STREAM_TREES})
    train_xgb_like(table, work / "ml", cfg=trees(GBDTConfig()))
    train_lgbm_like(table, work / "ml", cfg=trees(GBDTConfig.lgbm_like()))
    seconds["forests"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    streams = collect_base_preds(table.take(tv), table.take(te), take(tv), take(te), weight_dir=work / "vision",
                                 ml_dir=work / "ml")
    seconds["collect_base_preds"] = time.perf_counter() - t0
    shapes = {s: {k: None if v is None else len(v) for k, v in d.items()} for s, d in streams.items()}
    _check(all(v is not None and np.isfinite(v).all() and len(v) == (len(tv) if s == "val" else len(te))
               for s, d in streams.items() for v in d.values()),
           f"collect_base_preds on the card: all four streams found and finite, rows {shapes}")

    # (c) the progressive trainer, one seed, legacy augmentation
    sub = table.take(tv)
    tr_rel, va_rel = grouped_train_test_split(sub, 0.15, 42)
    data = lambda rel: VisionData(images=take(tv[rel]), y=np.asarray(sub["y_majority"])[rel].astype(int),
                                  origin_id=np.asarray(sub["origin_id"])[rel], aug_idx=np.asarray(sub["aug_idx"])[rel])
    pcfg = ProgressiveConfig(model_name=PROG_MODEL, stages=tuple(ProgressiveStage(*s) for s in PROG_STAGES), seeds=(42,))
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    states = train_progressive(pcfg, data(tr_rel), data(va_rel), aug_preset="legacy", log=lambda m: None)
    p_prog = progressive_ensemble_probs(states, data(va_rel))
    torch.cuda.synchronize()
    seconds["progressive"] = time.perf_counter() - t0
    launches["progressive"] = dict(LAUNCHES)
    peaks["progressive"] = torch.cuda.max_memory_allocated() / 1e9
    _check(len(p_prog) == len(va_rel) and np.isfinite(p_prog).all() and p_prog.min() >= 0 and p_prog.max() <= 1
           and all(launches["progressive"][k] > 0 for k in LEGACY_TABLE_KERNELS),
           f"train_progressive ({len(tr_rel)} train / {len(va_rel)} val rows) and progressive_ensemble_probs: "
           f"{len(p_prog)} probabilities in [0, 1]; launches {launches['progressive']}")
    del states

    # (d) the k-fold trainer with the freeze, MixUp, EMA and accumulation
    kcfg = KFoldConfig(model_name=KFOLD_MODEL[0], img_size=KFOLD_MODEL[1], batch_size=KFOLD_MODEL[2], n_folds=2,
                       epochs=2, freeze_epochs=1, use_mixup=True, ema_decay=0.99, grad_accum=2)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    kf = run_hard_kfold(imgs, table, kcfg, outdir=work / "kfold", log=lambda m: None)
    torch.cuda.synchronize()
    seconds["run_hard_kfold"] = time.perf_counter() - t0
    peaks["run_hard_kfold"] = torch.cuda.max_memory_allocated() / 1e9
    moved = [f["frozen_moved"] for f in kf["fits"]]
    _check(all(m == [] for m in moved),
           f"run_hard_kfold({kcfg.model_name}, freeze_epochs 1): every backbone parameter bit-equal before and after "
           f"the frozen epoch in each fold (moved: {moved}); summary {json.dumps({k: kf[k] for k in ('folds', 'mean_val_auc', 'test_auc')})}")
    y = np.asarray(table["y_majority"]).astype(int)
    probe = KFoldHardTrainer(kcfg, init=kf["fits"][0]["state"]["model"])
    logit = lambda p: np.log(np.clip(p, 1e-7, 1 - 1e-7) / (1 - np.clip(p, 1e-7, 1 - 1e-7)))
    lv, yv, lt = [], [], []
    for (_, va_rel), fit in zip(stratified_group_kfold(y[tv], np.asarray(table["origin_id"])[tv], 2, kcfg.seed),
                                kf["fits"]):
        lv.append(logit(probe.predict_proba(fit["state"], take(tv[va_rel]))))
        yv.append(y[tv[va_rel]])
        lt.append(logit(probe.predict_proba(fit["state"], take(te))))
    sweep = run_threshold_sweep(lv, yv, lt, y[te], outdir=work / "sweep", make_plots=False)
    _check(all(np.isfinite(r["T"]) and r["T"] > 0 and 0 <= r["thr"] <= 1 for r in sweep["folds"]),
           f"run_threshold_sweep on the folds' logits: {json.dumps(sweep['aggregate'])}")
    del probe, kf

    # (e) finalize phase 10's MM folds from their npz
    t0 = time.perf_counter()
    fin = finalize_mm_from_ckpts(imgs, train["table"], work / "mm_dualtask_v1", train["cfg"], outdir=work / "mm_final",
                                 log=lambda m: None)
    seconds["finalize"] = time.perf_counter() - t0
    fin_gap = max(float(np.abs(fin[k]["prob"] - train["mm"][k]["prob"]).max()) for k in ("oof", "test"))
    _check(fin_gap <= FINALIZE_BAR, f"finalize_mm_from_ckpts vs phase 10's run_mm_kfold OOF and test "
           f"probabilities: max |dp| {fin_gap:.3g} (bar {FINALIZE_BAR}); summary {json.dumps(fin['summary'])}")

    # (f) one f32 ConvNeXt step, card vs CPU
    f32 = {}
    for name in F32_CONVNEXT:
        t0 = time.perf_counter()
        lc, lg, gaps = _convnext_f32_step_check(torch, dev, name, take(tv[:F32_CONVNEXT_BATCH]).cpu())
        seconds[f"f32_{name}"] = time.perf_counter() - t0
        f32[name] = gaps
        _check(_f32_step_ok(gaps),
               f"f32 {name} train step at b{F32_CONVNEXT_BATCH} {F32_CONVNEXT_SIZE}^2 (LayerScale and GRN randomised), "
               f"card vs CPU: loss {lg:.7f} vs {lc:.7f} ({gaps['loss']:.3g} relative, bar {F32_LOSS_BAR}); gradients "
               f"{gaps['grad']:.3g} of their leaf's max (bar {F32_GRAD_BAR}); parameters after AdamW "
               f"{gaps['params_firm']:.3g} where the gradient is firm (bar {F32_PARAM_BAR})")

    # (g) bf16 steps timed: B3 hard, ConvNeXt-tiny soft, ConvNeXtV2-base k-fold
    steps = {}
    y_d = torch.from_numpy(y).to(dev)
    p_d = torch.from_numpy(np.asarray(table["p_indirect"], np.float32)).to(dev)
    w_d = torch.from_numpy(np.asarray(table["weight"], np.float32)).to(dev)
    origin, aug_idx = np.asarray(table["origin_id"]), np.asarray(table["aug_idx"])
    pick = np.random.default_rng(SEED + 111)
    for task, (model, size, bs, aug) in (("hard", VISION_HARD), ("soft", VISION_SOFT)):
        tr = VisionTrainer(VisionTrainConfig(model_name=model, img_size=size, task=task, batch_size=bs),
                           aug_preset=aug)
        tr.init_state(VISION_TIMED_STEPS)
        cw = torch.ones(2, device=dev)
        sels = [pick.choice(tv, bs, replace=False) for _ in range(VISION_TIMED_STEPS)]

        def prep(i, tr=tr, sels=sels):
            s = sels[i]
            sd = torch.from_numpy(s).to(dev)
            return tr._prep_images(imgs.index_select(0, sd), True, 42, origin[s], aug_idx[s]), sd

        def step(x, sd, tr=tr, task=task):
            if task == "hard":
                tr.train_step(x, y_d[sd], class_weights=cw)
            else:
                tr.train_step(x, y_d[sd], p_d[sd], w_d[sd])

        steps[f"{model} {task}"] = _timed_steps(torch, prep, step, bs)
        del tr
    model, size, bs = KFOLD_MODEL
    kt = KFoldHardTrainer(KFoldConfig(model_name=model, img_size=size, batch_size=bs, bf16=True, use_mixup=True))
    kt.init_state(VISION_TIMED_STEPS)
    sels = [pick.choice(tv, bs, replace=False) for _ in range(VISION_TIMED_STEPS)]

    def kprep(i):
        sd = torch.from_numpy(sels[i]).to(dev)
        return apply_mixup_cutmix(kt._prep(imgs.index_select(0, sd)), y_d[sd].float(), kt._mix_draws(i, bs))

    steps[f"{model} kfold"] = _timed_steps(torch, kprep, kt.train_step, bs)
    del kt
    torch.cuda.empty_cache()
    for name, st in steps.items():
        print(f"  bf16 {name} step at {size}^2 (median of {VISION_TIMED_STEPS - 1} after the first, host clock, each "
              f"ending in a synchronise): prep {st['prep_ms']:.2f} ms, forward + backward + AdamW {st['step_ms']:.2f} ms "
              f"(first {st['first_step_ms']:.2f} ms); {st['imgs_per_sec']:.2f} imgs/s over all {VISION_TIMED_STEPS}; "
              f"peak {st['peak_gb']:.2f} GB; {smi}")
    seconds["phase"] = time.perf_counter() - t_phase
    print(f"  phase 12 served checkpoints card vs CPU max |dp|: {json.dumps(ckpt_gap)}; finalize {fin_gap:.3g}; f32 "
          f"ConvNeXt steps: " + json.dumps({n: {k: g[k] for k in ('loss', 'grad', 'params_firm')} for n, g in f32.items()}))
    print("  phase 12 peak GB: " + json.dumps({k: round(v, 2) for k, v in peaks.items()}))
    print("  phase 12 seconds: " + ", ".join(f"{k} {v:.2f}" for k, v in seconds.items()) + f"; {smi}")
    print("  phase 12 kernel launches: " + json.dumps(launches))
    return {"launches": launches, "seconds": seconds, "steps": steps, "peaks": peaks, "ckpt_gap": ckpt_gap,
            "finalize_gap": fin_gap, "f32": f32}


# 26 cases: the fewest from 24 up whose grouped test split (seed 42, 0.19) holds both labels, so every
# AUC of the summary is finite (at 24 and 25 the test cases are all negative)
REHEARSAL_SMOKE = ["--n", "26", "--n_aug", "2", "--folds", "2", "--mm_epochs", "1", "--mil_epochs", "1"]
REPLAY_FLAGS = ("--n", "--n_aug", "--folds", "--raw_size")  # what stack_from_streams shares with the run
LAST_TEETH = 8  # run_augment*'s folder: JPEG, PNG and BMP, one phone-shaped
LAST_TARGET = 6  # run_augment's target rows a class (labels 5 / 3: 1 + 3 children)
LAST_SIMPLE_N = 3
EVAL_VISION_BAR = 1e-6  # cli.eval_vision vs _predict_vision_ckpt on the same decoded images, same card
REHEARSAL_KERNELS = SERVE_KERNELS + LEGACY_TABLE_KERNELS  # preprocess_batch, the legacy table, randaug
AUGMENT_CLI_KERNELS = {"strong": ("resample_rows", "photometric"), "medium": ("resample_rows",),
                       "simple": ("resample_rows",)}


def _bmp_bytes(img: np.ndarray) -> bytes:
    """A 24-bit bottom-up BI_RGB BMP of u8 [H, W, 3] (rows padded to 4 bytes)."""
    import struct

    h, w, _ = img.shape
    stride = (w * 3 + 3) // 4 * 4
    rows = np.zeros((h, stride), np.uint8)
    rows[:, : w * 3] = img[::-1, :, ::-1].reshape(h, w * 3)
    head = struct.pack("<2sIHHI", b"BM", 54 + rows.size, 0, 0, 54)
    info = struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, rows.size, 2835, 2835, 0, 0)
    return head + info + rows.tobytes()


def _finite_tree(x) -> bool:
    if isinstance(x, dict):
        return all(_finite_tree(v) for v in x.values())
    if isinstance(x, list):
        return all(_finite_tree(v) for v in x)
    return not isinstance(x, float) or np.isfinite(x)


def phase_last_entry_points(torch, dev, smi: str, work: Path, train: dict):
    """Phase 13: the pipeline's last entry points on the card. (a) The
    rehearsal twin at its widths (MM B4 380 b16, MIL B0 bag 12 at 320,
    stack_tab_like), depth cut to 26 cases x 3 rows, 2 folds, 1 epoch, then
    stack_from_streams on a copy of its folder; (b) run_augment (strong,
    medium) and run_augment_simple on a folder of JPEG, PNG and BMP teeth;
    (c) both split CLIs on phase 10's table; (d) eval_vision on phase 12's
    vision_hard_best; (e) evaluate_models --which blend on phase 12's
    forests (xgb_like Platt-calibrated)."""
    import shutil

    from mmtrs_tpu_torch.cli import (eval_vision, evaluate_models, make_balanced_splits, make_group_splits, rehearsal,
                                     run_augment, run_augment_simple, stack_from_streams)
    from mmtrs_tpu_torch.cli.run_train_images import load_vision_dataset
    from mmtrs_tpu_torch.data.splits import assert_no_group_leakage
    from mmtrs_tpu_torch.fusion.streams import _predict_vision_ckpt
    from mmtrs_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from mmtrs_tpu_torch.synth import synth_teeth
    from mmtrs_tpu_torch.utils.codec import encode_png
    from mmtrs_tpu_torch.utils.io import read_table
    from mmtrs_tpu_torch.utils.images import save_jpeg
    from mmtrs_tpu_torch.utils.table import Table, to_csv

    t_phase = time.perf_counter()
    print(f"phase 13: the last entry points: cli.rehearsal {' '.join(REHEARSAL_SMOKE)} at its widths -> "
          f"cli.stack_from_streams; cli.run_augment (strong, medium), cli.run_augment_simple; the split CLIs; "
          f"cli.eval_vision; cli.evaluate_models --which blend")
    seconds, launches = {}, {}
    quiet = lambda *a, **k: None

    # (a) the rehearsal twin and its replay
    run_dir = work / "rehearsal"
    reset_launches()
    t0 = time.perf_counter()
    code = rehearsal.main(REHEARSAL_SMOKE + ["--out", str(run_dir)], log=quiet)
    torch.cuda.synchronize()
    seconds["rehearsal"] = time.perf_counter() - t0
    launches["rehearsal"] = dict(LAUNCHES)
    rec = json.loads((run_dir / "summary.json").read_text())
    want = json.loads((ROOT / "results" / "rehearsal_r5" / "summary.json").read_text())
    missing = sorted(set(want) - set(rec)) + sorted(f"timings.{k}" for k in set(want["timings"]) - set(rec["timings"]))
    numbers = {k: rec[k] for k in ("timings", "streams", "stack", "best_stream_test_auc")}
    n_rows = 3 * int(REHEARSAL_SMOKE[1])
    _check(code == 0 and not missing and _finite_tree(numbers) and rec["n_rows_augmented"] == n_rows
           and rec["config"]["mm"]["img"] == 380 and rec["config"]["mil"]["bag"] == 12,
           f"cli.rehearsal: exit {code}, every summary key present (missing {missing}), all numbers finite, {n_rows} rows; "
           f"stack {json.dumps(rec['stack'])}, platform {rec['platform']!r}, timings {json.dumps(rec['timings'])}")
    _check(all(launches["rehearsal"][k] > 0 for k in REHEARSAL_KERNELS),
           f"the rehearsal launched {REHEARSAL_KERNELS}: {launches['rehearsal']}")
    replay = work / "replay"
    shutil.copytree(run_dir, replay)
    t0 = time.perf_counter()
    flags = [x for k, v in zip(REHEARSAL_SMOKE[::2], REHEARSAL_SMOKE[1::2]) if k in REPLAY_FLAGS for x in (k, v)]
    code = stack_from_streams.main(["--dir", str(replay)] + flags, log=quiet)
    seconds["stack_from_streams"] = time.perf_counter() - t0
    again = json.loads((replay / "summary.json").read_text())
    same = all((replay / "stack" / f).read_bytes() == (run_dir / "stack" / f).read_bytes()
               for f in ("stack_oof.csv", "stack_test.csv", "summary.json"))
    _check(code == 0 and same and again["stack"] == rec["stack"]
           and again["stack_beats_streams"] == rec["stack_beats_streams"],
           f"cli.stack_from_streams on a copy of the run: the stack's files byte for byte and the summary's stack "
           f"block equal ({json.dumps(again['stack'])})")

    # (b) the augmentation CLIs on a folder of JPEG, PNG and BMP teeth
    src = work / "augment_in"
    src.mkdir()
    shapes = [(512, 512)] * (LAST_TEETH - 2) + [(600, 520), (768, 1024)]  # one off-size, one phone-shaped
    names = []
    for i, hw in enumerate(shapes):
        img = synth_teeth(1, hw, seed=SEED + 130 + i)[0]
        kind = ("jpg", "png", "bmp")[i % 3]
        name = f"tooth_{i}.{kind}"
        if kind == "jpg":
            save_jpeg(src / name, torch.from_numpy(img).to(dev))
        else:
            (src / name).write_bytes(encode_png(img) if kind == "png" else _bmp_bytes(img))
        names.append(name)
    to_csv(Table({"image_name": names, "y_majority": [0, 1] * (LAST_TEETH // 2 - 1) + [0, 0]}), work / "augment.csv")
    aug_runs = {}
    for strength in ("strong", "medium"):
        out = work / f"augment_{strength}"
        reset_launches()
        t0 = time.perf_counter()
        code = run_augment.main(["--table", str(work / "augment.csv"), "--image_dir", str(src), "--out_dir", str(out),
                                 "--target_per_class", str(LAST_TARGET), "--strength", strength])
        torch.cuda.synchronize()
        seconds[f"run_augment_{strength}"] = time.perf_counter() - t0
        launches[f"run_augment_{strength}"] = dict(LAUNCHES)
        rows = read_table(out / "data_balanced.csv")
        kids = [n for n in rows["image_name"] if "_bal" in str(n)]
        aug_runs[strength] = (code, len(rows), len(kids))
        _check(code == 0 and len(rows) == 2 * LAST_TARGET and all((out / "images" / n).exists() for n in kids)
               and all(launches[f"run_augment_{strength}"][k] > 0 for k in AUGMENT_CLI_KERNELS[strength]),
               f"cli.run_augment --strength {strength}: {len(rows)} rows, {len(kids)} children written; launches "
               f"{launches[f'run_augment_{strength}']}")
    out = work / "augment_simple"
    reset_launches()
    t0 = time.perf_counter()
    code = run_augment_simple.main(["--input_dir", str(src), "--output_dir", str(out), "--n", str(LAST_SIMPLE_N)])
    torch.cuda.synchronize()
    seconds["run_augment_simple"] = time.perf_counter() - t0
    launches["run_augment_simple"] = dict(LAUNCHES)
    written = sorted(p.name for p in out.iterdir())
    _check(code == 0 and len(written) == LAST_TEETH * LAST_SIMPLE_N
           and all(launches["run_augment_simple"][k] > 0 for k in AUGMENT_CLI_KERNELS["simple"]),
           f"cli.run_augment_simple --n {LAST_SIMPLE_N}: {len(written)} children of {LAST_TEETH} JPEG/PNG/BMP teeth; "
           f"launches {launches['run_augment_simple']}")

    # (c) the split CLIs on phase 10's table
    t0 = time.perf_counter()
    base = train["table"]
    to_csv(base.select([c for c in base.columns if c != "split"]), work / "splits_in.csv")
    code_b = make_balanced_splits.main(["--table", str(work / "splits_in.csv"), "--out", str(work / "splits_balanced")])
    code_g = make_group_splits.main(["--csv", str(work / "splits_in.csv"), "--outdir", str(work / "splits_group")])
    balanced = read_table(work / "splits_balanced.csv")
    group = read_table(work / "splits_group" / "folds_group.csv")
    assert_no_group_leakage(balanced)
    assert_no_group_leakage(group)
    seconds["split_clis"] = time.perf_counter() - t0
    counts = lambda t: {s: int((np.asarray(t["split"]) == s).sum()) for s in ("train", "val", "test")}
    _check(code_b == 0 and code_g == 0 and len(balanced) == len(group) == len(base),
           f"cli.make_balanced_splits {counts(balanced)} and cli.make_group_splits {counts(group)} on phase 10's "
           f"{len(base)}-row table: no group spans two splits")

    # (d) eval_vision on phase 12's hard checkpoint
    ckpt = work / "vision" / "hard" / "vision_hard_best"
    t0 = time.perf_counter()
    code = eval_vision.main(["--ckpt", str(ckpt), "--data", str(work / "vision_meta.csv"), "--image_dir",
                             str(work / "vision_images"), "--outdir", str(work / "eval_vision")])
    seconds["eval_vision"] = time.perf_counter() - t0
    pred = read_table(work / "eval_vision" / "vision_hard_test_predictions.csv")
    meta = read_table(work / "vision_meta.csv")
    test = meta.take(np.asarray([str(s).lower() == "test" for s in meta["split"]]))
    size = json.loads(ckpt.with_suffix(".recipe.json").read_text())["img_size"]
    data, _ = load_vision_dataset(test, work / "vision_images", int(size), dev)
    ref = _predict_vision_ckpt(ckpt, data.images)
    gap = float(np.abs(np.asarray(pred["prob"]) - ref).max())
    _check(code == 0 and len(pred) == len(ref) and gap <= EVAL_VISION_BAR,
           f"cli.eval_vision on vision_hard_best ({len(pred)} test rows from JPEG): max |dp| {gap:.3g} against "
           f"_predict_vision_ckpt on the same decoded images (bar {EVAL_VISION_BAR})")

    # (e) evaluate_models --which blend on phase 12's forests
    t0 = time.perf_counter()
    to_csv(train["table"], work / "forest_data.csv")
    (work / "evaluate").mkdir()
    code = evaluate_models.main(["--data", str(work / "forest_data.csv"), "--xgb", str(work / "ml" / "xgb_forest"),
                                 "--lgbm", str(work / "ml" / "lgbm_forest"), "--which", "blend", "--outdir",
                                 str(work / "evaluate")])
    seconds["evaluate_models"] = time.perf_counter() - t0
    blend = json.loads((work / "evaluate" / "metrics_blend.json").read_text())
    _check(code == 0 and _finite_tree({k: v for k, v in blend.items() if k != "auc"}) and 0 <= blend["alpha"] <= 1,
           f"cli.evaluate_models --which blend on phase 12's xgb_like (Platt) and lgbm_like forests: {json.dumps(blend)}")
    torch.cuda.empty_cache()
    seconds["phase"] = time.perf_counter() - t_phase
    print("  phase 13 seconds: " + ", ".join(f"{k} {v:.2f}" for k, v in seconds.items()) + f"; {smi}")
    print("  phase 13 kernel launches: " + json.dumps(launches))
    return {"seconds": seconds, "launches": launches, "rehearsal": rec, "eval_vision_gap": gap, "blend": blend}


def main() -> int:
    if not (ROOT / "mmtrs_tpu_torch" / "csrc").is_dir():
        return _fail(f"mmtrs_tpu_torch/ not found beside {Path(__file__).name}; run from the repository")
    import torch

    if not torch.cuda.is_available():
        return _fail("no CUDA device: the port's kernels run only on the card")
    sys.path.insert(0, str(ROOT))
    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"phase 0: {torch.cuda.get_device_name(0)}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    from mmtrs_tpu_torch import _build

    t0 = time.perf_counter()
    _build.library()
    print(f"phase 1: kernels built in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_build.library.build_seconds:.2f} s) into {_build.BUILD_DIR.relative_to(ROOT)}")
    _check(_build.stream_handle() == torch.cuda.current_stream().cuda_stream,
           "the wrappers' raw stream handle equals torch.cuda.current_stream()'s")

    stats, errs = phase_kernels(torch, dev)
    ips = phase_preprocess(torch, dev)
    serve_launches, p50 = phase_serve(torch, dev)
    aug_launches, aug_ips, legacy_ips = phase_augment(torch, dev)
    preset_launches, preset_rates = phase_presets(torch, dev)
    archive_launches, archive_ips = phase_archive(torch, dev)
    full_launches, full_p50s, entry = phase_serve_weights(
        torch, dev, smi, then=phase_entry_points(torch, dev, smi, archive_ips))
    import tempfile

    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        work = Path(tmp)
        train = phase_train(torch, dev, smi, work)
        rest = phase_rest(torch, dev, smi, work, train)
        vision = phase_vision(torch, dev, smi, work, train)
        last = phase_last_entry_points(torch, dev, smi, work, train)
    _check(not work.exists(), "the training folder removed")
    if "jax" in sys.modules or "mmtrs_tpu" in sys.modules:
        return _fail("the port pulled in jax or the JAX package")

    sources = {
        "clahe_lab_fwd_lut": ("mmtrs_tpu_torch/csrc/clahe_lab.cu",
                              "mmtrs_tpu/ops/pallas/lab_kernels.py:112, mmtrs_tpu/ops/pallas/clahe_kernel.py:80"),
        "clahe_apply_lab_bwd": ("mmtrs_tpu_torch/csrc/clahe_lab.cu",
                                "mmtrs_tpu/ops/pallas/clahe_kernel.py:175, mmtrs_tpu/ops/pallas/lab_kernels.py:132"),
        "shift_rows": ("mmtrs_tpu_torch/csrc/shift_rows.cu", "mmtrs_tpu/ops/pallas/shift_kernel.py:39"),
        "resample_rows": ("mmtrs_tpu_torch/csrc/resample_rows.cu", "mmtrs_tpu/ops/pallas/shift_kernel.py:177"),
        "photometric": ("mmtrs_tpu_torch/csrc/photometric.cu", "mmtrs_tpu/ops/pallas/photometric_kernel.py:123"),
        "shift_rows_windowed": ("mmtrs_tpu_torch/csrc/shift_rows.cu", "mmtrs_tpu/ops/pallas/shift_kernel.py:102"),
        "scatter_rows": ("mmtrs_tpu_torch/csrc/scatter_rows.cu", "mmtrs_tpu/ops/pallas/scatter_kernel.py:48"),
        "clahe_hist_lut": ("mmtrs_tpu_torch/csrc/clahe_l.cu",
                           "mmtrs_tpu/ops/pallas/clahe_kernel.py:110, mmtrs_tpu/ops/pallas/clahe_kernel.py:80"),
        "clahe_apply": ("mmtrs_tpu_torch/csrc/clahe_l.cu", "mmtrs_tpu/ops/pallas/clahe_kernel.py:175"),
    }
    # launches: K1-K3 and K8-K9 from the serving run (phase 4), K4-K6 from
    # the augmentation run (phase 5), K7 from the three preset runs (phase
    # 6), each counted from 0 just before its path
    launches = {k: serve_launches[k] if k in SERVE_KERNELS + L_KERNELS else aug_launches[k] for k in sources}
    launches["scatter_rows"] = sum(c["scatter_rows"] for c in preset_launches.values())
    # every kernel: the contract's keys, then the back-to-back, host and
    # library back-to-back times; K3 and K6 their f32 times beside
    # grid_sample's, K3 its shapes and axes
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "ms_b2b", "host_us", "library_ms_b2b")
    extra = ("f32_ms", "f32_ms_b2b", "detail")
    kernels = [
        {"name": k, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[k], "max_abs_err": errs[k],
         **{key: stats[k][key] for key in keys}, **{key: stats[k][key] for key in extra if key in stats[k]}}
        for k, (src, rep) in sources.items()
    ]
    print(f"summary: preprocess_batch {ips:.1f} imgs/s at b16 512^2; serve p50 {p50:.2f} ms; "
          f"preprocess_augment_batch {aug_ips:.1f} imgs/s and augment_batch(legacy) "
          f"{legacy_ips:.1f} imgs/s at b{AUG_SHAPE[0]} 512^2; augment_batch ten {preset_rates['ten'][0]:.1f}, "
          f"simple {preset_rates['simple'][0]:.1f} imgs/s at b{PRESET_SHAPE[0]} 512^2, randaug "
          f"{preset_rates['randaug'][0]:.1f} imgs/s at b{RANDAUG_SHAPE[0]} 512^2; preprocess_stream "
          f"{archive_ips:.2f} imgs/s at b{ARCHIVE_SHAPE[0]} {ARCHIVE_SHAPE[1]}x{ARCHIVE_SHAPE[2]} (launches "
          f"{archive_launches}); full service (MM B4 x5, MIL B0 x5, Tab, Stacker) p50 "
          + ", ".join(f"{r} {'fields' if t else 'no fields'} {ms:.2f} ms" for (r, t), ms in sorted(full_p50s.items()))
          + f" (launches {full_launches}); the CLI twin {entry['cli']['imgs_per_sec']:.2f} imgs/s at 12 MP; "
          f"HTTP p50 JPEG {entry['app']['http_p50_ms']['jpeg']:.2f} ms, PNG {entry['app']['http_p50_ms']['png']:.2f} "
          f"ms; nvJPEG decode 12 MP {entry['codec']['decode_12mp_ms']:.2f} ms, encode 512² "
          f"{entry['codec']['encode_512_ms']:.2f} ms; phase 9 {entry['seconds']:.1f} s; MM training (B4 380 "
          f"b12 bf16 randaug) step {train['step']['step_ms']:.2f} ms + prep {train['step']['prep_ms']:.2f} ms, "
          f"{train['step']['imgs_per_sec']:.2f} imgs/s, peak {train['step']['peak_gb']:.2f} GB, phase 10 "
          f"{train['seconds']['phase']:.1f} s; MIL training (B0 bag 12 at 320 "
          f"b{MIL_BATCH} bf16) step {rest['mil_step']['step_ms']:.2f} ms + bags {rest['mil_step']['bags_ms']:.2f} ms, "
          f"{rest['mil_step']['bags_per_sec']:.2f} bags/s, peak {rest['mil_step']['peak_gb']:.2f} GB; "
          f"train_gbdt(stack_tab_like) {rest['gbdt']['seconds'][1]:.2f} s a forest; phase 11 "
          f"{rest['seconds']['phase']:.1f} s; vision training steps "
          + ", ".join(f"{k} {v['step_ms']:.2f} ms + prep {v['prep_ms']:.2f} ms, {v['imgs_per_sec']:.2f} imgs/s, "
                      f"peak {v['peak_gb']:.2f} GB" for k, v in vision["steps"].items())
          + f"; phase 12 {vision['seconds']['phase']:.1f} s; the rehearsal twin at its widths (26 cases, 2 folds, 1 "
          f"epoch) {last['seconds']['rehearsal']:.1f} s, phase 13 {last['seconds']['phase']:.1f} s; total "
          f"{time.perf_counter() - T_START:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
