#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (mmtrs_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root, on a CUDA machine

Phases (each raises on failure, so the script exits non-zero):
  0. device: a CUDA card is required (there is no CPU path); prints the
     card's name and power limit, and the torch / CUDA versions;
  1. build: compiles mmtrs_tpu_torch/csrc/*.cu with nvcc into build/;
  2. kernels vs their plain PyTorch versions on the card, at u8 / f32
     [16, 512, 512, 3]: K1 bit-equal, the K1+K2 chain ≥ 99.99 % bit-equal
     and max ≤ 32 levels, K3 f32 within 1e-3 and its u8 store equal to
     round-half-up of the f32 result; K4 (both axes, half the images
     flipped) and K6 (both axes, |off| ≤ 11) f32 within 1e-3; K4, K5 (rows
     of identity, brightness/contrast, HSV, noise σ = √5 and √15, dropout,
     all at once) and K6 u8 bit-equal to plain, or max ≤ 1 level on
     ≥ 99.99 % of values; median CUDA-event times;
  3. preprocess_batch at [16, 512, 512, 3] with deskew firing on 2 images:
     K1-K3 launched, and the result against the same port run on the CPU
     (seg_valid equal, angles within 1e-3°, boxes within 1 px, u8 within
     2 levels on ≥ 99.9 % of values); imgs/s;
  4. serving: PredictService with a 2-fold bf16 MILEnsemble of
     MILNet("efficientnet_b0", attn_dim=128) (random weights from seeded
     generators) answers uploads at 512², 512×768, 640×512 and 512×1024 and
     refuses a 480×640 one; the K1-K3 counters rise per request; p50
     latency; an f32 copy of each fold's logit on the card agrees with the
     CPU within 1e-3 relative;
  5. augmentation: preprocess_augment_batch with the legacy preset at u8
     [32, 512, 512, 3], draws from draw_legacy for origin ids chosen so that
     every gated member fires among the first 8 images, deskew on 2 of
     them: K1-K6 each launched, u8 out, the first 8 against the same port on
     the CPU with the same draws (bars of phase 3); imgs/s of the chain and
     of augment_batch(·, "legacy") alone.

The counters are reset just before each driven path (phases 3, 4 and 5);
the JSON line of kernels reports K1-K3's launches from the serving run
(phase 4) and K4-K6's from the augmentation run (phase 5).
The last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SHAPE = (16, 512, 512, 3)
AUG_SHAPE = (32, 512, 512, 3)  # build_augmented_table's default batch (data/records.py:63)
SEED = 20261016
# the kernels each driven path runs: serving (phases 3, 4) and the
# augmentation chain (phase 5)
SERVE_KERNELS = ("clahe_lab_fwd_lut", "clahe_apply_lab_bwd", "shift_rows")
AUG_KERNELS = SERVE_KERNELS + ("resample_rows", "photometric", "shift_rows_windowed")
# gated members of the legacy preset that must fire among the first 8 images
AUG_MEMBERS = ("hflip", "vflip", "ssr", "persp", "clahe", "bc", "hsv", "noise", "dropout", "blur", "elastic")


T_START = time.perf_counter()


def _fail(msg: str) -> int:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    return 1


def _time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of one call, from CUDA events around each call."""
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


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)
    print(f"  ok: {what}")


def phase_kernels(torch, dev):
    from mmtrs_tpu_torch.ops.clahe import quantize_u8
    from mmtrs_tpu_torch.ops.kernels import clahe_lab as K
    from mmtrs_tpu_torch.ops.kernels.shift import shift_rows, shift_rows_ref
    from mmtrs_tpu_torch.synth import synth_teeth

    print("phase 2: kernels vs plain on the card at", SHAPE)
    x = torch.from_numpy(synth_teeth(SHAPE[0], SHAPE[1], seed=SEED)).to(dev)
    clip, tiles = 3.0, (8, 8)

    got = K.clahe_lab_fwd_lut(x, clip, tiles)
    want = K.clahe_lab_fwd_lut_ref(x, clip, tiles)
    k1_err = max((g.int() - w.int()).abs().max().item() for g, w in zip(got, want))
    for name, g, w in zip(("L", "da", "db", "lut"), got, want):
        _check(torch.equal(g, w), f"K1 {name} bit-equal to plain")

    chain = K.clahe_apply_lab_bwd(*got, tiles)
    chain_ref = K.clahe_apply_lab_bwd_ref(*want, tiles)
    d = (chain.int() - chain_ref.int()).abs()
    eq = (d == 0).float().mean().item()
    k2_err = d.max().item()
    _check(eq >= 0.9999 and k2_err <= 32, f"K1+K2 chain {eq:.6f} bit-equal, max {k2_err}")

    gen = torch.Generator().manual_seed(SEED)
    xf = (torch.rand(SHAPE, generator=gen) * 255.0).to(dev).contiguous()
    k3_err = 0.0
    offs = {}
    for axis, n in ((2, SHAPE[1]), (1, SHAPE[2])):
        off = ((torch.rand((SHAPE[0], n), generator=gen) * 80.0) - 40.0).to(dev)
        offs[axis] = off
        e = (shift_rows(xf, off, axis) - shift_rows_ref(xf, off, axis)).abs().max().item()
        k3_err = max(k3_err, e)
        _check(e <= 1e-3, f"K3 f32 axis {axis} max err {e:.3g} <= 1e-3")
        u8 = shift_rows(x, off, axis)
        f32 = shift_rows(x.float(), off, axis)
        _check(torch.equal(u8, quantize_u8(f32)), f"K3 u8 axis {axis} == round-half-up of f32")
        _check(torch.equal(u8, shift_rows_ref(x, off, axis)), f"K3 u8 axis {axis} == plain")

    lq, da, db, lut = got
    times = {
        "clahe_lab_fwd_lut": (
            _time_ms(lambda: K.clahe_lab_fwd_lut(x, clip, tiles)),
            _time_ms(lambda: K.clahe_lab_fwd_lut_ref(x, clip, tiles)),
        ),
        "clahe_apply_lab_bwd": (
            _time_ms(lambda: K.clahe_apply_lab_bwd(lq, da, db, lut, tiles)),
            _time_ms(lambda: K.clahe_apply_lab_bwd_ref(lq, da, db, lut, tiles)),
        ),
        # u8 NHWC, one x-shear: what deskew runs per pass
        "shift_rows": (
            _time_ms(lambda: shift_rows(x, offs[2], 2)),
            _time_ms(lambda: shift_rows_ref(x, offs[2], 2)),
        ),
    }
    errs = {"clahe_lab_fwd_lut": k1_err, "clahe_apply_lab_bwd": k2_err, "shift_rows": k3_err}
    for check in (_check_resample, _check_photometric, _check_windowed):
        name, err, t = check(torch, dev, x, xf, gen)
        errs[name], times[name] = err, t
    for k, (ms, plain) in times.items():
        print(f"  {k}: kernel {ms:.4f} ms, plain {plain:.4f} ms (median of 20)")
    return times, errs


def _u8_bar(name, got, want):
    """u8 kernel output against its plain version: bit-equal expected; the
    stated fallback bar is max ≤ 1 level on ≥ 99.99 % of values (a
    transcendental of the card's libm against PyTorch's). Returns the max."""
    d = (got.int() - want.int()).abs()
    eq = (d == 0).float().mean().item()
    err = d.max().item()
    _check(err == 0 or (err <= 1 and eq >= 0.9999), f"{name} u8 {eq:.6f} bit-equal to plain, max {err}")
    return float(err)


def _check_resample(torch, dev, x, xf, gen):
    """K4 on both axes, u8 (u8 store) and f32, half the images flipped
    (α < 0 with r near n − 1, as an hflip composes)."""
    from mmtrs_tpu_torch.ops.kernels.resample import resample_rows, resample_rows_ref

    B, H, W, _ = SHAPE
    err = 0.0
    args = {}
    for axis, lines, n in ((2, H, W), (1, W, H)):
        flip = torch.arange(B) % 2 == 1
        alpha = torch.where(flip, -1.05, 0.9).float()
        beta = torch.rand((B, lines), generator=gen) * 40.0 - 20.0 + torch.where(flip, n - 1.0, 0.0)[:, None]
        r = beta.mean(dim=1)
        off = beta - r[:, None]
        a = args[axis] = tuple(t.to(dev).contiguous() for t in (off, alpha, r))
        e = (resample_rows(xf, *a, axis=axis) - resample_rows_ref(xf, *a, axis=axis)).abs().max().item()
        _check(e <= 1e-3, f"K4 f32 axis {axis} max err {e:.3g} <= 1e-3")
        err = max(err, e, _u8_bar(f"K4 axis {axis}", resample_rows(x, *a, axis=axis),
                                  resample_rows_ref(x, *a, axis=axis)))
    # u8 NHWC, the warp's horizontal pass
    t = (_time_ms(lambda: resample_rows(x, *args[2], axis=2)),
         _time_ms(lambda: resample_rows_ref(x, *args[2], axis=2)))
    return "resample_rows", err, t


def _check_photometric(torch, dev, x, xf, gen):
    """K5 on rows that are identity, brightness/contrast, HSV, noise at
    σ = √5 and √15, dropout, and all members at once (repeated over B)."""
    from mmtrs_tpu_torch.ops.kernels.photometric import photometric, photometric_ref

    B = SHAPE[0]
    kinds = np.zeros((7, 10), np.float32)
    kinds[1, :2] = (0.12, -0.09)
    kinds[2, 2:6] = (4.0, -6.0, 8.0, 1.0)
    kinds[3, 6] = np.sqrt(5.0)
    kinds[4, 6] = np.sqrt(15.0)
    kinds[5, 7:10] = (1.0, 200.0, 301.0)
    kinds[6] = (-0.07, 0.11, -3.0, 9.0, -5.0, 1.0, np.sqrt(15.0), 1.0, 40.0, 90.0)
    params = torch.from_numpy(kinds[np.arange(B) % 7]).to(dev)
    seeds = torch.randint(-(2**31), 2**31 - 1, (B,), generator=gen, dtype=torch.int32).to(dev)
    hole = 512 // 24
    err = _u8_bar("K5", photometric(x, params, seeds, hole), photometric_ref(x, params, seeds, hole))
    t = (_time_ms(lambda: photometric(x, params, seeds, hole)),
         _time_ms(lambda: photometric_ref(x, params, seeds, hole)))
    return "photometric", err, t


def _check_windowed(torch, dev, x, xf, gen):
    """K6 on both axes, u8 and f32, per-pixel offsets |off| ≤ 11 (the
    elastic pass's bound)."""
    from mmtrs_tpu_torch.ops.kernels.shift import shift_rows_windowed, shift_rows_windowed_ref

    B, H, W, _ = SHAPE
    off = (torch.rand((B, H, W), generator=gen) * 22.0 - 11.0).to(dev)
    err = 0.0
    for axis in (1, 2):
        e = (shift_rows_windowed(xf, off, 11, axis) - shift_rows_windowed_ref(xf, off, axis)).abs().max().item()
        _check(e <= 1e-3, f"K6 f32 axis {axis} max err {e:.3g} <= 1e-3")
        err = max(err, e, _u8_bar(f"K6 axis {axis}", shift_rows_windowed(x, off, 11, axis),
                                  shift_rows_windowed_ref(x, off, axis)))
    # u8 NHWC, the elastic transform's first (vertical) pass
    t = (_time_ms(lambda: shift_rows_windowed(x, off, 11, 1)),
         _time_ms(lambda: shift_rows_windowed_ref(x, off, 1)))
    return "shift_rows_windowed", err, t


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
    from mmtrs_tpu_torch.serve.ensembles import MILEnsemble
    from mmtrs_tpu_torch.serve.service import PredictService
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
    shapes = [(512, 512), (512, 768), (640, 512), (512, 1024)]
    uploads = [
        synth_teeth(1, s, seed=SEED + 10 + i, angles_deg=[25.0 + 5 * i])[0]
        for i, s in enumerate(shapes)
    ]
    svc.predict_one(uploads[0])  # warm-up: cuDNN plans, allocator
    torch.cuda.synchronize()

    reset_launches()
    lat, results = [], []
    for rep in range(3):
        for img in uploads:
            before = dict(LAUNCHES)
            t0 = time.perf_counter()
            r = svc.predict_one(img)
            torch.cuda.synchronize()
            lat.append(time.perf_counter() - t0)
            rose = all(LAUNCHES[k] > before[k] for k in SERVE_KERNELS)
            if not rose:
                raise AssertionError(f"counters did not rise for {img.shape}: {before} -> {LAUNCHES}")
            if "error" in r:
                raise AssertionError(f"request {img.shape} failed: {r['error']}")
            p = r["p_indirect"]
            if not (np.isfinite(p) and 0.0 <= p <= 1.0 and r["label"] in ("Direct", "Indirect")):
                raise AssertionError(f"bad answer {r}")
            if r["processed_image"].shape != (512, 512, 3) or r["processed_image"].dtype != np.uint8:
                raise AssertionError("processed image is not u8 512x512x3")
            if rep == 0:
                results.append((img.shape, r["label"], p))
    launches = dict(LAUNCHES)
    for shape, label, p in results:
        print(f"  upload {shape}: {label} p_indirect={p:.6f}")
    _check(True, f"12 requests answered; K1-K3 counters rose on every request: {launches}")
    low = svc.predict_one(synth_teeth(1, (480, 640), seed=SEED)[0])
    _check("resolution" in low.get("error", ""), f"480x640 refused: {low.get('error')}")
    p50 = float(np.median(lat)) * 1e3
    print(f"  p50 latency {p50:.2f} ms per request (host clock, {len(lat)} requests)")

    # each fold in f32 on the card against the CPU: logits of one bag of
    # the four processed uploads (TF32 is off; the bound covers cuDNN's
    # other summation order through 16 blocks)
    procs = torch.from_numpy(np.stack([svc.preprocess(u) for u in uploads]))
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


def _covering_origin_ids(n: int, first: int = 8) -> list[int]:
    """n origin ids (seed SEED, aug_idx 0) such that among the first ``first``
    every gated member of the legacy preset fires at least once; chosen
    greedily from the host draws' gates."""
    from mmtrs_tpu_torch.ops.augment import draw_uniforms, legacy_gates
    from mmtrs_tpu_torch.utils.rng import generators_for_batch

    cand = list(range(4000))
    g = legacy_gates(draw_uniforms(generators_for_batch(SEED, cand, 0)))
    fired = np.stack([g[k].numpy() for k in AUG_MEMBERS], axis=1)  # [cand, members]
    chosen, todo = [], np.ones(len(AUG_MEMBERS), bool)
    while todo.any() and len(chosen) < first:
        score = (fired & todo).sum(axis=1)
        score[chosen] = -1
        best = int(np.argmax(score))
        chosen.append(best)
        todo &= ~fired[best]
    if todo.any():
        raise AssertionError(f"no {first} lineages fire {np.array(AUG_MEMBERS)[todo]}")
    rest = [i for i in cand if i not in chosen]
    return chosen + rest[: n - len(chosen)]


def phase_augment(torch, dev):
    from mmtrs_tpu_torch.ops.augment import augment_batch, draw_legacy
    from mmtrs_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from mmtrs_tpu_torch.preprocess import preprocess_augment_batch
    from mmtrs_tpu_torch.synth import synth_teeth

    B, S = AUG_SHAPE[0], AUG_SHAPE[1]
    print("phase 5: preprocess_augment_batch (legacy preset) on the card at", AUG_SHAPE)
    ids = _covering_origin_ids(B)
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

    def rate(fn, reps=5):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return reps * B / (time.perf_counter() - t0)

    ips = rate(lambda: preprocess_augment_batch(x, draws, out_size=S))
    aug_ips = rate(lambda: augment_batch(x, draws, "legacy", img_size=S))
    print(f"  preprocess_augment_batch: {ips:.1f} imgs/s at b{B} 512^2 (host clock, 5 reps; "
          f"draws made beforehand, {draw_s * 1e3:.1f} ms per batch on the host)")
    print(f"  augment_batch(legacy): {aug_ips:.1f} imgs/s at b{B} 512^2 (host clock, 5 reps)")
    return counts, ips, aug_ips


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

    times, errs = phase_kernels(torch, dev)
    ips = phase_preprocess(torch, dev)
    serve_launches, p50 = phase_serve(torch, dev)
    aug_launches, aug_ips, legacy_ips = phase_augment(torch, dev)
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
    }
    # launches: K1-K3 from the serving run (phase 4), K4-K6 from the
    # augmentation run (phase 5), each counted from 0 just before its path
    launches = {k: serve_launches[k] if k in SERVE_KERNELS else aug_launches[k] for k in sources}
    kernels = [
        {"name": k, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[k], "max_abs_err": errs[k],
         "ms": times[k][0], "plain_ms": times[k][1]}
        for k, (src, rep) in sources.items()
    ]
    print(f"summary: preprocess_batch {ips:.1f} imgs/s at b16 512^2; serve p50 {p50:.2f} ms; "
          f"preprocess_augment_batch {aug_ips:.1f} imgs/s and augment_batch(legacy) "
          f"{legacy_ips:.1f} imgs/s at b{AUG_SHAPE[0]} 512^2; total {time.perf_counter() - T_START:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
