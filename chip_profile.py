#!/usr/bin/env python3
"""Where the time goes on the port's L-plane paths, on one NVIDIA GPU.

    python3 chip_profile.py        # from the repository root, on a CUDA machine

Three paths, on the inputs chip_smoke.py drives them with:
  1. the archive pass, ``preprocess_stream`` over 3 batches of u8
     [4, 3024, 4032, 3] synthetic 12 MP teeth: host-clock time of each
     stage of one batch (pinning, the copy to the card, the CLAHE stage, its
     float LAB, u8 L, K8 and K9 parts, deskew, the segmenter, the crop, the copy
     back), each ended by a synchronise; then ``torch.profiler`` over the
     stream: device busy share of the wall and the largest device items;
  2. one phone-shaped serving request's preprocessing (a 768x1024 upload,
     bucket 512x688): host-clock time of the bucket resize, the CLAHE stage
     and the whole ``PredictService.preprocess``.
  3. the augmentation chain, ``preprocess_augment_batch`` with the
     ``legacy`` preset on chip_smoke.py phase 5's u8 [32, 512, 512, 3] batch
     and draws (every gated member firing among the first 8): under
     ``torch.profiler`` over 3 batches, the device busy share and the
     device ms of the warp's resample (K4), the photometric pass (K5) and
     the elastic shift (K6).
K8 and K9 are also timed back to back (100 launches between two CUDA
events) against one call between events, which separates a launch's host
cost from the kernel. Prints the card's name and power limit, then one JSON
object of the numbers as its last line.

    python3 chip_profile.py --line-times

times the kernels K1-K6, K8 and K9 (see ``line_times``; K5 on the four
mixes of chip_smoke.py's K5_MIXES), at arguments that every tree of the
port takes: copy this file and chip_smoke.py into an older commit's
checkout and run it there and here in turns to compare two commits'
kernels in one call.

    python3 chip_profile.py --service

writes chip_smoke.py phase 8's weights folder, builds the full service
from it (MM, MIL, Tab, the Stacker) and reads one fused-route request with
all 9 fields, and its MM and MIL stages alone, under ``torch.profiler``:
wall and device busy ms, the busy share, the device events launched and
the largest of them (``full_service``).

    python3 chip_profile.py --bf16-spread

holds that service's bf16 image streams against the same folds read onto
the CPU, in bf16 and in f32, on phase 4's seven uploads (``bf16_spread``).

    python3 chip_profile.py --train

one bf16 train step of the MM trainer at MMJointConfig's widths (B4 at
380, batch 12, randaug on 512² u8 rows, as chip_smoke.py phase 10 runs
it): each stage's host-clock ms (prep, forward, backward, AdamW, through
the trainer's own stages; median of 5, each ending in a synchronise), then
the prep and the step under
``torch.profiler`` (``_busy``: wall and device busy ms, the device events,
the largest items) and the host syncs a step makes (``train_step``).

    python3 chip_profile.py --f32-step

reads chip_smoke.py phase 10's f32 card-vs-CPU train step
(``_f32_step_check``) on F32_READ_BATCHES batches of phase 10's lineage
table, the first (phase 10's own) twice, with TF32 off, then phase 10's
batch once with TF32 allowed in cuDNN and matmuls: a control that the
F32_* bars must fail (``f32_step``).

    python3 chip_profile.py --mil-train

one bf16 train step of the MIL trainer at chip_smoke.py phase 11's widths
(B0, bag 12 at 320, batch 16, on 512² u8 rows): each stage's host-clock ms
(make_bags + normalise, forward, backward, AdamW; median of 5), the bags
and the step under ``torch.profiler`` (``_busy``) and the host syncs a
step makes (``mil_train_step``).

    python3 chip_profile.py --gbdt

``train_gbdt`` at stack_tab_like on chip_smoke.py phase 11's seeded table:
the seconds of a 700-tree forest on the host clock, a 20-tree fit under
``torch.profiler`` (``_busy``: busy share, device events a tree, the
largest items) and the host syncs a fit makes (``gbdt_fit``).

    python3 chip_profile.py --sass

counts the SASS instructions of K1's and K2's per-pixel loops in the
library the tree builds (``sass_counts``) and K5's per path (``k5_sass``);
it too runs on an older checkout.
"""

from __future__ import annotations

import contextlib
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SEED = 20261016
ARCHIVE_SHAPE = (4, 3024, 4032, 3)


def _sync_ms(torch, fn):
    """(result, host-clock ms of ``fn`` ended by a synchronise)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _events_ms(torch, fn, n):
    """Device ms per call of ``fn`` over ``n`` back-to-back calls."""
    fn()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def archive_stages(torch, dev, host):
    from mmtrs_tpu_torch.models.segmenter import SaliencySegmenter
    from mmtrs_tpu_torch.ops.clahe import quantize_u8
    from mmtrs_tpu_torch.ops.color import lab_to_rgb, rgb_to_lab
    from mmtrs_tpu_torch.ops.deskew import deskew_batch
    from mmtrs_tpu_torch.ops.kernels.clahe import clahe_apply, clahe_hist_lut, quantize_l
    from mmtrs_tpu_torch.ops.resize import crop_box_resize
    from mmtrs_tpu_torch.preprocess import _clahe_lab_stage

    ms = {}
    pinned, ms["pin_memory"] = _sync_ms(torch, lambda: torch.from_numpy(host).pin_memory())
    x, ms["copy_to_card"] = _sync_ms(torch, lambda: pinned.to(dev, non_blocking=True))
    lab, ms["clahe.rgb_to_lab"] = _sync_ms(torch, lambda: rgb_to_lab(x.float()))
    l, ms["clahe.quantize_l"] = _sync_ms(torch, lambda: quantize_l(lab[..., 0]).contiguous())
    lut, ms["clahe.k8"] = _sync_ms(torch, lambda: clahe_hist_lut(l, 3.0, (8, 8)))
    l2, ms["clahe.k9_u8"] = _sync_ms(torch, lambda: clahe_apply(l, lut, (8, 8), torch.uint8))
    _, ms["clahe.lab_to_rgb_u8"] = _sync_ms(
        torch, lambda: quantize_u8(lab_to_rgb(torch.cat([l2.float()[..., None], lab[..., 1:]], dim=-1))))
    del lab, l, lut, l2
    c, ms["clahe_stage"] = _sync_ms(torch, lambda: _clahe_lab_stage(x, 3.0, (8, 8)))
    # in place, as the archive pass runs it: c is the CLAHE stage's fresh output
    (d, _), ms["deskew"] = _sync_ms(torch, lambda: deskew_batch(c))
    (boxes, _), ms["segmenter"] = _sync_ms(torch, lambda: SaliencySegmenter().propose_boxes(d))
    out, ms["crop_resize_u8"] = _sync_ms(torch, lambda: quantize_u8(crop_box_resize(d, boxes, 512, 15.0)))
    _, ms["copy_back"] = _sync_ms(torch, lambda: out.cpu().numpy())
    return ms


def archive_profile(torch, dev, host, batches=3):
    from torch.profiler import ProfilerActivity, profile

    from mmtrs_tpu_torch.preprocess import preprocess_stream

    list(preprocess_stream(iter([(0, host)]), device=dev))  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        list(preprocess_stream(((i, host) for i in range(batches)), device=dev))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # the device's own events (kernels, copies, memsets), not the host ops
    # that launched them
    dev_items = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in dev_items) / 1e3
    top = sorted(dev_items, key=lambda e: -e.self_device_time_total)[:12]
    return {
        "wall_ms_per_batch": wall_ms / batches,
        "device_busy_ms_per_batch": busy_ms / batches,
        "busy_share": busy_ms / wall_ms,
        "device_events_per_batch": sum(e.count for e in dev_items) / batches,
        "top_device_ms_per_batch": {e.key[:90]: e.self_device_time_total / 1e3 / batches for e in top},
    }


def legacy_profile(torch, dev, batches=3):
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import AUG_MEMBERS, AUG_SHAPE, _covering_origin_ids, _legacy_gates
    from mmtrs_tpu_torch.ops.augment import draw_legacy
    from mmtrs_tpu_torch.preprocess import preprocess_augment_batch
    from mmtrs_tpu_torch.synth import synth_teeth

    B, S = AUG_SHAPE[0], AUG_SHAPE[1]
    draws = draw_legacy(SEED, _covering_origin_ids(B, _legacy_gates, AUG_MEMBERS), 0, S, S, img_size=S)
    x = torch.from_numpy(synth_teeth(B, S, seed=SEED + 2, angles_deg=[30.0, -25.0] + [0.0] * (B - 2))).to(dev)
    preprocess_augment_batch(x, draws, out_size=S)  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(batches):
            preprocess_augment_batch(x, draws, out_size=S)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev_items = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in dev_items) / 1e3
    # the kernels by their device function names (csrc/resample_rows.cu,
    # csrc/shift_rows.cu, csrc/photometric.cu)
    own = lambda tag: sum(e.self_device_time_total for e in dev_items if tag in e.key) / 1e3 / batches
    k4, k5, k6 = own("resample_"), own("photometric"), own("window_")
    return {
        "elastic_images": int(draws.elastic_on.sum()),
        "wall_ms_per_batch": wall_ms / batches,
        "device_busy_ms_per_batch": busy_ms / batches,
        "busy_share": busy_ms / wall_ms,
        "k4_ms_per_batch": k4,
        "k5_ms_per_batch": k5,
        "k6_ms_per_batch": k6,
        "k4_k6_share_of_busy": (k4 + k6) * batches / busy_ms if busy_ms else None,
        "k5_share_of_busy": k5 * batches / busy_ms if busy_ms else None,
        "k4_k6_share_of_wall": (k4 + k6) * batches / wall_ms,
    }


# the device functions of each kernel, in this tree and in older ones
# (csrc/shift_rows.cu, csrc/resample_rows.cu, csrc/photometric.cu,
# csrc/clahe_lab.cu: K1 and K2 in their one-thread-a-pixel and their banded
# layouts; csrc/clahe_l.cu)
LINE_KERNEL_NAMES = {
    "K1": ("fwd_lut_kernel", "lab_fwd_hist_kernel"),
    "K2": ("apply_bwd_kernel", "lab_bwd_blend_kernel"),
    "K3": ("shift_w_kernel", "shift_h_kernel"),
    "K4": ("resample_",),
    "K5": ("photometric_kernel",),
    "K6": ("shift_pp_kernel", "window_w_kernel", "window_h_kernel"),
    "K8": ("hist_lut_kernel",),  # hist_lut_kernel, plane_hist_lut_kernel
    "K9": ("apply_kernel", "plane_blend_kernel"),
}
# K8 and K9 at a served request, serving's bucket at b16 and the archive's batch
L_PROFILE_SHAPES = ((16, 512, 688), (1, 512, 688), (4, 3024, 4032))


def _kernel_ms(torch, tags, fn, argsets, launches=20):
    """Device ms per launch of the kernels whose names hold one of ``tags``,
    under ``torch.profiler`` over ``launches`` calls of ``fn`` taking
    ``argsets`` in turn: the kernel alone, without whatever else its wrapper
    launches or waits for."""
    from torch.profiler import ProfilerActivity, profile

    fn(*argsets[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(launches):
            fn(*argsets[i % len(argsets)])
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and any(t in e.key for t in tags)) / 1e3 / launches


def line_times(torch, dev):
    """The kernels through their wrappers, at arguments that every tree of
    the port takes: first K1 and K2, with K8 and K9 as controls (see
    :func:`clahe_times`); then K3 with deskew's offsets at
    [16, 512, 512, 3]; K4 with random ±20 per line (half flipped) and K6
    with uniform ±11 (window 11) at [16, 512, 512, 3] and [12, 380, 380, 3],
    u8 and f32, both axes; K5 on chip_smoke.py's four mixes (K5_MIXES:
    phase 2's rows, the chain's draws, brightness/contrast alone and every
    member, its host µs on phase 2's rows before the profiler first runs),
    with each mix's bound and count of values that differ from the plain
    version. For each,
    the wrapper's ms per launch back to back between two CUDA events
    (``b2b``: whatever the wrapper launches or waits for included) and the
    kernel's own device ms per launch under ``torch.profiler`` (``kernel``);
    each wrapper's host µs at u8 [16, 512, 512, 3] (axis 1). Checks nothing
    (chip_smoke.py phase 2 does)."""
    from chip_smoke import (K5_MIXES, MM_SHAPE, OPS_PER_ELEMENT, SEED, SHAPE, _b2b_ms, _bound_ms, _deskew_offsets,
                            _host_us, _nbytes, _photometric_mix, _random_passes, _rotations, _teeth_at)
    from mmtrs_tpu_torch.ops.kernels.photometric import photometric, photometric_ref
    from mmtrs_tpu_torch.ops.kernels.resample import resample_rows
    from mmtrs_tpu_torch.ops.kernels.shift import shift_rows, shift_rows_windowed
    from mmtrs_tpu_torch.synth import synth_teeth

    gen = torch.Generator().manual_seed(SEED)
    x = torch.from_numpy(synth_teeth(SHAPE[0], SHAPE[1], seed=SEED)).to(dev)
    times, host_us = {}, {}

    def both(key, kernel, fn, args):
        sets = _rotations(args)
        times[key] = {"b2b": _b2b_ms(fn, sets), "kernel": _kernel_ms(torch, LINE_KERNEL_NAMES[kernel], fn, sets)}

    k5_args = {mix: _photometric_mix(torch, dev, x, mix, torch.Generator().manual_seed(SEED + 11))
               for mix in K5_MIXES}
    host_us[f"K5 {list(SHAPE)}"] = _host_us(lambda: photometric(*k5_args["a"]), ())
    mismatches = clahe_times(torch, dev, x, both, host_us)
    for axis in (2, 1):
        off = _deskew_offsets(torch, gen, SHAPE[0], SHAPE[1], axis).to(dev)
        both(f"K3 {list(SHAPE)} axis {axis} deskew u8", "K3", shift_rows, (x, off, axis))
    for shape in (SHAPE, MM_SHAPE):
        B, H, W, C = shape
        u8 = _teeth_at(torch, dev, x, shape)
        f32 = u8.float().contiguous()
        for axis, lines, n in ((2, H, W), (1, W, H)):
            a = tuple(t.to(dev).contiguous() for t in _random_passes(torch, gen, B, lines, n))
            off = (torch.rand((B, H, W), generator=gen) * 22.0 - 11.0).to(dev)
            for name, im in (("u8", u8), ("f32", f32)):
                both(f"K4 {list(shape)} axis {axis} random ±20 {name}", "K4",
                     lambda i, *t: resample_rows(i, *t, axis=axis), (im, *a))
                both(f"K6 {list(shape)} axis {axis} ±11 {name}", "K6",
                     lambda i, o: shift_rows_windowed(i, o, 11, axis), (im, off))
            if shape == SHAPE and axis == 1:
                host_us["K4"] = _host_us(lambda: resample_rows(u8, *a, axis=1), ())
                host_us["K6"] = _host_us(lambda: shift_rows_windowed(u8, off, 11, 1), ())
    for mix, args in k5_args.items():
        key = f"K5 mix ({mix}) {list(args[0].shape)}"
        both(key, "K5", photometric, args)
        imgs = args[0]
        times[key]["bound_ms"] = _bound_ms(_nbytes(imgs, *args[1:3], imgs),
                                           OPS_PER_ELEMENT["photometric"] * (imgs.numel() // 3))[0]
        mismatches[key] = int((photometric(*args) != photometric_ref(*args)).sum())
    return {"line_times_ms": times, "host_us": host_us, "mismatches": mismatches}


def clahe_times(torch, dev, x, both, host_us):
    """For :func:`line_times`, before its other kernels: K1 and K2 on teeth at
    [16, 512, 512, 3] and a served upload's [1, 512, 512, 3] (each wrapper's
    host µs, taken before the profiler first runs, then the times); K8 and
    K9 (u8 and f32 stores) on the L planes of teeth at ``L_PROFILE_SHAPES``
    (their host µs at [16, 512, 688] first too). Returns each kernel's
    count of values that differ from its plain version there, and K1's on
    the every-colour image and K2's on the every-triple planes with
    identity LUTs (chip_smoke.py phase 2 checks them)."""
    from chip_smoke import L_SHAPE, SERVE_SHAPE, SHAPE, _host_us, _l_teeth, every_byte_triple
    from mmtrs_tpu_torch.ops.kernels import clahe as C
    from mmtrs_tpu_torch.ops.kernels import clahe_lab as K

    clip, tiles = 3.0, (8, 8)
    differ = lambda got, want: sum(int((g != w).sum()) for g, w in zip(got, want))
    fwd = lambda im: K.clahe_lab_fwd_lut(im, clip, tiles)
    bwd = lambda *planes: K.clahe_apply_lab_bwd(*planes, tiles)
    mismatches = {}
    for shape in (SHAPE, SERVE_SHAPE):  # host µs first, before the profiler first runs
        teeth = x[: shape[0]]
        planes = fwd(teeth)
        host_us[f"K1 {list(shape)}"] = _host_us(lambda: fwd(teeth), ())
        host_us[f"K2 {list(shape)}"] = _host_us(lambda: bwd(*planes), ())
    l = _l_teeth(torch, dev, x, L_SHAPE)
    lut = C.clahe_hist_lut(l, clip, tiles)
    host_us[f"K8 {list(L_SHAPE)}"] = _host_us(lambda: C.clahe_hist_lut(l, clip, tiles), ())
    host_us[f"K9 {list(L_SHAPE)} uint8"] = _host_us(lambda: C.clahe_apply(l, lut, tiles, torch.uint8), ())
    for shape in (SHAPE, SERVE_SHAPE):
        teeth = x[: shape[0]]
        planes = fwd(teeth)
        both(f"K1 {list(shape)}", "K1", fwd, (teeth,))
        both(f"K2 {list(shape)}", "K2", bwd, planes)
        mismatches[f"K1 {list(shape)}"] = differ(planes, K.clahe_lab_fwd_lut_ref(teeth, clip, tiles))
        mismatches[f"K2 {list(shape)}"] = differ([bwd(*planes)], [K.clahe_apply_lab_bwd_ref(*planes, tiles)])
    every = torch.from_numpy(every_byte_triple()).to(dev)[None]
    mismatches["K1 every colour"] = differ(fwd(every), K.clahe_lab_fwd_lut_ref(every, clip, tiles))
    lq, da, db = (every[..., c].contiguous() for c in range(3))
    ident = torch.arange(256, dtype=torch.uint8, device=dev).expand(1, 64, 256).contiguous()
    triple = (lq, da.view(torch.int8), db.view(torch.int8), ident)
    mismatches["K2 every triple"] = differ([bwd(*triple)], [K.clahe_apply_lab_bwd_ref(*triple, tiles)])
    for shape in L_PROFILE_SHAPES:
        l = _l_teeth(torch, dev, x, shape)
        lut = C.clahe_hist_lut(l, clip, tiles)
        both(f"K8 {list(shape)}", "K8", lambda p: C.clahe_hist_lut(p, clip, tiles), (l,))
        mismatches[f"K8 {list(shape)}"] = differ([lut], [C.clahe_hist_lut_ref(l, clip, tiles)])
        for dt in (torch.uint8, torch.float32):
            key = f"K9 {list(shape)} {str(dt)[6:]}"
            both(key, "K9", lambda p, t, dt=dt: C.clahe_apply(p, t, tiles, dt), (l, lut))
            mismatches[key] = differ([C.clahe_apply(l, lut, tiles, dt)], [C.clahe_apply_ref(l, lut, tiles, dt)])
        del l, lut
    return mismatches


def kernel_launch_costs(torch, dev, host):
    from mmtrs_tpu_torch.ops.color import rgb_to_lab
    from mmtrs_tpu_torch.ops.kernels.clahe import clahe_apply, clahe_hist_lut, quantize_l
    from mmtrs_tpu_torch.synth import synth_teeth

    res = {}
    for what, rgb in (("serving_16x512x688", synth_teeth(16, (512, 688), seed=SEED + 5)),
                      ("archive_4x3024x4032", host)):
        l = quantize_l(rgb_to_lab(torch.from_numpy(rgb).to(dev).float())[..., 0]).contiguous()
        lut = clahe_hist_lut(l)
        for name, fn in (("clahe_hist_lut", lambda: clahe_hist_lut(l)),
                         ("clahe_apply_u8", lambda: clahe_apply(l, lut, out_dtype=torch.uint8))):
            res[f"{name}@{what}"] = {"one_call_ms": float(np.median([_events_ms(torch, fn, 1) for _ in range(20)])),
                                     "back_to_back_ms": _events_ms(torch, fn, 100)}
    return res


def serving_request(torch, dev):
    from mmtrs_tpu_torch.ops.resize import resize_bilinear_u8
    from mmtrs_tpu_torch.preprocess import _clahe_lab_stage
    from mmtrs_tpu_torch.serve.service import PredictService
    from mmtrs_tpu_torch.synth import synth_teeth

    img = synth_teeth(1, (768, 1024), seed=SEED + 10, angles_deg=[25.0])[0]
    svc = PredictService(mil_predict=lambda im: 0.5, device=dev)
    svc.preprocess(img)  # warm-up
    x = torch.from_numpy(img).to(dev)
    ms = {}
    for _ in range(5):
        r, t_resize = _sync_ms(torch, lambda: resize_bilinear_u8(x, (512, 688)))
        _, t_clahe = _sync_ms(torch, lambda: _clahe_lab_stage(r[None], 3.0, (8, 8)))
        _, t_all = _sync_ms(torch, lambda: svc.preprocess(img))
        for k, v in (("resize_bilinear_u8", t_resize), ("clahe_stage", t_clahe), ("preprocess", t_all)):
            ms.setdefault(k, []).append(v)
    return {k: float(np.median(v)) for k, v in ms.items()}


def _busy(torch, fn, top_n: int = 3) -> dict:
    """One call of ``fn`` under torch.profiler: its wall ms, the device's busy
    ms (DeviceType.CUDA events only: host ops carry a device time too), the
    share, the device events launched and the ``top_n`` largest by device
    ms."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    items = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in items) / 1e3
    top = sorted(items, key=lambda e: -e.self_device_time_total)[:top_n]
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms, "busy_share": busy_ms / wall_ms,
            "device_events": sum(e.count for e in items),
            "top_device_ms": {e.key[:90]: e.self_device_time_total / 1e3 for e in top}}


@contextlib.contextmanager
def _phase8_service(torch, dev):
    """(weights folder, service): chip_smoke.py phase 8's folder, written
    anew under build/ (5 bf16 B4 MM folds at 380, 5 bf16 B0 MIL folds, 5
    forests, the repo's OOF CSVs), and the service built from it on the
    card; the folder is removed on exit."""
    import tempfile

    from chip_smoke import _write_weights
    from mmtrs_tpu_torch.serve.ensembles import build_service_from_weights

    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        _write_weights(torch, dev, Path(tmp))
        yield Path(tmp), build_service_from_weights(tmp)


def full_service(torch, dev):
    """Phase 8's service: after a warm-up, one fused-route 512x512 request
    with all 9 fields, then its MM and MIL stages alone, each under
    torch.profiler (``_busy``)."""
    from chip_smoke import FUSED_UPLOADS, _field_rows
    from mmtrs_tpu_torch.serve.choices import encode_fields
    from mmtrs_tpu_torch.synth import synth_teeth

    with _phase8_service(torch, dev) as (_, svc):
        img = synth_teeth(1, FUSED_UPLOADS[0], seed=SEED + 10, angles_deg=[25.0])[0]
        fields = _field_rows(1, SEED + 50)[0]
        tab = encode_fields(fields)
        for _ in range(2):  # warm-up: cuDNN plans, allocator
            svc.predict_one(img, fields=fields)
        proc = svc.preprocess(img)
        return {"request": _busy(torch, lambda: svc.predict_one(img, fields=fields)),
                "mm_stage": _busy(torch, lambda: svc.mm_predict(proc, tab)),
                "mil_stage": _busy(torch, lambda: svc.mil_predict(proc))}


def train_step(torch, dev):
    """The MM trainer's bf16 step on chip_smoke.py phase 10's widths: 24
    synthetic 512² teeth on the card, random fields and labels, after 3
    warm-up steps: stage ms on the host clock, then ``_busy`` of the prep
    and of forward + backward + AdamW, and the host syncs of one whole step
    (``torch.cuda.set_sync_debug_mode``)."""
    import warnings

    from mmtrs_tpu_torch.config import MMJointConfig
    from mmtrs_tpu_torch.synth import synth_teeth
    from mmtrs_tpu_torch.train.mm import MMTrainer

    cfg = MMJointConfig()
    rng = np.random.default_rng(SEED + 70)
    n = 24
    imgs = torch.from_numpy(synth_teeth(n, 512, seed=SEED + 71)).to(dev)
    tab = torch.from_numpy(rng.normal(0, 1, (n, 9)).astype(np.float32)).to(dev)
    y = torch.from_numpy((rng.random(n) < 0.5).astype(np.float32)).to(dev)
    p = torch.from_numpy(rng.random(n).astype(np.float32)).to(dev)
    tr = MMTrainer(cfg)
    tr.init_state(100)
    batches = [np.sort(rng.choice(n, cfg.batch_size, replace=False)) for _ in range(12)]

    def args(i):
        sel = batches[i % len(batches)]
        sel_d = torch.from_numpy(sel).to(dev)
        return sel, sel_d

    def prep(i):
        sel, sel_d = args(i)
        return tr._prep_train(imgs.index_select(0, sel_d), sel, 0), sel_d

    for i in range(3):  # warm-up: cuDNN plans, allocator, lazy modules
        x, sel_d = prep(i)
        tr.train_step(x, tab[sel_d], y[sel_d], p[sel_d])
    stages = {"prep": [], "forward": [], "backward": [], "adamw": []}
    for i in range(5):
        t = [time.perf_counter()]
        x, sel_d = prep(i)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        loss = tr.loss(x, tab[sel_d], y[sel_d], p[sel_d])
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        tr.backward(loss)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        tr.opt.step()
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        for k, a, b in zip(stages, t, t[1:]):
            stages[k].append((b - a) * 1e3)
    x, sel_d = prep(5)
    out = {"stage_ms": {k: float(np.median(v)) for k, v in stages.items()},
           "prep": _busy(torch, lambda: prep(6)),
           "step": _busy(torch, lambda: tr.train_step(x, tab[sel_d], y[sel_d], p[sel_d]), top_n=8)}
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            x, sel_d = prep(7)
            tr.train_step(x, tab[sel_d], y[sel_d], p[sel_d])
        finally:
            torch.cuda.set_sync_debug_mode("default")
    out["host_syncs_per_step"] = sum("synchroniz" in str(w.message) for w in caught)
    out["params"] = sum(q.numel() for q in tr.model.parameters())
    return out


def _host_syncs(torch, fn) -> int:
    """The host syncs one call of ``fn`` makes
    (``torch.cuda.set_sync_debug_mode("warn")``)."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def mil_train_step(torch, dev):
    """The MIL trainer's bf16 step on chip_smoke.py phase 11's widths: 24
    synthetic 512² teeth on the card, random labels, after 3 warm-up steps:
    stage ms on the host clock, then ``_busy`` of the bags and of forward +
    backward + AdamW, and the host syncs of one whole step."""
    from mmtrs_tpu_torch.config import MILConfig
    from mmtrs_tpu_torch.synth import synth_teeth
    from mmtrs_tpu_torch.train.mil import MILTrainer

    cfg = MILConfig(batch_size=16)
    rng = np.random.default_rng(SEED + 91)
    n = 24
    imgs = torch.from_numpy(synth_teeth(n, 512, seed=SEED + 92)).to(dev)
    y = torch.from_numpy((rng.random(n) < 0.5).astype(np.float32)).to(dev)
    tr = MILTrainer(cfg)
    tr.init_state(100)
    batches = [np.sort(rng.choice(n, cfg.batch_size, replace=False)) for _ in range(12)]

    def bags(i):
        sel = batches[i % len(batches)]
        sel_d = torch.from_numpy(sel).to(dev)
        return tr.train_bags(imgs.index_select(0, sel_d), cfg.seed, sel), sel_d

    for i in range(3):  # warm-up: cuDNN plans, allocator
        b, sel_d = bags(i)
        tr.train_step(b, y[sel_d])
    stages = {"bags": [], "forward": [], "backward": [], "adamw": []}
    for i in range(5):
        t = [time.perf_counter()]
        b, sel_d = bags(i)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        loss = tr.loss(b, y[sel_d])
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        tr.backward(loss)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        tr.opt.step()
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        for k, a, c in zip(stages, t, t[1:]):
            stages[k].append((c - a) * 1e3)
    b, sel_d = bags(5)
    out = {"stage_ms": {k: float(np.median(v)) for k, v in stages.items()},
           "bags": _busy(torch, lambda: bags(6)),
           "step": _busy(torch, lambda: tr.train_step(b, y[sel_d]), top_n=8)}

    def one_step():
        b2, s2 = bags(7)
        tr.train_step(b2, y[s2])

    out["host_syncs_per_step"] = _host_syncs(torch, one_step)
    out["params"] = sum(q.numel() for q in tr.model.parameters())
    return out


def gbdt_fit(torch, dev):
    """``train_gbdt(stack_tab_like)`` on chip_smoke.py phase 11's table
    (3,010 + 752 rows × 9): a 700-tree forest on the host clock (after a
    5-tree warm-up), a 20-tree fit under ``_busy``, and the host syncs of
    a 20-tree fit."""
    import chip_smoke as cs
    from mmtrs_tpu_torch.config import GBDTConfig
    from mmtrs_tpu_torch.models.gbdt import GBDTDraws, train_gbdt

    cfg = GBDTConfig.stack_tab_like()
    X, y = cs._gbdt_table(cs.GBDT_ROWS)
    n_tr = int(cs.GBDT_ROWS * 0.8)
    draws = GBDTDraws.draw(cfg, n_tr, X.shape[1])

    def fit(trees):
        c = GBDTConfig(**{**cfg.__dict__, "n_estimators": trees})
        return train_gbdt(X[:n_tr], y[:n_tr], c, X_val=X[n_tr:], y_val=y[n_tr:],
                          draws=GBDTDraws(draws.col_keep[:trees], draws.row_keep[:trees]), device=dev)

    fit(5)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fit(cfg.n_estimators)
    torch.cuda.synchronize()
    out = {"forest_s": time.perf_counter() - t0, "trees": cfg.n_estimators, "rows": [n_tr, cs.GBDT_ROWS - n_tr]}
    busy = _busy(torch, lambda: fit(20), top_n=8)
    out["fit20"] = busy
    out["device_events_per_tree"] = busy["device_events"] / 20
    out["host_syncs_per_fit"] = _host_syncs(torch, lambda: fit(20))
    return out


F32_READ_BATCHES = 8


def f32_step(torch, dev):
    """The gaps of chip_smoke.py phase 10's f32 step, card vs CPU, each with
    whether it meets the F32_* bars (``_f32_step_ok``): see the module's
    docstring."""
    from chip_smoke import (F32_STEP_BATCH, TRAIN_AUG, TRAIN_CASES, _f32_step_check, _f32_step_ok,
                            _train_cohort)
    from mmtrs_tpu_torch.data.records import build_augmented_table, quantize_round_half_even
    from mmtrs_tpu_torch.preprocess import preprocess_batch

    table, raw = _train_cohort(TRAIN_CASES)  # phase 10's lineage table, built as phase 10 builds it
    proc, _ = preprocess_batch(torch.from_numpy(raw).to(dev))
    aug_table, aug_imgs = build_augmented_table(table, quantize_round_half_even(proc), n_aug=TRAIN_AUG,
                                                preset="legacy", seed=42, test_frac=0.19)
    tv = np.nonzero(aug_table["split"] != "test")[0]
    runs = [(b, False) for b in [0] + list(range(F32_READ_BATCHES))] + [(0, True)]
    readings = []
    for b, tf32 in runs:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            lc, lg, gaps = _f32_step_check(torch, dev, aug_table, aug_imgs,
                                           tv[b * F32_STEP_BATCH:(b + 1) * F32_STEP_BATCH])
        finally:
            torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        by_leaf = gaps.pop("grad_by_leaf")
        worst = sorted(by_leaf.items(), key=lambda kv: -kv[1][0])[:5]
        readings.append({"batch": b, "tf32": tf32, "loss_cpu": lc, "loss_card": lg, **gaps,
                         "meets_bars": _f32_step_ok(gaps), "worst_grad_leaves": dict(worst)})
        print(json.dumps(readings[-1]))
    return {"readings": readings}


def bf16_spread(torch, dev):
    """Phase 8's image streams on each of phase 4's seven uploads (processed
    as served): |dp| of the served bf16 MM (with all 9 fields, and
    without) and MIL streams against the same folds read onto the CPU in
    bf16 and in f32, and of the MM ensemble in f32 on the card against
    the CPU (TF32 off): what chip_smoke.py's SERVE_BF16_BAR and
    SERVE_F32_BAR stand on."""
    from chip_smoke import FUSED_UPLOADS, PHONE_UPLOADS, _field_rows, _recipe
    from mmtrs_tpu_torch.models.mil import MILNet
    from mmtrs_tpu_torch.models.mm_joint import MMJointDualHead
    from mmtrs_tpu_torch.serve.choices import encode_fields
    from mmtrs_tpu_torch.serve.ensembles import MILEnsemble, MMEnsemble
    from mmtrs_tpu_torch.synth import synth_teeth

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    tab = encode_fields(_field_rows(1, SEED + 50)[0])
    with _phase8_service(torch, dev) as (root, svc):
        mm, mil = svc.mm_predict.__self__, svc.mil_predict.__self__
        mm16 = MMEnsemble.from_folder(root / "mm_dualtask_v1", device="cpu")
        mil16 = MILEnsemble.from_folder(root / "mil_v1", device="cpu")
        mm_r, mil_r = _recipe("mm", "mm_dualtask_fold0"), _recipe("mil", "mil_v1_fold0")
        f32 = MMJointDualHead(mm_r["model_name"], dtype=torch.float32)
        mm32, mm32_card = MMEnsemble(mm16.folds, f32, device="cpu"), MMEnsemble(mm.folds, f32, device=dev)
        mil32 = MILEnsemble([n.state_dict() for n in mil16.nets],
                            MILNet(mil_r["model_name"], mil_r["attn_dim"], dtype=torch.float32), device="cpu")
        rows = []
        for i, shape in enumerate(FUSED_UPLOADS + PHONE_UPLOADS):
            img = synth_teeth(1, shape, seed=SEED + 10 + i, angles_deg=[25.0 + 5 * i])[0]
            proc = svc.preprocess(img)
            row = {"upload": list(shape)}
            for name, ens, e16, e32, args in (("mm_fields", mm, mm16, mm32, (proc, tab)),
                                              ("mm_no_fields", mm, mm16, mm32, (proc, None)),
                                              ("mil", mil, mil16, mil32, (proc,))):
                p, p16, p32 = ens.predict(*args), e16.predict(*args), e32.predict(*args)
                row[name] = {"p_card_bf16": p, "dp_cpu_bf16": abs(p - p16), "dp_cpu_f32": abs(p - p32),
                             "dp_cpu_bf16_vs_f32": abs(p16 - p32)}
                if e32 is mm32:
                    row[name]["dp_f32_card_vs_cpu"] = abs(mm32_card.predict(*args) - p32)
            rows.append(row)
    streams = ("mm_fields", "mm_no_fields", "mil")
    return {"uploads": rows,
            "max_dp_card_vs_cpu_bf16": {k: max(r[k]["dp_cpu_bf16"] for r in rows) for k in streams},
            "max_dp_f32_card_vs_cpu": max(r[k]["dp_f32_card_vs_cpu"] for r in rows for k in streams[:2])}


def _cuobjdump() -> str | None:
    """The toolkit's cuobjdump: on PATH, or beside the nvcc that builds the
    kernels."""
    import shutil

    from mmtrs_tpu_torch import _build

    cand = Path(_build._nvcc()).parent / "cuobjdump"
    return shutil.which("cuobjdump") or (str(cand) if cand.exists() else None)


_SASS_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_SASS_LABEL = re.compile(r"^\s*(\.L_x_\d+):")


def loop_bodies(sass: str) -> list[int]:
    """Instruction counts of the loops of one function's SASS listing, the
    largest first: each backward branch closes a loop from its target to
    itself. Branch targets are printed as addresses or as ``.L_x_N``
    labels, depending on the toolkit."""
    addrs, labels, branches, pending = [], {}, [], []
    for line in sass.splitlines():
        m = _SASS_LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = _SASS_LINE.search(line)
        if not m:
            continue
        addr, text = int(m.group(1), 16), m.group(2)
        addrs.append(addr)
        for name in pending:
            labels[name] = addr
        pending = []
        if re.search(r"\bBRA\b", text):
            t = re.search(r"(\.L_x_\d+)|0x([0-9a-f]+)", text.split("BRA", 1)[1])
            if t:
                branches.append((addr, t.group(1) or int(t.group(2), 16)))
    loops = []
    for addr, target in branches:
        t = labels.get(target) if isinstance(target, str) else target
        if t is not None and t <= addr:
            loops.append(sum(1 for a in addrs if t <= a <= addr))
    return sorted(loops, reverse=True)


def sass_counts(torch):
    """SASS instructions of K1's and K2's device functions in the library
    this tree builds: each function's total, and its largest loop (the
    per-pixel loop of a kernel that walks pixels: 4 pixels an iteration in
    this tree's, 1 in the parent's K1; the parent's K2 has no loop, one
    thread a pixel, so its total is its per-pixel body). The static counts
    leave out the division's slow path, a subroutine outside the loop.
    Also ``nvcc -Xptxas -v`` of csrc/clahe_lab.cu (registers, spills) and
    the SM clocks ``nvidia-smi`` reads."""
    from mmtrs_tpu_torch import _build

    lib = _build.library()
    tool = _cuobjdump()
    res = {"cuobjdump": tool, "functions": {}}
    if tool:
        dump = subprocess.run([tool, "-sass", lib._name], capture_output=True, text=True).stdout
        for chunk in dump.split("Function : ")[1:]:
            name = chunk.split(None, 1)[0]
            if any(t in name for k in ("K1", "K2") for t in LINE_KERNEL_NAMES[k]):
                loops = loop_bodies(chunk)
                res["functions"][name] = {"instructions": len(_SASS_LINE.findall(chunk)),
                                          "largest_loop": loops[0] if loops else None, "loops": loops[:6]}
    obj = _build.BUILD_DIR / "ptxas_probe.o"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c", str(_build.CSRC / "clahe_lab.cu"), "-o", str(obj)]
    out = subprocess.run(cmd, capture_output=True, text=True)
    obj.unlink(missing_ok=True)
    res["ptxas"] = [ln.strip() for ln in (out.stdout + out.stderr).splitlines() if "registers" in ln or "spill" in ln
                    or "Compiling entry" in ln]
    res["clocks_sm_mhz"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True).stdout.strip()
    return res


_NVDISASM_LOC = re.compile(r'"([^"]+)", line (\d+)')


def _spans(src: Path, names) -> dict:
    """Source lines [first, last] of each function in ``names`` in ``src``:
    from the line that defines it to the first later line that is a lone
    closing brace at column 0."""
    lines = src.read_text().splitlines()
    spans = {}
    for name in names:
        for i, ln in enumerate(lines):
            if re.search(rf"\b{name}\(", ln) and not ln.startswith((" ", "/")) and ln.rstrip().endswith(("{", ",")):
                end = next(j for j in range(i, len(lines)) if lines[j] == "}")
                spans[name] = (i + 1, end + 1)
                break
    return spans


def k5_sass():
    """K5's static SASS instruction counts per path, from ``nvdisasm -gi`` of
    csrc/photometric.cu compiled to a cubin with ``-lineinfo`` (which leaves
    the code as the library builds it). An instruction counts for each
    function of the file in its chain of inlined source lines. A kernel
    that walks a chunk's pixels in loops (this tree's) has one loop a pixel
    for each mix of stages: ``hsv_path`` is the largest loop with
    ``hsv_shift`` and without ``normal_of``, ``noise_path`` the reverse,
    ``hsv_noise_path`` the largest with both; ``light_stage1`` is the
    instructions of ``map_word`` a pixel (stage 1 on a chunk in registers).
    A kernel of one thread a pixel (the parent's) has no such loop: its
    whole body is one pixel, less ``normal_of`` on the HSV path and less
    ``hsv_shift`` on the noise path. Static counts include branches a
    pixel never takes (fmodf's and cosf's slow paths)."""
    import shutil

    from mmtrs_tpu_torch import _build

    src = _build.CSRC / "photometric.cu"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cubin = _build.BUILD_DIR / "k5_sass_probe.cubin"
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xcompiler", "-fPIC")]
    res = subprocess.run([_build._nvcc(), *flags, "-lineinfo", "-cubin", str(src), "-o", str(cubin)],
                         capture_output=True, text=True)
    tool = shutil.which("nvdisasm") or str(Path(_build._nvcc()).parent / "nvdisasm")
    if res.returncode != 0 or not Path(tool).exists():
        return {"error": (res.stdout + res.stderr)[-2000:] or "no nvdisasm"}
    dump = subprocess.run([tool, "-gi", "-c", str(cubin)], capture_output=True, text=True).stdout
    cubin.unlink(missing_ok=True)
    spans = _spans(src, ("hsv_shift", "normal_of", "map_word", "run_pixel", "heavy_chunk"))
    # (address, functions) of each instruction, and the backward branches
    instrs, labels, branches, chain, fresh = [], {}, [], [], True
    pending = []
    for line in dump.splitlines():
        if "//##" in line:  # a chain of inlined locations, one comment line a level
            chain = (chain if not fresh else []) + [
                int(n) for f, n in _NVDISASM_LOC.findall(line) if f.endswith("photometric.cu")]
            fresh = False
            continue
        fresh = True
        m = _SASS_LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = _SASS_LINE.search(line)
        if not m:
            continue
        addr, text = int(m.group(1), 16), m.group(2)
        for name in pending:
            labels[name] = addr
        pending = []
        instrs.append((addr, {k for k, (a, b) in spans.items() if any(a <= n <= b for n in chain)}))
        if re.search(r"\bBRA\b", text):
            t = re.search(r"(\.L_x_\d+)|0x([0-9a-f]+)", text.split("BRA", 1)[1])
            if t:
                branches.append((addr, t.group(1) or int(t.group(2), 16)))
    loops = []
    for addr, target in branches:
        lo = labels.get(target) if isinstance(target, str) else target
        if lo is not None and lo <= addr:
            body = [fns for a, fns in instrs if lo <= a <= addr]
            loops.append({"instructions": len(body), **{k: sum(k in fns for fns in body) for k in spans}})
    loops.sort(key=lambda lp: -lp["instructions"])
    total = {k: sum(k in fns for _, fns in instrs) for k in spans}
    px = re.search(r"constexpr int kPx = (\d+);", src.read_text())
    largest = lambda hsv, noise: max((lp["instructions"] for lp in loops
                                      if (lp.get("hsv_shift", 0) > 0) == hsv and (lp.get("normal_of", 0) > 0) == noise),
                                     default=None)
    if "heavy_chunk" in spans:
        per_pixel = {"hsv_path": largest(True, False), "noise_path": largest(False, True),
                     "hsv_noise_path": largest(True, True),
                     "light_stage1": total.get("map_word", 0) / int(px.group(1)) if px else None}
    else:
        per_pixel = {"all_stages": len(instrs), "hsv_path": len(instrs) - total.get("normal_of", 0),
                     "noise_path": len(instrs) - total.get("hsv_shift", 0)}
    return {"instructions": len(instrs), "by_function": total, "loops": loops[:8], "per_pixel": per_pixel}


def main() -> int:
    if not (ROOT / "mmtrs_tpu_torch" / "csrc").is_dir():
        print("chip_profile: run from the repository", file=sys.stderr)
        return 1
    import torch

    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from mmtrs_tpu_torch.synth import synth_teeth

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    modes = {"--line-times": line_times,
             "--sass": lambda torch, dev: {**sass_counts(torch), "K5": k5_sass()},
             "--service": full_service,
             "--train": train_step,
             "--f32-step": f32_step,
             "--mil-train": mil_train_step,
             "--gbdt": gbdt_fit,
             "--bf16-spread": bf16_spread}
    if sys.argv[1:2] and sys.argv[1] in modes:
        result = modes[sys.argv[1]](torch, dev)
        print(smi)
        print(json.dumps(result))
        return 0
    B, H, W, _ = ARCHIVE_SHAPE
    host = synth_teeth(B, (H, W), seed=SEED + 6, angles_deg=[30.0, -25.0] + [0.0] * (B - 2))
    archive_stages(torch, dev, host)  # warm-up
    result = {
        "archive_stage_ms": archive_stages(torch, dev, host),
        "archive_profile": archive_profile(torch, dev, host),
        "kernels": kernel_launch_costs(torch, dev, host),
        "serving_768x1024_ms": serving_request(torch, dev),
        "legacy_b32_profile": legacy_profile(torch, dev),
    }
    print(smi)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
