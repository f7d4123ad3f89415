"""The L-plane CLAHE route of the port (kernels K8 and K9, ``clahe_dispatch``,
``_clahe_lab_stage``), serving's Pillow-free bucket resize, the card as the
default device, and ``preprocess_stream``, held against the JAX package on
the CPU.

The JAX side runs as its own CPU tests run it: the Pallas kernels in
interpret mode, or the XLA oracle. On the CPU the kernel wrappers take their
plain versions; ``chip_smoke.py`` holds the kernels to those on the card.
Inputs come from numpy seeds.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tests.synth import synth_images


def _t(a):
    return torch.from_numpy(np.array(a))


def _q(a):
    return np.floor(np.clip(np.asarray(a), 0.0, 255.0) + 0.5)


def _l_plane(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(np.uint8)


# -- K8 and K9: plain versions against the Pallas kernels --------------------------


@pytest.mark.parametrize("tiles", [(4, 4), (8, 8)])
def test_hist_lut_plain_bit_equal_to_pallas_hist_lut_kernel(tiles):
    """K8's plain version against #10, ``_hist_lut_kernel`` itself (one tile
    row per grid step, grid (B, ty)), in interpret mode as
    scripts/exp_grid_r5.py:231-248 calls it, at u8 L [2, 64, 96]: the LUTs
    bit-equal."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu
    from mmtrs_tpu.ops.pallas.clahe_kernel import N_BINS, _hist_lut_kernel
    from mmtrs_tpu_torch.ops.kernels.clahe import clahe_hist_lut

    l = _l_plane((2, 64, 96), seed=5)
    B, H, W = l.shape
    ty, tx = tiles
    th, tw = H // ty, W // tx
    area, n = th * tw, ty * tx
    tiled = jnp.asarray(l).reshape(B, ty, th, tx, tw).transpose(0, 1, 3, 2, 4).reshape(B, n, 1, area)
    lut = pl.pallas_call(
        partial(_hist_lut_kernel, area=area, clip=3.0, tiles_per_step=tx),
        out_shape=jax.ShapeDtypeStruct((B, n, 1, N_BINS), jnp.float32),
        grid=(B, ty),
        in_specs=[pl.BlockSpec((1, tx, 1, area), lambda b, i: (b, i, 0, 0), memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((1, tx, 1, N_BINS), lambda b, i: (b, i, 0, 0), memory_space=pltpu.VMEM),
        interpret=True,
    )(tiled)
    got = clahe_hist_lut(_t(l), 3.0, tiles)
    assert got.dtype == torch.uint8 and got.shape == (B, n, N_BINS)
    np.testing.assert_array_equal(got.numpy().astype(np.float32), np.asarray(lut)[:, :, 0, :])


@pytest.mark.parametrize("out_dtype", ["float32", "uint8"])
def test_apply_plain_bit_equal_to_clahe_pallas(out_dtype):
    """K8 + K9's plain versions (``clahe_l``) against ``clahe_pallas`` in
    interpret mode at u8 L [2, 64, 128] (tiles 16 × 32 px): f32 and u8
    round-half-up outputs bit-equal."""
    from mmtrs_tpu.ops.pallas.clahe_kernel import clahe_pallas
    from mmtrs_tpu_torch.ops.kernels.clahe import clahe_l

    l = _l_plane((2, 64, 128), seed=5)
    want = np.asarray(clahe_pallas(jnp.asarray(l), tiles=(4, 4), interpret=True,
                                   out_dtype=getattr(jnp, out_dtype)))
    got = clahe_l(_t(l), 3.0, (4, 4), out_dtype=getattr(torch, out_dtype)).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_apply_plain_within_an_ulp_where_tile_fractions_are_inexact():
    """At u8 L [2, 64, 96] (tiles 16 × 24 px) x/24 is inexact in f32, and the
    three blends round it differently: K9 divides (true division, as K2 and
    the oracle's formula), the JAX oracle under XLA multiplies by the
    reciprocal, ``clahe_pallas`` blends with host-made f64 quadrant weights.
    The LUTs are equal; the f32 blends agree within 1e-4 (measured 3.05e-5)
    and the u8 stores within 1 level on ≤ 0.5 % of values (measured 0.20 %
    against clahe_pallas)."""
    from mmtrs_tpu.ops.clahe import clahe as jclahe
    from mmtrs_tpu.ops.pallas.clahe_kernel import clahe_pallas
    from mmtrs_tpu_torch.ops.kernels.clahe import clahe_l

    l = _l_plane((2, 64, 96), seed=5)
    got = clahe_l(_t(l), 3.0, (4, 4)).numpy()
    got_u8 = clahe_l(_t(l), 3.0, (4, 4), out_dtype=torch.uint8).numpy().astype(int)
    for want in (np.asarray(jclahe(jnp.asarray(l, jnp.float32), tiles=(4, 4))),
                 np.asarray(clahe_pallas(jnp.asarray(l), tiles=(4, 4), interpret=True))):
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
        d = np.abs(got_u8 - _q(want))
        assert d.max() <= 1 and (d == 0).mean() >= 0.995, (d.max(), (d == 0).mean())


# -- clahe_dispatch and clahe_rgb ----------------------------------------------------


@pytest.mark.parametrize("shape,tiles", [((2, 64, 96), (8, 8)), ((1, 96, 136), (8, 8)), ((2, 64, 80), (4, 4))])
def test_clahe_dispatch_matches_jax(shape, tiles):
    """An f32 L plane (rounded half-even to u8 inside, as ``clahe_pallas``)
    through the port's ``clahe_dispatch``: bit-equal to the port's plain
    ``clahe``, and against JAX ``clahe_dispatch`` on the CPU (the XLA
    oracle) within 1e-4 in f32, its u8 store within 1 level on ≤ 0.5 % of
    values (the tile fractions' rounding, test above)."""
    from mmtrs_tpu.ops.clahe import clahe_dispatch as jdispatch
    from mmtrs_tpu_torch.ops.clahe import clahe, clahe_dispatch

    l = (np.random.default_rng(3).random(shape) * 255).astype(np.float32)
    got = clahe_dispatch(_t(l), 3.0, tiles).numpy()
    np.testing.assert_array_equal(got, clahe(_t(l), tiles=tiles).numpy())
    want = np.asarray(jdispatch(jnp.asarray(l), tiles=tiles, use_pallas=False))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    d = np.abs(_q(got) - _q(want))
    assert d.max() <= 1 and (d == 0).mean() >= 0.995, (d.max(), (d == 0).mean())


@pytest.mark.parametrize("quant_l", [False, True])
def test_clahe_rgb_matches_jax_at_an_l_plane_shape(quant_l):
    """``clahe_rgb`` (rounded LAB → ``clahe_dispatch`` → RGB) at [2, 64, 80, 3],
    a shape the fused kernels refuse, against JAX ``clahe_rgb``: within 1e-3
    (the colour conversions' ULP differences) on ≥ 99.5 % of values; with
    the u8 L′ store a tile fraction's rounding (tiles 8 × 10 px) moves L′ by
    a level on a few pixels, so max ≤ 1.5 (measured 0.18 % beyond 1e-3, max
    1.14); without it max ≤ 1e-3."""
    from mmtrs_tpu.ops.clahe import clahe_rgb as jclahe_rgb
    from mmtrs_tpu_torch.ops.clahe import clahe_rgb

    imgs = synth_images(2, 80, seed=12)[:, :64].astype(np.float32)
    want = np.asarray(jclahe_rgb(jnp.asarray(imgs), quant_l=quant_l, use_pallas=False))
    d = np.abs(clahe_rgb(_t(imgs), quant_l=quant_l).numpy() - want)
    assert (d <= 1e-3).mean() >= 0.995 and d.max() <= (1.5 if quant_l else 1e-3), ((d <= 1e-3).mean(), d.max())


# -- the route choice ------------------------------------------------------------------


def _k1k2_everywhere(monkeypatch):
    import mmtrs_tpu_torch.preprocess as tp

    monkeypatch.setattr(tp, "supports", lambda H, W, tiles: True)


def test_clahe_stage_matches_jax_cpu_route_and_beats_the_fused_route(monkeypatch):
    """The CLAHE stage at [2, 96, 136, 3] (W % 128 ≠ 0, so the JAX package
    takes the L-plane route) against JAX ``_clahe_lab_stage`` on its XLA
    route, which on a TPU is bit-identical to the ``clahe_pallas`` route
    (tests/test_pallas_tpu.py:29): ≥ 99.8 % of u8 values equal, max ≤ 2
    (measured 99.93 %, max 1). The K1/K2 route at the same shape (i8 chroma
    lattice) is farther: measured 68.7 % equal, max 2."""
    import mmtrs_tpu_torch.preprocess as tp
    from mmtrs_tpu.preprocess import _clahe_lab_stage as jstage
    from mmtrs_tpu_torch.ops.kernels.clahe_lab import supports
    from mmtrs_tpu_torch.synth import synth_teeth

    imgs = synth_teeth(2, (96, 136), seed=5, angles_deg=[30.0, 4.0])
    assert not supports(96, 136)
    want = np.asarray(jstage(jnp.asarray(imgs), 3.0, (8, 8), False)).astype(int)
    got = tp._clahe_lab_stage(_t(imgs), 3.0, (8, 8))
    assert got.dtype == torch.uint8 and got.shape == imgs.shape
    d = np.abs(got.numpy().astype(int) - want)
    assert (d == 0).mean() >= 0.998 and d.max() <= 2, ((d == 0).mean(), d.max())
    _k1k2_everywhere(monkeypatch)
    d_fused = np.abs(tp._clahe_lab_stage(_t(imgs), 3.0, (8, 8)).numpy().astype(int) - want)
    assert (d_fused == 0).mean() < (d == 0).mean() - 0.1, ((d_fused == 0).mean(), (d == 0).mean())


@pytest.mark.parametrize("shape,seed,angles", [((96, 136), 5, [30.0, 4.0]), ((64, 80), 3, [25.0, -3.0])])
def test_preprocess_batch_matches_jax_at_an_l_plane_shape(monkeypatch, shape, seed, angles):
    """The repair: at an L-plane shape the port's ``preprocess_batch`` (one
    image rotated so deskew fires) against JAX ``preprocess_batch``
    (use_pallas=False): seg_valid equal, angles within 1e-3°, boxes within
    1 px, ≥ 99.9 % of u8 values within 1 level (measured: every value
    within 1, max 1, 93.0 % and 93.2 % equal; the rest is deskew's per-shear
    u8 store). The K1/K2 route at the same shape is farther: fewer values
    equal (measured 80.5 % and 80.0 %) and a larger max (2)."""
    import mmtrs_tpu_torch.preprocess as tp
    from mmtrs_tpu.preprocess import preprocess_batch as jpre
    from mmtrs_tpu_torch.synth import synth_teeth

    imgs = synth_teeth(2, shape, seed=seed, angles_deg=angles)
    jout, jinfo = jpre(jnp.asarray(imgs), out_size=64)
    out, info = tp.preprocess_batch(_t(imgs), out_size=64)
    assert np.asarray(jinfo["deskew_angle"])[0] != 0.0
    np.testing.assert_array_equal(info["seg_valid"].numpy(), np.asarray(jinfo["seg_valid"]))
    np.testing.assert_allclose(info["deskew_angle"].numpy(), np.asarray(jinfo["deskew_angle"]), atol=1e-3, rtol=0)
    assert np.abs(info["boxes"].numpy() - np.asarray(jinfo["boxes"])).max() <= 1.0
    d = np.abs(_q(out.numpy()) - _q(jout))
    assert (d <= 1).mean() >= 0.999, ((d <= 1).mean(), d.max())
    _k1k2_everywhere(monkeypatch)
    fused, _ = tp.preprocess_batch(_t(imgs), out_size=64)
    d_fused = np.abs(_q(fused.numpy()) - _q(jout))
    assert (d_fused == 0).mean() < (d == 0).mean() and d_fused.max() > d.max(), (
        (d_fused == 0).mean(), (d == 0).mean(), d_fused.max(), d.max())


def test_supports_shape_keeps_the_fused_route():
    """At [2, 64, 128, 3], a shape the fused kernels take, the stage is
    K1 → K2 (``clahe_lab_fused``) exactly as before."""
    from mmtrs_tpu_torch.ops.kernels.clahe_lab import clahe_lab_fused, supports
    from mmtrs_tpu_torch.preprocess import _clahe_lab_stage
    from mmtrs_tpu_torch.synth import synth_teeth

    imgs = _t(synth_teeth(2, (64, 128), seed=6))
    assert supports(64, 128)
    assert torch.equal(_clahe_lab_stage(imgs, 3.0, (8, 8)), clahe_lab_fused(imgs, 3.0, (8, 8)))


# -- serving: the bucket resize without Pillow, on the card by default ---------------------


@pytest.mark.parametrize(
    "upload,out_hw",
    [((1000, 750), (688, 512)), ((750, 1000), (512, 688)), ((576, 1024), (512, 912)),
     ((512, 680), (512, 688)), ((512, 688), (512, 688))],
)
def test_resize_bilinear_u8_bit_equal_to_pillow(upload, out_hw):
    """Pillow's BILINEAR resize of u8 RGB, bit for bit: the bucket shapes of
    portrait, landscape and 16:9 uploads, an upscale by 8 px and the
    identity, on a batch of two (each image against Pillow)."""
    from mmtrs_tpu_torch.ops.resize import resize_bilinear_u8
    from mmtrs_tpu_torch.serve.service import serve_bucket_shape

    if upload[1] != 680:
        assert serve_bucket_shape(*upload) == out_hw
    imgs = np.random.default_rng(sum(upload)).integers(0, 256, (2, *upload, 3)).astype(np.uint8)
    got = resize_bilinear_u8(_t(imgs), out_hw).numpy()
    for img, g in zip(imgs, got):
        np.testing.assert_array_equal(g, np.asarray(Image.fromarray(img).resize(out_hw[::-1], Image.BILINEAR)))
    np.testing.assert_array_equal(resize_bilinear_u8(_t(imgs[0]), out_hw).numpy(), got[0])


@pytest.mark.parametrize("upload", [(768, 1024), (1024, 768), (576, 1024)])
def test_phone_upload_preprocess_matches_jax_service(upload):
    """A phone-shaped upload through the port's ``PredictService.preprocess``
    (resize to the 512×688, 688×512 or 512×912 bucket, then the L-plane
    route) against the JAX service's (Pillow, then its CPU route), deskew
    firing: ≥ 99.99 % of u8 values within 1 level and max ≤ 3 (measured:
    88.2–90.8 % equal; 3 values of the 512×912 upload beyond 1 level, max 3,
    from deskew's per-shear u8 store)."""
    from mmtrs_tpu.serve.service import PredictService as JaxService
    from mmtrs_tpu_torch.serve.service import PredictService
    from mmtrs_tpu_torch.synth import synth_teeth

    img = synth_teeth(1, upload, seed=11, angles_deg=[25.0])[0]
    want = JaxService().preprocess(img)
    got = PredictService(device="cpu").preprocess(img)
    assert got.shape == want.shape == (512, 512, 3) and got.dtype == np.uint8
    d = np.abs(got.astype(int) - want.astype(int))
    assert (d <= 1).mean() >= 0.9999 and d.max() <= 3, ((d <= 1).mean(), d.max())


def test_serving_a_phone_upload_imports_no_pillow():
    """In a fresh interpreter a 600×800 upload is answered and Pillow is
    never imported."""
    import subprocess
    import sys
    from pathlib import Path

    code = (
        "import sys\n"
        "from mmtrs_tpu_torch.serve.service import PredictService\n"
        "from mmtrs_tpu_torch.synth import synth_teeth\n"
        "r = PredictService(mil_predict=lambda img: 0.25, device='cpu').predict_one(synth_teeth(1, (600, 800), seed=2)[0])\n"
        "print(r['label'], r['processed_image'].shape, 'PIL' in sys.modules)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=Path(__file__).resolve().parents[1],
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["Direct", "(512,", "512,", "3)", "False"], res.stdout


@pytest.mark.parametrize("entry", ["PredictService", "preprocess_numpy", "preprocess_stream", "resolve_device"])
def test_entry_points_default_to_the_card(entry):
    """With no device, an entry point asks for the card; this machine has
    none, so it raises instead of running on the CPU."""
    from mmtrs_tpu_torch.device import resolve_device
    from mmtrs_tpu_torch.preprocess import preprocess_numpy, preprocess_stream
    from mmtrs_tpu_torch.serve.service import PredictService

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    imgs = np.zeros((1, 64, 64, 3), np.uint8)
    calls = {
        "PredictService": lambda: PredictService(mil_predict=lambda img: 0.5),
        "preprocess_numpy": lambda: preprocess_numpy(imgs),
        "preprocess_stream": lambda: next(preprocess_stream(iter([(0, imgs)]))),
        "resolve_device": lambda: resolve_device(),
    }
    with pytest.raises(RuntimeError, match="no CUDA device; pass device='cpu'"):
        calls[entry]()
    assert resolve_device("cpu") == torch.device("cpu")


# -- the archive pass ---------------------------------------------------------------------


def test_preprocess_stream_in_order_and_equal_to_preprocess_batch():
    """Three batches of u8 [2, 96, 136, 3] (an L-plane shape) through
    ``preprocess_stream``: metas come back in input order, and each batch
    equals ``preprocess_batch`` of it cast to u8 (and its info)."""
    from mmtrs_tpu_torch.config import PreprocessConfig
    from mmtrs_tpu_torch.ops.clahe import quantize_u8
    from mmtrs_tpu_torch.preprocess import preprocess_batch, preprocess_stream
    from mmtrs_tpu_torch.synth import synth_teeth

    cfg = PreprocessConfig(output_size=64)
    batches = [(f"b{i}", synth_teeth(2, (96, 136), seed=20 + i, angles_deg=[20.0 * i, 0.0])) for i in range(3)]
    got = list(preprocess_stream(iter(batches), cfg, device="cpu"))
    assert [m for m, _, _ in got] == ["b0", "b1", "b2"]
    for (_, host), (_, out_u8, info) in zip(batches, got):
        want, want_info = preprocess_batch(_t(host), out_size=64)
        assert out_u8.dtype == np.uint8 and out_u8.shape == (2, 64, 64, 3)
        np.testing.assert_array_equal(out_u8, quantize_u8(want).numpy())
        for k, v in want_info.items():
            np.testing.assert_array_equal(info[k], v.numpy())
