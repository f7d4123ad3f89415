"""The PyTorch port's image ops (mmtrs_tpu_torch.ops, models.segmenter) held
against the JAX package on the CPU.

On the CPU every kernel wrapper runs its plain PyTorch version, so these
tests pin the arithmetic the CUDA kernels share with it (csrc/ mirrors the
plain versions op for op; chip_smoke.py compares the two on the card). The
JAX side runs as the JAX package's own CPU tests run it: the XLA oracle, or
the Pallas kernel in interpret mode. Inputs come from numpy seeds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.synth import synth_images


def _t(a):
    return torch.from_numpy(np.array(a))


def _q(a):
    return np.floor(np.clip(a, 0.0, 255.0) + 0.5)


# -- colour -----------------------------------------------------------------

# XLA's and PyTorch's CPU exp/log differ by an ULP on some inputs, so the
# f32 colour values agree to ~1e-4 on the 0..255 scale, not bit for bit.
@pytest.mark.parametrize(
    "name,scale",
    [("rgb_to_gray", 255.0), ("rgb_to_lab", 255.0), ("_srgb_to_linear", 1.0),
     ("_linear_to_srgb", 1.0), ("_f_lab", 1.0)],
)
def test_color_matches_jax(name, scale):
    from mmtrs_tpu.ops import color as jc
    from mmtrs_tpu_torch.ops import color as tc

    x = np.random.default_rng(1).uniform(0, scale, (4, 16, 16, 3)).astype(np.float32)
    want = np.asarray(getattr(jc, name)(jnp.asarray(x)))
    got = getattr(tc, name)(_t(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-3 * scale / 255.0 + 1e-6, rtol=0)


def test_lab_to_rgb_matches_jax():
    from mmtrs_tpu.ops.color import lab_to_rgb, rgb_to_lab
    from mmtrs_tpu_torch.ops import color as tc

    x = np.random.default_rng(2).uniform(0, 255, (4, 16, 16, 3)).astype(np.float32)
    lab = np.asarray(rgb_to_lab(jnp.asarray(x)))
    want = np.asarray(lab_to_rgb(jnp.asarray(lab)))
    np.testing.assert_allclose(tc.lab_to_rgb(_t(lab)).numpy(), want, atol=1e-3, rtol=0)


# -- CLAHE ------------------------------------------------------------------


@pytest.mark.parametrize("tiles", [(4, 4), (8, 8)])
def test_clahe_plain_bit_exact_vs_jax(tiles):
    """Integer histogram/LUT arithmetic and the oracle's blend order: f32
    output bit-equal to mmtrs_tpu.ops.clahe.clahe."""
    from mmtrs_tpu.ops.clahe import clahe as jclahe
    from mmtrs_tpu_torch.ops.clahe import clahe

    l = (np.random.default_rng(3).random((2, 64, 64)) * 255).astype(np.float32)
    want = np.asarray(jclahe(jnp.asarray(l), tiles=tiles))
    np.testing.assert_array_equal(clahe(_t(l), tiles=tiles).numpy(), want)


def test_clahe_plain_u8_matches_pallas_interpret():
    """Bit-exact against clahe_pallas(out_dtype=uint8) in interpret mode, as
    tests/test_ops.py holds the Pallas kernel to the oracle."""
    from mmtrs_tpu.ops.pallas.clahe_kernel import clahe_pallas
    from mmtrs_tpu_torch.ops.clahe import clahe, quantize_u8

    l_u8 = np.random.default_rng(17).integers(0, 256, (2, 64, 64)).astype(np.uint8)
    want = np.asarray(
        clahe_pallas(jnp.asarray(l_u8), tiles=(4, 4), interpret=True, out_dtype=jnp.uint8)
    )
    got = quantize_u8(clahe(_t(l_u8).float(), tiles=(4, 4))).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("quant_l", [False, True])
def test_clahe_rgb_matches_jax(quant_l):
    """RGB → rounded LAB → CLAHE → RGB against mmtrs_tpu.ops.clahe.clahe_rgb:
    atol 1e-3 (the colour conversions' ULP differences; the rounded L plane
    and the LUTs agree on this input)."""
    from mmtrs_tpu.ops.clahe import clahe_rgb as jclahe_rgb
    from mmtrs_tpu_torch.ops.clahe import clahe_rgb

    imgs = synth_images(2, 64, seed=12).astype(np.float32)
    want = np.asarray(jclahe_rgb(jnp.asarray(imgs), quant_l=quant_l))
    got = clahe_rgb(_t(imgs), quant_l=quant_l).numpy()
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)


def test_clahe_lab_fused_ref_matches_pallas_interpret():
    """The plain K1+K2 chain against clahe_lab_fused(interpret=True) at
    [4,128,128,3], synthetic teeth plus saturated random pixels. Bar: the
    JAX CPU test's (tests/test_ops.py:409-441), max ≤ 1 and ≥ 99.9 %
    bit-equal — met although XLA's and PyTorch's exp/log differ by an ULP
    (the i8 chroma lattice and u8 L absorb it almost everywhere)."""
    from mmtrs_tpu.ops.pallas.lab_kernels import clahe_lab_fused as jfused
    from mmtrs_tpu_torch.ops.kernels.clahe_lab import clahe_lab_fused, clahe_lab_fused_ref

    rng = np.random.default_rng(9)
    imgs = np.concatenate(
        [synth_images(2, 128, seed=9), rng.integers(0, 256, (2, 128, 128, 3)).astype(np.uint8)]
    )
    want = np.asarray(jfused(jnp.asarray(imgs), interpret=True))
    got = clahe_lab_fused_ref(_t(imgs)).numpy()
    d = np.abs(got.astype(int) - want.astype(int))
    assert d.max() <= 1, d.max()
    assert (d == 0).mean() >= 0.999, (d == 0).mean()
    # the wrapper takes the plain version on a CPU tensor
    np.testing.assert_array_equal(clahe_lab_fused(_t(imgs)).numpy(), got)


def test_clahe_lab_fwd_lut_planes_match_pallas_forward():
    """K1's plain version: the quantised L and chroma planes against the
    Pallas forward kernel's formulas run through XLA (color.py's shared
    exp/log compositions), and the LUTs through the JAX CLAHE oracle."""
    from mmtrs_tpu.ops.clahe import clahe as jclahe
    from mmtrs_tpu.ops.pallas import lab_kernels as L
    from mmtrs_tpu_torch.ops.clahe import interpolate_luts, tile_luts
    from mmtrs_tpu_torch.ops.kernels.clahe_lab import clahe_lab_fwd_lut

    imgs = synth_images(2, 64, seed=4)
    lq, da, db, lut = clahe_lab_fwd_lut(_t(imgs), 3.0, (8, 8))

    class Ref:  # a Pallas ref stand-in: the kernel body reads ref[...]
        def __init__(self, a):
            self.a = a

        def __getitem__(self, k):
            return self.a

        def __setitem__(self, k, v):
            self.a = v

    x = jnp.asarray(imgs)
    ins = [Ref(x[..., c]) for c in range(3)]
    outs = [Ref(None) for _ in range(3)]
    L._fwd_kernel(*ins, *outs)
    want_da, want_db, want_lq = (np.asarray(o.a) for o in outs)
    for got, want in ((lq, want_lq), (da, want_da), (db, want_db)):
        d = np.abs(got.numpy().astype(int) - want.astype(int))
        assert d.max() <= 1 and (d == 0).mean() >= 0.999, (d.max(), (d == 0).mean())
    # the u8 LUTs, blended with the oracle's formula, reproduce the JAX
    # oracle's CLAHE of the same L plane bit for bit
    assert lut.dtype == torch.uint8 and lut.shape == (2, 64, 256)
    np.testing.assert_array_equal(lut.numpy(), tile_luts(lq, 3.0, (8, 8)).numpy())
    want_l2 = np.asarray(jclahe(jnp.asarray(lq.numpy(), jnp.float32)))
    np.testing.assert_array_equal(interpolate_luts(lq, lut.float(), (8, 8)).numpy(), want_l2)


# -- shifts, rotation, deskew ----------------------------------------------


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_shift_rows_plain_matches_pallas_interpret(dtype):
    """u8 exact, f32 atol 1e-3, against shift_rows_pallas in interpret mode
    on the planar rows its caller builds."""
    from mmtrs_tpu.ops.pallas.shift_kernel import shift_rows_pallas
    from mmtrs_tpu_torch.ops.kernels.shift import shift_rows

    rng = np.random.default_rng(23)
    B, H, W, C = 2, 16, 128, 3
    img = rng.integers(0, 256, (B, H, W, C)).astype(dtype)
    off = rng.uniform(-40, 40, (B, H)).astype(np.float32)
    planar = img.transpose(0, 3, 1, 2).reshape(B * C * H, W)
    off_r = np.broadcast_to(off[:, None, :], (B, C, H)).reshape(-1)
    want = np.asarray(shift_rows_pallas(jnp.asarray(planar), jnp.asarray(off_r), interpret=True))
    want = want.reshape(B, C, H, W).transpose(0, 2, 3, 1)
    got = shift_rows(_t(img), _t(off)).numpy()
    assert got.dtype == dtype
    if dtype == np.uint8:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)


def test_shift_rows_axis1_matches_swapaxes_pair():
    """axis=1 shifts columns along H: the JAX y-shear's swapaxes pair around
    _shift_rows_frac_xla, computed in place."""
    from mmtrs_tpu.ops.warp import _shift_rows_frac_xla
    from mmtrs_tpu_torch.ops.kernels.shift import shift_rows

    rng = np.random.default_rng(29)
    img = rng.uniform(0, 255, (2, 32, 48, 3)).astype(np.float32)
    off = rng.uniform(-20, 20, (2, 48)).astype(np.float32)
    want = np.swapaxes(
        np.asarray(_shift_rows_frac_xla(jnp.swapaxes(jnp.asarray(img), 1, 2), jnp.asarray(off))), 1, 2
    )
    np.testing.assert_allclose(shift_rows(_t(img), _t(off), axis=1).numpy(), want, atol=1e-3, rtol=0)


def test_rotate_shear3_matches_jax():
    """f32: atol 1e-3 to JAX's rotate_shear3. u8: the port stores u8 after
    each shear (the TPU main path); JAX's CPU path shears in f32 and
    quantises once — ≤ 2 levels apart."""
    from mmtrs_tpu.ops.warp import rotate_shear3 as jrot
    from mmtrs_tpu_torch.ops.warp import rotate_shear3

    imgs = synth_images(2, 128, seed=3)
    ang = np.array([25.0, -31.0], np.float32)
    want = np.asarray(jrot(jnp.asarray(imgs, jnp.float32), jnp.asarray(ang), center_xy=(64.0, 64.0)))
    got_f = rotate_shear3(_t(imgs.astype(np.float32)), _t(ang), center_xy=(64.0, 64.0)).numpy()
    np.testing.assert_allclose(got_f, want, atol=1e-3, rtol=0)
    got_u8 = rotate_shear3(_t(imgs), _t(ang), center_xy=(64.0, 64.0)).numpy()
    assert got_u8.dtype == np.uint8
    assert np.abs(got_u8.astype(float) - _q(want)).max() <= 2


def test_deskew_batch_matches_jax():
    """Angles atol 1e-3° (moment sums in another order), image ≤ 2 levels
    (per-shear u8 stores vs JAX CPU's single quantisation)."""
    from mmtrs_tpu.ops.deskew import deskew_batch as jdeskew
    from mmtrs_tpu_torch.ops.deskew import deskew_batch
    from mmtrs_tpu_torch.synth import synth_teeth

    imgs = synth_teeth(4, 128, seed=5, angles_deg=[30.0, -3.0, 0.0, 5.0])
    jo, ja = jdeskew(jnp.asarray(imgs))
    to, ta = deskew_batch(_t(imgs))
    ja = np.asarray(ja)
    assert ja[0] != 0.0 and np.all(ja[1:] == 0.0)  # one image fires
    np.testing.assert_allclose(ta.numpy(), ja, atol=1e-3, rtol=0)
    assert to.dtype == torch.uint8
    assert np.abs(to.numpy().astype(int) - np.asarray(jo).astype(int)).max() <= 2


def test_subset_apply_touches_only_selected_rows():
    from mmtrs_tpu_torch.ops.augment import subset_apply

    x = torch.arange(5 * 3, dtype=torch.float32).reshape(5, 3)
    on = torch.tensor([False, True, False, True, False])
    k = torch.arange(5, dtype=torch.float32)
    out = subset_apply(lambda s, e: s * 10 + e[:, None], x, on, k)
    want = torch.where(on[:, None], x * 10 + k[:, None], x)
    assert torch.equal(out, want)
    assert subset_apply(lambda s: s * 0, x, torch.zeros(5, dtype=torch.bool)) is x


# -- segmenter and crop -----------------------------------------------------


def test_propose_boxes_matches_jax():
    """valid equal, boxes within 1 px (the bf16 pooled quantile can move an
    edge by one pixel when a pooled mean differs by an ULP)."""
    from mmtrs_tpu.models.segmenter import SaliencySegmenter as JSeg
    from mmtrs_tpu_torch.models.segmenter import SaliencySegmenter

    imgs = np.concatenate([
        synth_images(3, 128, seed=7),
        np.full((1, 128, 128, 3), 128, np.uint8),  # grey: fails the saturation gate
    ])
    jb, jv = JSeg().propose_boxes(jnp.asarray(imgs))
    tb, tv = SaliencySegmenter().propose_boxes(_t(imgs))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert not tv[3]
    assert np.abs(tb.numpy() - np.asarray(jb)).max() <= 1.0


@pytest.mark.parametrize("fn", ["crop_box_resize", "resize_bilinear", "center_crop_resize"])
def test_resize_ops_match_jax(fn):
    """Two-tap gathers vs the JAX hat-matrix matmuls: atol 1e-3."""
    from mmtrs_tpu.ops import resize as jr
    from mmtrs_tpu_torch.ops import resize as tr

    x = np.random.default_rng(11).uniform(0, 255, (2, 96, 128, 3)).astype(np.float32)
    boxes = np.array([[10, 20, 70, 90], [0, 0, 96, 128]], np.float32)
    if fn == "crop_box_resize":
        want = jr.crop_box_resize(jnp.asarray(x), jnp.asarray(boxes), 64)
        got = tr.crop_box_resize(_t(x), _t(boxes), 64)
    elif fn == "resize_bilinear":
        want = jr.resize_bilinear(jnp.asarray(x), (80, 100))
        got = tr.resize_bilinear(_t(x), (80, 100))
    else:
        want = jr.center_crop_resize(jnp.asarray(x), 48)
        got = tr.center_crop_resize(_t(x), 48)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3, rtol=0)
