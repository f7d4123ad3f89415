"""The port's augmentation chain (slice 2) held against the JAX package on the
CPU: HSV, the kernels K4 (resample_rows), K5 (photometric) and K6
(shift_rows_windowed) through their plain versions, the warp, the
``legacy`` draws, ``augment_legacy`` and ``preprocess_augment_batch``.

The JAX side runs as its own CPU tests run it: the XLA oracle, or the Pallas
kernel in interpret mode. Randomness cannot be shared bit for bit (threefry
against per-lineage torch generators), so the chain tests hand JAX's own
draws to the port through ``LegacyDraws.from_numpy``, and the port's own
draws are held to the preset's probabilities. Inputs come from numpy seeds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.synth import synth_images


def _t(a):
    return torch.from_numpy(np.array(a))


def _q(a):
    return np.floor(np.clip(np.asarray(a), 0.0, 255.0) + 0.5)


def _keys(ids, seed=0):
    from mmtrs_tpu.utils.rng import keys_for_batch

    return keys_for_batch(seed, jnp.asarray(ids, jnp.uint32), jnp.zeros(len(ids), jnp.uint32))


@pytest.fixture
def jax_tpu_route(monkeypatch):
    """Run the JAX package's TPU main path on the CPU, which is the route the
    port follows: the fused two-pass warp with u8 staging and the fused
    CLAHE-LAB kernels, their Pallas kernels in interpret mode (as
    tests/test_ops.py:521-533 runs them). Traces made before or under the
    patch are dropped, so no other test reuses them."""
    import functools

    import mmtrs_tpu.ops.pallas.shift_kernel as sk
    import mmtrs_tpu.preprocess as jp
    from mmtrs_tpu.ops import warp as jw
    from mmtrs_tpu.ops.pallas.lab_kernels import clahe_lab_fused

    orig = sk.resample_rows_pallas
    monkeypatch.setattr(sk, "resample_rows_pallas", lambda *a, **k: orig(*a, **{**k, "interpret": True}))
    monkeypatch.setattr(jw, "_fused_resample_ok", lambda H, W: True)
    monkeypatch.setattr(jp, "_lab_fused", functools.partial(clahe_lab_fused, interpret=True))
    jax.clear_caches()
    yield
    jax.clear_caches()


# -- HSV ----------------------------------------------------------------------

# XLA and PyTorch divide and floor-mod the same way (true division, fmod
# plus a sign fix), so the f32 values agree to a few ULPs of 255.
@pytest.mark.parametrize("name", ["rgb_to_hsv", "hsv_to_rgb", "hsv_shift"])
def test_hsv_matches_jax(name):
    from mmtrs_tpu.ops import augment as ja
    from mmtrs_tpu.ops import color as jc
    from mmtrs_tpu_torch.ops import color as tc

    rng = np.random.default_rng(31)
    rgb = rng.integers(0, 256, (4, 16, 16, 3)).astype(np.float32)
    rgb[0, :4] = 128.0  # grey: c == 0
    rgb[0, 4:8, :, 0] = 255.0  # ties between the max channel and the others
    rgb[0, 4:8, :, 1] = 255.0
    if name == "rgb_to_hsv":
        want, got = jc.rgb_to_hsv(jnp.asarray(rgb)), tc.rgb_to_hsv(_t(rgb))
    elif name == "hsv_to_rgb":
        hsv = np.array(jc.rgb_to_hsv(jnp.asarray(rgb)))
        hsv[..., 0] = rng.uniform(-20, 200, hsv.shape[:-1])  # wraps both ways
        want, got = jc.hsv_to_rgb(jnp.asarray(hsv)), tc.hsv_to_rgb(_t(hsv))
    else:
        d = [rng.uniform(lo, hi, 4).astype(np.float32) for lo, hi in ((-5, 5), (-12, 12), (-8, 8))]
        want = ja.hsv_shift(jnp.asarray(rgb), *map(jnp.asarray, d))
        got = tc.hsv_shift(_t(rgb), *map(_t, d))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


# -- K4 resample_rows -----------------------------------------------------------


@pytest.mark.parametrize("axis", [2, 1])
@pytest.mark.parametrize("kind", ["f32", "u8", "u8_steep"])
def test_resample_rows_plain_matches_pallas_interpret(axis, kind):
    """K4's plain version against resample_rows_pallas(interpret=True) on the
    planar rows its caller builds, one image per block, with a flipped α
    (−1.1) beside 0.8 and offsets in ±20; ``u8_steep`` takes α 2.9 and −3.1
    with offsets in ±n/2 (lines whose sources spread far apart). f32 out:
    atol 1e-2 (the interpret kernel's [n, n] f32 dot sums in another order,
    as tests/test_ops.py:518 bounds it); u8 out: max ≤ 1 level (the same
    sums on either side of a .5)."""
    from mmtrs_tpu.ops.pallas.shift_kernel import resample_rows_pallas
    from mmtrs_tpu_torch.ops.kernels.resample import resample_rows

    rng = np.random.default_rng(5)
    B, H, W, C = 2, 32, 64, 3
    dtype = np.float32 if kind == "f32" else np.uint8
    img = rng.integers(0, 256, (B, H, W, C)).astype(dtype)
    lines, n = (H, W) if axis == 2 else (W, H)
    alpha = np.array([2.9, -3.1] if kind == "u8_steep" else [0.8, -1.1], np.float32)
    amp = n / 2 if kind == "u8_steep" else 20
    beta = rng.uniform(-amp, amp, (B, lines)).astype(np.float32) + np.array([[0.0], [n - 1.0]], np.float32)
    r = beta.mean(axis=1).astype(np.float32)
    off = (beta - r[:, None]).astype(np.float32)

    rows = img if axis == 2 else img.transpose(0, 2, 1, 3)  # [B, lines, n, C]
    planar = rows.transpose(0, 3, 1, 2).reshape(B * C * lines, n)
    rep = lambda v: np.broadcast_to(v[:, None, None], (B, C, lines)).reshape(-1)
    off_r = np.broadcast_to(off[:, None, :], (B, C, lines)).reshape(-1)
    want = np.asarray(resample_rows_pallas(
        jnp.asarray(planar), jnp.asarray(off_r), jnp.asarray(rep(alpha)), jnp.asarray(rep(r)),
        block_rows=lines, interpret=True,
        out_dtype=jnp.uint8 if dtype == np.uint8 else jnp.float32,
    )).reshape(B, C, lines, n).transpose(0, 2, 3, 1)
    if axis == 1:
        want = want.transpose(0, 2, 1, 3)

    got = resample_rows(_t(img), _t(off), _t(alpha), _t(r), axis=axis).numpy()
    assert got.dtype == want.dtype
    if dtype == np.uint8:
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    else:
        np.testing.assert_allclose(got, want, atol=1e-2, rtol=0)


def _warp_mats():
    th = np.deg2rad(9.0)
    rot = np.array([[np.cos(th), -np.sin(th), 6.0], [np.sin(th), np.cos(th), -3.0], [0, 0, 1]])
    shear = np.array([[1.05, 0.1, -4.0], [0.02, 0.95, 5.0], [0, 0, 1]])
    flip = np.array([[-1.0, 0.0, 127.0], [0.0, 1.0, 0.0], [0, 0, 1]]) @ rot  # hflip: α < 0
    return np.stack([rot, shear, flip]).astype(np.float32)


def test_warp_affine_shear_u8_matches_jax_tpu_route_and_xla(monkeypatch):
    """u8 [3, 64, 128, 3], a rotation, a shear and a flipped rotation, constant
    border. Against the JAX TPU route run on the CPU (its fused two-pass
    warp with u8 staging, Pallas kernels in interpret mode): max ≤ 1 level.
    Against the XLA route (f32 between and after the passes), quantised:
    mean < 0.2 and max ≤ 1 level — the u8 intermediate adds at most half a
    level. (Against the XLA route's f32 values the u8 store alone costs
    ~0.25 on average, on the TPU route as here.)"""
    from mmtrs_tpu.ops import warp as jw
    from mmtrs_tpu_torch.ops.warp import warp_affine_shear

    imgs = np.random.default_rng(6).integers(0, 256, (3, 64, 128, 3)).astype(np.uint8)
    mats = _warp_mats()
    got = warp_affine_shear(_t(imgs), _t(mats)).numpy()
    assert got.dtype == np.uint8
    xla = _q(jw.warp_affine_shear(jnp.asarray(imgs), jnp.asarray(mats)))
    assert np.abs(got - xla).mean() < 0.2
    assert np.abs(got - xla).max() <= 1

    import mmtrs_tpu.ops.pallas.shift_kernel as sk

    orig = sk.resample_rows_pallas
    monkeypatch.setattr(sk, "resample_rows_pallas", lambda *a, **k: orig(*a, **{**k, "interpret": True}))
    monkeypatch.setattr(jw, "_fused_resample_ok", lambda H, W: True)
    tpu = np.asarray(jw.warp_affine_shear(jnp.asarray(imgs), jnp.asarray(mats)))
    assert tpu.dtype == np.uint8
    assert np.abs(got.astype(int) - tpu.astype(int)).max() <= 1


def test_warp_affine_shear_f32_matches_xla():
    """f32 stays f32 through both passes: atol 1e-2 to the JAX XLA route,
    whose hat matmuls sum in another order (replicate border too)."""
    from mmtrs_tpu.ops import warp as jw
    from mmtrs_tpu_torch.ops.warp import warp_affine_shear

    imgs = np.random.default_rng(8).uniform(0, 255, (3, 64, 128, 3)).astype(np.float32)
    mats = _warp_mats()
    for border in ("constant", "replicate"):
        want = np.asarray(jw.warp_affine_shear(jnp.asarray(imgs), jnp.asarray(mats), border=border))
        got = warp_affine_shear(_t(imgs), _t(mats), border=border).numpy()
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=1e-2, rtol=0)


# -- K6 shift_rows_windowed -------------------------------------------------------


@pytest.mark.parametrize("axis", [2, 1])
@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_shift_axis_windowed_matches_jax_xla(axis, dtype):
    """K6's two direct taps against the XLA windowed form's 2m+2 hat taps:
    f32 atol 1e-3 (the hat weights round differently), u8 within 1 level of
    the quantised XLA result."""
    from mmtrs_tpu.ops.warp import shift_axis_windowed as jshift
    from mmtrs_tpu_torch.ops.warp import shift_axis_windowed

    rng = np.random.default_rng(37)
    img = rng.integers(0, 256, (2, 48, 64, 3)).astype(dtype)
    off = rng.uniform(-11, 11, (2, 48, 64)).astype(np.float32)
    want = np.asarray(jshift(jnp.asarray(img), jnp.asarray(off), 11, axis=axis))
    got = shift_axis_windowed(_t(img), _t(off), 11, axis=axis).numpy()
    assert got.dtype == dtype
    if dtype == np.uint8:
        assert np.abs(got.astype(float) - _q(want)).max() <= 1
    else:
        np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)


def _pallas_windowed(img, off, m, axis):
    """``_shift_rows_pp_kernel`` through ``pl.pallas_call(..., interpret=True)``
    on the planar rows ``mmtrs_tpu.ops.warp.shift_axis_windowed`` builds for
    it (axis 1 inside that function's swapaxes pair); f32 out, NHWC."""
    import functools

    from jax.experimental import pallas as pl
    from mmtrs_tpu.ops.pallas.shift_kernel import _shift_rows_pp_kernel

    x, o = jnp.asarray(img), jnp.asarray(off)
    if axis == 1:
        x, o = jnp.swapaxes(x, 1, 2), jnp.swapaxes(o, 1, 2)
    B, H, W, C = x.shape
    planar = x.transpose(0, 3, 1, 2).reshape(B * C * H, W)
    off_r = jnp.broadcast_to(o[:, None], (B, C, H, W)).reshape(-1, W)
    out = pl.pallas_call(
        functools.partial(_shift_rows_pp_kernel, W=W, max_shift=m),
        out_shape=jax.ShapeDtypeStruct((B * C * H, W), jnp.float32),
        interpret=True,
    )(planar, off_r)
    out = np.asarray(out).reshape(B, C, H, W).transpose(0, 2, 3, 1)
    return out.swapaxes(1, 2) if axis == 1 else out


@pytest.mark.parametrize("axis", [2, 1])
@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_shift_windowed_beyond_its_window_matches_pallas_kernel(axis, dtype):
    """Offsets in ±(m + 3), half of them beyond the window m = 3: K6's plain
    version and ``shift_axis_windowed`` give the TPU kernel's windowed sum
    (taps outside [−m, m + 1] weigh 0, a clipped source takes the edge
    sample), not the bilinear shift. f32 within 1e-3 (the kernel's hat
    weights round differently), u8 within 1 level of the quantised Pallas
    result."""
    from mmtrs_tpu_torch.ops.kernels.shift import shift_rows_windowed_ref
    from mmtrs_tpu_torch.ops.warp import shift_axis_windowed

    m = 3
    rng = np.random.default_rng(41)
    img = rng.integers(0, 256, (2, 24, 32, 3)).astype(dtype)
    off = rng.uniform(-(m + 3), m + 3, (2, 24, 32)).astype(np.float32)
    assert (np.abs(off) > m + 1).mean() > 0.25
    want = _pallas_windowed(img, off, m, axis)
    for got in (shift_rows_windowed_ref(_t(img), _t(off), m, axis).numpy(),
                shift_axis_windowed(_t(img), _t(off), m, axis=axis).numpy()):
        assert got.dtype == dtype
        if dtype == np.uint8:
            assert np.abs(got.astype(float) - _q(want)).max() <= 1
        else:
            np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)


# -- K5 photometric ----------------------------------------------------------------


def _phot_rows(B=5):
    """The five row kinds of tests/test_ops.py:592-598: identity, bc, hsv,
    dropout, bc + hsv + dropout."""
    p = np.zeros((B, 10), np.float32)
    p[1, 0], p[1, 1] = 0.12, -0.09
    p[2, 2:6] = (4.0, -6.0, 8.0, 1.0)
    p[3, 7:10] = (1.0, 20.0, 33.0)
    p[4, 0], p[4, 1] = -0.07, 0.11
    p[4, 2:6] = (-3.0, 9.0, -5.0, 1.0)
    p[4, 7:10] = (1.0, 5.0, 90.0)
    return p


def test_photometric_plain_matches_pallas_interpret():
    """Max ≤ 1 level, ≥ 99.9 % equal: the JAX kernel's own CPU bar against
    its oracle (the HSV divisions straddle the .5 quantiser now and then)."""
    from mmtrs_tpu.ops.pallas.photometric_kernel import photometrics_fused_pallas
    from mmtrs_tpu_torch.ops.augment import photometrics_pointwise_ref
    from mmtrs_tpu_torch.ops.kernels.photometric import photometric

    imgs = np.random.default_rng(13).integers(0, 256, (5, 64, 128, 3)).astype(np.uint8)
    params, seeds = _phot_rows(), np.arange(5, dtype=np.int32)
    want = np.asarray(photometrics_fused_pallas(
        jnp.asarray(imgs), jnp.asarray(params), jnp.asarray(seeds), 7, interpret=True))
    got = photometric(_t(imgs), _t(params), _t(seeds), 7).numpy()
    assert got.dtype == np.uint8
    d = np.abs(got.astype(int) - want.astype(int))
    assert d.max() <= 1 and (d == 0).mean() >= 0.999, (d.max(), (d == 0).mean())
    # the JAX package's name for the plain version
    np.testing.assert_array_equal(photometrics_pointwise_ref(_t(imgs), _t(params), _t(seeds), 7).numpy(), got)


@pytest.mark.parametrize("var", [5.0, 15.0])
def test_photometric_noise_statistics(var):
    """Noise rows by statistics, on mid-grey pixels away from the 0/255 clips:
    out − out without noise has |mean| < 0.06 σ (4 standard errors of 24,576
    samples) and std within 3 % of √(σ² + 1/12) (the u8 store adds rounding
    noise), for the port's hash noise and for the JAX oracle's threefry
    noise alike."""
    from mmtrs_tpu.ops.augment import photometrics_pointwise_ref as jref
    from mmtrs_tpu_torch.ops.kernels.photometric import photometric

    sigma = np.float32(np.sqrt(var))
    imgs = np.random.default_rng(3).integers(100, 156, (2, 64, 128, 3)).astype(np.uint8)
    params = np.zeros((2, 10), np.float32)
    params[0, 6] = sigma
    seeds = np.array([12345, -7], np.int32)
    want_std = np.sqrt(var + 1.0 / 12.0)
    got = photometric(_t(imgs), _t(params), _t(seeds), 7).numpy().astype(float)
    jgot = np.asarray(jref(jnp.asarray(imgs), jnp.asarray(params), _keys([0, 1]), 7)).astype(float)
    for out in (got, jgot):
        np.testing.assert_array_equal(out[1], imgs[1])
        diff = out[0] - imgs[0]
        assert abs(diff.mean()) < 0.06 * sigma, diff.mean()
        assert abs(diff.std() / want_std - 1.0) < 0.03, diff.std()


def test_noise_hash_matches_uint32_arithmetic():
    """The int64 split products of the plain version equal plain uint32
    arithmetic (what the kernel computes), and the per-image streams differ."""
    from mmtrs_tpu_torch.ops.kernels.photometric import fmix32_ref, noise_normals_ref

    def fmix(h):
        h ^= h >> 16
        h = (h * 0x85EBCA6B) & 0xFFFFFFFF
        h ^= h >> 13
        h = (h * 0xC2B2AE35) & 0xFFFFFFFF
        return h ^ (h >> 16)

    vals = [0, 1, 0x7FFFFFFF, 0x80000000, 0xDEADBEEF, 0xFFFFFFFF]
    assert fmix32_ref(torch.tensor(vals)).tolist() == [fmix(v) for v in vals]
    seeds = torch.tensor([-1, 0, 2**31 - 1], dtype=torch.int32)
    z = noise_normals_ref(seeds, 4096)
    key = fmix(0xFFFFFFFF)
    e = 4095
    bits = fmix((e * 0x9E3779B1 + key) & 0xFFFFFFFF)
    u1, u2 = np.float32((bits & 0xFFFF) / 65536.0), np.float32((bits >> 16) / 65536.0)
    want = np.sqrt(-2.0 * np.log(1.0 - u1)) * np.cos(2.0 * np.pi * u2)
    assert abs(z[0, e].item() - want) < 1e-5
    assert not torch.equal(z[0], z[1]) and not torch.equal(z[1], z[2])
    assert abs(z.mean().item()) < 0.05 and abs(z.std().item() - 1.0) < 0.05


# -- primitives and geometric builders ---------------------------------------------


@pytest.mark.parametrize("name", ["brightness_contrast", "gauss_noise", "coarse_dropout", "motion_blur"])
def test_photometric_primitives_match_jax(name):
    """Each primitive fed the quantities JAX draws from its keys: exact
    selections, f32 atol 1e-3 (motion blur: 25 products summed in another
    order than XLA's convolution)."""
    from mmtrs_tpu.ops import augment as ja
    from mmtrs_tpu_torch.ops import augment as ta

    rng = np.random.default_rng(41)
    imgs = rng.uniform(0, 255, (3, 32, 48, 3)).astype(np.float32)
    keys = _keys([3, 4, 5])
    if name == "brightness_contrast":
        b, c = rng.uniform(-0.15, 0.15, (2, 3)).astype(np.float32)
        want = ja.brightness_contrast(jnp.asarray(imgs), jnp.asarray(b), jnp.asarray(c))
        got = ta.brightness_contrast(_t(imgs), _t(b), _t(c))
    elif name == "gauss_noise":
        var = np.array([5.0, 9.0, 15.0], np.float32)
        noise = np.asarray(jax.vmap(lambda k: jax.random.normal(k, imgs.shape[1:]))(keys))
        want = ja.gauss_noise(jnp.asarray(imgs), keys, jnp.asarray(var))
        got = ta.gauss_noise(_t(imgs), _t(noise), _t(var))
    elif name == "coarse_dropout":
        y0, x0 = jax.vmap(lambda k: ja._dropout_xy(k, 32, 48, 7))(keys)
        want = ja.coarse_dropout(jnp.asarray(imgs), keys, 7)
        got = ta.coarse_dropout(_t(imgs), _t(y0), _t(x0), 7)
    else:
        theta = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (), minval=0.0, maxval=jnp.pi))(keys))
        want = ja.motion_blur(jnp.asarray(imgs), keys, ksize=5)
        got = ta.motion_blur(_t(imgs), _t(theta), ksize=5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3, rtol=0)


@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_elastic_matches_jax(dtype):
    """elastic fed the raw fields JAX draws from its keys (augment.py:187-194).
    f32: atol 0.05 (two windowed passes at atol 1e-3 each, on offsets whose
    smoothing sums in another order); u8: the port stores u8 after each
    pass (the TPU route), JAX's XLA route once — within 1 level."""
    from mmtrs_tpu.ops import augment as ja
    from mmtrs_tpu_torch.ops.augment import elastic

    imgs = synth_images(2, 64, seed=2).astype(dtype)
    keys = _keys([6, 7])

    def raw(k):
        k1, k2 = jax.random.split(k)
        return jnp.stack([jax.random.uniform(kk, (64, 64), minval=-1.0, maxval=1.0) for kk in (k1, k2)])

    fields = np.asarray(jax.vmap(raw)(keys))
    want = np.asarray(ja.elastic(jnp.asarray(imgs), keys))
    got = elastic(_t(imgs), _t(fields)).numpy()
    assert got.dtype == dtype
    if dtype == np.uint8:
        assert np.abs(got.astype(float) - _q(want)).max() <= 1
    else:
        np.testing.assert_allclose(got, want, atol=0.05, rtol=0)


def test_geometric_builders_match_jax():
    """The 3×3 builders, ssr3 and perspective3 (fed the uniforms and normals
    JAX draws from the same keys) and the centre affine-isation: atol 1e-4
    relative to each entry's scale (f32 products and an 8×8 LU solve)."""
    from mmtrs_tpu.ops import augment as ja
    from mmtrs_tpu.ops import warp as jw
    from mmtrs_tpu_torch.ops import augment as ta
    from mmtrs_tpu_torch.ops import warp as tw

    H, W = 96, 128
    c = ((W - 1) / 2.0, (H - 1) / 2.0)
    key = _keys([11])[0]
    k1, k2, k3, k4 = jax.random.split(key, 4)
    u = lambda k, lo, hi: float(jax.random.uniform(k, (), minval=lo, maxval=hi))
    ang, sc = u(k1, -12.0, 12.0), 1.0 + u(k2, -0.1, 0.1)
    tx, ty = u(k3, -0.05, 0.05) * W, u(k4, -0.05, 0.05) * H
    ks, kj = jax.random.split(key)
    s = u(ks, 0.02, 0.05)
    jitter = np.asarray(jax.random.normal(kj, (4, 2)))
    persp = ta.perspective3(_t([s]).float(), _t(jitter[None]), H, W)[0]
    pairs = [
        (jw.rotation_matrix(17.0, c, 1.1), tw.rotation_matrix(17.0, c, 1.1)),
        (jw.scale3(1.2, 0.9, c), tw.scale3(1.2, 0.9, c)),
        (jw.rotate3(-30.0, c), tw.rotate3(-30.0, c)),
        (jw.mat3(jw.hflip3(float(W)), jw.vflip3(float(H))), tw.mat3(tw.hflip3(float(W)), tw.vflip3(float(H)))),
        (jw.invert_affine(jw.rotate3(-30.0, c)), tw.invert_affine(tw.rotate3(-30.0, c))),
        (jw.translate3(3.5, -2.0), tw.translate3(3.5, -2.0)),
        (jw.identity3(), tw.identity3()),
        (ja.ssr3(key, H, W), ta.ssr3(_t([ang]).float(), _t([sc]).float(), _t([tx]).float(), _t([ty]).float(), H, W)[0]),
        (ja.perspective3(key, H, W), persp),
        (jw.affineize_homography(ja.perspective3(key, H, W), *c), tw.affineize_homography(persp, *c)),
    ]
    for want, got in pairs:
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4 * max(1.0, np.abs(want).max()), rtol=0)


# -- draws ---------------------------------------------------------------------------


def test_draw_legacy_gate_frequencies():
    """Over 4,000 lineages every gate fires within 4σ of its probability
    (binomial σ); the OneOf's three branches each near p/3."""
    from mmtrs_tpu_torch.ops.augment import LEGACY_GATES, draw_uniforms, legacy_gates
    from mmtrs_tpu_torch.utils.rng import generators_for_batch

    n = 4000
    g = legacy_gates(draw_uniforms(generators_for_batch(2026, range(n), 3)))
    probs = dict(LEGACY_GATES, clahe=0.5 / 3, bc=0.5 / 3, hsv=0.5 / 3)
    for k, p in probs.items():
        assert abs(g[k].float().mean().item() - p) <= 4.0 * np.sqrt(p * (1 - p) / n), (k, g[k].float().mean())


def test_draw_legacy_depends_on_lineage_only():
    """The same lineage gives the same draws whatever the batch order, and a
    different aug_idx gives different ones."""
    from mmtrs_tpu_torch.ops.augment import draw_legacy

    ids = list(range(100, 140))
    a = draw_legacy(9, ids, 2, 32, 32)
    perm = np.random.default_rng(0).permutation(len(ids))
    b = draw_legacy(9, [ids[i] for i in perm], 2, 32, 32)
    back = b.take(np.argsort(perm))
    assert int(a.elastic_on.sum()) > 0
    for f in ("mats", "params", "seeds", "use_clahe", "blur_on", "blur_theta", "elastic_on", "elastic_fields"):
        assert torch.equal(getattr(a, f), getattr(back, f)), f
    assert not torch.equal(a.mats, draw_legacy(9, ids, 3, 32, 32).mats)


# -- the chain against JAX, on JAX's own draws -------------------------------------


def _jax_draws(keys, H, W, hole=21):
    """LegacyDraws built from the JAX package's draw structure
    (augment.py:360-442, :563-575, :107-108, :187-194)."""
    from mmtrs_tpu.ops import augment as ja
    from mmtrs_tpu_torch.ops.augment import LegacyDraws

    mats = ja.legacy_geo_mats(keys, H, W)
    params, nk, use_clahe = ja.photometric_params_legacy(keys, H, W, hole)
    seeds = jax.vmap(lambda k: jax.random.bits(k, (), jnp.uint32).astype(jnp.int32))(nk)
    bk = jax.vmap(lambda k: jax.random.fold_in(k, 3))(keys)
    blur_on = jax.vmap(lambda k: ja._gate(jax.random.fold_in(k, 0), 0.1))(bk)
    theta = jax.vmap(lambda k: jax.random.uniform(k, (), minval=0.0, maxval=jnp.pi))(bk)
    ek = jax.vmap(lambda k: jax.random.fold_in(k, 4))(keys)
    el_on = np.asarray(jax.vmap(lambda k: ja._gate(jax.random.fold_in(k, 0), 0.1))(ek))

    def raw(k):
        k1, k2 = jax.random.split(k)
        return jnp.stack([jax.random.uniform(kk, (H, W), minval=-1.0, maxval=1.0) for kk in (k1, k2)])

    fields = np.asarray(jax.vmap(raw)(ek))[el_on]
    return LegacyDraws.from_numpy(mats, params, seeds, use_clahe, blur_on, theta, el_on, fields), params


def _covering_ids(n_max=8):
    """Origin ids (seed 0, aug_idx 0) whose JAX draws make no noise and fire
    every other member of the preset at least once, found greedily."""
    from mmtrs_tpu.ops import augment as ja

    ids = np.arange(3000)
    keys = _keys(ids)
    gk = jax.vmap(lambda k: jax.random.split(jax.random.fold_in(k, 0), 5))(keys)
    gate = lambda ks, p: np.asarray(jax.vmap(lambda k: ja._gate(k, p))(ks))
    fold = lambda i, j: jax.vmap(lambda k: jax.random.fold_in(jax.random.fold_in(k, i), j))(keys)
    params, _, use_clahe = ja.photometric_params_legacy(keys, 64, 64, 21)
    params = np.asarray(params)
    fired = {
        "hflip": gate(gk[:, 0], 0.5), "vflip": gate(gk[:, 1], 0.05),
        "ssr": gate(jax.vmap(lambda k: jax.random.fold_in(k, 1))(gk[:, 2]), 0.9),
        "persp": gate(jax.vmap(lambda k: jax.random.fold_in(k, 1))(gk[:, 3]), 0.2),
        "clahe": np.asarray(use_clahe), "bc": params[:, 1] != 0, "hsv": params[:, 5] > 0,
        "dropout": params[:, 7] > 0, "blur": gate(fold(3, 0), 0.1), "elastic": gate(fold(4, 0), 0.1),
    }
    ok = params[:, 6] == 0
    chosen, todo = [], set(fired)
    while todo and len(chosen) < n_max:
        score = [len([k for k in todo if fired[k][i]]) if ok[i] and i not in chosen else -1 for i in ids]
        best = int(np.argmax(score))
        chosen.append(best)
        todo -= {k for k in todo if fired[k][best]}
    assert not todo, todo
    return chosen


def _chain_bar(got, want):
    d = np.abs(got.astype(int) - want.astype(int))
    assert (d <= 2).mean() >= 0.995, ((d <= 2).mean(), d.max())


def test_augment_legacy_matches_jax_on_its_draws(jax_tpu_route):
    """augment_legacy on u8 [B, 128, 128, 3] with JAX's draws for keys that
    fire every member but noise, against JAX augment_legacy on its TPU route
    (u8-staged warp; the photometrics through its XLA oracle, which equals
    the fused kernel without noise): u8 within 2 levels on ≥ 99.5 % of
    values. (Against the XLA warp route, whose f32 intermediate differs from
    the u8 one by a level that the CLAHE branch amplifies, 99.0 % within 2
    levels, max 6, on these inputs — ROADMAP Queue 3.)"""
    from mmtrs_tpu.ops.augment import augment_legacy as jaug
    from mmtrs_tpu_torch.ops.augment import augment_batch

    ids = _covering_ids()
    keys = _keys(ids)
    imgs = synth_images(len(ids), 128, seed=21)
    draws, _ = _jax_draws(keys, 128, 128)
    want = np.asarray(jaug(jnp.asarray(imgs), keys))
    got = augment_batch(_t(imgs), draws, "legacy").numpy()
    assert got.dtype == np.uint8 and got.shape == imgs.shape
    _chain_bar(got, want)


def test_preprocess_augment_batch_matches_jax_on_its_draws(jax_tpu_route):
    """The production chain at u8 [B, 128, 128, 3] (deskew firing on one
    image) with JAX's draws, against JAX preprocess_augment_batch on its TPU
    route (the planar chain: fused CLAHE-LAB and warp kernels in interpret
    mode): seg_valid equal, boxes within 1 px, angles within 1e-3°, u8
    within 2 levels on ≥ 99.5 % of values. (On the JAX CPU route, with
    float chroma at the entry CLAHE, image 1's saliency box moves by 35 px
    — slice 1's preprocess_batch shows the same on these inputs.)"""
    from mmtrs_tpu.preprocess import preprocess_augment_batch as jpre
    from mmtrs_tpu_torch.preprocess import preprocess_augment_batch
    from mmtrs_tpu_torch.synth import synth_teeth

    ids = _covering_ids()
    keys = _keys(ids)
    angles = [30.0] + [3.0] * (len(ids) - 1)
    imgs = synth_teeth(len(ids), 128, seed=8, angles_deg=angles)
    draws, _ = _jax_draws(keys, 128, 128, hole=128 // 24)
    jout, jinfo = jpre(jnp.asarray(imgs), keys, out_size=128, use_pallas=True)
    out, info = preprocess_augment_batch(_t(imgs), draws, out_size=128)
    assert out.dtype == torch.uint8 and out.shape == imgs.shape
    assert np.asarray(jinfo["deskew_angle"])[0] != 0.0
    np.testing.assert_array_equal(info["seg_valid"].numpy(), np.asarray(jinfo["seg_valid"]))
    np.testing.assert_allclose(info["deskew_angle"].numpy(), np.asarray(jinfo["deskew_angle"]), atol=1e-3, rtol=0)
    assert np.abs(info["boxes"].numpy() - np.asarray(jinfo["boxes"])).max() <= 1.0
    _chain_bar(out.numpy(), np.asarray(jout))


# -- small contracts ------------------------------------------------------------------


def test_subset_apply_refuses_a_dtype_change():
    """A float result for a u8 batch raises instead of being truncated."""
    from mmtrs_tpu_torch.ops.augment import subset_apply

    x = torch.full((3, 4, 4, 3), 7, dtype=torch.uint8)
    on = torch.tensor([True, False, True])
    with pytest.raises(TypeError, match="quantise"):
        subset_apply(lambda s: s.float() * 1.5, x, on)
    assert torch.equal(subset_apply(lambda s: s + 1, x, on)[1], x[1])


def test_augment_batch_dispatch():
    """"none" passes the batch through; ten and simple need aug_idx, as in
    the JAX package; an unknown name raises (tests/test_torch_presets.py
    runs the other presets)."""
    from mmtrs_tpu_torch.ops.augment import augment_batch, draw_ten

    x = torch.zeros((1, 8, 8, 3), dtype=torch.uint8)
    assert augment_batch(x, None, "none") is x
    for preset in ("ten", "simple"):
        with pytest.raises(ValueError, match="needs aug_idx"):
            augment_batch(x, draw_ten(0, [0], 1, 8, 8, [0]), preset)
    with pytest.raises(ValueError, match="unknown preset"):
        augment_batch(x, None, "bogus")
