"""The port's ``ten``, ``simple`` and ``randaug`` presets and the records device
loop (slice 3) held against the JAX package on the CPU.

Randomness cannot be shared bit for bit (threefry against per-lineage torch
generators, and the port's on-device counter-hash normals), so the
comparisons hand JAX's own draws to the port through ``*Draws.from_numpy``
and JAX's own normals through a patched ``seeded_normals``. JAX's ``ten``
and ``simple`` draw inside their jitted bodies; ``_jax_ten_draws`` and
``_jax_simple_draws`` repeat those lines (augment.py:597-635, :665-701)
with the same key splits. The port's own draws are held to the presets'
probabilities and ranges. Inputs come from numpy seeds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.synth import synth_images
from tests.test_torch_augment import jax_tpu_route  # noqa: F401  (a fixture)


def _t(a):
    return torch.from_numpy(np.array(a))


def _keys(ids, seed=0):
    from mmtrs_tpu.utils.rng import keys_for_batch

    return keys_for_batch(seed, jnp.asarray(ids, jnp.uint32), jnp.zeros(len(ids), jnp.uint32))


def _u8(a):
    """The table's store: round-half-even, clipped (jnp.round, records.py:152)."""
    return np.clip(np.round(np.asarray(a, np.float32)), 0, 255).astype(np.uint8)


def _normals(keys, fold, shape):
    """[B, *shape] JAX normals of fold_in(key, fold), as gauss_noise and
    random_erasing draw them."""
    return np.asarray(jax.vmap(lambda k: jax.random.normal(jax.random.fold_in(k, fold), shape))(keys))


@pytest.fixture
def jax_normals(monkeypatch):
    """Feed the port JAX's normals: image b's noise is ``normals[seed]``
    (the tests set seeds = arange(B))."""

    def use(normals):
        def fake(seeds, shape):
            out = torch.from_numpy(normals[seeds.long().numpy()])
            assert tuple(out.shape) == tuple(shape)
            return out

        import mmtrs_tpu_torch.ops.augment as ta

        monkeypatch.setattr(ta, "seeded_normals", fake)

    return use


def _raw_fields(keys, H, W):
    def raw(k):
        k1, k2 = jax.random.split(k)
        return jnp.stack([jax.random.uniform(kk, (H, W), minval=-1.0, maxval=1.0) for kk in (k1, k2)])

    return np.asarray(jax.vmap(raw)(keys))


def _jax_ten_draws(keys, which, H, W):
    """TenDraws from augment_ten's own draw lines (augment.py:597-635), and
    its noise normals (fold 7)."""
    from mmtrs_tpu.ops.warp import hflip3, identity3, rotate3, scale3, translate3, vflip3
    from mmtrs_tpu_torch.ops.augment import TenDraws

    def geo(key, w):
        k1, k2, k3, k4, k5 = jax.random.split(key, 5)
        tx = (jax.random.uniform(k1, (), minval=0.03, maxval=0.07)
              * jnp.where(jax.random.bernoulli(k2), 1.0, -1.0) * W)
        ty = (jax.random.uniform(k3, (), minval=0.03, maxval=0.07)
              * jnp.where(jax.random.bernoulli(jax.random.fold_in(k2, 1)), 1.0, -1.0) * H)
        sc = jax.random.uniform(k4, (), minval=0.9, maxval=1.1)
        ang = jax.random.uniform(k5, (), minval=-25.0, maxval=25.0)
        c = ((W - 1) / 2.0, (H - 1) / 2.0)
        mats = jnp.stack([hflip3(float(W)), vflip3(float(H)), translate3(tx, ty), scale3(sc, sc, c), rotate3(ang, c)])
        return jnp.where(w < 5, mats[jnp.minimum(w, 4)], identity3())

    def phot(key, w):
        kb, kc, kh1, kh2, kh3, kv = jax.random.split(key, 6)
        u = lambda k, lo, hi, on: jnp.where(on, jax.random.uniform(k, (), minval=lo, maxval=hi), 0.0)
        return jnp.stack([u(kb, -0.15, 0.15, w == 5), u(kc, -0.15, 0.15, w == 5), u(kh1, -5.0, 5.0, w == 6),
                          u(kh2, -12.0, 12.0, w == 6), u(kh3, -8.0, 8.0, w == 6), u(kv, 5.0, 15.0, w == 7)])

    w = jnp.asarray(which)
    bk = jax.vmap(lambda k: jax.random.fold_in(k, 8))(keys)
    theta = jax.vmap(lambda k: jax.random.uniform(k, (), minval=0.0, maxval=jnp.pi))(bk)
    ek = jax.vmap(lambda k: jax.random.fold_in(k, 9))(keys)
    fields = _raw_fields(ek, H, W)[np.asarray(which) % 10 == 9]
    draws = TenDraws.from_numpy(
        jax.vmap(geo)(keys, w), np.asarray(which) % 10, jax.vmap(phot)(keys, w),
        np.arange(len(which)), theta, fields,
    )
    return draws, _normals(keys, 7, (H, W, 3))


def _jax_simple_draws(keys, which, H, W):
    """SimpleDraws from augment_simple's own draw lines (augment.py:665-701)."""
    from mmtrs_tpu.ops.warp import hflip3, identity3, rotate3, scale3, translate3, vflip3
    from mmtrs_tpu_torch.ops.augment import SimpleDraws

    def geo(key, w):
        k1, k2, k3, k4, k5 = jax.random.split(key, 5)
        tx = jax.random.uniform(k1, (), minval=-0.07, maxval=0.07) * W
        ty = jax.random.uniform(k2, (), minval=-0.07, maxval=0.07) * H
        sc = jax.random.uniform(k3, (), minval=0.9, maxval=1.1)
        ang = jax.random.uniform(k4, (), minval=-25.0, maxval=25.0)
        pad = jax.random.randint(k5, (), 2, 7).astype(jnp.float32)
        zoom = W / (W - 2.0 * pad)
        c = ((W - 1) / 2.0, (H - 1) / 2.0)
        i3 = identity3()
        return jnp.stack([hflip3(float(W)), vflip3(float(H)), translate3(tx, ty), scale3(sc, sc, c),
                          rotate3(ang, c), i3, i3, i3, i3, scale3(zoom, zoom, c)])[w]

    def phot(key, w):
        kb, kc, kcol = jax.random.split(key, 3)
        u = lambda k, lo, hi, on: jnp.where(on, jax.random.uniform(k, (), minval=lo, maxval=hi), 0.0)
        return jnp.stack([u(kb, -0.1, 0.1, w == 5), u(kc, -0.1, 0.1, w == 5), u(kcol, -25.0, 25.0, w == 6),
                          jnp.where(w == 7, 64.0, 0.0)])

    w = jnp.asarray(which)
    draws = SimpleDraws.from_numpy(jax.vmap(geo)(keys, w), np.asarray(which) % 10, jax.vmap(phot)(keys, w),
                                   np.arange(len(which)))
    return draws, _normals(keys, 7, (H, W, 3))


def _jax_randaug_draws(keys, H, W):
    """RandaugDraws from randaug_geo_mats (augment.py:850) and
    random_erasing's box and fill draws (:916-942, erasing keys fold 99)."""
    from mmtrs_tpu.ops import augment as ja
    from mmtrs_tpu_torch.ops.augment import RandaugDraws

    mats, phot = ja.randaug_geo_mats(keys, H, W)
    er = jax.vmap(lambda k: jax.random.fold_in(k, 99))(keys)

    def box(key):
        kg, ka, kr, ki, kj = jax.random.split(key, 5)
        area = jax.random.uniform(ka, (), minval=0.02, maxval=1.0 / 3.0) * H * W
        r = jnp.exp(jax.random.uniform(kr, (), minval=jnp.log(0.3), maxval=jnp.log(3.3)))
        w = jnp.clip(jnp.sqrt(area * r), 1.0, float(W))
        h = jnp.clip(jnp.sqrt(area / r), 1.0, float(H))
        i = jax.random.uniform(ki, (), minval=0.0, maxval=1.0) * (H - h)
        j = jax.random.uniform(kj, (), minval=0.0, maxval=1.0) * (W - w)
        return ja._gate(kg, 0.2), jnp.stack([i, j, h, w])

    on, boxes = jax.vmap(box)(er)
    draws = RandaugDraws.from_numpy(mats=mats, **phot, erase_on=on, erase_box=boxes, seeds=np.arange(len(keys)))
    return draws, phot, er, _normals(er, 7, (H, W, 3))


# -- primitives -----------------------------------------------------------------------


def test_gaussian_blur3_matches_jax():
    """Edge-padded separable 3-tap blur, f32: within 1e-2 (the same taps in
    the same order, so the two agree far inside the blurs' bound)."""
    from mmtrs_tpu.ops.augment import gaussian_blur3 as jblur
    from mmtrs_tpu_torch.ops.augment import gaussian_blur3

    imgs = np.random.default_rng(4).uniform(0, 255, (3, 24, 40, 3)).astype(np.float32)
    want = np.asarray(jblur(jnp.asarray(imgs)))
    np.testing.assert_allclose(gaussian_blur3(_t(imgs)).numpy(), want, atol=1e-2, rtol=0)


def test_seeded_normals_are_k5_noise():
    """seeded_normals draws K5's stream: the noise of a K5 noise row (σ large
    enough to skip the u8 store's rounding) is the same normals, rounded."""
    from mmtrs_tpu_torch.ops.augment import seeded_normals
    from mmtrs_tpu_torch.ops.kernels.photometric import noise_normals_ref

    seeds = torch.tensor([3, -9], dtype=torch.int32)
    z = seeded_normals(seeds, (2, 8, 16, 3))
    assert z.shape == (2, 8, 16, 3)
    assert torch.equal(z.reshape(2, -1), noise_normals_ref(seeds, 8 * 16 * 3))


@pytest.mark.parametrize("var", [9.0, 64.0])
def test_noise_statistics_match_jax(var):
    """The ten/simple noise stage (f32, no u8 staging) on mid-grey images
    away from the clips: out − in has |mean| < 0.06 σ (4 standard errors of
    24,576 samples) and std within 3 % of σ, for the port's on-device hash
    normals and for JAX's threefry normals alike."""
    from mmtrs_tpu.ops.augment import gauss_noise as jnoise
    from mmtrs_tpu_torch.ops.augment import _noise_stage

    imgs = np.random.default_rng(3).uniform(100, 156, (2, 64, 128, 3)).astype(np.float32)
    v = np.array([var, var], np.float32)
    got = _noise_stage(_t(imgs), torch.tensor([True, False]), _t(v), torch.tensor([77, 5], dtype=torch.int32)).numpy()
    want = np.asarray(jnoise(jnp.asarray(imgs), _keys([1, 2]), jnp.asarray(v)))
    np.testing.assert_array_equal(got[1], imgs[1])
    sigma = np.sqrt(var)
    for out in (got[0], want[0]):
        diff = out - imgs[0]
        assert abs(diff.mean()) < 0.06 * sigma, diff.mean()
        assert abs(diff.std() / sigma - 1.0) < 0.03, diff.std()


# -- the stages after the warp, on JAX's draws and normals --------------------------------


def test_ten_stages_match_jax(jax_normals):
    """``ten`` variants 5-9 (identity warp, so JAX augment_ten's output is its
    stages on the input) against ten_photometrics on the same u8 input:
    within 1e-3 per value, motion blur and the elastic shift within 1e-2
    (25 products summed in another order than XLA's convolution; K6's two
    taps against XLA's windowed sum)."""
    from mmtrs_tpu.ops.augment import augment_ten as jten
    from mmtrs_tpu_torch.ops.augment import ten_photometrics

    which = np.array([5, 6, 7, 8, 9, 5, 6, 7], np.int32)
    keys = _keys(range(10, 18))
    imgs = synth_images(len(which), 64, seed=5)
    draws, normals = _jax_ten_draws(keys, which, 64, 64)
    jax_normals(normals)
    want = np.asarray(jten(jnp.asarray(imgs), keys, jnp.asarray(which)))
    got = ten_photometrics(_t(imgs), draws).numpy()
    assert got.dtype == np.float32
    loose = np.isin(which, (8, 9))
    np.testing.assert_allclose(got[~loose], want[~loose], atol=1e-3, rtol=0)
    np.testing.assert_allclose(got[loose], want[loose], atol=1e-2, rtol=0)
    assert np.abs(got[which == 7] - imgs[which == 7]).max() > 5  # the noise fired


def test_simple_stages_match_jax(jax_normals):
    """``simple`` variants 5-8 (identity warp) against simple_photometrics:
    within 1e-3 per value, the Gaussian blur within 1e-2."""
    from mmtrs_tpu.ops.augment import augment_simple as jsimple
    from mmtrs_tpu_torch.ops.augment import simple_photometrics

    which = np.array([5, 6, 7, 8, 5, 6, 7, 8], np.int32)
    keys = _keys(range(20, 28))
    imgs = synth_images(len(which), 64, seed=6)
    draws, normals = _jax_simple_draws(keys, which, 64, 64)
    jax_normals(normals)
    want = np.asarray(jsimple(jnp.asarray(imgs), keys, jnp.asarray(which)))
    got = simple_photometrics(_t(imgs), draws).numpy()
    blur = which == 8
    np.testing.assert_allclose(got[~blur], want[~blur], atol=1e-3, rtol=0)
    np.testing.assert_allclose(got[blur], want[blur], atol=1e-2, rtol=0)


def _randaug_ids(n=8, first=4000):
    """Origin ids (seed 0) whose JAX randaug draws, together, apply every
    photometric op (5-13) and fire the erasing; greedy, like
    tests/test_torch_augment.py's _covering_ids."""
    from mmtrs_tpu.ops import augment as ja

    keys = _keys(range(first))
    _, phot = ja.randaug_geo_mats(keys, 64, 64)
    ph = {k: np.asarray(v) for k, v in phot.items()}
    er = jax.vmap(lambda k: ja._gate(jax.random.split(jax.random.fold_in(k, 99), 5)[0], 0.2))(keys)
    fired = np.stack([ph["invert"], ph["autoc"], ph["post_step"] > 1, ph["solar_thr"] < 256, ph["solar_add"] > 0,
                      ph["color_f"] != 1, ph["contrast_f"] != 1, ph["bright_f"] != 1, ph["sharp_f"] != 1,
                      np.asarray(er)], axis=1)
    chosen, todo = [], np.ones(fired.shape[1], bool)
    while todo.any() and len(chosen) < n:
        score = (fired & todo).sum(axis=1)
        score[chosen] = -1
        best = int(np.argmax(score))
        chosen.append(best)
        todo &= ~fired[best]
    assert not todo.any(), todo
    rest = [i for i in range(first) if i not in chosen]
    return chosen + rest[: n - len(chosen)]


def test_randaug_stages_match_jax(jax_normals):
    """randaug_photometrics and the erasing on the same u8 input, with JAX's
    params, boxes and fill normals, every photometric op and the erasing
    firing: within 1e-3 per value (the same f32 ops in the same order, so
    autocontrast's stretch lands posterize's floor on the same step; only
    the contrast mean sums in another order)."""
    from mmtrs_tpu.ops import augment as ja
    from mmtrs_tpu_torch.ops.augment import random_erasing, randaug_photometrics, subset_apply

    ids = _randaug_ids()
    keys = _keys(ids)
    imgs = synth_images(len(ids), 64, seed=7)
    draws, phot, er, normals = _jax_randaug_draws(keys, 64, 64)
    jax_normals(normals)
    want = np.asarray(ja.random_erasing(ja.randaug_photometrics(jnp.asarray(imgs), phot), er, p=0.2))
    out = randaug_photometrics(_t(imgs), draws)
    got = subset_apply(random_erasing, out, draws.erase_on, draws.erase_box, draws.seeds).numpy()
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)
    assert draws.erase_on.any() and draws.autoc.any()


def test_randaug_posterize_and_solarize_exact_on_integers():
    """Invert, posterize and solarize (+ add) on integer-valued inputs, no
    other op drawn: equal to JAX's bit for bit (the discontinuous stages
    have no rounding to hide behind)."""
    from mmtrs_tpu.ops import augment as ja
    from mmtrs_tpu_torch.ops.augment import RandaugDraws, randaug_photometrics

    B = 4
    imgs = np.random.default_rng(9).integers(0, 256, (B, 16, 24, 3)).astype(np.uint8)
    phot = {
        "invert": np.array([True, False, True, False]), "autoc": np.zeros(B, bool),
        "post_step": np.array([16.0, 128.0, 1.0, 64.0], np.float32),
        "solar_thr": np.array([256.0, 100.0, 37.5, 256.0], np.float32),
        "solar_add": np.array([0.0, 0.0, 40.0, 99.0], np.float32),
        **{k: np.ones(B, np.float32) for k in ("color_f", "contrast_f", "bright_f", "sharp_f")},
    }
    want = np.asarray(ja.randaug_photometrics(jnp.asarray(imgs), {k: jnp.asarray(v) for k, v in phot.items()}))
    draws = RandaugDraws.from_numpy(mats=np.tile(np.eye(3), (B, 1, 1)), **phot, erase_on=np.zeros(B, bool),
                                    erase_box=np.zeros((B, 4)), seeds=np.zeros(B))
    got = randaug_photometrics(_t(imgs), draws).numpy()
    np.testing.assert_array_equal(np.round(got), np.round(want))
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)


# -- whole presets against the JAX TPU route ------------------------------------------------


def _preset_bar(got, want, bar=0.995):
    d = np.abs(_u8(got).astype(int) - _u8(want).astype(int))
    assert (d <= 2).mean() >= bar, ((d <= 2).mean(), d.max())


@pytest.mark.parametrize("preset", ["ten", "simple"])
def test_fixed_variant_presets_match_jax_tpu_route(preset, jax_tpu_route, jax_normals):
    """augment_ten / augment_simple on u8 [10, 64, 64, 3], all ten variants,
    JAX's draws and normals, against the JAX preset on its TPU route (the
    u8-staged two-pass warp, interpret-mode kernels): after round-half-even
    to u8, ≥ 99.5 % of values within 2 levels."""
    from mmtrs_tpu.ops import augment as ja
    from mmtrs_tpu_torch.ops.augment import augment_batch

    which = np.arange(10, dtype=np.int32)
    keys = _keys(range(30, 40))
    imgs = synth_images(10, 64, seed=8)
    make = _jax_ten_draws if preset == "ten" else _jax_simple_draws
    draws, normals = make(keys, which, 64, 64)
    jax_normals(normals)
    want = np.asarray(ja.augment_batch(jnp.asarray(imgs), keys, preset, aug_idx=which))
    got = augment_batch(_t(imgs), draws, preset, aug_idx=which).numpy()
    assert got.dtype == np.float32 and got.shape == imgs.shape
    _preset_bar(got, want)


def test_randaug_matches_jax_tpu_route(jax_tpu_route, jax_normals):
    """augment_randaug on u8 [8, 64, 64, 3] with JAX's draws and normals
    (every photometric op and the erasing firing), against JAX
    augment_randaug on its TPU route: after round-half-even to u8, ≥ 99.5 %
    of values within 2 levels (the warp's u8 store may differ by a level,
    which posterize can turn into a step)."""
    from mmtrs_tpu.ops.augment import augment_randaug as jrandaug
    from mmtrs_tpu_torch.ops.augment import augment_batch

    ids = _randaug_ids()
    keys = _keys(ids)
    imgs = synth_images(len(ids), 64, seed=10)
    draws, _, _, normals = _jax_randaug_draws(keys, 64, 64)
    jax_normals(normals)
    want = np.asarray(jrandaug(jnp.asarray(imgs), keys))
    got = augment_batch(_t(imgs), draws, "randaug").numpy()
    assert got.dtype == np.float32 and got.shape == imgs.shape
    _preset_bar(got, want)


# -- the port's own draws ---------------------------------------------------------------------


def test_ten_variant_dispatch():
    """Variant aug_idx % 10 on the port's own draws: 0 is the exact hflip
    and 1 the exact vflip (tests/test_augment.py:81-89), 10 and 11 the same
    again; variants 2-9 all change the image; draws made for other
    variants are refused."""
    from mmtrs_tpu_torch.ops.augment import augment_batch, draw_ten

    imgs = synth_images(6, 64, seed=1)
    ids = range(6)
    for k, flip in ((0, imgs[:, :, ::-1]), (1, imgs[:, ::-1]), (10, imgs[:, :, ::-1]), (11, imgs[:, ::-1])):
        aug = np.full(6, k)
        out = augment_batch(_t(imgs), draw_ten(42, ids, 1, 64, 64, aug), "ten", aug_idx=aug).numpy()
        np.testing.assert_allclose(out, flip, atol=1e-2, rtol=0)
    for k in range(2, 10):
        aug = np.full(6, k)
        out = augment_batch(_t(imgs), draw_ten(42, ids, 1, 64, 64, aug), "ten", aug_idx=aug).numpy()
        assert not np.allclose(out, imgs, atol=0.5), k
    with pytest.raises(ValueError, match="other variants"):
        augment_batch(_t(imgs), draw_ten(42, ids, 1, 64, 64, np.zeros(6)), "ten", aug_idx=np.ones(6))


def test_draw_ten_and_simple_ranges():
    """The port's draws over 1,000 lineages: every variant's parameter in its
    range and zero outside its variant, elastic fields only for variant 9,
    simple's zoom pad in 2..6 (W / (W − 2·pad))."""
    from mmtrs_tpu_torch.ops.augment import draw_simple, draw_ten

    n, H = 1000, 32
    aug = np.arange(n) % 10
    d = draw_ten(5, range(n), 1, H, H, aug)
    p = d.params.numpy()
    for col, (w, lo, hi) in enumerate([(5, -0.15, 0.15), (5, -0.15, 0.15), (6, -5, 5), (6, -12, 12),
                                       (6, -8, 8), (7, 5, 15)]):
        v = p[:, col]
        assert np.all(v[aug != w] == 0) and np.all((v[aug == w] >= lo) & (v[aug == w] <= hi)), col
    assert d.elastic_fields.shape == (100, 2, H, H)
    assert np.allclose(d.mats[aug >= 5].numpy(), np.eye(3))
    s = draw_simple(5, range(n), 1, H, H, aug)
    zoom = s.mats[aug == 9, 0, 0].numpy()
    pads = np.round(H * (1 - 1 / zoom) / 2)
    assert set(pads.tolist()) == {2.0, 3.0, 4.0, 5.0, 6.0}
    np.testing.assert_array_equal(s.params[aug == 7, 3].numpy(), 64.0)


def test_randaug_apply_rate_and_posterize_map():
    """tests/test_augment.py:160-188 on the port's own host draws: each drawn
    op applies with p 0.5, so some op applies to 0.64-0.86 of 400 images
    (0.75 expected); posterize steps are powers of two in 16..128."""
    from mmtrs_tpu_torch.ops.augment import RANDAUG_SLOTS, _randaug_params, draw_uniforms, randaug_ops
    from mmtrs_tpu_torch.utils.rng import generators_for_batch

    u = draw_uniforms(generators_for_batch(0, range(400), 0), len(RANDAUG_SLOTS))
    geo, phot = _randaug_params(u, 64, 64)
    changed_geo = (geo - torch.eye(3)).abs().amax(dim=(1, 2)) > 1e-6
    changed_phot = (phot["invert"] | phot["autoc"] | (phot["post_step"] > 1) | (phot["solar_thr"] < 256)
                    | (phot["solar_add"] > 0) | (phot["color_f"] != 1) | (phot["contrast_f"] != 1)
                    | (phot["bright_f"] != 1) | (phot["sharp_f"] != 1))
    applied = (changed_geo | changed_phot).float().mean().item()
    assert 0.64 <= applied <= 0.86, applied
    assert applied == (randaug_ops(u) < 14).any(dim=1).float().mean().item()
    steps = phot["post_step"][phot["post_step"] > 1].unique().tolist()
    assert steps and set(steps) <= {16.0, 32.0, 64.0, 128.0}, steps


@pytest.mark.parametrize("preset", ["ten", "simple", "randaug"])
def test_preset_draws_depend_on_lineage_only(preset):
    """The same lineage gives the same draws whatever the batch order."""
    from mmtrs_tpu_torch.ops.augment import draw_batch

    ids = list(range(100, 130))
    aug = [i % 10 for i in ids]
    a = draw_batch(preset, 9, ids, 2, 32, 32, aug_idx=aug)
    perm = np.random.default_rng(0).permutation(len(ids))
    b = draw_batch(preset, 9, [ids[i] for i in perm], 2, 32, 32, aug_idx=[aug[i] for i in perm])
    back = b.take(np.argsort(perm))
    for f in type(a).__dataclass_fields__:
        assert torch.equal(getattr(a, f), getattr(back, f)), f


# -- the records device loop ----------------------------------------------------------------


def test_records_loop_matches_jax_table_builder_order():
    """preset "none" through both loops: the children are the originals in
    the table's order (origin-major, aug_idx ascending), whatever the
    padding of the last batch."""
    pd = pytest.importorskip("pandas")
    from mmtrs_tpu.data.records import build_augmented_table
    from mmtrs_tpu_torch.data.records import augment_children, child_plan

    imgs = synth_images(5, 32, seed=2)
    df = pd.DataFrame({"image_id": [11, 12, 13, 14, 15], "split": ["train"] * 5})
    table, want = build_augmented_table(df, imgs, n_aug=3, preset="none", batch_size=4)
    plan = child_plan(df["image_id"], 3)
    assert [(o, a) for _, o, a in plan] == list(zip(table["origin_id"][5:], table["aug_idx"][5:]))
    got = augment_children(_t(imgs), plan, "none", batch_size=4).numpy()
    np.testing.assert_array_equal(got, want[5:])


@pytest.mark.parametrize("preset", ["ten", "randaug"])
def test_records_loop_padding_and_order(preset):
    """15 children in batches of 4 (the last padded by repeating its last
    entry) equal the same children in one batch of 15, and child k equals
    augmenting plan[k] alone with aug_idx − 1: draws depend on the lineage
    only, and padding changes nothing."""
    from mmtrs_tpu_torch.data.records import augment_children, child_plan, quantize_round_half_even
    from mmtrs_tpu_torch.ops.augment import augment_batch, draw_batch

    imgs = _t(synth_images(5, 32, seed=3))
    plan = child_plan([7, 8, 9, 10, 11], 3)
    got = augment_children(imgs, plan, preset, seed=4, batch_size=4)
    assert got.dtype == torch.uint8 and got.shape == (15, 32, 32, 3)
    assert torch.equal(got, augment_children(imgs, plan, preset, seed=4, batch_size=15))
    for k in (0, 7, 14):
        src, origin, a = plan[k]
        d = draw_batch(preset, 4, [origin], [a], 32, 32, aug_idx=[a - 1])
        one = augment_batch(imgs[src : src + 1], d, preset, aug_idx=[a - 1])
        assert torch.equal(got[k], quantize_round_half_even(one)[0]), k


def test_records_quantise_is_round_half_even():
    """The table's store is jnp.round's half-to-even, clipped; not the
    chain's round-half-up."""
    from mmtrs_tpu_torch.data.records import quantize_round_half_even

    x = np.array([0.5, 1.5, 2.5, 3.49, -0.6, 254.5, 255.7, 128.5], np.float32)
    want = np.asarray(jnp.clip(jnp.round(jnp.asarray(x)), 0, 255).astype(jnp.uint8))
    got = quantize_round_half_even(_t(x)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:3], [0, 2, 2])
    u8 = torch.arange(5, dtype=torch.uint8)
    assert quantize_round_half_even(u8) is u8
