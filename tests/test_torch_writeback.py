"""The in-place write-back of the chains' gated members (``subset_apply_``)
and the ``legacy`` CLAHE member's route, on the CPU.

- ``subset_apply_`` writes the same bytes as ``subset_apply`` into the batch
  it is given; the host and device paths of the row ids agree.
- Every public entry point on this path leaves its caller's tensor as it
  was, and gives the same result as with the copying ``subset_apply`` at
  every site.
- The ``legacy`` preset's CLAHE member takes the route the JAX package's
  ``_clahe_sub`` (mmtrs_tpu/ops/augment.py:543-558) takes on a TPU: off the
  fused kernels' shapes, JAX's ``_q8(clahe_rgb(·, quant_l=True))``, run here
  on the CPU; at 128² the fused LAB kernels K1/K2.

Inputs come from numpy seeds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmtrs_tpu_torch.synth import synth_teeth


def _batch(dtype, B=6, size=8, seed=3):
    x = np.random.default_rng(seed).integers(0, 200, (B, size, size, 3)).astype(np.uint8)
    return torch.from_numpy(x).to(dtype)


def _masks(B=6):
    return {
        "empty": torch.zeros(B, dtype=torch.bool),
        "full": torch.ones(B, dtype=torch.bool),
        "some": torch.tensor([True, False, False, True, True, False]),
    }


@pytest.mark.parametrize("mask", ["empty", "full", "some"])
@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32])
def test_subset_apply_in_place_matches_the_copy(dtype, mask):
    """The same bytes as ``subset_apply``, written into the tensor given
    (which is also returned); the copying version leaves its input alone."""
    from mmtrs_tpu_torch.ops.augment import subset_apply, subset_apply_

    x = _batch(dtype)
    on = _masks()[mask]
    op = lambda s, k: s + k.to(dtype)[:, None, None, None] + 1
    keep = x.clone()
    want = subset_apply(op, x, on, torch.arange(6))
    assert torch.equal(x, keep)
    got = subset_apply_(op, x, on, torch.arange(6))
    assert got is x
    assert torch.equal(got, want)
    assert torch.equal(x[~on], keep[~on])
    if on.any():
        assert not torch.equal(x[on], keep[on])


def test_subset_apply_in_place_refuses_a_strided_batch():
    from mmtrs_tpu_torch.ops.augment import subset_apply_

    x = _batch(torch.uint8).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        subset_apply_(lambda s: s, x, torch.ones(6, dtype=torch.bool))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_host_and_device_row_ids_select_the_same_rows(seed):
    """The ids taken on the host (gates drawn there) and on the batch's
    device (gates computed there) are the same rows, in the same order, for
    random, empty and full masks; ``row_ids`` takes the host path for CPU
    gates."""
    from mmtrs_tpu_torch.ops.augment import device_row_ids, host_row_ids, row_ids

    cpu = torch.device("cpu")
    rng = np.random.default_rng(seed)
    for on in (torch.from_numpy(rng.random(33) < 0.3), torch.zeros(5, dtype=torch.bool),
               torch.ones(7, dtype=torch.bool)):
        h, d = host_row_ids(on, cpu), device_row_ids(on, cpu)
        assert h.dtype == d.dtype == torch.int64
        assert torch.equal(h, d)
        assert torch.equal(row_ids(on, cpu), h)
        assert torch.equal(h, torch.arange(on.numel())[on])


def _copying(monkeypatch):
    """Every in-place site replaced by the copying ``subset_apply``."""
    from mmtrs_tpu_torch.ops import augment, deskew

    monkeypatch.setattr(augment, "subset_apply_", augment.subset_apply)
    monkeypatch.setattr(deskew, "subset_apply_", augment.subset_apply)


def _preset_case(preset, size=48):
    """A u8 batch and draws on which the preset's gated members fire."""
    from mmtrs_tpu_torch.ops.augment import draw_batch

    B = 10
    x = torch.from_numpy(synth_teeth(B, size, seed=5))
    aug = list(range(B))  # every variant of ten / simple
    ids = {"legacy": [2, 0, 1, 3, 4, 5, 175, 1091, 6, 7], "randaug": [21, 4, 24, 27, 57, 106, 123, 0, 1, 2]}
    draws = draw_batch(preset, 20261016, ids.get(preset, list(range(B))), 0, size, size, aug_idx=aug,
                       img_size=size)
    return x, draws, aug


@pytest.mark.parametrize("preset", ["none", "legacy", "ten", "simple", "randaug"])
def test_augment_batch_leaves_its_input_unmutated(preset, monkeypatch):
    """augment_batch of every preset keeps the caller's batch byte for byte
    and gives the same result as with copying write-backs."""
    from mmtrs_tpu_torch.ops.augment import augment_batch

    x, draws, aug = _preset_case(preset)
    if preset == "legacy":
        assert bool(draws.use_clahe.any() and draws.blur_on.any() and draws.elastic_on.any())
    if preset == "randaug":
        assert bool(draws.erase_on.any())
    keep = x.clone()
    got = augment_batch(x, draws, preset, aug_idx=aug, img_size=x.shape[1])
    assert torch.equal(x, keep)
    _copying(monkeypatch)
    want = augment_batch(x, draws, preset, aug_idx=aug, img_size=x.shape[1])
    assert torch.equal(got, want)


def _teeth(B=3, size=128):
    return torch.from_numpy(synth_teeth(B, size, seed=8, angles_deg=[30.0, -25.0] + [0.0] * (B - 2)))


@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32])
def test_deskew_batch_writes_into_the_batch_it_is_given(dtype, monkeypatch):
    """deskew_batch returns the batch it was given, the two firing images
    rotated in it and the others untouched, with the copying path's bytes."""
    from mmtrs_tpu_torch.ops.deskew import deskew_batch

    x = _teeth(4).to(dtype)
    keep = x.clone()
    got, angle = deskew_batch(x)
    fired = angle != 0
    assert got is x and int(fired.sum()) == 2
    assert torch.equal(x[~fired], keep[~fired])
    assert not torch.equal(x[fired], keep[fired])
    _copying(monkeypatch)
    want, want_angle = deskew_batch(keep.clone())
    assert torch.equal(got, want) and torch.equal(angle, want_angle)


def test_preprocess_batch_leaves_its_input_unmutated(monkeypatch):
    """Deskew fires on two images and writes back into the CLAHE stage's
    output: the caller's batch keeps its bytes, the result equals the
    copying path's."""
    from mmtrs_tpu_torch.preprocess import preprocess_batch

    x = _teeth()
    keep = x.clone()
    out, info = preprocess_batch(x)
    assert int((info["deskew_angle"] != 0).sum()) == 2
    assert torch.equal(x, keep)
    _copying(monkeypatch)
    want, _ = preprocess_batch(x)
    assert torch.equal(out, want)


def test_preprocess_augment_batch_leaves_its_input_unmutated(monkeypatch):
    from mmtrs_tpu_torch.ops.augment import draw_legacy
    from mmtrs_tpu_torch.preprocess import preprocess_augment_batch

    x = _teeth(4)
    draws = draw_legacy(20261016, [2, 175, 1091, 0], 0, 128, 128, img_size=128)
    keep = x.clone()
    out, info = preprocess_augment_batch(x, draws, out_size=128)
    assert int((info["deskew_angle"] != 0).sum()) == 2
    assert torch.equal(x, keep)
    _copying(monkeypatch)
    want, _ = preprocess_augment_batch(x, draws, out_size=128)
    assert torch.equal(out, want)


def test_preprocess_stream_leaves_its_input_unmutated(monkeypatch):
    """Host batches on the L-plane route (136 px wide) with deskew firing."""
    from mmtrs_tpu_torch.config import PreprocessConfig
    from mmtrs_tpu_torch.preprocess import preprocess_stream

    host = synth_teeth(2, (96, 136), seed=9, angles_deg=[30.0, 0.0])
    keep = host.copy()
    cfg = PreprocessConfig(output_size=64)
    (_, got, info), = preprocess_stream(iter([(0, host)]), cfg, device="cpu")
    assert info["deskew_angle"][0] != 0
    assert np.array_equal(host, keep)
    _copying(monkeypatch)
    (_, want, _), = preprocess_stream(iter([(0, host)]), cfg, device="cpu")
    assert np.array_equal(got, want)


def _clahe_only_draws(B, size):
    """LegacyDraws whose only firing member is the OneOf's CLAHE branch, on
    image 0 (K5's parameters all zero: the pointwise pass is the identity)."""
    from mmtrs_tpu_torch.ops.augment import LegacyDraws

    off = np.zeros(B, bool)
    on = off.copy()
    on[0] = True
    return LegacyDraws.from_numpy(
        np.tile(np.eye(3, dtype=np.float32), (B, 1, 1)), np.zeros((B, 10), np.float32),
        np.zeros(B, np.int32), on, off, np.zeros(B, np.float32), off, np.zeros((0, 2, size, size), np.float32))


def test_legacy_clahe_member_off_the_fused_shapes_takes_jax_route(monkeypatch):
    """[2, 96, 96, 3] fails photometric_kernel.supports (96·3 % 128 ≠ 0), so
    JAX's _clahe_sub runs ``_q8(clahe_rgb(·, clip=2.0, tiles=(8, 8),
    quant_l=True))``; the port's member takes the same route (the fused
    kernels are not called) and matches that JAX path run on the CPU: max
    1 level, ≥ 99.5 % of values equal (the blends' tile fractions, 12 px
    tiles, round differently: ROADMAP Queue 3). Image 1 passes through."""
    from mmtrs_tpu.ops import augment as ja
    from mmtrs_tpu.ops.clahe import clahe_rgb as jclahe_rgb
    from mmtrs_tpu_torch.ops import augment

    def refuse(*a, **k):
        raise AssertionError("the fused LAB route was taken")

    monkeypatch.setattr(augment, "clahe_lab_fused", refuse)
    x = synth_teeth(2, 96, seed=4)
    got = augment.legacy_photometrics(torch.from_numpy(x), _clahe_only_draws(2, 96), img_size=96).numpy()
    want = np.asarray(ja._q8(jclahe_rgb(jnp.asarray(x[:1]).astype(jnp.float32), clip=2.0, tiles=(8, 8),
                                        quant_l=True)))
    d = np.abs(got[:1].astype(int) - want.astype(int))
    assert d.max() <= 1 and (d == 0).mean() >= 0.995, (d.max(), (d == 0).mean())
    assert np.array_equal(got[1], x[1])


def test_legacy_clahe_member_at_128_takes_the_fused_kernels(monkeypatch):
    """At 128² both predicates hold: the member is K1/K2's
    ``clahe_lab_fused`` (the L-plane route is not called), as the
    jax_tpu_route chain test of tests/test_torch_augment.py expects."""
    from mmtrs_tpu_torch.ops import augment
    from mmtrs_tpu_torch.ops.kernels.clahe_lab import clahe_lab_fused

    def refuse(*a, **k):
        raise AssertionError("the L-plane route was taken")

    monkeypatch.setattr(augment, "clahe_rgb", refuse)
    x = torch.from_numpy(synth_teeth(2, 128, seed=4))
    got = augment.legacy_photometrics(x, _clahe_only_draws(2, 128), img_size=128)
    assert torch.equal(got[:1], clahe_lab_fused(x[:1], clip=2.0, tiles=(8, 8)))
    assert torch.equal(got[1], x[1])
