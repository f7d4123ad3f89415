"""K5, the ``legacy`` photometric pass (ops/kernels/photometric.py): its
plain version held against the JAX package's Pallas kernel in interpret mode
and its XLA oracle on the rows the kernel's checks use (hue wrapped both
ways, S and V clipped, holes at every edge, brightness/contrast ±0.15); the
host side of the CUDA kernel's launch (blocks per image, each image's head,
8-pixel chunks and tail); the wrapper's argument errors; and the mixes and
kernel-name tags chip_profile.py times K5 by.

The kernel itself runs only on the card, where chip_smoke.py holds it
``torch.equal`` to the plain version. Noise stays off against the JAX
kernel: ``pltpu.prng_*`` has no interpret lowering (its parity is by
statistics, tests/test_torch_augment.py).
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmtrs_tpu_torch.ops.kernels import LAUNCHES
from mmtrs_tpu_torch.ops.kernels import photometric as K

ROOT = Path(__file__).resolve().parents[1]
B, H, W, HOLE = 8, 32, 128, 5  # W·3 = 384 lanes: a shape the Pallas kernel takes


def _rows() -> np.ndarray:
    """HSV rows that wrap the hue both ways (dh ±5) and clip S (ds ±12) and
    V (dv ±8), two after brightness/contrast ±0.15 with holes at opposite
    corners, and two of brightness/contrast with a hole at the other two."""
    rows = [[0, 0, dh, ds, dv, 1, 0, 0, 0, 0] for dh, ds, dv in [(-5, -12, -8), (5, 12, 8), (5, -12, 8), (-5, 12, -8)]]
    rows += [[0.15, 0.15, 5, 12, 8, 1, 0, 1, 0, 0], [-0.15, -0.15, -5, -12, -8, 1, 0, 1, H - HOLE, W - HOLE],
             [0.15, -0.15, 0, 0, 0, 0, 0, 1, 0, W - HOLE], [-0.15, 0.15, 0, 0, 0, 0, 0, 1, H - HOLE, 0]]
    return np.array(rows, np.float32)


def _images(kind: str) -> np.ndarray:
    rng = np.random.default_rng(7)
    if kind == "teeth":
        from tests.synth import synth_images

        return np.ascontiguousarray(np.stack(synth_images(B, W, seed=7))[:, :H])
    imgs = rng.integers(0, 256, (B, H, W, 3)).astype(np.uint8)
    sat = rng.random((B, H, W, 3))
    imgs[sat < 0.15] = 0
    imgs[sat > 0.85] = 255
    return imgs


@pytest.mark.parametrize("kind", ["saturated random", "teeth"])
def test_plain_matches_jax_kernel_interpret(kind):
    """Against the Pallas kernel in interpret mode: within one level
    everywhere and equal on ≥ 99 % of the values (99.56 % and 99.72 % on
    these inputs). A level is the resolution of XLA on the CPU here: on
    these same inputs the JAX kernel and the JAX package's own XLA oracle
    differ from each other by a level (asserted below; the kernel's
    brightness/contrast rows round apart from the oracle's on values that
    sit on a quantiser boundary, every 20th byte under ±0.15), and the
    plain version agrees with the oracle exactly on the rows without HSV.
    The holes are zero in all three."""
    from mmtrs_tpu.ops.augment import photometrics_pointwise_ref as oracle
    from mmtrs_tpu.ops.pallas.photometric_kernel import photometrics_fused_pallas, supports
    from mmtrs_tpu.utils.rng import keys_for_batch

    assert supports(H, W) and K.supports(H, W)
    imgs, params, seeds = _images(kind), _rows(), np.arange(B, dtype=np.int32)
    got = K.photometric(torch.from_numpy(imgs), torch.from_numpy(params), torch.from_numpy(seeds), HOLE).numpy()
    kern = np.asarray(photometrics_fused_pallas(jnp.asarray(imgs), jnp.asarray(params), jnp.asarray(seeds), HOLE,
                                                interpret=True))
    keys = keys_for_batch(0, jnp.arange(B, dtype=jnp.uint32), jnp.zeros(B, jnp.uint32))
    ora = np.asarray(oracle(jnp.asarray(imgs), jnp.asarray(params), keys, HOLE))
    d = np.abs(got.astype(int) - kern.astype(int))
    assert d.max() <= 1 and (d == 0).mean() >= 0.99, (d.max(), (d == 0).mean())
    no_hsv = params[:, 5] == 0
    np.testing.assert_array_equal(got[no_hsv], ora[no_hsv])
    if kind == "saturated random":  # JAX's own two routes a level apart
        assert np.abs(kern.astype(int) - ora.astype(int)).max() == 1
    for b in np.flatnonzero(params[:, 7] > 0):
        y0, x0 = int(params[b, 8]), int(params[b, 9])
        for out in (got, kern, ora):
            assert not out[b, y0:y0 + HOLE, x0:x0 + HOLE].any()


@pytest.mark.parametrize("y0,x0", [(0, 0), (0, W - HOLE), (H - HOLE, 0), (H - HOLE, W - HOLE)])
def test_plain_hole_at_each_corner(y0, x0):
    """A hole touching two edges zeroes exactly its HOLE × HOLE square, with
    noise on (the hole comes after it), and nothing else moves."""
    imgs = _images("teeth")[:2]
    params = np.zeros((2, 10), np.float32)
    params[:, 6] = np.sqrt(5.0)
    params[0, 7:10] = (1.0, y0, x0)
    seeds = np.array([3, -3], np.int32)
    got = K.photometric(torch.from_numpy(imgs), torch.from_numpy(params), torch.from_numpy(seeds), HOLE).numpy()
    params[0, 7] = 0.0
    free = K.photometric(torch.from_numpy(imgs), torch.from_numpy(params), torch.from_numpy(seeds), HOLE).numpy()
    mask = np.zeros((H, W), bool)
    mask[y0:y0 + HOLE, x0:x0 + HOLE] = True
    assert not got[0][mask].any()
    np.testing.assert_array_equal(got[0][~mask], free[0][~mask])
    np.testing.assert_array_equal(got[1], free[1])


# -- the launch plan ------------------------------------------------------------------

SHAPES = [(512, 512), (380, 380), (752, 1000), (97, 101), (5, 3), (1, 1), (3, 1), (3024, 4032)]


@pytest.mark.parametrize("shape", SHAPES, ids=["x".join(map(str, s)) for s in SHAPES])
def test_jobs_cover_each_pixel_once(shape):
    """For an image's output at every byte of the 8-byte grid: the head
    brings it onto the grid, the chunks are whole 8-byte words there, the
    tail is short, and the jobs of launch_blocks' grid (job j < chunks: a
    chunk; j == chunks: head and tail) hold every pixel once."""
    h, w = shape
    n = h * w
    jobs = K.launch_blocks(h, w) * K._THREADS
    for addr in range(1000, 1008):
        head, chunks, tail = K.image_split(addr, n)
        assert 0 <= head < 8 and 0 <= tail < 8 and head + K._PX * chunks + tail == n
        if chunks:
            assert (addr + 3 * head) % 8 == 0
        assert chunks <= jobs and (chunks < jobs or head + tail == 0)
        if n < 4096:
            seen = np.zeros(n, int)
            for j in range(chunks):
                seen[head + K._PX * j: head + K._PX * (j + 1)] += 1
            seen[:head] += 1
            seen[head + K._PX * chunks:] += 1
            assert (seen == 1).all()


def test_launch_blocks_values():
    """512²: 128 blocks of 2048 pixels an image; 97 × 101: 5."""
    assert K.launch_blocks(512, 512) == 128
    assert K.launch_blocks(97, 101) == 5
    assert K.launch_blocks(1, 1) == 1


@pytest.mark.parametrize("B_,H_,W_", [(65536, 8, 8), (1, 26755, 26755)])
def test_launch_args_refuse_what_the_grid_cannot_hold(B_, H_, W_):
    """More images than a grid dimension holds, or an image of 2^31 bytes."""
    with pytest.raises(ValueError, match="photometric"):
        K._launch_args(B_, H_, W_)


# -- the wrapper ------------------------------------------------------------------


def _args(b=2, h=8, w=16):
    imgs = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (b, h, w, 3)).astype(np.uint8))
    params = torch.zeros((b, 10))
    params[:, 0] = 0.1
    return imgs, params, torch.arange(b, dtype=torch.int32), 3


BAD = {
    "f32 images": lambda i, p, s, h: (i.float(), p, s, h),
    "3-dim images": lambda i, p, s, h: (i[0], p, s, h),
    "4 channels": lambda i, p, s, h: (torch.cat([i, i[..., :1]], -1), p, s, h),
    "strided images": lambda i, p, s, h: (i.transpose(1, 2), p, s, h),
    "params of 9 columns": lambda i, p, s, h: (i, p[:, :9].contiguous(), s, h),
    "f64 params": lambda i, p, s, h: (i, p.double(), s, h),
    "params of another batch": lambda i, p, s, h: (i, p[:1].contiguous(), s, h),
    "i64 seeds": lambda i, p, s, h: (i, p, s.long(), h),
    "seeds of another batch": lambda i, p, s, h: (i, p, s[:1].contiguous(), h),
    "hole 0": lambda i, p, s, h: (i, p, s, 0),
    "params on another device": lambda i, p, s, h: (i, p.to("meta"), s, h),
}


@pytest.mark.parametrize("what", list(BAD))
def test_wrapper_refuses(what):
    with pytest.raises(ValueError, match="photometric"):
        K.photometric(*BAD[what](*_args()))


@pytest.mark.parametrize("b,h,w", [(2, 8, 16), (0, 8, 16), (3, 97, 101)])
def test_wrapper_on_cpu_is_the_plain_version(b, h, w):
    """A CPU tensor takes the plain version and launches nothing."""
    args = _args(b, h, w)
    before = LAUNCHES["photometric"]
    out = K.photometric(*args)
    assert LAUNCHES["photometric"] == before
    assert out.dtype == torch.uint8 and out.shape == args[0].shape
    assert torch.equal(out, K.photometric_ref(*args))


# -- what chip_profile.py times K5 by ------------------------------------------------


def test_chip_profile_names_and_spans():
    """--line-times finds K5 by the device function csrc/photometric.cu
    defines (the parent's has the same name), and --sass finds the functions
    it counts."""
    import chip_profile

    src = ROOT / "mmtrs_tpu_torch" / "csrc" / "photometric.cu"
    assert "photometric_kernel" in chip_profile.LINE_KERNEL_NAMES["K5"]
    assert re.search(r"\bphotometric_kernel\(", src.read_text())
    names = ("hsv_shift", "normal_of", "map_word", "run_pixel", "heavy_chunk")
    spans = chip_profile._spans(src, names)
    assert set(spans) == set(names)
    for a, b in spans.values():
        assert a < b


@pytest.mark.parametrize("mix", ["a", "b", "c", "d"])
def test_k5_mixes(monkeypatch, mix):
    """chip_smoke.py's K5 mixes at a small size: (a) phase 2's seven kinds,
    (b) the legacy draws, (c) brightness/contrast alone on every image, (d)
    every member on every image."""
    import chip_smoke
    from mmtrs_tpu_torch.synth import synth_teeth

    monkeypatch.setattr(chip_smoke, "SHAPE", (7, 48, 48, 3))
    monkeypatch.setattr(chip_smoke, "AUG_SHAPE", (6, 48, 48, 3))
    x = torch.from_numpy(synth_teeth(7, 48, seed=1))
    imgs, params, seeds, hole = chip_smoke._photometric_mix(torch, torch.device("cpu"), x, mix,
                                                            torch.Generator().manual_seed(0))
    assert imgs.dtype == torch.uint8 and params.shape == (imgs.shape[0], 10) and seeds.dtype == torch.int32
    assert hole == (48 // 24)
    on = params != 0
    if mix == "a":
        assert on[:, 5].sum() == 2 and on[:, 6].sum() == 3
    if mix == "c":
        assert on[:, :2].all() and not on[:, 2:].any()
    if mix == "d":
        assert on[:, :8].all() and (params[:, 6] ** 2 >= 5.0 - 1e-4).all() and (params[:, 6] ** 2 <= 15.0 + 1e-4).all()
    out = K.photometric(imgs, params, seeds, hole)
    assert torch.equal(out, K.photometric_ref(imgs, params, seeds, hole))
