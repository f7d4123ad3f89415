"""K1 and K2 (csrc/clahe_lab.cu) around their kernels, on the CPU: the launch
geometry the wrappers hand the kernels, the launch constants, the lean
wrappers' refusals, and the exhaustive inputs chip_smoke.py holds the
kernels to on the card (the kernels themselves run only there)."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.mark.parametrize(
    "n_tiles,th,sms,want",
    [
        (1024, 64, 132, 1),  # b16 at 512², 8 x 8 tiles: enough blocks
        (64, 64, 132, 4),    # a served 512² upload: a cluster of 4 per tile
        (128, 64, 132, 4),   # b2: 256 blocks at 2 per tile is below 264
        (256, 64, 132, 2),
        (264, 64, 132, 1),
        (64, 2, 132, 2),     # never more blocks than the tile has rows
        (64, 1, 132, 1),
        (64, 64, 16, 1),     # a small card
    ],
)
def test_fwd_split(n_tiles, th, sms, want):
    from mmtrs_tpu_torch.ops.kernels.clahe_lab import fwd_split

    assert fwd_split(n_tiles, th, sms) == want


@pytest.mark.parametrize(
    "shape,th,sms,want",
    [
        ((16, 512, 512), 64, 132, 8),   # 131072 threads of 4 pixels
        ((1, 512, 512), 64, 132, 1),    # a served upload: one row a thread
        ((1, 4096, 4096), 512, 132, 16),
        ((16, 512, 512), 4, 132, 2),    # a divisor of th // 2
        ((2, 64, 64), 8, 132, 1),
        ((3, 1000, 10), 125, 1, 2),     # W not a multiple of 4, th odd
    ],
)
def test_bwd_band(shape, th, sms, want):
    """K2's band: a power of two that divides th // 2, so that (th even) a
    band never straddles a change of its rows' lower tile row, which lies at
    rows th/2 + k·th."""
    from mmtrs_tpu_torch.ops.kernels.clahe_lab import bwd_band

    band = bwd_band(*shape, th, sms)
    assert band == want
    assert (th // 2) % band == 0
    if th % 2 == 0:
        for start in range(0, shape[1], band):
            lows = {min(max(int(np.floor(np.float32(y) / np.float32(th) - np.float32(0.5))), 0), shape[1] // th - 1)
                    for y in range(start, min(start + band, shape[1]))}
            assert len(lows) == 1, (start, lows)


def test_launch_constants(monkeypatch):
    """K1's and K2's cached launch constants past the pointers: K1's struct
    (B, H, W, ty, tx, limit, LUT scale, split), laid out as the C struct,
    and K2's arguments (B, H, W, ty, tx, band); off the tile grid they
    raise."""
    from mmtrs_tpu_torch.ops.clahe import clip_limit
    from mmtrs_tpu_torch.ops.kernels import clahe_lab as K

    monkeypatch.setattr(K, "sm_count", lambda device: 132)
    K._fwd_args.cache_clear()
    K._bwd_args.cache_clear()
    try:
        fields = lambda a: tuple(getattr(a, f) for f, _ in a._fields_)
        scale = float(np.float32(255 / 4096))  # a C float
        assert fields(K._fwd_args(16, 512, 512, (8, 8), 3.0, 0)) == (16, 512, 512, 8, 8, clip_limit(3.0, 4096), scale, 1)
        assert fields(K._fwd_args(1, 512, 512, (8, 8), 2.0, 0))[-3:] == (clip_limit(2.0, 4096), scale, 4)
        assert K._bwd_args(16, 512, 512, (8, 8), 0) == (16, 512, 512, 8, 8, 8)
        assert K._bwd_args(1, 512, 512, (8, 8), 0)[-1] == 1
        with pytest.raises(ValueError, match="tile grid"):
            K._fwd_args(1, 20, 16, (8, 8), 3.0, 0)
        with pytest.raises(ValueError, match="tile grid"):
            K._bwd_args(1, 16, 20, (8, 8), 0)
    finally:
        K._fwd_args.cache_clear()
        K._bwd_args.cache_clear()


def test_every_byte_triple_holds_each_case_once():
    from chip_smoke import every_byte_triple

    t = every_byte_triple()
    assert t.shape == (4096, 4096, 3) and t.dtype == np.uint8
    packed = (t[..., 0].astype(np.int64) << 16) | (t[..., 1].astype(np.int64) << 8) | t[..., 2]
    assert np.array_equal(np.bincount(packed.ravel(), minlength=1 << 24), np.ones(1 << 24, dtype=np.int64))


def test_identity_luts_make_k2_the_backward_conversion():
    """With identity LUTs K2's blend returns L' itself, so K2 on the
    every-triple planes meets every input of the backward conversion (here
    the planes' first 64 rows, through the plain versions)."""
    from chip_smoke import every_byte_triple
    from mmtrs_tpu_torch.ops.kernels.clahe_lab import clahe_apply_lab_bwd_ref, lab_bwd_ref

    t = torch.from_numpy(every_byte_triple()[None, :64])
    lq, da, db = (t[..., c].contiguous() for c in range(3))
    da, db = da.view(torch.int8), db.view(torch.int8)
    ident = torch.arange(256, dtype=torch.uint8).expand(1, 64, 256).contiguous()
    assert torch.equal(clahe_apply_lab_bwd_ref(lq, da, db, ident, (8, 8)), lab_bwd_ref(lq, da, db))


def _k2_inputs():
    lq = torch.zeros((2, 16, 16), dtype=torch.uint8)
    d = torch.zeros((2, 16, 16), dtype=torch.int8)
    lut = torch.zeros((2, 64, 256), dtype=torch.uint8)
    return lq, d, d.clone(), lut


@pytest.mark.parametrize("case", ["da_dtype", "noncontig", "lut_shape", "plane_shape", "tiles"])
def test_k2_rejects_bad_inputs(case):
    from mmtrs_tpu_torch.ops.kernels.clahe_lab import clahe_apply_lab_bwd

    lq, da, db, lut = _k2_inputs()
    args, msg = {
        "da_dtype": ((lq, da.view(torch.uint8), db, lut), "int8"),
        "noncontig": ((lq.transpose(1, 2), da, db, lut), "contiguous"),
        "lut_shape": ((lq, da, db, lut[:, :16].contiguous()), "mismatched"),
        "plane_shape": ((lq, da[:, :8].contiguous(), db, lut), "mismatched"),
        "tiles": ((torch.zeros((2, 20, 16), dtype=torch.uint8), da, db, lut), "tile grid"),
    }[case]
    with pytest.raises(ValueError, match=msg):
        clahe_apply_lab_bwd(*args)


def test_k2_raises_off_cpu_instead_of_plain_result():
    """A tensor that is not on the CPU never gets K2's plain version: a
    meta-device batch (a CPU-only machine has no CUDA one) is refused."""
    from mmtrs_tpu_torch.ops.kernels.clahe_lab import clahe_apply_lab_bwd

    meta = [t.to("meta") for t in _k2_inputs()]
    with pytest.raises(ValueError, match="CUDA device"):
        clahe_apply_lab_bwd(*meta)


def test_k1_wrapper_takes_plain_version_on_cpu():
    """The lean path only accepts CUDA tensors: a CPU batch goes through the
    full check to the plain version, planes typed u8 / i8 / i8."""
    from mmtrs_tpu_torch.ops.kernels.clahe_lab import clahe_lab_fwd_lut, clahe_lab_fwd_lut_ref
    from mmtrs_tpu_torch.synth import synth_teeth

    x = torch.from_numpy(synth_teeth(2, 64, seed=3))
    got, want = clahe_lab_fwd_lut(x, 3.0, (8, 8)), clahe_lab_fwd_lut_ref(x, 3.0, (8, 8))
    assert [t.dtype for t in got] == [torch.uint8, torch.int8, torch.int8, torch.uint8]
    assert all(torch.equal(g, w) for g, w in zip(got, want))
