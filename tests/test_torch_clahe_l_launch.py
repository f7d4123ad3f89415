"""The launch plans of K8 and K9 (ops/kernels/clahe.py), which the kernels in
csrc/clahe_l.cu follow: K8's blocks per tile, K9's bands of rows and the
arguments each wrapper caches, at every shape the L-plane route gives them
and on cards of 132 and 114 SMs (H100 SXM and PCIe). Also the wrappers on
the CPU, and the kernel-name tags chip_profile.py times them by.

The kernels themselves run only on the card; chip_smoke.py holds them to
their plain versions there. These tests hold the host's side.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from mmtrs_tpu_torch.ops.kernels import clahe as C

ROOT = Path(__file__).resolve().parents[1]
TILES = (8, 8)
# a served request, serving's buckets at b16, the archive's batch (b4 and
# b2) and a 750x1000 archive padded to /8
SHAPES = [(1, 512, 688), (16, 512, 688), (16, 688, 512), (16, 512, 912), (4, 3024, 4032), (2, 3024, 4032),
          (2, 752, 1000)]
SMS = [132, 114]
CASES = [(shape, sms) for shape in SHAPES for sms in SMS]


def _ids(cases):
    return [f"{'x'.join(map(str, shape))}-{sms}sm" for shape, sms in cases]


def _tile_rows(y: torch.Tensor, th: int, ty: int):
    """The kernel's lower and upper tile rows of rows ``y``, in f32 as
    tile_coord computes them: floor(y / th - 0.5) clamped to [0, ty - 1]."""
    f = y.to(torch.float32) / torch.tensor(float(th)) - 0.5
    lo = torch.clamp(torch.floor(f), 0, ty - 1).long()
    return lo, torch.clamp_max(lo + 1, ty - 1)


@pytest.mark.parametrize("shape", SHAPES, ids=["x".join(map(str, s)) for s in SHAPES])
def test_hist_split_fits_the_tile_and_the_cluster(shape):
    """K8's blocks per tile: a power of two up to 8 (a portable cluster),
    never more than the tile's rows, and doubled only while a block would
    count more than _SPLIT_PIXELS pixels."""
    B, H, W = shape
    ty, tx = TILES
    th, area = H // ty, (H // ty) * (W // tx)
    split = C.hist_split(area, th)
    assert split in (1, 2, 4, 8) and split <= th
    assert split == 1 or area > C._SPLIT_PIXELS * split // 2
    assert split == C._MAX_SPLIT or 2 * split > th or area <= C._SPLIT_PIXELS * split


@pytest.mark.parametrize("shape,want", [((1, 512, 688), 1), ((16, 512, 688), 1), ((4, 3024, 4032), 2),
                                        ((2, 752, 1000), 1), ((1, 16000, 1600), 4), ((1, 24, 800000), 2),
                                        ((1, 64000, 64000), 8)])
def test_hist_split_values(shape, want):
    """What the rule gives: serving's tiles one block each, a 12 MP tile of
    190,512 px over 2 blocks, 400,000 px over 4, tiles of 3 rows over 2 at
    most (never more blocks than rows), and at most 8 (a portable cluster)."""
    B, H, W = shape
    assert C.hist_split((H // 8) * (W // 8), H // 8) == want


@pytest.mark.parametrize("shape,sms", CASES, ids=_ids(CASES))
def test_band_plan_covers_each_row_once(shape, sms):
    """K9's bands 0 .. apply_bands - 1 (its grid's rows) hold every row of
    the image exactly once, none is empty, and the next one would be; a
    band has at most ``band`` rows, and ``band`` is within 2..32 and th."""
    B, H, W = shape
    th = H // TILES[0]
    band = C.apply_band(B, H, W, th, sms)
    assert 1 <= band <= min(C._MAX_BAND, th)
    n = C.apply_bands(H, th, band)
    rows = []
    for j in range(n):
        ya, yb = C.band_rows(j, H, th, band)
        assert ya < yb and yb - ya <= band, (j, ya, yb)
        rows.extend(range(ya, yb))
    assert rows == list(range(H))
    ya, yb = C.band_rows(n, H, th, band)
    assert ya >= yb


@pytest.mark.parametrize("shape,sms", CASES, ids=_ids(CASES))
def test_every_band_spans_two_tile_rows_so_is_staged(shape, sms):
    """Under the kernel's own f32 tile coordinate, the first and last rows
    of every band of the plan share their lower tile row, so the band reads
    two tile rows of LUTs (the lower one and its upper neighbour): the
    kernel's condition for staging them (with 8 tiles across) instead of
    reading them from global memory."""
    B, H, W = shape
    ty = TILES[0]
    th = H // ty
    band = C.apply_band(B, H, W, th, sms)
    bounds = torch.tensor([C.band_rows(j, H, th, band) for j in range(C.apply_bands(H, th, band))])
    first, _ = _tile_rows(bounds[:, 0], th, ty)
    last, upper = _tile_rows(bounds[:, 1] - 1, th, ty)
    assert torch.equal(first, last)
    assert int((upper - first).max()) <= 1


@pytest.mark.parametrize("th,band", [(1, 1), (5, 4), (43, 8), (64, 5), (86, 8), (94, 4), (189, 32), (378, 32)])
def test_band_rows_cut_at_the_lower_tile_rows_changes(th, band):
    """With 8 tile rows of ``th`` rows (halves odd, even and prime), every
    change of the lower tile row (th/2 + k·th, found in f32) falls on a
    band's first row, so no band's rows span two lower tile rows."""
    ty = 8
    H = ty * th
    y = torch.arange(H)
    lo, _ = _tile_rows(y, th, ty)
    changes = set((torch.nonzero(lo[1:] != lo[:-1]).flatten() + 1).tolist())
    edges = {C.band_rows(j, H, th, band)[0] for j in range(C.apply_bands(H, th, band))}
    assert changes <= edges


def test_launch_args(monkeypatch):
    """The cached arguments past the pointers: K8's (B, H, W, ty, tx, clip
    limit, LUT scale, split), K9's (B, H, W, ty, tx, band, bands); off the
    tile grid they raise, and so does a grid dimension past 65535."""
    from mmtrs_tpu_torch.ops.clahe import clip_limit

    monkeypatch.setattr(C, "sm_count", lambda device: 132)
    C._hist_args.cache_clear()
    C._apply_args.cache_clear()
    try:
        area = 64 * 86
        assert C._hist_args(16, 512, 688, TILES, 3.0) == (16, 512, 688, 8, 8, clip_limit(3.0, area), 255 / area, 1)
        assert C._hist_args(4, 3024, 4032, TILES, 3.0)[-1] == 2
        band = C.apply_band(16, 512, 688, 64, 132)
        assert C._apply_args(16, 512, 688, TILES, 0) == (16, 512, 688, 8, 8, band, C.apply_bands(512, 64, band))
        with pytest.raises(ValueError, match="tile grid"):
            C._hist_args(1, 20, 16, TILES, 3.0)
        with pytest.raises(ValueError, match="tile grid"):
            C._apply_args(1, 16, 20, TILES, 0)
        with pytest.raises(ValueError, match="65535 images"):
            C._hist_args(70000, 16, 16, TILES, 3.0)
        with pytest.raises(ValueError, match="65535 images and bands"):
            C._apply_args(70000, 16, 16, TILES, 0)
    finally:
        C._hist_args.cache_clear()
        C._apply_args.cache_clear()


@pytest.mark.parametrize("out_dtype", [torch.uint8, torch.float32])
def test_wrappers_take_the_plain_version_on_the_cpu(out_dtype):
    """On CPU tensors K8 and K9 return their plain versions, launch nothing
    and leave the counters alone."""
    from mmtrs_tpu_torch.ops.kernels import LAUNCHES

    l = torch.from_numpy(np.random.default_rng(4).integers(0, 256, (2, 40, 56)).astype(np.uint8))
    before = dict(LAUNCHES)
    lut = C.clahe_hist_lut(l, 3.0, TILES)
    assert torch.equal(lut, C.clahe_hist_lut_ref(l, 3.0, TILES))
    out = C.clahe_apply(l, lut, TILES, out_dtype)
    assert out.dtype == out_dtype and torch.equal(out, C.clahe_apply_ref(l, lut, TILES, out_dtype))
    assert LAUNCHES == before


@pytest.mark.parametrize("case", ["l_dims", "l_dtype", "lut_batch", "lut_bins", "lut_noncontig", "l_tiles"])
def test_wrappers_reject_bad_planes_and_luts(case):
    """K9 refuses a plane of the wrong rank or dtype, LUTs of another batch,
    bin count or layout, and a plane off the tile grid, with the full
    check's messages (the lean path takes none of them)."""
    l = torch.zeros((2, 16, 24), dtype=torch.uint8)
    lut = torch.zeros((2, 64, 256), dtype=torch.uint8)
    cases = {
        "l_dims": ((l[0], lut), "3 dims"),
        "l_dtype": ((l.to(torch.int8), lut), "uint8"),
        "lut_batch": ((l, lut[:1].contiguous()), "do not fit"),
        "lut_bins": ((l, lut[..., :128].contiguous()), "do not fit"),
        "lut_noncontig": ((l, torch.zeros((2, 256, 64), dtype=torch.uint8).transpose(1, 2)), "contiguous"),
        "l_tiles": ((torch.zeros((2, 20, 24), dtype=torch.uint8), lut), "tile grid"),
    }
    args, msg = cases[case]
    with pytest.raises(ValueError, match=msg):
        C.clahe_apply(*args, TILES)


def test_profile_tags_catch_each_kernel_once():
    """chip_profile.py times a kernel by the device functions whose names
    hold one of its tags: every __global__ function in csrc/ (and K8's and
    K9's names before this layout) is caught by one kernel's tags at most,
    and K8's and K9's tags catch both their old and new names."""
    from chip_profile import LINE_KERNEL_NAMES

    names = set()
    for src in (ROOT / "mmtrs_tpu_torch" / "csrc").glob("*.cu"):
        names |= set(re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)", src.read_text()))
    old = {"hist_lut_kernel": "K8", "apply_kernel": "K9"}
    assert {"plane_hist_lut_kernel", "plane_blend_kernel"} <= names
    for name in names | set(old):
        caught = [k for k, tags in LINE_KERNEL_NAMES.items() if any(t in name for t in tags)]
        assert len(caught) <= 1, (name, caught)
    for name, kernel in {**old, "plane_hist_lut_kernel": "K8", "plane_blend_kernel": "K9"}.items():
        assert any(t in name for t in LINE_KERNEL_NAMES[kernel]), name
