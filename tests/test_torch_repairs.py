"""Three results where the port departs from the JAX package on purpose,
each with the JAX package's own result pinned beside it:

- Platt calibration and unpenalised logistic regression on a score or
  feature column that is constant over the rows (the Newton Hessian is
  singular: JAX's solve gives NaN);
- a GBDT leaf with LH + λ = 0 (``stack_tab_like``'s reg_lambda 0 and a tree
  whose row sample keeps no row: JAX's leaf is 0/0);
- uncompressed BMP files, which the port's codec now reads as Pillow does.

Bars: Platt's p equal to the mean Platt target within 1e-12, unpenalised
LR predictions within 1e-6 of the fit without the constant columns (both
f32 Newton), a regular design's coefficients bit-equal to the plain
solver's, BMP pixels equal to Pillow's."""

import io
import struct

import numpy as np
import pytest
import torch
from PIL import Image


def _labels(n=50, seed=0):
    return (np.random.default_rng(seed).random(n) < 0.3).astype(int)


def _platt_target_mean(y):
    n_pos, n_neg = y.sum(), (1 - y).sum()
    return np.mean(np.where(y > 0, (n_pos + 1) / (n_pos + 2), 1.0 / (n_neg + 2)))


@pytest.mark.parametrize("value", [0.0, 0.3, 1.0])
def test_platt_on_a_constant_score_column_fits_b_alone(value):
    """a = 0 and b = logit(mean target): every row's p is the mean Platt
    target, as scikit-learn's sigmoid calibration gives."""
    from mmtrs_tpu_torch.models.linear import platt_calibrate

    y = _labels()
    cal = platt_calibrate(np.full(len(y), value), y, device="cpu")
    assert cal.a == 0.0 and np.isfinite(cal.b)
    assert abs(cal.transform([value])[0] - _platt_target_mean(y)) <= 1e-12
    raw = platt_calibrate(np.full(len(y), value), y, prior_correction=False, device="cpu")
    assert raw.a == 0.0 and abs(raw.transform([value])[0] - y.mean()) <= 1e-12


@pytest.mark.parametrize("value", [0.0, 1.0])
def test_jax_platt_on_a_constant_score_column_is_nan(value):
    """Pinned: the JAX package's Newton solve on the singular Hessian."""
    from mmtrs_tpu.models.linear import platt_calibrate

    cal = platt_calibrate(np.full(50, value), _labels())
    assert np.isnan(cal.a)


@pytest.mark.parametrize("const", [0.3, 0.0, -2.0])
def test_unpenalised_lr_with_a_constant_column_is_the_minimum_norm_fit(const):
    """A feature constant over the rows beside the intercept (or all zero):
    finite coefficients, the rule β_k = v_k·b / Σ v_j² over the constant
    columns (v_j their values, the intercept's 1; b the intercept of the fit
    without the constant feature; a zero column gets 0), and predictions
    equal to that fit's."""
    from mmtrs_tpu_torch.models.linear import LogisticRegression

    rng = np.random.default_rng(1)
    y = _labels()
    x = rng.normal(size=(len(y), 1))
    X = np.c_[x, np.full(len(y), const)]
    got = LogisticRegression(penalty="none").fit(X, y, device="cpu")
    ref = LogisticRegression(penalty="none").fit(x, y, device="cpu")
    assert np.isfinite(got.coef_).all() and np.isfinite(got.intercept_)
    b = ref.intercept_
    assert got.coef_[0] == ref.coef_[0]
    np.testing.assert_allclose([got.coef_[1], got.intercept_], [const * b / (const**2 + 1), b / (const**2 + 1)],
                               rtol=1e-12, atol=0)
    np.testing.assert_allclose(got.predict_proba(X), ref.predict_proba(x), rtol=0, atol=1e-6)


def test_unpenalised_lr_on_constant_columns_alone_is_the_intercept_fit():
    from mmtrs_tpu_torch.models.linear import LogisticRegression

    y = _labels()
    got = LogisticRegression(penalty="none").fit(np.zeros((len(y), 2)), y, device="cpu")
    assert np.array_equal(got.coef_, [0.0, 0.0])
    assert abs(1 / (1 + np.exp(-got.intercept_)) - y.mean()) <= 1e-6
    nofit = LogisticRegression(penalty="none", fit_intercept=False).fit(np.full((len(y), 1), 2.0), y, device="cpu")
    assert np.isfinite(nofit.coef_).all()
    assert abs(1 / (1 + np.exp(-2.0 * nofit.coef_[0])) - y.mean()) <= 1e-6


def test_jax_unpenalised_lr_on_a_constant_column_is_nan():
    from mmtrs_tpu.models.linear import LogisticRegression

    y = _labels()
    X = np.c_[np.random.default_rng(1).normal(size=len(y)), np.full(len(y), 0.3)]
    assert not np.isfinite(LogisticRegression(penalty="none").fit(X, y).coef_).all()


@pytest.mark.parametrize("penalty", ["l2", "none"])
def test_regular_designs_take_the_plain_newton_path_bit_for_bit(penalty):
    """No constant column (or a regularised one): the coefficients are the
    plain solver's on the same f32 design, bit for bit."""
    from mmtrs_tpu_torch.models.linear import LogisticRegression, _newton_logistic

    rng = np.random.default_rng(2)
    y = _labels(80, 3)
    X = rng.normal(size=(80, 3))
    if penalty == "l2":
        X[:, 2] = 0.5  # regularised, so the Hessian is regular
    got = LogisticRegression(penalty=penalty, C=0.7).fit(X, y, device="cpu")
    Xd = torch.tensor(np.c_[X, np.ones(80)], dtype=torch.float32)
    mask = torch.tensor([1.0, 1.0, 1.0, 0.0])
    beta, _ = _newton_logistic(Xd, torch.tensor(y, dtype=torch.float32), torch.ones(80), 0.0 if penalty == "none"
                               else 1 / 0.7, mask, 100, 1e-8)
    beta = beta.numpy().astype(np.float64)
    assert np.array_equal(got.coef_, beta[:-1]) and got.intercept_ == beta[-1]


# -- GBDT: a leaf with LH + λ = 0 -----------------------------------------------------------

# stack_tab_like at 40 trees and seed 56 over 4 rows: JAX's masks drop every
# row of tree 21 (found by jax_gbdt_masks; subsample 0.85)
EMPTY_TREE_SEED, EMPTY_TREE = 56, 21


def _empty_leaf_data():
    X = np.array([[0.0, 1.0, 2.0], [1.0, 0.0, 2.5], [0.5, 1.0, 3.0], [1.5, 0.5, 1.0]], np.float32)
    return X, np.array([0.0, 1.0, 0.0, 1.0], np.float32)


def test_gbdt_leaf_no_weighted_row_reaches_is_zero():
    """On JAX's masks a tree keeps no row, so its one reached leaf has
    LH + λ = 0: the port gives it 0 and every served row a finite p; each
    leaf of the other trees is finite too."""
    from mmtrs_tpu.config import GBDTConfig as J
    from mmtrs_tpu_torch.config import GBDTConfig as P
    from mmtrs_tpu_torch.models.gbdt import predict_proba, train_gbdt
    from tests.test_torch_gbdt_train import jax_draws_for, jax_gbdt_masks

    kw = {"n_estimators": 40, "seed": EMPTY_TREE_SEED}
    jcfg = J(**{**J.stack_tab_like().__dict__, **kw})
    assert jax_gbdt_masks(jcfg, 4, 3)[1][EMPTY_TREE].sum() == 0
    X, y = _empty_leaf_data()
    f = train_gbdt(X, y, P(**{**P.stack_tab_like().__dict__, **kw}), draws=jax_draws_for(jcfg)(4, 3), device="cpu")
    leaves = f.leaf_value.numpy()
    assert np.isfinite(leaves).all() and (leaves[EMPTY_TREE] == 0).all()
    served = np.array([[0.2, 0.9, 2.2], [9.0, -3.0, 0.0]], np.float32)
    assert np.isfinite(predict_proba(f, served).numpy()).all()


def test_jax_gbdt_leaf_no_weighted_row_reaches_is_nan():
    """Pinned: the same forest in the JAX package serves NaN."""
    from mmtrs_tpu.config import GBDTConfig as J
    from mmtrs_tpu.models.gbdt import predict_proba, train_gbdt

    X, y = _empty_leaf_data()
    f = train_gbdt(X, y, J(**{**J.stack_tab_like().__dict__, "n_estimators": 40, "seed": EMPTY_TREE_SEED}))
    assert np.isnan(np.asarray(f.leaf_value)[EMPTY_TREE]).all()
    assert np.isnan(np.asarray(predict_proba(f, X))).all()


# -- BMP in the codec ----------------------------------------------------------------------


def _pil_bmp(img, mode=None) -> bytes:
    b = io.BytesIO()
    im = Image.fromarray(img) if mode is None else Image.fromarray(img).convert(mode)
    im.save(b, "BMP")
    return b.getvalue()


def _top_down(data: bytes) -> bytes:
    """The same image stored top-down: rows reversed, height negated."""
    w, h = struct.unpack("<ii", data[18:26])
    bpp = struct.unpack("<H", data[28:30])[0]
    offset = struct.unpack("<I", data[10:14])[0]
    stride = (w * bpp + 31) // 32 * 4
    rows = [data[offset + i * stride: offset + (i + 1) * stride] for i in range(h)]
    return data[:22] + struct.pack("<i", -h) + data[26:offset] + b"".join(rows[::-1])


BMP_CASES = {  # Pillow's mode → the BMP it writes
    "rgb24": (None, (37, 41, 3)),  # width 41: 123 bytes a row, padded to 124
    "rgba32": (None, (19, 22, 4)),
    "gray8": ("L", (23, 29, 3)),  # a grayscale palette
    "palette8": ("P", (31, 17, 3)),
}


@pytest.mark.parametrize("order", ["bottom_up", "top_down"])
@pytest.mark.parametrize("case", sorted(BMP_CASES))
def test_bmp_decodes_as_pillow(case, order):
    from mmtrs_tpu_torch.utils.codec import decode_image, sniff

    mode, shape = BMP_CASES[case]
    img = np.random.default_rng(len(case)).integers(0, 256, shape, dtype=np.uint8)
    data = _pil_bmp(img, mode)
    if order == "top_down":
        data = _top_down(data)
    want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    assert sniff(data) == "BMP"
    np.testing.assert_array_equal(decode_image(data, "cpu").numpy(), want)


@pytest.mark.parametrize("comp,name", [(1, "BI_RLE8"), (2, "BI_RLE4"), (3, "BI_BITFIELDS"), (4, "BI_JPEG")])
def test_compressed_bmp_raises_naming_its_compression(comp, name):
    """A compression the codec does not read (BI_JPEG), or one at a depth
    it does not apply to (RLE8, RLE4 and bit fields on a 24-bit file),
    raises naming it."""
    from mmtrs_tpu_torch.utils.codec import decode_image

    data = _pil_bmp(np.zeros((8, 8, 3), np.uint8))
    data = data[:30] + struct.pack("<I", comp) + data[34:]
    with pytest.raises(ValueError, match=f"BMP compression {comp} \\({name}\\)"):
        decode_image(data, "cpu")


def test_bmp_other_depths_and_truncation_raise():
    """A 1-bit BMP decodes as Pillow's; a 2-bit one (no BMP depth) and a
    truncated one raise."""
    from mmtrs_tpu_torch.utils.codec import decode_image

    one_bit = io.BytesIO()
    Image.fromarray(np.eye(8, dtype=bool)).save(one_bit, "BMP")
    np.testing.assert_array_equal(decode_image(one_bit.getvalue(), "cpu").numpy(),
                                  np.asarray(Image.open(one_bit).convert("RGB")))
    two_bit = one_bit.getvalue()[:28] + struct.pack("<H", 2) + one_bit.getvalue()[30:]
    with pytest.raises(ValueError, match="2-bit BMP"):
        decode_image(two_bit, "cpu")
    data = _pil_bmp(np.zeros((16, 16, 3), np.uint8))
    with pytest.raises(ValueError, match="truncated BMP"):
        decode_image(data[: len(data) // 2], "cpu")


def test_bmp_loads_through_list_images_and_load_image(tmp_path):
    """A folder's .bmp file is listed and loaded as Pillow reads it."""
    from mmtrs_tpu_torch.utils.images import list_images, load_image

    img = np.random.default_rng(5).integers(0, 256, (12, 15, 3), dtype=np.uint8)
    (tmp_path / "a.bmp").write_bytes(_pil_bmp(img))
    assert list_images(tmp_path) == [tmp_path / "a.bmp"]
    np.testing.assert_array_equal(load_image(tmp_path / "a.bmp", "cpu").numpy(), img)
