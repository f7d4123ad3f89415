"""The port's Mask R-CNN (``models/detection``) held against the JAX
package's on the CPU: every op on the same inputs (ties, groups, all −inf
scores, clipped RoIAlign taps, FPN level boundaries, an empty mask), then
``MaskRCNN`` at the JAX tests' ``TINY`` config (tests/test_detection.py) from
the same Flax variables: the whole forward, each stage fed JAX's own
inputs, ``MaskRCNNSegmenter.propose_boxes``, the converters and
``load_detector``.

Bars: ops in f32 within 1e-5 absolute of JAX's (pixel- and feature-scale
values), index outputs equal. The TINY forward in f32: boxes within 1e-3
px (measured 5.1e-5), scores and masks within 1e-5 (1.2e-7 each), labels
and valid equal; the port in f64 against JAX's f32 within the same bars
(JAX's MaskRCNN runs in f32 at most, so f64 measures its f32 rounding:
boxes 6.1e-5 px, scores 1.7e-7, masks 1.8e-7). Random
weights give softmax scores near 1/num_classes, under the 0.05 gate: the
variables get biases planted in ``cls_score`` and ``mask_fcn_logits``
(as ``chip_smoke._detector`` plants them) so that detections and masks
pass.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmtrs_tpu.models.detection import DetectorConfig as JaxConfig
from mmtrs_tpu.models.detection import MaskRCNN as JaxMaskRCNN
from mmtrs_tpu.models.detection import ops as jops

TINY_KW = dict(img_size=64, base_width=8, layers=(1, 1, 1, 1), fpn_channels=16, num_classes=5,
               anchor_sizes=(8.0, 16.0, 32.0, 64.0, 128.0), pre_nms_topk=32, post_nms_topk=16, max_detections=4)
OP_BAR = 1e-5
BOX_PX_BAR = 1e-3
SCORE_BAR = 1e-5


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------


def test_box_coding_matches_jax_with_the_clip():
    from mmtrs_tpu_torch.models.detection import ops

    rng = np.random.default_rng(0)
    xy = rng.uniform(0, 80, (64, 2)).astype(np.float32)
    anchors = np.concatenate([xy, xy + rng.uniform(4, 60, (64, 2)).astype(np.float32)], 1)
    deltas = rng.normal(0, 1, (64, 4)).astype(np.float32)
    deltas[:8, 2:] = rng.uniform(4.2, 9.0, (8, 2))  # past log(1000/16): clipped before the exp
    for w in [(1.0, 1.0, 1.0, 1.0), (10.0, 10.0, 5.0, 5.0)]:
        want = np.asarray(jops.decode_boxes(jnp.asarray(deltas), jnp.asarray(anchors), w))
        got = ops.decode_boxes(_t(deltas), _t(anchors), w).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=OP_BAR)
        enc_w = np.asarray(jops.encode_boxes(jnp.asarray(want), jnp.asarray(anchors), w))
        np.testing.assert_allclose(ops.encode_boxes(_t(want), _t(anchors), w).numpy(), enc_w, rtol=1e-5, atol=OP_BAR)
    np.testing.assert_array_equal(ops.clip_boxes(_t(want * 1.5 - 20), (50, 70)).numpy(),
                                  np.asarray(jops.clip_boxes(jnp.asarray(want * 1.5 - 20), (50, 70))))


def _boxes(rng, n, lo=0, hi=80):
    xy = rng.uniform(lo, hi, (n, 2)).astype(np.float32)
    return np.concatenate([xy, xy + rng.uniform(5, 30, (n, 2)).astype(np.float32)], 1)


@pytest.mark.parametrize("case", ["random", "ties", "groups", "all_neg_inf", "k_past_n", "degenerate"])
def test_static_nms_matches_jax(case):
    """Index and valid outputs equal JAX's scan: ties keep the first
    maximum, an all −inf row gives index 0 and valid false, k_out past N
    pads the same way, zero-area boxes suppress nothing."""
    from mmtrs_tpu_torch.models.detection import ops

    rng = np.random.default_rng(len(case) * 7 + ord(case[0]))
    n, k = 40, 12
    boxes = _boxes(rng, n)
    scores = rng.uniform(0, 1, n).astype(np.float32)
    groups = None
    if case == "ties":
        scores = np.round(scores * 4) / 4  # five values over 40 boxes
        boxes[10:20] = boxes[0]
    elif case == "groups":
        boxes[10:20] = boxes[0]
        groups = rng.integers(0, 3, n).astype(np.int32)
    elif case == "all_neg_inf":
        scores[:] = -np.inf
    elif case == "k_past_n":
        k = 60
        scores[::3] = -np.inf
    elif case == "degenerate":
        boxes[::4, 2] = boxes[::4, 0]
    want_i, want_v = jops.static_nms(jnp.asarray(boxes), jnp.asarray(scores), 0.5, k,
                                     None if groups is None else jnp.asarray(groups))
    got_i, got_v = ops.static_nms(_t(boxes)[None], _t(scores)[None], 0.5, k,
                                  None if groups is None else _t(groups)[None])
    np.testing.assert_array_equal(got_v[0].numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_i[0].numpy(), np.asarray(want_i))
    np.testing.assert_allclose(ops.pairwise_iou(_t(boxes), _t(boxes[:7])).numpy(),
                               np.asarray(jops.pairwise_iou(jnp.asarray(boxes), jnp.asarray(boxes[:7]))), atol=1e-6)


def test_topk_static_keeps_jax_order_among_ties():
    from mmtrs_tpu_torch.models.detection import ops

    scores = np.random.default_rng(3).integers(0, 4, (3, 50)).astype(np.float32)
    scores[1, ::5] = -np.inf
    want_v, want_i = jax.lax.top_k(jnp.asarray(scores), 20)
    got_v, got_i = ops.topk_static(_t(scores), 20)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    assert ops.topk_static(_t(scores), 80)[1].shape == (3, 50)


def _roi_boxes(rng, n, img):
    """Boxes inside, across and beyond the image (taps clipped to [0, n − 1]),
    and a sub-pixel one."""
    b = _boxes(rng, n, -10, img)
    b[0] = [img - 3, img - 5, img + 20, img + 9]
    b[1] = [-15, -12, 4, 3]
    b[2] = [10.2, 10.3, 10.4, 10.5]
    return b


def test_roi_align_matches_jax_including_clipped_taps():
    from mmtrs_tpu_torch.models.detection import ops

    rng = np.random.default_rng(4)
    feat = rng.normal(size=(2, 16, 20, 5)).astype(np.float32)  # [B, H, W, C]
    boxes = np.stack([_roi_boxes(rng, 9, 70), _roi_boxes(rng, 9, 70)])
    for out, scale in ((7, 0.25), (14, 0.5)):
        got = ops.roi_align(_t(feat).permute(0, 3, 1, 2), _t(boxes), out, scale).permute(0, 1, 3, 4, 2).numpy()
        for b in range(2):
            want = np.asarray(jops.roi_align(jnp.asarray(feat[b]), jnp.asarray(boxes[b]), out, scale))
            np.testing.assert_allclose(got[b], want, atol=OP_BAR)


def test_roi_align_multilevel_matches_jax_at_level_boundaries():
    """Boxes of side 56, 112, 224 and 448 (the level mapper's steps) and a
    hair either side; each RoI aligned on its own level only."""
    from mmtrs_tpu_torch.models.detection import ops

    rng = np.random.default_rng(5)
    strides = [4, 8, 16, 32]
    feats = [rng.normal(size=(1, 256 // s, 256 // s, 3)).astype(np.float32) for s in strides]
    sides = [s * f for s in (56.0, 112.0, 224.0, 448.0) for f in (0.999, 1.0, 1.001)] + [3.0, 700.0]
    x0 = rng.uniform(0, 40, len(sides)).astype(np.float32)
    boxes = np.stack([x0, x0 + 1, x0 + np.float32(sides), x0 + 1 + np.float32(sides)], 1).astype(np.float32)
    k_jax = np.clip(np.floor(4 + np.log2(np.sqrt((boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])) / 224
                                         + 1e-6)), 2, 5) - 2
    np.testing.assert_array_equal(ops.roi_levels(_t(boxes), 4).numpy(), k_jax)
    assert len(set(k_jax.tolist())) == 4
    want = np.asarray(jops.roi_align_multilevel([jnp.asarray(f[0]) for f in feats], strides, jnp.asarray(boxes), 7))
    got = ops.roi_align_multilevel([_t(f).permute(0, 3, 1, 2) for f in feats], strides, _t(boxes)[None], 7)
    np.testing.assert_allclose(got[0].permute(0, 2, 3, 1).numpy(), want, atol=OP_BAR)


def test_paste_mask_and_mask_bbox_match_jax():
    """The continuous bilinear paste (a box across the border, a sub-pixel
    box at its 1e-3 floor) and the thresholded box, an empty mask's too."""
    from mmtrs_tpu_torch.models.detection import ops

    rng = np.random.default_rng(6)
    masks = rng.uniform(0, 1, (4, 28, 28)).astype(np.float32)
    boxes = np.array([[10.5, 20.25, 40.0, 50.75], [-8, -3, 20, 30], [30, 30, 30.0001, 30.0001], [0, 0, 64, 48]],
                     np.float32)
    got = ops.paste_mask(_t(masks), _t(boxes), (48, 64)).numpy()
    for i in range(4):
        want = np.asarray(jops.paste_mask(jnp.asarray(masks[i]), jnp.asarray(boxes[i]), (48, 64)))
        np.testing.assert_allclose(got[i], want, atol=1e-6)
        np.testing.assert_array_equal(ops.mask_bbox(_t(got[i] > 0.5)).numpy(),
                                      np.asarray(jops.mask_bbox(jnp.asarray(want > 0.5))))
    empty = np.zeros((8, 8), bool)
    np.testing.assert_array_equal(ops.mask_bbox(_t(empty)).numpy(), np.asarray(jops.mask_bbox(jnp.asarray(empty))))


# ---------------------------------------------------------------------------
# MaskRCNN at TINY
# ---------------------------------------------------------------------------


def _plant(v: dict) -> dict:
    """chip_smoke._detector's planted biases on a Flax tree (numpy leaves)."""
    v = jax.tree.map(np.array, v)
    v["params"]["box_head"]["cls_score"]["bias"][1] += 6.0
    v["params"]["mask_head"]["mask_fcn_logits"]["bias"][1] += 4.0
    return v


@pytest.fixture(scope="module")
def tiny():
    """JAX's MaskRCNN(TINY) with its init (biases planted), the port's
    loaded from the same variables, and two 64² images."""
    from mmtrs_tpu_torch.models.detection import DetectorConfig, MaskRCNN, detector_from_flax

    jm = JaxMaskRCNN(JaxConfig(**TINY_KW))
    rng = np.random.default_rng(3)
    img = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    v = _plant(jm.init(jax.random.key(0), jnp.asarray(img)))
    pm = MaskRCNN(DetectorConfig(**TINY_KW))
    pm.load_state_dict(detector_from_flax(v), strict=True)
    return jm, v, pm.eval(), img


def _compare_outputs(got, want, box_bar=BOX_PX_BAR, score_bar=SCORE_BAR):
    boxes, scores, labels, valid, masks = (np.asarray(a) for a in want)
    assert valid.sum() > 0
    np.testing.assert_array_equal(got[3].numpy(), valid)
    np.testing.assert_array_equal(got[2].numpy(), labels)
    np.testing.assert_allclose(got[0].double().numpy(), boxes, atol=box_bar)
    np.testing.assert_allclose(got[1].double().numpy(), scores, atol=score_bar)
    np.testing.assert_allclose(got[4].double().numpy(), masks, atol=score_bar)


def test_tiny_forward_matches_jax_f32(tiny):
    jm, v, pm, img = tiny
    with torch.no_grad():
        got = pm(_t(img))
    _compare_outputs(got, jm.apply(v, jnp.asarray(img)))


def test_tiny_forward_f64_matches_jax_f32(tiny):
    """The port in f64 (parameters and arithmetic) against JAX's f32: the
    gap is JAX's f32 rounding, within the f32 bars."""
    import copy

    jm, v, pm, img = tiny
    pm64 = copy.deepcopy(pm).double()
    assert pm64.dtype == torch.float64
    with torch.no_grad():
        got = pm64(_t(img.astype(np.float64)))
    assert got[0].dtype == torch.float64 and got[4].dtype == torch.float64
    _compare_outputs(got, jm.apply(v, jnp.asarray(img)))


def test_tiny_stages_fed_jax_inputs(tiny):
    """Each stage on JAX's own inputs: the FPN maps, the RPN head on JAX's
    maps, the proposals from JAX's maps, logits and deltas, the heads from
    JAX's maps and proposals."""
    jm, v, pm, img = tiny
    S = 64
    jf = jm.apply(v, jnp.asarray(img), method=JaxMaskRCNN.features)
    tf = [_t(np.asarray(f)).permute(0, 3, 1, 2) for f in jf]
    with torch.no_grad():
        pf = pm.features(_t(img))
        for a, b in zip(pf, tf):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=OP_BAR * float(b.abs().max()))
        jl, jd = jm.apply(v, jf, method=lambda m, f: m.rpn_head(f))
        pl, pd = pm.rpn_head(tf)
        for a, b in zip(pl, jl):
            np.testing.assert_allclose(a.numpy(), np.asarray(b).reshape(2, -1), atol=OP_BAR)
        for a, b in zip(pd, jd):
            np.testing.assert_allclose(a.numpy(), np.asarray(b).reshape(2, -1, 4), atol=OP_BAR)
        jp, jv = jm.apply(v, jf, jl, jd, S, method=JaxMaskRCNN.rpn_proposals)
        pp, pv = pm.rpn_proposals(tf, [_t(np.asarray(x)).reshape(2, -1) for x in jl],
                                  [_t(np.asarray(x)).reshape(2, -1, 4) for x in jd], S)
        np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
        np.testing.assert_allclose(pp.numpy(), np.asarray(jp), atol=BOX_PX_BAR)
        got = pm.detection_heads(tf, _t(np.asarray(jp)), _t(np.asarray(jv)), S)
    _compare_outputs(got, jm.apply(v, jf, jp, jv, S, method=JaxMaskRCNN.detection_heads))


def test_tiny_bf16_forward_runs_near_f32(tiny):
    """compute_dtype bf16: the FPN maps within 3e-2 of the f32 ones
    (relative to their largest), every output finite, boxes and masks f32."""
    from mmtrs_tpu_torch.models.detection import DetectorConfig, MaskRCNN

    _, _, pm, img = tiny
    bf = MaskRCNN(DetectorConfig(**TINY_KW, compute_dtype="bfloat16"))
    bf.load_state_dict(pm.state_dict())
    with torch.no_grad():
        fb, ff = bf.eval().features(_t(img)), pm.features(_t(img))
        assert fb[0].dtype == torch.bfloat16
        for a, b in zip(fb, ff):
            assert float((a.float() - b).abs().max() / b.abs().max()) <= 3e-2
        out = bf(_t(img))
    assert out[0].dtype == torch.float32 and out[4].dtype == torch.float32
    assert all(bool(torch.isfinite(o.float()).all()) for o in out)


def test_segmenter_propose_boxes_matches_jax(tiny):
    """propose_boxes on 80×96 inputs (resized to 64²) equal to JAX's, u8
    and float input alike; gray scenes fall back to the centre square."""
    from mmtrs_tpu.models.detection import MaskRCNNSegmenter as JaxSegmenter
    from mmtrs_tpu_torch.models.detection import DetectorConfig, MaskRCNNSegmenter

    jm, v, pm, _ = tiny
    js = JaxSegmenter(v, JaxConfig(**TINY_KW))
    ps = MaskRCNNSegmenter(pm.state_dict(), DetectorConfig(**TINY_KW), device="cpu")
    rng = np.random.default_rng(4)
    imgs = rng.integers(0, 256, (3, 80, 96, 3)).astype(np.uint8)
    imgs[2] = imgs[2, ..., :1]  # gray
    wb, wv = (np.asarray(a) for a in js.propose_boxes(jnp.asarray(imgs.astype(np.float32))))
    for x in (_t(imgs), _t(imgs.astype(np.float32))):
        gb, gv = ps.propose_boxes(x)
        np.testing.assert_array_equal(gv.numpy(), wv)
        np.testing.assert_allclose(gb.numpy(), wb, atol=1e-4)
    assert wv[:2].all() and not wv[2]
    np.testing.assert_array_equal(gb[2].numpy(), [0, 8, 80, 88])


# ---------------------------------------------------------------------------
# Converters and loading
# ---------------------------------------------------------------------------


def _flat(tree, prefix=""):
    out = {}
    for k, x in tree.items():
        out.update(_flat(x, f"{prefix}{k}/") if isinstance(x, dict) else {f"{prefix}{k}": x})
    return out


def test_fake_state_dict_equals_jax_at_tiny():
    from mmtrs_tpu.models.detection import fake_state_dict as jax_fake
    from mmtrs_tpu_torch.models.detection import DetectorConfig, fake_state_dict

    want = jax_fake(JaxConfig(**TINY_KW), seed=5)
    got = fake_state_dict(DetectorConfig(**TINY_KW), seed=5)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_jax_converter_then_from_flax_is_the_identity_and_loads_strictly():
    """On the full R50-FPN names: torchvision dict → JAX's convert_state_dict
    → detector_from_flax gives the dict back, every array equal; it loads
    into the port's MaskRCNN strictly, as does the dict itself, in either
    naming era, with torchvision's num_batches_tracked entries; and
    detector_to_flax gives JAX's tree back."""
    from mmtrs_tpu.models.detection import convert_state_dict
    from mmtrs_tpu_torch.models.detection import (DetectorConfig, MaskRCNN, detector_from_flax, detector_to_flax,
                                                  fake_state_dict, load_torchvision)

    sd = fake_state_dict(DetectorConfig(), seed=1)
    tree = convert_state_dict(sd, JaxConfig())
    back = detector_from_flax(tree)
    assert set(back) == set(sd)
    for k in sd:
        np.testing.assert_array_equal(back[k].numpy(), sd[k], err_msg=k)
    model = MaskRCNN(DetectorConfig())
    model.load_state_dict(back, strict=True)
    assert set(model.state_dict()) == set(sd)
    flat_j, flat_p = _flat(tree["params"]), _flat(detector_to_flax(model.state_dict())["params"])
    assert set(flat_j) == set(flat_p)
    for k in flat_j:
        np.testing.assert_array_equal(flat_p[k], flat_j[k], err_msg=k)

    newer = {}
    for k, a in sd.items():
        k = k.replace("rpn.head.conv.", "rpn.head.conv.0.0.")
        for kind in ("inner", "layer"):
            for i in range(4):
                k = k.replace(f"backbone.fpn.{kind}_blocks.{i}.", f"backbone.fpn.{kind}_blocks.{i}.0.")
        for i in range(1, 5):
            k = k.replace(f"roi_heads.mask_head.mask_fcn{i}.", f"roi_heads.mask_head.{i - 1}.0.")
        newer[k] = torch.from_numpy(a)
    newer["backbone.body.bn1.num_batches_tracked"] = torch.tensor(0)
    m2 = load_torchvision(MaskRCNN(DetectorConfig()), newer)
    for k, t in m2.state_dict().items():
        np.testing.assert_array_equal(t.numpy(), sd[k], err_msg=k)
    with pytest.raises(RuntimeError):
        load_torchvision(MaskRCNN(DetectorConfig()), {**sd, "rogue.weight": np.zeros(1, np.float32)})


def test_jax_converter_misfits_its_model_off_the_default_widths():
    """A fault of the JAX package, pinned: its MaskHead keeps 256 channels
    whatever fpn_channels is, while expected_torch_keys (and so
    fake_state_dict and convert_state_dict) size the mask head by
    fpn_channels; at TINY (16) the converted tree does not fit the model.
    The port's MaskRCNN follows the model (its mask head is 256 wide)."""
    from mmtrs_tpu.models.detection import convert_state_dict, fake_state_dict
    from mmtrs_tpu_torch.models.detection import DetectorConfig, MaskRCNN

    cfg = JaxConfig(**TINY_KW)
    conv = convert_state_dict(fake_state_dict(cfg), cfg)["params"]["mask_head"]["mask_fcn1"]["kernel"]
    init = jax.eval_shape(lambda: JaxMaskRCNN(cfg).init(jax.random.key(0), jnp.zeros((1, 64, 64, 3))))
    assert conv.shape == (3, 3, 16, 16)
    assert init["params"]["mask_head"]["mask_fcn1"]["kernel"].shape == (3, 3, 16, 256)
    port = MaskRCNN(DetectorConfig(**TINY_KW)).state_dict()
    assert tuple(port["roi_heads.mask_head.mask_fcn1.weight"].shape) == (256, 16, 3, 3)


def test_load_detector_from_npz(tmp_path):
    """load_detector reads <path>.npz and its recipe (img_size, num_classes)
    as JAX's reads an Orbax checkpoint's; a missing file raises."""
    from mmtrs_tpu_torch.models.detection import (DetectorConfig, detector_to_flax, fake_state_dict,
                                                  load_detector, load_torchvision, MaskRCNN)
    from mmtrs_tpu_torch.utils.checkpoint import save_npz_checkpoint

    cfg = DetectorConfig(img_size=64, num_classes=7)
    model = load_torchvision(MaskRCNN(cfg), fake_state_dict(cfg, seed=2))
    base = tmp_path / "mask_rcnn_molar"
    save_npz_checkpoint(base, detector_to_flax(model.state_dict()), {"img_size": 64, "num_classes": 7})
    seg = load_detector(base, device="cpu")
    assert seg.cfg == cfg and seg.device == torch.device("cpu")
    for k, t in seg.model.state_dict().items():
        assert torch.equal(t, model.state_dict()[k]), k
    boxes, valid = seg.propose_boxes(torch.zeros((1, 70, 90, 3), dtype=torch.uint8))
    assert boxes.shape == (1, 4) and not bool(valid[0])
    with pytest.raises(FileNotFoundError):
        load_detector(tmp_path / "missing", device="cpu")


def test_segmenter_wants_the_card_by_default():
    from mmtrs_tpu_torch.models.detection import DetectorConfig, MaskRCNN, MaskRCNNSegmenter

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    sd = MaskRCNN(DetectorConfig(**TINY_KW)).state_dict()
    with pytest.raises(RuntimeError, match="CUDA"):
        MaskRCNNSegmenter(sd, DetectorConfig(**TINY_KW))
