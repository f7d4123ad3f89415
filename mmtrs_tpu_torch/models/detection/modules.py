"""Mask R-CNN, ResNet-50-FPN (port of mmtrs_tpu/models/detection/modules.py).

Layer for layer the Flax modules, NCHW inside (channels-last memory):
frozen BatchNorms (the JAX order, ``inv = w·rsqrt(var + eps)``, ``off =
b − mean·inv``), explicit ``kernel // 2`` padding, the FPN's nearest ×2
top-down path cropped to each lateral and its P6 a stride-2 subsample, the
RPN head shared over the levels, TwoMLPHead + FastRCNNPredictor and the
mask head with its 2×2 transposed convolution.

Submodules carry torchvision's names (``backbone.body.layer1.0.conv1``,
``backbone.fpn.inner_blocks.0``, ``rpn.head.cls_logits``,
``roi_heads.box_head.fc6``, ``roi_heads.mask_predictor.conv5_mask``, …), so
a torchvision ``maskrcnn_resnet50_fpn`` state dict loads by name, strictly
(``convert_torchvision.load_torchvision``).

``compute_dtype="bfloat16"`` runs the body, the FPN, the RPN head and the
heads in bf16 (parameters stay f32 and are cast at use, as Flax's
``dtype=``); box decoding, NMS, RoIAlign's sums and the mask paste stay
f32. In f32 the convolutions run with cuDNN's TF32 off.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn as nn
import torch.nn.functional as F

from mmtrs_tpu_torch.models.detection.ops import (
    clip_boxes,
    decode_boxes,
    make_anchors_per_level,
    roi_align_multilevel,
    static_nms,
    topk_static,
)


@dataclass(frozen=True)
class DetectorConfig:
    """Static-shape inference configuration (a copy of the JAX package's).

    torchvision test-time defaults: rpn pre_nms 1000/level, post_nms 1000,
    nms 0.7; box score 0.05, nms 0.5, 100 detections. The TPU build uses
    smaller static budgets — the consumer keeps one box per image
    (segment.py:50-58), so a 256/128/32 budget loses nothing measurable
    while keeping the NMS IoU matrices tiny.
    """

    img_size: int = 512
    base_width: int = 64
    layers: tuple[int, ...] = (3, 4, 6, 3)
    fpn_channels: int = 256
    num_classes: int = 91
    anchor_sizes: tuple[float, ...] = (32.0, 64.0, 128.0, 256.0, 512.0)
    aspect_ratios: tuple[float, ...] = (0.5, 1.0, 2.0)
    pre_nms_topk: int = 256  # per level
    post_nms_topk: int = 128
    rpn_nms_thresh: float = 0.7
    box_score_thresh: float = 0.05
    box_nms_thresh: float = 0.5
    # Candidate cap BEFORE the class-aware box NMS: the flat candidate set
    # is post_nms_topk × (num_classes−1) = 11,520 boxes, whose pairwise-IoU
    # matrix is 531 MB f32 PER IMAGE — the detector's dominant HBM cost.
    # Greedy NMS picks in score order and keeps ≤ max_detections, so
    # restricting to the top-K scored candidates is exact unless > K−D of
    # the top K are suppressed before D survivors emerge (never observed;
    # K/D = 32). 512² IoU is 1 MB — a 500× traffic cut.
    box_pre_nms_topk: int = 512
    max_detections: int = 16
    mask_out: int = 28
    # "bfloat16" runs body/FPN/RPN/heads matmuls on the MXU at half the HBM
    # traffic; box decode/NMS/mask-paste stay f32. f32 default keeps the
    # converted-weight golden tests bit-stable.
    compute_dtype: str = "float32"

    @property
    def strides(self) -> tuple[int, ...]:
        return (4, 8, 16, 32, 64)


# ImageNet normalization (GeneralizedRCNNTransform defaults)
_MEAN = (0.485, 0.456, 0.406)
_STD = (0.229, 0.224, 0.225)


class Conv(nn.Conv2d):
    """A convolution whose weight and bias are cast to the input's dtype
    (Flax's ``dtype=``), padded ``padding`` on every side."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, self.weight.to(x.dtype), b, self.stride, self.padding)


def _conv(cin: int, cout: int, kernel: int, stride: int = 1, bias: bool = False) -> Conv:
    return Conv(cin, cout, kernel, stride=stride, padding=kernel // 2, bias=bias)


class Linear(nn.Linear):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class FrozenBN(nn.Module):
    """torchvision's FrozenBatchNorm2d with the JAX package's arithmetic:
    the folded affine in f32, applied in the input's dtype."""

    def __init__(self, c: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(c))
        self.register_buffer("bias", torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = self.weight * torch.rsqrt(self.running_var + self.eps)
        off = self.bias - self.running_mean * inv
        return x * inv.to(x.dtype)[:, None, None] + off.to(x.dtype)[:, None, None]


class Bottleneck(nn.Module):
    def __init__(self, cin: int, width: int, stride: int = 1, downsample: bool = False):
        super().__init__()
        self.conv1 = _conv(cin, width, 1)
        self.bn1 = FrozenBN(width)
        self.conv2 = _conv(width, width, 3, stride)
        self.bn2 = FrozenBN(width)
        self.conv3 = _conv(width, width * 4, 1)
        self.bn3 = FrozenBN(width * 4)
        self.downsample = nn.Sequential(_conv(cin, width * 4, 1, stride), FrozenBN(width * 4)) if downsample \
            else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class ResNetBody(nn.Module):
    """torchvision resnet50 body (conv1..layer4), returning C2..C5."""

    def __init__(self, base_width: int = 64, layers=(3, 4, 6, 3)):
        super().__init__()
        w = base_width
        self.conv1 = Conv(3, w, 7, stride=2, padding=3, bias=False)
        self.bn1 = FrozenBN(w)
        cin = w
        self.n_layers = len(layers)
        for li, blocks in enumerate(layers):
            width = w * (2 ** li)
            stride = 1 if li == 0 else 2
            seq = []
            for bi in range(blocks):
                seq.append(Bottleneck(cin if bi == 0 else width * 4, width, stride if bi == 0 else 1, bi == 0))
            setattr(self, f"layer{li + 1}", nn.Sequential(*seq))
            cin = width * 4

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        feats = []
        for li in range(self.n_layers):
            x = getattr(self, f"layer{li + 1}")(x)
            feats.append(x)
        return feats  # [C2, C3, C4, C5]


class FPN(nn.Module):
    """1×1 laterals + 3×3 outputs + P6 as a stride-2 subsample of P5."""

    def __init__(self, in_channels: list[int], out_channels: int = 256):
        super().__init__()
        self.inner_blocks = nn.ModuleList([_conv(c, out_channels, 1, bias=True) for c in in_channels])
        self.layer_blocks = nn.ModuleList([_conv(out_channels, out_channels, 3, bias=True) for _ in in_channels])

    def forward(self, feats: list[torch.Tensor]) -> list[torch.Tensor]:
        laterals = [blk(f) for blk, f in zip(self.inner_blocks, feats)]
        for i in range(len(laterals) - 2, -1, -1):  # top-down: nearest ×2, cropped, added
            up = laterals[i + 1].repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
            laterals[i] = laterals[i] + up[:, :, : laterals[i].shape[2], : laterals[i].shape[3]]
        outs = [blk(l) for blk, l in zip(self.layer_blocks, laterals)]
        return outs + [outs[-1][:, :, ::2, ::2]]  # [P2, P3, P4, P5, P6]


class Backbone(nn.Module):
    def __init__(self, cfg: DetectorConfig):
        super().__init__()
        self.body = ResNetBody(cfg.base_width, cfg.layers)
        self.fpn = FPN([cfg.base_width * (2 ** i) * 4 for i in range(4)], cfg.fpn_channels)


class RPNHead(nn.Module):
    def __init__(self, num_anchors: int = 3, channels: int = 256):
        super().__init__()
        self.conv = _conv(channels, channels, 3, bias=True)
        self.cls_logits = _conv(channels, num_anchors, 1, bias=True)
        self.bbox_pred = _conv(channels, num_anchors * 4, 1, bias=True)

    def forward(self, feats: list[torch.Tensor]) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
        """→ per level logits [B, H·W·A] and deltas [B, H·W·A, 4], flattened
        in (H, W, A) order as the JAX package's NHWA."""
        logits, deltas = [], []
        for f in feats:
            t = F.relu(self.conv(f))
            B = t.shape[0]
            logits.append(self.cls_logits(t).permute(0, 2, 3, 1).reshape(B, -1))
            deltas.append(self.bbox_pred(t).permute(0, 2, 3, 1).reshape(B, -1, 4))
        return logits, deltas


class RPN(nn.Module):
    def __init__(self, cfg: DetectorConfig):
        super().__init__()
        self.head = RPNHead(len(cfg.aspect_ratios), cfg.fpn_channels)


class BoxHead(nn.Module):
    """TwoMLPHead (fc6, fc7) on NCHW-flattened RoI features."""

    def __init__(self, in_features: int, representation: int = 1024):
        super().__init__()
        self.fc6 = Linear(in_features, representation)
        self.fc7 = Linear(representation, representation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.fc7(F.relu(self.fc6(x.flatten(1)))))


class BoxPredictor(nn.Module):
    """FastRCNNPredictor: class logits and per-class deltas."""

    def __init__(self, representation: int, num_classes: int):
        super().__init__()
        self.cls_score = Linear(representation, num_classes)
        self.bbox_pred = Linear(representation, num_classes * 4)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        return self.cls_score(x), self.bbox_pred(x)


class MaskHead(nn.Module):
    """MaskRCNNHeads: 4 × (conv3x3 + relu), ``channels`` wide whatever the
    FPN's width (the JAX package's MaskHead keeps its default 256)."""

    def __init__(self, in_channels: int, channels: int = 256):
        super().__init__()
        for i in range(1, 5):
            setattr(self, f"mask_fcn{i}", _conv(in_channels if i == 1 else channels, channels, 3, bias=True))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(1, 5):
            x = F.relu(getattr(self, f"mask_fcn{i}")(x))
        return x


class MaskPredictor(nn.Module):
    """MaskRCNNPredictor: 2×2/2 transposed conv + relu, 1×1 logits."""

    def __init__(self, channels: int, num_classes: int):
        super().__init__()
        self.conv5_mask = nn.ConvTranspose2d(channels, channels, 2, stride=2)
        self.mask_fcn_logits = _conv(channels, num_classes, 1, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        t = self.conv5_mask
        x = F.relu(F.conv_transpose2d(x, t.weight.to(x.dtype), t.bias.to(x.dtype), stride=2))
        return self.mask_fcn_logits(x)


class RoIHeads(nn.Module):
    """The box head at 1024 and the mask head at 256, as the JAX package's
    (both its defaults, whatever ``fpn_channels``)."""

    def __init__(self, cfg: DetectorConfig, representation: int = 1024):
        super().__init__()
        C = cfg.fpn_channels
        self.box_head = BoxHead(C * 7 * 7, representation)
        self.box_predictor = BoxPredictor(representation, cfg.num_classes)
        self.mask_head = MaskHead(C)
        self.mask_predictor = MaskPredictor(256, cfg.num_classes)


class MaskRCNN(nn.Module):
    """Inference-oriented Mask R-CNN; ``forward`` returns padded, masked
    detections: boxes [B,D,4], scores [B,D], labels [B,D], valid [B,D],
    masks [B,D,28,28] (sigmoid probabilities in ROI frame)."""

    def __init__(self, cfg: DetectorConfig = DetectorConfig()):
        super().__init__()
        self.cfg = cfg
        self.backbone = Backbone(cfg)
        self.rpn = RPN(cfg)
        self.roi_heads = RoIHeads(cfg)
        # constants that move with the module, outside the state dict, so
        # that a forward copies nothing from the host
        self.register_buffer("pixel_mean", torch.tensor(_MEAN), persistent=False)
        self.register_buffer("pixel_std", torch.tensor(_STD), persistent=False)
        self._anchors: dict = {}

    @property
    def out_dtype(self) -> torch.dtype:
        """The parameters' dtype (f32; f64 after ``.double()``): boxes,
        scores, RoIAlign's sums and masks come out in it."""
        return self.roi_heads.box_head.fc6.weight.dtype

    @property
    def dtype(self) -> torch.dtype:
        """The compute dtype of the convolutions and Dense layers."""
        return torch.bfloat16 if self.cfg.compute_dtype == "bfloat16" else self.out_dtype

    def _cudnn(self):
        """cuDNN without TF32 unless the compute dtype is bf16 (the JAX
        package's f32 convolutions)."""
        return torch.backends.cudnn.flags(enabled=torch.backends.cudnn.enabled,
                                          benchmark=torch.backends.cudnn.benchmark,
                                          deterministic=torch.backends.cudnn.deterministic,
                                          allow_tf32=self.dtype == torch.bfloat16)

    def features(self, imgs01: torch.Tensor) -> list[torch.Tensor]:
        """imgs01 [B, S, S, 3] float 0..1 → [P2, P3, P4, P5, P6], NCHW in
        the compute dtype."""
        dt = self.out_dtype
        x = ((imgs01.to(dt) - self.pixel_mean.to(dt)) / self.pixel_std.to(dt)).to(self.dtype).permute(0, 3, 1, 2)
        x = x.contiguous(memory_format=torch.channels_last)
        with self._cudnn():
            return self.backbone.fpn(self.backbone.body(x))

    def rpn_head(self, feats):
        with self._cudnn():
            return self.rpn.head(feats)

    def forward(self, imgs01: torch.Tensor):
        """imgs01: [B, S, S, 3] float in 0..1."""
        S = imgs01.shape[1]
        feats = self.features(imgs01)
        logits, deltas = self.rpn_head(feats)
        props, pvalid = self.rpn_proposals(feats, logits, deltas, S)
        return self.detection_heads(feats, props, pvalid, S)

    def anchors(self, feats, device) -> list[torch.Tensor]:
        """Each level's anchors on ``device``, made once a feature shape."""
        c = self.cfg
        key = (tuple(tuple(f.shape[2:]) for f in feats), str(device))
        if key not in self._anchors:
            self._anchors[key] = [
                torch.from_numpy(make_anchors_per_level((f.shape[2], f.shape[3]), s, sz, c.aspect_ratios)).to(device)
                for f, s, sz in zip(feats, c.strides, c.anchor_sizes)
            ]
        return self._anchors[key]

    def rpn_proposals(self, feats, logits, deltas, S: int):
        """Per-image RPN: level-wise top-k → decode → joint NMS with level
        groups → (proposals [B, post_nms_topk, 4] f32, valid [B,
        post_nms_topk])."""
        c = self.cfg
        B = logits[0].shape[0]
        all_boxes, all_scores, all_groups = [], [], []
        for lvl, (lg, dl, an) in enumerate(zip(logits, deltas, self.anchors(feats, logits[0].device))):
            k = min(c.pre_nms_topk, lg.shape[1])
            top_sc, top_i = topk_static(lg, k)
            dd = dl.gather(1, top_i[..., None].expand(B, k, 4))
            boxes = clip_boxes(decode_boxes(dd.to(self.out_dtype), an[top_i]), (S, S))
            # drop degenerate boxes (torchvision min_size=1e-3)
            ok = (boxes[..., 2] - boxes[..., 0] > 1e-3) & (boxes[..., 3] - boxes[..., 1] > 1e-3)
            all_boxes.append(boxes)
            all_scores.append(torch.where(ok, top_sc, torch.full_like(top_sc, -float("inf"))))
            all_groups.append(torch.full((B, k), lvl, dtype=torch.int32, device=lg.device))
        boxes = torch.cat(all_boxes, dim=1)
        scores = torch.cat(all_scores, dim=1)
        keep, valid = static_nms(boxes, scores, c.rpn_nms_thresh, c.post_nms_topk, torch.cat(all_groups, dim=1))
        return boxes.gather(1, keep[..., None].expand(*keep.shape, 4)), valid

    def detection_heads(self, feats, props, pvalid, S: int):
        """Box + mask heads over the RPN proposals → (boxes [B,D,4], scores
        [B,D], labels [B,D] int64, valid [B,D], masks [B,D,28,28])."""
        c = self.cfg
        B, R = props.shape[:2]
        n_cls = c.num_classes - 1
        strides = list(c.strides[:4])
        roi = roi_align_multilevel(feats[:4], strides, props, 7)  # [B, R, C, 7, 7] f32
        h = self.roi_heads
        with self._cudnn():
            scores, deltas2 = h.box_predictor(h.box_head(roi.reshape(B * R, -1).to(self.dtype)))
        scores, deltas2 = scores.to(self.out_dtype), deltas2.to(self.out_dtype)
        probs = torch.softmax(scores, dim=-1)[:, 1:].reshape(B, R, n_cls)  # drop background
        boxes2 = decode_boxes(deltas2.reshape(B, R, c.num_classes, 4)[:, :, 1:], props[:, :, None, :],
                              weights=(10.0, 10.0, 5.0, 5.0))
        flat_boxes = clip_boxes(boxes2, (S, S)).reshape(B, -1, 4)
        flat_scores = torch.where(pvalid[:, :, None], probs, torch.zeros((), device=probs.device)).reshape(B, -1)
        flat_labels = torch.arange(1, c.num_classes, device=props.device).repeat(R)[None].expand(B, -1)
        ok = flat_scores > c.box_score_thresh
        small = (flat_boxes[..., 2] - flat_boxes[..., 0] <= 1e-2) | (flat_boxes[..., 3] - flat_boxes[..., 1] <= 1e-2)
        sc = torch.where(ok & ~small, flat_scores, torch.full_like(flat_scores, -float("inf")))
        # cap candidates by score BEFORE building the IoU matrix (see
        # box_pre_nms_topk in DetectorConfig)
        K = min(c.box_pre_nms_topk, sc.shape[1])
        if K < sc.shape[1]:
            sc, top_i = topk_static(sc, K)
            flat_boxes = flat_boxes.gather(1, top_i[..., None].expand(B, K, 4))
            flat_scores = flat_scores.gather(1, top_i)
            flat_labels = flat_labels.gather(1, top_i)
        keep, valid = static_nms(flat_boxes, sc, c.box_nms_thresh, c.max_detections, flat_labels)
        det_boxes = flat_boxes.gather(1, keep[..., None].expand(*keep.shape, 4))
        det_scores = flat_scores.gather(1, keep)
        valid = valid & (det_scores > c.box_score_thresh)
        det_scores = torch.where(valid, det_scores, torch.zeros((), device=det_scores.device))
        det_labels = torch.where(valid, flat_labels.gather(1, keep), torch.zeros((), dtype=torch.long,
                                                                                 device=keep.device))

        D = det_boxes.shape[1]
        mroi = roi_align_multilevel(feats[:4], strides, det_boxes, 14)  # [B, D, C, 14, 14]
        with self._cudnn():
            mask_logits = h.mask_predictor(h.mask_head(mroi.reshape(B * D, *mroi.shape[2:]).to(self.dtype)))
        mask_logits = mask_logits.to(self.out_dtype)
        sel = mask_logits.reshape(B, D, c.num_classes, 28, 28).gather(
            2, det_labels[:, :, None, None, None].expand(B, D, 1, 28, 28))[:, :, 0]
        return det_boxes, det_scores, det_labels, valid, torch.sigmoid(sel)
