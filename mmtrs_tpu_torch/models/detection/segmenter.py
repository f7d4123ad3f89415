"""Learned molar segmenter: Mask R-CNN behind the Segmenter box contract
(port of mmtrs_tpu/models/detection/segmenter.py).

Reference behavior (src/preprocessing/segment.py:24-58), preserved exactly:
- score < 0.05 detections are skipped (:34);
- masks whose mean HSV saturation < 40 are metal → rejected (:37-39);
- shipped selection = argmax-score mask (:50-58 overwrite the
  centre-closest pick — the documented dead-code quirk);
- the crop is the bbox OF THE THRESHOLDED MASK (mask > 0.5), not the
  detection box (:57, :60-66);
- no valid mask → the caller's centre-crop fallback fires
  (pipeline.py:107-111), expressed here as valid=False + centre box.

The detector runs on the batch at ``img_size``²; each image's masks are then
pasted at its own size one image at a time (16 full-size f32 masks, 0.78 GB
at 12 MP), so the peak memory does not grow with the batch.
"""

from __future__ import annotations

import torch

from mmtrs_tpu_torch.device import resolve_device
from mmtrs_tpu_torch.models.detection.convert_torchvision import detector_from_flax
from mmtrs_tpu_torch.models.detection.modules import DetectorConfig, MaskRCNN
from mmtrs_tpu_torch.models.detection.ops import mask_bbox, paste_mask
from mmtrs_tpu_torch.ops.color import rgb_to_hsv
from mmtrs_tpu_torch.ops.resize import resize_bilinear


class MaskRCNNSegmenter:
    """Implements models.segmenter.Segmenter with a learned detector.
    ``state_dict`` holds the port's (torchvision) names: a torchvision
    checkpoint through ``convert_torchvision.classic_names``, or the JAX
    package's tree through ``detector_from_flax``. The detector lives on
    ``device`` (None: the card)."""

    def __init__(
        self,
        state_dict: dict,
        cfg: DetectorConfig = DetectorConfig(),
        score_thresh: float = 0.05,
        min_saturation: float = 40.0,
        mask_thresh: float = 0.5,
        device: str | torch.device | None = None,
    ):
        self.cfg = cfg
        self.score_thresh = score_thresh
        self.min_saturation = min_saturation
        self.mask_thresh = mask_thresh
        model = MaskRCNN(cfg)
        model.load_state_dict(state_dict, strict=True)
        self.model = model.eval()
        self.to(device)

    def to(self, device: str | torch.device | None) -> "MaskRCNNSegmenter":
        """Move the detector to ``device`` (None: the card); returns self."""
        self.device = resolve_device(device)
        self.model.to(self.device)
        return self

    @torch.no_grad()
    def propose_boxes(self, imgs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """imgs [B, H, W, 3] u8 or float 0..255 on the detector's device →
        (boxes [B, 4] f32 (y0, x0, y1, x1), valid [B] bool)."""
        B, H, W, _ = imgs.shape
        S = self.cfg.img_size
        x = imgs.float()
        det_in = x if (H, W) == (S, S) else resize_bilinear(x, (S, S))
        det_boxes, det_scores, _, det_valid, det_masks = self.model(det_in / 255.0)
        # scale detection boxes back to the input frame
        sy, sx = H / S, W / S
        det_boxes = torch.stack([det_boxes[..., 0] * sx, det_boxes[..., 1] * sy, det_boxes[..., 2] * sx,
                                 det_boxes[..., 3] * sy], dim=-1)
        sat = rgb_to_hsv(x)[..., 1]  # 0..255 scale (cv2 HSV parity)

        side = float(min(H, W))
        centre = torch.stack([torch.full((), v, device=x.device)
                              for v in ((H - side) / 2.0, (W - side) / 2.0, (H + side) / 2.0, (W + side) / 2.0)])
        boxes, valid = [], []
        for i in range(B):
            m = paste_mask(det_masks[i], det_boxes[i], (H, W)) > self.mask_thresh  # [D, H, W]
            area = m.sum(dim=(1, 2))
            mean_sat = torch.where(m, sat[i], 0.0).sum(dim=(1, 2)) / torch.clamp_min(area.float(), 1.0)
            ok = (det_valid[i] & (det_scores[i] >= self.score_thresh) & (mean_sat >= self.min_saturation)
                  & (area > 0))
            # shipped reference behavior: argmax score among gated masks
            best = torch.argmax(torch.where(ok, det_scores[i], -float("inf")))
            any_ok = ok.any()
            boxes.append(torch.where(any_ok, mask_bbox(m[best]), centre))
            valid.append(any_ok)
        return torch.stack(boxes), torch.stack(valid)


def load_detector(path, device: str | torch.device | None = None) -> MaskRCNNSegmenter:
    """Load a converted checkpoint — ``<path>.npz`` with its
    ``<path>.recipe.json``, as scripts/export_npz_checkpoints.py writes
    beside ``download_weights.py --torch_ckpt``'s output — into a
    pipeline-ready MaskRCNNSegmenter on ``device`` (None: the card). The
    recipe's ``img_size`` and ``num_classes`` set the config (512 and 91
    without one)."""
    from mmtrs_tpu_torch.utils.checkpoint import load_npz_checkpoint

    variables, recipe = load_npz_checkpoint(path)
    recipe = recipe or {}
    cfg = DetectorConfig(
        img_size=int(recipe.get("img_size", 512)),
        num_classes=int(recipe.get("num_classes", 91)),
    )
    return MaskRCNNSegmenter(detector_from_flax(variables), cfg, device=device)
