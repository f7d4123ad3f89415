"""Mask R-CNN detection stack of the port (mmtrs_tpu/models/detection's
twin).

- modules: ResNet-FPN / RPN / box+mask heads under torchvision's names
- ops: anchors, box coding, static NMS, gather RoIAlign, mask pasting
- convert_torchvision: torchvision checkpoints and the JAX package's tree
- segmenter: MaskRCNNSegmenter implementing the pipeline's box contract
"""

from mmtrs_tpu_torch.models.detection.convert_torchvision import (
    detector_from_flax,
    detector_to_flax,
    expected_torch_keys,
    fake_state_dict,
    load_torchvision,
)
from mmtrs_tpu_torch.models.detection.modules import DetectorConfig, MaskRCNN
from mmtrs_tpu_torch.models.detection.segmenter import MaskRCNNSegmenter, load_detector

__all__ = [
    "DetectorConfig",
    "MaskRCNN",
    "MaskRCNNSegmenter",
    "detector_from_flax",
    "detector_to_flax",
    "expected_torch_keys",
    "fake_state_dict",
    "load_detector",
    "load_torchvision",
]
