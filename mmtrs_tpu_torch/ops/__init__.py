"""Image ops (port of mmtrs_tpu/ops/): the counterpart of each name in
the JAX package's ``mmtrs_tpu.ops.__all__``."""

from mmtrs_tpu_torch.ops.color import hsv_to_rgb, lab_to_rgb, rgb_to_gray, rgb_to_hsv, rgb_to_lab
from mmtrs_tpu_torch.ops.warp import invert_affine, rotation_matrix, warp_affine, warp_perspective
from mmtrs_tpu_torch.ops.resize import center_crop_resize, crop_box_resize, resize_bilinear
from mmtrs_tpu_torch.ops.clahe import clahe, clahe_rgb
from mmtrs_tpu_torch.ops.deskew import deskew_batch, estimate_skew_angle

__all__ = [
    "rgb_to_lab",
    "lab_to_rgb",
    "rgb_to_hsv",
    "hsv_to_rgb",
    "rgb_to_gray",
    "warp_affine",
    "warp_perspective",
    "rotation_matrix",
    "invert_affine",
    "resize_bilinear",
    "center_crop_resize",
    "crop_box_resize",
    "clahe",
    "clahe_rgb",
    "deskew_batch",
    "estimate_skew_angle",
]
