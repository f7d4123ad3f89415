"""Boundaries of the PyTorch port: what it imports, and that a CUDA kernel is
never replaced by its plain version when the card or nvcc is missing."""

import dataclasses
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

SLICE_MODULES = [
    "mmtrs_tpu_torch",
    "mmtrs_tpu_torch._build",
    "mmtrs_tpu_torch.config",
    "mmtrs_tpu_torch.synth",
    "mmtrs_tpu_torch.ops.color",
    "mmtrs_tpu_torch.ops.clahe",
    "mmtrs_tpu_torch.ops.kernels",
    "mmtrs_tpu_torch.ops.kernels.clahe_lab",
    "mmtrs_tpu_torch.ops.kernels.shift",
    "mmtrs_tpu_torch.ops.warp",
    "mmtrs_tpu_torch.ops.augment",
    "mmtrs_tpu_torch.ops.deskew",
    "mmtrs_tpu_torch.ops.resize",
    "mmtrs_tpu_torch.models.segmenter",
    "mmtrs_tpu_torch.models.backbones.efficientnet",
    "mmtrs_tpu_torch.models.backbones.factory",
    "mmtrs_tpu_torch.models.mil",
    "mmtrs_tpu_torch.models.convert",
    "mmtrs_tpu_torch.train.common",
    "mmtrs_tpu_torch.preprocess",
    "mmtrs_tpu_torch.serve.choices",
    "mmtrs_tpu_torch.serve.ensembles",
    "mmtrs_tpu_torch.serve.service",
]


def test_slice_imports_no_jax_pandas_pil_or_jax_package():
    """The card has no JAX and may have no pandas or Pillow: importing every
    slice module in a fresh interpreter loads none of them, nor mmtrs_tpu."""
    code = (
        "import importlib, sys\n"
        f"for m in {SLICE_MODULES!r}: importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'pandas', 'PIL', 'mmtrs_tpu'))\n"
        "print(','.join(bad))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "", res.stdout


def test_config_copy_matches_jax_package():
    from mmtrs_tpu.config import PreprocessConfig as Orig
    from mmtrs_tpu_torch.config import PreprocessConfig

    def spec(cls):
        return [(f.name, f.default) for f in dataclasses.fields(cls)]

    assert spec(PreprocessConfig) == spec(Orig)


def test_choices_copy_matches_jax_package():
    from mmtrs_tpu.serve import choices as orig
    from mmtrs_tpu_torch.serve import choices

    assert choices.CHOICES_MAP == orig.CHOICES_MAP
    assert choices.FIELD_ORDER == orig.FIELD_ORDER
    full = {k: next(iter(v)) for k, v in orig.CHOICES_MAP.items()}
    for fields in (full, {}, {"depth": "> 4mm"}):
        assert choices.validate_all_or_none(fields) == orig.validate_all_or_none(fields)
    assert choices.encode_fields(full) == orig.encode_fields(full)


def test_build_without_card_raises():
    """No CUDA device (or no nvcc): asking for the kernel library raises."""
    from mmtrs_tpu_torch import _build

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        _build.library()


@pytest.mark.parametrize("wrapper", ["clahe_lab_fwd_lut", "shift_rows"])
def test_wrappers_raise_off_cpu_instead_of_plain_result(wrapper):
    """A tensor that is not on the CPU never gets the plain version: here a
    meta-device tensor (a CPU-only machine has no CUDA one) is refused."""
    from mmtrs_tpu_torch.ops.kernels.clahe_lab import clahe_lab_fwd_lut
    from mmtrs_tpu_torch.ops.kernels.shift import shift_rows

    x = torch.empty((1, 16, 16, 3), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        if wrapper == "clahe_lab_fwd_lut":
            clahe_lab_fwd_lut(x, 3.0, (8, 8))
        else:
            shift_rows(x, torch.empty((1, 16), device="meta"))


def test_wrappers_reject_bad_inputs():
    from mmtrs_tpu_torch.ops.kernels.clahe_lab import clahe_lab_fwd_lut
    from mmtrs_tpu_torch.ops.kernels.shift import shift_rows

    with pytest.raises(ValueError, match="uint8"):
        clahe_lab_fwd_lut(torch.zeros((1, 16, 16, 3)), 3.0, (8, 8))
    with pytest.raises(ValueError, match="tile grid"):
        clahe_lab_fwd_lut(torch.zeros((1, 20, 16, 3), dtype=torch.uint8), 3.0, (8, 8))
    with pytest.raises(ValueError, match="contiguous"):
        shift_rows(torch.zeros((1, 16, 16, 3)).transpose(1, 2), torch.zeros((1, 16)))
    with pytest.raises(ValueError, match="does not fit"):
        shift_rows(torch.zeros((1, 16, 8, 3)), torch.zeros((1, 16)), axis=1)
