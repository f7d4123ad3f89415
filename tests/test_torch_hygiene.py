"""Boundaries of the PyTorch port: what it imports, and that a CUDA kernel is
never replaced by its plain version when the card or nvcc is missing."""

import ctypes
import dataclasses
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

SLICE_MODULES = [
    "mmtrs_tpu_torch",
    "mmtrs_tpu_torch._build",
    "mmtrs_tpu_torch.config",
    "mmtrs_tpu_torch.device",
    "mmtrs_tpu_torch.synth",
    "mmtrs_tpu_torch.ops.color",
    "mmtrs_tpu_torch.ops.clahe",
    "mmtrs_tpu_torch.ops.kernels",
    "mmtrs_tpu_torch.ops.kernels.clahe_lab",
    "mmtrs_tpu_torch.ops.kernels.clahe",
    "mmtrs_tpu_torch.ops.kernels.shift",
    "mmtrs_tpu_torch.ops.kernels.resample",
    "mmtrs_tpu_torch.ops.kernels.photometric",
    "mmtrs_tpu_torch.ops.kernels.scatter",
    "mmtrs_tpu_torch.utils",
    "mmtrs_tpu_torch.utils.rng",
    "mmtrs_tpu_torch.ops.warp",
    "mmtrs_tpu_torch.ops.augment",
    "mmtrs_tpu_torch.ops.deskew",
    "mmtrs_tpu_torch.ops.resize",
    "mmtrs_tpu_torch.models.segmenter",
    "mmtrs_tpu_torch.models.backbones.efficientnet",
    "mmtrs_tpu_torch.models.backbones.factory",
    "mmtrs_tpu_torch.models.backbones.tinynet",
    "mmtrs_tpu_torch.models.mil",
    "mmtrs_tpu_torch.models.mm_joint",
    "mmtrs_tpu_torch.models.gbdt",
    "mmtrs_tpu_torch.models.linear",
    "mmtrs_tpu_torch.models.convert",
    "mmtrs_tpu_torch.metrics",
    "mmtrs_tpu_torch.metrics.thresholds",
    "mmtrs_tpu_torch.utils.checkpoint",
    "mmtrs_tpu_torch.train.common",
    "mmtrs_tpu_torch.train.tabular",
    "mmtrs_tpu_torch.preprocess",
    "mmtrs_tpu_torch.data",
    "mmtrs_tpu_torch.data.records",
    "mmtrs_tpu_torch.data.features",
    "mmtrs_tpu_torch.serve.choices",
    "mmtrs_tpu_torch.serve.ensembles",
    "mmtrs_tpu_torch.serve.service",
    "mmtrs_tpu_torch.utils.codec",
    "mmtrs_tpu_torch.utils.images",
    "mmtrs_tpu_torch.utils.io",
    "mmtrs_tpu_torch.serve.app",
    "mmtrs_tpu_torch.cli",
    "mmtrs_tpu_torch.cli.run_pipeline",
    "mmtrs_tpu_torch.utils.table",
    "mmtrs_tpu_torch.utils.profiling",
    "mmtrs_tpu_torch.data.splits",
    "mmtrs_tpu_torch.metrics.binary",
    "mmtrs_tpu_torch.train.mm",
    "mmtrs_tpu_torch.cli.run_augment_records",
    "mmtrs_tpu_torch.train.mil",
    "mmtrs_tpu_torch.fusion",
    "mmtrs_tpu_torch.fusion.stack",
    "mmtrs_tpu_torch.fusion.meta",
    "mmtrs_tpu_torch.fusion.weight_search",
    "mmtrs_tpu_torch.fusion.fuse",
    "mmtrs_tpu_torch.fusion.infer",
    "mmtrs_tpu_torch.cli.run_fusion",
]

# the vision-training slice: none of these may load matplotlib either (the
# threshold sweep imports it inside its plot functions)
VISION_MODULES = [
    "mmtrs_tpu_torch.models.backbones.convnext",
    "mmtrs_tpu_torch.train.vision",
    "mmtrs_tpu_torch.train.progressive",
    "mmtrs_tpu_torch.train.kfold",
    "mmtrs_tpu_torch.cli.run_train_images",
    "mmtrs_tpu_torch.fusion.streams",
    "mmtrs_tpu_torch.eval",
    "mmtrs_tpu_torch.eval.threshold_sweep",
]
SLICE_MODULES += VISION_MODULES
# the pipeline's last entry points and their data helpers
SLICE_MODULES += [
    "mmtrs_tpu_torch.data.standardize",
    "mmtrs_tpu_torch.cli.make_balanced_splits",
    "mmtrs_tpu_torch.cli.make_group_splits",
    "mmtrs_tpu_torch.cli.run_augment",
    "mmtrs_tpu_torch.cli.run_augment_simple",
    "mmtrs_tpu_torch.cli.eval_vision",
    "mmtrs_tpu_torch.cli.evaluate_models",
    "mmtrs_tpu_torch.cli.rehearsal",
    "mmtrs_tpu_torch.cli.stack_from_streams",
]


def test_slice_imports_no_jax_pandas_pil_or_jax_package():
    """The card has no JAX and may have no pandas, Pillow, optax or sklearn:
    importing every slice module in a fresh interpreter loads none of them,
    nor mmtrs_tpu."""
    code = (
        "import importlib, sys\n"
        f"for m in {SLICE_MODULES!r}: importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'sklearn', 'pandas', 'PIL', 'openpyxl', 'mmtrs_tpu'))\n"
        "print(','.join(bad))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "", res.stdout


def test_vision_modules_import_no_matplotlib_sklearn_pandas_or_pil():
    """Importing every module of the vision-training slice in a fresh
    interpreter loads no matplotlib, sklearn, pandas or PIL (the card's
    machine may lack them)."""
    code = (
        "import importlib, sys\n"
        f"for m in {VISION_MODULES!r}: importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('matplotlib', 'sklearn', 'pandas', 'PIL', 'jax', 'mmtrs_tpu'))\n"
        "print(','.join(bad))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "", res.stdout


def test_config_copy_matches_jax_package():
    from mmtrs_tpu.config import PreprocessConfig as Orig
    from mmtrs_tpu_torch.config import PreprocessConfig

    def spec(cls):
        return [(f.name, f.default) for f in dataclasses.fields(cls)]

    assert spec(PreprocessConfig) == spec(Orig)


def test_mm_joint_config_copy_matches_jax_package():
    from mmtrs_tpu.config import MMJointConfig as Orig
    from mmtrs_tpu_torch.config import MMJointConfig

    def spec(cls):
        return [(f.name, f.type, f.default) for f in dataclasses.fields(cls)]

    assert spec(MMJointConfig) == spec(Orig)


@pytest.mark.parametrize("name", ["GBDTConfig", "MILConfig", "FusionConfig", "VisionTrainConfig",
                                  "ProgressiveStage", "ProgressiveConfig"])
def test_training_config_copies_match_jax_package(name):
    """The copies of GBDTConfig (and its two recipes), MILConfig,
    FusionConfig, VisionTrainConfig, ProgressiveStage and ProgressiveConfig
    have the originals' fields, types and defaults (ProgressiveConfig's
    default stages compared field by field)."""
    import mmtrs_tpu.config as orig
    import mmtrs_tpu_torch.config as port

    def spec(cls):
        return [(f.name, f.type, f.default) for f in dataclasses.fields(cls)]

    if name == "ProgressiveConfig":
        pa, oa = port.ProgressiveConfig(), orig.ProgressiveConfig()
        assert [dataclasses.asdict(s) for s in pa.stages] == [dataclasses.asdict(s) for s in oa.stages]
        spec = lambda cls: [(f.name, f.type, f.default) for f in dataclasses.fields(cls) if f.name != "stages"]
    assert spec(getattr(port, name)) == spec(getattr(orig, name))
    if name == "GBDTConfig":
        for recipe in ("lgbm_like", "stack_tab_like"):
            assert dataclasses.asdict(getattr(port.GBDTConfig, recipe)()) == \
                dataclasses.asdict(getattr(orig.GBDTConfig, recipe)())


def test_port_sources_name_no_jax_side_package():
    """No module of the port names jax, flax, optax, sklearn, pandas, PIL or
    mmtrs_tpu in an import statement, even one inside a function that the
    import test above never calls."""
    pat = re.compile(r"^\s*(?:import|from)\s+(jax|jaxlib|flax|optax|sklearn|pandas|PIL|openpyxl|mmtrs_tpu)\b",
                     re.M)
    hits = [f"{p.relative_to(ROOT)}: {m.group(0).strip()}"
            for p in sorted((ROOT / "mmtrs_tpu_torch").rglob("*.py")) for m in pat.finditer(p.read_text())]
    assert hits == []


def test_supports_copy_matches_jax_package():
    """The route predicate and its row block, copied from the fused TPU
    kernels' module, agree with the originals over H, W in 16..1104 step 8
    and both tile grids."""
    from mmtrs_tpu.ops.pallas import lab_kernels as orig
    from mmtrs_tpu_torch.ops.kernels import clahe_lab

    sizes = range(16, 1105, 8)
    for H in sizes:
        try:
            want = orig._plane_rows(H)
        except ValueError:
            with pytest.raises(ValueError):
                clahe_lab._plane_rows(H)
        else:
            assert clahe_lab._plane_rows(H) == want, H
        for W in sizes:
            for tiles in ((8, 8), (4, 4)):
                assert clahe_lab.supports(H, W, tiles) == orig.supports(H, W, tiles), (H, W, tiles)


def test_photometric_supports_copy_matches_jax_package():
    """The fused photometric pass's shape predicate, which with the fused
    LAB kernels' one picks the ``legacy`` CLAHE member's route, agrees with
    the original over H, W in 16..1104."""
    from mmtrs_tpu.ops.pallas import photometric_kernel as orig
    from mmtrs_tpu_torch.ops.kernels import photometric

    sizes = range(16, 1105)
    got = [[photometric.supports(H, W) for W in sizes] for H in sizes]
    assert got == [[orig.supports(H, W) for W in sizes] for H in sizes]


def test_choices_copy_matches_jax_package():
    from mmtrs_tpu.serve import choices as orig
    from mmtrs_tpu_torch.serve import choices

    assert choices.CHOICES_MAP == orig.CHOICES_MAP
    assert choices.FIELD_ORDER == orig.FIELD_ORDER
    full = {k: next(iter(v)) for k, v in orig.CHOICES_MAP.items()}
    for fields in (full, {}, {"depth": "> 4mm"}):
        assert choices.validate_all_or_none(fields) == orig.validate_all_or_none(fields)
    assert choices.encode_fields(full) == orig.encode_fields(full)


def test_standardize_copies_match_jax_package():
    """``_norm``, the ordered rules and the field list of the standardiser
    are copies: the rules' encodings in order, and each predicate agrees
    with the original on every case string of tests/test_torch_standardize.py."""
    from mmtrs_tpu.data import standardize as orig
    from mmtrs_tpu_torch.data import standardize as port
    from tests.test_torch_standardize import CASES

    strings = [port._norm(v) for vals in CASES.values() for v in vals] + ["", "low high", "one side presence"]
    assert list(port.FIELD_MAPPERS) == list(orig.FIELD_MAPPERS)
    assert list(port._ORDERED_RULES) == list(orig._ORDERED_RULES)
    for field, rules in orig._ORDERED_RULES.items():
        assert [enc for _, enc in port._ORDERED_RULES[field]] == [enc for _, enc in rules], field
        for (pp, _), (op, _) in zip(port._ORDERED_RULES[field], rules):
            assert [pp(s) for s in strings] == [op(s) for s in strings], field
    assert [port._norm(s) for s in strings + [None, 3, "A\u2013B \u2264 4MM"]] == \
        [orig._norm(s) for s in strings + [None, 3, "A\u2013B \u2264 4MM"]]
    assert (port._YES("yes"), port._NO("absent")) == (orig._YES("yes"), orig._NO("absent"))


def test_three_way_split_config_copy_matches_jax_package():
    from mmtrs_tpu.data.splits import ThreeWaySplitConfig as Orig
    from mmtrs_tpu_torch.data.splits import ThreeWaySplitConfig

    spec = lambda cls: [(f.name, f.type, f.default) for f in dataclasses.fields(cls)]
    assert spec(ThreeWaySplitConfig) == spec(Orig)
    assert ThreeWaySplitConfig.__dataclass_params__.frozen and Orig.__dataclass_params__.frozen


def test_new_entry_points_resolve_to_the_card():
    """Every CLI of the slice takes ``--device`` with default None (the
    card, through ``resolve_device``)."""
    import importlib

    for name in ("make_balanced_splits", "make_group_splits", "run_augment", "run_augment_simple", "eval_vision",
                 "evaluate_models", "rehearsal", "stack_from_streams"):
        mod = importlib.import_module(f"mmtrs_tpu_torch.cli.{name}")
        dev = [a for a in mod.build_parser()._actions if a.dest == "device"]
        assert len(dev) == 1 and dev[0].default is None, name
        assert "resolve_device" in (ROOT / "mmtrs_tpu_torch" / "cli" / f"{name}.py").read_text(), name


def test_build_without_card_raises():
    """No CUDA device (or no nvcc): asking for the kernel library raises."""
    from mmtrs_tpu_torch import _build

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        _build.library()


@pytest.mark.parametrize(
    "wrapper",
    ["clahe_lab_fwd_lut", "shift_rows", "resample_rows", "photometric", "shift_rows_windowed", "scatter_rows",
     "clahe_hist_lut", "clahe_apply"],
)
def test_wrappers_raise_off_cpu_instead_of_plain_result(wrapper):
    """A tensor that is not on the CPU never gets the plain version: here a
    meta-device tensor (a CPU-only machine has no CUDA one) is refused."""
    from mmtrs_tpu_torch.ops.kernels.clahe import clahe_apply, clahe_hist_lut
    from mmtrs_tpu_torch.ops.kernels.clahe_lab import clahe_lab_fwd_lut
    from mmtrs_tpu_torch.ops.kernels.photometric import photometric
    from mmtrs_tpu_torch.ops.kernels.resample import resample_rows
    from mmtrs_tpu_torch.ops.kernels.scatter import scatter_rows_
    from mmtrs_tpu_torch.ops.kernels.shift import shift_rows, shift_rows_windowed

    meta = lambda shape, dtype=torch.float32: torch.empty(shape, dtype=dtype, device="meta")
    x = meta((1, 16, 16, 3), torch.uint8)
    calls = {
        "clahe_lab_fwd_lut": lambda: clahe_lab_fwd_lut(x, 3.0, (8, 8)),
        "shift_rows": lambda: shift_rows(x, meta((1, 16))),
        "resample_rows": lambda: resample_rows(x, meta((1, 16)), meta((1,)), meta((1,))),
        "photometric": lambda: photometric(x, meta((1, 10)), meta((1,), torch.int32), 2),
        "shift_rows_windowed": lambda: shift_rows_windowed(x, meta((1, 16, 16)), 11),
        "scatter_rows": lambda: scatter_rows_(x, meta((1, 16, 16, 3), torch.uint8), meta((1,), torch.int64)),
        "clahe_hist_lut": lambda: clahe_hist_lut(meta((1, 16, 16), torch.uint8), 3.0, (8, 8)),
        "clahe_apply": lambda: clahe_apply(meta((1, 16, 16), torch.uint8), meta((1, 64, 256), torch.uint8)),
    }
    with pytest.raises(ValueError, match="CUDA device"):
        calls[wrapper]()


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


def _bad_input_cases():
    """(wrapper, arguments, message) for K4, K5 and K6: a wrong dtype, a
    non-contiguous input, a shape mismatch, an axis K4 does not take, and a
    negative K6 window."""
    from mmtrs_tpu_torch.ops.kernels.photometric import photometric
    from mmtrs_tpu_torch.ops.kernels.resample import resample_rows
    from mmtrs_tpu_torch.ops.kernels.shift import shift_rows_windowed

    u8 = torch.zeros((2, 16, 8, 3), dtype=torch.uint8)
    f32 = torch.zeros((2, 16, 8, 3))
    v = torch.zeros(2)
    seeds = torch.zeros(2, dtype=torch.int32)
    return {
        "resample_dtype": (resample_rows, (f32.double(), torch.zeros((2, 16)), v, v), "contiguous"),
        "resample_noncontig": (resample_rows, (f32.transpose(1, 2), torch.zeros((2, 8)), v, v), "contiguous"),
        "resample_shape": (resample_rows, (f32, torch.zeros((2, 16)), v, v, 1), "does not fit"),
        "resample_axis": (resample_rows, (f32, torch.zeros((2, 16)), v, v, 3), "axis must be 1 or 2"),
        "photometric_dtype": (photometric, (f32, torch.zeros((2, 10)), seeds, 2), "uint8"),
        "photometric_noncontig": (photometric, (u8.transpose(1, 2), torch.zeros((2, 10)), seeds, 2), "contiguous"),
        "photometric_shape": (photometric, (u8, torch.zeros((2, 9)), seeds, 2), "does not fit"),
        "photometric_seed_dtype": (photometric, (u8, torch.zeros((2, 10)), seeds.long(), 2), "int32"),
        "windowed_dtype": (shift_rows_windowed, (u8.int(), torch.zeros((2, 16, 8)), 11), "contiguous"),
        "windowed_noncontig": (shift_rows_windowed, (u8, torch.zeros((2, 8, 16)).transpose(1, 2), 11), "contiguous"),
        "windowed_shape": (shift_rows_windowed, (u8, torch.zeros((2, 8, 16)), 11), "does not fit"),
        "windowed_negative_max_shift": (shift_rows_windowed, (u8, torch.zeros((2, 16, 8)), -1), "max_shift"),
    }


def _clahe_l_bad_input_cases():
    """(wrapper, arguments, message) for K8 and K9: a wrong dtype, a
    non-contiguous plane, a shape off the tile grid, LUTs that do not fit,
    and an output type K9 does not store."""
    from mmtrs_tpu_torch.ops.kernels.clahe import clahe_apply, clahe_hist_lut

    l = torch.zeros((2, 16, 24), dtype=torch.uint8)
    lut = torch.zeros((2, 64, 256), dtype=torch.uint8)
    return {
        "hist_lut_dtype": (clahe_hist_lut, (l.float(), 3.0, (8, 8)), "uint8"),
        "hist_lut_noncontig": (clahe_hist_lut, (torch.zeros((2, 24, 16), dtype=torch.uint8).transpose(1, 2), 3.0, (8, 8)), "contiguous"),
        "hist_lut_tiles": (clahe_hist_lut, (torch.zeros((2, 20, 24), dtype=torch.uint8), 3.0, (8, 8)), "tile grid"),
        "apply_lut_dtype": (clahe_apply, (l, lut.float()), "uint8"),
        "apply_lut_shape": (clahe_apply, (l, lut[:, :16].contiguous()), "do not fit"),
        "apply_out_dtype": (clahe_apply, (l, lut, (8, 8), torch.float16), "out_dtype"),
    }


@pytest.mark.parametrize(
    "case",
    ["hist_lut_dtype", "hist_lut_noncontig", "hist_lut_tiles", "apply_lut_dtype", "apply_lut_shape", "apply_out_dtype"],
)
def test_clahe_l_wrappers_reject_bad_inputs(case):
    fn, args, msg = _clahe_l_bad_input_cases()[case]
    with pytest.raises(ValueError, match=msg):
        fn(*args)


@pytest.mark.parametrize(
    "case",
    ["resample_dtype", "resample_noncontig", "resample_shape", "resample_axis",
     "photometric_dtype", "photometric_noncontig", "photometric_shape", "photometric_seed_dtype",
     "windowed_dtype", "windowed_noncontig", "windowed_shape", "windowed_negative_max_shift"],
)
def test_slice2_wrappers_reject_bad_inputs(case):
    fn, args, msg = _bad_input_cases()[case]
    with pytest.raises(ValueError, match=msg):
        fn(*args)


_CTYPES = {"void*": ctypes.c_void_p, "const void*": ctypes.c_void_p, "int": ctypes.c_int,
           "float": ctypes.c_float, "long long": ctypes.c_longlong}


def test_signatures_match_the_c_entry_points():
    """Every ``extern "C"`` entry point of csrc/*.cu has a ``_SIGNATURES``
    entry with one ctypes type per parameter, in order (a pointer or a
    64-bit count bound as a C int would be cut to 32 bits), and no entry
    names a function the sources lack."""
    from mmtrs_tpu_torch import _build

    found = {}
    for src in sorted(_build.CSRC.glob("*.cu")):
        text = " ".join(src.read_text().split())
        for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', text):
            found[name] = [_CTYPES[" ".join(p.split()[:-1])] for p in params.split(",")]
    assert set(found) == set(_build._SIGNATURES)
    for name, types in found.items():
        assert list(_build._SIGNATURES[name]) == types, name


def test_host_signatures_match_the_codec_entry_points():
    """Every ``extern "C"`` entry point of csrc/host/*.cpp (the codec's host
    libraries) has a ``_HOST_SIGNATURES`` entry with one ctypes type per
    parameter, in order, and no entry names a function the sources lack."""
    from mmtrs_tpu_torch import _build

    found = {}
    for src in sorted(_build.HOST_CSRC.glob("*.cpp")):
        text = " ".join(src.read_text().split())
        for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', text):
            found[name] = [_CTYPES[" ".join(p.split()[:-1])] for p in params.split(",")]
    assert set(found) == set(_build._HOST_SIGNATURES)
    for name, types in found.items():
        assert list(_build._HOST_SIGNATURES[name]) == types, name


@pytest.mark.parametrize("preset", ["none", "legacy", "ten", "simple", "randaug"])
def test_augment_batch_runs_every_preset(preset):
    """No preset raises NotImplementedError any more: each runs on its own
    host draws at u8 [3, 32, 32, 3] and keeps shape and range."""
    from mmtrs_tpu_torch.ops.augment import augment_batch, draw_batch

    x = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (3, 32, 32, 3)).astype(np.uint8))
    aug = [0, 7, 9]
    draws = draw_batch(preset, 1, [4, 5, 6], 1, 32, 32, aug_idx=aug, img_size=32)
    out = augment_batch(x, draws, preset, aug_idx=aug, img_size=32)
    assert out.shape == x.shape and float(out.min()) >= 0 and float(out.max()) <= 255
