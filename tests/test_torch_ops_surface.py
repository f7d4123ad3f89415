"""The public surface the JAX package exports, in the port: the gather
warps and mask_to_box against JAX's on the CPU, the profiler's trace and
annotate, the subpackages' re-exports and the config helpers."""

import importlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
# |port - JAX| over f32 images in [0, 255]: both sample the same four
# neighbours with the same f32 formula, but XLA contracts the unrolled
# transform's multiply-adds, so a source coordinate differs by an ulp or so
# (~1e-5 px at these sizes) and a sample by up to that times the image's
# gradient (~255 levels a pixel): read at most 2.2e-3 over 40 random batches
# of rotations, scales, shears and perspectives, both borders
WARP_TOL = 5e-3


def _matrices(kind: str, B: int, H: int, W: int, seed: int) -> np.ndarray:
    """Forward maps [B, 3, 3] about the image centre: rotation, anisotropic
    scale, shear and (``perspective``) a projective row."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(B):
        a = np.deg2rad(rng.uniform(-40, 40))
        sx, sy = rng.uniform(0.7, 1.4, 2)
        sh = rng.uniform(-0.3, 0.3)
        c = np.array([[1, 0, W / 2], [0, 1, H / 2], [0, 0, 1]])
        ci = np.array([[1, 0, -W / 2], [0, 1, -H / 2], [0, 0, 1]])
        rot = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]])
        m = c @ rot @ np.array([[sx, sh, 0], [0, sy, 0], [0, 0, 1]]) @ ci
        m[:2, 2] += rng.uniform(-5, 5, 2)
        if kind == "perspective":
            m[2, :2] = rng.uniform(-2e-3, 2e-3, 2)
        out.append(m)
    return np.asarray(out, np.float32)


@pytest.mark.parametrize("kind", ["affine", "perspective"])
@pytest.mark.parametrize("border", ["replicate", "constant"])
@pytest.mark.parametrize("out_hw", [None, (29, 41)])
def test_warps_equal_jax(kind, border, out_hw):
    import jax.numpy as jnp

    from mmtrs_tpu.ops.warp import warp_affine as jwarp
    from mmtrs_tpu_torch.ops import warp_affine, warp_perspective

    B, H, W = 3, 37, 45
    imgs = np.random.default_rng(1).uniform(0, 255, (B, H, W, 3)).astype(np.float32)
    mats = _matrices(kind, B, H, W, seed=2)
    want = np.asarray(jwarp(jnp.asarray(imgs), jnp.asarray(mats), out_hw, border, 17.0, kind == "perspective"))
    t, m = torch.from_numpy(imgs), torch.from_numpy(mats)
    if kind == "perspective":
        got = warp_perspective(t, m, out_hw, border, 17.0, device="cpu")
    else:
        got = warp_affine(t, m[:, :2], out_hw, border, 17.0)
    assert got.shape == want.shape and got.device.type == "cpu"
    err = np.abs(got.numpy() - want).max()
    assert err <= WARP_TOL, err


def test_sample_bilinear_equals_jax():
    import jax.numpy as jnp

    from mmtrs_tpu.ops.warp import sample_bilinear as jsample
    from mmtrs_tpu_torch.ops.warp import sample_bilinear

    rng = np.random.default_rng(3)
    img = rng.uniform(0, 255, (11, 13, 2)).astype(np.float32)
    ys, xs = rng.uniform(-3, 14, (2, 7, 5)).astype(np.float32)
    for border in ("replicate", "constant"):
        want = np.asarray(jsample(jnp.asarray(img), jnp.asarray(ys), jnp.asarray(xs), border, 5.0))
        got = sample_bilinear(torch.from_numpy(img), torch.from_numpy(ys), torch.from_numpy(xs), border, 5.0)
        assert np.abs(got.numpy() - want).max() <= WARP_TOL


@pytest.mark.parametrize("case", ["box", "row", "empty", "full"])
def test_mask_to_box_equals_jax(case):
    import jax.numpy as jnp

    from mmtrs_tpu.ops.resize import mask_to_box as jbox
    from mmtrs_tpu_torch.ops.resize import mask_to_box

    m = np.zeros((17, 23), bool)
    if case == "box":
        m[3:9, 5:20] = True
        m[12, 2] = True
    elif case == "row":
        m[16] = True
    elif case == "full":
        m[:] = True
    got = mask_to_box(torch.from_numpy(m))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jbox(jnp.asarray(m))))


def test_trace_writes_a_chrome_trace_holding_the_annotation(tmp_path):
    from mmtrs_tpu_torch.utils.profiling import annotate, trace

    with trace(tmp_path / "trace"):
        with annotate("surface_region"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    (out,) = list((tmp_path / "trace").glob("trace_*.json"))
    events = json.loads(out.read_text())["traceEvents"]
    assert any(e.get("name") == "surface_region" for e in events)


# JAX name → the port's, where they differ
RENAMED = {"engineer_features_jax": "engineer_features", "key_for_origin": "generator_for_origin",
           "split_keys": "generators_for_batch"}


@pytest.mark.parametrize("pkg", ["ops", "data", "metrics", "fusion", "utils"])
def test_every_jax_export_has_a_counterpart(pkg):
    """Each name in the JAX subpackage's __all__ (renamed as RENAMED says)
    is in the port's __all__ and resolves."""
    jax_all = importlib.import_module(f"mmtrs_tpu.{pkg}").__all__
    port = importlib.import_module(f"mmtrs_tpu_torch.{pkg}")
    assert sorted(RENAMED.get(n, n) for n in jax_all) == sorted(port.__all__)
    for name in port.__all__:
        assert getattr(port, name) is not None


def test_subpackages_import_without_matplotlib_or_cycles():
    """Each subpackage imports first in a fresh interpreter, without
    matplotlib, JAX or the JAX package."""
    for pkg in ("ops", "data", "metrics", "fusion", "utils"):
        code = (f"import sys, mmtrs_tpu_torch.{pkg}\n"
                "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('matplotlib', 'jax', 'mmtrs_tpu', 'PIL'))\n"
                "print(','.join(bad))\n")
        res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
        assert res.returncode == 0 and res.stdout.strip() == "", (pkg, res.stderr[-500:], res.stdout)


@pytest.mark.parametrize("name", ["Paths", "AugmentConfig", "SplitConfig", "PreprocessConfig", "MILConfig"])
def test_config_json_round_trip_equals_jax(name):
    """config_to_json and config_from_dict give the JAX package's text and
    objects."""
    import mmtrs_tpu.config as orig
    import mmtrs_tpu_torch.config as port

    text = port.config_to_json(getattr(port, name)())
    assert text == orig.config_to_json(getattr(orig, name)())
    back = port.config_from_dict(getattr(port, name), json.loads(text))
    assert port.config_to_json(back) == text


def test_io_load_json_and_copy_with_new_name(tmp_path):
    from mmtrs_tpu_torch.utils.io import copy_with_new_name, load_json, save_json

    p = save_json({"a": np.int64(3), "b": [1.5]}, tmp_path / "x.json")
    assert load_json(p) == {"a": 3, "b": [1.5]}
    dst = copy_with_new_name(p, tmp_path / "sub", "y.json")
    assert dst == tmp_path / "sub" / "y.json" and load_json(dst) == load_json(p)
