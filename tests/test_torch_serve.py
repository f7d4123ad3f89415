"""The port's serving path held against the JAX package on the CPU:
``preprocess_batch`` and ``PredictService.predict_one`` with a MIL ensemble.

The JAX side is its CPU route (``use_pallas=False``): CLAHE through the XLA
composition with float chroma, and deskew's three shears in f32 quantised
once. The port always takes the TPU main path's route: integer chroma (the
fused LAB kernels' i8 lattice) and a u8 store after each shear. The two
differ by a level or two on some pixels, which the bars below state.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tests.test_torch_models import _random_variables


def _q(a):
    return np.floor(np.clip(np.asarray(a), 0.0, 255.0) + 0.5)


def test_preprocess_batch_matches_jax():
    """[4,128,128,3] with one image rotated 30° (deskew fires): seg_valid
    equal, angles atol 1e-3°, boxes within 1 px, u8 output within 2 levels
    on ≥ 99.9 % of values and max ≤ 32 (the LUT-amplified bound of
    lab_kernels.py:41-46)."""
    from mmtrs_tpu.preprocess import preprocess_batch as jpre
    from mmtrs_tpu_torch.preprocess import preprocess_batch
    from mmtrs_tpu_torch.synth import synth_teeth

    imgs = synth_teeth(4, 128, seed=5, angles_deg=[30.0, -4.0, 2.0, 6.0])
    jout, jinfo = jpre(jnp.asarray(imgs), out_size=128)
    out, info = preprocess_batch(torch.from_numpy(imgs), out_size=128)
    assert out.shape == (4, 128, 128, 3) and out.dtype == torch.float32
    assert np.asarray(jinfo["deskew_angle"])[0] != 0.0
    np.testing.assert_array_equal(info["seg_valid"].numpy(), np.asarray(jinfo["seg_valid"]))
    np.testing.assert_allclose(info["deskew_angle"].numpy(), np.asarray(jinfo["deskew_angle"]), atol=1e-3, rtol=0)
    assert np.abs(info["boxes"].numpy() - np.asarray(jinfo["boxes"])).max() <= 1.0
    d = np.abs(_q(out.numpy()) - _q(jout))
    assert (d <= 2).mean() >= 0.999 and d.max() <= 32, ((d <= 2).mean(), d.max())


def test_preprocess_numpy_returns_u8_and_info():
    from mmtrs_tpu_torch.config import PreprocessConfig
    from mmtrs_tpu_torch.preprocess import min_edge_ok, preprocess_numpy
    from mmtrs_tpu_torch.synth import synth_teeth

    cfg = PreprocessConfig(output_size=64, do_rotate=False, do_crop=False)
    out, info = preprocess_numpy(synth_teeth(2, (96, 128), seed=1), cfg, device="cpu")
    assert out.dtype == np.uint8 and out.shape == (2, 64, 64, 3)
    assert set(info) == {"seg_valid", "deskew_angle", "boxes"}
    np.testing.assert_array_equal(info["boxes"], [[0, 16, 96, 112]] * 2)
    assert not info["seg_valid"].any()
    assert min_edge_ok((400, 900)) and not min_edge_ok((399, 900))


def _mil_pair(seed, calibrate=False):
    """(Flax MILNet, its numpy variables) for b0 / attn 128 in f32. With
    ``calibrate`` the BatchNorm statistics are set from a bag of synthetic
    teeth (the port's calibrate_batchnorm_, copied back into the Flax tree),
    so the 480² features have a trained net's scale; without it they are
    small and p barely moves with the input."""
    from mmtrs_tpu.models.mil import MILNet as FlaxMIL
    from mmtrs_tpu_torch.models.backbones.efficientnet import calibrate_batchnorm_
    from mmtrs_tpu_torch.models.convert import milnet_from_flax
    from mmtrs_tpu_torch.models.mil import MILNet, make_eval_bag
    from mmtrs_tpu_torch.synth import synth_teeth
    from mmtrs_tpu_torch.train.common import normalize_imagenet

    flax_net = FlaxMIL("efficientnet_b0", attn_dim=128, dtype=jnp.float32)
    v = _random_variables(flax_net, jnp.zeros((1, 1, 64, 64, 3)), seed=seed, train=False)
    v = jax.tree.map(np.asarray, v)
    if calibrate:
        net = MILNet("efficientnet_b0", 128, dtype=torch.float32)
        net.load_state_dict(milnet_from_flax(v))
        teeth = torch.from_numpy(synth_teeth(4, 512, seed=seed + 100))
        calibrate_batchnorm_(net.encoder, normalize_imagenet(make_eval_bag(teeth)))
        sd = net.state_dict()
        names = {"mean": "running_mean", "var": "running_var"}

        def stat(path, _):
            keys = [p.key for p in path]
            mod = ".".join(keys[:-1])
            mod = "blocks." + mod if keys[0].startswith("stage") else mod
            return sd[f"encoder.{mod}.{names[keys[-1]]}"].numpy()

        enc = next(iter(v["batch_stats"]))
        v = {"params": v["params"],
             "batch_stats": {enc: jax.tree_util.tree_map_with_path(stat, v["batch_stats"][enc])}}
    return flax_net, v


def test_predict_one_matches_jax_mil_service():
    """One 512² upload through PredictService with a 1-fold MIL ensemble from
    the same f32 parameters (converted): |Δp| ≤ 1e-4, same label. The
    parameters are uncalibrated, so the ≤ 2-level preprocessing route
    difference (test above) hardly moves p; the next test holds the model
    stream with sensitive parameters."""
    from mmtrs_tpu.serve.ensembles import MILEnsemble as JaxEnsemble
    from mmtrs_tpu.serve.service import PredictService as JaxService
    from mmtrs_tpu_torch.models.convert import milnet_from_flax
    from mmtrs_tpu_torch.models.mil import MILNet
    from mmtrs_tpu_torch.serve.ensembles import MILEnsemble
    from mmtrs_tpu_torch.serve.service import PredictService
    from mmtrs_tpu_torch.synth import synth_teeth

    flax_net, v = _mil_pair(seed=4)
    jsvc = JaxService(mil_predict=JaxEnsemble([{"variables": v}], flax_net).predict)
    ens = MILEnsemble([milnet_from_flax(v)], MILNet("efficientnet_b0", 128, dtype=torch.float32),
                      device="cpu")
    svc = PredictService(mil_predict=ens.predict, device="cpu")

    upload = synth_teeth(1, 512, seed=8)[0]
    want = jsvc.predict_one(upload)
    got = svc.predict_one(upload)
    assert abs(got["p_indirect"] - want["p_indirect"]) <= 1e-4, (got["p_indirect"], want["p_indirect"])
    assert got["label"] == want["label"] and got["threshold"] == 0.5
    assert got["processed_image"].shape == (512, 512, 3)
    low = svc.predict_one(upload[:480])
    assert "resolution" in low["error"]


def test_mil_ensemble_matches_jax_with_calibrated_weights():
    """The MIL stream on one processed image (a 1-image bag at 480²) with
    calibrated parameters, 2 folds: |Δp| ≤ 1e-4 with p away from 0 and 1."""
    from mmtrs_tpu.serve.ensembles import MILEnsemble as JaxEnsemble
    from mmtrs_tpu_torch.models.convert import milnet_from_flax
    from mmtrs_tpu_torch.models.mil import MILNet
    from mmtrs_tpu_torch.preprocess import preprocess_numpy
    from mmtrs_tpu_torch.serve.ensembles import MILEnsemble
    from mmtrs_tpu_torch.synth import synth_teeth

    pairs = [_mil_pair(seed=s, calibrate=True) for s in (4, 5)]
    flax_net = pairs[0][0]
    proc = preprocess_numpy(synth_teeth(1, 512, seed=8), device="cpu")[0][0]
    want = JaxEnsemble([{"variables": v} for _, v in pairs], flax_net).predict(proc)
    got = MILEnsemble([milnet_from_flax(v) for _, v in pairs],
                      MILNet("efficientnet_b0", 128, dtype=torch.float32), device="cpu").predict(proc)
    assert 0.01 < want < 0.99, want
    assert abs(got - want) <= 1e-4, (got, want)


def test_predict_one_stream_logic_matches_jax():
    """Tabular all-or-none contract, stream selection, stacker fusion and
    thresholds: the port's predict_one against the JAX one with the same
    stand-in streams (they ignore the pixels, so p must be equal)."""
    from mmtrs_tpu.serve.service import PredictService as JaxService
    from mmtrs_tpu.serve.choices import CHOICES_MAP
    from mmtrs_tpu_torch.serve.service import PredictService
    from mmtrs_tpu_torch.synth import synth_teeth

    class Stacker:
        thresholds = {"max_f1": 0.4, "youden": 0.7}

        def fuse(self, mm, mil, tab=None, legacy_blend=False):
            return 0.5 * (mm + mil) if tab is None else (mm + mil + tab) / 3.0

    streams = dict(mm_predict=lambda img, tab: 0.3 if tab is None else 0.6,
                   mil_predict=lambda img: 0.55, tab_predict=lambda tab: sum(tab) / 10.0)
    full = {k: list(v)[-1] for k, v in CHOICES_MAP.items()}
    upload = synth_teeth(1, 512, seed=3)[0]
    cases = [
        ({}, {}), ({"stacker": Stacker()}, {}), ({"stacker": Stacker()}, {"fields": full}),
        ({"stacker": Stacker()}, {"thr_mode": "youden"}), ({}, {"threshold": 0.9}),
        ({}, {"fields": {"depth": "> 4mm"}}),
    ]
    for ctor, call in cases:
        want = JaxService(**streams, **ctor).predict_one(upload, **call)
        got = PredictService(**streams, **ctor, device="cpu").predict_one(upload, **call)
        for k in ("label", "p_indirect", "threshold", "streams", "used_tabular", "error"):
            assert got.get(k) == want.get(k), (ctor, call, k, got.get(k), want.get(k))
    assert PredictService(device="cpu").predict_one(upload)["error"] == "no model streams available"
