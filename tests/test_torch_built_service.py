"""The port's whole service built from a weights folder serves one 520²
upload as the JAX package's does, without and with the 9 fields (split
from tests/test_torch_service_weights.py, whose folds and bars it shares,
so that this, one of the suite's longest tests, runs in a file of its own,
which ``--dist loadfile`` hands out early).
"""

from mmtrs_tpu.serve.choices import CHOICES_MAP, FIELD_ORDER
from tests.synth import synth_images
from tests.test_torch_service_weights import BF16_BAR, TAB_BAR, weights_dir  # noqa: F401 (a fixture)


def test_service_from_weights_matches_jax(weights_dir):
    """One 520² upload, without and with all 9 fields: the same streams,
    each image stream's p within BF16_BAR and Tab's within TAB_BAR, the
    same thresholds, and the same label where p is farther than BF16_BAR
    from the threshold."""
    from mmtrs_tpu.serve.ensembles import build_service_from_weights as jbuild
    from mmtrs_tpu_torch.serve.ensembles import build_service_from_weights

    jsvc, svc = jbuild(weights_dir), build_service_from_weights(weights_dir, device="cpu")
    assert svc.stacker is not None and svc.tab_predict is not None
    assert len(svc.mm_predict.__self__.nets) == len(svc.mil_predict.__self__.nets) == 2
    for mode in ("max_f1", "max_acc"):
        assert svc.stacker.thresholds[mode] == jsvc.stacker.thresholds[mode]
    assert abs(svc.stacker.thresholds["youden"] - jsvc.stacker.thresholds["youden"]) <= 1e-6

    img = synth_images(1, 520, seed=77)[0]
    fields = {k: list(CHOICES_MAP[k])[0] for k in FIELD_ORDER}
    for call, streams in (({}, {"prob_mm", "prob_mil"}),
                          ({"fields": fields, "thr_mode": "max_acc"}, {"prob_mm", "prob_mil", "prob_tab"})):
        want, got = jsvc.predict_one(img, **call), svc.predict_one(img, **call)
        assert set(got["streams"]) == set(want["streams"]) == streams
        for k, p in got["streams"].items():
            bar = TAB_BAR if k == "prob_tab" else BF16_BAR
            assert abs(p - want["streams"][k]) <= bar, (k, p, want["streams"][k])
        assert abs(got["p_indirect"] - want["p_indirect"]) <= BF16_BAR
        assert got["threshold"] == want["threshold"] and got["used_tabular"] == want["used_tabular"]
        if abs(want["p_indirect"] - want["threshold"]) > BF16_BAR:
            assert got["label"] == want["label"]
        assert got["processed_image"].shape == (512, 512, 3)
