"""In-process prediction service — the serving core behind the UI (port of
mmtrs_tpu/serve/service.py: ``serve_bucket_shape``, ``PredictService``).

Models load once at startup (app.py:110-155); preprocessing runs in process
on the compute device; each stream is an optional callable; with no stacker
the result is the mean of the streams present (``predict_one``'s graceful
degradation). ``Stacker`` (stack_meta.py:39-57) is the LR meta over the
streams' out-of-fold probabilities, fitted at startup from rows of the
``csv`` module (``read_oof_csv``): ``meta2`` on (MM, MIL), its thresholds,
and ``meta3`` on (Tab, MM, MIL) when a tab file is given; ``fuse`` blends
0.5·meta2 + 0.5·Tab instead with ``legacy_blend`` (the shipped UI's rule).

The service runs on the card unless it is given ``device="cpu"``. An upload
is resized to its bucket shape on that device with ``resize_bilinear_u8``,
which computes Pillow's BILINEAR resize (what the JAX service calls on the
host) bit for bit, so serving needs no Pillow.
"""

from __future__ import annotations

import csv
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from mmtrs_tpu_torch.config import PreprocessConfig
from mmtrs_tpu_torch.device import resolve_device
from mmtrs_tpu_torch.metrics.thresholds import choose_threshold
from mmtrs_tpu_torch.models.linear import LogisticRegression
from mmtrs_tpu_torch.ops.resize import resize_bilinear_u8
from mmtrs_tpu_torch.preprocess import preprocess_u8
from mmtrs_tpu_torch.serve.choices import encode_fields, validate_all_or_none


def read_oof_csv(path: str | Path) -> list[dict[str, str]]:
    """Rows of an out-of-fold CSV (image_name, y, prob), as the csv module
    reads them."""
    with open(path, newline="") as fh:
        return list(csv.DictReader(fh))


def _merge(left: list[dict], right: list[dict], prob: str) -> list[dict]:
    """Inner join on (image_name, y) with ``right``'s ``prob`` renamed
    ``prob``, in pandas ``merge``'s order: each left row in turn, with its
    matches in right's order. ``y`` is compared as a number (one file may
    write 1.0, another 1)."""
    key = lambda r: (r["image_name"], float(r["y"]))
    matches: dict = {}
    for r in right:
        matches.setdefault(key(r), []).append(r["prob"])
    return [{**l, prob: p} for l in left for p in matches.get(key(l), [])]


def _columns(rows: list[dict], names: tuple[str, ...]) -> tuple[np.ndarray, np.ndarray]:
    X = np.array([[float(r[n]) for n in names] for r in rows], dtype=np.float64)
    y = np.array([int(float(r["y"])) for r in rows], dtype=np.int64)
    return X, y


@dataclass
class Stacker:
    """LR meta over stream probabilities (stack_meta.py parity)."""

    meta2: LogisticRegression | None = None  # (mm, mil)
    meta3: LogisticRegression | None = None  # (tab, mm, mil)
    thresholds: dict = field(default_factory=dict)

    @staticmethod
    def fit(oof_mm: list[dict], oof_mil: list[dict], oof_tab: list[dict] | None = None,
            device: str | torch.device | None = None) -> "Stacker":
        """Rows of each stream's OOF CSV (``read_oof_csv``); the Newton fits
        run on ``device`` (None: the card)."""
        st = Stacker()
        m = _merge([{**r, "prob_mm": r["prob"]} for r in oof_mm], oof_mil, "prob_mil")
        X, y = _columns(m, ("prob_mm", "prob_mil"))
        st.meta2 = LogisticRegression(penalty="l2", max_iter=1000).fit(X, y, device=device)
        p2 = st.meta2.predict_proba(X)[:, 1]
        st.thresholds = {
            mode: choose_threshold(y, p2, mode) for mode in ("max_f1", "max_acc", "youden")
        }
        if oof_tab is not None:
            m3 = _merge(m, oof_tab, "prob_tab")
            X3, y3 = _columns(m3, ("prob_tab", "prob_mm", "prob_mil"))
            st.meta3 = LogisticRegression(penalty="l2", max_iter=1000).fit(X3, y3, device=device)
        return st

    def fuse(self, prob_mm: float, prob_mil: float,
             prob_tab: float | None = None, legacy_blend: bool = False) -> float:
        p_img = float(
            self.meta2.predict_proba(np.array([[prob_mm, prob_mil]]))[:, 1][0]
        )
        if prob_tab is None:
            return p_img
        if legacy_blend or self.meta3 is None:
            return 0.5 * p_img + 0.5 * prob_tab  # shipped UI behaviour
        return float(
            self.meta3.predict_proba(np.array([[prob_tab, prob_mm, prob_mil]]))[:, 1][0]
        )


def serve_bucket_shape(h: int, w: int, min_edge: int = 512,
                       max_edge: int = 1024, grain: int = 16) -> tuple[int, int]:
    """Canonical working shape for an upload: aspect-preserving scale so the
    min edge is ``min_edge`` (long edge capped at ``max_edge``), then each dim
    snapped to the nearest multiple of ``grain`` (≤1% aspect distortion).
    Kept from the JAX service so both serve the same pixels; it also keeps
    every working shape divisible by the 8×8 CLAHE tile grid."""
    s = min_edge / min(h, w)
    hs, ws = h * s, w * s
    if max(hs, ws) > max_edge:
        s *= max_edge / max(hs, ws)
        hs, ws = h * s, w * s
    snap = lambda v: max(grain, int(round(v / grain)) * grain)
    return snap(hs), snap(ws)


class PredictService:
    """End-to-end case prediction: preprocess → streams → stack → label."""

    def __init__(
        self,
        mm_predict=None,       # callable(img, tab9 or None) -> prob
        mil_predict=None,      # callable(img) -> prob
        tab_predict=None,      # callable(tab9) -> prob
        stacker: Stacker | None = None,
        preprocess_cfg: PreprocessConfig = PreprocessConfig(),
        min_resolution: int = 512,
        legacy_blend: bool = False,
        bucket_shapes: bool = True,
        device: str | torch.device | None = None,  # None: the card
    ):
        self.mm_predict = mm_predict
        self.mil_predict = mil_predict
        self.tab_predict = tab_predict
        self.stacker = stacker
        self.cfg = preprocess_cfg
        self.min_resolution = min_resolution
        self.legacy_blend = legacy_blend
        self.bucket_shapes = bucket_shapes
        self.device = resolve_device(device)

    # -- pipeline ------------------------------------------------------------

    def preprocess(self, image: np.ndarray | torch.Tensor) -> np.ndarray:
        """One upload, a host array or a tensor (an upload the codec decoded
        on the card stays there) → u8 [512, 512, 3] numpy."""
        x = image if isinstance(image, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(image))
        x = x.to(self.device)
        if self.bucket_shapes:
            h, w = image.shape[:2]
            bh, bw = serve_bucket_shape(h, w)
            if (h, w) != (bh, bw):
                x = resize_bilinear_u8(x.to(torch.uint8), (bh, bw))
        out, _ = preprocess_u8(x[None], self.cfg)
        return out[0].cpu().numpy()

    def predict_one(
        self,
        image: np.ndarray | torch.Tensor,
        fields: dict[str, str | None] | None = None,
        thr_mode: str = "max_f1",
        threshold: float | None = None,
    ) -> dict:
        # resolution gate ≥512 (app.py:272-274 / utils.py:20-24)
        if min(image.shape[:2]) < self.min_resolution:
            return {
                "error": f"image resolution too low "
                         f"(min edge {min(image.shape[:2])} < {self.min_resolution})"
            }
        # all-or-none tabular contract (app.py:298-318)
        fields = fields or {}
        use_tab, missing = validate_all_or_none(fields)
        if missing:
            return {"error": f"provide all tabular fields or none; missing: {missing}"}

        proc = self.preprocess(image)

        streams: dict[str, float] = {}
        tab_vec = encode_fields(fields) if use_tab else None
        if self.mm_predict is not None:
            streams["prob_mm"] = float(self.mm_predict(proc, tab_vec))
        if self.mil_predict is not None:
            streams["prob_mil"] = float(self.mil_predict(proc))
        if use_tab and self.tab_predict is not None:
            streams["prob_tab"] = float(self.tab_predict(tab_vec))

        if not streams:
            return {"error": "no model streams available"}

        if self.stacker is not None and "prob_mm" in streams and "prob_mil" in streams:
            p = self.stacker.fuse(
                streams["prob_mm"], streams["prob_mil"],
                streams.get("prob_tab"), legacy_blend=self.legacy_blend,
            )
            thr = (
                threshold
                if threshold is not None
                else self.stacker.thresholds.get(thr_mode, 0.5)
            )
        else:  # graceful degradation: mean of whatever is available
            p = float(np.mean(list(streams.values())))
            thr = threshold if threshold is not None else 0.5

        return {
            "label": "Indirect" if p >= thr else "Direct",
            "p_indirect": float(p),
            "threshold": float(thr),
            "thr_mode": thr_mode,
            "streams": streams,
            "used_tabular": use_tab,
            "processed_image": proc,
        }
