"""Histogram gradient-boosted decision trees, inference (port of
mmtrs_tpu/models/gbdt.py: ``BinSpec``, ``apply_bins``, ``Forest``,
``predict_raw``, ``predict_proba``).

A forest is rectangular: every tree has ``2^depth − 1`` split slots and
``2^depth`` leaves (the learning rate folded in). A row is quantised with
``searchsorted(edges, x, side="right")`` per feature (bin 0 for a feature
with no edges), then walked down all trees at once: one gather per level
over [trees, rows]. The sum of the leaves is taken in one f32 reduction,
where the JAX package adds the trees one after another in a scan, so the
two round differently (tests/test_torch_tab.py states the bar). Forests are
npz + json files, the JAX package's own format; their arrays are uploaded
to the device once, at load. Fitting (``train_gbdt``) comes with the
tabular training slice.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from mmtrs_tpu_torch.device import resolve_device


@dataclass(frozen=True)
class BinSpec:
    """Per-feature bin edges; bin index = searchsorted(edges, x, 'right')."""

    edges: tuple[np.ndarray, ...]  # each [n_edges_f] float32


def _edge_table(edges, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Edges as one [F, E] f32 table padded with +inf, and each feature's
    count of edges [F]."""
    counts = [len(e) for e in edges]
    table = np.full((len(edges), max(counts + [1])), np.inf, np.float32)
    for f, e in enumerate(edges):
        table[f, : len(e)] = e
    return (torch.from_numpy(table).to(device),
            torch.tensor(counts, dtype=torch.int64, device=device))


def _bin_rows(X: torch.Tensor, table: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    # the +inf padding is counted only for x = +inf (or NaN): cap at the
    # feature's own edge count, which is what searchsorted gives there
    b = torch.searchsorted(table, X.T.contiguous(), right=True)  # [F, N]
    return torch.minimum(b, counts[:, None]).T


def apply_bins(X, spec: BinSpec) -> torch.Tensor:
    """[N, F] features → [N, F] int64 bin indices, on X's device."""
    X = torch.as_tensor(X, dtype=torch.float32)
    return _bin_rows(X, *_edge_table(spec.edges, X.device))


@dataclass
class Forest:
    """Rectangular forest arrays on one device. n_nodes = 2^depth − 1."""

    split_feat: torch.Tensor  # [T, n_nodes] int64
    split_bin: torch.Tensor  # [T, n_nodes] int64 (go left iff bin <= split_bin)
    leaf_value: torch.Tensor  # [T, 2^depth] float32
    depth: int
    base_score: float
    n_trees_used: int
    objective: str
    bin_edges: tuple[np.ndarray, ...]
    val_history: np.ndarray | None = None
    _edges: torch.Tensor = field(init=False, repr=False)
    _n_edges: torch.Tensor = field(init=False, repr=False)

    def __post_init__(self):
        self._edges, self._n_edges = _edge_table(self.bin_edges, self.split_feat.device)

    def to(self, device: str | torch.device) -> "Forest":
        """This forest with its arrays on ``device`` (itself when they lie there)."""
        dev = torch.device(device)
        if self.split_feat.device == dev:
            return self
        return dataclasses.replace(self, split_feat=self.split_feat.to(dev),
                                   split_bin=self.split_bin.to(dev), leaf_value=self.leaf_value.to(dev))

    def save(self, path: str | Path) -> Path:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        np.savez(
            path.with_suffix(".npz"),
            split_feat=self.split_feat.cpu().to(torch.int32).numpy(),
            split_bin=self.split_bin.cpu().to(torch.int32).numpy(),
            leaf_value=self.leaf_value.cpu().numpy(),
            val_history=(
                self.val_history if self.val_history is not None else np.empty(0)
            ),
            **{f"edges_{i}": e for i, e in enumerate(self.bin_edges)},
        )
        meta = {
            "depth": self.depth,
            "base_score": self.base_score,
            "n_trees_used": self.n_trees_used,
            "objective": self.objective,
            "n_features": len(self.bin_edges),
        }
        path.with_suffix(".json").write_text(json.dumps(meta, indent=2))
        return path.with_suffix(".npz")

    @staticmethod
    def load(path: str | Path, device: str | torch.device | None = None) -> "Forest":
        """Read ``<path>.npz`` + ``<path>.json`` onto ``device`` (None: the card)."""
        dev = resolve_device(device)
        path = Path(path)
        meta = json.loads(path.with_suffix(".json").read_text())
        with np.load(path.with_suffix(".npz")) as z:
            arrays = {k: z[k] for k in z.files}
        up = lambda a, dt: torch.from_numpy(a).to(device=dev, dtype=dt)
        vh = arrays["val_history"]
        return Forest(
            split_feat=up(arrays["split_feat"], torch.int64),
            split_bin=up(arrays["split_bin"], torch.int64),
            leaf_value=up(arrays["leaf_value"], torch.float32),
            depth=meta["depth"],
            base_score=meta["base_score"],
            n_trees_used=meta["n_trees_used"],
            objective=meta["objective"],
            bin_edges=tuple(arrays[f"edges_{i}"] for i in range(meta["n_features"])),
            val_history=vh if vh.size else None,
        )


def predict_raw(forest: Forest, X) -> torch.Tensor:
    """[N, F] features → [N] f32 raw scores (base + the used trees' leaves),
    on the forest's device."""
    X = torch.as_tensor(X, dtype=torch.float32, device=forest.split_feat.device)
    bins = _bin_rows(X, forest._edges, forest._n_edges)
    T = forest.n_trees_used
    sf, sb, lv = forest.split_feat[:T], forest.split_bin[:T], forest.leaf_value[:T]
    rows = torch.arange(bins.shape[0], device=bins.device)
    node = torch.zeros((T, bins.shape[0]), dtype=torch.int64, device=bins.device)
    for level in range(forest.depth):
        at = node + (2**level - 1)
        fbin = bins[rows, sf.gather(1, at)]  # [T, N]
        node = node * 2 + (fbin > sb.gather(1, at))
    return lv.gather(1, node).sum(dim=0) + forest.base_score


def predict_proba(forest: Forest, X) -> torch.Tensor:
    raw = predict_raw(forest, X)
    if forest.objective == "binary_logistic":
        return 1.0 / (1.0 + torch.exp(-raw))
    # soft regression clipped to [0, 1] (lightgbm_model.py:37-49)
    return torch.clamp(raw, 0.0, 1.0)
