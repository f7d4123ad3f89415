"""Histogram gradient-boosted decision trees (port of mmtrs_tpu/models/gbdt.py:
``BinSpec``, ``fit_bins``, ``apply_bins``, ``Forest``, ``train_gbdt``,
``predict_raw``, ``predict_proba``, ``consensus_sample_weights``).

A forest is rectangular: every tree has ``2^depth − 1`` split slots and
``2^depth`` leaves (the learning rate folded in). A row is quantised with
``searchsorted(edges, x, side="right")`` per feature (bin 0 for a feature
with no edges), then walked down all trees at once: one gather per level
over [trees, rows]. The sum of the leaves is taken in one f32 reduction,
where the JAX package adds the trees one after another in a scan, so the
two round differently (tests/test_torch_tab.py states the bar). Forests are
npz + json files, the JAX package's own format; their arrays are uploaded
to the device once, at load.

Fitting is the JAX package's level-wise growth, in f32, one tree after
another on the device (JAX scans the trees in one compiled program). Each
level's gradient and hessian histograms per (node, feature, bin) are sums
over segments of a stable sort: the (feature, node, bin) key of every
(row, feature) pair is sorted, rows keep their order within a key, and
``torch.segment_reduce`` adds each segment in that order, one thread a
segment. No float is added by atomics, so every run on a card grows the
same forest, and the order is the one in which the JAX package's
``segment_sum`` adds on the CPU. A row's prediction takes its leaf by a
gather ``leaf[node]``: with ``reg_lambda`` 0 a leaf that no row reaches
is 0/0 = NaN, which a one-hot product would spread to every row. The
per-tree validation losses stay on the device and are read once, after
the last tree. Row and column subsampling come from :class:`GBDTDraws`,
drawn from a ``torch.Generator`` (not the JAX package's ``jax.random``
bits; ``GBDTDraws.from_numpy`` takes those).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from mmtrs_tpu_torch.config import GBDTConfig
from mmtrs_tpu_torch.device import resolve_device


@dataclass(frozen=True)
class BinSpec:
    """Per-feature bin edges; bin index = searchsorted(edges, x, 'right')."""

    edges: tuple[np.ndarray, ...]  # each [n_edges_f] float32


def fit_bins(X: np.ndarray, max_bins: int = 64) -> BinSpec:
    """Per feature: the midpoints of its distinct finite values when there
    are at most ``max_bins`` of them, else its distinct quantiles at
    ``max_bins − 1`` inner levels; no edges for a constant feature (host
    numpy, the JAX package's code)."""
    X = np.asarray(X, dtype=np.float32)
    edges = []
    for f in range(X.shape[1]):
        col = X[:, f]
        col = col[np.isfinite(col)]
        uniq = np.unique(col)
        if uniq.size <= 1:
            edges.append(np.empty(0, dtype=np.float32))
            continue
        if uniq.size <= max_bins:
            cuts = (uniq[:-1] + uniq[1:]) / 2.0
        else:
            qs = np.quantile(col, np.linspace(0, 1, max_bins + 1)[1:-1])
            cuts = np.unique(qs)
        edges.append(cuts.astype(np.float32))
    return BinSpec(tuple(edges))


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


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


@dataclass
class GBDTDraws:
    """The random part of a fit: per tree the columns it may split on and
    the rows it sees."""

    col_keep: torch.Tensor  # [T, F] bool, at least one True a tree
    row_keep: torch.Tensor | None  # [T, n] float32 0/1; None: every row

    @staticmethod
    def draw(cfg: GBDTConfig, n: int, n_feat: int, generator: torch.Generator | None = None) -> "GBDTDraws":
        """Uniforms from ``generator`` (default: a CPU generator seeded with
        ``cfg.seed``): a row is kept where its draw is below
        ``cfg.subsample``, a column where below ``cfg.colsample``; each
        tree's first kept column (column 0 when none is) is kept, as the
        JAX package guarantees one."""
        g = generator if generator is not None else torch.Generator().manual_seed(cfg.seed)
        T = cfg.n_estimators
        row = (torch.rand((T, n), generator=g) < cfg.subsample).float() if cfg.subsample < 1.0 else None
        if cfg.colsample < 1.0:
            col = torch.rand((T, n_feat), generator=g) < cfg.colsample
        else:
            col = torch.ones((T, n_feat), dtype=torch.bool)
        col[torch.arange(T), col.to(torch.uint8).argmax(1)] = True
        return GBDTDraws(col, row)

    @staticmethod
    def from_numpy(col_keep: np.ndarray, row_keep: np.ndarray | None = None) -> "GBDTDraws":
        """Masks made elsewhere (the tests feed in the JAX package's)."""
        return GBDTDraws(torch.from_numpy(np.array(col_keep, dtype=bool)),
                         None if row_keep is None else torch.from_numpy(np.array(row_keep, np.float32)))


def _effective_depth(cfg: GBDTConfig) -> int:
    if cfg.max_depth and cfg.max_depth > 0:
        return int(cfg.max_depth)
    # leaf-wise recipes (num_leaves): nearest power-of-two depth
    return max(1, int(np.ceil(np.log2(max(cfg.num_leaves, 2)))))


def _soft(g: torch.Tensor, alpha: float) -> torch.Tensor:
    return torch.sign(g) * torch.clamp_min(torch.abs(g) - alpha, 0.0)


def _segment_sums(keys: torch.Tensor, values: torch.Tensor, n_segments: int) -> torch.Tensor:
    """Per segment 0..n_segments−1 the sum of the ``values`` rows [m, c]
    whose key is that segment, added in row order by one thread each
    (a stable sort and ``segment_reduce``; no atomics)."""
    sk, perm = torch.sort(keys, stable=True)
    bounds = torch.searchsorted(sk, torch.arange(n_segments + 1, device=keys.device))
    return torch.segment_reduce(values[perm], "sum", lengths=bounds.diff(), unsafe=True)


def _walk(sf: torch.Tensor, sb: torch.Tensor, bins: torch.Tensor, depth: int) -> torch.Tensor:
    """Each row's leaf under one tree."""
    node = torch.zeros(bins.shape[0], dtype=torch.int64, device=bins.device)
    for level in range(depth):
        at = node + (2**level - 1)
        fbin = bins.gather(1, sf[at][:, None])[:, 0]
        node = node * 2 + (fbin > sb[at])
    return node


def train_gbdt(
    X_train: np.ndarray,
    y_train: np.ndarray,
    cfg: GBDTConfig,
    sample_weight: np.ndarray | None = None,
    X_val: np.ndarray | None = None,
    y_val: np.ndarray | None = None,
    max_bins: int | None = None,
    draws: GBDTDraws | None = None,
    device: str | torch.device | None = None,
) -> Forest:
    """Fit a forest on ``device`` (None: the card). With a validation set,
    ``n_trees_used`` is the best-loss prefix when early stopping is on (all
    trees still grow); else all trees are used. ``draws``: the subsampling
    (default ``GBDTDraws.draw(cfg, ...)``)."""
    from mmtrs_tpu_torch.train.common import host_to_device

    dev = resolve_device(device)
    spec = fit_bins(X_train, max_bins or cfg.max_bins)
    table, counts = _edge_table(spec.edges, dev)
    to_dev = lambda a: host_to_device(np.asarray(a), dev)  # pinned: no wait for the card
    Xb = _bin_rows(to_dev(np.asarray(X_train, np.float32)), table, counts)
    y = to_dev(np.asarray(y_train, dtype=np.float32))
    n, n_feat = Xb.shape
    B = int(cfg.max_bins if max_bins is None else max_bins)

    w = np.ones(n, dtype=np.float32) if sample_weight is None else np.asarray(sample_weight, dtype=np.float32)
    w = to_dev(w / max(w.mean(), 1e-12))

    has_val = X_val is not None and y_val is not None
    if has_val:
        Xb_val = _bin_rows(to_dev(np.asarray(X_val, np.float32)), table, counts)
        yv = to_dev(np.asarray(y_val, dtype=np.float32))
    else:  # a one-row stand-in, as the JAX package's static scan has
        Xb_val, yv = Xb[:1], y[:1]

    depth = _effective_depth(cfg)
    n_nodes, n_leaves = 2**depth - 1, 2**depth
    if cfg.objective == "binary_logistic":
        p0 = float(np.clip(np.average(np.asarray(y_train)), 1e-6, 1 - 1e-6))
        base = float(np.log(p0 / (1 - p0)))
    elif cfg.objective == "soft_regression":
        base = float(np.average(np.asarray(y_train)))
    else:
        raise ValueError(cfg.objective)
    mono = torch.tensor(cfg.monotone_constraints or (0,) * n_feat, dtype=torch.float32, device=dev)[:n_feat]
    mono = mono[None, :, None]
    lr, lam, alpha, gamma, mcw = cfg.learning_rate, cfg.reg_lambda, cfg.reg_alpha, cfg.gamma, cfg.min_child_weight

    T = cfg.n_estimators
    draws = draws if draws is not None else GBDTDraws.draw(cfg, n, n_feat)
    if draws.col_keep.shape != (T, n_feat) or (draws.row_keep is not None and draws.row_keep.shape != (T, n)):
        raise ValueError(f"draws do not fit {T} trees over {n} rows and {n_feat} features")
    col_keep = to_dev(draws.col_keep.numpy())
    row_keep = None if draws.row_keep is None else to_dev(draws.row_keep.numpy())
    feat = torch.arange(n_feat, device=dev)
    score = lambda G, H: _soft(G, alpha) ** 2 / (H + lam)
    leaf_w = lambda G, H: -_soft(G, alpha) / (H + lam)

    def grow_tree(gh: torch.Tensor, col: torch.Tensor):
        node = torch.zeros(n, dtype=torch.int64, device=dev)
        split_feat = torch.zeros(n_nodes, dtype=torch.int64, device=dev)
        split_bin = torch.full((n_nodes,), B - 1, dtype=torch.int64, device=dev)
        gh_rows = gh.repeat(n_feat, 1)  # [F·n, 2], feature-major as the keys
        for level in range(depth):
            n_level = 2**level
            K = n_level * B
            keys = ((node[None, :] * B + Xb.T) + feat[:, None] * K).reshape(-1)  # [F·n]
            hist = _segment_sums(keys, gh_rows, n_feat * K).reshape(n_feat, n_level, B, 2)
            HG, HH = hist[..., 0].transpose(0, 1), hist[..., 1].transpose(0, 1)  # [n_level, F, B]
            GL, HL = torch.cumsum(HG, dim=-1), torch.cumsum(HH, dim=-1)
            G, H = GL[..., -1:], HL[..., -1:]
            GR, HR = G - GL, H - HL
            gain = 0.5 * (score(GL, HL) + score(GR, HR) - score(G, H)) - gamma
            valid = (HL >= mcw) & (HR >= mcw) & col[None, :, None]
            wL, wR = leaf_w(GL, HL), leaf_w(GR, HR)
            mono_ok = torch.where(mono > 0, wL <= wR, torch.where(mono < 0, wL >= wR, True))
            gain = torch.where(valid & mono_ok, gain, -torch.inf)
            gain[..., B - 1] = -torch.inf  # never split on the last bin (empty right child)
            flat = gain.reshape(n_level, -1)
            best = torch.argmax(flat, dim=-1)
            do_split = flat.gather(1, best[:, None])[:, 0] > 0.0
            bf = torch.where(do_split, best // B, 0)
            bb = torch.where(do_split, best % B, B - 1)  # all-left when not splitting
            split_feat[n_level - 1 : 2 * n_level - 1] = bf
            split_bin[n_level - 1 : 2 * n_level - 1] = bb
            fbin = Xb.gather(1, bf[node][:, None])[:, 0]
            node = node * 2 + (fbin > bb[node])
        leaf_gh = _segment_sums(node, gh, n_leaves)
        den = leaf_gh[:, 1] + lam
        # a leaf no training row reaches has LH + λ = 0 (at reg_lambda 0,
        # stack_tab_like's): its value is 0, where the JAX package's is 0/0
        leaf = torch.where(den == 0, 0.0, -lr * _soft(leaf_gh[:, 0], alpha) / den)
        return split_feat, split_bin, leaf, node

    SF = torch.empty((T, n_nodes), dtype=torch.int64, device=dev)
    SB = torch.empty((T, n_nodes), dtype=torch.int64, device=dev)
    LV = torch.empty((T, n_leaves), dtype=torch.float32, device=dev)
    VL = torch.empty(T, dtype=torch.float32, device=dev)
    pred_tr = torch.full((n,), base, dtype=torch.float32, device=dev)
    pred_va = torch.full((Xb_val.shape[0],), base, dtype=torch.float32, device=dev)
    for t in range(T):
        if cfg.objective == "binary_logistic":
            p = torch.sigmoid(pred_tr)
            g, h = p - y, p * (1.0 - p)
        else:
            g, h = pred_tr - y, torch.ones_like(pred_tr)
        sw = w if row_keep is None else w * row_keep[t]
        SF[t], SB[t], LV[t], node_tr = grow_tree(torch.stack([g * sw, h * sw], dim=1), col_keep[t])
        pred_tr = pred_tr + LV[t][node_tr]
        pred_va = pred_va + LV[t][_walk(SF[t], SB[t], Xb_val, depth)]
        if cfg.objective == "binary_logistic":
            VL[t] = torch.mean(torch.logaddexp(torch.zeros_like(pred_va), pred_va) - yv * pred_va)
        else:
            VL[t] = torch.mean((pred_va - yv) ** 2)

    vl = VL.cpu().numpy()  # the one read of the fit
    n_used = int(np.argmin(vl)) + 1 if has_val and cfg.early_stopping_rounds else T
    return Forest(split_feat=SF, split_bin=SB, leaf_value=LV, depth=depth, base_score=base,
                  n_trees_used=n_used, objective=cfg.objective, bin_edges=spec.edges,
                  val_history=vl if has_val else None)


def consensus_sample_weights(weight: np.ndarray, y: np.ndarray, consensus_power: float,
                             class_balanced: bool) -> np.ndarray:
    """w^p × balanced class weights, mean-normalised (xgboost_model.py:131-135)."""
    w = np.power(np.clip(np.asarray(weight, dtype=np.float64), 0, None), consensus_power)
    if class_balanced:
        y = np.asarray(y).astype(int)
        n = y.size
        for cls in (0, 1):
            m = y == cls
            if m.any():
                w[m] *= n / (2.0 * m.sum())
    return (w / max(w.mean(), 1e-12)).astype(np.float32)
