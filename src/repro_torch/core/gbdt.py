"""From-scratch gradient-boosted regression trees (CatBoost-role model).

The paper selects CatBoost for both the power and the time model. CatBoost's
distinguishing mechanics are (a) *oblivious* (symmetric) decision trees — the
same (feature, threshold) split is applied at every node of a given depth
level — and (b) *ordered target statistics* for categorical features. Both are
implemented here from scratch (no sklearn/catboost in this environment).

Oblivious trees have a bonus property: a depth-``d`` tree is fully described
by ``d`` (feature, threshold) pairs plus ``2**d`` leaf values, so inference is
``leaf = Σ_l (x[f_l] > t_l) << l`` followed by a table lookup — a
branch-free gather/compare pattern that the CUDA kernel behind
:func:`repro_torch.kernels.ops.gbdt_predict` evaluates on the card.

Fitting is vectorized numpy fp64 on the host, exactly as in the reference
(training data here is O(10^3)×O(10^2) — apps × clock-pairs × features — so
histogram split search is instantaneous and the fitted trees are
array-equal to the reference's). :meth:`GBDTModel.predict` runs on the
model's device through the kernel wrapper.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device
from ..kernels import ops

__all__ = [
    "GBDTParams",
    "GBDTModel",
    "fit_gbdt",
    "OrderedTargetEncoder",
]


@dataclasses.dataclass(frozen=True)
class GBDTParams:
    """Hyperparameters (names mirror CatBoost's; Table III of the paper)."""

    iterations: int = 400
    depth: int = 4
    learning_rate: float = 0.1
    l2_leaf_reg: float = 3.0
    n_bins: int = 32
    subsample: float = 1.0
    random_state: int = 0
    min_child_samples: int = 1


@dataclasses.dataclass(eq=False)
class GBDTModel:
    """A fitted ensemble of oblivious regression trees.

    Attributes:
      base: scalar prior (mean of the training target).
      feats: (n_trees, depth) int32 — feature index used at each depth level.
      thresholds: (n_trees, depth) float64 — split threshold at each level.
      leaves: (n_trees, 2**depth) float64 — leaf values (already scaled by lr).
      split_gain: (n_features,) float64 — accumulated split gain per feature,
        the basis of the feature-importance score (paper Fig. 4).
      params: training hyperparameters.
      device: where :meth:`predict` runs; the ensemble tables are copied
        there once, at construction.
    """

    base: float
    feats: np.ndarray
    thresholds: np.ndarray
    leaves: np.ndarray
    split_gain: np.ndarray
    params: GBDTParams
    feature_names: Optional[Sequence[str]] = None
    device: "str | torch.device" = DEFAULT_DEVICE

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.feats = np.ascontiguousarray(self.feats, dtype=np.int32)
        self.thresholds = np.ascontiguousarray(self.thresholds,
                                               dtype=np.float64)
        self.leaves = np.ascontiguousarray(self.leaves, dtype=np.float64)
        n_feat = len(self.split_gain)
        if self.feats.size and (self.feats.min() < 0
                                or self.feats.max() >= n_feat):
            raise ValueError(f"feature indices outside [0, {n_feat})")
        self._tables = tuple(
            torch.from_numpy(a).to(self.device)
            for a in (self.feats, self.thresholds, self.leaves))

    def device_tables(self) -> tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
        """``(feats int32, thresholds fp64, leaves fp64)`` on the device."""
        return self._tables

    # ------------------------------------------------------------------ #
    def predict(self, X: np.ndarray) -> np.ndarray:
        """Ensemble prediction on the model's device (the CUDA kernel on a
        card, its plain version on the CPU). X: (n, n_features) → (n,)."""
        return ops.gbdt_predict_model(self, X)

    # ------------------------------------------------------------------ #
    def feature_importance(self, normalize: bool = True) -> np.ndarray:
        """Split-gain importance (loss-change attribution per feature).

        The paper defines F.I. as the change in loss with vs. without a
        feature; split gain is the standard (and far cheaper) first-order
        attribution of exactly that quantity: the total squared-error
        reduction credited to splits on the feature.
        """
        imp = self.split_gain.copy()
        if normalize and imp.sum() > 0:
            imp = imp / imp.sum()
        return imp

    def staged_rmse(self, X: np.ndarray, y: np.ndarray) -> np.ndarray:
        """RMSE after each boosting stage (for iteration-count
        diagnostics): host numpy fp64, the reference's formula, so the
        stages equal the reference's bit for bit. (n_trees,)"""
        X = np.asarray(X, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        depth = self.feats.shape[1]
        bits = X[:, self.feats] > self.thresholds[None, :, :]
        leaf_idx = bits @ (1 << np.arange(depth)).astype(np.int64)
        contrib = np.take_along_axis(
            self.leaves[None, :, :].repeat(X.shape[0], axis=0),
            leaf_idx[:, :, None], axis=2)[..., 0]          # (n, n_trees)
        err = self.base + np.cumsum(contrib, axis=1) - y[:, None]
        return np.sqrt(np.mean(err ** 2, axis=0))


# ---------------------------------------------------------------------- #
#  Categorical handling: ordered target statistics (CatBoost's mechanism)
# ---------------------------------------------------------------------- #
class OrderedTargetEncoder:
    """Encode categorical columns with ordered target statistics.

    For a random permutation σ of the training rows, category value ``c`` at
    row ``i`` is replaced by ``(Σ_{j: σ(j)<σ(i), x_j=c} y_j + a·p) / (n_c + a)``
    where ``p`` is the global target mean — i.e. the running mean of the target
    over *earlier* rows only, which avoids target leakage. At inference time
    the full-training-set statistics are used.
    """

    def __init__(self, prior_weight: float = 1.0, random_state: int = 0):
        self.prior_weight = float(prior_weight)
        self.random_state = random_state
        self.maps_: list[dict] = []
        self.prior_: float = 0.0
        self.cat_cols_: tuple[int, ...] = ()

    def fit_transform(
        self, X: np.ndarray, y: np.ndarray, cat_cols: Sequence[int]
    ) -> np.ndarray:
        X = np.asarray(X, dtype=np.float64).copy()
        y = np.asarray(y, dtype=np.float64)
        rng = np.random.default_rng(self.random_state)
        n = X.shape[0]
        perm = rng.permutation(n)
        self.prior_ = float(y.mean()) if n else 0.0
        self.cat_cols_ = tuple(int(c) for c in cat_cols)
        self.maps_ = []
        a, p = self.prior_weight, self.prior_
        for col in self.cat_cols_:
            vals = X[perm, col]
            ys = y[perm]
            running_sum: dict = {}
            running_cnt: dict = {}
            enc = np.empty(n, dtype=np.float64)
            for k in range(n):
                c = vals[k]
                s = running_sum.get(c, 0.0)
                m = running_cnt.get(c, 0)
                enc[k] = (s + a * p) / (m + a)
                running_sum[c] = s + ys[k]
                running_cnt[c] = m + 1
            X[perm, col] = enc
            # full-data statistics for inference
            full: dict = {}
            for c in np.unique(vals):
                mask = vals == c
                full[c] = (ys[mask].sum() + a * p) / (mask.sum() + a)
            self.maps_.append(full)
        return X

    def transform(self, X: np.ndarray) -> np.ndarray:
        X = np.asarray(X, dtype=np.float64).copy()
        a, p = self.prior_weight, self.prior_
        for col, full in zip(self.cat_cols_, self.maps_):
            col_vals = X[:, col]
            enc = np.full(col_vals.shape, p, dtype=np.float64)
            for c, v in full.items():
                enc[col_vals == c] = v
            X[:, col] = enc
        return X


# ---------------------------------------------------------------------- #
#  Training
# ---------------------------------------------------------------------- #
def _quantile_bins(X: np.ndarray, n_bins: int) -> list[np.ndarray]:
    """Per-feature candidate thresholds from quantiles (unique-safe)."""
    edges = []
    qs = np.linspace(0.0, 1.0, n_bins + 1)[1:-1]
    for f in range(X.shape[1]):
        col = X[:, f]
        cand = np.unique(np.quantile(col, qs))
        # drop degenerate thresholds (nothing strictly above)
        cand = cand[(cand > col.min()) & (cand < col.max())] if cand.size else cand
        edges.append(cand.astype(np.float64))
    return edges


def fit_gbdt(
    X: np.ndarray,
    y: np.ndarray,
    params: GBDTParams = GBDTParams(),
    feature_names: Optional[Sequence[str]] = None,
    sample_weight: Optional[np.ndarray] = None,
    device: "str | torch.device" = DEFAULT_DEVICE,
) -> GBDTModel:
    """Fit a squared-loss GBDT of oblivious trees.

    Split search per tree level: with rows currently assigned to leaves
    ``l ∈ [0, 2^level)``, a candidate (feature, threshold) is scored by the
    *total* gain of applying that same split to every leaf simultaneously
    (the oblivious-tree constraint):

        gain = Σ_l [ G_{l,L}²/(n_{l,L}+λ) + G_{l,R}²/(n_{l,R}+λ) − G_l²/(n_l+λ) ]

    with G the residual sums. This is a 2D (leaf × bin) histogram reduction,
    fully vectorized. The fit runs on the host; the fitted model predicts
    on ``device``.
    """
    device = resolve_device(device)
    X = np.asarray(X, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    n, n_feat = X.shape
    p = params
    rng = np.random.default_rng(p.random_state)
    w = np.ones(n) if sample_weight is None else np.asarray(sample_weight, np.float64)

    edges = _quantile_bins(X, p.n_bins)
    lam = p.l2_leaf_reg

    # Pre-bin every feature once (bins never change across trees/levels).
    nb_max = max((e.size for e in edges), default=0)
    W = nb_max + 1                                   # histogram width / feature
    B = np.zeros((n, n_feat), dtype=np.int64)        # bin index per (row, feat)
    n_cand = np.zeros(n_feat, dtype=np.int64)
    cand_pad = np.zeros((n_feat, max(nb_max, 1)), dtype=np.float64)
    for f in range(n_feat):
        c = edges[f]
        n_cand[f] = c.size
        if c.size:
            B[:, f] = np.searchsorted(c, X[:, f], side="left")
            cand_pad[f, : c.size] = c
    # valid-candidate mask (f, nb_max): True where a threshold exists
    cand_valid = np.arange(max(nb_max, 1))[None, :] < n_cand[:, None]

    base = float(np.average(y, weights=w)) if n else 0.0
    F = np.full(n, base)
    n_leaves = 1 << p.depth

    feats = np.zeros((p.iterations, p.depth), dtype=np.int32)
    thresholds = np.zeros((p.iterations, p.depth), dtype=np.float64)
    leaves = np.zeros((p.iterations, n_leaves), dtype=np.float64)
    split_gain = np.zeros(n_feat, dtype=np.float64)

    for m in range(p.iterations):
        if p.subsample < 1.0:
            mask = rng.random(n) < p.subsample
            if not mask.any():
                mask[rng.integers(n)] = True
        else:
            mask = np.ones(n, dtype=bool)
        g = (y - F) * w  # residuals (negative gradient of ½MSE), weighted
        gw = w.copy()
        g_m, w_m, X_m = g[mask], gw[mask], X[mask]
        B_m = B[mask]

        leaf_idx = np.zeros(X_m.shape[0], dtype=np.int64)
        tree_feats = np.zeros(p.depth, dtype=np.int32)
        tree_thr = np.zeros(p.depth, dtype=np.float64)

        for level in range(p.depth):
            if nb_max == 0:  # every feature constant — null tree
                tree_feats[level] = 0
                tree_thr[level] = np.inf
                continue
            n_cur = 1 << level
            # parent scores
            G_parent = np.bincount(leaf_idx, weights=g_m, minlength=n_cur)
            N_parent = np.bincount(leaf_idx, weights=w_m, minlength=n_cur)
            parent_score = np.sum(G_parent ** 2 / (N_parent + lam))
            # one histogram over (feature, leaf, bin) — vectorized split search
            feat_off = np.arange(n_feat, dtype=np.int64) * (n_cur * W)
            flat = (feat_off[None, :] + leaf_idx[:, None] * W + B_m).ravel()
            size = n_feat * n_cur * W
            G = np.bincount(
                flat,
                weights=np.broadcast_to(g_m[:, None], B_m.shape).ravel(),
                minlength=size,
            ).reshape(n_feat, n_cur, W)
            N = np.bincount(
                flat,
                weights=np.broadcast_to(w_m[:, None], B_m.shape).ravel(),
                minlength=size,
            ).reshape(n_feat, n_cur, W)
            # threshold k ⇒ LEFT = bins ≤ k (x ≤ t), RIGHT = x > t.
            # Empty sides are harmless: G = 0 when N = 0 ⇒ score term 0.
            G_left = np.cumsum(G, axis=2)[:, :, :-1]       # (F, n_cur, nb_max)
            N_left = np.cumsum(N, axis=2)[:, :, :-1]
            G_right = G_parent[None, :, None] - G_left
            N_right = N_parent[None, :, None] - N_left
            score = G_left ** 2 / (N_left + lam) + G_right ** 2 / (N_right + lam)
            tot = score.sum(axis=1)                        # (F, nb_max)
            tot = np.where(cand_valid, tot, -np.inf)
            f = -1
            gain = 0.0
            t = np.inf
            if np.isfinite(tot).any():
                fi, k = np.unravel_index(int(np.argmax(tot)), tot.shape)
                gain = float(tot[fi, k] - parent_score)
                if gain > 1e-12:
                    f, t = int(fi), float(cand_pad[fi, k])
            if f < 0:
                # no valid split — degenerate level (repeat a null split)
                tree_feats[level] = 0
                tree_thr[level] = np.inf  # bit always 0
            else:
                tree_feats[level] = f
                tree_thr[level] = t
                split_gain[f] += max(gain, 0.0)
                leaf_idx = leaf_idx + ((X_m[:, f] > t).astype(np.int64) << level)

        # leaf values with L2 regularization
        G = np.bincount(leaf_idx, weights=g_m, minlength=n_leaves)
        N = np.bincount(leaf_idx, weights=w_m, minlength=n_leaves)
        leaf_vals = G / (N + lam)

        feats[m] = tree_feats
        thresholds[m] = tree_thr
        leaves[m] = p.learning_rate * leaf_vals

        # update F on *all* rows
        bits = X[:, tree_feats] > tree_thr[None, :]
        idx_all = bits @ (1 << np.arange(p.depth)).astype(np.int64)
        F = F + leaves[m][idx_all]

    return GBDTModel(
        base=base,
        feats=feats,
        thresholds=thresholds,
        leaves=leaves,
        split_gain=split_gain,
        params=p,
        feature_names=feature_names,
        device=device,
    )
