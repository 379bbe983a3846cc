"""Application correlation via clustering (paper §III-D, Table IV).

A *new* application arrives with profiling data from a single default-clock
execution only. We (1) predict its K-means cluster from that profile, then
(2) pick, within the cluster, the exhaustively-profiled application with the
lowest absolute default-clock execution-time difference, and use *that*
application's multi-frequency training rows for prediction — exactly the
paper's heuristic.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import DEFAULT_DEVICE
from .features import FEATURE_NAMES
from .kmeans import KMeans, choose_k_elbow

__all__ = ["CorrelationIndex"]

_TIME_IDX = FEATURE_NAMES.index("time_default_log")


@dataclasses.dataclass
class CorrelationIndex:
    """Cluster index over the exhaustively-profiled application corpus."""

    k: int | None = 5            # paper found k = 5; None → elbow-choose
    random_state: int = 0
    device: "str | torch.device" = DEFAULT_DEVICE   # the Lloyd sweep's

    names_: list[str] = dataclasses.field(default_factory=list)
    features_: np.ndarray | None = None
    labels_: np.ndarray | None = None
    kmeans_: KMeans | None = None

    def fit(self, names: list[str], features: np.ndarray) -> "CorrelationIndex":
        assert len(names) == features.shape[0]
        self.names_ = list(names)
        self.features_ = np.asarray(features, dtype=np.float64)
        k = self.k or choose_k_elbow(self.features_,
                                     k_max=min(8, len(names)),
                                     random_state=self.random_state,
                                     device=self.device)
        k = min(k, len(names))
        self.kmeans_ = KMeans(k=k, random_state=self.random_state,
                              device=self.device).fit(self.features_)
        self.labels_ = self.kmeans_.labels_
        return self

    # ------------------------------------------------------------------ #
    def correlated(self, feature_vec: np.ndarray, exclude: str | None = None) -> str:
        """Most time-similar same-cluster profiled app (paper's heuristic).

        ``exclude`` supports the robustness evaluation where the query app is
        itself part of the corpus (paper Table IV lists each app's correlate
        ≠ itself unless the cluster is a singleton).
        """
        f = np.asarray(feature_vec, dtype=np.float64)
        label = int(self.kmeans_.predict(f[None, :])[0])
        t_query = f[_TIME_IDX]
        best_name, best_dt = None, np.inf
        for name, lab, feat in zip(self.names_, self.labels_, self.features_):
            if name == exclude or lab != label:
                continue
            dt = abs(feat[_TIME_IDX] - t_query)
            if dt < best_dt:
                best_name, best_dt = name, dt
        if best_name is None:
            # singleton cluster (paper's 2MM case: correlate = itself), or
            # excluded-everything: fall back to nearest by time overall
            for name, feat in zip(self.names_, self.features_):
                if name == exclude and len(self.names_) > 1:
                    continue
                dt = abs(feat[_TIME_IDX] - t_query)
                if dt < best_dt:
                    best_name, best_dt = name, dt
        return best_name

    def table(self) -> list[tuple[str, int, str]]:
        """(app, cluster label, correlated app) rows — paper Table IV."""
        rows = []
        for name, feat in zip(self.names_, self.features_):
            lab = int(self.kmeans_.predict(feat[None, :])[0])
            corr = self.correlated(feat, exclude=name)
            # singleton cluster → correlate is itself (paper's 2MM row)
            cluster_members = [n for n, l in zip(self.names_, self.labels_)
                               if l == lab]
            if cluster_members == [name]:
                corr = name
            rows.append((name, lab, corr))
        return rows
