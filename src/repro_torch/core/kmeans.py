"""K-means (k-means++ init, Lloyd iterations) for application correlation.

The paper (§III-D, Table IV) clusters exhaustively-profiled applications with
K-means (k = 5 chosen by the weighted-SSE elbow) so a *new* application —
profiled at the default clock only — can borrow the multi-frequency profile of
its most time-similar cluster mate.

The Lloyd sweep is torch in **float32**, on ``device``: the reference's
jitted sweep runs without JAX's x64 mode, so its inputs silently become
float32 there, and matching labels and SSE needs the same precision. The
k-means++ init and :meth:`KMeans.predict` stay float64 numpy on the host, as
in the reference. Data sizes are tiny (apps × features): this is for
fidelity, not throughput.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device

__all__ = ["KMeans", "elbow_sse", "choose_k_elbow"]


def _lloyd_step(X: torch.Tensor, centers: torch.Tensor, k: int):
    d2 = ((X[:, None, :] - centers[None, :, :]) ** 2).sum(dim=-1)
    assign = torch.argmin(d2, dim=1)
    one_hot = torch.nn.functional.one_hot(assign, k).to(X.dtype)  # (n, k)
    counts = one_hot.sum(dim=0)                                  # (k,)
    sums = one_hot.T @ X                                         # (k, d)
    new_centers = sums / torch.clamp(counts, min=1.0)[:, None]
    # keep empty clusters where they were
    new_centers = torch.where(counts[:, None] > 0, new_centers, centers)
    sse = d2.min(dim=1).values.sum()
    return new_centers, assign, sse


@dataclasses.dataclass
class KMeans:
    k: int
    n_iter: int = 100
    tol: float = 1e-9
    random_state: int = 0
    device: "str | torch.device" = DEFAULT_DEVICE

    centers_: np.ndarray | None = None
    labels_: np.ndarray | None = None
    sse_: float = np.inf
    _mean: np.ndarray | None = None
    _std: np.ndarray | None = None

    def __post_init__(self):
        self.device = resolve_device(self.device)

    # ------------------------------------------------------------------ #
    def _kpp_init(self, X: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        n = X.shape[0]
        centers = [X[rng.integers(n)]]
        for _ in range(1, self.k):
            d2 = np.min(
                ((X[:, None, :] - np.stack(centers)[None, :, :]) ** 2).sum(-1),
                axis=1,
            )
            tot = d2.sum()
            if tot <= 0:
                centers.append(X[rng.integers(n)])
                continue
            probs = d2 / tot
            centers.append(X[rng.choice(n, p=probs)])
        return np.stack(centers)

    def fit(self, X: np.ndarray) -> "KMeans":
        X = np.asarray(X, dtype=np.float64)
        self._mean = X.mean(axis=0)
        std = X.std(axis=0)
        self._std = np.where(std < 1e-12, 1.0, std)
        Xs = (X - self._mean) / self._std
        rng = np.random.default_rng(self.random_state)
        f32 = dict(dtype=torch.float32, device=self.device)
        centers = torch.as_tensor(self._kpp_init(Xs, rng), **f32)
        Xt = torch.as_tensor(Xs, **f32)
        prev = np.inf
        for _ in range(self.n_iter):
            centers, assign, sse = _lloyd_step(Xt, centers, self.k)
            sse = float(sse)
            if abs(prev - sse) < self.tol:
                break
            prev = sse
        self.centers_ = centers.cpu().numpy()          # float32, as the
        self.labels_ = assign.cpu().numpy()            # reference keeps it
        self.sse_ = sse
        return self

    def predict(self, X: np.ndarray) -> np.ndarray:
        X = np.asarray(X, dtype=np.float64)
        Xs = (X - self._mean) / self._std
        d2 = ((Xs[:, None, :] - self.centers_[None, :, :]) ** 2).sum(-1)
        return np.argmin(d2, axis=1)


def elbow_sse(X: np.ndarray, ks, random_state: int = 0,
              device: "str | torch.device" = DEFAULT_DEVICE
              ) -> dict[int, float]:
    """Weighted-SSE per k (the paper's elbow criterion for k = 5)."""
    out = {}
    for k in ks:
        km = KMeans(k=k, random_state=random_state, device=device).fit(X)
        out[int(k)] = float(km.sse_)
    return out


def choose_k_elbow(X: np.ndarray, k_max: int = 8, random_state: int = 0,
                   device: "str | torch.device" = DEFAULT_DEVICE) -> int:
    """Pick k at the maximum-curvature point of the SSE curve."""
    ks = list(range(1, min(k_max, len(X)) + 1))
    sse = elbow_sse(X, ks, random_state, device=device)
    vals = np.array([sse[k] for k in ks])
    if len(ks) <= 2:
        return ks[-1]
    # "knee" = k where the decrease before it dwarfs the decrease after it
    drops = np.maximum(vals[:-1] - vals[1:], 0.0)          # drop going k → k+1
    eps = 1e-9 * (vals[0] + 1.0)
    ratios = drops[:-1] / (drops[1:] + eps)                # at interior k
    return ks[int(np.argmax(ratios)) + 1]
