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

Every sum of the sweep (squared distances over features, centre sums and
SSE over rows) runs in one fixed pairwise order built from elementwise
adds (:func:`_ordered_sum`), so a card and the CPU give the same bits:
a reduction kernel or a cuBLAS product would sum in an order of its own
(and a product would read the global TF32 switch), and a label that flips
at a near-tie changes every cold-start neighbour downstream.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device

__all__ = ["KMeans", "elbow_sse", "choose_k_elbow"]


def _ordered_sum(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over ``dim`` in a fixed pairwise order, the same on every device:
    zero-pad to a power of two, then add the upper half onto the lower
    half until one slice is left. Only elementwise adds, so the bits do not
    depend on a reduction kernel's or a GEMM's order."""
    t = t.movedim(dim, 0)
    n = t.shape[0]
    size = 1 << max(n - 1, 0).bit_length()
    if size != n:
        t = torch.cat([t, t.new_zeros((size - n,) + tuple(t.shape[1:]))])
    while t.shape[0] > 1:
        half = t.shape[0] // 2
        t = t[:half] + t[half:]
    return t[0]


def _lloyd_step(X: torch.Tensor, centers: torch.Tensor, k: int):
    diff = X[:, None, :] - centers[None, :, :]
    d2 = _ordered_sum(diff * diff, -1)                           # (n, k)
    assign = torch.argmin(d2, dim=1)
    one_hot = torch.nn.functional.one_hot(assign, k).to(X.dtype)  # (n, k)
    counts = one_hot.sum(dim=0)                   # (k,), exact integers
    sums = _ordered_sum(one_hot[:, :, None] * X[:, None, :], 0)  # (k, d)
    new_centers = sums / torch.clamp(counts, min=1.0)[:, None]
    # keep empty clusters where they were
    new_centers = torch.where(counts[:, None] > 0, new_centers, centers)
    sse = _ordered_sum(d2.min(dim=1).values, 0)
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
