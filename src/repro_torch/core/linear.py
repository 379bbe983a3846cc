"""Linear baseline models the paper compares against (Fig. 3): LR, Lasso, SVR.

Implemented from scratch (no sklearn in this environment):

* :class:`LinearRegression` — ordinary least squares via lstsq, with internal
  feature standardization.
* :class:`Ridge` — closed-form L2.
* :class:`Lasso` — ISTA (proximal gradient) on standardized features.
* :class:`LinearSVR` — ε-insensitive L2-regularized regression fitted by
  subgradient descent (the paper's SVR baseline; linear kernel — with 700+
  training rows an RBF dual QP is unnecessary for a *weak baseline* whose role
  is to lose to GBDT, and the paper reports it does).
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["LinearRegression", "Ridge", "Lasso", "LinearSVR"]


@dataclasses.dataclass
class _Standardizer:
    mean: np.ndarray
    std: np.ndarray

    @classmethod
    def fit(cls, X: np.ndarray) -> "_Standardizer":
        mean = X.mean(axis=0)
        std = X.std(axis=0)
        std = np.where(std < 1e-12, 1.0, std)
        return cls(mean=mean, std=std)

    def __call__(self, X: np.ndarray) -> np.ndarray:
        return (X - self.mean) / self.std


class _LinearBase:
    coef_: np.ndarray
    intercept_: float
    _std: _Standardizer

    def predict(self, X: np.ndarray) -> np.ndarray:
        Xs = self._std(np.asarray(X, dtype=np.float64))
        return Xs @ self.coef_ + self.intercept_


class LinearRegression(_LinearBase):
    def fit(self, X: np.ndarray, y: np.ndarray) -> "LinearRegression":
        X = np.asarray(X, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        self._std = _Standardizer.fit(X)
        Xs = self._std(X)
        A = np.concatenate([Xs, np.ones((Xs.shape[0], 1))], axis=1)
        w, *_ = np.linalg.lstsq(A, y, rcond=None)
        self.coef_, self.intercept_ = w[:-1], float(w[-1])
        return self


class Ridge(_LinearBase):
    def __init__(self, alpha: float = 1.0):
        self.alpha = float(alpha)

    def fit(self, X: np.ndarray, y: np.ndarray) -> "Ridge":
        X = np.asarray(X, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        self._std = _Standardizer.fit(X)
        Xs = self._std(X)
        n, d = Xs.shape
        yc = y - y.mean()
        A = Xs.T @ Xs + self.alpha * np.eye(d)
        self.coef_ = np.linalg.solve(A, Xs.T @ yc)
        self.intercept_ = float(y.mean())
        return self


class Lasso(_LinearBase):
    """L1-regularized least squares via ISTA with backtracking-free step."""

    def __init__(self, alpha: float = 0.01, max_iter: int = 2000, tol: float = 1e-8):
        self.alpha = float(alpha)
        self.max_iter = int(max_iter)
        self.tol = float(tol)

    def fit(self, X: np.ndarray, y: np.ndarray) -> "Lasso":
        X = np.asarray(X, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        self._std = _Standardizer.fit(X)
        Xs = self._std(X)
        n, d = Xs.shape
        yc = y - y.mean()
        # Lipschitz constant of ∇(1/2n)||Xw−y||²  is  σ_max(X)²/n
        L = (np.linalg.norm(Xs, 2) ** 2) / max(n, 1) + 1e-12
        w = np.zeros(d)
        thr = self.alpha / L
        for _ in range(self.max_iter):
            grad = Xs.T @ (Xs @ w - yc) / n
            w_new = w - grad / L
            w_new = np.sign(w_new) * np.maximum(np.abs(w_new) - thr, 0.0)
            if np.max(np.abs(w_new - w)) < self.tol:
                w = w_new
                break
            w = w_new
        self.coef_ = w
        self.intercept_ = float(y.mean())
        return self


class LinearSVR(_LinearBase):
    """ε-insensitive linear SVR by averaged subgradient descent."""

    def __init__(
        self,
        C: float = 1.0,
        epsilon: float = 0.05,
        max_iter: int = 3000,
        lr: float = 0.05,
        random_state: int = 0,
    ):
        self.C = float(C)
        self.epsilon = float(epsilon)
        self.max_iter = int(max_iter)
        self.lr = float(lr)
        self.random_state = random_state

    def fit(self, X: np.ndarray, y: np.ndarray) -> "LinearSVR":
        X = np.asarray(X, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        self._std = _Standardizer.fit(X)
        Xs = self._std(X)
        n, d = Xs.shape
        w = np.zeros(d)
        b = float(y.mean())
        w_avg = np.zeros(d)
        b_avg = 0.0
        for t in range(self.max_iter):
            step = self.lr / (1.0 + 0.01 * t)
            r = Xs @ w + b - y
            s = np.where(r > self.epsilon, 1.0, np.where(r < -self.epsilon, -1.0, 0.0))
            grad_w = w / (self.C * n) + (Xs.T @ s) / n
            grad_b = s.mean()
            w -= step * grad_w
            b -= step * grad_b
            w_avg += w
            b_avg += b
        self.coef_ = w_avg / self.max_iter
        self.intercept_ = float(b_avg / self.max_iter)
        return self
