"""Gaussian-process Bayesian optimization for the autotuner.

Copy of ``horovod_tpu/optim.py`` (numpy only; the port keeps its own copy:
it imports nothing of the JAX package).

Reference: horovod/common/optim/bayesian_optimization.cc (194 LoC) +
gaussian_process.cc (183 LoC) — the ParameterManager's search engine: fit a
GP (RBF kernel) to (knob, score) samples, maximize expected improvement to
pick the next knob (parameter_manager.h:42-110).

NumPy implementation: RBF kernel with jitter, Cholesky posterior, EI
maximized over a dense candidate grid (the reference uses l-bfgs over the
same acquisition; a grid is equivalent for 1-2 dimensional knob spaces).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np


class GaussianProcess:
    """GP regression with an RBF kernel (gaussian_process.cc analog)."""

    def __init__(self, length_scale: float = 1.0, signal_var: float = 1.0,
                 noise: float = 1e-4):
        self.length_scale = length_scale
        self.signal_var = signal_var
        self.noise = noise
        self._x: Optional[np.ndarray] = None

    def _kernel(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
        return self.signal_var * np.exp(-0.5 * d2 / self.length_scale ** 2)

    def fit(self, x: np.ndarray, y: np.ndarray) -> None:
        """x: [n, d] normalized inputs; y: [n] scores (standardized
        internally)."""
        self._x = np.asarray(x, float)
        y = np.asarray(y, float)
        self._y_mean = float(y.mean()) if len(y) else 0.0
        self._y_std = float(y.std()) or 1.0
        self._y = (y - self._y_mean) / self._y_std
        k = self._kernel(self._x, self._x)
        k[np.diag_indices_from(k)] += self.noise
        self._chol = np.linalg.cholesky(k)
        self._alpha = np.linalg.solve(
            self._chol.T, np.linalg.solve(self._chol, self._y))

    def predict(self, x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Posterior mean and std at x [m, d] (de-standardized)."""
        x = np.asarray(x, float)
        ks = self._kernel(x, self._x)
        mean = ks @ self._alpha
        v = np.linalg.solve(self._chol, ks.T)
        var = np.clip(self.signal_var - (v ** 2).sum(0), 1e-12, None)
        return (mean * self._y_std + self._y_mean,
                np.sqrt(var) * self._y_std)


def _norm_pdf(z):
    return np.exp(-0.5 * z * z) / math.sqrt(2 * math.pi)


def _norm_cdf(z):
    from math import erf
    return 0.5 * (1.0 + np.vectorize(erf)(z / math.sqrt(2)))


def expected_improvement(mean: np.ndarray, std: np.ndarray,
                         best: float, xi: float = 0.01) -> np.ndarray:
    """EI acquisition (bayesian_optimization.cc ExpectedImprovement)."""
    imp = mean - best - xi
    z = imp / np.where(std > 0, std, 1.0)
    ei = imp * _norm_cdf(z) + std * _norm_pdf(z)
    return np.where(std > 0, ei, 0.0)


class BayesianOptimizer:
    """Sequential maximizer over a bounded 1-D knob
    (bayesian_optimization.cc BayesianOptimization)."""

    def __init__(self, low: float, high: float, grid: int = 256):
        self.low, self.high = float(low), float(high)
        self._xs: List[float] = []
        self._ys: List[float] = []
        self._grid = np.linspace(0.0, 1.0, grid)

    def _norm(self, x: float) -> float:
        return (x - self.low) / (self.high - self.low)

    def _denorm(self, u: float) -> float:
        return self.low + u * (self.high - self.low)

    def observe(self, x: float, y: float) -> None:
        self._xs.append(self._norm(x))
        self._ys.append(y)

    def suggest(self) -> float:
        """Next knob value: a fixed space-filling start (0.5, 0.1, 0.9),
        then argmax-EI.  Fully deterministic given the observation history —
        the schedule must be replayable (rank 0 publishes it)."""
        if len(self._xs) < 3:
            # deterministic space-filling start: 0.5, 0.1, 0.9
            return self._denorm([0.5, 0.1, 0.9][len(self._xs)])
        gp = GaussianProcess(length_scale=0.2)
        gp.fit(np.asarray(self._xs)[:, None], np.asarray(self._ys))
        mean, std = gp.predict(self._grid[:, None])
        ei = expected_improvement(mean, std, best=max(self._ys))
        return self._denorm(float(self._grid[int(np.argmax(ei))]))

    def best(self) -> float:
        if not self._xs:
            return self._denorm(0.5)
        return self._denorm(self._xs[int(np.argmax(self._ys))])
