"""Statistics (utils/statistics/): empirical distributions, streaming moments, PCA."""

from __future__ import annotations

import math

import numpy as np


class EmpiricalDistribution:
    """Discrete distribution sampling (utils/statistics/EmpiricalDistribution.java)."""

    def __init__(self, weights, rng=None):
        w = np.asarray(weights, dtype=float)
        if w.sum() <= 0:
            raise ValueError("empty distribution")
        self.p = w / w.sum()
        self.cdf = np.cumsum(self.p)
        self.rng = rng or np.random.default_rng()

    def draw(self) -> int:
        u = self.rng.random()
        return int(np.searchsorted(self.cdf, u))

    def mean(self) -> float:
        return float((np.arange(len(self.p)) * self.p).sum())


def poisson_pmf(mu: float, n: int) -> np.ndarray:
    """First n Poisson probabilities (SimulateHaploidChild.poisson)."""
    out = np.zeros(n)
    for k in range(n):
        out[k] = math.exp(-mu) * mu ** k / math.factorial(k)
    return out


class StatisticsOnStream:
    """Running count/mean/variance (Welford), StatisticsOnStream.java parity."""

    def __init__(self):
        self.n = 0
        self._mean = 0.0
        self._m2 = 0.0

    def push(self, x: float) -> None:
        self.n += 1
        d = x - self._mean
        self._mean += d / self.n
        self._m2 += d * (x - self._mean)

    # Java-style aliases
    def getNumObservations(self):
        return self.n

    def mean(self) -> float:
        return self._mean if self.n else 0.0

    def variance(self) -> float:
        return self._m2 / (self.n - 1) if self.n > 1 else 0.0

    def stdev(self) -> float:
        return math.sqrt(self.variance())


class PCA:
    """Principal component analysis over a samples x features matrix
    (utils/statistics/PCA.java, colt-based in the reference; SVD here)."""

    def __init__(self, matrix, row_names=None, col_names=None):
        x = np.asarray(matrix, dtype=float)
        self.mean = x.mean(axis=0)
        xc = x - self.mean
        u, s, vt = np.linalg.svd(xc, full_matrices=False)
        self.components = vt              # [k, features]
        self.singular_values = s
        self.scores = u * s               # [samples, k]
        n = max(1, x.shape[0] - 1)
        var = (s ** 2) / n
        self.explained_variance_ratio = var / var.sum() if var.sum() else var
        self.row_names = row_names
        self.col_names = col_names

    def transform(self, x) -> np.ndarray:
        return (np.asarray(x, dtype=float) - self.mean) @ self.components.T


def n50(lengths) -> int:
    """N50 of a length collection (SequenceUtils.java:352-421)."""
    ls = sorted((int(x) for x in lengths), reverse=True)
    total = sum(ls)
    acc = 0
    for l in ls:
        acc += l
        if 2 * acc >= total:
            return l
    return 0


def ng50(lengths, genome_size: int) -> int:
    ls = sorted((int(x) for x in lengths), reverse=True)
    acc = 0
    for l in ls:
        acc += l
        if 2 * acc >= genome_size:
            return l
    return 0
