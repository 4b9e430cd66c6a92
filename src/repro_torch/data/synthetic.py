"""Synthetic stand-ins for the paper's five LIBSVM data sets.

A copy of ``repro.data.synthetic`` (numpy only), except that the data
seed comes from ``zlib.crc32`` of the set's name instead of ``hash``,
which Python salts per process. The real a9a/mnist/ijcnn1/sensit/epsilon
sets are not fetched; these problems have the SAME dimensionality and
feature character (binary dummies for a9a, pixel-like sparse positives
for mnist, dense standardized for epsilon, ...), so every experiment runs
at the paper's shapes.

Generator: a two-class mixture with a nonlinear (quadratic) ground-truth
boundary — rich enough that an RBF SVM beats a linear one, so approximation
quality is tested on a genuinely nonlinear decision function.

Scale: `scale` < 1 shrinks n_train/n_test (NOT d — dimensionality is what
the technique's complexity depends on) so tests/benchmarks stay CPU-feasible.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Callable

import numpy as np

Array = np.ndarray


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    d: int
    n_train: int
    n_test: int
    feature_kind: str        # "binary" | "pixels" | "dense" | "standardized"
    paper_gamma: float       # the gamma the paper used (first row per set)
    paper_gamma_max: float   # the paper's reported gamma_max


# The five paper data sets (Table 1), full shapes.
DATASETS: dict[str, DatasetSpec] = {
    "a9a": DatasetSpec("a9a", 123, 32561, 16281, "binary", 0.01, 0.018),
    "mnist": DatasetSpec("mnist", 780, 60000, 10000, "pixels", 1e-4, 1e-3),
    "ijcnn1": DatasetSpec("ijcnn1", 22, 49990, 91701, "dense", 0.05, 0.064),
    "sensit": DatasetSpec("sensit", 100, 78823, 19705, "dense", 0.003, 0.0025),
    "epsilon": DatasetSpec("epsilon", 2000, 400000, 100000, "standardized", 0.35, 0.25),
}


def _features(rng: np.random.Generator, n: int, d: int, kind: str) -> Array:
    if kind == "binary":
        # a9a-like: mostly 0/1 dummies, sparse-ish.
        return (rng.random((n, d)) < 0.12).astype(np.float32)
    if kind == "pixels":
        # mnist-like: [0,1] values, ~80% zeros.
        x = rng.random((n, d)).astype(np.float32)
        mask = rng.random((n, d)) < 0.19
        return np.where(mask, x, 0.0).astype(np.float32)
    if kind == "dense":
        # ijcnn1/sensit-like: bounded dense features in [-1, 1].
        return (rng.random((n, d)).astype(np.float32) * 2.0 - 1.0) * 0.8
    if kind == "standardized":
        # epsilon-like: unit-variance gaussian, then row-normalized to unit
        # L2 norm (epsilon is distributed pre-normalized).
        x = rng.standard_normal((n, d)).astype(np.float32)
        return x / (np.linalg.norm(x, axis=1, keepdims=True) + 1e-12)
    raise ValueError(f"unknown feature kind {kind!r}")


def _quadratic_boundary(rng: np.random.Generator, d: int) -> Callable[[Array], Array]:
    """Random ground truth f*(x) = x^T A x + w^T x + c with low-rank A."""
    r = max(2, d // 16)
    U = rng.standard_normal((d, r)).astype(np.float32) / np.sqrt(d)
    s = rng.standard_normal(r).astype(np.float32)
    w = rng.standard_normal(d).astype(np.float32) / np.sqrt(d)

    def f(X: Array) -> Array:
        proj = X @ U
        return (proj * proj) @ s + X @ w

    return f


def make_dataset(
    name: str, scale: float = 1.0, seed: int = 0, label_noise: float = 0.03
) -> tuple[Array, Array, Array, Array, DatasetSpec]:
    """Returns (X_train, y_train, X_test, y_test, spec); labels in {-1,+1}."""
    spec = DATASETS[name]
    # zlib.crc32, not hash(): str hashes are salted per process, and the
    # same name and seed must give the same data in every run.
    rng = np.random.default_rng(seed + zlib.crc32(name.encode()) % 2**31)
    n_tr = max(64, int(spec.n_train * scale))
    n_te = max(64, int(spec.n_test * scale))
    X = _features(rng, n_tr + n_te, spec.d, spec.feature_kind)
    f = _quadratic_boundary(rng, spec.d)
    scores = f(X)
    y = np.where(scores > np.median(scores), 1.0, -1.0).astype(np.float32)
    flip = rng.random(y.shape) < label_noise
    y = np.where(flip, -y, y)
    return X[:n_tr], y[:n_tr], X[n_tr:], y[n_tr:], spec


def make_blobs(
    n: int, d: int, seed: int = 0, separation: float = 2.0
) -> tuple[Array, Array]:
    """Tiny two-blob task for unit tests."""
    rng = np.random.default_rng(seed)
    half = n // 2
    mu = rng.standard_normal(d).astype(np.float32)
    mu = mu / np.linalg.norm(mu) * separation / 2
    Xp = rng.standard_normal((half, d)).astype(np.float32) + mu
    Xn = rng.standard_normal((n - half, d)).astype(np.float32) - mu
    X = np.concatenate([Xp, Xn], 0)
    y = np.concatenate([np.ones(half), -np.ones(n - half)]).astype(np.float32)
    perm = rng.permutation(n)
    return X[perm], y[perm]
