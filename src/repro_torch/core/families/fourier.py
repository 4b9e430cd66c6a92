"""The ``fourier`` family — random Fourier features for the Gaussian kernel.

Rahimi & Recht's estimator: with frequencies W ~ N(0, 2 gamma I) and
phases p ~ U[0, 2 pi),

    k(x, z) = e^{-gamma ||x - z||^2}  ~  (2/F) sum_f cos(w_f.x + p_f) cos(w_f.z + p_f)

so the whole expansion collapses into per-head weight vectors at compile
time:

    weights[k, f] = (2/F) sum_i alpha_y[k, i] cos(w_f . x_i + p_f)
    f_k(z)       ~  weights[k] . cos(W z + p) + b_k

Prediction is O(F d) through kernel B4 (f32) or B5 (int8). W, the phases
and the held-out sample come from numpy's ``default_rng`` exactly as in
``repro``, so the same seed gives the same W and phase bytes in either
package. The Fastfood projection (``structured=True``) waits for kernels
B6/B7 and raises ``NotImplementedError``.

There is no per-row validity bound: the estimator's error is
probabilistic in F and uniform over the domain. The accuracy contract is
set at compile time (paper §4): a held-out sample is scored against the
exact expansion and the measured error ships in the meta
(``holdout_mean_abs_err`` / ``holdout_max_abs_err``). The engine falls
back per artifact: if the estimate misses ``err_tolerance``
(``valid_globally`` False), every row takes the exact path.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import backend
from repro_torch.core.families import quantize
from repro_torch.core.families.base import (
    CompiledArtifact,
    as_batch,
    base_meta,
    stack_heads,
)
from repro_torch.core.rbf import SVMModel
from repro_torch.kernels.common import TileConfig, tuning

NAME = "fourier"
TILE_KERNEL = "rff_score"
TILE_KERNEL_Q8 = "rff_score_q8"

DEFAULT_NUM_FEATURES = 1024
DEFAULT_HOLDOUT_N = 256

_NO_FASTFOOD = (
    "structured (Fastfood) fourier artifacts are not ported yet: they need "
    "kernels B6/B7 (ROADMAP B6/B7)"
)


def compile(  # noqa: A001
    svm: SVMModel,
    *,
    num_features: int = DEFAULT_NUM_FEATURES,
    structured: bool = False,
    dtype: str = "float32",
    seed: int = 0,
    err_tolerance: float | None = None,
    holdout=None,
    holdout_n: int = DEFAULT_HOLDOUT_N,
    **_opts,
) -> CompiledArtifact:
    """Sample features, fold the expansion into per-head weights, measure
    the held-out error, and pack the servable arrays.

    ``dtype="int8"`` quantizes the projection (per-feature-row scales)
    and the (K, F) readout (per-head scales), and the held-out error is
    then measured on the quantized artifact, so the meta describes what
    ships.
    """
    quantize.check_dtype(dtype)
    if structured:
        raise NotImplementedError(_NO_FASTFOOD)
    dev = svm.X.device
    X = svm.X.to(torch.float32)
    gamma = float(svm.gamma)
    ay2, b, k, multiclass = stack_heads(svm)
    ay2 = ay2.to(torch.float32).contiguous()
    b = b.to(torch.float32).contiguous()
    d = X.shape[1]
    rng = np.random.default_rng(seed)

    f = int(num_features)
    W = rng.normal(0.0, np.sqrt(2.0 * gamma), size=(f, d)).astype(np.float32)
    W = torch.from_numpy(W).to(dev)
    phase = rng.uniform(0.0, 2.0 * np.pi, size=(f,)).astype(np.float32)
    phase = torch.from_numpy(phase).to(dev)
    phi_x = torch.cos(X @ W.T + phase[None, :])  # (n_sv, F)
    weights = (2.0 / f) * (ay2 @ phi_x)  # (K, F)

    art = CompiledArtifact(
        family=NAME,
        arrays={"W": W, "phase": phase, "weights": weights, "b": b},
        meta=base_meta(
            d=d,
            num_heads=k,
            multiclass=multiclass,
            kind="rff",
            validity="global",
            num_features=f,
            seed=int(seed),
            projection="dense",
        ),
    )

    Zh = holdout if holdout is not None else holdout_sample(svm, seed, holdout_n)
    Zh = as_batch(Zh, dev)
    if dtype == quantize.INT8_DTYPE:
        art = quantize_rff_artifact(art, holdout=Zh)

    # §4 verification before serving: the estimator against the exact
    # expansion (kernel B2 on the card) on held-out rows; for int8, on the
    # quantized arrays that ship.
    exact = backend.rbf_scores(Zh, X.contiguous(), ay2, svm.gamma, b)
    approx, _ = score(art, Zh)
    err = (approx - exact).abs()
    mean_err = float(err.mean())
    return art.with_meta(
        holdout_n=int(Zh.shape[0]),
        holdout_mean_abs_err=mean_err,
        holdout_max_abs_err=float(err.max()),
        err_tolerance=err_tolerance,
        valid_globally=bool(err_tolerance is None or mean_err <= err_tolerance),
    )


def quantize_rff_artifact(art: CompiledArtifact, *, holdout=None) -> CompiledArtifact:
    """Int8 variant of a dense-projection RFF artifact.

    W goes int8 with one scale per feature row (folded onto its
    projection column), the readout int8 with one scale per head (the
    feature axis is the readout's contraction axis, so nothing finer can
    fold); phase and bias stay f32. The quantization error against the
    f32 parent rides in the meta when ``holdout`` is given.
    """
    if art.meta.get("projection") == "fastfood":
        raise NotImplementedError(_NO_FASTFOOD)
    a = art.arrays
    dev = a["W"].device
    w_q, w_scale = quantize.quantize_rows(a["W"])  # (F,d), (F,)
    wt_q, wt_scale = quantize.quantize_rows(a["weights"])  # (K,F), (K,)

    def on_dev(x):
        return torch.from_numpy(x).to(dev)

    q_art = CompiledArtifact(
        family=art.family,
        arrays={
            "W": on_dev(w_q),
            "W_scale": on_dev(w_scale),
            "weights": on_dev(wt_q),
            "weights_scale": on_dev(wt_scale),
            "phase": a["phase"],
            "b": a["b"],
        },
        meta={**art.meta, "dtype": quantize.INT8_DTYPE},
    )
    if holdout is not None:
        Z = as_batch(holdout, dev)
        q_art = q_art.with_meta(**quantize.measure_quant_error(art, q_art, Z))
    return q_art


def holdout_sample(svm: SVMModel, seed: int, n: int = DEFAULT_HOLDOUT_N):
    """Held-out points near the data manifold, as a numpy array: SVs plus
    per-feature-scaled Gaussian jitter, drawn from ``seed`` (the same
    bytes as ``repro``'s for the same SVs)."""
    X = svm.X.detach().cpu().numpy().astype(np.float32, copy=False)
    rng = np.random.default_rng(np.uint32(seed) ^ np.uint32(0x5EED))
    idx = rng.integers(0, X.shape[0], size=n)
    sigma = X.std(axis=0) + 1e-6
    noise = rng.standard_normal((n, X.shape[1])).astype(np.float32)
    return X[idx] + 0.5 * sigma[None, :] * noise


def score(artifact: CompiledArtifact, Z, *, config: TileConfig | None = None):
    """(scores (n, K), valid_rows (n,)).

    ``valid_rows`` is the compile-time held-out verdict broadcast over the
    batch: either every row is inside the accuracy contract or none is.
    """
    a = artifact.arrays
    if artifact.meta.get("projection") == "fastfood":
        raise NotImplementedError(_NO_FASTFOOD)
    if artifact.dtype == quantize.INT8_DTYPE:
        scores = backend.rff_score_q8(
            Z,
            a["W"],
            a["W_scale"],
            a["phase"],
            a["weights"],
            a["weights_scale"],
            a["b"],
            config=config,
        )
    else:
        scores = backend.rff_score(
            Z, a["W"], a["phase"], a["weights"], a["b"], config=config
        )
    valid = torch.full(
        (scores.shape[0],),
        bool(artifact.meta.get("valid_globally", True)),
        device=scores.device,
    )
    return scores, valid


def tile_lookup(artifact: CompiledArtifact, bucket: int) -> tuple[str, str]:
    """(kernel, shape_key) the tuning registry resolves for this bucket."""
    kernel = TILE_KERNEL_Q8 if artifact.dtype == quantize.INT8_DTYPE else TILE_KERNEL
    return kernel, tuning.shape_key(
        d=artifact.d, f=int(artifact.meta["num_features"]), n=bucket
    )
