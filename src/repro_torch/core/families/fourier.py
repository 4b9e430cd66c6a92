"""The ``fourier`` family — random Fourier features for the Gaussian kernel.

Rahimi & Recht's estimator: with frequencies W ~ N(0, 2 gamma I) and
phases p ~ U[0, 2 pi),

    k(x, z) = e^{-gamma ||x - z||^2}  ~  (2/F) sum_f cos(w_f.x + p_f) cos(w_f.z + p_f)

so the whole expansion collapses into per-head weight vectors at compile
time:

    weights[k, f] = (2/F) sum_i alpha_y[k, i] cos(w_f . x_i + p_f)
    f_k(z)       ~  weights[k] . cos(W z + p) + b_k

Prediction is O(F d) through kernel B4 (f32) or B5 (int8), or O(F log d)
with ``structured=True``, the Fastfood construction (Le et al. 2013),
through kernel B6 (f32) or B7 (int8): W is never materialized; each stack
of d' = 2^ceil(log2 d) features is S H G Pi H B with diagonal B (signs),
G (Gaussian), scaling S and a permutation Pi, applied by the
Walsh-Hadamard transform. W, the Fastfood operators, the phases and the
held-out sample come from numpy's ``default_rng`` exactly as in
``repro``, so the same seed gives the same bytes in either package.

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
    PAD_HEAD_BIAS,
    CompiledArtifact,
    as_batch,
    base_meta,
    pad_rows,
    placed,
    stack_heads,
)
from repro_torch.core.rbf import SVMModel
from repro_torch.kernels.common import TileConfig, tuning
from repro_torch.kernels.fwht.ref import fastfood_project

NAME = "fourier"
TILE_KERNEL = "rff_score"
TILE_KERNEL_Q8 = "rff_score_q8"
TILE_KERNEL_FF = "fwht"
TILE_KERNEL_FF_Q8 = "fwht_q8"

DEFAULT_NUM_FEATURES = 1024
DEFAULT_HOLDOUT_N = 256


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

    ``structured=True`` rounds ``num_features`` up to a whole number of
    Fastfood stacks (each d' wide). ``dtype="int8"`` quantizes the big
    operands (dense: the projection, per-feature-row scales; structured:
    the G/S diagonals, per-stack scales, with lossless narrowing of the
    signs, the permutation and the phase; both: the (K, F) readout,
    per-head scales), and the held-out error is then measured on the
    quantized artifact, so the meta describes what ships.
    """
    quantize.check_dtype(dtype)
    dev = svm.X.device
    X = svm.X.to(torch.float32)
    gamma = float(svm.gamma)
    ay2, b, k, multiclass = stack_heads(svm)
    ay2 = ay2.to(torch.float32).contiguous()
    b = b.to(torch.float32).contiguous()
    d = X.shape[1]
    rng = np.random.default_rng(seed)

    if structured:
        arrays, f, proj_meta = _fastfood_arrays(rng, d, num_features, gamma)
        arrays = {name: _on(dev, a) for name, a in arrays.items()}
        # Outside any kernel, as in ``repro``: the plain Kronecker-product
        # transforms on the SVs' device.
        proj_x = fastfood_project(
            X, arrays["ff_b"], arrays["ff_g"], arrays["ff_perm"], arrays["ff_scale"]
        )
    else:
        f = int(num_features)
        W = rng.normal(0.0, np.sqrt(2.0 * gamma), size=(f, d)).astype(np.float32)
        arrays = {"W": _on(dev, W)}
        proj_x = X @ arrays["W"].T
        proj_meta = {"projection": "dense"}
    phase = _on(dev, rng.uniform(0.0, 2.0 * np.pi, size=(f,)).astype(np.float32))
    phi_x = torch.cos(proj_x + phase[None, :])  # (n_sv, F)
    weights = (2.0 / f) * (ay2 @ phi_x)  # (K, F)

    arrays.update(phase=phase, weights=weights, b=b)
    art = CompiledArtifact(
        family=NAME,
        arrays=arrays,
        meta=base_meta(
            d=d,
            num_heads=k,
            multiclass=multiclass,
            kind="rff",
            validity="global",
            num_features=f,
            seed=int(seed),
            **proj_meta,
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
    Fastfood-projection artifacts route to ``quantize_fastfood_artifact``.
    """
    if art.meta.get("projection") == "fastfood":
        return quantize_fastfood_artifact(art, holdout=holdout)
    a = art.arrays
    dev = a["W"].device
    w_q, w_scale = quantize.quantize_rows(a["W"])  # (F,d), (F,)
    wt_q, wt_scale = quantize.quantize_rows(a["weights"])  # (K,F), (K,)

    q_art = CompiledArtifact(
        family=art.family,
        arrays={
            "W": _on(dev, w_q),
            "W_scale": _on(dev, w_scale),
            "weights": _on(dev, wt_q),
            "weights_scale": _on(dev, wt_scale),
            "phase": a["phase"],
            "b": a["b"],
        },
        meta={**art.meta, "dtype": quantize.INT8_DTYPE},
    )
    if holdout is not None:
        Z = as_batch(holdout, dev)
        q_art = q_art.with_meta(**quantize.measure_quant_error(art, q_art, Z))
    return q_art


def quantize_fastfood_artifact(
    art: CompiledArtifact, *, holdout=None
) -> CompiledArtifact:
    """Int8 variant of a structured (Fastfood) RFF artifact.

    A Fastfood artifact has no O(F d) operand, so every array that scales
    with F or K narrows:

      * ``ff_b``: exact +-1 signs -> int8, lossless, no scale;
      * ``ff_g`` / ``ff_scale``: int8 with one scale per stack row. Both
        diagonals multiply the same transform columns, so their per-stack
        scale product (``ff_stack_scale``) folds once per stack on the
        transform output;
      * ``ff_perm``: int16 when d' fits (lossless);
      * ``phase``: float16 (a phase into cos() needs ~1e-3 rad);
      * ``weights`` (K, F): int8 with per-head scales; ``b`` stays f32.

    Codes and scales are computed on the host in float64 with
    round-half-even, exactly as ``repro`` computes them. The quantization
    error against the f32 parent rides in the meta when ``holdout`` is
    given.
    """
    if art.meta.get("projection") != "fastfood":
        raise ValueError("not a fastfood-projection artifact")
    a = art.arrays
    dev = a["ff_g"].device
    g_q, g_scale = quantize.quantize_rows(a["ff_g"])  # (S,dd), (S,)
    s_q, s_scale = quantize.quantize_rows(a["ff_scale"])  # (S,dd), (S,)
    wt_q, wt_scale = quantize.quantize_rows(a["weights"])  # (K,F), (K,)
    stack_scale = (
        np.asarray(g_scale, np.float64) * np.asarray(s_scale, np.float64)
    ).astype(np.float32)

    q_art = CompiledArtifact(
        family=art.family,
        arrays={
            "ff_b": _on(dev, quantize.quantize_signs(a["ff_b"])),
            "ff_g": _on(dev, g_q),
            "ff_scale": _on(dev, s_q),
            "ff_stack_scale": _on(dev, stack_scale),
            "ff_perm": _on(dev, quantize.compact_perm(a["ff_perm"])),
            "phase": a["phase"].to(torch.float16),
            "weights": _on(dev, wt_q),
            "weights_scale": _on(dev, wt_scale),
            "b": a["b"],
        },
        meta={**art.meta, "dtype": quantize.INT8_DTYPE},
    )
    if holdout is not None:
        Z = as_batch(holdout, dev)
        q_art = q_art.with_meta(**quantize.measure_quant_error(art, q_art, Z))
    return q_art


def _on(dev, x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).to(dev)


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


def _fastfood_arrays(rng, d: int, num_features: int, gamma: float):
    """Sample the diagonal operators of ceil(F / d') Fastfood stacks, as
    numpy arrays drawn in ``repro``'s order (the same bytes for a seed).

    Each stack realizes d' frequency rows S H G Pi H B whose norms match
    W ~ N(0, 2 gamma I): rows of H G Pi H B have norm ||g|| sqrt(d'), so
    S_ii = sqrt(2 gamma) chi_i / (||g|| sqrt(d')) with chi_i ~ chi(d').
    """
    dd = 1 << max(1, (d - 1).bit_length())  # next pow2 >= d
    stacks = -(-int(num_features) // dd)
    f = stacks * dd
    B = rng.choice(np.float32([-1.0, 1.0]), size=(stacks, dd))
    G = rng.standard_normal((stacks, dd)).astype(np.float32)
    perm = np.stack([rng.permutation(dd) for _ in range(stacks)]).astype(np.int32)
    chi = np.sqrt(rng.chisquare(dd, size=(stacks, dd))).astype(np.float32)
    g_norm = np.linalg.norm(G, axis=-1, keepdims=True)
    scale = np.sqrt(2.0 * gamma) * chi / (g_norm * np.sqrt(dd))
    arrays = {
        "ff_b": B,
        "ff_g": G,
        "ff_perm": perm,
        "ff_scale": scale.astype(np.float32),
    }
    return arrays, f, {"projection": "fastfood", "dd": dd, "stacks": stacks}


def score(artifact: CompiledArtifact, Z, *, config: TileConfig | None = None):
    """(scores (n, K), valid_rows (n,)).

    Dense artifacts score through ``backend.rff_score[_q8]`` (B4/B5),
    Fastfood ones through ``backend.fastfood_score[_q8]`` (B6/B7).
    ``valid_rows`` is the compile-time held-out verdict broadcast over the
    batch: either every row is inside the accuracy contract or none is.
    """
    a = artifact.arrays
    if artifact.meta.get("projection") == "fastfood":
        if artifact.dtype == quantize.INT8_DTYPE:
            scores = backend.fastfood_score_q8(
                Z,
                a["ff_b"],
                a["ff_g"],
                a["ff_perm"],
                a["ff_scale"],
                a["ff_stack_scale"],
                a["phase"],
                a["weights"],
                a["weights_scale"],
                a["b"],
                config=config,
            )
        else:
            scores = backend.fastfood_score(
                Z,
                a["ff_b"],
                a["ff_g"],
                a["ff_perm"],
                a["ff_scale"],
                a["phase"],
                a["weights"],
                a["b"],
                config=config,
            )
    elif artifact.dtype == quantize.INT8_DTYPE:
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


def pad_heads(artifact: CompiledArtifact, multiple: int) -> CompiledArtifact:
    """Pad the head axis up to a multiple of ``multiple`` (head sharding).

    Only the (K, F) readout, its head scales (int8) and the (K,) bias have
    a head axis: padding heads get zero weights (int8: zero codes, scale
    1) and the argmax-neutral ``PAD_HEAD_BIAS``. Validity is a
    per-artifact verdict, which padding cannot move. ``meta["num_heads"]``
    keeps the real K; already aligned, the same object is returned.
    """
    k = artifact.num_heads
    pad = (-k) % max(1, int(multiple))
    if pad == 0:
        return artifact
    a = artifact.arrays
    arrays = dict(a)
    arrays["weights"] = pad_rows(a["weights"], pad)
    if artifact.dtype == quantize.INT8_DTYPE:
        arrays["weights_scale"] = pad_rows(a["weights_scale"], pad, 1.0)
    arrays["b"] = pad_rows(a["b"], pad, PAD_HEAD_BIAS)
    return CompiledArtifact(
        family=NAME,
        arrays=arrays,
        meta={**artifact.meta, "padded_heads": k + pad},
    )


def place_shards(artifact: CompiledArtifact, mesh) -> dict:
    """The scorer's operands placed on ``mesh`` once per (artifact, mesh)
    (``base.placed``): the readout, its head scales and the bias cut into
    shards, the projection operands and the phase on every shard's
    device."""
    a = artifact.arrays
    q8 = artifact.dtype == quantize.INT8_DTYPE
    heads = {"weights": a["weights"], "b": a["b"]}
    if q8:
        heads["weights_scale"] = a["weights_scale"]
    if artifact.meta.get("projection") == "fastfood":
        names = ("ff_b", "ff_g", "ff_perm", "ff_scale")
        names += ("ff_stack_scale", "phase") if q8 else ("phase",)
    else:
        names = ("W", "W_scale", "phase") if q8 else ("W", "phase")
    return placed(artifact, mesh, heads, {n: a[n] for n in names})


def score_sharded(
    artifact: CompiledArtifact, Z, *, mesh, config: TileConfig | None = None
):
    """``score`` with the (K, F) readout split over ``mesh``'s first axis.

    All four (projection, dtype) combinations shard: the per-row
    projection (the dense GEMM, or Fastfood's transforms) runs on every
    shard, the readout, its int8 head scales and the bias are split. The
    validity verdict is per-artifact meta, computed outside the shards.
    Returns (scores (n, K), valid_rows (n,)) on the mesh's first device.
    """
    p = place_shards(artifact, mesh)
    fastfood = artifact.meta.get("projection") == "fastfood"
    if artifact.dtype == quantize.INT8_DTYPE:
        readout = (p["weights"], p["weights_scale"], p["b"])
        if fastfood:
            ops = (p[n] for n in ("ff_b", "ff_g", "ff_perm", "ff_scale"))
            fn = backend.fastfood_score_q8_sharded
            args = (*ops, p["ff_stack_scale"], p["phase"], *readout)
        else:
            fn = backend.rff_score_q8_sharded
            args = (p["W"], p["W_scale"], p["phase"], *readout)
    elif fastfood:
        ops = (p[n] for n in ("ff_b", "ff_g", "ff_perm", "ff_scale"))
        fn = backend.fastfood_score_sharded
        args = (*ops, p["phase"], p["weights"], p["b"])
    else:
        fn = backend.rff_score_sharded
        args = (p["W"], p["phase"], p["weights"], p["b"])
    scores = fn(Z, *args, mesh=mesh, config=config)
    valid = torch.full(
        (scores.shape[0],),
        bool(artifact.meta.get("valid_globally", True)),
        device=scores.device,
    )
    return scores, valid


def tile_lookup(artifact: CompiledArtifact, bucket: int) -> tuple[str, str]:
    """(kernel, shape_key) the tuning registry resolves for this bucket."""
    q8 = artifact.dtype == quantize.INT8_DTYPE
    if artifact.meta.get("projection") == "fastfood":
        kernel = TILE_KERNEL_FF_Q8 if q8 else TILE_KERNEL_FF
    else:
        kernel = TILE_KERNEL_Q8 if q8 else TILE_KERNEL
    return kernel, tuning.shape_key(
        d=artifact.d, f=int(artifact.meta["num_features"]), n=bucket
    )
