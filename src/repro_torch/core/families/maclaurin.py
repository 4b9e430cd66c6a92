"""The ``maclaurin`` family — the paper's §3 quadratic-form collapse as a
compiled artifact.

Compiles an exact RBF ``SVMModel`` (binary or K-head OvR) into the
(c, v, M) quadratic form of Eq 3.8 and serves it through
``backend.quadform_heads`` (kernel B1 on the card) or, at int8,
``backend.quadform_heads_q8`` (kernel B3). Prediction is O(K d^2) per
row, independent of n_sv; validity is the per-row Eq 3.11 envelope with
the paper's 3.05% per-term relative-error guarantee.

Artifact layout:

    f32:  M (K, d, d) stacked Hessians     c, b, gamma, msq (K,) scalars
          v (K, d)    gradient terms

    int8 (``compile(..., dtype="int8")``): M stored int8 with per-(head,
          16-column-group) f32 scales ``M_scale`` (K, G); v stored int8
          with per-head scales ``v_scale`` (K,); scalars stay f32. The
          measured quantization error against the f32 parent ships in the
          meta (``quant_mean_abs_err`` / ``quant_max_abs_err``).
"""

from __future__ import annotations

import torch

from repro_torch.core import backend
from repro_torch.core.bounds import REL_ERR_AT_HALF
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
from repro_torch.core.maclaurin import ApproxModel, approximate
from repro_torch.core.rbf import SVMModel
from repro_torch.kernels.common import TileConfig, tuning

NAME = "maclaurin"
TILE_KERNEL = "quadform"  # tuning-registry family the scorer keys on
TILE_KERNEL_Q8 = "quadform_q8"  # ...and its int8-Hessian variant


def compile(  # noqa: A001
    svm: SVMModel,
    *,
    dtype: str = "float32",
    seed: int = 0,
    holdout=None,
    holdout_n: int = 256,
    **_opts,
) -> CompiledArtifact:
    """Collapse every head of ``svm`` (Eq 3.7); one product per head.

    ``dtype="int8"`` also quantizes the collapsed weights
    (``quantize_quadform_artifact``) and measures the quantization error
    on a held-out sample (``holdout``, or one drawn from ``seed``).
    """
    quantize.check_dtype(dtype)
    ay2, b, _, multiclass = stack_heads(svm)
    stacked = approximate(SVMModel(X=svm.X, alpha_y=ay2, b=b, gamma=svm.gamma))
    art = _quadform_artifact(NAME, stacked, multiclass, rel_err_at_half=REL_ERR_AT_HALF)
    if dtype == quantize.INT8_DTYPE:
        art = quantize_quadform_artifact(
            art, svm, seed=seed, holdout=holdout, holdout_n=holdout_n
        )
    return art


def from_approx(approx: ApproxModel) -> CompiledArtifact:
    """Wrap a (possibly head-stacked) ``ApproxModel`` without recomputing."""
    multiclass = approx.v.ndim == 2
    if not multiclass:
        approx = ApproxModel(*(t[None] for t in approx.tensors()))
    return _quadform_artifact(
        NAME, approx, multiclass, rel_err_at_half=REL_ERR_AT_HALF
    )


def _quadform_artifact(
    family: str, stacked: ApproxModel, multiclass: bool, **extra_meta
) -> CompiledArtifact:
    """Pack a head-stacked ``ApproxModel`` into the artifact arrays (shared
    by every quadratic-form family: maclaurin, poly2)."""
    k, d = stacked.v.shape
    dev = stacked.v.device

    def flat(x):
        x = torch.as_tensor(x, dtype=torch.float32, device=dev).reshape(-1)
        return x.expand(k).contiguous()

    arrays = {
        "M": stacked.M.to(torch.float32).contiguous(),
        "v": stacked.v.to(torch.float32).contiguous(),
        "c": flat(stacked.c),
        "b": flat(stacked.b),
        "gamma": flat(stacked.gamma),
        "msq": flat(stacked.max_sv_sq_norm),
    }
    return CompiledArtifact(
        family=family,
        arrays=arrays,
        meta=base_meta(
            d=d,
            num_heads=k,
            multiclass=multiclass,
            kind="quadform",
            validity="per-row",
            **extra_meta,
        ),
    )


def quantize_quadform_artifact(
    art: CompiledArtifact,
    svm: SVMModel | None = None,
    *,
    seed: int = 0,
    holdout=None,
    holdout_n: int = 256,
) -> CompiledArtifact:
    """Int8 variant of a compiled quadform artifact (maclaurin or poly2).

    The stacked Hessian goes int8 with per-(head, column-group) scales, v
    int8 with per-head scales; the four (K,) scalar vectors stay f32. The
    quantization error against the f32 parent is measured on ``holdout``
    (or a sample around the SVs drawn from ``seed`` when ``svm`` is given)
    and rides in the meta; with neither, the meta carries no error.
    """
    a = art.arrays
    dev = a["M"].device
    m_q, m_scale = quantize.quantize_col_groups(a["M"])  # (K,d,d), (K,G)
    v_q, v_scale = quantize.quantize_rows(a["v"])  # (K,d), (K,)

    def on_dev(x):
        return torch.from_numpy(x).to(dev)

    q_art = CompiledArtifact(
        family=art.family,
        arrays={
            "M": on_dev(m_q),
            "M_scale": on_dev(m_scale),
            "v": on_dev(v_q),
            "v_scale": on_dev(v_scale),
            "c": a["c"],
            "b": a["b"],
            "gamma": a["gamma"],
            "msq": a["msq"],
        },
        meta={
            **art.meta,
            "dtype": quantize.INT8_DTYPE,
            "group_size": quantize.GROUP_SIZE,
        },
    )
    Z = holdout
    if Z is None and svm is not None:
        from repro_torch.core.families import fourier

        Z = fourier.holdout_sample(svm, seed, holdout_n)
    if Z is not None:
        Z = as_batch(Z, dev)
        q_art = q_art.with_meta(**quantize.measure_quant_error(art, q_art, Z))
    return q_art


def score(artifact: CompiledArtifact, Z, *, config: TileConfig | None = None):
    """(scores (n, K), valid_rows (n,)) through the fused quadform path.

    ``valid_rows[i]`` is the Eq 3.11 envelope check over ALL heads: a row
    is servable by the fast path only if every head's bound holds. The
    envelope depends only on ||z||^2, gamma and msq, so the int8 variant
    keeps its f32 parent's validity contract.
    """
    a = artifact.arrays
    if artifact.dtype == quantize.INT8_DTYPE:
        col_scale, v = q8_operands(artifact)
        scores, _, valid = backend.quadform_heads_q8(
            Z, a["M"], col_scale, v, a["c"], a["b"], a["gamma"], a["msq"], config=config
        )
    else:
        scores, _, valid = backend.quadform_heads(
            Z, a["M"], a["v"], a["c"], a["b"], a["gamma"], a["msq"], config=config
        )
    return scores, valid.all(-1)


def q8_operands(artifact: CompiledArtifact) -> tuple[torch.Tensor, torch.Tensor]:
    """(col_scale (K, d), v (K, d)), f32 on the artifact's device: an int8
    artifact's per-group ``M_scale`` expanded to one scale per column, and
    ``v`` dequantized. Derived on the first call for an artifact, kept in
    ``artifact.derived`` and reused while its stored arrays are the same
    tensors, so a request launches no expansion around kernel B3."""
    a = artifact.arrays
    stored = (a["M_scale"], a["v"], a["v_scale"])
    hit = artifact.derived.get("q8_operands")
    if hit is not None and all(x is y for x, y in zip(hit[0], stored)):
        return hit[1]
    col_scale = quantize.expand_group_scales(
        a["M_scale"], artifact.d, int(artifact.meta["group_size"])
    )
    v = a["v"].to(torch.float32) * a["v_scale"][:, None]
    artifact.derived["q8_operands"] = (stored, (col_scale, v))
    return col_scale, v


def pad_heads(artifact: CompiledArtifact, multiple: int) -> CompiledArtifact:
    """Pad the head axis up to a multiple of ``multiple`` (head sharding).

    Padding heads are validity-neutral and argmax-neutral: msq = 0 holds
    the Eq 3.11 envelope for every row, gamma = 1, zero M, v and c, and the
    ``PAD_HEAD_BIAS`` bias can never win an argmax. Int8 padding is zero
    codes with scale 1. ``meta["num_heads"]`` keeps the real K and
    ``meta["padded_heads"]`` records the served width. The padded artifact
    is engine-internal (padding changes the digest). Already aligned, the
    same object is returned.
    """
    k = artifact.num_heads
    pad = (-k) % max(1, int(multiple))
    if pad == 0:
        return artifact
    a = artifact.arrays
    arrays = {
        "c": pad_rows(a["c"], pad),
        "b": pad_rows(a["b"], pad, PAD_HEAD_BIAS),
        "gamma": pad_rows(a["gamma"], pad, 1.0),
        "msq": pad_rows(a["msq"], pad),
        "M": pad_rows(a["M"], pad),
        "v": pad_rows(a["v"], pad),
    }
    if artifact.dtype == quantize.INT8_DTYPE:
        arrays["M_scale"] = pad_rows(a["M_scale"], pad, 1.0)
        arrays["v_scale"] = pad_rows(a["v_scale"], pad, 1.0)
    return CompiledArtifact(
        family=artifact.family,
        arrays=arrays,
        meta={**artifact.meta, "padded_heads": k + pad},
    )


def place_shards(artifact: CompiledArtifact, mesh) -> dict:
    """The scorer's per-head operands cut over ``mesh`` and placed on its
    shards' devices, once per (artifact, mesh) (``base.placed``)."""
    a = artifact.arrays
    heads = {n: a[n] for n in ("M", "v", "c", "b", "gamma", "msq")}
    if artifact.dtype == quantize.INT8_DTYPE:
        heads["col_scale"], heads["v"] = q8_operands(artifact)
    return placed(artifact, mesh, heads, {})


def score_sharded(
    artifact: CompiledArtifact, Z, *, mesh, config: TileConfig | None = None
):
    """``score`` with the K heads split over ``mesh``'s first axis.

    The (K, d, d) stacked Hessian, the operand that outgrows one device
    when K is in the thousands, lives shard by shard; each shard's device
    scores its K/shards heads through B1 (B3 at int8, its column scales
    split with the Hessian). The head count must already divide the axis
    size (``pad_heads``). Returns (scores (n, K), valid_rows (n,)) on the
    mesh's first device.
    """
    p = place_shards(artifact, mesh)
    rest = (p["c"], p["b"], p["gamma"], p["msq"])
    if artifact.dtype == quantize.INT8_DTYPE:
        scores, valid = backend.quadform_heads_q8_sharded(
            Z, p["M"], p["col_scale"], p["v"], *rest, mesh=mesh, config=config
        )
    else:
        scores, valid = backend.quadform_heads_sharded(
            Z, p["M"], p["v"], *rest, mesh=mesh, config=config
        )
    return scores, valid.all(-1)


def tile_lookup(artifact: CompiledArtifact, bucket: int) -> tuple[str, str]:
    """(kernel, shape_key) the tuning registry resolves for this bucket."""
    kernel = TILE_KERNEL_Q8 if artifact.dtype == quantize.INT8_DTYPE else TILE_KERNEL
    return kernel, tuning.shape_key(d=artifact.d, k=artifact.num_heads, n=bucket)
