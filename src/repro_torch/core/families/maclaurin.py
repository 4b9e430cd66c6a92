"""The ``maclaurin`` family — the paper's §3 quadratic-form collapse as a
compiled artifact.

Compiles an exact RBF ``SVMModel`` (binary or K-head OvR) into the
(c, v, M) quadratic form of Eq 3.8 and serves it through
``backend.quadform_heads`` (kernel B1 on the card). Prediction is
O(K d^2) per row, independent of n_sv; validity is the per-row Eq 3.11
envelope with the paper's 3.05% per-term relative-error guarantee.

Artifact layout (f32):

    M (K, d, d) stacked Hessians     c, b, gamma, msq (K,) scalars
    v (K, d)    gradient terms

The int8 variant is not ported yet (ROADMAP queue A5).
"""

from __future__ import annotations

import torch

from repro_torch.core import backend
from repro_torch.core.bounds import REL_ERR_AT_HALF
from repro_torch.core.families.base import CompiledArtifact, base_meta, stack_heads
from repro_torch.core.maclaurin import ApproxModel, approximate
from repro_torch.core.rbf import SVMModel
from repro_torch.kernels.common import TileConfig, tuning

NAME = "maclaurin"
TILE_KERNEL = "quadform"  # tuning-registry family the scorer keys on


def compile(  # noqa: A001
    svm: SVMModel, *, dtype: str = "float32", **_opts
) -> CompiledArtifact:
    """Collapse every head of ``svm`` (Eq 3.7); one product per head."""
    if dtype == "int8":
        raise NotImplementedError(
            "int8 maclaurin artifacts are not ported yet (ROADMAP queue A5)"
        )
    if dtype != "float32":
        raise ValueError(f"dtype must be 'float32' or 'int8', got {dtype!r}")
    ay2, b, _, multiclass = stack_heads(svm)
    stacked = approximate(SVMModel(X=svm.X, alpha_y=ay2, b=b, gamma=svm.gamma))
    return _quadform_artifact(
        NAME, stacked, multiclass, rel_err_at_half=REL_ERR_AT_HALF
    )


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
    """Pack a head-stacked ``ApproxModel`` into the artifact arrays."""
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


def score(artifact: CompiledArtifact, Z, *, config: TileConfig | None = None):
    """(scores (n, K), valid_rows (n,)) through the fused quadform path.

    ``valid_rows[i]`` is the Eq 3.11 envelope check over ALL heads — a row
    is servable by the fast path only if every head's bound holds.
    """
    if artifact.dtype != "float32":
        raise NotImplementedError(
            f"{artifact.dtype} maclaurin artifacts are not ported yet "
            "(ROADMAP queue A5)"
        )
    a = artifact.arrays
    scores, _, valid = backend.quadform_heads(
        Z, a["M"], a["v"], a["c"], a["b"], a["gamma"], a["msq"], config=config
    )
    return scores, valid.all(-1)


def tile_lookup(artifact: CompiledArtifact, bucket: int) -> tuple[str, str]:
    """(kernel, shape_key) the tuning registry resolves for this bucket."""
    return TILE_KERNEL, tuning.shape_key(d=artifact.d, k=artifact.num_heads, n=bucket)
