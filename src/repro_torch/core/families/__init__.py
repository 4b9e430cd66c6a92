"""Approximation families: compile an SVM into a servable artifact.

Only ``maclaurin`` (the paper's §3 collapse) is ported so far; ``poly2``
and ``fourier`` follow in ROADMAP queue A5 and A7. A family module
exports ``NAME``, ``compile(svm, **opts)``, ``score(artifact, Z,
config=None)``, ``TILE_KERNEL`` and ``tile_lookup(artifact, bucket)``.
"""

from repro_torch.core.families import maclaurin
from repro_torch.core.families.base import (
    ARTIFACT_FORMAT_VERSION,
    PAD_HEAD_BIAS,
    CompiledArtifact,
)

FAMILIES = {maclaurin.NAME: maclaurin}

_NOT_PORTED = ("poly2", "fourier")


def get_family(name: str):
    """The family module registered under ``name`` (KeyError otherwise)."""
    try:
        return FAMILIES[name]
    except KeyError:
        if name in _NOT_PORTED:
            raise KeyError(
                f"approximation family {name!r} is not yet ported to repro_torch; "
                f"ported: {sorted(FAMILIES)}"
            ) from None
        raise KeyError(
            f"unknown approximation family {name!r}; known: {sorted(FAMILIES)}"
        ) from None


def score_artifact(artifact: CompiledArtifact, Z, *, config=None):
    """(scores (n, K), valid_rows (n,)) via the artifact's family."""
    return get_family(artifact.family).score(artifact, Z, config=config)


__all__ = [
    "ARTIFACT_FORMAT_VERSION",
    "CompiledArtifact",
    "FAMILIES",
    "PAD_HEAD_BIAS",
    "get_family",
    "maclaurin",
    "score_artifact",
]
