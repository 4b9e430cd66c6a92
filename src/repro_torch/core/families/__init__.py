"""Approximation families: compile an SVM into a servable artifact.

  ===========  =============================  ========================
  family       prediction cost / row          accuracy contract
  ===========  =============================  ========================
  maclaurin    O(K d^2) quadratic form        per-row Eq 3.11 envelope,
                                              3.05% per-term rel. err
  poly2        O(K d^2) quadratic form        per-row Eq 3.11 envelope,
                                              7.26% per-term rel. err
  fourier      O(F d) dense RFF projection,   compile-time held-out
               or O(F log d) Fastfood         error estimate
               (``structured=True``)
  ===========  =============================  ========================

Every family also compiles an int8 variant (``dtype="int8"``, see
``quantize``). A family module exports
``NAME``, ``compile(svm, **opts)``, ``score(artifact, Z, config=None)``,
``TILE_KERNEL`` and ``tile_lookup(artifact, bucket)``, and for
head-sharded serving ``pad_heads(artifact, multiple)``,
``place_shards(artifact, mesh)`` and
``score_sharded(artifact, Z, mesh=..., config=None)``.

``compile_model(svm, budget)`` is the front door: the §4 verification
run across all families, returning the cheapest artifact within budget.
"""

from repro_torch.core.families import fourier, maclaurin, poly2, quantize
from repro_torch.core.families.base import (
    ARTIFACT_FORMAT_VERSION,
    PAD_HEAD_BIAS,
    CompiledArtifact,
)
from repro_torch.core.families.compile import Budget, compile_model

FAMILIES = {
    maclaurin.NAME: maclaurin,
    poly2.NAME: poly2,
    fourier.NAME: fourier,
}


def get_family(name: str):
    """The family module registered under ``name`` (KeyError lists known)."""
    try:
        return FAMILIES[name]
    except KeyError:
        raise KeyError(
            f"unknown approximation family {name!r}; known: {sorted(FAMILIES)}"
        ) from None


def score_artifact(artifact: CompiledArtifact, Z, *, config=None):
    """(scores (n, K), valid_rows (n,)) via the artifact's family."""
    return get_family(artifact.family).score(artifact, Z, config=config)


__all__ = [
    "ARTIFACT_FORMAT_VERSION",
    "Budget",
    "CompiledArtifact",
    "FAMILIES",
    "PAD_HEAD_BIAS",
    "compile_model",
    "fourier",
    "get_family",
    "maclaurin",
    "poly2",
    "quantize",
    "score_artifact",
]
