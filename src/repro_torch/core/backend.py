"""The serving primitives, each a hand-written CUDA kernel on the card.

  * ``quadform_heads`` — the collapsed quadratic form (Eq 3.8) fused over
    K heads, with ||z||^2 and the Eq 3.11 mask (kernel B1);
  * ``quadform_heads_q8`` — the same off an int8 stacked Hessian
    (kernel B3);
  * ``rbf_scores`` — the exact RBF expansion (Eq 3.2), the engine's
    accuracy fallback (kernel B2);
  * ``rff_score`` / ``rff_score_q8`` — random-Fourier-feature scores off
    f32 (kernel B4) or int8 (kernel B5) weights;
  * ``fastfood_score`` / ``fastfood_score_q8`` — the same off the
    structured (Fastfood) projection, f32 (kernel B6) or int8 (kernel B7)
    operators;
  * ``family_scores`` — a ``CompiledArtifact`` through its family's
    primitive;
  * ``*_sharded`` — the six head-stacked primitives with their K heads
    split over a ``repro_torch.launch.Mesh`` (head-sharded serving).

``repro``'s backend picked Pallas or XLA per process. Here the choice
follows the tensors: CUDA tensors launch the kernel (or raise, when it
cannot be built or launched), CPU tensors compute with the plain twins
(``*_torch``). There is no switch that sends CUDA tensors to the plain
versions.

``config=None`` resolves the ``TileConfig`` for the operand shapes from
the tuning registry.

Sharding follows ``repro``'s ``shard_map`` layout in one process: the
per-head operands are cut along the head axis into the mesh's first-axis
size of equal chunks (``shard_heads``), the replicated ones (Z, and a
fourier projection with its phase) are copied once to each distinct
device (``replicate``), shard s runs the one-device primitive on its
device, and the per-shard scores are concatenated along the head axis on
the mesh's first device. Each operand may also be passed already placed,
as the tuple ``shard_heads`` or ``replicate`` returns, so that a caller
serving many batches moves its slabs once.
"""

from __future__ import annotations

import contextlib

import torch

from repro_torch.kernels.common import TileConfig, tuning
from repro_torch.kernels.fwht.kernel import (
    fastfood_score_cuda,
    fastfood_score_q8_cuda,
    fastfood_score_q8_torch,
    fastfood_score_torch,
)
from repro_torch.kernels.quadform.kernel import (
    quadform_heads_cuda,
    quadform_heads_q8_cuda,
    quadform_heads_q8_torch,
    quadform_heads_torch,
)
from repro_torch.kernels.rbf_pred.kernel import rbf_scores_cuda, rbf_scores_torch
from repro_torch.kernels.rff_score.kernel import (
    rff_score_cuda,
    rff_score_q8_cuda,
    rff_score_q8_torch,
    rff_score_torch,
)

__all__ = [
    "family_scores",
    "fastfood_score",
    "fastfood_score_q8",
    "fastfood_score_q8_torch",
    "fastfood_score_torch",
    "fastfood_score_q8_sharded",
    "fastfood_score_sharded",
    "quadform_heads",
    "quadform_heads_q8",
    "quadform_heads_q8_sharded",
    "quadform_heads_q8_torch",
    "quadform_heads_sharded",
    "quadform_heads_torch",
    "rbf_scores",
    "rbf_scores_torch",
    "replicate",
    "rff_score",
    "rff_score_q8",
    "rff_score_q8_sharded",
    "rff_score_q8_torch",
    "rff_score_sharded",
    "rff_score_torch",
    "set_profile_scope",
    "shard_heads",
]

# Profiling seam: ``repro_torch.serve.runtime.obs.profile`` installs a
# ``name -> context manager`` factory (``torch.profiler.record_function``)
# here, so the dispatch seams below show up as named ranges in a profiler
# trace. A callback keeps the layering: ``core`` never imports ``serve``.
# Unset, ``_scope`` is a ``nullcontext``.
_profile_scope = None


def set_profile_scope(factory) -> None:
    """Install (or clear, with None) a ``name -> context manager`` factory
    wrapped around the top-level dispatch seams (``family_scores``,
    ``rbf_scores``)."""
    global _profile_scope
    _profile_scope = factory


def _scope(name: str):
    factory = _profile_scope
    if factory is None:
        return contextlib.nullcontext()
    return factory(name)


def quadform_heads(Z, M_all, V, c, b, gamma, msq, *, config: TileConfig | None = None):
    """Fused K-head scores.

    Z: (n, d); M_all: (K, d, d); V: (K, d); c/b/gamma/msq: (K,).
    Returns (scores (n, K), z_sq (n,), valid (n, K)) where valid is the
    per-head Eq 3.11 mask.
    """
    if config is None:
        config = tuning.lookup(
            "quadform",
            tuning.shape_key(
                d=Z.shape[1], k=M_all.shape[0], n=tuning.bucket(Z.shape[0])
            ),
        )
    return quadform_heads_cuda(Z, M_all, V, c, b, gamma, msq, config=config)


def quadform_heads_q8(
    Z, M_q, col_scale, V, c, b, gamma, msq, *, config: TileConfig | None = None
):
    """Fused K-head scores off an int8 stacked Hessian.

    Z: (n, d); M_q: (K, d, d) int8; col_scale: (K, d) f32 per-column
    dequantization scales; V: (K, d) f32 (already dequantized, it is
    thin); c/b/gamma/msq: (K,). Same return contract as
    ``quadform_heads``.
    """
    if config is None:
        config = tuning.lookup(
            "quadform_q8",
            tuning.shape_key(
                d=Z.shape[1], k=M_q.shape[0], n=tuning.bucket(Z.shape[0])
            ),
        )
    return quadform_heads_q8_cuda(
        Z, M_q, col_scale, V, c, b, gamma, msq, config=config
    )


def rff_score(Z, W, phase, weights, bias, *, config: TileConfig | None = None):
    """Random-Fourier-feature scores.

    Z: (n, d); W: (F, d); phase: (F,); weights: (K, F) with the 2/F
    feature scaling folded in at compile time; bias: (K,). Returns
    per-head scores (n, K).
    """
    if config is None:
        config = tuning.lookup(
            "rff_score",
            tuning.shape_key(d=Z.shape[1], f=W.shape[0], n=tuning.bucket(Z.shape[0])),
        )
    return rff_score_cuda(Z, W, phase, weights, bias, config=config)


def rff_score_q8(
    Z,
    W_q,
    w_scale,
    phase,
    weights_q,
    wt_scale,
    bias,
    *,
    config: TileConfig | None = None,
):
    """Random-Fourier-feature scores off int8 projection and readout.

    Z: (n, d); W_q: (F, d) int8 with per-row scales w_scale (F,);
    weights_q: (K, F) int8 with per-head scales wt_scale (K,); phase (F,)
    and bias (K,) f32. Returns (n, K).
    """
    if config is None:
        config = tuning.lookup(
            "rff_score_q8",
            tuning.shape_key(
                d=Z.shape[1], f=W_q.shape[0], n=tuning.bucket(Z.shape[0])
            ),
        )
    return rff_score_q8_cuda(
        Z, W_q, w_scale, phase, weights_q, wt_scale, bias, config=config
    )


def fastfood_score(
    Z, B, G, perm, scale, phase, weights, bias, *, config: TileConfig | None = None
):
    """Fastfood (structured RFF) scores.

    Z: (n, d); B/G/scale: (stacks, d') diagonal operators; perm:
    (stacks, d'); phase: (F,) with F = stacks d'; weights: (K, F) with the
    2/F scaling folded in at compile time; bias: (K,). Returns (n, K).
    """
    if config is None:
        config = tuning.lookup(
            "fwht",
            tuning.shape_key(
                d=Z.shape[1], f=B.shape[0] * B.shape[1], n=tuning.bucket(Z.shape[0])
            ),
        )
    return fastfood_score_cuda(
        Z, B, G, perm, scale, phase, weights, bias, config=config
    )


def fastfood_score_q8(
    Z,
    b_q,
    g_q,
    perm,
    s_q,
    stack_scale,
    phase,
    weights_q,
    wt_scale,
    bias,
    *,
    config: TileConfig | None = None,
):
    """Fastfood scores off int8 operators.

    b_q/g_q/s_q: (stacks, d') int8 (b_q holds exact +-1 signs);
    stack_scale: (stacks,) f32 combined G*S row scales; perm: (stacks, d')
    int16; phase: (F,) f16; weights_q: (K, F) int8 with per-head scales
    wt_scale (K,); bias (K,) f32. Returns (n, K).
    """
    if config is None:
        config = tuning.lookup(
            "fwht_q8",
            tuning.shape_key(
                d=Z.shape[1],
                f=b_q.shape[0] * b_q.shape[1],
                n=tuning.bucket(Z.shape[0]),
            ),
        )
    return fastfood_score_q8_cuda(
        Z,
        b_q,
        g_q,
        perm,
        s_q,
        stack_scale,
        phase,
        weights_q,
        wt_scale,
        bias,
        config=config,
    )

# ------------------------------------------------------- head sharding


def _shard_devices(mesh, k: int) -> tuple[torch.device, ...]:
    """The device of each shard along ``mesh``'s first axis, after checking
    that the ``k`` heads split evenly over it (``ValueError`` otherwise)."""
    axis = mesh.axis_names[0]
    shards = mesh.shape[axis]
    if k % shards:
        raise ValueError(
            f"num_heads ({k}) must divide by mesh axis {axis!r} ({shards}); "
            f"pad validity-neutral heads first"
        )
    return mesh.shard_devices()


def shard_heads(x: torch.Tensor, mesh) -> tuple[torch.Tensor, ...]:
    """``x`` cut along its first (head) axis into equal chunks, one per
    position of ``mesh``'s first axis, chunk s on shard s's device (a view
    of ``x`` where it already lies there)."""
    devices = _shard_devices(mesh, x.shape[0])
    chunks = x.split(x.shape[0] // len(devices))
    return tuple(c.to(dev) for c, dev in zip(chunks, devices))


def replicate(x: torch.Tensor, mesh) -> tuple[torch.Tensor, ...]:
    """``x`` on each shard's device of ``mesh``'s first axis: copied once
    per distinct device, and ``x`` itself where it already lies there."""
    copies: dict[torch.device, torch.Tensor] = {}
    for dev in mesh.shard_devices():
        if dev not in copies:
            copies[dev] = x.to(dev)
    return tuple(copies[dev] for dev in mesh.shard_devices())


def _per_shard(x, mesh, place) -> tuple[torch.Tensor, ...]:
    """An operand's part for each shard: as given when already placed, else
    ``place(x, mesh)``."""
    return tuple(x) if isinstance(x, (tuple, list)) else place(x, mesh)


def _num_heads(x) -> int:
    if isinstance(x, (tuple, list)):
        return sum(int(c.shape[0]) for c in x)
    return int(x.shape[0])


def _run_sharded(fn, Z, shared, heads, mesh):
    """``fn(z, shared, heads)`` on every shard: ``Z`` and the ``shared``
    operands replicated, the ``heads`` operands split (the head count read
    from the first). Returns the per-shard outputs and the gather device
    (the mesh's first)."""
    devices = _shard_devices(mesh, _num_heads(heads[0]))
    zs = replicate(Z, mesh)
    shared = [_per_shard(x, mesh, replicate) for x in shared]
    heads = [_per_shard(x, mesh, shard_heads) for x in heads]
    for x in shared + heads:
        if len(x) != len(devices):
            raise ValueError(f"{len(x)} placed operand parts for {len(devices)} shards")
    outs = [
        fn(zs[s], [x[s] for x in shared], [x[s] for x in heads])
        for s in range(len(devices))
    ]
    return outs, devices[0]


def _gather(parts, device) -> torch.Tensor:
    """Per-shard (n, K/shards) blocks side by side on ``device``."""
    return torch.cat([p.to(device) for p in parts], dim=1)


def quadform_heads_sharded(
    Z, M_all, V, c, b, gamma, msq, *, mesh, config: TileConfig | None = None
):
    """``quadform_heads`` with the K heads split over ``mesh``'s first axis.

    Every per-head operand (M, V, c, b, gamma, msq) is split, Z is
    replicated; each shard runs ``quadform_heads`` (kernel B1 on a card)
    for its K/shards heads on its device. K must divide the axis size
    (pad validity-neutral heads first, ``families.*.pad_heads``). Returns
    (scores (n, K), valid (n, K)) on the mesh's first device.
    """

    def shard(z, _, heads):
        scores, _, valid = quadform_heads(z, *heads, config=config)
        return scores, valid

    outs, dev = _run_sharded(shard, Z, [], [M_all, V, c, b, gamma, msq], mesh)
    return _gather([o[0] for o in outs], dev), _gather([o[1] for o in outs], dev)


def quadform_heads_q8_sharded(
    Z, M_q, col_scale, V, c, b, gamma, msq, *, mesh, config: TileConfig | None = None
):
    """``quadform_heads_q8`` with the K heads split over ``mesh``'s first
    axis: the int8 Hessians and their column scales split together, so
    each shard's kernel (B3 on a card) folds its own scales. Same contract
    as ``quadform_heads_sharded``."""

    def shard(z, _, heads):
        scores, _, valid = quadform_heads_q8(z, *heads, config=config)
        return scores, valid

    heads = [M_q, col_scale, V, c, b, gamma, msq]
    outs, dev = _run_sharded(shard, Z, [], heads, mesh)
    return _gather([o[0] for o in outs], dev), _gather([o[1] for o in outs], dev)


def rff_score_sharded(
    Z, W, phase, weights, bias, *, mesh, config: TileConfig | None = None
):
    """``rff_score`` with the (K, F) readout split over ``mesh``'s first
    axis: the projection (W, phase) is per-row work and is replicated, the
    readout and the bias are split, and each shard runs kernel B4 on a
    card for its heads. K must divide the axis size. Returns (n, K) on the
    mesh's first device."""

    def shard(z, shared, heads):
        return rff_score(z, *shared, *heads, config=config)

    outs, dev = _run_sharded(shard, Z, [W, phase], [weights, bias], mesh)
    return _gather(outs, dev)


def rff_score_q8_sharded(
    Z,
    W_q,
    w_scale,
    phase,
    weights_q,
    wt_scale,
    bias,
    *,
    mesh,
    config: TileConfig | None = None,
):
    """``rff_score_q8`` with the int8 readout split over ``mesh``'s first
    axis: W_q, its row scales and the phase replicated, the readout codes,
    their head scales and the bias split (kernel B5 on a card per shard).
    Same contract as ``rff_score_sharded``."""

    def shard(z, shared, heads):
        (wq, ws, ph), (rq, rs, bs) = shared, heads
        return rff_score_q8(z, wq, ws, ph, rq, rs, bs, config=config)

    outs, dev = _run_sharded(
        shard,
        Z,
        [W_q, w_scale, phase],
        [weights_q, wt_scale, bias],
        mesh,
    )
    return _gather(outs, dev)


def fastfood_score_sharded(
    Z,
    B,
    G,
    perm,
    scale,
    phase,
    weights,
    bias,
    *,
    mesh,
    config: TileConfig | None = None,
):
    """``fastfood_score`` with the (K, F) readout split over ``mesh``'s
    first axis: the O(F) operators and the phase replicated, the readout
    and the bias split (kernel B6 on a card per shard). K must divide the
    axis size. Returns (n, K) on the mesh's first device."""

    def shard(z, shared, heads):
        return fastfood_score(z, *shared, *heads, config=config)

    shared = [B, G, perm, scale, phase]
    outs, dev = _run_sharded(shard, Z, shared, [weights, bias], mesh)
    return _gather(outs, dev)


def fastfood_score_q8_sharded(
    Z,
    b_q,
    g_q,
    perm,
    s_q,
    stack_scale,
    phase,
    weights_q,
    wt_scale,
    bias,
    *,
    mesh,
    config: TileConfig | None = None,
):
    """``fastfood_score_q8`` with the int8 readout split over ``mesh``'s
    first axis: the int8 operators, the stack scales and the phase
    replicated, the readout codes, their head scales and the bias split
    (kernel B7 on a card per shard). Same contract as
    ``fastfood_score_sharded``."""

    def shard(z, shared, heads):
        return fastfood_score_q8(z, *shared, *heads, config=config)

    outs, dev = _run_sharded(
        shard,
        Z,
        [b_q, g_q, perm, s_q, stack_scale, phase],
        [weights_q, wt_scale, bias],
        mesh,
    )
    return _gather(outs, dev)


def rbf_scores(Z, X, alpha_y, gamma, b, *, config: TileConfig | None = None):
    """Exact decision values f(Z) = sum_i a_i K(x_i, z) + b.

    ``alpha_y`` (m,) with a scalar ``b`` gives (n,); (K, m) with ``b``
    (K,) gives (n, K), every distance shared by the K heads.
    """
    if config is None:
        config = tuning.lookup(
            "rbf_pred",
            tuning.shape_key(d=Z.shape[1], m=X.shape[0], n=tuning.bucket(Z.shape[0])),
        )
    with _scope("repro.backend/rbf_scores"):
        return rbf_scores_cuda(Z, X, alpha_y, gamma, b, config=config)


def family_scores(artifact, Z, *, config: TileConfig | None = None):
    """Score a ``CompiledArtifact`` through its family's serving primitive.

    Returns ``(scores (n, K), valid_rows (n,))``.
    """
    from repro_torch.core import families

    with _scope(f"repro.backend/family_scores/{artifact.family}"):
        return families.score_artifact(artifact, Z, config=config)
