"""Top-k Mixture-of-Experts FFN with sort-based dispatch.

The port of ``repro/models/moe.py``. Tokens are routed to their top-k
experts by sorting each batch row's (token, expert) assignments by expert
id and packing them into a fixed (E, C, d) buffer (C = capacity per
expert), so the expert products cost E*C*d*d_ff, about the active FLOPs
times the capacity factor. The reference vmaps the dispatch over batch
rows; here every row is dispatched at once, each row's sort and slots its
own, which is the same function.

Overflowed tokens (beyond capacity) are dropped (Switch behaviour): their
combine weight is zero, so the residual path carries them unchanged. The
reference scatters them to the out-of-range expert id E with
``mode="drop"``; here the buffer has a spill row E that takes them and is
sliced off.

Ties: ``jnp.argsort`` is stable and so is the sort here, which decides
which tokens overflow an expert. ``lax.top_k`` puts the lower index of a
tie first, and ``torch.topk`` promises no order for ties; routing
probabilities that tie exactly are the one place the two may differ.
"""

from __future__ import annotations

import torch

from repro_torch.models.layers import ParamModule, init_
from repro_torch.sharding.hints import hint


class MoE(ParamModule):
    """``router`` (d, E) at scale 0.02; ``w_gate``, ``w_up`` (E, d, f) and
    ``w_down`` (E, f, d). As in the reference, ``w_gate`` and ``w_up`` take
    the default scale of their first axis, 1/sqrt(E), and ``w_down``
    1/sqrt(f)."""

    SPEC = {
        "router": ("embed", None),
        "w_gate": ("experts", "embed", "ffn"),
        "w_up": ("experts", "embed", "ffn"),
        "w_down": ("experts", "ffn", "embed"),
    }

    def __init__(self, d: int, d_ff: int, num_experts: int, generator, device=None):
        super().__init__()
        E = num_experts
        self.router = init_((d, E), generator, device, scale=0.02)
        self.w_gate = init_((E, d, d_ff), generator, device)
        self.w_up = init_((E, d, d_ff), generator, device)
        self.w_down = init_((E, d_ff, d), generator, device, scale=1.0 / (d_ff**0.5))


def capacity(T: int, top_k: int, E: int, capacity_factor: float = 1.25) -> int:
    """Slots per expert for T tokens of one row: max(1, int(cf T k / E))."""
    return max(1, int(capacity_factor * T * top_k / E))


def _dispatch(x, expert_idx, gate_vals, E: int, top_k: int, C: int):
    """Sort-based dispatch of every batch row. x: (B, T, d); idx/gates:
    (B, T, k). Returns (buf (B, E, C, d), combine metadata)."""
    B, T, d = x.shape
    dev = x.device
    e_flat = expert_idx.reshape(B, -1)  # (B, T*k)
    tok_flat = torch.arange(T, device=dev).repeat_interleave(top_k)
    gate_flat = gate_vals.reshape(B, -1).to(x.dtype)
    order = torch.argsort(e_flat, dim=-1, stable=True)
    e_sorted = torch.gather(e_flat, 1, order)
    tok_sorted = tok_flat[order]
    gate_sorted = torch.gather(gate_flat, 1, order)
    experts = torch.arange(E, device=dev).expand(B, E).contiguous()
    first_of_expert = torch.searchsorted(e_sorted.contiguous(), experts)
    pos_in_expert = torch.arange(T * top_k, device=dev) - torch.gather(
        first_of_expert, 1, e_sorted
    )
    keep = pos_in_expert < C

    rows = torch.arange(B, device=dev)[:, None].expand_as(e_sorted)
    buf = torch.zeros((B, E + 1, C, d), dtype=x.dtype, device=dev)  # row E: spill
    scatter_e = torch.where(keep, e_sorted, E)
    slot = torch.where(keep, pos_in_expert, 0)
    # kept (expert, slot) pairs are distinct, so a plain write is the
    # reference's add into zeros; only the spill row takes several
    src = torch.where(keep[..., None], x[rows, tok_sorted], 0.0)
    buf.index_put_((rows, scatter_e, slot), src)
    return buf[:, :E], (order, e_sorted, gate_sorted, pos_in_expert, keep)


def _combine(y, meta, top_k: int, C: int):
    """Gather expert outputs back to token order for every row and add
    each token's k gated contributions. y: (B, E, C, d) -> (B, T, d).

    Entry j of the sorted list came from flat assignment ``order[j]``,
    token ``order[j] // k``: putting the contributions back at ``order``
    lays them out (T, k) a row, and the sum over k is taken in top-k
    order, the same on every run (no atomic adds)."""
    order, e_sorted, gate_sorted, pos_in_expert, keep = meta
    B, E, _, d = y.shape
    flat_y = y.reshape(B, E * C, d)
    slot = torch.where(keep, e_sorted * C + pos_in_expert, 0)
    rows = torch.arange(B, device=y.device)[:, None].expand_as(slot)
    contrib = flat_y[rows, slot] * torch.where(keep, gate_sorted, 0.0)[..., None]
    unsorted = torch.empty_like(contrib)
    unsorted[rows, order] = contrib
    return unsorted.reshape(B, -1, top_k, d).sum(dim=2)


def route(params, x, *, top_k: int, capacity_factor: float = 1.25):
    """Routing in f32 (softmax, top-k, gates renormalised) and the sort-based
    dispatch of every batch row. x: (B, T, d) -> (buf (B, E, C, d), combine
    metadata, probs (B, T, E), expert_idx (B, T, k), C)."""
    T = x.shape[1]
    E = params["router"].shape[1]
    logits = x @ params["router"]  # (B, T, E)
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    gate_vals, expert_idx = torch.topk(probs, top_k, dim=-1)  # (B, T, k)
    gate_vals = gate_vals / torch.sum(gate_vals, dim=-1, keepdim=True)
    C = capacity(T, top_k, E, capacity_factor)
    buf, meta = _dispatch(x, expert_idx, gate_vals, E, top_k, C)
    return buf, meta, probs, expert_idx, C


def experts(params, buf):
    """The experts' SwiGLU as batched products over the expert axis:
    buf (B, E, C, d) against E experts' weights -> (B, E, C, d)."""
    h = torch.nn.functional.silu(torch.einsum("becd,edf->becf", buf, params["w_gate"]))
    h = h * torch.einsum("becd,edf->becf", buf, params["w_up"])
    return torch.einsum("becf,efd->becd", h, params["w_down"])


def load_counts(expert_idx, E: int):
    """(B, T, E) f32: how many of each token's top-k picks name each expert.
    The one-hot is a comparison with the expert ids (what
    ``F.one_hot`` computes, without its host-side range check, and the same
    ops on the card, the CPU and the dry run's fake tensors)."""
    ids = torch.arange(E, device=expert_idx.device)
    one_hot = (expert_idx[..., None] == ids).to(torch.float32)
    return torch.sum(one_hot, dim=2)


def moe_forward(
    params, x, *, top_k: int, capacity_factor: float = 1.25, return_aux: bool = True
):
    """x: (B, T, d) -> (out (B, T, d), aux_loss scalar f32).

    ``route``, the experts' products (``experts``), the combine, and the
    Switch load-balancing loss (0 when ``return_aux`` is False)."""
    E = params["router"].shape[1]
    buf, meta, probs, expert_idx, C = route(
        params, x, top_k=top_k, capacity_factor=capacity_factor
    )
    buf = hint(buf, "batch", "experts", None, None)  # the experts' all-to-all
    y = experts(params, buf)  # (B, E, C, d)
    y = hint(y, "batch", "experts", None, None)

    out = _combine(y, meta, top_k, C)

    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    if not return_aux:
        return out, zero
    # Switch-style load-balancing aux loss (global over B*T tokens).
    me = torch.mean(probs, dim=(0, 1))  # (E,)
    ce = torch.mean(load_counts(expert_idx, E), dim=(0, 1))
    aux = E * torch.sum(me * ce)
    return out, aux
