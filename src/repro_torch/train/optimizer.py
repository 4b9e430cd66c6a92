"""Optimizers, written out as the reference writes them (no
``torch.optim``).

The port of ``repro/train/optimizer.py``: AdamW, the default, and
Adafactor (beta1 = 0, the second moment factored over the last two axes)
for the largest models. Each is a plain function on trees of tensors
(nested dicts, lists, tuples; an ``LMParams`` stands for its reference
tree, stacked layer leaves included): the state keeps the reference's
keys and shapes, so it checkpoints in the reference's layout and a
stacked leaf is one leaf, as it is to the reference's factored moments
and its RMS update clip. The updates take no gradient and return new
trees; f32 moments whatever the parameters' dtype.
"""

from __future__ import annotations

import math

import torch

from repro_torch.train.tree import as_tree, leaves, tree_map, unzip

# ------------------------------------------------------------- schedules


def cosine_schedule(step, *, peak_lr: float, warmup: int, total: int, floor: float = 0.1):
    """Linear warm-up to ``peak_lr``, then a cosine down to ``floor`` of it
    at ``total``: a 0-d f32 tensor."""
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = peak_lr * step / max(1.0, warmup)
    frac = torch.clamp((step - warmup) / max(1.0, total - warmup), 0.0, 1.0)
    cos = peak_lr * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * frac)))
    return torch.where(step < warmup, warm, cos)


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled so their global f32 norm is at most ``max_norm``, each
    leaf cast back to its dtype; the norm before clipping)."""
    grads = as_tree(grads)
    gnorm = torch.sqrt(sum(square_sum(l) for l in leaves(grads)))
    scale = clip_scale(gnorm, max_norm)
    return tree_map(lambda l: (l * scale).to(l.dtype), grads), gnorm


def square_sum(g) -> torch.Tensor:
    """A gradient leaf's share of the squared global norm, in f32."""
    return torch.sum(torch.square(g.to(torch.float32)))


def clip_scale(gnorm, max_norm: float) -> torch.Tensor:
    """The factor that brings a global norm ``gnorm`` to at most ``max_norm``."""
    return torch.clamp(max_norm / (gnorm + 1e-9), max=1.0)


def _count(tree) -> torch.Tensor:
    first = leaves(tree)[0]
    return torch.zeros((), dtype=torch.int32, device=first.device)


# ------------------------------------------------------------- AdamW


@torch.no_grad()
def adamw_init(params):
    params = as_tree(params)
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return {
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
        "count": _count(params),
    }


@torch.no_grad()
def adamw_update(params, grads, state, lr, *, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1):
    """One AdamW step: bias correction from the int32 ``count``, weight
    decay decoupled inside the step. Returns (new params, new state)."""
    params, grads = as_tree(params), as_tree(grads)
    count = state["count"] + 1
    c = count.to(torch.float32)

    def upd(p, g, m, v):
        g = g.to(torch.float32)
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        mh = m / (1 - b1**c)
        vh = v / (1 - b2**c)
        step = mh / (torch.sqrt(vh) + eps) + weight_decay * p.to(torch.float32)
        return (p.to(torch.float32) - lr * step).to(p.dtype), m, v

    out = tree_map(upd, params, grads, state["m"], state["v"])
    new_params, new_m, new_v = unzip(out, params, 3)
    return new_params, {"m": new_m, "v": new_v, "count": count}


# ------------------------------------------------------------- Adafactor


def _factored(shape) -> bool:
    return len(shape) >= 2


@torch.no_grad()
def adafactor_init(params):
    params = as_tree(params)
    f32 = torch.float32

    def init(p):
        if _factored(p.shape):
            return {
                "vr": torch.zeros(p.shape[:-1], dtype=f32, device=p.device),  # row stats
                "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], dtype=f32, device=p.device),
            }
        return {"v": torch.zeros(p.shape, dtype=f32, device=p.device)}

    return {"v": tree_map(init, params), "count": _count(params)}


ADAFACTOR_B2, ADAFACTOR_EPS, ADAFACTOR_CLIP = 0.999, 1e-30, 1.0


@torch.no_grad()
def adafactor_update(
    params,
    grads,
    state,
    lr,
    *,
    b2=ADAFACTOR_B2,
    eps=ADAFACTOR_EPS,
    weight_decay=0.0,
    clip=ADAFACTOR_CLIP,
):
    """One Adafactor step: factored second moments over the last two axes
    (a full one for vectors), Adafactor's RMS update clip over each leaf.
    Returns (new params, new state)."""
    params, grads = as_tree(params), as_tree(grads)
    count = state["count"] + 1

    def upd(p, g, s):
        g = g.to(torch.float32)
        g2 = g * g + eps
        if _factored(p.shape):
            vr = b2 * s["vr"] + (1 - b2) * torch.mean(g2, dim=-1)
            vc = b2 * s["vc"] + (1 - b2) * torch.mean(g2, dim=-2)
            denom = torch.clamp(torch.mean(vr, dim=-1, keepdim=True), min=eps)
            vhat = vr[..., None] * vc[..., None, :] / denom[..., None]
            u = g * torch.rsqrt(vhat + eps)
            new_s = {"vr": vr, "vc": vc}
        else:
            v = b2 * s["v"] + (1 - b2) * g2
            u = g * torch.rsqrt(v + eps)
            new_s = {"v": v}
        rms = torch.sqrt(torch.mean(u * u) + eps)  # Adafactor's update clip
        u = u / torch.clamp(rms / clip, min=1.0)
        p32 = p.to(torch.float32)
        newp = p32 - lr * (u + weight_decay * p32)
        return newp.to(p.dtype), new_s

    out = tree_map(upd, params, grads, state["v"])
    new_params, new_v = unzip(out, params, 2)
    return new_params, {"v": new_v, "count": count}
