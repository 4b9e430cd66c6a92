"""Train and eval step factories.

The port of ``repro/train/train_step.py``. ``make_train_step`` builds
(params, opt_state, batch, step) -> (params, opt_state, metrics):

  * token cross-entropy + the MoE aux loss (``aux_loss_weight``);
  * microbatch gradient accumulation: a loop over ``microbatches`` equal
    slices of the batch, the gradients summed and averaged, the loss the
    mean, the metrics the last microbatch's (what the reference's
    ``lax.scan`` leaves);
  * optional int8 error-feedback gradient compression, then global-norm
    clipping, the cosine schedule and AdamW or Adafactor, in that order.

``params`` is an ``LMParams`` holding the f32 master weights. The step
turns their gradients on (``requires_grad_(True)``: they are built
frozen), takes the gradients with ``torch.autograd.grad``, runs the
optimizer on the reference's tree (each stacked layer leaf one tensor:
``LMParams.tree``) and writes the result back into ``params`` in place,
which it returns. ``opt_state`` is a nested dict of tensors under the
reference's keys, as ``init_opt_state`` builds it. Remat is the model's
(``cfg.remat``: ``models.layers.remat`` around each layer of a scanned
stack).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch import device as _device
from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import softmax_xent
from repro_torch.models.transformer import LMParams, forward
from repro_torch.sharding.hints import hint
from repro_torch.train import compression
from repro_torch.train import optimizer as opt
from repro_torch.train.tree import leaves


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"  # adamw | adafactor
    peak_lr: float = 3e-4
    warmup: int = 100
    total_steps: int = 10_000
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    aux_loss_weight: float = 0.01
    microbatches: int = 1
    compress_grads: bool = False  # int8 error-feedback (cross-pod wire)


def make_loss_fn(cfg: ModelConfig, aux_weight: float = 0.01) -> Callable:
    """loss_fn(params, batch) -> (xent + aux_weight * aux, {"xent", "aux"});
    a VLM's batch carries ``image_embeds``. The logits are hinted to batch
    and vocab sharding as the reference's are (``sharding.hints``)."""

    def loss_fn(params, batch):
        logits, aux = forward(cfg, params, batch["tokens"], batch.get("image_embeds"))
        logits = hint(logits, "batch", None, "vocab")
        xent = softmax_xent(logits, batch["labels"])
        return xent + aux_weight * aux, {"xent": xent, "aux": aux}

    return loss_fn


def init_opt_state(ocfg: OptimizerConfig, params, device=None):
    """The optimizer's state for ``params`` (with ``ef`` when
    ``compress_grads``), built on ``device``: CUDA unless the caller says,
    raising when there is no card; ``params`` must lie there."""
    dev = _device.pin(_device.resolve(device))
    tensors = params.parameters() if isinstance(params, LMParams) else leaves(params)
    held = {_device.pin(p.device) for p in tensors}
    if held != {dev}:
        raise ValueError(f"init_opt_state on {dev}: the parameters lie on {sorted(map(str, held))}")
    state = opt.adafactor_init(params) if ocfg.name == "adafactor" else opt.adamw_init(params)
    if ocfg.compress_grads:
        state["ef"] = compression.init_error_feedback(params)
    return state


def _value_and_grad(loss_fn, params: LMParams, plist: list, batch):
    loss, metrics = loss_fn(params, batch)
    grads = torch.autograd.grad(loss, plist, allow_unused=True, materialize_grads=True)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def make_train_step(cfg: ModelConfig, ocfg: OptimizerConfig) -> Callable:
    loss_fn = make_loss_fn(cfg, ocfg.aux_loss_weight)

    def train_step(params: LMParams, opt_state, batch, step):
        params.requires_grad_(True)
        plist = list(params.parameters())
        if ocfg.microbatches > 1:
            n = ocfg.microbatches
            acc, loss = None, 0.0
            for i in range(n):
                mb = {k: x.reshape(n, x.shape[0] // n, *x.shape[1:])[i] for k, x in batch.items()}
                l, metrics, grads = _value_and_grad(loss_fn, params, plist, mb)
                acc = grads if acc is None else [a + g for a, g in zip(acc, grads)]
                loss = loss + l / n
            grads = [g / n for g in acc]
        else:
            loss, metrics, grads = _value_and_grad(loss_fn, params, plist, batch)

        by_param = dict(zip(plist, grads))
        grads = params.tree(lambda p: by_param[p])
        del by_param
        if ocfg.compress_grads:
            grads, new_ef = compression.compress_decompress(grads, opt_state["ef"])
        grads, gnorm = opt.clip_by_global_norm(grads, ocfg.clip_norm)
        lr = opt.cosine_schedule(
            step, peak_lr=ocfg.peak_lr, warmup=ocfg.warmup, total=ocfg.total_steps
        )
        update = opt.adafactor_update if ocfg.name == "adafactor" else opt.adamw_update
        new_tree, new_state = update(
            params.tree(), grads, opt_state, lr, weight_decay=ocfg.weight_decay
        )
        params.assign(new_tree)
        if ocfg.compress_grads:
            new_state["ef"] = new_ef
        metrics = dict(metrics, loss=loss, grad_norm=gnorm, lr=lr)
        return params, new_state, metrics

    return train_step


def make_eval_step(cfg: ModelConfig) -> Callable:
    loss_fn = make_loss_fn(cfg, 0.0)

    @torch.no_grad()
    def eval_step(params, batch):
        loss, metrics = loss_fn(params, batch)
        return dict(metrics, loss=loss)

    return eval_step
