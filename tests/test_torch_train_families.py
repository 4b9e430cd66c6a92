"""The training loss and every parameter's gradient against the JAX
package, for the five LM families, on the CPU.

``make_loss_fn``'s value and ``jax.value_and_grad`` of the reference's on
the same numpy weights (carried across by ``convert``) and the same batch,
reduced configurations at f32: smollm-135m (dense), qwen3-moe (top-2 of 8
experts), rwkv6, zamba2 (Mamba2 and the shared block) and the
VLM with random ``image_embeds``; the port with ``cfg.remat`` off and on
(the reference's reduced configurations run without). Then T = 1024,
where the blockwise attention checkpoints its query chunks and the
maclaurin backend takes the chunked route (the port's ``ChunkedMaclaurin``
around B8's dispatch, the reference's ``lax.scan`` form).

Tolerances: the loss within LOSS_TOL = 5e-6 of max(1, |loss|); each
gradient leaf within GRAD_TOL = 1e-4 of its max|grad| (f32 on both sides,
sums in other orders; the largest reading is 7e-6, zamba2's). Routing
ties: the MoE's inputs are normal draws, so no two routing probabilities
tie, and dropped tokens carry zero gradient in both packages.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.train import train_step as jts  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.train.train_step import make_loss_fn  # noqa: E402

LOSS_TOL = 5e-6
GRAD_TOL = 1e-4
FAMILIES = [
    "smollm-135m",
    "qwen3-moe-30b-a3b",
    "rwkv6-7b",
    "zamba2-2.7b",
    "llama-3.2-vision-90b",
]
LONG = [("softmax", 1024), ("maclaurin", 1024)]


def _configs(arch, backend):
    jcfg, cfg = JARCHS[arch].reduced(), ARCHS[arch].reduced()
    if backend is not None:
        jcfg, cfg = jcfg.with_backend(backend), cfg.with_backend(backend)
    return jcfg, cfg


@functools.lru_cache(maxsize=None)
def _reference(arch, backend, T, B):
    """The reference's weights, batch, loss, metrics and gradients (numpy)."""
    jcfg, cfg = _configs(arch, backend)
    jparams, _ = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (B, T + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "vlm":
        shape = (B, cfg.n_image_tokens, cfg.d_model)
        batch["image_embeds"] = rng.standard_normal(shape).astype(np.float32)
    fn = jax.jit(jax.value_and_grad(jts.make_loss_fn(jcfg), has_aux=True))
    (loss, metrics), grads = fn(jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    host = lambda t: jax.tree.map(np.asarray, t)
    return host(jparams), batch, float(loss), host(metrics), host(grads)


def _check(arch, backend, T, B, remat):
    jparams, batch, jloss, jmetrics, jgrads = _reference(arch, backend, T, B)
    _, cfg = _configs(arch, backend)
    cfg = dataclasses.replace(cfg, remat=remat)
    params = convert.lm_params_from_numpy(cfg, jparams, device="cpu").requires_grad_(True)
    loss, metrics = make_loss_fn(cfg)(params, {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    loss = loss.detach()
    assert abs(float(loss) - jloss) <= LOSS_TOL * max(1.0, abs(jloss))
    for key in ("xent", "aux"):
        assert abs(float(metrics[key]) - float(jmetrics[key])) <= LOSS_TOL * max(
            1.0, abs(float(jmetrics[key]))
        )
    grads = jax.tree.map(lambda t: t.numpy(), params.tree(lambda p: p.grad))
    jl = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    tl = jax.tree.leaves(grads)
    assert len(jl) == len(tl) == len(jax.tree.leaves(jparams))
    for (path, j), t in zip(jl, tl):
        assert t.shape == j.shape, path
        scale = float(np.abs(j).max())
        err = float(np.abs(t - j).max())
        assert err <= GRAD_TOL * scale or err == 0.0, (jax.tree_util.keystr(path), err, scale)
    if cfg.moe_num_experts:
        assert float(metrics["aux"]) > 0


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_grads_match_jax(arch, remat):
    _check(arch, None, 32, 2, remat)


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("backend,T", LONG)
def test_long_sequence_grads_match_jax(backend, T, remat):
    _check("smollm-135m", backend, T, 1, remat)
