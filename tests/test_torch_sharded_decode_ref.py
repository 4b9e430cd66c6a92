"""F11's maclaurin decode on 2 x 2 CPU slots under TP_ONLY against the JAX
package's one-device decode step.

smollm-135m reduced to 9 q and 3 kv heads at head_dim 8 with the
maclaurin backend: its ``MacState`` cache is a replica over "model" (3 kv
heads do not divide 2), which the reference's GSPMD computes and the
port's lockstep decodes by gathering q, k and v on every member. The
weights are the reference's (``convert``), rounded to bf16 for the
reference as the port's serving cell holds them.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.serve import decode_step as jds  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.sharding.partitioning import device_put  # noqa: E402
from test_torch_sharded_decode import MACLAURIN, B, _close, decode_cell  # noqa: E402


def test_maclaurin_against_the_reference():
    """Two steps against the JAX package's decode on the same weights
    (``convert``), within RTOL of the largest logit (at most 8.2e-7 here)."""
    name, T = "smollm-135m", 16
    jcfg = dataclasses.replace(JARCHS[name].reduced(), **MACLAURIN)
    np_params = jax.tree.map(np.asarray, jtf.init_params(jcfg, jax.random.PRNGKey(1))[0])
    cfg = dataclasses.replace(ARCHS[name].reduced(), **MACLAURIN)
    params = convert.lm_params_from_numpy(cfg, np_params, device="cpu")
    cell, cfg, _, tokens, _ = decode_cell(name, MACLAURIN, T, params=params)
    cache = device_put(tf.init_cache(cfg, B, T, dtype=torch.float32, device="cpu"), cell.in_shardings[3])
    rounded = jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16).astype(jnp.float32), np_params)
    jcache = jtf.init_cache(jcfg, B, T, dtype=jnp.float32)
    jserve = jax.jit(jds.make_serve_step(jcfg))
    for pos in range(2):
        tok = tokens[:, pos : pos + 1]
        logits, cache = cell.step_fn(cell.args[0], tok, pos, cache)
        logits = logits.gather()
        jlogits, jcache = jserve(rounded, jnp.asarray(tok.numpy()), jnp.int32(pos), jcache)
        _close(logits, torch.from_numpy(np.array(jlogits)), f"logits at {pos}")
