"""The rule-sharded steps where the heads do not make whole head shards of
the "model" axis, against the port's one-device steps and the JAX
package's, on a (1, 4) ("data", "model") mesh of CPU slots.

Reduced smollm-135m with 4 q and 2 kv heads (each member attends with its
own q head and the kv head it reads, k and v gathered) and with 6 q and 2
kv heads (6 do not divide 4: the group's attention spread over its
members by batch rows, ``spmd.Lockstep.spread``). Each a train step
(blockwise softmax at T = 16, maclaurin at T = 1024, the chunked route of
B8's dispatch) and a prefill (flash, B9's dispatch, and maclaurin at
T = 1024) held against the one-device steps from the same weights and
batch, with ``test_torch_sharded_families``' helpers and tolerances:
logits within RTOL = 1e-5 of the largest, loss and its parts, gradient
norm, learning rate, updated parameters and moments within RTOL and ATOL
= 1e-6, replicas bit-equal. Reduced llama-3.2-vision-90b with 6 q and 2
kv heads puts its self- and cross-attention on the rows route. Then the
rows route where the batch does not divide the group (query rows cut for
the blockwise softmax, a fused kernel's batch rows on several members) and
12 q heads over 3 kv heads, whose head shards straddle kv groups. One cell
(6q/2kv) is held against the JAX package's one-device steps
(``test_torch_sharded_step_ref``'s STEP_TOL).

And B8's and B9's launches a position, from a trace on fake devices
(``launch.dryrun``): one a member a layer, on every member.
"""

import collections
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.launch import dryrun, specs  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.serve import decode_step as ds  # noqa: E402
from repro_torch.sharding import partitioning as part  # noqa: E402
from repro_torch.sharding import spmd  # noqa: E402
from test_torch_sharded_families import (  # noqa: E402
    RTOL,
    _close,
    _extra,
    _one_thread,  # noqa: F401
    _rounded,
    _setup,
    train_against_one_device,
)

B = 4
HEADS = {
    "4q/2kv": (("n_heads", 4), ("n_kv_heads", 2)),
    "6q/2kv": (("n_heads", 6), ("n_kv_heads", 2)),
    "12q/3kv": (("n_heads", 12), ("n_kv_heads", 3)),
}
MAIN = ("4q/2kv", "6q/2kv")
MACLAURIN = (("attention_backend", "maclaurin"),)
FLASH = (("attention_impl", "flash"),)
LONG = 1024  # the shortest T at which maclaurin takes B8's chunked route
STEP_TOL = 1e-5


def _mesh():
    return make_mesh((1, 4), ("data", "model"), devices=["cpu"] * 4)


def prefill(name, rules, changes, seq, batch=B):
    """A prefill cell against one device's prefill of the same bf16
    weights: logits within RTOL of the largest."""
    cfg, params, tokens, _, images = _setup(name, changes, batch, seq)
    shape = ShapeConfig("p", seq, batch, "prefill")
    cell = specs.build_cell(cfg, shape, _mesh(), getattr(part, rules), params=params)
    got = cell.step_fn(cell.args[0], tokens, *_extra(images))
    want = ds.make_prefill_step(cfg)(_rounded(params), tokens, *_extra(images))
    _close(got.gather(), want, "logits", atol=RTOL * float(want.abs().max()))
    for group in got.replica_groups():
        assert all(torch.equal(got.local(p), got.local(group[0])) for p in group)


@pytest.mark.parametrize("heads", MAIN)
@pytest.mark.parametrize("backend, seq", [("flash", 16), ("maclaurin", LONG)])
def test_prefill_matches_one_device(heads, backend, seq):
    changes = HEADS[heads] + (FLASH if backend == "flash" else MACLAURIN)
    prefill("smollm-135m", "TP_ONLY_RULES", changes, seq)


@pytest.mark.parametrize("heads", MAIN)
@pytest.mark.parametrize("backend, seq", [("blockwise", 16), ("maclaurin", LONG)])
def test_train_step_matches_one_device(heads, backend, seq):
    changes = HEADS[heads] + (MACLAURIN if backend == "maclaurin" else ()) + (("remat", True),)
    train_against_one_device("smollm-135m", "DEFAULT_RULES", changes=changes, batch=B, seq=seq, mesh=_mesh())


@pytest.mark.parametrize(
    "heads, batch, backend",
    [
        ("6q/2kv", 2, "blockwise"),  # 2 batch blocks x 2 query blocks
        ("6q/2kv", 1, "blockwise"),  # 4 query blocks
        ("6q/2kv", 2, "flash"),  # a fused kernel's rows whole: each batch row on 2 members
        ("12q/3kv", 4, "flash"),  # each member's 3 q heads read kv heads (0, 1, 1), ...
    ],
)
def test_rows_and_heads_layouts(heads, batch, backend):
    """The rows route where the batch does not divide the group: the
    blockwise softmax's query rows cut too (each block's causal mask from
    its first row), a fused kernel's batch rows each on as many members as
    remain; and q head shards that straddle two kv groups (a kv head a q
    head). Prefill against one device, and a train step where the backend
    trains."""
    changes = HEADS[heads]
    if backend == "flash":
        prefill("smollm-135m", "TP_ONLY_RULES", changes + FLASH, 16, batch)
        return
    prefill("smollm-135m", "TP_ONLY_RULES", changes, 16, batch)
    train_against_one_device("smollm-135m", "DEFAULT_RULES", changes=changes, batch=batch, mesh=_mesh())


def test_vlm_self_and_cross_attention_on_the_rows_route():
    """6 q and 2 kv heads over model = 4 in both the self- and the
    cross-attention blocks (the image tokens' k and v gathered, each
    member its batch row of every q head)."""
    changes = HEADS["6q/2kv"]
    name = "llama-3.2-vision-90b"
    train_against_one_device(name, "DEFAULT_RULES", changes=changes, batch=B, mesh=_mesh())
    prefill(name, "TP_ONLY_RULES", changes, 16)


def _launches(cfg, kind: str, seq: int) -> list[collections.Counter]:
    """B8's and B9's launches at each of the (1, 4) positions, traced on
    fake devices."""
    shape = ShapeConfig("c", seq, B, kind)
    mesh = dryrun.fake_mesh((1, 4), ("data", "model"))
    t = dryrun.trace_cell(cfg, shape, mesh, part.TP_ONLY_RULES, classes=False)
    out = []
    for d in mesh.devices:
        counts = t["counts"].get(str(d), {})
        out.append(collections.Counter({t["records"][i][0]: c for i, c in counts.items() if t["records"][i][3]}))
    return out


@pytest.mark.parametrize("heads", MAIN)
@pytest.mark.parametrize("backend, seq", [("flash", 64), ("maclaurin", LONG)])
def test_kernel_launches_a_member(heads, backend, seq):
    cfg = dataclasses.replace(
        ARCHS["smollm-135m"].reduced(), **dict(HEADS[heads] + (FLASH if backend == "flash" else MACLAURIN))
    )
    kernel = "flash_attention" if backend == "flash" else "maclaurin_attention"
    assert _launches(cfg, "prefill", seq) == [collections.Counter({kernel: cfg.n_layers})] * 4


def test_rows_route_matches_the_reference():
    """6q/2kv under DEFAULT_RULES: a train step at steps 0 and 3 from zero
    moments and a prefill of the cell's bf16 weights, against the JAX
    package's one-device steps on the same weights and batches."""
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from repro.configs import ARCHS as JARCHS
    from repro.models import transformer as jtf
    from repro.serve import decode_step as jds
    from repro.train import train_step as jts
    from repro_torch import convert
    from repro_torch.train.train_step import OptimizerConfig

    changes = dict(HEADS["6q/2kv"])
    cfg = dataclasses.replace(ARCHS["smollm-135m"].reduced(), **changes)
    jcfg = dataclasses.replace(JARCHS["smollm-135m"].reduced(), **changes)
    np_params = jax.tree.map(np.asarray, jtf.init_params(jcfg, jax.random.PRNGKey(1))[0])
    params = convert.lm_params_from_numpy(cfg, np_params, device="cpu")
    T = 16

    def batch(seed):
        rng = np.random.default_rng(seed)
        return {k: rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32) for k in ("tokens", "labels")}

    def close(t, j, what):
        t = t.detach().double().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float64)
        j = np.asarray(j, np.float64)
        assert t.shape == j.shape, what
        assert float(np.abs(t - j).max()) <= STEP_TOL * max(1.0, float(np.abs(j).max())), what

    ocfg = OptimizerConfig(peak_lr=1e-3, warmup=2, total_steps=10)
    jocfg = jts.OptimizerConfig(**dataclasses.asdict(ocfg))
    cell = specs.build_cell(cfg, ShapeConfig("t", T, B, "train"), _mesh(), part.DEFAULT_RULES, ocfg, params=params)
    placed, state = cell.args[0], cell.args[1]
    jparams = jax.tree.map(jnp.asarray, np_params)
    jstate = jts.init_opt_state(jocfg, jparams)
    jstep = jax.jit(jts.make_train_step(jcfg, jocfg))
    for s in (0, 3):
        b = batch(s)
        placed, state, metrics = cell.step_fn(placed, state, {k: torch.from_numpy(v) for k, v in b.items()}, s)
        jparams, jstate, jmetrics = jstep(jparams, jstate, {k: jnp.asarray(v) for k, v in b.items()}, jnp.int32(s))
    for key in jmetrics:
        close(metrics[key], jmetrics[key], key)
    jflat = spmd.flat(jparams)
    for path, leaf in spmd.flat(placed).items():
        close(leaf.gather(), jflat[path], path)

    rounded = jax.tree.map(lambda x: np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32)), np_params)
    cell = specs.build_cell(cfg, ShapeConfig("p", T, B, "prefill"), _mesh(), part.DEFAULT_RULES, params=params)
    tokens = batch(5)["tokens"]
    logits = cell.step_fn(cell.args[0], torch.from_numpy(tokens)).gather()
    close(logits, jds.make_prefill_step(jcfg)(rounded, jnp.asarray(tokens)), "prefill logits")
