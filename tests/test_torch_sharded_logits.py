"""The sharded prefill and decode steps return their logits where they
were computed, in the layout the JAX package's compiled cells leave them.

The reference compiles each cell (``launch.specs.build_cell``: out
shardings None for prefill, (None, the cache's) for decode) for a (2, 2)
("data", "model") mesh of four forced host devices in one subprocess, under
its hints, and runs it; GSPMD keeps the logits in the layout it computed
them in. The port runs the same cells through its ``build_cell`` on 2 x 2
CPU slots. Both take the same weights and tokens, made from one numpy seed
and shared through an ``.npz``: reduced smollm-135m, a prefill and two
decode steps through an f32 cache under DEFAULT, TP_ONLY, SP_RULES,
DP_ONLY and EP_DP; a decode whose 3 kv heads do not divide "model" (its
cache cut along the sequence); and a decode of one row (the batch
replicated). At each mesh position the port's block has the shape of the
reference's addressable shard at the same mesh coordinate and agrees with
it within STEP_TOL = 1e-5 of max(1, max|ref|), each position's block lies
on its own device in storage of its own, and no step reaches
``collectives.gather``.

Then on fake devices (``launch.dryrun``'s, distinct a position), a class
trace on 4 x 2: every position's block on its own device, of its
sharding's block shape, a stand-in where the position is not run.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.kernels.build import card_stand_in  # noqa: E402
from repro_torch.launch import dryrun, specs  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.sharding import collectives as coll  # noqa: E402
from repro_torch.sharding import partitioning as part  # noqa: E402
from repro_torch.sharding.partitioning import Sharded, device_put  # noqa: E402
from repro_torch.sharding.spmd import class_reps, running  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
STEP_TOL = 1e-5
NAME, T, B, STEPS = "smollm-135m", 16, 4, 2
CONFIGS = {"base": {}, "narrow": dict(n_heads=9, n_kv_heads=3, head_dim=8)}
CELLS = [  # (id, kind, rules, global batch, config)
    (f"{kind}-{rules}", kind, rules, B, "base")
    for rules in ("DEFAULT_RULES", "TP_ONLY_RULES", "SP_RULES", "DP_ONLY_RULES", "EP_DP_RULES")
    for kind in ("prefill", "decode")
] + [
    ("decode-seq-cut-cache", "decode", "DEFAULT_RULES", B, "narrow"),
    ("decode-one-row", "decode", "DEFAULT_RULES", 1, "base"),
]

# One subprocess: each cell compiled and run on (2, 2), each output's shards
# saved by mesh position, its spec printed.
REF_CODE = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, "src")
import dataclasses
import numpy as np
import jax
import jax.numpy as jnp
from repro.configs import ARCHS
from repro.configs.base import ShapeConfig
from repro.launch.mesh import make_mesh
from repro.launch.specs import build_cell, choose_rules, pick_backend
from repro.sharding import partitioning
from repro.sharding.hints import use_hints

where, name, T, steps, configs, cells = sys.argv[1:]
T, steps, configs = int(T), int(steps), json.loads(configs)
mesh = make_mesh((2, 2), ("data", "model"))
position = {d.id: p for p, d in enumerate(mesh.devices.flat)}
tokens = np.load(os.path.join(where, "tokens.npy"))
saved = {}


def nest(flat):
    out = {}
    for key, value in flat.items():
        node = out
        *head, last = key.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = value
    return out


def keep(cell_id, step, out):
    for shard in out.addressable_shards:
        saved[f"{cell_id}/{step}/{position[shard.device.id]}"] = np.asarray(shard.data)
    spec = list(out.sharding.spec) + [None] * (out.ndim - len(out.sharding.spec))
    print(json.dumps(dict(cell=cell_id, shape=list(out.shape),
                          spec=[list(s) if isinstance(s, tuple) else s for s in spec])), flush=True)


for cell_id, kind, rules_name, GB, config in json.loads(cells):
    cfg = dataclasses.replace(ARCHS[name].reduced(), **configs[config])
    shape = ShapeConfig("c", T, GB, kind)
    rules = getattr(partitioning, rules_name)
    cell = build_cell(cfg, shape, mesh, rules)
    active = choose_rules(pick_backend(cfg, shape), shape, rules)
    weights = nest(dict(np.load(os.path.join(where, config + ".npz"))))
    params = jax.tree.map(lambda x, s: jnp.asarray(x, s.dtype), weights, cell.args[0])
    with mesh, use_hints(mesh, active):
        step = jax.jit(cell.step_fn, in_shardings=cell.in_shardings,
                       out_shardings=cell.out_shardings, donate_argnums=cell.donate_argnums)
        if kind == "prefill":
            keep(cell_id, 0, step(params, jnp.asarray(tokens[:GB])))
            continue
        cache = jax.tree.map(lambda s: jnp.zeros(s.shape, jnp.float32), cell.args[3])
        for pos in range(steps):
            tok = jnp.asarray(tokens[:GB, pos : pos + 1])
            logits, cache = step(params, tok, jnp.int32(pos), cache)
            keep(cell_id, pos, logits)
np.savez(os.path.join(where, "ref.npz"), **saved)
"""


def _weights(cfg) -> dict:
    """The reference's parameter tree of ``cfg`` as numpy arrays drawn from
    one seed, each matrix scaled by its fan-in, norm scales near 1."""
    rng = np.random.default_rng(0)
    like = convert.lm_params_to_numpy(cfg, tf.init_params(cfg, seed=0, device="cpu"))
    out = {}

    def draw(tree, path):
        for key, value in tree.items():
            if isinstance(value, dict):
                draw(value, path + (key,))
                continue
            x = rng.standard_normal(value.shape)
            if key == "scale":
                x = 1 + 0.1 * x
            elif value.ndim >= 2:
                x = x / np.sqrt(value.shape[-2])
            out["/".join(path + (key,))] = x.astype(np.float32)

    draw(like, ())
    return out


def _nest(flat: dict) -> dict:
    out: dict = {}
    for key, value in flat.items():
        node = out
        *head, last = key.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = value
    return out


def _config(config: str):
    import dataclasses

    return dataclasses.replace(ARCHS[NAME].reduced(), **CONFIGS[config])


class Reference:
    """The reference's subprocess, started once; ``result()`` waits for it
    and reads its blocks and specs."""

    def __init__(self, where: Path):
        self.where = where
        rng = np.random.default_rng(1)
        self.tokens = rng.integers(0, ARCHS[NAME].reduced().vocab_size, (B, T)).astype(np.int32)
        np.save(where / "tokens.npy", self.tokens)
        self.weights = {}
        for config in CONFIGS:
            self.weights[config] = _weights(_config(config))
            np.savez(where / f"{config}.npz", **self.weights[config])
        args = [str(where), NAME, str(T), str(STEPS), json.dumps(CONFIGS), json.dumps(CELLS)]
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        self.proc = subprocess.Popen(
            [sys.executable, "-c", REF_CODE, *args],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO, env=env,
        )
        self.done = None

    def result(self):
        if self.done is None:
            out, err = self.proc.communicate(timeout=600)
            assert self.proc.returncode == 0, out[-2000:] + err[-3000:]
            specs_ = {}
            for line in out.splitlines():
                if line.startswith("{"):
                    row = json.loads(line)
                    specs_[row["cell"]] = row
            self.done = (dict(np.load(self.where / "ref.npz")), specs_)
        return self.done

    def close(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    ref = Reference(tmp_path_factory.mktemp("logits"))
    yield ref
    ref.close()


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _no_gather(*args, **kwargs):
    raise AssertionError("a sharded serving step gathered onto one member")


def _port(reference: Reference, kind: str, rules: str, GB: int, config: str, monkeypatch) -> list:
    """The port's cell on 2 x 2 CPU slots: its logits (``Sharded``) a step."""
    cfg = _config(config)
    params = convert.lm_params_from_numpy(cfg, _nest(reference.weights[config]), device="cpu")
    mesh = make_mesh((2, 2), ("data", "model"), devices=["cpu"] * 4)
    shape = ShapeConfig("c", T, GB, kind)
    cell = specs.build_cell(cfg, shape, mesh, getattr(part, rules), params=params)
    tokens = torch.from_numpy(reference.tokens[:GB])
    monkeypatch.setattr(coll, "gather", _no_gather)
    if kind == "prefill":
        return [cell.step_fn(cell.args[0], tokens)]
    cache = device_put(tf.init_cache(cfg, GB, T, dtype=torch.float32, device="cpu"), cell.in_shardings[3])
    out = []
    for pos in range(STEPS):
        logits, cache = cell.step_fn(cell.args[0], tokens[:, pos : pos + 1], pos, cache)
        out.append(logits)
    return out


@pytest.mark.parametrize("cell_id, kind, rules, GB, config", CELLS, ids=[c[0] for c in CELLS])
def test_blocks_are_the_references_shards(reference, cell_id, kind, rules, GB, config, monkeypatch):
    got = _port(reference, kind, rules, GB, config, monkeypatch)
    blocks, ref_specs = reference.result()
    want_spec = ref_specs[cell_id]
    for step, logits in enumerate(got):
        assert isinstance(logits, Sharded), type(logits)
        assert list(logits.shape) == want_spec["shape"]
        spec = [list(s) if isinstance(s, tuple) else s for s in logits.sharding.spec]
        assert spec == want_spec["spec"], (cell_id, spec, want_spec["spec"])
        ref = [blocks[f"{cell_id}/{step}/{p}"] for p in range(4)]
        scale = max(1.0, max(float(np.abs(r).max()) for r in ref))
        storages = set()
        for p, want in enumerate(ref):
            block = logits.local(p)
            assert tuple(block.shape) == want.shape, (cell_id, step, p)
            assert block.device == logits.sharding.mesh.devices[p]
            storages.add(block.untyped_storage().data_ptr())
            worst = float(np.abs(block.double().numpy() - want).max())
            assert worst <= STEP_TOL * scale, (cell_id, step, p, worst)
        assert len(storages) == 4, f"{cell_id}: positions share a block"


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_class_trace_blocks_on_their_devices(kind):
    """On a 4 x 2 mesh of fake devices, one position traced a class: each
    position's logits block lies on its own device with its sharding's
    block shape, so ``position_bytes`` is exact everywhere."""
    sizes, GB = (4, 2), 8
    cfg = ARCHS[NAME].reduced()
    mesh = dryrun.fake_mesh(sizes, ("data", "model"))
    run = sorted(set(class_reps(sizes)))
    with FakeTensorMode(), card_stand_in():
        cell = specs.build_cell(cfg, ShapeConfig("c", T, GB, kind), mesh, part.TP_ONLY_RULES)
        args = list(cell.args)
        if kind == "decode":
            args[2] = 0
        with running(run):
            out = cell.step_fn(*args)
        logits = out if kind == "prefill" else out[0]
    assert isinstance(logits, Sharded)
    assert logits.shape == (GB, T if kind == "prefill" else 1, cfg.vocab_size)
    assert tuple(logits.sharding.spec) == ("data", None, "model")
    block = logits.sharding.shard_shape(logits.shape)
    for p, shard in enumerate(logits.shards):
        assert shard.device == mesh.devices[p], p
        assert tuple(shard.shape) == block, p
        assert (getattr(shard, "mesh_position", None) is None) == (p in run), p
    assert logits.position_bytes() == [np.prod(block) * 4] * mesh.size
