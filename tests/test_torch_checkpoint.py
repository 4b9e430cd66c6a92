"""Checkpoints, the data loader and the training entry point of the port,
on the CPU.

The reference's six checkpoint cases (``tests/test_checkpoint.py``) on the
port, a tree of devices standing in for its resharding case; checkpoints
crossing between the packages both ways (``{"params", "opt"}`` of a
reduced model, every array equal); the loader's batches byte-equal to the
reference's; ``launch.train``'s failure drill (exit 42, then the resume,
whose final parameters equal an uninterrupted run's bit for bit: the same
operations on the same CPU); and ``tests/test_system.py``'s LM pillar on
the port.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.data import loader as jloader  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro.train import train_step as jts  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import data as tdata  # noqa: E402
from repro_torch import train as ttrain  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.data.loader import ShardedLoader, lm_token_batches, prefetched  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models.transformer import init_cache, init_params  # noqa: E402
from repro_torch.serve.decode_step import greedy_generate  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train.train_step import (  # noqa: E402
    OptimizerConfig,
    init_opt_state,
    make_train_step,
)

SRC = Path(__file__).resolve().parents[1] / "src"


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "layers": {"w": torch.from_numpy(rng.standard_normal((4, 8)).astype(np.float32))},
        "head": (
            torch.from_numpy(rng.standard_normal(3).astype(np.float32)),
            torch.tensor(2.5, dtype=torch.float32),
        ),
    }


def _leaves(tree):
    return [x for x in jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, torch.Tensor))]


# ------------------------------------------------- the reference's six cases


def test_save_restore_roundtrip(tmp_path):
    t = _tree()
    ckpt.save(str(tmp_path), 7, t)
    assert ckpt.latest_step(str(tmp_path)) == 7
    like = jax.tree.map(
        lambda x: torch.empty(x.shape, dtype=x.dtype, device="meta"),
        t,
        is_leaf=lambda x: isinstance(x, torch.Tensor),
    )
    r = ckpt.restore(str(tmp_path), 7, like)
    assert isinstance(r["head"], tuple)
    for a, b in zip(_leaves(t), _leaves(r)):
        assert b.device.type == "cpu"
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_latest_pointer_advances_atomically(tmp_path):
    t = _tree()
    ckpt.save(str(tmp_path), 1, t)
    plus = {"layers": {"w": t["layers"]["w"] + 1}, "head": tuple(x + 1 for x in t["head"])}
    ckpt.save(str(tmp_path), 2, plus)
    assert ckpt.latest_step(str(tmp_path)) == 2
    r1 = ckpt.restore(str(tmp_path), 1, t)
    r2 = ckpt.restore(str(tmp_path), 2, t)
    np.testing.assert_allclose(r2["layers"]["w"].numpy(), r1["layers"]["w"].numpy() + 1)


def test_async_checkpointer(tmp_path):
    t = _tree()
    saver = ckpt.AsyncCheckpointer(str(tmp_path))
    saver.save(11, t)
    t["layers"]["w"].add_(100.0)  # the next step updates in place: the snapshot is a copy
    saver.wait()
    assert saver.last_committed == 11
    assert ckpt.latest_step(str(tmp_path)) == 11
    r = ckpt.restore(str(tmp_path), 11, t)
    np.testing.assert_array_equal(r["layers"]["w"].numpy(), _tree()["layers"]["w"].numpy())


def test_restore_with_resharding(tmp_path):
    """The port's counterpart of resharding on restore: a tree of devices
    (or one device) that each array is placed on."""
    t = _tree()
    ckpt.save(str(tmp_path), 3, t)
    cpu = torch.device("cpu")
    placement = {"layers": {"w": cpu}, "head": (cpu, "cpu")}
    r = ckpt.restore(str(tmp_path), 3, t, shardings=placement)
    assert all(x.device == cpu for x in _leaves(r))
    r1 = ckpt.restore(str(tmp_path), 3, t, shardings=cpu)
    for a, b in zip(_leaves(r), _leaves(r1)):
        assert torch.equal(a, b)
    cfg = ARCHS["smollm-135m"].reduced()
    params = init_params(cfg, seed=2, device="cpu")
    ckpt.save(str(tmp_path), 4, {"params": params})
    got = ckpt.restore(str(tmp_path), 4, {"params": params}, shardings={"params": cpu})
    assert got["params"] is not params
    assert all(torch.equal(a, b) for a, b in zip(got["params"].parameters(), params.parameters()))


def test_loader_is_step_resumable():
    X = np.arange(1000, dtype=np.float32).reshape(100, 10)
    y = np.arange(100, dtype=np.float32)
    l1 = ShardedLoader(X, y, global_batch=8, seed=5, shard_index=1, num_shards=2)
    l2 = ShardedLoader(X, y, global_batch=8, seed=5, shard_index=1, num_shards=2)
    for step in (0, 17, 123):
        a, _ = l1.batch_at(step)
        b, _ = l2.batch_at(step)
        np.testing.assert_array_equal(a, b)
    l0 = ShardedLoader(X, y, global_batch=8, seed=5, shard_index=0, num_shards=2)
    a0, _ = l0.batch_at(3)
    a1, _ = l1.batch_at(3)
    assert a0.shape == a1.shape == (4, 10)


def test_crash_safe_tmpdir_never_latest(tmp_path):
    t = _tree()
    ckpt.save(str(tmp_path), 1, t)
    os.makedirs(tmp_path / "step_2.tmp")
    assert ckpt.latest_step(str(tmp_path)) == 1
    assert ckpt.restore(str(tmp_path), 1, t) is not None


# ------------------------------------------------ across the two packages


def _reduced_state(name):
    """A reduced model's reference weights and optimizer state (moments
    made nonzero), and the port's copies of both."""
    jcfg, cfg = JARCHS["smollm-135m"].reduced(), ARCHS["smollm-135m"].reduced()
    jparams, _ = jtf.init_params(jcfg, jax.random.PRNGKey(4))
    jocfg = jts.OptimizerConfig(name=name, compress_grads=True)
    rng = np.random.default_rng(0)
    jst = jax.tree.map(
        lambda x: np.asarray(x) + rng.standard_normal(x.shape).astype(x.dtype)
        if x.dtype == np.float32 else np.asarray(x) + 3,
        jts.init_opt_state(jocfg, jparams),
    )
    jparams = jax.tree.map(np.asarray, jparams)
    params = convert.lm_params_from_numpy(cfg, jparams, device="cpu")
    return cfg, jparams, jst, params, convert.opt_state_from_numpy(jst, device="cpu")


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_checkpoints_cross_between_the_packages(tmp_path, name):
    cfg, jparams, jst, params, st = _reduced_state(name)
    ocfg = OptimizerConfig(name=name, compress_grads=True)
    blank = init_params(cfg, seed=9, device="cpu")
    like = {"params": blank, "opt": init_opt_state(ocfg, blank, device="cpu")}
    # the reference writes, the port restores
    jckpt.save(str(tmp_path / "j"), 5, {"params": jparams, "opt": jst})
    got = ckpt.restore(str(tmp_path / "j"), 5, like)
    assert jax.tree.structure(convert.opt_state_to_numpy(got["opt"])) == jax.tree.structure(jst)
    for a, b in zip(jax.tree.leaves(convert.opt_state_to_numpy(got["opt"])), jax.tree.leaves(jst)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    back = convert.lm_params_to_numpy(cfg, got["params"])
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jparams)):
        np.testing.assert_array_equal(a, b)
    # the port writes, the reference restores
    ckpt.save(str(tmp_path / "t"), 6, {"params": params, "opt": st})
    r = jckpt.restore(str(tmp_path / "t"), 6, {"params": jparams, "opt": jst})
    for a, b in zip(jax.tree.leaves(r), jax.tree.leaves({"params": jparams, "opt": jst})):
        assert a.dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, b)
    with np.load(tmp_path / "t" / "step_6" / "arrays.npz") as port, np.load(
        tmp_path / "j" / "step_5" / "arrays.npz"
    ) as ref:
        assert sorted(port.files) == sorted(ref.files)


def test_lm_params_convert_both_ways():
    cfg, jparams, jst, params, st = _reduced_state("adamw")
    back = convert.lm_params_to_numpy(cfg, params)
    assert jax.tree.structure(back) == jax.tree.structure(jparams)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jparams)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(jax.tree.leaves(convert.opt_state_to_numpy(st)), jax.tree.leaves(jst)):
        np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------- loader


def test_loader_batches_are_the_references():
    X = np.random.default_rng(0).standard_normal((50, 6)).astype(np.float32)
    y = np.arange(50, dtype=np.int32)
    for shard in (0, 1, 2):
        ours = ShardedLoader(X, y, global_batch=12, seed=3, shard_index=shard, num_shards=3)
        ref = jloader.ShardedLoader(X, y, global_batch=12, seed=3, shard_index=shard, num_shards=3)
        for step in (0, 1, 99):
            for a, b in zip(ours.batch_at(step), ref.batch_at(step)):
                assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    ours, ref = lm_token_batches(512, 4, 33, seed=42), jloader.lm_token_batches(512, 4, 33, seed=42)
    for step in (0, 7, 1000):
        a, b = ours(step), ref(step)
        assert sorted(a) == sorted(b) == ["labels", "tokens"]
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes()
    it = prefetched(ours, 5)
    assert next(it)["tokens"].tobytes() == ref(5)["tokens"].tobytes()
    assert next(it)["tokens"].tobytes() == ref(6)["tokens"].tobytes()
    it.close()
    assert tdata.__all__[-2:] == ["ShardedLoader", "lm_token_batches"]
    from repro import train as jtrain

    assert ttrain.__all__ == jtrain.__all__
    assert all(callable(getattr(ttrain, name)) for name in ttrain.__all__)


# ------------------------------------------------------- the entry point


def _flags(ckpt_dir, *extra):
    return [
        "--device", "cpu", "--arch", "smollm-135m", "--reduced", "--steps", "8",
        "--batch", "4", "--seq", "32", "--ckpt-every", "3", "--log-every", "1",
        "--ckpt-dir", str(ckpt_dir), *extra,
    ]


def test_failure_drill_resumes_to_the_uninterrupted_run(tmp_path, capsys):
    with pytest.raises(SystemExit) as died:
        launch_train.main(_flags(tmp_path / "a", "--simulate-failure", "5"))
    assert died.value.code == 42
    first = capsys.readouterr().out
    assert "SIMULATED NODE FAILURE at step 5" in first
    assert not (tmp_path / "a" / "step_7").exists()
    launch_train.main(_flags(tmp_path / "a"))
    resumed = capsys.readouterr().out
    last = int(resumed.split("[train] resumed from step ")[1].split()[0])
    assert last == 3  # the committed step at the failure (step 6 was never reached)
    assert "[train] done" in resumed
    line = lambda out, s: next(ln for ln in out.splitlines() if f"step {s:5d} loss" in ln)
    assert line(first, 4).split("gnorm")[0] == line(resumed, 4).split("gnorm")[0]
    launch_train.main(_flags(tmp_path / "b"))
    assert "resumed" not in capsys.readouterr().out
    with np.load(tmp_path / "a" / "step_7" / "arrays.npz") as a, np.load(
        tmp_path / "b" / "step_7" / "arrays.npz"
    ) as b:
        assert sorted(a.files) == sorted(b.files)
        assert any(k.startswith("opt/m/") for k in a.files)
        for k in a.files:
            assert a[k].tobytes() == b[k].tobytes(), k


def test_entry_point_runs_to_done_as_a_module():
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
           "--arch", "smollm-135m", "--reduced", "--steps", "6"]
    out = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=120, check=True)
    assert out.stdout.splitlines()[-1] == "[train] done"
    assert "[train] step     0 loss" in out.stdout


# ----------------------------------------------------------- LM pillar


def test_lm_pillar_end_to_end(tmp_path):
    """Pillar B on the port: init -> train steps -> async ckpt -> restore ->
    decode."""
    import dataclasses

    cfg = dataclasses.replace(
        ARCHS["qwen2-0.5b"].reduced(), n_layers=2, d_model=64, n_heads=2,
        n_kv_heads=2, head_dim=32, d_ff=128, vocab_size=256,
    )
    ocfg = OptimizerConfig(peak_lr=1e-3, warmup=2, total_steps=10)
    params = init_params(cfg, seed=0, device="cpu")
    state = init_opt_state(ocfg, params, device="cpu")
    step_fn = make_train_step(cfg, ocfg)
    make = lm_token_batches(cfg.vocab_size, batch=4, seq_len=32, seed=7)
    for s in range(4):
        batch = {k: torch.from_numpy(v) for k, v in make(s).items()}
        params, state, metrics = step_fn(params, state, batch, s)
        assert np.isfinite(float(metrics["loss"]))

    saver = ckpt.AsyncCheckpointer(str(tmp_path))
    saver.save(3, {"params": params})
    saver.wait()
    restored = ckpt.restore(str(tmp_path), 3, {"params": params})["params"]
    assert all(torch.equal(a, b) for a, b in zip(restored.parameters(), params.parameters()))

    prompt = torch.tensor([[1, 2, 3]], dtype=torch.int32)
    cache = init_cache(cfg, 1, 64, params=restored, dtype=torch.float32, device="cpu")
    toks, _ = greedy_generate(cfg, restored, prompt, cache, steps=4)
    assert toks.shape == (1, 4)
    assert int(toks.max()) < cfg.vocab_size
