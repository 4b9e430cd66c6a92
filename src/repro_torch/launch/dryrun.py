"""Dry run of the port's LM cells over a production mesh, with no card.

The counterpart of ``repro/launch/dryrun.py``, which lowers and compiles
each (arch x shape x mesh) cell for 256 or 512 forced host devices and
reads XLA's memory and cost analyses. The port compiles nothing: it runs
its own program, the lockstep sharded step of ``launch.specs.build_cell``,
on fake tensors (``FakeTensorMode``: shapes, dtypes and devices, no data)
over a mesh of fake devices, under ``launch.op_cost.CostRecorder``, on the
16 x 16 mesh or the 2 x 16 x 16 one (``--multi-pod``). The fake devices are
``meta:0 ... meta:127`` and then ``lazy:0 ... lazy:127``: a CPU-only
PyTorch cannot index or copy into a fake tensor on a ``cuda`` device (its
Python bindings take a CUDA device guard, which such a build lacks), fake
``meta`` and ``lazy`` devices keep the index, the checks across devices
and every view, and an index has 8 bits. Kernels B8 and B9 stand on their
launch ops' shape rules (``kernels.build.card_stand_in``).

One position of each class is traced (``sharding.spmd.class_reps``): a
position's counts depend only on which groups it leads, since every
member of a collective does alike but for the scalars summed on a
group's first member, so its class is the set of mesh axes on which its
coordinate is 0 (4 classes on 16 x 16, 8 on 2 x 16 x 16), and the
positions at coordinates 0 or 1 on every axis stand for them. The
program runs those positions only; each other member of a group they
join takes a stand-in of its representative's shape on its own device
(``collectives.stand_in``), made where nothing counts it, and each
collective runs over every member, so a traced position records exactly
what it would in a full trace. (The attention of heads that do not
divide "model" runs over blocks of a group, ``spmd.Lockstep.spread``,
each as much as the others, but led by members that do not lead the
group: so the program's calls are counted at every place they join, not
at their first member, ``program_calls``.) Every other position takes
its class's counts, copied (``total`` sums each class's counts times its
size); a leaf's block that differs in shape from its class
representative's raises. Argument, output and alias bytes stay exact at
every position, from the placements. The traced positions hold fake
devices of their own; on 2 x 16 x 16 the others share the remaining
indices (``fake_devices``).

A cell is traced at one and at two periods of layers (a layer;
``hybrid_attn_every`` layers and the shared block for zamba2,
``cross_attn_every`` for the VLM, as ``ModelConfig.reduced`` counts
them), and a train step at three as well (``depths``), every additive
count extrapolated to the full depth through those points (a cell no
deeper than its depths is traced whole): the
counterpart of ``hlo_cost``'s trip-count multiplication. The layout
policy (rules, optimizer, microbatches) is the full-depth config's.

Per cell, ``results/dryrun_torch/<arch>__<shape>__<mesh>[__...].json``
(``16x16`` or ``2x16x16``) holds the reference's keys: ``meta``'s fields,
``mesh``, ``rules``, ``n_devices``, ``memory`` (argument, output, temp,
alias and peak bytes), ``cost`` (flops and bytes accessed, and matmul
flops by dtype), ``collectives`` and ``collective_ops``, for the mesh
position with the largest peak (``position``: the positions may differ,
as a scalar is summed on a group's first member), with ``trace_seconds`` in
place of ``compile_seconds``, ``depth_traced``: the periods traced, and
``classes``: each traced position and the positions its counts stand
for, ``class_peaks`` each one's peak bytes. ``total`` sums the cost over
every device, ``kernels`` counts the launch ops and ``calls`` every
collective call of the program. Argument and output bytes are the placed
leaves' (``Sharded.position_bytes``: the parameters, the cache, and the
serving steps' logits, which stay where they were computed, in the
reference's layout), a scalar whole on every position, and, as XLA
counts them, 8 bytes a leaf of an output tuple; alias bytes are the
donated arguments'. The position's op counts go to ``<tag>.ops.json.gz``
(``profile_cell``; ``--reanalyze`` prices them again without a trace).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-135m --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-34b --shape decode_32k --multi-pod
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all    # the 80 cells on both meshes
"""

from __future__ import annotations

import argparse
import collections
import concurrent.futures
import dataclasses
import gzip
import json
import math
import multiprocessing
import os
import time
import traceback
from fractions import Fraction

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import ARCHS
from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig
from repro_torch.kernels.build import card_stand_in
from repro_torch.launch.mesh import Mesh, make_mesh, make_production_mesh
from repro_torch.launch.op_cost import FAKE_BLOCK, FAKE_TYPES, CostRecorder, price
from repro_torch.launch.specs import build_cell, choose_optimizer, choose_rules, pick_backend
from repro_torch.sharding.partitioning import (
    DEFAULT_RULES,
    DP_ONLY_RULES,
    EP_DATA_RULES,
    EP_DP_RULES,
    SP_RULES,
    TP_ONLY_RULES,
    AxisRules,
    Sharded,
)
from repro_torch.sharding.spmd import class_reps, class_sizes, rules_name, running
from repro_torch.train.train_step import OptimizerConfig

RESULTS_DIR = "results/dryrun_torch"
RULES = {
    "auto": None,
    "default": DEFAULT_RULES,
    "tp_only": TP_ONLY_RULES,
    "dp_only": DP_ONLY_RULES,
    "ep_data": EP_DATA_RULES,
    "ep_dp": EP_DP_RULES,
    "sp": SP_RULES,
}
TUPLE_ENTRY_BYTES = 8  # XLA's pointer a leaf of an output tuple
FAKE_CACHE_DEVICES = 16  # FakeTensorMode's dispatch cache pays up to this many traced positions


def fake_devices(n: int, run=()) -> list[torch.device]:
    """The dry run's mesh positions: ``meta:0 ... meta:127``, then
    ``lazy:0 ... lazy:127`` (``op_cost.FAKE_TYPES``), one a position up to
    256 (a device index has 8 bits). Past that, the positions in ``run``
    (those a class trace runs) keep devices of their own, position p < 256
    its own index's, the others the first indices left; every other
    position shares the indices none of ``run`` holds."""
    most = len(FAKE_TYPES) * FAKE_BLOCK
    pool = [torch.device(FAKE_TYPES[i // FAKE_BLOCK], i % FAKE_BLOCK) for i in range(most)]
    if n <= most:
        return pool[:n]
    run = sorted(set(run))
    if not run:
        raise NotImplementedError(f"{n} fake positions share {most} devices: name those run")
    if len(run) >= most:
        raise ValueError(f"{len(run)} positions run: a dry run has {most} fake devices")
    taken = {p for p in run if p < most}
    free = iter(i for i in range(most) if i not in taken)
    own = {p: p if p < most else next(free) for p in run}
    rest = [i for i in range(most) if i not in set(own.values())]
    return [pool[own[p]] if p in own else pool[rest[p % len(rest)]] for p in range(n)]


def fake_mesh(shape: tuple[int, ...], axes: tuple[str, ...]) -> Mesh:
    """A mesh of ``shape`` over fake devices, its class representatives
    each on a device of its own."""
    devices = fake_devices(math.prod(shape), run=class_reps(tuple(shape)))
    return make_mesh(shape, axes, devices=devices)


def period_layers(cfg: ModelConfig) -> int:
    """Layers a period of the stack holds: the unit it repeats."""
    if cfg.family == "hybrid":
        return cfg.hybrid_attn_every
    if cfg.family == "vlm":
        return cfg.cross_attn_every
    return 1


def periods(cfg: ModelConfig) -> int:
    return cfg.n_layers // period_layers(cfg)


def cut(cfg: ModelConfig, n: int) -> ModelConfig:
    """``cfg`` with ``n`` periods of layers."""
    return dataclasses.replace(cfg, n_layers=n * period_layers(cfg))


def cell_config(arch: str, backend=None, scores_bf16=False, kv_int8=False) -> ModelConfig:
    """The reference's ``run_cell`` edits of ``ARCHS[arch]``."""
    cfg = ARCHS[arch]
    if backend:
        cfg = cfg.with_backend(backend)
    if scores_bf16:
        cfg = dataclasses.replace(cfg, attn_scores_dtype="bfloat16")
    if kv_int8:
        cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    return cfg


def _leaves(tree, out: list) -> list:
    if isinstance(tree, dict):
        for v in tree.values():
            _leaves(v, out)
    elif isinstance(tree, (list, tuple)) and not isinstance(tree, torch.Tensor):
        for v in tree:
            _leaves(v, out)
    elif tree is not None:
        out.append(tree)
    return out


def _placed_bytes(tree, n: int) -> list[int]:
    """Bytes each of ``n`` positions holds of the ``Sharded`` leaves."""
    total = [0] * n
    for leaf in _leaves(tree, []):
        if isinstance(leaf, Sharded):
            total = [a + b for a, b in zip(total, leaf.position_bytes())]
    return total


def _output_bytes(out, n: int) -> list[int]:
    """Bytes each of ``n`` positions holds of the step's outputs: placed
    leaves as placed; a scalar (a train step's metrics) whole on each; 8
    bytes a leaf where the outputs are a tuple of more than one."""
    leaves = _leaves(out, [])
    total = [0] * n
    for leaf in leaves:
        if isinstance(leaf, Sharded):
            nbytes = leaf.position_bytes()
        else:
            if leaf.dim():
                raise ValueError(f"a step output of shape {tuple(leaf.shape)} is not placed")
            nbytes = [leaf.element_size()] * n
        total = [a + b for a, b in zip(total, nbytes)]
    if len(leaves) > 1:
        total = [t + TUPLE_ENTRY_BYTES * len(leaves) for t in total]
    return total


def trace_cell(
    cfg: ModelConfig,
    shape: ShapeConfig,
    mesh: Mesh,
    rules: AxisRules,
    ocfg: OptimizerConfig | None = None,
    classes: bool = True,
) -> dict:
    """``build_cell`` on ``mesh`` (fake devices) and one step under a
    ``CostRecorder``, running one position of each class (``classes``;
    else every position): its ``summary()`` with "run" (the positions
    run), "arguments", "outputs", "aliases" (bytes a position, at every
    position) and "seconds". The step and the decode position go in as
    Python ints: a fake scalar has no value to read."""
    t0 = time.time()
    run = sorted(set(class_reps(mesh.sizes))) if classes else list(range(mesh.size))
    devs = [str(d) for d in mesh.devices]
    kept = {devs[p]: p for p in run}
    fake = FakeTensorMode()
    # its dispatch cache misses on most ops once many traced devices make
    # distinct keys, and a miss costs more than no cache (about 20% at 256
    # devices); with one position a class traced it pays again
    fake.cache_enabled = fake.cache_enabled and len(run) <= FAKE_CACHE_DEVICES
    with fake, card_stand_in():
        cell = build_cell(cfg, shape, mesh, rules, ocfg)
        args = list(cell.args)
        scalar = {"train": 3, "decode": 2}.get(shape.kind)
        if scalar is not None:
            args[scalar] = 0
        n = mesh.size
        arguments = _placed_bytes(cell.args, n)
        aliases = _placed_bytes([cell.args[i] for i in cell.donate_argnums], n)
        recorder = CostRecorder(skip=set(devs) - set(kept), positions=kept)
        with running(run if classes else None), recorder as rec:
            out = cell.step_fn(*args)
        outputs = _output_bytes(out, mesh.size)
        del out, args, cell
    return {
        **rec.summary(),
        "run": run,
        "arguments": arguments,
        "outputs": outputs,
        "aliases": aliases,
        "seconds": time.time() - t0,
    }


def _trace_job(cfg, shape, sizes, axes, rules, ocfg) -> dict:
    """``trace_cell`` on a fake mesh of ``sizes`` over ``axes`` (what a
    worker process is handed: devices do not pickle across builds)."""
    return trace_cell(cfg, shape, fake_mesh(sizes, axes), rules, ocfg)


def _collective_ops(counts: dict) -> list[dict]:
    return [
        {
            "kind": kind,
            "bytes": nbytes,
            "group_size": group,
            "span": span,
            "nodes": nodes,
            "count": n,
            "total_bytes": nbytes * n,
        }
        for (kind, nbytes, group, span, nodes), n in sorted(counts.items())
        if n
    ]


def _aggregate(ops: list[dict]) -> dict:
    agg: dict = {}
    for c in ops:
        a = agg.setdefault(c["kind"], {"count": 0, "bytes": 0.0})
        a["count"] += c["count"]
        a["bytes"] += c["total_bytes"]
    return agg


def depths(shape: ShapeConfig) -> tuple[int, ...]:
    """Periods a cell is traced at: one and two, and three for a train
    step, whose cost is not linear in depth. Its backward sums a stacked
    leaf's gradient from one full-size select gradient a layer, L adds of L
    layers' worth: a term in L^2, which three points fit exactly."""
    return (1, 2, 3) if shape.kind == "train" else (1, 2)


def _weights(n: int, p: int) -> list[int]:
    """Lagrange weights at ``p`` of the polynomial through 1..n: integers,
    so that integral counts extrapolate exactly."""
    out = []
    for i in range(1, n + 1):
        w = Fraction(1)
        for j in range(1, n + 1):
            if j != i:
                w *= Fraction(p - j, i - j)
        out.append(int(w))
    return out


def extrapolate(values: list, p: int):
    """The count at ``p`` periods from those at 1, 2, ... periods."""
    return sum(w * v for w, v in zip(_weights(len(values), p), values))


def _extrapolate_counts(counters: list[dict], p: int) -> dict:
    keys = set().union(*counters)
    return {k: extrapolate([c.get(k, 0) for c in counters], p) for k in keys}


def fit_sequences(per_depth: list[dict], p: int) -> collections.Counter:
    """Counts at ``p`` periods of the call keys (kind, bytes, ...) that
    ``per_depth`` lists phase by phase at each depth traced. A phase that
    makes as many calls of the same kinds and groups at every depth (the
    optimizer's, one a leaf) has each call's bytes extrapolated (a stacked
    leaf's grow with its layers); another (a block a layer) has each key's
    count extrapolated."""
    out: collections.Counter = collections.Counter()
    for phase in set().union(*per_depth):
        runs = [d.get(phase, []) for d in per_depth]
        same = all(len(r) == len(runs[0]) for r in runs) and all(
            all(x[:1] + x[2:] == items[0][:1] + items[0][2:] for x in items) for items in zip(*runs)
        )
        if same:
            for items in zip(*runs):
                nbytes = extrapolate([x[1] for x in items], p)
                out[items[0][:1] + (nbytes,) + items[0][2:]] += 1
        else:
            for key in set().union(*runs):
                out[key] += extrapolate([r.count(key) for r in runs], p)
    return collections.Counter({k: v for k, v in out.items() if v})


def program_calls(collectives: list[dict], weight, p: int) -> collections.Counter:
    """Every collective call of the program at ``p`` periods, (kind,
    bytes, group size) -> count, from each traced depth's ``collectives``
    records weighted by the positions each device stands for (``weight``).
    A call is recorded once at each distinct place among its members (its
    span), so it is counted that many times, then divided. (Not from each
    call's first member: a group cut into blocks, as
    ``spmd.Lockstep.spread`` cuts one, is led by members whose class
    representative leads none.)"""
    joined: collections.Counter = collections.Counter()
    for dev in sorted({d for c in collectives for _, d in c}):
        per_depth = [{ph: keys for (ph, d), keys in c.items() if d == dev} for c in collectives]
        for (kind, nbytes, size, span, _), count in fit_sequences(per_depth, p).items():
            joined[kind, nbytes, size, span] += weight(dev) * count
    calls: collections.Counter = collections.Counter()
    for (kind, nbytes, size, span), count in joined.items():
        n, left = divmod(count, span)
        if left:
            raise ValueError(f"{kind} of {nbytes} B: recorded {count} times, not a multiple of its span {span}")
        calls[kind, nbytes, size] += n
    return calls


def peak_fit(traces: list[dict], dev: str, traced: tuple, p: int) -> int:
    """The most ``dev`` holds on top of its arguments at ``p`` periods: the
    largest of its phases' peaks (forward, backward, after; ``CostRecorder.
    trajectory``), each on the line through the two deepest traces (the
    first period is unlike the rest: one layer's stack is stacked, summed
    and gathered apart). A phase whose live bytes change at as many points
    at each depth runs the same ops on longer stacks (the optimizer, a leaf
    at a time): each point is extrapolated and the largest taken, since
    which leaf's update holds the most moves with the depth. Another (a
    block a layer) grows by a layer's worth a layer: its peak is."""
    if len(traces) == 1:  # traced at its full depth
        return max((max(v) for k, v in traces[0]["trajectory"].items() if k[1] == dev), default=0)
    (d0, d1), last = traced[-2:], traces[-2:]
    phases = {k[0] for t in last for k in t["trajectory"] if k[1] == dev}
    best = 0
    for phase in phases:
        a, b = (t["trajectory"].get((phase, dev), []) for t in last)
        if len(a) == len(b):
            pairs = zip(a, b)
        else:
            pairs = [(max(a, default=0), max(b, default=0))]
        top = max((y + (p - d1) * (y - x) // (d1 - d0) for x, y in pairs), default=0)
        best = max(best, top)
    return best


def predict(
    cfg: ModelConfig,
    shape: ShapeConfig,
    mesh: Mesh,
    rules: AxisRules | None = None,
    ocfg: OptimizerConfig | None = None,
    *,
    workers: int = 1,
) -> tuple[dict, dict]:
    """The dry run of one cell on ``mesh`` (fake devices): (its result
    without the file's fields, the reported position's op counts for
    ``<tag>.ops.json.gz``). ``cfg`` is the full-depth config; the layout
    policy is chosen for it, then the cell is traced at ``depths(shape)``
    periods of layers (in forked processes, ``workers`` at once; never
    from a process that has touched the card), one position of each class
    (``trace_cell``), and each count extrapolated to ``periods(cfg)``; a
    cell no deeper than that is traced whole. Every position takes its
    class's counts and peak over its own arguments; ``total``, ``kernels``
    and ``calls`` are each class's counts times its size, over every
    device the program touched (the learning rate's scalars live on the
    host)."""
    cfg = pick_backend(cfg, shape)
    rules = choose_rules(cfg, shape, rules)
    dp_ways = mesh.shape.get("data", 1) * mesh.shape.get("pod", 1)
    ocfg = ocfg or choose_optimizer(cfg, shape, dp_ways=dp_ways)
    P = periods(cfg)
    traced = (P,) if P <= max(depths(shape)) else depths(shape)  # shallow: traced whole
    jobs = [(cut(cfg, k), shape, mesh.sizes, mesh.axis_names, rules, ocfg) for k in traced]
    if workers > 1:
        ctx = multiprocessing.get_context("fork")
        with concurrent.futures.ProcessPoolExecutor(workers, mp_context=ctx) as pool:
            traces = list(pool.map(_trace_job, *zip(*jobs)))
    else:
        traces = [_trace_job(*job) for job in jobs]
    n = mesh.size
    devs = [str(d) for d in mesh.devices]
    rep, size = class_reps(mesh.sizes), class_sizes(mesh.sizes)
    weight = {devs[r]: k for r, k in size.items()}

    def w(d: str) -> int:
        """The positions a device's counts stand for: its class's (a traced
        position), one (the host, where the learning rate lives)."""
        return weight.get(d, 0 if d in devs else 1)

    def fit(values):
        return extrapolate(values, P)

    per = [{d: price(t["records"], c) for d, c in t["counts"].items()} for t in traces]
    peaks = {r: peak_fit(traces, devs[r], traced, P) for r in size}
    peak = [fit([t["arguments"][p] for t in traces]) + peaks[rep[p]] for p in range(n)]
    pos = max(range(n), key=lambda p: (peak[p], -p))
    dev = devs[rep[pos]]
    zero = {"flops": 0.0, "bytes_accessed": 0.0, "matmul_flops": {}}
    at = [x.get(dev, zero) for x in per]
    arguments, outputs, aliases = (fit([t[k][pos] for t in traces]) for k in ("arguments", "outputs", "aliases"))
    cost = {
        "flops": fit([x["flops"] for x in at]),
        "bytes_accessed": fit([x["bytes_accessed"] for x in at]),
        "matmul_flops": _extrapolate_counts([x["matmul_flops"] for x in at], P),
    }
    total = {
        k: fit([sum(w(d) * v[k] for d, v in x.items()) for x in per])
        for k in ("flops", "bytes_accessed")
    }
    mm = [collections.Counter() for _ in traces]
    kernels = [collections.Counter() for _ in traces]
    for m, kn, x, t in zip(mm, kernels, per, traces):
        for d, v in x.items():
            for dtype, flops in v["matmul_flops"].items():
                m[dtype] += w(d) * flops
        for d, counts in t["counts"].items():
            for i, c in counts.items():
                if t["records"][i][3] is not None:  # a launch op
                    kn[t["records"][i][0]] += w(d) * c
    total["matmul_flops"] = _extrapolate_counts(mm, P)
    colls = [{ph: c for (ph, d), c in t["collectives"].items() if d == dev} for t in traces]
    ops = _collective_ops(fit_sequences(colls, P))
    calls = program_calls([t["collectives"] for t in traces], w, P)
    result = {
        "n_devices": n,
        "position": pos,
        "depth_traced": list(traced),
        "period_layers": period_layers(cfg),
        "periods": P,
        "rule_set": rules_name(rules),
        "optimizer": {"name": ocfg.name, "microbatches": ocfg.microbatches},
        "trace_seconds": round(sum(t["seconds"] for t in traces), 1),
        "classes": {str(r): k for r, k in sorted(size.items())},
        "class_peaks": {str(r): peak[r] for r in sorted(size)},
        "memory": {
            "argument_bytes": arguments,
            "output_bytes": outputs,
            "temp_bytes": peak[pos] - arguments - outputs + aliases,
            "alias_bytes": aliases,
            "peak_device_bytes": peak[pos],
        },
        "cost": cost,
        "total": total,
        "kernels": {k: v for k, v in _extrapolate_counts(kernels, P).items() if v},
        "collectives": _aggregate(ops),
        "collective_ops": ops,
        "calls": [
            {"kind": k, "bytes": b, "group_size": g, "count": c}
            for (k, b, g), c in sorted(calls.items())
            if c
        ],
    }
    saved = {
        "position": pos,
        "periods": P,
        "records": [t["records"] for t in traces],
        "counts": [t["counts"].get(dev, {}) for t in traces],
        "collectives": [[[ph, [list(k) for k in keys]] for ph, keys in cs.items()] for cs in colls],
    }
    return result, saved


def measure(step_fn, *args) -> dict:
    """One real step under a ``CostRecorder``, summed over its devices:
    {"total", "kernels", "calls"} as ``predict`` gives them (the
    counterpart a dry run is held against)."""
    with CostRecorder() as rec:
        out = step_fn(*args)
    del out
    calls = collections.Counter(k for keys in rec.calls.values() for k in keys)
    return {
        "total": rec.totals(),
        "kernels": dict(rec.kernels),
        "calls": [
            {"kind": k, "bytes": b, "group_size": g, "count": c}
            for (k, b, g), c in sorted(calls.items())
        ],
        "peak": dict(rec.peak),
    }


def reprice(saved: dict) -> tuple[dict, list[dict]]:
    """(cost, collective_ops) of a stored position, priced again."""
    P = saved["periods"]
    per = [
        price([_record(r) for r in recs], {int(k): v for k, v in counts.items()})
        for recs, counts in zip(saved["records"], saved["counts"])
    ]
    cost = {
        "flops": extrapolate([x["flops"] for x in per], P),
        "bytes_accessed": extrapolate([x["bytes_accessed"] for x in per], P),
        "matmul_flops": _extrapolate_counts([x["matmul_flops"] for x in per], P),
    }
    return cost, _collective_ops(fit_sequences(stored_collectives(saved), P))


def stored_collectives(saved: dict) -> list[dict]:
    """The stored position's collective keys, phase by phase, a depth."""
    return [{ph: [tuple(k) for k in keys] for ph, keys in cs} for cs in saved["collectives"]]


def _record(r) -> tuple:
    """A record read back from JSON (lists) as the tuple ``cost`` takes."""
    name, outs, ins, fixed = r
    spec = lambda xs: tuple((tuple(s), d) for s, d in xs)  # noqa: E731
    return name, spec(outs), spec(ins), None if fixed is None else tuple(fixed)


def cell_tag(arch, shape_name, rules_name="auto", microbatches=None,
             backend=None, scores_bf16=False, kv_int8=False, multi_pod=False) -> str:
    tag = f"{arch}__{shape_name}__{mesh_name(multi_pod)}"
    if rules_name != "auto":
        tag += f"__{rules_name}"
    if microbatches is not None:
        tag += f"__mb{microbatches}"
    if backend:
        tag += f"__{backend}"
    if scores_bf16:
        tag += "__sbf16"
    if kv_int8:
        tag += "__kvint8"
    return tag


def mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def production_mesh(multi_pod: bool) -> Mesh:
    """The reference's production mesh over fake devices."""
    if not multi_pod:
        return make_production_mesh(devices=fake_devices(256))
    run = class_reps((2, 16, 16))
    return make_production_mesh(multi_pod=True, devices=fake_devices(512, run=run))


def run_cell(
    arch: str,
    shape_name: str,
    rules_name: str = "auto",
    force: bool = False,
    reanalyze: bool = False,
    microbatches: int | None = None,
    backend: str | None = None,
    scores_bf16: bool = False,
    kv_int8: bool = False,
    multi_pod: bool = False,
) -> dict:
    """The reference's ``run_cell``: the cell's JSON, read back where it
    exists (unless ``force``), its costs priced again from the stored op
    counts with ``reanalyze``, else traced on the 16 x 16 mesh of fake
    devices (2 x 16 x 16 with ``multi_pod``)."""
    tag = cell_tag(arch, shape_name, rules_name, microbatches, backend,
                   scores_bf16, kv_int8, multi_pod)
    os.makedirs(RESULTS_DIR, exist_ok=True)
    path = os.path.join(RESULTS_DIR, tag + ".json")
    ops_path = os.path.join(RESULTS_DIR, tag + ".ops.json.gz")
    if os.path.exists(path) and not (force or reanalyze):
        with open(path) as f:
            return json.load(f)
    if reanalyze and os.path.exists(path) and os.path.exists(ops_path):
        with open(path) as f:
            result = json.load(f)
        with gzip.open(ops_path, "rt") as f:
            saved = json.load(f)
        result["cost"], result["collective_ops"] = reprice(saved)
        result["collectives"] = _aggregate(result["collective_ops"])
        with open(path, "w") as f:
            json.dump(result, f, indent=1)
        return result
    cfg = cell_config(arch, backend, scores_bf16, kv_int8)
    shape = SHAPES[shape_name]
    mesh = production_mesh(multi_pod)
    ocfg = None
    if microbatches is not None:
        dp_ways = mesh.shape.get("data", 1) * mesh.shape.get("pod", 1)
        base = choose_optimizer(pick_backend(cfg, shape), shape, dp_ways=dp_ways)
        ocfg = dataclasses.replace(base, microbatches=microbatches)
    body, saved = predict(cfg, shape, mesh, RULES[rules_name], ocfg, workers=len(depths(shape)))
    full = pick_backend(cfg, shape)
    meta = {
        "kind": shape.kind,
        "arch": full.name,
        "shape": shape.name,
        "family": full.family,
        "params": full.param_count(),
        "active_params": full.active_param_count(),
        "seq_len": shape.seq_len,
        "global_batch": shape.global_batch,
    }
    if shape.kind == "train":
        meta["optimizer"] = body["optimizer"]["name"]
    if shape.kind == "decode":
        meta["backend"] = full.attention_backend
    result = {
        **meta,
        "mesh": mesh_name(multi_pod),
        "rules": rules_name,
        **body,
    }
    with gzip.open(ops_path, "wt") as f:
        json.dump(saved, f)
    with open(path, "w") as f:
        json.dump(result, f, indent=1)
    return result


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--rules", default="auto", choices=list(RULES))
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--reanalyze", action="store_true",
                    help="price the stored op counts again, no trace")
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--backend", default=None, choices=[None, "maclaurin", "softmax"])
    ap.add_argument("--scores-bf16", action="store_true")
    ap.add_argument("--kv-int8", action="store_true")
    args = ap.parse_args()

    archs = [args.arch] if args.arch else sorted(ARCHS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = [False, True] if (args.all or args.both_meshes) else [args.multi_pod]

    n_ok = n_fail = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                label = f"{arch:24s} {shape:12s} {mesh_name(mp):8s}"
                try:
                    r = run_cell(arch, shape, args.rules, args.force, args.reanalyze,
                                 args.microbatches, args.backend, args.scores_bf16,
                                 args.kv_int8, mp)
                    mem_gb = r["memory"]["peak_device_bytes"] / 2**30
                    colls = sum(v["count"] for v in r["collectives"].values())
                    print(
                        f"OK   {label} flops/dev={r['cost']['flops']:.3e} "
                        f"mem/dev={mem_gb:.2f}GiB colls={colls} ({r['trace_seconds']}s)",
                        flush=True,
                    )
                    n_ok += 1
                except Exception:
                    print(f"FAIL {label}", flush=True)
                    traceback.print_exc()
                    n_fail += 1
    print(f"\ndry-run: {n_ok} ok, {n_fail} failed")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
