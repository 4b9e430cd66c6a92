"""The cost of the port's program, counted op by op at each mesh position.

The counterpart of ``repro/launch/hlo_cost.py``, the reference's
trip-count-aware cost model over the post-SPMD HLO text. The port lowers
nothing, so ``CostRecorder``, a ``TorchDispatchMode``, watches the ATen ops
the program runs (on the card, on the CPU, or on the dry run's fake
tensors: ``launch.dryrun``) and charges each to the device of its output,
one device a mesh position, with the reference's weights
(``hlo_cost.py:50-80``):

    flops         matmuls (``mm``, ``addmm``, ``bmm``, ``baddbmm``; einsum
                  and matmul reach the card as these) as
                  ``torch.utils.flop_counter`` counts them, kept by operand
                  dtype; 1 a result element for elementwise ops and
                  reductions, 4 for transcendentals (a few fused ops, such
                  as softmax and SiLU, at the sum of what they are made of);
                  kernels B8 and B9 by their work formulas
                  (``maclaurin_work``, ``flash_work``), kept under the
                  rate their bodies run at (``F32_PRODUCTS`` in f32)
    bytes         the reference's "materializing" tier: operands and
                  results of matmuls, concatenations, pads, sorts and
                  reductions; the rows an indexed read or write moves, not
                  the whole buffer (``hlo_cost.py:217-237``); each copy
                  between devices, read at its source and written at its
                  destination (the collectives' copies); the kernels' bytes.
                  Views, casts and layout copies are free, as XLA fuses them
    live bytes    each new storage's bytes from the op that makes it until
                  it is freed (a finalizer on the storage): the most a
                  position holds on top of what it held before, and the
                  live bytes after each new storage, in phases (forward,
                  backward, after: each change of
                  ``torch._C._current_graph_task_id``)
    collectives   one record for each call into ``sharding.collectives``
                  (its ``OBSERVERS``) at each member's position: kind,
                  result bytes a member, group size, and how many distinct
                  devices and nodes of ``NODE_GPUS`` consecutive mesh
                  positions the members span; and each call once.

Under a class trace (``sharding.spmd.Lockstep``'s ``run``) the recorder
``skip``s the devices of the positions that are not run: nothing is
counted or held there, and ops that make stand-ins are not counted at all
(``collectives.quiet``). A stand-in member of a collective is a device of
its own at its own mesh position; ``positions`` maps each other device to
its position where ``device_position`` cannot (past 256 fake devices).

Each op becomes a record (its name, and the shapes and dtypes of its
results and tensor operands), counted at its position; ``cost`` prices a
record from those alone, so stored counts can be priced again
(``dryrun --reanalyze``). Repeated layers repeat records; the dry run
counts one and two periods of layers and extrapolates, as ``hlo_cost``
multiplies a scan body by its trip count.

``hlo_cost.normalize_cost_analysis``, the HLO parser and the trip-count
search have no counterpart: they read XLA's output, which the port does
not have.
"""

from __future__ import annotations

import collections
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.sharding import collectives as coll

NODE_GPUS = 8  # cards a node joins by NVLink (an HGX H100 board)
# A device index is 8 bits (0-127): the dry run's fake devices are meta:0-127,
# then lazy:0-127 (the two types a CPU-only build can index and copy into
# as fake tensors).
FAKE_TYPES, FAKE_BLOCK = ("meta", "lazy"), 128

_aten = torch.ops.aten
MATMULS = {"mm": _aten.mm, "addmm": _aten.addmm, "bmm": _aten.bmm, "baddbmm": _aten.baddbmm}
# flops a result element (hlo_cost's: elementwise 1, transcendental 4; a
# fused op at the sum of the HLO ops it stands for)
_ONE = (
    "add sub rsub mul div neg abs maximum minimum eq ne lt le gt ge where clamp "
    "clamp_min clamp_max floor ceil round sign trunc reciprocal square fmod remainder "
    "floor_divide logical_not logical_and logical_or logical_xor bitwise_and "
    "bitwise_or bitwise_xor bitwise_not masked_fill lerp threshold_backward"
)
_FOUR = "exp exp2 log log2 log1p expm1 tanh rsqrt sqrt pow sigmoid sin cos atan2 erf"
FLOPS_PER_ELEMENT = {
    **{k: 1.0 for k in _ONE.split()},
    **{k: 4.0 for k in _FOUR.split()},
    "addcmul": 2.0,
    "addcdiv": 2.0,
    "silu": 5.0,  # logistic, multiply
    "gelu": 6.0,
    "softplus": 8.0,  # exp, log1p
    "_softmax": 6.0,  # subtract, exp, divide (the row max and sum: reductions)
    "_log_softmax": 9.0,
    "sigmoid_backward": 2.0,
    "tanh_backward": 2.0,
    "silu_backward": 8.0,
    "softplus_backward": 6.0,
    "_softmax_backward_data": 3.0,
    "_log_softmax_backward_data": 6.0,
}
REDUCTIONS = set(
    "sum mean amax amin max min prod argmax argmin any all logsumexp var std "
    "var_mean std_mean linalg_vector_norm norm cumsum cumprod count_nonzero".split()
)
_MATERIALIZING = {"cat", "stack", "constant_pad_nd", "sort", "topk"} | REDUCTIONS
INDEXED_READS = {"index", "_unsafe_index", "index_select", "gather", "embedding", "take"}
INDEXED_WRITES = {
    "index_put", "_index_put_impl", "_unsafe_index_put", "scatter", "scatter_add",
    "scatter_reduce", "index_add", "index_copy", "masked_scatter",
}
COPY_IN, COPY_OUT = "copy:in", "copy:out"  # a copy's two ends across devices
# B8's and f32 B9's products: f32-accurate 3xTF32 on the tensor cores, three
# TF32 products for one (``launch.roofline.PEAK_F32_3XTF32``)
F32_PRODUCTS = "3xtf32"


def flash_work(
    bh: int, t: int, d: int, dv: int, nbytes_per: int, causal: bool = True
) -> tuple[float, float]:
    """(flops, bytes) of kernel B9: for each (row, key) pair it scores (on
    or below the diagonal where causal), the q.k product (2d), p.v (2dv)
    and four elementwise operations (scale, subtract, exp, add); q, k, v
    read once and the output written once at ``nbytes_per`` a value."""
    pairs = bh * t * (t + 1) / 2.0 if causal else float(bh) * t * t
    flops = pairs * (2.0 * d + 2.0 * dv + 4.0)
    nbytes = nbytes_per * bh * t * (2.0 * d + 2.0 * dv)
    return flops, nbytes


def maclaurin_work(bh: int, t: int, d: int, dv: int, chunk: int) -> tuple[float, float]:
    """(flops, bytes) of the function kernel B8 computes: the smaller of two
    ways to the same sums. The chunked moments, as the reference kernel
    computes them: per query phi2(q) (d^2), the readout phi2(q).S2 and
    phi2(q).k2 (2 d^2 (dv + 1)), q.S1 and q.k1 (2 d (dv + 1)), and the sums
    (2 dv + 6); per key of every chunk but the last phi2(k) (d^2), S2 and
    k2 (2 d^2 (dv + 1)), S1 and k1 (2 d (dv + 1)), v0 (dv); per (row, key)
    pair of a chunk on or below the diagonal q.k (2d), w(u) (4) and w v plus
    the row sum (2 dv + 2). The causal quadratic form: that last count over
    every pair on or below the diagonal, the smaller below T ~ 2 d dv. The
    inputs are f32 (the reference casts them), read once; the output is
    written once."""
    per_q = d * d + 2.0 * d * d * (dv + 1) + 2.0 * d * (dv + 1) + 2.0 * dv + 6.0
    folded = min(t, (t - 1) // chunk * chunk)  # keys of every chunk but the last
    per_k = d * d + 2.0 * d * d * (dv + 1) + 2.0 * d * (dv + 1) + dv
    pairs = 0.0
    for c0 in range(0, t, chunk):
        n = min(chunk, t - c0)
        pairs += n * (n + 1) / 2.0
    per_pair = 2.0 * d + 2.0 * dv + 6.0
    chunked = bh * (t * per_q + folded * per_k + pairs * per_pair)
    quadratic = bh * t * (t + 1) / 2.0 * per_pair
    nbytes = 4.0 * bh * t * (2.0 * d + 2.0 * dv)
    return min(chunked, quadratic), nbytes


def _kernel_work(name: str, args) -> tuple[float, str, float]:
    """(flops, rate, bytes) of one launch op's call: the rate its body runs
    at, bf16 products for B9 in bf16 and f32 products on the tensor cores
    (``F32_PRODUCTS``) for B9 in f32 and for B8 by either route, as the
    kernels' bounds count them."""
    q, v = args[0], args[2]
    bh, t, d = q.shape
    dv = v.shape[-1]
    if name == "flash_attention":  # (q, k, v, scale, causal)
        flops, nbytes = flash_work(bh, t, d, dv, q.element_size(), bool(args[4]))
        rate = str(q.dtype) if q.dtype != torch.float32 else F32_PRODUCTS
        return flops, rate, nbytes
    flops, nbytes = maclaurin_work(bh, t, d, dv, int(args[3]))  # (q, k, v, chunk, ...)
    return flops, F32_PRODUCTS, nbytes


def _elems(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


_ITEMSIZE: dict = {}


def _bytes(spec) -> int:
    shape, dtype = spec
    size = _ITEMSIZE.get(dtype)
    if size is None:
        size = _ITEMSIZE[dtype] = getattr(torch, dtype.split(".")[-1]).itemsize
    return _elems(shape) * size


def cost(rec) -> tuple[float, dict, float]:
    """(flops, {dtype: matmul and kernel flops}, bytes) of one record:
    ``(name, results, operands, fixed)``, each result and tensor operand a
    (shape, dtype name) pair, ``fixed`` a launch op's (flops, dtype,
    bytes) or None."""
    name, outs, ins, fixed = rec
    if fixed is not None:
        flops, dtype, nbytes = fixed
        return flops, {dtype: flops}, nbytes
    if name in MATMULS:
        shapes = [torch.Size(s) for s, _ in ins]
        flops = float(flop_registry[MATMULS[name]](*shapes, out_val=None))
        nbytes = sum(_bytes(x) for x in ins + outs)
        return flops, {outs[0][1]: flops}, float(nbytes)
    if name in (COPY_IN, COPY_OUT):
        return 0.0, {}, float(_bytes(outs[0] if outs else ins[0]))
    n = _elems(outs[0][0]) if outs else 0
    flops = FLOPS_PER_ELEMENT.get(name, 1.0 if name in REDUCTIONS else 0.0) * n
    if name in _MATERIALIZING:
        nbytes = sum(_bytes(x) for x in ins + outs)
    elif name in INDEXED_READS:
        nbytes = sum(_bytes(x) for x in outs)
    elif name in INDEXED_WRITES or name == "copy":  # read and write the slots
        nbytes = 2 * _bytes(ins[-1]) if ins else 0
    else:
        nbytes = 0
    return flops, {}, float(nbytes)


def _tensors(obj, acc: list) -> list:
    if isinstance(obj, torch.Tensor):
        acc.append(obj)
    elif isinstance(obj, (list, tuple)):
        for x in obj:
            _tensors(x, acc)
    return acc


def _spec(t: torch.Tensor) -> tuple:
    return tuple(t.shape), str(t.dtype)


def _base(func) -> str:
    name = func.overloadpacket.__name__
    if name.endswith("_") and not name.endswith("__"):
        name = name[:-1]  # an in-place variant costs as its op
    return name


def device_position(device: torch.device) -> int:
    """A device's place in a mesh's device order: its index, and for the
    dry run's fake devices their place in ``FAKE_TYPES`` order."""
    index = 0 if device.index is None else device.index
    if device.type in FAKE_TYPES:
        index += FAKE_TYPES.index(device.type) * FAKE_BLOCK
    return index


class CostRecorder(TorchDispatchMode):
    """Counts, for each device (``str(device)``), the records of the ops
    whose results it holds, its live and peak new bytes, the collectives it
    joins, and, over all devices, the launch ops called and every
    collective call.

    ``counts[dev]`` maps a record's index in ``records`` to its count;
    ``trajectory[phase, dev]`` lists the live bytes after each new storage;
    ``collectives[phase, dev]`` lists, in order, the (kind, result bytes a
    member, group size, devices spanned, nodes spanned) of each collective
    ``dev`` joins; ``calls[phase]`` lists the (kind, bytes, group size) of
    each collective call whose first member is counted; ``kernels`` maps a
    launch op (a ``build.KERNELS`` name) to its calls. An op that decomposes
    (``CompositeImplicitAutograd``, which reaches the mode whole under
    ``torch.inference_mode``) is counted as the ops it runs. Devices in
    ``skip`` are not counted (a class trace's positions that are not run);
    ``positions`` maps a device to its mesh position where its index does
    not say it."""

    def __init__(self, skip=(), positions=None):
        super().__init__()
        self.skip = frozenset(skip)
        self.positions = dict(positions or {})
        self.records: list = []
        self._index: dict = {}
        self.counts: dict = collections.defaultdict(collections.Counter)
        self.live: collections.Counter = collections.Counter()
        self.peak: collections.Counter = collections.Counter()
        self.phase = 0
        self.trajectory: dict = collections.defaultdict(list)
        self._backward = False
        self.collectives: dict = collections.defaultdict(list)
        self.calls: dict = collections.defaultdict(list)
        self.kernels: collections.Counter = collections.Counter()
        self._composites: dict = {}

    # ------------------------------------------------------------ entering

    def __enter__(self):
        coll.OBSERVERS.append(self._collective)
        return super().__enter__()

    def __exit__(self, *exc):
        coll.OBSERVERS.remove(self._collective)
        return super().__exit__(*exc)

    # ------------------------------------------------------------ counting

    def _count(self, dev: str, rec: tuple, n: int = 1) -> None:
        i = self._index.get(rec)
        if i is None:
            i = self._index[rec] = len(self.records)
            self.records.append(rec)
        self.counts[dev][i] += n

    def _position(self, device, stand_in) -> int:
        if stand_in is not None:
            return stand_in
        return self.positions.get(str(device), device_position(device))

    def _collective(self, kind: str, members: list, nbytes: int) -> None:
        """One collective over ``members`` (``collectives.places``: each
        member's device and, for a stand-in, its mesh position)."""
        ids = [str(d) if pos is None else ("stand-in", pos) for d, pos in members]
        nodes = len({self._position(d, pos) // NODE_GPUS for d, pos in members})
        key = (kind, nbytes, len(members), len(set(ids)), nodes)
        self._phase()
        for dev in sorted({str(d) for d, pos in members if pos is None} - self.skip):
            self.collectives[self.phase, dev].append(key)
        lead, stand_in = members[0]
        if stand_in is None and str(lead) not in self.skip:
            self.calls[self.phase].append((kind, nbytes, len(members)))

    def _phase(self) -> None:
        """A new phase at each entry to or exit from a backward pass."""
        backward = torch._C._current_graph_task_id() != -1
        if backward != self._backward:
            self._backward = backward
            self.phase += 1

    def _free(self, dev: str, nbytes: int) -> None:
        self.live[dev] -= nbytes

    def _composite(self, func) -> bool:
        known = self._composites.get(func)
        if known is None:
            known = func.namespace == "aten" and torch._C._dispatch_has_kernel_for_dispatch_key(
                func.name(), "CompositeImplicitAutograd"
            )
            self._composites[func] = known
        return known

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if coll.quiet():  # a stand-in: no work of the program
            return func(*args, **kwargs)
        if self._composite(func):  # reached whole under inference_mode
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        self._phase()
        ins = _tensors(args, [])
        _tensors(list(kwargs.values()), ins)
        outs = _tensors(out, [])
        if not outs:  # a query (sizes, a device, a scalar): no work
            return out
        where = outs[0].device
        dev = str(where)
        name = _base(func)
        fixed = None
        if func.namespace == "repro_torch":
            if dev not in self.skip:
                self.kernels[name] += 1
            fixed = _kernel_work(name, args)
        elif name in ("copy", "_to_copy") and ins and outs:
            src = ins[-1]
            if src.device != where:  # across devices: read there, written here
                spec = (_spec(src),)
                if str(src.device) not in self.skip:
                    self._count(str(src.device), (COPY_OUT, (), spec, None))
                if dev not in self.skip:
                    self._count(dev, (COPY_IN, spec, (), None))
                name = None
            elif name == "_to_copy":
                name = "cast"
        if name is not None and dev not in self.skip:
            rec = (name, tuple(_spec(t) for t in outs), tuple(_spec(t) for t in ins), fixed)
            self._count(dev, rec)
        self._track(outs, ins)
        return out

    def _track(self, outs: list, ins: list) -> None:
        """Charge each result's storage that no operand holds to its device
        until it is freed."""
        if not outs:
            return
        held = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in held:
                continue
            held.add(key)
            nbytes = st.nbytes()
            dev = str(t.device)
            if dev in self.skip:
                continue
            live = self.live[dev] = self.live[dev] + nbytes
            if live > self.peak[dev]:
                self.peak[dev] = live
            self.trajectory[self.phase, dev].append(live)
            weakref.finalize(st, self._free, dev, nbytes)

    # ------------------------------------------------------------- reading

    def devices(self) -> list[str]:
        return sorted(set(self.counts) | set(self.peak))

    def summary(self) -> dict:
        """What was counted, as plain containers (picklable): records,
        counts, peak, collectives, calls and kernels."""
        return {
            "records": list(self.records),
            "counts": {d: dict(c) for d, c in self.counts.items()},
            "peak": dict(self.peak),
            "trajectory": dict(self.trajectory),
            "collectives": dict(self.collectives),
            "calls": dict(self.calls),
            "kernels": dict(self.kernels),
        }

    def totals(self, dev: str | None = None) -> dict:
        """flops, matmul flops by dtype and bytes at ``dev`` (all devices
        when None)."""
        devs = self.devices() if dev is None else [dev]
        merged: collections.Counter = collections.Counter()
        for d in devs:
            merged.update(self.counts.get(d, {}))
        return price(self.records, merged)


def price(records: list, counts) -> dict:
    """{"flops", "matmul_flops": {dtype: flops}, "bytes_accessed"} of
    ``counts`` (record index -> count) over ``records``."""
    flops, nbytes = 0.0, 0.0
    mm: collections.Counter = collections.Counter()
    for i, n in counts.items():
        f, m, b = cost(records[i])
        flops += n * f
        nbytes += n * b
        for dtype, v in m.items():
            mm[dtype] += n * v
    return {"flops": flops, "matmul_flops": dict(mm), "bytes_accessed": nbytes}

