"""The lockstep executor: a rule-sharded LM program over a mesh, in one
thread.

The counterpart of what the reference's GSPMD makes of its steps under
``NamedSharding``s. Each mesh position holds its blocks of the parameters
(``partitioning.device_put``), of the batch and of the KV cache. The
program runs layer by layer over every position in turn: each position's
part on its device from its local blocks, then the collective the layout
needs (``sharding.collectives``), and only then the next layer. Under a
gradient the whole program is one autograd graph spanning every position
(one thread and no barriers: the autograd engine runs a card's backward on
one worker thread, and a card repeated in the mesh would wait on itself).

What the layout asks for, as GSPMD would insert it:

  * FSDP: each leaf's "embed"-cut dim, and any other dim cut over axes
    that are not the tensor-parallel axis (but "experts"), gathered over
    its mesh axes right before its block (the gather's backward is the
    reduce-scatter of its gradient), inside the layer's remat
    (``remat_lockstep``: one autograd node over every position) so that
    the backward gathers again. Under ``EP_DP_RULES`` the batch takes
    "model", so every "ffn" dim (the dense and expert FFNs, RWKV6's
    channel mix, Mamba2's weights) is gathered so, each position computing
    its own rows on whole weights, and nothing is all-reduced;
  * tensor parallelism over "model" (when the batch is not cut over it):
    column-cut q/k/v, ``w_gate``/``w_up`` and the experts' ``ffn``,
    row-cut ``w_o``/``w_down``, each product's partial sums all-reduced;
    a vocab-cut embedding looked up by range and all-reduced; vocab-cut
    logits with a vocab-parallel cross-entropy;
  * attention on a head shard where the q and kv cuts hold whole heads (q
    shard p's heads then read kv shard p's); otherwise spread evenly over
    the group (``spread``): k and v gathered, the q heads in gcd(heads,
    members) blocks, each block's rows (the batch, then the blockwise
    softmax's query rows) over its members, q all-to-all'd within a block
    and the output back to each member's ``w_o`` rows, the partial sums
    all-reduced. Decode through a cache whose kv heads do not divide
    "model" gathers q, k and v on every member, which reads its whole
    copy of the cache: a ``MacState`` (a replica) extended with every kv
    head and read out; a KV cache, a replica or cut along its sequence
    (int8's dequantized a block at a time with its own scales), by one
    combine over the group;
  * experts over "model": each member's experts on the replicated
    dispatch buffer, then the all-reduce; over "data" (``EP_DATA_RULES``,
    ``EP_DP_RULES``): the buffer all-to-all'd to the experts' owners and
    back over each "data" group;
  * sequence parallelism (``SP_RULES``, where the sequence divides the
    tensor-parallel axis): the residual between blocks cut along the
    sequence over it, each position its (B, T/m, d) block in group order;
    a block's norm on that block, then the sequence all-gathered, and its
    partial sums reduce-scattered back to the blocks (``finish``) where
    the all-reduce would stand, a whole output sliced to the member's
    rows; the vocab-cut embedding reduce-scattered, the LM head on the
    gathered sequence. Recurrences, convolutions, routing and attention
    see the whole sequence, so the values are DEFAULT's. Decode is
    DEFAULT's;
  * the MoE aux loss from the global ``me`` and ``ce`` (their sums
    all-reduced over the batch axes), the token loss a sum over the data
    shards over the global count, each counted once.

  * RWKV6 (``ssm``): the time mix on head shards (``w_r``/``w_k``/``w_v``/
    ``w_g``, ``w0``, ``w_lora_b``, ``ln_scale`` column-cut, the replicated
    ``u`` sliced to the shard's heads, ``w_o`` row-cut and all-reduced),
    the channel mix's value projection column- then row-cut and
    all-reduced before its gate; decode on the head-cut state;
  * Mamba2 (``hybrid``): the packed projection's column cut gathered
    before it is split into z | x | B | C | dt (a cut ends mid-segment),
    the depthwise conv on the channel block its weight (and the decode
    carry) holds, then gathered; the SSD on the heads of ``w_out``'s row
    block (``A_log``, ``D``, ``dt_bias`` sliced to them), the gated
    RMSNorm's sum of squares all-reduced over the whole inner width,
    ``w_out`` row-cut and all-reduced. The shared attention block is the
    dense block under its own path prefix, its gradient summed over its
    applications by autograd;
  * cross-attention (``vlm``) on head shards, or spread as self-attention
    is, over the batch block's image tokens, no mask and no RoPE; decode
    from the cached image K/V
    (or their ``MacState``), head-cut, sequence-cut or a replica.

A class trace runs one position of each class only (``run``,
``class_reps``: the positions with coordinate 0 or 1 on every axis), the
other members of each group it runs standing in with tensors of their
representative's shapes (``collectives.stand_in``); ``launch.dryrun``
gives every other position its class's counts.

The blocks are the port's own functions (``transformer._attn_forward``,
``_attn_core``, ``_attn_decode``, ``_cross_attn_decode``,
``layers.swiglu``, ``moe.route``, ``moe.experts``, ``rwkv.time_mix_*``,
``ssm.ssd_*``) on local shards, each block under the path prefix of its
own leaves (``layers``, ``shared_attn``, ``cross_layers``). Rule sets
other than the reference's six (``RULE_SETS``) and mesh axes other than
"pod", "data" and "model" raise ``NotImplementedError``.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import math

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import Mesh
from repro_torch.models import maclaurin_attention as mac
from repro_torch.models import transformer as tf
from repro_torch.models.attention import (
    _gqa_scores_full,
    cross_attention,
    decode_attend,
    qkv_columns,
    read_kv,
    split_heads,
    write_kv,
)
from repro_torch.models.layers import apply_rope, rmsnorm, swiglu
from repro_torch.models.moe import _combine, experts, load_counts, route
from repro_torch.models.rwkv import _mm, channel_mix_parts, time_mix_decode, time_mix_forward
from repro_torch.models.ssm import _causal_conv, _split_proj, ssd_scan, ssd_step
from repro_torch.sharding import collectives as coll
from repro_torch.sharding.partitioning import (
    DEFAULT_RULES,
    DP_ONLY_RULES,
    EP_DATA_RULES,
    EP_DP_RULES,
    SP_RULES,
    TP_ONLY_RULES,
    AxisRules,
    NamedSharding,
    PartitionSpec,
    Sharded,
    axis_groups,
    batch_sharding,
)

SHARDED_FAMILIES = ("dense", "moe", "audio", "ssm", "hybrid", "vlm")
STACKS = ("layers", "cross_layers")  # leaves stacked along a layer axis
BLOCKS = STACKS + ("shared_attn",)  # the prefixes of block leaves
RULE_SETS = {
    "DEFAULT_RULES": DEFAULT_RULES,
    "TP_ONLY_RULES": TP_ONLY_RULES,
    "EP_DATA_RULES": EP_DATA_RULES,
    "DP_ONLY_RULES": DP_ONLY_RULES,
    "SP_RULES": SP_RULES,
    "EP_DP_RULES": EP_DP_RULES,
}
MESH_AXES = ("pod", "data", "model")


def rules_name(rules: AxisRules) -> str:
    """The name of the rule set ``rules`` equals; raises for any other."""
    for name, known in RULE_SETS.items():
        if known.rules == rules.rules:
            return name
    raise NotImplementedError(
        f"no sharded step under the rules {rules.rules}: only {sorted(RULE_SETS)}"
    )


def check_supported(cfg: ModelConfig, mesh: Mesh, rules: AxisRules) -> None:
    if cfg.family not in SHARDED_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family has no sharded step"
        )
    rules_name(rules)
    odd = [a for a in mesh.axis_names if a not in MESH_AXES]
    if odd:
        raise NotImplementedError(f"no sharded step over the mesh axes {odd}")
    if not mesh.devices:
        raise ValueError("a sharded step needs a mesh of devices, not an abstract one")


def logical_spec(cfg: ModelConfig) -> dict:
    """``LMParams.spec()`` of ``cfg``, its parameters built on the meta
    device (no memory)."""
    return tf.LMParams(cfg, None, "meta").spec()


def flat(tree, path=()) -> dict:
    """{path: leaf} over nested dicts."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, path + (k,)))
        return out
    return {path: tree}


def nest(flat_tree: dict) -> dict:
    out: dict = {}
    for path, value in flat_tree.items():
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = value
    return out


_LEAF = object()


def _flatten(tree):
    """(the tensors of nested dicts, lists and tuples in order, its shape
    with ``_LEAF`` in their place)."""
    leaves: list = []
    return leaves, _shape_of(tree, leaves)


def _shape_of(t, leaves: list):
    # module level, not a closure: a closure that calls itself is a reference
    # cycle, which would keep ``leaves`` (a layer's weights and its residual)
    # alive until the cycle collector runs
    if isinstance(t, torch.Tensor):
        leaves.append(t)
        return _LEAF
    if isinstance(t, dict):
        return {k: _shape_of(v, leaves) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return type(t)(_shape_of(v, leaves) for v in t)
    return t


def _unflatten(shape, leaves):
    return _filled(shape, iter(leaves))


def _filled(s, it):
    if s is _LEAF:
        return next(it)
    if isinstance(s, dict):
        return {k: _filled(v, it) for k, v in s.items()}
    if isinstance(s, (list, tuple)):
        return type(s)(_filled(v, it) for v in s)
    return s


class _Remat(torch.autograd.Function):
    """``fn(*args)`` over every mesh position as one autograd node that keeps
    only its inputs: the backward reruns ``fn`` and differentiates it in one
    nested call. ``torch.utils.checkpoint``'s non-reentrant form unpacks
    each saved tensor on its device's autograd thread, so a layer that
    spans distinct cards is recomputed from several threads at once and
    fails; this node runs on one thread and its nested backward reaches
    every card."""

    @staticmethod
    def forward(ctx, fn, shape, box, *tensors):
        ctx.fn, ctx.shape = fn, shape
        ctx.save_for_backward(*tensors)
        with torch.no_grad():
            out, box["shape"] = _flatten(fn(*_unflatten(shape, tensors)))
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        inputs = [t.detach().requires_grad_(t.requires_grad) for t in ctx.saved_tensors]
        with torch.enable_grad():
            out, _ = _flatten(ctx.fn(*_unflatten(ctx.shape, inputs)))
        pairs = [(o, g) for o, g in zip(out, grads) if o.requires_grad and g is not None]
        wrt = [t for t in inputs if t.requires_grad]
        got = iter(
            torch.autograd.grad([o for o, _ in pairs], wrt, [g for _, g in pairs], allow_unused=True)
            if pairs and wrt
            else ()
        )
        return (None, None, None, *(next(got) if t.requires_grad else None for t in inputs))


def remat_lockstep(fn, *args):
    """``fn(*args)`` recomputed in the backward pass (``_Remat``) while
    autograd records a graph through a tensor of ``args``, a plain call
    otherwise: the lockstep counterpart of ``models.layers.remat``."""
    tensors, shape = _flatten(args)
    if not (torch.is_grad_enabled() and any(t.requires_grad for t in tensors)):
        return fn(*args)
    box: dict = {}
    out = _Remat.apply(fn, shape, box, *tensors)
    return _unflatten(box["shape"], out)


def class_reps(sizes: tuple[int, ...]) -> list[int]:
    """Each position's class representative on a mesh of ``sizes``
    (row-major). A position's counts depend only on the groups it leads
    (every member of a collective sends, receives and adds alike, but a
    tensor that no dim splits evenly, such as the loss and norm scalars, is
    summed on a group's first member, which has coordinate 0 on the
    group's axes; a microbatch's rows, copied to a position from the one
    that holds them or within it, cost each position the same bytes), so
    its class is the set of axes on which its coordinate is 0; the
    representative has coordinate 0 there and 1 on the other axes."""
    coords = np.indices(sizes).reshape(len(sizes), -1)
    return [int(p) for p in np.ravel_multi_index(np.minimum(coords, 1), sizes)]


def class_sizes(sizes: tuple[int, ...]) -> dict[int, int]:
    """{a class representative: the positions of its class}."""
    return dict(collections.Counter(class_reps(sizes)))


_RUN: list = [None]  # the positions a Lockstep built now runs (None: all)


@contextlib.contextmanager
def running(run):
    """Lockstep programs built inside run the mesh positions ``run`` only
    (a class trace; None: every position)."""
    _RUN.append(None if run is None else frozenset(run))
    try:
        yield
    finally:
        _RUN.pop()


@dataclasses.dataclass(frozen=True)
class Cut:
    """How one leaf is cut as its block sees it: ``gathered`` lists the
    (dim, mesh axes) gathered right before the block; ``axes`` gives the
    mesh axes that still cut each dim after that, and ``blocks`` each
    position's block (a gathered dim whole). The stacked layer axis is
    dropped for layer leaves."""

    axes: tuple[tuple[str, ...], ...]
    blocks: tuple[tuple[slice, ...], ...]
    gathered: tuple[tuple[int, tuple[str, ...]], ...]


def _cut(leaf: Sharded, logical: tuple, drop: int, tp: str | None) -> Cut:
    """A leaf's ``Cut``: its "embed" dim, and any other dim cut over axes
    that are not the tensor-parallel axis (``tp``), gathered, but
    "experts", which the experts' exchange carries out."""
    sh = leaf.sharding
    shape = leaf.shape[drop:]
    axes = list(sh.dim_axes(len(leaf.shape)))[drop:]
    logical = (tuple(logical) + (None,) * (len(leaf.shape) - len(logical)))[drop:]
    blocks = [list(sh.index(leaf.shape, p)[drop:]) for p in range(len(leaf.shards))]
    gathered = []
    for dim, (name, ax) in enumerate(zip(logical, axes)):
        if ax and (name == "embed" or (name != "experts" and ax != (tp,))):
            gathered.append((dim, ax))
            axes[dim] = ()
            for b in blocks:
                b[dim] = slice(0, shape[dim])
    return Cut(tuple(axes), tuple(tuple(b) for b in blocks), tuple(gathered))


class Lockstep:
    """One rule-sharded program of ``cfg`` over ``mesh``: the placed
    parameters' layout (``params``, a tree of ``Sharded`` in
    ``LMParams.tree()``'s layout) and a global batch of ``global_batch``
    rows. Methods take and return one value a mesh position, in position
    order: None at a position that is not run.

    ``run``: the positions to run (default: those ``running`` names, else
    all). Every class representative (``class_reps``) must be among them,
    each on a device of its own; any other member of a group that runs
    takes a stand-in shaped as its representative's value
    (``collectives.stand_in``). Where a leaf's block at such a position
    differs in shape from its representative's, the program raises."""

    def __init__(
        self,
        cfg: ModelConfig,
        mesh: Mesh,
        rules: AxisRules,
        params: dict,
        global_batch: int,
        run=None,
    ):
        check_supported(cfg, mesh, rules)
        self.cfg, self.mesh = cfg, mesh
        self.dtype = getattr(torch, cfg.dtype)
        self.n = mesh.size
        self.devices = mesh.devices
        self.rep = class_reps(mesh.sizes)
        run = _RUN[-1] if run is None else run
        self.run = tuple(range(self.n)) if run is None else tuple(sorted(set(run)))
        self.live = frozenset(self.run)
        self.partial = len(self.run) < self.n
        if self.partial:
            missing = sorted(set(self.rep) - self.live)
            if missing:
                raise ValueError(f"a class trace runs every class representative, not {missing}")
            if len({str(self.devices[p]) for p in self.run}) < len(self.run):
                raise ValueError("a class trace runs each position on a device of its own")
        self.global_batch = global_batch
        self.batch = batch_sharding(mesh, rules, global_batch)
        self.batch_axes = tuple(self.batch.dim_axes(1)[0])
        model = mesh.shape.get("model", 1)
        self.tp = "model" if model > 1 and "model" not in self.batch_axes else None
        self.tp_groups = axis_groups(mesh, (self.tp,) if self.tp else ())
        self.member = {p: i for g in self.tp_groups for i, p in enumerate(g)}
        # sequence parallelism: the residual cut along the sequence over the
        # tensor-parallel axis between blocks, where ``forward``'s T divides it
        self.sp = self.tp is not None and rules.lookup("seq") == self.tp
        self.seq_cut = False
        self.batch_groups = axis_groups(mesh, self.batch_axes)
        off_batch = [a for a in mesh.axis_names if a not in self.batch_axes]
        reps = [g[0] for g in axis_groups(mesh, off_batch)]
        index = lambda p: self.batch.index((global_batch,), p)[0].start  # noqa: E731
        self.reps = sorted(reps, key=index)  # one position a batch block, in order
        self.vocab = params["lm_head"]["w"].shape[-1]
        spec = flat(logical_spec(cfg))
        self.cuts = {}
        for path, leaf in flat(params).items():
            self.check_blocks(leaf, path)
            self.cuts[path] = _cut(leaf, spec[path], 1 if path[0] in STACKS else 0, self.tp)

    # ------------------------------------------------------------ layout

    def check_blocks(self, leaf: Sharded, what) -> None:
        """Raise where a position that is not run holds a block of ``leaf``
        of another shape than its class representative's."""
        if not self.partial:
            return
        for p in range(self.n):
            if p not in self.live:
                got, want = leaf.shards[p].shape, leaf.shards[self.rep[p]].shape
                if got != want:
                    raise ValueError(
                        f"{what}: position {p}'s block {tuple(got)} is not its class "
                        f"representative {self.rep[p]}'s {tuple(want)}: no stand-in"
                    )

    def each(self, fn) -> list:
        """``fn(p)`` at each position that runs, None at the others. (A
        loop body is a function: its temporaries die with its call, so the
        last position holds no more than the others.)"""
        return [fn(p) if p in self.live else None for p in range(self.n)]

    def each2(self, fn) -> tuple[list, list]:
        """``each`` of a function returning a pair: two lists."""
        both = self.each(fn)
        return [b and b[0] for b in both], [b and b[1] for b in both]

    def have(self, xs: list, p: int):
        """Position ``p``'s entry of ``xs``: its own where it runs, else a
        stand-in shaped as its class representative's."""
        if p in self.live:
            return xs[p]
        return coll.stand_in(xs[self.rep[p]], self.devices[p], p)

    def runs(self, group) -> bool:
        return any(p in self.live for p in group)

    def over(self, groups, xs: list, fn) -> list:
        """``fn`` on each group's members of ``xs`` (one a position), over
        every group that a position that runs belongs to."""
        out = list(xs)
        for g in groups:
            if len(g) > 1 and self.runs(g):
                for p, y in zip(g, fn([self.have(xs, p) for p in g])):
                    if p in self.live:
                        out[p] = y
        return out

    def tp_reduce(self, xs: list) -> list:
        return self.over(self.tp_groups, xs, coll.all_reduce)

    def finish(self, xs: list, partial: bool) -> list:
        """A block's (B, T, ...) outputs a position, in the residual's
        layout: partial sums reduced over the tensor-parallel group
        (reduce-scattered along the sequence where the residual is cut
        along it, else all-reduced); whole outputs kept, or sliced to the
        member's rows where the residual is cut."""
        if not self.seq_cut:
            return self.tp_reduce(xs) if partial else xs
        if partial:
            return self.over(self.tp_groups, xs, lambda m: coll.reduce_scatter(m, 1))
        return self.each(lambda p: xs[p][:, self.seq_rows(p, xs[p].shape[1])])

    def seq_rows(self, p: int, T: int) -> slice:
        """The rows of a T-token sequence position ``p``'s residual holds."""
        rows = T // self.mesh.shape[self.tp]
        return slice(self.member[p] * rows, (self.member[p] + 1) * rows)

    def whole_seq(self, xs: list) -> list:
        """Each position's residual block gathered along the sequence over
        its tensor-parallel group (as it is where not cut)."""
        if not self.seq_cut:
            return xs
        return self.over(self.tp_groups, xs, lambda m: coll.all_gather(m, 1))

    def fsdp(self, path, xs: list) -> list:
        """Leaf ``path``'s blocks (a layer leaf's, one layer's) with the
        dims its ``Cut`` gathers gathered over the axes that cut them."""
        for dim, axes in self.cuts[path].gathered:
            groups = axis_groups(self.mesh, axes)
            xs = self.over(groups, xs, lambda m, d=dim: coll.all_gather(m, d))
        return xs

    def block(self, path, p: int, dim: int) -> slice:
        return self.cuts[path].blocks[p][dim]

    def heads_cfg(self, parts: int) -> ModelConfig:
        cfg = self.cfg
        return dataclasses.replace(
            cfg,
            n_heads=cfg.n_heads // parts,
            n_kv_heads=cfg.n_kv_heads // parts,
            head_dim=cfg.hd,
        )

    def tp_parts(self, axes) -> int:
        return self.mesh.shape[self.tp] if axes else 1

    # ------------------------------------------------------------ blocks

    def gather_tp(self, xs: list, dim: int) -> list:
        """Each member's tensor concatenated along ``dim`` over its
        tensor-parallel group."""
        return self.over(self.tp_groups, xs, lambda m: coll.all_gather(m, dim))

    def block_params(self, stacks: list[dict], prefix: str, i) -> list[dict]:
        """Block ``prefix``'s parameters a position (layer ``i`` of a stack;
        ``i`` None for the unstacked shared block), cast to the compute
        dtype and FSDP-gathered, as ``layer.tensors(dtype)`` nests them."""
        out = self.each(lambda p: {})
        for path in stacks[self.run[0]][prefix]:
            xs = self.each(lambda p: stacks[p][prefix][path])
            xs = self.each(lambda p: (xs[p] if i is None else xs[p][i]).to(self.dtype))
            xs = self.fsdp((prefix,) + path, xs)
            for p in self.run:
                out[p][path] = xs[p]
        return self.each(lambda p: nest(out[p]))

    def embed(self, top: list[dict], tokens: list) -> list:
        path = ("embed", "table")
        table = self.fsdp(path, self.each(lambda p: top[p][path]))
        cut = bool(self.cuts[path].axes[0])

        def lookup(p):  # rows of the vocab block this position holds
            rows = table[p].shape[0]
            t = tokens[p].long() - self.block(path, p, 0).start
            inside = (t >= 0) & (t < rows)
            return torch.where(inside[..., None], table[p][t.clamp(0, rows - 1)], 0.0)

        x = self.each(lookup if cut else lambda p: table[p][tokens[p]])
        x = self.finish(x, cut)
        return self.each(lambda p: x[p].to(self.dtype))

    def head(self, top: list[dict], x: list) -> list:
        """Final norm and LM head: each position's (B, T, its vocab) logits."""
        ln, head = ("final_ln", "scale"), ("lm_head", "w")
        scale = self.fsdp(ln, self.each(lambda p: top[p][ln]))
        w = self.fsdp(head, self.each(lambda p: top[p][head].to(self.dtype)))
        h = self.whole_seq(self.each(lambda p: rmsnorm({"scale": scale[p]}, x[p])))
        return self.each(lambda p: h[p] @ w[p])

    def xent_sums(self, logits: list, labels: list) -> list:
        """Each position's sum of token losses over its rows: a
        vocab-parallel cross-entropy (max, sum of exponentials and target
        logit each reduced over the vocab's cut)."""
        path = ("lm_head", "w")
        cut = bool(self.cuts[path].axes[1])
        l32 = self.each(lambda p: logits[p].to(torch.float32))
        top = self.each(lambda p: torch.amax(l32[p], dim=-1).detach())
        if cut:
            top = self.over(self.tp_groups, top, coll.all_max)

        def parts(p):
            total = torch.sum(torch.exp(l32[p] - top[p][..., None]), dim=-1)
            cols = l32[p].shape[-1]
            t = labels[p].long() - self.block(path, p, 1).start
            inside = (t >= 0) & (t < cols)
            where = t.clamp(0, cols - 1)[..., None]
            hit = torch.take_along_dim(l32[p], where, dim=-1)[..., 0]
            return total, torch.where(inside, hit, 0.0)

        total, gold = self.each2(parts)
        if cut:
            total, gold = self.tp_reduce(total), self.tp_reduce(gold)
        return self.each(lambda p: torch.sum(top[p] + torch.log(total[p]) - gold[p]))

    def attn_axes(self, key: tuple) -> tuple:
        """(q's column cut, k's and v's, ``w_o``'s row cut) of the
        attention whose leaves are under ``key``."""
        return (
            self.cuts[key + ("w_q",)].axes[1],
            self.cuts[key + ("w_k",)].axes[1],
            self.cuts[key + ("w_o",)].axes[0],
        )

    def spread_plan(self, B: int, T: int, queries: bool) -> tuple[int, int, int, int]:
        """How ``spread`` cuts a tensor-parallel group's attention: (head
        blocks g, batch blocks, query blocks, members a block of rows). The
        q heads over g = gcd(heads, members) blocks, each block's r =
        members / g consecutive members over its rows: the batch over as
        many blocks as it and r share, then the query rows where
        ``queries`` (attention whose query rows are independent: the plain
        blockwise softmax), as far as T divides; a block of rows on as many
        members as remain (1 unless a fused kernel's batch does not divide
        r)."""
        parts = self.mesh.shape[self.tp]
        g = math.gcd(self.cfg.n_heads, parts)
        r = parts // g
        gb = math.gcd(B, r)
        gt = math.gcd(r // gb, T) if queries else 1
        return g, gb, gt, r // (gb * gt)

    def spread(self, q: list, k: list, v: list, kv_cut, lp: list[dict], key: tuple, attend, queries: bool) -> list:
        """A tensor-parallel group's attention spread evenly over its
        members (where the heads do not make whole head shards): the
        partial sums of each member's ``w_o`` rows, a position. ``q``: each
        member's q columns (B, T, Hq hd / members); ``k``, ``v``: its k and
        v columns (B, S, .), cut over the group where ``kv_cut``, else
        whole. ``attend(p, q, k, v, t0)`` runs attention of q (b, t, h, hd)
        from query row ``t0`` over k, v (b, S, h_kv, hd) and returns
        (b, t, h hd).

        Each member attends with one block of q heads (``spread_plan``) and
        the kv heads they read, over one block of rows. Where the q heads
        divide the group (r = 1) the block is its own columns and nothing
        moves. Otherwise the r members of a head block, whose columns it
        is, all-to-all their q columns so that each holds the block's
        every column for its rows, and all-to-all the output back to their
        columns. k and v are all-gathered over the consecutive members
        whose columns hold the kv heads a block reads (members /
        gcd(g, Hkv) of them). Every member computes as much as the others;
        collectives over part of a group are led by members other than the
        group's first, which the dry run's call count allows for
        (``launch.dryrun.program_calls``)."""
        cfg = self.cfg
        Hq, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
        G = Hq // Hkv
        B, T = q[self.run[0]].shape[:2]
        g, gb, gt, dup = self.spread_plan(B, T, queries)
        parts = self.mesh.shape[self.tp]
        r, hq = parts // g, Hq // g
        Bb, Tb = B // gb, T // gt
        blocks = [grp[i : i + r] for grp in self.tp_groups for i in range(0, len(grp), r)]
        # the kv heads of q head block hb lie in kv group hb // (g / d): Hkv / d heads
        d = math.gcd(g, Hkv) if kv_cut else 1
        n_kv = parts // d
        kv_groups = [grp[i : i + n_kv] for grp in self.tp_groups for i in range(0, len(grp), n_kv)]

        if kv_cut:  # k and v all-gathered over each kv group
            k, v = (self.over(kv_groups, x, lambda m: coll.all_gather(m, -1)) for x in (k, v))

        def cut(x):  # (B, T, c) -> (gb gt, Bb, Tb, c), batch-major
            return x.reshape(gb, Bb, gt, Tb, -1).transpose(1, 2).reshape(gb * gt, Bb, Tb, -1)

        def sent(p):  # rows block i for members i dup ... i dup + dup - 1
            x = cut(q[p])
            return torch.repeat_interleave(x, dup, 0) if dup > 1 else x

        qs = self.over(blocks, self.each(sent), lambda m: coll.all_to_all(m, 0, -1))

        def own(p):
            hb, j = divmod(self.member[p], r)
            bi, ti = divmod(j // dup, gt)
            first = self.member[p] // n_kv * (Hkv // d)  # the kv group's first kv head
            kv = [i // G - first for i in range(hb * hq, (hb + 1) * hq)]
            if hq % G == 0 or G % hq == 0:  # a block of kv heads
                heads = slice(kv[0], kv[-1] + 1)
            else:  # its q heads read kv heads unevenly: a kv head a q head
                heads = torch.tensor(kv, device=self.devices[p])
            rows = slice(bi * Bb, (bi + 1) * Bb)
            S = k[p].shape[1]
            kh = k[p][rows].reshape(Bb, S, Hkv // d, hd)[:, :, heads]
            vh = v[p][rows].reshape(Bb, S, Hkv // d, hd)[:, :, heads]
            o = attend(p, qs[p][0].reshape(Bb, Tb, hq, hd), kh, vh, ti * Tb)
            return o.reshape(Bb, Tb, r, -1).permute(2, 0, 1, 3)

        back = self.over(blocks, self.each(own), lambda m: coll.all_to_all(m, 0, 0))

        def joined(p):  # (r, Bb, Tb, c) -> (B, T, c), one copy a block
            y = back[p][::dup]
            return y.reshape(gb, gt, Bb, Tb, -1).transpose(1, 2).reshape(B, T, -1) @ lp[p][key[-1]]["w_o"]

        return self.each(joined)

    def route(self, key: tuple) -> str:
        """"shard" where the q, kv and ``w_o`` cuts make whole head shards
        (or there is no cut), "spread" where q and ``w_o`` are cut over the
        tensor-parallel axis otherwise (``spread``)."""
        cfg = self.cfg
        q_ax, kv_ax, o_ax = self.attn_axes(key)
        parts = self.tp_parts(q_ax)
        whole = cfg.n_heads % parts == 0 and cfg.n_kv_heads % parts == 0
        if q_ax == kv_ax == o_ax and whole:
            return "shard"
        if q_ax == o_ax == (self.tp,):
            return "spread"
        raise NotImplementedError(f"no sharded attention with q, kv and w_o cut over {q_ax}, {kv_ax}, {o_ax}")

    def attention(self, lp: list[dict], h: list, pos: list, prefix: str) -> list:
        cfg = self.cfg
        key = (prefix, "attn")
        q_ax, kv_ax, _ = self.attn_axes(key)
        if self.route(key) == "shard":
            local = self.heads_cfg(self.tp_parts(q_ax))  # whole heads: attention on the shard
            out = self.each(lambda p: tf._attn_forward(local, lp[p]["attn"], h[p], pos[p]))
            return self.finish(out, bool(q_ax))
        cols = self.each(lambda p: qkv_columns(lp[p]["attn"], h[p]))
        q = self.each(lambda p: cols[p][0])
        k, v = (self.each(lambda p, j=j: cols[p][j]) for j in (1, 2))
        del cols
        blockwise = cfg.attention_backend == "softmax" and cfg.attention_impl == "blockwise"
        scores = getattr(torch, cfg.attn_scores_dtype)

        def attend(p, qh, kh, vh, t0):
            b, t, nh, _ = qh.shape
            qh = apply_rope(qh, pos[p][t0 : t0 + t], cfg.rope_theta)
            kh = apply_rope(kh, pos[p], cfg.rope_theta)
            if t == kh.shape[1]:
                local = dataclasses.replace(cfg, n_heads=nh, n_kv_heads=kh.shape[2], head_dim=cfg.hd)
                return tf._attn_core(local, qh, kh, vh)
            o = _gqa_scores_full(qh, kh, vh, causal=True, scores_dtype=scores, offset=t0)
            return o.reshape(b, t, nh * cfg.hd)

        return self.finish(self.spread(q, k, v, bool(kv_ax), lp, key, attend, blockwise), True)

    def cross(self, lp: list[dict], h: list, ctx: list) -> list:
        """The VLM's cross-attention of each position's rows over its image
        tokens ``ctx``: on head shards where the q and kv cuts hold whole
        heads, else spread over the group (``spread``)."""
        cfg = self.cfg
        key = ("cross_layers", "xattn")
        q_ax, kv_ax, _ = self.attn_axes(key)
        if self.route(key) == "shard":
            local = self.heads_cfg(self.tp_parts(q_ax))
            heads = dict(n_heads=local.n_heads, n_kv=local.n_kv_heads, head_dim=cfg.hd)
            out = self.each(lambda p: cross_attention(lp[p]["xattn"], h[p], ctx[p], **heads))
            return self.finish(out, bool(q_ax))
        q = self.each(lambda p: h[p] @ lp[p]["xattn"]["w_q"])
        k, v = (self.each(lambda p, w=w: ctx[p] @ lp[p]["xattn"][w]) for w in ("w_k", "w_v"))

        def attend(p, qh, kh, vh, t0):
            b, t, nh, _ = qh.shape
            return _gqa_scores_full(qh, kh, vh, causal=False).reshape(b, t, nh * cfg.hd)

        return self.finish(self.spread(q, k, v, bool(kv_ax), lp, key, attend, True), True)

    def ffn(self, lp: list[dict], h: list, want_aux: bool, prefix: str = "layers"):
        """(y a position, aux a position or None)."""
        cfg = self.cfg
        aux = None
        if cfg.moe_num_experts:
            y, aux = self.moe(lp, h, want_aux)
        if not cfg.moe_num_experts or cfg.moe_dense_residual:
            dense = self.each(lambda p: swiglu(lp[p]["ffn"], h[p]))
            dense = self.finish(dense, bool(self.cuts[(prefix, "ffn", "w_down")].axes[0]))
            y = dense if not cfg.moe_num_experts else self.each(lambda p: y[p] + dense[p])
        return y, aux

    def moe(self, lp: list[dict], h: list, want_aux: bool):
        cfg = self.cfg
        E = cfg.moe_num_experts
        e_ax = self.cuts[("layers", "moe", "w_gate")].axes[0]
        f_ax = self.cuts[("layers", "moe", "w_down")].axes[1]
        routed = self.each(lambda p: route(lp[p]["moe"], h[p], top_k=cfg.moe_top_k))
        buf = self.each(lambda p: routed[p][0])
        if not e_ax:
            y = self.each(lambda p: experts(lp[p]["moe"], buf[p]))
        elif e_ax == (self.tp,):  # each member's experts, zero for the others'

            def mine(p):
                sl = self.block(("layers", "moe", "w_gate"), p, 0)
                y = experts(lp[p]["moe"], buf[p][:, sl])
                return torch.nn.functional.pad(y, (0, 0, 0, 0, sl.start, E - sl.stop))

            y = self.each(mine)
        else:  # experts over other axes: to their owners and back
            groups = axis_groups(self.mesh, e_ax)
            sent = self.over(groups, buf, lambda m: coll.all_to_all(m, 1, 0))
            done = self.each(lambda p: experts(lp[p]["moe"], sent[p]))
            y = self.over(groups, done, lambda m: coll.all_to_all(m, 0, 1))
        out = self.each(lambda p: _combine(y[p], routed[p][1], cfg.moe_top_k, routed[p][4]))
        out = self.finish(out, e_ax == (self.tp,) or bool(f_ax))
        if not want_aux:
            return out, None
        tokens = self.global_batch * h[self.run[0]].shape[1]
        me = self.each(lambda p: routed[p][2].sum(dim=(0, 1)))
        me = self.over(self.batch_groups, me, coll.all_reduce)
        ce = self.each(lambda p: load_counts(routed[p][3], E).sum(dim=(0, 1)))
        ce = self.over(self.batch_groups, ce, coll.all_reduce)
        return out, self.each(lambda p: E * torch.sum((me[p] / tokens) * (ce[p] / tokens)))

    def layer(self, i, stacks: list[dict], x: list, pos: list, prefix: str = "layers"):
        """Dense block ``i`` of ``prefix`` (the one-device ``_dense_block``):
        (x, aux)."""
        lp = self.block_params(stacks, prefix, i)
        h = self.whole_seq(self.each(lambda p: rmsnorm(lp[p]["ln1"], x[p])))
        a = self.attention(lp, h, pos, prefix)
        x = self.each(lambda p: x[p] + a[p])
        h = self.whole_seq(self.each(lambda p: rmsnorm(lp[p]["ln2"], x[p])))
        y, aux = self.ffn(lp, h, want_aux=True, prefix=prefix)
        return self.each(lambda p: x[p] + y[p]), aux

    def cross_layer(self, g: int, stacks: list[dict], x: list, ctx: list) -> list:
        """Cross block ``g`` (the one-device ``_cross_block``)."""
        lp = self.block_params(stacks, "cross_layers", g)
        h = self.whole_seq(self.each(lambda p: rmsnorm(lp[p]["ln1"], x[p])))
        a = self.cross(lp, h, ctx)
        x = self.each(lambda p: x[p] + a[p])
        h = self.whole_seq(self.each(lambda p: rmsnorm(lp[p]["ln2"], x[p])))
        y, _ = self.ffn(lp, h, want_aux=False, prefix="cross_layers")
        return self.each(lambda p: x[p] + y[p])

    # ------------------------------------------------------------- RWKV6

    def rwkv_params(self, lp: list[dict]):
        """(each position's time-mix parameters, whether its output is a
        partial sum). Where the "heads" cut holds whole heads: the shard's
        columns and ``u``'s rows of its heads; otherwise every head-cut
        leaf gathered (each member computes all heads)."""
        hd = self.cfg.rwkv_head_dim
        cut = self.cuts[("layers", "w_r")].axes[1]
        cols = [self.block(("layers", "w_r"), p, 1) for p in range(self.n)]
        if all(c.start % hd == 0 and c.stop % hd == 0 for c in cols):
            own = lambda p: lp[p]["u"][cols[p].start // hd : cols[p].stop // hd]  # noqa: E731
            return self.each(lambda p: {**lp[p], "u": own(p)}), bool(cut)
        out = self.each(lambda p: dict(lp[p]))
        for name, dim in (("w_r", 1), ("w_k", 1), ("w_v", 1), ("w_g", 1), ("w0", 0),
                          ("w_lora_b", 1), ("ln_scale", 0), ("w_o", 0)):
            if self.cuts[("layers", name)].axes[dim]:
                whole = self.gather_tp(self.each(lambda p: out[p][name]), dim)
                for p in self.run:
                    out[p][name] = whole[p]
        return out, False

    def channel_mix(self, lp: list[dict], h: list, last=None) -> list:
        """The channel mix a position: the value projection's partial sums
        reduced over the "ffn" cut before its gate (both in the residual's
        layout)."""
        parts = self.each(
            lambda p: channel_mix_parts(lp[p], h[p], None if last is None else last[p])
        )
        partial = bool(self.cuts[("layers", "w_ffn_v")].axes[0])
        value = self.finish(self.each(lambda p: parts[p][1]), partial)
        gate = self.finish(self.each(lambda p: parts[p][0]), False)
        return self.each(lambda p: gate[p] * value[p])

    def rwkv_layer(self, i: int, stacks: list[dict], x: list) -> list:
        """RWKV6 block ``i`` (the one-device ``_rwkv_block``)."""
        cfg = self.cfg
        lp = self.block_params(stacks, "layers", i)
        h = self.whole_seq(self.each(lambda p: rmsnorm({"scale": lp[p]["ln1"]}, x[p])))
        tm, partial = self.rwkv_params(lp)
        opts = dict(head_dim=cfg.rwkv_head_dim, chunk=cfg.scan_chunk)
        out = self.finish(self.each(lambda p: time_mix_forward(tm[p], h[p], **opts)), partial)
        x = self.each(lambda p: x[p] + out[p])
        h = self.whole_seq(self.each(lambda p: rmsnorm({"scale": lp[p]["ln2"]}, x[p])))
        mixed = self.channel_mix(lp, h)
        return self.each(lambda p: x[p] + mixed[p])

    def rwkv_decode(self, i: int, stacks: list[dict], x: list, cache: list) -> list:
        """One token through RWKV6 block ``i``, each position's blocks of
        the cache's states written in place."""
        f32 = torch.float32
        lp = self.block_params(stacks, "layers", i)
        h = self.each(lambda p: rmsnorm({"scale": lp[p]["ln1"]}, x[p]))
        tm, partial = self.rwkv_params(lp)
        hd = self.cfg.rwkv_head_dim
        state = lambda p: (cache[p]["S"][i], cache[p]["x_tm"][i].to(h[p].dtype))  # noqa: E731
        out, new = self.each2(lambda p: time_mix_decode(tm[p], h[p], state(p), head_dim=hd))
        out = self.finish(out, partial)
        x = self.each(lambda p: x[p] + out[p].to(x[p].dtype))
        h2 = self.each(lambda p: rmsnorm({"scale": lp[p]["ln2"]}, x[p]))
        last = self.each(lambda p: cache[p]["x_cm"][i].to(h2[p].dtype))
        out2 = self.channel_mix(lp, h2, last)
        x = self.each(lambda p: x[p] + out2[p].to(x[p].dtype))
        for p in self.run:
            for key, value in (("S", new[p][0]), ("x_tm", new[p][1]), ("x_cm", h2[p])):
                cache[p][key][i] = value.to(f32)
        return x

    # ------------------------------------------------------------ Mamba2

    def mamba(self, lp: list[dict], x: list, states=None, heads=None):
        """Mamba2 over each position's rows (``states``: each position's
        (ssm, conv carry) blocks for one decode token, ``heads`` the slice of
        heads its ssm block holds; else None): (out a position, each
        position's new (ssm, carry) or None)."""
        cfg = self.cfg
        P, N = cfg.ssm_head_dim, cfg.ssm_state
        d_inner = cfg.ssm_expand * cfg.d_model
        H = d_inner // P
        key = lambda name: ("layers",) + name  # noqa: E731
        w_in, conv, w_out = key(("w_in",)), key(("conv",)), key(("w_out",))
        # the packed projection's columns gathered before they are split
        proj = self.each(lambda p: x[p] @ lp[p]["w_in"])
        if self.cuts[w_in].axes[1]:
            proj = self.gather_tp(proj, -1)
        split = self.each(lambda p: _split_proj(proj[p], d_inner, N, H))
        # the conv on the channel block of x | B | C its weight holds

        def conv_block(p):
            _, xs, Bm, Cm, _ = split[p]
            xbc = torch.cat([xs, Bm, Cm], dim=-1)[..., self.block(conv, p, 1)]
            return _causal_conv(xbc, lp[p]["conv"], states[p][1] if states else None)

        conved, carries = self.each2(conv_block)
        if self.cuts[conv].axes[1]:
            conved = self.gather_tp(conved, -1)

        def scan(p):  # ((y rows, z rows), their sum of squares, the new states)
            z, _, _, _, dt = split[p]
            xs = conved[p][..., :d_inner]
            Bm = conved[p][..., d_inner : d_inner + N]
            Cm = conved[p][..., d_inner + N :]
            dt = torch.nn.functional.softplus(dt + lp[p]["dt_bias"])
            rows = self.block(w_out, p, 0)
            if states:  # the heads of the cache's ssm block (all, or w_out's)
                h0, h1 = heads[p].start, heads[p].stop
            else:  # the whole heads that cover w_out's rows
                h0, h1 = rows.start // P, -(-rows.stop // P)
            A = -torch.exp(lp[p]["A_log"][h0:h1])
            B, T = xs.shape[:2]
            xh = xs[..., h0 * P : h1 * P].reshape(B, T, h1 - h0, P)
            new = None
            if states:
                yh, ssm = ssd_step(states[p][0], xh[:, 0], Bm[:, 0], Cm[:, 0], dt[:, 0, h0:h1], A)
                yh = (yh + lp[p]["D"][h0:h1][None, :, None] * xh[:, 0])[:, None]
                new = (ssm, carries[p])
            else:
                yh = ssd_scan(xh, Bm, Cm, dt[..., h0:h1], A, cfg.scan_chunk)
                yh = yh + lp[p]["D"][h0:h1][None, None, :, None] * xh
            yp = yh.reshape(B, T, (h1 - h0) * P)[..., rows.start - h0 * P : rows.stop - h0 * P]
            y32 = yp.to(torch.float32)
            return (yp, z[..., rows]), torch.sum(y32 * y32, dim=-1, keepdim=True), new

        done = self.each(scan)
        y, ss = self.each(lambda p: done[p][0]), self.each(lambda p: done[p][1])
        new = self.each(lambda p: done[p][2])
        del done
        if self.cuts[w_out].axes[0]:
            ss = self.tp_reduce(ss)

        def project(p):
            yp, zp = y[p]
            var = ss[p] / d_inner
            normed = yp.to(torch.float32) * torch.rsqrt(var + 1e-5) * lp[p]["norm"]["scale"]
            gated = normed.to(yp.dtype) * torch.nn.functional.silu(zp)
            return _mm(gated, lp[p]["w_out"])

        out = self.finish(self.each(project), bool(self.cuts[w_out].axes[0]))
        return out, (new if states else None)

    def mamba_layer(self, i: int, stacks: list[dict], x: list) -> list:
        """Mamba2 block ``i`` (the one-device ``_mamba_block``)."""
        out, _ = self.mamba(self.block_params(stacks, "layers", i), self.whole_seq(x))
        return self.each(lambda p: x[p] + out[p])

    def mamba_decode(self, i, stacks: list[dict], x: list, cache: list, layouts: dict) -> list:
        """One token through Mamba2 block ``i``, each position's blocks of
        the ssm state and the conv carry written in place."""
        f32 = torch.float32
        lp = self.block_params(stacks, "layers", i)
        states = self.each(lambda p: (cache[p]["ssm"][i], cache[p]["conv"][i]))
        out, new = self.mamba(lp, x, states, layouts["ssm"])
        for p in self.run:
            cache[p]["ssm"][i], cache[p]["conv"][i] = (t.to(f32) for t in new[p])
        return self.each(lambda p: x[p] + out[p].to(x[p].dtype))

    # ----------------------------------------------------------- programs

    def split(self, local: list[dict]):
        """(top-level leaves, {block prefix: its leaves}) a position, flat."""
        top = self.each(lambda p: {k: v for k, v in local[p].items() if k[0] not in BLOCKS})
        stacks = self.each(
            lambda p: {b: {k[1:]: v for k, v in local[p].items() if k[0] == b} for b in BLOCKS}
        )
        return top, stacks

    def scanned(self, fn, i: int, stacks: list[dict], x: list, *extra):
        """Layer ``i`` of the scanned stack, under ``remat_lockstep`` where
        ``cfg.remat`` (``transformer._layer``): its inputs are its own
        slices of the stacked leaves, so the node keeps no whole stack."""
        if not self.cfg.remat:
            return fn(i, stacks, x, *extra)
        own = self.each(lambda p: {"layers": {k: v[i] for k, v in stacks[p]["layers"].items()}})
        return remat_lockstep(fn, None, own, x, *extra)

    def forward(self, local: list[dict], tokens: list, image_embeds: list | None = None):
        """``transformer.forward`` over the mesh: (logits a position, each
        (B, T, its vocab), the aux loss summed over layers a position). A
        VLM takes each position's block of ``image_embeds``."""
        cfg = self.cfg
        top, stacks = self.split(local)
        T = tokens[self.run[0]].shape[1]
        self.seq_cut = self.sp and T % self.mesh.shape[self.tp] == 0
        x = self.embed(top, tokens)
        pos = self.each(lambda p: torch.arange(T, dtype=torch.int32, device=self.devices[p]))
        aux = self.each(lambda p: torch.zeros((), dtype=torch.float32, device=self.devices[p]))

        def add(a):
            if a is not None:
                aux[:] = self.each(lambda p: aux[p] + a[p])

        if cfg.family == "ssm":
            for i in range(cfg.n_layers):
                x = self.scanned(self.rwkv_layer, i, stacks, x)
        elif cfg.family == "hybrid":
            k = cfg.hybrid_attn_every
            for g in range(cfg.n_layers // k):
                for i in range(g * k, (g + 1) * k):
                    x = self.scanned(self.mamba_layer, i, stacks, x)
                x, a = self.layer(None, stacks, x, pos, "shared_attn")
                add(a)
        elif cfg.family == "vlm":
            if image_embeds is None:
                raise ValueError(f"{cfg.name}: the vlm family's forward needs image_embeds")
            ctx = self.each(lambda p: image_embeds[p].to(self.dtype))
            n_cross, _, per_block = tf.vlm_layout(cfg)
            for g in range(n_cross):
                for i in range(g * per_block, (g + 1) * per_block):
                    x, a = self.scanned(self.layer, i, stacks, x, pos)
                    add(a)
                x = self.cross_layer(g, stacks, x, ctx)
        else:
            for i in range(cfg.n_layers):
                x, a = self.scanned(self.layer, i, stacks, x, pos)
                add(a)
        return self.head(top, x), aux

    def placed_logits(self, logits: list) -> Sharded:
        """The (GB, T, V) logits where they were computed, in the layout
        the reference's compiled cell leaves them: each position's own
        block on its device, the batch cut as the batch is, the vocab as
        the LM head's columns are (less any axis the batch takes), the
        sequence whole. Where the vocab is not cut, the members of a
        tensor-parallel group hold replicas. A position that is not run
        holds a stand-in of its class representative's block. Nothing is
        copied between devices; ``.gather()`` gives the whole tensor."""
        vocab = tuple(a for a in self.cuts[("lm_head", "w")].axes[1] if a not in self.batch_axes)
        spec = PartitionSpec(self.batch.spec[0], None, vocab[0] if len(vocab) == 1 else vocab or None)
        first = logits[self.run[0]]
        shape = (self.global_batch, first.shape[1], self.vocab)
        sharding = NamedSharding(self.mesh, spec)
        want = sharding.shard_shape(shape)
        shards = tuple(self.have(logits, p) for p in range(self.n))
        for p, block in enumerate(shards):
            if tuple(block.shape) != want:
                raise ValueError(f"position {p}'s logits {tuple(block.shape)} are not {spec}'s block {want}")
        return Sharded(shards, sharding, shape, first.dtype)

    def cache_layout(self, kv) -> tuple:
        """(the axes that cut the kv heads, each position's block of slots
        where the sequence is cut, else None) of a placed attention cache
        stack: a KV tuple of (L, B, S, Hkv, hd) leaves (and int8's scales)
        or a ``MacState``."""
        first = kv[0]
        axes = first.sharding.dim_axes(len(first.shape))
        mac_state = isinstance(kv, tf.mac.MacState)
        heads, seq = (axes[2], ()) if mac_state else (axes[3], axes[2])
        for what, ax in (("kv-head", heads), ("sequence", seq)):
            if ax and ax != (self.tp,):
                raise NotImplementedError(
                    f"no sharded decode cuts the cache's {what} dim over {ax}"
                )
        self.check_batch(first)
        for leaf in kv:
            self.check_blocks(leaf, "the cache")
        if not seq:
            return heads, None
        return heads, [first.sharding.index(first.shape, p)[2] for p in range(self.n)]

    def check_batch(self, leaf) -> None:
        """A cache leaf's batch dim (its second) cut as the batch is, and
        any other cut over the tensor-parallel axis."""
        axes = leaf.sharding.dim_axes(len(leaf.shape))
        if tuple(axes[1]) != self.batch_axes:
            raise ValueError(
                f"the cache's batch dim is cut over {axes[1]}, "
                f"the batch over {self.batch_axes}"
            )
        for dim, ax in enumerate(axes):
            if dim != 1 and ax and ax != (self.tp,):
                raise NotImplementedError(f"no sharded decode cuts a cache's dim {dim} over {ax}")

    def cache_layouts(self, cache: dict) -> dict:
        """``cache_layout`` of each attention stack of a placed cache; its
        recurrent states checked by ``check_batch``, and of Mamba2's ssm
        state, each position's slice of the heads it holds. (The conv
        carry's channels are cut as the conv weight's: both "ffn".)"""
        out = {}
        for key, value in cache.items():
            if key in ("kv", "attn", "self", "cross"):
                out[key] = self.cache_layout(value)
                continue
            self.check_batch(value)
            self.check_blocks(value, f"the cache's {key}")
            if key == "ssm":
                out[key] = [value.sharding.index(value.shape, p)[2] for p in range(self.n)]
        return out

    def decode(
        self,
        local: list[dict],
        tokens: list,
        pos: int,
        cache: list,
        layouts: dict,
    ) -> list:
        """``transformer.decode`` over the mesh: logits a position.
        ``cache``: each position's blocks of the cache tree (written in
        place), its attention stacks laid out as ``layouts`` says."""
        cfg = self.cfg
        top, stacks = self.split(local)
        self.seq_cut = False
        x = self.embed(top, tokens)
        if cfg.family == "ssm":
            for i in range(cfg.n_layers):
                x = self.rwkv_decode(i, stacks, x, cache)
        elif cfg.family == "hybrid":
            k = cfg.hybrid_attn_every
            attn = self.each(lambda p: cache[p]["attn"])
            for g in range(cfg.n_layers // k):
                for i in range(g * k, (g + 1) * k):
                    x = self.mamba_decode(i, stacks, x, cache, layouts)
                x = self.block_decode("shared_attn", None, stacks, x, pos, attn, layouts["attn"], g)
        elif cfg.family == "vlm":
            n_cross, _, per_block = tf.vlm_layout(cfg)
            own = self.each(lambda p: cache[p]["self"])
            cross = self.each(lambda p: cache[p]["cross"])
            for g in range(n_cross):
                for i in range(g * per_block, (g + 1) * per_block):
                    x = self.block_decode("layers", i, stacks, x, pos, own, layouts["self"], i)
                x = self.cross_decode(g, stacks, x, cross, layouts["cross"])
        else:
            kv = self.each(lambda p: cache[p]["kv"])
            for i in range(cfg.n_layers):
                x = self.block_decode("layers", i, stacks, x, pos, kv, layouts["kv"], i)
        return self.head(top, x)

    def block_decode(self, prefix, i, stacks, x, pos, kv, layout, slot) -> list:
        """One token through dense block ``i`` of ``prefix``, its attention
        through slot ``slot`` of the ``kv`` stacks."""
        lp = self.block_params(stacks, prefix, i)
        h = self.each(lambda p: rmsnorm(lp[p]["ln1"], x[p]))
        a = self.attention_decode(lp, h, pos, kv, layout, slot, prefix)
        x = self.each(lambda p: x[p] + a[p])
        h = self.each(lambda p: rmsnorm(lp[p]["ln2"], x[p]))
        y, _ = self.ffn(lp, h, want_aux=False, prefix=prefix)
        return self.each(lambda p: x[p] + y[p])

    def attention_decode(
        self, lp, h, pos: int, cache: list, layout: tuple, i: int, prefix: str = "layers"
    ) -> list:
        """One token's self-attention through the cache. Where the cache's
        kv heads are cut over the tensor-parallel axis (or there is none),
        ``_attn_decode`` on each head shard; otherwise q, k and v gathered
        on every member and its cache blocks read whole: a ``MacState``
        (a replica) extended with every kv head and read out
        (``mac_gathered``), a KV cache (sequence-cut, or a replica; int8's
        dequantized) by ``attend_gathered``."""
        cfg = self.cfg
        layer_cache = self.each(lambda p: tf._layer_cache(cache[p], i))
        heads_ax, seq_blocks = layout
        if not self.tp or heads_ax:
            local = self.heads_cfg(self.tp_parts(heads_ax))

            def shard(p):
                o, new = tf._attn_decode(local, lp[p]["attn"], h[p], pos, layer_cache[p])
                tf._store(cache[p], i, new)
                return o

            return self.finish(self.each(shard), bool(heads_ax))
        cols = self.each(lambda p: qkv_columns(lp[p]["attn"], h[p]))
        q_ax = self.cuts[(prefix, "attn", "w_q")].axes[1]
        kv_ax = self.cuts[(prefix, "attn", "w_k")].axes[1]
        full = []
        for j, ax in enumerate((q_ax, kv_ax, kv_ax)):
            xs = self.each(lambda p, j=j: cols[p][j])
            full.append(self.gather_tp(xs, -1) if ax else xs)

        def heads(p):
            B = full[0][p].shape[0]
            positions = torch.full((B, 1), pos, dtype=torch.int32, device=self.devices[p])
            qkv = (full[0][p], full[1][p], full[2][p])
            qh, kh, vh = split_heads(
                *qkv, cfg.n_heads, cfg.n_kv_heads, cfg.hd, positions, cfg.rope_theta
            )
            return qh, (kh, vh)

        q, kv = self.each2(heads)
        del full
        if isinstance(layer_cache[self.run[0]], tf.mac.MacState):
            out = self.mac_gathered(q, layer_cache, kv, cache, i)
        else:
            out = self.attend_gathered(q, layer_cache, seq_blocks, pos, kv)
        return self.rows_out(out, lp, (prefix, "attn"))

    def rows_out(self, out: list, lp: list[dict], key: tuple) -> list:
        """Each member's rows of the whole attention output through its
        ``w_o`` block, the partial sums reduced where ``w_o`` is row-cut."""
        res = self.each(lambda p: out[p][..., self.block(key + ("w_o",), p, 0)] @ lp[p][key[-1]]["w_o"])
        return self.finish(res, bool(self.cuts[key + ("w_o",)].axes[0]))

    def cross_decode(self, g: int, stacks, x: list, cross: list, layout: tuple) -> list:
        """One token through cross block ``g``, reading the cached image
        K/V (or their ``MacState``) at slot ``g``."""
        cfg = self.cfg
        lp = self.block_params(stacks, "cross_layers", g)
        h = self.each(lambda p: rmsnorm(lp[p]["ln1"], x[p]))
        layer = self.each(lambda p: tf._layer_cache(cross[p], g))
        heads_ax, seq_blocks = layout
        if not self.tp or heads_ax:
            local = self.heads_cfg(self.tp_parts(heads_ax))
            a = self.each(lambda p: tf._cross_attn_decode(local, lp[p]["xattn"], h[p], layer[p]))
            a = self.finish(a, bool(heads_ax))
        else:
            q = self.each(lambda p: h[p] @ lp[p]["xattn"]["w_q"])
            if self.cuts[("cross_layers", "xattn", "w_q")].axes[1]:
                q = self.gather_tp(q, -1)
            B = q[self.run[0]].shape[0]
            q = self.each(lambda p: q[p].reshape(B, 1, cfg.n_heads, cfg.hd))
            if isinstance(layer[self.run[0]], tf.mac.MacState):
                out = self.mac_gathered(q, layer, None, None, g)
            else:
                out = self.attend_gathered(q, layer, seq_blocks, None, None)
            a = self.rows_out(out, lp, ("cross_layers", "xattn"))
        x = self.each(lambda p: x[p] + a[p])
        h = self.each(lambda p: rmsnorm(lp[p]["ln2"], x[p]))
        y, _ = self.ffn(lp, h, want_aux=False, prefix="cross_layers")
        return self.each(lambda p: x[p] + y[p])

    def mac_gathered(self, q: list, states: list, kv, cache, i: int) -> list:
        """Each member's whole query (B, 1, Hq, hd) -> its (B, 1, Hq hd)
        attention output through its copy of the whole ``MacState`` (a
        replica over the group): extended with every kv head's new ``kv``
        and stored at slot ``i`` of ``cache`` (the reference's
        ``_mac_attn_decode``); ``kv`` None for the image context, which is
        only read. Every member computes the same on the same inputs, so
        the replicas stay equal."""
        cfg = self.cfg
        Hq, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
        f32 = torch.float32

        def read(p):
            B = q[p].shape[0]
            state = states[p]
            if kv is not None:
                kh, vh = kv[p]
                state = mac.extend_state(state, kh.transpose(1, 2).to(f32), vh.transpose(1, 2).to(f32))
                tf._store(cache[p], i, state)
            q_bh = q[p].reshape(B, 1, Hkv, Hq // Hkv, hd)[:, 0].to(f32)
            o, _ = mac.readout(state, q_bh)
            return o.reshape(B, 1, Hq * hd).to(q[p].dtype)

        return self.each(read)

    def attend_gathered(self, q: list, layer_cache, seq_blocks, pos, kv) -> list:
        """Each member's whole query (B, 1, Hq, hd) -> its (B, 1, Hq hd)
        attention output over its cache blocks: (k, v), or int8's (k, v, k
        scales, v scales), each block dequantized with its own per-token
        scales. ``kv``: each member's whole new (k, v) heads, written at
        slot ``pos`` (quantized into an int8 cache) and read causally; None
        for the image context (no write, no mask). A replicated cache: the
        slot written and read whole on each member. A sequence-cut cache:
        the slot's owner writes it, each member its scores over its slots,
        and one combine over the group (the max, then the sums of
        exponentials and of weighted values)."""
        cfg = self.cfg
        Hq, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
        f32 = torch.float32

        def scores(p):  # the whole attention (a replica), or (scores, values) over the block
            B = q[p].shape[0]
            sl = None if seq_blocks is None else seq_blocks[p]
            if kv is not None and (sl is None or sl.start <= pos < sl.stop):
                write_kv(layer_cache[p], *kv[p], pos - (0 if sl is None else sl.start))
            ck, cv = read_kv(layer_cache[p])
            if sl is None:
                last = pos if kv is not None else ck.shape[1] - 1
                return decode_attend(q[p], ck.to(q[p].dtype), cv.to(q[p].dtype), last, Hq, hd)
            qh = q[p].reshape(B, 1, Hkv, Hq // Hkv, hd).to(f32)
            u = torch.einsum("bthgd,bshd->bhgts", qh, ck.to(f32)) * (1.0 / hd**0.5)
            if kv is not None:
                slots = sl.start + torch.arange(ck.shape[1], device=u.device)
                u = u.masked_fill(slots > pos, -torch.inf)
            return u, cv

        if seq_blocks is None:
            return self.each(scores)
        scores, values = self.each2(scores)
        tops = self.each(lambda p: torch.amax(scores[p], dim=-1, keepdim=True))
        tops = self.over(self.tp_groups, tops, coll.all_max)
        e = self.each(lambda p: torch.exp(scores[p] - tops[p]))
        total = self.tp_reduce(self.each(lambda p: torch.sum(e[p], dim=-1)))  # (B, Hkv, g, 1)
        num = self.each(lambda p: torch.einsum("bhgts,bshd->bthgd", e[p], values[p].to(f32)))
        num = self.tp_reduce(num)  # (B, 1, Hkv, g, hd)
        B = num[self.run[0]].shape[0]
        return self.each(
            lambda p: (num[p] / total[p].permute(0, 3, 1, 2)[..., None]).reshape(B, 1, Hq * hd).to(self.dtype)
        )
