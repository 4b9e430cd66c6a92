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
    shard p's heads then read kv shard p's); otherwise q, k and v gathered
    over the group, attention once a group, each member its ``w_o`` rows;
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
  * cross-attention (``vlm``) on head shards over the batch block's
    image tokens, no mask and no RoPE; decode from the cached image K/V
    (or their ``MacState``), head-cut, sequence-cut or a replica.

The blocks are the port's own functions (``transformer._attn_forward``,
``_attn_core``, ``_attn_decode``, ``_cross_attn_decode``,
``layers.swiglu``, ``moe.route``, ``moe.experts``, ``rwkv.time_mix_*``,
``ssm.ssd_*``) on local shards, each block under the path prefix of its
own leaves (``layers``, ``shared_attn``, ``cross_layers``). Rule sets
other than the reference's six (``RULE_SETS``) and mesh axes other than
"pod", "data" and "model" raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import Mesh
from repro_torch.models import transformer as tf
from repro_torch.models.attention import (
    _gqa_scores_full,
    cross_attention,
    decode_attend,
    qkv_columns,
    split_heads,
    write_slot,
)
from repro_torch.models.layers import rmsnorm, swiglu
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
    leaves = []

    def go(t):
        if isinstance(t, torch.Tensor):
            leaves.append(t)
            return _LEAF
        if isinstance(t, dict):
            return {k: go(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(go(v) for v in t)
        return t

    return leaves, go(tree)


def _unflatten(shape, leaves):
    it = iter(leaves)

    def go(s):
        if s is _LEAF:
            return next(it)
        if isinstance(s, dict):
            return {k: go(v) for k, v in s.items()}
        if isinstance(s, (list, tuple)):
            return type(s)(go(v) for v in s)
        return s

    return go(shape)


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
    order."""

    def __init__(
        self,
        cfg: ModelConfig,
        mesh: Mesh,
        rules: AxisRules,
        params: dict,
        global_batch: int,
    ):
        check_supported(cfg, mesh, rules)
        self.cfg, self.mesh = cfg, mesh
        self.dtype = getattr(torch, cfg.dtype)
        self.n = mesh.size
        self.devices = mesh.devices
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
        spec = flat(logical_spec(cfg))
        self.cuts = {}
        for path, leaf in flat(params).items():
            self.cuts[path] = _cut(leaf, spec[path], 1 if path[0] in STACKS else 0, self.tp)

    # ------------------------------------------------------------ layout

    def over(self, groups, xs: list, fn) -> list:
        """``fn`` on each group's members of ``xs`` (one a position)."""
        out = list(xs)
        for g in groups:
            if len(g) > 1:
                for p, y in zip(g, fn([xs[p] for p in g])):
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
        return [x[:, self.seq_rows(p, x.shape[1])] for p, x in enumerate(xs)]

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
        out = [dict() for _ in range(self.n)]
        for path in stacks[0][prefix]:
            xs = [stacks[p][prefix][path] for p in range(self.n)]
            xs = [(x if i is None else x[i]).to(self.dtype) for x in xs]
            xs = self.fsdp((prefix,) + path, xs)
            for p in range(self.n):
                out[p][path] = xs[p]
        return [nest(o) for o in out]

    def embed(self, top: list[dict], tokens: list) -> list:
        path = ("embed", "table")
        table = self.fsdp(path, [t[path] for t in top])
        cut = bool(self.cuts[path].axes[0])
        if not cut:
            x = [table[p][tokens[p]] for p in range(self.n)]
        else:
            x = []
            for p in range(self.n):
                rows = table[p].shape[0]
                t = tokens[p].long() - self.block(path, p, 0).start
                inside = (t >= 0) & (t < rows)
                got = table[p][t.clamp(0, rows - 1)]
                x.append(torch.where(inside[..., None], got, 0.0))
        return [xi.to(self.dtype) for xi in self.finish(x, cut)]

    def head(self, top: list[dict], x: list) -> list:
        """Final norm and LM head: each position's (B, T, its vocab) logits."""
        ln, head = ("final_ln", "scale"), ("lm_head", "w")
        scale = self.fsdp(ln, [t[ln] for t in top])
        w = self.fsdp(head, [t[head].to(self.dtype) for t in top])
        h = self.whole_seq([rmsnorm({"scale": scale[p]}, x[p]) for p in range(self.n)])
        return [h[p] @ w[p] for p in range(self.n)]

    def xent_sums(self, logits: list, labels: list) -> list:
        """Each position's sum of token losses over its rows: a
        vocab-parallel cross-entropy (max, sum of exponentials and target
        logit each reduced over the vocab's cut)."""
        path = ("lm_head", "w")
        cut = bool(self.cuts[path].axes[1])
        l32 = [x.to(torch.float32) for x in logits]
        top = [torch.amax(x, dim=-1).detach() for x in l32]
        if cut:
            top = self.over(self.tp_groups, top, coll.all_max)
        total, gold = [], []
        for p in range(self.n):
            total.append(torch.sum(torch.exp(l32[p] - top[p][..., None]), dim=-1))
            cols = l32[p].shape[-1]
            t = labels[p].long() - self.block(path, p, 1).start
            inside = (t >= 0) & (t < cols)
            where = t.clamp(0, cols - 1)[..., None]
            hit = torch.take_along_dim(l32[p], where, dim=-1)[..., 0]
            gold.append(torch.where(inside, hit, 0.0))
        if cut:
            total, gold = self.tp_reduce(total), self.tp_reduce(gold)
        return [
            torch.sum(top[p] + torch.log(total[p]) - gold[p]) for p in range(self.n)
        ]

    def attention(self, lp: list[dict], h: list, pos: list, prefix: str) -> list:
        cfg = self.cfg
        q_ax = self.cuts[(prefix, "attn", "w_q")].axes[1]
        kv_ax = self.cuts[(prefix, "attn", "w_k")].axes[1]
        o_ax = self.cuts[(prefix, "attn", "w_o")].axes[0]
        parts = self.tp_parts(q_ax)
        whole = cfg.n_heads % parts == 0 and cfg.n_kv_heads % parts == 0
        if q_ax == kv_ax == o_ax and whole:
            local = self.heads_cfg(parts)  # whole heads: attention on the shard
            out = [
                tf._attn_forward(local, lp[p]["attn"], h[p], pos[p])
                for p in range(self.n)
            ]
            return self.finish(out, bool(q_ax))
        cols = [qkv_columns(lp[p]["attn"], h[p]) for p in range(self.n)]
        out = [None] * self.n
        for g in self.tp_groups:
            q, k, v = (
                coll.gather([cols[p][j] for p in g], -1) if ax else cols[g[0]][j]
                for j, ax in enumerate((q_ax, kv_ax, kv_ax))
            )
            heads = split_heads(
                q, k, v, cfg.n_heads, cfg.n_kv_heads, cfg.hd, pos[g[0]], cfg.rope_theta
            )
            o = tf._attn_core(cfg, *heads)
            for p in g:
                rows = self.block((prefix, "attn", "w_o"), p, 0)
                out[p] = o[..., rows].to(self.devices[p]) @ lp[p]["attn"]["w_o"]
        return self.finish(out, bool(o_ax))

    def cross(self, lp: list[dict], h: list, ctx: list) -> list:
        """The VLM's cross-attention of each position's rows over its image
        tokens ``ctx``: on head shards where the q and kv cuts hold whole
        heads, else q, k and v gathered over the group."""
        cfg = self.cfg
        key = ("cross_layers", "xattn")
        q_ax = self.cuts[key + ("w_q",)].axes[1]
        kv_ax = self.cuts[key + ("w_k",)].axes[1]
        o_ax = self.cuts[key + ("w_o",)].axes[0]
        parts = self.tp_parts(q_ax)
        whole = cfg.n_heads % parts == 0 and cfg.n_kv_heads % parts == 0
        if q_ax == kv_ax == o_ax and whole:
            local = self.heads_cfg(parts)
            heads = dict(n_heads=local.n_heads, n_kv=local.n_kv_heads, head_dim=cfg.hd)
            out = [
                cross_attention(lp[p]["xattn"], h[p], ctx[p], **heads)
                for p in range(self.n)
            ]
            return self.finish(out, bool(q_ax))
        out = [None] * self.n
        for g in self.tp_groups:
            w = [lp[p]["xattn"] for p in g]
            parts_ = (
                [h[p] @ wp["w_q"] for p, wp in zip(g, w)],
                [ctx[p] @ wp["w_k"] for p, wp in zip(g, w)],
                [ctx[p] @ wp["w_v"] for p, wp in zip(g, w)],
            )
            q, k, v = (
                coll.gather(xs, -1) if ax else xs[0]
                for xs, ax in zip(parts_, (q_ax, kv_ax, kv_ax))
            )
            B, T, N = q.shape[0], q.shape[1], k.shape[1]
            o = _gqa_scores_full(
                q.reshape(B, T, cfg.n_heads, cfg.hd),
                k.reshape(B, N, cfg.n_kv_heads, cfg.hd),
                v.reshape(B, N, cfg.n_kv_heads, cfg.hd),
                causal=False,
            ).reshape(B, T, cfg.n_heads * cfg.hd)
            for p in g:
                rows = self.block(key + ("w_o",), p, 0)
                out[p] = o[..., rows].to(self.devices[p]) @ lp[p]["xattn"]["w_o"]
        return self.finish(out, bool(o_ax))

    def ffn(self, lp: list[dict], h: list, want_aux: bool, prefix: str = "layers"):
        """(y a position, aux a position or None)."""
        cfg = self.cfg
        aux = None
        if cfg.moe_num_experts:
            y, aux = self.moe(lp, h, want_aux)
        if not cfg.moe_num_experts or cfg.moe_dense_residual:
            dense = [swiglu(lp[p]["ffn"], h[p]) for p in range(self.n)]
            dense = self.finish(dense, bool(self.cuts[(prefix, "ffn", "w_down")].axes[0]))
            y = dense if not cfg.moe_num_experts else [a + b for a, b in zip(y, dense)]
        return y, aux

    def moe(self, lp: list[dict], h: list, want_aux: bool):
        cfg = self.cfg
        E = cfg.moe_num_experts
        e_ax = self.cuts[("layers", "moe", "w_gate")].axes[0]
        f_ax = self.cuts[("layers", "moe", "w_down")].axes[1]
        routed = [route(lp[p]["moe"], h[p], top_k=cfg.moe_top_k) for p in range(self.n)]
        buf = [r[0] for r in routed]
        if not e_ax:
            y = [experts(lp[p]["moe"], buf[p]) for p in range(self.n)]
        elif e_ax == (self.tp,):  # each member's experts, zero for the others'
            y = []
            for p in range(self.n):
                sl = self.block(("layers", "moe", "w_gate"), p, 0)
                mine = experts(lp[p]["moe"], buf[p][:, sl])
                B, _, C, d = buf[p].shape
                before = mine.new_zeros((B, sl.start, C, d))
                after = mine.new_zeros((B, E - sl.stop, C, d))
                y.append(torch.cat([before, mine, after], dim=1))
        else:  # experts over other axes: to their owners and back
            groups = axis_groups(self.mesh, e_ax)
            sent = self.over(groups, buf, lambda m: coll.all_to_all(m, 1, 0))
            done = [experts(lp[p]["moe"], sent[p]) for p in range(self.n)]
            y = self.over(groups, done, lambda m: coll.all_to_all(m, 0, 1))
        out = [
            _combine(y[p], routed[p][1], cfg.moe_top_k, routed[p][4])
            for p in range(self.n)
        ]
        out = self.finish(out, e_ax == (self.tp,) or bool(f_ax))
        if not want_aux:
            return out, None
        tokens = self.global_batch * h[0].shape[1]
        me = [r[2].sum(dim=(0, 1)) for r in routed]
        me = self.over(self.batch_groups, me, coll.all_reduce)
        ce = [load_counts(r[3], E).sum(dim=(0, 1)) for r in routed]
        ce = self.over(self.batch_groups, ce, coll.all_reduce)
        return out, [E * torch.sum((m / tokens) * (c / tokens)) for m, c in zip(me, ce)]

    def layer(self, i, stacks: list[dict], x: list, pos: list, prefix: str = "layers"):
        """Dense block ``i`` of ``prefix`` (the one-device ``_dense_block``):
        (x, aux)."""
        lp = self.block_params(stacks, prefix, i)
        h = self.whole_seq([rmsnorm(lp[p]["ln1"], x[p]) for p in range(self.n)])
        a = self.attention(lp, h, pos, prefix)
        x = [xi + ai for xi, ai in zip(x, a)]
        h = self.whole_seq([rmsnorm(lp[p]["ln2"], x[p]) for p in range(self.n)])
        y, aux = self.ffn(lp, h, want_aux=True, prefix=prefix)
        return [xi + yi for xi, yi in zip(x, y)], aux

    def cross_layer(self, g: int, stacks: list[dict], x: list, ctx: list) -> list:
        """Cross block ``g`` (the one-device ``_cross_block``)."""
        lp = self.block_params(stacks, "cross_layers", g)
        h = self.whole_seq([rmsnorm(lp[p]["ln1"], x[p]) for p in range(self.n)])
        x = [xi + ai for xi, ai in zip(x, self.cross(lp, h, ctx))]
        h = self.whole_seq([rmsnorm(lp[p]["ln2"], x[p]) for p in range(self.n)])
        y, _ = self.ffn(lp, h, want_aux=False, prefix="cross_layers")
        return [xi + yi for xi, yi in zip(x, y)]

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
            out = []
            for p in range(self.n):
                mine = dict(lp[p])
                mine["u"] = lp[p]["u"][cols[p].start // hd : cols[p].stop // hd]
                out.append(mine)
            return out, bool(cut)
        out = [dict(d) for d in lp]
        for name, dim in (("w_r", 1), ("w_k", 1), ("w_v", 1), ("w_g", 1), ("w0", 0),
                          ("w_lora_b", 1), ("ln_scale", 0), ("w_o", 0)):
            if self.cuts[("layers", name)].axes[dim]:
                whole = self.gather_tp([d[name] for d in out], dim)
                for d, w in zip(out, whole):
                    d[name] = w
        return out, False

    def channel_mix(self, lp: list[dict], h: list, last=None) -> list:
        """The channel mix a position: the value projection's partial sums
        reduced over the "ffn" cut before its gate (both in the residual's
        layout)."""
        parts = [
            channel_mix_parts(lp[p], h[p], None if last is None else last[p])
            for p in range(self.n)
        ]
        partial = bool(self.cuts[("layers", "w_ffn_v")].axes[0])
        value = self.finish([v for _, v in parts], partial)
        gate = self.finish([g for g, _ in parts], False)
        return [g * v for g, v in zip(gate, value)]

    def rwkv_layer(self, i: int, stacks: list[dict], x: list) -> list:
        """RWKV6 block ``i`` (the one-device ``_rwkv_block``)."""
        cfg = self.cfg
        lp = self.block_params(stacks, "layers", i)
        h = self.whole_seq([rmsnorm({"scale": lp[p]["ln1"]}, x[p]) for p in range(self.n)])
        tm, partial = self.rwkv_params(lp)
        opts = dict(head_dim=cfg.rwkv_head_dim, chunk=cfg.scan_chunk)
        out = [time_mix_forward(tm[p], h[p], **opts) for p in range(self.n)]
        x = [xi + oi for xi, oi in zip(x, self.finish(out, partial))]
        h = self.whole_seq([rmsnorm({"scale": lp[p]["ln2"]}, x[p]) for p in range(self.n)])
        return [xi + oi for xi, oi in zip(x, self.channel_mix(lp, h))]

    def rwkv_decode(self, i: int, stacks: list[dict], x: list, cache: list) -> list:
        """One token through RWKV6 block ``i``, each position's blocks of
        the cache's states written in place."""
        f32 = torch.float32
        lp = self.block_params(stacks, "layers", i)
        h = [rmsnorm({"scale": lp[p]["ln1"]}, x[p]) for p in range(self.n)]
        tm, partial = self.rwkv_params(lp)
        out, new = [], []
        for p in range(self.n):
            state = (cache[p]["S"][i], cache[p]["x_tm"][i].to(h[p].dtype))
            o, st = time_mix_decode(tm[p], h[p], state, head_dim=self.cfg.rwkv_head_dim)
            out.append(o)
            new.append(st)
        x = [xi + oi.to(xi.dtype) for xi, oi in zip(x, self.finish(out, partial))]
        h2 = [rmsnorm({"scale": lp[p]["ln2"]}, x[p]) for p in range(self.n)]
        last = [cache[p]["x_cm"][i].to(h2[p].dtype) for p in range(self.n)]
        out2 = self.channel_mix(lp, h2, last)
        x = [xi + oi.to(xi.dtype) for xi, oi in zip(x, out2)]
        for p in range(self.n):
            S_, x_tm = new[p]
            for key, value in (("S", S_), ("x_tm", x_tm), ("x_cm", h2[p])):
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
        proj = [x[p] @ lp[p]["w_in"] for p in range(self.n)]
        if self.cuts[w_in].axes[1]:
            proj = self.gather_tp(proj, -1)
        split = [_split_proj(pr, d_inner, N, H) for pr in proj]
        # the conv on the channel block of x | B | C its weight holds
        conved, carries = [], []
        for p in range(self.n):
            z, xs, Bm, Cm, dt = split[p]
            ch = self.block(conv, p, 1)
            xbc = torch.cat([xs, Bm, Cm], dim=-1)[..., ch]
            carry = states[p][1] if states else None
            out, carry = _causal_conv(xbc, lp[p]["conv"], carry)
            conved.append(out)
            carries.append(carry)
        if self.cuts[conv].axes[1]:
            conved = self.gather_tp(conved, -1)
        y, ss, new = [], [], []
        for p in range(self.n):
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
            if states:
                yh, ssm = ssd_step(states[p][0], xh[:, 0], Bm[:, 0], Cm[:, 0], dt[:, 0, h0:h1], A)
                yh = (yh + lp[p]["D"][h0:h1][None, :, None] * xh[:, 0])[:, None]
                new.append((ssm, carries[p]))
            else:
                yh = ssd_scan(xh, Bm, Cm, dt[..., h0:h1], A, cfg.scan_chunk)
                yh = yh + lp[p]["D"][h0:h1][None, None, :, None] * xh
            yp = yh.reshape(B, T, (h1 - h0) * P)[..., rows.start - h0 * P : rows.stop - h0 * P]
            y.append((yp, z[..., rows]))
            y32 = yp.to(torch.float32)
            ss.append(torch.sum(y32 * y32, dim=-1, keepdim=True))
        if self.cuts[w_out].axes[0]:
            ss = self.tp_reduce(ss)
        out = []
        for p in range(self.n):
            yp, zp = y[p]
            var = ss[p] / d_inner
            normed = yp.to(torch.float32) * torch.rsqrt(var + 1e-5) * lp[p]["norm"]["scale"]
            gated = normed.to(yp.dtype) * torch.nn.functional.silu(zp)
            out.append(_mm(gated, lp[p]["w_out"]))
        out = self.finish(out, bool(self.cuts[w_out].axes[0]))
        return out, (new if states else None)

    def mamba_layer(self, i: int, stacks: list[dict], x: list) -> list:
        """Mamba2 block ``i`` (the one-device ``_mamba_block``)."""
        out, _ = self.mamba(self.block_params(stacks, "layers", i), self.whole_seq(x))
        return [xi + oi for xi, oi in zip(x, out)]

    def mamba_decode(self, i, stacks: list[dict], x: list, cache: list, layouts: dict) -> list:
        """One token through Mamba2 block ``i``, each position's blocks of
        the ssm state and the conv carry written in place."""
        f32 = torch.float32
        lp = self.block_params(stacks, "layers", i)
        states = [(c["ssm"][i], c["conv"][i]) for c in cache]
        out, new = self.mamba(lp, x, states, layouts["ssm"])
        for p in range(self.n):
            cache[p]["ssm"][i], cache[p]["conv"][i] = (t.to(f32) for t in new[p])
        return [xi + oi.to(xi.dtype) for xi, oi in zip(x, out)]

    # ----------------------------------------------------------- programs

    def split(self, local: list[dict]):
        """(top-level leaves, {block prefix: its leaves}) a position, flat."""
        top = [{k: v for k, v in t.items() if k[0] not in BLOCKS} for t in local]
        stacks = [
            {b: {k[1:]: v for k, v in t.items() if k[0] == b} for b in BLOCKS}
            for t in local
        ]
        return top, stacks

    def scanned(self, fn, i: int, stacks: list[dict], x: list, *extra):
        """Layer ``i`` of the scanned stack, under ``remat_lockstep`` where
        ``cfg.remat`` (``transformer._layer``): its inputs are its own
        slices of the stacked leaves, so the node keeps no whole stack."""
        if not self.cfg.remat:
            return fn(i, stacks, x, *extra)
        own = [{"layers": {k: v[i] for k, v in s["layers"].items()}} for s in stacks]
        return remat_lockstep(fn, None, own, x, *extra)

    def forward(self, local: list[dict], tokens: list, image_embeds: list | None = None):
        """``transformer.forward`` over the mesh: (logits a position, each
        (B, T, its vocab), the aux loss summed over layers a position). A
        VLM takes each position's block of ``image_embeds``."""
        cfg = self.cfg
        top, stacks = self.split(local)
        T = tokens[0].shape[1]
        self.seq_cut = self.sp and T % self.mesh.shape[self.tp] == 0
        x = self.embed(top, tokens)
        pos = [torch.arange(T, dtype=torch.int32, device=d) for d in self.devices]
        aux = [torch.zeros((), dtype=torch.float32, device=d) for d in self.devices]

        def add(a):
            if a is not None:
                aux[:] = [s + ai for s, ai in zip(aux, a)]

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
            ctx = [e.to(self.dtype) for e in image_embeds]
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

    def gather_logits(self, logits: list) -> torch.Tensor:
        """The whole (GB, T, V) logits on the mesh's first device."""
        vocab = bool(self.cuts[("lm_head", "w")].axes[1])
        parts = []
        for r in self.reps:
            g = next(g for g in self.tp_groups if r in g)
            own = coll.gather([logits[p] for p in g], -1) if vocab else logits[r]
            parts.append(own)
        return coll.gather(parts, 0).to(self.devices[0])

    def cache_layout(self, kv) -> tuple:
        """(the axes that cut the kv heads, each position's block of slots
        where the sequence is cut, else None) of a placed attention cache
        stack: a KV tuple of (L, B, S, Hkv, hd) leaves or a ``MacState``."""
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
            attn = [c["attn"] for c in cache]
            for g in range(cfg.n_layers // k):
                for i in range(g * k, (g + 1) * k):
                    x = self.mamba_decode(i, stacks, x, cache, layouts)
                x = self.block_decode("shared_attn", None, stacks, x, pos, attn, layouts["attn"], g)
        elif cfg.family == "vlm":
            n_cross, _, per_block = tf.vlm_layout(cfg)
            own = [c["self"] for c in cache]
            cross = [c["cross"] for c in cache]
            for g in range(n_cross):
                for i in range(g * per_block, (g + 1) * per_block):
                    x = self.block_decode("layers", i, stacks, x, pos, own, layouts["self"], i)
                x = self.cross_decode(g, stacks, x, cross, layouts["cross"])
        else:
            kv = [c["kv"] for c in cache]
            for i in range(cfg.n_layers):
                x = self.block_decode("layers", i, stacks, x, pos, kv, layouts["kv"], i)
        return self.head(top, x)

    def block_decode(self, prefix, i, stacks, x, pos, kv, layout, slot) -> list:
        """One token through dense block ``i`` of ``prefix``, its attention
        through slot ``slot`` of the ``kv`` stacks."""
        lp = self.block_params(stacks, prefix, i)
        h = [rmsnorm(lp[p]["ln1"], x[p]) for p in range(self.n)]
        a = self.attention_decode(lp, h, pos, kv, layout, slot, prefix)
        x = [xi + ai for xi, ai in zip(x, a)]
        h = [rmsnorm(lp[p]["ln2"], x[p]) for p in range(self.n)]
        y, _ = self.ffn(lp, h, want_aux=False, prefix=prefix)
        return [xi + yi for xi, yi in zip(x, y)]

    def attention_decode(
        self, lp, h, pos: int, cache: list, layout: tuple, i: int, prefix: str = "layers"
    ) -> list:
        """One token's self-attention through the cache. Where the cache's
        kv heads are cut over the tensor-parallel axis (or there is none),
        ``_attn_decode`` on each head shard; otherwise q, k and v gathered
        on every member, and its cache blocks (sequence-cut, or a replica)
        read by ``attend_gathered``."""
        cfg = self.cfg
        layer_cache = [tf._layer_cache(c, i) for c in cache]
        heads_ax, seq_blocks = layout
        if not self.tp or heads_ax:
            parts = self.tp_parts(heads_ax)
            local = self.heads_cfg(parts)
            out = []
            for p in range(self.n):
                attn = lp[p]["attn"]
                o, new = tf._attn_decode(local, attn, h[p], pos, layer_cache[p])
                tf._store(cache[p], i, new)
                out.append(o)
            return self.finish(out, bool(heads_ax))
        self.refuse_gathered(layer_cache)
        cols = [qkv_columns(lp[p]["attn"], h[p]) for p in range(self.n)]
        q_ax = self.cuts[(prefix, "attn", "w_q")].axes[1]
        kv_ax = self.cuts[(prefix, "attn", "w_k")].axes[1]
        full = []
        for j, ax in enumerate((q_ax, kv_ax, kv_ax)):
            xs = [c[j] for c in cols]
            if ax:
                xs = self.gather_tp(xs, -1)
            full.append(xs)
        q, kv = [], []
        for p in range(self.n):
            B = full[0][p].shape[0]
            positions = torch.full((B, 1), pos, dtype=torch.int32, device=self.devices[p])
            qkv = (full[0][p], full[1][p], full[2][p])
            qh, kh, vh = split_heads(
                *qkv, cfg.n_heads, cfg.n_kv_heads, cfg.hd, positions, cfg.rope_theta
            )
            q.append(qh)
            kv.append((kh, vh))
        out = self.attend_gathered(q, layer_cache, seq_blocks, pos, kv)
        return self.rows_out(out, lp, (prefix, "attn"))

    def refuse_gathered(self, layer_cache) -> None:
        if self.cfg.attention_backend == "maclaurin" or len(layer_cache[0]) != 2:
            raise NotImplementedError(
                f"{self.cfg.name}: a cache whose kv heads do not divide the model axis "
                "is only sharded for the softmax backend's bf16/f32 KV cache"
            )

    def rows_out(self, out: list, lp: list[dict], key: tuple) -> list:
        """Each member's rows of the whole attention output through its
        ``w_o`` block, the partial sums reduced where ``w_o`` is row-cut."""
        res = []
        for p in range(self.n):
            rows = self.block(key + ("w_o",), p, 0)
            res.append(out[p][..., rows] @ lp[p][key[-1]]["w_o"])
        return self.finish(res, bool(self.cuts[key + ("w_o",)].axes[0]))

    def cross_decode(self, g: int, stacks, x: list, cross: list, layout: tuple) -> list:
        """One token through cross block ``g``, reading the cached image
        K/V (or their ``MacState``) at slot ``g``."""
        cfg = self.cfg
        lp = self.block_params(stacks, "cross_layers", g)
        h = [rmsnorm(lp[p]["ln1"], x[p]) for p in range(self.n)]
        layer = [tf._layer_cache(c, g) for c in cross]
        heads_ax, seq_blocks = layout
        if not self.tp or heads_ax:
            local = self.heads_cfg(self.tp_parts(heads_ax))
            a = [
                tf._cross_attn_decode(local, lp[p]["xattn"], h[p], layer[p])
                for p in range(self.n)
            ]
            a = self.finish(a, bool(heads_ax))
        else:
            self.refuse_gathered(layer)
            q = [h[p] @ lp[p]["xattn"]["w_q"] for p in range(self.n)]
            if self.cuts[("cross_layers", "xattn", "w_q")].axes[1]:
                q = self.gather_tp(q, -1)
            B = q[0].shape[0]
            q = [qi.reshape(B, 1, cfg.n_heads, cfg.hd) for qi in q]
            out = self.attend_gathered(q, layer, seq_blocks, None, None)
            a = self.rows_out(out, lp, ("cross_layers", "xattn"))
        x = [xi + ai for xi, ai in zip(x, a)]
        h = [rmsnorm(lp[p]["ln2"], x[p]) for p in range(self.n)]
        y, _ = self.ffn(lp, h, want_aux=False, prefix="cross_layers")
        return [xi + yi for xi, yi in zip(x, y)]

    def attend_gathered(self, q: list, layer_cache, seq_blocks, pos, kv) -> list:
        """Each member's whole query (B, 1, Hq, hd) -> its (B, 1, Hq hd)
        attention output over its cache blocks. ``kv``: each member's whole
        new (k, v) heads, written at slot ``pos`` and read causally; None
        for the image context (no write, no mask). A replicated cache: the
        slot written and read whole on each member. A sequence-cut cache:
        the slot's owner writes it, each member its scores over its slots,
        and one combine over the group (the max, then the sums of
        exponentials and of weighted values)."""
        cfg = self.cfg
        Hq, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
        f32 = torch.float32
        heads, scores, tops = [], [], []
        for p in range(self.n):
            B = q[p].shape[0]
            ck, cv = layer_cache[p]
            if seq_blocks is None:
                if kv is not None:
                    write_slot(ck, cv, *kv[p], pos)
                last = pos if kv is not None else ck.shape[1] - 1
                heads.append(decode_attend(q[p], ck, cv, last, Hq, hd))
                continue
            sl = seq_blocks[p]
            if kv is not None and sl.start <= pos < sl.stop:
                write_slot(ck, cv, *kv[p], pos - sl.start)
            qh = q[p].reshape(B, 1, Hkv, Hq // Hkv, hd).to(f32)
            u = torch.einsum("bthgd,bshd->bhgts", qh, ck.to(f32)) * (1.0 / hd**0.5)
            if kv is not None:
                slots = sl.start + torch.arange(ck.shape[1], device=u.device)
                u = u.masked_fill(slots > pos, -torch.inf)
            scores.append(u)
            tops.append(torch.amax(u, dim=-1, keepdim=True))
        if seq_blocks is None:
            return heads
        tops = self.over(self.tp_groups, tops, coll.all_max)
        e = [torch.exp(u - t) for u, t in zip(scores, tops)]
        total = self.tp_reduce([torch.sum(x, dim=-1) for x in e])  # (B, Hkv, g, 1)
        num = [
            torch.einsum("bhgts,bshd->bthgd", x, layer_cache[p][1].to(f32))
            for p, x in enumerate(e)
        ]
        num = self.tp_reduce(num)  # (B, 1, Hkv, g, hd)
        out = []
        for p in range(self.n):
            B = num[p].shape[0]
            o = num[p] / total[p].permute(0, 3, 1, 2)[..., None]
            out.append(o.reshape(B, 1, Hq * hd).to(self.dtype))
        return out
