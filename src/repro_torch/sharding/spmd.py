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

  * FSDP: each leaf's "embed"-cut dim gathered over its mesh axes right
    before its block (the gather's backward is the reduce-scatter of its
    gradient), inside the layer's ``remat`` so that the backward gathers
    again;
  * tensor parallelism over "model" (when the batch is not cut over it):
    column-cut q/k/v, ``w_gate``/``w_up`` and the experts' ``ffn``,
    row-cut ``w_o``/``w_down``, each product's partial sums all-reduced;
    a vocab-cut embedding looked up by range and all-reduced; vocab-cut
    logits with a vocab-parallel cross-entropy;
  * attention on a head shard where the q and kv cuts hold whole heads (q
    shard p's heads then read kv shard p's); otherwise q, k and v gathered
    over the group, attention once a group, each member its ``w_o`` rows;
  * experts over "model": each member's experts on the replicated
    dispatch buffer, then the all-reduce; over "data" (``EP_DATA_RULES``):
    the buffer all-to-all'd to the experts' owners and back;
  * the MoE aux loss from the global ``me`` and ``ce`` (their sums
    all-reduced over the batch axes), the token loss a sum over the data
    shards over the global count, each counted once.

The blocks are the port's own functions (``transformer._attn_forward``,
``_attn_core``, ``_attn_decode``, ``layers.swiglu``, ``moe.route``,
``moe.experts``) on local shards. Families other than ``dense`` and
``moe``, rule sets other than the four ``choose_rules`` picks, and mesh
axes other than "pod", "data" and "model" raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import Mesh
from repro_torch.models import transformer as tf
from repro_torch.models.attention import (
    decode_attend,
    qkv_columns,
    split_heads,
    write_slot,
)
from repro_torch.models.layers import remat, rmsnorm, swiglu
from repro_torch.models.moe import _combine, experts, load_counts, route
from repro_torch.sharding import collectives as coll
from repro_torch.sharding.partitioning import (
    DEFAULT_RULES,
    DP_ONLY_RULES,
    EP_DATA_RULES,
    TP_ONLY_RULES,
    AxisRules,
    Sharded,
    axis_groups,
    batch_sharding,
)

SHARDED_FAMILIES = ("dense", "moe")
RULE_SETS = {
    "DEFAULT_RULES": DEFAULT_RULES,
    "TP_ONLY_RULES": TP_ONLY_RULES,
    "EP_DATA_RULES": EP_DATA_RULES,
    "DP_ONLY_RULES": DP_ONLY_RULES,
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


@dataclasses.dataclass(frozen=True)
class Cut:
    """How one leaf is cut: the mesh axes of each dim, its logical names,
    and the index of each position's block (the stacked layer axis dropped
    for layer leaves)."""

    axes: tuple[tuple[str, ...], ...]
    logical: tuple
    blocks: tuple[tuple[slice, ...], ...]


def _cut(leaf: Sharded, logical: tuple, drop: int) -> Cut:
    sh = leaf.sharding
    axes = tuple(sh.dim_axes(len(leaf.shape)))[drop:]
    logical = tuple(logical) + (None,) * (len(leaf.shape) - len(logical))
    blocks = tuple(sh.index(leaf.shape, p)[drop:] for p in range(len(leaf.shards)))
    return Cut(axes, logical[drop:], blocks)


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
        self.batch_groups = axis_groups(mesh, self.batch_axes)
        off_batch = [a for a in mesh.axis_names if a not in self.batch_axes]
        reps = [g[0] for g in axis_groups(mesh, off_batch)]
        index = lambda p: self.batch.index((global_batch,), p)[0].start  # noqa: E731
        self.reps = sorted(reps, key=index)  # one position a batch block, in order
        spec = flat(logical_spec(cfg))
        self.cuts = {}
        for path, leaf in flat(params).items():
            self.cuts[path] = _cut(leaf, spec[path], 1 if path[0] == "layers" else 0)
        self._check_layout()

    # ------------------------------------------------------------ layout

    def _check_layout(self) -> None:
        """Each cut is one this executor carries out: "embed" gathered and
        "experts" exchanged over any axes, any other dim over the
        tensor-parallel axis."""
        for path, cut in self.cuts.items():
            for logical, axes in zip(cut.logical, cut.axes):
                if not axes or logical in ("embed", "experts") or axes == (self.tp,):
                    continue
                raise NotImplementedError(
                    f"{'/'.join(path)}: no sharded step cuts its {logical!r} dim "
                    f"over {axes}"
                )

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

    def fsdp(self, path, xs: list) -> list:
        """Leaf ``path``'s blocks (a layer leaf's, one layer's) with their
        "embed" dim gathered over the axes that cut it."""
        cut = self.cuts[path]
        for dim, (logical, axes) in enumerate(zip(cut.logical, cut.axes)):
            if logical == "embed" and axes:
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

    def layer_params(self, layers: list[dict], i: int) -> list[dict]:
        """Layer ``i``'s parameters a position, cast to the compute dtype and
        FSDP-gathered, as ``layer.tensors(dtype)`` nests them."""
        out = [dict() for _ in range(self.n)]
        for path in layers[0]:
            xs = [layers[p][path][i].to(self.dtype) for p in range(self.n)]
            xs = self.fsdp(("layers",) + path, xs)
            for p in range(self.n):
                out[p][path] = xs[p]
        return [nest(o) for o in out]

    def embed(self, top: list[dict], tokens: list) -> list:
        path = ("embed", "table")
        table = self.fsdp(path, [t[path] for t in top])
        if not self.cuts[path].axes[0]:
            return [table[p][tokens[p]].to(self.dtype) for p in range(self.n)]
        x = []
        for p in range(self.n):
            rows = table[p].shape[0]
            t = tokens[p].long() - self.block(path, p, 0).start
            inside = (t >= 0) & (t < rows)
            got = table[p][t.clamp(0, rows - 1)]
            x.append(torch.where(inside[..., None], got, 0.0))
        return [xi.to(self.dtype) for xi in self.tp_reduce(x)]

    def head(self, top: list[dict], x: list) -> list:
        """Final norm and LM head: each position's (B, T, its vocab) logits."""
        ln, head = ("final_ln", "scale"), ("lm_head", "w")
        scale = self.fsdp(ln, [t[ln] for t in top])
        w = self.fsdp(head, [t[head].to(self.dtype) for t in top])
        return [
            rmsnorm({"scale": scale[p]}, x[p]) @ w[p] for p in range(self.n)
        ]

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

    def attention(self, lp: list[dict], h: list, pos: list) -> list:
        cfg = self.cfg
        q_ax = self.cuts[("layers", "attn", "w_q")].axes[1]
        kv_ax = self.cuts[("layers", "attn", "w_k")].axes[1]
        o_ax = self.cuts[("layers", "attn", "w_o")].axes[0]
        parts = self.tp_parts(q_ax)
        whole = cfg.n_heads % parts == 0 and cfg.n_kv_heads % parts == 0
        if q_ax == kv_ax == o_ax and whole:
            local = self.heads_cfg(parts)  # whole heads: attention on the shard
            out = [
                tf._attn_forward(local, lp[p]["attn"], h[p], pos[p])
                for p in range(self.n)
            ]
            return self.tp_reduce(out) if q_ax else out
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
                rows = self.block(("layers", "attn", "w_o"), p, 0)
                out[p] = o[..., rows].to(self.devices[p]) @ lp[p]["attn"]["w_o"]
        return self.tp_reduce(out) if o_ax else out

    def ffn(self, lp: list[dict], h: list, want_aux: bool):
        """(y a position, aux a position or None)."""
        cfg = self.cfg
        aux = None
        if cfg.moe_num_experts:
            y, aux = self.moe(lp, h, want_aux)
        if not cfg.moe_num_experts or cfg.moe_dense_residual:
            dense = [swiglu(lp[p]["ffn"], h[p]) for p in range(self.n)]
            if self.cuts[("layers", "ffn", "w_down")].axes[0]:
                dense = self.tp_reduce(dense)
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
        if e_ax == (self.tp,) or f_ax:
            out = self.tp_reduce(out)
        if not want_aux:
            return out, None
        tokens = self.global_batch * h[0].shape[1]
        me = [r[2].sum(dim=(0, 1)) for r in routed]
        me = self.over(self.batch_groups, me, coll.all_reduce)
        ce = [load_counts(r[3], E).sum(dim=(0, 1)) for r in routed]
        ce = self.over(self.batch_groups, ce, coll.all_reduce)
        return out, [E * torch.sum((m / tokens) * (c / tokens)) for m, c in zip(me, ce)]

    def layer(self, i: int, layers: list[dict], x: list, pos: list):
        """Dense block ``i`` (the one-device ``_dense_block``): (x, aux)."""
        lp = self.layer_params(layers, i)
        h = [rmsnorm(lp[p]["ln1"], x[p]) for p in range(self.n)]
        a = self.attention(lp, h, pos)
        x = [xi + ai for xi, ai in zip(x, a)]
        h = [rmsnorm(lp[p]["ln2"], x[p]) for p in range(self.n)]
        y, aux = self.ffn(lp, h, want_aux=True)
        return [xi + yi for xi, yi in zip(x, y)], aux

    # ----------------------------------------------------------- programs

    def split(self, local: list[dict]):
        """(top-level leaves, layer leaves) a position, flat."""
        top = [{k: v for k, v in t.items() if k[0] != "layers"} for t in local]
        layers = [{k[1:]: v for k, v in t.items() if k[0] == "layers"} for t in local]
        return top, layers

    def forward(self, local: list[dict], tokens: list):
        """``transformer.forward`` over the mesh: (logits a position, each
        (B, T, its vocab), the aux loss summed over layers a position)."""
        top, layers = self.split(local)
        T = tokens[0].shape[1]
        x = self.embed(top, tokens)
        pos = [torch.arange(T, dtype=torch.int32, device=d) for d in self.devices]
        aux = [torch.zeros((), dtype=torch.float32, device=d) for d in self.devices]
        for i in range(self.cfg.n_layers):
            if self.cfg.remat:
                x, a = remat(self.layer, i, layers, x, pos)
            else:
                x, a = self.layer(i, layers, x, pos)
            if a is not None:
                aux = [s + ai for s, ai in zip(aux, a)]
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
        where the sequence is cut, else None) of a placed ``kv`` stack: a
        KV tuple of (L, B, S, Hkv, hd) leaves or a ``MacState``."""
        first = kv[0]
        axes = first.sharding.dim_axes(len(first.shape))
        mac_state = isinstance(kv, tf.mac.MacState)
        heads, seq = (axes[2], ()) if mac_state else (axes[3], axes[2])
        for what, ax in (("kv-head", heads), ("sequence", seq)):
            if ax and ax != (self.tp,):
                raise NotImplementedError(
                    f"no sharded decode cuts the cache's {what} dim over {ax}"
                )
        if tuple(axes[1]) != self.batch_axes:
            raise ValueError(
                f"the cache's batch dim is cut over {axes[1]}, "
                f"the batch over {self.batch_axes}"
            )
        if not seq:
            return heads, None
        return heads, [first.sharding.index(first.shape, p)[2] for p in range(self.n)]

    def decode(
        self, local: list[dict], tokens: list, pos: int, cache: list, layout: tuple
    ) -> list:
        """``transformer.decode`` over the mesh (dense and MoE stacks):
        logits a position. ``cache``: each position's blocks of the kv stack
        (written in place), laid out as ``cache_layout`` says."""
        top, layers = self.split(local)
        x = self.embed(top, tokens)
        for i in range(self.cfg.n_layers):
            lp = self.layer_params(layers, i)
            h = [rmsnorm(lp[p]["ln1"], x[p]) for p in range(self.n)]
            a = self.attention_decode(lp, h, pos, cache, layout, i)
            x = [xi + ai for xi, ai in zip(x, a)]
            h = [rmsnorm(lp[p]["ln2"], x[p]) for p in range(self.n)]
            y, _ = self.ffn(lp, h, want_aux=False)
            x = [xi + yi for xi, yi in zip(x, y)]
        return self.head(top, x)

    def attention_decode(
        self, lp, h, pos: int, cache: list, layout: tuple, i: int
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
            return self.tp_reduce(out) if heads_ax else out
        if cfg.attention_backend == "maclaurin" or len(layer_cache[0]) != 2:
            raise NotImplementedError(
                f"{cfg.name}: a cache whose kv heads do not divide the model axis "
                "is only sharded for the softmax backend's bf16/f32 KV cache"
            )
        cols = [qkv_columns(lp[p]["attn"], h[p]) for p in range(self.n)]
        q_ax = self.cuts[("layers", "attn", "w_q")].axes[1]
        kv_ax = self.cuts[("layers", "attn", "w_k")].axes[1]
        full = []
        for j, ax in enumerate((q_ax, kv_ax, kv_ax)):
            xs = [c[j] for c in cols]
            if ax:
                xs = self.over(self.tp_groups, xs, lambda m: coll.all_gather(m, -1))
            full.append(xs)
        out = self.attend_gathered(full, pos, layer_cache, seq_blocks)
        o_ax = self.cuts[("layers", "attn", "w_o")].axes[0]
        res = []
        for p in range(self.n):
            rows = self.block(("layers", "attn", "w_o"), p, 0)
            res.append(out[p][..., rows] @ lp[p]["attn"]["w_o"])
        return self.tp_reduce(res) if o_ax else res

    def attend_gathered(self, full, pos: int, layer_cache, seq_blocks) -> list:
        """Each member's whole q, k, v -> its (B, 1, Hq hd) attention output.
        A replicated cache: the slot written and read whole on each member.
        A sequence-cut cache: the slot's owner writes it, each member its
        scores over its slots, and one combine over the group (the max,
        then the sums of exponentials and of weighted values)."""
        cfg = self.cfg
        Hq, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
        f32 = torch.float32
        heads, scores, tops = [], [], []
        for p in range(self.n):
            B = full[0][p].shape[0]
            dev = self.devices[p]
            positions = torch.full((B, 1), pos, dtype=torch.int32, device=dev)
            qkv = (full[0][p], full[1][p], full[2][p])
            q, k, v = split_heads(*qkv, Hq, Hkv, hd, positions, cfg.rope_theta)
            ck, cv = layer_cache[p]
            if seq_blocks is None:
                write_slot(ck, cv, k, v, pos)
                heads.append(decode_attend(q, ck, cv, pos, Hq, hd))
                continue
            sl = seq_blocks[p]
            if sl.start <= pos < sl.stop:
                write_slot(ck, cv, k, v, pos - sl.start)
            qh = q.reshape(B, 1, Hkv, Hq // Hkv, hd).to(f32)
            u = torch.einsum("bthgd,bshd->bhgts", qh, ck.to(f32)) * (1.0 / hd**0.5)
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
