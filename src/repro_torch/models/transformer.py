"""Decoder stacks of every family: parameters, forward (prefill) and
one-token decode.

The port of ``repro/models/transformer.py``: dense/GQA transformers
(``dense``, ``audio``; ``moe``, optionally with arctic's dense residual),
RWKV6 (``ssm``), Mamba2 with one shared attention block (``hybrid``, the
Zamba2 pattern) and self-attention stacks with interleaved
cross-attention to image tokens (``vlm``, the Llama-3.2-vision pattern).
``lax.scan`` over stacked layers becomes a loop over an
``nn.ModuleList``. The reference's sharding hints stand where it puts
them (``sharding.hints.hint``: each scanned layer's residual stream on
the way in and out, the embedding, the logits); they resolve their specs
under ``use_hints`` and never change a value. ``LMParams.spec()`` is the
reference's spec tree. Its ``jax.checkpoint`` is ``layers.remat``,
placed as the reference places it: with ``cfg.remat`` each layer of a
scanned stack (the dense blocks, RWKV6 blocks, Mamba2 blocks and the
VLM's self-attention blocks; not hybrid's shared block or the VLM's
cross blocks), taken only while autograd records a graph.

``forward`` records a graph where the parameters require gradients:
they are built frozen (``requires_grad=False``), and a trainer turns them
on for the module it trains (``train.train_step``). ``decode`` and the
serving steps run under ``torch.inference_mode``.

What is cast to ``cfg.dtype``, as in the reference: the layer stack
(every layer parameter, norms included) and the LM head, at each call.
The embedding table is gathered in f32 and the rows cast; ``final_ln``
stays f32.

Attention backends:
  "softmax"    exact attention (``attention_impl`` "blockwise": plain
               tensor code; "flash": kernel B9, one launch a layer)
  "maclaurin"  the paper's second-order collapse (from T = 1024 kernel
               B8, one launch a layer; decode from the O(d^2) state)
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch import device as _device
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attn import flash_attention
from repro_torch.models import maclaurin_attention as mac
from repro_torch.models.attention import (
    Attention,
    CrossAttention,
    _gqa_scores_full,
    _project_qkv,
    cross_attention,
    decode_attention,
    decode_attention_quant,
    kv_quant_groups,
)
from repro_torch.models.layers import (
    Embedding,
    LMHead,
    ParamModule,
    RMSNorm,
    SwiGLU,
    embed,
    lm_head,
    remat,
    rmsnorm,
    swiglu,
)
from repro_torch.models.moe import MoE, moe_forward
from repro_torch.models.rwkv import (
    RWKV6,
    channel_mix,
    rwkv6_init_state,
    time_mix_decode,
    time_mix_forward,
)
from repro_torch.models.ssm import (
    Mamba2,
    mamba2_decode,
    mamba2_forward,
    mamba2_init_state,
)
from repro_torch.sharding.hints import hint

SEED = 0


# ======================================================================
# parameter construction
# ======================================================================


class DenseLayer(ParamModule):
    """Pre-norm attention + FFN/MoE block: ``ln1``, ``attn``, ``ln2``, and
    ``ffn`` (SwiGLU) or ``moe``; with ``moe_dense_residual`` (arctic) both,
    the dense FFN in parallel with the experts."""

    def __init__(self, cfg: ModelConfig, generator, device=None):
        super().__init__()
        d = cfg.d_model
        self.ln1 = RMSNorm(d, device)
        self.attn = Attention(
            d, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.qkv_bias, generator, device
        )
        self.ln2 = RMSNorm(d, device)
        if cfg.moe_num_experts:
            self.moe = MoE(d, cfg.moe_d_ff, cfg.moe_num_experts, generator, device)
        if not cfg.moe_num_experts or cfg.moe_dense_residual:
            self.ffn = SwiGLU(d, cfg.d_ff, generator, device)


class CrossLayer(ParamModule):
    """The VLM's cross-attention block: ``ln1``, ``xattn``, ``ln2``, ``ffn``."""

    def __init__(self, cfg: ModelConfig, generator, device=None):
        super().__init__()
        d = cfg.d_model
        self.ln1 = RMSNorm(d, device)
        self.xattn = CrossAttention(
            d, cfg.n_heads, cfg.n_kv_heads, cfg.hd, generator, device
        )
        self.ln2 = RMSNorm(d, device)
        self.ffn = SwiGLU(d, cfg.d_ff, generator, device)


def vlm_layout(cfg: ModelConfig) -> tuple[int, int, int]:
    """(cross layers, self layers, self layers a superblock) of a VLM."""
    n_cross = cfg.n_layers // (cfg.cross_attn_every or cfg.n_layers)
    n_self = cfg.n_layers - n_cross
    return n_cross, n_self, n_self // n_cross


class LMParams(ParamModule):
    """``embed``, ``lm_head``, ``final_ln`` and the family's stack, one
    module a layer where the reference stacks every leaf along a layer
    axis: ``layers`` (dense/moe/audio: ``DenseLayer``; ssm: ``RWKV6``;
    hybrid: ``Mamba2``; vlm: the self-attention ``DenseLayer``s), with
    hybrid's one ``shared_attn`` ``DenseLayer`` (unstacked, as in the
    reference) and vlm's ``cross_layers``."""

    def __init__(self, cfg: ModelConfig, generator, device=None):
        super().__init__()
        self.embed = Embedding(cfg.vocab_size, cfg.d_model, generator, device)
        self.lm_head = LMHead(cfg.d_model, cfg.vocab_size, generator, device)
        self.final_ln = RMSNorm(cfg.d_model, device)
        d, n = cfg.d_model, cfg.n_layers
        if cfg.family == "ssm":
            opts = dict(head_dim=cfg.rwkv_head_dim)
            layers = (RWKV6(d, cfg.d_ff, generator, device, **opts) for _ in range(n))
        elif cfg.family == "hybrid":
            opts = dict(
                d_state=cfg.ssm_state, head_dim=cfg.ssm_head_dim, expand=cfg.ssm_expand
            )
            layers = (Mamba2(d, generator, device, **opts) for _ in range(n))
        elif cfg.family == "vlm":
            n = vlm_layout(cfg)[1]
            layers = (DenseLayer(cfg, generator, device) for _ in range(n))
        else:
            layers = (DenseLayer(cfg, generator, device) for _ in range(n))
        self.layers = nn.ModuleList(layers)
        if cfg.family == "hybrid":
            self.shared_attn = DenseLayer(cfg, generator, device)
        if cfg.family == "vlm":
            n_cross = vlm_layout(cfg)[0]
            self.cross_layers = nn.ModuleList(
                CrossLayer(cfg, generator, device) for _ in range(n_cross)
            )

    def tree(self, leaf=None) -> dict:
        """The reference's tree of these parameters: nested dicts under its
        keys, each ``nn.ModuleList`` (``layers``, ``cross_layers``) with every
        leaf stacked along a first layer axis (a copy), the rest as they
        are. ``leaf(p)`` stands in for each parameter where given (e.g. its
        gradient)."""
        leaf = leaf or (lambda p: p)
        out = {}
        for name, child in self.named_children():
            if isinstance(child, nn.ModuleList):
                layers = [dict(layer.named_parameters()) for layer in child]
                flat = {
                    path: torch.stack([leaf(layer[path]) for layer in layers])
                    for path in layers[0]
                }
            else:
                flat = {path: leaf(p) for path, p in child.named_parameters()}
            out[name] = _nest(flat)
        return out

    def spec(self) -> dict:
        """The reference's spec tree of these parameters (the second half
        of its ``init_params``), in ``tree()``'s layout: each stacked leaf's
        spec led by "layers"."""
        out = {}
        for name, child in self.named_children():
            if isinstance(child, nn.ModuleList):
                out[name] = _map_specs(lambda s: ("layers",) + s, child[0].spec())
            else:
                out[name] = child.spec()
        return out

    @torch.no_grad()
    def assign(self, tree: dict) -> "LMParams":
        """Copy the reference's tree (as ``tree`` gives it) into these
        parameters in place; returns self."""
        for name, child in self.named_children():
            if isinstance(child, nn.ModuleList):
                for i, layer in enumerate(child):
                    for path, p in layer.named_parameters():
                        p.copy_(_leaf(tree[name], path)[i])
            else:
                for path, p in child.named_parameters():
                    p.copy_(_leaf(tree[name], path))
        return self


def _map_specs(fn, spec: dict) -> dict:
    return {
        k: _map_specs(fn, v) if isinstance(v, dict) else fn(v) for k, v in spec.items()
    }


def _nest(flat: dict) -> dict:
    """``{"attn.w_q": x}`` -> ``{"attn": {"w_q": x}}``."""
    out = {}
    for path, value in flat.items():
        *parents, key = path.split(".")
        node = out
        for part in parents:
            node = node.setdefault(part, {})
        node[key] = value
    return out


def _leaf(tree: dict, path: str):
    for key in path.split("."):
        tree = tree[key]
    return tree


def init_params(cfg: ModelConfig, seed: int = SEED, device=None) -> LMParams:
    """Random weights from a ``torch.Generator`` seeded with ``seed``, at
    the reference's scales. Built on ``device``: CUDA unless the caller
    says, raising when there is no card. On a ``meta`` device (shapes
    only, as the dry run builds a full-width model) nothing is drawn."""
    dev = _device.resolve(device)
    generator = None if dev.type == "meta" else torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        return LMParams(cfg, generator, dev)


# ======================================================================
# forward (prefill)
# ======================================================================


def _attn_forward(cfg: ModelConfig, p_attn, x, positions):
    """Self-attention: the projections, ``_attn_core``, the output
    projection."""
    q, k, v = _project_qkv(
        p_attn, x, cfg.n_heads, cfg.n_kv_heads, cfg.hd, positions, cfg.rope_theta
    )
    return _attn_core(cfg, q, k, v) @ p_attn["w_o"]


def _attn_core(cfg: ModelConfig, q, k, v):
    """Causal attention of q (B, T, Hq, hd) over k, v (B, T, Hkv, hd),
    dispatched over backends/implementations -> (B, T, Hq hd)."""
    B, T = q.shape[:2]
    if cfg.attention_backend == "maclaurin":
        out = mac.maclaurin_attention_gqa(q, k, v)
    elif cfg.attention_impl == "flash":
        g = cfg.n_heads // cfg.n_kv_heads
        kq = torch.repeat_interleave(k, g, dim=2).transpose(1, 2)
        vq = torch.repeat_interleave(v, g, dim=2).transpose(1, 2)
        out = flash_attention(q.transpose(1, 2), kq, vq).transpose(1, 2)
    else:
        out = _gqa_scores_full(
            q, k, v, causal=True, scores_dtype=getattr(torch, cfg.attn_scores_dtype)
        )
    return out.reshape(B, T, cfg.n_heads * cfg.hd)


def _ffn(cfg: ModelConfig, p, h, return_aux: bool = True):
    """The block's FFN: SwiGLU, or the MoE (with arctic's dense residual
    beside it). Returns (y, aux_loss)."""
    if not cfg.moe_num_experts:
        zero = torch.zeros((), dtype=torch.float32, device=h.device)
        return swiglu(p["ffn"], h), zero
    y, aux = moe_forward(p["moe"], h, top_k=cfg.moe_top_k, return_aux=return_aux)
    if cfg.moe_dense_residual:
        y = y + swiglu(p["ffn"], h)
    return y, aux


def _dense_block(cfg: ModelConfig, p, x, positions):
    """Pre-norm attention + FFN/MoE block. Returns (x, aux_loss)."""
    x = x + _attn_forward(cfg, p["attn"], rmsnorm(p["ln1"], x), positions)
    y, aux = _ffn(cfg, p, rmsnorm(p["ln2"], x))
    return x + y, aux


def _rwkv_block(cfg: ModelConfig, p, x):
    h = rmsnorm({"scale": p["ln1"]}, x)
    x = x + time_mix_forward(p, h, head_dim=cfg.rwkv_head_dim, chunk=cfg.scan_chunk)
    out, _ = channel_mix(p, rmsnorm({"scale": p["ln2"]}, x))
    return x + out


def _mamba_block(cfg: ModelConfig, p, x):
    return x + mamba2_forward(
        p, x, d_state=cfg.ssm_state, head_dim=cfg.ssm_head_dim, chunk=cfg.scan_chunk
    )


def _cross_block(cfg: ModelConfig, pc, x, ctx):
    h = rmsnorm(pc["ln1"], x)
    x = x + cross_attention(
        pc["xattn"], h, ctx, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.hd
    )
    return x + swiglu(pc["ffn"], rmsnorm(pc["ln2"], x))


def _layer(cfg: ModelConfig, block, p, x, *extra):
    """One layer of a scanned stack, under ``remat`` where ``cfg.remat``,
    its residual stream hinted to batch sharding on the way in and out, as
    the reference's scan body does ("seq" is replicated unless the rules
    map it)."""
    x = hint(x, "batch", "seq", None)
    out = remat(block, cfg, p, x, *extra) if cfg.remat else block(cfg, p, x, *extra)
    if isinstance(out, tuple):
        return hint(out[0], "batch", "seq", None), out[1]
    return hint(out, "batch", "seq", None)


def forward(
    cfg: ModelConfig, params: LMParams, tokens: torch.Tensor, image_embeds=None
):
    """Full-sequence forward -> (logits, aux_loss). tokens: (B, T); a VLM
    also takes ``image_embeds`` (B, N, d). ``aux_loss`` is the sum over
    layers of the MoE load-balancing losses (0 for the other families).
    Records a graph when the parameters require gradients."""
    dtype = getattr(torch, cfg.dtype)
    T = tokens.shape[1]
    dev = tokens.device
    x = embed(params.embed.tensors(), tokens).to(dtype)
    x = hint(x, "batch", None, None)
    positions = torch.arange(T, dtype=torch.int32, device=dev)
    aux = torch.zeros((), dtype=torch.float32, device=dev)
    layers = params.layers
    if cfg.family == "ssm":
        for layer in layers:
            x = _layer(cfg, _rwkv_block, layer.tensors(dtype), x)
    elif cfg.family == "hybrid":
        k_every = cfg.hybrid_attn_every
        shared = params.shared_attn.tensors(dtype)
        for g in range(cfg.n_layers // k_every):
            for layer in layers[g * k_every : (g + 1) * k_every]:
                x = _layer(cfg, _mamba_block, layer.tensors(dtype), x)
            x, a = _dense_block(cfg, shared, x, positions)  # shared weights
            aux = aux + a
    elif cfg.family == "vlm":
        if image_embeds is None:
            raise ValueError(f"{cfg.name}: the vlm family's forward needs image_embeds")
        ctx = image_embeds.to(dtype)
        n_cross, _, per_block = vlm_layout(cfg)
        for g in range(n_cross):
            for layer in layers[g * per_block : (g + 1) * per_block]:
                x, a = _layer(cfg, _dense_block, layer.tensors(dtype), x, positions)
                aux = aux + a
            x = _cross_block(cfg, params.cross_layers[g].tensors(dtype), x, ctx)
    else:
        for layer in layers:
            x, a = _layer(cfg, _dense_block, layer.tensors(dtype), x, positions)
            aux = aux + a
    x = rmsnorm(params.final_ln.tensors(), x)
    logits = lm_head(params.lm_head.tensors(dtype), x)
    return hint(logits, "batch", None, "vocab"), aux


# ======================================================================
# decode (serve_step substrate)
# ======================================================================


def _mac_attn_decode(cfg: ModelConfig, p_attn, x, pos, state: mac.MacState):
    """Maclaurin-state decode attention: the paper's O(d^2) collapse.

    state leaves have batch dims (B, Hkv). Extend-then-readout = causal
    inclusive of the current token (matches the kernel/ref semantics).
    """
    B = x.shape[0]
    Hkv, g = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(
        p_attn, x, cfg.n_heads, cfg.n_kv_heads, cfg.hd, positions, cfg.rope_theta
    )
    k_bh = k.transpose(1, 2)  # (B, Hkv, 1, hd)
    v_bh = v.transpose(1, 2)
    f32 = torch.float32
    state = mac.extend_state(state, k_bh.to(f32), v_bh.to(f32))
    q_bh = q.reshape(B, 1, Hkv, g, cfg.hd)[:, 0].to(f32)  # (B, Hkv, g, hd)
    out, _valid = mac.readout(state, q_bh)  # (B, Hkv, g, hd)
    out = out.reshape(B, 1, cfg.n_heads * cfg.hd).to(x.dtype)
    return out @ p_attn["w_o"], state


def _dense_block_decode(cfg: ModelConfig, p, x, pos, attn_cache):
    """One-token dense block. attn_cache: (ck, cv) | int8 4-tuple | MacState."""
    h = rmsnorm(p["ln1"], x)
    attn_out, attn_cache = _attn_decode(cfg, p["attn"], h, pos, attn_cache)
    x = x + attn_out
    y, _ = _ffn(cfg, p, rmsnorm(p["ln2"], x), return_aux=False)
    return x + y, attn_cache


def _attn_decode(cfg: ModelConfig, p_attn, h, pos, attn_cache):
    """One-token self-attention through its cache: (B, 1, d), cache."""
    if cfg.attention_backend == "maclaurin":
        return _mac_attn_decode(cfg, p_attn, h, pos, attn_cache)
    heads = dict(
        n_heads=cfg.n_heads,
        n_kv=cfg.n_kv_heads,
        head_dim=cfg.hd,
        rope_theta=cfg.rope_theta,
    )
    attend = decode_attention_quant if len(attn_cache) == 4 else decode_attention
    out, *attn_cache = attend(p_attn, h, *attn_cache, pos, **heads)
    return out, attn_cache


def _cross_block_decode(cfg: ModelConfig, pc, x, cross):
    """One-token cross-attention block, its context read from the cache:
    the image K/V, or their ``MacState``."""
    x = x + _cross_attn_decode(cfg, pc["xattn"], rmsnorm(pc["ln1"], x), cross)
    return x + swiglu(pc["ffn"], rmsnorm(pc["ln2"], x))


def _cross_attn_decode(cfg: ModelConfig, p_xattn, h, cross):
    """One token's cross-attention over the cached context, through
    ``w_o``: (B, 1, d)."""
    B = h.shape[0]
    q = (h @ p_xattn["w_q"]).reshape(B, 1, cfg.n_heads, cfg.hd)
    if cfg.attention_backend == "maclaurin":
        Hkv, gq = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
        q_bh = q.reshape(B, 1, Hkv, gq, cfg.hd)[:, 0].to(torch.float32)
        out, _ = mac.readout(cross, q_bh)
        out = out.reshape(B, 1, cfg.n_heads * cfg.hd).to(h.dtype)
    else:
        kx, vx = cross
        out = _gqa_scores_full(q, kx.to(q.dtype), vx.to(q.dtype), causal=False)
        out = out.reshape(B, 1, cfg.n_heads * cfg.hd)
    return out @ p_xattn["w_o"]


def _layer_cache(tree, i: int):
    """Layer ``i``'s slice of a stacked KV tuple or ``MacState`` (views)."""
    leaves = [leaf[i] for leaf in tree]
    return mac.MacState(*leaves) if isinstance(tree, mac.MacState) else tuple(leaves)


def _store(tree, i: int, new) -> None:
    """Write a ``MacState`` layer back into slot ``i`` of its stack. KV
    slots are written in place by the attention and need no store."""
    if isinstance(tree, mac.MacState):
        for leaf, value in zip(tree, new):
            leaf[i] = value


def _kv(cfg: ModelConfig, L: int, B: int, S: int, dtype, dev):
    """L layers of the softmax backend's KV cache: (k, v) of ``dtype``, or
    with ``kv_cache_dtype="int8"`` (dense stacks only, as the reference's
    ``kv``) int8 values and f32 scales per 16-channel group."""
    Hkv, hd = cfg.n_kv_heads, cfg.hd
    shape = (L, B, S, Hkv, hd)
    if cfg.kv_cache_dtype == "int8" and cfg.family not in ("hybrid", "vlm"):
        scales = (L, B, S, Hkv, kv_quant_groups(hd))
        return (
            torch.zeros(shape, dtype=torch.int8, device=dev),
            torch.zeros(shape, dtype=torch.int8, device=dev),
            torch.zeros(scales, dtype=torch.float32, device=dev),
            torch.zeros(scales, dtype=torch.float32, device=dev),
        )
    return (
        torch.zeros(shape, dtype=dtype, device=dev),
        torch.zeros(shape, dtype=dtype, device=dev),
    )


def _attn_cache(cfg: ModelConfig, L: int, B: int, S: int, dtype, dev):
    if cfg.attention_backend == "maclaurin":
        return mac.init_state((L, B, cfg.n_kv_heads), cfg.hd, cfg.hd, device=dev)
    return _kv(cfg, L, B, S, dtype, dev)


def _tile(t, L: int):
    """``t`` repeated along a new first axis of L layers, f32."""
    return t[None].expand(L, *t.shape).to(torch.float32).contiguous()


def init_cache(
    cfg: ModelConfig,
    B: int,
    S: int,
    image_embeds=None,
    params=None,
    dtype=torch.bfloat16,
    device=None,
):
    """The decode cache for a context window of S tokens.

    dense/moe/audio: {"kv": (k, v)}, (L, B, S, Hkv, hd) tensors of
    ``dtype`` — O(S) memory; with ``kv_cache_dtype="int8"`` {"kv": (k, v,
    k_scale, v_scale)}, int8 values and f32 scales per 16-channel group;
    maclaurin backend: {"kv": MacState} with (L, B, Hkv, ...) f32 leaves —
    O(d^2), independent of S (S only bounds positions).
    ssm: {"S", "x_tm", "x_cm"}, the RWKV states, f32, a leading L axis.
    hybrid: {"ssm", "conv"} (f32, a leading L axis) and "attn", the shared
    block's KV pair or ``MacState`` over its G applications (never int8).
    vlm: {"self": KV pair or ``MacState`` over the self layers (never
    int8), "cross": per cross layer the image K/V in ``dtype``, computed
    once from ``image_embeds`` with ``params``, or their ``MacState``}.
    Built on ``device``: CUDA unless the caller says.
    """
    dev = _device.resolve(device)
    if cfg.family == "ssm":
        hd = cfg.rwkv_head_dim
        states = rwkv6_init_state(B, cfg.d_model, head_dim=hd, device=dev)
        tiled = (_tile(t, cfg.n_layers) for t in states)
        return dict(zip(("S", "x_tm", "x_cm"), tiled))
    if cfg.family == "hybrid":
        ssm, conv = mamba2_init_state(
            B, cfg.d_model, d_state=cfg.ssm_state, head_dim=cfg.ssm_head_dim,
            expand=cfg.ssm_expand, device=dev,
        )
        G = cfg.n_layers // cfg.hybrid_attn_every
        return {
            "ssm": _tile(ssm, cfg.n_layers),
            "conv": _tile(conv, cfg.n_layers),
            "attn": _attn_cache(cfg, G, B, S, dtype, dev),
        }
    if cfg.family == "vlm":
        if image_embeds is None or params is None:
            raise ValueError(f"{cfg.name}: the vlm cache needs image_embeds and params")
        n_self = vlm_layout(cfg)[1]
        Hkv, hd = cfg.n_kv_heads, cfg.hd
        N = image_embeds.shape[1]
        ctx = image_embeds.to(dtype)
        cross = []
        for layer in params.cross_layers:
            w = layer.xattn
            kx = (ctx @ w.w_k.to(dtype)).reshape(B, N, Hkv, hd)
            vx = (ctx @ w.w_v.to(dtype)).reshape(B, N, Hkv, hd)
            if cfg.attention_backend == "maclaurin":
                st = mac.init_state((B, Hkv), hd, hd, device=dev)
                k_bh, v_bh = (t.transpose(1, 2).to(torch.float32) for t in (kx, vx))
                cross.append(mac.extend_state(st, k_bh, v_bh))
            else:
                cross.append((kx, vx))
        stacked = tuple(torch.stack(leaves) for leaves in zip(*cross))
        if cfg.attention_backend == "maclaurin":
            stacked = mac.MacState(*stacked)
        return {"self": _attn_cache(cfg, n_self, B, S, dtype, dev), "cross": stacked}
    return {"kv": _attn_cache(cfg, cfg.n_layers, B, S, dtype, dev)}


def _tensors(tree):
    """Every tensor leaf of a cache (dicts, tuples and ``MacState``s)."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for value in tree.values():
            yield from _tensors(value)
    else:
        for value in tree:
            yield from _tensors(value)


def cache_bytes(cache) -> int:
    """Bytes the decode cache holds on the device: every tensor leaf."""
    return sum(t.numel() * t.element_size() for t in _tensors(cache))


@torch.inference_mode()
def decode(
    cfg: ModelConfig,
    params: LMParams,
    tokens: torch.Tensor,
    pos: int,
    cache,
    image_embeds=None,
):
    """One decode step. tokens: (B, 1) -> (logits (B, 1, V), cache).

    The caches are updated in place: KV slots ``pos`` are written, and the
    ``MacState`` and RWKV/Mamba state leaves are overwritten layer by
    layer, so the returned cache is the one passed in. States are stored
    f32 and cast to the compute dtype where the reference casts them. A
    VLM reads its image context from the cache (``image_embeds`` is taken,
    as the reference takes it, and not read).
    """
    dtype = getattr(torch, cfg.dtype)
    x = embed(params.embed.tensors(), tokens).to(dtype)
    x = hint(x, "batch", None, None)
    f32 = torch.float32
    if cfg.family == "ssm":
        for i, layer in enumerate(params.layers):
            p = layer.tensors(dtype)
            h = rmsnorm({"scale": p["ln1"]}, x)
            state = (cache["S"][i], cache["x_tm"][i].to(h.dtype))
            out, (S_, x_tm) = time_mix_decode(p, h, state, head_dim=cfg.rwkv_head_dim)
            x = x + out.to(x.dtype)
            h2 = rmsnorm({"scale": p["ln2"]}, x)
            out2, x_cm = channel_mix(p, h2, cache["x_cm"][i].to(h2.dtype))
            x = x + out2.to(x.dtype)
            for key, value in (("S", S_), ("x_tm", x_tm), ("x_cm", x_cm)):
                cache[key][i] = value.to(f32)
    elif cfg.family == "hybrid":
        k_every = cfg.hybrid_attn_every
        shared = params.shared_attn.tensors(dtype)
        attn = cache["attn"]
        for g in range(cfg.n_layers // k_every):
            for i in range(g * k_every, (g + 1) * k_every):
                p = params.layers[i].tensors(dtype)
                state = (cache["ssm"][i], cache["conv"][i])
                out, (ssm, conv) = mamba2_decode(
                    p, x, state, d_state=cfg.ssm_state, head_dim=cfg.ssm_head_dim
                )
                x = x + out.to(x.dtype)
                cache["ssm"][i], cache["conv"][i] = ssm.to(f32), conv.to(f32)
            x, new = _dense_block_decode(cfg, shared, x, pos, _layer_cache(attn, g))
            _store(attn, g, new)
    elif cfg.family == "vlm":
        n_cross, _, per_block = vlm_layout(cfg)
        own, cross = cache["self"], cache["cross"]
        for g in range(n_cross):
            for i in range(g * per_block, (g + 1) * per_block):
                p = params.layers[i].tensors(dtype)
                x, new = _dense_block_decode(cfg, p, x, pos, _layer_cache(own, i))
                _store(own, i, new)
            pc = params.cross_layers[g].tensors(dtype)
            x = _cross_block_decode(cfg, pc, x, _layer_cache(cross, g))
    else:
        kv = cache["kv"]
        for i, layer in enumerate(params.layers):
            p = layer.tensors(dtype)
            x, new = _dense_block_decode(cfg, p, x, pos, _layer_cache(kv, i))
            _store(kv, i, new)
    x = rmsnorm(params.final_ln.tensors(), x)
    logits = lm_head(params.lm_head.tensors(dtype), x)
    return logits, cache


def cache_spec(cfg: ModelConfig):
    """Logical-axis spec tree mirroring ``init_cache``'s structure: the
    reference's ``cache_spec``, which ``sharding.partitioning`` maps to
    shardings (``param_shardings``) as it does ``LMParams.spec()``."""
    kv_leaf = ("layers", "batch", None, "kv_heads", None)
    if cfg.kv_cache_dtype == "int8" and cfg.family not in ("hybrid", "vlm"):
        kv_tuple = (kv_leaf, kv_leaf, kv_leaf, kv_leaf)  # + per-token scales
    else:
        kv_tuple = (kv_leaf, kv_leaf)

    def mac_spec():
        return mac.MacState(
            s1=("layers", "batch", "kv_heads", None, None),
            s2=("layers", "batch", "kv_heads", None, None),
            k1=("layers", "batch", "kv_heads", None),
            k2=("layers", "batch", "kv_heads", None),
            n=("layers", "batch", "kv_heads", None),
            v0=("layers", "batch", "kv_heads", None),
            max_k_sq=("layers", "batch", "kv_heads", None),
        )

    maclaurin = cfg.attention_backend == "maclaurin"
    if cfg.family == "ssm":
        return {
            "S": ("layers", "batch", "heads", None, None),
            "x_tm": ("layers", "batch", None, None),
            "x_cm": ("layers", "batch", None, None),
        }
    if cfg.family == "hybrid":
        return {
            "ssm": ("layers", "batch", "ffn", None, None),
            "conv": ("layers", "batch", None, "ffn"),
            "attn": mac_spec() if maclaurin else (kv_leaf, kv_leaf),
        }
    if cfg.family == "vlm":
        self_ = mac_spec() if maclaurin else (kv_leaf, kv_leaf)
        cross = mac_spec() if maclaurin else (kv_leaf, kv_leaf)
        return {"self": self_, "cross": cross}
    return {"kv": mac_spec() if maclaurin else kv_tuple}
