"""Decode through a cache whose kv heads do not divide "model", on a
(data, model) mesh of 2 x 2 CPU slots under TP_ONLY, against the port's
one-device decode (the JAX package's: ``test_torch_sharded_decode_ref.py``).

A reduced dense config with 9 q and 3 kv heads at head_dim 8, so that
neither divides model = 2: q, k and v are gathered on every member, which
reads its whole copy of the cache and takes its own rows through its
``w_o`` block. Through the maclaurin backend's ``MacState`` (its kv-head
cut dropped: a replica over "model"), each member extends its state with
every kv head; through the int8 KV cache, cut along its sequence over
"model" where T divides it (each member dequantizes its block with its own
per-token scales, the slot's owner writes the new token) and a replica
where it does not. The VLM's self and cross ``MacState`` caches, the image
context read and never extended. Before F11 was repaired each of these
raised ``NotImplementedError``.

Two decode steps each, from a cache placed by the cell's cache shardings:
logits within RTOL = 1e-5 of the largest logit (f32 sums over the cut in
another order; at most 8.2e-7 of it here), the cache's replicas bit for bit
equal and each leaf within RTOL of its largest entry against the
one-device cache (at most 6.9e-7). Serving cells hold bf16 weights, so the one-device
steps run on the same weights rounded to bf16.
"""

import copy
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.serve import decode_step as ds  # noqa: E402
from repro_torch.sharding import partitioning as part  # noqa: E402
from repro_torch.sharding.partitioning import device_put  # noqa: E402

RTOL = 1e-5
B = 4
NARROW = dict(n_heads=9, n_kv_heads=3, head_dim=8)
MACLAURIN = dict(attention_backend="maclaurin", **NARROW)
INT8 = dict(kv_cache_dtype="int8", **NARROW)


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _mesh():
    return make_mesh((2, 2), ("data", "model"), devices=["cpu"] * 4)


def _rounded(params):
    out = copy.deepcopy(params)
    with torch.no_grad():
        for p in out.parameters():
            p.copy_(p.to(torch.bfloat16))
    return out


def _close(got, want, what):
    got, want = torch.as_tensor(got).double(), torch.as_tensor(want).double()
    assert got.shape == want.shape, what
    worst = float((got - want).abs().max())
    assert worst <= RTOL * float(want.abs().max()), (what, worst)


def _leaves(cache):
    return [leaf for stack in cache.values() for leaf in stack]


def decode_cell(name: str, changes: dict, T: int, params=None):
    """(cell, weights, one-device weights, tokens, images) of a decode cell
    of ``name`` reduced with ``changes`` on the 2 x 2 mesh."""
    cfg = dataclasses.replace(ARCHS[name].reduced(), **changes)
    params = params if params is not None else tf.init_params(cfg, seed=1, device="cpu")
    g = torch.Generator().manual_seed(3)
    tokens = torch.randint(0, cfg.vocab_size, (B, 2), generator=g, dtype=torch.int32)
    images = None
    if cfg.family == "vlm":
        images = torch.randn((B, cfg.n_image_tokens, cfg.d_model), generator=g)
    shape = ShapeConfig("d", T, B, "decode")
    cell = specs.build_cell(cfg, shape, _mesh(), part.TP_ONLY_RULES, params=params)
    return cell, cfg, _rounded(params), tokens, images


def _decode_against_one_device(name, changes, T):
    cell, cfg, rounded, tokens, images = decode_cell(name, changes, T)
    whole = tf.init_cache(cfg, B, T, image_embeds=images, params=rounded, dtype=torch.float32, device="cpu")
    want_cache = tf.init_cache(cfg, B, T, image_embeds=images, params=rounded, dtype=torch.float32, device="cpu")
    cache = device_put(whole, cell.in_shardings[3])
    step = ds.make_serve_step(cfg)
    extra = () if images is None else (images,)
    for pos in range(2):
        tok = tokens[:, pos : pos + 1]
        logits, cache = cell.step_fn(cell.args[0], tok, pos, cache, *extra)
        logits = logits.gather()
        want, want_cache = step(rounded, tok, pos, want_cache, *extra)
        _close(logits, want, f"logits at {pos}")
    for got, want in zip(_leaves(cache), _leaves(want_cache)):
        _close(got.gather(), want, "cache")
        for group in got.replica_groups():
            assert all(torch.equal(got.local(p), got.local(group[0])) for p in group)
    return cell


def test_maclaurin_state_replicated_over_model():
    cell = _decode_against_one_device("smollm-135m", MACLAURIN, 16)
    for sh in cell.in_shardings[3]["kv"]:  # the kv-head cut dropped: batch only
        assert "model" not in [a for s in sh.spec if s for a in ((s,) if isinstance(s, str) else s)]


@pytest.mark.parametrize("T", [16, 15])
def test_int8_cache_sequence_cut_and_replicated(T):
    cell = _decode_against_one_device("smollm-135m", INT8, T)
    want = (None, "data", "model", None, None) if T % 2 == 0 else (None, "data", None, None, None)
    for sh in cell.in_shardings[3]["kv"]:
        assert tuple(sh.spec) + (None,) * (5 - len(sh.spec)) == want


def test_vlm_self_and_cross_states():
    _decode_against_one_device("llama-3.2-vision-90b", MACLAURIN, 16)
