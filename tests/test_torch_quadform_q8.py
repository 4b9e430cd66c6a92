"""Kernel B3's plain side against the JAX package's int8 quadform kernel.

The same seeded numpy inputs (an int8 Hessian and its column scales from
the reference quantizer) go through ``quadform_heads_q8_pallas`` (run in
interpret mode, as the JAX tests run it on the CPU) and
``quadform_heads_q8_xla``, and through the port's plain twin, the kernel
wrapper and the backend on CPU tensors (which compute with the twin).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.core.backend import quadform_heads_q8_xla  # noqa: E402
from repro.core.families import quantize as jq  # noqa: E402
from repro.kernels.common import TileConfig as JTileConfig  # noqa: E402
from repro.kernels.quadform.kernel import quadform_heads_q8_pallas  # noqa: E402
from repro_torch.core import backend  # noqa: E402
from repro_torch.kernels.common import tuning  # noqa: E402
from repro_torch.kernels.quadform import kernel as qf  # noqa: E402

RTOL = ATOL = 2e-4  # as tests/test_torch_quadform.py (B1)
NEAR_BOUND = 1e-3  # masks compared on rows this far (relative) from Eq 3.11


def _inputs(n, k, d, seed):
    """Z and an int8 stacked Hessian with its expanded column scales, v
    dequantized, and the head scalars (Eq 3.11 bound inside the batch)."""
    rng = np.random.default_rng(seed)
    Z = (rng.standard_normal((n, d)) * 0.5).astype(np.float32)
    M = (rng.standard_normal((k, d, d)) * 0.1).astype(np.float32)
    M = (M + M.transpose(0, 2, 1)) / 2
    M[:, :, -1] *= 30.0  # one heavy column group: scales must differ
    M_q, m_scale = jq.quantize_col_groups(M)
    col_scale = jq.expand_group_scales(m_scale, d)
    v_q, v_scale = map(np.asarray, jq.quantize_rows(rng.standard_normal((k, d))))
    V = v_q.astype(np.float32) * v_scale[:, None]
    c, b = rng.standard_normal((2, k)).astype(np.float32)
    gamma = rng.uniform(0.01, 0.05, k).astype(np.float32)
    z_sq = (Z.astype(np.float64) ** 2).sum(-1)
    msq = (0.0625 / gamma.astype(np.float64) ** 2 / np.median(z_sq)).astype(np.float32)
    return Z, np.array(M_q), np.array(col_scale), V, c, b, gamma, msq


def _away_from_bound(z_sq, gamma, msq):
    lhs = msq[None, :].astype(np.float64) * z_sq[:, None]
    rhs = 0.0625 / gamma[None, :].astype(np.float64) ** 2
    return np.abs(lhs - rhs) >= NEAR_BOUND * rhs


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("d", [16, 37])  # 37: a ragged last column group
@pytest.mark.parametrize("n", [5, 70])
def test_quadform_q8_plain_matches_pallas_and_xla(n, d, k):
    arrays = _inputs(n, k, d, seed=n * d + k)
    j_args = [jnp.asarray(a) for a in arrays]
    cfg = JTileConfig(block_n=64)
    j_out = quadform_heads_q8_pallas(*j_args, config=cfg, interpret=True)
    j_s, j_zsq, j_v = map(np.asarray, j_out)
    x_s, x_zsq, _ = map(np.asarray, quadform_heads_q8_xla(*j_args))
    np.testing.assert_allclose(j_s, x_s, rtol=RTOL, atol=ATOL)
    t_args = [torch.from_numpy(np.array(a)) for a in arrays]
    assert t_args[1].dtype == torch.int8
    launches = qf.KERNEL_Q8.launches
    for fn in (
        qf.quadform_heads_q8_torch,
        qf.quadform_heads_q8_cuda,
        backend.quadform_heads_q8,
    ):
        s, zsq, v = (x.numpy() for x in fn(*t_args))
        for ref_s in (j_s, x_s):
            np.testing.assert_allclose(s, ref_s, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(zsq, j_zsq, rtol=1e-5, atol=1e-5)
        keep = _away_from_bound(j_zsq, arrays[6], arrays[7])
        assert keep.sum() > 0 and (~j_v[keep]).any() and j_v[keep].any()
        np.testing.assert_array_equal(v[keep], j_v[keep])
    assert qf.KERNEL_Q8.launches == launches  # CPU tensors never launch it


def test_quadform_q8_twin_is_b1_on_the_dequantized_hessian():
    """The oracle: B3 computes B1 on M_q * col_scale (the scale folds onto
    columns, an output axis of Z @ M, so folding before or after the
    product is the same function)."""
    Z, M_q, col_scale, V, c, b, gamma, msq = (
        torch.from_numpy(a) for a in _inputs(40, 3, 37, seed=1)
    )
    M = M_q.to(torch.float32) * col_scale[:, None, :]
    got = qf.quadform_heads_q8_torch(Z, M_q, col_scale, V, c, b, gamma, msq)
    want = qf.quadform_heads_torch(Z, M.contiguous(), V, c, b, gamma, msq)
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-5)
    assert torch.equal(got[2], want[2])


def test_q8_tuning_defaults():
    key = tuning.shape_key(d=780, k=10, n=32)
    for kernel in ("quadform_q8", "rff_score", "rff_score_q8"):
        assert tuning.lookup(kernel, key) == tuning.DEFAULTS[kernel]
    assert tuning.lookup("quadform_q8").block_n in qf.BLOCK_N


# --------------------------------------- what kernel B3's body rests on
# Numpy copies of ``csrc/ptx.cuh``'s ``split_tf32`` and ``s8_at`` and of the
# index arithmetic of ``csrc/quadform.cu``'s int8 stage product and fold:
# the card is the only place the body runs, so the facts it is built on
# are pinned here.

TF32_BITS = np.uint32(0xFFFFE000)  # sign, exponent and 10 mantissa bits


def _split_tf32(x):
    """ptx::split_tf32: (hi, lo) bit patterns of f32 ``x``."""
    x = np.asarray(x, np.float32)
    hi = (x.view(np.uint32) + np.uint32(0x1000)) & TF32_BITS
    lo = (x - hi.view(np.float32)).view(np.uint32) + np.uint32(0x1000)
    return hi, lo


def _byte_perm(x, y, sel):
    """CUDA's __byte_perm: byte i of the result is byte (sel >> 4i) & 7 of
    the eight bytes of (y:x)."""
    src = (np.uint64(y) << np.uint64(32)) | np.uint64(x)
    out = 0
    for i in range(4):
        b = (int(src) >> (8 * ((sel >> (4 * i)) & 7))) & 0xFF
        out |= b << (8 * i)
    return np.uint32(out)


def _s8_at(x, sel):
    """ptx::s8_at: byte ``sel & 3`` of x = w ^ 0x80808080 as a float."""
    bits = np.array([_byte_perm(x, 0x4B, sel)], np.uint32)
    return bits.view(np.float32)[0] - np.float32(8388736.0)


def test_split_tf32_keeps_every_int8_value_whole_in_hi():
    """An int8 value is exact in TF32: split_tf32 gives it back as hi, and
    lo has no TF32 bits, so Z_hi M_lo is zero and B3 drops that MMA."""
    values = np.arange(-128, 128, dtype=np.float32)
    hi, lo = _split_tf32(values)
    np.testing.assert_array_equal(hi.view(np.float32), values)
    assert not (lo & TF32_BITS).any()
    assert ((values.view(np.uint32) & ~TF32_BITS) == 0).all()


def test_s8_at_upcasts_every_byte_exactly():
    """Every byte value in each of the four positions of a word."""
    for w in range(256):
        for pos in range(4):
            word = np.uint32(w << (8 * pos)) ^ np.uint32(0x80808080)
            got = _s8_at(word, 0x4550 + pos)
            assert got == np.int8(np.uint8(w)), (w, pos, got)


def test_int8_stage_product_and_fold_place_every_column():
    """One warp's 32 x 64 tile as quadform.cu's int8 body computes it: lane
    (g, t) loads its A values at contraction columns 2t, 2t + 1 of each
    k-step and its B bytes M[2t (+1)][8g .. 8g + 7], one byte a fragment
    tile; the m16n8k8 products land in acc[i][j][2h + u], which the fold
    reads as row 16i + 8h + g, column 8 (2t + u) + j. The sum of those
    products must be Z M at that place, for every element."""
    rng = np.random.default_rng(0)
    Z = rng.standard_normal((32, 64))
    M = rng.integers(-127, 128, (64, 64)).astype(np.float64)
    acc = np.zeros((8, 4, 2, 8, 4))  # (g, t, i, j, e)
    for kk in range(8):
        for i in range(2):
            for j in range(8):
                A, B = np.zeros((16, 8)), np.zeros((8, 8))
                for g in range(8):
                    for t in range(4):
                        rz, cz = 16 * i + g, 8 * kk + 2 * t
                        A[g, t], A[g + 8, t] = Z[rz, cz], Z[rz + 8, cz]
                        A[g, t + 4], A[g + 8, t + 4] = Z[rz, cz + 1], Z[rz + 8, cz + 1]
                        B[t, g] = M[8 * kk + 2 * t, 8 * g + j]
                        B[t + 4, g] = M[8 * kk + 2 * t + 1, 8 * g + j]
                D = A @ B
                for g in range(8):
                    for t in range(4):
                        acc[g, t, i, j] += (
                            D[g, 2 * t], D[g, 2 * t + 1], D[g + 8, 2 * t], D[g + 8, 2 * t + 1]
                        )
    want, seen = Z @ M, np.zeros((32, 64), int)
    for g in range(8):
        for t in range(4):
            for i in range(2):
                for h in range(2):
                    for u in range(2):
                        for j in range(8):
                            r, c = 16 * i + 8 * h + g, 16 * t + 8 * u + j
                            np.testing.assert_allclose(acc[g, t, i, j, 2 * h + u], want[r, c])
                            seen[r, c] += 1
    assert (seen == 1).all()


def _int8_artifact():
    from repro_torch import convert
    from repro_torch.core import families

    rng = np.random.default_rng(3)
    X = (rng.standard_normal((200, 37)) * 0.3).astype(np.float32)
    ay = rng.standard_normal((3, 200)).astype(np.float32)
    b = rng.standard_normal(3).astype(np.float32)
    svm = convert.svm_from_numpy(X, ay, b, 0.05, device="cpu")
    art = families.maclaurin.compile(svm, dtype="int8", holdout_n=16)
    Z = torch.from_numpy((rng.standard_normal((50, 37)) * 0.3).astype(np.float32))
    return families, art, Z


def test_int8_scales_expand_once_per_artifact(monkeypatch):
    """maclaurin.score derives the per-column scales and the dequantized v
    of an int8 artifact on its first call only; the scores are the bits of
    the per-call expansion, and the artifact's bytes do not change."""
    families, art, Z = _int8_artifact()
    quantize = families.quantize
    digest = art.digest()
    a = art.arrays
    col = quantize.expand_group_scales(a["M_scale"], art.d, int(art.meta["group_size"]))
    v = a["v"].to(torch.float32) * a["v_scale"][:, None]
    s0, _, v0 = backend.quadform_heads_q8(
        Z, a["M"], col, v, a["c"], a["b"], a["gamma"], a["msq"]
    )
    expand = quantize.expand_group_scales
    calls = []
    monkeypatch.setattr(
        quantize, "expand_group_scales", lambda *x, **k: calls.append(1) or expand(*x, **k)
    )
    for _ in range(3):
        scores, valid = families.maclaurin.score(art, Z)
        assert torch.equal(scores, s0) and torch.equal(valid, v0.all(-1))
    assert len(calls) == 1
    assert families.poly2.score is families.maclaurin.score
    assert art.digest() == digest and sorted(art.arrays) == sorted(a)
    # A new artifact (even one sharing the arrays) expands once of its own.
    other = art.with_meta(note="copy")
    families.maclaurin.score(other, Z)
    families.maclaurin.score(other, Z)
    assert len(calls) == 2


def test_int8_scale_cache_follows_the_stored_arrays():
    """Replacing a stored array of the artifact derives the operands anew."""
    families, art, Z = _int8_artifact()
    first = families.maclaurin.q8_operands(art)
    assert families.maclaurin.q8_operands(art)[0] is first[0]
    art.arrays["v_scale"] = art.arrays["v_scale"] * 2
    col, v = families.maclaurin.q8_operands(art)
    assert col is not first[0]
    torch.testing.assert_close(v, first[1] * 2, rtol=0, atol=0)
