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
