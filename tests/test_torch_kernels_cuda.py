"""Kernels B1 and B2 on the card against their plain PyTorch twins.

Marked ``cuda``; each test skips inside its body where no card is present,
so every worker collects the same tests. On a card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import convert  # noqa: E402
from repro_torch.core import families  # noqa: E402
from repro_torch.kernels.common import TileConfig  # noqa: E402
from repro_torch.kernels.quadform import kernel as qf  # noqa: E402
from repro_torch.kernels.rbf_pred import kernel as rp  # noqa: E402
from repro_torch.serve import SVMEngine  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _heads(n, k, d, seed, dev):
    rng = np.random.default_rng(seed)
    Z = (rng.random((n, d)) * (rng.random((n, d)) < 0.3)).astype(np.float32)
    Z[::7] *= 30.0
    M = (rng.standard_normal((k, d, d)) * 1e-2).astype(np.float32)
    M = (M + M.transpose(0, 2, 1)) / 2
    V = (rng.standard_normal((k, d)) * 0.1).astype(np.float32)
    c, b = rng.standard_normal((2, k)).astype(np.float32)
    gamma = rng.uniform(0.005, 0.02, k).astype(np.float32)
    msq = np.full(k, 0.3 * d, np.float32)
    arrays = (Z, M, V, c, b, gamma, msq)
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]


@pytest.mark.parametrize("block_n", [32, 64, 128])
@pytest.mark.parametrize(
    "n,k,d", [(1, 1, 3), (5, 3, 22), (100, 1, 123), (257, 10, 780)]
)
def test_quadform_kernel_matches_plain(cuda, n, k, d, block_n):
    args = _heads(n, k, d, seed=n + d, dev=cuda)
    before = qf.KERNEL.launches
    s, zsq, v = qf.quadform_heads_cuda(*args, config=TileConfig(block_n=block_n))
    assert qf.KERNEL.launches == before + 1
    s0, zsq0, v0 = qf.quadform_heads_torch(*args)
    torch.cuda.synchronize()
    assert float((s - s0).abs().max()) <= 1e-4 * float(s0.abs().max()) + 1e-5
    assert float(((zsq - zsq0).abs() / zsq0.clamp(min=1e-30)).max()) <= 1e-5
    assert torch.equal(v, v0)
    again = qf.quadform_heads_cuda(*args, config=TileConfig(block_n=block_n))
    assert torch.equal(again[0], s)  # no atomics: the same bits every run


@pytest.mark.parametrize("splits", [None, 1, 5])
@pytest.mark.parametrize(
    "n,m,k,d",
    [(7, 13, 1, 3), (64, 128, 1, 22), (33, 257, 17, 100), (200, 4096, 10, 780)],
)
def test_rbf_kernel_matches_plain(cuda, n, m, k, d, splits):
    rng = np.random.default_rng(n * m)
    Z, X = (
        torch.from_numpy(rng.random(s).astype(np.float32)).to(cuda)
        for s in ((n, d), (m, d))
    )
    A = torch.from_numpy(rng.standard_normal((k, m)).astype(np.float32)).to(cuda)
    b = torch.from_numpy(rng.standard_normal(k).astype(np.float32)).to(cuda)
    before = rp.KERNEL.launches
    out = rp.rbf_scores_cuda(Z, X, A, 2.0 / d, b, config=TileConfig(splits=splits))
    assert rp.KERNEL.launches == before + 1
    out0 = rp.rbf_scores_torch(Z, X, A, 2.0 / d, b)
    torch.cuda.synchronize()
    assert float((out - out0).abs().max()) <= 1e-4 * float(out0.abs().max()) + 1e-6
    one = rp.rbf_scores_cuda(Z, X, A[0].contiguous(), 2.0 / d, 0.5)
    assert one.shape == (n,)
    torch.testing.assert_close(one, rp.rbf_scores_torch(Z, X, A[0], 2.0 / d, 0.5))


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    args = _heads(8, 2, 16, seed=0, dev=cuda)
    with pytest.raises(TypeError):
        qf.quadform_heads_cuda(args[0].double(), *args[1:])
    with pytest.raises(ValueError, match="contiguous"):
        qf.quadform_heads_cuda(args[0].T.contiguous().T, *args[1:])
    with pytest.raises(ValueError, match="shape"):
        qf.quadform_heads_cuda(args[0][:, :8].contiguous(), *args[1:])
    wide = _heads(300, 2, 16, seed=1, dev=cuda)  # 300 rows keep block_n=256
    with pytest.raises(ValueError, match="block_n"):
        qf.quadform_heads_cuda(*wide, config=TileConfig(block_n=256))


def test_engine_on_the_card_matches_the_cpu(cuda):
    rng = np.random.default_rng(1)
    X = (rng.standard_normal((300, 24)) * 0.3).astype(np.float32)
    ay = rng.standard_normal((3, 300)).astype(np.float32)
    b = rng.standard_normal(3).astype(np.float32)
    engines = []
    for dev in ("cpu", cuda):
        svm = convert.svm_from_numpy(X, ay, b, 0.02, device=dev)
        engines.append(SVMEngine(families.maclaurin.compile(svm), svm, device=dev))
    Z = (rng.standard_normal((77, 24)) * 0.3).astype(np.float32)
    Z[::6] *= 80.0
    cpu, gpu = (e.submit(Z) for e in engines)
    np.testing.assert_allclose(gpu.values, cpu.values, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(gpu.valid, cpu.valid)
    np.testing.assert_array_equal(gpu.labels, cpu.labels)
    assert engines[1].stats.fallback_instances == int((~cpu.valid).sum()) > 0
    ex_cpu, ex_gpu = (e.submit_exact(Z) for e in engines)
    np.testing.assert_allclose(ex_gpu.values, ex_cpu.values, rtol=1e-4, atol=1e-4)
