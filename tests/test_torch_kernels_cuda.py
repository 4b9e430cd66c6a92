"""Kernels B1-B9 on the card against their plain PyTorch twins.

Marked ``cuda``; each test skips inside its body where no card is present,
so every worker collects the same tests. On a card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import convert  # noqa: E402
from repro_torch.core import families  # noqa: E402
from repro_torch.kernels import flash_attn, fwht, maclaurin_attn  # noqa: E402
from repro_torch.kernels.common import TileConfig  # noqa: E402
from repro_torch.kernels.quadform import kernel as qf  # noqa: E402
from repro_torch.kernels.rbf_pred import kernel as rp  # noqa: E402
from repro_torch.kernels.rff_score import kernel as rk  # noqa: E402
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


@pytest.mark.parametrize("k", [1, 10])
@pytest.mark.parametrize("d", [20, 780])
@pytest.mark.parametrize("n", [1, 17, 130])
def test_quadform_kernel_at_ragged_shapes_repeats_bitwise(cuda, n, d, k):
    """B1's tensor-core body at ragged rows and columns, on a Hessian that is
    not symmetric: B1's rule (1e-4 of max|twin| + 1e-5), equal masks and
    the same bits on a second launch."""
    args = _heads(n, k, d, seed=n * d + k, dev=cuda)
    rng = np.random.default_rng(n + k)
    skew = torch.from_numpy((rng.standard_normal((k, d, d)) * 1e-2).astype(np.float32))
    args[1] = (args[1] + skew.triu(1).to(cuda)).contiguous()
    before = qf.KERNEL.launches
    s, zsq, v = qf.quadform_heads_cuda(*args)
    assert qf.KERNEL.launches == before + 1
    s0, zsq0, v0 = qf.quadform_heads_torch(*args)
    torch.cuda.synchronize()
    assert s.shape == (n, k) and zsq.shape == (n,) and v.shape == (n, k)
    assert float((s - s0).abs().max()) <= 1e-4 * float(s0.abs().max()) + 1e-5
    assert float(((zsq - zsq0).abs() / zsq0.clamp(min=1e-30)).max()) <= 1e-5
    assert torch.equal(v, v0)
    again = qf.quadform_heads_cuda(*args)
    assert all(torch.equal(a, b) for a, b in zip(again, (s, zsq, v)))


def _rbf_tol(Z, X, A, gamma, b):
    """(twin scores on Z, B2's rule): 4x the f32 twin's distance from
    float64 on the same outputs, + 1e-6 (the sums over SVs cancel, so no
    tolerance relative to the output holds)."""
    out0 = rp.rbf_scores_torch(Z, X, A, gamma, b)
    out64 = rp.rbf_scores_torch(Z.double(), X.double(), A.double(), gamma, b.double())
    return out0, 4.0 * float((out0.double() - out64).abs().max()) + 1e-6


@pytest.mark.parametrize("k", [1, 10, 17])
@pytest.mark.parametrize("m", [1, 100, 16384])
@pytest.mark.parametrize("n", [1, 37, 256])
def test_rbf_kernel_at_ragged_shapes_repeats_bitwise(cuda, n, m, k):
    """B2's tensor-core body at the mnist width: ragged rows, SV tiles and
    head groups (17 heads take two), held by B2's rule, the same bits on a
    second launch."""
    d = 780
    rng = np.random.default_rng(n + m + k)
    Z, X = (torch.from_numpy(rng.random(s).astype(np.float32)).to(cuda) for s in ((n, d), (m, d)))
    A = rng.standard_normal((k, m))
    A = torch.from_numpy((A - A.mean(1, keepdims=True)).astype(np.float32)).to(cuda)
    b = torch.from_numpy(rng.standard_normal(k).astype(np.float32)).to(cuda)
    before = rp.KERNEL.launches
    out = rp.rbf_scores_cuda(Z, X, A, 2.0 / d, b)
    assert rp.KERNEL.launches == before + 1
    out0, tol = _rbf_tol(Z, X, A, 2.0 / d, b)
    torch.cuda.synchronize()
    assert out.shape == (n, k)
    assert float((out - out0).abs().max()) <= tol
    assert torch.equal(rp.rbf_scores_cuda(Z, X, A, 2.0 / d, b), out)


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
    # The 1-D alpha_y path is head 0 of the 2-D one, bit for bit (each head's
    # sums run on their own), with its scalar bias added last; and it is no
    # farther from float64 than its fp32 twin, + one f32 step of the largest
    # output. (At (200, 4096) the twin's own distance from float64 exceeds
    # assert_close's 1e-5 + 1.3e-6|x| on an H100, so that yardstick held only
    # a kernel that rounds as the twin rounds, not one nearer to float64.)
    one = rp.rbf_scores_cuda(Z, X, A[0].contiguous(), 2.0 / d, 0.5)
    assert one.shape == (n,)
    head0 = rp.rbf_scores_cuda(Z, X, A, 2.0 / d, torch.zeros_like(b))[:, 0]
    assert torch.equal(one, head0 + 0.5)
    one0 = rp.rbf_scores_torch(Z, X, A[0], 2.0 / d, 0.5)
    one64 = rp.rbf_scores_torch(Z.double(), X.double(), A[0].double(), 2.0 / d, 0.5)
    step = float(np.spacing(np.float32(one64.abs().max().item())))
    dist = [float((x.double() - one64).abs().max()) for x in (one, one0)]
    assert dist[0] <= dist[1] + step


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


def _q8_heads(n, k, d, seed, dev, symmetric=True):
    """B3's operands: B1's, with the Hessian quantized per column group
    (with ``symmetric`` False, after adding a strictly upper triangle)."""
    Z, M, V, c, b, gamma, msq = _heads(n, k, d, seed, dev)
    if not symmetric:
        rng = np.random.default_rng(n + k)
        skew = torch.from_numpy((rng.standard_normal((k, d, d)) * 1e-2).astype(np.float32))
        M = M + skew.triu(1).to(dev)
    M_q, scale = families.quantize.quantize_col_groups(M.cpu().numpy())
    col_scale = families.quantize.expand_group_scales(torch.from_numpy(scale), d)
    return Z, torch.from_numpy(M_q).to(dev), col_scale.to(dev), V, c, b, gamma, msq


@pytest.mark.parametrize("block_n", [32, 64, 128])
@pytest.mark.parametrize(
    "n,k,d",
    [(1, 1, 3), (5, 3, 22), (100, 1, 123), (64, 2, 64), (257, 10, 780), (1024, 10, 780)],
)
def test_quadform_q8_kernel_matches_plain(cuda, n, k, d, block_n):
    """d = 64, 780: four-byte Hessian loads; 3, 22, 123: the byte path."""
    args = _q8_heads(n, k, d, seed=n + d, dev=cuda)
    before = qf.KERNEL_Q8.launches
    s, zsq, v = qf.quadform_heads_q8_cuda(*args, config=TileConfig(block_n=block_n))
    assert qf.KERNEL_Q8.launches == before + 1
    s0, zsq0, v0 = qf.quadform_heads_q8_torch(*args)
    torch.cuda.synchronize()
    assert float((s - s0).abs().max()) <= 1e-4 * float(s0.abs().max()) + 1e-5
    assert float(((zsq - zsq0).abs() / zsq0.clamp(min=1e-30)).max()) <= 1e-5
    assert torch.equal(v, v0)
    again = qf.quadform_heads_q8_cuda(*args, config=TileConfig(block_n=block_n))
    assert torch.equal(again[0], s)


@pytest.mark.parametrize("k", [1, 10])
@pytest.mark.parametrize("d", [20, 780])
@pytest.mark.parametrize("n", [1, 17, 130])
def test_quadform_q8_kernel_at_ragged_shapes_repeats_bitwise(cuda, n, d, k):
    """B3's tensor-core body at ragged rows and columns, on a Hessian that is
    not symmetric: B1's rule (1e-4 of max|twin| + 1e-5), equal masks and
    the same bits on a second launch."""
    args = _q8_heads(n, k, d, seed=n * d + k, dev=cuda, symmetric=False)
    before = qf.KERNEL_Q8.launches
    s, zsq, v = qf.quadform_heads_q8_cuda(*args)
    assert qf.KERNEL_Q8.launches == before + 1
    s0, zsq0, v0 = qf.quadform_heads_q8_torch(*args)
    torch.cuda.synchronize()
    assert s.shape == (n, k) and zsq.shape == (n,) and v.shape == (n, k)
    assert float((s - s0).abs().max()) <= 1e-4 * float(s0.abs().max()) + 1e-5
    assert float(((zsq - zsq0).abs() / zsq0.clamp(min=1e-30)).max()) <= 1e-5
    assert torch.equal(v, v0)
    again = qf.quadform_heads_q8_cuda(*args)
    assert all(torch.equal(a, b) for a, b in zip(again, (s, zsq, v)))


@pytest.mark.parametrize("block_n", [32, 64, 128])
@pytest.mark.parametrize("n,k,d", [(1, 1, 3), (130, 10, 780), (1024, 10, 780)])
def test_quadform_q8_kernel_is_as_near_float64_as_its_twin(cuda, n, k, d, block_n):
    """B2's rule on B3's scores: at most 4x the f32 twin's distance from the
    twin in float64 on the same int8 codes, + 1e-6."""
    args = _q8_heads(n, k, d, seed=3 * n + d, dev=cuda, symmetric=False)
    s = qf.quadform_heads_q8_cuda(*args, config=TileConfig(block_n=block_n))[0]
    s0 = qf.quadform_heads_q8_torch(*args)[0]
    d64 = [a if a.dtype == torch.int8 else a.double() for a in args]
    s64 = qf.quadform_heads_q8_torch(*d64)[0]
    torch.cuda.synchronize()
    twin = float((s0.double() - s64).abs().max())
    assert float((s.double() - s64).abs().max()) <= 4.0 * twin + 1e-6


def _rff(n, d, f, k, seed, dev, q8, spread=1.0):
    """B4's or B5's operands; ``spread`` scales W, and so the cos arguments."""
    rng = np.random.default_rng(seed)
    Z = rng.random((n, d)).astype(np.float32)
    W = rng.normal(0.0, spread * np.sqrt(2.0 / d), size=(f, d)).astype(np.float32)
    phase = rng.uniform(0.0, 2.0 * np.pi, size=f).astype(np.float32)
    wt = (rng.standard_normal((k, f)) * 2.0 / f).astype(np.float32)
    bias = rng.standard_normal(k).astype(np.float32)
    if q8:
        W_q, w_scale = families.quantize.quantize_rows(W)
        wt_q, wt_scale = families.quantize.quantize_rows(wt)
        arrays = (Z, W_q, w_scale, phase, wt_q, wt_scale, bias)
    else:
        arrays = (Z, W, phase, wt, bias)
    return [torch.from_numpy(a).to(dev) for a in arrays]


def _rff_tol(args, q8):
    """4x the f32 twin's distance from a float64 evaluation, + 1e-6."""
    twin = rk.rff_score_q8_torch if q8 else rk.rff_score_torch
    d64 = [a if a.dtype == torch.int8 else a.double() for a in args]
    out0, out64 = twin(*args), twin(*d64)
    return out0, 4.0 * float((out0.double() - out64).abs().max()) + 1e-6


@pytest.mark.parametrize("q8", [False, True])
@pytest.mark.parametrize("splits", [None, 1, 3])
@pytest.mark.parametrize(
    "n,d,f,k",
    [
        (1, 3, 10, 1),
        (7, 22, 100, 3),
        (65, 40, 1000, 17),
        (300, 780, 1024, 10),
        (1024, 780, 4096, 10),  # the main path's shape
        (100, 64, 500, 33),  # 33 heads, all read out of one block's cos tiles
        (517, 780, 1000, 10),  # n a multiple of no block, F of no tile
    ],
)
def test_rff_kernels_match_plain_and_repeat_bitwise(cuda, n, d, f, k, splits, q8):
    args = _rff(n, d, f, k, seed=n + f, dev=cuda, q8=q8)
    kernel = rk.KERNEL_Q8 if q8 else rk.KERNEL
    fn = rk.rff_score_q8_cuda if q8 else rk.rff_score_cuda
    before = kernel.launches
    out = fn(*args, config=TileConfig(splits=splits))
    assert kernel.launches == before + 1
    out0, tol = _rff_tol(args, q8)
    torch.cuda.synchronize()
    assert out.shape == (n, k)
    assert float((out - out0).abs().max()) <= tol
    again = fn(*args, config=TileConfig(splits=splits))
    assert torch.equal(again, out)  # no atomics: the same bits every run


@pytest.mark.parametrize("q8", [False, True])
@pytest.mark.parametrize("block_n", [32, 64, 128])
def test_rff_kernels_hold_the_twins_when_the_cos_arguments_span_tens_of_radians(
    cuda, block_n, q8
):
    """As fourier's W ~ N(0, 2 gamma) puts them on real rows: the projection
    and the cos's reduction are held at every compiled block."""
    args = _rff(300, 780, 1024, 10, seed=5, dev=cuda, q8=q8, spread=12.0)
    W = args[1].float() * args[2][:, None] if q8 else args[1]
    assert float((args[0] @ W.T).abs().max()) > 20.0
    fn = rk.rff_score_q8_cuda if q8 else rk.rff_score_cuda
    out = fn(*args, config=TileConfig(block_n=block_n))
    out0, tol = _rff_tol(args, q8)
    torch.cuda.synchronize()
    assert float((out - out0).abs().max()) <= tol
    assert torch.equal(fn(*args, config=TileConfig(block_n=block_n)), out)


def test_rff_cos_is_within_two_ulp_over_the_float_range(cuda):
    """The kernels' own cos (no stack: cosf's large-argument reduction redone
    in registers) against float64, through B5 at d = 1: Z = 1, W = 1 with
    row scales x, an identity readout, so out[k] = cos(x_k) exactly."""
    xs = np.concatenate(
        [
            np.linspace(-60.0, 60.0, 1001),
            10.0 ** np.linspace(-6.0, 38.0, 600),
            -(10.0 ** np.linspace(-3.0, 30.0, 300)),
            [105614.99, 105615.0, 105615.01, 3.4028235e38],
        ]
    ).astype(np.float32)
    f = xs.size
    Z = torch.ones((1, 1), device=cuda)
    W_q = torch.ones((f, 1), dtype=torch.int8, device=cuda)
    eye = torch.eye(f, dtype=torch.int8, device=cuda)
    zero, one = torch.zeros(f, device=cuda), torch.ones(f, device=cuda)
    x = torch.from_numpy(xs).to(cuda)
    out = rk.rff_score_q8_cuda(Z, W_q, x, zero, eye, one, zero)
    got = out[0].double().cpu().numpy()
    ref = np.cos(xs.astype(np.float64))
    ulp = np.spacing(np.abs(ref).astype(np.float32)).astype(np.float64)
    assert float((np.abs(got - ref) / ulp).max()) <= 2.0


def test_new_wrappers_reject_what_the_kernels_do_not_take(cuda):
    q = _q8_heads(8, 2, 16, seed=0, dev=cuda)
    with pytest.raises(TypeError, match="int8"):
        qf.quadform_heads_q8_cuda(q[0], q[1].float(), *q[2:])
    with pytest.raises(ValueError, match="shape"):
        qf.quadform_heads_q8_cuda(*q[:2], q[2][:, :8].contiguous(), *q[3:])
    r = _rff(8, 16, 70, 2, seed=0, dev=cuda, q8=False)
    with pytest.raises(TypeError):
        rk.rff_score_cuda(r[0].double(), *r[1:])
    with pytest.raises(ValueError, match="shape"):
        rk.rff_score_cuda(r[0], r[1][:, :8].contiguous(), *r[2:])
    with pytest.raises(ValueError, match="contiguous"):
        rk.rff_score_cuda(r[0], r[1], r[2], r[3].T.contiguous().T, r[4])
    with pytest.raises(ValueError, match="block_n"):
        wide = _rff(200, 16, 70, 2, seed=1, dev=cuda, q8=False)
        rk.rff_score_cuda(*wide, config=TileConfig(block_n=96))
    r8 = _rff(8, 16, 70, 2, seed=0, dev=cuda, q8=True)
    with pytest.raises(TypeError, match="int8"):
        rk.rff_score_q8_cuda(r8[0], r8[1].float(), *r8[2:])
    with pytest.raises(ValueError, match="shape"):
        rk.rff_score_q8_cuda(*r8[:5], r8[5][:1].contiguous(), r8[6])


@pytest.mark.parametrize("family", ["maclaurin", "poly2", "fourier", "fastfood"])
@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_every_family_on_the_card_matches_the_cpu(cuda, family, dtype):
    rng = np.random.default_rng(2)
    X = (rng.standard_normal((300, 24)) * 0.3).astype(np.float32)
    ay = rng.standard_normal((3, 300)).astype(np.float32)
    ay -= ay.mean(1, keepdims=True)
    b = rng.standard_normal(3).astype(np.float32)
    svm_cpu = convert.svm_from_numpy(X, ay, b, 0.02, device="cpu")
    opts = {"num_features": 500}
    if family == "fastfood":  # fourier's structured projection
        family, opts["structured"] = "fourier", True
    art = families.get_family(family).compile(svm_cpu, dtype=dtype, **opts)
    Z = (rng.standard_normal((77, 24)) * 0.3).astype(np.float32)
    Z[::6] *= 80.0
    kind = art.meta.get("projection", "quadform")
    kernel = {
        ("quadform", "float32"): qf.KERNEL,
        ("quadform", "int8"): qf.KERNEL_Q8,
        ("dense", "float32"): rk.KERNEL,
        ("dense", "int8"): rk.KERNEL_Q8,
        ("fastfood", "float32"): fwht.KERNEL,
        ("fastfood", "int8"): fwht.KERNEL_Q8,
    }[(kind, dtype)]
    results = []
    for dev in ("cpu", cuda):
        svm = convert.svm_from_numpy(X, ay, b, 0.02, device=dev)
        before = kernel.launches
        results.append(SVMEngine(art.to(dev), svm, device=dev).submit(Z))
    assert kernel.launches == before + 1  # the card's submit went through it
    cpu, gpu = results
    np.testing.assert_allclose(gpu.values, cpu.values, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(gpu.valid, cpu.valid)
    assert (gpu.labels == cpu.labels).mean() >= 0.98  # near-ties may split


def _fastfood(n, d, stacks, k, seed, dev, q8):
    """B6's or B7's operands at d' = next pow2 >= d: the int8 ones as the
    artifact stores them (int16 perm, f16 phase)."""
    rng = np.random.default_rng(seed)
    dd = 1 << max(1, (d - 1).bit_length())
    f = stacks * dd
    Z = rng.random((n, d)).astype(np.float32)
    B = rng.choice(np.float32([-1.0, 1.0]), (stacks, dd))
    G = rng.standard_normal((stacks, dd)).astype(np.float32)
    perm = np.stack([rng.permutation(dd) for _ in range(stacks)]).astype(np.int32)
    chi = np.sqrt(rng.chisquare(dd, (stacks, dd)))
    S = (np.sqrt(2.0 / d) * chi / np.sqrt(dd * dd)).astype(np.float32)
    phase = rng.uniform(0.0, 2.0 * np.pi, f).astype(np.float32)
    wt = (rng.standard_normal((k, f)) * 2.0 / f).astype(np.float32)
    bias = rng.standard_normal(k).astype(np.float32)
    if q8:
        g_q, g_s = families.quantize.quantize_rows(G)
        s_q, s_s = families.quantize.quantize_rows(S)
        wt_q, wt_s = families.quantize.quantize_rows(wt)
        arrays = (
            Z,
            families.quantize.quantize_signs(B),
            g_q,
            perm.astype(np.int16),
            s_q,
            (g_s.astype(np.float64) * s_s).astype(np.float32),
            phase.astype(np.float16),
            wt_q,
            wt_s,
            bias,
        )
    else:
        arrays = (Z, B, G, perm, S, phase, wt, bias)
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]


def _fastfood_tol(args, q8):
    """4x the twin's distance from a float64 evaluation, + 1e-6 (B4's rule:
    the readout sums cancel, so no output-relative tolerance holds)."""
    twin = fwht.fastfood_score_q8_torch if q8 else fwht.fastfood_score_torch
    d64 = [a if not a.is_floating_point() or q8 else a.double() for a in args]
    d64[0] = args[0].double()  # the twin computes in Z's dtype
    out0, out64 = twin(*args), twin(*d64)
    return out0, 4.0 * float((out0.double() - out64).abs().max()) + 1e-6


@pytest.mark.parametrize("q8", [False, True])
@pytest.mark.parametrize("block_n", [None, 1, 32])
@pytest.mark.parametrize(
    "n,d,stacks,k",
    [
        (1, 3, 1, 1),
        (7, 20, 3, 3),
        (33, 100, 2, 17),
        (300, 780, 4, 10),
        (65, 1500, 2, 10),
    ],
)
def test_fastfood_kernels_match_plain_and_repeat_bitwise(
    cuda, n, d, stacks, k, block_n, q8
):
    """d' = 4 and 32 put several rows in a warp, 128 one row a warp with
    K > 16 in two head groups, 1024 the mnist width, 2048 the widest d'."""
    args = _fastfood(n, d, stacks, k, seed=n + d, dev=cuda, q8=q8)
    kernel = fwht.KERNEL_Q8 if q8 else fwht.KERNEL
    fn = fwht.fastfood_score_q8_cuda if q8 else fwht.fastfood_score_cuda
    config = TileConfig(block_n=block_n) if block_n else None
    before = kernel.launches
    out = fn(*args, config=config)
    assert kernel.launches == before + 1
    out0, tol = _fastfood_tol(args, q8)
    torch.cuda.synchronize()
    assert out.shape == (n, k)
    assert float((out - out0).abs().max()) <= tol
    again = fn(*args, config=config)
    assert torch.equal(again, out)  # no atomics: the same bits every run


def test_fastfood_wrappers_reject_what_the_kernels_do_not_take(cuda):
    f = _fastfood(4, 20, 2, 3, seed=0, dev=cuda, q8=False)
    with pytest.raises(TypeError, match="int32"):
        fwht.fastfood_score_cuda(*f[:3], f[3].to(torch.int64), *f[4:])
    with pytest.raises(ValueError, match="columns"):
        wide = torch.zeros((4, 40), device=cuda)
        fwht.fastfood_score_cuda(wide, *f[1:])
    big = _fastfood(2, 3000, 1, 1, seed=1, dev=cuda, q8=False)
    with pytest.raises(ValueError, match="2048"):
        fwht.fastfood_score_cuda(*big)
    q = _fastfood(4, 20, 2, 3, seed=0, dev=cuda, q8=True)
    with pytest.raises(TypeError, match="float16"):
        fwht.fastfood_score_q8_cuda(*q[:6], q[6].float(), *q[7:])
    with pytest.raises(TypeError, match="int16"):
        fwht.fastfood_score_q8_cuda(*q[:3], q[3].int(), *q[4:])
    with pytest.raises(ValueError, match="shape"):
        fwht.fastfood_score_q8_cuda(*q[:5], q[5][:1].contiguous(), *q[6:])


# ------------------------------------------------- B8, B9: the LM kernels
#
# The rule of B2 and B4-B7: the kernel may be at most 4x as far from its
# plain twin as that twin is from the float64 answer (the quadratic-form
# oracle in float64), + 1e-6. B9 in bf16 is also held element by element
# against the twin's f32 value before rounding (the twin on the same inputs
# widened to f32, as the kernel widens them): the kernel rounds a value
# within the f32 rule's tolerance of it, so each element may differ by half
# a bf16 step of itself (2^-8 |x|) plus that tolerance.


def _attn_inputs(bh, t, d, dv, seed, dev, scale=1.0, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    q, k = ((rng.standard_normal((bh, t, d)) * scale).astype(np.float32) for _ in range(2))
    v = rng.standard_normal((bh, t, dv)).astype(np.float32)
    return [torch.from_numpy(a).to(dev).to(dtype) for a in (q, k, v)]


def _within_rule(out, twin, exact):
    err = float((out.double() - twin.double()).abs().max())
    twin_err = float((twin.double() - exact).abs().max())
    assert err <= 4.0 * twin_err + 1e-6, (err, twin_err)
    return err


def _within_bf16_rounding(out, q, k, v, exact, **kw):
    twin32 = flash_attn.flash_attention_torch(q.float(), k.float(), v.float(), **kw).double()
    tol32 = 4.0 * float((twin32 - exact).abs().max()) + 1e-6
    over = (out.double() - twin32).abs() - (2.0**-8 * twin32.abs() + (1 + 2.0**-8) * tol32)
    assert float(over.max()) <= 0, float(over.max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "bh,t,d,dv",
    [
        (3, 1, 32, 32),
        (2, 100, 64, 64),
        (4, 257, 96, 96),
        (1, 130, 128, 128),
        (2, 77, 64, 24),
        (2, 300, 16, 16),
        (1, 640, 64, 128),
        (36, 256, 64, 64),
        (2, 100, 40, 72),  # d not a multiple of the bf16 k-step, zero-padded
        (1, 70, 13, 7),  # rows not whole 16-byte chunks: copied element by element
    ],
)
def test_flash_kernel_matches_plain_and_repeats_bitwise(cuda, bh, t, d, dv, dtype):
    q, k, v = _attn_inputs(bh, t, d, dv, seed=t + d, dev=cuda, dtype=dtype)
    before = flash_attn.KERNEL.launches
    out = flash_attn.flash_attention_cuda(q, k, v)
    assert flash_attn.KERNEL.launches == before + 1
    assert out.dtype == dtype and out.shape == (bh, t, dv)
    twin = flash_attn.flash_attention_torch(q, k, v)
    exact = flash_attn.softmax_attention_ref(q.double(), k.double(), v.double(), scale=d**-0.5)
    torch.cuda.synchronize()
    _within_rule(out, twin, exact)
    if dtype == torch.bfloat16:
        _within_bf16_rounding(out, q, k, v, exact)
    again = flash_attn.flash_attention_cuda(q, k, v)
    assert torch.equal(again, out)  # no atomics: the same bits every run


def test_flash_kernel_full_attention_and_large_logits(cuda):
    q, k, v = _attn_inputs(2, 128, 64, 64, seed=1, dev=cuda)
    out = flash_attn.flash_attention_cuda(q, k, v, causal=False)
    s = (q.double() @ k.double().transpose(1, 2)) / 8.0
    exact = torch.softmax(s, -1) @ v.double()
    twin = flash_attn.flash_attention_torch(q, k, v, causal=False)
    _within_rule(out, twin, exact)
    # T = 100 at the reference's default blocks (256, cut to T) pads no key,
    # so the kernel computes, as it does with a named block_k of 100
    q, k, v = (x[:, :100].contiguous() for x in (q, k, v))
    s = (q.double() @ k.double().transpose(1, 2)) / 8.0
    exact = torch.softmax(s, -1) @ v.double()
    twin = flash_attn.flash_attention_torch(q, k, v, causal=False)
    out = flash_attn.flash_attention_cuda(q, k, v, causal=False)
    _within_rule(out, twin, exact)
    named = flash_attn.flash_attention_cuda(q, k, v, causal=False, block_q=32, block_k=100)
    assert torch.equal(named, out)  # the blocks set the refusal only
    with pytest.raises(ValueError, match="explicit mask"):
        flash_attn.flash_attention_cuda(q, k, v, causal=False, block_k=64)
    big = [x * 30 for x in _attn_inputs(1, 64, 16, 16, seed=0, dev=cuda)]
    out = flash_attn.flash_attention_cuda(*big[:2], big[2] / 30)
    assert bool(torch.isfinite(out).all())


def _maclaurin_exact(q, k, v):
    """The float64 quadratic-form oracle, a few heads at a time (it holds
    every head's T x T weights)."""
    g = max(1, 2**28 // q.shape[1] ** 2)
    scale = q.shape[-1] ** -0.5
    parts = [
        maclaurin_attn.maclaurin_attention_ref(*(x[i : i + g].double() for x in (q, k, v)), scale=scale)
        for i in range(0, q.shape[0], g)
    ]
    return torch.cat(parts)


def _check_maclaurin(q, k, v, config, force_route):
    bh, t, _ = q.shape
    dv = v.shape[-1]
    before = maclaurin_attn.KERNEL.launches
    out = maclaurin_attn.maclaurin_attention_cuda(q, k, v, config=config, force_route=force_route)
    assert maclaurin_attn.KERNEL.launches == before + 1
    assert out.dtype == torch.float32 and out.shape == (bh, t, dv)
    twin = maclaurin_attn.maclaurin_attention_torch(q, k, v, config=config)
    torch.cuda.synchronize()
    _within_rule(out, twin, _maclaurin_exact(q, k, v))
    again = maclaurin_attn.maclaurin_attention_cuda(q, k, v, config=config, force_route=force_route)
    assert torch.equal(again, out)  # no atomics: the same bits every run
    return out


# B8's moments route (the chunked schedule) at every chunk; dv = 160 spans
# two column groups of the quadratic route.
B8_CASES = [
    (2, 1, 16, 16),
    (3, 200, 32, 48),
    (2, 300, 64, 64),
    (1, 257, 96, 96),
    (2, 160, 128, 128),
    (2, 128, 64, 24),
    (2, 4096, 16, 16),
    (1, 3000, 32, 20),
    (1, 200, 64, 160),
]


@pytest.mark.parametrize("chunk", [16, 64, 100, 256])
@pytest.mark.parametrize("bh,t,d,dv", B8_CASES)
def test_maclaurin_kernel_matches_plain_and_repeats_bitwise(cuda, bh, t, d, dv, chunk):
    q, k, v = _attn_inputs(bh, t, d, dv, seed=t + d, dev=cuda, scale=0.3)
    _check_maclaurin(q, k, v, TileConfig(chunk=chunk), "moments")


@pytest.mark.parametrize("bh,t,d,dv", B8_CASES + [(1, 2100, 96, 40), (3, 700, 128, 72)])
def test_maclaurin_quadratic_route_matches_plain_and_repeats_bitwise(cuda, bh, t, d, dv):
    q, k, v = _attn_inputs(bh, t, d, dv, seed=t + d, dev=cuda, scale=0.3)
    _check_maclaurin(q, k, v, TileConfig(chunk=64), "quadratic")


@pytest.mark.parametrize("route", ["moments", "quadratic"])
@pytest.mark.parametrize("bh,t,d,dv", [(2, 300, 80, 80), (3, 200, 19, 24)])
def test_maclaurin_kernel_pads_head_dims_it_is_not_compiled_for(cuda, bh, t, d, dv, route):
    """d = 80 runs at 96 and d = 19 at 32, zero-padded, at the scale of the
    original d: the twin's answer by B8's rule, by either route."""
    q, k, v = _attn_inputs(bh, t, d, dv, seed=t + d, dev=cuda, scale=0.3)
    _check_maclaurin(q, k, v, TileConfig(chunk=64), route)


@pytest.mark.parametrize(
    "bh,t,d,dv,want",
    [(2, 300, 64, 64, "quadratic"), (2, 4096, 16, 16, "quadratic"), (64, 8192, 16, 16, "moments")],
)
def test_maclaurin_kernel_takes_its_route(cuda, bh, t, d, dv, want):
    """Unforced, the kernel takes ``route``'s pick: the same bits as that
    route forced."""
    assert maclaurin_attn.route(bh, t, d, dv) == want
    q, k, v = _attn_inputs(bh, t, d, dv, seed=t + d, dev=cuda, scale=0.3)
    config = TileConfig(chunk=64)
    out = _check_maclaurin(q, k, v, config, None)
    forced = maclaurin_attn.maclaurin_attention_cuda(q, k, v, config=config, force_route=want)
    assert torch.equal(forced, out)


def test_attention_wrappers_reject_what_the_kernels_do_not_take(cuda):
    q, k, v = _attn_inputs(2, 64, 64, 64, seed=0, dev=cuda)
    out = flash_attn.flash_attention_cuda(q, k, v)
    for blocks in (dict(block_q=128), dict(block_q=16, block_k=16), dict(block_k=32)):
        # any named blocks run the one 64 x 64 tile: the same bits
        assert torch.equal(flash_attn.flash_attention_cuda(q, k, v, **blocks), out)
    with pytest.raises(TypeError):
        flash_attn.flash_attention_cuda(q.double(), k.double(), v.double())
    with pytest.raises(TypeError):
        flash_attn.flash_attention_cuda(q, k.to(torch.bfloat16), v)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attn.flash_attention_cuda(q.transpose(1, 2).contiguous().transpose(1, 2), k, v)
    wide = _attn_inputs(1, 16, 160, 16, seed=0, dev=cuda)
    with pytest.raises(ValueError, match="128"):
        flash_attn.flash_attention_cuda(*wide)
    with pytest.raises(ValueError, match="at most 128"):
        maclaurin_attn.maclaurin_attention_cuda(*wide)
    with pytest.raises(ValueError, match="route"):
        maclaurin_attn.maclaurin_attention_cuda(q, k, v, force_route="chunked")


# --------------------------------------------- head- and SV-sharded shapes

# (n, d, K): one shard of the extreme one-vs-rest model (4096 heads over
# four shards), the whole of it, and a shard of the mnist width's 10 heads
# padded to 12 over four shards.
SHARD_SHAPES = [(256, 32, 1024), (256, 32, 4096), (1024, 780, 3)]


@pytest.mark.parametrize("q8", [False, True])
@pytest.mark.parametrize("n,d,k", SHARD_SHAPES)
def test_quadform_kernels_at_sharded_head_counts(cuda, n, d, k, q8):
    """B1 and B3 at a shard's head count: a grid of up to 4096 heads in y,
    held by B1's rule, equal masks."""
    args = (_q8_heads if q8 else _heads)(n, k, d, seed=k + d, dev=cuda)
    kernel = qf.KERNEL_Q8 if q8 else qf.KERNEL
    fn = qf.quadform_heads_q8_cuda if q8 else qf.quadform_heads_cuda
    twin = qf.quadform_heads_q8_torch if q8 else qf.quadform_heads_torch
    before = kernel.launches
    s, _, v = fn(*args)
    assert kernel.launches == before + 1
    s0, _, v0 = twin(*args)
    torch.cuda.synchronize()
    assert s.shape == (n, k)
    assert float((s - s0).abs().max()) <= 1e-4 * float(s0.abs().max()) + 1e-5
    assert torch.equal(v, v0)


@pytest.mark.parametrize("kind", ["rff", "rff_q8", "fastfood", "fastfood_q8"])
@pytest.mark.parametrize("n,d,k", SHARD_SHAPES)
def test_fourier_kernels_at_sharded_head_counts(cuda, n, d, k, kind):
    """B4-B7 at a shard's head count: F = 64 at d = 32 (B6/B7 at d' = 32, two
    stacks; 4096 heads are 86 of B4/B5's 48-head blocks and 256 of B6/B7's
    16-head tiles), F = 4096 at d = 780; held by their twins' rule."""
    q8 = kind.endswith("q8")
    f = 64 if d == 32 else 4096
    if kind.startswith("rff"):
        args = _rff(n, d, f, k, seed=k + d, dev=cuda, q8=q8)
        kernel = rk.KERNEL_Q8 if q8 else rk.KERNEL
        fn = rk.rff_score_q8_cuda if q8 else rk.rff_score_cuda
        out0, tol = _rff_tol(args, q8)
    else:
        stacks = 2 if d == 32 else 4  # d' = 32 or 1024
        args = _fastfood(n, d, stacks, k, seed=k + d, dev=cuda, q8=q8)
        kernel = fwht.KERNEL_Q8 if q8 else fwht.KERNEL
        fn = fwht.fastfood_score_q8_cuda if q8 else fwht.fastfood_score_cuda
        out0, tol = _fastfood_tol(args, q8)
    before = kernel.launches
    out = fn(*args)
    assert kernel.launches == before + 1
    torch.cuda.synchronize()
    assert out.shape == (n, k)
    assert float((out - out0).abs().max()) <= tol


def _small_ovr(dev, k=10, d=24, n_sv=300, seed=2):
    rng = np.random.default_rng(seed)
    X = (rng.standard_normal((n_sv, d)) * 0.3).astype(np.float32)
    ay = rng.standard_normal((k, n_sv)).astype(np.float32)
    ay -= ay.mean(1, keepdims=True)
    b = rng.standard_normal(k).astype(np.float32)
    Z = (rng.standard_normal((77, d)) * 0.3).astype(np.float32)
    Z[::6] *= 80.0  # outside the Eq 3.11 envelope
    return convert.svm_from_numpy(X, ay, b, 0.02, device=dev), Z


def _compiled(svm, family, dtype):
    opts = {"num_features": 500, "dtype": dtype}
    if family == "fastfood":  # fourier's structured projection
        family, opts["structured"] = "fourier", True
    return families.get_family(family).compile(svm, **opts)


FAMILY_CELLS = [
    (f, dt) for f in ("maclaurin", "fourier", "fastfood") for dt in ("float32", "int8")
]
SHARD_KERNELS = {
    ("maclaurin", "float32"): qf.KERNEL,
    ("maclaurin", "int8"): qf.KERNEL_Q8,
    ("fourier", "float32"): rk.KERNEL,
    ("fourier", "int8"): rk.KERNEL_Q8,
    ("fastfood", "float32"): fwht.KERNEL,
    ("fastfood", "int8"): fwht.KERNEL_Q8,
}


@pytest.mark.parametrize("family,dtype", FAMILY_CELLS)
def test_padding_heads_never_win_and_stay_finite_on_the_card(cuda, family, dtype):
    """Heads padded with PAD_HEAD_BIAS (10 -> 12) through each family's kernel,
    on rows inside and far outside the envelope: every padding score is the
    bias exactly (no NaN, no inf), no argmax lands on one, the real heads'
    scores and the validity are unchanged."""
    svm, Z = _small_ovr(cuda)
    art = _compiled(svm, family, dtype)
    fam = families.get_family(art.family)
    padded = fam.pad_heads(art, 4)
    Zd = torch.from_numpy(Z).to(cuda)
    s0, v0 = fam.score(art, Zd)
    s1, v1 = fam.score(padded, Zd)
    torch.cuda.synchronize()
    assert s1.shape == (77, 12) and bool(torch.isfinite(s1).all())
    assert bool((s1[:, 10:] == families.PAD_HEAD_BIAS).all())
    assert int(s1.argmax(1).max()) < 10
    assert torch.equal(v1, v0)
    assert float((s1[:, :10] - s0).abs().max()) <= 1e-4 * float(s0.abs().max()) + 1e-5


@pytest.mark.parametrize("family,dtype", FAMILY_CELLS)
def test_head_sharded_engine_on_four_logical_shards_matches_unsharded(cuda, family, dtype):
    """A head mesh of 4 x the card: each submit launches the family's kernel
    once a shard (3 of 12 padded heads each) and serves the unsharded
    engine's scores, validity and labels."""
    from repro_torch.launch import make_mesh

    svm, Z = _small_ovr(cuda)
    art = _compiled(svm, family, dtype)
    mesh = make_mesh((4,), ("heads",), devices=[cuda] * 4)
    ref = SVMEngine(art, device=cuda)
    shd = SVMEngine(art, head_mesh=mesh)
    kernel = SHARD_KERNELS[family, dtype]
    before = kernel.launches
    r_shd = shd.submit(Z)
    assert kernel.launches == before + 4
    r_ref = ref.submit(Z)
    assert r_shd.values.shape == (77, 10)
    np.testing.assert_allclose(r_shd.values, r_ref.values, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(r_shd.valid, r_ref.valid)
    assert (r_shd.labels == r_ref.labels).mean() >= 0.98  # near-ties may split


def test_sv_sharded_exact_path_on_four_logical_shards_matches_unsharded(cuda):
    """An SV mesh of 4 x the card at the mnist width: 16384 SVs in shards of
    4096, B2 launched four times a call; both engines within B2's rule of
    each other and of float64, with float64's labels."""
    from repro_torch.launch import make_mesh

    rng = np.random.default_rng(3)
    d, m, k = 780, 16384, 10
    X = rng.random((m, d)).astype(np.float32)
    A = rng.standard_normal((k, m))
    A = (A - A.mean(1, keepdims=True)).astype(np.float32)
    b = rng.standard_normal(k).astype(np.float32)
    svm = convert.svm_from_numpy(X, A, b, 2.0 / d, device=cuda)
    art = families.maclaurin.compile(svm)
    Z = rng.random((256, d)).astype(np.float32)
    mesh = make_mesh((4,), ("sv",), devices=[cuda] * 4)
    ref = SVMEngine(art, svm, device=cuda)
    shd = SVMEngine(art, svm, mesh=mesh)
    before = rp.KERNEL.launches
    got = shd.submit_exact(Z)
    got.values
    assert rp.KERNEL.launches == before + 4
    want = ref.submit_exact(Z)
    Zd = torch.from_numpy(Z).to(cuda)
    out0, tol = _rbf_tol(Zd, svm.X, svm.alpha_y, 2.0 / d, svm.b)
    out64 = rp.rbf_scores_torch(
        Zd.double(), svm.X.double(), svm.alpha_y.double(), 2.0 / d, svm.b.double()
    ).cpu().numpy()
    assert float(np.abs(got.values - want.values).max()) <= tol
    assert float(np.abs(got.values - out64).max()) <= tol
    top2 = np.sort(out64, -1)[:, -2:]
    decided = top2[:, 1] - top2[:, 0] > 2 * tol
    np.testing.assert_array_equal(got.labels[decided], out64.argmax(-1)[decided])
