"""The Fastfood slice on the CPU against the JAX package: the transform,
the plain twins of kernels B6/B7, the structured fourier artifacts (f32
and int8) and their bytes, on the same seeded inputs.

Tolerances: the transforms are exact in +-1 arithmetic and differ only in
f32 summation order, so scores agree to 1e-5 relative + 1e-4 absolute
(the reference suite's Pallas-vs-XLA tolerance); operators drawn from a
seed and int8 codes of an equal f32 parent are equal byte for byte.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.core import SVMModel as JSVM  # noqa: E402
from repro.core import gamma_max  # noqa: E402
from repro.core.families import fourier as jfourier  # noqa: E402
from repro.core.families import quantize as jq  # noqa: E402
from repro.kernels.common.config import TileConfig as JTileConfig  # noqa: E402
from repro.kernels import fwht as jfwht  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import backend, families  # noqa: E402
from repro_torch.core.families import CompiledArtifact  # noqa: E402
from repro_torch.core.families import quantize as tq  # noqa: E402
from repro_torch.kernels import fwht  # noqa: E402
from repro_torch.serve import SVMEngine  # noqa: E402

RTOL, ATOL = 1e-5, 1e-4


def _sylvester(d):
    H = np.array([[1.0]])
    while H.shape[0] < d:
        H = np.block([[H, H], [H, -H]])
    return H


def _svm(seed=0, d=20, n_sv=40, k=3):
    rng = np.random.default_rng(seed)
    X = (rng.standard_normal((n_sv, d)) * 0.5).astype(np.float32)
    gamma = np.float32(float(gamma_max(jnp.asarray(X))) * 0.8)
    ay = (rng.standard_normal((k, n_sv)) * 0.5).astype(np.float32)
    b = (rng.standard_normal(k) * 0.1).astype(np.float32)
    jm = JSVM(
        X=jnp.asarray(X), alpha_y=jnp.asarray(ay), b=jnp.asarray(b), gamma=gamma
    )
    return jm, convert.svm_from_numpy(X, ay, b, gamma, device="cpu")


def _operands(rng, n, d, stacks, k):
    """Random Fastfood operands at d' = next pow2 >= d (the reference
    suite's ``_operands``), as numpy arrays."""
    dd = 1 << max(1, (d - 1).bit_length())
    f = stacks * dd
    return dict(
        Z=rng.standard_normal((n, d)).astype(np.float32),
        B=rng.choice(np.float32([-1, 1]), (stacks, dd)),
        G=rng.standard_normal((stacks, dd)).astype(np.float32),
        perm=np.stack([rng.permutation(dd) for _ in range(stacks)]).astype(np.int32),
        scale=(rng.standard_normal((stacks, dd)) * 0.1).astype(np.float32),
        phase=rng.uniform(0, 2 * np.pi, f).astype(np.float32),
        weights=(rng.standard_normal((k, f)) * 0.05).astype(np.float32),
        bias=rng.standard_normal(k).astype(np.float32),
    )


def _q8_operands(rng, n, d, stacks, k):
    """B7's operands, as the int8 artifact stores them (int16 perm, f16
    phase)."""
    ops = _operands(rng, n, d, stacks, k)

    def q(x, s):
        return np.clip(np.round(x / s), -127, 127).astype(np.int8)

    return dict(
        Z=ops["Z"],
        b_q=ops["B"].astype(np.int8),
        g_q=q(ops["G"], 0.02),
        perm=ops["perm"].astype(np.int16),
        s_q=q(ops["scale"], 0.002),
        stack_scale=np.full((stacks,), 0.02 * 0.002, np.float32),
        phase=ops["phase"].astype(np.float16),
        weights_q=q(ops["weights"], 0.001),
        wt_scale=np.full((k,), 0.001, np.float32),
        bias=ops["bias"],
    )


def _torch(ops):
    return {k: torch.from_numpy(v) for k, v in ops.items()}


def _jax(ops):
    return {k: jnp.asarray(v) for k, v in ops.items()}


# ------------------------------------------------------------- transform


@pytest.mark.parametrize("d", [1, 2, 8, 64, 1024, 2048])
def test_fwht_and_kron_match_the_sylvester_matrix(d):
    x = np.random.default_rng(d).standard_normal((5, d)).astype(np.float32)
    want = x.astype(np.float64) @ _sylvester(d).T
    tol = dict(rtol=1e-5, atol=1e-4 * np.sqrt(d))
    np.testing.assert_allclose(fwht.fwht(torch.from_numpy(x)).numpy(), want, **tol)
    np.testing.assert_allclose(
        fwht.fwht_kron(torch.from_numpy(x)).numpy(), want, **tol
    )
    # and the port's butterfly is the reference's, to f32 rounding
    np.testing.assert_allclose(
        fwht.fwht(torch.from_numpy(x)).numpy(),
        np.asarray(jfwht.fwht(jnp.asarray(x))),
        **tol,
    )


def test_fastfood_project_pads_nonpow2_d_exactly():
    ops = _torch(_operands(np.random.default_rng(1), 7, 20, 2, 3))
    dd = ops["B"].shape[1]
    Zp = torch.nn.functional.pad(ops["Z"], (0, dd - 20))
    args = (ops["B"], ops["G"], ops["perm"], ops["scale"])
    a = fwht.fastfood_project(ops["Z"], *args)
    b = fwht.fastfood_project(Zp, *args)
    assert torch.equal(a, b)


# -------------------------------------------------------- twins of B6/B7


@pytest.mark.parametrize("d", [6, 20, 100])
def test_fastfood_twin_matches_reference_and_pallas(d):
    rng = np.random.default_rng(d)
    ops = _operands(rng, 33, d, 3, 5)
    got = fwht.fastfood_score_torch(**_torch(ops)).numpy()
    ref = np.asarray(jfwht.fastfood_score_ref(**_jax(ops)))
    pallas = jfwht.fastfood_score_pallas(
        **_jax(ops), config=JTileConfig(block_n=16), interpret=True
    )
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("d", [6, 20, 100])
def test_fastfood_q8_twin_matches_reference_and_pallas(d):
    rng = np.random.default_rng(100 + d)
    ops = _q8_operands(rng, 21, d, 2, 6)
    got = fwht.fastfood_score_q8_torch(**_torch(ops)).numpy()
    ref = np.asarray(jfwht.fastfood_score_q8_ref(**_jax(ops)))
    pallas = jfwht.fastfood_score_q8_pallas(
        **_jax(ops), config=JTileConfig(block_n=8), interpret=True
    )
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=RTOL, atol=ATOL)


def test_backend_on_cpu_tensors_is_the_twin():
    rng = np.random.default_rng(5)
    ops = _torch(_operands(rng, 17, 20, 2, 4))
    assert torch.equal(backend.fastfood_score(**ops), fwht.fastfood_score_torch(**ops))
    q8 = _torch(_q8_operands(rng, 9, 20, 2, 4))
    assert torch.equal(
        backend.fastfood_score_q8(**q8), fwht.fastfood_score_q8_torch(**q8)
    )


# ------------------------------------------------ operators and artifacts


@pytest.mark.parametrize("d,f,seed", [(6, 64, 0), (20, 200, 3), (100, 600, 9)])
def test_fastfood_arrays_and_holdout_sample_are_byte_equal(d, f, seed):
    gamma = 0.37 / d
    j_arrays, j_f, j_meta = jfourier._fastfood_arrays(
        np.random.default_rng(seed), d, f, gamma
    )
    t_arrays, t_f, t_meta = families.fourier._fastfood_arrays(
        np.random.default_rng(seed), d, f, gamma
    )
    assert (t_f, t_meta) == (j_f, j_meta)
    assert set(t_arrays) == set(j_arrays)
    for name, ref in j_arrays.items():
        ref = np.asarray(ref)
        assert t_arrays[name].dtype == ref.dtype, name
        assert t_arrays[name].tobytes() == ref.tobytes(), name
    jm, tm = _svm(seed, d=d)
    got = families.fourier.holdout_sample(tm, seed, 31)
    ref = np.asarray(jfourier.holdout_sample(jm, seed, 31))
    assert got.dtype == ref.dtype and got.tobytes() == ref.tobytes()


def test_sign_and_perm_narrowing_are_byte_equal():
    rng = np.random.default_rng(4)
    signs = rng.choice(np.float32([-1, 1]), (3, 64))
    ref = np.asarray(jq.quantize_signs(signs))
    assert tq.quantize_signs(signs).tobytes() == ref.tobytes()
    with pytest.raises(ValueError, match="exactly"):
        tq.quantize_signs(signs * 0.5)
    for dd in (64, 40000):
        perm = np.stack([rng.permutation(dd) for _ in range(2)]).astype(np.int32)
        got = tq.compact_perm(torch.from_numpy(perm))
        ref = np.asarray(jq.compact_perm(perm))
        assert got.dtype == ref.dtype and got.tobytes() == ref.tobytes()


def test_int8_fastfood_of_a_repro_parent_has_the_reference_digest(tmp_path):
    jm, _ = _svm(7, d=100, n_sv=60, k=10)
    j_f32 = jfourier.compile(jm, num_features=512, structured=True, seed=3)
    t_f32 = CompiledArtifact.load(j_f32.save(str(tmp_path / "f32.npz")), device="cpu")
    j_q8 = jfourier.quantize_fastfood_artifact(j_f32)
    t_q8 = families.fourier.quantize_rff_artifact(t_f32)  # routes to Fastfood
    assert t_q8.meta == j_q8.meta
    for name, arr in j_q8.arrays.items():
        got, ref = t_q8.arrays[name].numpy(), np.asarray(arr)
        assert got.dtype == ref.dtype and got.tobytes() == ref.tobytes(), name
    assert t_q8.digest() == j_q8.digest()
    with pytest.raises(ValueError, match="fastfood"):
        families.fourier.quantize_fastfood_artifact(
            families.fourier.compile(_svm(1)[1], num_features=32)
        )


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_repro_written_structured_artifact_keeps_its_digest_and_scores(
    dtype, tmp_path
):
    jm, tm = _svm(11, d=20, n_sv=50, k=4)
    j_art = jfourier.compile(
        jm, num_features=256, structured=True, dtype=dtype, seed=2
    )
    t_art = CompiledArtifact.load(j_art.save(str(tmp_path / "a.npz")), device="cpu")
    assert t_art.digest() == j_art.digest()
    t_art.save(str(tmp_path / "b.npz"))
    assert (tmp_path / "b.npz").read_bytes() == (tmp_path / "a.npz").read_bytes()
    Z = (np.random.default_rng(0).standard_normal((40, 20)) * 0.5).astype(np.float32)
    j_s, j_v = map(np.asarray, jfourier.score(j_art, jnp.asarray(Z)))
    t_s, t_v = families.fourier.score(t_art, torch.from_numpy(Z))
    np.testing.assert_allclose(t_s.numpy(), j_s, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(t_v.numpy(), j_v)
    kernel = "fwht_q8" if dtype == "int8" else "fwht"
    assert families.fourier.tile_lookup(t_art, 64) == (kernel, "d20_f256_n64")


def test_int8_fastfood_artifact_contract():
    """Every array that scales with F or K narrows, the serialized file is
    >= 3x smaller, labels agree with the f32 parent, and it serves."""
    _, tm = _svm(7, d=100, n_sv=60, k=10)
    f32 = families.fourier.compile(tm, num_features=2048, structured=True, seed=3)
    q8 = families.fourier.compile(
        tm, num_features=2048, structured=True, dtype="int8", seed=3
    )
    a = q8.arrays
    for name in ("ff_b", "ff_g", "ff_scale", "weights"):
        assert a[name].dtype == torch.int8, name
    assert a["ff_perm"].dtype == torch.int16 and a["phase"].dtype == torch.float16
    assert len(f32.to_bytes()) / len(q8.to_bytes()) >= 3.0
    assert q8.meta["quant_mean_abs_err"] < 0.05
    Z = families.fourier.holdout_sample(tm, 3, 128)
    s32, _ = families.fourier.score(f32, torch.from_numpy(Z))
    s8, _ = families.fourier.score(q8, torch.from_numpy(Z))
    assert (s32.argmax(1) == s8.argmax(1)).float().mean() >= 0.99
    labels = SVMEngine(q8, device="cpu").predict_labels(Z[:9])
    assert labels.shape == (9,)
