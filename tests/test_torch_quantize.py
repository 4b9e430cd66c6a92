"""The port's int8 quantizers against the JAX package's.

The same seeded numpy inputs go through ``repro.core.families.quantize``
and ``repro_torch.core.families.quantize``: the int8 codes and the f32
scales must be equal byte for byte, and an int8 artifact quantized by the
port from a ``repro``-written f32 parent must have the reference's
``digest()``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.core import SVMModel as JSVM  # noqa: E402
from repro.core.families import maclaurin as jmac  # noqa: E402
from repro.core.families import poly2 as jpoly2  # noqa: E402
from repro.core.families import quantize as jq  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import families  # noqa: E402
from repro_torch.core.families import CompiledArtifact  # noqa: E402
from repro_torch.core.families import quantize as tq  # noqa: E402


def _bytes_equal(port, ref):
    port, ref = np.asarray(port), np.asarray(ref)
    assert port.dtype == ref.dtype
    assert port.shape == ref.shape
    assert port.tobytes() == ref.tobytes()


def _operand(shape, seed, zero_group=False):
    """Heavy-tailed rows of different scales, optionally with one all-zero
    16-column group (its scale must be 1)."""
    rng = np.random.default_rng(seed)
    row_scale = rng.choice([1e-3, 1e-1, 10.0], size=shape[:-1] + (1,))
    x = (rng.standard_t(3, size=shape) * row_scale).astype(np.float32)
    if zero_group:
        x[..., :16] = 0.0
    return x


@pytest.mark.parametrize(
    "shape,axis",
    [((5, 40), -1), ((3, 7, 33), -1), ((6, 50), 0), ((2, 16), -1)],
)
@pytest.mark.parametrize("zero_group", [False, True])
def test_quantize_groups_bytes_equal(shape, axis, zero_group):
    x = _operand(shape, seed=len(shape) + shape[-1], zero_group=zero_group)
    q, s = tq.quantize_groups(x, axis=axis)
    jq_, js = jq.quantize_groups(x, axis=axis)
    _bytes_equal(q, jq_)
    _bytes_equal(s, js)
    # from a tensor, on the CPU, the same bytes
    q2, s2 = tq.quantize_groups(torch.from_numpy(x), axis=axis)
    _bytes_equal(q2, jq_)
    _bytes_equal(s2, js)
    if axis == -1:
        deq = tq.dequantize_groups(torch.from_numpy(q), torch.from_numpy(s))
        _bytes_equal(deq.numpy(), jq.dequantize_groups(jq_, js))


@pytest.mark.parametrize("shape", [(3, 22, 22), (1, 37, 37), (2, 5, 48), (4, 16)])
@pytest.mark.parametrize("zero_group", [False, True])
def test_quantize_col_groups_bytes_equal(shape, zero_group):
    x = _operand(shape, seed=shape[-1], zero_group=zero_group)
    q, s = tq.quantize_col_groups(torch.from_numpy(x))
    jq_, js = jq.quantize_col_groups(x)
    _bytes_equal(q, jq_)
    _bytes_equal(s, js)
    n = shape[-1]
    expanded = tq.expand_group_scales(torch.from_numpy(s), n)
    _bytes_equal(expanded.numpy(), jq.expand_group_scales(js, n))
    _bytes_equal(tq.expand_group_scales(s, n), jq.expand_group_scales(js, n))


@pytest.mark.parametrize("shape", [(10, 22), (3, 1024), (4, 7, 5), (6,)])
def test_quantize_rows_bytes_equal(shape):
    x = _operand(shape, seed=sum(shape))
    if len(shape) > 1:
        x[0] = 0.0  # an all-zero row gets scale 1
    q, s = tq.quantize_rows(torch.from_numpy(x))
    jq_, js = jq.quantize_rows(x)
    _bytes_equal(q, jq_)
    _bytes_equal(s, js)


def test_dtype_and_group_helpers_match():
    assert tq.GROUP_SIZE == jq.GROUP_SIZE
    assert tq.DTYPES == jq.DTYPES
    for n in (1, 15, 16, 17, 780):
        assert tq.num_groups(n) == jq.num_groups(n)
    assert tq.check_dtype("int8") == "int8"
    with pytest.raises(ValueError, match="dtype"):
        tq.check_dtype("bfloat16")


def _svm(k, seed, n_sv=90, d=21):
    rng = np.random.default_rng(seed)
    X = (rng.standard_normal((n_sv, d)) * 0.3).astype(np.float32)
    ay = rng.standard_normal((k, n_sv) if k > 1 else (n_sv,)).astype(np.float32)
    b = rng.standard_normal(k).astype(np.float32) if k > 1 else np.float32(0.2)
    gamma = np.float32(0.04)
    j = JSVM(
        X=jnp.asarray(X),
        alpha_y=jnp.asarray(ay),
        b=jnp.asarray(b),
        gamma=jnp.asarray(gamma),
    )
    return j, convert.svm_from_numpy(X, ay, b, gamma, device="cpu")


@pytest.mark.parametrize("family", ["maclaurin", "poly2"])
@pytest.mark.parametrize("k", [1, 3])
def test_int8_artifact_of_a_repro_parent_has_the_reference_digest(
    family, k, tmp_path
):
    jm, _ = _svm(k, seed=5 + k)
    jfam = {"maclaurin": jmac, "poly2": jpoly2}[family]
    j_f32 = jfam.compile(jm)
    path = j_f32.save(str(tmp_path / "f32.npz"))
    t_f32 = CompiledArtifact.load(path, device="cpu")
    j_q8 = jmac.quantize_quadform_artifact(j_f32)
    t_q8 = families.maclaurin.quantize_quadform_artifact(t_f32)
    assert t_q8.meta == j_q8.meta
    for name, arr in j_q8.arrays.items():
        _bytes_equal(t_q8.arrays[name].numpy(), arr)
    assert t_q8.digest() == j_q8.digest()
    # and the file the port writes is the file repro writes
    t_q8.save(str(tmp_path / "t.npz"))
    j_q8.save(str(tmp_path / "j.npz"))
    assert (tmp_path / "t.npz").read_bytes() == (tmp_path / "j.npz").read_bytes()


@pytest.mark.parametrize("k", [1, 3])
def test_measured_quant_error_matches_the_reference(k):
    """The error the int8 artifact carries in its meta, measured on the
    same held-out rows (the port's twin against the reference's XLA
    path), agrees to f32 rounding."""
    jm, tm = _svm(k, seed=20 + k)
    j_q8 = jmac.compile(jm, dtype="int8", seed=3)
    t_q8 = families.maclaurin.compile(tm, dtype="int8", seed=3)
    assert t_q8.meta["quant_holdout_n"] == j_q8.meta["quant_holdout_n"] == 256
    for key in ("quant_mean_abs_err", "quant_max_abs_err"):
        np.testing.assert_allclose(
            t_q8.meta[key], j_q8.meta[key], rtol=0.05, atol=1e-6
        )
