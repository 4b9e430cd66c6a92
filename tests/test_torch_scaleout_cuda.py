"""Scale-out across distinct cards: head- and SV-sharded engines on a mesh
of every card, and runtime replicas pinned round-robin across them, held
against one card's unsharded engine.

Marked ``cuda``; each test skips inside its body unless two or more cards
are present (a mesh of one card repeated is covered by
``tests/test_torch_kernels_cuda.py``). On a machine with several cards:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_scaleout_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import convert  # noqa: E402
from repro_torch.core import families  # noqa: E402
from repro_torch.kernels import fwht  # noqa: E402
from repro_torch.kernels.quadform import kernel as qf  # noqa: E402
from repro_torch.kernels.rbf_pred import kernel as rp  # noqa: E402
from repro_torch.kernels.rff_score import kernel as rk  # noqa: E402
from repro_torch.launch import make_mesh  # noqa: E402
from repro_torch.serve import PublishSpec, Runtime, SVMEngine  # noqa: E402

pytestmark = pytest.mark.cuda

KERNELS = {
    ("maclaurin", "float32"): qf.KERNEL,
    ("maclaurin", "int8"): qf.KERNEL_Q8,
    ("fourier", "float32"): rk.KERNEL,
    ("fourier", "int8"): rk.KERNEL_Q8,
    ("fastfood", "float32"): fwht.KERNEL,
    ("fastfood", "int8"): fwht.KERNEL_Q8,
}


@pytest.fixture
def cards():
    """Every card, when there are two or more."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA cards")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _ovr(dev, k=10, d=24, n_sv=300, seed=2):
    """A seeded one-vs-rest model on ``dev`` and rows on both sides of the
    Eq 3.11 envelope."""
    rng = np.random.default_rng(seed)
    X = (rng.standard_normal((n_sv, d)) * 0.3).astype(np.float32)
    ay = rng.standard_normal((k, n_sv)).astype(np.float32)
    ay -= ay.mean(1, keepdims=True)
    b = rng.standard_normal(k).astype(np.float32)
    Z = (rng.standard_normal((77, d)) * 0.3).astype(np.float32)
    Z[::6] *= 80.0
    return convert.svm_from_numpy(X, ay, b, 0.02, device=dev), Z


def _compiled(svm, family, dtype):
    opts = {"num_features": 500, "dtype": dtype}
    if family == "fastfood":  # fourier's structured projection
        family, opts["structured"] = "fourier", True
    return families.get_family(family).compile(svm, **opts)


def test_mesh_without_devices_takes_every_card(cards):
    mesh = make_mesh((len(cards),), ("heads",))
    assert mesh.devices == tuple(cards)
    assert mesh.shard_devices() == tuple(cards)


@pytest.mark.parametrize("family,dtype", list(KERNELS))
def test_head_sharded_engine_across_cards_matches_one_card(cards, family, dtype):
    """Heads split over every card (10 padded to a multiple of the count):
    the family's kernel launches once a card, the scores gather on the
    first, and the answers equal one card's unsharded engine."""
    svm, Z = _ovr(cards[0])
    art = _compiled(svm, family, dtype)
    mesh = make_mesh((len(cards),), ("heads",), devices=cards)
    ref = SVMEngine(art, svm, device=cards[0])
    shd = SVMEngine(art, svm, head_mesh=mesh)
    for engine in (ref, shd):
        engine.warmup([77])
    shards = shd._serve_artifact.meta.get("padded_heads", 10) // len(cards)
    placed = families.get_family(art.family).place_shards(shd._serve_artifact, mesh)
    for name, parts in placed.items():
        assert [p.device for p in parts] == cards, name
    assert placed["b"][-1].shape[0] == shards
    kernel = KERNELS[family, dtype]
    before = kernel.launches
    r_shd = shd.submit(Z)
    values = r_shd.values
    assert kernel.launches == before + len(cards)
    r_ref = ref.submit(Z)
    assert values.shape == (77, 10)
    np.testing.assert_allclose(values, r_ref.values, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(r_shd.valid, r_ref.valid)
    assert (r_shd.labels == r_ref.labels).mean() >= 0.98  # near-ties may split


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_extreme_head_count_across_cards_keeps_argmax_parity(cards, dtype):
    """4096 one-vs-rest heads at d = 32 split over every card."""
    rng = np.random.default_rng(7)
    X = (rng.standard_normal((64, 32)) * 0.5).astype(np.float32)
    gamma = 0.8 / (4.0 * float((X.astype(np.float64) ** 2).sum(1).max()))
    ay = (rng.standard_normal((4096, 64)) * 0.5).astype(np.float32)
    b = (rng.standard_normal(4096) * 0.1).astype(np.float32)
    svm = convert.svm_from_numpy(X, ay, b, gamma, device=cards[0])
    art = families.maclaurin.compile(svm, dtype=dtype)
    Z = np.random.default_rng(2).standard_normal((256, 32)).astype(np.float32)
    mesh = make_mesh((len(cards),), ("heads",), devices=cards)
    r_ref = SVMEngine(art, device=cards[0]).submit(Z)
    r_shd = SVMEngine(art, head_mesh=mesh).submit(Z)
    assert r_shd.values.shape == (256, 4096)
    tol = 1e-4 * float(np.abs(r_ref.values).max()) + 1e-5
    assert float(np.abs(r_shd.values - r_ref.values).max()) <= tol
    top2 = np.sort(r_ref.values, -1)[:, -2:]
    decided = top2[:, 1] - top2[:, 0] > tol
    np.testing.assert_array_equal(r_shd.labels[decided], r_ref.labels[decided])
    np.testing.assert_array_equal(r_shd.valid, r_ref.valid)


def test_sv_sharded_exact_path_across_cards_matches_one_card(cards):
    """16384 SVs at d = 780 split over every card: B2 launched once a card a
    call, the partial sums added on the first; within B2's rule (4x the f32
    twin's distance from float64, + 1e-6) of one card's engine and of
    float64, for ``submit_exact`` and for the per-row fallback."""
    rng = np.random.default_rng(3)
    d, m, k = 780, 16384, 10
    X = rng.random((m, d)).astype(np.float32)
    A = rng.standard_normal((k, m))
    A = (A - A.mean(1, keepdims=True)).astype(np.float32)
    b = rng.standard_normal(k).astype(np.float32)
    gamma = 2.0 / d
    svm = convert.svm_from_numpy(X, A, b, gamma, device=cards[0])
    art = families.maclaurin.compile(svm)
    Z = rng.random((256, d)).astype(np.float32)
    Z[::8] *= 6.0  # outside the envelope: the fallback runs on the shards
    mesh = make_mesh((len(cards),), ("sv",), devices=cards)
    ref = SVMEngine(art, svm, device=cards[0])
    shd = SVMEngine(art, svm, mesh=mesh)
    assert [x.device for x in shd._X] == cards
    before = rp.KERNEL.launches
    got = shd.submit_exact(Z)
    got.values
    assert rp.KERNEL.launches == before + len(cards)
    want = ref.submit_exact(Z)
    Zd = torch.from_numpy(Z).to(cards[0])
    out0 = rp.rbf_scores_torch(Zd, svm.X, svm.alpha_y, gamma, svm.b)
    out64 = rp.rbf_scores_torch(
        Zd.double(), svm.X.double(), svm.alpha_y.double(), gamma, svm.b.double()
    )
    tol = 4.0 * float((out0.double() - out64).abs().max()) + 1e-6
    out64 = out64.cpu().numpy()
    assert float(np.abs(got.values - want.values).max()) <= tol
    assert float(np.abs(got.values - out64).max()) <= tol
    fast_shd, fast_ref = shd.submit(Z), ref.submit(Z)
    assert not fast_shd.valid.all()
    np.testing.assert_array_equal(fast_shd.valid, fast_ref.valid)
    out = ~fast_shd.valid
    assert float(np.abs(fast_shd.values[out] - out64[out]).max()) <= tol


def test_replicas_pin_round_robin_across_cards(cards):
    """A runtime with no device named pins one replica a card, and every
    replica's answers equal a direct submit on the first card."""
    svm, Z = _ovr(cards[0], k=3)
    art = families.maclaurin.compile(svm).to("cpu")
    direct = SVMEngine(art, svm, device=cards[0], min_bucket=8, max_batch=64)
    with Runtime(engine_opts=dict(min_bucket=8, max_batch=64), max_wait_us=500.0) as rt:
        rt.publish("m", art, PublishSpec(exact=svm, replicas=len(cards)))
        engines = rt.registry.get_engines("m")[1]
        assert [e.device for e in engines] == cards
        for i in range(2 * len(cards)):
            rows = Z[4 * i : 4 * i + 4]
            res = rt.submit("m", rows).result(timeout=60.0)
            want = direct.submit(rows)
            np.testing.assert_allclose(res.values, want.values, rtol=1e-5, atol=1e-6)
            np.testing.assert_array_equal(res.labels, want.labels)
            np.testing.assert_array_equal(res.valid, want.valid)
        per = rt.stats("m")["replicas"]
        assert all(per[i]["flushes"] >= 1 for i in per)
