"""Kernel B8's route: the one of its two bodies that the cost model fitted
on the card finds faster (pure Python, no card)."""

import pytest

pytest.importorskip("torch")

from repro_torch.kernels.maclaurin_attn import kernel as ma  # noqa: E402

# (BH, T, d, dv): each route's ms, both forced, from ``python3 chip_smoke.py
# --route-sweep`` on an H100 80GB HBM3 at 700 W.
MEASURED = {
    (64, 2048, 64, 64): {"moments": 8.657, "quadratic": 0.680},
    (16, 1024, 128, 128): {"moments": 13.25, "quadratic": 0.146},
    (4, 4096, 16, 16): {"moments": 2.303, "quadratic": 0.257},
    (16, 4096, 16, 16): {"moments": 2.289, "quadratic": 0.634},
    (256, 1024, 16, 64): {"moments": 3.333, "quadratic": 0.707},
    (1, 65536, 128, 128): {"moments": 59.03, "quadratic": 28.01},
    (64, 8192, 16, 16): {"moments": 4.827, "quadratic": 9.730},
    (256, 2048, 16, 16): {"moments": 1.833, "quadratic": 2.544},
    (16, 32768, 32, 32): {"moments": 31.25, "quadratic": 38.06},
    (64, 32768, 64, 64): {"moments": 143.2, "quadratic": 169.2},
    (4, 65536, 96, 96): {"moments": 60.01, "quadratic": 107.2},
}


@pytest.mark.parametrize("bh,t,d,dv", [(36, 2048, 64, 64), (8, 1024, 128, 128)])
def test_model_shapes_take_the_quadratic_route(bh, t, d, dv):
    assert ma.route(bh, t, d, dv) == "quadratic"
    times = ma.route_ms(bh, t, d, dv)
    assert times["quadratic"] < times["moments"] / 4


def test_long_narrow_heads_take_the_moments_route():
    assert ma.route(64, 8192, 16, 16) == "moments"
    assert ma.route(8, 4096, 16, 16) == "quadratic"  # fewer heads: the card is not full
    times = ma.route_ms(64, 8192, 16, 16)
    assert 1.5 < times["quadratic"] / times["moments"] < 3


@pytest.mark.parametrize("shape", sorted(MEASURED))
def test_the_route_is_the_faster_on_the_card(shape):
    measured = MEASURED[shape]
    assert ma.route(*shape) == min(measured, key=measured.get)
    for name, ms in ma.route_ms(*shape).items():
        assert 0.5 < ms / measured[name] < 1.5, (name, ms, measured[name])


@pytest.mark.parametrize("bh", [1, 4, 64, 256])
@pytest.mark.parametrize("d", [16, 32, 64, 96, 128])
def test_the_route_flips_once_as_t_grows(bh, d):
    """The quadratic form's time grows as T^2, the moments' as T: past one
    length the moments win, and they win at every longer one."""
    routes = [ma.route(bh, 2**e, d, d) for e in range(6, 21)]
    assert routes[0] == "quadratic"
    assert routes[-1] == "moments"
    assert sum(a != b for a, b in zip(routes, routes[1:])) == 1


@pytest.mark.parametrize(
    "d,dv,columns",
    [(16, 16, (16, 16)), (32, 20, (10, 16)), (64, 64, (8, 9)), (64, 160, (9, 9)), (96, 96, (3, 3)), (128, 128, (1, 1))],
)
def test_value_columns_follow_the_source(d, dv, columns):
    """What maclaurin_attn.cu's value_columns picks: as many columns as fit
    227 KB of shared memory beside the denominator's, at most 16, spread
    evenly over the blocks of a head."""
    assert ma.value_columns(d, dv) == columns
