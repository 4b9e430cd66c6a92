"""``sharding.collectives`` on four CPU slots: each collective against
``torch.cat`` and sums, its replicas bit for bit equal, and its gradient
against the numerical Jacobian (``torch.autograd.gradcheck``, f64); on four
fake devices under the cost recorder, every member of a reduction sends,
receives and adds the same share (a tensor no dim of which splits evenly
summed on the first member); then ``partitioning.axis_groups`` and
``Sharded.replica_groups``, which name the groups the sharded steps run
them over."""

import pytest

torch = pytest.importorskip("torch")

from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.launch.op_cost import COPY_IN, COPY_OUT, CostRecorder, cost  # noqa: E402
from repro_torch.sharding import collectives as coll  # noqa: E402
from repro_torch.sharding.partitioning import (  # noqa: E402
    NamedSharding,
    PartitionSpec as P,
    axis_groups,
    device_put,
)

N = 4


def _members(shape=(2, 8, 3), dtype=torch.float64, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=g, dtype=dtype) for _ in range(N)]


def _fresh(out, xs):
    """Each output is its own tensor: no output shares storage with another
    or with an input."""
    ptrs = [t.data_ptr() for t in out] + [t.data_ptr() for t in xs]
    assert len(set(ptrs)) == len(ptrs)


def test_all_reduce_sums_once_and_copies():
    xs = _members(dtype=torch.float32)
    out = coll.all_reduce(xs)
    want = xs[0] + xs[1] + xs[2] + xs[3]  # the group's order
    assert all(torch.equal(o, want) for o in out)
    _fresh(out, xs)
    assert coll.all_reduce(xs[:1])[0] is xs[0]  # a group of one: the tensor itself


def test_all_gather_concatenates_on_every_member():
    xs = _members()
    for dim in (0, 1, -1):
        out = coll.all_gather(xs, dim)
        want = torch.cat(xs, dim)
        assert all(torch.equal(o, want) for o in out)
        _fresh(out, xs)


def test_reduce_scatter_hands_each_member_its_chunk():
    xs = _members()
    out = coll.reduce_scatter(xs, 1)
    total = xs[0] + xs[1] + xs[2] + xs[3]
    for i, o in enumerate(out):
        assert torch.equal(o, total[:, 2 * i : 2 * i + 2])
    with pytest.raises(ValueError, match="split"):
        coll.reduce_scatter(_members((2, 6, 3)), 1)


def test_all_to_all_exchanges_chunks_and_inverts():
    xs = _members((4, 8, 3))
    out = coll.all_to_all(xs, 1, 0)
    for j, o in enumerate(out):
        assert torch.equal(o, torch.cat([x[:, 2 * j : 2 * j + 2] for x in xs], 0))
    back = coll.all_to_all(out, 0, 1)
    assert all(torch.equal(b, x) for b, x in zip(back, xs))
    with pytest.raises(ValueError, match="split"):
        coll.all_to_all(_members((2, 6, 3)), 1, 0)


def test_all_max_and_gather():
    xs = _members(dtype=torch.float32)
    out = coll.all_max(xs)
    want = torch.stack(xs).amax(0)
    assert all(torch.equal(o, want) for o in out)
    _fresh(out, xs)
    assert torch.equal(coll.gather(xs, 1), torch.cat(xs, 1))


@pytest.mark.parametrize(
    "name, fn",
    [
        ("all_reduce", lambda xs: coll.all_reduce(xs)),
        ("all_gather", lambda xs: coll.all_gather(xs, 1)),
        ("reduce_scatter", lambda xs: coll.reduce_scatter(xs, 1)),
        ("all_to_all", lambda xs: coll.all_to_all(xs, 1, 0)),
        ("gather", lambda xs: (coll.gather(xs, 1),)),
        ("sum_in_order", lambda xs: (coll.sum_in_order(xs),)),
    ],
)
def test_gradient_is_the_conjugate(name, fn):
    """The backward of each is the vector-Jacobian product of its forward
    over every member's tensor (all-gather's is reduce-scatter, all-to-all's
    its inverse, the all-reduce's itself; gather's and sum_in_order's
    copies back to each member, in one node)."""
    xs = [x.requires_grad_(True) for x in _members((2, 4, 3))]
    assert torch.autograd.gradcheck(lambda *a: tuple(fn(list(a))), xs)


def _moved(rec, dev: str) -> tuple[float, float, float]:
    """(bytes in, bytes out, flops) of what ``dev`` did under ``rec``:
    its copies from and to other devices, and its adds."""
    moved = {COPY_IN: 0.0, COPY_OUT: 0.0}
    flops = 0.0
    for i, n in rec.counts[dev].items():
        rec_flops, _, nbytes = cost(rec.records[i])
        name = rec.records[i][0]
        if name in moved:
            moved[name] += n * nbytes
        flops += n * rec_flops
    return moved[COPY_IN], moved[COPY_OUT], flops


@pytest.mark.parametrize(
    "name, fn, moved, flops",
    [  # each member's tensor 8 x 32 f32 (1 KiB); g = 4
        ("all_reduce", lambda xs: coll.all_reduce(xs), 2 * 3 / 4 * 1024, 3 * 64),
        ("all_max", lambda xs: coll.all_max(xs), 2 * 3 / 4 * 1024, 3 * 64),
        ("all_gather", lambda xs: coll.all_gather(xs, 1), 3 / 4 * 4096, 0),
        ("reduce_scatter", lambda xs: coll.reduce_scatter(xs, 1), 3 / 4 * 1024, 3 * 64),
    ],
)
def test_every_member_moves_the_same_share(name, fn, moved, flops):
    """Each member receives and sends (g - 1) / g of a result (of the whole
    sum for a reduce-scatter), twice for an all-reduce or a max, and adds
    its chunk of the other members' tensors: the same at every member."""
    with FakeTensorMode():
        xs = [torch.ones(8, 32, device=f"meta:{i}") for i in range(N)]
        with CostRecorder() as rec:
            out = fn(xs)
    assert [o.device for o in out] == [x.device for x in xs]
    for i in range(N):
        assert _moved(rec, f"meta:{i}") == (moved, moved, flops), (name, i)


def test_a_tensor_that_splits_unevenly_sums_on_the_first_member():
    """No dim of a (3,) tensor splits over four members: the first member
    adds the other three and copies the sum back (the loss and norm
    scalars take this route)."""
    with FakeTensorMode():
        xs = [torch.ones(3, device=f"meta:{i}") for i in range(N)]
        with CostRecorder() as rec:
            coll.all_reduce(xs)
    assert _moved(rec, "meta:0") == (3 * 12, 3 * 12, 3 * 3)
    assert all(_moved(rec, f"meta:{i}") == (12, 12, 0) for i in (1, 2, 3))


def test_groups_follow_the_block_order():
    mesh = make_mesh((2, 3), ("data", "model"), devices=["cpu"] * 6)
    assert axis_groups(mesh, ("model",)) == [[0, 1, 2], [3, 4, 5]]
    assert axis_groups(mesh, ("data",)) == [[0, 3], [1, 4], [2, 5]]
    assert axis_groups(mesh, ()) == [[p] for p in range(6)]
    # a dim cut over (model, data): model the major axis, as the index is
    assert axis_groups(mesh, ("model", "data")) == [[0, 3, 1, 4, 2, 5]]
    x = torch.arange(12.0).reshape(6, 2)
    placed = device_put(x, NamedSharding(mesh, P(("model", "data"))))
    order = axis_groups(mesh, ("model", "data"))[0]
    assert torch.equal(torch.cat([placed.local(p) for p in order]), x)
    with pytest.raises(ValueError, match="pod"):
        axis_groups(mesh, ("pod",))


def test_replica_groups_name_the_holders_of_each_block():
    mesh = make_mesh((2, 2), ("data", "model"), devices=["cpu"] * 4)
    x = torch.arange(8.0).reshape(4, 2)
    assert device_put(x, NamedSharding(mesh, P("model"))).replica_groups() == [[0, 2], [1, 3]]
    assert device_put(x, NamedSharding(mesh, P("data", "model"))).replica_groups() == [[0], [1], [2], [3]]
    assert device_put(x, NamedSharding(mesh, P())).replica_groups() == [[0, 1, 2, 3]]
    scalar = device_put(torch.tensor(3), NamedSharding(mesh, P()))
    assert scalar.replica_groups() == [[0, 1, 2, 3]] and int(scalar.local(2)) == 3
