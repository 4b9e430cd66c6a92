"""Placement by the partitioning rules over distinct cards: a model's
parameters put on a (data, model) mesh of every card, each card's
allocated memory held against the bytes the placement says it holds, and
every leaf gathered back bit for bit.

Marked ``cuda``; each test skips inside its body unless two or more cards
are present (one card repeated as the mesh's slots is driven by
``chip_smoke.py``'s path 10). On a machine with several cards:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_sharding_cuda.py
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.launch import make_mesh  # noqa: E402
from repro_torch.launch.specs import sanitize  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.sharding import partitioning as part  # noqa: E402

pytestmark = pytest.mark.cuda

# PyTorch's caching allocator splits a cached block for a request only
# where more than 1 MiB would remain, so a card's allocated memory grows by
# at least the bytes it holds and by less than this a shard more.
SLACK = 1 << 20


@pytest.fixture
def cards():
    """Every card, when there are two or more."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA cards")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _mesh(cards):
    n = len(cards) // 2 * 2
    return make_mesh((n // 2, 2), ("data", "model"), devices=cards[:n])


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


@pytest.mark.parametrize("rules_name", ["DEFAULT_RULES", "TP_ONLY_RULES", "EP_DATA_RULES"])
@pytest.mark.parametrize("name", ["qwen3-moe-30b-a3b", "smollm-135m"])
def test_each_card_holds_the_bytes_the_placement_names(cards, name, rules_name):
    mesh = _mesh(cards)
    params = transformer.init_params(ARCHS[name].reduced(), device="cpu")
    tree = params.tree()
    rules = getattr(part, rules_name)
    shardings = sanitize(part.param_shardings(params.spec(), rules, mesh), tree, mesh)
    for dev in mesh.devices:
        torch.cuda.synchronize(dev)
    before = {dev: torch.cuda.memory_allocated(dev) for dev in mesh.devices}
    placed = part.device_put(tree, shardings)
    held = {dev: 0 for dev in mesh.devices}
    shards = {dev: 0 for dev in mesh.devices}
    for leaf in _leaves(placed):
        for dev, nbytes in leaf.device_bytes().items():
            held[dev] += nbytes
        for dev in leaf.sharding.mesh.devices:
            shards[dev] += 1
    for dev in mesh.devices:
        grown = torch.cuda.memory_allocated(dev) - before[dev]
        assert held[dev] <= grown < held[dev] + SLACK * shards[dev], (dev, grown, held[dev])
    for got, want in zip(_leaves(placed), _leaves(tree)):
        assert torch.equal(got.gather("cpu"), want)
        assert {s.device for s in got.shards} == set(mesh.devices)
    # every rule set here cuts the vocabulary over 'model': no card holds all
    whole = sum(x.numel() * x.element_size() for x in _leaves(tree))
    assert max(held.values()) < whole
