"""The LM families past dense against the JAX package, part 2: ``forward``
logits and aux at T = 1024 (blockwise attention in two query chunks,
flash, and the maclaurin backend's chunked branch, B8's twin; RWKV6 and
Mamba2 over 64 chunks) for the reduced qwen3-moe, arctic, rwkv6, zamba2
and llama-3.2-vision. The cases, weights and tolerance are
``test_torch_lm_families.py``'s (see its docstring); this file runs on
its own xdist worker.
"""

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from test_torch_lm_families import FORWARD_PARAMS, check_forward  # noqa: E402


@pytest.mark.parametrize("name,backend,impl", FORWARD_PARAMS)
def test_forward_matches_jax(name, backend, impl):
    check_forward(name, backend, impl, 1024)
