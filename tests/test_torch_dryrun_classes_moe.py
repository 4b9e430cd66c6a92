"""The class trace against the full trace for qwen3-moe's train step
under EP_DP_RULES on a (4, 4) mesh of fake devices: the batch cut over
both axes (every position its own rows), the experts over "data" (the
dispatch buffer all-to-all'd to their owners and back), the dense parts'
weights replicated and every "ffn" dim gathered. Held equal at every
position as ``test_torch_dryrun_classes.py`` holds smollm-135m's cells.
"""

import pytest

pytest.importorskip("torch")

from test_torch_dryrun_classes import _one_thread, assert_class_trace_equals_full  # noqa: E402, F401


def test_ep_dp_train_step():
    got, _ = assert_class_trace_equals_full("qwen3-moe-30b-a3b", "train", "EP_DP_RULES")
    kinds = {k[0] for ks in got["calls"].values() for k in ks}
    assert "all-to-all" in kinds
