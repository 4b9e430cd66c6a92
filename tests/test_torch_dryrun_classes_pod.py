"""The class trace against the full trace (``test_torch_dryrun_classes.py``)
for smollm-135m's TP_ONLY decode on a (4, 4) mesh of fake devices, whose
cache (2 kv heads, model = 4) is cut along its sequence over "model": the
slot's owner, member 0 of each group, writes the new token, and the
softmax partials are combined over the group. And its train step under
DEFAULT on a (2, 4, 2) mesh over ("pod", "data", "model"), 8 of 16
positions run (on (2, 2, 2) every position is its own class's
representative, so nothing would be copied): the batch over pod and data,
FSDP over data, the weights replicated over pod.
"""

import pytest

pytest.importorskip("torch")

from test_torch_dryrun_classes import _one_thread, assert_class_trace_equals_full  # noqa: E402, F401


def test_sequence_cut_decode():
    got, _ = assert_class_trace_equals_full("smollm-135m", "decode", "TP_ONLY_RULES")
    assert any(k[0] == "all-max" for ks in got["calls"].values() for k in ks)


def test_pod_axis_train_step():
    axes = ("pod", "data", "model")
    got, _ = assert_class_trace_equals_full("smollm-135m", "train", "DEFAULT_RULES", (2, 4, 2), axes)
    assert len(got["run"]) == 8
