"""The class trace against the full trace (``test_torch_dryrun_classes.py``)
for smollm-135m's train step under DEFAULT with the optimizer options on a
(2, 4) mesh of fake devices, 4 of 8 positions run: Adafactor (each block's
row and column sums copied to the first position and added there, the
whole ``vr``/``vc`` written back to every position), ``compress_grads``
(the scale a max over every block) and two microbatches. A block whose
first position is not run is a stand-in there, and only its copies to and
from the first position run.
"""

import dataclasses

import pytest

pytest.importorskip("torch")

from test_torch_dryrun_classes import OCFG, _one_thread, assert_class_trace_equals_full  # noqa: E402, F401


def test_optimizer_options():
    ocfg = dataclasses.replace(OCFG, name="adafactor", compress_grads=True, microbatches=2)
    got, _ = assert_class_trace_equals_full("smollm-135m", "train", "DEFAULT_RULES", (2, 4), ocfg=ocfg)
    assert len(got["run"]) == 4
