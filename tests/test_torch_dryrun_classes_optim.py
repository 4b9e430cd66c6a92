"""The class trace against the full trace (``test_torch_dryrun_classes.py``)
for smollm-135m's train step under DEFAULT with the optimizer options on a
(2, 4) mesh of fake devices, 4 of 8 positions run: Adafactor (each
position's row and column sums all-reduced along the axes that cut the
dims they sum over, each position's own blocks of ``vr``/``vc`` written in
place), ``compress_grads`` (the scale a max over every block, all-maxed
along the axes that cut the leaf) and two microbatches (each position's
rows copied from the positions that hold them). A chunk of a collective
whose owner is not run is a stand-in there, and only the copies to and
from positions that run are made.
"""

import dataclasses

import pytest

pytest.importorskip("torch")

from test_torch_dryrun_classes import OCFG, _one_thread, assert_class_trace_equals_full  # noqa: E402, F401


def test_optimizer_options():
    ocfg = dataclasses.replace(OCFG, name="adafactor", compress_grads=True, microbatches=2)
    got, _ = assert_class_trace_equals_full("smollm-135m", "train", "DEFAULT_RULES", (2, 4), ocfg=ocfg)
    assert len(got["run"]) == 4
