"""The port keeps its own data and its own defaults: the learned ORB
pattern is a byte-for-byte copy of the reference's file, read from the
port's directory, and the converters that carry the reference's state
across default to the card."""
import inspect
import os

import numpy as np
import pytest

import orb_slam2_tpu
import orb_slam2_tpu_torch
from orb_slam2_tpu.ops import orient_brief as jbrief
from orb_slam2_tpu_torch.ops import orient_brief as tbrief
from orb_slam2_tpu_torch.utils import convert

REF_PATTERN = os.path.join(os.path.dirname(orb_slam2_tpu.__file__), "data", "brief_pattern.npy")


def test_brief_pattern_file_is_a_copy_of_the_reference():
    with open(tbrief.BRIEF_PATTERN_PATH, "rb") as a, open(REF_PATTERN, "rb") as b:
        assert a.read() == b.read()


def test_brief_pattern_is_read_from_the_port(monkeypatch):
    port_dir = os.path.dirname(os.path.abspath(orb_slam2_tpu_torch.__file__))
    assert os.path.commonpath([tbrief.BRIEF_PATTERN_PATH, port_dir]) == port_dir
    read = []
    real_load = np.load
    monkeypatch.setattr(np, "load", lambda path, *a, **k: read.append(path) or
                        real_load(path, *a, **k))
    tbrief.brief_pattern.cache_clear()
    try:
        pat = tbrief.brief_pattern()
    finally:
        tbrief.brief_pattern.cache_clear()
    assert read == [tbrief.BRIEF_PATTERN_PATH]
    assert pat.shape == (256, 4) and pat.dtype == np.int32
    np.testing.assert_array_equal(pat, np.asarray(jbrief.brief_pattern()))


@pytest.mark.parametrize("name", ["keypoints_from_numpy", "frame_from_numpy",
                                  "mapstate_from_numpy", "track_result_from_numpy",
                                  "ba_problem_from_numpy"])
def test_converters_default_to_the_card(name):
    param = inspect.signature(getattr(convert, name)).parameters["device"]
    assert param.default == "cuda"
