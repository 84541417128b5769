"""The port's monocular TUM example against the JAX package's on the same
sequence on disk (the pattern and bounds of tests/test_torch_examples.py:
320x240, 6 frames, the reference's RANSAC draws handed to the port's
initializer, the keypoint capacity 1024)."""
from orb_slam2_tpu_torch.examples import mono_tum

from test_torch_examples import check_example, write_tum_mono


def test_mono_tum_matches_reference(tmp_path):
    check_example(tmp_path, write_tum_mono, mono_tum.main, "mono_tum.py")
