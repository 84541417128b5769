"""The port's entry points in the style of `__graft_entry__.py`
(`orb_slam2_tpu_torch/graft_entry.py`) on the CPU: `entry()`'s extractor
against the JAX entry's on the same image (the keypoints equal), and
`dryrun_multichip` over gloo at one rank (the sharded global BA and
essential graph) and at two (rank 0 also runs the tracking / mapping split:
SlamSystem streaming at depth 2 with its mapping passes on a worker
thread)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orb_slam2_tpu.ops import extractor as jex
from orb_slam2_tpu.utils.config import SlamConfig as JConfig

from orb_slam2_tpu_torch import graft_entry

torch.set_num_threads(2)


def test_entry():
    fn, (img,) = graft_entry.entry(device="cpu")
    assert img.shape == (480, 640) and img.device.type == "cpu"
    xy, desc, valid = fn(img)
    ref = jex.extract(jnp.asarray(img.numpy()), JConfig(n_features=1000, width=640, height=480,
                                                        use_pallas=0))
    v = np.asarray(ref.valid)
    np.testing.assert_array_equal(valid.numpy(), v)
    np.testing.assert_array_equal(xy.numpy()[v], np.asarray(ref.xy)[v])
    assert int(valid.sum()) == 1000 and desc.shape[1] == 8


@pytest.mark.parametrize("n", [1, 2])
def test_dryrun_multichip(n, capsys):
    graft_entry.dryrun_multichip(n, device="cpu")
    out = capsys.readouterr().out
    assert f"dryrun_multichip({n})" in out and ("split" in out) == (n >= 2)
