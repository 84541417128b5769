"""RGB-D TUM example, the analogue of `Examples/RGB-D/rgbd_tum.cc`.

Usage:
  python -m orb_slam2_tpu_torch.examples.rgbd_tum <settings.yaml> <sequence_dir> \
      [association_file] [out_prefix]
"""
import sys

from ..pipeline.system import SlamSystem
from ..utils.config import SENSOR_RGBD, SlamConfig
from ..utils.datasets import TumRGBD
from .common import run_dataset


def main(argv=None, device="cuda"):
    argv = sys.argv[1:] if argv is None else argv
    settings, seq = argv[0], argv[1]
    assoc = argv[2] if len(argv) > 2 else None
    prefix = argv[3] if len(argv) > 3 else "rgbd_tum"
    cfg = SlamConfig.from_yaml(settings, sensor=SENSOR_RGBD)
    ds = TumRGBD(seq, assoc)
    s = SlamSystem(cfg, device=device)
    return run_dataset(s, ds, lambda s_, f: s_.track_rgbd(f[1], f[2], f[0]), prefix)


if __name__ == "__main__":
    main()
