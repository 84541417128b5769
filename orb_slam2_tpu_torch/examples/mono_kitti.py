"""Monocular example, the analogue of `Examples/Monocular/mono_kitti.cc`.

Usage:
  python -m orb_slam2_tpu_torch.examples.mono_kitti <settings.yaml> <sequence_dir> [out_prefix]

sequence_dir is a KITTI odometry sequence (image_0/ + times.txt); settings.yaml can be the reference's own KITTI00-02.yaml.
"""
import sys

from ..pipeline.system import SlamSystem
from ..utils.config import SENSOR_MONOCULAR, SlamConfig
from ..utils.datasets import KittiMonocular
from .common import run_dataset


def main(argv=None, device="cuda"):
    argv = sys.argv[1:] if argv is None else argv
    settings, seq = argv[0], argv[1]
    prefix = argv[2] if len(argv) > 2 else "mono_kitti"
    cfg = SlamConfig.from_yaml(settings, sensor=SENSOR_MONOCULAR)
    ds = KittiMonocular(seq)
    s = SlamSystem(cfg, device=device)
    return run_dataset(s, ds, lambda s_, f: s_.track_monocular(f[1], f[0]), prefix)


if __name__ == "__main__":
    main()
