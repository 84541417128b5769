"""Stereo KITTI example, the analogue of `Examples/Stereo/stereo_kitti.cc`.

Usage:
  python -m orb_slam2_tpu_torch.examples.stereo_kitti <settings.yaml> <sequence_dir> [out_prefix]

settings.yaml can be the reference's KITTI00-02.yaml etc.
"""
import sys

from ..pipeline.system import SlamSystem
from ..utils.config import SENSOR_STEREO, SlamConfig
from ..utils.datasets import KittiStereo
from .common import run_dataset


def main(argv=None, device="cuda"):
    argv = sys.argv[1:] if argv is None else argv
    settings, seq = argv[0], argv[1]
    prefix = argv[2] if len(argv) > 2 else "stereo_kitti"
    cfg = SlamConfig.from_yaml(settings, sensor=SENSOR_STEREO)
    ds = KittiStereo(seq)
    s = SlamSystem(cfg, device=device)
    return run_dataset(s, ds, lambda s_, f: s_.track_stereo(f[1], f[2], f[0]), prefix)


if __name__ == "__main__":
    main()
