"""Stereo EuRoC example, the analogue of `Examples/Stereo/stereo_euroc.cc`.

Usage:
  python -m orb_slam2_tpu_torch.examples.stereo_euroc <settings.yaml> <sequence_dir> [out_prefix]

If the settings YAML carries the reference's LEFT./RIGHT. calibration blocks
(EuRoC.yaml does), each pair is undistorted and rectified on the fly as
`stereo_euroc.cc` does with cv::initUndistortRectifyMap + cv::remap;
otherwise the sequence is taken as rectified.
"""
import sys

from ..geometry.rectify import StereoRectifier
from ..pipeline.system import SlamSystem
from ..utils.config import SENSOR_STEREO, SlamConfig
from ..utils.datasets import EurocStereo
from .common import run_dataset


def main(argv=None, device="cuda"):
    argv = sys.argv[1:] if argv is None else argv
    settings, seq = argv[0], argv[1]
    prefix = argv[2] if len(argv) > 2 else "stereo_euroc"
    cfg = SlamConfig.from_yaml(settings, sensor=SENSOR_STEREO)
    rect = (StereoRectifier.from_settings(settings)
            if StereoRectifier.available(settings) else None)
    ds = EurocStereo(seq, rectifier=rect)
    s = SlamSystem(cfg, device=device)
    return run_dataset(s, ds, lambda s_, f: s_.track_stereo(f[1], f[2], f[0]), prefix)


if __name__ == "__main__":
    main()
