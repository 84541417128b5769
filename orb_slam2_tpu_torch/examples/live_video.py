"""Live / offline video example, the analogue of the fork's
`Examples/myvideo/myvideo.cpp` (OpenCV VideoCapture + monocular SLAM).
OpenCV is imported when a capture opens.

Usage:
  python -m orb_slam2_tpu_torch.examples.live_video <settings.yaml> [video_path_or_camera_index]
"""
import sys

from ..pipeline.system import SlamSystem
from ..utils.config import SENSOR_MONOCULAR, SlamConfig
from .common import run_sequence


def frames_from_capture(src):
    import cv2

    cap = cv2.VideoCapture(int(src) if str(src).isdigit() else src)
    fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
    i = 0
    try:
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            gray = cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY).astype("float32")
            yield i / fps, gray
            i += 1
    finally:
        cap.release()


def main(argv=None, device="cuda"):
    argv = sys.argv[1:] if argv is None else argv
    settings = argv[0]
    src = argv[1] if len(argv) > 1 else 0
    cfg = SlamConfig.from_yaml(settings, sensor=SENSOR_MONOCULAR)
    s = SlamSystem(cfg, device=device)
    run_sequence(s, frames_from_capture(src), lambda s_, f: s_.track_monocular(f[1], f[0]),
                 save_prefix="live")
    return s


if __name__ == "__main__":
    main()
