"""Per-frame data record construction (port of
`orb_slam2_tpu/pipeline/frame.py`).

`Frame` (`src/Frame.cc:119-205`): ORB extraction, undistortion and the
stereo or RGB-D depth association, one function per sensor type. Images may arrive as
uint8 (gray) and uint16 (depth) tensors and are cast on their device.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..geometry import camera as camera_mod
from ..ops import extractor, stereo as stereo_ops
from ..utils.config import SlamConfig, SENSOR_STEREO, SENSOR_RGBD, device_cache


class FrameData(NamedTuple):
    xy: torch.Tensor        # (N,2) undistorted keypoint coords
    xy_raw: torch.Tensor    # (N,2) raw (distorted) coords
    level: torch.Tensor     # (N,) int32
    angle: torch.Tensor     # (N,)
    response: torch.Tensor  # (N,)
    desc: torch.Tensor      # (N,8) int32 (uint32 bits)
    valid: torch.Tensor     # (N,) bool
    ur: torch.Tensor        # (N,) stereo right-x or -1
    depth: torch.Tensor     # (N,) stereo/RGBD depth or -1

    @property
    def n(self):
        return self.valid.to(torch.int32).sum()


@device_cache()
def _camera(cfg: SlamConfig, device) -> camera_mod.Camera:
    return cfg.camera(device)


def _undistorted(kps, cfg: SlamConfig):
    # the reference undistorts only when k1 or k2 is set
    if cfg.k1 or cfg.k2:
        return camera_mod.undistort_pixels(_camera(cfg, kps.xy.device), kps.xy)
    return kps.xy


def make_frame_monocular(img, cfg: SlamConfig, init: bool = False) -> FrameData:
    """init=True doubles the extraction budget (capped at max_keypoints so
    shapes are unchanged) — the reference's initialization extractor
    `mpIniORBextractor = ORBextractor(2*nFeatures, ...)`
    (`src/Tracking.cc:188-190`)."""
    img = img.to(torch.float32)
    if init:
        cfg = dataclasses.replace(
            cfg, n_features=min(2 * cfg.n_features, cfg.max_keypoints),
            max_keypoints=cfg.max_keypoints)
    kps = extractor.extract(img, cfg)
    neg = torch.full((kps.xy.shape[0],), -1.0, device=img.device)
    return FrameData(xy=_undistorted(kps, cfg), xy_raw=kps.xy, level=kps.level,
                     angle=kps.angle, response=kps.response, desc=kps.desc,
                     valid=kps.valid, ur=neg, depth=neg)


def make_frame_stereo(img_left, img_right, cfg: SlamConfig) -> FrameData:
    """A rectified stereo pair (the reference's requirement), so raw ==
    undistorted coordinates. Each image is extracted once and its pyramid
    goes on to the SAD refinement: one K1, K2 and K3 launch per image."""
    kl, pyr_l = extractor.extract_with_pyramid(img_left.to(torch.float32), cfg)
    kr, pyr_r = extractor.extract_with_pyramid(img_right.to(torch.float32), cfg)
    ur, depth = stereo_ops.compute_stereo_matches(
        kl.xy, kl.level, kl.desc, kl.valid, kr.xy, kr.level, kr.desc, kr.valid,
        pyr_l, pyr_r, cfg.scale_factors, cfg.bf, max_disparity=cfg.fx)
    return FrameData(xy=kl.xy, xy_raw=kl.xy, level=kl.level, angle=kl.angle,
                     response=kl.response, desc=kl.desc, valid=kl.valid, ur=ur, depth=depth)


def make_frame_rgbd(img, depth_img, cfg: SlamConfig) -> FrameData:
    img = img.to(torch.float32)
    depth_img = depth_img.to(torch.float32)  # cfg.depth_map_factor rescales below
    kps = extractor.extract(img, cfg)
    xy_und = _undistorted(kps, cfg)
    ur, depth = stereo_ops.stereo_from_rgbd(
        kps.xy, xy_und, kps.valid, depth_img, cfg.bf, cfg.depth_map_factor)
    return FrameData(xy=xy_und, xy_raw=kps.xy, level=kps.level, angle=kps.angle,
                     response=kps.response, desc=kps.desc, valid=kps.valid,
                     ur=ur, depth=depth)


def make_frame(cfg: SlamConfig, img, img_right=None, depth_img=None) -> FrameData:
    if cfg.sensor == SENSOR_STEREO:
        return make_frame_stereo(img, img_right, cfg)
    if cfg.sensor == SENSOR_RGBD:
        return make_frame_rgbd(img, depth_img, cfg)
    return make_frame_monocular(img, cfg)
