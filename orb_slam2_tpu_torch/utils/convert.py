"""Carry state across from the JAX reference package.

The engine has no weights: its parameters are the config and constant
tables, and its state is the per-frame records. These functions take the
reference's objects as plain Python/NumPy data (without importing jax) and
return the port's, so a test can feed one package's intermediate state to
the other. Descriptors are uint32 words in the reference and an int32 view
of the same bits in the port.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..geometry.sim3 import Sim3
from ..mapstate.map import MapState
from ..ops.extractor import Keypoints
from ..pipeline.frame import FrameData
from ..pipeline.loop_closing import LoopState
from ..pipeline.tracking_step import TrackStepResult
from ..solvers.pose_graph import PoseGraphProblem
from ..solvers.schur_ba import BAProblem, BAResult
from .config import SlamConfig

_DROPPED = ("use_pallas",)   # the reference's kernel switch; the port dispatches by device


def config_from_jax(cfg_obj) -> SlamConfig:
    """The port's SlamConfig from a reference `SlamConfig` instance."""
    fields = dataclasses.asdict(cfg_obj)
    for k in _DROPPED:
        fields.pop(k, None)
    return SlamConfig(**fields)


_DESC = ("desc", "kf_desc", "pt_desc")   # uint32 words in the reference


def _tensor(name, value, device):
    a = np.asarray(value)
    if name in _DESC:
        a = np.ascontiguousarray(a, dtype=np.uint32).view(np.int32)
    return torch.from_numpy(np.array(a)).to(device)


def _array(name, t):
    a = t.detach().cpu().numpy()
    return a.view(np.uint32) if name in _DESC else a


def _from_numpy(cls, rec, device):
    return cls(**{f: _tensor(f, getattr(rec, f), device) for f in cls._fields})


def keypoints_from_numpy(kps, device="cuda") -> Keypoints:
    """Port `Keypoints` from a reference `Keypoints` (or any object with its
    fields as arrays)."""
    return _from_numpy(Keypoints, kps, device)


def frame_from_numpy(frame, device="cuda") -> FrameData:
    """Port `FrameData` from a reference `FrameData` (or any object with its
    fields as arrays)."""
    return _from_numpy(FrameData, frame, device)


def frame_to_numpy(frame: FrameData) -> dict:
    """The port's FrameData as a dict of NumPy arrays in the reference's
    types (descriptors back to uint32)."""
    return {f: _array(f, getattr(frame, f)) for f in FrameData._fields}


def mapstate_from_numpy(m, device="cuda") -> MapState:
    """Port `MapState` from a reference `MapState` (or any object with its
    31 fields as arrays): descriptors become the int32 view of their uint32
    words, every other field keeps its dtype."""
    return _from_numpy(MapState, m, device)


def mapstate_to_numpy(m: MapState) -> dict:
    """The port's MapState as a dict of NumPy arrays in the reference's
    types (descriptors back to uint32)."""
    return {f: _array(f, getattr(m, f)) for f in MapState._fields}


def track_result_from_numpy(res, device="cuda") -> TrackStepResult:
    """Port `TrackStepResult` from a reference one (map and frame included)."""
    return TrackStepResult(**{
        f: mapstate_from_numpy(res.m, device) if f == "m" else
        frame_from_numpy(res.frame, device) if f == "frame" else
        _tensor(f, getattr(res, f), device) for f in TrackStepResult._fields})


def track_result_to_numpy(res: TrackStepResult) -> dict:
    """The port's TrackStepResult as NumPy, the map and frame as dicts."""
    return {f: mapstate_to_numpy(res.m) if f == "m" else
            frame_to_numpy(res.frame) if f == "frame" else _array(f, getattr(res, f))
            for f in TrackStepResult._fields}


def ba_problem_from_numpy(prob, device="cuda") -> BAProblem:
    """Port `BAProblem` from a reference `BAProblem` (or any object with its
    8 fields as arrays)."""
    return _from_numpy(BAProblem, prob, device)


def ba_problem_to_numpy(prob: BAProblem) -> dict:
    """The port's BAProblem as a dict of NumPy arrays."""
    return {f: _array(f, getattr(prob, f)) for f in BAProblem._fields}


def ba_result_to_numpy(res: BAResult) -> dict:
    """The port's BAResult as a dict of NumPy arrays."""
    return {f: _array(f, getattr(res, f)) for f in BAResult._fields}


def sim3_from_numpy(g, device="cuda") -> Sim3:
    """Port `Sim3` from a reference `Sim3` (R, t, s as arrays)."""
    return _from_numpy(Sim3, g, device)


def loop_state_from_numpy(state, device="cuda") -> LoopState:
    """Port `LoopState` from a reference `LoopState` (its groups and counts
    as arrays, or None before the first detection)."""
    out = LoopState()
    if state.groups is not None:
        out.groups = _tensor("groups", state.groups, device)
        out.cons = _tensor("cons", state.cons, device)
    out.last_loop_kf_seq = int(state.last_loop_kf_seq)
    return out


def pose_graph_problem_from_numpy(prob, device="cuda") -> PoseGraphProblem:
    """Port `PoseGraphProblem` from a reference one (its Sim3 fields as
    reference `Sim3`s)."""
    return PoseGraphProblem(**{
        f: sim3_from_numpy(getattr(prob, f), device) if f in ("nodes", "edge_meas") else
        _tensor(f, getattr(prob, f), device) for f in PoseGraphProblem._fields})
