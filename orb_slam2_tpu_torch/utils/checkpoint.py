"""Map checkpoint / resume (port of `orb_slam2_tpu/utils/checkpoint.py`).

The reference's SaveMap/LoadMap is an unimplemented TODO
(`include/System.h:148-151`). The map is one record of tensors, so a
checkpoint is every MapState field as a compressed npz (`map_<field>`), with
any extra tracker state beside it (`extra_<key>`). The layout and the types
are the JAX package's (descriptors as uint32 words), so a map saved by
either package loads in the other.
"""
from __future__ import annotations

import numpy as np
import torch

from ..mapstate.map import OBS_W, MapState, refresh_obs_table
from .convert import _array, _tensor


def save_map(path: str, m: MapState, extra: dict | None = None):
    """Write `m` (one host copy per field) and `extra` to `path` (.npz)."""
    arrays = {f"map_{k}": _array(k, v) for k, v in m._asdict().items()}
    for k, v in (extra or {}).items():
        arrays[f"extra_{k}"] = np.asarray(v)
    np.savez_compressed(path, **arrays)


def load_map(path: str, device="cuda"):
    """The MapState of a checkpoint on `device`, and its extra entries as
    NumPy arrays. Checkpoints written before a field existed get its
    default (`loop_edges`, `pt_obs_cnt`, `pt_forward`, `obs_kf` / `obs_ft`);
    the observation table and the weighted counts are rebuilt from kf_obs
    rather than trusted from disk."""
    fields, extra = {}, {}
    with np.load(path) as data:
        for k in data.files:
            if k.startswith("map_"):
                fields[k[4:]] = _tensor(k[4:], data[k], device)
            elif k.startswith("extra_"):
                extra[k[6:]] = data[k]
    P = fields["pt_valid"].shape[0]
    i32 = dict(dtype=torch.int32, device=device)
    defaults = {"loop_edges": lambda: torch.full((32, 2), -1, **i32),
                "pt_obs_cnt": lambda: torch.zeros((P,), **i32),
                "pt_forward": lambda: torch.arange(P, **i32),
                "obs_kf": lambda: torch.full((P, OBS_W), -1, **i32),
                "obs_ft": lambda: torch.full((P, OBS_W), -1, **i32)}
    for k, make in defaults.items():
        if k not in fields:
            fields[k] = make()
    return refresh_obs_table(MapState(**fields)), extra
