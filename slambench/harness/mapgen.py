"""The synthetic map a global BA runs on, made from a seed.

A deployment's configuration file (`configs/<name>.json`, its "map" and
"slam" groups) fixes the shapes: the keyframe and point capacities, how many
slots are filled, the camera, the trajectory and the scene. The traffic file
(`traffic/<name>.json`) fixes what a closure hands its global BA, as
measured on a map the port itself built (`tools/mapstats.py`): how many
keyframes see a point, which observations carry a stereo match, pixel
noise, gross outliers, and the drift the global BA removes. The seed draws
the content only: which pixel and depth each point comes from, its
observers among the keyframes that see it, the noise, the outliers and the
drift. Shapes and counts do not depend on it, so neither does the work.

Everything is drawn by one `torch.Generator` on the target device, in bulk.
The arrays are the harness's own: the program's map is built from them
(`entries/global_ba.py`) and the reference reads them
(`harness/reference.py`); neither reads what the other made.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .trajectories import TRAJECTORIES

Z_MIN = 0.1          # a point is visible only in front of a camera by this much (m)
ROUNDS = 64          # draws per point before the generator gives up
CHUNK = 4096         # points per visibility block


@dataclasses.dataclass
class MapArrays:
    """A drifted map: K keyframe slots, P point slots, O = max observations
    a point. Observations are point-major, observers in keyframe order,
    -1 padded."""
    Tcw: torch.Tensor         # (K,4,4) float32 drifted world-to-camera (identity in empty slots)
    Twc_true: torch.Tensor    # (K,4,4) float64 ground truth camera-to-world
    kf_valid: torch.Tensor    # (K,) bool
    frame_id: torch.Tensor    # (K,) int32 (-1 empty)
    points: torch.Tensor      # (P,3) float32 drifted positions
    points_true: torch.Tensor  # (P,3) float64
    pt_valid: torch.Tensor    # (P,) bool
    anchor: torch.Tensor      # (P,) int64 keyframe the point was drawn from
    obs_kf: torch.Tensor      # (P,O) int64 observing keyframe (-1 pad)
    obs_uv: torch.Tensor      # (P,O,2) float32 observed pixel
    obs_ur: torch.Tensor      # (P,O) float32 observed right x (-1 mono)
    obs_level: torch.Tensor   # (P,O) int64 pyramid level
    obs_depth: torch.Tensor   # (P,O) float32 true depth (-1 where mono)
    outlier: torch.Tensor     # (P,O) bool: a gross mismatch

    @property
    def n_obs(self) -> torch.Tensor:
        return (self.obs_kf >= 0).sum(dim=1)


def _normal(g, shape, device, dtype=torch.float64):
    return torch.randn(shape, generator=g, device=device, dtype=dtype)


def _uniform(g, shape, device, lo=0.0, hi=1.0, dtype=torch.float64):
    return lo + (hi - lo) * torch.rand(shape, generator=g, device=device, dtype=dtype)


def _rodrigues(w):
    """(...,3) axis-angle -> (...,3,3), float64."""
    th = torch.linalg.norm(w, dim=-1, keepdim=True).clamp(min=1e-300)
    k = w / th
    K = torch.zeros(w.shape[:-1] + (3, 3), dtype=w.dtype, device=w.device)
    K[..., 0, 1], K[..., 0, 2] = -k[..., 2], k[..., 1]
    K[..., 1, 0], K[..., 1, 2] = k[..., 2], -k[..., 0]
    K[..., 2, 0], K[..., 2, 1] = -k[..., 1], k[..., 0]
    s, c = torch.sin(th)[..., None], torch.cos(th)[..., None]
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + s * K + (1 - c) * (K @ K)


def _inverse(T):
    R, t = T[..., :3, :3], T[..., :3, 3]
    out = torch.zeros_like(T)
    out[..., :3, :3] = R.transpose(-1, -2)
    out[..., :3, 3] = -(R.transpose(-1, -2) @ t[..., None])[..., 0]
    out[..., 3, 3] = 1.0
    return out


def keyframe_poses(cfg: dict) -> np.ndarray:
    """(n_kf, 4, 4) float64 camera-to-world poses: the configuration's
    trajectory sampled evenly over its frames."""
    mp = cfg["map"]
    traj = dict(mp["trajectory"])
    fn = TRAJECTORIES[traj.pop("kind")]
    frames = np.asarray(fn(**traj))
    n_kf = mp["keyframes"]
    idx = np.round(np.linspace(0, len(frames) - 1, n_kf)).astype(np.int64)
    return frames[idx], idx


def level_weights(slam: dict) -> np.ndarray:
    """The share of features on each pyramid level: ORB-SLAM2's per-level
    budget, proportional to (1/scale_factor)^level."""
    f = 1.0 / slam["scale_factor"]
    w = f ** np.arange(slam["n_levels"])
    return w / w.sum()


def count_table(traffic: dict, n_points: int) -> np.ndarray:
    """Observations per point for n_points points: the traffic's histogram
    of observers a point (keys "1".."12"), as exact multiplicities (the
    remainder to the smallest counts), so every seed gets the same set."""
    hist = {int(k): float(v) for k, v in traffic["observers_per_point"].items()}
    ks = sorted(hist)
    tot = sum(hist.values())
    mult = [int(math.floor(hist[k] / tot * n_points)) for k in ks]
    for i in range(n_points - sum(mult)):
        mult[i % len(ks)] += 1
    return np.repeat(np.asarray(ks, dtype=np.int64), mult)


def _depth_street(sc, g, ray, dev):
    """Depth along camera rays (z = 1) in a street canyon: the ground
    `camera_height` below, facades `half_width` to each side up to
    `facade_height` above the ground, and far structure at a uniform depth
    in [far_min, far_max] where a ray hits neither within far_max."""
    x, y = ray[:, 0], ray[:, 1]
    h, w, H = sc["camera_height"], sc["half_width"], sc["facade_height"]
    inf = torch.full_like(x, float("inf"))
    t_g = torch.where(y > 1e-9, h / y.clamp(min=1e-9), inf)
    t_f = torch.where(x.abs() > 1e-9, w / x.abs().clamp(min=1e-9), inf)
    t_f = torch.where(t_f * y >= h - H, t_f, inf)
    d = torch.minimum(t_g, t_f)
    far = _uniform(g, x.shape, dev, sc["far_min"], sc["far_max"])
    return torch.where(d <= sc["far_max"], d, far)


def _depth_relief_wall(sc, g, ray, dev, Twc):
    """Depth along camera rays to a wall `distance` ahead whose relief is
    `amplitude` * sin(2 pi x / wavelength) sin(2 pi y / wavelength) in the
    world's x and y at the flat hit."""
    d0 = sc["distance"]
    p = (Twc[:, :3, :3] @ (ray * d0)[..., None])[..., 0] + Twc[:, :3, 3]
    k = 2.0 * math.pi / sc["wavelength"]
    return d0 + sc["amplitude"] * torch.sin(k * p[:, 0]) * torch.sin(k * p[:, 1])


def _sample_points(slam, sc, g, anchors, Twc, dev, margin):
    """World points drawn from their anchor keyframes' views: a pixel
    uniform over the image inside `margin`, a depth from the scene."""
    n = anchors.shape[0]
    W, H = slam["width"], slam["height"]
    u = _uniform(g, (n,), dev, margin, W - 1 - margin)
    v = _uniform(g, (n,), dev, margin, H - 1 - margin)
    ray = torch.stack([(u - slam["cx"]) / slam["fx"], (v - slam["cy"]) / slam["fy"],
                       torch.ones_like(u)], dim=-1)
    Ta = Twc[anchors]
    if sc["kind"] == "street":
        d = _depth_street(sc, g, ray, dev)
    elif sc["kind"] == "relief_wall":
        d = _depth_relief_wall(sc, g, ray, dev, Ta)
    else:
        raise ValueError(f"unknown scene kind {sc['kind']!r}")
    pc = ray * d[:, None]
    return (Ta[:, :3, :3] @ pc[..., None])[..., 0] + Ta[:, :3, 3]


def _depths(Tcw, X):
    """(n, K) depth of each point in each keyframe, and the camera-frame
    points (n, K, 3)."""
    pc = torch.einsum("kij,nj->nki", Tcw[:, :3, :3], X) + Tcw[None, :, :3, 3]
    return pc[..., 2], pc


def _visible(slam, mp, X, Tcw, margin):
    """(n, K) bool: keyframe k sees point n: in front, inside the image by
    `margin`, nearer than max_depth."""
    z, pc = _depths(Tcw, X)
    zs = z.clamp(min=1e-9)
    u = slam["fx"] * pc[..., 0] / zs + slam["cx"]
    v = slam["fy"] * pc[..., 1] / zs + slam["cy"]
    W, H = slam["width"], slam["height"]
    return ((z > Z_MIN) & (z < mp["max_depth"]) & (u >= margin) & (u <= W - 1 - margin)
            & (v >= margin) & (v <= H - 1 - margin))


def _close_stereo(slam, X, Tcw):
    """(n,) bool: X seen by the cameras Tcw (n,4,4) nearer than th_depth
    baselines, its right-image x inside the image: a point that one
    keyframe's stereo match alone places (ORB-SLAM2 makes map points from a
    keyframe's close stereo points only)."""
    pc = (Tcw[:, :3, :3] @ X[..., None])[..., 0] + Tcw[:, :3, 3]
    z = pc[:, 2].clamp(min=1e-9)
    ur = slam["fx"] * pc[:, 0] / z + slam["cx"] - slam["bf"] / z
    return (z < slam["th_depth"] * slam["bf"] / slam["fx"]) & (ur >= 0)


def _choose_observers(mp, X, vis, anchors, want, Twc, dist, O):
    """For each point the `want` keyframes nearest its anchor (by camera
    centre) among those that see it (vis (n, K), `_visible`): a point of one
    observer is seen by its anchor alone. Returns (observers (n,O) -1
    padded, whether its rays span min_parallax_deg or it has one
    observer)."""
    score = torch.where(vis, dist[anchors], torch.full_like(dist[anchors], float("inf")))
    _, order = torch.topk(score, O, dim=1, largest=False)
    take = torch.arange(O, device=X.device)[None, :] < torch.minimum(want, vis.sum(dim=1))[:, None]
    obs = torch.where(take, order, torch.full_like(order, -1))
    # parallax: two of a point's rays at least min_parallax_deg apart
    # (ORB-SLAM2 triangulates no flatter)
    centres = Twc[:, :3, 3]
    rays = X[:, None, :] - centres[order]
    rays = rays / torch.linalg.norm(rays, dim=-1, keepdim=True).clamp(min=1e-12)
    cos = torch.einsum("noi,npi->nop", rays, rays)
    pair = take[:, :, None] & take[:, None, :]
    min_cos = torch.where(pair, cos, torch.ones_like(cos)).flatten(1).min(dim=1).values
    par_ok = (min_cos <= math.cos(math.radians(mp["min_parallax_deg"]))) | (want == 1)
    return obs, par_ok


def _table(pairs, x, scale):
    """The value of a step table [[upper edge / scale (None: open), value],
    ...] at each x."""
    out = torch.zeros_like(x)
    lo = 0.0
    for hi, val in pairs:
        hi = math.inf if hi is None else hi * scale
        out = torch.where((x >= lo) & (x < hi), torch.full_like(x, val), out)
        lo = hi
    return out


def _quantile_draw(g, q, shape, dev):
    """Draws from the distribution whose quantiles at 0, 1/n, ..., 1 are q
    (linear between them)."""
    qs = torch.as_tensor(q, dtype=torch.float64, device=dev)
    p = _uniform(g, shape, dev) * (qs.numel() - 1)
    i = p.floor().long().clamp(max=qs.numel() - 2)
    return qs[i] + (p - i) * (qs[i + 1] - qs[i])


def synthesize(cfg: dict, traffic: dict, seed: int, device) -> MapArrays:
    """The drifted map of configuration `cfg` under `traffic`, drawn from
    `seed` on `device`."""
    dev = torch.device(device)
    slam, mp = cfg["slam"], cfg["map"]
    K, P, O = slam["max_keyframes"], slam["max_map_points"], slam["ba_max_obs"]
    n_kf, n_pt = mp["keyframes"], mp["points"]
    if not (O <= n_kf <= K and 1 <= n_pt <= P):
        raise ValueError(f"fill {n_kf} keyframes / {n_pt} points outside {O}..{K} / 1..{P}")
    g = torch.Generator(device=dev)
    g.manual_seed(int(seed) % (1 << 63))
    f64 = dict(dtype=torch.float64, device=dev)

    poses_np, frames = keyframe_poses(cfg)
    Twc = torch.as_tensor(poses_np, **f64)
    Tcw = _inverse(Twc)
    centres = Twc[:, :3, 3]
    dist = torch.cdist(centres, centres)
    margin = float(traffic["image_margin_px"])

    # points: anchors spread evenly over the keyframes, counts from the
    # traffic's histogram, both in an order drawn from the seed
    counts = torch.as_tensor(count_table(traffic, n_pt), device=dev)
    counts = counts[torch.randperm(n_pt, generator=g, device=dev)]
    if int(counts.max()) > O:
        raise ValueError(f"observers_per_point reaches {int(counts.max())} > ba_max_obs {O}")
    anchors = torch.arange(n_pt, device=dev) % n_kf
    anchors = anchors[torch.randperm(n_pt, generator=g, device=dev)]

    # Rounds of draws. In each, every point not yet placed draws a position;
    # the counts not yet placed go to those points by rank (the most
    # counts to the point the most keyframes see), so the table of counts
    # stays the traffic's whatever the seed; a point whose keyframes are too
    # few for its count, or too close together, draws again.
    X = torch.zeros((n_pt, 3), **f64)
    obs = torch.full((n_pt, O), -1, dtype=torch.int64, device=dev)
    pending = torch.arange(n_pt, device=dev)
    for _ in range(ROUNDS):
        if pending.numel() == 0:
            break
        Xc = _sample_points(slam, mp["scene"], g, anchors[pending], Twc, dev, margin)
        vis = torch.cat([_visible(slam, mp, Xc[s:s + CHUNK], Tcw, margin)
                         for s in range(0, pending.numel(), CHUNK)])
        n_vis = vis.sum(dim=1)
        by_vis = torch.argsort(n_vis.clamp(max=O), stable=True)
        want = torch.empty_like(counts[pending])
        want[by_vis] = torch.sort(counts[pending]).values
        counts[pending] = want
        ok = torch.zeros_like(n_vis, dtype=torch.bool)
        for s in range(0, pending.numel(), CHUNK):
            sl = slice(s, s + CHUNK)
            oc, par_ok = _choose_observers(mp, Xc[sl], vis[sl], anchors[pending[sl]], want[sl],
                                           Twc, dist, O)
            ok[sl] = (n_vis[sl] >= want[sl]) & par_ok & \
                ((want[sl] > 1) | _close_stereo(slam, Xc[sl], Tcw[anchors[pending[sl]]]))
            obs[pending[sl]] = oc
        X[pending[ok]] = Xc[ok]
        pending = pending[~ok]
    if pending.numel():
        raise RuntimeError(f"{pending.numel()} points found too few observers in {ROUNDS} draws")
    obs, _ = torch.sort(torch.where(obs >= 0, obs, torch.full_like(obs, K)), dim=1)
    obs = torch.where(obs < K, obs, torch.full_like(obs, -1))
    on = obs >= 0
    kc = obs.clamp(min=0)

    # observations: projection, level, noise, stereo, outliers
    pc = (Tcw[kc, :3, :3] @ X[:, None, :, None])[..., 0] + Tcw[kc, :3, 3]
    z = pc[..., 2]
    u = slam["fx"] * pc[..., 0] / z + slam["cx"]
    v = slam["fy"] * pc[..., 1] / z + slam["cy"]
    lw = torch.as_tensor(level_weights(slam), **f64)
    level = torch.multinomial(lw, n_pt * O, replacement=True, generator=g).reshape(n_pt, O)
    level_sigma = slam["scale_factor"] ** level.to(torch.float64)
    sigma = traffic["pixel_sigma"] * level_sigma
    nz = _normal(g, (3, n_pt, O), dev)
    ur = u - slam["bf"] / z
    # gross outliers: their error, in sigmas of their level, drawn from the
    # traffic's quantiles
    out = on & (_uniform(g, (n_pt, O), dev) < traffic["outlier_share"])
    mag = _quantile_draw(g, traffic["outlier_sigmas"], (n_pt, O), dev) * level_sigma
    ang = _uniform(g, (n_pt, O), dev, 0.0, 2.0 * math.pi)
    du = torch.where(out, mag * torch.cos(ang), torch.zeros_like(mag))
    dv = torch.where(out, mag * torch.sin(ang), torch.zeros_like(mag))
    u_obs = (u + sigma * nz[0] + du).clamp(0.0, slam["width"] - 1.0)
    v_obs = (v + sigma * nz[1] + dv).clamp(0.0, slam["height"] - 1.0)
    ur_obs = ur + sigma * nz[2] + du
    # a stereo observation: its match found with the traffic's share at its
    # depth (in units of th_depth x baseline), inside the right image; a
    # point of one observer has its stereo match (`_close_stereo`)
    p_stereo = _table(traffic["stereo_by_depth"], z, slam["th_depth"] * slam["bf"] / slam["fx"])
    single = (counts == 1)[:, None]
    stereo = on & (ur_obs >= 0) & ((_uniform(g, (n_pt, O), dev) < p_stereo) | single)
    neg = torch.full_like(u, -1.0)

    # drift: a smooth error that vanishes at the first keyframe (held
    # fixed) and peaks mid-trajectory, as an essential-graph correction
    # leaves it, plus a jitter per keyframe (a share of the keyframes'
    # spacing); each point moves with its anchor keyframe (the correction
    # re-expresses it there), plus noise
    dr = traffic["drift"]
    length = float(torch.linalg.norm(centres[1:] - centres[:-1], dim=1).sum())
    spacing = length / max(n_kf - 1, 1)
    s = torch.linspace(0.0, 1.0, n_kf, **f64)
    bump = torch.sin(math.pi * s)[:, None]
    d_t = _normal(g, (3,), dev)
    d_r = _normal(g, (3,), dev)
    jit = _normal(g, (2, n_kf, 3), dev)
    jit[:, 0] = 0.0
    dt = bump * (dr["translation_frac"] * length) * d_t / torch.linalg.norm(d_t) \
        + dr["jitter_frac"] * spacing * jit[0]
    dw = bump * dr["rotation_rad"] * d_r / torch.linalg.norm(d_r) + dr["jitter_rad"] * jit[1]
    Twc_d = Twc.clone()
    Twc_d[:, :3, :3] = _rodrigues(dw) @ Twc[:, :3, :3]
    Twc_d[:, :3, 3] = Twc[:, :3, 3] + dt
    Tcw_d = _inverse(Twc_d)
    pa = (Tcw[anchors, :3, :3] @ X[..., None])[..., 0] + Tcw[anchors, :3, 3]
    Xd = (Twc_d[anchors, :3, :3] @ pa[..., None])[..., 0] + Twc_d[anchors, :3, 3]
    Xd = Xd + dr["point_frac"] * pa[:, 2:3] * _normal(g, (n_pt, 3), dev)

    eye = torch.eye(4, dtype=torch.float32, device=dev)
    Tcw_full = eye.repeat(K, 1, 1)
    Tcw_full[:n_kf] = Tcw_d.to(torch.float32)
    Twc_full = eye.to(torch.float64).repeat(K, 1, 1)
    Twc_full[:n_kf] = Twc
    kf_valid = torch.zeros((K,), dtype=torch.bool, device=dev)
    kf_valid[:n_kf] = True
    frame_id = torch.full((K,), -1, dtype=torch.int32, device=dev)
    frame_id[:n_kf] = torch.as_tensor(frames, dtype=torch.int32, device=dev)

    def pts(a, fill, dtype):
        full = torch.full((P,) + a.shape[1:], fill, dtype=dtype, device=dev)
        full[:n_pt] = a.to(dtype)
        return full

    f32 = torch.float32
    return MapArrays(
        Tcw=Tcw_full, Twc_true=Twc_full, kf_valid=kf_valid, frame_id=frame_id,
        points=pts(Xd, 0.0, f32), points_true=pts(X, 0.0, torch.float64),
        pt_valid=pts(torch.ones((n_pt,), dtype=torch.bool, device=dev), False, torch.bool),
        anchor=pts(anchors, -1, torch.int64), obs_kf=pts(obs, -1, torch.int64),
        obs_uv=pts(torch.where(on[..., None], torch.stack([u_obs, v_obs], -1), -1.0), -1.0, f32),
        obs_ur=pts(torch.where(stereo, ur_obs, neg), -1.0, f32),
        obs_level=pts(torch.where(on, level, torch.zeros_like(level)), 0, torch.int64),
        obs_depth=pts(torch.where(stereo, z, neg), -1.0, f32),
        outlier=pts(out, False, torch.bool))


def keyframe_major(arr: MapArrays, n_feat: int):
    """The observations as each keyframe's feature rows, for the program's
    map: (feat_point (K,N) int64 point id or -1, xy (K,N,2), ur (K,N),
    depth (K,N), level (K,N)). A keyframe's observations take its first
    slots, in point order. Raises if a keyframe sees more than n_feat."""
    K = arr.Tcw.shape[0]
    P, O = arr.obs_kf.shape
    dev = arr.obs_kf.device
    on = arr.obs_kf.reshape(-1) >= 0
    kf = arr.obs_kf.reshape(-1)[on]
    pt = torch.arange(P, device=dev).repeat_interleave(O)[on]
    flat = torch.arange(P * O, device=dev)[on]
    order = torch.argsort(kf * P + pt)
    kf, pt, flat = kf[order], pt[order], flat[order]
    per_kf = torch.bincount(kf, minlength=K)
    if int(per_kf.max()) > n_feat:
        raise RuntimeError(f"a keyframe sees {int(per_kf.max())} points, more than its "
                           f"{n_feat} feature slots")
    start = torch.cumsum(per_kf, 0) - per_kf
    slot = torch.arange(kf.numel(), device=dev) - start[kf]
    feat_point = torch.full((K, n_feat), -1, dtype=torch.int64, device=dev)
    feat_point[kf, slot] = pt
    xy = torch.zeros((K, n_feat, 2), dtype=torch.float32, device=dev)
    xy[kf, slot] = arr.obs_uv.reshape(-1, 2)[flat]
    ur = torch.full((K, n_feat), -1.0, dtype=torch.float32, device=dev)
    ur[kf, slot] = arr.obs_ur.reshape(-1)[flat]
    depth = torch.full((K, n_feat), -1.0, dtype=torch.float32, device=dev)
    depth[kf, slot] = arr.obs_depth.reshape(-1)[flat]
    level = torch.zeros((K, n_feat), dtype=torch.int64, device=dev)
    level[kf, slot] = arr.obs_level.reshape(-1)[flat]
    return feat_point, xy, ur, depth, level
