"""The port's SE(3) logarithm and quaternions (`geometry/se3.py`), its
trajectory export and evaluation (`utils/trajectory.py`) and the system's
trajectory rehoming under keyframe culling (`pipeline/system.py`) against
the JAX reference on the CPU.

Tolerances, and why:
- `so3_log` / `log` / `to_quat` / `from_quat`: 1e-6 absolute, both sides in
  float32 with the same branches (theta ~ 0 by its Taylor series, theta ~ pi
  by the diagonal formula); XLA and torch may round a transcendental one ulp
  apart;
- TUM and KITTI files: byte-equal (7 and 9 printed digits);
- `umeyama_align`, `ate_rmse`, `rpe_stats`: 1e-9, the same float64 NumPy code;
- the rehomed trajectory: the same reference keyframes and poses within 1e-6.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orb_slam2_tpu.geometry import se3 as jse3
from orb_slam2_tpu.mapstate import map as jmap
from orb_slam2_tpu.pipeline import system as jsystem
from orb_slam2_tpu.utils import config as jconfig
from orb_slam2_tpu.utils import trajectory as jtraj

from orb_slam2_tpu_torch.geometry import se3 as tse3
from orb_slam2_tpu_torch.mapstate import map as tmap
from orb_slam2_tpu_torch.pipeline import system as tsystem
from orb_slam2_tpu_torch.utils import convert
from orb_slam2_tpu_torch.utils import trajectory as ttraj

torch.set_num_threads(1)

# rotation angles at both special branches and between them
ANGLES = [0.0, 1e-7, 1e-5, 1e-3, 0.3, 1.5, 3.0, np.pi - 1e-3, np.pi - 1e-6, np.pi]


def _rotations():
    rng = np.random.default_rng(0)
    axes = rng.normal(size=(len(ANGLES), 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    w = (axes * np.asarray(ANGLES)[:, None]).astype(np.float32)
    # the rotations from one float64 Rodrigues, handed to both packages
    R = []
    for v in w.astype(np.float64):
        th = np.linalg.norm(v)
        K = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
        R.append(np.eye(3) + (np.sin(th) / th if th else 1.0) * K +
                 ((1 - np.cos(th)) / th ** 2 if th else 0.5) * K @ K)
    return np.asarray(R, np.float32)


def test_so3_log_and_log_match_reference():
    R = _rotations()
    got = tse3.so3_log(torch.from_numpy(R)).numpy()
    want = np.asarray(jse3.so3_log(jnp.asarray(R)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    rng = np.random.default_rng(1)
    T = np.tile(np.eye(4, dtype=np.float32), (len(R), 1, 1))
    T[:, :3, :3] = R
    T[:, :3, 3] = rng.normal(size=(len(R), 3)).astype(np.float32)
    np.testing.assert_allclose(tse3.log(torch.from_numpy(T)).numpy(),
                               np.asarray(jse3.log(jnp.asarray(T))), rtol=0, atol=1e-5)
    # exp(log(T)) = T away from pi and from the float32 cancellation of both
    # packages' V^-1 coefficient at small theta (inf at theta = 1e-5, 3 %
    # off at 1e-3, in both)
    rows = [0, 4, 5, 6]
    back = tse3.exp(tse3.log(torch.from_numpy(T[rows]))).numpy()
    np.testing.assert_allclose(back, T[rows], rtol=0, atol=1e-5)


def test_quaternion_round_trip_matches_reference():
    R = _rotations()
    rng = np.random.default_rng(2)
    # every branch of Shepperd's method: random rotations, and half-turns
    # about x, y and z (trace -1, the largest diagonal term picks the case)
    extra = [np.diag(d).astype(np.float32) for d in ((1, -1, -1), (-1, 1, -1), (-1, -1, 1))]
    q_rand = rng.normal(size=(20, 4))
    R = np.concatenate([R, np.asarray(extra),
                        np.asarray(jse3.from_quat(jnp.asarray(q_rand, jnp.float32)))])
    q_t = tse3.to_quat(torch.from_numpy(R)).numpy()
    q_j = np.asarray(jse3.to_quat(jnp.asarray(R)))
    np.testing.assert_allclose(q_t, q_j, rtol=0, atol=1e-6)
    R_t = tse3.from_quat(torch.from_numpy(q_t)).numpy()
    np.testing.assert_allclose(R_t, np.asarray(jse3.from_quat(jnp.asarray(q_j))), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(R_t, R, rtol=0, atol=2e-6)


def _trajectories(n=25):
    rng = np.random.default_rng(3)
    gt, est = [], []
    for i in range(n):
        T = np.eye(4)
        T[:3, :3] = np.asarray(jse3.so3_exp(jnp.asarray(rng.normal(size=3) * 0.5,
                                                        jnp.float32)), np.float64)
        T[:3, 3] = rng.normal(size=3)
        gt.append((0.1 * i, T))
        E = T.copy()
        E[:3, 3] = 1.3 * T[:3, 3] + rng.normal(size=3) * 0.01 + [0.2, -0.1, 0.05]
        est.append((0.1 * i + 0.001 * (i % 3), E))
    return gt, est


def test_tum_and_kitti_files_byte_equal(tmp_path):
    gt, est = _trajectories()
    for name, t_save, j_save in (("tum", ttraj.save_tum, jtraj.save_tum),
                                 ("kitti", ttraj.save_kitti, jtraj.save_kitti)):
        t_save(str(tmp_path / f"port.{name}"), est)
        j_save(str(tmp_path / f"ref.{name}"), est)
        assert (tmp_path / f"port.{name}").read_bytes() == (tmp_path / f"ref.{name}").read_bytes()
    got = ttraj.load_tum(str(tmp_path / "ref.tum"))
    want = jtraj.load_tum(str(tmp_path / "ref.tum"))
    assert [ts for ts, _ in got] == [ts for ts, _ in want]
    np.testing.assert_allclose(np.stack([T for _, T in got]), np.stack([T for _, T in want]),
                               rtol=0, atol=1e-6)
    # save then load gives the poses back to the file's 7 digits
    np.testing.assert_allclose(np.stack([T for _, T in got]), np.stack([T for _, T in est]),
                               rtol=0, atol=2e-6)


@pytest.mark.parametrize("with_scale", [False, True])
def test_ate_rpe_umeyama_equal(with_scale):
    gt, est = _trajectories()
    e = np.stack([T[:3, 3] for _, T in est])
    g = np.stack([T[:3, 3] for _, T in gt])
    for a, b in zip(ttraj.umeyama_align(e, g, with_scale), jtraj.umeyama_align(e, g, with_scale)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-9)
    assert abs(ttraj.ate_rmse(est, gt, with_scale) - jtraj.ate_rmse(est, gt, with_scale)) <= 1e-9
    assert ttraj.ate_rmse(est[:1], gt) == jtraj.ate_rmse(est[:1], gt) == float("inf")
    for delta in (1, 5):
        got, want = ttraj.rpe_stats(est, gt, delta), jtraj.rpe_stats(est, gt, delta)
        for k in ("rmse", "mean"):
            assert abs(got[k] - want[k]) <= 1e-9


K, P, N = 8, 128, 32


def _pose_x(tx):
    T = np.eye(4, dtype=np.float32)
    T[0, 3] = tx
    return T


def test_rehome_trajectory_matches_reference():
    """The construct of tests/test_trajectory.py: keyframes kf0 <- kf1 <-
    kf2, a frame tracked against kf2, then kf1 and kf2 culled in one batch
    and the root moved: both packages rebase the entry onto kf0 and export
    the same poses."""
    jcfg = jconfig.SlamConfig(fx=300.0, fy=300.0, cx=160.0, cy=120.0, width=320, height=240,
                              n_features=N, max_keypoints=N, sensor=jconfig.SENSOR_RGBD,
                              bf=30.0, max_keyframes=K, max_map_points=P)
    js = jsystem.SlamSystem(jcfg, enable_loop_closing=False)
    ts = tsystem.SlamSystem(convert.config_from_jax(jcfg), enable_loop_closing=False,
                            device="cpu")
    m = jmap.empty(K, P, N)
    poses = [_pose_x(0.0), _pose_x(1.0), _pose_x(2.5)]
    for i, T in enumerate(poses):
        m, _ = jmap.add_keyframe(
            m, jnp.asarray(T), jnp.zeros((N, 2)), jnp.zeros(N, jnp.int32), jnp.zeros(N),
            jnp.zeros((N, 8), jnp.uint32), jnp.full(N, -1.0), jnp.full(N, -1.0),
            jnp.zeros(N, bool), jnp.full(N, -1, jnp.int32), i, float(i))
    culled = np.zeros(K, bool)
    culled[1] = culled[2] = True
    m = m._replace(parent=m.parent.at[1].set(0).at[2].set(1),
                   kf_valid=m.kf_valid & ~jnp.asarray(culled))
    js.m = m
    ts.m = convert.mapstate_from_numpy(m, device="cpu")
    T_rel = _pose_x(3.0) @ np.linalg.inv(poses[2])
    for s, mod in ((js, jsystem), (ts, tsystem)):
        s.trajectory.append(mod.TrajectoryEntry(0.1, T_rel, 2, False))
        s.trajectory.append(mod.TrajectoryEntry(0.2, np.eye(4, dtype=np.float32), 0, False))
        s.ref_kf = 2
        s._rehome_trajectory(culled)
    assert [e.ref_kf for e in ts.trajectory] == [e.ref_kf for e in js.trajectory] == [0, 0]
    assert ts.ref_kf == js.ref_kf == 0
    for e_t, e_j in zip(ts.trajectory, js.trajectory):
        np.testing.assert_allclose(e_t.T_rel, e_j.T_rel, rtol=0, atol=1e-6)
    corr = _pose_x(-0.5)
    js.m = js.m._replace(kf_pose=js.m.kf_pose.at[0].set(jnp.asarray(corr @ poses[0])))
    ts.m = ts.m._replace(kf_pose=tmap.put_drop(ts.m.kf_pose, torch.tensor([0]),
                                               torch.from_numpy(corr @ poses[0])[None]))
    for (t1, a), (t2, b) in zip(ts.get_trajectory(), js.get_trajectory()):
        assert t1 == t2
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    np.testing.assert_allclose(ts.get_trajectory()[0][1], np.linalg.inv(_pose_x(3.0) @ corr),
                               rtol=1e-5, atol=1e-5)
