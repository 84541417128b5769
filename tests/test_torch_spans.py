"""The port's spans and counters (`utils/spans.py`) in its global BA, on the
CPU: a small PCG global BA through `loop_closing.run_global_ba` (PCG forced
by a small DENSE_GBA_BYTES) under `spans.recording()` and a CPU profile.
The span tree and each span's count per chunk, the LM counters against the
answer, the answer bit for bit with recording on and off, and nothing
recorded, launched or allocated with recording off."""
import contextlib
import threading

import numpy as np
import pytest
import torch

from orb_slam2_tpu_torch.mapstate import map as mapstate
from orb_slam2_tpu_torch.pipeline import loop_closing
from orb_slam2_tpu_torch.pipeline.frame import _camera
from orb_slam2_tpu_torch.solvers import pcg_ba, schur_ba
from orb_slam2_tpu_torch.utils import spans
from orb_slam2_tpu_torch.utils.config import SlamConfig, SENSOR_RGBD

K, P, N = 8, 128, 128
FX = 300.0
N_ITERS = 3
CPU = torch.device("cpu")

# each span of a PCG chunk: (its parent, times a chunk)
TREE = {"loop_closing.global_ba": (None, 1),
        "loop_closing.ba_problem": ("loop_closing.global_ba", 1),
        "solvers.pcg": ("loop_closing.global_ba", 1),
        "solvers.pcg.edges": ("solvers.pcg", 1),
        "solvers.assemble": ("solvers.pcg", 1 + N_ITERS),
        "solvers.pcg.precompute": ("solvers.pcg", N_ITERS),
        "solvers.pcg.step": ("solvers.pcg", N_ITERS),
        "solvers.pcg.cg": ("solvers.pcg.step", N_ITERS)}


def _cfg():
    return SlamConfig(fx=FX, fy=FX, cx=160.0, cy=120.0, width=320, height=240, n_features=N,
                      max_keypoints=N, sensor=SENSOR_RGBD, bf=FX * 0.1, max_keyframes=K,
                      max_map_points=P)


def _map(seed: int, outliers: float):
    """K keyframes 0.2 m apart along x, each seeing all P points (feature i
    is point i) with 0.5 px of noise and a share `outliers` of its
    observations moved by ~80 px; every keyframe but the first drifted by
    2 cm, every point by 2 cm."""
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-1.0, 2.4, P), rng.uniform(-0.8, 0.8, P),
                  rng.uniform(3.0, 6.0, P)], -1)
    m = mapstate.empty(K, P, N, device=CPU)
    f32 = lambda a: torch.tensor(a, dtype=torch.float32)
    slots = []
    for k in range(K):
        T = np.eye(4)
        T[0, 3] = -0.2 * k
        Xc = X + T[:3, 3]
        uv = np.stack([FX * Xc[:, 0] / Xc[:, 2] + 160, FX * Xc[:, 1] / Xc[:, 2] + 120], -1)
        uv += rng.normal(0, 0.5, uv.shape)
        bad = rng.random(P) < outliers
        uv[bad] += rng.normal(0, 80, (int(bad.sum()), 2))
        if k:
            T[:3, 3] += rng.normal(0, 0.02, 3)
        m, slot = mapstate.add_keyframe(
            m, f32(T), f32(uv), torch.zeros(N, dtype=torch.int32), torch.zeros(N),
            torch.zeros((N, 8), dtype=torch.int32), f32(uv[:, 0] - FX * 0.1 / Xc[:, 2]),
            f32(Xc[:, 2]), torch.ones(N, dtype=torch.bool), torch.full((N,), -1, dtype=torch.int32),
            k, float(k))
        slots.append(slot)
    ids = mapstate.allocate_points(m, torch.ones(P, dtype=torch.bool))
    zero = torch.zeros(P, dtype=torch.int64)
    m = mapstate.add_points(m, ids, f32(X + rng.normal(0, 0.02, X.shape)),
                            torch.zeros((P, 8), dtype=torch.int32), zero, zero)
    for slot in slots:
        m = mapstate.bind_observations(m, slot, torch.arange(N, dtype=torch.int32), ids,
                                       torch.ones(N, dtype=torch.bool))
    return _cfg(), m


def _chi2(cfg, m) -> float:
    """The total chi2 of the global BA's edges at the map's state."""
    prob = loop_closing.global_ba_problem(cfg, m)
    res = pcg_ba.solve_ba_pcg(_camera(cfg, CPU), prob, cfg.level_sigma2, n_iters=0)
    return float(res.chi2[schur_ba._weights(prob, cfg.level_sigma2)[1]].sum())


@pytest.fixture
def pcg(monkeypatch):
    monkeypatch.setattr(loop_closing, "DENSE_GBA_BYTES", 0)


def _profiled(cfg, m, chunks: int, record: bool):
    """`chunks` chained global BAs under a CPU profile, recording or not:
    (the map, the profile's events, the counters)."""
    spans.counts()
    rec = spans.recording() if record else contextlib.nullcontext()
    with rec, torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(chunks):
            m = loop_closing.run_global_ba(cfg, m, n_iters=N_ITERS)
    return m, prof.events(), spans.counts()


def _program_spans(events):
    return [e for e in events if e.name in TREE]


@pytest.mark.parametrize("chunks", [1, 2])
def test_span_tree_per_chunk(pcg, chunks):
    cfg, m = _map(0, 0.0)
    _, events, _ = _profiled(cfg, m, chunks, True)
    got = _program_spans(events)
    for name, (parent, per_chunk) in TREE.items():
        mine = [e for e in got if e.name == name]
        assert len(mine) == per_chunk * chunks, name
        for e in mine:
            holders = [h for h in got if h is not e and h.time_range.start <= e.time_range.start
                       and e.time_range.end <= h.time_range.end]
            inner = max(holders, key=lambda h: h.time_range.start, default=None)
            assert (inner.name if inner else None) == parent, name
    assert len(got) == 17 * chunks


@pytest.mark.parametrize("seed,outliers,kept", [(0, 0.0, "all"), (1, 0.3, "some"),
                                                (0, 0.6, "none")])
def test_lm_counters_against_the_answer(pcg, seed, outliers, kept):
    """lm_tried is the LM steps run; lm_kept is 0 where the answer is the
    input unchanged and at least 1 where the total chi2 fell."""
    cfg, m = _map(seed, outliers)
    out, _, c = _profiled(cfg, m, 1, True)
    assert c["solvers.pcg.lm_tried"] == N_ITERS
    unchanged = torch.equal(out.kf_pose, m.kf_pose) and torch.equal(out.pt_pos, m.pt_pos)
    fell = _chi2(cfg, out) < _chi2(cfg, m)
    n = c["solvers.pcg.lm_kept"]
    assert {"all": n == N_ITERS and fell, "some": 0 < n < N_ITERS and fell,
            "none": n == 0 and unchanged}[kept], (n, unchanged, fell)
    assert unchanged != fell


def test_answers_bit_identical_with_recording_on_and_off(pcg):
    cfg, m = _map(2, 0.3)
    on, _, _ = _profiled(cfg, m, 2, True)
    off, _, _ = _profiled(cfg, m, 2, False)
    assert torch.equal(on.kf_pose, off.kf_pose) and torch.equal(on.pt_pos, off.pt_pos)


def test_recording_off_leaves_no_span_and_no_count(pcg):
    cfg, m = _map(0, 0.0)
    _, events, c = _profiled(cfg, m, 1, False)
    assert _program_spans(events) == [] and c == {}
    assert spans.span("a") is spans.span("b")


def test_off_span_and_count_launch_sync_and_allocate_nothing():
    """With recording off, a span and a count of a tensor do no tensor
    work: the profile, with memory, holds no event at all."""
    flag = torch.ones((), dtype=torch.bool)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU],
                                profile_memory=True) as prof:
        with spans.span("solvers.pcg.cg"):
            spans.count("solvers.pcg.lm_kept", flag)
            spans.count("solvers.pcg.lm_tried")
    assert list(prof.events()) == []
    assert spans.counts() == {}


def test_counts_read_once_and_reset():
    """Counters sum whole numbers and tensors, only while recording, and
    reset when read; nested recording stays on until the outer one ends."""
    spans.counts()
    with spans.recording():
        spans.count("a")
        spans.count("a", torch.tensor(True))
        with spans.recording():
            spans.count("b", torch.tensor(5))
        spans.count("b", 2)
    spans.count("a", 100)
    assert spans.counts() == {"a": 2, "b": 7}
    assert spans.counts() == {}


def test_recording_holds_for_its_own_thread_only():
    """A thread that runs while another records, or that was started
    inside recording(), records nothing: spans and counts stay off there."""
    seen = []

    def work():
        seen.append(spans.span("x") is spans.span("y"))
        spans.count("other_thread")

    spans.counts()
    with spans.recording():
        t = threading.Thread(target=work)
        t.start()
        t.join()
        spans.count("mine")
    assert seen == [True]
    assert spans.counts() == {"mine": 1}
