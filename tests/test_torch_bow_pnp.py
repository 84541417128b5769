"""The port's vocabulary tree (`bow/vocabulary.py`), keyframe database
(`bow/database.py`) and EPnP RANSAC (`solvers/pnp.py`) against the JAX
reference on the CPU.

Tolerances, and why:
- vocabulary arrays (training, synthesis, the text reader, npz): equal;
- `transform`'s words and nodes: bit-exact (integer Hamming argmins, the
  lowest child wins a tie on both sides);
- `bow_sparse`: words exact, weights 1e-6 (float32 sums of a word's weights);
- `query_scores`: 1e-6; `detect_reloc_candidates`: masks equal;
- `ransac_pnp` with the reference's draws (`jax.random.randint` as at
  `pnp.py:165-166`, handed in as `draws=`): the same inliers. Tcw within
  1e-4 where the homography hypothesis wins (the planar scene); where an
  EPnP hypothesis wins, within 3e-3: EPnP's kernel vector is the smallest
  eigenvector of a float32 12x12 M^T M whose condition is the square of
  M's, and two LAPACKs (torch's MKL, the one jaxlib calls) part there
  by 1.8e-3 on the general scene's winner and 3.3e-4 on the outlier
  scene's, each pose within 2.5e-3 of the truth.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from orb_slam2_tpu.bow import database as jdb
from orb_slam2_tpu.bow import vocabulary as jvoc
from orb_slam2_tpu.geometry import se3 as jse3
from orb_slam2_tpu.solvers import pnp as jpnp

from orb_slam2_tpu_torch.bow import database as tdb
from orb_slam2_tpu_torch.bow import vocabulary as tvoc
from orb_slam2_tpu_torch.solvers import pnp as tpnp

torch.set_num_threads(1)
LEVEL_SIGMA2 = [1.2 ** (2 * i) for i in range(8)]
FIELDS = ("children", "centroids", "node_valid", "word_id", "word_weight")


def _clustered_desc(rng, n, n_centres=60, flips=0.06):
    """n descriptors around n_centres random ones, each bit flipped with
    probability `flips` (uint32 words)."""
    centres = rng.integers(0, 2 ** 32, (n_centres, 8), dtype=np.uint32)
    bits = np.unpackbits(centres[rng.integers(0, n_centres, n)].view(np.uint8), axis=-1)
    bits ^= (rng.random(bits.shape) < flips).astype(np.uint8)
    return np.packbits(bits, axis=-1).view(np.uint32)


def _assert_same_vocabulary(t, j):
    assert (t.k, t.depth, t.n_words) == (j.k, j.depth, j.n_words)
    for name in FIELDS:
        a, b = getattr(t, name).numpy(), np.asarray(getattr(j, name))
        if name == "centroids":
            a = a.view(np.uint32)
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.fixture(scope="module")
def trained():
    train = _clustered_desc(np.random.default_rng(0), 1600)
    return (train, tvoc.build_vocabulary(train, k=10, depth=3, device="cpu"),
            jvoc.build_vocabulary(train, k=10, depth=3))


def test_build_vocabulary_equal(trained):
    _, t, j = trained
    _assert_same_vocabulary(t, j)
    assert t.n_words > 100 and float(t.word_weight.max()) > 0


@pytest.mark.parametrize("k,depth", [(10, 4), (4, 6)])
def test_synth_vocabulary_equal(k, depth):
    _assert_same_vocabulary(tvoc.synth_vocabulary(k, depth, seed=3, device="cpu"),
                            jvoc.synth_vocabulary(k, depth, seed=3))


def test_vocabulary_files_round_trip(tmp_path, trained):
    """The ORBvoc.txt reader on a small tree the test writes itself (root,
    3 inner nodes, 6 leaves), and the npz cache in both directions."""
    rng = np.random.default_rng(5)
    lines = ["3 2 0 0"]
    parents = [0, 0, 0, 1, 1, 2, 2, 3, 3]
    for nid, parent in enumerate(parents, start=1):
        leaf = int(nid > 3)
        desc = " ".join(str(int(b)) for b in rng.integers(0, 256, 32))
        lines.append(f"{parent} {leaf} {desc} {rng.uniform(0, 3) if leaf else 0.0:.6f}")
    path = tmp_path / "voc.txt"
    path.write_text("\n".join(lines) + "\n")
    t = tvoc.load_orb_vocabulary(str(path), device="cpu")
    _assert_same_vocabulary(t, jvoc.load_orb_vocabulary(str(path)))
    assert t.n_words == 6 and t.n_nodes == 10
    _, tv, jv = trained
    tvoc.save_npz(tv, str(tmp_path / "t.npz"))
    jvoc.save_npz(jv, str(tmp_path / "j.npz"))
    _assert_same_vocabulary(tvoc.load_npz(str(tmp_path / "j.npz"), device="cpu"), jv)
    _assert_same_vocabulary(tv, jvoc.load_npz(str(tmp_path / "t.npz")))


def _transform_both(t, j, desc, valid, levels_up=2):
    got = tvoc.transform(t, torch.from_numpy(desc.view(np.int32)), torch.from_numpy(valid),
                         levels_up)
    want = jvoc.transform(j, jnp.asarray(desc), jnp.asarray(valid), levels_up)
    return got, want


@pytest.mark.parametrize("which", ["trained", "synth_10x5"])
def test_transform_and_bow_sparse(trained, which):
    rng = np.random.default_rng(7)
    train, t, j = trained
    if which != "trained":
        t, j = tvoc.synth_vocabulary(10, 5, device="cpu"), jvoc.synth_vocabulary(10, 5)
    desc = np.concatenate([train[:300], _clustered_desc(rng, 212)])
    valid = rng.random(len(desc)) < 0.9
    (w, wt, node), (jw, jwt, jnode) = _transform_both(t, j, desc, valid)
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(node.numpy(), np.asarray(jnode))
    np.testing.assert_array_equal(wt.numpy(), np.asarray(jwt))
    assert (w.numpy()[valid] >= 0).all() and (w.numpy()[~valid] == -1).all()
    sw, swt = tvoc.bow_sparse(w, wt)
    jsw, jswt = jvoc.bow_sparse(jw, jwt)
    np.testing.assert_array_equal(sw.numpy(), np.asarray(jsw))
    np.testing.assert_allclose(swt.numpy(), np.asarray(jswt), rtol=0, atol=1e-6)
    dense = tvoc.bow_vector(w, wt, t.n_words)
    np.testing.assert_allclose(dense.numpy(), np.asarray(jvoc.bow_vector(jw, jwt, j.n_words)),
                               rtol=0, atol=1e-6)
    assert abs(float(tvoc.l1_score(dense, dense)) - 1.0) < 1e-5


def _database(rng, t, j, n_kf=16, n_feat=200):
    """Both databases over n_kf keyframes: groups of 4 keyframes around a
    shared set of places, a covisibility matrix linking each group."""
    tdb_, jdb_ = tdb.BowDatabase.empty(n_kf + 4, n_feat, device="cpu"), \
        jdb.BowDatabase.empty(n_kf + 4, n_feat)
    places = [_clustered_desc(rng, n_feat, n_centres=200, flips=0.0) for _ in range(n_kf // 4)]
    rows = []
    for i in range(n_kf):
        d = places[i // 4].copy()
        d[rng.random(n_feat) < 0.3 + 0.1 * (i % 4)] = _clustered_desc(rng, n_feat)[0]
        (w, wt, _), (jw, jwt, _) = _transform_both(t, j, d, np.ones(n_feat, bool))
        tdb_ = tdb_.add(i, tvoc.bow_sparse(w, wt))
        jdb_ = jdb_.add(i, jvoc.bow_sparse(jw, jwt))
        rows.append(d)
    covis = np.zeros((n_kf + 4, n_kf + 4), np.int32)
    for i in range(n_kf):
        for k in range(n_kf):
            if i != k and i // 4 == k // 4:
                covis[i, k] = covis[k, i] = 20 + (i * 7 + k * 3) % 40
    return tdb_, jdb_, covis, places


def test_query_scores_and_reloc_candidates(trained):
    rng = np.random.default_rng(11)
    _, t, j = trained
    tdb_, jdb_, covis, places = _database(rng, t, j)
    erase = np.zeros(20, bool)
    erase[5] = True
    tdb_, jdb_ = tdb_.erase(torch.from_numpy(erase)), jdb_.erase(jnp.asarray(erase))
    n_cand = []
    for p in range(len(places)):
        q = places[p].copy()
        q[rng.random(len(q)) < 0.2] = 0
        (w, wt, _), (jw, jwt, _) = _transform_both(t, j, q, np.ones(len(q), bool))
        tq, jq = tvoc.bow_sparse(w, wt), jvoc.bow_sparse(jw, jwt)
        s, sh = tdb.query_scores(tdb_, tq)
        js, jsh = jdb.query_scores(jdb_, jq)
        np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=0, atol=1e-6)
        np.testing.assert_array_equal(sh.numpy(), np.asarray(jsh))
        mask, acc, scores = tdb.detect_reloc_candidates(tdb_, tq, torch.from_numpy(covis))
        jmask, jacc, jscores = jdb.detect_reloc_candidates(jdb_, jq, jnp.asarray(covis))
        np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
        np.testing.assert_allclose(acc.numpy(), np.asarray(jacc), rtol=0, atol=1e-5)
        cmask, cacc = tdb.detect_candidates(tdb_, tq, torch.from_numpy(erase), 0.01,
                                            torch.from_numpy(covis))
        jcmask, jcacc = jdb.detect_candidates(jdb_, jq, jnp.asarray(erase), 0.01,
                                              jnp.asarray(covis))
        np.testing.assert_array_equal(cmask.numpy(), np.asarray(jcmask))
        np.testing.assert_allclose(cacc.numpy(), np.asarray(jcacc), rtol=0, atol=1e-5)
        n_cand.append(int(mask.sum()))
        # the query's own place wins, through some member of its group
        assert mask.numpy()[4 * p:4 * p + 4].any() and not mask.numpy()[5]
    assert min(n_cand) >= 1


def _scene(rng, case):
    """The scenes of tests/test_bow_pnp_sim3.py::TestPnP: 120 points in
    general position, 150 with 27 % outliers, 120 on a plane."""
    n = 150 if case == "outliers" else 120
    if case == "planar":
        Xw = np.concatenate([rng.uniform(-3, 3, (n, 2)), np.full((n, 1), 5.0)], axis=1)
        xi = [0.25, -0.15, 0.1, 0.04, -0.06, 0.08]
    else:
        Xw = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n), rng.uniform(4, 10, n)], -1)
        xi = [0.3, -0.1, 0.2, 0.05, -0.08, 0.1] if case == "general" else \
            [0.2, 0.1, -0.1, 0.03, 0.05, -0.02]
    Xw = Xw.astype(np.float32)
    T = np.asarray(jse3.exp(jnp.asarray(xi)))
    pc = Xw @ T[:3, :3].T + T[:3, 3]
    uv = np.stack([500 * pc[:, 0] / pc[:, 2] + 320, 500 * pc[:, 1] / pc[:, 2] + 240],
                  -1).astype(np.float32)
    if case == "outliers":
        uv[:40] += rng.uniform(30, 120, (40, 2))
    level = rng.integers(0, 4, n).astype(np.int32)
    valid = rng.random(n) < 0.95
    return Xw, uv, level, valid, T


@pytest.mark.parametrize("case", ["general", "outliers", "planar"])
def test_ransac_pnp_with_the_reference_draws(case):
    Xw, uv, level, valid, T = _scene(np.random.default_rng(21), case)
    key = jax.random.PRNGKey(7)
    want = jpnp.ransac_pnp(jnp.asarray(Xw), jnp.asarray(uv), jnp.asarray(level),
                           jnp.asarray(valid), LEVEL_SIGMA2, 500.0, 500.0, 320.0, 240.0, key=key)
    # the reference's draws, recomputed as ransac_pnp makes them
    draws = jax.random.randint(key, (256, 6), 0, max(int(valid.sum()), 1))
    got = tpnp.ransac_pnp(torch.from_numpy(Xw), torch.from_numpy(uv), torch.from_numpy(level),
                          torch.from_numpy(valid), LEVEL_SIGMA2, 500.0, 500.0, 320.0, 240.0,
                          draws=torch.from_numpy(np.asarray(draws)))
    assert bool(got.ok) and bool(want.ok)
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(want.inliers))
    assert int(got.n_inliers) == int(want.n_inliers)
    tol = 1e-4 if case == "planar" else 3e-3
    np.testing.assert_allclose(got.Tcw.numpy(), np.asarray(want.Tcw), rtol=0, atol=tol)
    np.testing.assert_allclose(got.Tcw.numpy(), T, rtol=0, atol=0.03)
    if case == "outliers":
        assert got.inliers.numpy()[:40].sum() <= 2


def test_ransac_pnp_generator_draws_are_reproducible():
    """The port's own draws come from a seeded CPU generator: the same seed,
    the same result; a pose recovered on the general scene."""
    Xw, uv, level, valid, T = _scene(np.random.default_rng(22), "general")
    args = (torch.from_numpy(Xw), torch.from_numpy(uv), torch.from_numpy(level),
            torch.from_numpy(valid), LEVEL_SIGMA2, 500.0, 500.0, 320.0, 240.0)
    a = tpnp.ransac_pnp(*args, generator=torch.Generator().manual_seed(131))
    b = tpnp.ransac_pnp(*args, generator=torch.Generator().manual_seed(131))
    assert torch.equal(a.Tcw, b.Tcw) and torch.equal(a.inliers, b.inliers)
    assert bool(a.ok) and int(a.n_inliers) > 100
    np.testing.assert_allclose(a.Tcw.numpy(), T, rtol=0, atol=0.02)
