"""The work counts behind `solver.roofline` and `kernels.k9_roofline`,
against sums written out by hand."""
import pytest

from slambench.harness import counts

S = counts.Shapes(edges=10, points=4, free_cams=2, cam_slots=3, point_slots=5, edge_pairs=20)


def test_bound_is_the_slower_of_bytes_and_operations():
    assert counts.bound_s(3.35e12, 0) == (1.0, "bytes")
    assert counts.bound_s(0, 67e12) == (1.0, "operations")
    assert counts.bound_s(3.35e12, 2 * 67e12) == (2.0, "operations")


def test_k9_bytes():
    # 105 a padded edge, 50 a point slot, 156 a camera slot, 4 for err
    assert counts.ba_assemble_bytes(196608, 16384, 128) == \
        105 * 196608 + 50 * 16384 + 156 * 128 + 4 == 21_483_012


def test_assembly():
    # per edge 24 in + 72 (W_e) out; per free camera 12 in + 27 out floats;
    # per point 3 in + 9 out floats; 600 operations an edge
    assert counts.assembly(S) == (10 * 96 + 2 * 39 * 4 + 4 * 12 * 4, 6000)


def test_pcg_step():
    passes = 50 + 2
    b = passes * (10 * 72 + (4 * 3 + 2 * 6) * 4)
    o = passes * (10 * 72 + 4 * 18 + 2 * 72) + 4 * 60 + 2 * 400
    assert counts.pcg_step(S, 50) == (b, o)


def test_only_the_pcg_step_is_counted():
    with pytest.raises(ValueError):
        counts.global_ba(S, "dense", chunks=4, iters=3, cg_iters=0)


def test_global_ba_is_chunks_of_linearizations_and_steps():
    a_b, a_o = counts.assembly(S)
    s_b, s_o = counts.pcg_step(S, 50)
    state = (2 * 12 + 4 * 3) * 4 * 2
    b, o = counts.global_ba(S, "pcg", chunks=4, iters=3, cg_iters=50)
    assert b == 4 * (4 * a_b + 3 * s_b + state)
    assert o == pytest.approx(4 * (4 * a_o + 3 * s_o))
