"""The per-message loop of ``generic_bench_app`` on route D
(``configurations/corridor.json``: the fast tracker, one frame-kernel step
a message) over the first ``FRAMES`` corridor frames: the JAX package (its
Pallas frame kernel in interpret mode) against the port (the kernel's
plain version). Variables, factors, closures and relocalizations must be
EQUAL after every frame. Counts only: the poses of the two runs differ by
millimetres (two implementations of the frame step's sums), which
``tests/message_loop_witness.py`` prints over a longer prefix."""

from tests.message_loop_witness import compare, run_package

FRAMES = 30


def test_route_d_graph_counters_equal_jax_after_every_frame():
    r = compare(run_package("srrg2_laser_slam_2d_tpu", FRAMES, "D"),
                run_package("srrg2_laser_slam_2d_tpu_torch", FRAMES, "D"))
    assert r["frames"] == [FRAMES, FRAMES]
    assert r["first_counter_difference"] is None, r
    assert r["end"]["torch"]["variables"] >= 3, r      # the loop split the local map
