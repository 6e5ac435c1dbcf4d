"""The trace arithmetic on a made-up window of two steps."""

from benchmark.trace import Trace, union_ns


def _trace():
    t = Trace(steps=2, window_s=1.0)
    # Device: two overlapping kernels, a gap of 100, a copy, a gap of 300, a K1 kernel.
    t.device = [(0, 50, "gemm"), (40, 100, "elementwise"), (200, 210, "Memcpy HtoD"),
                (510, 530, "k1::skinny::gates_kernel")]
    t.device_corr = [1, 2, 3, 4]
    t.launches = [(0, 1), (30, 2), (150, 3), (480, 4)]
    t.host_ops = [(0, 600, "step"), (140, 160, "aten::copy_"), (470, 500, "aten::mm")]
    return t


def test_busy_is_the_union_of_intervals():
    t = _trace()
    assert union_ns(t.device) == [(0, 100), (200, 210), (510, 530)]
    assert t.busy_s() == 130 / 1e9
    assert t.launch_count() == 4
    assert t.device_s(lambda n: "k1::" in n) == 20 / 1e9


def test_top_ops_per_step_and_gaps_by_host_op():
    t = _trace()
    assert t.top_ops(1) == [["elementwise", 60 / 1e9 / 2]]
    assert t.idle_gaps(2) == [["aten::mm", 300 / 1e9], ["aten::copy_", 100 / 1e9]]
