"""The benchmark's arithmetic on synthetic numbers and event lists."""
import math

import pytest

from harness import stats

MS = 1_000_000  # ns


def test_rate_is_all_the_work_over_all_the_window():
    # three items of 10 paths in a window of 4 s: the gaps count
    assert stats.rate(3 * 10, 4.0) == 7.5
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def test_p95_is_over_every_frame():
    frames = [1.0] * 95 + [5.0] * 5
    assert stats.percentile(frames, 95) == 1.0
    frames = [1.0] * 94 + [5.0] * 6
    assert stats.percentile(frames, 95) == 5.0
    # nearest rank, no interpolation, on any order
    assert stats.percentile([3, 1, 2], 50) == 2
    assert stats.percentile(list(range(1, 101)), 95) == 95


def test_union_and_idle_share():
    window = (0, 10 * MS)
    # two overlapping kernels and a copy: busy 1-4 and 6-7 ms
    dev = [("k", "kernel", 1 * MS, 3 * MS), ("k", "kernel", 2 * MS, 4 * MS),
           ("Memcpy", "copy", 6 * MS, 7 * MS),
           # outside the window: clipped away
           ("k", "kernel", 11 * MS, 12 * MS)]
    assert stats.busy_ns(dev, window) == 4 * MS
    assert stats.idle_share(dev, window) == pytest.approx(0.6)
    assert stats.kernel_ns(dev, "k", window) == 4 * MS   # 2 + 2, summed
    assert stats.kernel_ns(dev, "other", window) == 0


def test_host_ms_is_span_less_device_time_inside():
    dev = [("k", "kernel", 2 * MS, 5 * MS), ("k", "kernel", 8 * MS, 9 * MS)]
    spans = [("bench.item", 0, 6 * MS),       # 6 ms, 3 on the card
             ("bench.item", 6 * MS, 10 * MS)]  # 4 ms, 1 on the card
    assert stats.host_ms(spans, dev) == pytest.approx((3 + 3) / 2)
    assert stats.host_ms([], dev) is None


def test_breakdown_lists():
    window = (0, 10 * MS)
    dev = [("a", "kernel", 0, 4 * MS), ("b", "kernel", 5 * MS, 6 * MS),
           ("a", "kernel", 9 * MS, 10 * MS)]
    host = [("bench.item", 0, 10 * MS), ("aten::to", 4 * MS, 5 * MS),
            ("cudaLaunchKernel", 6 * MS, 6 * MS + 10),
            ("cudaDeviceSynchronize", 7 * MS, 8 * MS)]
    top = stats.top_device_ops(dev, window)
    assert top[0] == ["a", 5 * MS / 1e9] and top[1][0] == "b"
    gaps = dict((k, v) for k, v in stats.idle_gaps(dev, host, window))
    # the gap 4-5 ms is aten::to's, the innermost host event at its middle;
    # 6-9 ms has the sync at its middle, not the launch at its start
    assert gaps == pytest.approx({"aten::to": 0.001,
                                  "cudaDeviceSynchronize": 0.003})


def test_roofline_share():
    # 67e9 operations at 67e12/s take 1 ms; a kernel of 10 ms reads 10%
    assert stats.roofline_share(67e9, 67e12, 0.010) == pytest.approx(10.0)
    assert stats.roofline_share(None, 67e12, 0.01) is None
    assert stats.roofline_share(1.0, 67e12, 0.0) is None
    assert math.isfinite(stats.roofline_share(1.0, 1.0, 1.0))


class _Event:
    def __init__(self, name, annotation=False, activity=None):
        self._name, self._annotation = name, annotation
        if activity is not None:
            self.activity_type = lambda: activity

    def name(self):
        return self._name

    def is_user_annotation(self):
        return self._annotation


def test_device_events_with_and_without_an_activity_type():
    from harness.tracing import _device_kind
    # torch builds whose kineto events carry an activity type
    assert _device_kind(_Event("k", activity="kernel")) == "kernel"
    assert _device_kind(_Event("Memcpy HtoD", activity="gpu_memcpy")) == "copy"
    assert _device_kind(_Event("x", activity="gpu_user_annotation")) is None
    # and those whose events do not: the name decides
    assert _device_kind(_Event("wavefront_forward_kernel")) == "kernel"
    assert _device_kind(_Event("Memset (Device)")) == "copy"
    assert _device_kind(_Event("bench.item")) is None
    assert _device_kind(_Event("k", annotation=True)) is None
