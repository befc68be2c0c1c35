"""The traced window's reductions on a hand-made trace: busy time as the
union of device intervals, time by kernel, idle gaps by the host call
that was running, kernel names matched without their templates."""

import numpy as np
import pytest

from benchmark.lib.trace import Trace, kernel_matcher, short_name


def trace():
    # device: [0, 50], [100, 200] and [150, 250] overlap, [300, 400]
    # host: "outer" [40, 290] holds "inner" [60, 90]; "x" [210, 220]
    return Trace(
        ["void band_conv_kernel<32, 27>(float*)", "k2", "k2", "k3"],
        np.array([0, 100, 150, 300]), np.array([50, 200, 250, 400]),
        ["outer", "inner", "x"], np.array([40, 60, 210]),
        np.array([290, 90, 220]))


def test_busy_is_the_union_of_device_intervals():
    t = trace()
    assert t.busy_intervals() == [(0, 50), (100, 250), (300, 400)]
    assert t.busy_s() == pytest.approx(300e-9)


def test_idle_gaps_go_to_the_innermost_running_host_call():
    # gap [50, 100] (mid 75): inner; gap [250, 300] (mid 275): outer
    assert trace().idle_gaps() == [["inner", 50e-9], ["outer", 50e-9]]


def test_device_time_by_name_and_group():
    t = trace()
    assert t.top_device_ops() == [["k2", 200e-9], ["k3", 100e-9],
                                  ["band_conv_kernel", 50e-9]]
    assert t.device_seconds(kernel_matcher(["band_conv_kernel"])) == \
        pytest.approx(50e-9)
    assert t.count_host(["x", "inner"]) == 2


def test_names_lose_templates_and_anonymous_namespaces():
    assert short_name("void (anonymous namespace)::dq_kernel<64>(int)") == \
        "dq_kernel"
    assert short_name("at::native::reduce_kernel<512, 1>") == \
        "at::native::reduce_kernel"
    assert not kernel_matcher(["band_conv_kernel"])("zband_conv_kernel")
