"""The end-to-end metrics' arithmetic on a synthetic window holding one
stall: the tail is the tail of every point, and the rate is all the work
over the whole window."""

import numpy as np
import pytest

from perfbench.harness import cells


def _window(stall: float):
    """Ten seconds of 2 ms points of one 1e6-symbol call each, one of
    them stalled for ``stall`` seconds; a call done after the close."""
    t, calls, points = 100.0, [], []
    for i in range(10000):
        d = 0.002 + (stall if i == 1234 else 0.0)
        if t + d > 110.0:
            break
        calls.append((t, t + 0.0005, 4, 10 ** 6, t + d))
        points.append((t, t + d, 0.0))
        t += d
    calls.append((t, t + 0.0005, 4, 10 ** 6, 110.5))     # after the close
    points.append((t, 110.5, 0.0))
    return {"t0": 100.0, "t_end": 110.0, "seconds": 10.0, "calls": calls,
            "points": points, "setup_s": 1.0}


def _read(name, host):
    return cells.reader(name)(cells.Context({}, {}, {}, host))


@pytest.mark.parametrize("stall", [0.0, 0.5])
def test_rate_is_all_work_over_the_whole_window(stall):
    host = _window(stall)
    done = len(host["calls"]) - 1
    assert _read("sym_rate", host) == pytest.approx(done * 1e6 / 10.0)
    assert _read("point_ms", host) == pytest.approx(10.0 * 1e3 / done)


def test_the_stall_costs_the_rate_what_it_took():
    calm, stalled = _window(0.0), _window(0.5)
    lost = _read("sym_rate", calm) - _read("sym_rate", stalled)
    assert lost == pytest.approx(0.5 / 0.002 * 1e6 / 10.0, rel=0.01)


def test_the_tail_is_of_every_point():
    host = _window(0.0)
    # one point in 10 slow: the 95th percentile lands among them
    points = [(a, b + (0.05 if i % 10 == 0 else 0.0), s)
              for i, (a, b, s) in enumerate(host["points"][:-1])]
    host["points"] = points
    durations = [b - a for a, b, _ in points]
    p95 = _read("point_ms_p95", host)
    assert p95 == pytest.approx(np.percentile(durations, 95) * 1e3)
    stalled = _window(0.5)
    assert _read("point_ms_p95", stalled) == pytest.approx(2.0, rel=1e-6)
    # the stalled point is in the window: it is the maximum
    assert max(b - a for a, b, _ in stalled["points"][:-1]) == \
        pytest.approx(0.502)


def test_the_host_probe_counts_the_collectors_pauses():
    import gc

    from perfbench.harness.window import HostProbe
    probe = HostProbe()
    gc.collect()
    out = probe.stop()
    assert out["gc_runs"][2] >= 1 and out["gc_s"] > 0
    assert probe._gc not in gc.callbacks
    assert out["cpu_s"] > 0
    for key in ("on_cpu_s", "wait_s", "preempted", "steal_s"):
        assert out.get(key, 0) >= 0
