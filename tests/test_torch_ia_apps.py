"""The port's IA apps on the CPU: the kernel app
(apps/ia/ia_mc_kernel_torch.py, the runner's bulk path), the stream
selection app (apps/ia/batched_stream_selection_torch.py, the per-key
path), and the two host / batched comparison apps.

Capacity must rise with SNR, and the runners' results must not depend on
the chunk size (every attempt's bits come from its own stream): the bulk
path's sums are bitwise equal, the per-key path's within 1e-6 relative
(torch's CPU matmul may block a batch differently by its size).
"""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def _values(runner, name):
    return [float(v) for v in runner.results.get_result_values_list(name)]


def test_kernel_app_capacity_rises_and_is_chunk_invariant():
    from apps.ia.ia_mc_kernel_torch import IaMcKernelSimulationRunner

    def make(batch):
        r = IaMcKernelSimulationRunner(K=2, tile=8, lane=128, num_tiles=1,
                                       iterations=1, device="cpu",
                                       read_command_line_args=False)
        r.params.add("SNR", np.array([0.0, 15.0]))
        r.rep_max, r.batch_size = 4, batch
        r.update_progress_function_style = None
        r.simulate()
        return r

    r1, r2 = make(2), make(4)
    caps = _values(r1, "sum_capacity")
    assert caps[1] > caps[0] > 0.0, caps
    assert caps == _values(r2, "sum_capacity")
    assert (r1.chunks_dispatched, r2.chunks_dispatched) == (4, 2)
    assert (r1.mc.launch_count, r1.mc.reference_count) == (0, 4)


def test_kernel_app_bench_point_in_band():
    from apps.ia.ia_mc_kernel_torch import IaMcKernelSimulationRunner
    r = IaMcKernelSimulationRunner(tile=8, lane=128, num_tiles=1,
                                   iterations=10, device="cpu",
                                   read_command_line_args=False)
    r.params.add("SNR", np.array([10.0]))     # noise_var 0.1
    r.rep_max, r.batch_size = 1, 1
    r.update_progress_function_style = None
    r.simulate()
    assert 6.0 < _values(r, "sum_capacity")[0] < 16.0


def test_stream_selection_app():
    from apps.ia.batched_stream_selection_torch import StreamSelectionRunner

    def make(batch):
        r = StreamSelectionRunner(K=2, reps=8, iters=3, device="cpu")
        r.params.add("SNR", np.array([0.0, 20.0]))
        r.batch_size = batch
        r.simulate()
        return r

    r1, r2 = make(4), make(8)
    caps = _values(r1, "sum_capacity")
    assert caps[1] > caps[0] > 0.0, caps
    np.testing.assert_allclose(caps, _values(r2, "sum_capacity"), rtol=1e-6)
    ratios = _values(r1, "greedy_capacity_ratio")
    assert all(0.5 < x <= 1.0 + 1e-6 for x in ratios), ratios
    hist = r1.results["stream_choice"][1].get_result()
    assert len(hist) == len(r1.combos) == 4
    assert hist.sum() == pytest.approx(1.0)
    assert r1.chunks_dispatched == 2 * 2


def test_host_and_batched_comparison_apps():
    from apps.ia.ia_SINRs_and_capacity_torch import solve_all
    from apps.ia.simple_ia_torch import run
    mmse_sinrs, max_sinr_sinrs, mmse_cap, max_sinr_cap = run(
        "cpu", rep_max=1, max_iterations=20)
    assert mmse_sinrs.shape == max_sinr_sinrs.shape == (3, 2)
    assert mmse_cap > 0 and max_sinr_cap > 0
    caps = solve_all(8, 5.0, 4, device="cpu")
    assert set(caps) == {"Min. Leakage", "Max SINR", "MMSE", "Alt Min",
                         "Closed Form"}
    assert all(v.shape == (8,) and np.isfinite(v).all()
               for v in caps.values())
    # Max-SINR beats leakage minimization at 5 dB
    assert caps["Max SINR"].mean() > caps["Min. Leakage"].mean()
    with pytest.raises(ValueError, match="unknown"):
        solve_all(2, 5.0, 1, ("bogus",), device="cpu")
