"""The per-key runner's gated sub-chunks on the card (``cuda``-marked).

The flagship ``ChainStep`` (9,600 symbols an attempt) and the 4x4
``MimoChainStep``, under the stop rule of 1e4 bit errors in sub-chunks of
32 attempts at 0, 20 and 40 dB: the executor, which gates each sub-chunk
on one fetch and dispatches the next before its bookkeeping, makes the
calls, counts the bit errors and keeps the Results of the sequential order
(``torch_runner_checks.py``) bit for bit; under the profiler each
sub-chunk waits for the device once."""

import collections
import gc

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pyphysim_tpu_torch import tracing  # noqa: E402
from torch_runner_checks import use_sequential_executor  # noqa: E402

SNRS_DB = np.array([0.0, 20.0, 40.0])


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


def _runner(step, chain=None):
    """The step's app runner at the benchmark's chunking, its calls logged
    as ``(point, attempts, counts)`` device tensors (read after the
    sweep, so that the log adds no wait)."""
    if step == "flagship":
        from apps.ofdm.ofdm_tdlchannel_torch import OfdmTdlSimulationRunner
        from pyphysim_tpu_torch.chain import ChainStep
        r = OfdmTdlSimulationRunner(device="cuda",
                                    read_command_line_args=False)
        r.chain = chain or ChainStep(9600, 512, 52, 300, block_static=True,
                                     device="cuda")
    else:
        from apps.mimo.mimo_ofdm_tdl_torch import MimoOfdmTdlSimulationRunner
        r = MimoOfdmTdlSimulationRunner(device="cuda",
                                        read_command_line_args=False,
                                        chain=chain)
    r.params.add("SNR", SNRS_DB)
    r.params.set_unpack_parameter("SNR")
    r.rep_max, r.batch_size, r.num_stop_subchunks = 4096, 256, 8
    r.batch_stop_criterion = ("bit_errors", 10000.0)
    r.update_progress_function_style = None
    r.base_seed = 2 ** 31 + 77
    r.calls = []
    make = r._gen_simulation_kernel

    def logged(params):
        kernel = make(params)

        def run(streams):
            out = kernel(streams)
            r.calls.append((params.unpack_index, streams.attempts,
                            out["bit_errors"]))
            return out
        return run

    r._gen_simulation_kernel = logged
    return r


def _summary(r):
    res = r.results
    return {name: [float(v) for v in res.get_result_values_list(name)]
            for name in ("bit_errors", "ber", "num_skipped_reps")} | {
        "runned_reps": list(r.runned_reps),
        "calls": [(p, int(a[0]), int(a.shape[0])) for p, a, _ in r.calls]}


@pytest.mark.cuda
@pytest.mark.parametrize("step", ["flagship", "mimo4x4"])
def test_gated_subchunks_are_the_sequential_order_on_the_card(step):
    _needs_card()
    # the runners' reference cycles hold the step's CUDA graphs: collect
    # them here, not inside a later capture (where freeing a graph
    # invalidates the capture)
    gc.collect()
    try:
        _check_gated_subchunks(step)
    finally:
        gc.collect()


def _check_gated_subchunks(step):
    from torch.profiler import ProfilerActivity, profile
    want = use_sequential_executor(_runner(step))
    want.simulate()
    got = _runner(step, chain=want.chain)
    got.simulate()
    assert _summary(got) == _summary(want)
    for (_, _, g), (_, _, w) in zip(got.calls, want.calls):
        assert torch.equal(g, w)
    assert max(p for p, _, _ in got.calls) == len(SNRS_DB) - 1
    assert len(got.calls) > len(SNRS_DB)     # 40 dB runs several

    traced = _runner(step, chain=want.chain)
    with profile(activities=[ProfilerActivity.CPU]):
        traced.simulate()
    n = collections.Counter(s.name for s in tracing.spans())
    assert n["wrapper.call"] == len(traced.calls) == len(got.calls)
    assert n["engine.wait"] == n["wrapper.call"]
    assert 0 < n["engine.overlap"] < n["wrapper.call"]
    assert _summary(traced) == _summary(want)
