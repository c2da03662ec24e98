"""The port's spans (``pyphysim_tpu_torch/tracing.py``): nothing recorded
without a profiler; under ``torch.profiler`` the spans of the runner's
and the chain step's layer boundaries, with their parents, their
request ids and their counts, on the CPU routes of the bulk and per-key
OFDM apps."""

import collections
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from pyphysim_tpu_torch import tracing  # noqa: E402

SNRS = np.array([0.0, 10.0])
# each span's parents: a chunk's accounting runs in the point, or under a
# stop rule inside the engine.deferred span of its next chunk's dispatch
PARENT = {"engine.sweep": (None,), "engine.point": ("engine.sweep",),
          "wrapper.call": ("engine.point",), "engine.wait": ("engine.point",),
          "engine.account": ("engine.point", "engine.deferred"),
          "engine.deferred": ("engine.point",),
          "engine.overlap": ("engine.point",),
          "chain.draw": ("wrapper.call",), "chain.forward": ("wrapper.call",)}


def _bulk_runner():
    from apps.ofdm.ofdm_mc_kernel_torch import OfdmMcKernelSimulationRunner
    from pyphysim_tpu_torch.ops.mc_kernel import MonteCarloOfdmTdl
    r = OfdmMcKernelSimulationRunner(device="cpu",
                                     read_command_line_args=False)
    r.params.add("SNR", SNRS)
    r.rep_max, r.batch_size, r.tile, r.num_tiles = 16, 8, 8, 1
    r.mc = MonteCarloOfdmTdl(r.ofdm, r.channel, M=16, tile=8, device="cpu")
    r.update_progress_function_style = None
    r.batch_stop_criterion = ("bit_errors", 1e9)
    r.base_seed = 77
    return r


def _perkey_runner():
    from apps.ofdm.ofdm_tdlchannel_torch import OfdmTdlSimulationRunner
    from pyphysim_tpu_torch.chain import ChainStep
    r = OfdmTdlSimulationRunner(device="cpu", read_command_line_args=False)
    r.params.add("SNR", SNRS)
    r.rep_max, r.batch_size = 16, 16
    r.chain = ChainStep(600, 512, 52, 300, block_static=True, device="cpu")
    r.update_progress_function_style = None
    r.batch_stop_criterion = ("bit_errors", 1e9)
    r.num_stop_subchunks = 4
    r.base_seed = 78
    return r


def _traced(runner):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        runner.simulate()
    return tracing.spans(), prof


@pytest.fixture(scope="module")
def bulk():
    runner = _bulk_runner()
    recs, _ = _traced(runner)
    return runner, recs


@pytest.fixture(scope="module")
def perkey():
    runner = _perkey_runner()
    recs, prof = _traced(runner)
    return runner, recs, prof


def test_without_a_profiler_a_span_is_one_shared_object_that_records():
    before = {s: len(tracing.spans(s)) for s in tracing.sessions()}
    a = tracing.span("engine.point", base_seed=1, unpack_index=0)
    b = tracing.span("wrapper.call")
    assert a is b
    with a, tracing.span("engine.wait"):
        pass
    assert {s: len(tracing.spans(s)) for s in tracing.sessions()} == before


@pytest.mark.parametrize("route", ["bulk", "perkey"])
def test_the_spans_and_their_parents(route, request):
    recs = request.getfixturevalue(route)[1]
    names = {s.name for s in recs}
    # the per-key fixture runs one chunk a point: no chunk is deferred
    want = set(PARENT) - ({"chain.draw", "chain.forward", "engine.overlap"}
                          if route == "bulk" else {"engine.deferred"})
    assert names == want
    for s in recs:
        assert s.end_ns >= s.start_ns > 0
        parent = recs[s.parent].name if s.parent >= 0 else None
        assert parent in PARENT[s.name], s
        if parent is not None:
            up = recs[s.parent]
            assert up.start_ns <= s.start_ns and s.end_ns <= up.end_ns


@pytest.mark.parametrize("route", ["bulk", "perkey"])
def test_every_span_of_a_point_carries_its_request(route, request):
    runner, recs = request.getfixturevalue(route)[:2]
    points = [s for s in recs if s.name == "engine.point"]
    assert [s.request for s in points] == [
        (runner.base_seed, i) for i in range(len(SNRS))]
    for s in recs:
        up = s
        while up.parent >= 0 and up.name != "engine.point":
            up = recs[up.parent]
        want = up.request if up.name == "engine.point" else None
        assert s.request == want, s
    assert points[0].attrs == {"base_seed": runner.base_seed,
                               "unpack_index": 0}


def test_two_waits_a_bulk_call(bulk):
    runner, recs = bulk
    n = collections.Counter(s.name for s in recs)
    assert n["wrapper.call"] == runner.chunks_dispatched == 4
    assert n["engine.wait"] == 2 * n["wrapper.call"]
    assert n["engine.account"] == n["wrapper.call"]
    assert [s.attrs for s in recs if s.name == "wrapper.call"] == \
        [{"attempts": 8}] * 4


def test_a_bulk_chunk_is_booked_after_the_next_dispatch(bulk):
    """Under a stop rule every bulk chunk but a point's last is booked in
    one engine.deferred span, which opens after the next chunk's call and
    holds that chunk's one engine.account."""
    runner, recs = bulk
    n = collections.Counter(s.name for s in recs)
    assert n["engine.deferred"] == n["wrapper.call"] - len(SNRS) == 2
    for i, s in enumerate(recs):
        if s.name != "engine.deferred":
            continue
        inner = [r for r in recs if r.parent == i]
        assert [r.name for r in inner] == ["engine.account"]
        # the next chunk's call came after the last chunk booked
        before = [r for r in recs[:i]
                  if r.name in ("wrapper.call", "engine.account")]
        assert before[-1].name == "wrapper.call"
        assert before[-1].end_ns <= s.start_ns
        assert recs[s.parent].name == "engine.point"
    accounts = [s for s in recs if s.name == "engine.account"]
    assert sum(recs[s.parent].name == "engine.point"
               for s in accounts) == len(SNRS)      # each point's last


def test_three_waits_a_perkey_subchunk_under_a_stop_rule(perkey):
    runner, recs, _ = perkey
    n = collections.Counter(s.name for s in recs)
    subchunks = len(SNRS) * runner.num_stop_subchunks
    assert n["wrapper.call"] == runner.chunks_dispatched == subchunks
    assert n["engine.wait"] == 3 * subchunks
    # every sub-chunk but a chunk's last is accounted after the next one
    # was dispatched
    assert n["engine.overlap"] == subchunks - len(SNRS)
    assert n["chain.draw"] == n["chain.forward"] == subchunks
    assert n["engine.account"] == len(SNRS)        # one chunk a point


def test_the_profiler_holds_the_spans_beside_its_own_events(perkey):
    recs, prof = perkey[1:]
    events = collections.Counter(e.name for e in prof.events())
    for name, k in collections.Counter(s.name for s in recs).items():
        assert events[name] == k, name


def test_the_pusch_step_records_its_estimate_and_equalize_spans():
    """The PUSCH step's eager forward records ``chain.estimate`` and then
    ``chain.equalize``, each once a step, inside its ``chain.forward``,
    after its ``chain.draw``."""
    from apps.mimo.pusch_etu70_torch import etu_channel
    from pyphysim_tpu_torch.ops.streams import AttemptStreams
    from pyphysim_tpu_torch.pusch_chain import PuschChainStep
    step = PuschChainStep(2, 2, 16, 12 * 72, 128, 9, 72,
                          etu_channel(2, 2, bandwidth_hz=1.92e6,
                                      device="cpu"), 25, (0, 6),
                          ((1, 1), (1, 1)), taps_to_keep=8, device="cpu")
    streams = AttemptStreams.from_range(5, 0, 2, "cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            step.step(streams, 10.0)
    recs = tracing.spans()
    assert [r.name for r in recs] == 2 * ["chain.draw", "chain.forward",
                                          "chain.estimate", "chain.equalize"]
    for i in (0, 4):
        assert recs[i + 2].parent == recs[i + 3].parent == i + 1
        assert recs[i + 1].start_ns <= recs[i + 2].start_ns <= \
            recs[i + 2].end_ns <= recs[i + 3].start_ns <= \
            recs[i + 3].end_ns <= recs[i + 1].end_ns
    events = collections.Counter(e.name for e in prof.events())
    assert events["chain.estimate"] == events["chain.equalize"] == 2


def test_a_second_profiler_session_is_a_new_session():
    def traced_span(name):
        with profile(activities=[ProfilerActivity.CPU]):
            with tracing.span(name):
                pass
        return tracing.sessions()[-1]

    first = traced_span("engine.sweep")
    second = traced_span("engine.point")
    assert second == first + 1
    assert [s.name for s in tracing.spans(first)] == ["engine.sweep"]
    assert [s.name for s in tracing.spans()] == ["engine.point"]
    assert tracing.spans(second)[0].request == (None, None)
    tracing.clear()
    assert tracing.sessions() == [] and tracing.spans() == []


def test_each_thread_keeps_its_own_stack():
    barrier = threading.Barrier(2, timeout=30)

    def nest(name):
        with tracing.span(name):
            barrier.wait()
            with tracing.span("engine.wait"):
                barrier.wait()

    with profile(activities=[ProfilerActivity.CPU]):
        threads = [threading.Thread(target=nest, args=(n,))
                   for n in ("engine.sweep", "engine.account")]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    recs = tracing.spans()
    roots = {i: s.name for i, s in enumerate(recs) if s.parent < 0}
    assert sorted(roots.values()) == ["engine.account", "engine.sweep"]
    waits = [s for s in recs if s.name == "engine.wait"]
    assert len(waits) == 2 and {s.parent for s in waits} == set(roots)


def test_importing_the_package_and_the_module_loads_no_torch():
    code = ("import sys, pyphysim_tpu_torch, pyphysim_tpu_torch.tracing; "
            "print('torch' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=os.path.dirname(os.path.dirname(
                             os.path.abspath(__file__))))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"
