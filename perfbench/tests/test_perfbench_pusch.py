"""The PUSCH route (``paths/pusch_perkey.py``) and the cell
``etu4x4.pusch``: the new files are found by their names; the check of
``correct`` at the cell's own limits on tiny CPU runs (the sound run
correct and equal to the reference, its bf16 control and each planted
equalizer or estimator fault not); the reference's imports; the
equalizer's work from shapes; the new metrics' readers on a trace made
here; a traced tiny run reading the engine's, the wrapper's and the
chain's metrics. On the card: a short run of the cell, correct, with
every metric it reports."""

import io
import json
import subprocess
import sys

import pytest

from perfbench import run
from perfbench.harness import cells, program, pusch_work, work
from perfbench.harness.trace import Trace
from perfbench.tests import tiny
from perfbench.tests.conftest import ROOT

CELL = "etu4x4.pusch"
NEW_METRICS = {"kernel.roofline.sc_mmse_eq", "pusch.equalize_share"}


@pytest.fixture(autouse=True)
def _restore_program():
    """The faults patch the program in this process: put it back."""
    import pyphysim_tpu_torch.pusch_chain as pusch_chain
    from pyphysim_tpu_torch.reference_signals import \
        LayeredOCCChannelEstimator as Est
    saved = (pusch_chain.sc_mmse_eq, Est.estimate_channel_freq_domain)
    yield
    pusch_chain.sc_mmse_eq, Est.estimate_channel_freq_domain = saved


def test_the_new_files_are_found_by_their_names():
    bench = cells.load_benchmark()
    entry = cells.cell(bench, CELL)
    wl = cells.workload(CELL)
    cfg = cells.config(entry["config"])
    assert wl["name"] == CELL and cfg["name"] == entry["config"]
    assert program.path(wl["path"]).bits_per_attempt(cfg, wl) == 230400
    for m in cells.metrics_for(bench, CELL, True):
        assert callable(cells.reader(m["name"]))


def _patch_equalizer(alter):
    import pyphysim_tpu_torch.pusch_chain as pusch_chain
    orig = pusch_chain.sc_mmse_eq
    pusch_chain.sc_mmse_eq = lambda h, y, s2, data: alter(orig, h, y, s2,
                                                          data)


def equalizer_zero_forcing():
    """The MMSE regulariser dropped: zero forcing on the estimate."""
    _patch_equalizer(lambda eq, h, y, s2, data: eq(h, y, s2 * 0, data))


def equalizer_biased():
    """The per-layer unbiasing undone: the gains read as 1."""
    def alter(eq, h, y, s2, data):
        x, gain = eq(h, y, s2, data)
        return x, gain * 0 + 1
    _patch_equalizer(alter)


def estimator_fewer_taps():
    """The estimate keeps the delays 0..10 in place of the
    configuration's: ETU's later taps cut off."""
    from pyphysim_tpu_torch.reference_signals import \
        LayeredOCCChannelEstimator as Est
    orig = Est.estimate_channel_freq_domain
    Est.estimate_channel_freq_domain = \
        lambda self, rx, keep: orig(self, rx, 10)


def test_sound_tiny_run_is_correct_and_equals_the_reference():
    res = tiny.run_tiny(CELL)
    assert res["correct"], res["compare"]
    # float32 rounding may move one decision at a slicer boundary: one
    # Gray-coded bit
    assert res["compare"]["count_gap_max"]["value"] <= 1


def test_control_is_not_correct():
    wl = cells.workload(CELL)
    res = tiny.run_tiny(CELL, dtype=wl["control_dtype"], seconds=0.1)
    assert not res["correct"], res["compare"]


@pytest.mark.parametrize("fault", [equalizer_zero_forcing, equalizer_biased,
                                   estimator_fewer_taps],
                         ids=lambda f: f.__name__)
def test_pusch_fault_is_not_correct(fault):
    fault()
    res = tiny.run_tiny(CELL, seconds=0.1)
    assert not res["correct"], res["compare"]


_REF = """
import json, sys
sys.path.insert(0, {root!r})
import perfbench.reference.pusch, perfbench.harness.pusch_work
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_the_reference_imports_nothing_of_the_program():
    out = subprocess.run([sys.executable, "-c", _REF.format(root=str(ROOT))],
                         capture_output=True, text=True, timeout=300,
                         cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    names = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not names & {"pyphysim_tpu_torch", "pyphysim_tpu", "jax", "apps"}


def test_equalizer_work_from_shapes():
    # 4 x 4: Gram 260, LDL^H 86, W's 4 solves 416, gains 64
    assert pusch_work.filter_flops(4, 4) == 826
    # 2 x 2: Gram 34, LDL^H 1 + 2 + 6, solves 2 x 20, gains 16
    assert pusch_work.filter_flops(2, 2) == 34 + 9 + 40 + 16
    assert pusch_work.equalize_flops(32, 14400, 1200, 4, 4) == \
        32 * (1200 * 826 + 14400 * 128)
    assert pusch_work.equalize_bytes(32, 14400, 1200, 4, 4) == \
        32 * (1200 * 128 + 14400 * 64 + 16)
    t = pusch_work.equalize_least_seconds(32, 14400, 1200, 4, 4)
    assert t == pytest.approx(32 * (1200 * 128 + 14400 * 64 + 16) /
                              work.PEAK_HBM_BYTES)


def _context(device_ops, calls=(32, 32)):
    bench = cells.load_benchmark()
    entry = cells.cell(bench, CELL)
    trace = Trace((0.0, 1000.0), device_ops, {})
    return cells.Context(entry, cells.workload(CELL),
                         cells.config(entry["config"]), {}, trace,
                         list(calls))


def test_the_readers_on_a_trace():
    ops = [("void (anonymous namespace)::sc_mmse_eq_kernel<4, 4>", 100.0,
            130.0), ("block_fir_kernel", 150.0, 300.0),
           ("void (anonymous namespace)::sc_mmse_eq_kernel<4, 4>", 500.0,
            530.0)]
    ctx = _context(ops)
    need = 2 * pusch_work.equalize_least_seconds(32, 14400, 1200, 4, 4)
    assert cells.reader("kernel.roofline.sc_mmse_eq")(ctx) == \
        pytest.approx(100.0 * need / 60e-6)
    assert cells.reader("pusch.equalize_share")(ctx) == pytest.approx(
        100.0 * 60.0 / 210.0)


def test_the_readers_read_nothing_without_the_equalizer():
    ctx = _context([("void (anonymous namespace)::mimo_mmse_kernel<4, 4>",
                     0.0, 10.0)])
    for name in NEW_METRICS:
        assert cells.reader(name)(ctx) is None
        ctx_none = _context([])
        ctx_none.trace = None
        assert cells.reader(name)(ctx_none) is None


# the cell's metrics that read the engine's, the wrapper's and the chain's
# spans and counters, whatever the step (not engine.overlap_share: every
# point of the cell ends in its first sub-chunk, so no sub-chunk's outputs
# are ever built behind the next one's dispatch)
SHARED = {"engine.exposed_ms_per_point", "engine.calls_per_point",
          "wrapper.host_ms_per_call", "device.idle",
          "engine.syncs_per_point", "engine.account_ms_per_chunk",
          "chain.draw_ms_per_step",
          "chain.forward_ms_per_step", "device.idle.engine",
          "device.idle.wrapper", "chain.replay_share"}
# read only on the card: its kernels, the device's busy time, and the
# replay of a captured graph
CARD_ONLY = NEW_METRICS | {"kernel.roofline.block_fir_mimo",
                           "mimo.device_ms_per_step", "chain.replay_share"}


def test_metrics_of_the_new_cells():
    bench = cells.load_benchmark()
    layer = {m["name"] for m in cells.metrics_for(bench, CELL, True)}
    assert layer == SHARED | NEW_METRICS | {"kernel.roofline.block_fir_mimo",
                                            "mimo.device_ms_per_step"}


def test_a_traced_tiny_run_reads_the_shared_metrics():
    res = tiny.run_tiny(CELL, trace=True)
    assert res["correct"], res["compare"]
    bench = cells.load_benchmark()
    want = {m["name"] for m in cells.metrics_for(bench, CELL, True)}
    assert set(res["metrics"]) == want - CARD_ONLY


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [CELL])
@pytest.mark.parametrize("trace", [0, 1])
def test_new_cell_on_the_card(cuda_card, cell, trace):
    bench = cells.load_benchmark()
    entry = cells.cell(bench, cell)
    res = run.run_cell(bench, entry, cells.workload(cell),
                       cells.config(entry["config"]), 2 ** 31 + 55, 2.0,
                       bool(trace))
    out, err = io.StringIO(), io.StringIO()
    run.emit(res, out, err)
    line = json.loads(out.getvalue())
    assert line["correct"], err.getvalue()[-2000:]
    want = {m["name"] for m in cells.metrics_for(bench, cell, bool(trace))}
    assert set(line["metrics"]) == want
    assert line["device"]["platform"] == "gpu"

