"""The MIMO-OFDM route (``paths/mimo_perkey.py``) and the cell
``eva4x4.perkey``: the check of ``correct`` at the cell's own limits on
tiny CPU runs (the sound run correct, the bf16 control and each planted
detector fault not), the reference's imports, the detector's and the MIMO
block FIR's work from shapes, the new metrics' readers on a trace made
here, and a traced tiny run reading the engine's, the wrapper's and the
chain's metrics. On the card: a short run of the cell through the
command's own entry, correct, with every metric the cell reports."""

import io
import json
import subprocess
import sys

import pytest

from perfbench import run
from perfbench.harness import cells, mimo_work, work
from perfbench.harness.trace import Trace
from perfbench.tests import tiny
from perfbench.tests.conftest import ROOT

CELL = "eva4x4.perkey"


@pytest.fixture(autouse=True)
def _restore_program():
    """The faults patch the program in this process: put it back."""
    import pyphysim_tpu_torch.mimo_chain as mimo_chain
    from pyphysim_tpu_torch.ops.mc_kernel import MonteCarloOfdmTdl
    saved = (mimo_chain.mimo_mmse, MonteCarloOfdmTdl.build)
    yield
    mimo_chain.mimo_mmse, MonteCarloOfdmTdl.build = saved


def _patch_detector(alter):
    import pyphysim_tpu_torch.mimo_chain as mimo_chain
    orig = mimo_chain.mimo_mmse
    mimo_chain.mimo_mmse = lambda h, y, sent, s2, M: alter(orig, h, y,
                                                           sent, s2, M)


def detector_zero_forcing():
    """The MMSE regulariser dropped: zero forcing."""
    _patch_detector(lambda det, h, y, sent, s2, M: det(h, y, sent, s2 * 0,
                                                       M))


def detector_drops_a_layer():
    """The last layers neither detected nor counted: 4 x 4 detected as
    4 x 2 (a shape the detector is built for)."""
    _patch_detector(lambda det, h, y, sent, s2, M: det(
        h[:, :, :2].contiguous(), y, sent[:, :2].contiguous(), s2, M))


def detector_stale_noise():
    """The regulariser of 0 dB at every SNR."""
    _patch_detector(lambda det, h, y, sent, s2, M: det(
        h, y, sent, s2 * 0 + 1344 / 2048, M))


def test_sound_tiny_run_is_correct():
    res = tiny.run_tiny(CELL)
    assert res["correct"], res["compare"]
    assert res["compare"]["count_gap_max"]["value"] == 0


def test_control_is_not_correct():
    wl = cells.workload(CELL)
    res = tiny.run_tiny(CELL, dtype=wl["control_dtype"], seconds=0.1)
    assert not res["correct"], res["compare"]


@pytest.mark.parametrize("fault", [detector_zero_forcing,
                                   detector_drops_a_layer,
                                   detector_stale_noise],
                         ids=lambda f: f.__name__)
def test_detector_fault_is_not_correct(fault):
    fault()
    res = tiny.run_tiny(CELL, seconds=0.1)
    assert not res["correct"], res["compare"]


_REF = """
import json, sys
sys.path.insert(0, {root!r})
import perfbench.reference.mimo_ofdm, perfbench.harness.mimo_work
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_the_reference_imports_nothing_of_the_program():
    out = subprocess.run([sys.executable, "-c", _REF.format(root=str(ROOT))],
                         capture_output=True, text=True, timeout=300,
                         cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    names = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not names & {"pyphysim_tpu_torch", "pyphysim_tpu", "jax", "apps"}


def test_mimo_block_fir_rows():
    # 32 subframes x 14 OFDM symbols x 16 links
    assert mimo_work.fir_rows(32, 16800, 1200, 4, 4) == 7168
    assert mimo_work.fir_rows(3, 2400, 1200, 2, 3) == 36


def test_detector_work_from_shapes():
    # 4 x 4: Gram 260, H^H y 128, LDL^H solve 190, decision 16
    assert mimo_work.mmse_flops_per_re(4, 4) == 594
    # 2 x 2: Gram 2 (8 + 8) + 2, H^H y 32, solve 3 + 6 + 16 + 4, decision 8
    assert mimo_work.mmse_flops_per_re(2, 2) == 34 + 32 + 29 + 8
    assert mimo_work.mmse_bytes(32, 16800, 4, 4) == 32 * (16800 * 192 + 8)
    t = mimo_work.mmse_least_seconds(32, 16800, 4, 4)
    assert t == pytest.approx(32 * (16800 * 192 + 8) / work.PEAK_HBM_BYTES)


def _context(device_ops, calls=(32, 32)):
    bench = cells.load_benchmark()
    entry = cells.cell(bench, CELL)
    trace = Trace((0.0, 1000.0), device_ops, {})
    return cells.Context(entry, cells.workload(CELL),
                         cells.config(entry["config"]), {}, trace,
                         list(calls))


def test_the_readers_on_a_trace():
    from pyphysim_tpu_torch import tracing
    tracing.clear()
    ops = [("void (anonymous namespace)::mimo_mmse_kernel<4, 4>", 100.0,
            150.0), ("block_fir_kernel", 150.0, 300.0),
           ("void (anonymous namespace)::mimo_mmse_kernel<4, 4>", 500.0,
            550.0)]
    ctx = _context(ops)
    roof = cells.reader("kernel.roofline.mimo_mmse")(ctx)
    need = 2 * mimo_work.mmse_least_seconds(32, 16800, 4, 4)
    assert roof == pytest.approx(100.0 * need / 100e-6)
    fir_need = 2 * work.fir_least_seconds(
        7168, 2192, [0, 1, 5, 10, 11, 22, 33, 53, 77])
    assert cells.reader("kernel.roofline.block_fir_mimo")(ctx) == \
        pytest.approx(100.0 * fir_need / 150e-6)
    assert cells.reader("mimo.detect_share")(ctx) == pytest.approx(
        100.0 * 100.0 / 250.0)
    # no program spans recorded in this process's newest session: nothing
    assert cells.reader("mimo.device_ms_per_step")(ctx) is None


def test_the_readers_read_nothing_without_the_detector():
    ctx = _context([("block_fir_kernel", 0.0, 10.0)])
    for name in ("kernel.roofline.mimo_mmse", "mimo.detect_share"):
        assert cells.reader(name)(ctx) is None
    assert cells.reader("kernel.roofline.block_fir_mimo")(
        _context([("mimo_mmse_kernel", 0.0, 10.0)])) is None
    ctx.trace = None
    for name in ("kernel.roofline.mimo_mmse", "mimo.detect_share",
                 "mimo.device_ms_per_step", "kernel.roofline.block_fir_mimo"):
        assert cells.reader(name)(ctx) is None


# the cell's metrics that read the engine's, the wrapper's and the chain's
# spans and counters, whatever the step's geometry
SHARED = {"engine.exposed_ms_per_point", "engine.calls_per_point",
          "wrapper.host_ms_per_call", "device.idle",
          "engine.syncs_per_point", "engine.account_ms_per_chunk",
          "chain.draw_ms_per_step", "chain.forward_ms_per_step",
          "device.idle.engine", "device.idle.wrapper", "chain.replay_share"}
# read only on the card: its kernels, the device's busy time, and the
# replay of a captured graph
CARD_ONLY = {"kernel.roofline.mimo_mmse", "kernel.roofline.block_fir_mimo",
             "mimo.detect_share", "mimo.device_ms_per_step",
             "chain.replay_share"}


def test_metrics_of_the_new_cells():
    bench = cells.load_benchmark()
    layer = {m["name"] for m in cells.metrics_for(bench, CELL, True)}
    assert layer == SHARED | {"kernel.roofline.mimo_mmse",
                              "kernel.roofline.block_fir_mimo",
                              "mimo.detect_share", "mimo.device_ms_per_step"}


def test_a_traced_tiny_run_reads_the_shared_metrics(monkeypatch):
    """On the CPU every metric of the cell but the card's is read, and a
    sub-chunk waits three times, as ``tu.perkey``'s does."""
    from perfbench.harness import program_spans
    seen = {}
    read = cells.read_metrics

    def keep(specs, ctx, *args, **kwargs):
        seen["ctx"] = ctx
        return read(specs, ctx, *args, **kwargs)
    monkeypatch.setattr(cells, "read_metrics", keep)
    res = tiny.run_tiny(CELL, trace=True)
    assert res["correct"], res["compare"]
    bench = cells.load_benchmark()
    want = {m["name"] for m in cells.metrics_for(bench, CELL, True)}
    assert set(res["metrics"]) == want - CARD_ONLY
    ctx = seen["ctx"]
    calls = program_spans.count(ctx, "wrapper.call")
    assert calls == program_spans.count(ctx, "chain.forward") > 0
    assert res["metrics"]["engine.syncs_per_point"]["value"] == \
        pytest.approx(3 * calls / program_spans.count(ctx, "engine.point"))


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
