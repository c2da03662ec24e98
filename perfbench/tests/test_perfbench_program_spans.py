"""The per-layer metrics that read the program's own spans
(``harness/program_spans.py``): a traced tiny run of each cell reads every
metric its entries list, the program's spans land on the trace's clock
inside the benchmark's own, and the idle split is exact."""

import sys

import pytest

from perfbench.harness import cells, program_spans
from perfbench.harness.trace import Trace
from perfbench.tests import tiny

WAITS_A_CALL = {"tu.bulk": 2, "exp250.bulk": 2, "tu.perkey": 3}
NEW = ("engine.syncs_per_point", "engine.account_ms_per_chunk",
       "chain.draw_ms_per_step", "chain.forward_ms_per_step",
       "device.idle.engine", "device.idle.wrapper")


@pytest.fixture
def traced(monkeypatch):
    """``run(cell)``: a traced tiny run, as ``(result, ctx)``."""
    seen = {}
    read = cells.read_metrics

    def keep(specs, ctx, *args, **kwargs):
        seen["ctx"] = ctx
        return read(specs, ctx, *args, **kwargs)

    monkeypatch.setattr(cells, "read_metrics", keep)

    def run(cell):
        return tiny.run_tiny(cell, trace=True), seen["ctx"]
    return run


@pytest.mark.parametrize("cell", sorted(WAITS_A_CALL))
def test_a_traced_run_reads_every_metric_and_maps_the_spans(cell, traced):
    res, ctx = traced(cell)
    bench = cells.load_benchmark()
    listed = {m["name"] for m in bench["per_layer"]
              if cell in m["workloads"]}
    assert {n for n in NEW if n in res["metrics"]} == listed & set(NEW)
    got = {k: v["value"] for k, v in res["metrics"].items()}

    calls = program_spans.count(ctx, "wrapper.call")
    points = program_spans.count(ctx, "engine.point")
    assert got["engine.syncs_per_point"] == WAITS_A_CALL[cell] * calls / \
        points
    assert got["device.idle.engine"] + got["device.idle.wrapper"] >= \
        0.95 * got["device.idle"]

    tr = ctx.trace
    spans = program_spans.mapped(ctx)
    anchors, pb_calls = tr.spans["pb.point"], tr.spans["pb.call"]
    wrapper = [(a, b) for n, a, b, _, _ in spans if n == "wrapper.call"]
    assert len(wrapper) == len(pb_calls) == calls
    for a, b in wrapper:
        assert sum(a <= (c + d) / 2 <= b for c, d in pb_calls) == 1
    for name, a, b, _, k in spans:
        if name == "engine.point":
            assert a == pytest.approx(anchors[k][0]) and b >= anchors[k][1]
        elif k >= 0:
            assert anchors[k][0] - 50 <= a <= b <= anchors[k][1] + 50, name


class _Rec:
    def __init__(self, name, start, end, parent):
        self.name, self.start_ns, self.end_ns = name, start * 1000, \
            end * 1000
        self.parent = parent


def test_the_idle_split_is_exact(monkeypatch):
    # program clock = trace clock + 1000 us; one sweep of one point with a
    # call (a draw inside) and a wait; device busy over [30, 50) and
    # [75, 85)
    recs = [_Rec("engine.sweep", 1000, 1100, -1),
            _Rec("engine.point", 1010, 1090, 0),
            _Rec("wrapper.call", 1020, 1060, 1),
            _Rec("chain.draw", 1025, 1040, 2),
            _Rec("engine.wait", 1070, 1080, 1)]
    monkeypatch.setattr(program_spans, "records", lambda ctx: recs)
    tr = Trace((0.0, 120.0), [("k", 30.0, 50.0), ("k", 75.0, 85.0)],
               {"pb.point": [(10.0, 89.0)]})
    ctx = cells.Context({}, {}, {}, {}, tr)
    split = program_spans.idle_split(ctx)
    # idle: [0, 30), [50, 75), [85, 120)
    # engine: sweep [0, 10) + point [10, 20) + point [60, 70) + wait
    #   [70, 75) + point [85, 90) + sweep [90, 100) = 50; wrapper: call
    #   [20, 25) + draw [25, 30) + call [50, 60) = 20; outside: [100, 120)
    assert split == pytest.approx({"engine": 50.0, "wrapper": 20.0,
                                   "outside": 20.0})
    assert program_spans.idle_percent(ctx, "wrapper") == \
        pytest.approx(100 * 20 / 120)


def test_a_program_without_spans_reads_nothing(monkeypatch):
    import pyphysim_tpu_torch
    monkeypatch.setitem(sys.modules, "pyphysim_tpu_torch.tracing", None)
    monkeypatch.delattr(pyphysim_tpu_torch, "tracing", raising=False)
    tr = Trace((0.0, 1.0), [], {"pb.point": [(0.0, 1.0)]})
    ctx = cells.Context({}, {}, {}, {}, tr)
    for name in NEW:
        assert cells.reader(name)(ctx) is None
