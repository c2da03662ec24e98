"""On the card: a short run of each one-card cell through the command's own
entry, correct, with every metric the cell reports."""

import io
import json

import pytest

from perfbench import run
from perfbench.harness import cells


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["tu.bulk", "exp250.bulk", "tu.perkey"])
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_on_the_card(cuda_card, cell, trace):
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
    assert list(line)[-1] == "compare"
    assert line["device"]["platform"] == "gpu"
