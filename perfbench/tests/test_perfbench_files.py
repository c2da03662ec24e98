"""The benchmark's files: found by the names in BENCHMARK.json, a new file
picked up without an edit, and BENCHMARK.json within its contract's
shape."""

import json
import re
import shutil

import pytest

from perfbench.harness import cells, program

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_every_name_has_its_files():
    bench = cells.load_benchmark()
    for w in bench["workloads"]:
        wl = cells.workload(w["name"])
        route = program.path(wl["path"])
        for part in ("make_runner", "warm", "bits_per_attempt",
                     "reference_counts", "replay", "tiny"):
            assert callable(getattr(route, part)), (wl["path"], part)
        assert wl["config"] == w["config"]
        assert int(wl["chips"]) == w["chips"]
        cfg = cells.config(w["config"])
        assert cfg["name"] == w["config"]
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(cells.reader(m["name"]))
    for c in bench["configs"]:
        assert (cells.ROOT / c["file"]).is_file()


def test_benchmark_json_shape():
    bench = cells.load_benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "perfbench/run.py"]
    assert 1 <= bench["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in bench[k]]
    assert all(NAME.match(n) for n in names)
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in (
            "host_clock", "device_trace")
    cfgs = {c["name"] for c in bench["configs"]}
    for w in bench["workloads"]:
        assert w["config"] in cfgs and len(w["why"]) <= 200
        reported = {m["name"] for m in cells.metrics_for(bench, w["name"],
                                                         True)}
        assert reported, w["name"]
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    assert four <= max(1, len(bench["workloads"]) // 4)
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
    assert len(json.dumps(bench)) < 64 * 1024


@pytest.mark.parametrize("kind", ["workload", "config", "metric", "path"])
def test_a_new_file_is_found_by_its_name(tmp_path, kind):
    base = tmp_path / "perfbench"
    shutil.copytree(cells.HERE, base, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    if kind == "workload":
        wl = cells.workload("tu.bulk")
        wl.update(name="tu.bulk.new", snr_db=[5, 15])
        (base / "workloads" / "tu.bulk.new.json").write_text(json.dumps(wl))
        assert cells.workload("tu.bulk.new", base)["snr_db"] == [5, 15]
    elif kind == "config":
        cfg = cells.config("ofdm16qam_cost259tu")
        cfg.update(name="new_cfg", doppler_hz=100.0)
        (base / "configs" / "new_cfg.json").write_text(json.dumps(cfg))
        assert cells.config("new_cfg", base)["doppler_hz"] == 100.0
    elif kind == "path":
        # a new route: a path module that takes the bulk path's parts
        (base / "paths" / "newroute.py").write_text(
            "from .bulk import *  # noqa: F401,F403\n"
            "from .bulk import warm as _warm\n\n"
            "def warm(runner, wl):\n    return 'new'\n")
        route = program.path("newroute", base)
        assert route.warm(None, {}) == "new"
        assert route.replay is program.path("bulk").replay
    else:
        (base / "metrics" / "new.metric.py").write_text(
            "def read(ctx):\n    return len(ctx.host['calls'])\n")
        ctx = cells.Context({}, {}, {}, {"calls": [1, 2, 3]})
        got = cells.read_metrics([{"name": "new.metric", "unit": "calls"}],
                                 ctx, base)
        assert got == {"new.metric": {"value": 3.0, "unit": "calls"}}


def test_metrics_for_a_cell():
    bench = cells.load_benchmark()
    e2e = {m["name"] for m in cells.metrics_for(bench, "tu.perkey", False)}
    assert e2e == {"sym_rate", "point_ms", "point_ms_p95", "setup_s"}
    layer = {m["name"] for m in cells.metrics_for(bench, "tu.perkey", True)}
    assert "kernel.roofline.block_fir" in layer
    assert "kernel.roofline.mc_ofdm_tdl" not in layer
