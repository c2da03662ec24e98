"""The port's notebooks (``notebooks/0*_torch.py``): their ``.ipynb``
files, their device contract and imports, and notebooks 01, 06 and 07
run end to end on the CPU against the JAX package.

* Each committed ``.ipynb`` is what ``bin/percent_to_ipynb.py`` makes of
  its script.
* Each notebook that touches a tensor (all but 07), run without
  ``DEVICE``, asks for the card and, without one, raises ``RuntimeError``
  (no CPU fallback).
* No notebook imports jax, the JAX package or a JAX app, by its source
  and in a fresh interpreter that imports every module the notebooks and
  the port's new ``bin/`` tools import.
* 01: the QPSK theory curve equals the JAX package's ``qfunc`` on the same
  SNRs (float64, rtol 1e-12), and each point's bit errors lie within 5
  standard deviations (+ 3) of the theory's count: the symbols'
  decisions are independent, so the count is binomial; its two bits a
  symbol at most double the variance, which the band allows for.
* 06: every path loss and ``which_distance_dB`` equals the JAX package's
  on the same numpy inputs (the port in float64 tensors, JAX in numpy
  float64: rtol 1e-12).
* 07, run without ``DEVICE`` (it runs on the host alone): the text bars
  print the JAX bars' last lines; the multiprocess and ZMQ servers count
  every worker's updates.
"""

import ast
import contextlib
import io
import json
import os
import runpy
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NOTEBOOK_DIR = os.path.join(REPO, "notebooks")
NOTEBOOKS = {
    name[:2]: os.path.join(NOTEBOOK_DIR, name)
    for name in sorted(os.listdir(NOTEBOOK_DIR))
    if name.startswith("0") and name.endswith("_torch.py")
}
NEW_BIN_TOOLS = ("combine_results_torch.py",
                 "split_into_partial_results_torch.py",
                 "generate_api_docs_torch.py")
HOST_NOTEBOOKS = ("07",)                # touch no tensor, read no DEVICE
FORBIDDEN = ("jax", "jaxlib", "pyphysim_tpu")


def run_notebook(number, workdir, monkeypatch, device="cpu"):
    """The namespace of notebook ``number`` ("01" .. "09") run through
    ``runpy.run_path(path, init_globals={"DEVICE": device})`` (without
    globals where ``device`` is None) in ``workdir`` (the notebooks save
    their figures there), its printed output discarded. The other
    notebook test files import it from here."""
    monkeypatch.chdir(workdir)
    init = None if device is None else {"DEVICE": device}
    with contextlib.redirect_stdout(io.StringIO()):
        return runpy.run_path(NOTEBOOKS[number], init_globals=init)


def _percent_to_ipynb():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "percent_to_ipynb", os.path.join(REPO, "bin", "percent_to_ipynb.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


def test_there_are_nine_notebooks():
    assert sorted(NOTEBOOKS) == [f"0{i}" for i in range(1, 10)]


@pytest.mark.parametrize("number", sorted(NOTEBOOKS))
def test_notebook_ipynb_is_its_script_converted(number):
    tool = _percent_to_ipynb()
    path = NOTEBOOKS[number]
    with open(path) as f:
        want = tool.to_ipynb(tool.parse_percent_cells(f.read()))
    with open(os.path.splitext(path)[0] + ".ipynb") as f:
        got = json.load(f)
    assert got == want
    assert all(cell.get("outputs", []) == [] for cell in got["cells"])


@pytest.mark.parametrize("number", sorted(set(NOTEBOOKS) -
                                         set(HOST_NOTEBOOKS)))
def test_notebook_without_device_asks_for_the_card(number, tmp_path,
                                                   monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        runpy.run_path(NOTEBOOKS[number])


def test_new_files_import_neither_jax_nor_the_jax_package():
    paths = list(NOTEBOOKS.values()) + [
        os.path.join(REPO, "bin", name) for name in NEW_BIN_TOOLS]
    modules = set()
    for path in paths:
        names = _imported_modules(path)
        assert not {n.split(".")[0] for n in names} & set(FORBIDDEN), path
        apps = [n for n in names if n.startswith("apps.")]
        assert all(n.endswith("_torch") for n in apps), (path, apps)
        modules |= names
    tools = [os.path.join(REPO, "bin", name) for name in NEW_BIN_TOOLS]
    code = ("import importlib, importlib.util, sys\n"
            f"sys.path.insert(0, {REPO!r})\n"
            f"for m in {sorted(modules)!r}:\n"
            "    importlib.import_module(m)\n"
            f"for i, p in enumerate({tools!r}):\n"
            "    spec = importlib.util.spec_from_file_location(f't{i}', p)\n"
            "    spec.loader.exec_module(importlib.util.module_from_spec("
            "spec))\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"


def _theory_band_ok(errors, bits, p):
    """``errors`` within 5 standard deviations (two bits a symbol: twice
    the binomial variance) + 3 of ``bits * p``."""
    errors, bits, p = map(np.asarray, (errors, bits, p))
    sd = np.sqrt(2.0 * bits * p * (1.0 - p))
    return np.abs(errors - bits * p) <= 5.0 * sd + 3.0


def test_notebook_01_against_theory_and_jax(tmp_path, monkeypatch):
    from pyphysim_tpu.utils.conversion import dB2Linear as jdB2Linear
    from pyphysim_tpu.utils.misc import qfunc as jqfunc
    ns = run_notebook("01", tmp_path, monkeypatch)
    snrs = ns["snrs"]
    np.testing.assert_array_equal(snrs, np.arange(0.0, 18.0, 2.0))
    np.testing.assert_allclose(ns["theory"],
                               jqfunc(np.sqrt(jdB2Linear(snrs))), rtol=1e-12)
    reps = np.array(ns["runner"].runned_reps)
    assert ((reps > 0) & (reps <= 500)).all()
    assert _theory_band_ok(ns["bit_errors"], ns["bits"], ns["theory"]).all()
    np.testing.assert_allclose(ns["ber"], ns["bit_errors"] / ns["bits"])
    assert (tmp_path / "awgn_ber.png").exists()


def test_notebook_06_path_losses_equal_the_jax_package(tmp_path,
                                                       monkeypatch):
    from pyphysim_tpu.channels import pathloss as J
    ns = run_notebook("06", tmp_path, monkeypatch)
    d = np.linspace(0.05, 5.0, 100)
    hata = J.PathLossOkomuraHata()
    hata.fc, hata.hbs, hata.hms, hata.area_type = 900.0, 30.0, 1.5, \
        "medium city"
    models = {"free space 900 MHz": J.PathLossFreeSpace(n=2, fc=900.0),
              "free space 2600 MHz": J.PathLossFreeSpace(n=2, fc=2600.0),
              "general": J.PathLossGeneral(n=3.7, C=120.9),
              "3GPP": J.PathLoss3GPP1(), "Okomura-Hata": hata}
    for name, model in models.items():
        np.testing.assert_allclose(ns["at_1km"][name],
                                   float(model.calc_path_loss_dB(1.0)),
                                   rtol=1e-12, err_msg=name)
    curves = {"free space 2.6 GHz": models["free space 2600 MHz"],
              "general n=3.7": models["general"], "3GPP": models["3GPP"],
              "Okomura-Hata urban": hata}
    for name, model in curves.items():
        got = ns["curves"][name]
        assert got.dtype == torch.float64
        np.testing.assert_allclose(got.numpy(), model.calc_path_loss_dB(d),
                                   rtol=1e-12, err_msg=name)
    metis = J.PathLossMetisPS7(fc=2600.0)
    d_m = np.array([5.0, 15.0, 30.0])
    for walls, got in ns["metis"].items():
        want = metis._calc_deterministic_path_loss_dB(
            d_m, num_walls=np.full(3, walls))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)
    np.testing.assert_allclose(ns["reach_km"],
                               models["3GPP"].which_distance_dB(130.0),
                               rtol=1e-12)
    sample = ns["sample"]
    assert sample.shape == (5,) and torch.isfinite(sample).all()
    assert (tmp_path / "pathloss_models.png").exists()


def test_notebook_07_bars_and_servers(tmp_path, monkeypatch):
    import io

    from pyphysim_tpu import progressbar as J
    ns = run_notebook("07", tmp_path, monkeypatch, device=None)
    assert "DEVICE" not in ns
    for name in ("ProgressbarText", "ProgressbarText3"):
        out = io.StringIO()
        bar = getattr(J, name)(50, message="demo", output=out)
        for i in (10, 30, 50):
            bar.progress(i)
        want = out.getvalue().replace("\r", "\n").strip().splitlines()[-1]
        assert ns["last_lines"][name] == want
    assert ns["last_lines"]["ProgressbarText2"].startswith(
        "[" + "*" * 50 + "] 100% - demo")
    assert "42%" in ns["file_line"]
    assert ns["multiprocess_count"] == 400
    pytest.importorskip("zmq")
    assert ns["zmq_count"] == 100
