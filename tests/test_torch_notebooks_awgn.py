"""The port's notebooks 04 and 05 run end to end on the CPU, held against
the JAX package and the physics.

* 04 runs in a process of its own: ``make_mesh`` starts a process group
  (gloo on the CPU), which must not outlive the notebook in a test
  worker. ``simulate_in_parallel`` on the 1-rank mesh equals
  ``simulate()`` bit for bit at every SNR; the time-sharded channel on
  the 1-rank mesh and as 4 shards with their halos added lies within
  2e-5 of the unsharded ``corrupt_data`` (both packages' tolerance,
  ``tests/test_parallel.py``), the sharded and unsharded receptions
  count the same bit errors, and the notebook releases the group it
  started.
* 05: the three theory curves equal the JAX package's on the same SNRs
  (float64, rtol 1e-12), and each point's bit errors lie within 5 standard
  deviations (+ 3) of the theory's count: every symbol has its own noise
  and fading draw, so the count is binomial; its two bits a symbol at
  most double the variance, which the band allows for.
"""

import json
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from test_torch_notebooks import (NOTEBOOKS, REPO,  # noqa: E402
                                  run_notebook)

TS_ATOL = 2e-5


def test_notebook_04_parallel_in_its_own_process(tmp_path):
    code = ("import json, runpy, sys\n"
            f"sys.path.insert(0, {REPO!r})\n"
            "import torch.distributed as dist\n"
            "from pyphysim_tpu_torch.ops import fir\n"
            f"ns = runpy.run_path({NOTEBOOKS['04']!r}, "
            "init_globals={'DEVICE': 'cpu'})\n"
            "print(json.dumps({'equal': [bool(e) for e in ns['equal']], "
            "'max_abs_err': ns['max_abs_err'], "
            "'bit_errors': ns['bit_errors'], "
            "'runned_reps': ns['runner_parallel'].runned_reps, "
            "'serial_reps': ns['runner_serial'].runned_reps, "
            "'started_group': ns['started_group'], "
            "'group_after': dist.is_initialized(), "
            "'block_fir_plain_calls': fir.block_fir.reference_count}))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["equal"] == [True] * 4
    assert out["runned_reps"] == out["serial_reps"] == [512] * 4
    assert max(out["max_abs_err"].values()) <= TS_ATOL, out
    assert out["bit_errors"]["time-sharded"] == \
        out["bit_errors"]["unsharded"]
    assert out["started_group"] and not out["group_after"]
    # the 1-rank call, the unsharded call and the 4 shards
    assert out["block_fir_plain_calls"] == 6


def test_notebook_05_against_theory_and_jax(tmp_path, monkeypatch):
    from pyphysim_tpu.modulators import QPSK
    from pyphysim_tpu.utils.conversion import dB2Linear
    ns = run_notebook("05", tmp_path, monkeypatch)
    snrs = ns["SNRS_DB"]
    np.testing.assert_array_equal(snrs, np.arange(0.0, 22.0, 3.0))
    g = dB2Linear(snrs) / 2
    mu = np.sqrt(g / (1.0 + g))
    want = {"awgn": QPSK().calcTheoreticalBER(snrs),
            "rayleigh": 0.5 * (1.0 - mu),
            "mrc": (((1 - mu) / 2) ** 2) * (2 + mu)}
    bits = ns["num_bits"]
    assert bits == 20_000 * 50 * 2
    for mode, theory in want.items():
        np.testing.assert_allclose(ns[f"theory_{mode}"], theory, rtol=1e-12)
        errors = ns["bit_errors"][mode]
        sd = np.sqrt(2.0 * bits * theory * (1.0 - theory))
        assert (np.abs(errors - bits * theory) <= 5.0 * sd + 3.0).all(), \
            (mode, errors, bits * theory)
    assert (tmp_path / "rayleigh_awgn_ber.png").exists()
