"""The port's AWGN modulator apps (``apps/awgn_modulators/*_torch.py``):

* the PSK, BPSK and QAM per-key runners' error rates lie inside the 99 %
  confidence interval of their theory at a small ``rep_max``, where the
  theory is exact: BER of QPSK and BPSK (Gray mapping), SER of BPSK and
  of square QAM (PSK's SER curve is the nearest-neighbour bound);
* ``simulate_parallel_psk_torch.main()`` on a 2-rank ``gloo`` group prints
  and returns equal serial and parallel BER rows on both ranks.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import torch_parallel_checks as checks  # noqa: E402
from pyphysim_tpu_torch.parallel.launch import run_ranks  # noqa: E402
from pyphysim_tpu_torch.utils.misc import \
    calc_confidence_interval  # noqa: E402


def _inside_99(rate, theory, trials):
    std = np.sqrt(theory * (1.0 - theory))
    lo, hi = calc_confidence_interval(theory, std, trials, P=99.0)
    return lo <= rate <= hi


def _run(cls, snrs, rep_max):
    runner = cls(device="cpu", read_command_line_args=False)
    runner.params.add("SNR", np.asarray(snrs, dtype=float))
    runner.params.set_unpack_parameter("SNR")
    runner.rep_max = rep_max
    runner.update_progress_function_style = None
    runner.simulate()
    return runner


def _app(kind):
    from apps.awgn_modulators import (simulate_bpsk_torch, simulate_psk_torch,
                                      simulate_qam_torch)
    return {"psk": simulate_psk_torch.VerySimplePskSimulationRunner,
            "bpsk": simulate_bpsk_torch.VerySimpleBpskSimulationRunner,
            "qam": simulate_qam_torch.VerySimpleQamSimulationRunner}[kind]


@pytest.mark.parametrize("kind,snrs,check_ber,check_ser", [
    ("psk", [0.0, 4.0, 8.0], True, False),
    ("bpsk", [0.0, 4.0], True, True),
    ("qam", [6.0, 12.0], False, True),
])
def test_error_rates_inside_the_theory_interval(kind, snrs, check_ber,
                                                check_ser):
    runner = _run(_app(kind), snrs, rep_max=20)
    snr, ber, ser, t_ber, t_ser = runner.get_data_to_be_plotted()
    res = runner.results
    symbols = res.get_result_values_list("num_symbols")
    bits = res.get_result_values_list("num_bits")
    for i in range(len(snr)):
        assert ser[i] > 0
        if check_ser:
            assert _inside_99(ser[i], t_ser[i], symbols[i]), (snr[i],
                                                              ser[i],
                                                              t_ser[i])
        if check_ber:
            assert _inside_99(ber[i], t_ber[i], bits[i]), (snr[i], ber[i],
                                                           t_ber[i])
    assert runner.modulator.M == {"psk": 4, "bpsk": 2, "qam": 16}[kind]


def test_parallel_psk_main_on_two_ranks(tmp_path):
    rows = run_ranks(checks.parallel_psk_main, 2,
                     store_dir=str(tmp_path))
    for ber_s, ber_p in rows:
        np.testing.assert_array_equal(ber_s, ber_p)
        assert len(ber_s) == 5 and ber_s[0] > ber_s[-1]
    np.testing.assert_array_equal(rows[0][0], rows[1][0])
