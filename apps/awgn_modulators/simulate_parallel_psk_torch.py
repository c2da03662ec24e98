#!/usr/bin/env python
"""Serial against parallel Monte Carlo of PSK over AWGN, on the port.

The PyTorch counterpart of ``apps/awgn_modulators/simulate_parallel_psk.py``:
the same sweep once with ``simulate()`` and once with
``simulate_in_parallel(make_mesh())``, whose chunks are split over the
ranks of the process group (a world-size-1 group is started when none is
up). Both give the same BERs: attempt ``a`` draws from its own streams on
whichever rank computes it.

Run:  python apps/awgn_modulators/simulate_parallel_psk_torch.py
[--device cuda]. Called on every rank of a process group (as the tests
do on a gloo group), the parallel sweep spans the group's ranks.
"""

import sys

sys.path.insert(0, ".")

import numpy as np  # noqa: E402

from apps.awgn_modulators.simulate_psk_torch import (  # noqa: E402
    VerySimplePskSimulationRunner, device_arg)
from pyphysim_tpu_torch.parallel import make_mesh  # noqa: E402

SNRS = np.array([0.0, 3, 6, 9, 12])


def _runner(device):
    runner = VerySimplePskSimulationRunner(device=device)
    runner.params.add("SNR", SNRS)
    runner.params.set_unpack_parameter("SNR")
    return runner


def main(device=None):
    """Run both sweeps, print their BER rows, the theory and the mesh
    size; return the two rows."""
    device = device or device_arg()
    serial = _runner(device)
    serial.simulate()
    print("Serial elapsed time:", serial.elapsed_time)

    parallel = _runner(device)
    mesh = make_mesh(device=parallel.device.type)
    parallel.simulate_in_parallel(mesh)
    print(f"Parallel elapsed time ({mesh.size()} ranks):",
          parallel.elapsed_time)

    ber_s = np.asarray(serial.results.get_result_values_list("ber"))
    ber_p = np.asarray(parallel.results.get_result_values_list("ber"))
    theory = serial.modulator.calcTheoreticalBER(
        np.asarray(serial.results.params["SNR"], dtype=float))
    print("SNR:         ", serial.results.params["SNR"])
    print("Serial BER:  ", ber_s)
    print("Parallel BER:", ber_p)
    print("Theory:      ", theory)
    return ber_s, ber_p


if __name__ == "__main__":
    main()
