#!/usr/bin/env python
"""METIS PS7 indoor scenario: SINR map over a grid of square rooms, on the
PyTorch port.

The counterpart of ``apps/metis_scenarios/simulate_metis_ps7.py``: a
floor of square rooms with one access point a room (the port's
``Cluster`` of ``CellSquare`` cells), users on a pixel grid, METIS PS7
path loss with wall counts, and the resulting downlink SINR map. The
per-(pixel, AP) math runs as float64 tensors on ``--device``; matplotlib
is imported only to draw the map, and the map is skipped without it.

Run: ``python apps/metis_scenarios/simulate_metis_ps7_torch.py
[--device cuda]``.
"""

import argparse
import sys

sys.path.insert(0, ".")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from pyphysim_tpu_torch._device import require_cuda  # noqa: E402
from pyphysim_tpu_torch.cell import Cluster  # noqa: E402
from pyphysim_tpu_torch.channels.pathloss import PathLossMetisPS7  # noqa: E402
from pyphysim_tpu_torch.utils.conversion import (dB2Linear,  # noqa: E402
                                                 linear2dB)


def simulate(num_rooms_per_side: int = 4, side_length: float = 10.0,
             grid_points: int = 60, tx_power_dbm: float = 20.0,
             noise_power_dbm: float = -94.0, device="cuda"):
    """``(sinr_db, xs, ys)``: the (grid_points, grid_points) SINR map in
    dB as a float64 tensor on ``device``, and the pixel coordinates."""
    dev = require_cuda(device)
    num_cells = num_rooms_per_side ** 2
    cluster = Cluster(cell_radius=side_length, num_cells=num_cells,
                      cell_type="square")
    ap_np = np.array([c.pos for c in cluster])

    # pixel grid covering the floor
    xs = np.linspace(ap_np.real.min() - side_length / 2,
                     ap_np.real.max() + side_length / 2, grid_points)
    ys = np.linspace(ap_np.imag.min() - side_length / 2,
                     ap_np.imag.max() + side_length / 2, grid_points)
    pts = torch.as_tensor((xs[None, :] + 1j * ys[:, None]).ravel(),
                          device=dev)
    aps = torch.as_tensor(ap_np, device=dev)

    # distance and wall count pixel -> AP (walls = rooms crossed, Manhattan)
    diff = pts[:, None] - aps[None, :]
    d = torch.clamp(diff.abs(), min=0.1)
    walls = torch.floor((diff.real.abs() + diff.imag.abs()) /
                        side_length).long()
    pl_db = PathLossMetisPS7(fc=2600.0)._calc_deterministic_path_loss_dB(
        d, num_walls=walls)

    tx_pow = dB2Linear(tx_power_dbm - 30)
    noise = dB2Linear(noise_power_dbm - 30)
    rx_pow = tx_pow * 10.0 ** (-pl_db / 10.0)           # (pixels, aps)
    best = rx_pow.max(dim=1).values
    interference = rx_pow.sum(dim=1) - best
    sinr_db = linear2dB(best / (interference + noise))
    return sinr_db.reshape(grid_points, grid_points), xs, ys


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default="metis_ps7_sinr.png")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    sinr, xs, ys = simulate(device=args.device)
    sinr = sinr.cpu().numpy()
    print(f"SINR map {sinr.shape}: min {sinr.min():.1f} dB, "
          f"median {np.median(sinr):.1f} dB, max {sinr.max():.1f} dB")
    try:
        import matplotlib
    except ImportError:
        print("plotting skipped: matplotlib is not installed")
        return sinr
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots()
    im = ax.pcolormesh(xs, ys, sinr, shading="auto")
    fig.colorbar(im, label="SINR (dB)")
    ax.set_title("METIS PS7 indoor SINR map")
    fig.savefig(args.out, dpi=100)
    plt.close(fig)
    print(f"Saved {args.out}")
    return sinr


if __name__ == "__main__":
    main()
