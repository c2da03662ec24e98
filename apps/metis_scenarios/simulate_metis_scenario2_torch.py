#!/usr/bin/env python
"""Dense indoor scenario: AP association, SINR and per-user capacity, on
the PyTorch port.

The counterpart of ``apps/metis_scenarios/simulate_metis_scenario2.py``
(METIS Test Case 2, one floor, indoor APs only): a grid of square rooms
with APs every ``ap_decimation`` rooms, random user drops, METIS PS7 path
loss plus per-wall penetration loss, best-channel AP association, and the
resulting SINR and spectral efficiency. An AP's bandwidth is split among
its users, and only APs with at least one user transmit.

The drops come from the JAX app's numpy ``RandomState`` (so both apps
place the same users); the per-(user, AP) distances, wall counts, path
losses, association, SINR and capacity are float64 tensors on
``--device``.

Run: ``python apps/metis_scenarios/simulate_metis_scenario2_torch.py
[--users 100] [--rooms 12] [--ap-decimation 2] [--device cuda]``.
"""

import argparse
import sys

sys.path.insert(0, ".")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from pyphysim_tpu_torch._device import require_cuda  # noqa: E402
from pyphysim_tpu_torch.channels.pathloss import PathLossMetisPS7  # noqa: E402
from pyphysim_tpu_torch.utils.conversion import (dBm2Linear,  # noqa: E402
                                                 linear2dB)


def calc_room_positions_square(side_length, num_rooms):
    """Center positions (complex) of a square grid of square rooms,
    centred at the origin."""
    per_side = int(round(np.sqrt(num_rooms)))
    idx = np.arange(per_side) - (per_side - 1) / 2.0
    pos = side_length * (idx[None, :] + 1j * idx[:, None])
    return pos.ravel()


def get_ap_positions(room_positions, ap_decimation=1):
    """Keep one AP every ``ap_decimation`` rooms (valid: 1, 2, 4, 9) of a
    (per_side, per_side) grid of room positions."""
    if ap_decimation == 1:
        return room_positions.ravel()
    per_side = room_positions.shape[0]
    mask = np.zeros((per_side, per_side), dtype=bool)
    if ap_decimation == 2:
        mask[(np.add.outer(np.arange(per_side),
                           np.arange(per_side)) % 2) == 0] = True
    else:
        step = {4: (2, 2), 9: (3, 3)}[ap_decimation]
        offset = {4: (1, 0), 9: (1, 1)}[ap_decimation]
        mask[offset[0]::step[0], offset[1]::step[1]] = True
    return room_positions[mask].ravel()


def calc_num_walls(side_length, user_positions, ap_positions):
    """Walls between each user and each AP (rooms crossed, Manhattan
    count) of complex positions (tensors, or arrays read as CPU tensors),
    as an int64 tensor."""
    diff = torch.as_tensor(user_positions)[:, None] - \
        torch.as_tensor(ap_positions)[None, :]
    half = side_length / 2
    return (torch.floor((diff.real.abs() + half) / side_length) +
            torch.floor((diff.imag.abs() + half) / side_length)).long()


def drop_users(num_users, num_rooms_per_side, side_length, seed):
    """The JAX app's user drop: uniform over the floor from
    ``RandomState(seed)`` (complex numpy)."""
    rng = np.random.RandomState(seed)
    span = num_rooms_per_side * side_length
    return span * (rng.random_sample(num_users) - 0.5 +
                   1j * (rng.random_sample(num_users) - 0.5))


def simulate(num_users=100, num_rooms_per_side=12, side_length=10.0,
             single_wall_loss_dB=5.0, ap_decimation=2, Pt_dBm=20.0,
             noise_power_dBm=-94.0, seed=0, device="cuda"):
    """``(sinr_dB, capacity, num_transmitting_aps, num_aps)``: the
    per-user SINR (dB) and spectral efficiency as float64 tensors on
    ``device``, and the two AP counts."""
    dev = require_cuda(device)
    num_rooms = num_rooms_per_side ** 2
    Pt = dBm2Linear(Pt_dBm)
    noise_var = dBm2Linear(noise_power_dBm)

    room_grid = calc_room_positions_square(side_length, num_rooms).reshape(
        num_rooms_per_side, num_rooms_per_side)
    ap_np = get_ap_positions(room_grid, ap_decimation)
    users = torch.as_tensor(drop_users(num_users, num_rooms_per_side,
                                       side_length, seed), device=dev)
    aps = torch.as_tensor(ap_np, device=dev)

    dists = torch.clamp((users[:, None] - aps[None, :]).abs(), min=0.1)
    walls = calc_num_walls(side_length, users, aps)
    pl_dB = PathLossMetisPS7(fc=2600.0)._calc_deterministic_path_loss_dB(
        dists, num_walls=walls)
    # channel gain including the wall penetration loss, linear
    gains = 10.0 ** (-(pl_dB + single_wall_loss_dB * walls) / 10.0)

    # best-channel association; only APs with >= 1 user transmit
    ap_assoc = gains.argmax(dim=-1)
    transmitting = torch.unique(ap_assoc)               # sorted
    g_tx = gains[:, transmitting]                       # (users, tx aps)
    desired_idx = torch.searchsorted(transmitting, ap_assoc)
    desired = Pt * g_tx.gather(1, desired_idx[:, None])[:, 0]
    total = Pt * g_tx.sum(dim=-1)
    sinr = desired / (total - desired + noise_var)
    users_per_ap = torch.bincount(ap_assoc, minlength=ap_np.size)
    capacity = torch.log2(1.0 + sinr) / users_per_ap[ap_assoc]
    return linear2dB(sinr), capacity, int(transmitting.numel()), ap_np.size


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--users", type=int, default=100)
    parser.add_argument("--rooms", type=int, default=12,
                        help="rooms per side")
    parser.add_argument("--ap-decimation", type=int, default=2,
                        choices=[1, 2, 4, 9])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    sinr_dB, capacity, num_tx, num_aps = simulate(
        num_users=args.users, num_rooms_per_side=args.rooms,
        ap_decimation=args.ap_decimation, seed=args.seed, device=args.device)
    sinr_dB, capacity = sinr_dB.cpu().numpy(), capacity.cpu().numpy()

    print(f"{args.users} users, {num_aps} APs "
          f"(decimation {args.ap_decimation}), {num_tx} transmitting")
    print(f"SINR (dB):  mean {sinr_dB.mean():7.2f}  "
          f"p10 {np.percentile(sinr_dB, 10):7.2f}  "
          f"p90 {np.percentile(sinr_dB, 90):7.2f}")
    print(f"Capacity:   mean {capacity.mean():7.3f}  "
          f"p10 {np.percentile(capacity, 10):7.3f}  "
          f"p90 {np.percentile(capacity, 90):7.3f}  bits/s/Hz per user")


if __name__ == "__main__":
    main()
