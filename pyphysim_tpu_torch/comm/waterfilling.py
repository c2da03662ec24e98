"""Water-filling power allocation.

Counterpart of ``pyphysim_tpu/comm/waterfilling.py``: :func:`doWF` is the
classic host algorithm in numpy (raise the water level, dropping channels
whose power would be negative, until the power budget is met);
:func:`doWF_jit` the same solution written branch-free for batched tensors
(for every possible number of kept channels the water level in closed
form, then the largest feasible count), with no sort and no data-dependent
loop. The BD kernel (``ops/csrc/mc_bd.cu``) runs the same rank arithmetic
per realization.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

__all__ = ["doWF", "doWF_jit"]


def doWF(vtChannels: np.ndarray, dPt: float, noiseVar: float = 1.0,
         Es: float = 1.0) -> Tuple[np.ndarray, float]:
    """Classic water-filling over parallel channel POWER gains.

    Returns ``(optimum_powers, water_level)``.

    >>> import numpy as np
    >>> p, mu = doWF(np.array([0.5, 1.0, 2.0]), dPt=10.0)
    >>> p.round(4), round(mu, 4)
    (array([2.5, 3.5, 4. ]), 4.5)
    >>> p, _ = doWF(np.array([0.1, 10.0]), dPt=1.0)
    >>> p                        # the bad channel is dropped
    array([0., 1.])
    """
    vtChannels = np.asarray(vtChannels, dtype=float)
    n = vtChannels.size
    order = np.argsort(vtChannels)[::-1]
    g_sorted = vtChannels[order]

    remove = 0
    while True:
        kept = n - remove
        # water level touching the worst kept channel
        min_mu = noiseVar / (Es * g_sorted[kept - 1])
        powers = min_mu - noiseVar / (Es * g_sorted[:kept])
        if powers.sum() <= dPt or remove >= n - 1:
            break
        remove += 1

    kept = n - remove
    powers = powers + (dPt - powers.sum()) / kept
    opt = np.zeros(n)
    opt[order[:kept]] = powers
    mu = powers[0] + noiseVar / g_sorted[0]
    return opt, float(mu)


def doWF_jit(gains: torch.Tensor, total_power,
             noise_var=1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Branch-free water-filling, batched over the leading dims of
    ``gains`` (..., n): returns ``(powers (..., n), water_level (...))``.

    Each 1/gain gets its stable ascending rank by pairwise comparison (ties
    broken by index); keeping the k+1 best channels gives the water level
    ``(P + sum of their 1/gain) / (k + 1)``, feasible if the worst kept one
    still gets a non-negative power; the optimum keeps the most channels.
    ``total_power`` and ``noise_var`` are numbers or tensors broadcast
    against the batch."""
    n = gains.shape[-1]
    dev, dt = gains.device, gains.dtype
    if isinstance(noise_var, torch.Tensor):
        noise_var = noise_var[..., None]
    if isinstance(total_power, torch.Tensor):
        total_power = total_power[..., None]
    inv = noise_var / gains                              # (..., n)
    idx = torch.arange(n, device=dev)
    lt = inv[..., None, :] < inv[..., :, None]           # inv_j < inv_i
    tie = (inv[..., None, :] == inv[..., :, None]) & (idx < idx[:, None])
    rank = (lt | tie).sum(dim=-1)                        # (..., n)
    keep = rank[..., None, :] <= idx[:, None]            # (..., k, i)
    zero = torch.zeros((), dtype=dt, device=dev)
    cum_inv = torch.where(keep, inv[..., None, :], zero).sum(dim=-1)
    at_k = rank[..., None, :] == idx[:, None]
    worst_inv = torch.where(at_k, inv[..., None, :], zero).sum(dim=-1)
    mu_k = (total_power + cum_inv) / (idx + 1.0).to(dt)  # (..., n)
    kept = (mu_k >= worst_inv).sum(dim=-1)               # (...,)
    mu = torch.where(idx == (kept - 1)[..., None], mu_k, zero).sum(dim=-1)
    powers = torch.clamp(mu[..., None] - inv, min=0.0)
    return powers, mu
