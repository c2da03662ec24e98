# %% [markdown]
# # Path loss models (PyTorch port)
#
# The port's counterpart of `06_pathloss_models.py`: a tour of every path
# loss model in `pyphysim_tpu_torch.channels.pathloss` — free space, the
# general A + B log10(d) form, 3GPP, METIS PS7 indoor (with wall losses)
# and Okomura-Hata — plus log-normal shadowing and the inverse
# `which_distance` queries. Every model evaluates elementwise over a
# tensor of distances on `DEVICE`, here in float64 (a numpy array works
# too, on the host).
#
# Runs on the card by default; `runpy.run_path(path, init_globals=
# {"DEVICE": "cpu"})` runs it on the CPU.

# %%
import os
import sys

# the repository root: the parent of this file's folder, or of the working
# directory of a notebook server started in notebooks/
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    globals().get("__file__", "notebook")))))

import numpy as np
import torch

from pyphysim_tpu_torch._device import require_cuda
from pyphysim_tpu_torch.channels.pathloss import (PathLoss3GPP1,
                                                  PathLossFreeSpace,
                                                  PathLossGeneral,
                                                  PathLossMetisPS7,
                                                  PathLossOkomuraHata)

DEVICE = globals().get("DEVICE", "cuda")
require_cuda(DEVICE)      # no CPU fallback: without a card, say DEVICE="cpu"


def km(values):
    """Distances as a float64 tensor on ``DEVICE``."""
    return torch.as_tensor(values, dtype=torch.float64, device=DEVICE)


d = km(np.linspace(0.05, 5.0, 100))  # distances in km

# %% [markdown]
# ## Free space
#
# `PL = 10 n log10(d) + 10 log10((4 pi fc / c)^2)` with path loss exponent
# n = 2 by default. Frequency matters: compare 900 MHz against 2.6 GHz.

# %%
pl_fs_900 = PathLossFreeSpace(n=2, fc=900.0)
pl_fs_2600 = PathLossFreeSpace(n=2, fc=2600.0)
at_1km = {"free space 900 MHz": float(pl_fs_900.calc_path_loss_dB(km(1.0))),
          "free space 2600 MHz":
              float(pl_fs_2600.calc_path_loss_dB(km(1.0)))}
print("Free space @1km, 900 MHz: ", at_1km["free space 900 MHz"], "dB")
print("Free space @1km, 2600 MHz:", at_1km["free space 2600 MHz"], "dB")

# %% [markdown]
# ## General A + B log10(d), 3GPP and Okomura-Hata

# %%
pl_general = PathLossGeneral(n=3.7, C=120.9)
pl_3gpp = PathLoss3GPP1()          # 128.1 + 37.6 log10(d)
pl_hata = PathLossOkomuraHata()
pl_hata.fc = 900.0
pl_hata.hbs = 30.0
pl_hata.hms = 1.5
pl_hata.area_type = "medium city"
at_1km["general"] = float(pl_general.calc_path_loss_dB(km(1.0)))
at_1km["3GPP"] = float(pl_3gpp.calc_path_loss_dB(km(1.0)))
at_1km["Okomura-Hata"] = float(pl_hata.calc_path_loss_dB(km(1.0)))
print("General   @1km:", at_1km["general"], "dB")
print("3GPP      @1km:", at_1km["3GPP"], "dB")
print("OkomuraHata@1km:", at_1km["Okomura-Hata"], "dB")

# %% [markdown]
# ## METIS PS7 indoor, with walls
#
# The indoor model takes the number of walls crossed; distances here are
# in meters.

# %%
pl_metis = PathLossMetisPS7(fc=2600.0)
d_m = km([5.0, 15.0, 30.0])
metis = {}
for walls in (0, 1, 3):
    metis[walls] = pl_metis._calc_deterministic_path_loss_dB(
        d_m, num_walls=torch.full(d_m.shape, walls, device=DEVICE))
    print(f"METIS PS7, {walls} walls:",
          metis[walls].cpu().numpy().round(1), "dB")

# %% [markdown]
# ## Shadowing and the inverse query
#
# Every model can add log-normal shadowing (for a tensor, drawn from the
# `torch.Generator` it is given), and `which_distance_dB` inverts the
# deterministic model: given a loss budget, how far does the signal reach?

# %%
pl_3gpp.use_shadow_bool = True
pl_3gpp.sigma_shadow = 8.0
shadow = torch.Generator(device=DEVICE).manual_seed(0)
sample = pl_3gpp.calc_path_loss_dB(km(np.full(5, 1.0)),
                                   shadow_generator=shadow)
print("3GPP @1km with 8 dB shadowing:", sample.cpu().numpy().round(1))
pl_3gpp.use_shadow_bool = False

budget_dB = 130.0
reach_km = float(pl_3gpp.which_distance_dB(km(budget_dB)))
print(f"3GPP range at {budget_dB} dB budget:", reach_km, "km")

# %% [markdown]
# ## The full picture

# %%
curves = {name: model.calc_path_loss_dB(d)
          for name, model in [("free space 2.6 GHz", pl_fs_2600),
                              ("general n=3.7", pl_general),
                              ("3GPP", pl_3gpp),
                              ("Okomura-Hata urban", pl_hata)]}
try:
    from matplotlib import pyplot as plt
    for name, pl in curves.items():
        plt.plot(d.cpu().numpy(), pl.cpu().numpy(), label=name)
    plt.xlabel("distance (km)"), plt.ylabel("path loss (dB)")
    plt.legend(), plt.grid(True)
    plt.savefig("pathloss_models.png", dpi=120)
    plt.close()
    print("Saved pathloss_models.png")
except ImportError:
    pass
