# %% [markdown]
# # CoMP block diagonalization with external interference (PyTorch port)
#
# The port's counterpart of `08_comp_bd_stream_sacrifice.py`, through
# `apps/comp_BD/simulate_comp_torch.py`: a 3-cell cluster jointly
# transmits to one user per cell with Block Diagonalization precoding
# while an external interference source sits at the cluster border.
# Sacrificing transmit streams in the directions the interference occupies
# can buy back a lot of SER — `EnhancedBD` decides how many streams to
# drop per user using one of several metrics, and `WhiteningBD` whitens
# instead.
#
# The whole study runs on the device engine: each chunk of repetitions
# drops users at random positions (host-side geometry), then one batch of
# device work draws the path-loss-scaled channels, solves every precoder
# and pushes the transmit chain for every repetition of the chunk
# (`pyphysim_tpu_torch.comm.batched`). The draws come from the Philox
# streams of each repetition's attempt, on the card through the
# `philox_stream_fill` kernel, so the card and the CPU see the same bits.
#
# Runs on the card by default; `runpy.run_path(path, init_globals=
# {"DEVICE": "cpu"})` runs it on the CPU.

# %%
import os
import sys

# the repository root: the parent of this file's folder, or of the working
# directory of a notebook server started in notebooks/
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(
    globals().get("__file__", "notebook"))))
sys.path.insert(0, ROOT)

import numpy as np

from apps.comp_BD.simulate_comp_torch import METRICS, BDSimulationRunner
from pyphysim_tpu_torch._device import require_cuda

DEVICE = globals().get("DEVICE", "cuda")
require_cuda(DEVICE)      # no CPU fallback: without a card, say DEVICE="cpu"

# %% [markdown]
# ## The scenario runner
#
# `BDSimulationRunner` reads the reference-shaped config
# (`apps/comp_BD/bd_config_file.txt`) — grid geometry, (SNR, Pe_dBm)
# sweep, modulation — and simulates every stream-sacrifice metric at
# once, sharing the data / interference / noise draws across metrics so
# per-repetition comparisons are paired.

# %%
runner = BDSimulationRunner(read_command_line_args=False, device=DEVICE)
runner.params.add("SNR", np.array([20.0]))
runner.params.add("Pe_dBm", np.array([10.0]))  # strong interferer
runner.params.add("NSymbs", 200)
runner.rep_max = 32
runner.batch_size = 32
runner.update_progress_function_style = None
runner.simulate()

# %%
print(f"{'metric':>18} {'SER':>9} {'PER':>7} {'spec effic':>11}")
ser = {}
for m in METRICS:
    ser[m] = float(runner.results.get_result_values_list(f"ser_{m}")[0])
    per = float(runner.results.get_result_values_list(f"per_{m}")[0])
    se = float(
        runner.results.get_result_values_list(f"spec_effic_{m}")[0])
    print(f"{m:>18} {ser[m]:9.4f} {per:7.3f} {se:11.2f}")

# %% [markdown]
# With a strong external interferer the "None" row (no stream
# reduction) suffers: the receiver has no spatial dimensions left to
# dodge the interference. The `capacity` / `effective_throughput`
# metrics sacrifice a stream exactly when that trade is worth it, and
# `WhiteningBD` gets part of the benefit without dropping streams.
#
# ## Non-square geometry
#
# The device solvers are shape-general for `Nt_u >= Nr_u`: with more
# transmit than receive antennas per base station the null spaces grow,
# and the precoder keeps the best `Nr_u` stream directions of the FULL
# null space. A shipped config exercises it:

# %%
cfg = os.path.join(ROOT, "apps", "comp_BD", "bd_config_file_nonsquare.txt")
ns_runner = BDSimulationRunner(
    read_command_line_args=False, default_config_file=cfg,
    metrics=["None", "capacity", "Whitening"], device=DEVICE)
ns_runner.params.add("SNR", np.array([20.0]))
ns_runner.params.add("Pe_dBm", np.array([10.0]))
ns_runner.params.add("NSymbs", 200)
ns_runner.rep_max = 16
ns_runner.batch_size = 16
ns_runner.update_progress_function_style = None
ns_runner.simulate()
ns_ser = {}
for m in ns_runner.metrics:
    ns_ser[m] = float(
        ns_runner.results.get_result_values_list(f"ser_{m}")[0])
    print(f"Nt=3 > Nr=2  {m:>10}: SER {ns_ser[m]:.4f}")

# %% [markdown]
# ## Parity anchor
#
# `engine="host"` runs the same scenario through the per-repetition
# host solver classes (`EnhancedBD` / `WhiteningBD` objects, the
# reference's flow) — useful for validating the device program on a
# new geometry. The test suite pins the two engines against each other
# (`tests/test_torch_comp_bd_host.py`), and the device engine against the
# JAX package (`tests/test_torch_comp_bd_app.py`).
