# %% [markdown]
# # The kernel tier: whole Monte Carlo repetitions in one CUDA kernel
# (PyTorch port)
#
# The port's counterpart of `09_kernel_tier_monte_carlo.py`. The fastest
# execution tier of `pyphysim_tpu_torch` runs an ENTIRE Monte Carlo
# repetition inside one hand-written CUDA kernel for the H100 (`sm_90a`,
# `pyphysim_tpu_torch/ops/csrc/`): data bits, channels and noise come
# from Philox4x32-10 streams computed in the kernel, every intermediate
# lives in registers and shared memory, and the only global-memory traffic
# is one reduced number per block. Four families have kernels; their
# times, measured by `chip_smoke.py` on an NVIDIA H100 80GB HBM3 at a
# 700 W power limit (PERF.md §6):
#
# | family | class | time of one call |
# |---|---|---|
# | OFDM/TDL BER (flagship) | `ops.mc_kernel.MonteCarloOfdmTdl` | 0.4570 ms, 32 reps x 4 tiles, float32 product |
# | Alamouti 2x1 QPSK BER | `ops.alamouti_kernel.MonteCarloAlamouti` | 0.3831 ms, 512 reps x 4 tiles x 64 x 256 |
# | Max-SINR IA sum capacity | `ops.ia_kernel.MonteCarloMaxSinr` | 1.3021 ms, 2,097,152 solves at (3, 2, 1), 10 iterations |
# | BD CoMP sum capacity | `ops.bd_kernel.MonteCarloBD` | 0.5840 ms, 2,097,152 solves at (3, 2) |
#
# Each kernel takes every geometry its JAX counterpart takes (users x
# antennas x streams; one outside the prebuilt kernel library is compiled
# into a library of its own on its first launch) and can split its
# repetition axis over the ranks of a device mesh bit for bit.
# Every kernel sits beside its plain PyTorch version, which takes CPU
# tensors; the kernels' randomness is injectable (`build_inject`), so the
# same math runs on the card and on the CPU from the same bits.
#
# Runs on the card by default; `runpy.run_path(path, init_globals=
# {"DEVICE": "cpu"})` runs the plain versions on the CPU.

# %%
import os
import sys

# the repository root: the parent of this file's folder, or of the working
# directory of a notebook server started in notebooks/
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    globals().get("__file__", "notebook")))))

import numpy as np
import torch
import torch.distributed as dist

from pyphysim_tpu_torch._device import require_cuda

DEVICE = globals().get("DEVICE", "cuda")
require_cuda(DEVICE)      # no CPU fallback: without a card, say DEVICE="cpu"

# %% [markdown]
# ## A BD capacity sweep riding the kernel, at a non-bench geometry
#
# `BDKernelCapacityRunner` plugs the BD kernel into `SimulationRunner`
# through the bulk-kernel extension point: the kernel owns the
# repetition axis and draws each attempt's channels from its Philox
# stream, the runner owns the parameter sweep, Result accumulation and
# checkpoint/resume. `K`/`nr_u` pick the geometry — here 2 users x 2
# antennas (not the K=3 bench point).

# %%
from apps.comp_BD.batched_bd_capacity_torch import BDKernelCapacityRunner

runner = BDKernelCapacityRunner(K=2, nr_u=2, tile=8, lane=128,
                                num_tiles=1, device=DEVICE,
                                read_command_line_args=False)
runner.params.add("Pu_dB", np.array([-5.0, 5.0, 15.0]))
runner.rep_max = 2
runner.batch_size = 2
runner.update_progress_function_style = None
runner.simulate()
caps = np.array(runner.results.get_result_values_list("sum_capacity"))
print("per-BS power (dB):", runner.results.params["Pu_dB"])
print("mean BD sum capacity (b/s/Hz):", np.round(caps, 2))

# %% [markdown]
# ## The IA kernel's geometries: users x antennas x streams
#
# `MonteCarloMaxSinr(K=, N=, Ns=)` picks the kernel instance from the
# geometry. The (N, Ns) = (2, 1) point runs closed-form 2x2 algebra
# (`mc_ia_closed_kernel`); other points (e.g. 4x4 antennas, 2 streams a
# user) run the general kernel with unrolled LDL^H solves
# (`mc_ia_general_kernel`); a geometry outside the prebuilt library runs
# the same bodies in `mc_ia_wide_kernel`. The bits are numpy's, injected,
# so the JAX package's kernel bodies can be held to the same numbers.

# %%
from pyphysim_tpu_torch.ops.ia_kernel import MonteCarloMaxSinr

ia_kernels, ia_bits, ia_capacity = {}, {}, {}
for K, N, Ns in [(3, 2, 1), (2, 4, 2)]:
    mc = MonteCarloMaxSinr(tile=8, lane=128, iterations=4, K=K, N=N, Ns=Ns,
                           device=DEVICE)
    bits = np.random.default_rng(7).integers(
        0, 2 ** 32, (1, mc.tile, mc.num_planes * mc.lane), dtype=np.uint32)
    cap = float(mc.build_inject(1, 1)(bits, 0.1).sum())
    per_solve = cap / (mc.tile * mc.lane)
    ia_kernels[K, N, Ns], ia_bits[K, N, Ns] = mc, bits
    ia_capacity[K, N, Ns] = per_solve
    print(f"(K={K}, {N}x{N}, Ns={Ns}): mean sum capacity "
          f"{per_solve:.2f} b/s/Hz")

# %% [markdown]
# ## Sharding the kernel tier over a mesh
#
# Every kernel keys its random streams by the ABSOLUTE repetition index,
# so splitting the rep axis over the ranks of a mesh (rank `i` runs the
# rows `[i * reps_local, (i + 1) * reps_local)` and the rows are
# all-gathered) gives results BIT-identical to the unsharded kernel. In a
# notebook the mesh is this process's own group, world size 1; the 2- and
# 4-rank splits are shown as the launches each rank would make on the
# rows it owns, concatenated in rank order. (NCCL runs one rank a card:
# `bin/weak_scaling_curve_torch.py` runs the collectives over the cards
# of a node.)

# %%
from pyphysim_tpu_torch.ops.bd_kernel import MonteCarloBD
from pyphysim_tpu_torch.parallel import make_mesh

started_group = not dist.is_initialized()
mesh = make_mesh(device=DEVICE)
mc = MonteCarloBD(tile=8, lane=128, K=2, Nr_u=1, device=DEVICE)
reps = 8
bits = np.random.default_rng(3).integers(
    0, 2 ** 32, (reps, mc.tile, mc.num_planes * mc.lane), dtype=np.uint32)
one = mc.build_inject(reps, 1)(bits)
sharded = {1: mc.build_inject(reps, 1, mesh=mesh)(bits)}
for ranks in (2, 4):
    local = reps // ranks
    sharded[ranks] = torch.cat([
        mc.build_inject(local, 1)(bits[r * local:(r + 1) * local])
        for r in range(ranks)])
equal = {ranks: torch.equal(out, one) for ranks, out in sharded.items()}
print("sharded == unsharded, bit-identical, by ranks:", equal)

if started_group:      # this process's group, if the notebook started it
    dist.destroy_process_group()

# %% [markdown]
# On several cards the same `build(...)` call takes `mesh=` too, and
# `SimulationRunner.simulate_in_parallel(mesh)` drives any of these
# kernels through the same sweep/checkpoint machinery — see
# `apps/mimo/alamouti_mc_kernel_torch.py`, `apps/ia/ia_mc_kernel_torch.py`
# and `apps/comp_BD/batched_bd_capacity_torch.py` for the three family
# apps, and PERF.md for the kernels' times against their bounds.
