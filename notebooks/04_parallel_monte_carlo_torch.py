# %% [markdown]
# # Parallel Monte Carlo on a device mesh (PyTorch port)
#
# The port's counterpart of `04_parallel_monte_carlo.py`. PyTorch runs one
# process per device, so a mesh is a `torch.distributed` `DeviceMesh` over
# the ranks of a process group: NCCL for the card, gloo for the CPU. The
# two sharding axes of the framework:
#
# 1. **Realization sharding** — `SimulationRunner.simulate_in_parallel`
#    splits every chunk of attempts over the mesh: rank `r` runs its rows
#    from the streams of their absolute attempts, and the rows are
#    all-gathered, bit for bit the serial result.
# 2. **Time sharding** — `corrupt_data_time_sharded` splits one long
#    symbol stream over the ranks; each runs the block-static channel on
#    its shard (on the card through the `block_fir` CUDA kernel) and sends
#    the convolution's spill-over to the next rank.
#
# In a notebook the mesh is this process's own group, world size 1
# (`make_mesh` starts it). For several cards of a node, run
# `bin/weak_scaling_curve_torch.py` under one process a card; below, the
# time-sharded stream is also cut into 4 shards computed here, their halos
# added as the ranks would receive them.
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

import math

import numpy as np
import torch
import torch.distributed as dist

from pyphysim_tpu_torch._device import require_cuda
from pyphysim_tpu_torch.modulators import QPSK
from pyphysim_tpu_torch.ops.streams import AttemptStreams
from pyphysim_tpu_torch.parallel import make_mesh
from pyphysim_tpu_torch.simulations import Result, SimulationRunner
from pyphysim_tpu_torch.utils.conversion import dB2Linear
from pyphysim_tpu_torch.utils.misc import count_bit_errors, randn_c

DEVICE = globals().get("DEVICE", "cuda")
require_cuda(DEVICE)      # no CPU fallback: without a card, say DEVICE="cpu"
SEED = 2024

started_group = not dist.is_initialized()
mesh = make_mesh(device=DEVICE)
print("mesh:", mesh, "backend:", dist.get_backend())


# %% A per-key runner: declare result types, return a kernel of streams
class QpskAwgnRunner(SimulationRunner):
    def __init__(self):
        super().__init__(read_command_line_args=False)
        self.device = DEVICE
        self.params.add("SNR", np.arange(0.0, 16.0, 5.0))
        self.params.set_unpack_parameter("SNR")
        self.rep_max = 512
        self.update_progress_function_style = None
        self.batch_result_types = {"ber": Result.RATIOTYPE}

    def _gen_simulation_kernel(self, current_params):
        snr = dB2Linear(float(current_params["SNR"]))
        mod = QPSK(device=DEVICE)
        n = 512

        def kernel(streams):
            s_data, s_noise = streams.split(2)
            data = s_data.integers(4, (n,))
            rx = mod.modulate(data) + randn_c(s_noise, n) * math.sqrt(1 / snr)
            errors = count_bit_errors(data, mod.demodulate(rx), axis=-1)
            return {"ber": (errors, float(2 * n))}

        return kernel


# %% Serial vs mesh-parallel: the SAME results, bit for bit
runner_serial = QpskAwgnRunner()
runner_serial.simulate()
runner_parallel = QpskAwgnRunner()
runner_parallel.simulate_in_parallel(mesh)

equal = []
for snr, r_s, r_p in zip(runner_serial.params["SNR"],
                         runner_serial.results["ber"],
                         runner_parallel.results["ber"]):
    equal.append(r_s.get_result() == r_p.get_result())
    print(f"SNR {snr:5.1f} dB: serial BER {r_s.get_result():.5f}  "
          f"parallel BER {r_p.get_result():.5f}  equal: {equal[-1]}")

# %% [markdown]
# ## Time-sharding one long stream
#
# A single long OFDM transmission is split over the mesh: every rank
# computes its channel taps from the closed-form Jakes state (`skip` is
# O(1)) and passes the convolution halo to the next rank. On this
# process's 1-rank mesh the call is the whole stream; the 4 shards below
# are what 4 ranks would compute, with the halos added as they receive
# them. Both agree with the unsharded channel to float32 rounding of the
# skipped Jakes clock.

# %%
from pyphysim_tpu_torch.channels import (COST259_TUx, JakesSampleGenerator,
                                         TdlChannel)
from pyphysim_tpu_torch.modulators import OFDM, QAM, OfdmOneTapEqualizer
from pyphysim_tpu_torch.parallel import corrupt_data_time_sharded
from pyphysim_tpu_torch.parallel.timeshard import corrupt_shard

fft, cp, used = 512, 52, 300
qam, ofdm = QAM(16, device=DEVICE), OFDM(fft, cp, used, device=DEVICE)
channel = TdlChannel(JakesSampleGenerator(Fd=30.0, Ts=1 / 20e6, L=16,
                                          device=DEVICE), COST259_TUx)
equalizer = OfdmOneTapEqualizer(ofdm)
time_mesh = make_mesh(axis_name="time", device=DEVICE)
block = ofdm.samples_per_symbol
num_shards = 4                   # the shards computed in this process
n_sym = 2 * num_shards

# one attempt's streams (a leading axis of 1): data, channel and noise
s_data, s_channel, s_noise = AttemptStreams.from_range(
    SEED, 0, 1, DEVICE).split(3)
data = s_data.integers(16, (used * n_sym,))
tx = ofdm.modulate(qam.modulate(data))
state = channel.init_state(s_channel)
noise = randn_c(s_noise, tx.shape[-1]) * math.sqrt(10 ** -1.5)

rx_sharded, ir, _ = corrupt_data_time_sharded(channel, state, tx, block,
                                              time_mesh)
rx_ref, ir_ref, _ = channel.corrupt_data(state, tx, block_size=block)
rx_ref = rx_ref[..., :tx.shape[-1]]

shards = [corrupt_shard(channel, state, tx, block, i, num_shards)
          for i in range(num_shards)]
mains = [main for main, _, _ in shards]
for i in range(1, num_shards):
    tail = shards[i - 1][1]
    mains[i][..., :tail.shape[-1]] += tail
rx_shards = torch.cat(mains, dim=-1)

max_abs_err = {"time-sharded": float((rx_sharded - rx_ref).abs().max()),
               f"{num_shards} shards": float((rx_shards - rx_ref).abs().max())}
print("max |sharded - unsharded|:", max_abs_err)

bit_errors = {}
for name, rx, ir_ in (("time-sharded", rx_sharded, ir),
                      ("unsharded   ", rx_ref, ir_ref)):
    eq = equalizer.equalize_data(ofdm.demodulate(rx + noise), ir_)
    bit_errors[name.strip()] = int(count_bit_errors(
        data, qam.demodulate_hard(eq)))
    print(f"{name}: {bit_errors[name.strip()]} bit errors / "
          f"{used * n_sym * 4}")

# %% This process's group, if the notebook started it, ends here
if started_group:
    dist.destroy_process_group()
