#!/usr/bin/env python3
"""Where the time goes in the port's per-key chain steps, on one card.

For the flagship block-static time-domain step (256 x 9,600 16-QAM
symbols, the shape ``bench.py`` times as ``value_time_domain``), the fused
diag step (512 x 4,800, ``value_xla_fused``), the Alamouti 2x1 chain step
(1,024 x 2,048 QPSK symbols, ``bench.py``'s ``ala_step``), the BD
capacity step (4,096 joint 6x6 channels, K = 3, normalized, ``bd_step``)
and the Max-SINR IA step (4,096 K = 3, 2x2 channels, 'svd' init, 10
iterations, noise 0.1, ``ia_step``):

  * the step split in two with CUDA events (best of 3 after a warm-up):
    drawing the inputs from the per-attempt streams, and ``forward``;
  * a ``torch.profiler`` trace of 3 steps: the busy share of the device
    (kernel time over wall time) and the kernels that take most of it;
  * the per-key engine over 1,024 attempts in chunks of 256, without a
    stop criterion (double-buffered) and with one that never trips
    (8 synchronous sub-chunks of 32 per chunk): the cost of the
    per-sub-chunk host check.

Run from the repository root: ``python3 bin/profile_chain_torch.py
[--json PATH]``. Needs a CUDA device.
"""

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

SNR = 10 ** 1.5
ROUTES = {"time_domain": (256, 300 * 32, False), "fused": (512, 300 * 16, True)}


def best_ms(fn, repeat=3):
    import torch
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(repeat):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        best = min(best, start.elapsed_time(stop))
    return best


def kernel_time_us(event):
    """Device time of a device-side event (a kernel or a copy); 0 for the
    host-side operators, whose device time their kernels already carry."""
    from torch.autograd import DeviceType
    if event.device_type != DeviceType.CUDA:
        return 0.0
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, name):
            return float(getattr(event, name))
    return 0.0


def profile_step(name, batch, units, unit_name, draw, forward):
    """Time ``forward(*draw())`` (one chain step of ``batch`` attempts doing
    ``units`` units of work), its two halves, and trace 3 steps."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    inputs = draw()

    def step():
        return forward(*draw())

    step_ms = best_ms(step)
    draw_ms = best_ms(draw)
    forward_ms = best_ms(lambda: forward(*inputs))

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tic = time.perf_counter()
        for _ in range(3):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - tic) * 1e6
    events = [(e.key, kernel_time_us(e), e.count)
              for e in prof.key_averages()]
    busy_us = sum(t for _, t, _ in events)
    top = sorted((e for e in events if e[1] > 0), key=lambda e: -e[1])[:12]
    out = {
        "route": name, "batch": batch, "units_per_step": units,
        "step_ms": step_ms, f"{unit_name}_per_s": units / step_ms * 1e3,
        "draw_ms": draw_ms, "forward_ms": forward_ms,
        "traced_wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
        "device_busy_share": busy_us / wall_us,
        "device_kernels_per_step": sum(c for _, t, c in events if t > 0) / 3,
        "block_fir_ms_per_step": sum(t for k, t, _ in events
                                     if "block_fir" in k) / 3e3,
        "top_kernels": [{"kernel": k[:90], "ms_per_step": t / 3e3,
                         "share_of_busy": t / busy_us, "calls": c}
                        for k, t, c in top],
    }
    print(json.dumps(out, indent=1), flush=True)
    return out


def profile_route(name, batch, num_symbols, fused, dev):
    from pyphysim_tpu_torch.chain import ChainStep
    from pyphysim_tpu_torch.ops.streams import AttemptStreams
    from pyphysim_tpu_torch.utils.misc import randn_c, random_symbols

    chain = ChainStep(num_symbols, 512, 52, 300, block_static=True,
                      fused=fused, device=dev)
    streams = AttemptStreams.from_range(7, 0, batch, dev)

    def draw():
        s_data, s_channel, s_noise = streams.split(3)
        return (random_symbols(s_data, num_symbols, chain.qam.K),
                chain.channel.init_state(s_channel),
                randn_c(s_noise, chain.noise_length))

    return profile_step(name, batch, batch * num_symbols, "sym", draw,
                        lambda *x: chain.forward(*x, SNR))


def profile_families(dev):
    """The Alamouti 2x1 step at 10 dB, and the BD and Max-SINR IA capacity
    steps at the bench points, through the per-key apps' own draw and
    chain."""
    from apps.comp_BD.batched_bd_capacity_torch import bd_capacity
    from apps.mimo.simulate_mimo_torch import MimoSimulationRunner
    from chip_smoke import ia_capacity
    from pyphysim_tpu_torch.ops.streams import AttemptStreams
    from pyphysim_tpu_torch.utils.misc import randn_c

    ala = MimoSimulationRunner("alamouti", 1, device=dev,
                               read_command_line_args=False)
    ala.NSymbs = 2048
    streams = AttemptStreams.from_range(7, 0, 1024, dev)
    out = [profile_step("alamouti", 1024, 1024 * 2048, "sym",
                        lambda: ala.draw(streams),
                        lambda *x: ala.forward(*x, 10.0))]
    streams = AttemptStreams.from_range(7, 0, 4096, dev)
    out.append(profile_step(
        "bd", 4096, 4096, "solves", lambda: (randn_c(streams, 6, 6),),
        lambda H: bd_capacity(H, 3, 10.0 / 3, 1.0, "normalized")))
    out.append(profile_step(
        "ia", 4096, 4096, "solves",
        lambda: (randn_c(streams, 3, 3, 2, 2),), ia_capacity))
    return out


def engine_stop_cost(dev):
    import numpy as np
    from apps.ofdm.ofdm_tdlchannel_torch import OfdmTdlSimulationRunner
    from pyphysim_tpu_torch.chain import ChainStep

    batch, num_symbols, _ = ROUTES["time_domain"]
    chain = ChainStep(num_symbols, 512, 52, 300, block_static=True,
                      device=dev)
    out = {}
    for label, stop in (("no_stop_criterion", None),
                        ("stop_criterion_8_subchunks",
                         ("bit_errors", 1e18))):
        r = OfdmTdlSimulationRunner(device=dev, read_command_line_args=False)
        r.params.add("SNR", np.array([15.0]))
        r.chain = chain
        r.rep_max, r.batch_size = 4 * batch, batch
        r.batch_stop_criterion = stop
        r.num_stop_subchunks = 8
        r.update_progress_function_style = None
        ms = best_ms(r.simulate)
        out[label] = {"ms": ms, "sym_per_s": 4 * batch * num_symbols / ms
                      * 1e3, "kernel_calls_per_run": r.chunks_dispatched // 4}
    print(json.dumps({"per_key_engine": out}, indent=1), flush=True)
    return out


def main() -> int:
    import torch
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--json", default=None,
                        help="also write the results to this file")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_chain_torch: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    result = {"card": card,
              "routes": [profile_route(name, *shape, dev)
                         for name, shape in ROUTES.items()] +
              profile_families(dev),
              "per_key_engine": engine_stop_cost(dev)}
    if args.json:
        os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
