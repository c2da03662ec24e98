#!/usr/bin/env python3
"""Where the time goes in the port's per-key chain steps, on one card.

For the flagship block-static time-domain step (256 x 9,600 16-QAM
symbols, the shape ``bench.py`` times as ``value_time_domain``, and 32 x
9,600, the ``tu.perkey`` cell's sub-chunk), the fused diag step (512 x
4,800, ``value_xla_fused``), the Alamouti 2x1 chain step
(1,024 x 2,048 QPSK symbols, ``bench.py``'s ``ala_step``), the BD
capacity step (4,096 joint 6x6 channels, K = 3, normalized, ``bd_step``)
and the Max-SINR IA step (4,096 K = 3, 2x2 channels, 'svd' init, 10
iterations, noise 0.1, ``ia_step``):

  * the step split in two with CUDA events (best of 10 after a warm-up):
    drawing the inputs from the per-attempt streams, and ``forward``; and
    the host's time to issue ``forward`` (best of 20, the device waited
    for between calls), with, on the time-domain route, the host's time
    of one ``block_fir`` wrapper call at the forward's shape;
  * a ``torch.profiler`` trace of 3 steps: the busy share of the device
    (kernel time over wall time) and the kernels that take most of it;
    and traces of 3 draws alone and 3 forwards alone: the device kernels
    each issues a step, the draws' Philox fills (``philox_stream_fill``)
    among them, and ``block_fir``'s share of the forward's device time;
  * the 4x4 MIMO-OFDM step at the ``eva4x4.perkey`` cell's sub-chunk (32
    subframes of 4 x 14 x 1,200 symbols): the same split and trace;
  * the 4-layer PUSCH step at its benchmark sub-chunk (32 subframes of
    4 x 12 x 1,200 data symbols, ``apps/mimo/pusch_etu70_torch.py``): the
    same split and trace, and its two stages by their spans: the host
    time of the eager step's ``chain.estimate`` and ``chain.equalize``
    spans under the profiler, and each stage's device time (a CUDA graph
    of the calls the span holds: the DMRS estimate; the equalizer, the
    de-spreading IDFT and the decision kernel), beside the step whole,
    replayed and eager;
  * on the two OFDM routes, ``ChainStep.step`` whole (CUDA events over
    one step, and the host's time to issue it): the route the checkout's
    step takes, one CUDA graph replay where it has one, and beside it the
    step launched op by op (``step_eager``) where the checkout has both;
  * the per-key engine over 1,024 attempts in chunks of 256, without a
    stop criterion (double-buffered) and with one that never trips
    (8 synchronous sub-chunks of 32 per chunk): the cost of the
    per-sub-chunk host check.

Run from the repository root: ``python3 bin/profile_chain_torch.py
[--json PATH] [--only NAME,...]``, the names among ``time_domain``,
``fused``, ``time_domain_cell``, ``families``, ``mimo``, ``pusch`` and
``engine`` (all by default). Needs a CUDA device. It reads only names an older
checkout also has, so a copy of it in that checkout's ``bin/`` measures
that checkout with the same yardstick.
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
ROUTES = {"time_domain": (256, 300 * 32, False),
          "fused": (512, 300 * 16, True),
          "time_domain_cell": (32, 300 * 32, False)}
SECTIONS = (*ROUTES, "families", "mimo", "pusch", "engine")


def best_ms(fn, repeat=10):
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


def host_ms(fn, repeat=20):
    """Best host time of one ``fn()`` in ms: what issuing its work takes,
    the device idle at the start of each call."""
    import torch
    best = float("inf")
    for _ in range(repeat):
        torch.cuda.synchronize()
        tic = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - tic)
    torch.cuda.synchronize()
    return best * 1e3


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


def trace(fn, repeat=3):
    """``[(key, device us, count)]`` of ``repeat`` calls of ``fn`` under
    ``torch.profiler``, and the traced wall time in us."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tic = time.perf_counter()
        for _ in range(repeat):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - tic) * 1e6
    return ([(e.key, kernel_time_us(e), e.count)
             for e in prof.key_averages()], wall_us)


def kernels(events, name="", repeat=3):
    """Device kernels (and copies) a call among ``events``, of those whose
    key holds ``name``."""
    return sum(c for k, t, c in events if t > 0 and name in k) / repeat


def profile_step(name, batch, units, unit_name, draw, forward):
    """Time ``forward(*draw())`` (one chain step of ``batch`` attempts doing
    ``units`` units of work), its two halves, and trace 3 steps."""
    inputs = draw()

    def step():
        return forward(*draw())

    step_ms = best_ms(step)
    draw_ms = best_ms(draw)
    forward_ms = best_ms(lambda: forward(*inputs))
    forward_host_ms = host_ms(lambda: forward(*inputs))

    events, wall_us = trace(step)
    busy_us = sum(t for _, t, _ in events)
    top = sorted((e for e in events if e[1] > 0), key=lambda e: -e[1])[:12]
    draw_events, _ = trace(draw)
    forward_events, _ = trace(lambda: forward(*inputs))
    forward_us = sum(t for _, t, _ in forward_events)
    fir_us = sum(t for k, t, _ in forward_events if "block_fir" in k)
    out = {
        "route": name, "batch": batch, "units_per_step": units,
        "step_ms": step_ms, f"{unit_name}_per_s": units / step_ms * 1e3,
        "draw_ms": draw_ms, "forward_ms": forward_ms,
        "forward_host_ms": forward_host_ms,
        "traced_wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
        "device_busy_share": busy_us / wall_us,
        "device_kernels_per_step": kernels(events),
        "draw_kernels_per_step": kernels(draw_events),
        "draw_fills_per_step": kernels(draw_events, "philox_stream_fill"),
        "forward_kernels_per_step": kernels(forward_events),
        "forward_device_ms": forward_us / 3e3,
        "block_fir_ms_per_step": fir_us / 3e3,
        "block_fir_share_of_forward_device": fir_us / forward_us,
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

    out = profile_step(name, batch, batch * num_symbols, "sym", draw,
                       lambda *x: chain.forward(*x, SNR))
    routes = {"step": chain.step}
    if hasattr(chain, "step_eager"):
        routes["step_eager"] = chain.step_eager
    for label, fn in routes.items():
        out[f"{label}_whole_ms"] = best_ms(lambda: fn(streams, SNR))
        out[f"{label}_whole_host_ms"] = host_ms(lambda: fn(streams, SNR))
    print(json.dumps({"route": name, **{k: v for k, v in out.items()
                                        if "_whole_" in k}}), flush=True)
    if not fused:
        from chip_smoke import fir_inputs
        from pyphysim_tpu_torch.ops import fir
        rows = batch * (num_symbols // chain.ofdm.num_used_subcarriers)
        args = fir_inputs(dev, rows)
        out["block_fir_rows"] = rows
        out["block_fir_wrapper_host_ms"] = host_ms(
            lambda: fir.block_fir(*args))
        print(json.dumps({"route": name, "block_fir_wrapper_host_ms":
                          out["block_fir_wrapper_host_ms"]}), flush=True)
    return out


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


def profile_mimo(dev):
    """The 4x4 MIMO-OFDM step's split and trace at the cell's sub-chunk."""
    from apps.mimo.mimo_ofdm_tdl_torch import eva_channel
    from pyphysim_tpu_torch.mimo_chain import MimoChainStep
    from pyphysim_tpu_torch.ops.streams import AttemptStreams

    batch = 32
    step = MimoChainStep(4, 4, 16, 1200 * 14, 2048, 144, 1200,
                         eva_channel(4, 4, device=dev), device=dev)
    streams = AttemptStreams.from_range(7, 0, batch, dev)
    out = profile_step("mimo4x4", batch, batch * step.num_tx *
                       step.num_symbols, "sym",
                       lambda: step.draw(*streams.split(3)),
                       lambda *x: step.forward(*x, SNR))
    out["step_replayed_ms"] = best_ms(lambda: step.step(streams, SNR))
    out["step_eager_ms"] = best_ms(lambda: step.step_eager(streams, SNR))
    print(json.dumps({"route": "mimo4x4", "step_replayed_ms":
                      out["step_replayed_ms"], "step_eager_ms":
                      out["step_eager_ms"]}), flush=True)
    return out


def profile_pusch(dev):
    """The PUSCH step's split and trace, its spans' host time and its two
    stages' device time (the module docstring)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from apps.mimo.pusch_etu70_torch import pusch_step
    from chip_smoke import graph_ms
    from pyphysim_tpu_torch import tracing
    from pyphysim_tpu_torch.ops.mimo_detect import sc_decide, sc_mmse_eq
    from pyphysim_tpu_torch.ops.streams import AttemptStreams

    batch = 32
    step = pusch_step(dev)
    streams = AttemptStreams.from_range(7, 0, batch, dev)
    out = profile_step("pusch", batch, batch * step.num_tx *
                       step.num_symbols, "sym",
                       lambda: step.draw(*streams.split(3)),
                       lambda *x: step.forward(*x, SNR))
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        for _ in range(3):
            step.step_eager(streams, SNR)
        torch.cuda.synchronize()
    spans = {}
    for r in tracing.spans():
        spans.setdefault(r.name, []).append((r.end_ns - r.start_ns) * 1e-6)
    data, state, noise = step.draw(*streams.split(3))
    fwd = step.forward(data, state, noise, SNR)
    K = step.ofdm.num_used_subcarriers
    frames = fwd.received.reshape(batch, step.num_rx,
                                  step.symbols_per_subframe, K)
    pilots = frames.index_select(2, step._pilot_index)
    s2 = torch.full((), step.noise_amplitude(SNR) ** 2 * step._var_scale,
                    dtype=torch.float32, device=dev)

    def equalize():
        x, gain = sc_mmse_eq(fwd.estimate, frames, s2, step.data_symbols)
        return sc_decide(torch.fft.ifft(x, norm="ortho"), gain.mean(dim=-1),
                         data, step.qam.M)
    stages = {
        "span_host_ms": {k: min(v) for k, v in spans.items()
                         if k in ("chain.estimate", "chain.equalize")},
        "estimate_device_ms": graph_ms(
            lambda: step.estimator.estimate_channel_freq_domain(
                pilots, step.taps_to_keep)),
        "equalize_device_ms": graph_ms(equalize),
        "step_replayed_ms": best_ms(lambda: step.step(streams, SNR)),
        "step_eager_ms": best_ms(lambda: step.step_eager(streams, SNR))}
    print(json.dumps({"route": "pusch", **stages}, indent=1), flush=True)
    out.update(stages)
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
    parser.add_argument("--only", default=",".join(SECTIONS),
                        help="comma-separated sections to run, of "
                        + ", ".join(SECTIONS))
    args = parser.parse_args()
    only = args.only.split(",")
    unknown = sorted(set(only) - set(SECTIONS))
    if unknown:
        parser.error(f"unknown sections {unknown}")
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
    routes = [profile_route(name, *shape, dev)
              for name, shape in ROUTES.items() if name in only]
    if "families" in only:
        routes += profile_families(dev)
    routes += [fn(dev) for name, fn in (("mimo", profile_mimo),
                                        ("pusch", profile_pusch))
               if name in only]
    result = {"card": card, "routes": routes}
    if "engine" in only:
        result["per_key_engine"] = engine_stop_cost(dev)
    if args.json:
        os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
