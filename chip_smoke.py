#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA card.

Drives the port's main path — the flagship OFDM-over-TDL Monte Carlo BER
sweep through ``SimulationRunner``'s bulk path and the hand-written CUDA
kernel — at full width, and checks every kernel of that path against its
plain PyTorch version on the card. One line per phase; any failure raises
and the script exits non-zero. There is no CPU fallback: without a CUDA
device it fails before printing any result.

Run from the repository root: ``python3 chip_smoke.py`` (one card, a few
minutes including the nvcc build).
"""

import json
import subprocess
import sys
import time

BER_CORNERS = {5.0: (0.08, 0.22), 15.0: (0.02, 0.06), 30.0: (2e-4, 6e-3)}
TILE, NUM_TILES = 1024, 4           # flagship kernel shape
REL_TOL = 2e-4                      # |kernel - plain| per cell / cell bits


def phase(name, **fields):
    print(f"[{name}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def best_ms(fn, repeat=3, inner=1):
    """Best of ``repeat`` CUDA-event timings of ``inner`` calls, in ms per
    call (after one warm-up call)."""
    import torch
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(repeat):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        stop.record()
        stop.synchronize()
        best = min(best, start.elapsed_time(stop) / inner)
    return best


def check_cells(name, got, want, cell_bits):
    import torch
    diff = (got.to(torch.int64) - want.to(torch.int64)).abs()
    limit = REL_TOL * cell_bits
    max_abs = int(diff.max())
    total = int(want.sum())
    phase(name, max_abs_cell_diff=max_abs, limit=limit, total_errors=total)
    if max_abs > limit or total <= 0:
        raise AssertionError(f"{name}: kernel and plain version disagree "
                             f"(max |diff| {max_abs} > {limit}) or no errors")
    return max_abs


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    import numpy as np

    from apps.ofdm.ofdm_mc_kernel_torch import OfdmMcKernelSimulationRunner
    from pyphysim_tpu_torch.ops import _build, philox
    from pyphysim_tpu_torch.ops.mc_kernel import MonteCarloOfdmTdl

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    phase("device", nvidia_smi=repr(smi), torch=torch.__version__,
          cuda=torch.version.cuda,
          matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
          cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)

    # 2. build
    tic = time.time()
    lib_path = _build.build()
    _build.load()
    phase("build", seconds=time.time() - tic, nvcc_seconds=_build.build_seconds,
          library=lib_path.name)
    log = lib_path.with_suffix(".log")
    for line in log.read_text().splitlines() if log.exists() else []:
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())

    # 3. Philox on the device, bit for bit
    n = 1 << 20
    g = torch.Generator(device=dev).manual_seed(7)
    ctr = torch.randint(0, 2 ** 32, (n, 4), dtype=torch.int64, device=dev,
                        generator=g)
    key = (0x12345678, 0x9ABCDEF0)
    want = philox.to_int32_bits(torch.stack(
        philox.philox4x32_10(ctr[:, 0], ctr[:, 1], ctr[:, 2], ctr[:, 3],
                             *key), dim=1))
    ctr32 = philox.to_int32_bits(ctr).contiguous()
    key32 = philox.to_int32_bits(torch.tensor(key, device=dev))
    got = torch.empty_like(ctr32)
    _build.check(_build.load().philox_fill(
        ctr32.data_ptr(), key32.data_ptr(), got.data_ptr(), n,
        torch.cuda.current_stream().cuda_stream), "philox_fill")
    torch.cuda.synchronize()
    mismatches = int((got != want).sum())
    phase("philox", counters=n, mismatched_words=mismatches)
    if mismatches:
        raise AssertionError("device Philox differs from ops/philox.py")

    # 4. inject parity at the flagship shape, 15 dB
    runner = OfdmMcKernelSimulationRunner(device=dev,
                                          read_command_line_args=False)
    mc = MonteCarloOfdmTdl(runner.ofdm, runner.channel, M=16, tile=TILE,
                           device=dev)
    cell_bits = TILE * mc.used * mc.bits_per_symbol
    reps = 4
    g = torch.Generator(device=dev).manual_seed(11)

    def bits(*shape):
        return torch.randint(-2 ** 31, 2 ** 31, shape, dtype=torch.int32,
                             device=dev, generator=g)
    pb = bits(reps, 8, mc.TLp)
    db, n1, n2 = (bits(reps, NUM_TILES * TILE, mc.used_p) for _ in range(3))
    amp = mc.amp(10 ** 1.5)
    got = mc.build_inject(reps, NUM_TILES)(pb, db, n1, n2, amp)
    want = mc.simulate_block_reference(pb, db, n1, n2, amp)
    torch.cuda.synchronize()
    check_cells("inject_parity", got, want, cell_bits)

    # 5. PRNG mode at the main path's chunk shape (32 reps): kernel vs
    # plain, and chunk invariance of the kernel
    seed, snr, chunk = 1234567, 10 ** 1.5, 32
    k32 = mc.build(chunk, NUM_TILES)(seed, snr, 0)
    p32 = mc.prng_reference(chunk, NUM_TILES, seed, mc.amp(snr), 0)
    max_abs_err = check_cells("prng_parity", k32, p32, cell_bits)
    k4 = mc.build(4, NUM_TILES)(seed, snr, 4)
    torch.cuda.synchronize()
    same = bool(torch.equal(k32[4:8], k4))
    phase("chunk_invariance", rows_4_to_7_equal_start_4=same)
    if not same:
        raise AssertionError("kernel results depend on the chunking")

    # 6. the main path: SimulationRunner bulk path on the card
    def make_runner(snrs, rep_max, batch):
        r = OfdmMcKernelSimulationRunner(device=dev,
                                         read_command_line_args=False)
        r.params.add("SNR", np.array(snrs))
        r.params.set_unpack_parameter("SNR")
        r.rep_max, r.batch_size = rep_max, batch
        r.tile, r.num_tiles = TILE, NUM_TILES
        r.mc = MonteCarloOfdmTdl(r.ofdm, r.channel, M=16, tile=TILE,
                                 device=dev)
        r.update_progress_function_style = None
        return r

    main_runner = make_runner([5.0, 15.0, 30.0], 64, chunk)
    main_runner.mc.launch_count = 0
    main_runner.mc.reference_count = 0
    tic = time.time()
    main_runner.simulate()
    seconds = time.time() - tic
    launches = main_runner.mc.launch_count
    bers = [float(b) for b in main_runner.results.get_result_values_list("ber")]
    phase("main_path", snr_db=[5.0, 15.0, 30.0], ber=bers,
          runned_reps=main_runner.runned_reps, seconds=seconds,
          kernel_launches=launches,
          chunks=main_runner.chunks_dispatched,
          plain_calls=main_runner.mc.reference_count)
    for snr_db, ber in zip((5.0, 15.0, 30.0), bers):
        lo, hi = BER_CORNERS[snr_db]
        if not lo < ber < hi:
            raise AssertionError(f"BER {ber} at {snr_db} dB outside "
                                 f"({lo}, {hi})")
    if launches != main_runner.chunks_dispatched or launches == 0 or \
            main_runner.mc.reference_count != 0:
        raise AssertionError("the main path did not run through the kernel")

    # 7. times on the card (CUDA events, best of 3)
    syms = chunk * NUM_TILES * TILE * mc.used
    run32 = mc.build(chunk, NUM_TILES)
    kernel_ms = best_ms(lambda: run32(seed, snr, 0), inner=10)
    plain_ms = best_ms(lambda: mc.prng_reference(chunk, NUM_TILES, seed,
                                                 mc.amp(snr), 0))
    engine = make_runner([15.0], 512, 128)
    engine_ms = best_ms(engine.simulate)
    engine_syms = 512 * NUM_TILES * TILE * mc.used
    phase("times", card=repr(smi), shape=f"reps={chunk},tiles={NUM_TILES},"
          f"tile={TILE},used={mc.used}",
          kernel_ms=kernel_ms, kernel_sym_per_s=syms / kernel_ms * 1e3,
          plain_ms=plain_ms, plain_sym_per_s=syms / plain_ms * 1e3,
          engine_ms=engine_ms, engine_sym_per_s=engine_syms / engine_ms * 1e3)

    print(smi)
    print(json.dumps({"kernels": [{
        "name": "mc_ofdm_tdl_prng",
        "route": "cuda",
        "source": "pyphysim_tpu_torch/ops/csrc/mc_ofdm_tdl.cu",
        "replaces": "pyphysim_tpu/ops/mc_pallas.py:336",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
