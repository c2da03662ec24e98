#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA card.

Drives the port's paths at full width and checks every kernel of them
against its plain PyTorch version on the card:

  * the flagship OFDM-over-TDL Monte Carlo BER sweep through
    ``SimulationRunner``'s bulk path and the Monte Carlo CUDA kernel, in
    both channel-product types (float32 and the reference's bf16 mode;
    phases 1-7);
  * the per-attempt streams' draws (``ops/streams.py`` ``philox_draw``,
    one launch of the ``philox_stream_fill`` CUDA kernel a draw) bit for
    bit against their plain version and the CPU route (phase 3);
  * the flagship chain's block-static time-domain route, whose block
    convolution is the ``block_fir`` CUDA kernel, and its fused diag route,
    each in both signal types (complex64 and the reference's bf16), and
    the per-sample app ``apps/ofdm/ofdm_tdlchannel_torch.py``, each through
    the runner's per-key path (phases 8-12);
  * the Alamouti 2x1 family through its CUDA kernel on the bulk path and
    through its library chain on the per-key path, and the BD CoMP capacity
    family the same way, at ``bench.py``'s widths (phases 13-19);
  * the Max-SINR interference-alignment family: its CUDA kernel against its
    plain version at every point of the kernel's menu and at the bench
    widths, the bulk app and the batched chain (``ia_step``), the per-key
    stream-selection app, and their times (phases 20-26).

One line per phase; any failure raises and the script exits non-zero.
There is no CPU fallback: without a CUDA device it fails before printing
any result.

Run from the repository root: ``python3 chip_smoke.py`` (one card, a few
minutes including the nvcc builds, one per source, in parallel).
"""

import json
import subprocess
import sys
import time

BER_CORNERS = {5.0: (0.08, 0.22), 15.0: (0.02, 0.06), 30.0: (2e-4, 6e-3)}
TILE, NUM_TILES = 1024, 4           # flagship kernel shape
REL_TOL = 2e-4                      # |kernel - plain| per cell / cell bits
FIR_REL_TOL = 1e-5                  # block_fir: max |kernel - plain| / max |y|
FIR_ROWS = (8192, 1000, 1)          # time-domain step's rows; ragged counts
# phase 8's other geometries, (rows, block_size, offsets): a row of 4,520 B
# (not a multiple of 16), 20 taps over 96 samples, 64 taps over 127
FIR_GEOMETRIES = ((1000, 565, None), (1000, 564, tuple(range(0, 100, 5))),
                  (256, 564, tuple(range(0, 128, 2))))
FILL_ROWS, FILL_WORDS = 512, 2049   # phase 3: 1,049,088 draws a kind, odd m
FILL_ULP_LIMIT = 2                  # normals: kernel vs plain, in ulps
FILL_GRID_COUNTERS = 132 * 16 * 256  # counters one fill grid covers a stride
TD_BATCH, TD_SYMBOLS = 256, 300 * 32    # bench.py's time-domain step
FUSED_BATCH, FUSED_SYMBOLS = 512, 300 * 16  # bench.py's fused step
HBM_BYTES_PER_S = 3.35e12           # H100 SXM data sheet
F32_FLOP_PER_S = 67e12              # f32 outside the tensor cores
MC_DTYPES = ("float32", "bfloat16")  # the flagship kernel's product types
SIGNAL_DTYPES = (None, "bfloat16")  # the chain's signal types (None: complex64)
ALAMOUTI_BER_10DB = (0.008, 0.030)  # bench.py's bands
BD_CAP_RANGE = (5.0, 16.0)
ALA_TILE, ALA_LANE, ALA_TILES, ALA_CHUNK = 64, 256, 4, 512   # bench.py
ALA_CHAIN_BATCH, ALA_CHAIN_SYMBOLS = 1024, 2048              # ala_step
BD_TILE, BD_LANE, BD_TILES, BD_CHUNK = 8, 512, 4, 128        # bench.py
BD_PARITY_TILE = 64                 # inject parity: 32,768 solves per cell
BD_CHAIN_BATCH = 4096                                        # bd_step
BD_REL_TOL = 2e-4                   # |kernel - plain| / |plain| per cell
BD_MAX_REGISTERS_3_2 = 128          # 4 blocks of 128 threads a SM, or more
# The fewest SASS instructions known to solve one BD element at (3, 2),
# normalized, per pipe as ``ops/sass.py`` counts them: the listing of the
# earlier register-resident mc_bd.cu (4 solves a thread, 23,215.3
# instructions a thread). The shared-memory form issues more a solve
# (shared loads and stores, loop counters, run-time addresses), which the
# function does not need, so the BD bound takes the smaller count.
BD_FEWEST_SASS_PER_SOLVE = {k: v / 4 for k, v in {
    "total": 23215.311932398534, "imad": 1317.0, "alu": 4752.960406820743,
    "xu": 383.98020341038057}.items()}
IA_CAP_RANGE = (6.0, 16.0)          # bench.py: K=3, 2x2, Ns=1, noise 0.1
IA_TILE, IA_LANE, IA_TILES, IA_CHUNK = 8, 512, 4, 128        # bench.py
IA_ITERS, IA_NV = 10, 0.1
IA_PARITY_TILE = 64                 # inject parity: 32,768 solves per cell
IA_PLAIN_SLICE = 32                 # reps per plain-version call
IA_CHAIN_BATCH = 4096                                        # ia_step
IA_REL_TOL = 2e-4                   # |kernel - plain| / |plain| per cell


def phase(name, **fields):
    print(f"[{name}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def compact(obj):
    """``obj`` as JSON with no spaces, one field of a phase line."""
    return json.dumps(obj, separators=(",", ":"))


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


def graph_ms(fn, inner=10):
    """Best of 3 replays of a CUDA graph of ``inner`` calls of ``fn``, in
    ms per call: the device's time for what ``fn`` launches, without the
    host's work between launches (for kernels shorter than it)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    return best_ms(graph.replay) / inner


def bound_ms(nbytes=0, flops=0, issue_ms=0.0):
    """The least time the card could take: bytes over the memory rate, f32
    operations over the f32 rate, or the instructions' time on their
    busiest pipe (``issue_ms``, see :func:`sass_bound`), whichever is
    largest; and which ("bytes" or "operations")."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(flops / F32_FLOP_PER_S * 1e3, issue_ms)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sass_bound(profile, nbytes, flops=0):
    """The bound of a PRNG-mode kernel from the SASS of the library built
    in this run (``ops/sass.py``), beside its bytes and f32 operations:
    (per-thread instructions by pipe, bound ms, "bytes" or "operations",
    the pipe that sets it)."""
    from pyphysim_tpu_torch.ops import _build, sass
    listing = sass.function_sass(_build.library_path(), profile["pattern"])
    counts = sass.pipe_counts(listing, profile["loop_trips"],
                              profile["loops"])
    issue_ms, pipe = sass.issue_bound_ms(counts, profile["threads"])
    ms, by = bound_ms(nbytes=nbytes, flops=flops, issue_ms=issue_ms)
    return counts, ms, by, pipe


def mc_flops(mc, reps, num_tiles):
    """f32 operations the flagship function needs per call: the T-deep
    complex product (8 T per symbol) and the ray sums (2 adds per symbol
    row, tap and ray)."""
    rows = reps * num_tiles * mc.tile
    return rows * (8 * mc.taps * mc.used + 2 * mc.TL)


def check_bers(name, snrs, bers):
    for snr_db, ber in zip(snrs, bers):
        lo, hi = BER_CORNERS[snr_db]
        if not lo < ber < hi:
            raise AssertionError(f"{name}: BER {ber} at {snr_db} dB outside "
                                 f"({lo}, {hi})")


def fir_geometry():
    """(block_size, tap offsets) of the flagship block-static channel:
    one OFDM(512, 52, 300) symbol, COST259-TU at Ts = 50 ns."""
    from pyphysim_tpu_torch.channels import COST259_TUx
    from pyphysim_tpu_torch.modulators import OFDM
    ofdm = OFDM(512, 52, 300, device="cpu")
    offsets = COST259_TUx.get_discretize_profile(1 / 20e6).tap_delays
    return ofdm.samples_per_symbol, [int(d) for d in offsets]


def fir_inputs(dev, rows, seed=5, block_size=None, offsets=None):
    """Random x and taps of ``rows`` rows at the flagship geometry, or at
    ``block_size`` / ``offsets`` where given."""
    import torch
    flagship = fir_geometry()
    block_size = block_size or flagship[0]
    offsets = list(offsets or flagship[1])
    g = torch.Generator(device=dev).manual_seed(seed + rows)
    x = torch.randn(rows, block_size, dtype=torch.complex64, device=dev,
                    generator=g)
    taps = torch.randn(rows, len(offsets), dtype=torch.complex64,
                       device=dev, generator=g)
    return x, taps, offsets, block_size


def fir_bytes(rows, block_size, offsets):
    """Bytes block_fir must move: read x and taps, write y (complex64)."""
    return 8 * rows * (block_size + len(offsets) +
                       block_size + offsets[-1])


def chain_runner(dev, chain, snrs, rep_max, batch):
    """The app's per-key runner around ``chain``, at ``snrs`` (dB)."""
    import numpy as np
    from apps.ofdm.ofdm_tdlchannel_torch import OfdmTdlSimulationRunner
    r = OfdmTdlSimulationRunner(device=dev, read_command_line_args=False)
    r.params.add("SNR", np.array(snrs, dtype=float))
    r.params.set_unpack_parameter("SNR")
    r.chain = chain
    r.rep_max, r.batch_size = rep_max, batch
    r.update_progress_function_style = None
    return r


def run_sweep_values(runner, name):
    """Run ``runner``'s sweep; its result ``name`` per point and the
    seconds it took."""
    tic = time.time()
    runner.simulate()
    seconds = time.time() - tic
    return ([float(v) for v in runner.results.get_result_values_list(name)],
            seconds)


def run_sweep(runner):
    return run_sweep_values(runner, "ber")


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
    from pyphysim_tpu_torch.ops import _build, philox

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    smi = card()
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
        if "entry function" in line or "registers" in line or \
                "spill" in line:
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
    fill_err = fill_parity(dev)

    mc_entries = [flagship_phases(dev, smi, dtype) for dtype in MC_DTYPES]

    phases_8_to_12 = chain_phases(dev, smi, fill_err)
    phases_13_to_19 = mimo_bd_phases(dev, smi)
    phases_20_to_26 = ia_phases(dev, smi)

    print(smi)
    print(json.dumps({"kernels": [
        *mc_entries, *phases_8_to_12, *phases_13_to_19, phases_20_to_26]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def float_ulps(a, b):
    """Largest distance in units of the last place between two float32
    tensors of one shape."""
    import torch

    def ordered(t):
        i = t.contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i + 2 ** 31), i)
    return int((ordered(a) - ordered(b)).abs().max())


def fill_parity(dev):
    """Phase 3, the streams' draws: ``philox_draw`` (one launch of the fill
    kernel) against its plain version on the card and against the CPU
    route, on ``FILL_ROWS`` attempts across 2**32 with per-row keys and
    with the scalar key of an ``AttemptStreams``, at an odd ``FILL_WORDS``
    a row. Bits and uniforms must be equal bit for bit everywhere; normals
    within ``FILL_ULP_LIMIT`` ulps of the plain version on the card (the
    CPU's ``log`` / ``cos`` / ``sin`` are other functions). Returns the
    largest |kernel - plain| over the kinds."""
    import torch
    from pyphysim_tpu_torch.ops.streams import (philox_draw,
                                                philox_draw_reference)
    g = torch.Generator(device=dev).manual_seed(3)
    a = torch.arange(2 ** 32 - FILL_ROWS // 2, 2 ** 32 + FILL_ROWS // 2,
                     dtype=torch.int64, device=dev)
    keys = torch.randint(0, 2 ** 32, (FILL_ROWS, 2), dtype=torch.int64,
                         device=dev, generator=g)
    err = 0.0
    for key_name, k0, k1 in (("per_row", keys[:, 0], keys[:, 1]),
                             ("scalar", 0x9E3779B9, 12345)):
        for kind in ("bits", "uniform", "normal"):
            args = (k0, k1, (a, 0), (a, 32), FILL_WORDS)
            cpu_args = tuple(w.cpu() if isinstance(w, torch.Tensor) else w
                             for w in (k0, k1)) + (
                (a.cpu(), 0), (a.cpu(), 32), FILL_WORDS)
            before = philox_draw.launch_count
            got = philox_draw(kind, *args)
            launches = philox_draw.launch_count - before
            plain = philox_draw_reference(kind, *args)
            cpu = philox_draw(kind, *cpu_args)
            torch.cuda.synchronize()
            differ = int((got != plain).sum())
            cpu_differ = int((got.cpu() != cpu).sum())
            fields = {}
            if kind == "normal":
                fields = {"max_ulps": float_ulps(got, plain),
                          "max_ulps_cpu": float_ulps(got.cpu(), cpu),
                          "ulp_limit": FILL_ULP_LIMIT}
            phase("fill_parity", keys=key_name, kind=kind,
                  shape=f"{FILL_ROWS}x{FILL_WORDS}", launches=launches,
                  differ_from_plain=differ, differ_from_cpu=cpu_differ,
                  **fields)
            exact = kind != "normal"
            if launches != 1 or (exact and (differ or cpu_differ)) or \
                    (not exact and fields["max_ulps"] > FILL_ULP_LIMIT):
                raise AssertionError(f"fill_parity {key_name} {kind}: the "
                                     f"fill differs from its plain version")
            err = max(err, float((got.double() - plain.double()).abs()
                                 .max()))
    return err


def recorded_draws(step):
    """Run ``step()`` and return the draws it made through
    ``AttemptStreams``: ``[(kind, streams, m, mask)]``, ``m`` the draws a
    row."""
    from pyphysim_tpu_torch.ops.streams import AttemptStreams
    draws = []
    draw = AttemptStreams._draw

    def record(self, kind, shape, mask=0xFFFFFFFF):
        out = draw(self, kind, shape, mask)
        draws.append((kind, self, out[0].numel(), mask))
        return out
    AttemptStreams._draw = record
    try:
        step()
    finally:
        AttemptStreams._draw = draw
    return draws


def fill_main_path_parity(dev, name, chain, batch):
    """Phase 10, the fill at the main path's own shapes: every draw one
    step of ``chain`` makes over ``batch`` attempts across 2**32 (symbol
    bits, channel uniforms, noise normals), the fill against its plain
    version, bits and uniforms bit for bit, normals within
    ``FILL_ULP_LIMIT`` ulps. The noise draws span several grids of the
    fill's launch, so its grid-stride loop runs. Returns the largest
    |kernel - plain|."""
    import torch
    from pyphysim_tpu_torch.ops.streams import (AttemptStreams, philox_draw,
                                                philox_draw_reference)
    a = torch.arange(2 ** 32 - batch // 2, 2 ** 32 + batch - batch // 2,
                     dtype=torch.int64, device=dev)
    draws = recorded_draws(lambda: chain.step(AttemptStreams(99, a), 10.0))
    err = 0.0
    for kind, s, m, mask in draws:
        args = (kind, s.seed, s.salt, (s.attempts, 0), (s.attempts, 32), m,
                mask)
        got = philox_draw(*args)
        plain = philox_draw_reference(*args)
        torch.cuda.synchronize()
        differ = int((got != plain).sum())
        ulps = float_ulps(got, plain) if kind == "normal" else 0
        counters = s.n * -(-(m + (m & 1 if kind == "normal" else 0)) // 4)
        phase("fill_main_path", step=name, kind=kind, shape=f"{s.n}x{m}",
              counters=counters, grids=counters / FILL_GRID_COUNTERS,
              differ_from_plain=differ, max_ulps=ulps,
              ulp_limit=FILL_ULP_LIMIT)
        if (kind != "normal" and differ) or ulps > FILL_ULP_LIMIT:
            raise AssertionError(f"fill_main_path {name} {kind} {s.n}x{m}: "
                                 f"the fill differs from its plain version")
        err = max(err, float((got.double() - plain.double()).abs().max()))
    kinds = sorted(k for k, *_ in draws)
    if kinds != ["bits", "normal", "uniform"]:
        raise AssertionError(f"fill_main_path {name}: a step drew {kinds}, "
                             f"expected symbol bits, channel uniforms and "
                             f"noise normals")
    return err


def flagship_phases(dev, smi, dtype):
    """Phases 4-7 in one channel-product type of the flagship kernel:
    inject and PRNG parity with the plain version at the flagship shape,
    chunk invariance, the main path (the runner's bulk path at 5 / 15 / 30
    dB, inside ``BER_CORNERS``, through the kernel), and the times and
    SASS bound. Returns the kernel's entry of the ``kernels`` line."""
    import numpy as np
    import torch
    from apps.ofdm.ofdm_mc_kernel_torch import OfdmMcKernelSimulationRunner
    from pyphysim_tpu_torch.ops.mc_kernel import MonteCarloOfdmTdl

    def make_runner(snrs, rep_max, batch):
        r = OfdmMcKernelSimulationRunner(device=dev,
                                         read_command_line_args=False,
                                         matmul_dtype=dtype)
        r.params.add("SNR", np.array(snrs))
        r.params.set_unpack_parameter("SNR")
        r.rep_max, r.batch_size = rep_max, batch
        r.tile, r.num_tiles = TILE, NUM_TILES
        r.mc = MonteCarloOfdmTdl(r.ofdm, r.channel, M=16, tile=TILE,
                                 matmul_dtype=dtype, device=dev)
        r.update_progress_function_style = None
        return r

    # 4. inject parity at the flagship shape, 15 dB
    mc = make_runner([15.0], 1, 1).mc
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
    check_cells(f"inject_parity {dtype}", got, want, cell_bits)

    # 5. PRNG mode at the main path's chunk shape (32 reps): kernel vs
    # plain, and chunk invariance of the kernel
    seed, snr, chunk = 1234567, 10 ** 1.5, 32
    k32 = mc.build(chunk, NUM_TILES)(seed, snr, 0)
    p32 = mc.prng_reference(chunk, NUM_TILES, seed, mc.amp(snr), 0)
    max_abs_err = check_cells(f"prng_parity {dtype}", k32, p32, cell_bits)
    k4 = mc.build(4, NUM_TILES)(seed, snr, 4)
    torch.cuda.synchronize()
    same = bool(torch.equal(k32[4:8], k4))
    phase(f"chunk_invariance {dtype}", rows_4_to_7_equal_start_4=same)
    if not same:
        raise AssertionError("kernel results depend on the chunking")

    # 6. the main path: SimulationRunner bulk path on the card
    snrs = [5.0, 15.0, 30.0]
    main_runner = make_runner(snrs, 64, chunk)
    main_runner.mc.launch_count = 0
    main_runner.mc.reference_count = 0
    bers, seconds = run_sweep(main_runner)
    launches = main_runner.mc.launch_count
    phase(f"main_path {dtype}", snr_db=snrs, ber=bers,
          runned_reps=main_runner.runned_reps, seconds=seconds,
          kernel_launches=launches, chunks=main_runner.chunks_dispatched,
          plain_calls=main_runner.mc.reference_count)
    check_bers(f"main_path {dtype}", snrs, bers)
    check_launches(f"main_path {dtype}", launches,
                   main_runner.chunks_dispatched,
                   main_runner.mc.reference_count)

    # 7. times on the card (CUDA events, best of 3) and the bound from the
    # SASS of the library built in this run
    syms = chunk * NUM_TILES * TILE * mc.used
    run32 = mc.build(chunk, NUM_TILES)
    kernel_ms = best_ms(lambda: run32(seed, snr, 0), inner=10)
    plain_ms = best_ms(lambda: mc.prng_reference(chunk, NUM_TILES, seed,
                                                 mc.amp(snr), 0))
    engine = make_runner([15.0], 512, 128)
    engine_ms = best_ms(engine.simulate)
    engine_syms = 512 * NUM_TILES * TILE * mc.used
    profile = mc.prng_kernel_profile(chunk, NUM_TILES)
    flops = mc_flops(mc, chunk, NUM_TILES)
    # G_tap read once, one count per (rep, tile) written
    nbytes = 8 * mc.taps * mc.used + 4 * chunk * NUM_TILES
    counts, bound, bound_by, pipe = sass_bound(profile, nbytes, flops)
    phase(f"times {dtype}", card=repr(smi),
          shape=f"reps={chunk},tiles={NUM_TILES},tile={TILE},used={mc.used},"
          f"taps={mc.taps},rays={mc.rays}",
          kernel_ms=kernel_ms, kernel_sym_per_s=syms / kernel_ms * 1e3,
          plain_ms=plain_ms, plain_sym_per_s=syms / plain_ms * 1e3,
          engine_ms=engine_ms, engine_sym_per_s=engine_syms / engine_ms * 1e3,
          engine_share_of_kernel=engine_syms / engine_ms / (syms / kernel_ms),
          bound_ms=bound, bound_by=bound_by, bound_pipe=pipe,
          flop_bound_ms=flops / F32_FLOP_PER_S * 1e3,
          sass_per_thread=compact(counts),
          sass_per_symbol=counts["total"] * profile["threads"] / syms,
          product_share_of_issue=4 * mc.taps * syms /
          (counts["total"] * profile["threads"]),
          share_of_bound=bound / kernel_ms)
    return {
        "name": "mc_ofdm_tdl_prng" + ("_bf16" if dtype == "bfloat16" else ""),
        "route": "cuda",
        "source": "pyphysim_tpu_torch/ops/csrc/mc_ofdm_tdl.cu",
        "replaces": "pyphysim_tpu/ops/mc_pallas.py:336",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": kernel_ms,
        "timed_by": "wrapper_events",
        "wrapper_ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound,
        "bound_by": bound_by,
        "library_ms": None,
    }


def chain_phases(dev, smi, fill_err):
    """Phases 8-12: block_fir against its plain version, the time-domain
    and fused chains and the per-sample app through the per-key runner
    (their draws through the fill kernel, and the fill against its plain
    version at each of their draws), and their times. Returns the entries
    of block_fir and of the fill (``fill_err``: its phase-3 parity error,
    raised by phase 10's) in the ``kernels`` line."""
    import torch
    from pyphysim_tpu_torch.chain import ChainStep
    from pyphysim_tpu_torch.channels import fading
    from pyphysim_tpu_torch.ops import _build, fir, sass
    from pyphysim_tpu_torch.ops.streams import (AttemptStreams, philox_draw,
                                                philox_draw_reference)

    # 8. block_fir against its plain version, at the time-domain step's
    # rows, at ragged row counts and at the other geometries
    fir_err = 0.0
    for rows, block_size, offsets in [(r, None, None) for r in FIR_ROWS] + \
            list(FIR_GEOMETRIES):
        x, taps, offsets, block_size = fir_inputs(dev, rows,
                                                  block_size=block_size,
                                                  offsets=offsets)
        y = fir.block_fir(x, taps, offsets, block_size)
        ref = fir.block_fir_reference(x, taps, offsets, block_size)
        torch.cuda.synchronize()
        err = float((y - ref).abs().max())
        rel = err / float(ref.abs().max())
        plan = fir.kernel_plan(rows, block_size, tuple(offsets))
        phase("fir_parity", rows=rows, block_size=block_size,
              row_bytes=8 * block_size, taps=len(offsets),
              span=offsets[-1] + 1, out_len=y.shape[1],
              instance=f"{plan['tap_bound']}/{int(plan['full'])}/"
              f"{plan['stages']}", max_abs_diff=err, rel=rel,
              limit=FIR_REL_TOL)
        if not rel <= FIR_REL_TOL:
            raise AssertionError(f"block_fir disagrees with its plain "
                                 f"version at R={rows}, block_size="
                                 f"{block_size}, T={len(offsets)}: {rel}")
        fir_err = max(fir_err, err)

    # 9. the block-static time-domain chain through the per-key runner, in
    # each signal type; 10. the fused diag chain through the same runner
    snrs = [5.0, 15.0, 30.0]
    if fading.BLOCK_CONV_IMPL not in ("auto", "kernel"):
        raise AssertionError("the default block convolution is not the "
                             "kernel")
    td, fused, fir_launches, fill_launches = {}, {}, 0, 0

    def check_fills(name, runner):
        """Three draws a chain call (symbols, channel, noise), each one
        fill launch, and no plain draw."""
        fills = philox_draw.launch_count
        plain = philox_draw.reference_count
        if fills != 3 * runner.chunks_dispatched or plain != 0:
            raise AssertionError(f"{name}: {fills} fill launches and {plain} "
                                 f"plain draws for {runner.chunks_dispatched}"
                                 f" chain calls")
        return fills

    for dtype in SIGNAL_DTYPES:
        tag = dtype or "complex64"
        td[dtype] = ChainStep(TD_SYMBOLS, 512, 52, 300, block_static=True,
                              signal_dtype=dtype, device=dev)
        runner = chain_runner(dev, td[dtype], snrs, 2 * TD_BATCH, TD_BATCH)
        fir.block_fir.launch_count = 0
        fir.block_fir.reference_count = 0
        philox_draw.launch_count = 0
        philox_draw.reference_count = 0
        bers, seconds = run_sweep(runner)
        launches = fir.block_fir.launch_count
        fir_plain = fir.block_fir.reference_count
        phase("time_domain_path", signal=tag, snr_db=snrs, ber=bers,
              runned_reps=runner.runned_reps, seconds=seconds,
              chain_calls=runner.chunks_dispatched,
              block_fir_launches=launches, block_fir_plain_calls=fir_plain,
              fill_launches=philox_draw.launch_count,
              plain_draws=philox_draw.reference_count)
        check_bers(f"time_domain_path {tag}", snrs, bers)
        if launches != runner.chunks_dispatched or launches == 0 or \
                fir_plain != 0:
            raise AssertionError("the time-domain path did not run its "
                                 "block convolutions through the "
                                 "block_fir kernel")
        fill_launches += check_fills(f"time_domain_path {tag}", runner)
        fir_launches += launches

    for dtype in SIGNAL_DTYPES:
        tag = dtype or "complex64"
        fused[dtype] = ChainStep(FUSED_SYMBOLS, 512, 52, 300,
                                 block_static=True, fused=True,
                                 signal_dtype=dtype, device=dev)
        runner = chain_runner(dev, fused[dtype], snrs, 2 * FUSED_BATCH,
                              FUSED_BATCH)
        philox_draw.launch_count = 0
        philox_draw.reference_count = 0
        bers, seconds = run_sweep(runner)
        phase("fused_path", signal=tag, snr_db=snrs, ber=bers,
              runned_reps=runner.runned_reps, seconds=seconds,
              chain_calls=runner.chunks_dispatched,
              fill_launches=philox_draw.launch_count,
              plain_draws=philox_draw.reference_count)
        check_bers(f"fused_path {tag}", snrs, bers)
        fill_launches += check_fills(f"fused_path {tag}", runner)

    # the fill at every draw of a time-domain and a fused step, bitwise
    for name, chain, batch in (("time_domain", td[None], TD_BATCH),
                               ("fused", fused[None], FUSED_BATCH)):
        fill_err = max(fill_err, fill_main_path_parity(dev, name, chain,
                                                       batch))

    # 11. the per-sample app (apps/ofdm/ofdm_tdlchannel_torch.py)
    from apps.ofdm.ofdm_tdlchannel_torch import OfdmTdlSimulationRunner
    app = OfdmTdlSimulationRunner(device=dev, read_command_line_args=False)
    app.rep_max, app.batch_size = 64, 16
    app.update_progress_function_style = None
    app_bers, seconds = run_sweep(app)
    app_snrs = [float(v) for v in app.results.params["SNR"]]
    phase("app", snr_db=app_snrs, ber=app_bers, runned_reps=app.runned_reps,
          seconds=seconds, chain_calls=app.chunks_dispatched)
    if any(b >= a for a, b in zip(app_bers, app_bers[1:])):
        raise AssertionError("app: BER does not fall with SNR")
    check_bers("app", [15.0], [app_bers[app_snrs.index(15.0)]])

    # 12. times (CUDA events, best of 3 after a warm-up)
    rows = FIR_ROWS[0]
    x, taps, offsets, block_size = fir_inputs(dev, rows)
    args = (x, taps, offsets, block_size)
    # the kernel's time without the host's launch work (a CUDA graph of
    # wrapper calls), and the wrapper's, whose host work may exceed it
    fir_ms = graph_ms(lambda: fir.block_fir(*args))
    fir_wrapper_ms = best_ms(lambda: fir.block_fir(*args), inner=10)
    fir_plain_ms = best_ms(lambda: fir.block_fir_reference(*args))
    fir_fft_ms = best_ms(lambda: fir.block_fir_fft(*args), inner=10)
    fir_nbytes = fir_bytes(rows, block_size, offsets)
    fir_bound, fir_bound_by = bound_ms(
        nbytes=fir_nbytes, flops=8 * rows * block_size * len(offsets))
    # the one PyTorch call that computes it: a grouped conv1d with the
    # dense (R, D) kernel built outside the timed call (TF32 off)
    span = offsets[-1] + 1
    dense = torch.zeros(rows, span, dtype=torch.complex64, device=dev)
    dense[:, list(offsets)] = taps
    weight = dense.flip(-1)[:, None, :].contiguous()

    def conv1d():
        return torch.nn.functional.conv1d(x[None], weight, padding=span - 1,
                                          groups=rows)[0]
    y = fir.block_fir(*args)
    conv_rel = float((conv1d() - y).abs().max() / y.abs().max())
    conv_ms = best_ms(conv1d, inner=10)
    copy_ms = best_ms(lambda: y.clone(), inner=10)
    # the kernel's own SASS: its issue beside the bytes
    profile = fir.kernel_profile(rows, block_size, offsets)
    listing = sass.function_sass(_build.library_path(), profile["pattern"])
    trips = fir.loop_trips(sass.loop_ops(listing), profile)
    counts = sass.pipe_counts(listing, trips, len(trips))
    issue_ms, issue_pipe = sass.issue_bound_ms(counts, profile["threads"])
    pairs = rows * y.shape[1] * len(offsets)
    # the fill at the time-domain step's largest draw (its noise normals)
    attempts = torch.arange(TD_BATCH, dtype=torch.int64, device=dev)
    fill_args = ("normal", 99, 7, (attempts, 0), (attempts, 32),
                 2 * td[None].noise_length)
    fill_ms = graph_ms(lambda: philox_draw(*fill_args))
    fill_wrapper_ms = best_ms(lambda: philox_draw(*fill_args), inner=10)
    fill_plain_ms = best_ms(lambda: philox_draw_reference(*fill_args))
    fill_bound, fill_bound_by = bound_ms(
        nbytes=4 * TD_BATCH * fill_args[-1] + 8 * TD_BATCH)
    snr = 10 ** 1.5

    def step_ms(chain, batch):
        streams = AttemptStreams.from_range(99, 0, batch, dev)
        return best_ms(lambda: chain.step(streams, snr))

    td_ms = step_ms(td[None], TD_BATCH)
    fused_ms = step_ms(fused[None], FUSED_BATCH)
    td_bf16_ms = step_ms(td["bfloat16"], TD_BATCH)
    fused_bf16_ms = step_ms(fused["bfloat16"], FUSED_BATCH)
    engine = chain_runner(dev, td[None], [15.0], 4 * TD_BATCH, TD_BATCH)
    engine_ms = best_ms(engine.simulate)
    phase("times", card=repr(smi), block_fir_rows=rows,
          block_fir_ms=fir_ms, block_fir_bound_ms=fir_bound,
          block_fir_bound_by=fir_bound_by,
          block_fir_share_of_bound=fir_bound / fir_ms,
          block_fir_wrapper_ms=fir_wrapper_ms,
          block_fir_sass_per_thread=compact(counts),
          block_fir_sass_per_pair=counts["total"] * profile["threads"] /
          pairs, block_fir_issue_ms=issue_ms, block_fir_issue_pipe=issue_pipe,
          block_fir_loop_trips=compact(trips),
          block_fir_plain_ms=fir_plain_ms, block_fir_fft_route_ms=fir_fft_ms,
          block_fir_conv1d_ms=conv_ms, conv1d_rel_diff=conv_rel,
          copy_of_y_ms=copy_ms,
          copy_bytes_per_s=2 * 8 * y.numel() / copy_ms * 1e3,
          block_fir_bytes_per_s=fir_nbytes / fir_ms * 1e3,
          fill_shape=f"normal,{TD_BATCH}x{fill_args[-1]}", fill_ms=fill_ms,
          fill_wrapper_ms=fill_wrapper_ms, fill_plain_ms=fill_plain_ms,
          fill_bound_ms=fill_bound,
          fill_share_of_bound=fill_bound / fill_ms,
          time_domain_step_ms=td_ms,
          time_domain_sym_per_s=TD_BATCH * TD_SYMBOLS / td_ms * 1e3,
          fused_step_ms=fused_ms,
          fused_sym_per_s=FUSED_BATCH * FUSED_SYMBOLS / fused_ms * 1e3,
          time_domain_bf16_step_ms=td_bf16_ms,
          fused_bf16_step_ms=fused_bf16_ms,
          per_key_engine_ms=engine_ms,
          per_key_engine_sym_per_s=4 * TD_BATCH * TD_SYMBOLS / engine_ms * 1e3)
    return [{
        "name": "block_fir",
        "route": "cuda",
        "source": "pyphysim_tpu_torch/ops/csrc/block_fir.cu",
        "replaces": "pyphysim_tpu/ops/fir_pallas.py:52",
        "launches": fir_launches,
        "max_abs_err": fir_err,
        "ms": fir_ms,
        "timed_by": "graph_replay",
        "wrapper_ms": fir_wrapper_ms,
        "plain_ms": fir_plain_ms,
        "bound_ms": fir_bound,
        "bound_by": fir_bound_by,
        "library_ms": conv_ms,
        "fft_route_ms": fir_fft_ms,
    }, {
        "name": "philox_stream_fill",
        "route": "cuda",
        "source": "pyphysim_tpu_torch/ops/csrc/philox_fill.cu",
        "replaces": None,
        "launches": fill_launches,
        "max_abs_err": fill_err,
        "ms": fill_ms,
        "timed_by": "graph_replay",
        "wrapper_ms": fill_wrapper_ms,
        "plain_ms": fill_plain_ms,
        "bound_ms": fill_bound,
        "bound_by": fill_bound_by,
        "library_ms": None,
    }]


def sweep_runner(runner, name, values, rep_max, batch):
    """``runner`` set up to sweep its parameter ``name`` over ``values``."""
    import numpy as np
    runner.params.add(name, np.array(values, dtype=float))
    runner.params.set_unpack_parameter(name)
    runner.rep_max, runner.batch_size = rep_max, batch
    runner.update_progress_function_style = None
    return runner


def check_launches(name, launches, chunks, plain_calls):
    if launches != chunks or launches == 0 or plain_calls != 0:
        raise AssertionError(f"{name}: {launches} kernel launches for "
                             f"{chunks} chunks and {plain_calls} plain calls")


def check_range(name, value, band):
    if not band[0] < value < band[1]:
        raise AssertionError(f"{name}: {value} outside {band}")


def bd_guard_witness(mc, seed, k_main, p_main):
    """The draw behind the BD PRNG parity's worst cell. For each solve of
    that cell the plain version's guard ratio sqrt(smin) / sqrt(smax) (the
    guard keeps a draw when it exceeds 1e-6), in float32 and, on the same
    float32 draws, in float64; the draw with the smallest float64 ratio is
    then replaced by its neighbour's in inject mode, which must take the
    kernel's difference from the plain version down to float32 summation
    rounding (1e-5 of the cell): the whole difference is that draw's."""
    import torch
    diff = (k_main - p_main).abs()
    worst = int(diff.argmax())
    rep, tile = divmod(worst, k_main.shape[1])
    rows = slice(tile * mc.tile, (tile + 1) * mc.tile)
    bits = mc.prng_bits(1, k_main.shape[1], seed, rep)[:, rows].contiguous()
    ratio = {}
    for name, dtype in (("float32", torch.complex64),
                        ("float64", torch.complex128)):
        gains = torch.stack(mc.stream_gains(bits, dtype)).reshape(
            mc.K * mc.Nr_u, -1)
        ratio[name] = (gains.min(dim=0).values.sqrt() /
                       gains.max(dim=0).values.sqrt())
    element = int(ratio["float64"].argmin())
    row, lane = divmod(element, mc.lane)
    swapped = bits.clone()
    cols = torch.arange(mc.num_planes, device=bits.device) * mc.lane
    swapped[0, row, cols + lane] = bits[0, row, cols + (lane + 1) % mc.lane]
    run = mc.build_inject(1, 1)
    cell, cell_swapped = (
        float((run(b) - mc.simulate_block_reference(b)).abs())
        for b in (bits, swapped))
    plain_cell = float(p_main[rep, tile])
    phase("bd_guard_witness", rep=rep, tile=tile, row=row, lane=lane,
          prng_cell_diff=float(diff.max()), inject_cell_diff=cell,
          ratio_float32=float(ratio["float32"][element]),
          ratio_float64=float(ratio["float64"][element]),
          next_smallest_ratio_float64=float(
              ratio["float64"].kthvalue(2).values),
          draw_capacity_plain=float(
              mc.element_capacities(bits).reshape(-1)[element]),
          inject_cell_diff_draw_replaced=cell_swapped,
          limit=1e-5 * abs(plain_cell))
    if not cell_swapped <= 1e-5 * abs(plain_cell):
        raise AssertionError("bd_guard_witness: the worst cell's difference "
                             "is not one draw's")


def mimo_bd_phases(dev, smi):
    """Phases 13-19: the Alamouti and BD kernels against their plain
    versions, both families through the bulk path (kernel) and the per-key
    path (library chain), and their times. Returns the two kernels'
    entries of the ``kernels`` line."""
    import numpy as np
    import torch
    from apps.comp_BD.batched_bd_capacity_torch import (
        BatchedBDCapacityRunner, BDKernelCapacityRunner)
    from apps.mimo.alamouti_mc_kernel_torch import \
        AlamoutiMcKernelSimulationRunner
    from apps.mimo.simulate_mimo_torch import MimoSimulationRunner
    from pyphysim_tpu_torch.ops import bd_kernel, sass
    from pyphysim_tpu_torch.ops.alamouti_kernel import MonteCarloAlamouti
    from pyphysim_tpu_torch.ops.streams import AttemptStreams
    from pyphysim_tpu_torch.simulations import kernel_stream_seed

    g = torch.Generator(device=dev).manual_seed(13)

    def bits(*shape):
        return torch.randint(-2 ** 31, 2 ** 31, shape, dtype=torch.int32,
                             device=dev, generator=g)

    # 13. Alamouti: inject parity, PRNG parity at the main path's chunk,
    # chunk invariance
    mca = MonteCarloAlamouti(tile=ALA_TILE, lane=ALA_LANE, device=dev)
    cell_bits = ALA_TILE * ALA_LANE * 4
    ala_bits = [bits(4, 8, ALA_LANE)] + [
        bits(4, ALA_TILES * ALA_TILE, ALA_LANE) for _ in range(5)]
    amp = mca.amp(10.0)
    got = mca.build_inject(4, ALA_TILES)(*ala_bits, amp)
    want = mca.simulate_block_reference(*ala_bits, amp)
    torch.cuda.synchronize()
    check_cells("alamouti_inject_parity", got, want, cell_bits)
    seed, snr = 4242, 10.0
    k_main = mca.build(ALA_CHUNK, ALA_TILES)(seed, snr, 0)
    p_main = mca.prng_reference(ALA_CHUNK, ALA_TILES, seed, amp, 0)
    ala_err = check_cells("alamouti_prng_parity", k_main, p_main, cell_bits)
    k4 = mca.build(4, ALA_TILES)(seed, snr, 4)
    torch.cuda.synchronize()
    same = bool(torch.equal(k_main[4:8], k4))
    phase("alamouti_chunk_invariance", rows_4_to_7_equal_start_4=same)
    if not same:
        raise AssertionError("Alamouti kernel results depend on the "
                             "chunking")

    # 14. A1: the Alamouti kernel through the bulk runner
    def ala_runner(snrs, rep_max):
        r = AlamoutiMcKernelSimulationRunner(
            tile=ALA_TILE, lane=ALA_LANE, num_tiles=ALA_TILES, device=dev,
            read_command_line_args=False)
        return sweep_runner(r, "SNR", snrs, rep_max, ALA_CHUNK)

    snrs = [0.0, 10.0, 20.0]
    runner = ala_runner(snrs, ALA_CHUNK)
    runner.mc.launch_count = 0
    runner.mc.reference_count = 0
    bers, seconds = run_sweep(runner)
    ala_launches = runner.mc.launch_count
    phase("alamouti_path", snr_db=snrs, ber=bers,
          runned_reps=runner.runned_reps, seconds=seconds,
          kernel_launches=ala_launches, chunks=runner.chunks_dispatched,
          plain_calls=runner.mc.reference_count)
    if not bers[0] > bers[1] > bers[2]:
        raise AssertionError("alamouti_path: BER does not fall with SNR")
    check_range("alamouti_path BER at 10 dB", bers[1], ALAMOUTI_BER_10DB)
    check_launches("alamouti_path", ala_launches, runner.chunks_dispatched,
                   runner.mc.reference_count)

    # 15. A2: the Alamouti library chain through the per-key runner
    def ala_chain_runner(rep_max):
        r = MimoSimulationRunner("alamouti", 1, device=dev,
                                 read_command_line_args=False)
        r.NSymbs, r.max_bit_errors = ALA_CHAIN_SYMBOLS, 10 ** 12
        return sweep_runner(r, "SNR", [10.0], rep_max, ALA_CHAIN_BATCH)

    runner = ala_chain_runner(2 * ALA_CHAIN_BATCH)
    chain_bers, seconds = run_sweep(runner)
    phase("alamouti_chain_path", snr_db=[10.0], ber=chain_bers,
          runned_reps=runner.runned_reps, seconds=seconds,
          chain_calls=runner.chunks_dispatched)
    check_range("alamouti_chain_path BER at 10 dB", chain_bers[0],
                ALAMOUTI_BER_10DB)

    # 16. BD: inject parity over the menu and modes; PRNG parity, bitwise
    # chunk invariance and a bitwise rerun at (3, 2) normalized
    def check_caps(name, got, want, **fields):
        rel = float(((got - want).abs() / want.abs()).max())
        err = float((got - want).abs().max())
        phase(name, max_rel_cell_diff=rel, max_abs_cell_diff=err,
              limit=BD_REL_TOL, total_cap=float(want.sum()), **fields)
        if not rel <= BD_REL_TOL:
            raise AssertionError(f"{name}: kernel and plain version differ "
                                 f"by {rel} relative")
        return err

    # The guard zeroes a draw whose smaller gain is within float32 rounding
    # of 0, so the kernel and the plain version may disagree on such a
    # draw (~1e-6 of the draws); at 4,096 solves per cell one disagreement
    # is ~2e-4 of the cell, at 32,768 it is below 3e-5.
    for K, NR in bd_kernel.MENU:
        for mode in bd_kernel.MODES:
            mc = bd_kernel.MonteCarloBD(tile=BD_PARITY_TILE, lane=BD_LANE,
                                        K=K, Nr_u=NR, mode=mode, device=dev)
            ch = bits(2, 2 * BD_PARITY_TILE, mc.num_planes * BD_LANE)
            got = mc.build_inject(2, 2)(ch)
            want = mc.simulate_block_reference(ch)
            torch.cuda.synchronize()
            check_caps(f"bd_inject_parity K={K} Nr_u={NR} {mode}", got,
                       want)
    # PRNG parity over the main path's whole chunk (2.1e6 solves), where
    # such a draw is likely and moves its 4,096-solve cell by ~2.4e-4: the
    # chunk is held per repetition (16,384 solves, ~6e-5 a draw), and the
    # cells' own differences are printed beside it.
    mcb = bd_kernel.MonteCarloBD(tile=BD_TILE, lane=BD_LANE, device=dev)
    k_main = mcb.build(BD_CHUNK, BD_TILES)(seed, 0)
    p_main = mcb.prng_reference(BD_CHUNK, BD_TILES, seed, 0)
    cell_rel = (k_main - p_main).abs() / p_main.abs()
    bd_err = check_caps(
        "bd_prng_parity per rep", k_main.sum(dim=1), p_main.sum(dim=1),
        reps=BD_CHUNK, max_rel_diff_4096_solve_cell=float(cell_rel.max()),
        cells_over_limit=int((cell_rel > BD_REL_TOL).sum()))
    bd_guard_witness(mcb, seed, k_main, p_main)
    k4 = mcb.build(4, BD_TILES)(seed, 4)
    again = mcb.build(BD_CHUNK, BD_TILES)(seed, 0)
    torch.cuda.synchronize()
    same = bool(torch.equal(k_main[4:8], k4))
    rerun = bool(torch.equal(k_main, again))
    phase("bd_chunk_invariance", rows_4_to_7_equal_start_4=same,
          rerun_bitwise_equal=rerun)
    if not (same and rerun):
        raise AssertionError("BD kernel results are not bitwise "
                             "reproducible")

    # 17. B1: the BD kernel through the bulk runner at the bench point
    pu_db = [float(10 * np.log10(10.0 / 3))]

    def bd_runner(rep_max):
        r = BDKernelCapacityRunner(K=3, nr_u=2, tile=BD_TILE, lane=BD_LANE,
                                   num_tiles=BD_TILES, device=dev,
                                   read_command_line_args=False)
        return sweep_runner(r, "Pu_dB", pu_db, rep_max, BD_CHUNK)

    runner = bd_runner(2 * BD_CHUNK)
    runner.mc.launch_count = 0
    runner.mc.reference_count = 0
    caps, seconds = run_sweep_values(runner, "sum_capacity")
    bd_launches = runner.mc.launch_count
    phase("bd_path", pu_db=pu_db, mean_sum_capacity=caps,
          runned_reps=runner.runned_reps, seconds=seconds,
          kernel_launches=bd_launches, chunks=runner.chunks_dispatched,
          plain_calls=runner.mc.reference_count)
    check_range("bd_path mean capacity", caps[0], BD_CAP_RANGE)
    check_launches("bd_path", bd_launches, runner.chunks_dispatched,
                   runner.mc.reference_count)

    # 18. B2: the BD library chain through the per-key runner
    def bd_chain_runner(rep_max):
        r = BatchedBDCapacityRunner("normalized", K=3, nr_u=2, device=dev,
                                    read_command_line_args=False)
        return sweep_runner(r, "Pu_dB", pu_db, rep_max, BD_CHAIN_BATCH)

    runner = bd_chain_runner(2 * BD_CHAIN_BATCH)
    chain_caps, seconds = run_sweep_values(runner, "sum_capacity")
    skipped = runner.results.get_result_values_list("num_skipped_reps")
    phase("bd_chain_path", pu_db=pu_db, mean_sum_capacity=chain_caps,
          runned_reps=runner.runned_reps, skipped_attempts=skipped,
          seconds=seconds, chain_calls=runner.chunks_dispatched)
    check_range("bd_chain_path mean capacity", chain_caps[0], BD_CAP_RANGE)

    # 19. the BD kernel's instances as built (phase 2), then times (CUDA
    # events, best of 3 after a warm-up)
    bd_instances = kernel_ptxas("mc_bd_kernel")
    for name, regs in bd_instances.items():
        phase("bd_build", instance=name, ptxas=repr(regs))
    if len(bd_instances) != 2 * len(bd_kernel.MENU) * len(bd_kernel.MODES):
        raise AssertionError(f"bd_build: {len(bd_instances)} mc_bd "
                             f"instances")
    bd_spilling = sorted(n for n, r in bd_instances.items()
                         if " 0 bytes spill stores" not in r)
    bd_heavy = sorted(n for n, r in bd_instances.items()
                      if n.startswith("mc_bd_kernelILi3ELi2E")
                      and int(r.split()[0]) > BD_MAX_REGISTERS_3_2)
    if bd_spilling or bd_heavy:
        raise AssertionError(f"bd_build: spills in {bd_spilling}, more than "
                             f"{BD_MAX_REGISTERS_3_2} registers in {bd_heavy}")
    run_a = mca.build(ALA_CHUNK, ALA_TILES)
    ala_ms = best_ms(lambda: run_a(seed, snr, 0), inner=10)
    ala_plain_ms = best_ms(lambda: mca.prng_reference(
        ALA_CHUNK, ALA_TILES, seed, amp, 0))
    ala_syms = ALA_CHUNK * ALA_TILES * mca.symbols_per_grid_step
    # outputs only: nothing is read per element in PRNG mode
    ala_sass, ala_bound, ala_bound_by, ala_pipe = sass_bound(
        mca.prng_kernel_profile(ALA_CHUNK, ALA_TILES),
        nbytes=4 * ALA_CHUNK * ALA_TILES)
    run_b = mcb.build(BD_CHUNK, BD_TILES)
    bd_ms = best_ms(lambda: run_b(seed, 0), inner=10)
    bd_plain_ms = best_ms(lambda: mcb.prng_reference(BD_CHUNK, BD_TILES,
                                                     seed, 0))
    bd_solves = BD_CHUNK * BD_TILES * mcb.solves_per_grid_step
    bd_sass, bd_built_bound, _, bd_pipe = sass_bound(
        mcb.prng_kernel_profile(BD_CHUNK, BD_TILES),
        nbytes=4 * BD_CHUNK * BD_TILES)
    bd_fewest_bound, bd_fewest_pipe = sass.issue_bound_ms(
        BD_FEWEST_SASS_PER_SOLVE, bd_solves)
    bd_bound, bd_bound_by = bound_ms(
        nbytes=4 * BD_CHUNK * BD_TILES,
        issue_ms=min(bd_built_bound, bd_fewest_bound))

    def step_ms(runner, batch):
        """One chain call of the per-key runner's kernel on ``batch``
        attempts of its first variation."""
        params = runner.params.get_unpacked_params_list()[0]
        kernel = runner._gen_simulation_kernel(params)
        streams = AttemptStreams.from_range(
            kernel_stream_seed(runner.base_seed, 0), 0, batch, dev)
        return best_ms(lambda: kernel(streams))

    ala_chain_ms = step_ms(ala_chain_runner(ALA_CHAIN_BATCH), ALA_CHAIN_BATCH)
    bd_chain_ms = step_ms(bd_chain_runner(BD_CHAIN_BATCH), BD_CHAIN_BATCH)
    ala_engine_ms = best_ms(ala_runner([10.0], 4 * ALA_CHUNK).simulate)
    bd_engine_ms = best_ms(bd_runner(4 * BD_CHUNK).simulate)
    phase("times", card=repr(smi),
          alamouti_shape=f"reps={ALA_CHUNK},tiles={ALA_TILES},"
          f"tile={ALA_TILE},lane={ALA_LANE}",
          alamouti_kernel_ms=ala_ms,
          alamouti_kernel_sym_per_s=ala_syms / ala_ms * 1e3,
          alamouti_bound_ms=ala_bound, alamouti_bound_by=ala_bound_by,
          alamouti_bound_pipe=ala_pipe,
          alamouti_sass_per_thread=compact(ala_sass),
          alamouti_share_of_bound=ala_bound / ala_ms,
          alamouti_plain_ms=ala_plain_ms,
          bd_shape=f"reps={BD_CHUNK},tiles={BD_TILES},tile={BD_TILE},"
          f"lane={BD_LANE},K=3,Nr_u=2,normalized",
          bd_kernel_ms=bd_ms, bd_kernel_solves_per_s=bd_solves / bd_ms * 1e3,
          bd_bound_ms=bd_bound, bd_bound_by=bd_bound_by,
          bd_share_of_bound=bd_bound / bd_ms,
          bd_built_bound_ms=bd_built_bound, bd_built_bound_pipe=bd_pipe,
          bd_sass_per_thread=compact(bd_sass),
          bd_share_of_built_bound=bd_built_bound / bd_ms,
          bd_fewest_bound_ms=bd_fewest_bound,
          bd_fewest_bound_pipe=bd_fewest_pipe,
          bd_fewest_sass_per_solve=BD_FEWEST_SASS_PER_SOLVE["total"],
          bd_plain_ms=bd_plain_ms,
          bd_registers_3_2=bd_instances.get(
              "mc_bd_kernelILi3ELi2ELi0ELb0E", "?"),
          bd_spilling_instances=len(bd_spilling),
          alamouti_chain_step_ms=ala_chain_ms,
          alamouti_chain_sym_per_s=ALA_CHAIN_BATCH * ALA_CHAIN_SYMBOLS /
          ala_chain_ms * 1e3,
          bd_chain_step_ms=bd_chain_ms,
          bd_chain_solves_per_s=BD_CHAIN_BATCH / bd_chain_ms * 1e3,
          alamouti_engine_ms=ala_engine_ms,
          alamouti_engine_sym_per_s=4 * ala_syms / ala_engine_ms * 1e3,
          bd_engine_ms=bd_engine_ms,
          bd_engine_solves_per_s=4 * bd_solves / bd_engine_ms * 1e3)
    return [{
        "name": "mc_alamouti_prng",
        "route": "cuda",
        "source": "pyphysim_tpu_torch/ops/csrc/mc_alamouti.cu",
        "replaces": "pyphysim_tpu/ops/alamouti_pallas.py:180",
        "launches": ala_launches,
        "max_abs_err": ala_err,
        "ms": ala_ms,
        "timed_by": "wrapper_events",
        "wrapper_ms": ala_ms,
        "plain_ms": ala_plain_ms,
        "bound_ms": ala_bound,
        "bound_by": ala_bound_by,
        "library_ms": None,
    }, {
        "name": "mc_bd_prng",
        "route": "cuda",
        "source": "pyphysim_tpu_torch/ops/csrc/mc_bd.cu",
        "replaces": "pyphysim_tpu/ops/bd_pallas.py:282",
        "launches": bd_launches,
        "max_abs_err": bd_err,
        "ms": bd_ms,
        "timed_by": "wrapper_events",
        "wrapper_ms": bd_ms,
        "plain_ms": bd_plain_ms,
        "bound_ms": bd_bound,
        "bound_by": bd_bound_by,
        "library_ms": None,
    }]


def ia_capacity(H):
    """``bench.py``'s ``ia_step`` after its draw, on the port: Max-SINR from
    the 'svd' init on a batch of K=3, 2x2 channels ``H`` and each one's sum
    capacity."""
    from pyphysim_tpu_torch.ia.batched import (calc_sinrs, max_sinr_solve,
                                               sum_capacity)
    F, U = max_sinr_solve(H, None, Ns=1, noise_var=IA_NV,
                          iterations=IA_ITERS, init="svd")
    return sum_capacity(calc_sinrs(H, F, U, IA_NV, 1.0))


def ia_step(streams):
    """``bench.py``'s ``ia_step``, batched over the attempts of
    ``streams``: each attempt's channel from its stream, then
    :func:`ia_capacity`."""
    from pyphysim_tpu_torch.utils.misc import randn_c
    return ia_capacity(randn_c(streams, 3, 3, 2, 2))


def ia_plain(mc, reps, num_tiles, seed, start=0):
    """The IA kernel's plain version over a chunk in slices of
    ``IA_PLAIN_SLICE`` reps (bounds its memory): (reps, num_tiles)."""
    import torch
    return torch.cat([
        mc.prng_reference(min(IA_PLAIN_SLICE, reps - r), num_tiles, seed,
                          IA_NV, start + r)
        for r in range(0, reps, IA_PLAIN_SLICE)])


def ptxas_info(log, kernel):
    """``{instance: "registers, spill stores / loads"}`` of the instances
    of the kernel named by the regex ``kernel`` in the ``-Xptxas -v`` lines
    of the nvcc log ``log`` (text)."""
    import re
    out, name = {}, None
    for line in log.splitlines():
        if "entry function" in line:
            m = re.search(rf"\d({kernel}I\w*?)EEv", line)
            name = m.group(1) if m else None
        elif name and "spill" in line:
            out[name] = re.sub(r"\s+", " ", line.strip())
        elif name and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            out[name] = f"{regs} registers, {out.get(name, '')}"
            name = None
    return out


def kernel_ptxas(kernel):
    """:func:`ptxas_info` of the library built in this run."""
    from pyphysim_tpu_torch.ops import _build
    log = _build.library_path().with_suffix(".log")
    return ptxas_info(log.read_text() if log.exists() else "", kernel)


def card():
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def ia_phases(dev, smi):
    """Phases 20-26: the Max-SINR IA kernel's build, its inject parity at
    every menu point and PRNG parity at the bench widths, the physics of
    the kernel and of the batched chain, the bulk app (the main path) and
    the per-key stream-selection app, and their times. Returns the kernel's
    entry of the ``kernels`` line."""
    import numpy as np
    import torch
    from apps.ia.batched_stream_selection_torch import StreamSelectionRunner
    from apps.ia.ia_mc_kernel_torch import IaMcKernelSimulationRunner
    from pyphysim_tpu_torch.ops import ia_kernel
    from pyphysim_tpu_torch.ops.streams import AttemptStreams

    # 20. the kernel instances the build made (phase 2 built the library)
    instances = kernel_ptxas("mc_ia_(?:closed|general)_kernel")
    for name, regs in instances.items():
        phase("ia_build", instance=name, ptxas=repr(regs))
    if len(instances) != 2 * len(ia_kernel.MENU):
        raise AssertionError(f"ia_build: {len(instances)} mc_ia instances, "
                             f"expected {2 * len(ia_kernel.MENU)}")

    g = torch.Generator(device=dev).manual_seed(17)

    def check_caps(name, got, want, **fields):
        rel = (got - want).abs() / want.abs()
        worst = int(rel.argmax())
        err = float((got - want).abs().max())
        phase(name, max_rel_cell_diff=float(rel.max()),
              worst_cell=worst, worst_got=float(got.flatten()[worst]),
              worst_plain=float(want.flatten()[worst]),
              max_abs_cell_diff=err, limit=IA_REL_TOL,
              total_cap=float(want.sum()), **fields)
        if not float(rel.max()) <= IA_REL_TOL:
            raise AssertionError(f"{name}: kernel and plain version differ "
                                 f"by {float(rel.max())} relative")
        return err

    # 21. inject parity at every menu point, 32,768 solves per cell
    for K, N, Ns in ia_kernel.MENU:
        mc = ia_kernel.MonteCarloMaxSinr(tile=IA_PARITY_TILE, lane=IA_LANE,
                                         iterations=IA_ITERS, K=K, N=N,
                                         Ns=Ns, device=dev)
        ch = torch.randint(-2 ** 31, 2 ** 31,
                           (2, 2 * IA_PARITY_TILE, mc.num_planes * IA_LANE),
                           dtype=torch.int32, device=dev, generator=g)
        got = mc.build_inject(2, 2)(ch, IA_NV)
        want = mc.simulate_block_reference(ch, IA_NV)
        torch.cuda.synchronize()
        check_caps(f"ia_inject_parity K={K} N={N} Ns={Ns}", got, want)

    # 22. PRNG parity over the bench chunk (2.1e6 solves), held per rep
    # (16,384 solves), the 4,096-solve cells printed beside it; bitwise
    # chunk invariance and rerun
    seed = 777
    mci = ia_kernel.MonteCarloMaxSinr(tile=IA_TILE, lane=IA_LANE,
                                      iterations=IA_ITERS, device=dev)
    k_main = mci.build(IA_CHUNK, IA_TILES)(seed, IA_NV, 0)
    p_main = ia_plain(mci, IA_CHUNK, IA_TILES, seed)
    cell_rel = (k_main - p_main).abs() / p_main.abs()
    ia_err = check_caps(
        "ia_prng_parity per rep", k_main.sum(dim=1), p_main.sum(dim=1),
        reps=IA_CHUNK, max_rel_diff_4096_solve_cell=float(cell_rel.max()),
        cells_over_limit=int((cell_rel > IA_REL_TOL).sum()))
    k4 = mci.build(4, IA_TILES)(seed, IA_NV, 4)
    again = mci.build(IA_CHUNK, IA_TILES)(seed, IA_NV, 0)
    torch.cuda.synchronize()
    same = bool(torch.equal(k_main[4:8], k4))
    rerun = bool(torch.equal(k_main, again))
    phase("ia_chunk_invariance", rows_4_to_7_equal_start_4=same,
          rerun_bitwise_equal=rerun)
    if not (same and rerun):
        raise AssertionError("IA kernel results are not bitwise "
                             "reproducible")

    # 23. physics: the kernel's and the batched chain's mean sum capacity
    solves = IA_CHUNK * IA_TILES * mci.solves_per_grid_step
    kernel_mean = float(k_main.sum()) / solves
    chain_caps = ia_step(AttemptStreams.from_range(99, 0, IA_CHAIN_BATCH,
                                                   dev))
    chain_mean = float(chain_caps.mean())
    phase("ia_physics", kernel_mean_sum_capacity=kernel_mean,
          kernel_solves=solves, chain_mean_sum_capacity=chain_mean,
          chain_solves=IA_CHAIN_BATCH,
          chain_finite=bool(torch.isfinite(chain_caps).all()))
    check_range("ia kernel mean capacity", kernel_mean, IA_CAP_RANGE)
    check_range("ia chain mean capacity", chain_mean, IA_CAP_RANGE)

    # 24. the main path: the bulk app through the runner, on the kernel
    def ia_runner(snrs, rep_max, batch):
        r = IaMcKernelSimulationRunner(K=3, tile=IA_TILE, lane=IA_LANE,
                                       num_tiles=IA_TILES,
                                       iterations=IA_ITERS, device=dev,
                                       read_command_line_args=False)
        return sweep_runner(r, "SNR", snrs, rep_max, batch)

    snrs = [0.0, 10.0, 20.0]
    runner = ia_runner(snrs, 2 * IA_CHUNK, IA_CHUNK)
    runner.mc.launch_count = 0
    runner.mc.reference_count = 0
    caps, seconds = run_sweep_values(runner, "sum_capacity")
    ia_launches = runner.mc.launch_count
    half = ia_runner(snrs, 2 * IA_CHUNK, IA_CHUNK // 2)
    half_caps, _ = run_sweep_values(half, "sum_capacity")
    phase("ia_path", snr_db=snrs, mean_sum_capacity=caps,
          runned_reps=runner.runned_reps, seconds=seconds,
          kernel_launches=ia_launches, chunks=runner.chunks_dispatched,
          plain_calls=runner.mc.reference_count,
          half_chunks_bitwise_equal=caps == half_caps)
    if not caps[0] < caps[1] < caps[2]:
        raise AssertionError("ia_path: capacity does not rise with SNR")
    check_range("ia_path mean capacity at 10 dB", caps[1], IA_CAP_RANGE)
    check_launches("ia_path", ia_launches, runner.chunks_dispatched,
                   runner.mc.reference_count)
    if caps != half_caps:
        raise AssertionError("ia_path: results depend on the chunk size")

    # 25. the per-key path: the stream-selection app (brute force and
    # greedy searches, batched)
    sel = StreamSelectionRunner(reps=256, iters=12, device=dev)
    sel.batch_size = 128
    tic = time.time()
    sel.simulate()
    seconds = time.time() - tic
    sel_caps = [float(v) for v in
                sel.results.get_result_values_list("sum_capacity")]
    ratios = [float(v) for v in
              sel.results.get_result_values_list("greedy_capacity_ratio")]
    hist = [[round(float(h), 4) for h in r.get_result()]
            for r in sel.results["stream_choice"]]
    phase("ia_stream_selection_path", snr_db=[0.0, 10.0, 20.0],
          brute_mean_capacity=sel_caps, greedy_over_brute=ratios,
          choice_histograms=compact(hist), runned_reps=sel.runned_reps,
          seconds=seconds, chain_calls=sel.chunks_dispatched)
    if not sel_caps[0] < sel_caps[1] < sel_caps[2]:
        raise AssertionError("stream selection: capacity does not rise "
                             "with SNR")
    if not all(0.5 < x <= 1.0 + 1e-6 for x in ratios):
        raise AssertionError(f"stream selection: greedy / brute {ratios}")

    # 26. times (CUDA events, best of 3 after a warm-up)
    run_i = mci.build(IA_CHUNK, IA_TILES)
    ia_ms = best_ms(lambda: run_i(seed, IA_NV, 0), inner=10)
    ia_plain_ms = best_ms(lambda: ia_plain(mci, IA_CHUNK, IA_TILES, seed))
    # outputs only: nothing is read per element in PRNG mode
    ia_sass, ia_bound, ia_bound_by, ia_pipe = sass_bound(
        mci.prng_kernel_profile(IA_CHUNK, IA_TILES),
        nbytes=4 * IA_CHUNK * IA_TILES)
    engine_ms = best_ms(ia_runner([10.0], 4 * IA_CHUNK, IA_CHUNK).simulate)
    streams = AttemptStreams.from_range(99, 0, IA_CHAIN_BATCH, dev)
    chain_ms = best_ms(lambda: ia_step(streams))
    phase("times", card=repr(smi),
          ia_shape=f"reps={IA_CHUNK},tiles={IA_TILES},tile={IA_TILE},"
          f"lane={IA_LANE},K=3,N=2,Ns=1,iterations={IA_ITERS}",
          ia_kernel_ms=ia_ms, ia_kernel_solves_per_s=solves / ia_ms * 1e3,
          ia_bound_ms=ia_bound, ia_bound_by=ia_bound_by,
          ia_bound_pipe=ia_pipe, ia_sass_per_thread=compact(ia_sass),
          ia_share_of_bound=ia_bound / ia_ms, ia_plain_ms=ia_plain_ms,
          ia_engine_ms=engine_ms,
          ia_engine_solves_per_s=4 * solves / engine_ms * 1e3,
          ia_chain_step_ms=chain_ms,
          ia_chain_solves_per_s=IA_CHAIN_BATCH / chain_ms * 1e3)
    return {
        "name": "mc_maxsinr_prng",
        "route": "cuda",
        "source": "pyphysim_tpu_torch/ops/csrc/mc_ia.cu",
        "replaces": "pyphysim_tpu/ops/ia_pallas.py:480",
        "launches": ia_launches,
        "max_abs_err": ia_err,
        "ms": ia_ms,
        "timed_by": "wrapper_events",
        "wrapper_ms": ia_ms,
        "plain_ms": ia_plain_ms,
        "bound_ms": ia_bound,
        "bound_by": ia_bound_by,
        "library_ms": None,
    }


if __name__ == "__main__":
    sys.exit(main())
