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
    the runner's per-key path (phases 8-12), and the chain step replayed
    as one CUDA graph against the step launched op by op (phase 12b);
  * the 4x4 MIMO-OFDM step at the benchmark's LTE 20 MHz / EVA70
    configuration (phase 12c): the per-RE MMSE detector kernel
    (``mimo_mmse``) bit for bit its plain version on the step's own
    inputs, a replayed step's launches (3 fills, 1 ``block_fir``, 1
    ``mimo_mmse``) and counts against its eager step, and the kernel's
    time beside its byte bound, its plain version and the batched
    ``torch.linalg.solve`` route;
  * the 4-layer PUSCH step at the benchmark's LTE-A uplink / ETU70
    configuration (phase 12d): the SC-FDMA equalizer kernel
    (``sc_mmse_eq``) and the decision kernel after the de-spreading IDFT
    (``sc_decide``) bit for bit their plain versions on the step's own
    values, a replayed step's launches (3 fills, 1 ``block_fir``, 1
    ``sc_mmse_eq``, 1 ``sc_decide``) and counts against its eager step,
    and the kernels' times beside their byte bounds, registers and
    spills;
  * the per-key steps' symbol map and decision (phase 12e, ``qam_phase``):
    ``qam_map`` at the three per-key cells' shapes and ``ChainStep``'s
    decision (``sc_decide`` with a unit gain) at ``tu.perkey``'s, bit for
    bit their plain versions over 10 calls on the steps' own draws and
    equalized values, each replayed step against its eager step in turns
    (counts equal, one map launch a replay, and one decision launch a
    ``ChainStep`` replay), and their graph replay times on inputs that
    outgrow the L2 beside their byte bounds; the map's registers and
    spills. The runner's sweeps (phases 9, 10) and the MIMO and PUSCH
    replays (12c, 12d) check one map launch a step call there;
  * the Alamouti 2x1 family through its CUDA kernel on the bulk path and
    through its library chain on the per-key path, and the BD CoMP capacity
    family the same way, at ``bench.py``'s widths (phases 13-19);
  * the Max-SINR interference-alignment family: its CUDA kernel against its
    plain version at every point of the kernel's menu and at the bench
    widths, the bulk app and the batched chain (``ia_step``), the per-key
    stream-selection app, and their times (phases 20-26).
  * the comp_BD CoMP scenario (EnhancedBD / WhiteningBD stream sacrifice
    under external interference, ``apps/comp_BD/simulate_comp_torch.py``):
    its batched solvers on the card against the same functions on the CPU,
    ``bench.py``'s stage at full width through the runner's bulk path (its
    draws through the ``philox_stream_fill`` kernel), chunk invariance,
    every metric and the non-square configuration, the host engine, and
    the stage's times (phases 27-31). This path reaches no TPU kernel.
  * the MIMO and multiuser TDL channels (phases 32-37): the MIMO
    block-static route (``TdlMimoChannel.corrupt_data`` with a block size,
    one ``block_fir`` launch over every (rx, tx) pair's blocks) at 64
    attempts x 4x4 x 32 OFDM blocks of 564 samples, then 2x3 and 2x3 on
    the uplink (``mimo_fir``), each held to block_fir's plain version at
    its rows, to the FFT route and to per-sample filtering; a K = 3
    ``MuMimoChannel`` interference sweep (QPSK on 300 of 512 carriers, 14
    OFDM symbols, SNR 10 / 20 / 30 dB, 4,096 attempts in chunks of 256,
    the JAX test's path losses and equal power) through the runner's
    per-key path, against the CPU route on the same attempts
    (``mu_mimo_path``); the LS / MMSE estimation sweep (Nr 4, the comb-2
    SRS of 300 subcarriers, 16,384 realizations) against its theory
    (``estimation_path``); ``apps/simple_precoded_srs_torch.py`` and
    ``apps/ia/simulate_ia_torch.py`` on the card against the CPU, and
    ``apps/ia/simulate_greedy_ia_torch.py`` once (``srs_app``,
    ``ia_app``, ``greedy_ia_app``); and their times (``mimo_times``).
  * the data-parallel layer (phases 38-42, ``parallel_phases``):
    ``make_mesh`` starts a world-size-1 NCCL group and all-gathers on it
    (``mesh``); the flagship bulk runner through ``simulate_in_parallel``
    at full width in both product types, bit for bit ``simulate()``'s,
    then with ``block=False`` (``parallel_main_path``,
    ``parallel_async``); the Alamouti, BD and IA bulk runners the same way,
    per rep (``parallel_families``); every Monte Carlo kernel's sharded
    PRNG build against its unsharded launch, on the 1-rank mesh and as the
    launches of 2- and 4-rank splits (``sharded_build``); and the
    time-sharded TDL channel through ``block_fir`` against the unsharded
    ``corrupt_data``, also as 4 shards with their halos added in this
    process (``time_sharded_channel``).
  * the last apps (phases 43-46, ``app_phases``): the Grassmannian
    codebook search (``apps/find_codebook_torch.py``) at its CLI defaults
    and at G(4, 2), K = 64 in each codebook type (``find_codebook``);
    the quantized-CSI Max-SINR IA app at its defaults
    (``maxsinr_quantized``); the METIS scenario-2 drops
    (``metis_scenario2``); the three host IA solvers of the feasibility
    app at 4x4 (``ia_feasibility``); each on the card against the CPU on
    the same Philox draws, with its rates, its launches and the device's
    busy time and share from a ``torch.profiler`` trace.
  * the BD and IA kernels at geometries outside the prebuilt kernel
    library (phases 55-60, ``geometry_phases``), each geometry built into
    a library of its own at phase 2 beside the prebuilt one: BD (3, 1)
    in the prebuilt kernel's form (and in the wide form, which the two
    are held against each other and timed in), (5, 2), the 7-cell CoMP
    cluster (7, 2), (8, 2) and (11, 2), whose per-element state is past
    shared memory; IA (5, 2, 1), (2, 3, 1),
    (3, 4, 2) and (4, 4, 2); inject parity in every mode, PRNG parity per
    rep, a rerun and another chunking, the main paths (BD (7, 2) through
    the bulk runner at bench.py's widths, IA K = 5 through the bulk app, IA
    (3, 4, 2) through ``MonteCarloMaxSinr.build``), the instances'
    registers and spills, each library's build seconds, and the times
    beside the bounds; the 1-rank sharded builds of the three main points
    equal their unsharded launches (phase 41).
  * the flagship kernel and ``block_fir`` at shapes past their first
    forms (phases 61-64, ``shape_phases``): the Monte Carlo kernel's
    general form at 51 taps of 32 rays (the IEEE 802.11 exponential
    profile, Trms = 250 ns) through the bulk runner in PRNG and inject
    mode and both product types (``f1_*``); 70,000 reps and 70,000 tiles
    in one call (two launches of the fast instance each, ``f2_*``);
    ``block_fir``'s segments form at 81 taps through ``TdlChannel`` /
    ``TdlMimoChannel.corrupt_data(..., block_size=564)`` and at
    COST259-HT's long spans and blocks of 8,192 and 16,384 (``b_route``),
    and its direct form once (``b_direct``); each against its plain
    version, with its time, bound, launch (registers, spills, shared
    bytes, blocks a SM), launches and library call.
  * the notebooks (phases 47-54, ``notebook_phases``): each of
    ``notebooks/0*_torch.py`` that touches a tensor (all but 07) run at
    its own settings with ``DEVICE="cuda"`` and again on the CPU, the card
    held to the CPU on the same Philox draws (a boundary flip or two a
    1e6 symbols) or injected bits, and to each notebook's physics (closed
    forms, ``bench.py``'s bands); 02 and 04 drive ``block_fir``, 09
    ``mc_bd`` (PRNG and inject) and ``mc_ia`` (the closed and the general
    kernel), and their sharded results equal the unsharded ones.

One line per phase; any failure raises and the script exits non-zero.
There is no CPU fallback: without a CUDA device it fails before printing
any result.

Run from the repository root: ``python3 chip_smoke.py`` (one card, a few
minutes including the nvcc builds, one per source, in parallel).
"""

import contextlib
import functools
import hashlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time

BER_CORNERS = {5.0: (0.08, 0.22), 15.0: (0.02, 0.06), 30.0: (2e-4, 6e-3)}
TILE, NUM_TILES = 1024, 4           # flagship kernel shape
PAR_REPS, PAR_CHUNK = 512, 128      # flagship under simulate_in_parallel
TS_BLOCKS = 4096                    # time-sharded channel: OFDM symbols
TS_ATOL = 2e-5                      # tests/test_parallel.py's tolerance
REL_TOL = 2e-4                      # |kernel - plain| per cell / cell bits
FIR_REL_TOL = 1e-5                  # block_fir: max |kernel - plain| / max |y|
FIR_ROWS = (8192, 1000, 1)          # time-domain step's rows; ragged counts
# phase 8's other geometries, (rows, block_size, offsets): a row of 4,520 B
# (not a multiple of 16), 20 taps over 96 samples, 64 taps over 127
FIR_GEOMETRIES = ((1000, 565, None), (1000, 564, tuple(range(0, 100, 5))),
                  (256, 564, tuple(range(0, 128, 2))))
# phases 61-64 (shape_phases): the flagship kernel and block_fir past their
# first forms. F1: the IEEE 802.11 exponential-decay profile (taps every
# 50 ns, power exp(-k Ts / Trms), k <= 10 Trms / Ts) at Trms = 250 ns, 51
# taps, under 32 Jakes rays (TL = 1,632); F2: the flagship past the grid's
# 65,535 a dimension; B1: the same model at 400 ns (81 taps), block 564 over
# the time-domain step's 8,192 rows, SISO and 2x2 MIMO; B2: COST259-HT at
# 20 MHz (span 361), block 8,192 over 1,024 rows, and at 100 MHz (span
# 1,802), block 16,384 over 256 rows
EXP_TRMS_F1, EXP_TRMS_B1, EXP_RAYS = 250e-9, 400e-9, 32
F2_REPS, F2_TILES, F2_TILE, F2_SPLIT = 70000, 70000, 8, 65530
F2_PLAIN_SLICE = 4096               # reps a plain call (memory)
F2_CELL = 1000                      # symbols a cell of F2's whole-call check
F1_PLAIN_SLICE = 8                  # reps a plain call at 1,632 pairs
# taps of F1's equal-power profile (every 50 ns, a span of 52 inside the
# flagship's CP of 52): 20 past the general form's first chunk of 32,
# carrying 38 % of the power (the exponential's taps past 31 carry 0.2 %)
FLAT_TAPS = 52
FIR_SHAPES = (("T81_B564", "exponential", 20e6, 564, 256, 32),
              ("HT20_B8192", "ht", 20e6, 8192, 256, 4),
              ("HT100_B16384", "ht", 100e6, 16384, 64, 4))
# block_fir's direct form, timed once: a span past what one stage of the
# segments form holds (two taps 30,000 samples apart) over 256 rows
FIR_DIRECT_SHAPE = (256, 16384, (0, 30000))
# The bounds of the flagship kernel's shapes past its first forms, from the
# first general form's listings (NVIDIA H100 80GB HBM3, 700 W): F1 36,883 /
# 38,624 SASS a thread (f32 / bf16) x 614,400 threads, F2 tiles 2,595 x
# 1,120,000 (its general form's trips over the 16 taps). A redesign that issues
# fewer instructions lowers its own listing's bound; the bound is the
# least time for the same work, so each entry takes the smaller of the two
REF_BOUND_MS = {"mc_ofdm_tdl_general_prng_T51_L32": 0.6774,
                 "mc_ofdm_tdl_general_prng_T51_L32_bf16": 0.7093,
                 "mc_ofdm_tdl_general_prng_tiles70000": 3.2574}
# The fewest SASS instructions known a thread for the flagship kernel's
# fast instance in PRNG mode under the COST259-TU channel (16 taps x 16
# rays, 300 used bins), by pipe as ops/sass.py counts them, at the rows a
# block of the shapes this script bounds it at (64: the bench chunk; 8:
# F2's tiles of 8): the listing from before each launch carried its first
# tile (NVIDIA H100 80GB HBM3). The bound is the least time for the same
# work, so a listing that issues more does not raise it (``fast_fewest``).
FAST_FEWEST_SASS = {
    ("mc_ofdm_tdl_kernelILi16ELb0ELb0EE", 64): {
        "total": 17140.2053, "imad": 1587.9112, "alu": 4693.5646,
        "xu": 680.9823},
    ("mc_ofdm_tdl_kernelILi16ELb0ELb1EE", 64): {
        "total": 17358.6586, "imad": 1704.0022, "alu": 4688.7002,
        "xu": 790.209},
    ("mc_ofdm_tdl_kernelILi16ELb0ELb0EE", 8): {
        "total": 2561.6507, "imad": 284.7872, "alu": 761.6022,
        "xu": 89.2411}}
FILL_ROWS, FILL_WORDS = 512, 2049   # phase 3: 1,049,088 draws a kind, odd m
FILL_ULP_LIMIT = 2                  # normals: kernel vs plain, in ulps
FILL_GRID_COUNTERS = 132 * 16 * 256  # counters one fill grid covers a stride
TD_BATCH, TD_SYMBOLS = 256, 300 * 32    # bench.py's time-domain step
FUSED_BATCH, FUSED_SYMBOLS = 512, 300 * 16  # bench.py's fused step
REPLAY_BATCHES = (32, 256)          # the benchmark's sub-chunk; bench.py's
REPLAY_INNER = 8                    # steps a timing of the replay phase
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
# Geometries outside the prebuilt kernel library, each built into a library
# of its own at phase 2 (mc_bd.cu's prebuilt form up to NT = 8, else the
# wide form of mc_bd.cu / mc_ia.cu): BD (K, Nr_u) up to the 7-cell CoMP
# cluster (7, 2) of the main path, (8, 2) and (11, 2); IA (K, N, Ns) with
# the closed form at K = 5, the general body at odd N and at the
# feasibility app's 3-user 4x4 two-stream point, and IA_SCRATCH, the
# fewest users of that point whose group state passes 227 KB a block: the
# scratch buffer of ops/csrc/wide.cuh (a BD geometry gets there first at
# (61, 2): its unrolled solve builds in minutes and its plain version runs
# for some ten; bin/probe_wide_builds.py builds and reruns it)
BD_GEOMETRIES = ((3, 1), (5, 2), (7, 2), (8, 2), (11, 2))
BD_WIDE_MAIN = (7, 2)
BD_FORMS = (3, 1)      # built in both forms too: held together and timed
IA_SCRATCH = (15, 4, 2)
IA_GEOMETRIES = ((5, 2, 1), (2, 3, 1), (3, 4, 2), (4, 4, 2), IA_SCRATCH)
IA_WIDE_MAIN = ((5, 2, 1), (3, 4, 2))   # runner (closed); build (general)
WIDE_PRNG_REPS = 8                  # PRNG parity away from the main points
WIDE_PLAIN_SLICE = 16               # reps per plain-version call (memory)
# comp_BD scenario (bench.py _bench_comp_bd_scenario, :550-615): SNR 20 dB,
# Pe 10 dBm, random drops, metrics None / capacity / Whitening
COMP_BD_SER_CAPACITY = (0.0015, 0.03)
COMP_BD_SER_NONE = (0.025, 0.15)
COMP_BD_CHUNK = 4096                # bench.py's batch_size
COMP_BD_REPS = 16384                # bench.py's timed reps
COMP_BD_METRICS = ["None", "capacity", "Whitening"]
COMP_BD_SOLVER_DRAWS = 4096         # batched solvers: card against CPU
COMP_BD_SINR_RTOL = 1e-3            # solvers: error floor (see phase 27)
COMP_BD_FLIP_LIMIT = 8              # Ns flips (near ties) per 4,096 draws
COMP_BD_SMALL_REPS = 2048           # every metric, and the non-square file
# MIMO block-static route (bench.py's COST259-TU, Jakes 30 Hz, Ts 50 ns,
# L 16): attempts x (Nr, Nt) x OFDM blocks of 564 samples
MIMO_ATTEMPTS, MIMO_BLOCKS, MIMO_BLOCK = 64, 32, 564
MIMO_REL_TOL = 1e-5                 # route vs route: max |diff| / max |y|
MU_REPS, MU_CHUNK = 4096, 256       # the K = 3 interference sweep
MU_SER_BAND = (0.05, 0.95)          # the JAX test's band, equal power
MU_FLIP_SHARE = 1e-4                # card vs CPU: symbol flips / symbols
EST_REPS, EST_CHUNK = 16384, 4096   # LS / MMSE realizations
EST_REL_TOL = 0.03                  # sample MSE vs theory
IA_APP_CONFIG = """[Scenario]
SNR = 20
M = 4
modulator = PSK
NSymbs = 100
K = 3
Nr = 2
Nt = 2
Ns = 1
[IA Algorithm]
max_iterations = 5,60
initialize_with = random
[General]
max_bit_errors = 1000000
unpacked_parameters = SNR, max_iterations, initialize_with
rep_max = 8
"""
# the last apps (phases 43-46): the codebook search's CLI defaults and the
# larger G(4, 2) searches, one a codebook type
CB_DEFAULT = dict(Nt=3, Ns=1, K=16, rep_max=10000, batch=256)
CB_LARGE = dict(Nt=4, Ns=2, K=64, rep_max=65536, batch=2048)
CB_CPU_REPS = 4096                  # candidates scored on both routes
CB_HOST_TOL = 1e-3                  # vs float64 numpy (tests/test_apps.py)
CB_CPU_TOL = 1e-5                   # card vs CPU best distance
QIA_ARGS = dict(reps=300, codebook_size=512, snr=15.0, nsymbs=50)
# card vs CPU bit flips: the streams' normals differ by a few ulps
# (ROADMAP property 8); on the CPU a 3-ulp change of the channels moves
# no decision in 45,000 bits, so 0.1 % of the bits is a wide margin
QIA_FLIP_SHARE = 1e-3
METIS_DROPS = ((100, 0), (10000, 1))  # (users, seed) at 12 rooms, dec. 2
METIS_RTOL = 1e-4                   # card vs CPU SINR and capacity
# the host IA solvers are numpy on both routes; only the channel's
# normals differ (a few ulps), which moved the capacities by <= 2.2e-7
# relative and the leakage by <= 5e-10 on the CPU
FEAS_CAP_RTOL = 1e-4
FEAS_COST_ATOL = 1e-6
# the notebooks (phases 47-54): card against the CPU run of the same
# notebook on the same Philox draws
NB_FLIPS_PER_1E6 = 2                # flips a 1e6 symbols (ROADMAP property 14)
NB_BAND_SIGMAS = 5.0                # bit errors against a closed form
NB_IA_RTOL = 1e-3                   # 03: mean IA capacities, 25 iterations
NB_OUT_RTOL = 1e-5                  # 02: frequency-domain output / max |out|
NB_PL_RTOL = 1e-12                  # 06: float64 path losses
GREEDY_APP_CONFIG = """[Grid]
cell_radius = 1.0
num_cells = 3
num_clusters = 1
[Scenario]
NSymbs = 100
SNR = 20
M = 4
modulator = PSK
Nr = 3
Nt = 3
Ns = 3
N0 = -116.4
scenario = Random, NoPathLoss
[IA Algorithm]
max_iterations = 60
initialize_with = random
stream_sel_method = greedy
[General]
rep_max = 4
max_bit_errors = 1000000
unpacked_parameters = SNR, stream_sel_method, scenario, initialize_with
"""


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


def rotated_graph_ms(fn, args, nbytes, inner=10):
    """:func:`graph_ms` of ``fn(*args)`` on copies of ``args``, one a call
    and enough that one replay moves three times the card's 50 MB L2
    (``nbytes`` a call; at least ``inner`` calls): each call reads its
    inputs from HBM, as a step's call does, and writes an output of its
    own (kept to the end)."""
    calls = max(inner, -(-150_000_000 // nbytes))
    copies = [[a.clone() for a in args] for _ in range(calls)]
    outputs = []

    def call():
        outputs.append(fn(*copies[len(outputs) % calls]))
    return graph_ms(call, inner=calls)


def zero_counts(wrappers):
    for w in wrappers:
        w.launch_count = 0
        w.reference_count = 0


def check_step_kernels(name, calls, wrappers):
    """Each kernel of ``wrappers`` launched once a step call of the
    ``calls`` since its counters were zeroed, and its plain version never.
    Returns each one's launches."""
    launches = tuple(w.launch_count for w in wrappers)
    plain = tuple(w.reference_count for w in wrappers)
    if calls == 0 or any(n != calls for n in launches) or any(plain):
        raise AssertionError(f"{name}: launches {launches} and plain calls "
                             f"{plain} of {[w.__name__ for w in wrappers]} "
                             f"for {calls} step calls")
    return launches


def bound_ms(nbytes=0, flops=0, issue_ms=0.0):
    """The least time the card could take: bytes over the memory rate, f32
    operations over the f32 rate, or the instructions' time on their
    busiest pipe (``issue_ms``, see :func:`sass_bound`), whichever is
    largest; and which ("bytes" or "operations")."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(flops / F32_FLOP_PER_S * 1e3, issue_ms)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sass_bound(profile, nbytes, flops=0, fewest=None):
    """The bound of a PRNG-mode kernel from the SASS of the library built
    in this run (``ops/sass.py``), beside its bytes and f32 operations:
    (per-thread instructions by pipe, bound ms, "bytes" or "operations",
    the pipe that sets it). ``fewest``: the fewest instructions a thread
    known for the same work, by pipe, whose issue the bound takes where
    this listing's is longer."""
    from pyphysim_tpu_torch.ops import sass
    counts = sass.pipe_counts(sass.kernel_sass(profile),
                              profile["loop_trips"], profile["loops"])
    issue_ms, pipe = sass.issue_bound_ms(counts, profile["threads"])
    if fewest is not None:
        issue_ms, pipe = min((issue_ms, pipe), sass.issue_bound_ms(
            fewest, profile["threads"]))
    ms, by = bound_ms(nbytes=nbytes, flops=flops, issue_ms=issue_ms)
    return counts, ms, by, pipe


def fast_fewest(mc, profile, rows):
    """``FAST_FEWEST_SASS``'s counts for ``mc``'s fast instance in the
    profile's instance at ``rows`` a block, where they were counted (the
    COST259-TU flagship channel), else None."""
    if (mc.taps, mc.TL, mc.used) != (16, 256, 300):
        return None
    return FAST_FEWEST_SASS.get((profile["pattern"], rows))


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

    # 2. build: the prebuilt library and every geometry's own, all nvcc
    # processes started together
    tic = time.time()
    lib_path = _build.build(geometry_builds())
    _build.load()
    phase("build", seconds=time.time() - tic, nvcc_seconds=_build.build_seconds,
          library=lib_path.name,
          geometry_libraries=len(_build.geometry_build_seconds))
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

    phases_8_to_12, chain_maps = chain_phases(dev, smi, fill_err)
    mimo_entry, mimo_fills, mimo_firs, mimo_maps = mimo_ofdm_phase(dev, smi)
    pusch_entry, pusch_fills, pusch_firs, pusch_maps = pusch_phase(dev, smi)
    qam_entry = qam_phase(dev, smi, chain_maps + mimo_maps + pusch_maps)
    phases_13_to_19 = mimo_bd_phases(dev, smi)
    phases_20_to_26 = ia_phases(dev, smi)
    wide_entries = geometry_phases(dev, smi)
    shape_entries = shape_phases(dev, smi)
    comp_bd_fill_err = comp_bd_phases(dev, smi)
    mimo = mimo_phases(dev, smi)
    fir_entry, fill_entry = phases_8_to_12
    fill_entry["max_abs_err"] = max(fill_entry["max_abs_err"],
                                    comp_bd_fill_err)
    fill_entry["launches"] += mimo.pop("fill_launches") + mimo_fills + \
        pusch_fills
    fir_entry["launches"] += mimo_firs + pusch_firs
    # block_fir: the MIMO route's launches, parity and geometry
    fir_entry["launches"] += mimo.pop("launches")
    fir_entry["max_abs_err"] = max(fir_entry["max_abs_err"],
                                   mimo.pop("max_abs_err"))
    fir_entry.update(mimo)

    parallel = parallel_phases(dev, smi)
    fill_entry["launches"] += app_phases(dev, smi)
    notebooks = notebook_phases(dev, smi)
    entries = [*mc_entries, *phases_8_to_12, mimo_entry, pusch_entry,
               qam_entry, *phases_13_to_19,
               phases_20_to_26, *wide_entries, *shape_entries]
    for entry in entries:
        more = parallel.get(entry["name"], {})
        # a kernel's launches on this slice's paths join its main path's
        entry["launches"] += more.get("parallel_launches", 0) + \
            more.get("time_sharded_launches", 0)
        entry.update(more)
        if entry["name"] in notebooks:
            entry["notebook_launches"] = notebooks[entry["name"]]
            entry["launches"] += notebooks[entry["name"]]
    missing = [name for name in [*parallel, *notebooks]
               if name not in {e["name"] for e in entries}]
    if missing:
        raise AssertionError(f"kernels line: no entry named {missing}")

    print(smi)
    print(json.dumps({"kernels": entries}))
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
    bits, channel uniforms, noise normals), held by
    :func:`fill_draws_parity`. Returns the largest |kernel - plain|."""
    import torch
    from pyphysim_tpu_torch.ops.streams import AttemptStreams
    a = torch.arange(2 ** 32 - batch // 2, 2 ** 32 + batch - batch // 2,
                     dtype=torch.int64, device=dev)
    # the eager route: a replayed step draws inside its graph, where no
    # draw is recorded
    draws = recorded_draws(lambda: chain.step_eager(AttemptStreams(99, a),
                                                    10.0))
    kinds = sorted(k for k, *_ in draws)
    if kinds != ["bits", "normal", "uniform"]:
        raise AssertionError(f"fill_main_path {name}: a step drew {kinds}, "
                             f"expected symbol bits, channel uniforms and "
                             f"noise normals")
    return fill_draws_parity(name, draws)


def replay_phase(dev, smi):
    """Phase 12b: the block-static time-domain step at the benchmark's
    sub-chunk (32 x 9,600 symbols) and at bench.py's 256 x 9,600, replayed
    (``ChainStep.step``: one CUDA graph) against eager (``step_eager``) in
    this process and in turns (eager, replay, replay, eager): the host's
    time to issue a step (the device idle at its start), a step's time
    back to back (CUDA events over ``REPLAY_INNER`` steps, each on fresh
    attempts), and the counts of both routes on the same streams, equal
    bit for bit at two SNRs, in both signal types."""
    import torch
    from pyphysim_tpu_torch.chain import ChainStep
    from pyphysim_tpu_torch.ops.streams import AttemptStreams
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "bin"))
    from profile_chain_torch import host_ms

    out = {}
    for batch in REPLAY_BATCHES:
        for dtype in SIGNAL_DTYPES:
            tag = f"{batch}x{TD_SYMBOLS}_{dtype or 'complex64'}"
            chain = ChainStep(TD_SYMBOLS, 512, 52, 300, block_static=True,
                              signal_dtype=dtype, device=dev)
            streams = [AttemptStreams.from_range(2 ** 31 + 5 + k, k * batch,
                                                 batch, dev)
                       for k in range(REPLAY_INNER)]
            chain.step(streams[0], 10.0)          # eager, then the capture
            differ = 0
            for snr in (10 ** 0.5, 10 ** 2.5):
                for s in streams[:4]:
                    differ += int((chain.step(s, snr) !=
                                   chain.step_eager(s, snr)).sum())
            routes = {"eager": chain.step_eager, "replay": chain.step}
            host = {k: [] for k in routes}
            back = {k: [] for k in routes}
            for name in ("eager", "replay", "replay", "eager"):
                fn = routes[name]
                host[name].append(host_ms(lambda: fn(streams[0], 10.0)))
                back[name].append(best_ms(
                    lambda: [fn(s, 10.0) for s in streams]) / REPLAY_INNER)
            row = {"differing_counts": differ,
                   "eager_host_ms": min(host["eager"]),
                   "replay_host_ms": min(host["replay"]),
                   "eager_step_ms": min(back["eager"]),
                   "replay_step_ms": min(back["replay"]),
                   "graphs": len(chain._graphs)}
            row["speedup"] = row["eager_step_ms"] / row["replay_step_ms"]
            row["replay_sym_per_s"] = batch * TD_SYMBOLS / \
                row["replay_step_ms"] * 1e3
            phase("replay", shape=tag, card=repr(smi), **row)
            if differ or row["graphs"] != int(torch.device(dev).type ==
                                              "cuda"):
                raise AssertionError(f"replay {tag}: {differ} counts differ "
                                     f"from the eager step's, "
                                     f"{row['graphs']} graphs")
            out[tag] = row
    return out


def mimo_ofdm_phase(dev, smi):
    """Phase 12c: the 4x4 MIMO-OFDM step at the benchmark's configuration
    (LTE 20 MHz, EVA70, 16-QAM, 14 x 1,200 REs a layer) and sub-chunk of
    32 attempts. The detector kernel (``mimo_mmse``) held to its plain
    version on the step's own H, y and sent indices at five SNRs and two
    seeds: the same counts bit for bit (the two round the same float32
    operations in the same order), and the step's counts equal them. A
    replayed step launches the fill 3 times, ``block_fir``, the symbol map
    (``qam_map``) and the detector once each, and counts what its eager
    step counts; the map's plain version never runs. The kernel's
    time (a CUDA graph of wrapper calls) beside its byte bound (H, y and
    the indices read once: 192 B an RE), its plain version's and
    Blast's library route's (batched ``torch.linalg.solve``). Returns the
    detector's ``kernels`` entry, the fill's and block_fir's launches and
    the map's in the replayed and eager steps."""
    import torch
    from apps.mimo.mimo_ofdm_tdl_torch import eva_channel
    from pyphysim_tpu_torch.mimo_chain import MimoChainStep
    from pyphysim_tpu_torch.modulators import QAM
    from pyphysim_tpu_torch.ops import fir
    from pyphysim_tpu_torch.ops.mimo_detect import (mimo_mmse,
                                                    mimo_mmse_reference)
    from pyphysim_tpu_torch.ops.qam import qam_map
    from pyphysim_tpu_torch.ops.streams import AttemptStreams, philox_draw
    from pyphysim_tpu_torch.utils.misc import count_bits

    nt = nr = 4
    fft, cp, used, batch = 2048, 144, 1200, 32
    res = used * 14
    step = MimoChainStep(nt, nr, 16, res, fft, cp, used,
                         eva_channel(nr, nt, device=dev), device=dev)
    counters = (philox_draw, fir.block_fir, mimo_mmse, qam_map)
    for c in counters:
        c.launch_count = 0
    qam_map.reference_count = 0
    gap = step_gap = errors = 0
    for seed in (2 ** 31 + 21, 5):
        streams = AttemptStreams.from_range(seed, 3 * batch, batch, dev)
        draws = step.draw(*streams.split(3))
        for snr_db in (0.0, 10.0, 20.0, 30.0, 40.0):
            snr = 10 ** (snr_db / 10)
            out = step.forward(*draws, snr)
            amp = torch.full((), step.noise_amplitude(snr),
                             dtype=torch.float32, device=dev)
            s2 = amp * amp * ((used + cp) / fft)
            got = mimo_mmse(out.response, out.received, draws[0], s2)
            want = mimo_mmse_reference(out.response, out.received,
                                       draws[0], s2)
            gap += int((got - want).abs().sum())
            step_gap += int((out.bit_errors - got).abs().sum())
            errors += int(want.sum())
    fills, firs, detects, _ = (c.launch_count for c in counters)
    maps = 0
    phase("mimo_detect_parity", shape=f"{batch}x{nr}x{nt}x{res}", calls=10,
          bits=10 * batch * res * nt * 4, bit_errors=errors,
          kernel_vs_plain_gap=gap, step_vs_kernel_gap=step_gap)
    if gap or step_gap:
        raise AssertionError(f"mimo_detect: the kernel's counts differ from "
                             f"its plain version's by {gap} bits, the "
                             f"step's from the kernel's by {step_gap}")

    # one replay: its launches, and its counts against the eager step's
    streams = AttemptStreams.from_range(2 ** 31 + 22, 0, batch, dev)
    step.step(streams, 10.0)                     # eager, then the capture
    launches = {}
    for route in ("replay", "eager"):
        fn = step.step if route == "replay" else step.step_eager
        for c in counters:
            c.launch_count = 0
        counts = fn(streams, 10.0)
        launches[route] = tuple(c.launch_count for c in counters)
        fills += launches[route][0]
        firs += launches[route][1]
        detects += launches[route][2]
        maps += launches[route][3]
        if route == "replay":
            replayed = counts.clone()
    same = bool(torch.equal(replayed, counts))
    phase("mimo_replay", launches_per_replay=compact(launches["replay"]),
          launches_eager=compact(launches["eager"]), replay_eq_eager=same,
          map_plain_calls=qam_map.reference_count, graphs=len(step._graphs))
    if launches["replay"] != (3, 1, 1, 1) or \
            launches["eager"] != (3, 1, 1, 1) or not same or \
            qam_map.reference_count:
        raise AssertionError(f"mimo_replay: launches {launches} (fill, "
                             f"block_fir, mimo_mmse, qam_map), "
                             f"{qam_map.reference_count} plain maps, replay "
                             f"equal to the eager step: {same}")

    # times (CUDA events, best of 3 after a warm-up)
    draws = step.draw(*streams.split(3))
    out = step.forward(*draws, 100.0)
    h, y, sent = out.response, out.received, draws[0]
    s2 = torch.full((), (used + cp) / (fft * 100.0), dtype=torch.float32,
                    device=dev)
    kernel_ms = graph_ms(lambda: mimo_mmse(h, y, sent, s2))
    wrapper_ms = best_ms(lambda: mimo_mmse(h, y, sent, s2), inner=10)
    plain_ms = best_ms(lambda: mimo_mmse_reference(h, y, sent, s2))
    qam = QAM(16, device=dev)
    eye = torch.eye(nt, dtype=torch.complex64, device=dev)

    def library():
        hm = h.permute(0, 3, 1, 2)                   # (n, S, Nr, Nt)
        hh = hm.mH
        est = torch.linalg.solve(hh @ hm + s2 * eye,
                                 hh @ y.permute(0, 2, 1)[..., None]
                                 )[..., 0] * math.sqrt(nt)
        bits = qam.demodulate_hard(est) ^ sent.permute(0, 2, 1)
        return count_bits(bits).sum(dim=(1, 2))
    library_gap = int((library() - mimo_mmse(h, y, sent, s2)).abs().sum())
    library_ms = best_ms(library)
    nbytes = batch * (res * (8 * nr * nt + 8 * nr + 8 * nt) + 8)
    bound, bound_by = bound_ms(nbytes=nbytes, flops=batch * res * 594)
    phase("mimo_times", card=repr(smi), shape=f"{batch}x{nr}x{nt}x{res}",
          mimo_mmse_ms=kernel_ms, bound_ms=bound, bound_by=bound_by,
          share_of_bound=bound / kernel_ms, wrapper_ms=wrapper_ms,
          plain_ms=plain_ms, library_ms=library_ms,
          library_vs_kernel_gap=library_gap)
    return {
        "name": "mimo_mmse",
        "route": "cuda",
        "source": "pyphysim_tpu_torch/ops/csrc/mimo_mmse.cu",
        "replaces": None,
        "launches": detects,
        "max_abs_err": gap,
        "ms": kernel_ms,
        "timed_by": "graph_replay",
        "wrapper_ms": wrapper_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound,
        "bound_by": bound_by,
        "library_ms": library_ms,
    }, fills, firs, maps


def pusch_phase(dev, smi, seeds=(2 ** 31 + 25, 6)):
    """Phase 12d: the 4-layer PUSCH step at the benchmark's configuration
    (LTE-A uplink, 20 MHz, ETU70, 16-QAM, 12 x 1,200 data REs a layer)
    and sub-chunk of 32 subframes. The SC-FDMA equalizer kernel
    (``sc_mmse_eq``) held to its plain version on the step's own DMRS
    estimate and received symbols at five SNRs and each of ``seeds``: x
    and the gains equal bit for bit (the two round the same float32
    operations in the same order), and the step's own x equal to them. A
    replayed step launches the fill 3 times, ``block_fir``, the equalizer,
    the decision and the symbol map (``qam_map``) once each, and counts
    what its eager step counts; the map's plain version never runs. The
    equalizer's time (a CUDA graph of wrapper calls) beside
    its bound (H and the data symbols' y read once, x and the gain sums
    written once; the fewest
    float32 operations: the Gram and its LDL^H factors a subcarrier, W's
    columns by the solves, the gains, W y an RE), its registers and
    spills, its plain version's time; the decision kernel (``sc_decide``:
    the unbiasing, the slicer and the count after the IDFT) against its
    plain version bit for bit and its time beside its byte bound; and the
    time of what follows the equalizer in the step (the IDFT, the mean
    gains and ``sc_decide``). Returns the equalizer's ``kernels`` entry,
    the fill's and block_fir's launches and the map's in the replayed and
    eager steps."""
    import torch
    from apps.mimo.pusch_etu70_torch import pusch_step
    from pyphysim_tpu_torch.ops import fir
    from pyphysim_tpu_torch.ops.mimo_detect import (sc_decide,
                                                    sc_decide_reference,
                                                    sc_mmse_eq,
                                                    sc_mmse_eq_reference)
    from pyphysim_tpu_torch.ops.qam import qam_map
    from pyphysim_tpu_torch.ops.streams import AttemptStreams, philox_draw

    nt = nr = 4
    fft, cp, used, batch = 2048, 144, 1200, 32
    step = pusch_step(dev)
    ns, data = step.symbols_per_subframe, step.data_symbols
    nd = len(data)
    counters = (philox_draw, fir.block_fir, sc_mmse_eq, sc_decide, qam_map)
    for c in counters:
        c.launch_count = 0
    qam_map.reference_count = 0
    gap = step_gap = count_gap = errors = 0
    for seed in seeds:
        streams = AttemptStreams.from_range(seed, 3 * batch, batch, dev)
        draws = step.draw(*streams.split(3))
        for snr_db in (0.0, 10.0, 20.0, 30.0, 40.0):
            snr = 10 ** (snr_db / 10)
            out = step.forward(*draws, snr)
            amp = torch.full((), step.noise_amplitude(snr),
                             dtype=torch.float32, device=dev)
            s2 = amp * amp * ((used + cp) / fft)
            y = out.received.reshape(batch, nr, ns, used)
            x, g = sc_mmse_eq(out.estimate, y, s2, data)
            xr, gr = sc_mmse_eq_reference(out.estimate, y, s2, data)
            gap += int((x != xr).sum()) + int((g != gr).sum())
            step_gap += int((out.equalized != x).sum())
            mu = g.mean(dim=-1)
            count_gap += int((sc_decide(out.symbols, mu, draws[0]) -
                              sc_decide_reference(out.symbols, mu, draws[0])
                              ).abs().sum())
            errors += int(out.bit_errors.sum())
    fills, firs, eqs, decides, _ = (c.launch_count for c in counters)
    maps = 0
    phase("pusch_equalize_parity", shape=f"{batch}x{nr}x{nt}x{nd}x{used}",
          calls=5 * len(seeds), bit_errors=errors,
          bits=5 * len(seeds) * batch * step.bits_per_attempt,
          kernel_vs_plain_differing=gap, step_vs_kernel_differing=step_gap,
          decide_vs_plain_gap=count_gap)
    if gap or step_gap or count_gap:
        raise AssertionError(f"sc_mmse_eq: {gap} values differ from its "
                             f"plain version's, {step_gap} of the step's "
                             f"from the kernel's; sc_decide's counts from "
                             f"its plain version's by {count_gap}")

    # one replay: its launches, and its counts against the eager step's
    streams = AttemptStreams.from_range(2 ** 31 + 26, 0, batch, dev)
    step.step(streams, 10.0)                     # eager, then the capture
    launches = {}
    for route in ("replay", "eager"):
        fn = step.step if route == "replay" else step.step_eager
        for c in counters:
            c.launch_count = 0
        counts = fn(streams, 10.0)
        launches[route] = tuple(c.launch_count for c in counters)
        fills += launches[route][0]
        firs += launches[route][1]
        eqs += launches[route][2]
        decides += launches[route][3]
        maps += launches[route][4]
        if route == "replay":
            replayed = counts.clone()
    same = bool(torch.equal(replayed, counts))
    phase("pusch_replay", launches_per_replay=compact(launches["replay"]),
          launches_eager=compact(launches["eager"]), replay_eq_eager=same,
          map_plain_calls=qam_map.reference_count, graphs=len(step._graphs))
    if launches["replay"] != (3, 1, 1, 1, 1) or \
            launches["eager"] != (3, 1, 1, 1, 1) or not same or \
            qam_map.reference_count:
        raise AssertionError(f"pusch_replay: launches {launches} (fill, "
                             f"block_fir, sc_mmse_eq, sc_decide, qam_map), "
                             f"{qam_map.reference_count} plain maps, replay "
                             f"equal to the eager step: {same}")

    # times (CUDA events, best of 3 after a warm-up)
    draws = step.draw(*streams.split(3))
    out = step.forward(*draws, 100.0)
    h, y = out.estimate, out.received.reshape(batch, nr, ns, used)
    s2 = torch.full((), (used + cp) / (fft * 100.0), dtype=torch.float32,
                    device=dev)
    kernel_ms = graph_ms(lambda: sc_mmse_eq(h, y, s2, data))
    wrapper_ms = best_ms(lambda: sc_mmse_eq(h, y, s2, data), inner=10)
    plain_ms = best_ms(lambda: sc_mmse_eq_reference(h, y, s2, data))
    x, g = sc_mmse_eq(h, y, s2, data)
    sent, symbols, mu = draws[0], torch.fft.ifft(x, norm="ortho"), \
        g.mean(dim=-1)
    decide_ms = graph_ms(lambda: sc_decide(symbols, mu, sent))
    decide_plain_ms = best_ms(lambda: sc_decide_reference(symbols, mu, sent))
    after_ms = graph_ms(lambda: sc_decide(torch.fft.ifft(x, norm="ortho"),
                                          g.mean(dim=-1), sent))
    step_ms = best_ms(lambda: step.step(streams, 100.0), inner=10)
    res = nd * used
    nbytes = batch * (used * 8 * nr * nt + res * 8 * (nr + nt) + 4 * nt)
    flops_sc = nr * (4 * nt + 4 * nt * (nt - 1)) + nt + \
        sum(5 * j + 1 + (nt - 1 - j) * (10 * j + 2) for j in range(nt)) + \
        nr * (8 * nt * (nt - 1) + 2 * nt) + 4 * nr * nt
    flops = batch * (used * flops_sc + res * 8 * nr * nt)
    bound, bound_by = bound_ms(nbytes=nbytes, flops=flops)
    ptxas = kernel_ptxas("sc_mmse_eq_kernel")
    ptxas.update(kernel_ptxas("sc_decide_kernel"))
    phase("pusch_times", card=repr(smi),
          shape=f"{batch}x{nr}x{nt}x{nd}x{used}", sc_mmse_eq_ms=kernel_ms,
          bound_ms=bound, bound_by=bound_by,
          share_of_bound=bound / kernel_ms,
          wrapper_ms=wrapper_ms, plain_ms=plain_ms, sc_decide_ms=decide_ms,
          sc_decide_bound_ms=bound_ms(nbytes=batch * nt * res * 16)[0],
          sc_decide_plain_ms=decide_plain_ms,
          despread_decide_count_ms=after_ms, replayed_step_ms=step_ms,
          ptxas=compact(ptxas))
    return {
        "name": "sc_mmse_eq",
        "route": "cuda",
        "source": "pyphysim_tpu_torch/ops/csrc/sc_mmse_eq.cu",
        "replaces": None,
        "launches": eqs,
        "max_abs_err": gap,
        "ms": kernel_ms,
        "timed_by": "graph_replay",
        "wrapper_ms": wrapper_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound,
        "bound_by": bound_by,
    }, fills, firs, maps


def qam_steps(dev):
    """The per-key cells' steps at their sub-chunk's configuration, with
    the gain each passes ``qam_map`` (``tu.perkey`` in both signal
    types)."""
    from apps.mimo.mimo_ofdm_tdl_torch import eva_channel
    from apps.mimo.pusch_etu70_torch import pusch_step
    from pyphysim_tpu_torch.chain import ChainStep
    from pyphysim_tpu_torch.mimo_chain import MimoChainStep
    mimo = MimoChainStep(4, 4, 16, 1200 * 14, 2048, 144, 1200,
                         eva_channel(4, 4, device=dev), device=dev)
    return {
        "tu.perkey": (ChainStep(TD_SYMBOLS, 512, 52, 300, block_static=True,
                                device=dev), None),
        "tu.perkey.bf16": (ChainStep(TD_SYMBOLS, 512, 52, 300,
                                     block_static=True,
                                     signal_dtype="bfloat16", device=dev),
                           None),
        "eva4x4.perkey": (mimo, mimo._split),
        "etu4x4.pusch": (pusch_step(dev), None)}


def qam_phase(dev, smi, main_launches, batch=32, calls=10):
    """Phase 12e: the per-key steps' symbol map (``qam_map``,
    ``ops/csrc/qam.cu``) and the SISO step's decision with its bit count
    (``sc_decide`` with a unit gain) at the three per-key cells' sub-chunk
    of ``batch`` attempts. Over ``calls`` calls of each step's own draws
    (fresh attempts, SNRs from 0 to 40 dB): the map's points equal its
    plain version's bit for bit, and on ``ChainStep`` the decision's counts
    on the step's equalized values equal its plain version's and the
    step's own. Each step replayed against its eager step in turns (eager,
    replay, replay, eager): counts equal, the map launched once a replay
    and the decision once a replay of a step that decides with it, as
    eagerly. Times by graph replay on copies of the inputs that outgrow
    the L2 (:func:`rotated_graph_ms`): the map at each shape and the
    decision at ``tu.perkey``'s, beside their byte bounds (16 B an element:
    an int64 index in and a complex64 point out; a complex64 point and an
    int64 index in), their wrappers' and plain versions'; the map's
    registers and spills. Returns the map's ``kernels`` entry, whose
    launches are ``main_launches``: those of the main path's runs (the
    runner's sweeps of the time-domain and fused chains, the MIMO and
    PUSCH steps' replays), each checked there against its step calls."""
    import torch
    from pyphysim_tpu_torch.chain import ChainStep
    from pyphysim_tpu_torch.ops.mimo_detect import (sc_decide,
                                                    sc_decide_reference)
    from pyphysim_tpu_torch.ops.qam import qam_map, qam_map_reference
    from pyphysim_tpu_torch.ops.streams import AttemptStreams

    def bits(t):
        return torch.view_as_real(t).contiguous().view(torch.int32)

    def decide(eq, data, unit, fn=sc_decide):
        return fn(eq[:, None], unit, data[:, None], 16)

    counters = (qam_map, sc_decide)
    times = {}
    differ = gap = 0
    for name, (step, gain) in qam_steps(dev).items():
        siso = isinstance(step, ChainStep)
        step_differ = step_gap = errors = 0
        unit = torch.ones(batch, 1, device=dev)
        for k in range(calls):
            s = AttemptStreams.from_range(2 ** 31 + 41 + k, 2 ** 32 - 7 +
                                          k * batch, batch, dev)
            draws = step.draw(*s.split(3))
            data = draws[0]
            step_differ += int((bits(qam_map(data, 16, gain)) != bits(
                qam_map_reference(data, 16, gain))).sum())
            if siso:
                out = step.forward(*draws, 10 ** (4 * k / (calls - 1)))
                got = decide(out.equalized, data, unit)
                want = decide(out.equalized, data, unit, sc_decide_reference)
                step_gap += int((got - want).abs().sum()) + \
                    int((out.bit_errors - want).abs().sum())
                errors += int(want.sum())
        # replay against eager in turns
        s0 = AttemptStreams.from_range(2 ** 31 + 61, 0, batch, dev)
        step.step(s0, 10.0)                      # eager, then the capture
        same, launches = True, {}
        for k, route in enumerate(("eager", "replay", "replay", "eager")):
            fn = step.step if route == "replay" else step.step_eager
            s = AttemptStreams.from_range(2 ** 31 + 62 + k // 2, 0, batch,
                                          dev)
            before = [c.launch_count for c in counters]
            got = fn(s, 10 ** (k / 2))
            launches[route] = tuple(c.launch_count - b
                                    for c, b in zip(counters, before))
            other = step.step_eager if route == "replay" else step.step
            same = same and bool(torch.equal(got, other(s, 10 ** (k / 2))))
        want_launches = (1, int(sc_decide in step.counted_kernels))
        phase("qam_parity", step=name, shape=compact(list(data.shape)),
              calls=calls, map_differing=step_differ,
              decide_vs_plain_gap=step_gap, bit_errors=errors,
              launches_per_replay=compact(launches["replay"]),
              launches_eager=compact(launches["eager"]), replay_eq_eager=same)
        if step_differ or step_gap or not same or \
                launches["replay"] != want_launches or \
                launches["eager"] != want_launches:
            raise AssertionError(f"qam {name}: {step_differ} points, "
                                 f"{step_gap} counts differ from the plain "
                                 f"versions; replay equal to eager: {same}; "
                                 f"launches {launches} (qam_map, sc_decide),"
                                 f" want {want_launches}")
        differ += step_differ
        gap += step_gap
        # times at the step's own shape
        n = data.numel()
        entry = {"qam_map_ms": rotated_graph_ms(
                     lambda d: qam_map(d, 16, gain), (data,), 16 * n),
                 "qam_map_bound_ms": bound_ms(nbytes=16 * n)[0],
                 "qam_map_wrapper_ms": best_ms(
                     lambda: qam_map(data, 16, gain), inner=10),
                 "qam_map_plain_ms": best_ms(
                     lambda: qam_map_reference(data, 16, gain))}
        if siso:
            eq = out.equalized
            entry.update({
                "decide_ms": rotated_graph_ms(
                    lambda e, d: decide(e, d, unit), (eq, data), 16 * n),
                "decide_bound_ms": bound_ms(
                    nbytes=16 * n + 12 * batch)[0],
                "decide_wrapper_ms": best_ms(
                    lambda: decide(eq, data, unit), inner=10),
                "decide_plain_ms": best_ms(
                    lambda: decide(eq, data, unit, sc_decide_reference))})
        for kernel in ("qam_map", "decide"):
            if f"{kernel}_ms" in entry:
                entry[f"{kernel}_share_of_bound"] = \
                    entry[f"{kernel}_bound_ms"] / entry[f"{kernel}_ms"]
        times[name] = entry
        phase("qam_times", card=repr(smi), step=name,
              shape=compact(list(data.shape)), **entry)
    phase("qam_build", ptxas=compact(kernel_ptxas("qam_map_kernel")))
    cell = times["tu.perkey"]
    return {
        "name": "qam_map",
        "route": "cuda",
        "source": "pyphysim_tpu_torch/ops/csrc/qam.cu",
        "replaces": None,
        "launches": main_launches,
        "max_abs_err": differ,
        "ms": cell["qam_map_ms"],
        "timed_by": "graph_replay",
        "wrapper_ms": cell["qam_map_wrapper_ms"],
        "plain_ms": cell["qam_map_plain_ms"],
        "bound_ms": cell["qam_map_bound_ms"],
        "bound_by": "bytes",
    }


def fill_draws_parity(name, draws):
    """The fill against its plain version at each draw of ``draws`` (from
    :func:`recorded_draws`), with the draw's own keys, attempts, width and
    mask: bits (masked as drawn) and uniforms bit for bit, normals within
    ``FILL_ULP_LIMIT`` ulps. The widest draws span several grids of the
    fill's launch, so its grid-stride loop runs. Returns the largest
    |kernel - plain|."""
    import torch
    from pyphysim_tpu_torch.ops.streams import (philox_draw,
                                                philox_draw_reference)
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
        phase("fill_main_path", step=name, kind=kind, mask=hex(mask),
              shape=f"{s.n}x{m}", counters=counters,
              grids=counters / FILL_GRID_COUNTERS,
              differ_from_plain=differ, max_ulps=ulps,
              ulp_limit=FILL_ULP_LIMIT)
        if (kind != "normal" and differ) or ulps > FILL_ULP_LIMIT:
            raise AssertionError(f"fill_main_path {name} {kind} {s.n}x{m}: "
                                 f"the fill differs from its plain version")
        err = max(err, float((got.double() - plain.double()).abs().max()))
    return err


def parallel_phases(dev, smi):
    """Phases 38-42: the port's data-parallel layer on the card, on the
    world-size-1 NCCL group that ``make_mesh`` starts itself. The mesh and
    its collectives; the flagship bulk runner through
    ``simulate_in_parallel`` at full width in both channel-product types
    (equal to ``simulate()`` bit for bit, the BERs in ``BER_CORNERS``;
    then ``block=False`` and the wait); the Alamouti, BD and IA bulk
    runners the same way at two chunks each (BD held per rep); every
    Monte Carlo kernel's sharded PRNG build against its unsharded launch,
    on the 1-rank mesh and as the per-rank launches of 2- and 4-rank
    splits; the time-sharded channel through ``block_fir`` against the
    unsharded ``corrupt_data``, on the 1-rank mesh and as 4 shards with
    their halos added in this process. Returns, per kernel name, what the
    ``kernels`` line gains."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from apps.comp_BD.batched_bd_capacity_torch import BDKernelCapacityRunner
    from apps.ia.ia_mc_kernel_torch import IaMcKernelSimulationRunner
    from apps.mimo.alamouti_mc_kernel_torch import \
        AlamoutiMcKernelSimulationRunner
    from apps.ofdm.ofdm_mc_kernel_torch import OfdmMcKernelSimulationRunner
    from pyphysim_tpu_torch.ops.mc_kernel import MonteCarloOfdmTdl
    from pyphysim_tpu_torch.parallel import (gather_rows, make_host_chip_mesh,
                                             make_mesh)
    start_time = time.perf_counter()

    # 38. the mesh: make_mesh with no group starts a world-size-1 NCCL one
    if dist.is_initialized():
        raise AssertionError("mesh: a process group is already up")
    mesh = make_mesh()
    probe = torch.arange(6, dtype=torch.int32, device=dev).reshape(3, 2)
    gathered = gather_rows(mesh, "mc", probe)
    torch.cuda.synchronize()
    phase("mesh", backend=dist.get_backend(), world=dist.get_world_size(),
          mesh=repr(mesh), all_gather=gathered.tolist(),
          nccl_socket_ifname=os.environ.get("NCCL_SOCKET_IFNAME"))
    backend = {"cuda": "nccl", "cpu": "gloo"}[dev.type]
    if dist.get_backend() != backend or dist.get_world_size() != 1 or \
            not torch.equal(gathered, probe):
        raise AssertionError(f"mesh: not a 1-rank {backend} group, or its "
                             "all-gather changed the rows")
    try:
        make_host_chip_mesh(num_hosts=2)
    except ValueError as exc:
        phase("mesh_split", num_hosts=2, raised=repr(str(exc)))
    else:
        raise AssertionError("make_host_chip_mesh(num_hosts=2) split 1 rank")

    # 39. the slice's main path: the flagship runner at full width
    def flagship(dtype, rep_max, batch):
        r = OfdmMcKernelSimulationRunner(device=dev,
                                         read_command_line_args=False,
                                         matmul_dtype=dtype)
        r.tile, r.num_tiles = TILE, NUM_TILES
        r.mc = MonteCarloOfdmTdl(r.ofdm, r.channel, M=16, tile=TILE,
                                 matmul_dtype=dtype, device=dev)
        return sweep_runner(r, "SNR", list(BER_CORNERS), rep_max, batch)

    def errors(runner):
        return [int(v) for v in
                runner.results.get_result_values_list("bit_errors")]

    snrs, reps, chunk = list(BER_CORNERS), PAR_REPS, PAR_CHUNK
    extra = {}
    for dtype in MC_DTYPES:
        serial = flagship(dtype, reps, chunk)
        tic = time.perf_counter()
        serial.simulate()
        serial_s = time.perf_counter() - tic
        runner = flagship(dtype, reps, chunk)
        runner.mc.launch_count = 0
        runner.mc.reference_count = 0
        tic = time.perf_counter()
        runner.simulate_in_parallel(mesh)
        parallel_s = time.perf_counter() - tic
        launches = runner.mc.launch_count
        bers = [float(v) for v in runner.results.get_result_values_list(
            "ber")]
        equal = errors(runner) == errors(serial) and \
            runner.runned_reps == serial.runned_reps
        # the gather's share of a chunk: one sharded chunk and its gather
        seed = 1234567
        run = runner.mc.build(chunk, NUM_TILES, mesh=mesh)
        counts = run(seed, 10 ** 1.5, 0)
        chunk_ms = best_ms(lambda: run(seed, 10 ** 1.5, 0), inner=10)
        gather_ms = best_ms(lambda: gather_rows(mesh, "mc", counts),
                            inner=10)
        phase(f"parallel_main_path {dtype}", card=repr(smi), snr_db=snrs,
              ber=bers, bit_errors=errors(runner),
              serial_bit_errors=errors(serial), equal_to_simulate=equal,
              runned_reps=runner.runned_reps, kernel_launches=launches,
              chunks=runner.chunks_dispatched,
              plain_calls=runner.mc.reference_count,
              parallel_seconds=parallel_s, serial_seconds=serial_s,
              sharded_chunk_ms=chunk_ms, nccl_gather_ms=gather_ms,
              gather_share_of_chunk=gather_ms / chunk_ms,
              mesh_after=repr(runner.mesh))
        if not equal:
            raise AssertionError(f"parallel_main_path {dtype}: "
                                 "simulate_in_parallel != simulate()")
        check_bers(f"parallel_main_path {dtype}", snrs, bers)
        check_launches(f"parallel_main_path {dtype}", launches,
                       runner.chunks_dispatched, runner.mc.reference_count)
        if runner.mesh is not None:
            raise AssertionError("parallel_main_path: mesh not reset")
        name = "mc_ofdm_tdl_prng" + ("_bf16" if dtype == "bfloat16" else "")
        extra[name] = {"parallel_launches": launches}

        later = flagship(dtype, reps, chunk)
        later.simulate_in_parallel(mesh, block=False)
        later.wait_parallel_simulation()
        same = errors(later) == errors(serial)
        phase(f"parallel_async {dtype}", equal_to_simulate=same,
              mesh_after=repr(later.mesh))
        if not same or later.mesh is not None:
            raise AssertionError(f"parallel_async {dtype}: block=False "
                                 "differs from simulate() or kept its mesh")

    # 40. the other bulk families through simulate_in_parallel, two chunks
    def recorded(runner, name):
        """Record each chunk's per-rep values of result ``name``."""
        rows = []
        make = runner._gen_bulk_kernel

        def gen(params):
            bulk = make(params)

            def run(start, n):
                out = bulk(start, n)
                values = out[name][0] if isinstance(out[name], tuple) \
                    else out[name]
                rows.append((start, torch.as_tensor(values).cpu().numpy()))
                return out

            return run

        runner._gen_bulk_kernel = gen
        return rows

    families = {
        "mc_alamouti_prng": (lambda: sweep_runner(
            AlamoutiMcKernelSimulationRunner(
                tile=ALA_TILE, lane=ALA_LANE, num_tiles=ALA_TILES,
                device=dev, read_command_line_args=False),
            "SNR", [10.0], 2 * ALA_CHUNK, ALA_CHUNK), "bit_errors"),
        "mc_bd_prng": (lambda: sweep_runner(
            BDKernelCapacityRunner(
                K=3, nr_u=2, tile=BD_TILE, lane=BD_LANE, num_tiles=BD_TILES,
                device=dev, read_command_line_args=False),
            "Pu_dB", [float(10 * np.log10(10.0 / 3))], 2 * BD_CHUNK,
            BD_CHUNK), "sum_capacity"),
        "mc_maxsinr_prng": (lambda: sweep_runner(
            IaMcKernelSimulationRunner(
                K=3, tile=IA_TILE, lane=IA_LANE, num_tiles=IA_TILES,
                iterations=IA_ITERS, device=dev,
                read_command_line_args=False),
            "SNR", [10.0], 2 * IA_CHUNK, IA_CHUNK), "sum_capacity"),
    }
    for name, (make, result) in families.items():
        serial, runner = make(), make()
        serial_rows = recorded(serial, result)
        rows = recorded(runner, result)
        serial.simulate()
        runner.mc.launch_count = 0
        runner.mc.reference_count = 0
        runner.simulate_in_parallel(mesh)
        launches = runner.mc.launch_count
        per_rep = len(rows) == len(serial_rows) and all(
            a[0] == b[0] and np.array_equal(a[1], b[1])
            for a, b in zip(rows, serial_rows))
        values = [float(v) for v in
                  runner.results.get_result_values_list(result)]
        want = [float(v) for v in
                serial.results.get_result_values_list(result)]
        phase("parallel_families", kernel=name, result=result,
              values=values, serial_values=want, per_rep_equal=per_rep,
              reps=sum(len(r[1]) for r in rows), kernel_launches=launches,
              chunks=runner.chunks_dispatched,
              plain_calls=runner.mc.reference_count)
        if not per_rep or values != want:
            raise AssertionError(f"parallel_families {name}: "
                                 "simulate_in_parallel != simulate()")
        check_launches(f"parallel_families {name}", launches,
                       runner.chunks_dispatched, runner.mc.reference_count)
        extra[name] = {"parallel_launches": launches}

    # 41. sharded PRNG builds: the 1-rank mesh, and the per-rank launches
    # of 2- and 4-rank splits in this process, against the unsharded one
    from pyphysim_tpu_torch.ops.alamouti_kernel import MonteCarloAlamouti
    from pyphysim_tpu_torch.ops.bd_kernel import MonteCarloBD
    from pyphysim_tpu_torch.ops.ia_kernel import MonteCarloMaxSinr
    flag = flagship("float32", 1, 1).mc
    flag16 = flagship("bfloat16", 1, 1).mc
    builds = {
        "mc_ofdm_tdl_prng": (flag, chunk, NUM_TILES, (77, 10 ** 1.5), 2),
        "mc_ofdm_tdl_prng_bf16": (flag16, chunk, NUM_TILES,
                                  (77, 10 ** 1.5), 2),
        "mc_alamouti_prng": (MonteCarloAlamouti(tile=ALA_TILE, lane=ALA_LANE,
                                                device=dev),
                             ALA_CHUNK, ALA_TILES, (77, 10.0), 2),
        "mc_bd_prng": (MonteCarloBD(tile=BD_TILE, lane=BD_LANE, K=3,
                                    Nr_u=2, device=dev),
                       BD_CHUNK, BD_TILES, (77,), 1),
        "mc_maxsinr_prng": (MonteCarloMaxSinr(tile=IA_TILE, lane=IA_LANE,
                                              iterations=IA_ITERS, K=3,
                                              device=dev),
                            IA_CHUNK, IA_TILES, (77, IA_NV), 2),
        # the main points built on first use (phases 55-60)
        "mc_bd_wide_prng_K{}_Nr{}".format(*BD_WIDE_MAIN): (
            MonteCarloBD(tile=BD_TILE, lane=BD_LANE, K=BD_WIDE_MAIN[0],
                         Nr_u=BD_WIDE_MAIN[1], device=dev),
            BD_CHUNK, BD_TILES, (77,), 1),
        **{"mc_ia_wide_prng_K{}_N{}_Ns{}".format(*geom): (
            MonteCarloMaxSinr(tile=IA_TILE, lane=IA_LANE,
                              iterations=IA_ITERS, K=geom[0], N=geom[1],
                              Ns=geom[2], device=dev),
            IA_CHUNK, IA_TILES, (77, IA_NV), 2) for geom in IA_WIDE_MAIN},
    }
    for name, (mc, reps, tiles, args, start_at) in builds.items():
        start = 1000

        def call(build, begin):
            a = list(args)
            a.insert(start_at, begin)
            return build(*a)

        whole = call(mc.build(reps, tiles), start)
        one_rank = call(mc.build(reps, tiles, mesh=mesh), start)
        splits = {k: torch.cat([call(mc.build(reps // k, tiles),
                                     start + i * reps // k)
                                for i in range(k)]) for k in (2, 4)}
        torch.cuda.synchronize()
        ok = {1: torch.equal(one_rank, whole),
              **{k: torch.equal(v, whole) for k, v in splits.items()}}
        phase("sharded_build", kernel=name, reps=reps, tiles=tiles,
              start=start, bitwise_equal=compact(ok))
        if not all(ok.values()):
            raise AssertionError(f"sharded_build {name}: a split differs "
                                 "from the unsharded launch")
        # the mesh's gather ran at world size 1; the 2- and 4-rank splits
        # are the ranks' launches in this process, which hold the stream
        # contract only (bin/weak_scaling_curve_torch.py runs the gathers
        # over several cards)
        extra.setdefault(name, {}).update(sharded_parity=True,
                                          sharded_world_sizes=[1],
                                          stream_split_world_sizes=[2, 4])

    # 42. the time-sharded channel through block_fir
    from pyphysim_tpu_torch.channels import (COST259_TUx,
                                             JakesSampleGenerator, TdlChannel)
    from pyphysim_tpu_torch.ops import fir
    from pyphysim_tpu_torch.parallel import corrupt_data_time_sharded
    from pyphysim_tpu_torch.parallel.timeshard import corrupt_shard
    block, blocks = fir_geometry()[0], TS_BLOCKS
    channel = TdlChannel(JakesSampleGenerator(Fd=30.0, Ts=1 / 20e6, L=16,
                                              device=dev), COST259_TUx)
    g = torch.Generator(device=dev).manual_seed(42)
    state = channel.init_state(g)
    n = block * blocks
    x = torch.randn(n, dtype=torch.complex64, device=dev, generator=g)
    want, want_ir, _ = channel.corrupt_data(state, x, block_size=block)
    want = want[:n]
    time_mesh = make_mesh(axis_name="time")
    fir.block_fir.launch_count = 0
    fir.block_fir.reference_count = 0
    got, ir, _ = corrupt_data_time_sharded(channel, state, x, block,
                                           time_mesh)
    torch.cuda.synchronize()
    ts_launches = fir.block_fir.launch_count
    ts_plain = fir.block_fir.reference_count
    err = float((got - want).abs().max())
    ir_err = float((ir.tap_values_sparse -
                    want_ir.tap_values_sparse).abs().max())
    # 4 shards in this process, the halos added as ranks 1-3 receive them
    shards = [corrupt_shard(channel, state, x, block, i, 4)
              for i in range(4)]
    mains = [m for m, _, _ in shards]
    for i in range(1, 4):
        tail = shards[i - 1][1]
        mains[i][:tail.shape[-1]] += tail
    four = torch.cat(mains)
    four_err = float((four - want).abs().max())
    halo = channel.num_taps_with_padding - 1
    n_local = n // 4
    halo_err = max(float((four[i * n_local:i * n_local + halo] -
                          want[i * n_local:i * n_local + halo]).abs().max())
                   for i in range(1, 4))
    phase("time_sharded_channel", card=repr(smi), samples=n, block=block,
          blocks=blocks, max_abs_err_1_rank=err, max_abs_err_ir=ir_err,
          max_abs_err_4_shards=four_err, max_abs_err_halos=halo_err,
          limit=TS_ATOL, block_fir_launches=ts_launches,
          block_fir_plain_calls=ts_plain)
    if max(err, ir_err, four_err) > TS_ATOL or ts_launches != 1 or \
            ts_plain != 0:
        raise AssertionError("time_sharded_channel: off the unsharded "
                             "corrupt_data, or not one block_fir launch")
    extra["block_fir"] = {"time_sharded_launches": ts_launches,
                          "time_sharded_max_abs_err": max(err, four_err)}
    dist.destroy_process_group()
    phase("parallel_seconds", phases_38_to_42=time.perf_counter() -
          start_time)
    return extra


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
    # the bench chunk's counts as a digest: equal across trees that keep
    # the fast instance's arithmetic
    digest = hashlib.sha256(k32.cpu().numpy().tobytes()).hexdigest()[:16]
    phase(f"chunk_invariance {dtype}", rows_4_to_7_equal_start_4=same,
          prng_counts_digest=digest)
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
    fewest = fast_fewest(mc, profile,
                         mc.kernel_plan(chunk, NUM_TILES)["rows"])
    counts, listing, _, _ = sass_bound(profile, nbytes, flops)
    _, bound, bound_by, pipe = sass_bound(profile, nbytes, flops, fewest)
    phase(f"times {dtype}", card=repr(smi),
          shape=f"reps={chunk},tiles={NUM_TILES},tile={TILE},used={mc.used},"
          f"taps={mc.taps},rays={mc.rays}",
          kernel_ms=kernel_ms, kernel_sym_per_s=syms / kernel_ms * 1e3,
          plain_ms=plain_ms, plain_sym_per_s=syms / plain_ms * 1e3,
          engine_ms=engine_ms, engine_sym_per_s=engine_syms / engine_ms * 1e3,
          engine_share_of_kernel=engine_syms / engine_ms / (syms / kernel_ms),
          bound_ms=bound, bound_by=bound_by, bound_pipe=pipe,
          listing_bound_ms=listing,
          fewest_sass_per_thread=fewest and fewest["total"],
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
    version at each of their draws, their symbol maps and decisions one
    launch each a chain call), and their times. Returns the entries of
    block_fir and of the fill (``fill_err``: its phase-3 parity error,
    raised by phase 10's) in the ``kernels`` line, and the map's launches
    in the runner's sweeps."""
    import torch
    from pyphysim_tpu_torch.chain import ChainStep
    from pyphysim_tpu_torch.channels import fading
    from pyphysim_tpu_torch.ops import _build, fir, sass
    from pyphysim_tpu_torch.ops.mimo_detect import sc_decide
    from pyphysim_tpu_torch.ops.qam import qam_map
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
    # the symbol map and the decision: one launch each a chain call
    step_kernels, map_launches = (qam_map, sc_decide), 0

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
        zero_counts(step_kernels)
        bers, seconds = run_sweep(runner)
        launches = fir.block_fir.launch_count
        fir_plain = fir.block_fir.reference_count
        phase("time_domain_path", signal=tag, snr_db=snrs, ber=bers,
              runned_reps=runner.runned_reps, seconds=seconds,
              chain_calls=runner.chunks_dispatched,
              block_fir_launches=launches, block_fir_plain_calls=fir_plain,
              fill_launches=philox_draw.launch_count,
              plain_draws=philox_draw.reference_count,
              map_decide_launches=compact([w.launch_count
                                           for w in step_kernels]),
              map_decide_plain_calls=compact([w.reference_count
                                              for w in step_kernels]))
        map_launches += check_step_kernels(f"time_domain_path {tag}",
                                           runner.chunks_dispatched,
                                           step_kernels)[0]
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
        zero_counts(step_kernels)
        bers, seconds = run_sweep(runner)
        phase("fused_path", signal=tag, snr_db=snrs, ber=bers,
              runned_reps=runner.runned_reps, seconds=seconds,
              chain_calls=runner.chunks_dispatched,
              fill_launches=philox_draw.launch_count,
              plain_draws=philox_draw.reference_count,
              map_decide_launches=compact([w.launch_count
                                           for w in step_kernels]),
              map_decide_plain_calls=compact([w.reference_count
                                              for w in step_kernels]))
        check_bers(f"fused_path {tag}", snrs, bers)
        map_launches += check_step_kernels(f"fused_path {tag}",
                                           runner.chunks_dispatched,
                                           step_kernels)[0]
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
    replay_phase(dev, smi)
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
    }], map_launches


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

    # 16. BD: inject parity over the prebuilt geometries and modes; PRNG
    # parity, bitwise
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
    for K, NR in bd_kernel.PREBUILT:
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
    if len(bd_instances) != 2 * len(bd_kernel.PREBUILT) * len(bd_kernel.MODES):
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
    if len(instances) != 2 * len(ia_kernel.PREBUILT):
        raise AssertionError(f"ia_build: {len(instances)} mc_ia instances, "
                             f"expected {2 * len(ia_kernel.PREBUILT)}")
    for K, N, Ns in ia_kernel.PREBUILT:      # every point's launch
        launch_phase(ia_kernel.MonteCarloMaxSinr(
            tile=IA_TILE, lane=IA_LANE, K=K, N=N, Ns=Ns, device=dev),
            f"prebuilt mc_ia K={K} N={N} Ns={Ns}")

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

    # 21. inject parity at every prebuilt point, 32,768 solves per cell
    for K, N, Ns in ia_kernel.PREBUILT:
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


def wide_form(mc):
    """``mc`` (a ``MonteCarloBD`` of a geometry up to NT = 8 outside the
    prebuilt library) launching the wide form instead, from its library
    built with ``-DMC_BD_WIDE=1``."""
    source, defines = mc.geometry_build()
    geometry = (source, {**defines, "MC_BD_WIDE": 1})
    mc.geometry_build = lambda: geometry
    return mc


def geometry_kernels(dev):
    """A ``MonteCarloBD`` / ``MonteCarloMaxSinr`` on ``dev`` for every
    geometry library the script uses, at the bench widths (BD ``BD_FORMS``
    in the wide form too)."""
    from pyphysim_tpu_torch.ops.bd_kernel import MonteCarloBD
    from pyphysim_tpu_torch.ops.ia_kernel import MonteCarloMaxSinr
    return [*(MonteCarloBD(tile=BD_TILE, lane=BD_LANE, K=K, Nr_u=NR,
                           device=dev) for K, NR in BD_GEOMETRIES),
            wide_form(MonteCarloBD(tile=BD_TILE, lane=BD_LANE,
                                   K=BD_FORMS[0], Nr_u=BD_FORMS[1],
                                   device=dev)),
            *(MonteCarloMaxSinr(tile=IA_TILE, lane=IA_LANE,
                                iterations=IA_ITERS, K=K, N=N, Ns=Ns,
                                device=dev) for K, N, Ns in IA_GEOMETRIES)]


def geometry_builds():
    """``(source, defines)`` of every geometry library the script uses."""
    return [mc.geometry_build() for mc in geometry_kernels("cpu")]


def launch_phase(mc, label):
    """One phase line of how ``mc``'s kernel launches on the card, as its
    library reports it (``mc_*_launch_info``: threads and shared bytes a
    block, elements a block, lanes an element, the scratch buffer, resident
    blocks and warps a SM) with its partials a (rep, tile) cell and its
    scratch bytes at the bench chunk; fails unless a block is resident,
    the blocks cover the cell and the scratch bytes agree with the scratch
    flag. Returns the launch."""
    from pyphysim_tpu_torch.ops import _build
    launch = mc.launch_info()
    lib = _build.load(mc.geometry_build())
    if hasattr(mc, "Nr_u"):
        parts = lib.mc_bd_num_parts(mc.tile, mc.lane)
        nbytes = lib.mc_bd_scratch_bytes(BD_CHUNK, BD_TILES, mc.tile, mc.lane)
    else:
        parts = lib.mc_ia_num_parts(mc.tile, mc.lane, mc.K, mc.N, mc.Ns)
        nbytes = lib.mc_ia_scratch_bytes(IA_CHUNK, IA_TILES, mc.tile, mc.lane)
    phase("geometry_launch", instance=label, **launch, parts=parts,
          scratch_bytes=nbytes)
    if not (launch["blocks_per_sm"] >= 1 and
            parts * launch["elems"] >= mc.tile * mc.lane and
            launch["scratch"] == (nbytes > 0)):
        raise AssertionError(f"geometry_launch {label}: {launch}, {parts} "
                             f"parts, {nbytes} scratch bytes")
    return launch


def bd_solve_flops(K, NR):
    """The fewest f32 operations one BD solve needs, whatever the kernel (a
    complex multiply-add 8, a complex product or |x|^2 with its sum 6 /
    3): the Hermitian Gram H H^H of the joint channel once (its upper
    triangle, NT (NT + 1) / 2 entries of NT terms), of which every user's B
    = tilde tilde^H and Y = Hk tilde^H are blocks; then per user the LDL^H
    of B, the two substitutions on Nr_u columns and the scale, and T = Hk -
    W^H tilde with its Gram (T T^H as Hk Hk^H - Y W would be cheaper but
    cancels in float32). Not the water-filling, the channel draws (Philox,
    erfinvf) or memory traffic, so the bound is a floor. This is the
    function's minimum, not the kernel's own count (``mc_bd.cu`` sums the
    whole Gram's lower triangle and solves spare users on idle
    sub-groups)."""
    NT, M = K * NR, (K - 1) * NR
    gram = 8 * NT * (NT * (NT + 1) // 2)
    user = sum(5 * j + (M - 1 - j) * (10 * j + 2) for j in range(M))
    user += 8 * NR * M * (M - 1) + 2 * NR * M
    user += 8 * NR * M * NT + 2 * NR * NT + NT * (3 if NR == 1 else 14)
    return gram + K * user


def ia_solve_flops(K, N, Ns, iters, init_iters):
    """The fewest f32 operations one Max-SINR solve of the general body
    needs, whatever the kernel (a complex multiply-add 8): the init (each
    user's Gram M^H M by its triangle, N (N + 1) / 2 entries of N terms,
    and ``init_iters`` orthogonal-iteration steps), 2 iters + 1 filter
    updates (per user: K Ns link products H_kj f and their outer products
    p t t^H into the Hermitian Bkl, by its triangle; per stream the rank-1
    downdate, by the triangle, the LDL^H solve and the normalization) and
    the SINRs (the downdate by the triangle, Bkl u in full); not the
    channel draws. This is the function's minimum, not the kernel's own
    count: ``mc_ia.cu`` forms whole rows of Bkl, each lane its own."""
    tri = N * (N + 1) // 2
    ldl = sum(5 * j + (N - 1 - j) * (10 * j + 2) for j in range(N)) + \
        8 * N * (N - 1) + 2 * N
    first = K * Ns * (8 * N * N + 10 * tri)
    update = K * (first + Ns * (10 * tri + ldl + 10 * N))
    init = K * (8 * N * tri + init_iters * Ns * (8 * N * N + 8 * Ns * N))
    final = K * (first + Ns * (10 * tri + 8 * N * N + 16 * N))
    return init + (2 * iters + 1) * update + final


def once_ms(fn):
    """One call of ``fn`` timed by CUDA events (its warm-up ran before)."""
    import torch
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop)


def plain_slices(fn, reps, start=0):
    """The plain version ``fn(n, start)`` over ``reps`` reps in slices of
    ``WIDE_PLAIN_SLICE`` (bounds its memory): (reps, num_tiles)."""
    import torch
    return torch.cat([fn(min(WIDE_PLAIN_SLICE, reps - r), start + r)
                      for r in range(0, reps, WIDE_PLAIN_SLICE)])


def geometry_phases(dev, smi):
    """Phases 55-60: the BD and IA kernels at geometries outside the
    prebuilt library, each from its own library built at phase 2 (BD up
    to NT = 8 in the prebuilt kernel's form, else the kernels' wide form;
    BD ``BD_FORMS`` in both, held together and timed): the instances'
    registers and spills and each
    library's build seconds; inject parity at every geometry (and BD mode)
    per 32,768-solve cell; PRNG parity per rep, a bitwise rerun and another
    chunking; the main paths (BD (7, 2) through ``BDKernelCapacityRunner``'s
    bulk path at bench.py's widths, IA K = 5 through
    ``IaMcKernelSimulationRunner``, IA (3, 4, 2) through
    ``MonteCarloMaxSinr.build``) with their launches and no plain call; and
    their times beside their bounds. Returns their ``kernels`` entries."""
    import numpy as np
    import torch
    from apps.comp_BD.batched_bd_capacity_torch import \
        BDKernelCapacityRunner
    from apps.ia.ia_mc_kernel_torch import IaMcKernelSimulationRunner
    from pyphysim_tpu_torch.ops import _build, sass
    from pyphysim_tpu_torch.ops.bd_kernel import MODES, MonteCarloBD
    from pyphysim_tpu_torch.ops.ia_kernel import MonteCarloMaxSinr

    # 55. the geometry libraries phase 2 built: seconds, registers, spills,
    # and each PRNG instance's launch (threads and shared bytes a block,
    # resident warps a SM, the scratch buffer: IA_SCRATCH's state in it)
    spilling, in_scratch = [], set()
    for mc in geometry_kernels(dev):
        source, defines = mc.geometry_build()
        path = _build.library_path((source, defines))
        log = path.with_suffix(".log")
        info = ptxas_info(log.read_text() if log.exists() else "",
                          "mc_(?:bd|ia)_(?:wide_|general_)?kernel")
        phase("geometry_build", library=path.name, geometry=compact(defines),
              seconds=_build.geometry_build_seconds.get(path.name),
              instances=len(info))
        for name, regs in info.items():
            phase("geometry_build", instance=name, ptxas=repr(regs))
            if " 0 bytes spill stores" not in regs:
                spilling.append(name)
        if len(info) != (2 * len(MODES) if source == "mc_bd" else 2):
            raise AssertionError(f"geometry_build: {len(info)} instances "
                                 f"in {path.name}")
        for mode in (MODES if source == "mc_bd" else (None,)):
            if mode is not None:
                mc.mode = mode
            launch = launch_phase(mc, f"{path.name} {mode or ''}".strip())
            if launch["scratch"]:
                in_scratch.add(compact(defines))
    phase("geometry_spills", spilling_instances=len(spilling),
          names=compact(sorted(spilling)))
    want = compact(MonteCarloMaxSinr(K=IA_SCRATCH[0], N=IA_SCRATCH[1],
                                     Ns=IA_SCRATCH[2],
                                     device="cpu").geometry_build()[1])
    phase("geometry_scratch", libraries=sorted(in_scratch))
    if in_scratch != {want}:
        raise AssertionError(f"geometry_scratch: {sorted(in_scratch)} keep "
                             f"their state in the scratch buffer, not {want}")

    g = torch.Generator(device=dev).manual_seed(55)

    def bits(*shape):
        return torch.randint(-2 ** 31, 2 ** 31, shape, dtype=torch.int32,
                             device=dev, generator=g)

    def check_rel(name, got, want, limit, **fields):
        rel = (got - want).abs() / want.abs()
        err = float((got - want).abs().max())
        phase(name, max_rel_cell_diff=float(rel.max()),
              max_abs_cell_diff=err, limit=limit,
              total_cap=float(want.sum()), **fields)
        if not float(rel.max()) <= limit:
            raise AssertionError(f"{name}: kernel and plain version differ "
                                 f"by {float(rel.max())} relative")
        return err

    def check_repeat(name, mc_build, k_main, args, start_at):
        """A rerun and another chunking (reps 4-7 from attempt 4) give the
        same bits."""
        def call(reps, start):
            a = list(args)
            a.insert(start_at, start)
            return mc_build(reps, k_main.shape[1])(*a)
        k4, again = call(4, 4), call(k_main.shape[0], 0)
        torch.cuda.synchronize()
        same = bool(torch.equal(k_main[4:8], k4))
        rerun = bool(torch.equal(k_main, again))
        phase(name, rows_4_to_7_equal_start_4=same,
              rerun_bitwise_equal=rerun)
        if not (same and rerun):
            raise AssertionError(f"{name}: not bitwise reproducible")

    # 56. BD: inject parity at every geometry and mode, PRNG parity per rep
    # (16,384 solves), rerun and chunking
    seed = 4242
    for K, NR in BD_GEOMETRIES:
        for mode in MODES:
            mc = MonteCarloBD(tile=BD_PARITY_TILE, lane=BD_LANE, K=K,
                              Nr_u=NR, mode=mode, device=dev)
            ch = bits(2, 2 * BD_PARITY_TILE, mc.num_planes * BD_LANE)
            got = mc.build_inject(2, 2)(ch)
            want = mc.simulate_block_reference(ch)
            torch.cuda.synchronize()
            check_rel(f"wide_bd_inject_parity K={K} Nr_u={NR} {mode}", got,
                      want, BD_REL_TOL, launches=mc.launch_count)
        if (K, NR) == BD_WIDE_MAIN:
            continue
        mc = MonteCarloBD(tile=BD_TILE, lane=BD_LANE, K=K, Nr_u=NR,
                          device=dev)
        k_main = mc.build(WIDE_PRNG_REPS, BD_TILES)(seed, 0)
        p_main = plain_slices(lambda n, s: mc.prng_reference(
            n, BD_TILES, seed, s), WIDE_PRNG_REPS)
        check_rel(f"wide_bd_prng_parity per rep K={K} Nr_u={NR}",
                  k_main.sum(dim=1), p_main.sum(dim=1), BD_REL_TOL,
                  reps=WIDE_PRNG_REPS)
        check_repeat(f"wide_bd_chunk_invariance K={K} Nr_u={NR}", mc.build,
                     k_main, (seed,), 1)

    # 57. the main path at (7, 2): the bulk runner at bench.py's widths,
    # two chunks of 128 reps x 4 tiles x 8 x 512 (2.1e6 solves each)
    K, NR = BD_WIDE_MAIN
    pu_db = [0.0, float(10 * np.log10(10.0 / 3)), 10.0]
    runner = BDKernelCapacityRunner(K=K, nr_u=NR, tile=BD_TILE, lane=BD_LANE,
                                    num_tiles=BD_TILES, device=dev,
                                    read_command_line_args=False)
    sweep_runner(runner, "Pu_dB", pu_db, 2 * BD_CHUNK, BD_CHUNK)
    runner.mc.launch_count = 0
    runner.mc.reference_count = 0
    caps, seconds = run_sweep_values(runner, "sum_capacity")
    bd_launches = runner.mc.launch_count
    phase("wide_bd_path", geometry=f"K={K},Nr_u={NR}", pu_db=pu_db,
          mean_sum_capacity=caps, runned_reps=runner.runned_reps,
          seconds=seconds, kernel_launches=bd_launches,
          chunks=runner.chunks_dispatched,
          plain_calls=runner.mc.reference_count)
    if not (caps[0] < caps[1] < caps[2] and all(np.isfinite(caps))):
        raise AssertionError("wide_bd_path: capacity does not rise with Pu")
    check_launches("wide_bd_path", bd_launches, runner.chunks_dispatched,
                   runner.mc.reference_count)
    # PRNG parity over the main path's chunk, per rep; rerun and chunking
    mcb = MonteCarloBD(tile=BD_TILE, lane=BD_LANE, K=K, Nr_u=NR, device=dev)
    run_b = mcb.build(BD_CHUNK, BD_TILES)
    k_main = run_b(seed, 0)
    p_main = plain_slices(lambda n, s: mcb.prng_reference(
        n, BD_TILES, seed, s), BD_CHUNK)
    cell_rel = (k_main - p_main).abs() / p_main.abs()
    bd_err = check_rel(
        f"wide_bd_prng_parity per rep K={K} Nr_u={NR}", k_main.sum(dim=1),
        p_main.sum(dim=1), BD_REL_TOL, reps=BD_CHUNK,
        max_rel_diff_4096_solve_cell=float(cell_rel.max()),
        cells_over_limit=int((cell_rel > BD_REL_TOL).sum()))
    check_repeat(f"wide_bd_chunk_invariance K={K} Nr_u={NR}", mcb.build,
                 k_main, (seed,), 1)

    # 58. IA: inject parity at every geometry (10 iterations, noise 0.1),
    # PRNG parity per rep, rerun and chunking
    ia_mcs = {}
    for K, N, Ns in IA_GEOMETRIES:
        mc = MonteCarloMaxSinr(tile=IA_PARITY_TILE, lane=IA_LANE,
                               iterations=IA_ITERS, K=K, N=N, Ns=Ns,
                               device=dev)
        ch = bits(2, 2 * IA_PARITY_TILE, mc.num_planes * IA_LANE)
        got = mc.build_inject(2, 2)(ch, IA_NV)
        want = mc.simulate_block_reference(ch, IA_NV)
        torch.cuda.synchronize()
        check_rel(f"wide_ia_inject_parity K={K} N={N} Ns={Ns}", got, want,
                  IA_REL_TOL)
        mc = MonteCarloMaxSinr(tile=IA_TILE, lane=IA_LANE,
                               iterations=IA_ITERS, K=K, N=N, Ns=Ns,
                               device=dev)
        reps = IA_CHUNK if (K, N, Ns) in IA_WIDE_MAIN else WIDE_PRNG_REPS
        mc.launch_count = 0
        k_main = mc.build(reps, IA_TILES)(seed, IA_NV, 0)
        launches = mc.launch_count
        p_main = plain_slices(lambda n, s: mc.prng_reference(
            n, IA_TILES, seed, IA_NV, s), reps)
        cell_rel = (k_main - p_main).abs() / p_main.abs()
        err = check_rel(
            f"wide_ia_prng_parity per rep K={K} N={N} Ns={Ns}",
            k_main.sum(dim=1), p_main.sum(dim=1), IA_REL_TOL, reps=reps,
            max_rel_diff_4096_solve_cell=float(cell_rel.max()),
            cells_over_limit=int((cell_rel > IA_REL_TOL).sum()))
        check_repeat(f"wide_ia_chunk_invariance K={K} N={N} Ns={Ns}",
                     mc.build, k_main, (seed, IA_NV), 2)
        ia_mcs[K, N, Ns] = (mc, k_main, p_main, err, launches)

    # 59. the main paths of IA: K = 5 through the bulk runner, (3, 4, 2)
    # through MonteCarloMaxSinr.build (its launches in phase 58)
    snrs = [0.0, 10.0, 20.0]
    K = IA_WIDE_MAIN[0][0]
    runner = IaMcKernelSimulationRunner(K=K, tile=IA_TILE, lane=IA_LANE,
                                        num_tiles=IA_TILES,
                                        iterations=IA_ITERS, device=dev,
                                        read_command_line_args=False)
    sweep_runner(runner, "SNR", snrs, 2 * IA_CHUNK, IA_CHUNK)
    runner.mc.launch_count = 0
    runner.mc.reference_count = 0
    ia_caps, seconds = run_sweep_values(runner, "sum_capacity")
    ia_launches = runner.mc.launch_count
    phase("wide_ia_path", geometry=f"K={K},N=2,Ns=1", snr_db=snrs,
          mean_sum_capacity=ia_caps, runned_reps=runner.runned_reps,
          seconds=seconds, kernel_launches=ia_launches,
          chunks=runner.chunks_dispatched,
          plain_calls=runner.mc.reference_count)
    if not ia_caps[0] < ia_caps[1] < ia_caps[2]:
        raise AssertionError("wide_ia_path: capacity does not rise with SNR")
    check_launches("wide_ia_path", ia_launches, runner.chunks_dispatched,
                   runner.mc.reference_count)
    ia_mcs[IA_WIDE_MAIN[0]] = ia_mcs[IA_WIDE_MAIN[0]][:4] + (ia_launches,)

    # 60. times (CUDA events: the kernel best of 3 after a warm-up, the
    # plain version once over the chunk, its parity run the warm-up) and
    # bounds: the SASS issue bound where the profile lists the loops (IA
    # K = 5), else the solve's f32 operations at 67 TFLOP/s
    entries = []
    wide = [("mc_bd", BD_WIDE_MAIN, mcb, bd_err, bd_launches,
             lambda: run_b(seed, 0),
             lambda: plain_slices(lambda n, s: mcb.prng_reference(
                 n, BD_TILES, seed, s), BD_CHUNK),
             bd_solve_flops(*BD_WIDE_MAIN), BD_CHUNK, BD_TILES,
             "pyphysim_tpu/ops/bd_pallas.py:282")]
    for geom in IA_WIDE_MAIN:
        mc, _, _, err, launches = ia_mcs[geom]
        run_i = mc.build(IA_CHUNK, IA_TILES)
        wide.append(("mc_ia", geom, mc, err, launches,
                     functools.partial(run_i, seed, IA_NV, 0),
                     functools.partial(
                         plain_slices, functools.partial(
                             lambda m, n, s: m.prng_reference(
                                 n, IA_TILES, seed, IA_NV, s), mc), IA_CHUNK),
                     ia_solve_flops(*geom, IA_ITERS, mc.init_iters),
                     IA_CHUNK, IA_TILES,
                     "pyphysim_tpu/ops/ia_pallas.py:480"))
    for (source, geom, mc, err, launches, kernel, plain, flops, reps, tiles,
         replaces) in wide:
        ms = best_ms(kernel, inner=3)
        plain_ms = once_ms(plain)
        solves = reps * tiles * mc.solves_per_grid_step
        nbytes = 4 * reps * tiles        # outputs only, nothing read
        profile = mc.prng_kernel_profile(reps, tiles) \
            if source == "mc_bd" or mc.closed_form else {"loops": None}
        if profile["loops"] is None:
            bound, bound_by = bound_ms(nbytes=nbytes, flops=flops * solves)
            counts, pipe = None, "f32 operations"
        else:
            counts, bound, bound_by, pipe = sass_bound(profile, nbytes,
                                                       flops * solves)
        tag = "_".join(f"{k}{v}" for k, v in zip(
            ("K", "Nr") if source == "mc_bd" else ("K", "N", "Ns"), geom))
        phase("wide_times", card=repr(smi), kernel=f"{source}_{tag}",
              shape=f"reps={reps},tiles={tiles},tile={mc.tile},"
              f"lane={mc.lane}", kernel_ms=ms,
              solves_per_s=solves / ms * 1e3, bound_ms=bound,
              bound_by=bound_by, bound_pipe=pipe,
              flops_per_solve=flops,
              sass_per_thread=compact(counts) if counts else None,
              share_of_bound=bound / ms, plain_ms=plain_ms,
              launches=launches)
        entries.append({
            "name": f"{source}_wide_prng_{tag}",
            "route": "cuda",
            "source": f"pyphysim_tpu_torch/ops/csrc/{source}.cu",
            "replaces": replaces,
            "launches": launches,
            "max_abs_err": err,
            "ms": ms,
            "timed_by": "wrapper_events",
            "wrapper_ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound,
            "bound_by": bound_by,
            "library_ms": None,
        })
    # every other geometry's PRNG kernel at the same chunk (best of 2 after
    # a warm-up) beside its f32-operation bound
    others = [MonteCarloBD(tile=BD_TILE, lane=BD_LANE, K=K, Nr_u=NR,
                           device=dev) for K, NR in BD_GEOMETRIES
              if (K, NR) != BD_WIDE_MAIN]
    others += [MonteCarloMaxSinr(tile=IA_TILE, lane=IA_LANE,
                                 iterations=IA_ITERS, K=K, N=N, Ns=Ns,
                                 device=dev)
               for K, N, Ns in IA_GEOMETRIES if (K, N, Ns) not in IA_WIDE_MAIN]
    for mc in others:
        bd = isinstance(mc, MonteCarloBD)
        run = mc.build(BD_CHUNK if bd else IA_CHUNK,
                       BD_TILES if bd else IA_TILES)
        args = (seed, 0) if bd else (seed, IA_NV, 0)
        ms = best_ms(lambda: run(*args), repeat=2)
        solves = (BD_CHUNK * BD_TILES if bd else IA_CHUNK * IA_TILES) * \
            mc.solves_per_grid_step
        flops = bd_solve_flops(mc.K, mc.Nr_u) if bd else ia_solve_flops(
            mc.K, mc.N, mc.Ns, IA_ITERS, mc.init_iters)
        bound, _ = bound_ms(flops=flops * solves)
        phase("wide_geometry_times", card=repr(smi),
              kernel=f"mc_bd K={mc.K} Nr_u={mc.Nr_u}" if bd else
              f"mc_ia K={mc.K} N={mc.N} Ns={mc.Ns}", solves=solves,
              kernel_ms=ms, flop_bound_ms=bound, share_of_bound=bound / ms,
              form=("wide" if mc.wide_form else "tile") if bd else "wide")
    # BD_FORMS in the prebuilt kernel's form (its library's) and in the
    # wide form: the same draws within BD_REL_TOL per rep, and each timed
    # at the same chunk, alternately (best of 3, twice each)
    K, NR = BD_FORMS
    runs = {form: mc.build(BD_CHUNK, BD_TILES) for form, mc in (
        ("tile", MonteCarloBD(tile=BD_TILE, lane=BD_LANE, K=K, Nr_u=NR,
                              device=dev)),
        ("wide", wide_form(MonteCarloBD(tile=BD_TILE, lane=BD_LANE, K=K,
                                        Nr_u=NR, device=dev))))}
    caps = {form: run(seed, 0).sum(dim=1) for form, run in runs.items()}
    torch.cuda.synchronize()
    check_rel(f"bd_forms_parity per rep K={K} Nr_u={NR}", caps["wide"],
              caps["tile"], BD_REL_TOL, reps=BD_CHUNK)
    times = {form: float("inf") for form in runs}
    for _ in range(2):
        for form, run in runs.items():
            times[form] = min(times[form],
                              best_ms(functools.partial(run, seed, 0)))
    solves = BD_CHUNK * BD_TILES * BD_TILE * BD_LANE
    bound, _ = bound_ms(flops=bd_solve_flops(K, NR) * solves)
    phase("bd_form_times", card=repr(smi), kernel=f"mc_bd K={K} Nr_u={NR}",
          solves=solves, tile_form_ms=times["tile"],
          wide_form_ms=times["wide"],
          wide_over_tile=times["wide"] / times["tile"],
          flop_bound_ms=bound)
    return entries


def exponential_profile(trms, ts):
    """The IEEE 802.11 exponential-decay profile: taps every ``ts``, power
    exp(-k ts / trms) for k <= 10 trms / ts."""
    import numpy as np
    from pyphysim_tpu_torch.channels import TdlChannelProfile
    k = np.arange(int(round(10 * trms / ts)) + 1)
    return TdlChannelProfile(10 * np.log10(np.exp(-k * ts / trms)), k * ts,
                             f"exponential {trms * 1e9:g} ns")


def shape_profile(kind, bandwidth):
    from pyphysim_tpu_torch.channels import COST259_HTx
    return (COST259_HTx if kind == "ht"
            else exponential_profile(EXP_TRMS_B1, 1 / bandwidth))


def device_bits(dev, seed, mc, num_tiles):
    """An inject-mode bit source on the card for ``mc``'s runner: (unpack
    index, start, n) -> the chunk's four int32 bit tensors, from a seeded
    generator."""
    import torch

    def bits(unpack_idx, start, n):
        g = torch.Generator(device=dev).manual_seed(
            seed + 1000003 * unpack_idx + start)

        def draw(*shape):
            return torch.randint(-2 ** 31, 2 ** 31, shape, dtype=torch.int32,
                                 device=dev, generator=g)
        return (draw(n, 8, mc.TLp),
                *(draw(n, num_tiles * mc.tile, mc.used_p) for _ in range(3)))
    return bits


def shape_mc_entry(name, mc, launches, err, ms, plain_ms, reps, tiles):
    """A ``kernels`` entry of the flagship kernel at one shape: its bound
    the least of this run's listing's (PRNG mode, ``listing_bound_ms``),
    the fast instance's fewest known (``fewest_bound_ms``,
    ``FAST_FEWEST_SASS``) and the first general form's (``ref_bound_ms``,
    ``REF_BOUND_MS``), with the launch's registers, spills, shared bytes
    and blocks a SM."""
    profile = mc.prng_kernel_profile(reps, tiles)
    plan = mc.kernel_plan(reps, tiles)
    fewest = None if plan["general"] else fast_fewest(mc, profile,
                                                      plan["rows"])
    nbytes = 8 * mc.taps * mc.used + 4 * reps * tiles
    flops = mc_flops(mc, reps, tiles)
    counts, listing, _, _ = sass_bound(profile, nbytes, flops)
    _, least, bound_by, pipe = sass_bound(profile, nbytes, flops, fewest)
    ref = REF_BOUND_MS.get(name)
    bound = least if ref is None else min(least, ref)
    return {"name": name, "route": "cuda",
            "source": "pyphysim_tpu_torch/ops/csrc/mc_ofdm_tdl.cu",
            "replaces": "pyphysim_tpu/ops/mc_pallas.py:336",
            "launches": launches, "max_abs_err": err, "ms": ms,
            "timed_by": "wrapper_events", "wrapper_ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
            "library_ms": None, "sass_per_thread": counts["total"],
            "bound_pipe": pipe, "listing_bound_ms": listing,
            "fewest_bound_ms": least if fewest else None,
            "ref_bound_ms": ref, "share_of_bound": bound / ms,
            "form": "general" if plan["general"] else "fast",
            "launch": mc.launch_info(reps, tiles)}


def f1_phases(dev, smi, dtype):
    """Phase 61: the flagship kernel's general form at 51 taps of 32 rays
    (TL = 1,632) through the bulk runner, PRNG and inject mode, at the
    bench chunk: inject and PRNG parity with the plain version (and at
    FLAT_TAPS equal-power taps, where the taps past the first 32 carry
    power), chunk invariance, the main path at 5 / 15 / 30 dB (BER finite,
    in (0, 0.5), falling with SNR), times and the SASS bound."""
    import numpy as np
    import torch
    from apps.ofdm.ofdm_mc_kernel_torch import OfdmMcKernelSimulationRunner
    from pyphysim_tpu_torch.channels import (JakesSampleGenerator,
                                             TdlChannel, TdlChannelProfile)
    from pyphysim_tpu_torch.ops.mc_kernel import MonteCarloOfdmTdl

    def make_runner(snrs, rep_max, batch):
        r = OfdmMcKernelSimulationRunner(device=dev,
                                         read_command_line_args=False,
                                         matmul_dtype=dtype)
        r.params.add("SNR", np.array(snrs))
        r.params.set_unpack_parameter("SNR")
        r.rep_max, r.batch_size = rep_max, batch
        r.tile, r.num_tiles = TILE, NUM_TILES
        r.jakes = JakesSampleGenerator(Fd=30.0, Ts=1 / 20e6, L=EXP_RAYS,
                                       device=dev)
        r.channel = TdlChannel(r.jakes, exponential_profile(EXP_TRMS_F1,
                                                            1 / 20e6))
        r.mc = MonteCarloOfdmTdl(r.ofdm, r.channel, M=16, tile=TILE,
                                 matmul_dtype=dtype, device=dev)
        r.update_progress_function_style = None
        return r

    base = make_runner([15.0], 1, 1)
    mc = base.mc
    plan = mc.kernel_plan(32, NUM_TILES)
    if (mc.taps, mc.TL) != (51, 1632) or not plan["general"]:
        raise AssertionError(f"f1: {mc.taps} taps, TL {mc.TL}, {plan}")
    cell_bits = TILE * mc.used * mc.bits_per_symbol
    reps, chunk, seed, snr = 4, 32, 1234567, 10 ** 1.5
    amp = mc.amp(snr)
    bits = device_bits(dev, 17, mc, NUM_TILES)(0, 0, reps)
    got = mc.build_inject(reps, NUM_TILES)(*bits, amp)
    want = mc.simulate_block_reference(*bits, amp)
    torch.cuda.synchronize()
    err = check_cells(f"f1_inject_parity {dtype}", got, want, cell_bits)

    # the second chunk of taps, where it carries power: FLAT_TAPS taps of
    # equal power, inject and PRNG mode against the plain version
    flat = MonteCarloOfdmTdl(
        base.ofdm,
        TdlChannel(JakesSampleGenerator(Fd=30.0, Ts=1 / 20e6, L=EXP_RAYS,
                                        device=dev),
                   TdlChannelProfile(np.zeros(FLAT_TAPS),
                                     np.arange(FLAT_TAPS) / 20e6,
                                     f"equal power {FLAT_TAPS}")),
        M=16, tile=TILE, matmul_dtype=dtype, device=dev)
    flat_plan = flat.kernel_plan(reps, NUM_TILES)
    if flat.taps != FLAT_TAPS or not flat_plan["general"]:
        raise AssertionError(f"f1 flat: {flat.taps} taps, {flat_plan}")
    bits = device_bits(dev, 19, flat, NUM_TILES)(0, 0, reps)
    flat_amp = flat.amp(snr)
    err = max(err, check_cells(
        f"f1_flat_inject_parity {dtype}",
        flat.build_inject(reps, NUM_TILES)(*bits, flat_amp),
        flat.simulate_block_reference(*bits, flat_amp), cell_bits))
    err = max(err, check_cells(
        f"f1_flat_prng_parity {dtype}",
        flat.build(reps, NUM_TILES)(seed, snr, 0),
        flat.prng_reference(reps, NUM_TILES, seed, flat_amp, 0), cell_bits))

    def plain(n, start):
        return torch.cat([mc.prng_reference(
            min(F1_PLAIN_SLICE, n - r), NUM_TILES, seed, amp, start + r)
            for r in range(0, n, F1_PLAIN_SLICE)])
    k32 = mc.build(chunk, NUM_TILES)(seed, snr, 0)
    err = max(err, check_cells(f"f1_prng_parity {dtype}", k32,
                               plain(chunk, 0), cell_bits))
    k4 = mc.build(4, NUM_TILES)(seed, snr, 4)
    torch.cuda.synchronize()
    same = bool(torch.equal(k32[4:8], k4))
    phase(f"f1_chunk_invariance {dtype}", rows_4_to_7_equal_start_4=same,
          plan=compact(plan))
    if not same:
        raise AssertionError("f1: kernel results depend on the chunking")

    snrs = [5.0, 15.0, 30.0]
    launches = 0
    for mode in ("prng", "inject"):
        runner = make_runner(snrs, 64 if mode == "prng" else chunk, chunk)
        if mode == "inject":
            runner.bit_source = device_bits(dev, 23, runner.mc, NUM_TILES)
        runner.mc.launch_count = 0
        runner.mc.reference_count = 0
        bers, seconds = run_sweep(runner)
        n = runner.mc.launch_count
        phase(f"f1_main_path {dtype}", mode=mode, profile="exponential "
              f"Trms=250ns,taps={mc.taps},rays={mc.rays}", snr_db=snrs,
              ber=bers, runned_reps=runner.runned_reps, seconds=seconds,
              kernel_launches=n, chunks=runner.chunks_dispatched,
              plain_calls=runner.mc.reference_count)
        if not all(0 < b < 0.5 for b in bers) or \
                any(b >= a for a, b in zip(bers, bers[1:])):
            raise AssertionError(f"f1 {mode}: BER {bers} not finite in "
                                 f"(0, 0.5) or not falling with SNR")
        check_launches(f"f1_main_path {dtype} {mode}", n,
                       runner.chunks_dispatched, runner.mc.reference_count)
        launches += n

    run32 = mc.build(chunk, NUM_TILES)
    ms = best_ms(lambda: run32(seed, snr, 0), inner=10)
    plain_ms = once_ms(lambda: plain(chunk, 0))
    entry = shape_mc_entry(
        "mc_ofdm_tdl_general_prng_T51_L32" +
        ("_bf16" if dtype == "bfloat16" else ""), mc, launches, err, ms,
        plain_ms, chunk, NUM_TILES)
    syms = chunk * NUM_TILES * TILE * mc.used
    phase(f"f1_times {dtype}", card=repr(smi),
          shape=f"reps={chunk},tiles={NUM_TILES},tile={TILE},"
          f"used={mc.used},taps={mc.taps},rays={mc.rays}", kernel_ms=ms,
          kernel_sym_per_s=syms / ms * 1e3, plain_ms=plain_ms,
          bound_ms=entry["bound_ms"], bound_by=entry["bound_by"],
          bound_pipe=entry["bound_pipe"],
          listing_bound_ms=entry["listing_bound_ms"],
          ref_bound_ms=entry["ref_bound_ms"],
          sass_per_thread=entry["sass_per_thread"],
          sass_per_symbol=entry["sass_per_thread"] *
          mc.prng_kernel_profile(chunk, NUM_TILES)["threads"] / syms,
          share_of_bound=entry["share_of_bound"],
          launch=compact(entry["launch"]), plan=compact(plan))
    return entry


def f2_phases(dev, smi):
    """Phase 62: the flagship kernel (COST259-TU, 16 rays, tile 8) past the
    grid's 65,535 a dimension. 70,000 reps in one ``build`` call (two
    launches of the fast instance): rows [65,530, 70,000) bit for bit a
    call of those reps from start 65,530, and rows held to the plain
    version around the split. 70,000 tiles of 2 reps in one call (two
    launches of the fast instance, the second from tile 65,535): its
    first and last tiles held to the plain version on those tiles, and
    its first 65,535 tiles bit for bit a call of 65,535 tiles. Returns the
    two ``kernels`` entries."""
    import torch
    from apps.ofdm.ofdm_mc_kernel_torch import OfdmMcKernelSimulationRunner
    from pyphysim_tpu_torch.ops.mc_kernel import (MonteCarloOfdmTdl,
                                                  launch_slices)
    r = OfdmMcKernelSimulationRunner(device=dev, read_command_line_args=False)
    mc = MonteCarloOfdmTdl(r.ofdm, r.channel, M=16, tile=F2_TILE,
                           device=dev)
    seed, snr = 4242, 10 ** 1.5
    amp = mc.amp(snr)
    cell_bits = F2_TILE * mc.used * mc.bits_per_symbol

    mc.launch_count = 0
    run_reps = mc.build(F2_REPS, 1)
    big = run_reps(seed, snr, 0)
    torch.cuda.synchronize()
    reps_launches = mc.launch_count
    part = mc.build(F2_REPS - F2_SPLIT, 1)(seed, snr, F2_SPLIT)
    torch.cuda.synchronize()
    same = bool(torch.equal(big[F2_SPLIT:], part))
    lo = max(launch_slices(F2_REPS)[0][1] - 16, 0)   # across the split
    n = min(32, F2_REPS - lo)
    err = check_cells("f2_reps_plain", big[lo:lo + n],
                      mc.prng_reference(n, 1, seed, amp, lo), cell_bits)
    phase("f2_reps", reps=F2_REPS, tiles=1, tile=F2_TILE,
          launches=reps_launches, slices=compact(launch_slices(F2_REPS)),
          rows_65530_on_equal_start_65530=same,
          plan=compact(mc.kernel_plan(65535, 1)))
    if not same or reps_launches != len(launch_slices(F2_REPS)):
        raise AssertionError(f"f2 reps: split rows differ ({same}) or "
                             f"{reps_launches} launches")

    mc.launch_count = 0
    run_tiles = mc.build(2, F2_TILES)
    wide = run_tiles(seed, snr, 0)
    torch.cuda.synchronize()
    tiles_launches = mc.launch_count
    fast_tiles = min(65535, F2_TILES)     # the fast instance's grid y
    fast = mc.build(2, fast_tiles)(seed, snr, 0)
    torch.cuda.synchronize()
    folded_equal = bool(torch.equal(wide[:, :fast_tiles], fast))
    ends = (0, F2_TILES - 8)
    for t0 in ends:
        err = max(err, check_cells(
            f"f2_tiles_plain first_tile={t0}", wide[:, t0:t0 + 8],
            mc.prng_reference(2, 8, seed, amp, 0, first_tile=t0),
            cell_bits))
    plan = mc.kernel_plan(2, F2_TILES)
    want_launches = len(launch_slices(2)) * len(launch_slices(F2_TILES))
    phase("f2_tiles", reps=2, tiles=F2_TILES, tile=F2_TILE,
          launches=tiles_launches, plan=compact(plan),
          launch=compact(mc.launch_info(2, F2_TILES)),
          slices=compact(launch_slices(F2_TILES)),
          first_65535_tiles_equal_a_65535_tile_call=folded_equal,
          total_errors=int(wide.sum()))
    if not (not plan["general"] and tiles_launches == want_launches and
            folded_equal):
        raise AssertionError(f"f2 tiles: plan {plan}, {tiles_launches} "
                             f"launches (want {want_launches}), the first "
                             f"65,535 tiles equal {folded_equal}")

    def plain_reps():
        return torch.cat([mc.prng_reference(
            min(F2_PLAIN_SLICE, F2_REPS - r0), 1, seed, amp, r0)
            for r0 in range(0, F2_REPS, F2_PLAIN_SLICE)])

    def plain_tiles():
        return torch.cat([mc.prng_reference(
            2, min(F2_PLAIN_SLICE, F2_TILES - t0), seed, amp, 0,
            first_tile=t0)
            for t0 in range(0, F2_TILES, F2_PLAIN_SLICE)], dim=1)
    reps_ms = best_ms(lambda: run_reps(seed, snr, 0), inner=3)
    tiles_ms = best_ms(lambda: run_tiles(seed, snr, 0), inner=3)
    reps_plain = plain_reps()
    reps_plain_ms = once_ms(plain_reps)
    tiles_plain = plain_tiles()
    tiles_plain_ms = once_ms(plain_tiles)
    torch.cuda.synchronize()
    # every count against the plain version, summed into cells of the
    # flagship's size (F2_CELL symbols of 8-symbol tiles or reps): a cell of
    # one 8-symbol tile allows fewer than 2 flips, which 140,000 such cells
    # pass only by chance at the rate the flagship's cells show
    group = F2_CELL // F2_TILE
    err = max(err, check_cells("f2_reps_all_plain",
                               big.reshape(-1, group).sum(1),
                               reps_plain.reshape(-1, group).sum(1),
                               group * cell_bits),
              check_cells("f2_tiles_all_plain",
                          wide.reshape(2, -1, group).sum(2),
                          tiles_plain.reshape(2, -1, group).sum(2),
                          group * cell_bits))
    entries = [
        shape_mc_entry("mc_ofdm_tdl_prng_reps70000", mc, reps_launches, err,
                       reps_ms, reps_plain_ms, F2_REPS, 1),
        shape_mc_entry("mc_ofdm_tdl_general_prng_tiles70000", mc,
                       tiles_launches, err, tiles_ms, tiles_plain_ms, 2,
                       F2_TILES)]
    for entry, shape in zip(entries, (f"reps={F2_REPS},tiles=1",
                                      f"reps=2,tiles={F2_TILES}")):
        phase("f2_times", card=repr(smi), kernel=entry["name"],
              shape=f"{shape},tile={F2_TILE},used={mc.used}",
              kernel_ms=entry["ms"], plain_ms=entry["plain_ms"],
              bound_ms=entry["bound_ms"], bound_by=entry["bound_by"],
              share_of_bound=entry["share_of_bound"],
              listing_bound_ms=entry["listing_bound_ms"],
              fewest_bound_ms=entry["fewest_bound_ms"],
              ref_bound_ms=entry["ref_bound_ms"], form=entry["form"],
              launch=compact(entry["launch"]),
              sass_per_thread=entry["sass_per_thread"])
    return entries


def b_route(dev, smi, name, kind, bandwidth, block, attempts, blocks):
    """Phase 63 / 64 at one shape: ``TdlChannel.corrupt_data(...,
    block_size=block)`` of ``attempts`` Jakes states over ``blocks``
    blocks (one block_fir launch), and for the 81-tap profile the 2x2
    ``TdlMimoChannel`` route at the same rows (another); block_fir held
    to its plain version at the route's rows and the route to the FFT
    route; then block_fir's time at those rows beside its bound, its
    plain version, one grouped ``conv1d`` and the FFT route. Returns the
    ``kernels`` entry."""
    import torch
    from pyphysim_tpu_torch.channels import (JakesSampleGenerator,
                                             TdlChannel, TdlMimoChannel,
                                             fading)
    from pyphysim_tpu_torch.ops import fir
    from pyphysim_tpu_torch.ops.streams import AttemptStreams
    from pyphysim_tpu_torch.utils.misc import randn_c
    ts = 1 / bandwidth
    profile = shape_profile(kind, bandwidth)
    launches, err, rows_seen = 0, 0.0, None
    routes = [("siso", None)] + ([("mimo", (2, 2))]
                                 if kind == "exponential" else [])
    for route, shape in routes:
        gen = JakesSampleGenerator(30.0, ts, 16, shape=shape, device=dev)
        ch = (TdlMimoChannel(gen, profile) if shape
              else TdlChannel(gen, profile))
        n = attempts if shape is None else attempts // 4
        s_state, s_x = AttemptStreams.from_range(71, 0, n, dev).split(2)
        x = (randn_c(s_x, blocks * block) if shape is None
             else randn_c(s_x, shape[1], blocks * block))
        state = ch.init_state(s_state)
        fir.block_fir.launch_count = 0
        fir.block_fir.reference_count = 0
        y, ir_block, _ = ch.corrupt_data(state, x, block_size=block)
        torch.cuda.synchronize()
        n_launch = fir.block_fir.launch_count
        check_launches(f"b_route {name} {route}", n_launch, 1,
                       fir.block_fir.reference_count)
        launches += n_launch
        taps = ir_block.tap_values_sparse
        if shape is None:
            x_rows = x.reshape(-1, block)
            t_rows = taps.movedim(-2, -1).reshape(-1, taps.shape[-2])
        else:
            x_rows, t_rows = mimo_rows(ir_block, x, block)
        offsets = [int(d) for d in ir_block.tap_indexes_sparse]
        got = fir.block_fir(x_rows, t_rows, offsets, block)
        ref = fir.block_fir_reference(x_rows, t_rows, offsets, block)
        rel = rel_diff(got, ref)
        saved = fading.BLOCK_CONV_IMPL
        fading.BLOCK_CONV_IMPL = "fft"
        try:
            y_fft = (fading.tdl_filter_block_fft(ir_block, x, block)
                     if shape is None else
                     fading.tdl_filter_block_fft_mimo(ir_block, x, block))
        finally:
            fading.BLOCK_CONV_IMPL = saved
        fft_rel = rel_diff(y, y_fft)
        plan = fir.kernel_plan(x_rows.shape[0], block, tuple(offsets))
        phase("b_route", shape=name, route=route, taps=len(offsets),
              span=offsets[-1] + 1, block_size=block,
              rows=x_rows.shape[0], out=tuple(y.shape),
              block_fir_launches=n_launch, form=plan["form"],
              dense=plan["dense"], warps=plan["warps"],
              stages=plan["stages"], rows_per_item=plan["rows_per_item"],
              segment=plan["segment"], segments=plan["segments"],
              items=plan["items"], blocks=plan["blocks"],
              smem_bytes=plan["smem_bytes"],
              launch=compact(fir.launch_info(x_rows.shape[0], block,
                                             tuple(offsets))),
              kernel_vs_plain_rel=rel,
              fir_limit=FIR_REL_TOL, route_vs_fft_route_rel=fft_rel,
              route_limit=MIMO_REL_TOL)
        if not (rel <= FIR_REL_TOL and fft_rel <= MIMO_REL_TOL):
            raise AssertionError(f"b_route {name} {route}: block_fir "
                                 f"{rel}, route against FFT {fft_rel}")
        err = max(err, float((got - ref).abs().max()))
        if rows_seen is None:
            rows_seen = (x_rows, t_rows, offsets)

    x_rows, t_rows, offsets = rows_seen
    rows = x_rows.shape[0]
    args = (x_rows, t_rows, offsets, block)
    ms = graph_ms(lambda: fir.block_fir(*args))
    wrapper_ms = best_ms(lambda: fir.block_fir(*args), inner=10)
    plain_ms = best_ms(lambda: fir.block_fir_reference(*args))
    fft_ms = best_ms(lambda: fir.block_fir_fft(*args), inner=10)
    span = offsets[-1] + 1
    dense = torch.zeros(rows, span, dtype=torch.complex64, device=dev)
    dense[:, offsets] = t_rows
    weight = dense.flip(-1)[:, None, :].contiguous()

    def conv1d():
        return torch.nn.functional.conv1d(x_rows[None], weight,
                                          padding=span - 1, groups=rows)[0]
    y = fir.block_fir(*args)
    conv_rel = rel_diff(conv1d(), y)
    conv_ms = best_ms(conv1d, inner=3)
    nbytes = fir_bytes(rows, block, offsets)
    flops = 8 * rows * block * len(offsets)
    bound, bound_by = bound_ms(nbytes=nbytes, flops=flops)
    plan = fir.kernel_plan(rows, block, tuple(offsets))
    phase("b_times", card=repr(smi), shape=name, rows=rows, block_size=block,
          taps=len(offsets), span=span, form=plan["form"],
          dense=plan["dense"], launch=compact(fir.launch_info(
              rows, block, tuple(offsets))), kernel_ms=ms,
          wrapper_ms=wrapper_ms, bound_ms=bound, bound_by=bound_by,
          byte_bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
          flop_bound_ms=flops / F32_FLOP_PER_S * 1e3,
          share_of_bound=bound / ms, plain_ms=plain_ms, conv1d_ms=conv_ms,
          conv1d_rel_diff=conv_rel, fft_route_ms=fft_ms, launches=launches)
    return {"name": f"block_fir_{name}", "route": "cuda",
            "source": "pyphysim_tpu_torch/ops/csrc/block_fir.cu",
            "replaces": "pyphysim_tpu/ops/fir_pallas.py:52",
            "launches": launches, "max_abs_err": err, "ms": ms,
            "timed_by": "graph_replay", "wrapper_ms": wrapper_ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
            "library_ms": conv_ms, "fft_route_ms": fft_ms,
            "form": plan["form"]}


def b_direct(dev, smi):
    """Phase 64b: block_fir's direct form, which this PR leaves as it is,
    timed once at ``FIR_DIRECT_SHAPE`` beside its bound and held to its
    plain version."""
    import torch
    from pyphysim_tpu_torch.ops import fir
    rows, block, offsets = FIR_DIRECT_SHAPE
    plan = fir.kernel_plan(rows, block, offsets)
    if plan["form"] != "direct":
        raise AssertionError(f"b_direct: {plan['form']} form")
    x, taps, offsets, block = fir_inputs(dev, rows, block_size=block,
                                         offsets=offsets)
    got = fir.block_fir(x, taps, offsets, block)
    want = fir.block_fir_reference(x, taps, offsets, block)
    rel = rel_diff(got, want)
    torch.cuda.synchronize()
    ms = graph_ms(lambda: fir.block_fir(x, taps, offsets, block))
    nbytes = fir_bytes(rows, block, offsets)
    flops = 8 * rows * block * len(offsets)
    bound, bound_by = bound_ms(nbytes=nbytes, flops=flops)
    phase("b_direct_times", card=repr(smi), rows=rows, block_size=block,
          taps=len(offsets), span=offsets[-1] + 1, form=plan["form"],
          blocks=plan["blocks"], launch=compact(fir.launch_info(
              rows, block, offsets)), kernel_ms=ms, bound_ms=bound,
          bound_by=bound_by, share_of_bound=bound / ms,
          kernel_vs_plain_rel=rel, fir_limit=FIR_REL_TOL)
    if not rel <= FIR_REL_TOL:
        raise AssertionError(f"b_direct: block_fir {rel}")


def shape_phases(dev, smi):
    """Phases 61-64: the flagship kernel and block_fir past their first
    forms (F1 in each product type, F2, then B1 and B2 through the
    channels' block routes). Returns their ``kernels`` entries."""
    start_time = time.perf_counter()
    entries = [f1_phases(dev, smi, dtype) for dtype in MC_DTYPES]
    entries += f2_phases(dev, smi)
    entries += [b_route(dev, smi, *shape) for shape in FIR_SHAPES]
    b_direct(dev, smi)
    phase("shape_seconds", phases_61_to_64=time.perf_counter() - start_time)
    return entries


def comp_bd_runner(dev, metrics, rep_max, batch, config=None,
                   engine="device"):
    """``BDSimulationRunner`` at bench.py's point: SNR 20 dB, Pe 10 dBm,
    random drops."""
    import numpy as np
    from apps.comp_BD.simulate_comp_torch import BDSimulationRunner
    r = BDSimulationRunner(read_command_line_args=False, engine=engine,
                           metrics=metrics, device=dev,
                           default_config_file=config)
    r.params.add("SNR", np.array([20.0]))
    r.params.add("Pe_dBm", np.array([10.0]))
    r.params.add("user_positioning_method", "Random")
    r.rep_max, r.batch_size = rep_max, batch
    r.update_progress_function_style = None
    return r


def comp_bd_sers(runner):
    return {m: float(runner.results.get_result_values_list(f"ser_{m}")[0])
            for m in runner.metrics}


def comp_bd_solver_parity(dev):
    """Phase 27: the main path's own draws (the first chunk of 4,096
    attempts of the bench point) through the fill against its plain
    version (:func:`fill_draws_parity`: the channel, ext-int channel,
    ext-int signal and noise normals, and the data symbols' bits under the
    mask M - 1), then ``enhanced_bd_batched`` (every metric) and
    ``whitening_bd_batched`` on them, on the card against the same
    functions on the CPU. Returns the fill's largest |kernel - plain|.

    Stream counts may flip on near ties of the candidates' metric, and
    validity masks differ as rarely (each at most COMP_BD_FLIP_LIMIT). The
    users' rows differ by up to ~50 dB here, so float32 rounding moves the
    SINRs of ill-conditioned draws by per cents on any backend: each
    backend's float32 result is held to a float64 run of the same
    algorithm (on the CPU): the card's error may exceed ``max(
    COMP_BD_SINR_RTOL, 4 x the CPU's)`` on at most COMP_BD_FLIP_LIMIT
    draws, and its 99.9th percentile and largest error over the draws may
    be at most twice the CPU's (or COMP_BD_SINR_RTOL). For whitening the
    quantity is each user's effective channel after its filter, ``W_k H_k
    Ms_k`` (the identity, but for the streams the 6x6 pseudo-inverse
    drops at or below 1e-3 of the draw's largest singular value, as in the
    JAX package)."""
    import torch
    from apps.comp_BD.simulate_comp_torch import _solver_cases
    from pyphysim_tpu_torch.comm.batched import (enhanced_bd_batched,
                                                 whitening_bd_batched)
    r = comp_bd_runner(dev, None, 1, 1)
    p = r.params.get_unpacked_params_list()[0]
    c = r._point(p)
    draws = {}
    fills = recorded_draws(lambda: draws.update(
        r._draw(p, c, 0, COMP_BD_SOLVER_DRAWS)))
    full = 0xFFFFFFFF
    layout = [("normal", full), ("normal", full), ("bits", c["M"] - 1),
              ("normal", full), ("normal", full)]
    if [(kind, mask) for kind, _, _, mask in fills] != layout:
        raise AssertionError(f"comp_bd: the draws of a chunk are {fills}, "
                             f"expected {layout}")
    fill_err = fill_draws_parity("comp_bd", fills)
    H, R, K, pt = draws["H"], draws["R"], c["K"], c["pt"]
    Hc, Rc = H.cpu(), R.cpu()
    H64, R64 = Hc.to(torch.complex128), Rc.to(torch.complex128)

    def rel_err(x, ref):
        """Per draw: the largest |x - ref| / |ref| (elementwise)."""
        d = (x - ref).abs() / ref.abs().clamp(min=1e-30)
        return d.flatten(1).amax(dim=-1)

    def check(name, flips, bad_valid, card_err, cpu_err, **fields):
        over = card_err > torch.clamp(4 * cpu_err, min=COMP_BD_SINR_RTOL)
        phase("comp_bd_solvers", solver=name, draws=COMP_BD_SOLVER_DRAWS,
              ns_flips=flips, valid_mismatches=bad_valid,
              card_max_err=float(card_err.max()),
              cpu_max_err=float(cpu_err.max()),
              card_p999_err=float(card_err.quantile(0.999)),
              cpu_p999_err=float(cpu_err.quantile(0.999)),
              draws_over=int(over.sum()), **fields)
        worse = [float(card_err.quantile(q)) >
                 max(COMP_BD_SINR_RTOL, 2 * float(cpu_err.quantile(q)))
                 for q in (0.999, 1.0)]
        if flips > COMP_BD_FLIP_LIMIT or bad_valid > COMP_BD_FLIP_LIMIT \
                or int(over.sum()) > COMP_BD_FLIP_LIMIT or any(worse):
            raise AssertionError(f"comp_bd_solvers {name}: the card's "
                                 "float32 error exceeds the CPU's")

    for name, metric, kw in _solver_cases(r.metrics, r.modulator, c["L"]):
        g = [x.cpu() for x in enhanced_bd_batched(H, R, K, pt,
                                                  metric=metric, **kw)]
        w = enhanced_bd_batched(Hc, Rc, K, pt, metric=metric, **kw)
        e = enhanced_bd_batched(H64, R64, K, pt, metric=metric, **kw)
        flips = (g[2] != w[2]).any(dim=-1)
        ok = g[4] & w[4] & ~flips & (g[2] == e[2]).all(dim=-1)
        check(f"enhanced_bd_batched {name}", int(flips.sum()),
              int((g[4] != w[4]).sum()), rel_err(g[3], e[3])[ok],
              rel_err(w[3], e[3])[ok], valid=int(w[4].sum()),
              what="per-stream SINR")

    def effective(out):
        nr = c["nr"]
        h = H64.to(out[0].dtype)
        return torch.stack([out[1][:, k] @ h[:, k * nr:(k + 1) * nr, :] @
                            out[0][:, k] for k in range(K)], dim=1)

    g = [x.cpu() for x in whitening_bd_batched(H, R, K, pt)]
    w = whitening_bd_batched(Hc, Rc, K, pt)
    e = whitening_bd_batched(H64, R64, K, pt)
    eff = [effective(out) for out in (g, w, e)]
    kept = [torch.diagonal(x, dim1=-2, dim2=-1).real.round() for x in eff]
    flips = (kept[0] != kept[1]).flatten(1).any(dim=-1)
    ok = g[2] & w[2] & ~flips & (kept[0] == kept[2]).flatten(1).all(-1)

    def abs_err(x):
        return (x.to(torch.complex128) - eff[2]).abs().flatten(1).amax(-1)

    check("whitening_bd_batched", int(flips.sum()),
          int((g[2] != w[2]).sum()), abs_err(eff[0])[ok],
          abs_err(eff[1])[ok], valid=int(w[2].sum()),
          dropped_streams=int((kept[1] == 0).sum()),
          what="W_k H_k Ms_k, absolute")
    return fill_err


def comp_bd_phases(dev, smi):
    """Phases 27-31: the comp_BD scenario (``apps/comp_BD/
    simulate_comp_torch.py``), whose path reaches no TPU kernel: its
    batched solvers on the card against the CPU, bench.py's stage at full
    width through the runner's bulk path (its draws through the
    ``philox_stream_fill`` kernel: five launches a chunk), chunk
    invariance, every metric and the non-square file at reduced reps, the
    host engine, and the stage's times. Returns the fill's largest
    |kernel - plain| on the path's draws (phase 27)."""
    import os

    import numpy as np
    import torch
    from apps.comp_BD.simulate_comp_torch import CONFIG_DIR
    from pyphysim_tpu_torch.ops.streams import philox_draw
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "bin"))
    from profile_chain_torch import host_ms, kernels, trace

    # 27. the fill at the path's draws, and the batched solvers on the card
    # against the CPU
    fill_err = comp_bd_solver_parity(dev)

    # 28. bench.py's stage: a warm-up chunk, then 16,384 reps timed
    comp_bd_runner(dev, COMP_BD_METRICS, COMP_BD_CHUNK,
                   COMP_BD_CHUNK).simulate()
    runner = comp_bd_runner(dev, COMP_BD_METRICS, COMP_BD_REPS,
                            COMP_BD_CHUNK)
    philox_draw.launch_count = 0
    philox_draw.reference_count = 0
    torch.cuda.synchronize()
    tic = time.perf_counter()
    runner.simulate()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - tic
    fills, plain = philox_draw.launch_count, philox_draw.reference_count
    sers = comp_bd_sers(runner)
    skipped = runner.results.get_result_values_list("num_skipped_reps")
    phase("comp_bd_path", snr_db=20.0, pe_dbm=10.0,
          ser=compact(sers), runned_reps=runner.runned_reps,
          skipped=skipped, chunks=runner.chunks_dispatched,
          seconds=seconds, reps_per_s=COMP_BD_REPS / seconds,
          philox_stream_fill_launches=fills, plain_draws=plain)
    check_range("comp_bd ser_capacity", sers["capacity"],
                COMP_BD_SER_CAPACITY)
    check_range("comp_bd ser_None", sers["None"], COMP_BD_SER_NONE)
    if not sers["capacity"] < sers["None"]:
        raise AssertionError(f"comp_bd: ser_capacity not below ser_None "
                             f"{sers}")
    # five draws a chunk (channels, ext-int channels, data, ext-int
    # signal, noise), each one launch of the fill kernel
    check_launches("comp_bd philox_stream_fill", fills,
                   5 * runner.chunks_dispatched, plain)

    # 29. chunk invariance: attempts 4..7 alone and inside a chunk of 8
    r = comp_bd_runner(dev, None, 8, 8)
    bulk = r._gen_bulk_kernel(r.params.get_unpacked_params_list()[0])
    whole, part = bulk(0, 8), bulk(4, 4)
    exact, worst = True, 0.0
    for name in sorted(whole):
        a, b = (v[0] if isinstance(v, tuple) else v
                for v in (whole[name], part[name]))
        a = a[4:]
        if a.dtype in (torch.bool, torch.int64):
            if not torch.equal(a, b):
                raise AssertionError(f"comp_bd chunk invariance: {name}")
        else:
            exact = exact and bool(torch.equal(a, b))
            worst = max(worst, float(((a - b).abs() /
                                      b.abs().clamp(min=1e-30)).max()))
    phase("comp_bd_chunk_invariance", counts_and_masks_equal=True,
          floats_bitwise_equal=exact, max_rel_float_diff=worst)
    if worst > COMP_BD_SINR_RTOL:
        raise AssertionError("comp_bd chunk invariance: floats differ")

    # 30. every metric (bench point) and the non-square file, reduced reps;
    # the host engine for a few repetitions on the card
    for config in ("bd_config_file.txt", "bd_config_file_nonsquare.txt"):
        r = comp_bd_runner(dev, None, COMP_BD_SMALL_REPS,
                           COMP_BD_SMALL_REPS,
                           config=os.path.join(CONFIG_DIR, config))
        r.simulate()
        sers = comp_bd_sers(r)
        sinr = {m: float(r.results.get_result_values_list(f"sinr_{m}")[0])
                for m in r.metrics}
        phase("comp_bd_metrics", config=config,
              nr_nt=f"{r.params['Nr']}x{r.params['Nt']}",
              runned_reps=r.runned_reps, ser=compact(sers),
              mean_sinr=compact(sinr))
        if not all(0.0 <= v < 1.0 for v in sers.values()) or \
                not all(np.isfinite(v) and v > 0 for v in sinr.values()):
            raise AssertionError(f"comp_bd metrics {config}: {sers} {sinr}")
        if not sers["capacity"] < sers["None"]:
            raise AssertionError(f"comp_bd metrics {config}: capacity "
                                 f"not below None {sers}")
    host = comp_bd_runner(dev, None, 8, 8, engine="host")
    host.simulate()
    sers = comp_bd_sers(host)
    phase("comp_bd_host_engine", runned_reps=host.runned_reps,
          ser=compact(sers))
    if not all(np.isfinite(v) for v in sers.values()):
        raise AssertionError(f"comp_bd host engine: {sers}")

    # 31. times: the stage's reps/s (phase 28), host ms a chunk (drops and
    # path loss for 4,096 attempts), and one chunk's kernels and device
    # busy share from a profiler trace
    p = runner.params.get_unpacked_params_list()[0]
    drops_ms = host_ms(lambda: runner._scenario_pathloss(
        p, 0, COMP_BD_CHUNK), repeat=5)
    bulk = runner._gen_bulk_kernel(p)
    chunk_ms = best_ms(lambda: bulk(0, COMP_BD_CHUNK))
    events, wall_us = trace(lambda: bulk(0, COMP_BD_CHUNK), repeat=1)
    device_ms = sum(t for _, t, _ in events) / 1e3
    top = sorted((round(t / 1e3, 3), n, key[:60])
                 for key, t, n in events if t > 0)[::-1][:6]
    phase("comp_bd_times", card=repr(smi), chunk=COMP_BD_CHUNK,
          metrics=",".join(COMP_BD_METRICS),
          reps_per_s=COMP_BD_REPS / seconds, stage_seconds=seconds,
          host_drops_ms_a_chunk=drops_ms, chunk_ms=chunk_ms,
          kernels_a_chunk=kernels(events, repeat=1),
          device_ms_a_chunk=device_ms, traced_chunk_wall_ms=wall_us / 1e3,
          device_busy_share=device_ms * 1e3 / wall_us,
          busy_share_of_untraced_chunk=device_ms / chunk_ms,
          top_device_kernels=compact(top))
    return fill_err



def mimo_inputs(dev, nr, nt, switched=False, seed=61):
    """A MIMO channel at the smoke's geometry, its attempts' Jakes states
    and random signals (the transmitting side's antennas, each
    ``MIMO_BLOCKS`` blocks of ``MIMO_BLOCK`` samples)."""
    from pyphysim_tpu_torch.channels import (COST259_TUx,
                                             JakesSampleGenerator,
                                             TdlMimoChannel)
    from pyphysim_tpu_torch.ops.streams import AttemptStreams
    from pyphysim_tpu_torch.utils.misc import randn_c
    ch = TdlMimoChannel(JakesSampleGenerator(30.0, 1 / 20e6, 16,
                                             shape=(nr, nt), device=dev),
                        COST259_TUx)
    ch.switched_direction = switched
    s_state, s_x = AttemptStreams.from_range(seed, 0, MIMO_ATTEMPTS,
                                             dev).split(2)
    x = randn_c(s_x, nr if switched else nt, MIMO_BLOCKS * MIMO_BLOCK)
    return ch, ch.init_state(s_state), x


def mimo_rows(ir_block, x, block=MIMO_BLOCK):
    """The (x rows, tap rows) the MIMO kernel route hands to block_fir:
    every (r, t) pair's blocks, the signal repeated for each r."""
    taps = ir_block.tap_values_sparse                # (n, T, Nr, Nt, nb)
    n, T, nr, nt, nb = taps.shape
    x_rows = x.reshape(n, 1, nt, nb, block).expand(
        n, nr, nt, nb, block).reshape(-1, block)
    return x_rows, taps.movedim(1, -1).reshape(-1, T)


def rel_diff(a, b):
    return float((a - b).abs().max() / b.abs().max())


def mimo_route(dev, name, nr, nt, switched=False):
    """One MIMO block-static run through ``TdlMimoChannel.corrupt_data``
    (the kernel route), held to block_fir's plain version at its rows, to
    the FFT route and to per-sample filtering with block-constant taps.
    Returns (block_fir launches, |kernel - plain|, the route's rows)."""
    import torch
    from pyphysim_tpu_torch.channels import TdlImpulseResponse, fading
    from pyphysim_tpu_torch.ops import fir
    ch, state, x = mimo_inputs(dev, nr, nt, switched)
    fir.block_fir.launch_count = 0
    fir.block_fir.reference_count = 0
    y, ir_block, _ = ch.corrupt_data(state, x, block_size=MIMO_BLOCK)
    torch.cuda.synchronize()
    launches = fir.block_fir.launch_count
    plain_calls = fir.block_fir.reference_count
    check_launches(f"{name} block_fir", launches, 1, plain_calls)
    ir_use = ir_block.transposed() if switched else ir_block
    x_rows, t_rows = mimo_rows(ir_use, x)
    offsets = ir_block.tap_indexes_sparse
    got = fir.block_fir(x_rows, t_rows, offsets, MIMO_BLOCK)
    ref = fir.block_fir_reference(x_rows, t_rows, offsets, MIMO_BLOCK)
    fir_err = float((got - ref).abs().max())
    fir_rel = rel_diff(got, ref)
    saved = fading.BLOCK_CONV_IMPL
    fading.BLOCK_CONV_IMPL = "fft"
    try:
        y_fft = fading.tdl_filter_block_fft_mimo(ir_use, x, MIMO_BLOCK)
    finally:
        fading.BLOCK_CONV_IMPL = saved
    per_sample = TdlImpulseResponse(
        ir_use.tap_values_sparse.repeat_interleave(MIMO_BLOCK, dim=-1),
        ir_block.channel_profile, True)
    y_ps = fading.tdl_filter(per_sample, x)
    fft_rel, ps_rel = rel_diff(y, y_fft), rel_diff(y, y_ps)
    phase(name, attempts=MIMO_ATTEMPTS, nr_nt=f"{nr}x{nt}",
          switched_direction=switched, blocks=MIMO_BLOCKS,
          block_size=MIMO_BLOCK, rows=x_rows.shape[0], out=tuple(y.shape),
          block_fir_launches=launches, block_fir_plain_calls=plain_calls,
          kernel_vs_plain_rel=fir_rel, fir_limit=FIR_REL_TOL,
          kernel_route_vs_fft_route_rel=fft_rel,
          kernel_route_vs_per_sample_rel=ps_rel, route_limit=MIMO_REL_TOL)
    if not fir_rel <= FIR_REL_TOL:
        raise AssertionError(f"{name}: block_fir disagrees with its plain "
                             f"version at the MIMO rows: {fir_rel}")
    if not (fft_rel <= MIMO_REL_TOL and ps_rel <= MIMO_REL_TOL):
        raise AssertionError(f"{name}: the kernel route disagrees with the "
                             f"FFT route ({fft_rel}) or per-sample "
                             f"filtering ({ps_rel})")
    return launches, fir_err, x_rows.shape[0]


def mu_runner(dev, pathloss):
    """The K = 3 interference sweep's runner (``MU_REPS`` attempts in
    chunks of ``MU_CHUNK``)."""
    from apps.mimo.mu_mimo_interference_torch import \
        MuMimoInterferenceRunner
    r = MuMimoInterferenceRunner(pathloss=pathloss, device=dev,
                                 read_command_line_args=False)
    r.rep_max, r.batch_size = MU_REPS, MU_CHUNK
    return r


def mu_errors(runner, snr_db, start, n, dev):
    """Per-attempt symbol errors of attempts [start, start + n) at
    ``snr_db``, their streams on ``dev``."""
    from pyphysim_tpu_torch.ops.streams import AttemptStreams
    from pyphysim_tpu_torch.simulations import kernel_stream_seed
    idx = [float(v) for v in runner.params["SNR"]].index(snr_db)
    seed = kernel_stream_seed(runner.base_seed, idx)
    return runner.symbol_errors(AttemptStreams.from_range(seed, start, n,
                                                          dev),
                                10 ** (snr_db / 10)).cpu()


@contextlib.contextmanager
def scratch_dir(config_name, config_text):
    """A scratch folder holding one config file, the current directory
    while the block runs (the apps write their results there)."""
    here = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, config_name), "w") as f:
            f.write(config_text)
        os.chdir(tmp)
        try:
            yield
        finally:
            os.chdir(here)


def ia_app_runs(dev, draws_seed):
    """``simulate_ia_torch`` (closed form and Max-SINR) on ``dev``, its
    channels and noise from a seeded numpy stream, in a scratch folder."""
    import numpy as np
    from apps.ia import simulate_ia_torch as app
    rng = {}

    def setup(r):
        r.ia_solver.set_precoder_seed(11)
        r.update_progress_function_style = None
        g = rng.setdefault(type(r).__name__,
                           np.random.default_rng(draws_seed))
        r.channel_draws = lambda: tuple(
            ((g.standard_normal((6, n)) + 1j * g.standard_normal((6, n))) /
             np.sqrt(2)).astype(np.complex64) for n in (6, 100))

    with scratch_dir("ia_config_file.txt", IA_APP_CONFIG):
        return app.main_simulate(["Closed Form", "Max SINR"],
                                 "ia_config_file.txt",
                                 read_command_line_args=False, device=dev,
                                 setup=setup)


def greedy_app_run(dev):
    """``simulate_greedy_ia_torch`` once on ``dev``, in a scratch folder."""
    from apps.ia.simulate_greedy_ia_torch import IAStreamSelSimulationRunner
    with scratch_dir("greedy_config_file.txt", GREEDY_APP_CONFIG):
        r = IAStreamSelSimulationRunner("greedy_config_file.txt",
                                        read_command_line_args=False,
                                        device=dev)
        r.update_progress_function_style = None
        r.simulate()
        return r


def mimo_phases(dev, smi):
    """Phases 32-37: the MIMO block-static route through block_fir at
    64 attempts x 4x4 x 32 blocks of 564 (then 2x3 and the uplink), the
    K = 3 MuMimoChannel interference sweep and the LS / MMSE estimation
    sweep through the runner's per-key path, the SRS and IA apps on the
    card against the CPU, and their times. Returns what block_fir's and
    the fill's ``kernels`` entries gain."""
    import numpy as np
    import torch
    from apps import simple_precoded_srs_torch as srs_app
    from apps.channel_estimation_sweep_torch import EstimationSweepRunner
    from apps.mimo.mu_mimo_interference_torch import JAX_TEST_PATHLOSS
    from pyphysim_tpu_torch.channels import fading
    from pyphysim_tpu_torch.ops import fir
    from pyphysim_tpu_torch.ops.streams import AttemptStreams, philox_draw
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "bin"))
    from profile_chain_torch import kernels, trace
    start = time.perf_counter()

    # 32. the 4x4 route; 33. 2x3, and 2x3 on the uplink
    if fading.BLOCK_CONV_IMPL not in ("auto", "kernel"):
        raise AssertionError("the default block convolution is not the "
                             "kernel")
    launches, fir_err = 0, 0.0
    for name, nr, nt, switched in (("mimo_fir", 4, 4, False),
                                   ("mimo_fir_2x3", 2, 3, False),
                                   ("mimo_fir_2x3_uplink", 2, 3, True)):
        n, err, rows = mimo_route(dev, name, nr, nt, switched)
        launches += n
        fir_err = max(fir_err, err)

    # 34. the K = 3 interference sweep on the per-key path: the JAX test's
    # path losses, then equal power
    sers, fill_launches = {}, 0
    for case, pl in (("pathloss", JAX_TEST_PATHLOSS), ("equal", None)):
        runner = mu_runner(dev, pl)
        philox_draw.launch_count = 0
        philox_draw.reference_count = 0
        fir.block_fir.launch_count = 0
        torch.cuda.synchronize()
        tic = time.perf_counter()
        runner.simulate()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - tic
        fills, plain = philox_draw.launch_count, philox_draw.reference_count
        sers[case] = [float(v) for v in
                      runner.results.get_result_values_list("ser")]
        snrs = [float(v) for v in runner.results.params["SNR"]]
        # the card against the CPU route on the chunk of attempts 0..255
        flips = {}
        cpu = mu_runner("cpu", pl)
        for snr in snrs:
            a = mu_errors(runner, snr, 0, MU_CHUNK, dev)
            b = mu_errors(cpu, snr, 0, MU_CHUNK, "cpu")
            flips[snr] = int((a - b).abs().sum())
        # chunk invariance: attempts 256..511 alone and inside 0..511
        whole = mu_errors(runner, snrs[0], 0, 2 * MU_CHUNK, dev)
        part = mu_errors(runner, snrs[0], MU_CHUNK, MU_CHUNK, dev)
        invariant = bool(torch.equal(whole[MU_CHUNK:], part))
        symbols = MU_CHUNK * runner.symbols_per_attempt
        phase("mu_mimo_path", case=case, K=runner.K, snr_db=snrs,
              ser=sers[case], runned_reps=runner.runned_reps,
              chunks=runner.chunks_dispatched, seconds=seconds,
              attempts_per_s=len(snrs) * MU_REPS / seconds,
              fill_launches=fills, plain_draws=plain,
              block_fir_launches=fir.block_fir.launch_count,
              card_vs_cpu_flips=compact(flips),
              flip_limit=MU_FLIP_SHARE * symbols,
              chunk_invariant=invariant)
        check_launches(f"mu_mimo_path {case} fill", fills,
                       3 * runner.chunks_dispatched, plain)
        fill_launches += fills
        if max(flips.values()) > MU_FLIP_SHARE * symbols or not invariant:
            raise AssertionError(f"mu_mimo_path {case}: card vs CPU flips "
                                 f"{flips} or chunk invariance {invariant}")
    for ser in sers["equal"]:
        check_range("mu_mimo_path equal-power SER", ser, MU_SER_BAND)
    if not sers["pathloss"][-1] < sers["equal"][-1]:
        raise AssertionError(f"mu_mimo_path: the weaker interferers do not "
                             f"lower the SER {sers}")

    # 35. LS / MMSE through the per-key path (Nr 4, the comb-2 SRS pilots)
    est = EstimationSweepRunner(Nr=4, device=dev,
                                read_command_line_args=False)
    est.rep_max, est.batch_size = EST_REPS, EST_CHUNK
    philox_draw.launch_count = 0
    philox_draw.reference_count = 0
    torch.cuda.synchronize()
    tic = time.perf_counter()
    est.simulate()
    torch.cuda.synchronize()
    est_seconds = time.perf_counter() - tic
    fills, plain = philox_draw.launch_count, philox_draw.reference_count
    ls = [float(v) for v in est.results.get_result_values_list("ls_mse")]
    mm = [float(v) for v in est.results.get_result_values_list("mmse_mse")]
    npows = [float(v) for v in est.results.params["noise_power"]]
    theory = [est.theory(p) for p in npows]
    phase("estimation_path", Nr=est.Nr, pilots=est.num_pilots,
          noise_power=npows, realizations=EST_REPS, ls_mse=ls,
          ls_theory=[t[0] for t in theory], mmse_mse=mm,
          mmse_theory=[t[1] for t in theory], rel_limit=EST_REL_TOL,
          chunks=est.chunks_dispatched, fill_launches=fills,
          plain_draws=plain, seconds=est_seconds)
    check_launches("estimation_path fill", fills,
                   2 * est.chunks_dispatched, plain)
    fill_launches += fills
    for i, (t_ls, t_mm) in enumerate(theory):
        if not (abs(ls[i] / t_ls - 1) <= EST_REL_TOL and
                abs(mm[i] / t_mm - 1) <= EST_REL_TOL):
            raise AssertionError(f"estimation_path: MSE off its theory at "
                                 f"noise {npows[i]}: {ls[i]} vs {t_ls}, "
                                 f"{mm[i]} vs {t_mm}")
    if not mm[1] < ls[1]:
        raise AssertionError("estimation_path: MMSE not below LS at 1.0")

    # 36. the SRS app and the IA apps on the card against the CPU
    gen = torch.Generator().manual_seed(3)
    state = srs_app.channel("cpu").init_state(gen, (3, 3))
    on_card = srs_app.run(dev, type(state)(*(v.to(dev) for v in state)))
    on_cpu = srs_app.run("cpu", state)
    srs_diff = max(abs(a - b) for k in on_cpu
                   for a, b in zip(on_card[k], on_cpu[k]))
    phase("srs_app", links=len(on_card), max_mse_diff_db=srs_diff,
          limit_db=0.05,
          mse_db=compact({f"{an}{ue}": [round(v, 3) for v in on_card[an, ue]]
                          for an, ue in on_card}))
    if not srs_diff <= 0.05:
        raise AssertionError(f"srs_app: card vs CPU {srs_diff} dB")
    card_runs, cpu_runs = ia_app_runs(dev, 5), ia_app_runs("cpu", 5)
    for a, b in zip(card_runs, cpu_runs):
        caps = [np.array(r.results.get_result_values_list("sum_capacity"),
                         float) for r in (a, b)]
        bers = [np.array(r.results.get_result_values_list("ber"), float)
                for r in (a, b)]
        cap_rel = float(np.max(np.abs(caps[0] / caps[1] - 1)))
        ber_diff = float(np.max(np.abs(bers[0] - bers[1])))
        phase("ia_app", runner=type(a).__name__, runned_reps=a.runned_reps,
              sum_capacity=caps[0].tolist(), ber=bers[0].tolist(),
              card_vs_cpu_capacity_rel=cap_rel, card_vs_cpu_ber=ber_diff)
        if not (cap_rel <= 1e-4 and ber_diff <= 2e-3):
            raise AssertionError(f"ia_app {type(a).__name__}: card vs CPU "
                                 f"capacity {cap_rel}, BER {ber_diff}")
    greedy = greedy_app_run(dev)
    g_caps = [float(v) for v in
              greedy.results.get_result_values_list("sum_capacity")]
    g_bers = [float(v) for v in greedy.results.get_result_values_list("ber")]
    phase("greedy_ia_app", runned_reps=greedy.runned_reps,
          sum_capacity=g_caps, ber=g_bers)
    if not all(np.isfinite(g_caps + g_bers)) or min(g_caps) <= 0:
        raise AssertionError(f"greedy_ia_app: {g_caps} {g_bers}")

    # 37. times: block_fir and both routes at the MIMO geometry; the
    # interference sweep's chunk (draws and forward apart, busy share);
    # the estimation sweep's realizations per second
    ch, state, x = mimo_inputs(dev, 4, 4)
    ir_block, _ = ch._generate_strided_impulse_response(state, MIMO_BLOCKS,
                                                        MIMO_BLOCK)
    x_rows, t_rows = mimo_rows(ir_block, x)
    offsets = [int(d) for d in ir_block.tap_indexes_sparse]
    rows = x_rows.shape[0]
    args = (x_rows, t_rows, offsets, MIMO_BLOCK)
    fir_ms = graph_ms(lambda: fir.block_fir(*args))
    plain_ms = best_ms(lambda: fir.block_fir_reference(*args))
    fft_rows_ms = best_ms(lambda: fir.block_fir_fft(*args), inner=10)
    fir_nbytes = fir_bytes(rows, MIMO_BLOCK, offsets)
    fir_bound, fir_bound_by = bound_ms(
        nbytes=fir_nbytes, flops=8 * rows * MIMO_BLOCK * len(offsets))
    span = offsets[-1] + 1
    dense = torch.zeros(rows, span, dtype=torch.complex64, device=dev)
    dense[:, offsets] = t_rows
    weight = dense.flip(-1)[:, None, :].contiguous()

    def conv1d():
        return torch.nn.functional.conv1d(x_rows[None], weight,
                                          padding=span - 1, groups=rows)[0]
    conv_ms = best_ms(conv1d, inner=3)
    routes = {}
    for impl in ("kernel", "fft"):
        fading.BLOCK_CONV_IMPL = impl
        try:
            routes[impl] = best_ms(lambda: fading.tdl_filter_block_fft_mimo(
                ir_block, x, MIMO_BLOCK), inner=3)
        finally:
            fading.BLOCK_CONV_IMPL = "auto"
    runner = mu_runner(dev, JAX_TEST_PATHLOSS)
    streams = AttemptStreams.from_range(99, 0, MU_CHUNK, dev)
    snr, n_sym = 100.0, runner.symbols_per_attempt
    s_data, s_channel, s_noise = streams.split(3)
    mu_ms = best_ms(lambda: runner.symbol_errors(streams, snr))
    draws_ms = best_ms(lambda: (s_data.integers(4, (runner.K, n_sym)),
                                runner.mu.init_state(s_channel),
                                s_noise.normal((2, n_sym))))
    events, wall_us = trace(lambda: runner.symbol_errors(streams, snr),
                            repeat=3)
    device_ms = sum(t for _, t, _ in events) / 1e3 / 3
    phase("mimo_times", card=repr(smi), block_fir_rows=rows,
          block_fir_ms=fir_ms, block_fir_bound_ms=fir_bound,
          block_fir_bound_by=fir_bound_by,
          block_fir_share_of_bound=fir_bound / fir_ms,
          block_fir_bytes=fir_nbytes, block_fir_plain_ms=plain_ms,
          block_fir_fft_rows_ms=fft_rows_ms, block_fir_conv1d_ms=conv_ms,
          mimo_kernel_route_ms=routes["kernel"],
          mimo_fft_route_ms=routes["fft"],
          mu_chunk=MU_CHUNK, mu_chunk_ms=mu_ms, mu_draws_ms=draws_ms,
          mu_forward_ms=mu_ms - draws_ms, mu_device_ms=device_ms,
          mu_kernels_a_chunk=kernels(events, repeat=3),
          mu_device_busy_share=device_ms * 3e3 / wall_us,
          mu_attempts_per_s=MU_CHUNK / mu_ms * 1e3,
          estimation_realizations_per_s=len(npows) * EST_REPS / est_seconds,
          phases_32_to_37_seconds=time.perf_counter() - start)
    return {"launches": launches, "max_abs_err": fir_err,
            "fill_launches": fill_launches, "mimo_rows": rows,
            "mimo_ms": fir_ms, "mimo_bound_ms": fir_bound,
            "mimo_bound_by": fir_bound_by, "mimo_plain_ms": plain_ms,
            "mimo_library_ms": conv_ms, "mimo_fft_route_ms": routes["fft"],
            "mimo_kernel_route_ms": routes["kernel"]}


def fill_counts():
    """(fill launches, plain draws) of ``philox_draw`` since its counts
    were last set to 0."""
    from pyphysim_tpu_torch.ops.streams import philox_draw
    return philox_draw.launch_count, philox_draw.reference_count


def reset_fill_counts():
    from pyphysim_tpu_torch.ops.streams import philox_draw
    philox_draw.launch_count = 0
    philox_draw.reference_count = 0


def timed(fn):
    """``(fn(), seconds)`` on the host clock, the device synchronized on
    both sides."""
    import torch
    torch.cuda.synchronize()
    tic = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - tic


def device_ms(events, repeat):
    """Device time a call, in ms, of the kernels and copies among the
    ``trace`` events of ``repeat`` calls."""
    return sum(t for _, t, _ in events) / repeat / 1e3


def codebook_search(dev, smi, name, ctype, Nt, Ns, K, rep_max, batch):
    """One search of ``rep_max`` candidates on the card: its best distance
    against the float64 host distance, the Rankin simplex bound and the
    CPU route on the first ``CB_CPU_REPS`` candidates; its rate, its
    launches a batch and the device's busy time a batch. Returns the fill
    launches of the timed search."""
    from apps.find_codebook_torch import CodebookFinder
    from profile_chain_torch import kernels, trace

    def finder(device):
        return CodebookFinder(Nt, Ns, K, ctype, prng_seed=0, batch=batch,
                              device=device)

    tic = time.perf_counter()
    f = finder(dev)
    f.search(batch)                                   # warm-up
    f = finder(dev)
    reset_fill_counts()
    (best_d2, best_C), seconds = timed(lambda: f.search(rep_max))
    fills, plain = fill_counts()
    check_launches(f"{name} fill", fills, f.candidates_scored // batch,
                   plain)
    d = float(best_d2) ** 0.5
    host_d, _ = CodebookFinder.calc_min_chordal_dist(
        best_C.cpu().numpy().astype(complex))
    rankin = Ns * (Nt - Ns) / Nt * K / (K - 1)
    n = min(CB_CPU_REPS, rep_max)
    card_d2 = float(finder(dev).search(n)[0])
    cpu_d2 = float(finder("cpu").search(n)[0])
    events, _ = trace(lambda: finder(dev).search(batch), repeat=3)
    per_batch = kernels(events, repeat=3)
    busy_ms = device_ms(events, repeat=3)
    batch_ms = seconds * 1e3 * batch / f.candidates_scored
    phase("find_codebook", case=name, type=f.type, Nt=Nt, Ns=Ns, K=K,
          candidates=f.candidates_scored, batch=batch, best_dist=d,
          host_float64_dist=host_d, rankin_d2=rankin, best_d2=float(best_d2),
          cpu_candidates=n, card_vs_cpu_dist=abs(card_d2 ** 0.5 -
                                                  cpu_d2 ** 0.5),
          seconds=seconds, codebooks_per_s=f.candidates_scored / seconds,
          launches_a_batch=per_batch, ms_a_batch=batch_ms,
          device_busy_ms_a_batch=busy_ms,
          device_busy_share=busy_ms / batch_ms, fill_launches=fills,
          card=repr(smi),
          phase_seconds=time.perf_counter() - tic)
    if not abs(d - host_d) <= CB_HOST_TOL:
        raise AssertionError(f"find_codebook {name}: device {d} vs host "
                             f"{host_d}")
    if not 0.0 < float(best_d2) <= rankin + 1e-6:
        raise AssertionError(f"find_codebook {name}: d^2 {float(best_d2)} "
                             f"outside (0, {rankin}]")
    if not abs(card_d2 ** 0.5 - cpu_d2 ** 0.5) <= CB_CPU_TOL:
        raise AssertionError(f"find_codebook {name}: card {card_d2} vs CPU "
                             f"{cpu_d2}")
    return fills


def app_phases(dev, smi):
    """Phases 43-46: the codebook search, the quantized-CSI Max-SINR IA,
    the METIS scenario-2 drops and the IA feasibility solvers on the card
    against the CPU route on the same Philox draws, with their rates,
    launches and device-busy times. Returns the fill kernel's launches in
    the timed runs."""
    import numpy as np
    from apps.find_codebook_torch import COMPLEX, COMPLEX_QEGT, REAL
    from apps.ia import simple_maxsinr_quantized_torch as qia
    from apps.ia import test_ia_feasibility_torch as feas
    from apps.metis_scenarios import simulate_metis_scenario2_torch as metis
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "bin"))
    from profile_chain_torch import kernels, trace
    start = time.perf_counter()

    # 43. the codebook search: the CLI defaults, then G(4, 2) by type
    fill_launches = codebook_search(dev, smi, "defaults", COMPLEX,
                                    **CB_DEFAULT)
    for name, ctype in (("complex", COMPLEX), ("real", REAL),
                        ("qegt", COMPLEX_QEGT)):
        fill_launches += codebook_search(dev, smi, f"G(4,2) {name}", ctype,
                                         **CB_LARGE)

    # 44. quantized-CSI Max-SINR IA at the app's defaults
    tic = time.perf_counter()
    qia.run(**dict(QIA_ARGS, reps=8), device=dev)      # warm-up
    reset_fill_counts()
    (err_q, err_p, bits), seconds = timed(lambda: qia.run(**QIA_ARGS,
                                                          device=dev))
    fills, plain = fill_counts()
    # one fill a draw: codebook, channels, initial precoders, bits, noise
    check_launches("maxsinr_quantized fill", fills, 5, plain)
    fill_launches += fills
    cpu_q, cpu_p, _ = qia.run(**QIA_ARGS, device="cpu")
    flips = {"quantized": abs(int(err_q) - int(cpu_q)),
             "perfect": abs(int(err_p) - int(cpu_p))}
    ber_q, ber_p = int(err_q) / bits, int(err_p) / bits
    # launches and device time: a fixed part and a part an iteration, from
    # two short traced runs
    short = [trace(lambda: qia.run(**QIA_ARGS, iterations=n, device=dev),
                   repeat=1)[0] for n in (2, 4)]
    launches = [kernels(e, repeat=1) for e in short]
    busy = [device_ms(e, repeat=1) for e in short]
    per_iteration = (launches[1] - launches[0]) / 2
    busy_an_iteration = (busy[1] - busy[0]) / 2
    busy_a_run = busy[0] + (qia.ITERATIONS - 2) * busy_an_iteration
    phase("maxsinr_quantized", **QIA_ARGS, iterations=qia.ITERATIONS,
          ber_quantized=ber_q, ber_perfect=ber_p, bits=bits,
          card_vs_cpu_error_diff=compact(flips),
          flip_limit=QIA_FLIP_SHARE * bits, seconds=seconds,
          reps_per_s=QIA_ARGS["reps"] / seconds,
          launches_an_iteration=per_iteration,
          launches_a_run=launches[0] + (qia.ITERATIONS - 2) * per_iteration,
          device_busy_ms_an_iteration=busy_an_iteration,
          device_busy_ms_a_run=busy_a_run,
          device_busy_share=busy_a_run / (seconds * 1e3),
          fill_launches=fills, card=repr(smi),
          phase_seconds=time.perf_counter() - tic)
    if not (0.0 < ber_p <= ber_q < 0.5):
        raise AssertionError(f"maxsinr_quantized: BERs {ber_q}, {ber_p}")
    if max(flips.values()) > QIA_FLIP_SHARE * bits:
        raise AssertionError(f"maxsinr_quantized: card vs CPU {flips}")

    # 45. the METIS scenario-2 drops
    tic = time.perf_counter()
    for users, seed in METIS_DROPS:
        metis.simulate(num_users=users, seed=seed, device=dev)   # warm-up
        (sinr, cap, tx, aps), seconds = timed(lambda: metis.simulate(
            num_users=users, seed=seed, device=dev))
        events, _ = trace(lambda: metis.simulate(
            num_users=users, seed=seed, device=dev), repeat=1)
        busy_ms = device_ms(events, repeat=1)
        c_sinr, c_cap, c_tx, c_aps = metis.simulate(num_users=users,
                                                    seed=seed, device="cpu")
        lin = 10 ** (sinr.cpu().numpy() / 10)
        c_lin = 10 ** (c_sinr.numpy() / 10)
        sinr_rel = float(np.max(np.abs(lin / c_lin - 1)))
        cap_rel = float(np.max(np.abs(cap.cpu().numpy() / c_cap.numpy() - 1)))
        phase("metis_scenario2", users=users, seed=seed, aps=aps,
              transmitting_aps=tx, cpu_transmitting_aps=c_tx,
              sinr_db_mean=float(sinr.mean()), capacity_mean=float(cap.mean()),
              card_vs_cpu_sinr_rel=sinr_rel, card_vs_cpu_capacity_rel=cap_rel,
              ms_a_drop=seconds * 1e3, users_per_s=users / seconds,
              launches_a_drop=kernels(events, repeat=1),
              device_busy_ms_a_drop=busy_ms,
              device_busy_share=busy_ms / (seconds * 1e3),
              card=repr(smi), phase_seconds=time.perf_counter() - tic)
        if (tx, aps) != (c_tx, c_aps) or not (sinr_rel <= METIS_RTOL and
                                               cap_rel <= METIS_RTOL):
            raise AssertionError(f"metis_scenario2 {users}: card vs CPU "
                                 f"{tx} / {c_tx} APs, {sinr_rel}, {cap_rel}")

    # 46. the feasibility app's three host solvers at 4x4, as the app runs
    # them (feas.run), with each solve timed on the card and on the CPU
    # route; then the launches and device time an iteration from two
    # short solves on the card
    def solve_all(device):
        solvers = feas.make_solvers(feas.make_channel(0, device), 0)
        iterations, ms = {}, {}
        for name, solver in solvers.items():
            iterations[name], seconds = timed(lambda: solver.solve(feas.NS))
            ms[name] = seconds * 1e3 / iterations[name]
        return {"cost": float(solvers["Alt Min"].get_cost()),
                "capacity": {n: feas.sum_capacity(s)
                             for n, s in solvers.items()},
                "iterations": iterations}, ms

    tic = time.perf_counter()
    card_out, card_ms = solve_all(dev)
    cpu_out, cpu_ms = solve_all("cpu")
    rates = {}
    for name in card_ms:
        counts, busy = [], []
        for n in (10, 20):
            short = feas.make_solvers(feas.make_channel(0, dev), 0)[name]
            short.max_iterations = n
            events = trace(lambda: short.solve(feas.NS), repeat=1)[0]
            counts.append(kernels(events, repeat=1))
            busy.append(device_ms(events, repeat=1))
        busy_an_iteration = (busy[1] - busy[0]) / 10
        rates[name] = {"ms_an_iteration": card_ms[name],
                       "cpu_ms_an_iteration": cpu_ms[name],
                       "launches_an_iteration": (counts[1] - counts[0]) / 10,
                       "launches_a_solve_outside_iterations":
                           2 * counts[0] - counts[1],
                       "device_busy_ms_an_iteration": busy_an_iteration,
                       "device_busy_share":
                           busy_an_iteration / card_ms[name]}
    cap_rel = {n: abs(card_out["capacity"][n] / cpu_out["capacity"][n] - 1)
               for n in card_out["capacity"]}
    phase("ia_feasibility", K=feas.K, Nr=4, Nt=4, Ns=2, snr_db=feas.SNR,
          cost=card_out["cost"], cpu_cost=cpu_out["cost"],
          capacity=compact(card_out["capacity"]),
          card_vs_cpu_capacity_rel=compact(cap_rel),
          capacity_rtol=FEAS_CAP_RTOL, iterations=compact(
              card_out["iterations"]),
          rates=compact(rates), card=repr(smi),
          phase_seconds=time.perf_counter() - tic,
          phases_43_to_46_seconds=time.perf_counter() - start)
    if max(cap_rel.values()) > FEAS_CAP_RTOL or \
            abs(card_out["cost"] - cpu_out["cost"]) > FEAS_COST_ATOL or \
            card_out["iterations"] != cpu_out["iterations"]:
        raise AssertionError(f"ia_feasibility: card {card_out} vs CPU "
                             f"{cpu_out}")
    return fill_launches


def run_notebook(number, device):
    """``(namespace, seconds)`` of the port's notebook ``number`` ("01" ..
    "09") run with ``DEVICE=device`` in a scratch folder, its printed
    output discarded."""
    import glob
    import io
    import runpy

    import torch
    root = os.path.dirname(os.path.abspath(__file__))
    path, = glob.glob(os.path.join(root, "notebooks", f"{number}_*_torch.py"))
    with tempfile.TemporaryDirectory() as tmp, contextlib.chdir(tmp), \
            contextlib.redirect_stdout(io.StringIO()):
        if device == "cuda":
            torch.cuda.synchronize()
        tic = time.perf_counter()
        ns = runpy.run_path(path, init_globals={"DEVICE": device})
        if device == "cuda":
            torch.cuda.synchronize()
        seconds = time.perf_counter() - tic
    return ns, seconds


def flip_limit(symbols):
    """Boundary flips allowed between the card and the CPU on the same
    draws: ``NB_FLIPS_PER_1E6`` for each started 1e6 symbols."""
    import math
    return NB_FLIPS_PER_1E6 * math.ceil(symbols / 1e6)


def check_flips(name, card_errors, cpu_errors, symbols):
    """Each count of ``card_errors`` within ``flip_limit`` of the CPU's;
    returns the largest difference."""
    import numpy as np
    diff = np.abs(np.asarray(card_errors, dtype=np.int64) -
                  np.asarray(cpu_errors, dtype=np.int64))
    limit = flip_limit(symbols)
    if diff.max() > limit:
        raise AssertionError(f"{name}: card {card_errors} against CPU "
                             f"{cpu_errors}, more than {limit} flips")
    return int(diff.max())


def check_theory_band(name, errors, bits, p):
    """Bit errors within ``NB_BAND_SIGMAS`` standard deviations (+ 3) of a
    closed form's count: independent decisions a symbol, two bits a
    symbol at most doubling the binomial variance."""
    import numpy as np
    errors, bits, p = (np.asarray(v, dtype=float) for v in (errors, bits, p))
    sd = np.sqrt(2.0 * bits * p * (1.0 - p))
    off = np.abs(errors - bits * p) > NB_BAND_SIGMAS * sd + 3.0
    if off.any():
        raise AssertionError(f"{name}: bit errors {errors} against the "
                             f"theory's {bits * p}")


def notebook_phases(dev, smi):
    """Phases 47-54: the port's notebooks 01-06, 08 and 09 run at their
    own settings on the card, each against a run of the same notebook on
    the CPU (the same Philox draws, or the same injected bits), with the
    physics bands of each. Notebook 07 touches no tensor. Returns, per
    kernel name, the launches of these runs."""
    import numpy as np
    from pyphysim_tpu_torch.ops import fir
    from pyphysim_tpu_torch.utils.conversion import dB2Linear
    from pyphysim_tpu_torch.utils.misc import qfunc
    start = time.perf_counter()
    launches = {}

    def card_and_cpu(number):
        """The notebook on the card, block_fir's and the fill's counts set
        to 0 just before it and read just after, then on the CPU."""
        reset_fill_counts()
        fir.block_fir.launch_count = 0
        fir.block_fir.reference_count = 0
        ns, seconds = run_notebook(number, dev.type)
        counts = {"block_fir": (fir.block_fir.launch_count,
                                fir.block_fir.reference_count),
                  "philox_stream_fill": fill_counts()}
        fills, plain = counts["philox_stream_fill"]
        if plain or not fills:
            raise AssertionError(f"notebook {number}: {fills} fill launches "
                                 f"and {plain} plain draws")
        launches["philox_stream_fill"] = \
            launches.get("philox_stream_fill", 0) + fills
        cpu, cpu_seconds = run_notebook(number, "cpu")
        return ns, cpu, seconds, cpu_seconds, counts

    def fir_launches(number, counts, want):
        got, plain = counts["block_fir"]
        check_launches(f"notebook {number} block_fir", got, want, plain)
        launches["block_fir"] = launches.get("block_fir", 0) + got

    # 47. QPSK over AWGN through the runner's per-key path
    ns, cpu, seconds, cpu_seconds, counts = card_and_cpu("01")
    reps = ns["runner"].runned_reps
    flips = check_flips("notebook 01", ns["bit_errors"], cpu["bit_errors"],
                        max(reps) * ns["runner"].num_symbols)
    phase("notebook_01", snr_db=ns["snrs"].tolist(),
          ber=ns["ber"].tolist(), theory=ns["theory"].tolist(),
          runned_reps=reps, cpu_runned_reps=cpu["runner"].runned_reps,
          max_flips=flips, fill_launches=counts["philox_stream_fill"][0],
          seconds=seconds, cpu_seconds=cpu_seconds, card=repr(smi))
    if reps != cpu["runner"].runned_reps:
        raise AssertionError("notebook 01: the card ran other repetitions")
    check_theory_band("notebook 01", ns["bit_errors"], ns["bits"],
                      ns["theory"])

    # 48. the flagship chain per-sample and block-static (block_fir), and
    # the frequency-domain path
    ns, cpu, seconds, cpu_seconds, counts = card_and_cpu("02")
    fir_launches("02", counts, 3)        # one a block-static transmission
    keys = sorted(ns["bit_errors"])
    errs = [ns["bit_errors"][k] for k in keys]
    bits = ns["bits_per_point"]
    flips = check_flips("notebook 02", errs,
                        [cpu["bit_errors"][k] for k in keys], bits // 4)
    out, cpu_out = ns["out"].cpu(), cpu["out"]
    out_err = float((out - cpu_out).abs().max() / cpu_out.abs().max())
    phase("notebook_02", points=[f"{'block' if b else 'sample'}@{s}"
                                 for b, s in keys],
          ber=[e / bits for e in errs], max_flips=flips,
          freq_domain_shape=list(out.shape), freq_domain_rel_err=out_err,
          block_fir_launches=counts["block_fir"][0],
          fill_launches=counts["philox_stream_fill"][0], seconds=seconds,
          cpu_seconds=cpu_seconds, card=repr(smi))
    for (block_static, snr), e in zip(keys, errs):
        if snr in BER_CORNERS:
            check_range(f"notebook 02 BER {block_static} {snr}", e / bits,
                        BER_CORNERS[snr])
        if snr == 25.0 and not e < ns["bit_errors"][block_static, 15.0]:
            raise AssertionError("notebook 02: BER at 25 dB not below 15")
    if out_err > NB_OUT_RTOL:
        raise AssertionError(f"notebook 02: frequency-domain output "
                             f"{out_err} off the CPU")

    # 49. Alamouti / MRC, and the IA sweeps
    ns, cpu, seconds, cpu_seconds, counts = card_and_cpu("03")
    keys = sorted(ns["ber"])
    symbols = ns["reps"] * ns["n"]
    flips = check_flips(
        "notebook 03", [round(ns["ber"][k] * 2 * symbols) for k in keys],
        [round(cpu["ber"][k] * 2 * symbols) for k in keys], symbols)
    ia = np.concatenate([ns["caps"], ns["caps3"].ravel()])
    cpu_ia = np.concatenate([cpu["caps"], cpu["caps3"].ravel()])
    ia_rel = float(np.max(np.abs(ia / cpu_ia - 1)))
    phase("notebook_03", ber=compact({f"{a}@{s}": v for (a, s), v in
                                      ns["ber"].items()}),
          max_flips=flips, ia_mean_capacity=ns["caps"].tolist(),
          solvers_mean_capacity=ns["caps3"].tolist(),
          ia_card_vs_cpu_rel=ia_rel, fill_launches=counts[
              "philox_stream_fill"][0], seconds=seconds,
          cpu_seconds=cpu_seconds, card=repr(smi))
    check_range("notebook 03 Alamouti BER at 10 dB",
                ns["ber"]["Alamouti 2x1", 10.0], ALAMOUTI_BER_10DB)
    check_range("notebook 03 IA capacity at 10 dB", ns["caps"][1],
                IA_CAP_RANGE)
    check_range("notebook 03 Max-SINR capacity at 10 dB", ns["caps3"][1, 0],
                IA_CAP_RANGE)
    if ia_rel > NB_IA_RTOL:
        raise AssertionError(f"notebook 03: IA capacities {ia_rel} off the "
                             "CPU")

    # 50. simulate_in_parallel on the process's own NCCL group, and the
    # time-sharded channel through block_fir
    ns, cpu, seconds, cpu_seconds, counts = card_and_cpu("04")
    fir_launches("04", counts, 6)   # the 1-rank call, unsharded, 4 shards
    snrs = np.asarray(ns["runner_serial"].params["SNR"], dtype=float)
    bits = 512 * 512 * 2
    card_ber = [float(r.get_result())
                for r in ns["runner_parallel"].results["ber"]]
    cpu_ber = [float(r.get_result())
               for r in cpu["runner_parallel"].results["ber"]]
    card_errs = [round(b * bits) for b in card_ber]
    flips = check_flips("notebook 04", card_errs,
                        [round(b * bits) for b in cpu_ber], bits // 2)
    ts = [ns["bit_errors"][k] for k in ("time-sharded", "unsharded")]
    ts_flips = check_flips("notebook 04 time-sharded", ts,
                           [cpu["bit_errors"][k] for k in
                            ("time-sharded", "unsharded")], 300 * 8)
    phase("notebook_04", snr_db=snrs.tolist(), ber=card_ber,
          equal_to_simulate=[bool(e) for e in ns["equal"]],
          max_flips=flips, time_sharded_max_abs_err=compact(
              ns["max_abs_err"]), limit=TS_ATOL,
          time_sharded_bit_errors=compact(ns["bit_errors"]),
          time_sharded_flips=ts_flips,
          block_fir_launches=counts["block_fir"][0],
          fill_launches=counts["philox_stream_fill"][0], seconds=seconds,
          cpu_seconds=cpu_seconds, card=repr(smi))
    if not all(ns["equal"]) or ts[0] != ts[1]:
        raise AssertionError("notebook 04: a sharded result differs")
    if max(ns["max_abs_err"].values()) > TS_ATOL:
        raise AssertionError(f"notebook 04: time-sharded channel "
                             f"{ns['max_abs_err']} off corrupt_data")
    check_theory_band("notebook 04", card_errs, [bits] * len(snrs),
                      qfunc(np.sqrt(dB2Linear(snrs))))

    # 51. AWGN, flat Rayleigh and MRC 1x2 against their closed forms
    ns, cpu, seconds, cpu_seconds, counts = card_and_cpu("05")
    modes = ("awgn", "rayleigh", "mrc")
    flips = check_flips(
        "notebook 05", np.concatenate([ns["bit_errors"][m] for m in modes]),
        np.concatenate([cpu["bit_errors"][m] for m in modes]),
        ns["NUM_SYMBOLS"] * ns["NUM_REPS"])
    phase("notebook_05", snr_db=ns["SNRS_DB"].tolist(),
          ber=compact({m: (ns["bit_errors"][m] / ns["num_bits"]).tolist()
                       for m in modes}), max_flips=flips,
          fill_launches=counts["philox_stream_fill"][0], seconds=seconds,
          cpu_seconds=cpu_seconds, card=repr(smi))
    for m in modes:
        check_theory_band(f"notebook 05 {m}", ns["bit_errors"][m],
                          ns["num_bits"], ns[f"theory_{m}"])

    # 52. the path-loss models in float64 tensors on the card
    ns, seconds = run_notebook("06", dev.type)
    cpu, cpu_seconds = run_notebook("06", "cpu")
    values = [(ns["at_1km"][k], cpu["at_1km"][k]) for k in ns["at_1km"]]
    values += [(ns[k], cpu[k]) for k in ("reach_km",)]
    tensors = [(ns["curves"][k], cpu["curves"][k]) for k in ns["curves"]]
    tensors += [(ns["metis"][k], cpu["metis"][k]) for k in ns["metis"]]
    rel = max([abs(a / b - 1) for a, b in values] +
              [float((a.cpu() / b - 1).abs().max()) for a, b in tensors])
    phase("notebook_06", at_1km_db=compact(ns["at_1km"]),
          reach_km=ns["reach_km"], card_vs_cpu_rel=rel,
          dtype=str(ns["curves"]["3GPP"].dtype),
          device=str(ns["curves"]["3GPP"].device), seconds=seconds,
          cpu_seconds=cpu_seconds, card=repr(smi))
    if rel > NB_PL_RTOL or ns["curves"]["3GPP"].device.type != dev.type:
        raise AssertionError(f"notebook 06: path losses {rel} off the CPU")

    # 53. comp_BD stream sacrifice through the bulk engine
    ns, cpu, seconds, cpu_seconds, counts = card_and_cpu("08")
    card_counts, cpu_counts = [], []     # (symbol errors, symbols) a metric
    for runner, cpu_runner in ((ns["runner"], cpu["runner"]),
                               (ns["ns_runner"], cpu["ns_runner"])):
        for m in runner.metrics:
            for r, out in ((runner, card_counts), (cpu_runner, cpu_counts)):
                ser = r.results[f"ser_{m}"][0]
                out.append((int(ser._value), int(ser._total)))
    card_counts, cpu_counts = np.array(card_counts), np.array(cpu_counts)
    flips = check_flips("notebook 08 symbol errors", card_counts[:, 0],
                        cpu_counts[:, 0], int(cpu_counts[:, 1].sum()))
    phase("notebook_08", ser=compact(ns["ser"]), cpu_ser=compact(cpu["ser"]),
          nonsquare_ser=compact(ns["ns_ser"]),
          cpu_nonsquare_ser=compact(cpu["ns_ser"]), max_flips=flips,
          symbols=int(cpu_counts[:, 1].sum()),
          fill_launches=counts["philox_stream_fill"][0], seconds=seconds,
          cpu_seconds=cpu_seconds, card=repr(smi))
    check_range("notebook 08 ser_None", ns["ser"]["None"], COMP_BD_SER_NONE)
    check_range("notebook 08 ser_capacity", ns["ser"]["capacity"],
                COMP_BD_SER_CAPACITY)
    # the streams each metric kept: the same decisions on the same draws
    if not np.array_equal(card_counts[:, 1], cpu_counts[:, 1]):
        raise AssertionError(f"notebook 08: symbols sent {card_counts[:, 1]} "
                             f"against the CPU's {cpu_counts[:, 1]}")

    # 54. the kernel tier: mc_bd (PRNG and inject), mc_ia (closed and
    # general); the notebook builds its own kernels, their counts from 0
    ns, seconds = run_notebook("09", dev.type)
    cpu, cpu_seconds = run_notebook("09", "cpu")
    sweep, inject = ns["runner"].mc, ns["mc"]
    check_launches("notebook 09 mc_bd PRNG", sweep.launch_count,
                   ns["runner"].chunks_dispatched, sweep.reference_count)
    check_launches("notebook 09 mc_bd inject", inject.launch_count,
                   1 + 1 + 2 + 4, inject.reference_count)
    ia = {f"{k}": (m.launch_count, m.reference_count)
          for k, m in ns["ia_kernels"].items()}
    for key, (got, plain) in ia.items():
        check_launches(f"notebook 09 mc_ia {key}", got, 1, plain)
    bd_rel = max(float(np.max(np.abs(ns["caps"] / cpu["caps"] - 1))),
                 float(((ns["one"].cpu() - cpu["one"]).abs() /
                        cpu["one"].abs()).max()))
    ia_rel = max(abs(ns["ia_capacity"][k] / cpu["ia_capacity"][k] - 1)
                 for k in ns["ia_capacity"])
    phase("notebook_09", bd_mean_capacity=ns["caps"].tolist(),
          ia_mean_capacity=compact({str(k): v for k, v in
                                    ns["ia_capacity"].items()}),
          sharded_equal=compact(ns["equal"]), bd_card_vs_cpu_rel=bd_rel,
          ia_card_vs_cpu_rel=ia_rel, mc_bd_prng_launches=sweep.launch_count,
          mc_bd_inject_launches=inject.launch_count,
          mc_ia_launches=compact(ia), seconds=seconds,
          cpu_seconds=cpu_seconds, card=repr(smi))
    if not all(ns["equal"].values()):
        raise AssertionError(f"notebook 09: sharded builds {ns['equal']}")
    if bd_rel > BD_REL_TOL or ia_rel > IA_REL_TOL:
        raise AssertionError(f"notebook 09: kernels off their plain "
                             f"versions: BD {bd_rel}, IA {ia_rel}")
    launches["mc_bd_prng"] = sweep.launch_count + inject.launch_count
    launches["mc_maxsinr_prng"] = sum(got for got, _ in ia.values())
    phase("notebook_seconds", phases_47_to_54=time.perf_counter() - start,
          card=repr(smi))
    return launches

if __name__ == "__main__":
    sys.exit(main())
