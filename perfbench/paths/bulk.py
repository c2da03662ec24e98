"""Traffic path ``"bulk"``: ``apps/ofdm/ofdm_mc_kernel_torch.py``
``OfdmMcKernelSimulationRunner`` (``_bulk_loop``, ``ops/mc_kernel.py``,
``ops/csrc/mc_ofdm_tdl.cu``) with the configuration's OFDM geometry,
profile and Jakes generator. A call runs ``chunk`` attempts (or a rung of
the loop's ladder) of ``tiles`` x ``tile`` OFDM symbols."""

from __future__ import annotations

from typing import Dict

import numpy as np

from ..harness import program
from ..harness.spans import Recorder, bench_runner
from ..reference import engine, flagship


def make_runner(cfg: Dict, wl: Dict, device, judged, dtype):
    from apps.ofdm.ofdm_mc_kernel_torch import OfdmMcKernelSimulationRunner
    from pyphysim_tpu_torch.modulators import OFDM
    from pyphysim_tpu_torch.ops.mc_kernel import MonteCarloOfdmTdl

    o = cfg["ofdm"]
    tile, tiles = int(wl["tile"]), int(wl["tiles"])
    runner = bench_runner(OfdmMcKernelSimulationRunner)(
        device=device, read_command_line_args=False, matmul_dtype=dtype)
    program.sweep_params(runner, wl)
    runner.tile, runner.num_tiles = tile, tiles
    runner.ofdm = OFDM(o["fft_size"], o["cp_size"], o["num_used"],
                       device=device)
    runner.jakes, runner.channel = program.channel(cfg, device)
    runner.mc = MonteCarloOfdmTdl(runner.ofdm, runner.channel,
                                  M=int(cfg["modulation"]["M"]), tile=tile,
                                  matmul_dtype=dtype, device=device)
    runner.recorder = Recorder(lambda args: (int(args[0]), int(args[1])),
                               tiles * tile * int(o["num_used"]), judged,
                               runner.batch_stop_criterion)
    return runner, runner.recorder


def warm(runner, wl: Dict) -> None:
    """Every chunk size the bulk loop's ladder can ask for, once, through
    the app's own kernel callable (the ladder of ``_bulk_loop``; one size
    without a stop rule)."""
    if program.stop_limit(wl) is None:
        sizes = [int(wl["chunk"])]
    else:
        q = int(wl["subchunks"])
        bsize = -(-int(wl["chunk"]) // q) * q
        sizes = sorted({-(-max(bsize // d, 1) // q) * q
                        for d in (8, 4, 2, 1)})
    fn = runner._gen_bulk_kernel(runner.params.get_unpacked_params_list()[0])
    for n in sizes:
        fn(0, n)["bit_errors"].cpu()


def bits_per_attempt(cfg: Dict, wl: Dict) -> int:
    k = int(round(np.log2(cfg["modulation"]["M"])))
    return int(wl["tiles"]) * int(wl["tile"]) * \
        int(cfg["ofdm"]["num_used"]) * k


def reference_counts(cfg: Dict, wl: Dict, seed: int, snr_db: float,
                     attempts, n: int, device) -> np.ndarray:
    return flagship.bulk_counts(cfg, int(wl["tile"]), int(wl["tiles"]),
                                seed, snr_db, int(attempts), n,
                                device).cpu().numpy()


def replay(calls, wl: Dict) -> Dict:
    return engine.replay_bulk(calls, int(wl["rep_max"]), int(wl["chunk"]),
                              program.stop_limit(wl), int(wl["subchunks"]))


def tiny(wl: Dict) -> None:
    wl.update(tile=16, tiles=1, rep_max=32, chunk=8, snr_db=[0, 20])
