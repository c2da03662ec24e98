"""Traffic path ``"pusch_perkey"``: ``apps/mimo/mimo_ofdm_tdl_torch.py``
``MimoOfdmTdlSimulationRunner`` (the chunk loop, ``ops/streams.py``,
``ops/fir.py``'s MIMO route) given a ``PuschChainStep``
(``pusch_chain.py``: SC-FDMA, the DMRS estimate of
``reference_signals/channel_estimation.py``, ``ops/mimo_detect.py``
``sc_mmse_eq``) of the configuration's antennas, modulation, SC-FDMA
geometry, DMRS and channel, ``symbols`` data REs a layer an attempt (one
subframe). A call is one step: a chunk of ``chunk`` attempts runs as
``subchunks`` calls under a stop rule, as one call without."""

from __future__ import annotations

from typing import Dict

import numpy as np

from ..harness import program
from ..harness.spans import Recorder, bench_runner
from ..reference import engine, pusch


def make_runner(cfg: Dict, wl: Dict, device, judged, dtype):
    from apps.mimo.mimo_ofdm_tdl_torch import MimoOfdmTdlSimulationRunner
    from pyphysim_tpu_torch.pusch_chain import PuschChainStep

    o, d = cfg["ofdm"], cfg["dmrs"]
    nt, nr = int(cfg["num_tx"]), int(cfg["num_rx"])
    symbols = int(wl["symbols"])
    _, channel = program.channel(cfg, device)
    channel.set_num_antennas(nr, nt)
    chain = PuschChainStep(
        nt, nr, int(cfg["modulation"]["M"]), symbols, o["fft_size"],
        o["cp_size"], o["num_used"], channel, int(d["root_index"]),
        d["cyclic_shifts"], d["cover_codes"], dmrs_symbols=d["symbols"],
        symbols_per_subframe=o["symbols_per_subframe"],
        taps_to_keep=int(d["taps_to_keep"]),
        signal_dtype=None if dtype == "float32" else dtype, device=device)
    runner = bench_runner(MimoOfdmTdlSimulationRunner)(
        device=device, read_command_line_args=False, chain=chain)
    program.sweep_params(runner, wl)
    runner.recorder = Recorder(
        lambda args: (args[0].attempts, int(args[0].n)), symbols * nt,
        judged, runner.batch_stop_criterion)
    return runner, runner.recorder


def warm(runner, wl: Dict) -> None:
    """The step's one shape: the warm-up sweep has run it (and captured
    its graph on a card)."""


def bits_per_attempt(cfg: Dict, wl: Dict) -> int:
    return int(wl["symbols"]) * int(cfg["num_tx"]) * \
        int(round(np.log2(cfg["modulation"]["M"])))


def reference_counts(cfg: Dict, wl: Dict, seed: int, snr_db: float,
                     attempts, n: int, device) -> np.ndarray:
    import torch
    att = torch.as_tensor(np.asarray(attempts, np.int64), device=device)
    return pusch.perkey_counts(cfg, int(wl["symbols"]), seed, snr_db,
                               att).cpu().numpy()


def replay(calls, wl: Dict) -> Dict:
    return engine.replay_perkey(calls, int(wl["rep_max"]),
                                int(wl["chunk"]), program.stop_limit(wl),
                                int(wl["subchunks"]))


def tiny(wl: Dict) -> None:
    """The configuration as it is (a subframe an attempt), 16 attempts a
    point in chunks of 8, a sub-chunk an attempt."""
    wl.update(rep_max=16, chunk=8, snr_db=[0, 20])
