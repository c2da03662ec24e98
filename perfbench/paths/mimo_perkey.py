"""Traffic path ``"mimo_perkey"``: ``apps/mimo/mimo_ofdm_tdl_torch.py``
``MimoOfdmTdlSimulationRunner`` (``_batch_loop``, ``mimo_chain.py``,
``ops/streams.py``, ``ops/fir.py``'s MIMO route, ``ops/mimo_detect.py``)
given a ``MimoChainStep`` of the configuration's antennas, modulation, OFDM
geometry and channel (its ``detector``, MMSE, is the step's), ``symbols``
resource elements a layer an attempt. A call is one step: a chunk of
``chunk`` attempts runs as ``subchunks`` calls under a stop rule, as one
call without."""

from __future__ import annotations

from typing import Dict

import numpy as np

from ..harness import program
from ..harness.spans import Recorder, bench_runner
from ..reference import engine, mimo_ofdm


def make_runner(cfg: Dict, wl: Dict, device, judged, dtype):
    from apps.mimo.mimo_ofdm_tdl_torch import MimoOfdmTdlSimulationRunner
    from pyphysim_tpu_torch.mimo_chain import MimoChainStep

    o = cfg["ofdm"]
    nt, nr = int(cfg["num_tx"]), int(cfg["num_rx"])
    symbols = int(wl["symbols"])
    _, channel = program.channel(cfg, device)
    channel.set_num_antennas(nr, nt)
    chain = MimoChainStep(
        nt, nr, int(cfg["modulation"]["M"]), symbols, o["fft_size"],
        o["cp_size"], o["num_used"], channel,
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
    return mimo_ofdm.perkey_counts(cfg, int(wl["symbols"]), seed, snr_db,
                                   att).cpu().numpy()


def replay(calls, wl: Dict) -> Dict:
    return engine.replay_perkey(calls, int(wl["rep_max"]),
                                int(wl["chunk"]), program.stop_limit(wl),
                                int(wl["subchunks"]))


def tiny(wl: Dict) -> None:
    """The configuration as it is, one OFDM symbol a subframe (its
    ``num_used`` resource elements a layer), 48 attempts a point."""
    wl.update(symbols=1200, rep_max=48, chunk=16, snr_db=[0, 20])
