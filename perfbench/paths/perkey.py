"""Traffic path ``"perkey"``: ``apps/ofdm/ofdm_tdlchannel_torch.py``
``OfdmTdlSimulationRunner`` (``_batch_loop``, ``chain.py``,
``ops/streams.py`` and ``ops/fir.py``) with a block-static ``ChainStep``
of ``symbols`` 16-QAM symbols an attempt on the configuration's channel. A
call is one chain step: a chunk of ``chunk`` attempts runs as
``subchunks`` calls under a stop rule, as one call without."""

from __future__ import annotations

from typing import Dict

import numpy as np

from ..harness import program
from ..harness.spans import Recorder, bench_runner
from ..reference import engine, flagship


def make_runner(cfg: Dict, wl: Dict, device, judged, dtype):
    from apps.ofdm.ofdm_tdlchannel_torch import OfdmTdlSimulationRunner
    from pyphysim_tpu_torch.chain import ChainStep

    o = cfg["ofdm"]
    runner = bench_runner(OfdmTdlSimulationRunner)(
        device=device, read_command_line_args=False)
    program.sweep_params(runner, wl)
    symbols = int(wl["symbols"])
    runner.chain = ChainStep(symbols, o["fft_size"], o["cp_size"],
                             o["num_used"], block_static=True,
                             signal_dtype=None if dtype == "float32"
                             else dtype, device=device)
    # the chain builds the flagship channel itself: hold it to the
    # configuration's
    runner.chain.jakes, runner.chain.channel = program.channel(cfg, device)
    runner.recorder = Recorder(
        lambda args: (args[0].attempts, int(args[0].n)), symbols, judged,
        runner.batch_stop_criterion)
    return runner, runner.recorder


def warm(runner, wl: Dict) -> None:
    """The chain's one shape: the warm-up sweep has run it."""


def bits_per_attempt(cfg: Dict, wl: Dict) -> int:
    return int(wl["symbols"]) * int(round(np.log2(cfg["modulation"]["M"])))


def reference_counts(cfg: Dict, wl: Dict, seed: int, snr_db: float,
                     attempts, n: int, device) -> np.ndarray:
    import torch
    att = torch.as_tensor(np.asarray(attempts, np.int64), device=device)
    return flagship.perkey_counts(cfg, int(wl["symbols"]), seed, snr_db,
                                  att).cpu().numpy()


def replay(calls, wl: Dict) -> Dict:
    return engine.replay_perkey(calls, int(wl["rep_max"]),
                                int(wl["chunk"]), program.stop_limit(wl),
                                int(wl["subchunks"]))


def tiny(wl: Dict) -> None:
    wl.update(symbols=600, rep_max=48, chunk=16, snr_db=[0, 20])
