"""The system under test, set up from a cell's files.

A traffic mix names its ``path``: the module ``perfbench/paths/<path>.py``
that builds the app's own runner for it and says how its calls are judged.
A path module has

  * ``make_runner(cfg, wl, device, judged, dtype) -> (runner, Recorder)``:
    the app's runner class under :func:`spans.bench_runner`, its
    parameters set as data from the traffic mix (:func:`sweep_params`) and
    the configuration;
  * ``warm(runner, wl)``: every shape the traffic can ask for, once;
  * ``bits_per_attempt(cfg, wl)``;
  * ``reference_counts(cfg, wl, seed, snr_db, attempts, n, device)``: the
    plain reference's per-attempt bit errors of one call;
  * ``replay(calls, wl)``: the runner's rules for one point, replayed on
    the program's counts (:mod:`reference.engine`);
  * ``tiny(wl)``: the traffic cut to a size the CPU runs in seconds (the
    tests').

A new route or family of the program is a new path file. Only this module
and the path modules import the program.
"""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path
from types import ModuleType
from typing import Dict

import numpy as np

from .cells import HERE


def path(name: str, base: Path = HERE) -> ModuleType:
    """The module ``<base>/paths/<name>.py`` (``base`` is ``perfbench/``),
    as the module ``perfbench.paths.<name>``, loaded once."""
    if not name.isidentifier():
        raise ValueError(f"a traffic path is a module name, not {name!r}")
    file = (base / "paths" / f"{name}.py").resolve()
    full = f"perfbench.paths.{name}"
    module = sys.modules.get(full)
    if module is None or Path(module.__file__).resolve() != file:
        spec = importlib.util.spec_from_file_location(full, file)
        module = importlib.util.module_from_spec(spec)
        sys.modules[full] = module
        spec.loader.exec_module(module)
    return module


def make_runner(cfg: Dict, wl: Dict, device, judged=(), dtype=None):
    """``(runner, recorder)`` for a cell; ``dtype`` overrides the traffic's
    compute type (the control's lower precision)."""
    return path(wl["path"]).make_runner(cfg, wl, device, set(judged),
                                        dtype or wl["dtype"])


def stop_limit(wl: Dict):
    """The stop rule's limit, or None where the traffic has no stop rule
    (``"stop": null``: each point runs ``rep_max`` attempts)."""
    stop = wl.get("stop")
    return None if stop is None else float(stop[1])


def sweep_params(runner, wl: Dict) -> None:
    """The sweep's parameters, from the traffic mix."""
    runner.params.add("SNR", np.asarray(wl["snr_db"], dtype=float))
    runner.params.set_unpack_parameter("SNR")
    runner.rep_max = int(wl["rep_max"])
    runner.batch_size = int(wl["chunk"])
    stop = wl.get("stop")
    runner.batch_stop_criterion = (None if stop is None
                                   else (stop[0], float(stop[1])))
    runner.num_stop_subchunks = int(wl["subchunks"])
    runner.update_progress_function_style = None


def channel(cfg: Dict, device):
    """``(jakes, TdlChannel)`` of the configuration's profile."""
    from pyphysim_tpu_torch.channels import (JakesSampleGenerator,
                                             TdlChannel, TdlChannelProfile)

    from ..reference.profiles import raw_profile
    powers_db, delays = raw_profile(cfg["channel"])
    jakes = JakesSampleGenerator(Fd=float(cfg["doppler_hz"]),
                                 Ts=1.0 / float(cfg["bandwidth_hz"]),
                                 L=int(cfg["jakes_rays"]), device=device)
    return jakes, TdlChannel(jakes, TdlChannelProfile(
        powers_db, delays, cfg["channel"]["name"]))


def counters(runner) -> Dict[str, int]:
    """The program's counters a per-layer metric may read: the app's
    calls of its kernel callable."""
    return {"chunks_dispatched": int(runner.chunks_dispatched)}
