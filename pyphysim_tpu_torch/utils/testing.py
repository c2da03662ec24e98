"""Reproducibility helpers for stochastic tests.

Counterpart of ``pyphysim_tpu/utils/testing.py``: capture the randomness
of a test on failure and replay it on the next run. The unit of randomness
is an integer seed or a ``torch.Generator`` (its ``get_state()``, kept as a
numpy byte array), where the JAX package keeps jax keys.

Usage::

    from pyphysim_tpu_torch.utils.testing import SeedReplay

    def test_something():
        with SeedReplay("test_something.pickle") as sr:
            gen = sr.generator("channel", torch.Generator().manual_seed(1))
            noise_seed = sr.seed("noise", 42)
            ...stochastic assertions...

On failure the seeds and generator states handed out inside the block are
saved; the next run replays exactly those, so the failure is reproducible.
On success any stored replay file is removed.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, Optional

import numpy as np
import torch

__all__ = ["SeedReplay"]


class SeedReplay:
    """Capture-on-failure / replay-on-rerun of named seeds and generator
    states."""

    def __init__(self, filename: str, folder: str = ".seed_replays") -> None:
        self._path = os.path.join(folder, filename)
        self._values: Dict[str, np.ndarray] = {}
        self._replayed: Optional[Dict[str, np.ndarray]] = None
        if os.path.exists(self._path):
            with open(self._path, "rb") as f:
                self._replayed = pickle.load(f)

    @property
    def replaying(self) -> bool:
        """True when a previous failure's values are being replayed."""
        return self._replayed is not None

    def _recorded(self, name: str) -> Optional[np.ndarray]:
        if self._replayed is None:
            return None
        return self._replayed.get(name)

    def generator(self, name: str,
                  default: torch.Generator) -> torch.Generator:
        """``default``, set to the state recorded for ``name`` if a failure
        was recorded; its state as handed out is remembered for capture."""
        state = self._recorded(name)
        if state is not None:
            default.set_state(torch.from_numpy(np.array(state,
                                                        dtype=np.uint8)))
        self._values[name] = default.get_state().numpy().copy()
        return default

    def seed(self, name: str, default: int) -> int:
        """The integer seed to use for ``name``: the replayed one if a
        failure was recorded, otherwise ``default``."""
        state = self._recorded(name)
        value = int(default) if state is None else int(state)
        self._values[name] = np.asarray(value)
        return value

    # -- context manager ---------------------------------------------------

    def __enter__(self) -> "SeedReplay":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is not None:
            os.makedirs(os.path.dirname(self._path) or ".", exist_ok=True)
            with open(self._path, "wb") as f:
                pickle.dump(self._values, f)
        elif os.path.exists(self._path):
            os.unlink(self._path)
        return False  # never swallow the exception
