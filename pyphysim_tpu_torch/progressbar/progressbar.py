"""Local text progress bars.

Counterpart of the text bars of ``pyphysim_tpu/progressbar/progressbar.py``:
  * :class:`ProgressBarBase` — count -> percent, elapsed/ETA, 0.1 s display
    throttle,
  * :class:`ProgressbarText` / 2 / 3 — terminal styles,
  * :class:`DummyProgressbar` — the no-op bar.

The IPython, multiprocess and ZMQ bars are not ported yet.
"""

from __future__ import annotations

import sys
import time
from typing import Any, Optional

from ..utils.misc import pretty_time

__all__ = ["center_message", "DummyProgressbar", "ProgressBarBase",
           "ProgressbarTextBase", "ProgressbarText", "ProgressbarText2",
           "ProgressbarText3"]


def center_message(message: str, length: int = 50, fill_char: str = " ",
                   left: str = "", right: str = "") -> str:
    """Return ``message`` (surrounded by spaces) centered in a
    ``length``-wide field filled with ``fill_char``, with optional fixed
    ``left``/``right`` decorations; odd fill goes left
    (progressbar.py:77-117)."""
    fill_size = length - (len(message) + 2) - len(left) - len(right)
    fill_size = max(fill_size, 0)
    left_fill = fill_size // 2 + (fill_size % 2)
    right_fill = fill_size // 2
    return (f"{left}{fill_char * left_fill} {message} "
            f"{fill_char * right_fill}{right}")


class DummyProgressbar:
    """A no-op progressbar (parity with the reference DummyProgressbar)."""

    def __init__(self, *args: Any, **kwargs: Any) -> None:
        pass

    def progress(self, count: int) -> None:
        pass


class ProgressBarBase:
    """Common machinery: percent computation, elapsed time, ETA and a
    display throttle of 0.1 s (updates faster than that are dropped)."""

    def __init__(self, finalcount: int, output=None) -> None:
        self.finalcount = int(finalcount)
        self._count = 0
        self._start_time: Optional[float] = None
        self._stop_time: Optional[float] = None
        self._last_display_time = 0.0
        self._display_interval = 0.1
        self._output = output if output is not None else sys.stdout
        self._finalized = False

    @property
    def n(self) -> int:
        """Current count (reference progressbar.py:208-210)."""
        return self._count

    # -- timing ------------------------------------------------------------

    @property
    def display_interval(self) -> float:
        """Minimum seconds between display updates
        (parity: progressbar.py:217-225)."""
        return self._display_interval

    @display_interval.setter
    def display_interval(self, value: float) -> None:
        self._display_interval = float(value)

    @property
    def elapsed_time(self) -> str:
        return pretty_time(self._elapsed_seconds)

    @property
    def elapsed_time_in_seconds(self) -> float:
        """Elapsed seconds since the first progress update
        (parity: progressbar.py:227-243)."""
        return self._elapsed_seconds

    @property
    def _elapsed_seconds(self) -> float:
        if self._start_time is None:
            return 0.0
        end = self._stop_time if self._stop_time is not None else time.time()
        return end - self._start_time

    def get_eta_in_seconds(self) -> float:
        """Estimated remaining seconds (parity: progressbar.py:245-251)."""
        frac = self._count / self.finalcount if self.finalcount else 1.0
        if frac <= 0:
            return float("inf")
        return self._elapsed_seconds * (1.0 - frac) / frac

    def get_eta(self) -> str:
        """Estimated remaining time, pretty-printed
        (parity: progressbar.py:252-262)."""
        return self.eta

    def stop(self) -> None:
        """Finalize the bar early: subsequent ``progress`` calls are
        ignored (parity: progressbar.py:286-302)."""
        if not self._finalized:
            self._stop_time = time.time()
            self._finalized = True
            self._output.write("\n")
            try:
                self._output.flush()
            except Exception:
                pass

    @property
    def eta(self) -> str:
        frac = self._count / self.finalcount if self.finalcount else 1.0
        if frac <= 0:
            return "???"
        remaining = self._elapsed_seconds * (1.0 - frac) / frac
        return pretty_time(remaining)

    # -- updating ----------------------------------------------------------

    def progress(self, count: int) -> None:
        """Update the bar to ``count`` (monotonic; capped at finalcount)."""
        if self._finalized:
            return
        if self._start_time is None:
            self._start_time = time.time()
        count = min(int(count), self.finalcount)
        self._count = count
        now = time.time()
        if count == self.finalcount:
            self._stop_time = now
            self._display_current_progress()
            self._finalized = True
            self._output.write("\n")
            try:
                self._output.flush()
            except Exception:
                pass
        elif now - self._last_display_time > self._display_interval:
            self._last_display_time = now
            self._display_current_progress()

    def __call__(self, count: int) -> None:
        self.progress(count)

    # -- rendering (subclass responsibility) ------------------------------

    def _display_current_progress(self) -> None:  # pragma: no cover
        raise NotImplementedError

    @property
    def percent(self) -> float:
        if self.finalcount == 0:
            return 100.0
        return self._count / self.finalcount * 100.0


class ProgressbarTextBase(ProgressBarBase):
    """Shared state of the terminal bars: fill character, center message
    and display width (progressbar.py:399-657)."""

    def __init__(self, finalcount: int, progresschar: str = "*",
                 message: str = "", output=None, width: int = 50) -> None:
        super().__init__(finalcount, output)
        self.progresschar = progresschar
        self.message = message
        self.width = max(int(width), 20)


class ProgressbarText(ProgressbarTextBase):
    """Classic bar with a centered message:
    ``------------ message [37%] -----------``"""

    def _display_current_progress(self) -> None:
        pct = self.percent
        nchars = int(pct / 100.0 * self.width)
        bar = (self.progresschar * nchars).ljust(self.width)
        label = f" {int(pct)}% "
        center = (self.width - len(label)) // 2
        display = bar[:center] + label + bar[center + len(label):]
        msg = f" {self.message}" if self.message else ""
        self._output.write(f"\r[{display}]{msg}")
        try:
            self._output.flush()
        except Exception:
            pass


class ProgressbarText2(ProgressbarTextBase):
    """Bar + percentage + elapsed time on one line."""

    def _display_current_progress(self) -> None:
        pct = self.percent
        nchars = int(pct / 100.0 * self.width)
        bar = (self.progresschar * nchars).ljust(self.width)
        msg = self.message if self.message else f"{pct:.2f}%"
        self._output.write(
            f"\r[{bar}] {pct:3.0f}% - {msg} - Elapsed: {self.elapsed_time}")
        try:
            self._output.flush()
        except Exception:
            pass


class ProgressbarText3(ProgressbarTextBase):
    """Count display: ``-------- message: 400/600 ---------``"""

    def __init__(self, finalcount: int, progresschar: str = "-",
                 message: str = "", output=None, width: int = 50) -> None:
        super().__init__(finalcount, progresschar, message, output, width)

    def _display_current_progress(self) -> None:
        label = f"{self.message}: " if self.message else ""
        label = f"{label}{self._count}/{self.finalcount}"
        self._output.write(
            "\r" + center_message(label, self.width, self.progresschar))
        try:
            self._output.flush()
        except Exception:
            pass
