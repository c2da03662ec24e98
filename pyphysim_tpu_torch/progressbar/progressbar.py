"""Text progress bars and the same-host progress server.

Counterpart of ``pyphysim_tpu/progressbar/progressbar.py``:
  * :class:`ProgressBarBase` — count -> percent, elapsed/ETA, 0.1 s display
    throttle,
  * :class:`ProgressbarText` / 2 / 3 — terminal styles,
  * :class:`DummyProgressbar` — the no-op bar,
  * :class:`ProgressBarIPython` — an ipywidgets bar for notebooks, which
    falls back to the text bar where ipywidgets is absent,
  * :class:`ProgressbarMultiProcessServer` — one bar for many clients (the
    runners of ``simulate_do_what_i_mean``'s list mode), whose proxies
    write their counts into a managed list that a render thread sums,
  * :class:`ProgressbarZMQServer` / :class:`ProgressbarZMQClient` — the
    same across hosts: clients PUSH ``"client_id:count"`` messages to the
    server's PULL socket.

``zmq``, ``ipywidgets`` and ``IPython`` are imported only inside the
classes that use them, so the rest of the port runs without them.
"""

from __future__ import annotations

import multiprocessing
import sys
import threading
import time
from typing import Any, List, Optional

from ..utils.misc import pretty_time

__all__ = ["center_message", "DummyProgressbar", "ProgressBarBase",
           "ProgressbarTextBase", "ProgressbarText", "ProgressbarText2",
           "ProgressbarText3", "ProgressBarIPython",
           "ProgressbarDistributedServerBase",
           "ProgressbarDistributedClientBase",
           "ProgressbarMultiProcessServer", "ProgressbarMultiProcessClient",
           "ProgressbarZMQServer", "ProgressbarZMQClient"]


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


class ProgressBarIPython(ProgressBarBase):
    """ipywidgets progress bar for notebooks: a ``FloatProgress`` widget
    showing the percentage. Without ipywidgets (or IPython) it is a
    :class:`ProgressbarText2` instead."""

    def __init__(self, finalcount: int, message: str = "") -> None:
        super().__init__(finalcount)
        self.message = message
        try:
            import ipywidgets
            from IPython.display import display
        except ImportError:
            self._widget = None
            self._fallback = ProgressbarText2(finalcount, message=message)
        else:
            self._widget = ipywidgets.FloatProgress(min=0, max=100,
                                                    description=message)
            display(self._widget)
            self._fallback = None

    def _display_current_progress(self) -> None:
        if self._widget is not None:
            self._widget.value = self.percent
        else:
            self._fallback.progress(self._count)


# ---------------------------------------------------------------------------
# Progress server: one bar for many clients
# ---------------------------------------------------------------------------


class ProgressbarDistributedServerBase:
    """Server + proxy model: each client gets a proxy bar that reports its
    count to the server; a daemon thread sums the registered clients'
    counts and renders one text bar of the total."""

    def __init__(self, progresschar: str = "*", message: str = "",
                 sleep_time: float = 0.2, style=ProgressbarText2) -> None:
        self._progresschar = progresschar
        self._message = message
        self._sleep_time = float(sleep_time)
        self._style = style
        self._total_final_count = 0
        self._client_counts: Any = []
        self._update_thread: Optional[threading.Thread] = None
        self._stop_event = threading.Event()
        self._bar: Optional[ProgressBarBase] = None

    def _get_total_count(self) -> int:  # pragma: no cover - abstract
        raise NotImplementedError

    def register_client_and_get_proxy_progressbar(self, total_count: int):
        raise NotImplementedError  # pragma: no cover

    @property
    def total_final_count(self) -> int:
        return self._total_final_count

    @property
    def finalcount(self) -> int:
        """Alias of ``total_final_count``."""
        return self._total_final_count

    @property
    def is_running(self) -> bool:
        """Whether the render thread is alive."""
        return (self._update_thread is not None
                and self._update_thread.is_alive())

    @property
    def num_clients(self) -> int:
        return len(self._client_counts)

    def start_updater(self) -> None:
        """Start the daemon render thread (it ends by itself once the
        total reaches the final count)."""
        if self._update_thread is not None:
            return
        self._bar = self._style(self._total_final_count,
                                self._progresschar, self._message)
        self._stop_event.clear()

        def run() -> None:
            while not self._stop_event.is_set():
                count = self._get_total_count()
                self._bar.progress(count)
                if count >= self._total_final_count:
                    break
                self._stop_event.wait(self._sleep_time)

        self._update_thread = threading.Thread(target=run, daemon=True)
        self._update_thread.start()

    def stop_updater(self, timeout: Optional[float] = 2.0) -> None:
        self._stop_event.set()
        if self._update_thread is not None:
            self._update_thread.join(timeout)
            self._update_thread = None


class ProgressbarMultiProcessServer(ProgressbarDistributedServerBase):
    """Same-host progress server over a ``multiprocessing`` managed list:
    its proxies may live in this process's threads or in other processes
    of the host. :meth:`close` ends the manager's process."""

    def __init__(self, progresschar: str = "*", message: str = "",
                 sleep_time: float = 0.2, style=ProgressbarText2) -> None:
        super().__init__(progresschar, message, sleep_time, style)
        self._manager = multiprocessing.get_context("spawn").Manager()
        self._client_counts = self._manager.list()

    def register_client_and_get_proxy_progressbar(self, total_count: int):
        client_id = len(self._client_counts)
        self._client_counts.append(0)
        self._total_final_count += int(total_count)
        return ProgressbarMultiProcessClient(client_id, self._client_counts)

    def _get_total_count(self) -> int:
        return int(sum(self._client_counts))

    def close(self) -> None:
        """Stop the render thread and the manager's process."""
        self.stop_updater()
        self._manager.shutdown()


class ProgressbarDistributedClientBase:
    """Base of the client-side proxies: a picklable callable that reports
    a count to the server."""

    def __init__(self, client_id: int) -> None:
        self.client_id = int(client_id)

    def progress(self, count: int) -> None:  # pragma: no cover - abstract
        raise NotImplementedError

    def __call__(self, count: int) -> None:
        self.progress(count)


class ProgressbarMultiProcessClient(ProgressbarDistributedClientBase):
    """A proxy of :class:`ProgressbarMultiProcessServer`: writes its count
    into the server's managed list."""

    def __init__(self, client_id: int, client_counts) -> None:
        super().__init__(client_id)
        self._client_counts = client_counts

    def progress(self, count: int) -> None:
        self._client_counts[self.client_id] = int(count)


class ProgressbarZMQServer(ProgressbarDistributedServerBase):
    """Cross-host progress server: binds a ZMQ PULL socket on ``ip:port``
    when the updater starts, and a receive thread stores each client's
    latest ``"client_id:count"`` message."""

    def __init__(self, progresschar: str = "*", message: str = "",
                 sleep_time: float = 0.2, style=ProgressbarText2,
                 ip: str = "*", port: int = 7396) -> None:
        super().__init__(progresschar, message, sleep_time, style)
        self._ip = ip
        self._port = int(port)
        self._client_counts: List[int] = []
        self._recv_thread: Optional[threading.Thread] = None
        self._context = None
        self._socket = None

    @property
    def ip(self) -> str:
        return self._ip

    @property
    def port(self) -> int:
        return self._port

    def register_client_and_get_proxy_progressbar(
            self, total_count: int) -> "ProgressbarZMQClient":
        client_id = len(self._client_counts)
        self._client_counts.append(0)
        self._total_final_count += int(total_count)
        ip = "localhost" if self._ip == "*" else self._ip
        return ProgressbarZMQClient(client_id, ip, self._port)

    def start_updater(self) -> None:
        """Bind the socket (``zmq.ZMQError`` if the port is taken), start
        the receive thread, then the render thread."""
        import zmq
        if self._socket is None:
            context = zmq.Context()
            socket = context.socket(zmq.PULL)
            try:
                socket.bind(f"tcp://{self._ip}:{self._port}")
            except zmq.ZMQError:
                socket.close(linger=0)
                context.term()
                raise
            self._context, self._socket = context, socket

            def recv_loop() -> None:
                poller = zmq.Poller()
                poller.register(socket, zmq.POLLIN)
                while not self._stop_event.is_set():
                    if poller.poll(100):
                        msg = socket.recv_string()
                        try:
                            cid_s, count_s = msg.split(":")
                            cid, count = int(cid_s), int(count_s)
                        except ValueError:
                            continue  # malformed message: ignore
                        if 0 <= cid < len(self._client_counts):
                            self._client_counts[cid] = count

            self._recv_thread = threading.Thread(target=recv_loop,
                                                 daemon=True)
            self._recv_thread.start()
        super().start_updater()

    def stop_updater(self, timeout: Optional[float] = 2.0) -> None:
        """Stop both threads and close the socket."""
        super().stop_updater(timeout)
        if self._recv_thread is not None:
            self._recv_thread.join(timeout)
            self._recv_thread = None
        if self._socket is not None:
            self._socket.close(linger=0)
            self._context.term()
            self._socket = None
            self._context = None

    def _get_total_count(self) -> int:
        return int(sum(self._client_counts))


class ProgressbarZMQClient(ProgressbarDistributedClientBase):
    """Client-side proxy: PUSHes ``"client_id:count"`` without blocking
    (LINGER 0; an update that finds the queue full is dropped). It pickles
    as its id and address, and connects on its first update."""

    def __init__(self, client_id: int, ip: str, port: int) -> None:
        super().__init__(client_id)
        self.ip = ip
        self.port = int(port)
        self._socket = None
        self._context = None

    def _connect(self) -> None:
        import zmq
        self._context = zmq.Context()
        self._socket = self._context.socket(zmq.PUSH)
        self._socket.setsockopt(zmq.LINGER, 0)
        self._socket.connect(f"tcp://{self.ip}:{self.port}")

    def progress(self, count: int) -> None:
        import zmq
        if self._socket is None:
            self._connect()
        try:
            self._socket.send_string(f"{self.client_id}:{int(count)}",
                                     flags=zmq.NOBLOCK)
        except zmq.Again:
            pass  # the send queue is full: drop this update

    def close(self) -> None:
        """Close the socket (a later update connects again)."""
        if self._socket is not None:
            self._socket.close(linger=0)
            self._context.term()
            self._socket = None
            self._context = None

    def __getstate__(self):
        return {"client_id": self.client_id, "ip": self.ip,
                "port": self.port}

    def __setstate__(self, state):
        self.client_id = state["client_id"]
        self.ip = state["ip"]
        self.port = state["port"]
        self._socket = None
        self._context = None
