"""The port's IPython and ZMQ progress bars against the JAX package's, on the
CPU (mirrors ``tests/test_progressbar.py``'s ZMQ tests).

* ZMQ: a server and two clients count to the total, on a free port picked
  by the OS (never a fixed one: several test workers run at once); a port
  taken between the pick and the bind is retried with a fresh one. The
  client pickles as its id and address, like the JAX client.
* IPython: with ipywidgets the bar is a ``FloatProgress`` whose value is
  the percentage, as the JAX bar's; without it both fall back to the text
  bar and print the same line.
"""

import io
import pickle
import socket
import sys
import time

import pytest

torch = pytest.importorskip("torch")

from pyphysim_tpu import progressbar as J  # noqa: E402
from pyphysim_tpu_torch import progressbar as T  # noqa: E402


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _started_server(cls, clients=(50, 50), attempts=5):
    """A started ``cls`` server on a free port with its client proxies;
    another port is picked if the one chosen was taken before the bind."""
    zmq = pytest.importorskip("zmq")
    for _ in range(attempts):
        server = cls(message="zmq", sleep_time=0.05, ip="127.0.0.1",
                     port=_free_port())
        proxies = [server.register_client_and_get_proxy_progressbar(n)
                   for n in clients]
        try:
            server.start_updater()
        except zmq.ZMQError:
            server.stop_updater()
            continue
        return server, proxies
    pytest.fail(f"no free port in {attempts} attempts")


@pytest.mark.parametrize("package", [J, T], ids=["jax", "torch"])
def test_zmq_roundtrip(package):
    server, (c1, c2) = _started_server(package.ProgressbarZMQServer)
    try:
        assert isinstance(c1, package.ProgressbarZMQClient)
        assert (c1.client_id, c2.client_id) == (0, 1)
        assert server.total_final_count == 100
        assert server.num_clients == 2
        c1.progress(20)
        c2(30)
        deadline = time.time() + 5.0
        while time.time() < deadline and server._get_total_count() < 50:
            time.sleep(0.05)
        assert server._get_total_count() == 50
        c1.progress(50)
        c2.progress(50)
        deadline = time.time() + 5.0
        while time.time() < deadline and server._get_total_count() < 100:
            time.sleep(0.05)
        assert server._get_total_count() == 100
    finally:
        server.stop_updater()
        if package is T:
            c1.close()
            c2.close()
    assert not server.is_running


def test_zmq_server_ignores_malformed_messages():
    zmq = pytest.importorskip("zmq")
    server, (c1,) = _started_server(T.ProgressbarZMQServer, clients=(10,))
    ctx = zmq.Context()
    push = ctx.socket(zmq.PUSH)
    push.setsockopt(zmq.LINGER, 0)
    try:
        push.connect(f"tcp://127.0.0.1:{server.port}")
        for msg in ("garbage", "9:5", "0:x"):
            push.send_string(msg)
        c1.progress(7)
        deadline = time.time() + 5.0
        while time.time() < deadline and server._get_total_count() < 7:
            time.sleep(0.05)
        assert server._client_counts == [7]
    finally:
        push.close(linger=0)
        ctx.term()
        server.stop_updater()
        c1.close()


def test_zmq_taken_port_raises_and_is_released():
    zmq = pytest.importorskip("zmq")
    first, (c,) = _started_server(T.ProgressbarZMQServer, clients=(1,))
    try:
        second = T.ProgressbarZMQServer(ip="127.0.0.1", port=first.port)
        second.register_client_and_get_proxy_progressbar(1)
        with pytest.raises(zmq.ZMQError):
            second.start_updater()
        assert second._socket is None and not second.is_running
    finally:
        first.stop_updater()
        c.close()


def test_zmq_client_pickles_like_the_jax_client():
    c = T.ProgressbarZMQClient(3, "localhost", 7396)
    c2 = pickle.loads(pickle.dumps(c))
    assert (c2.client_id, c2.ip, c2.port) == (3, "localhost", 7396)
    j = J.ProgressbarZMQClient(3, "localhost", 7396)
    assert c.__getstate__() == j.__getstate__()
    server = T.ProgressbarZMQServer(port=7000)
    proxy = server.register_client_and_get_proxy_progressbar(5)
    assert (proxy.ip, proxy.port) == ("localhost", 7000)     # ip "*"
    assert issubclass(T.ProgressbarZMQClient,
                      T.ProgressbarDistributedClientBase)
    assert issubclass(T.ProgressbarZMQServer,
                      T.ProgressbarDistributedServerBase)


def test_ipython_bar_sets_the_widget_like_the_jax_bar(capsys):
    pytest.importorskip("ipywidgets")
    pytest.importorskip("IPython")
    bars = [pkg.ProgressBarIPython(200, message="sim") for pkg in (J, T)]
    for bar in bars:
        assert bar._widget is not None and bar._fallback is None
        assert bar._widget.description == "sim"
        bar.progress(50)
        assert bar._widget.value == 25.0
        bar.progress(200)
    assert bars[0]._widget.value == bars[1]._widget.value == 100.0


def test_ipython_bar_falls_back_to_text_without_ipywidgets(monkeypatch):
    monkeypatch.setitem(sys.modules, "ipywidgets", None)
    outs = []
    for pkg in (J, T):
        bar = pkg.ProgressBarIPython(10, message="fallback")
        assert bar._widget is None
        assert isinstance(bar._fallback, pkg.ProgressbarText2)
        bar._fallback._output = io.StringIO()
        bar.progress(10)
        outs.append(bar._fallback._output.getvalue())
    assert "100%" in outs[1] and "fallback" in outs[1]
    # the same line but for the elapsed time
    assert outs[0].split("Elapsed")[0] == outs[1].split("Elapsed")[0]
