# %% [markdown]
# # Progress bars (PyTorch port)
#
# The port's counterpart of `07_progress_bars.py`: the text progress bar
# styles, the file-sink mode (for cluster jobs whose stdout you can't
# watch), and the two distributed servers — multiprocess (a managed list)
# and ZMQ (sockets, across hosts) — that aggregate many workers into one
# bar. The Monte Carlo runner picks these up through
# `update_progress_function_style`.
#
# The bars touch no tensor, so this notebook runs on the host alone and,
# unlike the other notebooks of the port, reads no `DEVICE`: it needs no
# card.

# %%
import os
import sys

# the repository root: the parent of this file's folder, or of the working
# directory of a notebook server started in notebooks/
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    globals().get("__file__", "notebook")))))

import io
import time

from pyphysim_tpu_torch.progressbar import (ProgressbarText, ProgressbarText2,
                                            ProgressbarText3)

# %% [markdown]
# ## Text styles
#
# Style 1 is the classic bar with a centered message, style 2 a bar with
# percentage and elapsed time, style 3 a count display.

# %%
last_lines = {}
for cls in (ProgressbarText, ProgressbarText2, ProgressbarText3):
    out = io.StringIO()
    bar = cls(50, message="demo", output=out)
    for i in (10, 30, 50):
        bar.progress(i)
    last_lines[cls.__name__] = \
        out.getvalue().replace("\r", "\n").strip().splitlines()[-1]
    print(f"{cls.__name__:18s}: {last_lines[cls.__name__]}")

# %% [markdown]
# ## File sink
#
# Writing progress to a file lets a detached job report status; the
# Monte Carlo runner's `progress_output_type='file'` uses this to write
# `<name>_progress_<i>_of_<N>.txt` files.

# %%
import tempfile

with tempfile.TemporaryDirectory() as tmp:
    path = os.path.join(tmp, "progress.txt")
    with open(path, "w") as f:
        bar = ProgressbarText(100, message="file sink", output=f)
        bar.progress(42)
    with open(path) as f:
        file_line = f.read().replace("\r", "\n").strip().splitlines()[-1]
    print(file_line)

# %% [markdown]
# ## Multiprocess server
#
# Each worker registers a proxy; a daemon thread in the parent sums the
# counts. The workers are forked: `worker` is defined in this notebook,
# which a spawned process could not import.

# %%
import multiprocessing

from pyphysim_tpu_torch.progressbar import ProgressbarMultiProcessServer


def worker(n, proxy):
    for i in range(0, n + 1, n // 4):
        proxy.progress(i)
        time.sleep(0.01)


pb = ProgressbarMultiProcessServer(message="4 workers")
ctx = multiprocessing.get_context("fork")
try:
    procs = [ctx.Process(target=worker, args=(
        100, pb.register_client_and_get_proxy_progressbar(100)))
        for _ in range(4)]
    for p in procs:
        p.start()
    pb.start_updater()
    for p in procs:
        p.join()
    multiprocess_count = pb._get_total_count()
finally:
    pb.close()
print(f"\nmultiprocess bar done: {multiprocess_count} of "
      f"{pb.total_final_count}")

# %% [markdown]
# ## ZMQ server
#
# The cross-host variant: workers PUSH "client_id:count" strings to a
# PULL socket. Here client and server run in the same process just to
# show the protocol. The server binds a port the OS reports free (and
# takes another if that one is taken before the bind): several notebooks
# or test workers may run at once.

# %%
import socket


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


zmq_count = None
try:
    import zmq
except ImportError:
    zmq = None
    print("pyzmq not available; skipping the ZMQ demo")

if zmq is not None:
    from pyphysim_tpu_torch.progressbar import ProgressbarZMQServer

    for _ in range(5):
        pb = ProgressbarZMQServer(message="zmq", ip="127.0.0.1",
                                  port=free_port())
        proxy = pb.register_client_and_get_proxy_progressbar(100)
        try:
            pb.start_updater()
            break
        except zmq.ZMQError:
            pb.stop_updater()
    else:
        raise RuntimeError("no free port in 5 attempts")
    try:
        for i in (25, 50, 100):
            proxy.progress(i)
            time.sleep(0.05)
        deadline = time.time() + 5.0
        while pb._get_total_count() < 100 and time.time() < deadline:
            time.sleep(0.05)
        zmq_count = pb._get_total_count()
    finally:
        pb.stop_updater()
        proxy.close()
    print(f"\nzmq bar done: {zmq_count} of {pb.total_final_count}")
