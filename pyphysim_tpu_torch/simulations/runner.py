"""The Monte Carlo simulation runner — the framework's engine.

Counterpart of ``pyphysim_tpu/simulations/runner.py``: the template-method
engine with lifecycle hooks, early stop via ``_keep_going``,
``SkipThisOne`` skip-and-retry accounting, partial-results
checkpoint/resume and progress tracking, with three execution paths:

  * **Serial path** — subclasses implement
    ``_run_simulation(current_parameters) -> SimulationResults`` and get
    one Python call per repetition.

  * **Per-key path** — subclasses implement ``_gen_simulation_kernel``
    returning ``kernel(streams)``: the batched counterpart of the JAX
    package's vmapped ``kernel(key)``. ``streams`` is an
    ``ops.streams.AttemptStreams`` over a chunk of absolute attempts, and
    row ``i`` of every output belongs to attempt ``i`` of the chunk
    (``apps/ofdm/ofdm_tdlchannel_torch.py``). A ``batch_stop_criterion``
    gates whole sub-chunks of ``num_stop_subchunks``, with one host check
    per sub-chunk.

  * **Bulk path** — subclasses implement ``_gen_bulk_kernel`` returning
    ``fn(start, n)``, a function that simulates attempts
    ``[start, start + n)`` in one call (``apps/ofdm/ofdm_mc_kernel_torch.py``
    runs a whole chunk of repetitions in one CUDA kernel launch); with a
    stop criterion the chunk sizes come from a 4-rung ladder.

The per-key and bulk paths run through one chunk loop (``_chunk_loop``):
an absolute attempt cursor (accepted plus skipped attempts, so a resume
continues the stream sequence), the first ``rep_max`` valid attempts
accepted (the reserved ``"__valid__"`` mask skips and retries,
``_consume_chunk``), and the next chunk queued ahead of the host's work.
Without a stop criterion chunk k+1 is dispatched before chunk k's outputs
are fetched. With one, the loop gates on its own running counts (accepted
attempts, cursor, stop metric): chunk k+1 is dispatched as soon as chunk
k's outputs are fetched, and chunk k's bookkeeping (its Results, progress
and checkpoint, the ``engine.deferred`` span) runs while the device runs
chunk k+1. Each distinct device tensor of a chunk is copied to the host
once, and the host waits once (``_fetch_each_once``).

``simulate_in_parallel`` runs the same sweep with each chunk's attempts
split over a ``torch.distributed`` device mesh (``parallel/mesh.py``): every
rank of the group runs the runner, computes its contiguous shard of the
chunk from its own absolute attempt, and the shards are all-gathered, so
every rank keeps the same Results (the per-key path here, the bulk
kernels through their ``mesh=`` builds). Only rank 0 writes files.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from contextlib import nullcontext
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from ..tracing import span
from .parameters import SimulationParameters
from .results import Result, SimulationResults

__all__ = ["SimulationRunner", "SkipThisOne", "get_common_parser",
           "get_partial_results_filename", "kernel_stream_seed"]


def kernel_stream_seed(base_seed: int, unpack_index: int) -> int:
    """Per-variation 31-bit seed of a bulk kernel's random streams (the
    same formula as the JAX package, so a seed names the same variation
    in both): attempt-level independence comes from the kernel's
    absolute-attempt streams, variation-level independence from this."""
    return (int(base_seed) * 1000003 + max(int(unpack_index), 0)) \
        & 0x7FFFFFFF


def get_partial_results_filename(
        results_base_filename: str,
        current_params: SimulationParameters,
        partial_results_folder: Optional[str] = None) -> str:
    """Name of the partial-results checkpoint file for one unpacked
    variation: ``<base>_unpack_<i>.pickle`` with the index zero-padded to
    the digit count of the total number of variations."""
    total_unpacks = current_params.get_num_unpacked_variations()
    num_digits = len(str(total_unpacks))
    unpack_index_str = str(max(current_params.unpack_index, 0)).zfill(
        num_digits)
    filename = f"{results_base_filename}_unpack_{unpack_index_str}.pickle"
    if partial_results_folder is not None:
        filename = os.path.join(partial_results_folder, filename)
    return filename


class SkipThisOne(Exception):
    """Raised inside ``_run_simulation`` to discard the current repetition
    (e.g. a singular matrix was drawn); the repetition is retried and a
    ``num_skipped_reps`` SUMTYPE result accounts for it."""

    def __init__(self, msg: str = "") -> None:
        super().__init__(msg)
        self.msg = msg


_common_parser: Optional[argparse.ArgumentParser] = None


def get_common_parser() -> argparse.ArgumentParser:
    """Singleton argparse parser with the shared simulation options."""
    global _common_parser
    if _common_parser is None:
        parser = argparse.ArgumentParser(add_help=False)
        group = parser.add_argument_group("Simulation options")
        group.add_argument("-c", "--config", type=str, default=None,
                           help="Config file with simulation parameters")
        group.add_argument("-i", "--index", type=int, default=None,
                           help="Run only the variation with this unpack "
                                "index and save only its partial results")
        group.add_argument("-n", "--number_variations", action="store_true",
                           help="Print the number of unpacked variations "
                                "and exit")
        _common_parser = parser
    return _common_parser


class _HostCopy:
    """A CUDA tensor's copy into pinned host memory, queued on its stream,
    and the event that marks the copy done."""

    def __init__(self, tensor) -> None:
        import torch
        self.host = torch.empty(tensor.shape, dtype=tensor.dtype,
                                pin_memory=True)
        self.host.copy_(tensor.detach(), non_blocking=True)
        self.done = torch.cuda.Event()
        self.done.record(torch.cuda.current_stream(tensor.device))


def _queue_copies(value, copies: Dict[int, _HostCopy]):
    """``value`` with each CUDA tensor replaced by its pinned host copy,
    queued on its stream, one a distinct tensor (``copies``, by identity);
    any other value on the host at once, as numpy."""
    if isinstance(value, tuple):
        return tuple(_queue_copies(v, copies) for v in value)
    if not getattr(value, "is_cuda", False):
        if hasattr(value, "detach"):
            with span("engine.wait"):
                return value.detach().cpu().numpy()
        return np.asarray(value)
    if id(value) not in copies:
        copies[id(value)] = _HostCopy(value)
    return copies[id(value)]


def _copied(value):
    """``value`` with each host copy replaced by its numpy array."""
    if isinstance(value, tuple):
        return tuple(_copied(v) for v in value)
    return value.host.numpy() if isinstance(value, _HostCopy) else value


def _fetch_each_once(values):
    """Start the fetch of ``values`` (a list of outputs: tensors, arrays,
    scalars or ``(values, totals)`` pairs) to the host: one pinned copy of
    each distinct CUDA tensor among them, queued now behind its work
    (``_queue_copies``). Every chunked output reaches the host this way.
    Returns a function that waits for the copies, in one ``engine.wait``,
    and returns ``values`` on the host. Queued right after a dispatch, the
    copies do not wait for the work dispatched after it. No reference
    cycle holds a copy: its pinned memory is freed with its last
    reference, never by the garbage collector inside a graph capture."""
    copies: Dict[int, _HostCopy] = {}
    queued = [_queue_copies(v, copies) for v in values]

    def wait():
        if copies:
            with span("engine.wait"):
                for copy in copies.values():
                    copy.done.synchronize()
        return [_copied(v) for v in queued]

    return wait


class _OffsetProgressProxy:
    """A variation's repetition count mapped into a runner-wide count on a
    shared progress server's proxy."""

    def __init__(self, proxy, offset: int) -> None:
        self._proxy = proxy
        self._offset = int(offset)

    def progress(self, count: int) -> None:
        self._proxy.progress(self._offset + int(count))


def _gather_outputs(mesh, axis: str, out: Dict[str, Any], n_local: int,
                    device) -> Dict[str, Any]:
    """A per-key kernel's outputs for this rank's shard (``n_local`` rows
    each: a tensor, an array, or a ``(values, totals)`` pair) as every
    rank's rows, in rank order: the outputs' bytes packed side by side
    into one buffer, one all-gather of it. A scalar total is the same
    for every attempt of a call and stays a scalar, as it is unsharded."""
    import torch
    from ..parallel.mesh import gather_rows
    leaves = []          # (name, index in a pair or None, tensor)
    for name, value in out.items():
        parts = value if isinstance(value, tuple) else (value,)
        for i, v in enumerate(parts):
            t = v if isinstance(v, torch.Tensor) else \
                torch.as_tensor(np.asarray(v))
            if t.dim() > 0:
                leaves.append((name, i if isinstance(value, tuple) else None,
                               t.to(device).contiguous()))
    packed = gather_rows(mesh, axis, torch.cat(
        [t.reshape(n_local, -1).view(torch.uint8) for _, _, t in leaves],
        dim=1))
    gathered = {name: list(v) if isinstance(v, tuple) else v
                for name, v in out.items()}
    column = 0
    for name, i, t in leaves:
        width = t[:1].numel() * t.element_size()
        rows = packed[:, column:column + width].contiguous().view(t.dtype)
        column += width
        rows = rows.reshape((packed.shape[0],) + tuple(t.shape[1:]))
        if i is None:
            gathered[name] = rows
        else:
            gathered[name][i] = rows
    return {name: tuple(v) if isinstance(v, list) else v
            for name, v in gathered.items()}


def _host_outputs(out, n: int):
    """A per-key chunk's host outputs with each RATIOTYPE total as ``(n,)``
    float64 rows (a scalar total broadcast); the bulk path keeps its
    kernel's totals as they are."""
    host = dict(out)
    for name, v in out.items():
        if isinstance(v, tuple):
            totals = np.asarray(v[1], np.float64)
            if totals.ndim == 0:
                totals = np.full(n, float(totals))
            host[name] = (v[0], totals)
    return host


def _stack_rows(parts, n: int):
    """Concatenate per-sub-chunk host outputs along rows and pad with zero
    rows up to ``n`` (the rows of sub-chunks that did not run)."""
    if isinstance(parts[0], tuple):
        return tuple(_stack_rows(list(p), n) for p in zip(*parts))
    a = np.concatenate([np.asarray(p) for p in parts])
    return np.concatenate([a, np.zeros((n - len(a),) + a.shape[1:],
                                       a.dtype)])


class SimulationRunner:
    """Monte Carlo engine: parameter sweep x repetitions -> typed results."""

    def __init__(self, default_config_file: Optional[str] = None,
                 config_spec=None, read_command_line_args: bool = True,
                 save_parsed_file: bool = False) -> None:
        self.rep_max = 1
        self._elapsed_time = 0.0
        self._runned_reps: List[int] = []
        # serial-path attempt cursor (set by _serial_loop before every
        # _run_simulation call; resume-safe — see _serial_loop)
        self.serial_attempt = 0
        self.params = SimulationParameters()
        self.results = SimulationResults()

        # Progress display
        self.progressbar_message = "Progress"
        self.update_progress_function_style: Optional[str] = "text1"
        self.progress_output_type = "screen"  # or 'file'
        self.progressbar_extra_args: Dict[str, Any] = {}

        # Checkpointing
        self.partial_results_folder = "partial_results"
        self.delete_partial_results_bool = False
        self.__results_base_filename: Optional[str] = None
        self.__partial_files_to_delete: List[Path] = []
        self.__last_checkpoint_time = time.time()
        self.__last_checkpoint_rep = 0

        # Bulk and per-key execution
        self.batch_size: Optional[int] = None  # auto if None
        # the device mesh of a sweep under simulate_in_parallel (None
        # otherwise) and its axis that chunks are split over
        self.mesh: Any = None
        self.mesh_axis = "mc"
        # a shared progress server's proxy (simulationhelpers' list mode)
        self.external_progress_proxy: Any = None
        # the device the per-key path draws its attempt streams on (the
        # apps set their own; the serial and bulk paths do not read it)
        self.device: Any = "cuda"
        self.batch_result_types: Dict[str, Any] = {}
        self.base_seed = 1234
        # Early stop: (result_name, limit) stops a variation once the
        # ACCUMULATED raw value of that (SUMTYPE, or RATIOTYPE numerator)
        # result crosses ``limit``; the bulk path then shrinks its chunks
        # down a 4-rung ladder as the metric approaches the limit.
        self.batch_stop_criterion: Optional[Tuple[str, float]] = None
        # chunk sizes are rounded to a multiple of this while a stop
        # criterion is set (the same rounding as the JAX runner, so both
        # packages cut a sweep into the same chunks)
        self.num_stop_subchunks = 8

        # Command line integration
        self.command_line_args = argparse.Namespace(
            config=None, index=None, number_variations=False)
        if read_command_line_args and not self._running_under_test():
            parser = argparse.ArgumentParser(parents=[get_common_parser()])
            self.command_line_args, _ = parser.parse_known_args()

        config_file = self.command_line_args.config or default_config_file
        if config_file is not None and os.path.exists(config_file):
            self.params = SimulationParameters.load_from_config_file(
                config_file, config_spec, save_parsed_file)

    @staticmethod
    def _running_under_test() -> bool:
        return "pytest" in sys.modules or "unittest" in sys.modules

    # ------------------------------------------------------------------
    # Template methods (subclass API)
    # ------------------------------------------------------------------

    def _run_simulation(
            self, current_parameters: SimulationParameters
    ) -> SimulationResults:
        """One repetition (serial path)."""
        raise NotImplementedError(
            "Implement either _run_simulation (serial path) or "
            "_gen_bulk_kernel (bulk path)")

    def _gen_simulation_kernel(
            self, current_parameters: SimulationParameters
    ) -> Optional[Callable]:
        """Per-key path: return ``kernel(streams) -> {name: value}`` where
        ``streams`` is an ``ops.streams.AttemptStreams`` over ``n``
        absolute attempts (on ``self.device``) and every ``value`` is an
        ``(n,)`` tensor or array, or a ``((n,) values, totals)`` pair for
        RATIOTYPE (``totals`` may be one number). Declare the Result types
        in ``self.batch_result_types``; the reserved ``"__valid__"`` mask
        marks attempts to skip and retry. Row ``i`` must depend only on
        attempt ``i``'s streams. Return None (default) for the serial
        path."""
        return None

    def _gen_bulk_kernel(
            self, current_parameters: SimulationParameters
    ) -> Optional[Callable]:
        """Bulk path: return ``fn(start: int, n: int) -> {name: out}``
        where every ``out`` has leading axis ``n`` (or is a
        ``(values, totals)`` pair of such arrays for RATIOTYPE); declare
        the Result types in ``self.batch_result_types``. Outputs may be
        numpy arrays or torch tensors on any device; returning device
        tensors without synchronising lets the runner enqueue chunk k+1
        before it fetches chunk k. The reserved ``"__valid__"`` mask marks
        attempts to skip and retry.

        Contract: attempt ``start + i``'s randomness must depend only on
        ``(base_seed, unpack_index, start + i)`` — that is what makes
        results chunk-size invariant and checkpoint/resume exact. ``n`` is
        the batch size without a stop criterion; with
        ``batch_stop_criterion`` set it comes from the fixed 4-entry
        ladder (batch, batch/2, /4, /8), so a kernel that caches one
        compiled program per ``n`` builds at most 4. Return None (default)
        to use the serial path.

        While :meth:`simulate_in_parallel` runs, ``self.mesh`` is the
        device mesh: ``n`` is then a multiple of its ``mesh_axis`` size, and
        the kernel splits its rep axis over it (the Monte Carlo kernels'
        ``build(..., mesh=self.mesh)``), every rank returning all ``n``
        rows."""
        return None

    # noinspection PyUnusedLocal
    def _keep_going(self, current_params: SimulationParameters,
                    current_sim_results: SimulationResults,
                    current_rep: int) -> bool:
        """Early-stop predicate, checked between repetitions (serial) or
        chunks (bulk). Default: never stop early."""
        return True

    def _on_simulate_start(self) -> None:
        """Hook called once at simulation start."""

    def _on_simulate_finish(self) -> None:
        """Hook called once at simulation end."""

    def _on_simulate_current_params_start(
            self, current_params: SimulationParameters) -> None:
        """Hook called before each variation."""

    def _on_simulate_current_params_finish(
            self, current_params: SimulationParameters,
            current_params_sim_results: SimulationResults) -> None:
        """Hook called after each variation."""

    def clear(self) -> None:
        """Reset the elapsed time, the run repetitions and the results,
        keeping the parameters."""
        self._elapsed_time = 0.0
        self._runned_reps = []
        self.results = SimulationResults()

    # ------------------------------------------------------------------
    # Properties
    # ------------------------------------------------------------------

    @property
    def elapsed_time(self) -> str:
        from ..utils.misc import pretty_time
        return pretty_time(self._elapsed_time)

    @property
    def runned_reps(self) -> List[int]:
        """Repetitions actually executed per variation."""
        return self._runned_reps

    @property
    def results_base_filename(self) -> Optional[str]:
        return self.__results_base_filename

    @property
    def results_filename(self) -> Optional[str]:
        """Final results filename with ``{param}`` placeholders replaced."""
        return self._get_results_filename()

    def set_results_filename(self, filename: Optional[str] = None) -> None:
        """Set the base filename for final and partial results
        ( ``{param}`` templating supported)."""
        self.__results_base_filename = filename

    # ------------------------------------------------------------------
    # Checkpointing
    # ------------------------------------------------------------------

    def _get_results_filename(self) -> Optional[str]:
        if self.__results_base_filename is None:
            return None
        from ..utils.misc import replace_dict_values
        return replace_dict_values(self.__results_base_filename,
                                   self.params.parameters,
                                   filename_mode=True)

    def _get_partial_results_filename(
            self, current_params: SimulationParameters) -> Optional[str]:
        base = self._get_results_filename()
        if base is None:
            return None
        folder = self.partial_results_folder
        if folder and not os.path.isabs(folder):
            # keep partials next to the results file
            folder = os.path.join(os.path.dirname(base), folder)
        return get_partial_results_filename(
            os.path.basename(base), current_params,
            folder or os.path.dirname(base))

    @staticmethod
    def _is_primary_host() -> bool:
        """Only rank 0 of ``torch.distributed`` touches the filesystem
        when a process group is initialized; a single process always
        does."""
        import torch.distributed as dist
        if dist.is_available() and dist.is_initialized():
            return dist.get_rank() == 0
        return True

    def _save_partial_results(self, current_rep: int,
                              current_params: SimulationParameters,
                              current_sim_results: SimulationResults) -> None:
        if not self._is_primary_host():
            return
        filename = self._get_partial_results_filename(current_params)
        if filename is None:
            return
        current_sim_results.set_parameters(current_params)
        current_sim_results.current_rep = current_rep
        folder = os.path.dirname(filename)
        if folder:
            os.makedirs(folder, exist_ok=True)
        current_sim_results.save_to_file(filename)
        self.__partial_files_to_delete.append(Path(filename).absolute())

    def _save_partial_results_maybe(
            self, current_rep: int, current_params: SimulationParameters,
            current_sim_results: SimulationResults) -> None:
        """Throttled checkpoint: every 500 reps or 300 s. The rep throttle
        fires on CROSSING a multiple of 500, not on exact equality — chunks
        whose size does not divide 500 would otherwise never trigger it."""
        now = time.time()
        if now - self.__last_checkpoint_time > 300 or \
                current_rep // 500 > self.__last_checkpoint_rep // 500:
            self._save_partial_results(current_rep, current_params,
                                       current_sim_results)
            self.__last_checkpoint_time = now
            self.__last_checkpoint_rep = current_rep

    def _load_partial_results(
            self, current_params: SimulationParameters
    ) -> Optional[SimulationResults]:
        """Load+validate a partial-results checkpoint; raises ValueError on
        parameter mismatch."""
        filename = self._get_partial_results_filename(current_params)
        if filename is None or not os.path.exists(filename):
            return None
        partial = SimulationResults.load_from_file(filename)
        if not current_params == partial.params:
            raise ValueError(
                "Partial results loaded from file do not match current "
                f"parameters.\nfile: '{filename}'\nDelete that file first "
                "to simulate with a new configuration.")
        return partial

    def __delete_partial_results_maybe(self) -> None:
        if self.delete_partial_results_bool and self._is_primary_host():
            for f in self.__partial_files_to_delete:
                try:
                    f.unlink()
                except OSError:
                    pass
            self.__partial_files_to_delete.clear()

    # ------------------------------------------------------------------
    # Progress helpers
    # ------------------------------------------------------------------

    def _get_progress_bar(self, variation_index: int, num_variations: int,
                          rep_max: int, current_params=None):
        if self.external_progress_proxy is not None:
            # one proxy covers the runner; variations are offset into it
            return _OffsetProgressProxy(self.external_progress_proxy,
                                        variation_index * rep_max)
        from ..progressbar import (DummyProgressbar, ProgressbarText,
                                   ProgressbarText2, ProgressbarText3)
        styles = {"text1": ProgressbarText, "text2": ProgressbarText2,
                  "text3": ProgressbarText3}
        if self.update_progress_function_style not in styles or \
                not self._is_primary_host():
            return DummyProgressbar()
        source = (current_params.parameters if current_params is not None
                  else self.params.parameters)
        try:
            message = self.progressbar_message.format(**{
                k: v for k, v in source.items()
                if not isinstance(v, (list, np.ndarray))})
        except (KeyError, IndexError):
            message = self.progressbar_message
        output = None
        if self.progress_output_type == "file":
            base = self._get_results_filename() or "simulation"
            output = open(
                f"{base}_progress_{variation_index + 1}_of_"
                f"{num_variations}.txt", "w")
        return styles[self.update_progress_function_style](
            rep_max, message=message, output=output,
            **self.progressbar_extra_args)

    # ------------------------------------------------------------------
    # Main entry point
    # ------------------------------------------------------------------

    def simulate(self,
                 param_variation_index: Optional[int] = None) -> None:
        """Run the full simulation (all variations), or exactly one
        variation when ``param_variation_index`` (or the ``-i`` CLI arg)
        is given — the cluster job-splitting mode that only writes that
        variation's partial results file."""
        if self.command_line_args.number_variations:
            print(self.params.get_num_unpacked_variations())
            return
        if param_variation_index is None:
            param_variation_index = self.command_line_args.index
        with span("engine.sweep"):
            tic = time.time()
            self.__partial_files_to_delete.clear()
            self.params.add("rep_max", self.rep_max)
            self.results = SimulationResults()
            self.results.set_parameters(self.params)
            self._runned_reps = []
            self._on_simulate_start()

            unpacked = self.params.get_unpacked_params_list()
            if param_variation_index is not None:
                if not 0 <= param_variation_index < len(unpacked):
                    raise ValueError(
                        f"Invalid variation index: {param_variation_index}")
                unpacked = [unpacked[param_variation_index]]

            for i, current_params in enumerate(unpacked):
                if self.update_progress_function_style is not None and \
                        self.progress_output_type == "screen" and \
                        len(unpacked) > 1:
                    print(f"Current Variation: {i + 1}/{len(unpacked)}")
                current_results, reps = self._simulate_for_current_params(
                    current_params, i, len(unpacked))
                self._runned_reps.append(reps)
                if param_variation_index is None:
                    self.results.append_all_results(current_results)

            self._elapsed_time = time.time() - tic
            self._on_simulate_finish()
            self.results.runned_reps = list(self._runned_reps)

            if param_variation_index is None:
                self.simulate_common_cleaning()

    def simulate_common_cleaning(self) -> None:
        """Finalize a simulation: save final results and delete partials
        if requested. Called automatically by :meth:`simulate`."""
        filename = self._get_results_filename()
        if filename is not None and self._is_primary_host():
            self.results.save_to_file(filename)
        self.__delete_partial_results_maybe()

    def simulate_in_parallel(self, mesh=None, block: bool = True) -> None:
        """Run the sweep with each chunk's attempts split over a device mesh.

        Every rank of the process group calls this on its own copy of the
        runner. ``mesh``: a ``DeviceMesh`` with the axis ``mesh_axis``
        (default: ``parallel.make_mesh`` over every rank, on
        ``self.device``'s type, which starts a world-size-1 group when none
        is up); its device type must be ``self.device``'s. Chunks are
        rounded to a multiple of the axis size; each rank computes its
        contiguous shard and the shards are all-gathered, so every rank
        holds the same Results, equal to :meth:`simulate`'s on the same
        chunks. ``self.mesh`` is set for the sweep and reset after it.

        ``block=False`` returns at once with the sweep running on a thread
        (on this thread's CUDA device and current stream);
        :meth:`wait_parallel_simulation` joins it and re-raises its error.
        Do not read ``self.results`` before the wait returns. A second call
        while a sweep is running raises ``RuntimeError``.
        """
        from .._device import require_cuda
        thread = getattr(self, "_parallel_thread", None)
        if thread is not None:
            if thread.is_alive():
                raise RuntimeError(
                    "An asynchronous sweep is already running on this "
                    "runner; call wait_parallel_simulation() first")
            self.wait_parallel_simulation()   # a finished one: surface it
        device = require_cuda(self.device)
        if mesh is None:
            from ..parallel.mesh import make_mesh
            mesh = make_mesh(axis_name=self.mesh_axis, device=device.type)
        if mesh.device_type != device.type:
            raise ValueError(f"a {mesh.device_type} mesh cannot run a "
                             f"runner on {device}")
        self.mesh = mesh

        def sweep() -> None:
            try:
                self.simulate()
            finally:
                self.mesh = None

        if block:
            sweep()
            return

        import threading

        import torch
        # a new thread starts on device 0's default stream: carry this
        # thread's device and current stream over
        stream = (torch.cuda.current_stream(device)
                  if device.type == "cuda" else None)

        def run_async() -> None:
            try:
                if stream is None:
                    sweep()
                    return
                torch.cuda.set_device(stream.device)
                with torch.cuda.stream(stream):
                    sweep()
            except BaseException as exc:  # re-raised by the wait
                self._parallel_error = exc

        self._parallel_error = None
        self._parallel_thread = threading.Thread(
            target=run_async, name="simulate_in_parallel", daemon=True)
        self._parallel_thread.start()

    def wait_parallel_simulation(self) -> None:
        """Wait for a sweep started with ``simulate_in_parallel(block=
        False)``: join its thread, then re-raise any error it hit. A no-op
        when no such sweep was started."""
        thread = getattr(self, "_parallel_thread", None)
        if thread is None:
            return
        thread.join()
        self._parallel_thread = None
        err = self.__dict__.pop("_parallel_error", None)
        if err is not None:
            raise err

    # ------------------------------------------------------------------
    # Per-variation execution
    # ------------------------------------------------------------------

    def _simulate_for_current_params(
            self, current_params: SimulationParameters,
            variation_index: int,
            num_variations: int) -> Tuple[SimulationResults, int]:
        with span("engine.point", base_seed=self.base_seed,
                  unpack_index=current_params.unpack_index):
            self._on_simulate_current_params_start(current_params)

            partial = self._load_partial_results(current_params)
            if partial is not None:
                current_results = partial
                current_rep = partial.current_rep
            else:
                current_results = SimulationResults()
                current_rep = 0
            self.__last_checkpoint_rep = current_rep

            pbar = self._get_progress_bar(variation_index, num_variations,
                                          self.rep_max, current_params)

            bulk = self._gen_bulk_kernel(current_params)
            kernel = (self._gen_simulation_kernel(current_params)
                      if bulk is None else None)
            if bulk is None and kernel is None:
                current_rep = self._serial_loop(current_params,
                                                current_results,
                                                current_rep, pbar)
            else:
                if not self.batch_result_types:
                    raise RuntimeError(
                        f"The {'per-key' if bulk is None else 'bulk'} path "
                        "requires self.batch_result_types to declare the "
                        "Result type of every kernel output")
                chunks = (self._bulk_chunks(bulk) if bulk is not None
                          else self._perkey_chunks(kernel, current_params))
                current_rep = self._chunk_loop(*chunks, current_params,
                                               current_results, current_rep,
                                               pbar)
            pbar.progress(self.rep_max)

            self._on_simulate_current_params_finish(current_params,
                                                    current_results)
            if current_rep > 0:
                self._save_partial_results(current_rep, current_params,
                                           current_results)
            return current_results, current_rep

    @staticmethod
    def _skipped_before(current_results) -> int:
        """Skips already merged into (resumed) results: the attempt cursor
        resumes as accepted + skipped, because skipped attempts consumed
        stream indices too."""
        if "num_skipped_reps" in current_results and \
                current_results["num_skipped_reps"]:
            prior = current_results["num_skipped_reps"][-1]
            if prior.num_updates > 0:
                return int(prior.get_result())
        return 0

    # -- serial path -------------------------------------------------------

    def _serial_loop(self, current_params, current_results, current_rep,
                     pbar) -> int:
        # ``serial_attempt`` is the serial path's analog of the bulk
        # path's absolute attempt cursor: monotone within a variation
        # (skipped attempts advance it, so retries get fresh randomness)
        # and derived from the PERSISTED repetition AND skip counts, so a
        # checkpoint-resume continues the attempt sequence instead of
        # replaying realizations already accumulated — which is why every
        # skip is merged into the results IMMEDIATELY. User
        # ``_run_simulation`` code that seeds per-repetition randomness
        # should key it on this (plus the variation's unpack_index).
        attempt = current_rep + self._skipped_before(current_results)
        while current_rep < self.rep_max and self._keep_going(
                current_params, current_results, current_rep):
            tic = time.time()
            attempt += 1
            self.serial_attempt = attempt
            try:
                rep_results = self._run_simulation(current_params)
            except SkipThisOne:
                self._merge_skip_count(current_results, 1)
                continue
            elapsed = time.time() - tic
            rep_results.add_result(
                Result.create("elapsed_time", Result.SUMTYPE, elapsed))
            current_results.merge_all_results(rep_results)
            current_rep += 1
            pbar.progress(current_rep)
            self._save_partial_results_maybe(current_rep, current_params,
                                             current_results)
        self._merge_skip_count(current_results, 0)  # ensure existence
        return current_rep

    @staticmethod
    def _merge_skip_count(current_results, num_skipped: int) -> None:
        skip = Result.create("num_skipped_reps", Result.SUMTYPE, num_skipped)
        if "num_skipped_reps" in current_results:
            current_results["num_skipped_reps"][-1].merge(skip)
        else:
            current_results.add_result(skip)

    # -- chunked paths (per-key and bulk) ------------------------------------

    def _default_batch_size(self) -> int:
        if self.batch_size is not None:
            bsize = int(self.batch_size)
        else:
            bsize = int(min(max(self.rep_max // 8, 1), 4096))
        return self._round_chunk(bsize)

    def _chunk_quantum(self) -> int:
        """Chunk sizes are a multiple of this: the mesh axis size under
        :meth:`simulate_in_parallel` (even shards) times the early-stop
        sub-chunk count when a stop criterion is set (whole sub-chunks are
        gated)."""
        q = 1
        if self.mesh is not None:
            q *= int(self.mesh.size(
                self.mesh.mesh_dim_names.index(self.mesh_axis)))
        if self.batch_stop_criterion is not None:
            q *= max(int(self.num_stop_subchunks), 1)
        return q

    def _round_chunk(self, n: int) -> int:
        q = self._chunk_quantum()
        return ((max(int(n), 1) + q - 1) // q) * q

    def _stop_metric_value(self, current_results) -> float:
        """Accumulated raw value of the stop-criterion result (SUMTYPE
        value, or RATIOTYPE numerator)."""
        name, _ = self.batch_stop_criterion
        if name in current_results and current_results[name]:
            r = current_results[name][-1]
            if r.num_updates > 0:
                return float(r._value)
        return 0.0

    @staticmethod
    def _accept_prefix(valid, active, nk: int,
                       needed: int) -> Tuple[np.ndarray, int]:
        """The accept prefix of one chunk: of its attempts that are valid
        (``valid``, the ``"__valid__"`` mask; None: all) and ran
        (``active``; None: all), the first ``needed``. Returns (accept
        mask, consumed): the attempts after the last accepted one consume
        no stream index."""
        valid = np.ones(nk, dtype=bool) if valid is None else \
            np.asarray(valid).astype(bool)
        if active is None:
            active = np.ones(nk, dtype=bool)
        candidates = valid & active
        cand_pos = np.flatnonzero(candidates)
        if len(cand_pos) >= needed:
            last = int(cand_pos[needed - 1])
            return candidates & (np.arange(nk) <= last), last + 1
        return candidates, int(np.count_nonzero(active))

    def _consume_chunk(self, out, nk, needed, elapsed, current_results,
                       active=None) -> Tuple[int, int, int]:
        """Accept-prefix + skip accounting + Result merging for one chunk
        of attempt outputs (host numpy arrays), shared by the per-key and
        bulk paths. ``active`` (None: all) is True on the prefix of the
        chunk that ran (the per-key path's sub-chunk early stop); attempts
        after it never ran and consume no stream indices. Returns
        (n_accept, consumed, n_skip)."""
        accept, consumed = self._accept_prefix(out.pop("__valid__", None),
                                               active, nk, needed)
        n_accept = int(np.count_nonzero(accept))
        n_skip = consumed - n_accept

        chunk_results = SimulationResults()
        for name, spec in self.batch_result_types.items():
            if name not in out:
                raise RuntimeError(
                    f"Kernel did not produce declared result {name!r}")
            type_code, choice_num = self._parse_type_spec(spec)
            r = Result(name, type_code, choice_num=choice_num)
            value = out[name]
            if isinstance(value, tuple):
                r.update_batch(value[0][accept], value[1][accept])
            else:
                r.update_batch(np.asarray(value)[accept])
            chunk_results.add_result(r)
        chunk_results.add_result(
            Result.create("elapsed_time", Result.SUMTYPE, elapsed))
        chunk_results.add_result(
            Result.create("num_skipped_reps", Result.SUMTYPE, n_skip))
        current_results.merge_all_results(chunk_results)
        return n_accept, consumed, n_skip

    def _chunk_loop(self, dispatch, chunk_size, current_params,
                    current_results, current_rep, pbar) -> int:
        """Chunk loop of the per-key and bulk paths: ``chunk_size(needed,
        metric)`` sizes the next chunk when ``needed`` attempts are still
        to accept and the stop metric reads ``metric``; ``dispatch(cursor,
        nk, metric)`` queues attempts ``[cursor, cursor + nk)`` and returns
        ``fetch()``, which waits for them and returns ``(host outputs,
        active)``.

        The loop gates on counts of its own: the accepted attempts, the
        cursor (``_accept_prefix``) and the stop metric's raw value, summed
        over the same rows in the same dtype as its Result sums it, so that
        it reads ``_stop_metric_value(current_results)`` once a chunk is
        booked. Under a stop criterion chunk k+1 is sized and dispatched as
        soon as chunk k's outputs are fetched, and chunk k is booked
        (``_consume_chunk``, progress, checkpoint) after that, inside an
        ``engine.deferred`` span, while the device runs chunk k+1; a
        point's last chunk is booked before the loop ends. A runner that
        overrides ``_keep_going`` gates on its Results, so there each chunk
        is booked before the gate."""
        cursor = current_rep + self._skipped_before(current_results)
        stop = self.batch_stop_criterion
        raw = 0
        if stop is not None and stop[0] in current_results and \
                current_results[stop[0]]:
            raw = current_results[stop[0]][-1]._value
        metric = float(raw)
        # Without a stop criterion chunk k+1 is dispatched before chunk k is
        # fetched, so the device runs it while the host accounts chunk k; a
        # mispredicted cursor or size discards it and stops speculating.
        speculate = stop is None
        defer = stop is not None and getattr(
            self._keep_going, "__func__", None) is SimulationRunner._keep_going
        pending: Optional[Tuple[int, int, Any]] = None
        deferred: Optional[Tuple] = None

        def book(out, nk, needed, elapsed, active, rep):
            with span("engine.account", attempts=nk):
                self._consume_chunk(out, nk, needed, elapsed,
                                    current_results, active)
            pbar.progress(rep)
            self._save_partial_results_maybe(rep, current_params,
                                             current_results)

        while current_rep < self.rep_max and \
                (stop is None or metric < float(stop[1])) and \
                self._keep_going(current_params, current_results,
                                 current_rep):
            tic = time.time()
            needed = self.rep_max - current_rep
            nk = chunk_size(needed, metric)
            if pending is not None and pending[:2] == (cursor, nk):
                fetch = pending[2]
            else:
                fetch = dispatch(cursor, nk, metric)
            pending = None
            if speculate and needed > nk:
                nk_next = chunk_size(needed - nk, metric)
                pending = (cursor + nk, nk_next,
                           dispatch(cursor + nk, nk_next, metric))
            if deferred is not None:
                with span("engine.deferred"):
                    book(*deferred)
                deferred = None
            out, active = fetch()
            elapsed = time.time() - tic
            accept, consumed = self._accept_prefix(out.get("__valid__"),
                                                   active, nk, needed)
            if stop is not None:
                values = out[stop[0]]
                values = values[0] if isinstance(values, tuple) else values
                raw = raw + np.asarray(values)[accept].sum()
                metric = float(raw)
            current_rep += int(np.count_nonzero(accept))
            cursor += consumed
            if consumed != nk:
                speculate = False
            chunk = (out, nk, needed, elapsed, active, current_rep)
            if defer and consumed:
                deferred = chunk
                continue
            book(*chunk)
            if not consumed:
                break    # the stop criterion gated the whole chunk off
        if deferred is not None:
            book(*deferred)
        self._merge_skip_count(current_results, 0)
        return current_rep

    # -- per-key path ------------------------------------------------------

    def _perkey_chunks(self, kernel, current_params):
        """The per-key path's ``(dispatch, chunk_size)``: chunks of
        ``min(batch, needed)`` attempts, rounded. Attempt ``a``'s streams
        depend only on ``(base_seed, unpack_index, a)``, so any chunking
        and any resume give the same accepted attempts."""
        from .._device import require_cuda
        seed = kernel_stream_seed(self.base_seed, current_params.unpack_index)
        executor = self._make_chunk_executor(kernel, seed,
                                             require_cuda(self.device))
        bsize = self._default_batch_size()
        return executor, \
            lambda needed, metric: min(bsize, self._round_chunk(needed))

    def _make_chunk_executor(self, kernel, seed: int, device):
        """Build ``executor(cursor, nk, prior_metric) -> fetch`` for the
        per-key path: ``fetch()`` returns ``(outputs, active)``, where
        ``outputs`` maps each result name to the kernel's per-attempt
        values on the host (``_host_outputs``) and ``active`` is None
        (every attempt ran) or a bool mask over the chunk. Without a stop
        criterion the host copies are queued at once and ``fetch`` waits
        for them.

        With ``batch_stop_criterion`` the chunk runs as
        ``num_stop_subchunks`` sub-chunks, each only while the accumulated
        stop metric (``prior_metric`` plus the valid attempts' metric so
        far, summed in float32) is below the limit: the rule of the JAX
        package's device ``scan``. The executor queues the first
        sub-chunk and returns; ``fetch`` then reads the sum on the host
        after each sub-chunk, one device synchronisation per sub-chunk (one
        fetch of each distinct output tensor, ``_fetch_each_once``), and
        dispatches the next sub-chunk before the host builds this one's
        outputs, so that the device runs it meanwhile. The calls are those
        of the rule, in its order. The rows of sub-chunks that did not run
        are zeros and inactive.

        Under a mesh every (sub-)chunk is split over ``mesh_axis``: rank
        ``r`` runs the kernel on the streams of attempts ``[start + r *
        n_local, start + (r + 1) * n_local)`` and every output is
        all-gathered, so each rank reads the same metric and takes the same
        continue / stop decision."""
        from ..ops.streams import AttemptStreams
        mesh, axis = self.mesh, self.mesh_axis

        def streams_for(start: int, n: int):
            if mesh is None:
                return AttemptStreams.from_range(seed, start, n, device)
            from ..parallel.mesh import shard_rows
            index, n_local = shard_rows(mesh, axis, n)
            return AttemptStreams.from_range(
                seed, start + index * n_local, n_local, device)

        def call(streams):
            with span("wrapper.call", attempts=streams.n):
                out = kernel(streams)
            if mesh is None:
                return out
            return _gather_outputs(mesh, axis, out, streams.n, device)

        if self.batch_stop_criterion is None:
            def executor(cursor, nk, prior_metric):
                del prior_metric
                out = call(streams_for(cursor, nk))
                names, wait = list(out), _fetch_each_once(list(out.values()))
                return lambda: (_host_outputs(dict(zip(names, wait())), nk),
                                None)

            return executor

        stop_name, limit = self.batch_stop_criterion
        limit = np.float32(limit)
        n_sub = max(int(self.num_stop_subchunks), 1)

        def executor(cursor, nk, prior_metric):
            sub = nk // n_sub   # nk is a _round_chunk multiple of n_sub
            first = call(streams_for(cursor, sub)) \
                if np.float32(prior_metric) < limit else None

            def fetch():
                acc = np.float32(prior_metric)
                parts = []
                out = first
                while out is not None:
                    metric = out[stop_name]
                    if isinstance(metric, tuple):
                        metric = metric[0]
                    valid = out.get("__valid__")
                    gate = [metric] if valid is None else [metric, valid]
                    wait = _fetch_each_once(gate + list(out.values()))
                    k = len(parts) + 1
                    # built while the copies are on their way; dropped if
                    # the gate closes
                    streams = streams_for(cursor + k * sub, sub) \
                        if k < n_sub else None
                    host = wait()
                    metric = np.asarray(host[0], np.float64)
                    if valid is not None:
                        metric = np.where(host[1], metric, 0)
                    acc = np.float32(acc + np.float32(metric.sum()))
                    following = call(streams) \
                        if streams is not None and acc < limit else None
                    outputs = dict(zip(out, host[len(gate):]))
                    with (span("engine.overlap") if following is not None
                          else nullcontext()):
                        parts.append(_host_outputs(outputs, sub))
                    out = following
                active = np.arange(nk) < len(parts) * sub
                merged = {name: _stack_rows([p[name] for p in parts], nk)
                          for name in parts[0]}
                return merged, active

            return fetch

        return executor

    # -- bulk path ---------------------------------------------------------

    def _bulk_chunks(self, bulk):
        """The bulk path's ``(dispatch, chunk_size)``: the kernel owns its
        rep axis; the runner only hands it an attempt cursor and a size."""
        bsize = self._default_batch_size()

        # Early stop at sub-chunk granularity: the kernel always receives a
        # size from a FIXED 4-entry ladder (bsize, bsize/2, bsize/4,
        # bsize/8 — rounded), so it builds at most 4 shapes; as the
        # accumulated stop metric approaches the limit the runner picks
        # the smallest rung that covers the EXPECTED remaining attempts
        # (estimated from the accepted-rep metric rate), landing within
        # ~bsize/8 of the threshold instead of overshooting by a chunk.
        ladder = sorted({self._round_chunk(max(bsize // d, 1))
                         for d in (8, 4, 2, 1)})

        def chunk_size(needed: int, metric: float) -> int:
            if self.batch_stop_criterion is None:
                return bsize
            nk = next((n for n in ladder if n >= needed), ladder[-1])
            limit = float(self.batch_stop_criterion[1])
            done = self.rep_max - needed
            if done > 0 and metric > 0:
                rate = metric / done
                expected = (limit - metric) / rate
                rung = ladder[0]
                for n in ladder:
                    if n <= expected:
                        rung = n
                nk = min(nk, rung)
            return nk

        def dispatch(start: int, n: int, metric: float):
            del metric
            with span("wrapper.call", attempts=n):
                out = bulk(start, n)
            names, wait = list(out), _fetch_each_once(list(out.values()))
            return lambda: (dict(zip(names, wait())), None)

        return dispatch, chunk_size

    @staticmethod
    def _parse_type_spec(spec) -> Tuple[int, Optional[int]]:
        if isinstance(spec, tuple):
            return int(spec[0]), int(spec[1])
        return int(spec), None
