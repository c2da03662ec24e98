#!/usr/bin/env python
"""Full CoMP block-diagonalization scenario on the PyTorch / CUDA port.

The counterpart of ``apps/comp_BD/simulate_comp.py``: a cell-grid cluster
with one user per cell (dropped at a random position each repetition, or
at the symmetric far-away border points), 3GPP path-loss channels, an
external interference source at the cluster border, and a sweep over
(SNR, Pe_dBm) comparing the stream-sacrifice metrics of EnhancedBD
("None", "naive", "fixed", "capacity", "effective_throughput") and
WhiteningBD, recording BER / SER / packet error rate / effective spectral
efficiency / mean SINR per metric. The same ``SPEC``, ``METRICS``, result
names and config files (``bd_config_file.txt``,
``bd_config_file_nonsquare.txt``) as the JAX app.

Two engines:

* ``engine="device"`` (default): the runner's bulk path. Per chunk the host
  draws the user drops and their path loss for every attempt (numpy, as the
  JAX app does), and the card draws the channels, data, external
  interference and noise, runs the batched solvers
  (``comm.batched.enhanced_bd_batched`` per metric and
  ``whitening_bd_batched``) and counts the errors of every stream. The
  chunk's outputs are device tensors, returned without a sync.
* ``engine="host"``: the runner's serial path on the host solver classes
  (``EnhancedBD``, ``WhiteningBD`` and ``MultiUserChannelMatrixExtInt``),
  one repetition at a time: the parity anchor.

Random streams. The drops ride numpy's Philox keyed by ``(base_seed,
unpack_index)`` exactly as in the JAX app (``_positions_for_attempts``
and ``_scenario_pathloss`` are its code), so both packages drop the users
at the same places for the same seed. Everything else of attempt ``a``
comes from ``ops.streams.AttemptStreams`` under the key
``kernel_stream_seed(base_seed, unpack_index)`` at attempt ``a``, split
(``AttemptStreams.split(5)``) into five sub-streams in this order: the
(K, K, Nr, Nt) user channel blocks, the (K, Nr, rank) external
interference channels, the (K, Nr, NSymbs) data symbols (``integers``,
so M must be a power of two), the (rank, NSymbs) external interference
signal and the (K * Nr, NSymbs) noise. The draws are not the JAX app's
(``jax.random``); the physics is.

Attempt cursor. The bulk engine's attempts are 0-based: a chunk covers
attempts ``[start, start + n)`` from 0. The host engine keys on the
runner's 1-based ``serial_attempt``, as the JAX app does, so its
repetition ``r`` (from 1) is attempt ``r``; both engines draw attempt
``a`` identically, so host repetition ``a`` is the bulk engine's attempt
``a``, its ``a + 1``-th row. The indices are the JAX app's so the drops
agree with it. The port compiles nothing, so it keeps no per-point
program cache.

Run: ``python apps/comp_BD/simulate_comp_torch.py [-c config] [-i index]
[--device cuda]``.
"""

import math
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from scipy.linalg import block_diag  # noqa: E402

from pyphysim_tpu_torch._device import require_cuda  # noqa: E402
from pyphysim_tpu_torch.cell.cell import Grid  # noqa: E402
from pyphysim_tpu_torch.channels.multiuser import \
    MultiUserChannelMatrixExtInt  # noqa: E402
from pyphysim_tpu_torch.channels.pathloss import PathLoss3GPP1  # noqa: E402
from pyphysim_tpu_torch.comm.batched import (  # noqa: E402
    _linear_sinrs, enhanced_bd_batched, whitening_bd_batched)
from pyphysim_tpu_torch.comm.blockdiagonalization import (  # noqa: E402
    EnhancedBD, WhiteningBD)
from pyphysim_tpu_torch.modulators import BPSK, PSK, QAM, QPSK  # noqa: E402
from pyphysim_tpu_torch.ops.streams import AttemptStreams  # noqa: E402
from pyphysim_tpu_torch.simulations import (Result,  # noqa: E402
                                            SimulationResults,
                                            SimulationRunner,
                                            kernel_stream_seed)
from pyphysim_tpu_torch.utils.conversion import (dB2Linear,  # noqa: E402
                                                 dBm2Linear)
from pyphysim_tpu_torch.utils.misc import (count_bit_errors,  # noqa: E402
                                           count_bits, randn_c)

# Config spec of the JAX app (simulate_comp.py SPEC)
SPEC = """[Grid]
cell_radius=float(min=0.01, default=1.0)
num_cells=integer(min=3, default=3)
num_clusters=integer(min=1, default=1)
[Scenario]
NSymbs=integer(min=10, max=1000000, default=500)
SNR=real_numpy_array(min=-50, max=100, default=0:3:31)
Pe_dBm=real_numpy_array(min=-50, max=100, default=[-10. 0. 10.])
Nr=integer(default=2)
Nt=integer(default=2)
N0=float(default=-116.4)
ext_int_rank=integer(min=1, default=1)
user_positioning_method=option("Random", 'Symmetric Far Away', default="Symmetric Far Away")
[Modulation]
M=integer(min=4, max=512, default=4)
modulator=option('PSK', 'QPSK', 'QAM', 'BPSK', default="PSK")
packet_length=integer(min=1, default=60)
[General]
rep_max=integer(min=1, default=5000)
unpacked_parameters=string_list(default=list('SNR','Pe_dBm'))
""".split("\n")

# result-name suffixes, the JAX app's
METRICS = ["None", "naive", "fixed", "capacity", "effec_throughput",
           "Whitening"]

CONFIG_DIR = os.path.dirname(os.path.abspath(__file__))


def _make_modulator(name: str, M: int, device):
    if name == "BPSK":
        return BPSK(device=device)
    if name == "QPSK":
        return QPSK(device=device)
    if name == "QAM":
        return QAM(M, device=device)
    return PSK(M, device=device)


def _hexagon_fan(cluster):
    """(centers (K,), vertices (K, 6)) complex arrays of the cluster's
    cells, for exact vectorized uniform sampling (each hexagon = a fan
    of 6 triangles around its center)."""
    centers = np.array([c.pos for c in cluster._cells])
    verts = np.stack([np.asarray(c.vertices) for c in cluster._cells])
    return centers, verts


def _solver_cases(metrics, modulator, packet_length):
    """(result suffix, enhanced_bd_batched metric, its keyword arguments)
    of the EnhancedBD metrics in ``metrics``, in METRICS order."""
    return [c for c in [
        ("None", None, {}),
        ("naive", "naive", {"num_streams": 1}),
        ("fixed", "fixed", {"num_streams": 1}),
        ("capacity", "capacity", {}),
        ("effec_throughput", "effective_throughput",
         {"modulator": modulator, "packet_length": packet_length}),
    ] if c[0] in metrics]


def draw_attempts(streams: AttemptStreams, spl: torch.Tensor,
                  spl_i: torch.Tensor, nr: int, nt: int, rank: int,
                  NSymbs: int, M: int, pe: float, noise_var: float):
    """Every random quantity of a chunk of attempts except the drops (the
    salt layout of the module docstring), on the streams' device.

    ``spl`` (n, K, K) and ``spl_i`` (n, K) are the square roots of the
    user-to-cell and ext-int-to-user path losses. Returns a dict: ``H``
    (n, K * nr, K * nt) joint channel, ``He`` (n, K * nr, rank) ext-int
    channel, ``R`` (n, K, nr, nr) ext-int-plus-noise covariances, ``data``
    (n, K, nr, NSymbs) int64 symbols, ``ext`` (n, rank, NSymbs) ext-int
    signal and ``noise`` (n, K * nr, NSymbs). ``M`` must be a power of
    two (``AttemptStreams.integers`` raises otherwise)."""
    n, K = spl.shape[0], spl.shape[1]
    kH, kE, kD, kX, kN = streams.split(5)
    Hb = randn_c(kH, K, K, nr, nt) * spl[:, :, :, None, None]
    H = Hb.permute(0, 1, 3, 2, 4).reshape(n, K * nr, K * nt)
    He = randn_c(kE, K, nr, rank) * spl_i[:, :, None, None]
    eye = torch.eye(nr, dtype=He.dtype, device=He.device)
    R = pe * (He @ He.mH) + noise_var * eye
    return {"H": H, "He": He.reshape(n, K * nr, rank), "R": R,
            "data": kD.integers(M, (K, nr, NSymbs)),
            "ext": randn_c(kX, rank, NSymbs) * math.sqrt(pe),
            "noise": randn_c(kN, K * nr, NSymbs) * math.sqrt(noise_var)}


def solve_attempts(draws, K: int, pt: float, metrics, modulator,
                   packet_length: int):
    """The precoders of every metric in ``metrics`` for a chunk of draws:
    ``({suffix: (Ms, Wk, Ns, sinrs)}, valid)``, ``valid`` the AND of every
    solver's validity mask (a degenerate draw is skipped and retried)."""
    H, R = draws["H"], draws["R"]
    nr = H.shape[-2] // K
    sols = {}
    valid = torch.ones(H.shape[0], dtype=torch.bool, device=H.device)
    for name, metric, kw in _solver_cases(metrics, modulator,
                                          packet_length):
        Ms, Wk, Ns, sinrs, ok = enhanced_bd_batched(H, R, K, pt,
                                                    metric=metric, **kw)
        sols[name] = (Ms, Wk, Ns, sinrs)
        valid = valid & ok
    if "Whitening" in metrics:
        Ms_w, Wk_w, ok_w = whitening_bd_batched(H, R, K, pt)
        valid = valid & ok_w
        # WhiteningBD keeps every stream; its SINRs take EnhancedBD's
        # formula on each user's own channel
        Heq = torch.stack([H[:, k * nr:(k + 1) * nr, :] @ Ms_w[:, k]
                           for k in range(K)], dim=1)
        sinr_w = _linear_sinrs(Wk_w, Heq, R)
        Ns_w = torch.full((H.shape[0], K), float(Ms_w.shape[-1]),
                          dtype=H.real.dtype, device=H.device)
        sols["Whitening"] = (Ms_w, Wk_w, Ns_w, sinr_w)
    return sols, valid


def account_attempts(draws, sols, modulator, packet_length: int):
    """Per-attempt results of every solver (the JAX app's per-stream
    accounting): BER / SER / PER as (errors, totals), spectral efficiency
    as (value, 1) and the SINR sum over the active streams; all device
    tensors of leading dim n."""
    H, data = draws["H"], draws["data"]
    n, K, nr, NSymbs = data.shape
    Kmod = modulator.K
    L = packet_length
    x = modulator.modulate(data)                      # (n, K, nr, NSymbs)
    interference = draws["He"] @ draws["ext"] + draws["noise"]
    stream = torch.arange(nr, device=H.device)
    out = {}
    for name, (Ms, Wk, Ns, sinrs) in sols.items():
        tx = (Ms @ x).sum(dim=1)                      # (n, Nt, NSymbs)
        rx = (H @ tx + interference).reshape(n, K, nr, NSymbs)
        decided = modulator.demodulate(Wk @ rx)       # (n, K, nr, NSymbs)
        active = stream < Ns[..., None]               # (n, K, nr)
        live = active[..., None]
        sym_errs = ((decided != data) & live).sum(dim=(1, 2, 3))
        stream_bits = (count_bits(data ^ decided) * live).sum(dim=-1)
        bit_errs = stream_bits.sum(dim=(1, 2))
        ber_s = stream_bits.to(torch.float32) / float(NSymbs * Kmod)
        per_s = 1.0 - (1.0 - ber_s) ** L
        zero = torch.zeros_like(per_s)
        pkg_errs = torch.where(active, per_s, zero).sum(dim=(1, 2)) * \
            float(NSymbs * Kmod / L)
        spec_eff = torch.where(active, (1.0 - per_s) * Kmod,
                               zero).sum(dim=(1, 2))
        n_streams = Ns.sum(dim=-1)
        n_syms = n_streams * NSymbs
        out[f"ber_{name}"] = (bit_errs, n_syms * Kmod)
        out[f"ser_{name}"] = (sym_errs, n_syms)
        out[f"per_{name}"] = (pkg_errs, n_syms * Kmod / L)
        out[f"spec_effic_{name}"] = (spec_eff, torch.ones_like(spec_eff))
        out[f"sinr_{name}"] = (sinrs.sum(dim=(1, 2)), n_streams)
    return out


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """float32 copy of a host array on ``device``; from pinned memory and
    without a host sync on the card."""
    t = torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


class BDSimulationRunner(SimulationRunner):
    """The JAX app's ``BDSimulationRunner``: one runner computes every
    metric of ``metrics`` (all six by default) per repetition, sharing its
    data, external interference and noise draws."""

    def __init__(self, read_command_line_args: bool = True,
                 engine: str = "device",
                 default_config_file: str = None,
                 metrics=None, device="cuda"):
        if default_config_file is None:
            default_config_file = os.path.join(CONFIG_DIR,
                                               "bd_config_file.txt")
        super().__init__(default_config_file, SPEC, read_command_line_args)
        if engine not in ("device", "host"):
            raise ValueError(f"engine must be 'device' or 'host', got "
                             f"{engine!r}")
        self.device = require_cuda(device)
        self.engine = engine
        self.metrics = list(METRICS if metrics is None else metrics)
        unknown = set(self.metrics) - set(METRICS)
        if unknown:
            raise ValueError(f"unknown metrics: {sorted(unknown)}")
        self.path_loss_obj = PathLoss3GPP1()
        self.cell_grid = Grid()
        self.cell_grid.create_clusters(int(self.params["num_clusters"]),
                                       int(self.params["num_cells"]),
                                       float(self.params["cell_radius"]))
        self._cluster0 = self.cell_grid.get_cluster_from_index(0)
        self._centers, self._verts = _hexagon_fan(self._cluster0)
        self.noise_var = float(dBm2Linear(float(self.params["N0"])))
        self.modulator = _make_modulator(str(self.params["modulator"]),
                                         int(self.params["M"]),
                                         self.device)
        self.rep_max = int(self.params["rep_max"])
        self.batch_size = 32
        self.progressbar_message = "SNR: {SNR}, Pe_dBm: {Pe_dBm}"
        self.batch_result_types = {}
        for m in self.metrics:
            for kind in ("ber", "ser", "per", "spec_effic", "sinr"):
                self.batch_result_types[f"{kind}_{m}"] = Result.RATIOTYPE
        # host channel object of the parity engine
        self.multiuser_channel = MultiUserChannelMatrixExtInt(
            device=self.device)
        self.multiuser_channel.noise_var = self.noise_var
        self.chunks_dispatched = 0

    # -- shared scenario helpers ------------------------------------------

    def _transmit_power(self, snr_db: float) -> float:
        """Transmit power giving the desired mean SNR at the cell
        border."""
        pl_border = float(self.path_loss_obj.calc_path_loss(
            float(self.params["cell_radius"])))
        return float(dB2Linear(snr_db)) * self.noise_var / pl_border

    def _positions_for_attempts(self, p, start: int, n: int) -> np.ndarray:
        """User positions (n, K) complex for absolute attempts
        [start, start+n) — a pure function of (base_seed, unpack_index,
        attempt), which is what makes the bulk path chunk-size
        invariant and resumable.

        Random drops ride ONE counter-based Philox stream keyed by
        (base_seed, unpack_index): attempt ``i`` owns a fixed
        BLOCK-ALIGNED draw window (Philox counters index 4-word output
        blocks, so each attempt gets ceil(3K/4) whole blocks — setting
        ``counter = start * blocks_per_attempt`` reaches it in O(1);
        ``Philox.advance`` does NOT align with stream positions and
        cannot be used here). Any chunking/resume therefore reads
        identical values, the whole chunk is one vectorized draw, and
        there is no per-attempt RandomState construction (which
        measured ~0.4 ms/attempt and dominated the engine at wide
        chunks)."""
        method = str(p["user_positioning_method"])
        K = self._centers.size
        if method != "Random":
            # Symmetric Far Away (simulate_comp.py:171-185): fixed
            # border points at 70% radius, angles 210 / -30 / 90 deg
            if K != 3:
                raise ValueError(
                    "'Symmetric Far Away' needs num_cells == 3")
            ang = np.deg2rad(np.array([210.0, -30.0, 90.0]))
            r = 0.7 * float(self.params["cell_radius"])
            return np.tile(self._centers + r * np.exp(1j * ang), (n, 1))
        B = 3 * K                          # doubles needed per attempt
        blocks = (B + 3) // 4              # whole 4-word blocks
        W = 4 * blocks                     # words drawn per attempt
        bg = np.random.Philox(
            key=np.array([self.base_seed & 0xFFFFFFFFFFFFFFFF,
                          max(p.unpack_index, 0)], dtype=np.uint64),
            counter=np.array([start * blocks, 0, 0, 0], np.uint64))
        u = np.random.Generator(bg).random(n * W).reshape(n, W)
        # exact triangle-fan hexagon sampling, vectorized over attempts
        tri = np.minimum((u[:, :K] * 6).astype(np.int64), 5)
        r1 = np.sqrt(u[:, K:2 * K])
        r2 = u[:, 2 * K:3 * K]
        k_idx = np.arange(K)[None, :]
        A = self._verts[k_idx, tri] - self._centers[None, :]
        Bv = self._verts[k_idx, (tri + 1) % 6] - self._centers[None, :]
        return self._centers[None, :] + r1 * (A + r2 * (Bv - A))

    def _positions_for_attempt(self, p, attempt: int) -> np.ndarray:
        """Scalar view of :meth:`_positions_for_attempts` (the host
        parity engine's per-repetition call — same stream, same
        values)."""
        return self._positions_for_attempts(p, attempt, 1)[0]

    def _scenario_pathloss(self, p, start: int, n: int):
        """sqrt path-loss arrays for attempts [start, start+n):
        (n, K, K) user-to-cell and (n, K) ext-int-to-user; one
        vectorized position draw + one vectorized path-loss call."""
        pos = self._positions_for_attempts(p, start, n)
        dists = np.abs(pos[:, :, None] - self._centers[None, None, :])
        spl = np.sqrt(self.path_loss_obj.calc_path_loss(dists))
        d_center = np.abs(pos - self._cluster0.pos)
        spl_i = np.sqrt(self.path_loss_obj.calc_path_loss(
            self._cluster0.external_radius - d_center))
        return np.asarray(spl), np.asarray(spl_i)

    def _point(self, p):
        """The scenario constants of a parameter point."""
        nr, nt = int(p["Nr"]), int(p["Nt"])
        return dict(K=self._centers.size, nr=nr, nt=nt,
                    rank=int(p["ext_int_rank"]), NSymbs=int(p["NSymbs"]),
                    M=int(p["M"]), L=int(p["packet_length"]),
                    pt=self._transmit_power(float(p["SNR"])),
                    pe=float(dBm2Linear(float(p["Pe_dBm"]))),
                    seed=kernel_stream_seed(self.base_seed,
                                            p.unpack_index))

    def _draw(self, p, c, start: int, n: int):
        """The draws of attempts [start, start + n) at point ``p``."""
        spl, spl_i = self._scenario_pathloss(p, start, n)
        streams = AttemptStreams.from_range(c["seed"], start, n,
                                            self.device)
        return draw_attempts(streams, _to_device(spl, self.device),
                             _to_device(spl_i, self.device), c["nr"],
                             c["nt"], c["rank"], c["NSymbs"], c["M"],
                             c["pe"], self.noise_var)

    # -- bulk engine (the card) --------------------------------------------

    def _gen_bulk_kernel(self, p):
        if self.engine != "device":
            return None
        c = self._point(p)
        if c["nt"] < c["nr"]:
            raise ValueError(
                "device engine needs Nt >= Nr per BS (the coherent "
                "stream-sacrifice family); use engine='host'")
        if c["M"] & (c["M"] - 1):
            raise ValueError(f"M must be a power of two, got {c['M']}")
        mod, L, metrics = self.modulator, c["L"], self.metrics

        def bulk(start, n):
            self.chunks_dispatched += 1
            draws = self._draw(p, c, start, n)
            sols, valid = solve_attempts(draws, c["K"], c["pt"], metrics,
                                         mod, L)
            out = account_attempts(draws, sols, mod, L)
            out["__valid__"] = valid
            return out    # device tensors, not synchronised

        return bulk

    # -- host parity engine (the serial path) ------------------------------

    def _run_simulation(self, current_parameters):
        p = current_parameters
        c = self._point(p)
        K, nr, nt, rank = c["K"], c["nr"], c["nt"], c["rank"]
        NSymbs, L, pt, pe = c["NSymbs"], c["L"], c["pt"], c["pe"]
        mod = self.modulator
        attempt = self.serial_attempt          # 1-based, the JAX app's
        pos = self._positions_for_attempt(p, attempt)
        dists = np.abs(pos[:, None] - self._centers[None, :])
        pathloss = np.asarray(self.path_loss_obj.calc_path_loss(dists))
        d_center = np.abs(pos - self._cluster0.pos)
        pathloss_int = np.asarray(self.path_loss_obj.calc_path_loss(
            self._cluster0.external_radius - d_center)).reshape(K, 1)

        # this attempt's draws, unscaled (the channel object applies the
        # path loss): the bulk engine's streams at the same attempt
        streams = AttemptStreams.from_range(c["seed"], attempt, 1,
                                            self.device)
        d = draw_attempts(streams, torch.ones(1, K, K, device=self.device),
                          torch.ones(1, K, device=self.device), nr, nt,
                          rank, NSymbs, c["M"], pe, self.noise_var)
        mu = self.multiuser_channel
        mu.init_from_channel_matrix(torch.cat([d["H"][0], d["He"][0]],
                                              dim=-1), nr, nt, K, rank)
        mu.set_pathloss(pathloss, pathloss_int)

        solvers = {}
        for name, metric, extra in _solver_cases(self.metrics, mod, L):
            bd = EnhancedBD(K, pt, self.noise_var, pe)
            bd.set_ext_int_handling_metric(metric, extra or None)
            solvers[name] = bd.block_diagonalize_no_waterfilling(mu)
        if "Whitening" in self.metrics:
            wbd = WhiteningBD(K, pt, self.noise_var, pe)
            solvers["Whitening"] = wbd.block_diagonalize_no_waterfilling(mu)

        big_H = mu.big_H.cpu().numpy()
        data_all = d["data"][0].cpu().numpy()            # (K, nr, NSymbs)
        ext_data = d["ext"][0].cpu().numpy()
        noise = d["noise"][0].cpu().numpy()
        results = SimulationResults()
        for name, (MsPk, Wk, Ns) in solvers.items():
            # user k sends on its first Ns[k] streams: the rows of the
            # shared data draw the bulk engine counts
            data = np.concatenate([data_all[k, :int(Ns[k])]
                                   for k in range(K)])
            Ns_total = data.shape[0]
            precoded = np.hstack(list(MsPk)) @ mod.modulate(data)
            received = big_H @ np.vstack([precoded, ext_data]) + noise
            decided = mod.demodulate(block_diag(*list(Wk)) @ received)
            sym_errs = int(np.sum(decided != data))
            bit_errs = int(count_bit_errors(data, decided))
            ber_s = np.array([
                int(count_bit_errors(data[s], decided[s])) /
                (NSymbs * mod.K) for s in range(Ns_total)])
            per_s = 1.0 - (1.0 - ber_s) ** L
            n_pkgs = NSymbs * mod.K / L
            sinr_all = mu.calc_JP_SINR(
                list(MsPk), [np.asarray(w).conj().T for w in Wk], pe)
            sinr_flat = torch.cat([s.reshape(-1) for s in sinr_all]).cpu()
            results.add_result(Result.create(
                f"ber_{name}", Result.RATIOTYPE, bit_errs,
                Ns_total * NSymbs * mod.K))
            results.add_result(Result.create(
                f"ser_{name}", Result.RATIOTYPE, sym_errs,
                Ns_total * NSymbs))
            results.add_result(Result.create(
                f"per_{name}", Result.RATIOTYPE,
                float(np.sum(per_s) * n_pkgs), Ns_total * n_pkgs))
            results.add_result(Result.create(
                f"spec_effic_{name}", Result.RATIOTYPE,
                float(np.sum((1 - per_s) * mod.K)), 1))
            results.add_result(Result.create(
                f"sinr_{name}", Result.RATIOTYPE,
                float(sinr_flat.sum()), int(sinr_flat.numel())))
        return results


def main():
    import argparse

    from pyphysim_tpu_torch.simulations import simulate_do_what_i_mean

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--engine", default="device",
                        choices=("device", "host"))
    args, _ = parser.parse_known_args()
    runner = BDSimulationRunner(engine=args.engine, device=args.device)
    runner.set_results_filename(
        "bd_results_{Nr}x{Nt}_ext_int_rank_{ext_int_rank}")
    simulate_do_what_i_mean(runner, ".")
    if runner.command_line_args.index is None:
        print(f"Runned iterations: {runner.runned_reps}")
        print(f"Elapsed Time: {runner.elapsed_time}")


if __name__ == "__main__":
    main()
