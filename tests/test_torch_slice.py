"""The ported slice end to end: the OFDM/TDL Monte Carlo app on the
port's SimulationRunner bulk path against the JAX app on the JAX runner.

Both apps run the flagship geometry (16-QAM, OFDM(512, 52, 300),
COST259-TU, Jakes with 16 rays) at tile 16, 2 tiles per repetition,
rep_max 4 in chunks of 2, at 10 and 25 dB, and both get the same numpy
bits for each absolute attempt: the JAX app's kernel in inject mode under
the Pallas interpreter, the port's app through its ``bit_source`` on the
plain PyTorch version. Each SNR point's ``bit_errors`` must agree within 16
per (rep, tile) cell — the JAX kernel test's decision-boundary slack.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from apps.ofdm.ofdm_mc_kernel import \
    OfdmMcKernelSimulationRunner as JaxApp  # noqa: E402
from apps.ofdm.ofdm_mc_kernel_torch import \
    OfdmMcKernelSimulationRunner as TorchApp  # noqa: E402
from pyphysim_tpu.ops.mc_pallas import MonteCarloOfdmTdl as J_MC  # noqa: E402
from pyphysim_tpu.utils.conversion import dB2Linear  # noqa: E402
from pyphysim_tpu_torch.ops.mc_kernel import MonteCarloOfdmTdl  # noqa: E402

TILE, NUM_TILES, REP_MAX, BATCH = 16, 2, 4, 2
SNRS = np.array([10.0, 25.0])


def attempt_bits(base_seed, unpack_index, start, n, TLp, used_p):
    """uint32 bits of attempts [start, start + n) in the inject layout,
    each attempt from its own numpy seed."""
    pb, db, n1, n2 = [], [], [], []
    for a in range(start, start + n):
        rng = np.random.default_rng([base_seed, unpack_index, a])
        pb.append(rng.integers(0, 2 ** 32, (8, TLp), dtype=np.uint32))
        for out in (db, n1, n2):
            out.append(rng.integers(0, 2 ** 32,
                                    (NUM_TILES * TILE, used_p),
                                    dtype=np.uint32))
    return tuple(np.stack(x) for x in (pb, db, n1, n2))


class JaxInjectApp(JaxApp):
    """The JAX app with its CPU bulk kernel fed the numpy bits."""

    def _gen_bulk_kernel(self, current_parameters):
        mc, nt = self.mc, self.num_tiles
        amp = np.float32(np.sqrt(0.5 / dB2Linear(
            float(current_parameters["SNR"]))) * mc.noise_gain)
        unpack = max(current_parameters.unpack_index, 0)
        bits_per_rep = float(self._bits_per_rep())

        def bulk(start, n):
            if n not in self._fns:
                self._fns[n] = mc.build_inject(n, nt)
            bits = attempt_bits(self.base_seed, unpack, start, n,
                                mc._TLp, mc._used_p)
            counts = np.asarray(self._fns[n](*bits, amp),
                                np.int64).sum(axis=1)
            return {"bit_errors": counts,
                    "ber": (counts.astype(float), np.full(n, bits_per_rep))}

        return bulk


def _configure(r, mc):
    r.params.add("SNR", SNRS)
    r.params.set_unpack_parameter("SNR")
    r.rep_max, r.batch_size = REP_MAX, BATCH
    r.tile, r.num_tiles = TILE, NUM_TILES
    r.mc = mc
    r.update_progress_function_style = None
    return r


def _torch_app(batch=BATCH):
    r = TorchApp(device="cpu", read_command_line_args=False)
    _configure(r, MonteCarloOfdmTdl(r.ofdm, r.channel, M=16, tile=TILE,
                                    device="cpu"))
    r.batch_size = batch
    return r


def test_slice_matches_jax_app():
    jr = JaxInjectApp()
    _configure(jr, J_MC(jr.ofdm, jr.channel, M=16, tile=TILE))
    jr.simulate()

    tr = _torch_app()
    mc = tr.mc
    tr.bit_source = lambda unpack, start, n: attempt_bits(
        tr.base_seed, unpack, start, n, mc.TLp, mc.used_p)
    tr.simulate()

    assert tr.runned_reps == jr.runned_reps == [REP_MAX] * len(SNRS)
    want = [int(v) for v in jr.results.get_result_values_list("bit_errors")]
    got = [int(v) for v in tr.results.get_result_values_list("bit_errors")]
    assert min(want) > 0
    for g, w in zip(got, want):
        assert abs(g - w) <= 16 * REP_MAX * NUM_TILES, (got, want)
    for r in (jr, tr):
        ber10, ber25 = r.results.get_result_values_list("ber")
        assert 0.0 < ber25 < ber10 < 0.5
    assert mc.launch_count == 0
    assert mc.reference_count == tr.chunks_dispatched == 4


def test_prng_mode_app_on_cpu():
    """The app's default (PRNG) mode on the CPU runs the plain version on
    the kernel's Philox bits: ordered BERs, chunk-size invariant."""
    a, b = _torch_app(batch=2), _torch_app(batch=4)
    a.simulate()
    b.simulate()
    ber = a.results.get_result_values_list("ber")
    assert 0.0 < ber[1] < ber[0] < 0.5
    assert a.results.get_result_values_list("bit_errors") == \
        b.results.get_result_values_list("bit_errors")
    assert (a.mc.launch_count, a.mc.reference_count) == (0, 4)
    assert b.chunks_dispatched == 2
