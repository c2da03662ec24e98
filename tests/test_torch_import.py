"""The PyTorch port's import and device contracts.

* ``import pyphysim_tpu_torch`` and every module of the ported slice leave
  ``jax`` and ``triton`` out of ``sys.modules`` (checked in a fresh
  interpreter, since this test process imports jax for the other tests).
* The kernel module imports without nvcc: the CUDA library is built on the
  first launch, never at import.
* Asking for a CUDA device without one raises instead of falling back to
  the CPU, and every public constructor and entry point asks for one
  unless the caller says ``device="cpu"``.
"""

import inspect
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SLICE_MODULES = [
    "pyphysim_tpu_torch._device",
    "pyphysim_tpu_torch.utils.conversion",
    "pyphysim_tpu_torch.utils.serialize",
    "pyphysim_tpu_torch.utils.misc",
    "pyphysim_tpu_torch.progressbar",
    "pyphysim_tpu_torch.simulations.parameters",
    "pyphysim_tpu_torch.simulations.configobjvalidation",
    "pyphysim_tpu_torch.simulations.results",
    "pyphysim_tpu_torch.simulations.runner",
    "pyphysim_tpu_torch.simulations",
    "pyphysim_tpu_torch.modulators.fundamental",
    "pyphysim_tpu_torch.modulators.ofdm",
    "pyphysim_tpu_torch.modulators",
    "pyphysim_tpu_torch.channels.fading_generators",
    "pyphysim_tpu_torch.channels.fading",
    "pyphysim_tpu_torch.channels",
    "pyphysim_tpu_torch.ops.philox",
    "pyphysim_tpu_torch.ops.streams",
    "pyphysim_tpu_torch.ops.sparse_dft",
    "pyphysim_tpu_torch.ops.fir",
    "pyphysim_tpu_torch.ops.fused_ofdm_tdl",
    "pyphysim_tpu_torch.ops.mc_kernel",
    "pyphysim_tpu_torch.ops._build",
    "pyphysim_tpu_torch.chain",
    "pyphysim_tpu_torch.mimo.mimo",
    "pyphysim_tpu_torch.mimo",
    "pyphysim_tpu_torch.comm.waterfilling",
    "pyphysim_tpu_torch.comm.batched",
    "pyphysim_tpu_torch.comm",
    "pyphysim_tpu_torch.ops.planes",
    "pyphysim_tpu_torch.ops.alamouti_kernel",
    "pyphysim_tpu_torch.ops.bd_kernel",
    "pyphysim_tpu_torch.ops.sass",
    "apps.ofdm.ofdm_mc_kernel_torch",
    "apps.ofdm.ofdm_tdlchannel_torch",
    "apps.mimo.alamouti_mc_kernel_torch",
    "apps.mimo.simulate_mimo_torch",
    "apps.comp_BD.batched_bd_capacity_torch",
]

IA_MODULES = [
    "pyphysim_tpu_torch.ops.ia_kernel",
    "pyphysim_tpu_torch.channels.multiuser",
    "pyphysim_tpu_torch.ia.iabase",
    "pyphysim_tpu_torch.ia.algorithms",
    "pyphysim_tpu_torch.ia.batched",
    "pyphysim_tpu_torch.ia",
    "apps.ia.ia_mc_kernel_torch",
    "apps.ia.batched_stream_selection_torch",
    "apps.ia.simple_ia_torch",
    "apps.ia.ia_SINRs_and_capacity_torch",
]
SLICE_MODULES += IA_MODULES

COMP_BD_MODULES = [
    "pyphysim_tpu_torch.subspace.projections",
    "pyphysim_tpu_torch.subspace.metrics",
    "pyphysim_tpu_torch.subspace",
    "pyphysim_tpu_torch.comm.blockdiagonalization",
    "pyphysim_tpu_torch.channels.pathloss",
    "pyphysim_tpu_torch.cell.shapes",
    "pyphysim_tpu_torch.cell.cell",
    "pyphysim_tpu_torch.cell",
    "pyphysim_tpu_torch.simulations.simulationhelpers",
    "apps.comp_BD.simulate_comp_torch",
    "apps.comp_BD.simulate_comp_bd_torch",
    "apps.comp_BD.simulate_comp_simple_torch",
    "apps.comp_BD.simulate_comp_with_ext_int_simple_torch",
    "apps.simple_BD_with_whitening_torch",
]
SLICE_MODULES += COMP_BD_MODULES

MIMO_MODULES = [
    "pyphysim_tpu_torch.channels.fading",
    "pyphysim_tpu_torch.channels.fading_generators",
    "pyphysim_tpu_torch.channels.singleuser",
    "pyphysim_tpu_torch.channels.antennagain",
    "pyphysim_tpu_torch.channels.noise",
    "pyphysim_tpu_torch.channels",
    "pyphysim_tpu_torch.reference_signals.zadoffchu",
    "pyphysim_tpu_torch.reference_signals.ts36211_tables",
    "pyphysim_tpu_torch.reference_signals.root_sequence",
    "pyphysim_tpu_torch.reference_signals.srs",
    "pyphysim_tpu_torch.reference_signals.dmrs",
    "pyphysim_tpu_torch.reference_signals.channel_estimation",
    "pyphysim_tpu_torch.reference_signals",
    "pyphysim_tpu_torch.channel_estimation.estimators",
    "pyphysim_tpu_torch.channel_estimation",
    "apps.simple_precoded_srs_torch",
    "apps.ia.simulate_ia_torch",
    "apps.ia.simulate_greedy_ia_torch",
    "apps.mimo.mu_mimo_interference_torch",
    "apps.channel_estimation_sweep_torch",
    "pyphysim_tpu_torch.pusch_chain",
    "apps.mimo.pusch_etu70_torch",
]
SLICE_MODULES += [m for m in MIMO_MODULES if m not in SLICE_MODULES]

PARALLEL_MODULES = [
    "pyphysim_tpu_torch.parallel.mesh",
    "pyphysim_tpu_torch.parallel.timeshard",
    "pyphysim_tpu_torch.parallel.launch",
    "pyphysim_tpu_torch.parallel",
    "pyphysim_tpu_torch.simulations.simulationhelpers",
    "apps.awgn_modulators.simulate_psk_torch",
    "apps.awgn_modulators.simulate_bpsk_torch",
    "apps.awgn_modulators.simulate_qam_torch",
    "apps.awgn_modulators.simulate_parallel_psk_torch",
]
SLICE_MODULES += PARALLEL_MODULES

LAST_NAMES_MODULES = [
    "pyphysim_tpu_torch.pointprocess.pointprocess",
    "pyphysim_tpu_torch.pointprocess",
    "pyphysim_tpu_torch.extra.matlab",
    "pyphysim_tpu_torch.extra.pgfplotshelper",
    "pyphysim_tpu_torch.extra",
    "pyphysim_tpu_torch.utils.testing",
    "pyphysim_tpu_torch.progressbar.progressbar",
]
LAST_APPS = [
    "apps.find_codebook_torch",
    "apps.ia.simple_maxsinr_quantized_torch",
    "apps.metis_scenarios.simulate_metis_scenario2_torch",
    "apps.waterfilling_tikz_draw_torch",
    "apps.ia.test_ia_feasibility_torch",
    "apps.metis_scenarios.simulate_metis_ps7_torch",
    "apps.ofdm.plot_ofdm_PSD_torch",
    "apps.testing_multiprocessing_progressbar_torch",
    "apps.configobj_usage_example_torch",
    "apps.ia.greedy_statistics_torch",
    "apps.ia.check_greedy_partial_results_torch",
    "apps.ia.ia_results_plots_torch",
]
SLICE_MODULES += LAST_NAMES_MODULES + LAST_APPS

# packages the card's machine lacks: imported only where they are used
OPTIONAL_PACKAGES = ("zmq", "IPython", "ipywidgets", "matplotlib",
                     "configobj")


def _run(code: str) -> str:
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


def test_package_import_is_light():
    out = _run("import sys, pyphysim_tpu_torch; "
               "print(sorted(m for m in ('jax', 'triton', 'torch') "
               "if m in sys.modules))")
    assert out.strip() == "[]"


def test_slice_modules_import_neither_jax_nor_triton():
    code = ("import importlib, sys\n"
            f"for m in {SLICE_MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'triton', 'pyphysim_tpu'))\n"
            "print(bad)\n")
    assert _run(code).strip() == "[]"


@pytest.mark.parametrize("name", IA_MODULES + COMP_BD_MODULES +
                         MIMO_MODULES + PARALLEL_MODULES +
                         LAST_NAMES_MODULES + LAST_APPS)
def test_ia_module_names_neither_jax_nor_the_jax_package(name):
    """The IA, comp_BD and MIMO channel slices' sources import nothing of
    jax or pyphysim_tpu (the interpreter-level check is
    test_slice_modules_import_neither_jax_nor_triton)."""
    import ast
    import importlib.util
    path = importlib.util.find_spec(name).origin
    with open(path) as f:
        tree = ast.parse(f.read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    assert not roots & {"jax", "jaxlib", "pyphysim_tpu", "triton"}, roots


def test_last_names_import_neither_jax_triton_nor_the_jax_package():
    out = _run("import sys\n"
               "import pyphysim_tpu_torch.pointprocess, "
               "pyphysim_tpu_torch.extra, pyphysim_tpu_torch.utils.testing\n"
               "print(sorted(m for m in sys.modules if m.split('.')[0] in "
               "('jax', 'jaxlib', 'triton', 'pyphysim_tpu')))\n")
    assert out.strip() == "[]"


def test_slice_modules_leave_the_optional_packages_unimported():
    """zmq, IPython, ipywidgets, matplotlib and configobj are imported only
    inside the classes and functions that use them."""
    code = ("import importlib, sys\n"
            f"for m in {SLICE_MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{OPTIONAL_PACKAGES!r}))\n")
    assert _run(code).strip() == "[]"


def _load_weak_scaling_script():
    """``bin/weak_scaling_curve_torch.py`` as a module, loaded from its
    path (``bin/`` is no package: a site package takes the name)."""
    import importlib.util
    path = os.path.join(REPO, "bin", "weak_scaling_curve_torch.py")
    spec = importlib.util.spec_from_file_location("weak_scaling_curve_torch",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_weak_scaling_script_imports_neither_jax_nor_triton():
    """``bin/`` is no package (a site package takes the name), so the
    script is loaded from its path."""
    path = os.path.join(REPO, "bin", "weak_scaling_curve_torch.py")
    code = ("import importlib.util, sys\n"
            f"spec = importlib.util.spec_from_file_location('w', {path!r})\n"
            "mod = importlib.util.module_from_spec(spec)\n"
            "spec.loader.exec_module(mod)\n"
            "import pyphysim_tpu_torch.parallel.launch\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'triton', 'pyphysim_tpu')))\n")
    assert _run(code).strip() == "[]"


def test_kernel_module_imports_without_building():
    from pyphysim_tpu_torch.ops import (_build, alamouti_kernel,  # noqa: F401
                                        bd_kernel, ia_kernel, mc_kernel)
    assert _build._lib is None
    path = _build.library_path()
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("libpyphysim_kernels_")
    assert "sm_90a" in " ".join(_build.NVCC_FLAGS)


def test_cuda_request_raises_without_cuda(monkeypatch):
    from apps.comp_BD.batched_bd_capacity_torch import (
        BatchedBDCapacityRunner, BDKernelCapacityRunner)
    from apps.mimo.alamouti_mc_kernel_torch import \
        AlamoutiMcKernelSimulationRunner
    from apps.mimo.simulate_mimo_torch import MimoSimulationRunner
    from apps.ofdm.ofdm_mc_kernel_torch import OfdmMcKernelSimulationRunner
    from pyphysim_tpu_torch._device import require_cuda
    from pyphysim_tpu_torch.channels import JakesSampleGenerator
    from pyphysim_tpu_torch.mimo import Alamouti
    from pyphysim_tpu_torch.modulators import OFDM
    from pyphysim_tpu_torch.ops.alamouti_kernel import MonteCarloAlamouti
    from apps.ia.batched_stream_selection_torch import StreamSelectionRunner
    from apps.ia.ia_mc_kernel_torch import IaMcKernelSimulationRunner
    from pyphysim_tpu_torch.channels import (MultiUserChannelMatrix,
                                             generate_jakes_samples)
    from pyphysim_tpu_torch.ops.bd_kernel import MonteCarloBD
    from pyphysim_tpu_torch.ops.ia_kernel import MonteCarloMaxSinr

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert require_cuda("cpu") == torch.device("cpu")
    assert require_cuda(None) == torch.device("cpu")
    from apps.comp_BD.simulate_comp_bd_torch import CompBDSimulationRunner
    from apps.comp_BD.simulate_comp_torch import BDSimulationRunner
    from pyphysim_tpu_torch.channels import MultiUserChannelMatrixExtInt
    from apps.channel_estimation_sweep_torch import EstimationSweepRunner
    from apps.ia.simulate_greedy_ia_torch import IAStreamSelSimulationRunner
    from apps.ia.simulate_ia_torch import (ClosedFormSimulationRunner,
                                           MaxSINRSimulationRunner)
    from apps.mimo.mu_mimo_interference_torch import \
        MuMimoInterferenceRunner
    from apps.simple_precoded_srs_torch import run as srs_run
    from pyphysim_tpu_torch.channels import (MuChannel, MuMimoChannel,
                                             SuChannel, SuMimoChannel)
    from apps.awgn_modulators.simulate_bpsk_torch import \
        VerySimpleBpskSimulationRunner
    from apps.awgn_modulators.simulate_psk_torch import \
        VerySimplePskSimulationRunner
    from apps.awgn_modulators.simulate_qam_torch import \
        VerySimpleQamSimulationRunner
    from pyphysim_tpu_torch.parallel import (init_multihost,
                                             make_host_chip_mesh, make_mesh)
    runners = (OfdmMcKernelSimulationRunner, AlamoutiMcKernelSimulationRunner,
               MimoSimulationRunner, BatchedBDCapacityRunner,
               BDKernelCapacityRunner, IaMcKernelSimulationRunner,
               StreamSelectionRunner, BDSimulationRunner,
               CompBDSimulationRunner, MuMimoInterferenceRunner,
               EstimationSweepRunner, IAStreamSelSimulationRunner,
               VerySimplePskSimulationRunner, VerySimpleBpskSimulationRunner,
               VerySimpleQamSimulationRunner)
    for make in (lambda: require_cuda("cuda"),
                 lambda: require_cuda(torch.device("cuda", 0)),
                 lambda: OFDM(64, 8, 32, device="cuda"),
                 lambda: JakesSampleGenerator(device="cuda"),
                 lambda: Alamouti(),
                 lambda: MonteCarloAlamouti(),
                 lambda: MonteCarloBD(),
                 lambda: MonteCarloMaxSinr(),
                 lambda: MultiUserChannelMatrix(),
                 lambda: MultiUserChannelMatrixExtInt(),
                 lambda: generate_jakes_samples(30.0),
                 lambda: SuChannel(), lambda: SuMimoChannel(2),
                 lambda: MuChannel(3), lambda: MuMimoChannel(2, 2, 2),
                 lambda: srs_run(),
                 lambda: make_mesh(), lambda: make_host_chip_mesh(),
                 lambda: init_multihost("localhost:1", 1, 0),
                 lambda: ClosedFormSimulationRunner(
                     "none", read_command_line_args=False),
                 lambda: MaxSINRSimulationRunner(
                     "none", read_command_line_args=False),
                 *(lambda cls=cls: cls(read_command_line_args=False)
                   for cls in runners)):
        with pytest.raises(RuntimeError, match="cuda"):
            make()


def test_default_ofdm_raises_without_a_card():
    """No silent CPU fallback: a default-constructed object asks for the
    card, and without one it raises."""
    from pyphysim_tpu_torch.modulators import OFDM
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="cuda"):
        OFDM(512, 52, 300)


def test_public_entry_points_default_to_the_card(monkeypatch):
    from apps.comp_BD.batched_bd_capacity_torch import (
        BatchedBDCapacityRunner, BDKernelCapacityRunner)
    from apps.mimo.alamouti_mc_kernel_torch import \
        AlamoutiMcKernelSimulationRunner
    from apps.mimo.simulate_mimo_torch import MimoSimulationRunner
    from apps.ofdm.ofdm_mc_kernel_torch import OfdmMcKernelSimulationRunner
    from apps.ofdm.ofdm_tdlchannel_torch import OfdmTdlSimulationRunner
    from pyphysim_tpu_torch import _device, mimo
    from pyphysim_tpu_torch.chain import ChainStep
    from pyphysim_tpu_torch.channels import (FadingSampleGenerator,
                                             JakesSampleGenerator,
                                             JakesState,
                                             RayleighSampleGenerator,
                                             RayleighState,
                                             TdlImpulseResponse,
                                             generate_jakes_samples)
    from pyphysim_tpu_torch.modulators import (BPSK, OFDM, PSK, QAM, QPSK,
                                               Modulator)
    from apps.ia.batched_stream_selection_torch import StreamSelectionRunner
    from apps.ia.ia_mc_kernel_torch import IaMcKernelSimulationRunner
    from apps.ia.ia_SINRs_and_capacity_torch import solve_all
    from apps.ia.simple_ia_torch import run as simple_ia_run
    from pyphysim_tpu_torch.channels import MultiUserChannelMatrix
    from pyphysim_tpu_torch.ops import (alamouti_kernel, bd_kernel,
                                        ia_kernel, mc_kernel)
    from pyphysim_tpu_torch.ops.streams import AttemptStreams
    from pyphysim_tpu_torch.simulations import SimulationRunner
    entry_points = [
        _device.require_cuda, OFDM, Modulator, PSK, QPSK, BPSK, QAM,
        JakesSampleGenerator, JakesState.from_numpy,
        RayleighSampleGenerator, RayleighState.from_numpy,
        TdlImpulseResponse.from_numpy, mc_kernel.MonteCarloOfdmTdl,
        mc_kernel.from_jax_arrays, ChainStep, AttemptStreams.from_range,
        OfdmMcKernelSimulationRunner, OfdmTdlSimulationRunner,
        mimo.MimoBase, mimo.Blast, mimo.MRT, mimo.MRC, mimo.SVDMimo,
        mimo.GMDMimo, mimo.Alamouti, alamouti_kernel.MonteCarloAlamouti,
        alamouti_kernel.from_jax_attrs, bd_kernel.MonteCarloBD,
        bd_kernel.from_jax_attrs, AlamoutiMcKernelSimulationRunner,
        MimoSimulationRunner, BatchedBDCapacityRunner,
        BDKernelCapacityRunner, ia_kernel.MonteCarloMaxSinr,
        ia_kernel.from_jax_attrs, MultiUserChannelMatrix,
        IaMcKernelSimulationRunner, StreamSelectionRunner, solve_all,
        simple_ia_run, FadingSampleGenerator, generate_jakes_samples]
    from apps.comp_BD import (simulate_comp_simple_torch,
                              simulate_comp_with_ext_int_simple_torch)
    from apps.comp_BD.simulate_comp_bd_torch import CompBDSimulationRunner
    from apps.comp_BD.simulate_comp_torch import BDSimulationRunner
    from apps.simple_BD_with_whitening_torch import run as simple_bd_run
    from pyphysim_tpu_torch.channels import MultiUserChannelMatrixExtInt
    entry_points += [
        BDSimulationRunner, CompBDSimulationRunner,
        MultiUserChannelMatrixExtInt, simulate_comp_simple_torch.simulate,
        simulate_comp_with_ext_int_simple_torch.simulate,
        simulate_comp_with_ext_int_simple_torch.simulate_device,
        simple_bd_run]
    from apps import simple_precoded_srs_torch as srs
    from apps.channel_estimation_sweep_torch import EstimationSweepRunner
    from apps.ia import simulate_greedy_ia_torch, simulate_ia_torch
    from apps.mimo.mu_mimo_interference_torch import \
        MuMimoInterferenceRunner
    from pyphysim_tpu_torch.channels import (MuChannel, MuMimoChannel,
                                             SuChannel, SuMimoChannel,
                                             jakes_state_from_numpy)
    entry_points += [
        SuChannel, SuMimoChannel, MuChannel, MuMimoChannel,
        jakes_state_from_numpy, srs.run, srs.channel,
        simulate_ia_torch.IASimulationRunner,
        simulate_ia_torch.ClosedFormSimulationRunner,
        simulate_ia_torch.AlternatingSimulationRunner,
        simulate_ia_torch.MinLeakageSimulationRunner,
        simulate_ia_torch.MaxSINRSimulationRunner,
        simulate_ia_torch.MMSESimulationRunner,
        simulate_ia_torch.main_simulate,
        simulate_greedy_ia_torch.IAStreamSelSimulationRunner,
        MuMimoInterferenceRunner, EstimationSweepRunner]
    from apps.awgn_modulators import (simulate_bpsk_torch,
                                      simulate_psk_torch, simulate_qam_torch)
    from pyphysim_tpu_torch import parallel
    entry_points += [
        simulate_psk_torch.VerySimplePskSimulationRunner,
        simulate_bpsk_torch.VerySimpleBpskSimulationRunner,
        simulate_qam_torch.VerySimpleQamSimulationRunner, parallel.make_mesh,
        parallel.make_host_chip_mesh, parallel.init_multihost]
    weak = _load_weak_scaling_script()
    entry_points += [weak.curve]
    from apps import (find_codebook_torch,
                      testing_multiprocessing_progressbar_torch)
    from apps.ia import (simple_maxsinr_quantized_torch,
                         test_ia_feasibility_torch)
    from apps.metis_scenarios import (simulate_metis_ps7_torch,
                                      simulate_metis_scenario2_torch)
    from apps.ofdm import plot_ofdm_PSD_torch
    entry_points += [
        find_codebook_torch.CodebookFinder, find_codebook_torch.find_codebook,
        simple_maxsinr_quantized_torch.run,
        simulate_metis_scenario2_torch.simulate,
        simulate_metis_ps7_torch.simulate, test_ia_feasibility_torch.run,
        test_ia_feasibility_torch.make_channel,
        plot_ofdm_PSD_torch.ofdm_signal,
        testing_multiprocessing_progressbar_torch.run,
        testing_multiprocessing_progressbar_torch.func]
    for fn in entry_points:
        default = inspect.signature(fn).parameters["device"].default
        assert default == "cuda", f"{fn.__qualname__} defaults to {default}"
    assert SimulationRunner(read_command_line_args=False).device == "cuda"
    assert weak.parse_args([]).device == "cuda"
    assert weak.parse_args(["--device", "cpu"]).device == "cpu"
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        weak.main([])        # asks for the card, and there is none


@pytest.mark.parametrize("name", [
    m for m in LAST_APPS if not m.endswith((
        "greedy_statistics_torch", "partial_results_torch",
        "ia_results_plots_torch"))])
def test_new_apps_ask_for_the_card_by_default(name, monkeypatch, tmp_path):
    """Each app's ``main`` with no arguments asks for ``--device cuda``,
    and without a card raises before it writes anything."""
    import importlib
    app = importlib.import_module(name)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        app.main([])
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("module, names", [
    ("pyphysim_tpu_torch.utils.misc", ["round_bf16"]),
    ("pyphysim_tpu_torch.channels.fading_generators",
     ["FadingSampleGenerator", "generate_jakes_samples"]),
    ("pyphysim_tpu_torch.channels",
     ["FadingSampleGenerator", "generate_jakes_samples"]),
    ("pyphysim_tpu_torch.utils.misc", ["full_precision"]),
    ("pyphysim_tpu_torch.channels",
     ["TdlMimoChannel", "SuChannel", "SuMimoChannel", "MuChannel",
      "MuMimoChannel", "jakes_state_from_numpy"]),
    ("pyphysim_tpu_torch.channels.fading",
     ["TdlMimoChannel", "tdl_filter_block_fft_mimo"]),
    ("pyphysim_tpu_torch.parallel",
     ["make_mesh", "make_host_chip_mesh", "shard_batch", "init_multihost",
      "corrupt_data_time_sharded"]),
    ("pyphysim_tpu_torch.progressbar",
     ["ProgressbarMultiProcessServer", "ProgressbarMultiProcessClient",
      "ProgressbarDistributedServerBase",
      "ProgressbarDistributedClientBase"]),
    ("pyphysim_tpu_torch.progressbar.progressbar",
     ["ProgressBarIPython", "ProgressbarZMQServer", "ProgressbarZMQClient"]),
    ("pyphysim_tpu_torch.progressbar",
     ["ProgressBarIPython", "ProgressbarZMQServer", "ProgressbarZMQClient"]),
    ("pyphysim_tpu_torch.utils.misc",
     ["xor", "qfunc_inv", "peig_h", "leig_h", "calc_unorm_autocorr",
      "calc_autocorr", "calc_decorrelation_matrix",
      "get_mixed_range_representation"]),
    ("pyphysim_tpu_torch.pointprocess",
     ["generate_random_points_in_circle",
      "generate_random_points_in_rectangle"]),
    ("pyphysim_tpu_torch.extra",
     ["to_mat_str", "generate_pgfplots_plotline", "ber_plot_options",
      "ser_plot_options"]),
    ("pyphysim_tpu_torch.utils.testing", ["SeedReplay"]),
    ("pyphysim_tpu_torch.reference_signals", ["LayeredOCCChannelEstimator"]),
    ("pyphysim_tpu_torch.ops.mimo_detect",
     ["sc_mmse_eq", "sc_mmse_eq_reference"]),
    ("pyphysim_tpu_torch.pusch_chain", ["PuschChainStep"]),
])
def test_new_names_are_exported(module, names):
    import importlib
    mod = importlib.import_module(module)
    for name in names:
        assert hasattr(mod, name), name
        assert name in getattr(mod, "__all__", names), name


def test_new_methods_exist():
    """The methods the JAX package has and earlier slices lacked."""
    from pyphysim_tpu_torch.channels import (FadingSampleGenerator,
                                             JakesSampleGenerator,
                                             RayleighSampleGenerator)
    from pyphysim_tpu_torch.modulators import PSK, Modulator
    from pyphysim_tpu_torch.ops.bd_kernel import block_threads
    from pyphysim_tpu_torch.simulations import SimulationRunner
    for name in ("calcTheoreticalPER", "calcTheoreticalSpectralEfficiency",
                 "plotConstellation"):
        assert callable(getattr(Modulator, name))
    assert callable(PSK.setPhaseOffset)
    from pyphysim_tpu_torch.channels import TdlImpulseResponse
    for name in ("plot_impulse_response", "plot_frequency_response"):
        assert callable(getattr(TdlImpulseResponse, name))
    assert callable(SimulationRunner.clear)
    for name in ("simulate_in_parallel", "wait_parallel_simulation"):
        assert callable(getattr(SimulationRunner, name))
    for cls in (JakesSampleGenerator, RayleighSampleGenerator):
        assert issubclass(cls, FadingSampleGenerator)
        for name in ("get_similar_fading_generator", "set_seed",
                     "generate_more_samples", "get_samples",
                     "skip_samples_for_next_generation"):
            assert callable(getattr(cls, name))
    assert block_threads() == 128


def test_cpu_builder_takes_the_plain_version():
    from apps.ofdm.ofdm_mc_kernel_torch import OfdmMcKernelSimulationRunner
    from pyphysim_tpu_torch.ops.mc_kernel import MonteCarloOfdmTdl
    r = OfdmMcKernelSimulationRunner(device="cpu",
                                     read_command_line_args=False)
    mc = MonteCarloOfdmTdl(r.ofdm, r.channel, M=16, tile=8, device="cpu")
    out = mc.build(2, 1)(seed=3, snr_linear=10.0, start=0)
    assert out.shape == (2, 1) and out.dtype == torch.int32
    assert out.device.type == "cpu"
    assert (mc.launch_count, mc.reference_count) == (0, 1)


@pytest.mark.parametrize("name", [m for m in SLICE_MODULES
                                  if m.startswith("pyphysim_tpu_torch")])
def test_doctests(name):
    import doctest
    import importlib
    results = doctest.testmod(importlib.import_module(name), verbose=False)
    assert results.failed == 0, f"{results.failed} doctest failures"
