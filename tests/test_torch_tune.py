"""What ``chip_smoke.py`` and the kernel tuners (``bin/tune_*_kernel.py``,
``bin/_tune.py``) compute without a card: the ``-Xptxas -v`` parser on a
canned log, the tuners' source substitutions against the committed CUDA
sources, and the BD bound of the fewest instructions known for the
function at the bench chunk."""

import os
import sys

import pytest

torch = pytest.importorskip("torch")

_BIN = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "bin")
sys.path.insert(0, _BIN)

import _tune  # noqa: E402
import chip_smoke  # noqa: E402
import tune_bd_kernel  # noqa: E402
import tune_mc_kernel  # noqa: E402
from pyphysim_tpu_torch.ops import _build, sass  # noqa: E402

# mangled names as nvcc gives them
_BD = ("_ZN40_GLOBAL__N__2e65895d_8_mc_bd_cu_1314b47012"
       "mc_bd_kernelILi3ELi2ELi{}ELb0EEEvNS_6ParamsE")
_MC = ("_ZN47_GLOBAL__N__a808642d_14_mc_ofdm_tdl_cu_ff0b38f318"
       "mc_ofdm_tdl_kernelILi16ELb0ELb1EEEvNS_6ParamsE")
_FIR = ("_ZN45_GLOBAL__N__57c7dba4_12_block_fir_cu_dba4674416"
        "block_fir_kernelEPK6float2S2_PS0_iiNS_10TapOffsetsE")


def _entry(name, regs, spill_stores=0):
    return (f"ptxas info    : Compiling entry function '{name}' for "
            f"'sm_90a'\n"
            f"ptxas info    : Function properties for {name}\n"
            f"    0 bytes stack frame, {spill_stores} bytes spill stores, "
            f"{spill_stores} bytes spill loads\n"
            f"ptxas info    : Used {regs} registers, used 1 barriers, "
            f"16 bytes smem\n"
            f"ptxas info    : Compile time = 5.0 ms\n")


LOG = (_entry(_BD.format(0), 56) + _entry(_BD.format(1), 255, 40) +
       _entry(_MC, 64) + _entry(_FIR, 30))


def test_ptxas_info_reads_each_instance():
    bd = chip_smoke.ptxas_info(LOG, "mc_bd_kernel")
    assert bd == {
        "mc_bd_kernelILi3ELi2ELi0ELb0E": "56 registers, 0 bytes stack "
        "frame, 0 bytes spill stores, 0 bytes spill loads",
        "mc_bd_kernelILi3ELi2ELi1ELb0E": "255 registers, 0 bytes stack "
        "frame, 40 bytes spill stores, 40 bytes spill loads"}
    mc = chip_smoke.ptxas_info(LOG, "mc_ofdm_tdl_kernel")
    assert list(mc) == ["mc_ofdm_tdl_kernelILi16ELb0ELb1E"]
    assert int(mc["mc_ofdm_tdl_kernelILi16ELb0ELb1E"].split()[0]) == 64
    # a kernel that is not a template of Params is not an instance
    assert chip_smoke.ptxas_info(LOG, "block_fir_kernel") == {}
    assert chip_smoke.ptxas_info("", "mc_bd_kernel") == {}


def test_substitute_raises_when_the_source_moved_on():
    assert _tune.substitute("v", "a b a", [("a", "c"), ("b", "d")]) == \
        "c d c"
    with pytest.raises(RuntimeError, match="v: the source has no 'x'"):
        _tune.substitute("v", "a b", [("x", "y")])


@pytest.mark.parametrize("tuner,source", [
    (tune_bd_kernel, "mc_bd.cu"), (tune_mc_kernel, "mc_ofdm_tdl.cu")])
def test_every_variant_applies_to_the_committed_source(tuner, source):
    text = (_build.SRC_DIR / source).read_text()
    for name, variant in tuner.VARIANTS.items():
        if tuner is tune_bd_kernel:
            subs = variant[0] + tune_bd_kernel._ONLY_3_2
        else:
            subs = variant
        _tune.substitute(name, text, subs)   # raises if a line moved


def test_bd_fewest_bound_at_the_bench_chunk():
    """0.3638 ms for 128 reps x 4 tiles x 8 x 512 solves: the bound the
    register-resident kernel's own listing gave (5,804 instructions a
    solve, instruction issue)."""
    solves = 128 * 4 * 8 * 512
    ms, pipe = sass.issue_bound_ms(chip_smoke.BD_FEWEST_SASS_PER_SOLVE,
                                   solves)
    assert pipe == "issue"
    assert ms == pytest.approx(0.3638273556592608, rel=1e-12)
    assert chip_smoke.BD_FEWEST_SASS_PER_SOLVE["total"] == pytest.approx(
        5803.83, abs=0.01)
