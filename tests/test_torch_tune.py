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
import tune_fir_kernel  # noqa: E402
import tune_mc_kernel  # noqa: E402
from pyphysim_tpu_torch.ops import _build, fir, sass  # noqa: E402

# mangled names as nvcc gives them
_BD = ("_ZN40_GLOBAL__N__2e65895d_8_mc_bd_cu_1314b47012"
       "mc_bd_kernelILi3ELi2ELi{}ELb0EEEvNS_6ParamsE")
_MC = ("_ZN47_GLOBAL__N__a808642d_14_mc_ofdm_tdl_cu_ff0b38f318"
       "mc_ofdm_tdl_kernelILi16ELb0ELb1EEEvNS_6ParamsE")
_FIR = ("_ZN45_GLOBAL__N__57c7dba4_12_block_fir_cu_dba4674416"
        "block_fir_kernelEPK6float2S2_PS0_iiNS_10TapOffsetsE")
_FIR_T = ("_ZN45_GLOBAL__N__57c7dba4_12_block_fir_cu_dba4674416"
          "block_fir_kernelILi{}ELb1ELi2EEEvPK6float2S3_PS1_NS_8Geometry"
          "ENS_10TapOffsetsE")


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
FIR_LOG = _entry(_FIR_T.format(16), 72) + _entry(_FIR_T.format(64), 80)


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
    # a kernel that is no template has no instance
    assert chip_smoke.ptxas_info(LOG, "block_fir_kernel") == {}
    assert chip_smoke.ptxas_info("", "mc_bd_kernel") == {}
    # the FIR kernel's instances are templates of plain arguments
    fir_info = chip_smoke.ptxas_info(FIR_LOG, "block_fir_kernel")
    assert list(fir_info) == ["block_fir_kernelILi16ELb1ELi2E",
                              "block_fir_kernelILi64ELb1ELi2E"]
    assert fir_info["block_fir_kernelILi16ELb1ELi2E"].startswith(
        "72 registers")


def test_substitute_raises_when_the_source_moved_on():
    assert _tune.substitute("v", "a b a", [("a", "c"), ("b", "d")]) == \
        "c d c"
    with pytest.raises(RuntimeError, match="v: the source has no 'x'"):
        _tune.substitute("v", "a b", [("x", "y")])


@pytest.mark.parametrize("tuner,source", [
    (tune_bd_kernel, "mc_bd.cu"), (tune_mc_kernel, "mc_ofdm_tdl.cu"),
    (tune_fir_kernel, "block_fir.cu")])
def test_every_variant_applies_to_the_committed_source(tuner, source):
    text = (_build.SRC_DIR / source).read_text()
    for name, variant in tuner.VARIANTS.items():
        if tuner is tune_bd_kernel:
            subs = variant[0] + tune_bd_kernel._ONLY_3_2
        else:
            subs = variant
        _tune.substitute(name, text, subs)   # raises if a line moved


@pytest.mark.parametrize("tuner,table,source", [
    (tune_mc_kernel, "GENERAL_VARIANTS", "mc_ofdm_tdl.cu"),
    (tune_fir_kernel, "SEG_VARIANTS", "block_fir.cu")])
def test_redesigned_forms_variants_set_only_their_constants(tuner, table,
                                                            source):
    """The flagship general form's and the segments form's variants each
    apply to the committed source and change the constants they name, and
    nothing else: their kernels plan from their own constants."""
    import re
    text = (_build.SRC_DIR / source).read_text()

    def constants(t):
        return {m.group(1): m.group(2) for m in re.finditer(
            r"constexpr (?:int|long long|bool) (k\w+) = (\w+);", t)}
    base = constants(text)
    for name, subs in getattr(tuner, table).items():
        got = constants(_tune.substitute(name, text, subs))
        if not any("constexpr" in old for old, _ in subs):
            assert got == base, name      # a pragma or a bound, no constant
            continue
        changed = {k for k in base if got[k] != base[k]}
        named = {re.search(r"constexpr (?:int|bool) (k\w+)", old).group(1)
                 for old, _ in subs}
        assert changed == named, name


def test_fir_diagnostic_variants_apply():
    """The segments form's diagnostic variants (its loads alone, its
    compute alone) each change one line of the committed source, and
    are built only with the segments form's shapes."""
    text = (_build.SRC_DIR / "block_fir.cu").read_text()
    for name, subs in tune_fir_kernel.DIAGNOSTIC_VARIANTS.items():
        got = _tune.substitute(name, text, subs)
        assert len(set(got.splitlines()) - set(text.splitlines())) == 1
    assert not set(tune_fir_kernel.DIAGNOSTIC_VARIANTS) & set(
        tune_fir_kernel.sources(None))
    assert set(tune_fir_kernel.DIAGNOSTIC_VARIANTS) <= set(
        tune_fir_kernel.sources(None, segments=True))


def test_mc_tuner_sources_follow_the_shapes(tmp_path):
    """``bin/tune_mc_kernel.py`` builds the committed source, the fast
    instance's variants only for the flagship shape, the general form's
    only for f1, and the parent's ``mc_ofdm_tdl.cu`` where given (called
    through its own interface: the committed source has the launch's tile
    range, the earlier one had not)."""
    parent = tmp_path / "pyphysim_tpu_torch" / "ops" / "csrc"
    parent.mkdir(parents=True)
    (parent / "mc_ofdm_tdl.cu").write_text("// the parent's\n")
    f2 = tune_mc_kernel.sources(str(tmp_path), ("f2tiles",))
    assert sorted(f2) == sorted([tune_mc_kernel.COMMITTED, "parent"])
    assert f2["parent"] == ("// the parent's\n", parent)
    assert "int tile0" in f2[tune_mc_kernel.COMMITTED][0]
    f1 = tune_mc_kernel.sources(None, ("f1",))
    assert sorted(f1) == sorted([tune_mc_kernel.COMMITTED,
                                 *tune_mc_kernel.GENERAL_VARIANTS,
                                 *tune_mc_kernel.LAYOUT_VARIANTS])
    both = tune_mc_kernel.sources(None, ("flagship", "f1"))
    assert len(both) == len(tune_mc_kernel.VARIANTS) + len(
        tune_mc_kernel.GENERAL_VARIANTS) + len(
        tune_mc_kernel.LAYOUT_VARIANTS)
    # each layout keeps every field once and moves only the first tile
    for name in tune_mc_kernel.LAYOUT_VARIANTS:
        text = both[name][0]
        assert text.count("  int tile0;\n") == 1
        assert sorted(text.splitlines()) == sorted(
            both[tune_mc_kernel.COMMITTED][0].splitlines())
    assert set(tune_mc_kernel.SHAPES) == {"flagship", "f1", "f2tiles"}
    assert tune_fir_kernel.shape("ht20")[:2] == (1024, 8192)
    assert tune_fir_kernel.shape("ht100")[2][-1] + 1 > 1800
    rows, block, offsets = tune_fir_kernel.shape("b1")
    assert (rows, block, offsets) == (8192, 564, list(range(81)))


def test_fir_variants_plan_from_their_own_constants():
    """Each FIR variant's text sets the constant the tuner names, and
    nothing else differs from the committed source: the kernel plans its
    launch from its own constants (``block_fir.cu`` ``make_plan``, read
    through each variant's ``block_fir_plan``), so the row buffers, warps
    and rows a warp a variant runs are the ones it names."""
    import re
    sources = tune_fir_kernel.sources(None)
    committed = sources["committed"][0]

    def constants(text):
        return {m.group(1): int(m.group(2)) for m in re.finditer(
            r"constexpr int (k\w+) = (\d+);", text)}
    base = constants(committed)
    assert {k: base[k] for k in ("kWarps", "kRowsPerWarp", "kStages",
                                 "kChunks")} == {
        "kWarps": 4, "kRowsPerWarp": 8, "kStages": 2, "kChunks": 4}
    assert "block_fir_plan" in committed and "make_plan" in committed
    want = {"1 row in flight (no ring)": ("kStages", 1),
            "4 row buffers a warp": ("kStages", 4),
            "8 warps a block": ("kWarps", 8),
            "4 rows a warp": ("kRowsPerWarp", 4),
            "2 chunks a lane": ("kChunks", 2)}
    for name, (const, value) in want.items():
        got = constants(sources[name][0])
        assert got == {**base, const: value}, name
    assert len(sources) == len(tune_fir_kernel.VARIANTS)


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


@pytest.mark.parametrize("fused", [False, True])
def test_fill_main_path_parity_sees_every_draw_of_a_step(monkeypatch,
                                                         fused):
    """``chip_smoke.fill_main_path_parity`` at a small chain step on the
    CPU (both sides the plain version there): it records the step's three
    draws (symbol bits, channel uniforms, noise normals) at their own
    shapes, over attempts across 2**32, and finds them equal."""
    import torch
    from pyphysim_tpu_torch.chain import ChainStep
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    chain = ChainStep(300 * 2, 512, 52, 300, block_static=True, fused=fused,
                      device="cpu")
    lines = []
    monkeypatch.setattr(chip_smoke, "phase",
                        lambda name, **f: lines.append(f))
    assert chip_smoke.fill_main_path_parity("cpu", "small", chain, 4) == 0.0
    shapes = {f["kind"]: f["shape"] for f in lines}
    assert shapes["bits"] == f"4x{600 // 8}"
    assert shapes["normal"] == f"4x{2 * chain.noise_length}"
    assert all(f["differ_from_plain"] == 0 for f in lines)
    draws = chip_smoke.recorded_draws(lambda: None)
    assert draws == []


def test_wide_tuner_variants(tmp_path, monkeypatch):
    """``bin/tune_wide_kernel.py``: at every geometry the committed source
    (a library of one geometry, or the prebuilt one) and the parent's; with
    ``--grid`` also every pair of lanes a user's solve (at most
    ``MAX_ROWS`` rows a lane) and users at once (within a warp, below 2 K),
    each a copy of the source whose Lu and U rules alone are replaced by
    the pair, and 1 or 2 warps a block, in a copy of the headers whose
    ``wide.cuh`` alone differs in ``kMaxWarps``."""
    import tune_wide_kernel as tw
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    parent = tmp_path / "parent" / "pyphysim_tpu_torch" / "ops" / "csrc"
    parent.mkdir(parents=True)
    for f in ("mc_bd.cu", "mc_ia.cu"):
        (parent / f).write_text(f"// the parent's {f}\n")
    bd_text = (_build.SRC_DIR / "mc_bd.cu").read_text()
    ia_text = (_build.SRC_DIR / "mc_ia.cu").read_text()
    points, srcs = tw.sources(str(tmp_path / "parent"), None)
    assert [(s, g) for s, g, _ in points] == [
        *(("mc_bd", g) for g in tw.BD_POINTS),
        *(("mc_ia", g) for g in tw.IA_POINTS)]
    assert sorted(n for (s, g, n) in srcs if g == (7, 2)) == [
        "committed", "parent"]
    assert srcs["mc_bd", (7, 2), "committed"] == (
        bd_text, _build.SRC_DIR, {"MC_BD_K": 7, "MC_BD_NR": 2})
    assert srcs["mc_bd", (7, 2), "parent"] == (
        "// the parent's mc_bd.cu\n", parent, {"MC_BD_K": 7, "MC_BD_NR": 2})
    # the prebuilt IA points share one library each side: the whole source
    assert srcs["mc_ia", "prebuilt", "committed"] == (
        ia_text, _build.SRC_DIR, {})
    assert srcs["mc_ia", "prebuilt", "parent"][2] == {}

    _, grid = tw.sources(str(tmp_path / "parent"), None, grid=True)
    names = {k[1:]: v for k, v in grid.items() if k[0] == "mc_bd"}
    # (7, 2): 14 rows, so 4, 8 or 16 lanes a user; users within a warp
    assert sorted(n for g, n in names if g == (7, 2)) == sorted(
        ["committed", "parent", "1 warp a block", "2 warps a block"] +
        [f"{n} lanes a user, {u} users at once" for n in (4, 8, 16)
         for u in (1, 2, 4, 8) if n * u <= 32])
    # (11, 2): 22 rows, 4 lanes a user would hold 6 a lane
    assert {n for g, n in names if g == (11, 2)} == {
        "committed", "parent", "1 warp a block", "2 warps a block",
        *(f"{n} lanes a user, {u} users at once" for n in (8, 16)
          for u in (1, 2, 4) if n * u <= 32)}
    text, include, defines = names[(7, 2), "16 lanes a user, 2 users at once"]
    assert include == _build.SRC_DIR
    assert defines == {"MC_BD_K": 7, "MC_BD_NR": 2}
    assert text == bd_text.replace(
        "static constexpr int Lu = wide::lanes_for((NT + 3) / 4, 4);",
        "static constexpr int Lu = 16;").replace(
        "static constexpr int U = default_users();",
        "static constexpr int U = 2;")
    assert text != bd_text
    text, include, defines = names[(7, 2), "2 warps a block"]
    assert text == bd_text and defines == {"MC_BD_K": 7, "MC_BD_NR": 2}
    assert include.parent == tmp_path / "tune"
    for header in _build.SRC_DIR.glob("*.cuh"):
        copy = (include / header.name).read_text()
        if header.name == "wide.cuh":
            assert copy == header.read_text().replace(
                "constexpr int kMaxWarps = 4;", "constexpr int kMaxWarps = 2;")
            assert copy != header.read_text()
        else:
            assert copy == header.read_text()
    ia = {k[1:]: v for k, v in grid.items() if k[0] == "mc_ia"}
    assert sorted(n for g, n in ia if g == (3, 4, 2)) == sorted(
        ["committed", "parent", "1 warp a block", "2 warps a block"] +
        [f"{n} lanes a user, {u} users at once" for n in (2, 4, 8)
         for u in (1, 2, 4)])
    text, _, defines = ia[(3, 4, 2), "8 lanes a user, 1 users at once"]
    assert defines == {"MC_IA_K": 3, "MC_IA_N": 4, "MC_IA_NS": 2}
    assert text == ia_text.replace(
        "static constexpr int Lu = wide::lanes_for((N + 1) / 2, 1);",
        "static constexpr int Lu = 8;").replace(
        "static constexpr int U = Lu < 32 ? 2 : 1;",
        "static constexpr int U = 1;")
    # the prebuilt IA library's variants change every general-body instance
    assert ia["prebuilt", "4 lanes a user, 2 users at once"][2] == {}
    # a source whose rule moved on is refused, not timed as the committed
    monkeypatch.setitem(tw._RULES, "mc_ia", ("no such rule", "nor this"))
    with pytest.raises(RuntimeError, match="no such rule"):
        tw.sources(None, "ia", grid=True)


def test_probe_stops_a_build_at_its_timeout():
    """``bin/probe_wide_builds.py``: a build that outlasts ``--timeout`` is
    stopped with every process it started (its process group), one that
    ends in time gets its seconds; the geometry's library is the one
    ``ops/_build.py`` would build."""
    import subprocess
    import time

    import probe_wide_builds as pw
    slow = subprocess.Popen(["bash", "-c", "sleep 30 & sleep 30"],
                            start_new_session=True)
    quick = subprocess.Popen(["true"], start_new_session=True)
    tic = time.time()
    seconds = pw.wait_all({"slow": slow, "quick": quick}, timeout=1.0)
    assert time.time() - tic < 10
    assert seconds["slow"] is None and slow.returncode is not None
    assert 0 <= seconds["quick"] < 2
    assert pw.kernel_of("mc_bd", (61, 2), "cpu").geometry_build() == (
        "mc_bd", {"MC_BD_K": 61, "MC_BD_NR": 2})
    assert pw.kernel_of("mc_ia", (15, 4, 2), "cpu").geometry_build() == (
        "mc_ia", {"MC_IA_K": 15, "MC_IA_N": 4, "MC_IA_NS": 2})
