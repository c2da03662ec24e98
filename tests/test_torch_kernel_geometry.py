"""The BD and Max-SINR IA Monte Carlo kernels at geometries outside the
prebuilt kernel library (pyphysim_tpu_torch/ops/bd_kernel.py,
ops/ia_kernel.py), held against the JAX kernels on the same numpy bits,
and the build of one geometry's own library (ops/_build.py).

Tolerances and why:

* the plain version against the JAX kernel body (``_solve_block``, run
  eagerly as a plain function, as tests/test_torch_bd.py runs it) on
  identical bits: the same operations in the same order in float32, so
  each per-tile capacity sum (1,024 solves) agrees to rel 2e-4, the
  chip_smoke.py tolerance between the CUDA kernel and the plain version.
  The scale-relative guard (and, in IA, the closed-form init's switch and
  the determinant floors) is a discontinuity: a draw within float32
  rounding of it may take the other branch in one implementation, which
  moves a 1,024-solve sum by ~1e-3; the seeds below were drawn once.
* everything else is exact: constructor checks, attributes, build
  commands and library names.
"""

import ctypes
import subprocess
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from pyphysim_tpu.ops.bd_pallas import MonteCarloBD as J_BD  # noqa: E402
from pyphysim_tpu.ops.ia_pallas import MonteCarloMaxSinr as J_IA  # noqa: E402
from pyphysim_tpu_torch.ops import _build, bd_kernel, ia_kernel  # noqa: E402
from pyphysim_tpu_torch.ops.bd_kernel import MonteCarloBD  # noqa: E402
from pyphysim_tpu_torch.ops.ia_kernel import MonteCarloMaxSinr  # noqa: E402

REL = 2e-4


def _bits(seed, mc, reps, num_tiles):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2 ** 32, (reps, num_tiles * mc.tile,
                                     mc.num_planes * mc.lane),
                        dtype=np.uint32)


def _jax_tile_sums(jmc, bits, num_tiles, **kw):
    """The JAX kernel body on identical bits, eagerly, one call a tile (the
    BD body returns each element's capacity, the IA body their sum)."""
    tile, lane = jmc._tile, jmc._lane
    b = bits[0].astype(np.int32).reshape(num_tiles, tile, jmc.num_planes,
                                         lane)
    return np.array([
        np.asarray(jmc._solve_block(
            [jnp.asarray(t[:, i]) for i in range(jmc.num_planes)],
            **kw)).sum() for t in b])


# -- the plain versions against the JAX kernels ----------------------------

@pytest.mark.parametrize("K,NR", [(3, 1), (5, 1)])
@pytest.mark.parametrize("mode", ["normalized", "global", "none"])
def test_bd_plain_version_matches_jax_kernel_body(K, NR, mode):
    jmc = J_BD(tile=8, lane=128, K=K, Nr_u=NR, mode=mode)
    mc = bd_kernel.from_jax_attrs(vars(jmc), device="cpu")
    assert (mc.K, mc.Nr_u, mc.mode, mc.num_planes) == \
        (K, NR, mode, jmc.num_planes)
    bits = _bits(10 * K + NR, mc, 1, 2)
    want = _jax_tile_sums(jmc, bits, 2, noise_var=1.0, iPu=10.0 / 3)
    got = mc.build_inject(1, 2)(bits).numpy()[0]
    np.testing.assert_allclose(got, want, rtol=REL)
    assert (mc.launch_count, mc.reference_count) == (0, 1)
    assert 2.0 < got.sum() / (2 * mc.solves_per_grid_step) < 30.0


@pytest.mark.parametrize("K,N,Ns,iters", [(5, 2, 1, 1), (2, 3, 1, 2)])
def test_ia_plain_version_matches_jax_kernel_body(K, N, Ns, iters):
    jmc = J_IA(tile=8, lane=128, iterations=iters, K=K, N=N, Ns=Ns,
               init_iters=6)
    mc = ia_kernel.from_jax_attrs(vars(jmc), device="cpu")
    assert (mc.K, mc.N, mc.Ns, mc.iterations, mc.init_iters) == \
        (K, N, Ns, iters, 6)
    assert mc.closed_form == ((N, Ns) == (2, 1))
    bits = _bits(7 * K + N, mc, 1, 2)
    want = _jax_tile_sums(jmc, bits, 2, noise_var=jnp.float32(0.1))
    got = mc.build_inject(1, 2)(bits, 0.1).numpy()[0]
    np.testing.assert_allclose(got, want, rtol=REL)
    assert (mc.launch_count, mc.reference_count) == (0, 1)
    assert 1.0 < got.sum() / (2 * mc.solves_per_grid_step) < 40.0


# -- every geometry the JAX constructors take ------------------------------

@pytest.mark.parametrize("K,NR", [(2, 1), (3, 1), (6, 2), (7, 2), (12, 2)])
@pytest.mark.parametrize("mode", ["normalized", "global", "none"])
def test_bd_takes_every_jax_geometry(K, NR, mode):
    J_BD(K=K, Nr_u=NR, mode=mode)                 # the JAX kernel takes it
    mc = MonteCarloBD(tile=8, lane=128, K=K, Nr_u=NR, mode=mode,
                      device="cpu")
    assert mc.prebuilt == ((K, NR) in bd_kernel.PREBUILT)
    if K * NR <= 6:       # the plain version's PRNG route, on the CPU
        caps = mc.build(1, 1)(seed=3)
        assert caps.shape == (1, 1) and float(caps) > 0
    for bad in ({"K": 1}, {"Nr_u": 3}, {"Nr_u": 0}):
        with pytest.raises(ValueError):
            MonteCarloBD(device="cpu", **{"K": K, "Nr_u": NR, **bad})


@pytest.mark.parametrize("K,N,Ns", [(5, 2, 1), (2, 3, 1), (2, 3, 3),
                                    (3, 4, 2), (4, 4, 2), (2, 5, 4)])
def test_ia_takes_every_jax_geometry(K, N, Ns):
    J_IA(K=K, N=N, Ns=Ns)
    mc = MonteCarloMaxSinr(tile=8, lane=128, iterations=1, K=K, N=N, Ns=Ns,
                           init_iters=2, device="cpu")
    assert not mc.prebuilt
    if K * N <= 10:
        caps = mc.build(1, 1)(3, 0.1)
        assert caps.shape == (1, 1) and bool(torch.isfinite(caps).all())


# -- one library a geometry ------------------------------------------------

class _Lib:
    """A geometry's library: the IA wide form's scratch bytes; the BD wide
    form's partials and launch (128 threads and 32 elements a block: 4
    lanes a solve)."""

    def __init__(self, nbytes=0):
        self.nbytes = nbytes

    def mc_ia_scratch_bytes(self, reps, num_tiles, tile, lane):
        return self.nbytes

    def mc_bd_num_parts(self, tile, lane):
        return -(-tile * lane // 32)

    def mc_bd_launch_info(self, K, NR, mode, info):
        (ctypes.c_int * 6).from_address(info)[:] = [128, 0, 32, 4, 0, 2]
        return 0


def test_geometry_builds_and_library_names(monkeypatch):
    assert MonteCarloBD(K=3, Nr_u=2, device="cpu").geometry_build() is None
    assert MonteCarloBD(K=7, Nr_u=2, device="cpu").geometry_build() == \
        ("mc_bd", {"MC_BD_K": 7, "MC_BD_NR": 2})
    assert MonteCarloMaxSinr(K=3, N=4, Ns=1,
                             device="cpu").geometry_build() is None
    assert MonteCarloMaxSinr(K=3, N=4, Ns=2, device="cpu").geometry_build() \
        == ("mc_ia", {"MC_IA_K": 3, "MC_IA_N": 4, "MC_IA_NS": 2})
    a = _build.library_path(("mc_bd", {"MC_BD_K": 7, "MC_BD_NR": 2}))
    b = _build.library_path(("mc_bd", {"MC_BD_K": 8, "MC_BD_NR": 2}))
    assert a.parent == b.parent == _build.BUILD_DIR
    assert a.name.startswith("libmc_bd_K7_NR2_") and a.suffix == ".so"
    assert a != b != _build.library_path()
    # the wide form's profile asks its library how it launches
    monkeypatch.setattr(_build, "load", lambda geo=None: _Lib())
    assert MonteCarloBD(K=7, Nr_u=2, device="cpu").prng_kernel_profile(
        1, 1)["library"] == a
    assert MonteCarloBD(K=3, Nr_u=2, device="cpu").prng_kernel_profile(
        1, 1)["library"] == _build.library_path()


def test_wide_profiles(monkeypatch):
    """The SASS profile names the instance in the library it is built into:
    a BD geometry up to NT = 8 runs the prebuilt kernel's form and lists
    its loops (at odd NT the Philox calls that fill two entries), the BD
    wide form lists none (its bound is the solve's operations) and counts
    the threads its library says it launches (a group of lanes a solve),
    the IA wide closed form its Philox calls, iterations and block walk,
    while its library says the channels fit in shared memory."""
    assert bd_kernel.tile_form_max_nt() == 8
    tile = MonteCarloBD(tile=8, lane=512, K=3, Nr_u=1, mode="none",
                        device="cpu")
    assert not tile.wide_form and not tile.prebuilt
    assert tile.prng_kernel_profile(128, 4) == {
        "library": _build.library_path(tile.geometry_build()),
        "pattern": "mc_bd_kernelILi3ELi1ELi2ELb0EE",
        "threads": 128 * 4 * 8 * 512, "loops": 7,
        "loop_trips": [4, 3, 3, 3, 3, 3, 3]}
    assert not MonteCarloBD(K=8, Nr_u=1, device="cpu").wide_form
    assert MonteCarloBD(K=9, Nr_u=1, device="cpu").wide_form
    assert MonteCarloBD(K=5, Nr_u=2, device="cpu").wide_form
    assert not MonteCarloBD(K=4, Nr_u=2, device="cpu").wide_form
    asked = []
    monkeypatch.setattr(_build, "load",
                        lambda geo=None: asked.append(geo) or _Lib(0))
    bd = MonteCarloBD(tile=8, lane=512, K=7, Nr_u=2, mode="global",
                      device="cpu").prng_kernel_profile(128, 4)
    assert set(map(str, asked)) == {str(("mc_bd", {"MC_BD_K": 7,
                                                   "MC_BD_NR": 2}))}
    assert bd["pattern"] == "mc_bd_wide_kernelILi7ELi2ELi1ELb0EE"
    assert bd["library"].name.startswith("libmc_bd_K7_NR2_")
    assert bd["loops"] is None and bd["threads"] == 128 * 4 * 8 * 512 * 4
    asked.clear()
    ia = MonteCarloMaxSinr(tile=8, lane=512, iterations=10, K=5,
                           device="cpu").prng_kernel_profile(128, 4)
    assert asked == [("mc_ia", {"MC_IA_K": 5, "MC_IA_N": 2, "MC_IA_NS": 1})]
    assert ia["pattern"] == "mc_ia_wide_kernelILi5ELi2ELi1ELb0EE"
    assert ia["loops"] == 3 and ia["loop_trips"] == [50, 10, 1]
    assert ia["library"].name.startswith("libmc_ia_K5_N2_NS1_")
    monkeypatch.setattr(_build, "load", lambda geo=None: _Lib(1 << 20))
    with pytest.raises(ValueError, match="shared memory"):
        MonteCarloMaxSinr(K=16, device="cpu").prng_kernel_profile(1, 1)


class _FakeNvcc:
    """Stands for nvcc: records each command and writes its ``-o`` file."""

    def __init__(self, rc=0):
        self.rc, self.cmds = rc, []

    def __call__(self, cmd, stdout=None, stderr=None):
        self.cmds.append(cmd)
        if self.rc == 0:
            Path(cmd[cmd.index("-o") + 1]).write_text("lib")
        stdout.write("ptxas info    : Used 40 registers\n")
        return subprocess.CompletedProcess(cmd, self.rc)


def _fake_build(monkeypatch, tmp_path, rc=0):
    fake = _FakeNvcc(rc)

    class Proc:
        def __init__(self, cmd, stdout=None, stderr=None):
            self.returncode = fake(cmd, stdout, stderr).returncode

        def poll(self):
            return self.returncode

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "Popen", Proc)
    monkeypatch.setattr(_build, "geometry_build_seconds", {})
    return fake


def test_geometry_library_builds_from_the_sources_alone(monkeypatch,
                                                        tmp_path):
    fake = _fake_build(monkeypatch, tmp_path)
    geo = ("mc_bd", {"MC_BD_K": 7, "MC_BD_NR": 2})
    _build.build([geo], prebuilt=False)
    (cmd,) = fake.cmds
    assert cmd[0] == "nvcc" and "-shared" in cmd
    assert "-DMC_BD_K=7" in cmd and "-DMC_BD_NR=2" in cmd
    assert cmd[-1] == str(_build.SRC_DIR / "mc_bd.cu")
    assert "arch=compute_90a,code=sm_90a" in cmd
    path = _build.library_path(geo)
    assert path.exists() and path.with_suffix(".log").exists()
    assert list(_build.geometry_build_seconds) == [path.name]
    _build.build([geo], prebuilt=False)         # built: nothing to do
    assert len(fake.cmds) == 1


def test_geometry_library_loads_once(monkeypatch, tmp_path):
    """A geometry's library is built, loaded and declared on its first
    launch; later launches find it by the geometry, without hashing the
    sources again."""
    fake = _fake_build(monkeypatch, tmp_path)
    monkeypatch.setattr(_build, "_geometry_libs", {})

    class Lib:                                  # stands for the CDLL
        def __getattr__(self, name):
            return lambda *args: 0

    loaded = []
    monkeypatch.setattr(_build.ctypes, "CDLL",
                        lambda path: loaded.append(path) or Lib())
    lib = _build.load(("mc_bd", {"MC_BD_K": 7, "MC_BD_NR": 2}))
    assert loaded == [str(_build.library_path(
        ("mc_bd", {"MC_BD_K": 7, "MC_BD_NR": 2})))]
    hashed = []
    monkeypatch.setattr(_build, "_sources_hash",
                        lambda *extra: hashed.append(extra) or "0")
    assert _build.load(("mc_bd", {"MC_BD_NR": 2, "MC_BD_K": 7})) is lib
    assert (hashed, len(loaded), len(fake.cmds)) == ([], 1, 1)


def test_build_starts_geometries_beside_the_prebuilt_library(monkeypatch,
                                                             tmp_path):
    fake = _fake_build(monkeypatch, tmp_path)
    monkeypatch.setattr(_build.subprocess, "run",
                        lambda cmd, **kw: fake(cmd, _Sink()))
    geos = [("mc_bd", {"MC_BD_K": 3, "MC_BD_NR": 1}),
            ("mc_ia", {"MC_IA_K": 5, "MC_IA_N": 2, "MC_IA_NS": 1})]
    lib = _build.build(geos)
    sources = sorted(_build.SRC_DIR.glob("*.cu"))
    compiles = [c for c in fake.cmds if "-c" in c]
    shared = [c for c in fake.cmds if "-shared" in c and "-c" not in c]
    assert len(compiles) == len(sources)
    assert len(shared) == 3                      # two geometries, one link
    assert lib.exists() and lib == _build.library_path()
    assert all(_build.library_path(g).exists() for g in geos)


class _Sink:
    def write(self, text):
        pass


def test_failed_geometry_build_raises(monkeypatch, tmp_path):
    _fake_build(monkeypatch, tmp_path, rc=1)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _build.build([("mc_ia", {"MC_IA_K": 3, "MC_IA_N": 4,
                                 "MC_IA_NS": 2})], prebuilt=False)
    assert not list(tmp_path.glob("*.so"))


def test_cuda_launch_outside_the_prebuilt_library_builds_it(monkeypatch):
    """On a CUDA tensor the wrapper asks for the geometry's own library and
    raises when it cannot be built: no fallback to the plain version."""
    def no_build(geometry=None):
        assert geometry is not None           # not the prebuilt library
        raise RuntimeError(f"nvcc failed: {geometry[0]}")

    monkeypatch.setattr(_build, "load", no_build)
    mc = MonteCarloBD(tile=8, lane=128, K=7, Nr_u=2, device="cpu")
    with pytest.raises(RuntimeError, match="nvcc failed: mc_bd"):
        mc._launch(1, 1, None, None, None)
    assert (mc.launch_count, mc.reference_count) == (0, 0)
    ia = MonteCarloMaxSinr(tile=8, lane=128, K=5, device="cpu")
    with pytest.raises(RuntimeError, match="nvcc failed: mc_ia"):
        ia._launch(1, 1, None, 0.1)
    assert (ia.launch_count, ia.reference_count) == (0, 0)
