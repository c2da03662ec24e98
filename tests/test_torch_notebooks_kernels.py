"""The port's notebook 09, the kernel tier, run end to end on the CPU (the
kernels' plain versions), held against the JAX package's kernel bodies.

* The IA menu's mean sum capacities a solve, on the notebook's own numpy
  bits, against the JAX kernel bodies within rel 2e-4, the chip_smoke.py
  tolerance between the CUDA kernel and its plain version: at (3, 2, 1)
  the closed-form body ``_solve_block`` (jitted under vmap, as
  tests/test_torch_ia_kernel.py runs it); at (2, 4, 2) the general body
  ``_solve_block_general`` on the whole block, run op by op (jitting its
  unrolled program takes ~40 s on a CPU, running it ~3 s).
* The BD sweep's mean capacities are finite and grow with the power, and
  the sharded BD builds (the 1-rank mesh, and the 2- and 4-rank splits as
  per-rank launches) equal the unsharded build bit for bit. The notebook
  releases the process group it started.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_notebooks import run_notebook  # noqa: E402


def test_notebook_09_kernel_tier_against_jax(tmp_path, monkeypatch):
    import torch.distributed as dist
    from pyphysim_tpu.ops.ia_pallas import MonteCarloMaxSinr as J_MC
    ns = run_notebook("09", tmp_path, monkeypatch)
    assert not dist.is_initialized()

    caps = ns["caps"]
    assert np.isfinite(caps).all() and (np.diff(caps) > 0).all()
    assert ns["runner"].runned_reps == [2, 2, 2]
    assert ns["equal"] == {1: True, 2: True, 4: True}
    assert ns["mc"].reference_count == 1 + 1 + 2 + 4

    mc, bits = ns["ia_kernels"][3, 2, 1], ns["ia_bits"][3, 2, 1]
    jmc = J_MC(tile=8, lane=128, iterations=4, K=3)
    blocks = jnp.asarray(bits.view(np.int32).reshape(
        1, jmc._tile, jmc.num_planes, jmc._lane))

    def one(block):
        return jmc._solve_block([block[:, i] for i in range(jmc.num_planes)],
                                jnp.float32(0.1))

    want = float(np.asarray(jax.jit(jax.vmap(one))(blocks)).sum()) / \
        (mc.tile * mc.lane)
    np.testing.assert_allclose(ns["ia_capacity"][3, 2, 1], want, rtol=2e-4)

    mc, bits = ns["ia_kernels"][2, 4, 2], ns["ia_bits"][2, 4, 2]
    assert not mc.closed_form
    jmc = J_MC(tile=8, lane=128, iterations=4, K=2, N=4, Ns=2)
    block = jnp.asarray(bits.view(np.int32).reshape(
        jmc._tile, jmc.num_planes, jmc._lane))
    want = float(jmc._solve_block_general(
        [block[:, i] for i in range(jmc.num_planes)], jnp.float32(0.1))) / \
        (mc.tile * mc.lane)
    np.testing.assert_allclose(ns["ia_capacity"][2, 4, 2], want, rtol=2e-4)
