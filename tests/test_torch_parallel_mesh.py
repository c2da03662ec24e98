"""The port's device meshes (``pyphysim_tpu_torch/parallel/mesh.py``) and
``SimulationRunner.simulate_in_parallel`` on a 4-rank ``gloo`` group.

The group is started once for the module (``run_ranks`` over a
``file://`` store in ``tmp_path``: no port); every rank runs
``torch_parallel_checks.mesh_checks`` and the tests read its results:

* ``make_mesh``, ``make_host_chip_mesh`` and ``shard_batch``: names,
  shapes, the 2 x 2 split, a sum over ``chip`` that stays within a host,
  and ``num_hosts=3`` refused, as the JAX package's
  ``tests/test_parallel.py`` ``TestMeshHelpers``;
* ``init_multihost`` on a live group is a no-op; a CUDA mesh without a
  card raises (no fallback);
* the runner's ``mesh`` is reset after ``simulate_in_parallel``; with
  ``block=False`` a second call while the sweep runs raises
  ``RuntimeError``, the wait gives the blocking run's results and
  re-raises the sweep's error.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import torch_parallel_checks as checks  # noqa: E402
from pyphysim_tpu_torch.parallel.launch import run_ranks  # noqa: E402

WORLD = 4


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks(checks.mesh_checks, WORLD,
                     store_dir=str(tmp_path_factory.mktemp("store")))


@pytest.fixture(scope="module")
def single():
    runner = checks.QpskRunner()
    runner.simulate()
    return checks.summary(runner)


def test_make_mesh_names_and_shape(ranks):
    for rank, out in enumerate(ranks):
        assert out["mesh"] == (("mc",), (WORLD,), rank)
        assert out["too_many"]


def test_make_mesh_of_the_first_ranks(ranks):
    assert [out["sub_mesh"] for out in ranks] == \
        [((2,), True), ((2,), True), ((2,), False), ((2,), False)]


def test_host_chip_mesh(ranks):
    for rank, out in enumerate(ranks):
        assert out["host_chip"] == (("host", "chip"), (2, 2), rank // 2,
                                    rank % 2)
        # the sum over 'chip' adds the ranks of one host only
        assert out["chip_sum"] == {0: 1.0, 1: 5.0}[rank // 2]
        assert out["default_hosts"] == (1, WORLD)   # one node
        assert out["three_hosts"]


def test_shard_batch(ranks):
    full = list(np.arange(4.0 * WORLD))
    for rank, out in enumerate(ranks):
        local, gathered = out["shard"]
        assert local == full[4 * rank:4 * rank + 4]
        assert gathered == full
        # sharded over 'chip' (2 ways), replicated over 'host'
        assert out["chip_shard"] == list(np.arange(8.0))[
            4 * (rank % 2):4 * (rank % 2) + 4]


def test_gather_rows_in_rank_order(ranks):
    for out in ranks:
        assert out["gather"] == [[r] for r in range(WORLD) for _ in (0, 1)]
        assert out["gather_bool"] == [True, False, True, False]


def test_init_multihost_is_a_no_op_on_a_live_group(ranks):
    assert [out["world_after_init"] for out in ranks] == [WORLD] * WORLD


def test_cuda_mesh_without_a_card_raises(ranks):
    assert all(out["cuda_mesh_raises"] for out in ranks)


def test_mesh_reset_after_the_sweep(ranks, single):
    for out in ranks:
        assert out["reset"]
        assert out["blocking"] == single


def test_async_sweep_and_wait(ranks, single):
    for out in ranks:
        second_call_raised, reset, summary = out["async"]
        assert second_call_raised
        assert reset
        assert summary == single
        assert out["async_error"]


def test_mesh_of_another_device_type_raises():
    """A runner on the CPU refuses a CUDA mesh (no silent move)."""
    import types
    runner = checks.QpskRunner()
    with pytest.raises(ValueError, match="cannot run"):
        runner.simulate_in_parallel(types.SimpleNamespace(device_type="cuda"))
    assert runner.mesh is None
