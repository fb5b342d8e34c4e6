"""``launch.mesh``: a spawned rank runs torch's CPU ops on the thread count
its caller sets (``spawn(threads=)``), and ``AbstractMesh`` places a rank
where ``Mesh`` places it on a real world.

Spawned ranks used to take the host's cores divided by the world, whatever
else ran on the host; beside five other test workers that oversubscribed
the cores, and real-clock tests in other workers (the WAN window's 30 ms
timer) waited on delayed wakeups. The tests pass ``threads=1``.
"""
import pytest
import torch

from repro_torch.launch.mesh import AbstractMesh, make_mesh, spawn


def _rank_report() -> dict:
    """This rank's thread count and mesh placement (spawn target)."""
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    return {"threads": torch.get_num_threads(), "rank": mesh.rank, "coords": mesh.coords,
            "batch_index": mesh.batch_index()}


@pytest.fixture(scope="module")
def one_thread():
    return spawn("test_torch_mesh:_rank_report", 4, backend="gloo", threads=1, timeout_s=120.0)


def test_spawned_ranks_take_the_callers_thread_count(one_thread):
    assert [r["threads"] for r in one_thread] == [1] * 4
    ranks = spawn("test_torch_mesh:_rank_report", 4, backend="gloo", threads=3, timeout_s=120.0)
    assert [r["threads"] for r in ranks] == [3] * 4


def test_abstract_mesh_places_ranks_as_the_world_does(one_thread):
    for r in one_thread:
        abstract = AbstractMesh({"data": 2, "model": 2}, rank=r["rank"])
        assert abstract.coords == r["coords"]
        assert abstract.batch_index() == r["batch_index"]
