"""``correct`` on the CPU at a size a test run holds: a sound run comes
out correct, the control (the reference in bfloat16 in the program's
place) does not, and neither does a run whose timed path is broken in any
of the ways a cell can break: an insert that leaves the map unchanged,
half of every cloud left out, an answer altered where it is produced."""

import numpy as np
import pytest
import torch

from chad_tsdf_tpu_torch.core import map as map_mod
from tsdf_bench import check, control, run

pytestmark = pytest.mark.usefixtures("kept_cells")

LIDAR_MAP = {"block_capacity": 1 << 16, "touched_capacity": 1 << 13,
             "max_points": 1 << 13}
SPHERE_MAP = {"block_capacity": 1 << 13, "max_points": 1 << 13}
SMALL = {
    "kitti_drive": {"sensor": {"azimuths": 96}, "warm_steps": 8,
                    "map_config": LIDAR_MAP},
    "kitti_parked": {"sensor": {"azimuths": 96}, "warm_steps": 8,
                     "map_config": LIDAR_MAP},
    # two finished submaps and the active one when the window starts
    "kitti_drive_save": {"sensor": {"azimuths": 96}, "lead_in": 16,
                         "params": {"stop_after": 16}, "warm_steps": 1,
                         "map_config": LIDAR_MAP},
    "sphere_insert": {"cloud": {"points": 4096}, "warm_steps": 8,
                      "map_config": SPHERE_MAP},
    "sphere_save": {"cloud": {"points": 4096}, "warm_steps": 2,
                    "map_config": SPHERE_MAP},
}


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def one_run(cell, seed=2**31 + 5, seconds=1.0):
    return run.run_cell(cell, seed, seconds, False, device="cpu",
                        overrides=SMALL[cell])


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_sound_run_is_correct(cell):
    out = one_run(cell)
    assert out["failed"] == 0
    assert out["correct"], out["checks"]
    if cell in ("kitti_drive", "kitti_drive_save"):
        assert "leaf_off_share" in out["checks"]


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_control_is_not_correct(cell):
    _, _, spec, _ = run.cell_spec(cell, SMALL[cell])
    nums = control.control_numbers(cell, 7, device="cpu",
                                   overrides=SMALL[cell])
    assert not check.judge(nums, spec["limits"]), nums


def unchanged(orig):
    def insert(self, points, position):
        return map_mod.LazyMetrics()
    return insert


def half(orig):
    def insert(self, points, position):
        return orig(self, np.asarray(points)[: len(points) // 2], position)
    return insert


def altered(orig):
    def insert(self, points, position):
        out = orig(self, points, position)
        st = self.state
        st.pool_sd.add_(0.01 * st.pool_w)       # every touched voxel + 1 cm
        return out
    return insert


FAULTS = {"unchanged": unchanged, "half": half, "altered": altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_broken_path_is_not_correct(cell, fault, monkeypatch):
    orig = map_mod.TSDFMap.insert
    monkeypatch.setattr(map_mod.TSDFMap, "insert", FAULTS[fault](orig))
    out = one_run(cell)
    assert not out["correct"], out["checks"]


def test_altered_mesh_is_not_correct(monkeypatch):
    write = map_mod.write_ply

    def shifted(path, mesh):
        mesh.vertices = mesh.vertices + np.float32(1e-3)
        write(path, mesh)
    monkeypatch.setattr(map_mod, "write_ply", shifted)
    out = one_run("sphere_save")
    assert out["checks"]["mesh_off_share"]["value"] > \
        out["checks"]["mesh_off_share"]["limit"]
    assert not out["correct"]
