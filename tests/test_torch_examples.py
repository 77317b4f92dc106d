"""The port's examples (``chad_tsdf_tpu_torch/examples``) on the CPU, each
in its own process with ``--cpu`` at small sizes through its own flags:
exit codes, PLYs, and that neither jax nor any module of the JAX package
was loaded.  ``demo_kitti`` runs on a 3-scan sequence in KITTI's layout
written here from ``synthetic_lidar_scan`` (no KITTI data ships with the
repository), and exits 2 on a root without one, as the JAX demo does."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from chad_tsdf_tpu_torch.io.kitti import synthetic_lidar_scan
from chad_tsdf_tpu_torch.mesh import read_ply

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# runs one example module as ``python -m`` would, then reports the modules
# of jax and of the JAX package that the process loaded
_RUNNER = """
import runpy, sys
name = sys.argv[1]
sys.argv = [name] + sys.argv[2:]
code = 0
try:
    runpy.run_module(name, run_name="__main__", alter_sys=True)
except SystemExit as e:
    code = e.code or 0
bad = sorted(k for k in sys.modules if k == "jax" or k.startswith("jax.")
             or k == "chad_tsdf_tpu" or k.startswith("chad_tsdf_tpu."))
print("LOADED", ",".join(bad))
sys.exit(code)
"""


def run_example(name, *args, cwd):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-c", _RUNNER,
         f"chad_tsdf_tpu_torch.examples.{name}", "--cpu", *args],
        cwd=str(cwd), env=env, capture_output=True, text=True, timeout=600)
    loaded = [x for x in proc.stdout.splitlines() if x.startswith("LOADED")]
    assert loaded == ["LOADED "], (loaded, proc.stderr[-2000:])
    return proc


def _radii(path):
    mesh = read_ply(str(path))
    assert mesh.n_vertices > 0 and mesh.n_faces > 0
    return np.linalg.norm(mesh.vertices.astype(np.float64), axis=1)


def test_demo_sphere(tmp_path):
    proc = run_example("demo_sphere", "--points", "16384", "--out", "s.ply",
                       cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "M points/s" in proc.stdout and "stats:" in proc.stdout
    r = _radii(tmp_path / "s.ply")
    assert abs(r.mean() - 5.0) < 0.05 and r.std() < 0.05


def test_demo_loop_closure(tmp_path):
    proc = run_example("demo_loop_closure", "--points", "4000", "--out",
                       "l.ply", cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "optimizer: cost" in proc.stdout
    r = _radii(tmp_path / "l.ply")
    assert abs(r.mean() - 2.0) < 0.05


def test_demo_carve(tmp_path):
    proc = run_example("demo_carve", "--out", "c.ply", cwd=tmp_path)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-2000:]
    assert "carving OK" in proc.stdout
    v = read_ply(str(tmp_path / "c.ply")).vertices
    assert len(v) > 0 and not np.any(np.abs(v[:, 0] - 2.0) < 0.2)


def _fake_sequence(root, n_scans=3, every=8):
    """KITTI's layout: sequences/00/velodyne/*.bin (x, y, z, reflectance
    in the sensor's frame), sequences/00/calib.txt (an identity Tr) and
    poses/00.txt (the sensor's position, 1.5 m apart); every ``every``-th
    point of each synthetic scan."""
    seq = root / "sequences" / "00"
    (seq / "velodyne").mkdir(parents=True)
    (root / "poses").mkdir()
    rows = []
    for i in range(n_scans):
        origin = np.float32([1.5 * i, 0.0, 1.7])
        pts = synthetic_lidar_scan([1.5 * i, 0.0, 0.0], seed=i)[::every]
        scan = np.zeros((len(pts), 4), np.float32)
        scan[:, :3] = pts - origin
        scan.tofile(seq / "velodyne" / f"{i:06d}.bin")
        pose = np.hstack([np.eye(3), origin[:, None]])
        rows.append(" ".join(f"{x:.6f}" for x in pose.reshape(-1)))
    (root / "poses" / "00.txt").write_text("\n".join(rows) + "\n")
    tr = np.hstack([np.eye(3), np.zeros((3, 1))]).reshape(-1)
    (seq / "calib.txt").write_text(
        "Tr: " + " ".join(f"{x:.1f}" for x in tr) + "\n")


def test_demo_kitti(tmp_path):
    _fake_sequence(tmp_path / "kitti")
    proc = run_example("demo_kitti", "--root", str(tmp_path / "kitti"),
                       "--out", "k.ply", "--metrics", "m.jsonl",
                       cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "total: 3 scans" in proc.stdout
    records = [json.loads(x) for x in
               (tmp_path / "m.jsonl").read_text().splitlines()]
    assert [r["scan"] for r in records] == [1, 2, 3]
    for r in records:
        assert r["n_valid_samples"] > 0
        assert all(type(v) is int for k, v in r.items() if k != "ts")
    assert read_ply(str(tmp_path / "k.ply")).n_faces > 0


def test_demo_kitti_without_a_sequence(tmp_path):
    proc = run_example("demo_kitti", "--root", str(tmp_path / "none"),
                       cwd=tmp_path)
    assert proc.returncode == 2
    assert "KITTI sequence not found" in proc.stderr


@pytest.mark.parametrize("script,args,keys", [
    ("bench", ["--points", "4096", "--reps", "2", "--rounds", "1",
               "--scans", "2"],
     {"metric", "value", "unit", "vs_baseline", "kitti_scans_per_sec",
      "kitti_points_per_sec", "kitti_tile_overflow", "device"}),
    ("gpu_equality", ["--points", "4096", "--out", "eq.json"],
     {"all_pass"}),
])
def test_script_prints_its_json(script, args, keys, tmp_path):
    """``scripts/bench.py`` and ``scripts/gpu_equality.py`` on the CPU at a
    few thousand points: the last line is their JSON object with the
    documented keys."""
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-m", f"chad_tsdf_tpu_torch.scripts.{script}",
         "--device", "cpu", *args], cwd=str(tmp_path), env=env,
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.splitlines()[-1])
    assert set(out) == keys
    if script == "bench":
        assert out["metric"] == "tsdf_integrate_points_per_sec"
        assert out["device"] == "cpu" and out["value"] > 0
        assert out["kitti_tile_overflow"] == 0
        assert "eager loop:" in proc.stdout
    else:
        assert out["all_pass"] is True
        eq = json.loads((tmp_path / "eq.json").read_text())
        assert set(eq["workloads"]) == {"dense_sphere_1m",
                                        "sparse_lidar_131k",
                                        "fallback_sphere_2048"}
        for wl in eq["workloads"].values():
            assert set(wl) == {"xla", "fused", "tile", "pallas", "seg",
                               "sample_tile"}
            for name, r in wl.items():
                if name != "xla":
                    assert r["pass"] and r["dir_keys_equal"]
                    assert r["max_weight_diff"] == 0.0
                    assert r["max_mean_sd_diff_in_quanta"] < 1.0
