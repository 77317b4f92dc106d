"""Nothing a run loads has the top-level name of JAX or of the JAX
package (``chad_tsdf_tpu``; the port ``chad_tsdf_tpu_torch`` is allowed).
The names are compared whole, before the first dot."""

import subprocess
import sys

from tsdf_bench import run

from .conftest import KEPT

PROBE = r"""
import sys
from tsdf_bench import run, control, trial
from tsdf_bench import check
from tsdf_bench.metrics import (device_idle_pct, finalize_scan_ms,
    insert_call_ms, insert_roofline_pct, mc_ms, normals_roofline_pct,
    ply_ms, points_per_s, save_ms, scan_p95_ms, scans_per_s, setup_s,
    voxel_samples_ms)
from tsdf_bench.traffic import lidar, sphere
load = run.load_json
def with_kept(path):
    out = load(path)
    if path == "BENCHMARK.json":
        out["workloads"] = out["workloads"] + KEPT
    return out
run.load_json = with_kept
out = run.run_cell("sphere_save", 3, 0.2, True, device="cpu",
                   overrides={"cloud": {"points": 2048}, "warm_steps": 1,
                              "trace_steps": 1})
assert out["attempted"] >= 1
print(sorted({n.split(".")[0] for n in sys.modules}))
"""


def test_forbidden_names_are_whole():
    assert "chad_tsdf_tpu" in run.FORBIDDEN
    assert "chad_tsdf_tpu_torch".split(".")[0] not in run.FORBIDDEN


def test_nothing_reachable_loads_jax():
    """A save (the kept ``sphere_save``) loads no forbidden name."""
    probe = f"KEPT = {KEPT!r}\n" + PROBE
    r = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                       text=True, timeout=600, cwd=run.os.path.dirname(
                           run.HERE))
    assert r.returncode == 0, r.stderr[-3000:]
    loaded = set(eval(r.stdout.strip().splitlines()[-1]))
    assert "chad_tsdf_tpu_torch" in loaded
    assert not loaded & set(run.FORBIDDEN), loaded & set(run.FORBIDDEN)
