"""Mesh fidelity metrics — a numpy copy of ``chad_tsdf_tpu/mesh/rmse.py``,
the BASELINE "vertex RMSE vs reference mesh" criterion's measurement tool.

The reference's output contract is its PLY mesh (reference:
src/chad/detail/lvr2.cpp:317-319); BASELINE.md requires the TPU build's
meshes to match within SDF/vertex tolerance.  Without a buildable C++
reference in this environment, the committed golden artifacts
(tests/golden/, fixed-seed sphere workload) stand in as the regression
proxy: any change to integration, quantization or meshing that moves
vertices shows up as RMSE against the golden mesh.
"""

from __future__ import annotations

import numpy as np


def vertex_rmse(verts_a: np.ndarray, verts_b: np.ndarray) -> dict:
    """Symmetric nearest-neighbour vertex distances between two meshes.

    Returns {rmse_a_to_b, rmse_b_to_a, rmse, hausdorff} in mesh units.
    """
    from scipy.spatial import cKDTree

    if len(verts_a) == 0 or len(verts_b) == 0:
        nan = float("nan")
        return {"rmse_a_to_b": nan, "rmse_b_to_a": nan, "rmse": nan,
                "hausdorff": nan}
    ta = cKDTree(verts_a)
    tb = cKDTree(verts_b)
    d_ab, _ = tb.query(verts_a, k=1)
    d_ba, _ = ta.query(verts_b, k=1)
    r_ab = float(np.sqrt(np.mean(d_ab ** 2)))
    r_ba = float(np.sqrt(np.mean(d_ba ** 2)))
    return {
        "rmse_a_to_b": r_ab,
        "rmse_b_to_a": r_ba,
        "rmse": float(np.sqrt((np.mean(d_ab ** 2) + np.mean(d_ba ** 2)) / 2)),
        "hausdorff": float(max(d_ab.max(), d_ba.max())),
    }


def analytic_sphere_rmse(verts: np.ndarray, radius: float,
                         centre=(0.0, 0.0, 0.0)) -> float:
    """RMSE of vertex distances to an analytic sphere (the reference demo's
    ground truth, main.cpp:8-30)."""
    r = np.linalg.norm(verts - np.float32(centre)[None, :], axis=1)
    return float(np.sqrt(np.mean((r - radius) ** 2)))
