"""Binary ``.grid`` dump, format-compatible with the reference — a numpy
copy of ``chad_tsdf_tpu/mesh/grid.py``.

The reference writes this unconditionally on every save (reference:
src/chad/detail/lvr2.cpp:170-200, invoked at lvr2.cpp:290): a header of
``float voxel_res`` + ``size_t n_query_points`` + ``size_t n_cells``, then
per query point an Eigen::Vector3f position + float signed distance, then
8 uint32 query-point indices per cell.

Reference defect NOT replicated: lvr2.cpp:176 writes ``m_truncsize`` into
the voxel-resolution header field; we write the actual voxel resolution.
Here the dump is opt-in (MapConfig.save_grid / TSDFMap.save_grid).
"""

from __future__ import annotations

import numpy as np

from ..ops import morton
from .tables import CORNERS


def build_cells(sample_codes: np.ndarray, sample_sd: np.ndarray):
    """Complete cells (all 8 corner samples present, lvr2.cpp:115-129).

    Returns (cell_corner_indices (C, 8) int64 into the sample arrays)."""
    order = np.argsort(sample_codes, kind="stable")
    codes = sample_codes[order]
    coords = morton.np_decode63(codes)
    cand = coords[:, None, :] - CORNERS[None, :, :]
    cell_codes = np.unique(morton.np_encode63(cand.reshape(-1, 3)))
    cc = morton.np_decode63(cell_codes)
    corner_codes = morton.np_encode63(
        (cc[:, None, :] + CORNERS[None, :, :]).reshape(-1, 3))
    pos = np.searchsorted(codes, corner_codes)
    pos_c = np.minimum(pos, codes.shape[0] - 1)
    found = (codes[pos_c] == corner_codes).reshape(-1, 8)
    complete = found.all(axis=1)
    return order, pos_c.reshape(-1, 8)[complete], complete.sum()


def write_grid(path: str, sample_codes: np.ndarray, sample_sd: np.ndarray,
               sdf_res: float) -> None:
    order, cells, _ = build_cells(sample_codes, sample_sd)
    codes = sample_codes[order]
    sd = sample_sd[order]
    pos = morton.np_decode63(codes).astype(np.float32) * np.float32(sdf_res)
    with open(path, "wb") as fh:
        fh.write(np.float32(sdf_res).tobytes())
        fh.write(np.uint64(pos.shape[0]).tobytes())
        fh.write(np.uint64(cells.shape[0]).tobytes())
        inter = np.empty((pos.shape[0], 4), np.float32)
        inter[:, :3] = pos
        inter[:, 3] = sd
        fh.write(inter.tobytes())
        fh.write(cells.astype(np.uint32).tobytes())
