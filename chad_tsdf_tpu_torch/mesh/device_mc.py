"""Device marching cubes — PyTorch port of
``chad_tsdf_tpu/mesh/device_mc.py``.

The reference meshes on the host through LVR2 (reference:
src/chad/detail/lvr2.cpp:235-320) and :mod:`.mc` is its numpy form; this
module runs the heavy part as torch ops on the map's device.  The JAX
package leaves all of it to XLA (no Pallas kernel), so these are plain
torch ops, not a hand kernel:

* host prep (numpy, as in JAX): sort the samples, split each code into
  ``block = code >> 9`` and ``offset = code & 511`` (Morton codes nest),
  and build each block's (2, 2, 2) neighbour table with ``searchsorted``
  over the unique blocks (B marks a missing neighbour);
* pass 1: scatter the samples into (B + 1, 512) sd and "present" grids
  (row B stays empty: it is what a missing neighbour reads); then, a chunk
  of blocks at a time, gather each block's 9x9x9 corner lattice through
  one flat index, classify its 512 cells into a uint8 case and an
  "active" flag (complete-cell rule: all 8 corners sampled,
  lvr2.cpp:115-129) and count the active cells and their triangles
  exactly (one host read: ``save`` is a drain point);
* pass 2: compact the active cells (``nonzero``), read their 8 corner
  sds through the neighbour table again, gather the (15, 256) triangle
  table, interpolate the 12 edges and compact the live triangles;
* weld: one stable sort of an int64 canonical edge key, the same key and
  the same vertex order as the host weld's ``np.unique``.

Device memory follows the map: ~3.7 KB per block (the grids, case,
flags and neighbour table) plus a bounded chunk in pass 1, and pass 2's
per-cell and per-triangle arrays, which follow the surface.

The 512 cells of a block are enumerated in Morton offset order, so the
active cells come out in ascending cell-code order, which is the host
path's order; each (cell, edge) vertex is interpolated with the host's
operations and, of the copies of a welded vertex, the last in soup order
is kept, as numpy's fancy assignment does.  So the device mesh equals the
host mesh (vertices, faces and their order), not only up to rounding.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.state import resolve_device
from ..ops import morton
from ..utils import timing
from .mc import TriangleMesh, _vertex_normals
from .tables import CORNERS, EDGES, TRI_TABLE

_G = 9                      # corner lattice per block: 9x9x9
_CHUNK_BLOCKS = 1 << 14     # blocks pass 1 classifies at a time

# device MC runs since the last reset (chip_smoke.py checks that ``save``
# went through this path)
CALLS = {"marching_cubes_device": 0}


def _host_consts():
    """Static index tables of the block lattice.  Cell j of a block is the
    one at Morton offset j, so flat (block, cell) order is cell-code order."""
    xyz = np.stack(np.meshgrid(np.arange(_G), np.arange(_G), np.arange(_G),
                               indexing="ij"), -1).reshape(-1, 3)  # (729, 3)
    nsel = ((xyz[:, 0] >> 3) | ((xyz[:, 1] >> 3) << 1) |
            ((xyz[:, 2] >> 3) << 2)).astype(np.int64)
    off = morton.encode_offset(xyz[:, 0] & 7, xyz[:, 1] & 7, xyz[:, 2] & 7)

    cxyz = np.stack(morton.decode_offset(np.arange(512)), -1)     # (512, 3)
    corner_g = np.zeros((8, 512), np.int64)
    for ci in range(8):
        p = cxyz + CORNERS[ci]
        corner_g[ci] = (p[:, 0] * _G + p[:, 1]) * _G + p[:, 2]
    return nsel, off.astype(np.int64), cxyz.astype(np.int64), corner_g


_NSEL, _OFF, _CXYZ, _CORNER_G = _host_consts()
_E0, _E1 = EDGES[:, 0], EDGES[:, 1]
_ELO = np.minimum(CORNERS[_E0], CORNERS[_E1]).astype(np.int64)   # (12, 3)
_EAXIS = np.argmax(np.abs(CORNERS[_E0] - CORNERS[_E1]),
                   axis=1).astype(np.int64)
# the (15, 256) transposed triangle table and the triangles per case
_TRI15_T = np.ascontiguousarray(TRI_TABLE[:, :15].T.astype(np.int64))
_TRI_N = (TRI_TABLE[:, :15:3] >= 0).sum(1).astype(np.int64)     # (256,)


def _host_prep(sample_codes: np.ndarray, sample_sd: np.ndarray):
    """Block grouping and neighbour table (numpy).  Returns (flat grid
    index row * 512 + offset per sample, sd, neighbour rows (B, 8), block
    coordinates (B, 3))."""
    order = np.argsort(sample_codes, kind="stable")
    codes = sample_codes[order]
    sd = np.ascontiguousarray(sample_sd[order], np.float32)
    bcode = codes >> np.uint64(9)
    soff = (codes & np.uint64(511)).astype(np.int64)
    ublocks = np.unique(bcode)
    srow = np.searchsorted(ublocks, bcode).astype(np.int64)
    bcoords = morton.np_decode63(ublocks << np.uint64(9)) >> 3   # (B, 3)
    nb = np.empty((ublocks.shape[0], 8), np.int64)
    bsent = ublocks.shape[0]
    for sel in range(8):
        d = np.array([sel & 1, (sel >> 1) & 1, (sel >> 2) & 1], np.int32)
        ncode = morton.np_encode63((bcoords + d) * 8) >> np.uint64(9)
        pos = np.searchsorted(ublocks, ncode)
        pos_c = np.minimum(pos, bsent - 1)
        nb[:, sel] = np.where(ublocks[pos_c] == ncode, pos_c, bsent)
    return srow * 512 + soff, sd, nb, bcoords.astype(np.int64)


def _classify(flat, sd, nb, iso: float):
    """Pass 1, over ``_CHUNK_BLOCKS`` blocks at a time: a chunk's corner
    lattice and planes are all it holds beside the grids, so its memory
    follows the blocks by ~4 KB each.  Returns (sd grid ((B + 1) * 512,)
    f32, case (B * 512,) uint8, active (B * 512,) bool, counts
    [n_active, n_tris] int64)."""
    dev = sd.device
    b = nb.shape[0]
    sd_grid = torch.zeros((b + 1) * 512, dtype=torch.float32, device=dev)
    ok_grid = torch.zeros((b + 1) * 512, dtype=torch.bool, device=dev)
    # sample codes are unique: every grid element is written at most once
    sd_grid[flat] = sd
    ok_grid[flat] = True
    nsel = torch.from_numpy(_NSEL).to(dev)
    off = torch.from_numpy(_OFF).to(dev)
    corner_g = torch.from_numpy(_CORNER_G).to(dev)
    tri_n = torch.from_numpy(_TRI_N).to(dev)
    case = torch.zeros((b, 512), dtype=torch.uint8, device=dev)
    active = torch.empty((b, 512), dtype=torch.bool, device=dev)
    n_tris = torch.zeros((), dtype=torch.int64, device=dev)
    for beg in range(0, b, _CHUNK_BLOCKS):
        end = min(beg + _CHUNK_BLOCKS, b)
        lattice = nb[beg:end, nsel] * 512 + off              # (k, 729)
        g_sd = sd_grid[lattice]
        g_ok = ok_grid[lattice]
        del lattice
        c = case[beg:end]
        ok = torch.ones((end - beg, 512), dtype=torch.bool, device=dev)
        for ci in range(8):
            ok &= g_ok[:, corner_g[ci]]
            c |= (g_sd[:, corner_g[ci]] < iso).to(torch.uint8) << ci
        del g_sd, g_ok
        active[beg:end] = ok & (c != 0) & (c != 255)
        n_tris += torch.where(active[beg:end], tri_n[c.long()], 0).sum()
    counts = torch.stack([active.sum(), n_tris])
    return sd_grid, case.reshape(-1), active.reshape(-1), counts


def _spread3_11(x):
    """Spread the low 11 bits of ``x`` to bits 0,3,...,30."""
    x = x & 0x7FF
    x = (x | (x << 16)) & 0x070000FF
    x = (x | (x << 8)) & 0x0700F00F
    x = (x | (x << 4)) & 0x430C30C3
    x = (x | (x << 2)) & 0x49249249
    return x


def weld_key(lo, axis):
    """The host weld key ``(np_encode63(lo) << 2) | axis`` (uint64, bit 64
    of the shift silently dropped) as one int64 whose signed order is the
    host key's unsigned order: ``key = host_key - 2**63``.

    ``lo``: (..., 3) int64 world voxel coords; ``axis``: (...) int64.
    Biased coord bit i of axis k sits at host key position 3i + k + 2:
    positions < 32 (i <= 9) form the low word, i >= 10 the high word at
    3(i - 10) + k, where the axis-2 bit 20 lands at 32 and is dropped as
    the u64 shift drops it.  torch has no unsigned 64-bit order and no
    multi-key sort, so the words combine as (hi - 2**31) * 2**32 + lo,
    exact in int64."""
    klo = axis
    khi = torch.zeros_like(axis)
    for k in range(3):
        u = lo[..., k] + (1 << 20)
        klo = klo | (morton.spread3_10(u & 0x3FF) << (k + 2))
        khi = khi | (_spread3_11((u >> 10) & 0x7FF) << k)
    khi = khi & 0xFFFFFFFF
    return (khi - (1 << 31)) * (1 << 32) + klo


def _mesh_blocks(sd_grid, case, active, nb, bcoords, iso: float,
                 cell_cap: int, tri_cap: int):
    """Pass 2 and the weld over the first ``cell_cap`` active cells and
    their first ``tri_cap`` triangles (T of them).  Returns (vertex
    positions (3T + 1, 3) f32 in voxel units, live prefix [:n_verts];
    faces (T, 3) int64; n_verts (a device scalar); cell and triangle
    overflow (host ints))."""
    dev = sd_grid.device
    i64 = dict(dtype=torch.int64, device=dev)
    # ---- compact the active cells, in cell-code order ----
    timing.count("host_syncs")           # nonzero waits for its count
    sid = torch.nonzero(active).squeeze(1)
    cell_overflow = max(sid.shape[0] - cell_cap, 0)
    sid = sid[:cell_cap]
    c_case = case[sid].long()                            # (C,)
    c_block = sid // 512
    cell = sid % 512
    del sid
    # ---- the 8 corner sds of each cell, through the neighbour table ----
    nsel = torch.from_numpy(_NSEL).to(dev)
    off = torch.from_numpy(_OFF).to(dev)
    corner_g = torch.from_numpy(_CORNER_G).to(dev)
    c_sd = torch.empty((8, cell.shape[0]), dtype=torch.float32, device=dev)
    for ci in range(8):
        g = corner_g[ci][cell]
        c_sd[ci] = sd_grid[nb[c_block, nsel[g]] * 512 + off[g]]
    base = bcoords[c_block] * 8 + torch.from_numpy(_CXYZ).to(dev)[cell]
    del c_block, cell
    # the weld key of each cell's 12 edges
    ekey = weld_key(base[None] + torch.from_numpy(_ELO).to(dev)[:, None],
                    torch.from_numpy(_EAXIS).to(dev)[:, None])   # (12, C)

    # ---- 12 edge vertices per cell, the host's arithmetic ----
    basef = base.to(torch.float32)                       # exact: |x| < 2^24
    del base
    e0 = torch.from_numpy(_E0.astype(np.int64)).to(dev)
    e1 = torch.from_numpy(_E1.astype(np.int64)).to(dev)
    sd_a, sd_b = c_sd[e0], c_sd[e1]                      # (12, C)
    del c_sd
    denom = sd_a - sd_b
    t = torch.where(denom.abs() > 1e-30,
                    (sd_a - iso) / torch.where(denom == 0, 1.0, denom), 0.5)
    t = torch.clamp(t, 0.0, 1.0)
    del sd_a, sd_b, denom
    ca = torch.from_numpy(CORNERS[_E0].astype(np.float32)).to(dev)  # (12, 3)
    step = torch.from_numpy(
        (CORNERS[_E1] - CORNERS[_E0]).astype(np.float32)).to(dev)
    pos = (basef[None] + ca[:, None]) + step[:, None] * t[..., None]
    del basef, t                                         # pos: (12, C, 3)

    # ---- the live triangles, cell-major as the host's soup ----
    te = torch.from_numpy(_TRI15_T).to(dev)[:, c_case]   # (15, C) edge ids
    timing.count("host_syncs")
    tid = torch.nonzero((te[0::3] >= 0).T.reshape(-1)).squeeze(1)
    tri_overflow = max(tid.shape[0] - tri_cap, 0)
    tid = tid[:tri_cap]
    c_of_t = (tid // 5)[:, None]
    edge = te[(tid % 5)[:, None] * 3 + torch.arange(3, **i64)[None, :],
              c_of_t]                                    # (T, 3)
    soup_pos = pos[edge, c_of_t].reshape(-1, 3)          # (3T, 3)
    soup_key = ekey[edge, c_of_t].reshape(-1)            # (3T,)
    del te, edge, pos, ekey

    # ---- weld: stable sort, one vertex per key, the last copy in soup
    # order (numpy's ``vertices[inverse] = soup``) ----
    t3 = soup_key.shape[0]
    s_key, s_idx = torch.sort(soup_key, stable=True)
    change = s_key[1:] != s_key[:-1]
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), change])
    last = torch.cat([change, torch.ones(1, dtype=torch.bool, device=dev)])
    vid = torch.cumsum(first, 0) - 1
    vdest = torch.where(last, vid, t3)
    verts = torch.zeros((t3 + 1, 3), dtype=torch.float32, device=dev)
    verts[vdest] = soup_pos[s_idx]
    inv = torch.empty(t3, **i64)
    inv[s_idx] = vid                                     # a permutation
    return (verts, inv.reshape(-1, 3), first.sum(), cell_overflow,
            tri_overflow)


def triangulate_device(sample_codes: np.ndarray, sample_sd: np.ndarray,
                       sdf_res: float, iso: float = 0.0,
                       cell_cap: int | None = None, device="cuda"):
    """Marching cubes on ``device`` without the normals: (vertices (V, 3)
    f32, faces (F, 3) int32), equal to :func:`.mc.triangulate` on the same
    samples.  ``cell_cap`` bounds pass 2's cell slots (and 5x that its
    triangles); capacities that overflow are doubled and pass 2 rerun.
    By default pass 1's exact counts size them and pass 2 runs once."""
    dev = resolve_device(device)
    CALLS["marching_cubes_device"] += 1
    empty = (np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32))
    if sample_codes.shape[0] == 0:
        return empty
    flat, sd, nb, bcoords = _host_prep(sample_codes, sample_sd)
    nb = torch.from_numpy(nb).to(dev)
    sd_grid, case, active, counts = _classify(
        torch.from_numpy(flat).to(dev), torch.from_numpy(sd).to(dev), nb,
        float(iso))
    n_active, n_tris = (int(x) for x in timing.to_host(counts))
    if n_tris == 0:
        return empty
    if cell_cap is None:
        cell_cap, tri_cap = n_active, n_tris
    else:
        tri_cap = cell_cap * 5
    bc = torch.from_numpy(bcoords).to(dev)
    while True:
        verts, faces, n_verts, c_ovf, t_ovf = _mesh_blocks(
            sd_grid, case, active, nb, bc, float(iso), cell_cap, tri_cap)
        if c_ovf == 0 and t_ovf == 0:
            break
        if c_ovf > 0:
            cell_cap *= 2
        if t_ovf > 0:
            tri_cap *= 2
    v = timing.host_item(n_verts)
    vertices = timing.to_host(verts[:v]).numpy() * np.float32(sdf_res)
    faces = timing.to_host(faces).numpy().astype(np.int32)
    # drop degenerate triangles (two corners welded to the same vertex)
    ok = ((faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2]) &
          (faces[:, 0] != faces[:, 2]))
    return vertices, faces[ok]


def marching_cubes_device(sample_codes: np.ndarray, sample_sd: np.ndarray,
                          sdf_res: float, iso: float = 0.0,
                          cell_cap: int | None = None,
                          device="cuda") -> TriangleMesh:
    """Device-backed :func:`.mc.marching_cubes`: the same mesh, with the
    vertex normals computed on the host as there."""
    v, f = triangulate_device(sample_codes, sample_sd, sdf_res, iso,
                              cell_cap, device)
    return TriangleMesh(v, f, _vertex_normals(v, f))
