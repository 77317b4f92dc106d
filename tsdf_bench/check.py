"""What decides ``correct``: the program's outputs read back, the plain
reference (``reference/tsdf_ref.py``) worked out again from the same
inputs, and the numbers compared.

Numbers (each with the limit the workload file gives it):

* ``w_mismatch``: voxels whose weight differs from the reference's sample
  count, a voxel missing on one side counting once: in the active map
  (f32 counts) and in each finished submap checked (8-bit weight codes,
  ``min(count, 254)``);
* ``sd_off_share``: the share of the active map's voxels whose mean
  signed distance (``pool_sd / pool_w``) lies farther from the reference's
  than ``SD_OFF_M`` plus the rounding bound of the program's f32 sum over
  the inserts that touched the voxel (``sd_tolerance``);
* ``leaf_off_share``: the share of a finished submap's voxels whose 8-bit
  signed-distance code (``leaf_arrays``) differs from the code of the
  reference's mean;
* ``mesh_off_share``: the share of the last saved mesh's vertices and the
  reference's marching-cubes vertices that have no vertex of the other
  side within 1e-5 m.  The reference meshes what a save fuses
  (:func:`fused_samples`): every submap of the run's inserts, finished or
  active, each coded as a finished submap keeps it; only the first where
  the configuration sets ``mesh_first_submap_only``.
"""

from __future__ import annotations

import numpy as np
import torch

from .reference import tsdf_ref as R

MATCH_M = 1e-5
# 5x the widest gap of a well-conditioned voxel between the f32 program and
# the f64 reference (1.5e-6 m of fixed-point grid and f32 rounding); a
# voxel beyond it has a sample whose plane fit is ill-conditioned (the
# weighted-determinant signs decided by rounding), or is wrong
SD_OFF_M = 1e-5
F32_EPS = 2.0 ** -24


def sd_tolerance(ref: R.Voxels) -> np.ndarray:
    """Per voxel: ``SD_OFF_M`` plus the bound on the rounding of a
    recursive f32 sum of ``n`` adds, u * n * sum|x| (u = 2^-24), over the
    count, with two adds an update: an insert's band (K3 merges up to a row
    per tile that holds the voxel) or an insert's carve (its product and
    its add).  A map that keeps integrating one place for thousands of
    inserts drifts by some 1e-5 m that way."""
    adds = 2.0 * ref.inserts.cpu().numpy()
    mean_abs = (ref.abs_sums / ref.counts.to(torch.float64)).cpu().numpy()
    return SD_OFF_M + F32_EPS * adds * mean_abs


def _compact(x: np.ndarray, bits: int) -> np.ndarray:
    out = np.zeros_like(x)
    for b in range(bits):
        out |= ((x >> (3 * b)) & 1) << b
    return out


def read_active(state, block_bits: int):
    """The active map's occupied voxels from the program's state (the dense
    block pool, its sorted directory of local block Morton keys, and the
    origin block): (keys int64 sorted, sd sums f64, weights f64)."""
    if state is None or int(state.n_blocks) == 0:
        z = np.zeros(0)
        return z.astype(np.int64), z, z
    n = int(state.n_blocks)
    keys = state.dir_keys[:n].cpu().numpy().astype(np.int64)
    slots = state.dir_slots[:n].long()
    sd = state.pool_sd[slots].cpu().numpy()
    w = state.pool_w[slots].cpu().numpy()
    org = state.origin_blocks.cpu().numpy().astype(np.int64) * 8
    off = np.arange(512, dtype=np.int64)
    occ = w > 0
    vox = np.stack([
        (_compact(keys >> a, block_bits)[:, None] * 8 +
         _compact(off >> a, 3)[None, :] + org[a])[occ] for a in range(3)], 1)
    k = R.pack_key(torch.from_numpy(vox)).numpy()
    order = np.argsort(k)
    return (k[order], sd[occ].astype(np.float64)[order],
            w[occ].astype(np.float64)[order])


def read_leaves(coords, sd, w, sdf_trunc: float):
    """A finished submap's ``leaf_arrays``: (keys int64 sorted, sd codes
    int64, weight codes int64)."""
    k = R.pack_key(torch.from_numpy(np.asarray(coords, np.int64))).numpy()
    code = np.rint(np.asarray(sd, np.float64) / sdf_trunc * 127.0) + 127
    order = np.argsort(k)
    return k[order], code.astype(np.int64)[order], \
        np.asarray(w, np.int64)[order]


def read_ply_vertices(path: str) -> np.ndarray:
    """Vertices (V, 3) f32 of a binary little-endian PLY whose vertex
    element leads with float x, y, z."""
    with open(path, "rb") as fh:
        n_vert, props = 0, []
        while True:
            line = fh.readline().decode("ascii").strip()
            if line.startswith("element vertex"):
                n_vert = int(line.split()[2])
                props = []
            elif line.startswith("property") and n_vert and \
                    "list" not in line:
                props.append(line.split()[1])
            elif line.startswith("element"):
                n_prop = len(props)
            elif line == "end_header":
                break
        if any(p != "float" for p in props[:n_prop]):
            raise ValueError(f"{path}: vertex properties {props}")
        data = np.frombuffer(fh.read(4 * n_vert * n_prop), "<f4")
    return data.reshape(n_vert, n_prop)[:, :3].copy()


def _join(ka, kb):
    common, ia, ib = np.intersect1d(ka, kb, assume_unique=True,
                                    return_indices=True)
    return ia, ib, len(ka) + len(kb) - 2 * len(common)


def _share(bad: np.ndarray) -> float:
    return float(bad.mean()) if bad.size else 0.0


def active_numbers(prog, ref: R.Voxels) -> dict:
    """``w_mismatch`` and ``sd_off_share`` of the active map."""
    pk, psum, pw = prog
    rk = ref.keys.cpu().numpy()
    ia, ib, missing = _join(pk, rk)
    counts = ref.counts.cpu().numpy()
    mean = ref.mean.cpu().numpy()
    gap = np.abs(psum[ia] / pw[ia] - mean[ib])
    return {"w_mismatch": missing + int((pw[ia] != counts[ib]).sum()),
            "sd_off_share": _share(gap > sd_tolerance(ref)[ib])}


def leaf_numbers(prog, ref: R.Voxels, sdf_trunc: float) -> dict:
    """``w_mismatch`` and ``leaf_off_share`` of one finished submap."""
    pk, pcode, pw = prog
    code, wcode = (c.cpu().numpy() for c in R.leaf_codes(ref, sdf_trunc))
    ia, ib, missing = _join(pk, ref.keys.cpu().numpy())
    return {"w_mismatch": missing + int((pw[ia] != wcode[ib]).sum()),
            "leaf_off_share": _share(pcode[ia] != code[ib])}


def fused_samples(parts: list, sdf_trunc: float):
    """The samples a save meshes from its submaps, given as (keys int64
    ascending and unique, sd codes, weight codes) each: every sd code
    decoded (``decode_sd``); a voxel that several submaps hold takes the
    mean of their decoded values weighted by ``max(weight code, 1)``,
    worked out in f64 and rounded to f32 (``TSDFMap.voxel_samples``'
    documented fusion).  A voxel of one submap keeps its decoded value
    exactly: an f32 value times a weight under 2^8, and that over the
    weight, are exact in f64.  Returns (keys int64 ascending, sd f32)."""
    keys = torch.cat([k for k, _, _ in parts])
    sd = torch.cat([R.decode_sd(c, sdf_trunc) for _, c, _ in parts])
    w = torch.cat([wc.clamp(min=1) for _, _, wc in parts]).to(torch.float64)
    u, inv = torch.unique(keys, return_inverse=True)
    wsum = torch.zeros(u.shape[0], dtype=torch.float64,
                       device=keys.device).index_add_(0, inv, w)
    sdw = torch.zeros_like(wsum).index_add_(0, inv, sd.to(torch.float64) * w)
    return u, (sdw / wsum).to(torch.float32)


def mesh_reference(groups: list, sem: R.Semantics) -> np.ndarray:
    """The reference's marching-cubes vertices (M, 3) f32 of a save of the
    submaps whose reference voxels are ``groups``, oldest first: of the
    first alone where the configuration meshes the first submap only, as
    the program does."""
    if sem.mesh_first_submap_only:
        groups = groups[:1]
    # each submap coded as a finished submap keeps it; a save finalizes the
    # active submap's snapshot into the same codes
    keys, sd = fused_samples(
        [(g.keys, *R.leaf_codes(g, sem.sdf_trunc)) for g in groups],
        sem.sdf_trunc)
    return R.mesh_vertices(keys, sd, sem.sdf_res).cpu().numpy()


def mesh_numbers(prog_vertices: np.ndarray, rv: np.ndarray) -> dict:
    """``mesh_off_share`` of a saved mesh's vertices against the
    reference's, ``rv`` (:func:`mesh_reference`)."""
    from scipy.spatial import cKDTree
    if len(rv) == 0 or len(prog_vertices) == 0:
        return {"mesh_off_share": 0.0 if len(rv) == len(prog_vertices)
                else 1.0}
    d_prog, _ = cKDTree(rv).query(prog_vertices, distance_upper_bound=1.0)
    d_ref, _ = cKDTree(prog_vertices).query(rv, distance_upper_bound=1.0)
    off = int((d_prog > MATCH_M).sum()) + int((d_ref > MATCH_M).sum())
    return {"mesh_off_share": off / (len(rv) + len(prog_vertices))}


def merge(numbers: list) -> dict:
    """One reading per name: counts add, shares take the largest."""
    out: dict = {}
    for d in numbers:
        for k, v in d.items():
            if k not in out:
                out[k] = v
            elif k == "w_mismatch":
                out[k] += v
            else:
                out[k] = max(out[k], v)
    return out


def template_of(traffic, i: int) -> int:
    """The template of scan ``i``: the generator's ``template(i)`` where it
    has one, else ``i % len(templates)``."""
    pick = getattr(traffic, "template", None)
    return pick(i) if pick is not None else i % len(traffic.templates)


class Reference:
    """The reference's voxels for groups of inserts, each (template,
    position) computed once and weighted by how often it was inserted.

    A carving map's carve depends on what the submap holds (the erosion
    rule, ``reference/tsdf_ref.py``), so the steps of a group are walked in
    insert order: the band of each (template, position) is computed once,
    and its carve once per size of the set of allocated blocks it meets.
    That set only grows within a submap, so one size is one set; a parked
    stream's set stops growing after one cycle of templates, and each
    template's carve is worked out about twice.  Without carving the walk
    only counts the bands."""

    def __init__(self, traffic, sem: R.Semantics, device, dtype=None):
        self.traffic, self.sem, self.device = traffic, sem, device
        self.dtype = torch.float64 if dtype is None else dtype
        self.touched: dict = {}         # template -> voxels of one insert

    def voxels(self, steps: list) -> R.Voxels:
        first = self.traffic.position(steps[0])
        carving = self.sem.carve_steps > 0
        band: dict = {}             # (template, position) -> its band
        samples: dict = {}          # (template, position) -> carve samples
        carved: dict = {}           # (template, position, size) -> carve
        mult: dict = {}             # ("band" | "carve", key) -> multiplicity
        allocated = torch.zeros(0, dtype=torch.int64, device=self.device)
        for i in steps:
            k = (template_of(self.traffic, i),
                 tuple(self.traffic.position(i).tolist()))
            if k not in band:
                keys, sd = R.scan_samples(self.traffic.points(i),
                                          self.traffic.position(i), first,
                                          self.sem, self.device, self.dtype)
                band[k] = R.reduce_samples(keys, sd)
                self.touched[k[0]] = int(band[k].keys.shape[0])
                if carving:
                    allocated = torch.unique(torch.cat(
                        [allocated, R.block_keys(band[k].keys)]))
                    samples[k] = R.carve_samples(
                        self.traffic.points(i), self.traffic.position(i),
                        first, self.sem, self.device)
            parts = [("band", k)]
            if carving:
                c = k + (int(allocated.shape[0]),)
                if c not in carved:
                    carved[c] = R.carve_voxels(*samples[k], allocated,
                                               self.sem)
                parts.append(("carve", c))
            for p in parts:
                mult[p] = mult.get(p, 0) + 1
        return R.combine([(band[key] if kind == "band" else carved[key], m)
                          for (kind, key), m in mult.items()])


def judge(numbers: dict, limits: dict) -> bool:
    return all(numbers[k] <= limits[k] for k in numbers)
