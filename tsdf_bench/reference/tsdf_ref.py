"""Plain reference of what ``TSDFMap`` computes, in plain PyTorch.

It imports nothing of the measured package: the semantics below are the
port's documented ones (its module docstrings and ``MapConfig``), written
out again from the inputs the benchmark made.  Every tensor may live on the
card or on the CPU; the reference runs once a run's window has closed.

Semantics, per insert of ``points`` scanned from ``position``:

* packed ingest (``MapConfig.packed_ingest``): each point is rounded to
  int16 steps of ``sdf_res / 8`` relative to the scanner (round half to
  even, in f64, clipped to +-32767), then ``q * step + position`` in f32;
* voxel ``floor(p * f32(1 / sdf_res))``; a submap keeps voxels within
  ``2**block_bits * 8`` of its origin block (``floor(first position /
  (8 res)) - 2**(block_bits - 1)``);
* normals: the points of one cell of ``2**d`` voxels a side (d = 0, 1, 2,
  cells aligned to the voxel grid) form a neighbourhood; each point takes
  the smallest d whose cell holds >= ``normal_min_points`` points, fits a
  plane by the weighted-determinant method, and flips it toward the
  scanner; with no such cell, the unit vector to the scanner;
* the Amanatides-Woo walk from ``p - dir * trunc`` to ``p + dir * trunc``
  in f32 (each operation rounded, no fused multiply-add), at most
  ``dda_steps`` voxels, with the walk's tie-break and stop rule;
* signed distance ``clamp(n . (voxel * res - p), -trunc, trunc)``;
* a voxel's value is the mean of its samples, its weight their count.

Space carving (``MapConfig.carve_steps > 0``; ``core/carve.py``'s
docstring and ``MapConfig``'s comments), after each insert's band:

* every ``carve_subsample``-th row of the ingested cloud, in its input
  order, is a ray from the scanner along the unit vector ``(p - position) /
  |p - position|`` (f32, the norm as ``sqrt((dx dx + dy dy) + dz dz)``);
* its sample ``i < carve_steps`` lies at ``t = (i + 0.5) * f32(stride *
  res)`` and is valid while ``t < |p - position| - f32(trunc)``; it is
  voxelized as the walk is, ``floor((position + u * t) * f32(1 / res))``,
  each f32 operation rounded, and dropped outside the local extent;
* erosion only: a sample counts only where its block (8 voxels a side)
  holds a band sample of this submap, from an earlier insert or from this
  one (the band goes in before its carve);
* each counted sample is an observation of ``+trunc`` with weight
  ``carve_weight``: it adds ``trunc * w`` to the voxel's sum, ``w`` to its
  weight.  The check's weights are exact counts, so ``w`` must be 1.

Departures from the program, each far below what ``compare.py`` judges:
the normal fit and the signed distance are computed in f64 (the program
uses f32, anchored at one point of the neighbourhood), and samples are
averaged exactly rather than on the program's 16-bit fixed-point grid of
``trunc / 32767`` (a difference of at most 1.6e-6 m).

``dtype`` (the control) computes the normal fit and the signed distance in
that precision instead; the walk keeps f32, since voxel indices are not
representable in a narrower type.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

BIAS = 1 << 20          # voxel coordinates are packed biased, 21 bits each
FMAX = float(np.float32(3.4028235e38))


@dataclasses.dataclass(frozen=True)
class Semantics:
    """The configuration values the reference needs, read from a
    configuration file's ``map_config`` over the program's defaults."""
    sdf_res: float = 0.05
    sdf_trunc: float = 0.1
    submap_distance: float = 5.0
    normal_min_points: int = 8
    normal_max_depth: int = 3
    block_bits: int = 10
    packed_ingest: bool = False
    max_points: int = 1 << 20
    carve_steps: int = 0
    carve_stride: float = 2.0
    carve_subsample: int = 2
    carve_weight: float = 1.0
    mesh_first_submap_only: bool = False

    def __post_init__(self):
        if self.carve_steps > 0 and self.carve_weight != 1.0:
            raise ValueError(
                f"carve_weight {self.carve_weight}: the check compares "
                f"weights as exact sample counts, so it judges carving "
                f"only at carve_weight 1.0")

    @property
    def dda_steps(self) -> int:
        return int(math.ceil(2.0 * self.sdf_trunc / self.sdf_res *
                             math.sqrt(3.0))) + 3

    @classmethod
    def from_map_config(cls, overrides: dict) -> "Semantics":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in overrides.items() if k in names})


def pack_key(vox: torch.Tensor) -> torch.Tensor:
    """(S, 3) int64 voxel coordinates -> one int64 key each."""
    v = vox.to(torch.int64) + BIAS
    return (v[:, 0] << 42) | (v[:, 1] << 21) | v[:, 2]


def unpack_key(key: torch.Tensor) -> torch.Tensor:
    mask = (1 << 21) - 1
    return torch.stack([(key >> 42) & mask, (key >> 21) & mask, key & mask],
                       dim=1) - BIAS


def origin_voxel(first_position, sem: Semantics) -> np.ndarray:
    half = (1 << sem.block_bits) // 2
    block = np.floor(np.asarray(first_position, np.float64) /
                     (8.0 * sem.sdf_res)) - half
    return block.astype(np.int64) * 8


def ingest(points: torch.Tensor, position: torch.Tensor,
           sem: Semantics) -> torch.Tensor:
    if not sem.packed_ingest:
        return points
    step = sem.sdf_res / 8.0
    q = (points.double() - position.double()) / step
    q = torch.clamp(torch.round(q), -32767, 32767)
    return q.float() * np.float32(step) + position[None, :]


def _plane_normals(cov: torch.Tensor) -> torch.Tensor:
    """Weighted-determinant plane normal of each (G, 6) covariance (xx, xy,
    xz, yy, yz, zz), unit length; zero where the fit has no direction."""
    tiny = torch.finfo(cov.dtype).tiny
    xx, xy, xz, yy, yz, zz = cov.unbind(1)
    scale = cov.abs().amax(1).clamp(min=tiny)
    xx, xy, xz, yy, yz, zz = (c / scale for c in (xx, xy, xz, yy, yz, zz))
    axes = [
        (yy * zz - yz * yz, torch.stack(
            [yy * zz - yz * yz, xz * yz - xy * zz, xy * yz - xz * yy], 1)),
        (xx * zz - xz * xz, torch.stack(
            [xz * yz - xy * zz, xx * zz - xz * xz, xy * xz - yz * xx], 1)),
        (xx * yy - xy * xy, torch.stack(
            [xy * yz - xz * yy, xy * xz - yz * xx, xx * yy - xy * xy], 1)),
    ]
    acc = torch.zeros_like(axes[0][1])
    for det, axis in axes:
        w = det * det
        w = torch.where((acc * axis).sum(1) < 0.0, -w, w)
        acc = acc + axis * w[:, None]
    norm = acc.norm(dim=1, keepdim=True)
    return torch.where(norm > 0, acc / norm.clamp(min=tiny), 0.0)


def normals(p: torch.Tensor, vox: torch.Tensor, position: torch.Tensor,
            sem: Semantics, dtype=torch.float64) -> torch.Tensor:
    """(N, 3) unit normals in ``dtype`` for valid points ``p`` (f32) with
    voxels ``vox``, flipped toward ``position``."""
    n = p.shape[0]
    pd = p.to(torch.float64)
    out = torch.zeros((n, 3), dtype=dtype, device=p.device)
    found = torch.zeros(n, dtype=torch.bool, device=p.device)
    for depth in range(sem.normal_max_depth):
        _, gid, count = torch.unique(pack_key(vox >> depth),
                                     return_inverse=True, return_counts=True)
        use = (~found) & (count[gid] >= sem.normal_min_points)
        if not bool(use.any()):
            continue
        # a cell's fit is over all its points, also those that found a
        # smaller cell
        cnt = count.to(torch.float64)
        mean = torch.zeros((count.shape[0], 3), dtype=torch.float64,
                           device=p.device).index_add_(0, gid, pd)
        mean = mean / cnt[:, None]
        r = (pd - mean[gid]).to(dtype)
        prods = torch.stack([r[:, 0] * r[:, 0], r[:, 0] * r[:, 1],
                             r[:, 0] * r[:, 2], r[:, 1] * r[:, 1],
                             r[:, 1] * r[:, 2], r[:, 2] * r[:, 2]], 1)
        cov = torch.zeros((count.shape[0], 6), dtype=dtype,
                          device=p.device).index_add_(0, gid, prods)
        cov = cov / cnt[:, None].to(dtype)
        out[use] = _plane_normals(cov)[gid[use]]
        found |= use
    to_scanner = position.to(torch.float64)[None, :] - pd
    flip = (out.to(torch.float64) * to_scanner).sum(1) < 0.0
    out = torch.where(flip[:, None], -out, out)
    fallback = to_scanner / to_scanner.norm(dim=1, keepdim=True)
    return torch.where(found[:, None], out, fallback.to(dtype))


def _walk_axis(p, d, res: float, recip: float, trunc: float):
    start = p - d * trunc
    final = p + d * trunc
    vs = torch.floor(start * recip).to(torch.int64)
    vf = torch.floor(final * recip).to(torch.int64)
    step = torch.sign(vf - vs)
    d_recip = 1.0 / d
    delta = torch.abs(d_recip * res)
    bound = torch.where(step < 0, torch.floor(start * recip) * res,
                        torch.ceil(start * recip) * res)
    tmax = torch.abs((bound - start) * d_recip)
    tmax = torch.where(step == 0, FMAX, tmax)
    delta = torch.where(step == 0, FMAX, delta)
    return vs, vf, step, delta, tmax


def walk(p: torch.Tensor, position: torch.Tensor, sem: Semantics):
    """Voxels each ray crosses in its band: (K, N, 3) int64 and (K, N)
    bool, K = ``dda_steps``."""
    res = float(np.float32(sem.sdf_res))
    trunc = float(np.float32(sem.sdf_trunc))
    recip = float(np.float32(1.0 / sem.sdf_res))
    d = p - position[None, :]
    norm = torch.sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] +
                      d[:, 2] * d[:, 2])
    d = d * (1.0 / norm)[:, None]
    alive = torch.isfinite(d).all(1)
    axes = [_walk_axis(p[:, a], d[:, a], res, recip, trunc) for a in range(3)]
    v = [a[0] for a in axes]
    t = [a[4] for a in axes]
    out_v, out_ok = [torch.stack(v, 1)], [alive]
    for _ in range(sem.dda_steps - 1):
        px = (t[0] < t[1]) & (t[0] < t[2])
        py = (~(t[0] < t[1])) & (t[1] < t[2])
        pick = [px, py, ~(px | py)]
        for a in range(3):
            v[a] = torch.where(pick[a], v[a] + axes[a][2], v[a])
            t[a] = torch.where(pick[a], t[a] + axes[a][3], t[a])
        passed = torch.zeros_like(alive)
        for a in range(3):
            passed |= pick[a] & (v[a] == axes[a][1] + axes[a][2])
        alive = alive & ~passed
        out_v.append(torch.stack(v, 1))
        out_ok.append(alive)
    return torch.stack(out_v), torch.stack(out_ok)


def scan_samples(points, position, first_position, sem: Semantics,
                 device="cpu", dtype=torch.float64):
    """One insert's samples: (voxel keys int64 (S,), signed distances f64
    (S,)) over every valid sample, in no particular order."""
    pos = torch.as_tensor(np.asarray(position, np.float32), device=device)
    p = ingest(torch.as_tensor(np.asarray(points, np.float32),
                               device=device), pos, sem)
    recip = float(np.float32(1.0 / sem.sdf_res))
    extent = (1 << sem.block_bits) * 8
    org = torch.as_tensor(origin_voxel(first_position, sem), device=device)
    vox = torch.floor(p * recip).to(torch.int64)
    inside = ((vox - org >= 0) & (vox - org < extent)).all(1)
    p, vox = p[inside], vox[inside]
    nrm = normals(p, vox, pos, sem, dtype)
    sv, ok = walk(p, pos, sem)                                # (K, N, ...)
    ok &= ((sv - org >= 0) & (sv - org < extent)).all(2)
    res = np.float32(sem.sdf_res)
    rel = sv.to(torch.float32) * res - p[None]               # (K, N, 3)
    sd = (rel.to(dtype) * nrm[None]).sum(2)
    sd = torch.clamp(sd, -sem.sdf_trunc, sem.sdf_trunc)
    return pack_key(sv[ok]), sd[ok].to(torch.float64)


def carve_samples(points, position, first_position, sem: Semantics,
                  device="cpu"):
    """One insert's free-space samples inside the local extent, before the
    erosion rule: (voxel keys int64 (U,) ascending and unique, their sample
    counts int64 (U,))."""
    if len(points) > sem.max_points:
        raise ValueError(f"{len(points)} points: the map carves each "
                         f"chunk of max_points ({sem.max_points}) rows "
                         f"after that chunk's band; one chunk is modelled")
    pos = torch.as_tensor(np.asarray(position, np.float32), device=device)
    p = ingest(torch.as_tensor(np.asarray(points, np.float32),
                               device=device), pos, sem)
    d = p[::sem.carve_subsample] - pos[None, :]                  # (R, 3)
    r = torch.sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] +
                   d[:, 2] * d[:, 2])
    u = d / torch.clamp(r, min=1e-12)[:, None]
    limit = r - np.float32(sem.sdf_trunc)
    stride = np.float32(sem.carve_stride * sem.sdf_res)
    recip = np.float32(1.0 / sem.sdf_res)
    extent = (1 << sem.block_bits) * 8
    org = torch.as_tensor(origin_voxel(first_position, sem), device=device)
    keys = []
    # 16 steps of every ray at a time, which bounds the memory
    for i0 in range(0, sem.carve_steps, 16):
        i = torch.arange(i0, min(i0 + 16, sem.carve_steps),
                         dtype=torch.float32, device=device)
        t = (i + 0.5) * stride                                  # (k,)
        q = u[None, :, :] * t[:, None, None]
        q = q + pos
        vox = torch.floor(q * recip).to(torch.int64)            # (k, R, 3)
        ok = (t[:, None] < limit[None, :]) & \
            ((vox - org >= 0) & (vox - org < extent)).all(2)
        keys.append(pack_key(vox[ok]))
    return torch.unique(torch.cat(keys), return_counts=True)


def block_keys(voxel_keys: torch.Tensor) -> torch.Tensor:
    """The packed key of each voxel's block (8 voxels a side), as a
    voxel-like key of the block's coordinates."""
    return pack_key(unpack_key(voxel_keys) >> 3)


@dataclasses.dataclass
class Voxels:
    """Code-sorted voxels: keys int64 (V,), signed-distance sums f64 (V,),
    sample counts int64 (V,), sums of the samples' absolute signed
    distances f64 (V,), and the number of updates that touched each: an
    insert's band, and an insert's carve (each one f32 product and one f32
    add of the voxel's carve samples in the program)."""
    keys: torch.Tensor
    sums: torch.Tensor
    counts: torch.Tensor
    abs_sums: torch.Tensor
    inserts: torch.Tensor

    @property
    def mean(self) -> torch.Tensor:
        return self.sums / self.counts.to(torch.float64)


def _scatter(inv, n, values, dtype):
    return torch.zeros(n, dtype=dtype, device=inv.device).index_add_(
        0, inv, values.to(dtype))


def reduce_samples(keys: torch.Tensor, sd: torch.Tensor) -> Voxels:
    """One insert's samples -> its voxels."""
    u, inv = torch.unique(keys, return_inverse=True)
    n = u.shape[0]
    return Voxels(u, _scatter(inv, n, sd, torch.float64),
                  _scatter(inv, n, torch.ones_like(inv), torch.int64),
                  _scatter(inv, n, sd.abs(), torch.float64),
                  torch.ones(n, dtype=torch.int64, device=keys.device))


def combine(parts: list) -> Voxels:
    """Sum of (Voxels, multiplicity) pairs: a voxel's sums and counts add
    over inserts, as the map accumulates them."""
    keys = torch.cat([v.keys for v, _ in parts])
    u, inv = torch.unique(keys, return_inverse=True)
    n = u.shape[0]

    def total(field, dtype):
        return _scatter(inv, n, torch.cat([getattr(v, field) * m
                                           for v, m in parts]), dtype)
    return Voxels(u, total("sums", torch.float64),
                  total("counts", torch.int64),
                  total("abs_sums", torch.float64),
                  total("inserts", torch.int64))


def carve_voxels(keys: torch.Tensor, counts: torch.Tensor,
                 allocated: torch.Tensor, sem: Semantics) -> Voxels:
    """One insert's carve under the erosion rule: the samples of
    :func:`carve_samples` whose block is in ``allocated`` (block keys),
    each an observation of ``+trunc``."""
    keep = torch.isin(block_keys(keys), allocated)
    keys, counts = keys[keep], counts[keep]
    sums = counts.to(torch.float64) * (sem.sdf_trunc * sem.carve_weight)
    return Voxels(keys, sums, counts, sums.clone(),
                  torch.ones_like(counts))


def submap_groups(positions, sem: Semantics) -> list:
    """Insert indices per submap under the rotation policy: a new submap
    when a scan's position lies more than ``submap_distance`` from the
    first position of the active one (f32 positions, as inserted)."""
    groups, first = [], None
    for i, pos in enumerate(positions):
        pos = np.asarray(pos, np.float32)
        if first is None or np.linalg.norm(pos - first) > \
                sem.submap_distance:
            groups.append([])
            first = pos
        groups[-1].append(i)
    return groups


def leaf_codes(vox: Voxels, sdf_trunc: float):
    """The 8-bit codes a finished submap stores: (sd codes, weight codes)
    int64, ``floor(clamp(mean / trunc, -1, 1) * 127 + 127)`` and
    ``min(count, 254)``."""
    m = torch.clamp(vox.mean / sdf_trunc, -1.0, 1.0)
    return (torch.floor(m * 127.0 + 127.0).to(torch.int64),
            torch.clamp(vox.counts, max=254))


def decode_sd(codes: torch.Tensor, sdf_trunc: float) -> torch.Tensor:
    """f32 signed distance of an 8-bit code."""
    sd = codes.to(torch.float32) - 127.0
    return sd * np.float32(1.0 / 127.0) * np.float32(sdf_trunc)


CORNERS = torch.tensor([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
                        [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]])


def mesh_vertices(keys: torch.Tensor, sd: torch.Tensor,
                  sdf_res: float) -> torch.Tensor:
    """Marching-cubes vertices (M, 3) f32 of voxel samples (corner values
    at ``voxel * res``): one on every cell edge whose ends differ in
    ``sd < 0``, over the cells whose 8 corners all hold a sample, placed by
    linear interpolation of the two ends."""
    dev = keys.device
    order = torch.argsort(keys)
    keys, sd = keys[order], sd[order]
    vox = unpack_key(keys)
    edge_vertices = []
    corners = CORNERS.to(dev)
    for axis in range(3):
        step = torch.zeros(3, dtype=torch.int64, device=dev)
        step[axis] = 1
        nb = pack_key(vox + step)
        j = torch.searchsorted(keys, nb).clamp(max=keys.shape[0] - 1)
        has = keys[j] == nb
        a = torch.nonzero(has).squeeze(1)
        b = j[a]
        cross = (sd[a] < 0) != (sd[b] < 0)
        a, b = a[cross], b[cross]
        # the edge belongs to a mesh cell when one of the 4 cells around it
        # has all 8 corners
        lo = vox[a]
        other = [x for x in range(3) if x != axis]
        in_cell = torch.zeros(a.shape[0], dtype=torch.bool, device=dev)
        for du in (0, -1):
            for dv in (0, -1):
                cell = lo.clone()
                cell[:, other[0]] += du
                cell[:, other[1]] += dv
                full = torch.ones_like(in_cell)
                for c in corners:
                    ck = pack_key(cell + c)
                    k = torch.searchsorted(keys, ck).clamp(
                        max=keys.shape[0] - 1)
                    full &= keys[k] == ck
                in_cell |= full
        a, b = a[in_cell], b[in_cell]
        sa, sb = sd[a], sd[b]
        denom = sa - sb
        t = torch.where(denom.abs() > 1e-30,
                        sa / torch.where(denom == 0, 1.0, denom), 0.5)
        t = torch.clamp(t, 0.0, 1.0)
        pa = vox[a].to(torch.float32)
        pb = vox[b].to(torch.float32)
        edge_vertices.append((pa + (pb - pa) * t[:, None]) *
                             np.float32(sdf_res))
    return torch.cat(edge_vertices)
