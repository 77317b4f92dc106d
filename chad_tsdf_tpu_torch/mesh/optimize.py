"""Mesh contour optimization — a numpy copy of
``chad_tsdf_tpu/mesh/optimize.py``.

The reference's "PMC" path runs LVR2's ``optimizePlanarFaces(mesh, 5)``
after triangulation (reference: src/chad/detail/lvr2.cpp:262-266) — an
iterative pass that clusters planar face regions and regresses their
vertices so walls/ground mesh with clean contours.  Two equivalents here:

* :func:`optimize_planar_faces` — the faithful-in-intent analog: faces are
  clustered into planar regions (connected components over the face-
  adjacency graph gated by normal similarity, with a cluster-level
  planarity check so curved surfaces are never flattened), a regression
  plane is fit per region, interior vertices are projected onto their
  region's plane, and contour vertices shared by 2 (3) regions are
  projected onto the planes' intersection line (point) — the step that
  produces the reference's crisp planar contours.
* :func:`taubin_smooth` — the generic shrink-free λ|μ smoother, kept as the
  geometry-agnostic option.

Both are off by default (``TSDFMap.extract_mesh(optimize_iterations=...)``)
so meshes stay bit-reproducible for the test oracles.
"""

from __future__ import annotations

import numpy as np

from .mc import TriangleMesh, _vertex_normals


def taubin_smooth(mesh: TriangleMesh, iterations: int = 5,
                  lam: float = 0.5, mu: float = -0.53) -> TriangleMesh:
    """Shrink-free smoothing over the vertex one-ring graph."""
    if iterations <= 0 or mesh.n_faces == 0:
        return mesh
    v = mesh.vertices.astype(np.float64).copy()
    f = mesh.faces
    edges = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]])
    edges = np.unique(np.sort(edges, axis=1), axis=0)
    i, j = edges[:, 0], edges[:, 1]
    deg = np.zeros(len(v))
    np.add.at(deg, i, 1)
    np.add.at(deg, j, 1)
    deg = np.maximum(deg, 1)[:, None]

    def laplace_step(v, factor):
        acc = np.zeros_like(v)
        np.add.at(acc, i, v[j])
        np.add.at(acc, j, v[i])
        return v + factor * (acc / deg - v)

    for _ in range(iterations):
        v = laplace_step(v, lam)
        v = laplace_step(v, mu)
    v = v.astype(np.float32)
    return TriangleMesh(v, f, _vertex_normals(v, f))


# ---------------------------------------------------------------------------
# Planar-region contour optimization (lvr2.cpp:262-266 analog)
# ---------------------------------------------------------------------------

def _face_geometry(v: np.ndarray, f: np.ndarray):
    """Unit face normals, face areas, face centroids."""
    a, b, c = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
    cr = np.cross(b - a, c - a)
    dbl = np.linalg.norm(cr, axis=1)
    n = cr / np.maximum(dbl, 1e-30)[:, None]
    return n, dbl * 0.5, (a + b + c) / 3.0


def _planar_regions(f: np.ndarray, fn: np.ndarray, areas: np.ndarray,
                    cos_threshold: float, min_region_size: int):
    """Cluster faces into planar regions.

    Connected components over the face-adjacency graph restricted to edges
    whose two faces' normals agree (dot > cos_threshold), then a cluster-
    level planarity gate: a component whose faces deviate from the cluster
    mean normal beyond the threshold is discarded wholesale — pairwise
    chaining on smoothly curved surfaces (a sphere passes every pairwise
    test) must not produce a "planar" region.  Returns (region id per face,
    -1 = none; region unit normals (R, 3); region offsets d (R,))."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    nf = f.shape[0]
    # face adjacency via shared (sorted) edges
    e = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]])
    e = np.sort(e, axis=1)
    fid = np.tile(np.arange(nf, dtype=np.int64), 3)
    ekey = e[:, 0].astype(np.int64) * (f.max() + 1) + e[:, 1]
    order = np.argsort(ekey, kind="stable")
    ekey_s, fid_s = ekey[order], fid[order]
    same = ekey_s[1:] == ekey_s[:-1]
    fa, fb = fid_s[:-1][same], fid_s[1:][same]
    agree = np.einsum("ij,ij->i", fn[fa], fn[fb]) > cos_threshold
    fa, fb = fa[agree], fb[agree]

    graph = coo_matrix((np.ones(len(fa)), (fa, fb)), shape=(nf, nf))
    n_comp, labels = connected_components(graph, directed=False)

    # area-weighted mean normal + planarity gate per component
    wn = fn * areas[:, None]
    mean_n = np.zeros((n_comp, 3))
    np.add.at(mean_n, labels, wn)
    norm = np.linalg.norm(mean_n, axis=1)
    mean_n = mean_n / np.maximum(norm, 1e-30)[:, None]
    dots = np.einsum("ij,ij->i", fn, mean_n[labels])
    min_dot = np.full(n_comp, 2.0)
    np.minimum.at(min_dot, labels, dots)
    sizes = np.bincount(labels, minlength=n_comp)
    keep = (sizes >= min_region_size) & (min_dot > cos_threshold)

    remap = np.full(n_comp, -1, np.int64)
    remap[keep] = np.arange(keep.sum())
    return remap[labels], mean_n[keep]


def optimize_planar_faces(mesh: TriangleMesh, iterations: int = 5,
                          cos_threshold: float = 0.85,
                          min_region_size: int = 12) -> TriangleMesh:
    """Planar-region contour optimization — the analog of LVR2's
    ``optimizePlanarFaces(mesh, 5)`` run by the reference's PMC meshing path
    (reference: src/chad/detail/lvr2.cpp:262-266).

    Per iteration: cluster faces into planar regions, fit an area-weighted
    regression plane per region, then move every vertex to the nearest
    point satisfying ALL planes of the regions it touches — interior
    vertices project onto their plane, edge (contour) vertices onto the
    intersection line of their two planes, corner vertices onto the
    intersection point of three.  Curved surfaces are untouched (planarity
    gate in :func:`_planar_regions`), so the pass coplanarizes staircase
    artifacts on walls/ground without volume loss.
    """
    if iterations <= 0 or mesh.n_faces == 0:
        return mesh
    v = mesh.vertices.astype(np.float64).copy()
    f = mesh.faces

    for _ in range(iterations):
        fn, areas, cent = _face_geometry(v, f)
        region, rn = _planar_regions(f, fn, areas, cos_threshold,
                                     min_region_size)
        if rn.shape[0] == 0:
            break
        # region plane offsets: area-weighted centroid projected on normal
        wsum = np.zeros(rn.shape[0])
        csum = np.zeros((rn.shape[0], 3))
        sel = region >= 0
        np.add.at(wsum, region[sel], areas[sel])
        np.add.at(csum, region[sel], cent[sel] * areas[sel][:, None])
        rd = np.einsum("ij,ij->i", rn, csum / np.maximum(wsum, 1e-30)[:, None])

        # distinct regions per vertex (up to 3, via sorted unique pairs)
        vid = f.ravel()
        reg = np.repeat(region, 3)
        m = reg >= 0
        pairs = np.unique(
            vid[m].astype(np.int64) * (rn.shape[0] + 1) + reg[m])
        pv = pairs // (rn.shape[0] + 1)
        pr = (pairs % (rn.shape[0] + 1)).astype(np.int64)
        first = np.concatenate([[True], pv[1:] != pv[:-1]])
        slot = np.arange(len(pv)) - np.maximum.accumulate(
            np.where(first, np.arange(len(pv)), 0))
        use = slot < 3
        vplanes = np.full((v.shape[0], 3), -1, np.int64)
        vplanes[pv[use], slot[use]] = pr[use]

        nk = (vplanes >= 0).sum(axis=1)
        # normals/offsets per vertex constraint slot (unit rows where absent)
        vp = np.where(vplanes >= 0, vplanes, 0)
        N = rn[vp]                                  # (V, 3, 3)
        d = rd[vp]                                  # (V, 3)
        present = (vplanes >= 0)[..., None]
        N = np.where(present, N, 0.0)
        d = np.where(vplanes >= 0, d, 0.0)
        # least-norm correction: p' = p - N^T (N N^T)^+ (N p - d), computed
        # as a damped 3x3 solve (Gram matrix of the active constraints)
        G = N @ N.transpose(0, 2, 1) + 1e-9 * np.eye(3)
        r = np.einsum("vkj,vj->vk", N, v) - d
        lam = np.linalg.solve(G, r[..., None])[..., 0]
        delta = -np.einsum("vk,vkj->vj", lam, N)
        # near-parallel plane pairs (two offset parallel walls sharing a
        # vertex) make G ill-conditioned; damping bounds the solve and the
        # move is capped at one mean edge length so a degenerate constraint
        # can never fling a vertex
        edge = v[f[:, 1]] - v[f[:, 0]]
        mean_edge = float(np.mean(np.linalg.norm(edge, axis=1))) + 1e-30
        step = np.linalg.norm(delta, axis=1)
        scale = np.minimum(1.0, mean_edge / np.maximum(step, 1e-30))
        v = np.where((nk > 0)[:, None], v + delta * scale[:, None], v)

    v = v.astype(np.float32)
    return TriangleMesh(v, f, _vertex_normals(v, f))
