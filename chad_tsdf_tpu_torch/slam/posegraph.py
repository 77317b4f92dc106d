"""Pose-graph optimization — PyTorch port of
``chad_tsdf_tpu/slam/posegraph.py`` (the reference's unbuilt "Loop
closure" roadmap item, reference README.md:59, declared surface
include/chad/tsdf.hpp:158-161).

Nodes are submap poses in SE(3); edges are relative-pose constraints:
odometry between consecutive submaps plus loop closures.  The residual of
edge (i, j) with measurement Z is ``log(Z^-1 · T_i^-1 · T_j)`` in the se(3)
tangent.  Gauss-Newton / LM iterations linearize it with forward-mode
autodiff (``torch.func.jacfwd`` over the per-node local perturbations,
vmapped over the edges), as the JAX package does with ``jax.jacfwd``.
Everything is f32 torch on one device.

The normal equations are accumulated in a fixed order: the per-edge blocks
fill a dense (6E, 6N) Jacobian and ``H = Jᵀ J``, ``b = Jᵀ r`` are one
product each (N is the submap count, so the matrix is small), where the JAX
package adds the blocks one edge at a time in a ``lax.scan``.  Float
``index_add_`` on CUDA would sum in no fixed order.  With a ``mesh``
(``parallel.make_mesh``) the edges are split over its shards and the
shards' normal equations summed, the JAX package's ``psum``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.func import jacfwd, vmap


# ---------------------------------------------------------------------------
# SE(3) exponential / logarithm (tangent = [rho, phi]: translation, rotation)
# ---------------------------------------------------------------------------

def _hat(v):
    x, y, z = v[0], v[1], v[2]
    zero = torch.zeros_like(x)
    return torch.stack([
        torch.stack([zero, -z, y]),
        torch.stack([z, zero, -x]),
        torch.stack([-y, x, zero]),
    ])


def _eye3(like):
    return torch.eye(3, dtype=like.dtype, device=like.device)


def se3_exp(xi):
    """se(3) tangent (6,) [rho, phi] -> (4, 4) homogeneous transform."""
    rho, phi = xi[:3], xi[3:]
    theta = torch.sqrt(torch.sum(phi * phi) + 1e-32)
    k = _hat(phi / theta)
    s, c = torch.sin(theta), torch.cos(theta)
    eye = _eye3(xi)
    # Rodrigues; first order below 1e-6 (the 1e-32 guard keeps the
    # normalized axis finite, so both branches are NaN-free under jacfwd)
    small = theta < 1e-6
    r_full = eye + s * k + (1.0 - c) * (k @ k)
    r_small = eye + _hat(phi)
    R = torch.where(small, r_small, r_full)
    # left Jacobian V
    v_full = eye + (1.0 - c) / theta * k + (1.0 - s / theta) * (k @ k)
    v_small = eye + 0.5 * _hat(phi)
    V = torch.where(small, v_small, v_full)
    t = V @ rho
    top = torch.cat([R, t[:, None]], dim=1)
    bot = torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=xi.dtype,
                       device=xi.device)
    return torch.cat([top, bot], dim=0)


def se3_log(T):
    """(4, 4) homogeneous transform -> se(3) tangent (6,) [rho, phi].

    The atan2 form keeps the derivative finite at the identity, where
    Gauss-Newton linearizes converged edges (arccos((tr - 1) / 2) has an
    infinite slope there).  Valid for |theta| < pi."""
    R = T[:3, :3]
    t = T[:3, 3]
    w_hat = (R - R.T) / 2.0
    w = torch.stack([w_hat[2, 1], w_hat[0, 2], w_hat[1, 0]])  # sin(th)*axis
    sin_t = torch.sqrt(torch.sum(w * w) + 1e-32)
    cos_t = torch.clamp((R[0, 0] + R[1, 1] + R[2, 2] - 1.0) / 2.0, -1.0, 1.0)
    theta = torch.atan2(sin_t, cos_t)
    phi = w * (theta / sin_t)
    small = theta < 1e-6
    k = _hat(w / sin_t)                 # unit axis (guarded by 1e-32)
    one = torch.ones_like(theta)
    th = torch.where(small, one, theta)
    eye = _eye3(T)
    v_full = eye + (1.0 - cos_t) / th * k + (1.0 - sin_t / th) * (k @ k)
    v_small = eye + 0.5 * _hat(phi)
    V = torch.where(small, v_small, v_full)
    return torch.cat([_solve3(V, t), phi])


def _solve3(A, y):
    """``A^-1 y`` for one 3x3 system by Cramer's rule: elementwise, so it
    vmaps and differentiates like any other op (``torch.linalg.solve``
    under ``vmap(jacfwd(...))`` returned NaN for some batch elements)."""
    c0 = torch.linalg.cross(A[:, 1], A[:, 2])
    c1 = torch.linalg.cross(A[:, 2], A[:, 0])
    c2 = torch.linalg.cross(A[:, 0], A[:, 1])
    det = torch.sum(A[:, 0] * c0)
    return torch.stack([torch.sum(c0 * y), torch.sum(c1 * y),
                        torch.sum(c2 * y)]) / det


def _rigid_inv(T):
    """Inverse of a rigid (4, 4) transform: [R^T, -R^T t]."""
    rt = T[:3, :3].T
    top = torch.cat([rt, -(rt @ T[:3, 3])[:, None]], dim=1)
    return torch.cat([top, T[3:]], dim=0)


# ---------------------------------------------------------------------------
# Pose graph
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PoseGraph:
    n_nodes: int
    edges: np.ndarray          # (E, 2) int32 node indices (i, j)
    measurements: np.ndarray   # (E, 4, 4) float32 Z_ij: T_i^-1 T_j measured
    weights: np.ndarray        # (E,) float32 information scale per edge


def make_odometry_edges(poses: np.ndarray, noise: float = 0.0,
                        seed: int = 0) -> PoseGraph:
    """Consecutive-pose odometry constraints from a trajectory (T, 4, 4);
    optional multiplicative tangent noise to simulate drift (for tests; the
    f32 exponential runs on the CPU)."""
    t = poses.shape[0]
    rng = np.random.default_rng(seed)
    edges, zs = [], []
    for i in range(t - 1):
        z = np.linalg.inv(poses[i]) @ poses[i + 1]
        if noise > 0:
            xi = rng.normal(0, noise, 6)
            z = z @ se3_exp(torch.as_tensor(xi, dtype=torch.float32)).numpy()
        edges.append((i, i + 1))
        zs.append(z)
    return PoseGraph(t, np.asarray(edges, np.int32),
                     np.asarray(zs, np.float32),
                     np.ones(len(edges), np.float32))


def add_edge(graph: PoseGraph, i: int, j: int, z: np.ndarray,
             weight: float = 1.0) -> PoseGraph:
    return PoseGraph(
        graph.n_nodes,
        np.concatenate([graph.edges, np.asarray([(i, j)], np.int32)]),
        np.concatenate([graph.measurements,
                        np.asarray(z, np.float32)[None]]),
        np.concatenate([graph.weights, np.asarray([weight], np.float32)]))


def _edge_residual(xi_i, xi_j, base_i, base_j, z_inv):
    """Residual of one edge at local perturbations (xi around base poses)."""
    ti = base_i @ se3_exp(xi_i)
    tj = base_j @ se3_exp(xi_j)
    return se3_log(z_inv @ (_rigid_inv(ti) @ tj))


_edge_jac = jacfwd(_edge_residual, argnums=(0, 1))


def _edge_blocks(base_i, base_j, z_inv, w, huber_delta=0.0,
                 mode: str = "huber"):
    """Per-edge normal-equation blocks at xi = 0: (r (6,), Ji (6, 6),
    Jj (6, 6)) scaled by sqrt(w) times the robust scale of ``mode``:

    ``dcs`` (Dynamic Covariance Scaling, Agarwal et al. 2013): scale
    ``min(1, 2*phi / (phi + w*||r||^2))`` with ``phi = huber_delta^2``, a
    redescending kernel, so a grossly wrong constraint's pull vanishes;
    ``huber``: ``sqrt(min(1, d / ||r||))``, convex, bounded influence;
    ``quad``: plain least squares.  ``huber_delta <= 0`` disables the
    robust scale in any mode."""
    zero = torch.zeros(6, dtype=base_i.dtype, device=base_i.device)
    r = _edge_residual(zero, zero, base_i, base_j, z_inv)
    ji, jj = _edge_jac(zero, zero, base_i, base_j, z_inv)
    hd = torch.as_tensor(huber_delta, dtype=torch.float32,
                         device=base_i.device)
    if mode == "quad":
        scale = torch.ones_like(hd)
    elif mode == "dcs":
        phi = hd * hd
        chi2 = w * torch.sum(r * r)
        scale = torch.clamp(2.0 * phi / (phi + chi2 + 1e-32), max=1.0)
    elif mode == "huber":
        rn = torch.sqrt(torch.sum(r * r) + 1e-32)
        scale = torch.sqrt(torch.clamp(hd / rn, max=1.0))
    else:
        raise ValueError(f"bad robust mode {mode!r}")
    sw = torch.sqrt(w) * torch.where(hd > 0, scale, torch.ones_like(scale))
    return r * sw, ji * sw, jj * sw


def _accumulate_normal_eq(poses, edges, z_inv, weights, n_nodes: int,
                          huber_delta=0.0, mode: str = "huber", valid=None):
    """Dense H (6N, 6N), b (6N,) and the cost from all edges (those where
    ``valid`` holds, when given).

    The edge blocks are vmapped, placed in a dense (6E, 6N) Jacobian and
    reduced by two products, a fixed order on any device.  Dense H is
    (6N)^2: fine to several hundred submaps."""
    r, ji, jj = vmap(
        lambda pi, pj, zi, w: _edge_blocks(pi, pj, zi, w, huber_delta, mode)
    )(poses[edges[:, 0]], poses[edges[:, 1]], z_inv, weights)
    if valid is not None:
        r = torch.where(valid[:, None], r, 0.0)
        ji = torch.where(valid[:, None, None], ji, 0.0)
        jj = torch.where(valid[:, None, None], jj, 0.0)
    e = edges.shape[0]
    rows = torch.arange(e, device=poses.device)
    J = torch.zeros((e, 6, n_nodes, 6), dtype=poses.dtype,
                    device=poses.device)
    J[rows, :, edges[:, 0], :] = ji
    J[rows, :, edges[:, 1], :] += jj      # a self-edge adds to its block
    J = J.reshape(6 * e, 6 * n_nodes)
    r = r.reshape(-1)
    return J.T @ J, J.T @ r, torch.sum(r * r)


def _accumulate_sharded(mesh, poses, edges, z_inv, weights, n_nodes: int,
                        huber_delta, mode: str, device):
    """:func:`_accumulate_normal_eq` with the edges padded to a multiple
    of the mesh's shards and split over them, each shard's part on its
    device, summed over the mesh (``ShardMesh.psum``) onto ``device``."""
    e = edges.shape[0]
    k = -(-e // mesh.n_shards)
    pad = k * mesh.n_shards - e
    edges = torch.cat([edges, edges.new_zeros((pad, 2))])
    eye = torch.eye(4, dtype=z_inv.dtype, device=z_inv.device)
    z_inv = torch.cat([z_inv, eye.expand(pad, 4, 4)])
    weights = torch.cat([weights, weights.new_zeros(pad)])
    valid = torch.arange(e + pad, device=edges.device) < e
    parts = []
    for i, dev in enumerate(mesh.devices):
        sl = slice((mesh.first + i) * k, (mesh.first + i + 1) * k)
        parts.append(_accumulate_normal_eq(
            poses.to(dev), edges[sl].to(dev), z_inv[sl].to(dev),
            weights[sl].to(dev), n_nodes, huber_delta, mode,
            valid[sl].to(dev)))
    return tuple(mesh.psum([p[j] for p in parts]).to(device)
                 for j in range(3))


def optimize_poses(graph: PoseGraph, init_poses: np.ndarray,
                   iterations: int = 10, damping: float = 1e-6,
                   mesh=None, huber_delta: float = 1.0, device="cuda"):
    """Gauss-Newton/LM over the pose graph on ``device``; node 0 is
    gauge-fixed.

    Edges are robustified by default (``huber_delta`` = expected inlier
    residual scale in tangent units; 0 = plain quadratic) with the JAX
    package's two-phase schedule: the first half of the iterations runs
    the redescending DCS kernel, then edges whose residual norm still
    exceeds ``3 * huber_delta`` become gate candidates.  A high-residual
    edge is either a wrong constraint or a correct loop closure over large
    drift that DCS starved of influence, so both models (candidates
    dropped / all kept) are optimized quadratically and the one with the
    lower saturating cost wins; ``stats["gated_edges"]`` counts the edges
    dropped.  With ``mesh`` (``parallel.make_mesh``) the edges are padded
    and split over its shards, and the normal equations summed; the solve
    runs on ``device``.  Returns (poses (N, 4, 4) np.float32, stats dict).
    """
    dev = torch.device(device)
    n = graph.n_nodes
    f32 = dict(dtype=torch.float32, device=dev)
    poses = torch.as_tensor(np.asarray(init_poses, np.float32), **f32)
    z_inv = torch.as_tensor(np.linalg.inv(
        graph.measurements.astype(np.float64)).astype(np.float32), **f32)
    edges = torch.as_tensor(np.asarray(graph.edges, np.int64), device=dev)
    weights = torch.as_tensor(np.asarray(graph.weights, np.float32), **f32)
    e = edges.shape[0]

    def accumulate(p, w, mode):
        if mesh is not None:
            return _accumulate_sharded(mesh, p, edges, z_inv, w, n,
                                       huber_delta, mode, dev)
        return _accumulate_normal_eq(p, edges, z_inv, w, n, huber_delta,
                                     mode)

    def res_norms(p):
        zero = torch.zeros(6, **f32)
        r = vmap(lambda pi, pj, zi: _edge_residual(zero, zero, pi, pj, zi))(
            p[edges[:, 0]], p[edges[:, 1]], z_inv)
        return torch.sqrt(torch.sum(r * r, dim=1)).cpu().numpy()

    def apply(p, dx):
        return vmap(lambda t, x: t @ se3_exp(x))(p, dx.reshape(n, 6))

    if huber_delta > 0:
        modes = ["dcs"] * ((iterations + 1) // 2)
        modes += ["quad"] * (iterations - len(modes))
    else:
        modes = ["quad"] * iterations
    costs = []
    gated = 0
    gauge = torch.zeros(6 * n, **f32)
    gauge[:6] = 1e12

    def run_phase(poses, w, mode, n_iter):
        for _ in range(n_iter):
            H, b, cost = accumulate(poses, w, mode)
            costs.append(float(cost))
            # gauge fix: clamp node 0 by lifting its diagonal block
            Hd = H + torch.diag(gauge + damping *
                                torch.clamp(torch.diag(H), min=1.0))
            dx = -torch.linalg.solve(Hd, b)
            poses = apply(poses, dx)
            if costs[-1] < 1e-18:
                break
        return poses

    def saturating_cost(poses):
        """Bounded (Geman-McClure) total cost over all edges: each edge
        adds at most phi = huber_delta^2, the score of the gate's
        hypothesis test."""
        rn = res_norms(poses).astype(np.float64)
        chi2 = np.asarray(graph.weights, np.float64) * rn * rn
        phi = float(huber_delta) ** 2
        return float((phi * chi2 / (phi + chi2)).sum())

    init = poses
    weights_run = weights
    n_dcs = sum(m == "dcs" for m in modes)
    n_quad = len(modes) - n_dcs
    if huber_delta > 0 and n_dcs:
        poses = run_phase(poses, weights_run, "dcs", n_dcs)
        gate = res_norms(poses)[:e] > 3.0 * huber_delta
        gated = int(gate.sum())
        if gated == 0:
            poses = run_phase(poses, weights_run, "quad", n_quad)
        else:
            wh = np.where(gate, 0.0, np.asarray(graph.weights)).astype(
                np.float32)
            w_drop = torch.as_tensor(wh, **f32)
            poses_drop = run_phase(poses, w_drop, "quad", max(n_quad, 1))
            poses_keep = run_phase(init, weights_run, "quad",
                                   max(n_quad, n_dcs, 1))
            if saturating_cost(poses_keep) < saturating_cost(poses_drop):
                poses, gated = poses_keep, 0
            else:
                poses, weights_run = poses_drop, w_drop
    else:
        poses = run_phase(poses, weights_run, "quad", iterations)
    # costs on one scale: the plain weighted quadratic over the surviving
    # edges at the initial and final poses
    init_cost = accumulate(init, weights_run, "quad")[2]
    final_cost = accumulate(poses, weights_run, "quad")[2]
    return (poses.cpu().numpy(),
            {"initial_cost": float(init_cost),
             "final_cost": float(final_cost),
             "iterations": len(costs),
             "gated_edges": gated})
