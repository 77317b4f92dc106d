"""The port's pose graph (``chad_tsdf_tpu_torch/slam/posegraph.py``) and
``TSDFMap.optimize_loop_closures`` on the CPU, against the JAX package's
``slam/posegraph.py``: SE(3) exp / log, the optimizer on the same graphs
(poses, gated edges, iterations), the outlier gate and the large-drift
hypothesis test of tests/test_posegraph.py, the normal equations summed
over an 8-shard mesh, the three map cases of tests/test_loop_closure.py,
and a ``raycast`` that answers from the corrected map."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chad_tsdf_tpu.parallel import make_mesh as jax_make_mesh
from chad_tsdf_tpu.slam import posegraph as j_pg
from chad_tsdf_tpu_torch import MapConfig, TSDFMap
from chad_tsdf_tpu_torch.io import load_checkpoint, save_checkpoint
from chad_tsdf_tpu_torch.parallel import make_mesh
from chad_tsdf_tpu_torch.slam import posegraph as pg

DRIFT = np.float32([0.35, 0.0, 0.0])
POS2_TRUE = np.float32([0.6, 0.0, 0.0])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: intra-op threads buy nothing and, on several test
    workers, fight them for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def circle_trajectory(n=16, radius=10.0):
    """Poses around a circle, heading tangent; closes a loop."""
    poses = []
    for i in range(n):
        a = 2 * np.pi * i / n
        c, s = np.cos(a), np.sin(a)
        R = np.array([[-s, 0, c], [c, 0, s], [0, 1, 0]], np.float64).T
        T = np.eye(4)
        T[:3, :3] = R
        T[:3, 3] = [radius * c, radius * s, 0.0]
        poses.append(T)
    return np.asarray(poses)


def _integrate(gt, graph):
    init = [gt[0]]
    for k in range(len(gt) - 1):
        init.append(init[-1] @ graph.measurements[k].astype(np.float64))
    return np.asarray(init)


def _problem(name):
    """(ground truth, graph, initial poses, huber_delta) of
    tests/test_posegraph.py's three optimizer cases."""
    gt = circle_trajectory()
    t = len(gt)
    if name == "large_drift":
        bias = pg.se3_exp(torch.tensor(
            [0.0, 0.0, 0.0, 0.0, 0.0, np.deg2rad(6.0)],
            dtype=torch.float32)).numpy()
        zs = [(np.linalg.inv(gt[i]) @ gt[i + 1]) @ bias for i in range(t - 1)]
        graph = pg.PoseGraph(t, np.asarray([(i, i + 1) for i in range(t - 1)],
                                           np.int32),
                             np.asarray(zs, np.float32),
                             np.ones(t - 1, np.float32))
    else:
        graph = pg.make_odometry_edges(gt, noise=0.02,
                                       seed=1 if name == "drift" else 5)
    graph = pg.add_edge(graph, t - 1, 0, np.linalg.inv(gt[-1]) @ gt[0],
                        weight=10.0)
    init = _integrate(gt, graph)
    if name == "outlier":
        bad = np.eye(4, dtype=np.float32)
        bad[:3, 3] = [15.0, -7.0, 3.0]
        graph = pg.add_edge(graph, 2, 8, bad, weight=1.0)
    return gt, graph, init


_JAX = {}


def _jax_solve(name, iterations=20, huber_delta=1.0):
    """The JAX package's solve of a case on the port's graph, once per
    module."""
    key = (name, iterations, huber_delta)
    if key not in _JAX:
        _, graph, init = _problem(name)
        jg = j_pg.PoseGraph(graph.n_nodes, graph.edges, graph.measurements,
                            graph.weights)
        _JAX[key] = j_pg.optimize_poses(jg, init, iterations=iterations,
                                        huber_delta=huber_delta)
    return _JAX[key]


@pytest.mark.parametrize("scale", [1e-8, 1e-4, 0.1, 1.0, 2.5])
def test_se3_exp_log_match_jax(scale):
    rng = np.random.default_rng(0)
    xi = rng.normal(0, scale, 6).astype(np.float32)
    T = pg.se3_exp(torch.from_numpy(xi))
    np.testing.assert_allclose(T.numpy(),
                               np.asarray(j_pg.se3_exp(jnp.asarray(xi))),
                               rtol=0, atol=1e-5)
    back = pg.se3_log(T)
    np.testing.assert_allclose(back.numpy(),
                               np.asarray(j_pg.se3_log(jnp.asarray(
                                   T.numpy()))), rtol=0, atol=1e-5)
    np.testing.assert_allclose(back.numpy(), xi, rtol=1e-4, atol=1e-6)
    R = T.numpy()[:3, :3]
    np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-5)


def test_jacobian_finite_at_zero_residual():
    """Converged edges must not poison H with NaNs, vmapped or not."""
    gt = circle_trajectory()
    poses = torch.as_tensor(gt, dtype=torch.float32)
    z_inv = torch.as_tensor(np.stack([np.linalg.inv(
        np.linalg.inv(gt[i]) @ gt[i + 1]) for i in range(15)]),
        dtype=torch.float32)
    edges = torch.stack([torch.arange(15), torch.arange(1, 16)], 1)
    for mode in ("quad", "dcs", "huber"):
        H, b, cost = pg._accumulate_normal_eq(
            poses, edges, z_inv, torch.ones(15), 16, 1.0, mode)
        assert torch.isfinite(H).all() and torch.isfinite(b).all()
        assert float(cost) < 1e-10


@pytest.mark.parametrize("name", ["drift", "outlier", "large_drift"])
def test_optimize_poses_matches_jax(name):
    _, graph, init = _problem(name)
    jp, js = _jax_solve(name)
    tp, ts = pg.optimize_poses(graph, init, iterations=20, device="cpu")
    np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-4)
    assert ts["gated_edges"] == js["gated_edges"]
    assert ts["iterations"] == js["iterations"]
    np.testing.assert_allclose(ts["final_cost"], js["final_cost"],
                               rtol=1e-3, atol=1e-6)


def test_loop_closure_reduces_drift():
    gt, graph, init = _problem("drift")
    drift0 = np.linalg.norm(init[-1][:3, 3] - gt[-1][:3, 3])
    opt, stats = pg.optimize_poses(graph, init, iterations=15, device="cpu")
    assert stats["final_cost"] < stats["initial_cost"] * 0.1
    assert np.linalg.norm(opt[-1][:3, 3] - gt[-1][:3, 3]) < 0.25 * drift0
    np.testing.assert_allclose(opt[0], gt[0], atol=1e-3)


def test_outlier_loop_edge_is_rejected():
    """One grossly wrong loop edge is gated and the trajectory stays
    within 10 cm of the outlier-free solve; the plain quadratic is
    corrupted by it."""
    gt, graph, init = _problem("drift")
    _, bad_graph, _ = _problem("outlier")
    # the outlier case's odometry differs (seed 5): solve it without the
    # bad edge for the clean reference
    clean = pg.PoseGraph(bad_graph.n_nodes, bad_graph.edges[:-1],
                         bad_graph.measurements[:-1], bad_graph.weights[:-1])
    init = _integrate(gt, bad_graph)
    opt_clean, _ = pg.optimize_poses(clean, init, iterations=20,
                                     device="cpu")
    opt_rob, stats = pg.optimize_poses(bad_graph, init, iterations=20,
                                       device="cpu")
    assert stats["gated_edges"] == 1, stats
    err_rob = np.linalg.norm(opt_rob[:, :3, 3] - opt_clean[:, :3, 3], axis=1)
    assert err_rob.max() < 0.1
    opt_quad, _ = pg.optimize_poses(bad_graph, init, iterations=20,
                                    huber_delta=0.0, device="cpu")
    err_quad = np.linalg.norm(opt_quad[:, :3, 3] - opt_clean[:, :3, 3],
                              axis=1)
    assert err_quad.max() > 10 * err_rob.max()


def test_large_drift_loop_closure_not_gated():
    gt, graph, init = _problem("large_drift")
    drift0 = np.linalg.norm(init[-1][:3, 3] - gt[-1][:3, 3])
    assert drift0 > 5.0
    opt, stats = pg.optimize_poses(graph, init, iterations=20, device="cpu")
    assert stats["gated_edges"] == 0, stats
    assert np.linalg.norm(opt[-1][:3, 3] - gt[-1][:3, 3]) < 0.1 * drift0


def test_sharded_reduction_not_ported():
    """The sharded reduction (once refused, now ported): edges padded and
    split over an 8-shard mesh, their normal equations summed, equal the
    single-device solve and the JAX package's 8-device solve within
    tests/test_posegraph.py's tolerance."""
    _, graph, init = _problem("drift")
    opt1, s1 = pg.optimize_poses(graph, init, iterations=8, device="cpu")
    opt8, s8 = pg.optimize_poses(graph, init, iterations=8,
                                 mesh=make_mesh(8, device="cpu"),
                                 device="cpu")
    np.testing.assert_allclose(opt8, opt1, rtol=1e-3, atol=1e-4)
    assert abs(s8["final_cost"] - s1["final_cost"]) <= \
        1e-3 * max(1.0, s1["final_cost"])
    jg = j_pg.PoseGraph(graph.n_nodes, graph.edges, graph.measurements,
                        graph.weights)
    jopt, js = j_pg.optimize_poses(jg, init, iterations=8,
                                   mesh=jax_make_mesh(8))
    np.testing.assert_allclose(opt8, jopt, rtol=1e-3, atol=1e-4)
    assert s8["gated_edges"] == js["gated_edges"]


# --- the map: tests/test_loop_closure.py ---------------------------------

def _sphere_points(n=20000, r=2.0, seed=7):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (d * r).astype(np.float32)


def _cfg():
    return MapConfig(max_points=1 << 15, block_capacity=1 << 14,
                     touched_capacity=1 << 13, submap_distance=0.5)


def _trans(t):
    T = np.eye(4)
    T[:3, 3] = t
    return T


def _two_pass_map(drift):
    pts = _sphere_points()
    m = TSDFMap(config=_cfg(), device="cpu")
    m.insert(pts, np.zeros(3, np.float32))
    m.finalize_active()
    m.insert(pts + drift, POS2_TRUE + drift)
    m.finalize_active()
    return m


@pytest.fixture(scope="module")
def drifted():
    """The drifted two-pass map before and after its loop closure:
    (voxel samples before, the corrected map, its stats), built once."""
    m = _two_pass_map(DRIFT)
    before = m.voxel_samples()
    stats = m.optimize_loop_closures(
        loop_edges=[(0, 1, _trans(POS2_TRUE), 1000.0)])
    return before, m, stats


def test_loop_closure_corrects_drifted_map(drifted):
    (codes_drift, _), m, stats = drifted
    assert len(m.submaps) == 2
    oracle = TSDFMap(config=_cfg(), device="cpu")
    pts = _sphere_points()
    oracle.insert(pts, np.zeros(3, np.float32))
    oracle.insert(pts, POS2_TRUE)
    oracle.finalize_active()
    codes_o, sd_o = oracle.voxel_samples()
    assert codes_drift.shape[0] > 1.5 * codes_o.shape[0]
    assert stats["final_cost"] < stats["initial_cost"]
    corr = m.submaps[1].corrected
    assert corr is not None and m.submaps[0].corrected is None
    np.testing.assert_allclose(corr[:3, 3], -DRIFT, atol=0.01)
    codes_c, sd_c = m.voxel_samples()
    assert abs(codes_c.shape[0] - codes_o.shape[0]) < 0.1 * codes_o.shape[0]
    common, ia, ib = np.intersect1d(codes_c, codes_o, return_indices=True)
    assert common.shape[0] > 0.9 * codes_o.shape[0]
    quantum = m.config.sdf_trunc / 127
    diff = np.abs(sd_c[ia] - sd_o[ib])
    assert float(np.median(diff)) < 2 * quantum
    assert float(np.mean(diff)) < 6 * quantum


def test_loop_closure_matches_jax_solve(drifted):
    """The map's corrections equal the JAX package's solve of the graph
    built from the same anchors (within 1e-4), with the same stats."""
    _, m, stats = drifted
    anchors = np.stack([sm.anchor for sm in m.submaps]).astype(np.float32)
    graph = j_pg.add_edge(j_pg.make_odometry_edges(anchors), 0, 1,
                          _trans(POS2_TRUE).astype(np.float32), 1000.0)
    jp, js = j_pg.optimize_poses(graph, anchors, iterations=20,
                                 huber_delta=1.0)
    for sm, a, p in zip(m.submaps, anchors, jp):
        corr = sm.corrected if sm.corrected is not None else np.eye(4)
        np.testing.assert_allclose(corr @ a, p, rtol=0, atol=1e-4)
    assert stats["iterations"] == js["iterations"]
    assert stats["gated_edges"] == js["gated_edges"]


def test_loop_closure_noop_without_drift():
    """A consistent trajectory and a truthful loop edge move nothing."""
    m = _two_pass_map(np.zeros(3, np.float32))
    before, sd_before = m.voxel_samples()
    m.optimize_loop_closures(loop_edges=[(0, 1, _trans(POS2_TRUE), 1000.0)])
    after, sd_after = m.voxel_samples()
    np.testing.assert_array_equal(before, after)
    np.testing.assert_allclose(sd_before, sd_after)
    # the normal equations summed over a mesh: still nothing moves
    m.optimize_loop_closures(loop_edges=[(0, 1, _trans(POS2_TRUE), 1000.0)],
                             mesh=make_mesh(4, device="cpu"))
    after, sd_after = m.voxel_samples()
    np.testing.assert_array_equal(before, after)
    np.testing.assert_allclose(sd_before, sd_after)


def test_loop_closure_checkpoint_roundtrip(drifted, tmp_path):
    _, m, _ = drifted
    codes_c, sd_c = m.voxel_samples()
    p = str(tmp_path / "ckpt.npz")
    save_checkpoint(p, m)
    m2 = load_checkpoint(p, device="cpu")
    assert m2.submaps[1].corrected is not None
    codes_2, sd_2 = m2.voxel_samples()
    np.testing.assert_array_equal(codes_c, codes_2)
    np.testing.assert_allclose(sd_c, sd_2)


def test_raycast_after_loop_closure_uses_corrected_map():
    """A raycast before the closure caches the query index; the closure
    must drop it, so the next raycast answers from the corrected map."""
    m = _two_pass_map(DRIFT)
    # seen from the scanner inside, the first (+ to -) crossing along -x
    # is the far wall: the drifted copy's at x = -1.65, then at -2
    origin, direction = np.float32([4.0, 0.0, 0.0]), np.float32([-1, 0, 0])
    hit0 = m.raycast(origin, direction)
    m.optimize_loop_closures(loop_edges=[(0, 1, _trans(POS2_TRUE), 1000.0)])
    hit1 = m.raycast(origin, direction)
    m._query_cache = None
    fresh = m.raycast(origin, direction)
    np.testing.assert_array_equal(hit1, fresh)
    assert abs(hit0[0] + 1.65) < 0.05 and abs(hit1[0] + 2.0) < 0.05
