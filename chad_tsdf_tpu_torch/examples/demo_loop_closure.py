"""Loop-closure demo on the port (``examples/demo_loop_closure.py`` of the
JAX package): correct a drifted revisit with the pose graph.

Two passes over the same sphere; the second pass's odometry is off by an
injected drift, so the raw map contains two displaced copies of the
surface.  A single loop-closure constraint (the true relative pose between
the two submaps — in a real system from place recognition + scan matching)
lets ``TSDFMap.optimize_loop_closures`` re-anchor the drifted submap, and
the fused map collapses back onto one surface.

Reference parity: the reference lists "Loop closure" as unbuilt roadmap
(README.md:59; declared surface tsdf.hpp:158-161).

Usage:  python3 -m chad_tsdf_tpu_torch.examples.demo_loop_closure
            [--out corrected.ply] [--cpu]
"""

import argparse


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="corrected.ply")
    ap.add_argument("--points", type=int, default=50000)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    import numpy as np

    from chad_tsdf_tpu_torch import MapConfig, TSDFMap

    rng = np.random.default_rng(7)
    d = rng.normal(size=(args.points, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pts = (d * 2.0).astype(np.float32)

    drift = np.float32([0.35, 0.0, 0.0])
    pos2_true = np.float32([0.6, 0.0, 0.0])

    m = TSDFMap(config=MapConfig(max_points=1 << 16,
                                 block_capacity=1 << 14,
                                 touched_capacity=1 << 13,
                                 submap_distance=0.5),
                device="cpu" if args.cpu else "cuda")
    m.insert(pts, np.zeros(3, np.float32))
    m.finalize_active()
    # second pass: same true geometry, odometry corrupted by `drift`
    m.insert(pts + drift, pos2_true + drift)
    m.finalize_active()

    codes_before, _ = m.voxel_samples()
    print(f"before: {codes_before.shape[0]} voxels "
          f"(two displaced surface copies)")

    z = np.eye(4)
    z[:3, 3] = pos2_true                      # true relative pose 0 -> 1
    stats = m.optimize_loop_closures(loop_edges=[(0, 1, z, 1000.0)])
    corr = m.submaps[1].corrected
    print(f"optimizer: cost {stats['initial_cost']:.4f} -> "
          f"{stats['final_cost']:.6f} in {stats['iterations']} iters")
    print(f"submap 1 correction translation: {corr[:3, 3]} "
          f"(injected drift was {-drift})")

    codes_after, _ = m.voxel_samples()
    mesh = m.extract_mesh()
    radii = np.linalg.norm(mesh.vertices, axis=1)
    print(f"after:  {codes_after.shape[0]} voxels "
          f"({codes_after.shape[0] / codes_before.shape[0]:.0%}); "
          f"mesh |v| = {radii.mean():.4f} ± {radii.std():.4f} (want 2.0)")
    from chad_tsdf_tpu_torch.mesh import write_ply
    write_ply(args.out, mesh)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
