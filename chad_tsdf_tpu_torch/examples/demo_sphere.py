"""The reference's canonical demo: 1M random points on a 5 m sphere
-> insert -> save mesh.ply (reference: src/chad/main.cpp:7-42, seed 420),
on the port (``examples/demo_sphere.py`` of the JAX package).

Usage:
    python3 -m chad_tsdf_tpu_torch.examples.demo_sphere [--points 1000000]
        [--out mesh.ply] [--cpu] [--profile]
"""

import argparse
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--points", type=int, default=1_000_000)
    ap.add_argument("--out", default="mesh.ply")
    ap.add_argument("--res", type=float, default=0.05)
    ap.add_argument("--trunc", type=float, default=0.1)
    ap.add_argument("--cpu", action="store_true", help="force CPU backend")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--repeats", type=int, default=1,
                    help="re-insert the cloud N times (throughput runs)")
    args = ap.parse_args()

    import numpy as np
    import torch

    from chad_tsdf_tpu_torch import MapConfig, TSDFMap

    rng = np.random.default_rng(420)          # main.cpp:10 gen(420)
    d = rng.uniform(-1.0, 1.0, (args.points, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    points = (d * 5.0).astype(np.float32)
    position = np.zeros(3, np.float32)

    cfg = MapConfig(sdf_res=args.res, sdf_trunc=args.trunc,
                    profile=args.profile)
    m = TSDFMap(config=cfg, device="cpu" if args.cpu else "cuda")

    t0 = time.perf_counter()
    for _ in range(args.repeats):
        metrics = m.insert(points, position)
    m.state                               # settles the last insert
    if m.device.type == "cuda":
        torch.cuda.synchronize(m.device)
    dt = time.perf_counter() - t0
    total_pts = args.points * args.repeats
    print(f"insert: {dt*1e3:.1f} ms total, "
          f"{total_pts / dt / 1e6:.2f} M points/s")
    print(f"metrics: {metrics}")

    t0 = time.perf_counter()
    m.save(args.out)
    print(f"save:   {(time.perf_counter()-t0)*1e3:.1f} ms -> {args.out}")

    from chad_tsdf_tpu_torch.mesh import read_ply
    mesh = read_ply(args.out)
    r = np.linalg.norm(mesh.vertices, axis=1)
    print(f"mesh: {mesh.n_vertices} vertices, {mesh.n_faces} faces; "
          f"|v| = {r.mean():.4f} ± {r.std():.4f} (want 5.0)")
    print(f"stats: {m.stats()}")


if __name__ == "__main__":
    main()
