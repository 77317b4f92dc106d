"""Space-carving demo on the port (``examples/demo_carve.py`` of the JAX
package): a dynamic object's stale map residue erodes away.

A "parked car" (box of returns) is scanned and mapped; it then drives off,
and later scans see the wall behind it.  Without carving the TSDF keeps
the car forever (the reference has no mechanism to remove it — space
carving is the unbuilt last item of its roadmap, README.md:60).  With
``MapConfig(carve_steps=...)`` the free-space evidence of the later scans
erodes the car's zero crossing and the saved mesh shows only the wall.

Usage:  python3 -m chad_tsdf_tpu_torch.examples.demo_carve
            [--out carved.ply] [--cpu]
"""

import argparse
import sys


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="carved.ply")
    ap.add_argument("--scans", type=int, default=16)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    import numpy as np

    from chad_tsdf_tpu_torch import MapConfig, TSDFMap

    rng = np.random.default_rng(42)

    def car(n=1500):
        """Front + top faces of a 1.6 x 1.2 box at x = 2 (what a scanner
        at the origin actually sees of a parked car)."""
        face = rng.uniform(-0.8, 0.8, (n, 2)).astype(np.float32)
        front = np.column_stack([np.full(n, 2.0, np.float32),
                                 face[:, 0], 0.75 * np.abs(face[:, 1])])
        return front

    def wall(n=2000):
        # wide enough that its rays blanket the car's full silhouette
        # from the scanner (a ray to (5, y, z) crosses x=2 at 0.4*(y, z))
        yz = rng.uniform(-2.5, 2.5, (n, 2)).astype(np.float32)
        return np.column_stack([np.full(n, 5.0, np.float32),
                                yz[:, 0], yz[:, 1]])

    cfg = MapConfig(max_points=1 << 12,
                    carve_steps=128, carve_stride=1.0, carve_subsample=1)
    pos = np.float32([0.0, 0.0, 0.5])

    m = TSDFMap(config=cfg, device="cpu" if args.cpu else "cuda")
    m.insert(car(), pos)                     # the car is parked...
    before = m.extract_mesh()
    n_car0 = int(np.sum(np.abs(before.vertices[:, 0] - 2.0) < 0.2))
    print(f"after scan 1:  {before.n_vertices} mesh verts, "
          f"{n_car0} on the car")

    for _ in range(args.scans):              # ...then drives off
        m.insert(wall(), pos)

    m.save(args.out)
    after = m.extract_mesh()
    n_car1 = int(np.sum(np.abs(after.vertices[:, 0] - 2.0) < 0.2))
    n_wall = int(np.sum(np.abs(after.vertices[:, 0] - 5.0) < 0.2))
    print(f"after {args.scans + 1} scans: {after.n_vertices} mesh verts, "
          f"{n_car1} on the (gone) car, {n_wall} on the wall")
    print(f"wrote {args.out}")
    if n_car0 > 0 and n_car1 == 0 and n_wall > 0:
        print("carving OK: stale car erased, wall intact")
        return 0
    print("unexpected: residue remains")
    return 1


if __name__ == "__main__":
    sys.exit(main())
