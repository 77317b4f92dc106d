"""KITTI odometry streaming integrate (BASELINE.json config 2) on the port
(``examples/demo_kitti.py`` of the JAX package).

Usage:
    python3 -m chad_tsdf_tpu_torch.examples.demo_kitti \
        --root /data/kitti_odometry --seq 00 [--scans 100] [--out kitti.ply]
        [--cpu]

Streams velodyne scans through TSDFMap.insert with real poses; submaps
rotate automatically every 5 m of travel (reference policy, tsdf.cpp:52).
Prints scans/s and per-insert metrics; writes the fused mesh at the end.
Exits 2 when the sequence is not found (no KITTI data ships with the
repository).
"""

import argparse
import sys
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--seq", default="00")
    ap.add_argument("--scans", type=int, default=None)
    ap.add_argument("--out", default="kitti.ply")
    ap.add_argument("--res", type=float, default=0.1)
    ap.add_argument("--trunc", type=float, default=0.3)
    ap.add_argument("--max-range", type=float, default=80.0)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--metrics", default=None,
                    help="JSON-lines metrics sink path")
    args = ap.parse_args()

    import torch

    from chad_tsdf_tpu_torch import MapConfig, TSDFMap
    from chad_tsdf_tpu_torch.io import KittiSequence
    from chad_tsdf_tpu_torch.utils import JsonMetricsSink

    seq = KittiSequence(args.root, args.seq)
    if not seq.available:
        print(f"KITTI sequence not found under {args.root} "
              f"(need sequences/{args.seq}/velodyne, poses/{args.seq}.txt, "
              f"calib.txt)", file=sys.stderr)
        sys.exit(2)

    cfg = MapConfig(sdf_res=args.res, sdf_trunc=args.trunc,
                    max_points=1 << 17)
    m = TSDFMap(config=cfg, device="cpu" if args.cpu else "cuda")
    sink = JsonMetricsSink(args.metrics) if args.metrics else None

    t0 = time.perf_counter()
    n = 0
    for pts, pos in seq.stream_scans(args.scans, max_range=args.max_range):
        metrics = m.insert(pts, pos)
        n += 1
        if sink:
            sink.write({"scan": n, "n_points": len(pts), **metrics})
        if n % 50 == 0:
            dt = time.perf_counter() - t0
            print(f"{n} scans, {n/dt:.2f} scans/s, "
                  f"submaps={len(m.submaps)}, "
                  f"active_blocks={int(m.state.n_blocks)}")
    m.state                               # settles the last insert
    if m.device.type == "cuda":
        torch.cuda.synchronize(m.device)
    dt = time.perf_counter() - t0
    print(f"total: {n} scans in {dt:.1f} s -> {n/dt:.2f} scans/s")
    print(f"stats: {m.stats()}")
    m.save(args.out)
    print(f"mesh -> {args.out}")


if __name__ == "__main__":
    main()
